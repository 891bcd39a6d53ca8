"""Closed-loop clients: the next query leaves when the last result is on
the host, so the load is what the system sustains.  A query's latency
runs from its call to its result on the host.  The traffic file's
``clients`` says how many; this loop drives one."""
from __future__ import annotations

import time
import traceback
from types import SimpleNamespace


def drive(call, seconds: float, traffic: dict, done, log):
    """Calls ``call()`` (one query, its result on the host) until
    ``seconds`` have passed, and ``done(index, result)`` after each query
    that returned.  Each result is dropped before the next query leaves;
    the last one is returned as ``last``, ``(index, result)``."""
    if traffic.get("clients", 1) != 1:
        raise ValueError("the closed loop drives one client")
    latencies, failed = [], 0
    begin = time.perf_counter()
    while True:
        result = None
        t0 = time.perf_counter()
        try:
            result = call()
        except Exception:
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if result is not None:
            done(len(latencies) - 1, result)
        if t1 - begin >= seconds:
            break
    last = (len(latencies) - 1, result) if result is not None else None
    return SimpleNamespace(latencies=latencies, window_s=t1 - begin,
                           failed=failed, last=last)
