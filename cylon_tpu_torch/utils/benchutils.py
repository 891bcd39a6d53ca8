"""Benchmark helpers (``cylon_tpu/utils/benchutils.py``; reference:
python/pycylon/util/benchutils.py, the ``benchmark_with_repitions``
decorator of the op micro-benchmarks)."""
from __future__ import annotations

import time
from typing import Callable


def time_conversion(t_ns: float, time_type: str = "ms") -> float:
    """Nanoseconds to the requested unit (the reference's four)."""
    if time_type == "ms":
        return t_ns / 1e6
    if time_type == "us":
        return t_ns / 1e3
    if time_type == "s":
        return t_ns / 1e9
    if time_type == "ns":
        return t_ns
    raise ValueError(f"bad time_type {time_type!r}")


def _wait_for_devices(result) -> None:
    """Block until the CUDA work behind ``result`` has finished (every
    card's queue), so the device time is measured; a no-op without
    CUDA tensors."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def benchmark_with_repetitions(repetitions: int = 10, time_type: str = "ms"):
    """Decorator: run ``repetitions`` times, return (average time in
    ``time_type``, last result), waiting for the card's queued work
    before the clock stops."""
    def wrap(f: Callable):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            result = None
            for _ in range(repetitions):
                result = f(*args, **kwargs)
            _wait_for_devices(result)
            elapsed = (time.perf_counter_ns() - t0) / max(repetitions, 1)
            return time_conversion(elapsed, time_type), result

        return wrapped

    return wrap


# the reference spells it "repitions"; accept both
benchmark_with_repitions = benchmark_with_repetitions
