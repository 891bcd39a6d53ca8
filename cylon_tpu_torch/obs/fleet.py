"""The failure flight recorder.

The part of ``cylon_tpu/obs/fleet.py`` the out-of-core engine calls:
:func:`flight_record` dumps the always-on event ring
(``obs.spans.ring_events``: the most recent events, kept even in aggregate
mode) and a metrics snapshot to
``CYLON_TPU_TRACE_DIR/flight/<run_id>.r<rank>.json`` when a classified
terminal event fires (a quarantined part, a fatal pass failure).  The
dump is written atomically (tmp + rename), and a failed dump is logged and
swallowed: the recorder never kills the path it records.  One process
drives every shard here, so a dump's rank is 0 unless the caller names
one; the fleet's clock alignment and coordinator incarnations are not ported
(their fields stay None).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import config
from . import metrics as metrics_mod
from . import spans as spans_mod
from . import tracectx

log = logging.getLogger("cylon_tpu_torch")

_lock = threading.Lock()
_reasons: List[Dict[str, object]] = []   # terminal events this process saw


def reset() -> None:
    """Clear the recorded terminal events (tests)."""
    with _lock:
        _reasons.clear()
        _last_write.clear()


def _event_json(ev: spans_mod.Event, pid: int) -> Dict[str, object]:
    """One Chrome-trace event (``cylon_tpu/obs/export.py:74``)."""
    out: Dict[str, object] = {
        "name": ev.name, "cat": "cylon_tpu", "ph": ev.ph,
        "ts": ev.ts / 1e3, "pid": pid, "tid": ev.tid,
    }
    if ev.ph == "X":
        out["dur"] = ev.dur / 1e3
    else:
        out["s"] = "t"  # thread-scoped instant
    args: Dict[str, object] = {"depth": ev.depth}
    if ev.attrs:
        args.update(ev.attrs)
    if ev.trace is not None:
        args["trace_id"], args["span_id"] = ev.trace[0], ev.trace[1]
        if ev.trace[2]:
            args["parent_span_id"] = ev.trace[2]
    out["args"] = args
    return out


FLIGHT_KIND = "cylon_tpu.flight"


def flight_dir() -> str:
    return os.path.join(
        str(config.knob("CYLON_TPU_TRACE_DIR")) or "traces", "flight")


def _safe_component(s: str) -> str:
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in s)


#: minimum spacing between REWRITES of one dump file for an IDENTICAL
#: repeating event (same reason, same attrs — e.g. one tenant's sheds
#: hammering a full queue): some call sites fire from hot paths, so an
#: event flood must not cost a file write apiece.  A DISTINCT terminal
#: event (different reason or attrs — a second rank lost, a different
#: tenant shed) always writes: the contract is that every classified
#: terminal event reaches disk, and only exact repeats coalesce into
#: the ledger the next write carries.
FLIGHT_REWRITE_MIN_S = 0.25

_last_write: Dict[str, Tuple[float, str]] = {}  # path -> (mono, event fp)


def flight_record(reason: str, *, rank=None, run_id: Optional[str] = None,
                  **attrs) -> Optional[str]:
    """Dump the flight ring + metrics snapshot for a classified terminal
    event.  Returns the dump path, or None when throttled, or
    the write failed (a recorder failure must never mask the event it
    records).

    Repeated terminal events in one process rewrite the same
    ``<run_id>.r<rank>.json`` file (an IDENTICAL event repeating within
    ``FLIGHT_REWRITE_MIN_S`` coalesces into the next write; distinct
    events always write); every dump
    carries the cumulative ``terminal_events`` list, so the latest file
    tells the whole story.  The write is atomic (tmp + rename) but NOT
    fsynced — this is a best-effort post-mortem, and several call sites
    hold hot locks; a synchronous disk flush there would stall the very
    control paths being recorded.
    """
    try:
        entry = {"reason": reason, "ts_unix": time.time(),
                 "attrs": {k: v for k, v in attrs.items()}}
        with _lock:
            _reasons.append(entry)
            del _reasons[:-64]
            reasons = list(_reasons)
        r = 0 if rank is None else rank
        rid = run_id or f"run-{os.getpid()}"
        d = flight_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"{_safe_component(str(rid))}.r{_safe_component(str(r))}.json")
        now = time.monotonic()
        fp = f"{reason}|{sorted(entry['attrs'].items())!r}"
        with _lock:
            last = _last_write.get(path)
            if (last is not None and last[1] == fp
                    and now - last[0] < FLIGHT_REWRITE_MIN_S):
                return None  # exact repeat coalesced; the ledger kept it
            _last_write[path] = (now, fp)
        pid = r if isinstance(r, int) else 0
        # the active (or explicitly attributed) request trace: a flight
        # dump can then be JOINED to the request trace that died — the
        # post-mortem's causal edge
        tctx = tracectx.current()
        trace_id = entry["attrs"].get("trace_id") or (
            tctx.trace_id if tctx is not None else None)
        doc = {
            "kind": FLIGHT_KIND,
            "run_id": str(rid),
            "rank": r,
            "reason": reason,
            "trace_id": trace_id,
            "attrs": entry["attrs"],
            "terminal_events": reasons,
            "clock": None,
            "incarnation": None,
            "traceEvents": [_event_json(e, pid)
                            for e in spans_mod.ring_events()],
            "ring_cap": spans_mod.RING_CAP,
            "dropped_events": spans_mod.dropped(),
            "metrics": metrics_mod.snapshot(),
            "aggregates": {k: [t, c] for k, (t, c)
                           in sorted(spans_mod.aggregate_report().items())},
            "ts_unix": entry["ts_unix"],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=str)
        os.replace(tmp, path)
        metrics_mod.counter_add("flight.dumps")
        spans_mod.instant("flight.dump", reason=reason)
        return path
    except Exception as e:
        log.warning("flight recorder dump failed (%s): %s: %s",
                    reason, type(e).__name__, e)
        return None


def load_flight(path: str) -> Dict[str, object]:
    """Load and validate a flight-recorder dump."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("kind") != FLIGHT_KIND:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         f"(kind={doc.get('kind')!r})")
    for k in ("run_id", "rank", "reason", "traceEvents", "metrics"):
        if k not in doc:
            raise ValueError(f"{path}: flight dump missing {k!r}")
    if not isinstance(doc["traceEvents"], list):
        raise ValueError(f"{path}: traceEvents is not a list")
    return doc
