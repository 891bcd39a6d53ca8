"""Fleet observability: process identity, clock alignment, and the
failure flight recorder.

A copy of ``cylon_tpu/obs/fleet.py``:

- **identity**: which rank this process is (:func:`set_rank`; consulted
  by ``obs.export`` for artifact naming before the ``torch.distributed``
  rank) and which logical run it belongs to (:func:`set_run_id`, else
  ``CYLON_TPU_RUN_ID``), namespacing exports and flight dumps;
- **clock alignment**: :func:`measure_offset`, an NTP-style
  offset/uncertainty handshake over a caller's ``request_fn`` (best of N
  round trips), whose :class:`ClockInfo` rides every export's
  ``otherData`` (:func:`set_clock`, :func:`clock_dict`); and
  :func:`merge_hist`, which adds two histogram dicts (the per-tenant
  latency histograms included, ``le`` buckets too);
- **flight recorder**: :func:`flight_record` dumps the always-on event
  ring (``obs.spans.ring_events``) and a metrics snapshot to
  ``CYLON_TPU_TRACE_DIR/flight/<run_id>.r<rank>.json`` when a classified
  terminal event fires (a quarantined part, a fatal pass, a serve shed or
  failed request).  The dump is atomic (tmp + rename), and a failed dump
  is logged and swallowed: the recorder never kills the path it records.

The elastic gang's coordinator and agents (``elastic.py``) call
``measure_offset``, ``set_rank`` and ``set_incarnation``.  Host-side
stdlib only.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .. import config
from . import metrics as metrics_mod
from . import spans as spans_mod
from . import tracectx

log = logging.getLogger("cylon_tpu_torch")

_lock = threading.Lock()
_rank: Optional[object] = None       # int rank, or "coord" on a coordinator
_run_id: Optional[str] = None
_clock: Optional["ClockInfo"] = None
_incarnation: Optional[int] = None   # coordinator incarnation last seen
_reasons: List[Dict[str, object]] = []   # terminal events this process saw


# ---------------------------------------------------------------------------
# identity
# ---------------------------------------------------------------------------

def set_rank(rank, *, force: bool = False) -> None:
    """Register this process's fleet rank (the elastic agent calls this at
    join).  First registration wins unless ``force`` — a process hosts one
    agent in deployment, and in-process multi-agent tests must not have
    the last-constructed agent steal the export naming."""
    global _rank
    with _lock:
        if _rank is None or force:
            _rank = rank


def current_rank() -> Optional[object]:
    with _lock:
        return _rank


def set_run_id(run_id: Optional[str], *, force: bool = True) -> None:
    global _run_id
    with _lock:
        if _run_id is None or force:
            _run_id = run_id or None


def current_run_id() -> Optional[str]:
    """The explicitly registered run id, else the ``CYLON_TPU_RUN_ID``
    knob, else None (flat artifact naming)."""
    with _lock:
        if _run_id:
            return _run_id
    return str(config.knob("CYLON_TPU_RUN_ID")) or None


def set_incarnation(inc: Optional[int]) -> None:
    """Register the coordinator incarnation this process last observed
    (the elastic agent calls this on every absorbed view): flight dumps
    and the status tooling stamp it, so a post-mortem can tell which
    coordinator lifetime an event belongs to."""
    global _incarnation
    with _lock:
        _incarnation = None if inc is None else int(inc)


def current_incarnation() -> Optional[int]:
    with _lock:
        return _incarnation


def reset() -> None:
    """Clear identity, clock, and recorded terminal events (tests)."""
    global _rank, _run_id, _clock, _incarnation
    with _lock:
        _rank = None
        _run_id = None
        _clock = None
        _incarnation = None
        _reasons.clear()
        _last_write.clear()


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClockInfo:
    """One measured mapping from this process's ``perf_counter_ns`` onto
    a reference clock: ``t_ref ≈ t_local + offset_ns``, wrong by at most
    about ``uncertainty_ns`` (half the round-trip residue)."""

    offset_ns: int
    uncertainty_ns: int
    rtt_ns: int
    ref: str                 # who the offset is against (host:port)
    measured_unix: float     # wall-clock stamp, labeling only
    measured_mono: float     # local monotonic stamp, for aging

    def as_dict(self) -> Dict[str, object]:
        return {"offset_ns": int(self.offset_ns),
                "uncertainty_ns": int(self.uncertainty_ns),
                "rtt_ns": int(self.rtt_ns), "ref": self.ref,
                "measured_unix": self.measured_unix}


def measure_offset(request_fn: Callable[[Dict], Dict], *, ref: str = "",
                   rank: Optional[int] = None,
                   rounds: int = 8) -> ClockInfo:
    """NTP-style offset handshake: ``rounds`` ``{"cmd": "clock"}`` round
    trips through ``request_fn`` (the agent's coordinator RPC), keeping
    the round with the smallest uncertainty.  Raises whatever
    ``request_fn`` raises (``OSError`` on a dead peer) and ``ValueError``
    on a malformed reply."""
    best: Optional[ClockInfo] = None
    for _ in range(max(1, int(rounds))):
        t0 = time.perf_counter_ns()
        resp = request_fn({"cmd": "clock", "rank": rank, "t0": t0})
        t3 = time.perf_counter_ns()
        if not resp.get("ok") or "t_recv" not in resp or "t_send" not in resp:
            raise ValueError(f"malformed clock reply: {resp}")
        t1, t2 = int(resp["t_recv"]), int(resp["t_send"])
        rtt = (t3 - t0) - (t2 - t1)
        offset = ((t1 - t0) + (t2 - t3)) // 2
        unc = max(rtt // 2, 1)
        if best is None or unc < best.uncertainty_ns:
            best = ClockInfo(offset, unc, rtt, ref,
                             time.time(), time.monotonic())
    assert best is not None
    return best


def set_clock(info: Optional[ClockInfo]) -> None:
    global _clock
    with _lock:
        _clock = info


def clock() -> Optional[ClockInfo]:
    with _lock:
        return _clock


def clock_dict() -> Optional[Dict[str, object]]:
    c = clock()
    return None if c is None else c.as_dict()


def merge_hist(a: Optional[Dict], b: Optional[Dict]) -> Optional[Dict]:
    """Merge two ``obs.metrics`` histogram dicts (count/sum/min/max +
    power-of-two buckets) — the coordinator aggregates per-rank serve
    telemetry with this."""
    if a is None:
        return None if b is None else dict(b)
    if b is None:
        return dict(a)
    mins = [v for v in (a.get("min"), b.get("min")) if v is not None]
    maxs = [v for v in (a.get("max"), b.get("max")) if v is not None]
    buckets: Dict[str, int] = dict(a.get("buckets") or {})
    for k, v in (b.get("buckets") or {}).items():
        buckets[k] = buckets.get(k, 0) + int(v)
    # the fixed cumulative le buckets sum per boundary (both sides share
    # the metrics.LE_BUCKETS boundary set, so cumulative counts add)
    le: Dict[str, int] = dict(a.get("le") or {})
    for k, v in (b.get("le") or {}).items():
        le[k] = le.get(k, 0) + int(v)
    out = {"count": int(a.get("count", 0)) + int(b.get("count", 0)),
           "sum": float(a.get("sum", 0.0)) + float(b.get("sum", 0.0)),
           "min": min(mins) if mins else None,
           "max": max(maxs) if maxs else None,
           "buckets": {k: buckets[k] for k in sorted(buckets, key=int)}}
    if le:
        out["le"] = {k: le[k] for k in sorted(
            le, key=lambda s: float("inf") if s == "+Inf" else float(s))}
    return out


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

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
        r = rank if rank is not None else current_rank()
        if r is None:
            r = 0
        rid = run_id or current_run_id() or f"run-{os.getpid()}"
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
            "clock": clock_dict(),
            "incarnation": current_incarnation(),
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
