"""Structured tracing spans: the event substrate of the flight recorder
and the Chrome-trace export.

A copy of ``cylon_tpu/obs/spans.py``.  Every span records (monotonic ns
start, duration, thread id, nesting depth, attributes).  Three modes, by
the ``CYLON_TPU_TRACE`` knob (read on every ``span()`` call):

- ``auto`` (default): the aggregate stopwatch (two ``perf_counter_ns``
  reads and two dict updates per span) and the flight ring;
- ``1`` / ``on``: aggregates plus the bounded event buffer
  (``BUFFER_CAP`` events; past it events are dropped and counted),
  which ``obs.export`` writes out;
- ``0`` / ``off``: a no-op singleton.

Spans measure host wall-clock.  Device work is asynchronous, so its time
lands in whichever span blocks on it (the engine's pass span blocks on
its fetch); ``CYLON_TPU_TRACE_SYNC=1`` fences at span boundaries
(``torch.cuda.synchronize`` where the reference blocks on a trivial
dispatch; nothing to fence in a process that never touched a card) so
device time lands in the span that launched it.  The flight ring
(``RING_CAP`` events) keeps the most recent events in every enabled mode
for ``obs.fleet.flight_record``.  ``CYLON_TPU_DEBUG`` (or
``enable_log``) logs one INFO line per finished span.  Tail-based
retention (``obs.tracectx.finish_request``) removes a closed request's
events through :func:`discard_trace`.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from .. import config
from . import tracectx

OFF = "off"
AGGREGATE = "aggregate"
EVENTS = "events"

_MODE_OF = {"0": OFF, "off": OFF, "auto": AGGREGATE,
            "1": EVENTS, "on": EVENTS}

#: maximum buffered events per process under ``CYLON_TPU_TRACE=1``
BUFFER_CAP = 65536
#: flight-recorder ring size: the most recent events a dump carries
RING_CAP = 512


class Event(NamedTuple):
    """One buffered trace event.  ``ts``/``dur`` are monotonic
    nanoseconds (``time.perf_counter_ns``); ``ph`` is the Chrome-trace
    phase — "X" complete span, "i" instant.  ``trace`` is the causal
    identity triple ``(trace_id, span_id, parent_span_id)`` when a
    request context (obs.tracectx) was active, else None."""

    name: str
    ts: int
    dur: int
    tid: int
    depth: int
    ph: str
    attrs: Optional[Dict[str, object]]
    trace: Optional[Tuple[str, str, Optional[str]]] = None


_events: List[Event] = []
_dropped = 0
# guards buffer membership (record vs retention discard): only taken
# when event buffering is ON — the aggregate-only default never touches
# it.  Readers (events(), exports) stay lock-free: tuple(_events) is one
# GIL-atomic C call and the list is only ever appended or rebuilt whole.
_buf_lock = threading.Lock()
_totals: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_tls = threading.local()

# flight-recorder ring: the most recent events, kept in EVERY enabled
# mode (aggregate included) so a terminal-event dump (obs.fleet) has
# context even when the user never armed CYLON_TPU_TRACE=1.  Unlike the
# export buffer it overwrites oldest-first — a post-mortem wants the
# events LEADING UP to the failure, not the run's first N.
_ring: "deque[Event]" = deque(maxlen=RING_CAP)

# per-span INFO log: initialized from CYLON_TPU_DEBUG, flipped by
# enable_log()
_log_on = bool(config.knob("CYLON_TPU_DEBUG"))
_log = logging.getLogger("cylon_tpu_torch.spans")


def enable_log(on: bool = True) -> None:
    """Log every finished span at INFO (name and milliseconds)."""
    global _log_on
    _log_on = bool(on)


def log_enabled() -> bool:
    return _log_on


def mode() -> str:
    """The live tracing mode: "off" | "aggregate" | "events"
    (``CYLON_TPU_TRACE``, read per call so knob_env overrides apply)."""
    return _MODE_OF.get(str(config.knob("CYLON_TPU_TRACE")), AGGREGATE)


def enabled() -> bool:
    return mode() != OFF


def events_enabled() -> bool:
    return mode() == EVENTS


def sync_enabled() -> bool:
    return bool(config.knob("CYLON_TPU_TRACE_SYNC"))


def _fence() -> None:
    """Drain the device's launched work (``torch.cuda.synchronize`` on the
    current card).  A no-op in a process that never initialized CUDA:
    CPU tensors run synchronously, so there is nothing to drain."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    try:
        torch.cuda.synchronize()
    except Exception as e:  # a failed fence must never kill the op it wraps
        _log.debug("trace sync fence failed: %s: %s", type(e).__name__, e)


def ring_events() -> Tuple[Event, ...]:
    """Snapshot of the flight-recorder ring, oldest first."""
    return tuple(_ring)


def _depth() -> int:
    return getattr(_tls, "depth", 0)


def _record(ev: Event) -> None:
    global _dropped
    with _buf_lock:
        if len(_events) >= BUFFER_CAP:
            _dropped += 1
            return
        _events.append(ev)


class _NullSpan:
    """The disabled-mode singleton: every method is a no-op and ``span()``
    hands out the same instance, so fully-disabled tracing allocates
    nothing per call site."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_d", "_buffer", "_sync", "_trace")

    def __init__(self, name: str, attrs: Optional[Dict[str, object]],
                 buffer: bool, sync: bool):
        self.name = name
        self.attrs = attrs
        self._buffer = buffer
        self._sync = sync
        self._trace = None

    def set(self, **attrs) -> "_Span":
        """Attach/refresh attributes after entry (e.g. a row count known
        only once the pass fetched)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        if self._sync:
            _fence()
        # causal identity: become a child span of the active request
        # context (None — the common case — costs one contextvar read)
        self._trace = tracectx.push_span()
        self._d = _depth()
        _tls.depth = self._d + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync:
            _fence()
        t1 = time.perf_counter_ns()
        _tls.depth = self._d
        dur = t1 - self._t0
        _totals[self.name] = _totals.get(self.name, 0.0) + dur * 1e-9
        _counts[self.name] = _counts.get(self.name, 0) + 1
        if _log_on:
            _log.info("%s %.3f ms", self.name, dur / 1e6)
        tr = None
        if self._trace is not None:
            ctx, tok = self._trace
            tracectx.pop_span(tok)
            tr = ctx.triple()
        ev = Event(self.name, self._t0, dur,
                   threading.get_ident(), self._d, "X", self.attrs, tr)
        if self._buffer:
            _record(ev)
        _ring.append(ev)
        return False


def span(name: str, **attrs):
    """Context manager timing one named phase.

    Aggregate totals always accumulate (unless tracing is fully off);
    under ``CYLON_TPU_TRACE=1`` the span also lands in the event buffer
    with its attributes.  Use ``as s`` + ``s.set(...)`` for attributes
    known only at exit."""
    m = mode()
    if m == OFF:
        return _NULL
    return _Span(name, attrs or None, m == EVENTS, sync_enabled())


def instant(name: str, **attrs) -> None:
    """Record a zero-duration instant event (retry, injected fault, OOM
    refinement).  Counted in the aggregates; buffered only under
    ``CYLON_TPU_TRACE=1``."""
    m = mode()
    if m == OFF:
        return
    _counts[name] = _counts.get(name, 0) + 1
    _totals.setdefault(name, 0.0)
    c = tracectx.current()
    ev = Event(name, time.perf_counter_ns(), 0,
               threading.get_ident(), _depth(), "i", attrs or None,
               None if c is None else c.triple())
    if m == EVENTS:
        _record(ev)
    _ring.append(ev)


def events() -> Tuple[Event, ...]:
    """Snapshot of the buffered events, in record order."""
    return tuple(_events)


def discard_trace(trace_id: str) -> int:
    """Tail-based retention's discard half: remove the buffered events
    stamped with ``trace_id`` (a fast-and-healthy request closing) and
    return how many went.  The flight ring is untouched, and the drop
    counter stays MONOTONE: retention discards are counted apart
    (``trace.tail_dropped``), never by un-counting overflow drops.  One
    O(buffer) rebuild under the record lock, so a concurrent append is
    never lost mid-rebuild."""
    with _buf_lock:
        before = len(_events)
        _events[:] = [e for e in _events
                      if e.trace is None or e.trace[0] != trace_id]
        return before - len(_events)


def dropped() -> int:
    """Events discarded because the buffer was at capacity."""
    return _dropped


def aggregate_report() -> Dict[str, Tuple[float, int]]:
    """{span name: (total seconds, call count)}."""
    return {k: (_totals[k], _counts.get(k, 0)) for k in _totals}


def reset_aggregates() -> None:
    """Clear the aggregate stopwatch totals ONLY — buffered events and
    the drop counter survive, so clearing phase totals between phases
    cannot truncate the flight recorder's events."""
    _totals.clear()
    _counts.clear()


def reset() -> None:
    """Clear the event buffer, the flight ring, the drop counter and the
    aggregates."""
    global _dropped
    _events.clear()
    _ring.clear()
    _dropped = 0
    reset_aggregates()
