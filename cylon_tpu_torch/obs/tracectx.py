"""Causal request tracing: W3C-traceparent-style context propagation.

A copy of ``cylon_tpu/obs/tracectx.py``:

- a :class:`TraceContext` (trace_id, span_id, parent_span_id, sampled)
  in a ``contextvars.ContextVar``, made active with :func:`activate`;
  every ``obs.spans`` span entered while a context is active becomes a
  CHILD span whose event carries the (trace_id, span_id, parent_span_id)
  triple, and a pass deadline's watchdog fires under the context that
  armed it;
- the W3C ``traceparent`` wire form, which clients of the serve layer
  may supply and the control-plane verbs carry (``net/control.py``);
- :func:`new_trace` mints a request's root (1-in-N head sampling by
  ``CYLON_TPU_TRACE_SAMPLE_N``), and ``CYLON_TPU_TRACEPARENT`` roots a
  whole process in a caller's trace when no request context is active;
- **tail-based retention**: with ``CYLON_TPU_TRACE_TAIL_MS`` > 0 a
  closing request (:func:`finish_request`) keeps its buffered events only
  if it was slow (above the knob, or above a rolling p99 estimate),
  failed, or head-sampled; the others' events are discarded at close
  (``trace.tail_dropped``).

Host-side stdlib only.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading
from contextvars import ContextVar
from typing import Dict, NamedTuple, Optional, Tuple

from .. import config
from . import metrics as metrics_mod


# ---------------------------------------------------------------------------
# knob accessors (registry rows in config.py::KNOBS)
# ---------------------------------------------------------------------------

def tail_threshold_ms() -> float:
    """``CYLON_TPU_TRACE_TAIL_MS``: latency above which a request's
    buffered events are kept; 0 disables tail retention (keep all)."""
    return max(0.0, float(config.knob("CYLON_TPU_TRACE_TAIL_MS")))


def head_sample_n() -> int:
    """``CYLON_TPU_TRACE_SAMPLE_N``: 1-in-N head sampling; 0 disables."""
    return max(0, int(config.knob("CYLON_TPU_TRACE_SAMPLE_N")))


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

class TraceContext(NamedTuple):
    """One causal position: which request (``trace_id``), which span
    within it (``span_id``), and which span caused it
    (``parent_span_id``).  ``sampled`` marks a head-sampled trace that
    survives tail retention regardless of latency."""

    trace_id: str                    # 32 lowercase hex chars
    span_id: str                     # 16 lowercase hex chars
    parent_span_id: Optional[str] = None
    sampled: bool = False

    def child(self) -> "TraceContext":
        """A fresh span under this one (same trace, new span_id)."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id,
                            self.sampled)

    def traceparent(self) -> str:
        """The W3C wire form."""
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def triple(self) -> Tuple[str, str, Optional[str]]:
        return (self.trace_id, self.span_id, self.parent_span_id)


_TRACEPARENT = re.compile(
    r"^(?P<ver>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})-"
    r"(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$")


def parse_traceparent(s: str) -> TraceContext:
    """Strict W3C ``traceparent`` parse.  Raises ``ValueError`` on any
    malformation (wrong field widths, uppercase hex, version ``ff``,
    all-zero trace or span id, trailing garbage) — a garbled header must
    be REJECTED, never silently adopted as somebody's trace."""
    if not isinstance(s, str):
        raise ValueError(f"traceparent must be a string, got {type(s)}")
    m = _TRACEPARENT.match(s)
    if m is None:
        raise ValueError(f"malformed traceparent {s!r} (want "
                         f"00-<32 hex>-<16 hex>-<2 hex>, lowercase)")
    if m.group("ver") == "ff":
        raise ValueError(f"traceparent {s!r}: version ff is forbidden")
    if m.group("trace") == "0" * 32:
        raise ValueError(f"traceparent {s!r}: all-zero trace id")
    if m.group("span") == "0" * 16:
        raise ValueError(f"traceparent {s!r}: all-zero span id")
    return TraceContext(m.group("trace"), m.group("span"), None,
                        bool(int(m.group("flags"), 16) & 1))


def parse_or_none(s) -> Optional[TraceContext]:
    """Lenient parse for wire paths where a bad header means "no trace",
    not an error (a control verb must never fail on a garbled label)."""
    if not isinstance(s, str) or not s:
        return None
    try:
        return parse_traceparent(s)
    except ValueError:
        return None


def _new_span_id() -> str:
    return os.urandom(8).hex()


_mint_lock = threading.Lock()
_minted = 0


def new_trace(sampled: Optional[bool] = None) -> TraceContext:
    """Mint a root context for one request.  ``sampled`` defaults to the
    1-in-N head-sampling decision (``CYLON_TPU_TRACE_SAMPLE_N``)."""
    if sampled is None:
        n = head_sample_n()
        if n > 0:
            global _minted
            with _mint_lock:
                sampled = _minted % n == 0
                _minted += 1
        else:
            sampled = False
    return TraceContext(os.urandom(16).hex(), _new_span_id(), None,
                        bool(sampled))


# ---------------------------------------------------------------------------
# the ambient context
# ---------------------------------------------------------------------------

_current: "ContextVar[Optional[TraceContext]]" = ContextVar(
    "cylon_tpu_trace", default=None)

# CYLON_TPU_TRACEPARENT fallback, cached per raw value: the knob roots a
# whole process in a caller's trace (deployment/CI hook) and is read on
# the span hot path, so the parse must not repeat per span
_ambient_cache: Tuple[Optional[str], Optional[TraceContext]] = (None, None)


def _ambient() -> Optional[TraceContext]:
    global _ambient_cache
    raw = str(config.knob("CYLON_TPU_TRACEPARENT"))
    if not raw:
        return None
    cached_raw, cached = _ambient_cache
    if cached_raw != raw:
        cached = parse_or_none(raw)
        _ambient_cache = (raw, cached)
    return cached


def current() -> Optional[TraceContext]:
    """The active context: the contextvar when set, else the
    ``CYLON_TPU_TRACEPARENT`` ambient root, else None."""
    ctx = _current.get()
    return ctx if ctx is not None else _ambient()


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make ``ctx`` the active context for the dynamic extent (a no-op
    passthrough when ``ctx`` is None, so call sites need no branching)."""
    if ctx is None:
        yield None
        return
    tok = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(tok)


def push_span():
    """Enter a child span of the active context (obs.spans calls this on
    span entry).  Returns ``(child_ctx, reset_token)`` or None when no
    context is active — the common case, kept to one contextvar read."""
    cur = current()
    if cur is None:
        return None
    child = cur.child()
    return child, _current.set(child)


def pop_span(token) -> None:
    _current.reset(token)


# ---------------------------------------------------------------------------
# tail-based retention
# ---------------------------------------------------------------------------

#: minimum closed-request observations before the rolling p99 estimate
#: may keep a request on its own (before that every request would read
#: as "above p99" and retention would keep everything)
P99_MIN_SAMPLES = 32

_tail_lock = threading.Lock()
_p99_ms: Optional[float] = None
_lat_samples = 0


def _observe_latency(ms: float) -> None:
    """Asymmetric EWMA approximating a rolling upper-tail latency: rises
    quickly toward outliers, decays slowly — a cheap stand-in for p99
    that needs no reservoir."""
    global _p99_ms, _lat_samples
    with _tail_lock:
        _lat_samples += 1
        if _p99_ms is None:
            _p99_ms = ms
        elif ms > _p99_ms:
            _p99_ms += 0.5 * (ms - _p99_ms)
        else:
            _p99_ms -= 0.01 * (_p99_ms - ms)


def p99_estimate_ms() -> Optional[float]:
    with _tail_lock:
        return _p99_ms


def tail_keep(ctx: TraceContext, duration_ms: float, *,
              failed: bool = False) -> bool:
    """The retention decision for one closing request.  Retention off
    (``CYLON_TPU_TRACE_TAIL_MS`` = 0) keeps everything; on, keep only
    slow / failed / head-sampled requests."""
    thr = tail_threshold_ms()
    if thr <= 0:
        return True
    with _tail_lock:
        p99, samples = _p99_ms, _lat_samples
    keep = (failed or ctx.sampled or duration_ms >= thr
            or (p99 is not None and samples >= P99_MIN_SAMPLES
                and duration_ms > p99))
    # only HEALTHY closes feed the estimator: sheds close at ~0 ms and a
    # shed storm would decay the p99 toward zero, after which every fast
    # request reads as "slow" and retention keeps everything — the exact
    # buffer flood the feature exists to prevent
    if not failed:
        _observe_latency(duration_ms)
    return keep


def finish_request(ctx: Optional[TraceContext], duration_ms: float, *,
                   failed: bool = False) -> bool:
    """Close one request's trace: decide retention, discard the trace's
    buffered events when it loses, and count the outcome
    (``trace.tail_kept`` / ``trace.tail_dropped`` — the scrapeable
    retention behavior).  Returns whether the events were kept.  Every
    terminal serve path calls this exactly once — completed, failed,
    cancelled, and shed requests all close their trace.  With retention
    OFF (the default) this is a pure no-op: the kept/dropped counters
    describe RETENTION decisions, so they stay zero until the knob is
    set ("no requests closed yet" and "retention disabled" both read as
    zeros; a missing counter is a broken deploy)."""
    if ctx is None or tail_threshold_ms() <= 0:
        return True
    if tail_keep(ctx, duration_ms, failed=failed):
        metrics_mod.counter_add("trace.tail_kept")
        return True
    from . import spans as spans_mod  # no cycle at call time

    discarded = spans_mod.discard_trace(ctx.trace_id)
    metrics_mod.counter_add("trace.tail_dropped")
    if discarded:
        metrics_mod.counter_add("trace.tail_events_discarded", discarded)
    return False


def reset() -> None:
    """Clear the retention estimator and sampling counter (tests)."""
    global _p99_ms, _lat_samples, _minted, _ambient_cache
    with _tail_lock:
        _p99_ms = None
        _lat_samples = 0
    with _mint_lock:
        _minted = 0
    _ambient_cache = (None, None)


# ---------------------------------------------------------------------------
# wire helpers (control-plane verbs)
# ---------------------------------------------------------------------------

def attach_wire(obj: Dict) -> Dict:
    """Return ``obj`` with the active context's ``traceparent`` attached
    (a copy; the original is never mutated).  No-op when no context is
    active or the caller already set one."""
    ctx = current()
    if ctx is None or "traceparent" in obj:
        return obj
    return dict(obj, traceparent=ctx.traceparent())
