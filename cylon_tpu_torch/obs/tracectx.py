"""Causal trace identity: W3C-traceparent-style contexts.

The part of ``cylon_tpu/obs/tracectx.py`` the engine's spans and pass
deadlines read: a :class:`TraceContext` (trace_id, span_id,
parent_span_id, sampled) in a ``contextvars.ContextVar``, made active by
a caller with :func:`activate`.  Every ``obs.spans`` span entered while a
context is active becomes a CHILD span whose event carries the
(trace_id, span_id, parent_span_id) triple, and a pass deadline's
watchdog fires under the context that armed it.  The wire helpers
(:func:`attach_wire`, :func:`parse_or_none`) carry a context across the
control-plane verbs (``net/control.py``) as a W3C ``traceparent``.  The
ambient root, request minting and tail-based retention wait for the
serving layers (ROADMAP.md queue A, item 11).  Host-side stdlib only.
"""
from __future__ import annotations

import contextlib
import os
import re
from contextvars import ContextVar
from typing import Dict, NamedTuple, Optional, Tuple


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

class TraceContext(NamedTuple):
    """One causal position: which request (``trace_id``), which span
    within it (``span_id``), and which span caused it
    (``parent_span_id``).  ``sampled`` is the W3C sampled flag."""

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
    """Strict W3C ``traceparent`` parse (``cylon_tpu/obs/tracectx.py:96``).
    Raises ``ValueError`` on any malformation (wrong field widths,
    uppercase hex, version ``ff``, all-zero trace or span id, trailing
    garbage): a garbled header is rejected, never adopted as somebody's
    trace."""
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


# ---------------------------------------------------------------------------
# the ambient context
# ---------------------------------------------------------------------------

_current: "ContextVar[Optional[TraceContext]]" = ContextVar(
    "cylon_tpu_trace", default=None)


def current() -> Optional[TraceContext]:
    """The active context, else None."""
    return _current.get()


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
