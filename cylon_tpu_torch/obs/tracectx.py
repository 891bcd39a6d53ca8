"""Causal trace identity: W3C-traceparent-style contexts.

The part of ``cylon_tpu/obs/tracectx.py`` the engine's spans and pass
deadlines read: a :class:`TraceContext` (trace_id, span_id,
parent_span_id, sampled) in a ``contextvars.ContextVar``, made active by
a caller with :func:`activate`.  Every ``obs.spans`` span entered while a
context is active becomes a CHILD span whose event carries the
(trace_id, span_id, parent_span_id) triple, and a pass deadline's
watchdog fires under the context that armed it.  The ambient
``traceparent`` root, request minting, tail-based retention and the wire
helpers wait for the serving layers (ROADMAP.md queue A, item 11).
Host-side stdlib only.
"""
from __future__ import annotations

import contextlib
import os
from contextvars import ContextVar
from typing import NamedTuple, Optional, Tuple


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

    def triple(self) -> Tuple[str, str, Optional[str]]:
        return (self.trace_id, self.span_id, self.parent_span_id)


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

