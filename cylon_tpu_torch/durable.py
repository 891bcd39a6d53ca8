"""Pass deadlines and poison-pass quarantine for the out-of-core engine.

The part of ``cylon_tpu/durable.py`` the engine calls while the run
journal is off:

- **pass deadlines** (:func:`pass_deadline`): a watchdog thread armed per
  pass fires ``deadline.fired`` (obs instant + metric) the moment
  ``CYLON_TPU_PASS_DEADLINE_S`` elapses, and the overrun is classified
  `Code.Timeout`, which the streaming loop retries like any transient.
  The watchdog cannot preempt a wedged native call; it makes the hang
  visible and classified.
- **poison-pass quarantine** (:func:`quarantine_after`): a part failing
  the same way ``CYLON_TPU_QUARANTINE_AFTER`` consecutive times is
  isolated into the run report instead of wedging refinement.

The run journal itself (spill files, manifests, crash resume; the
``CYLON_TPU_DURABLE_DIR`` knob) is not ported: :func:`require_off`
raises `Code.NotImplemented` when the knob asks for it, rather than
silently running without the journal it names (ROADMAP.md, queue A item
10).  Host-side only.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from . import config
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .obs import tracectx
from .status import Code, CylonError

log = logging.getLogger("cylon_tpu_torch")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def durable_dir() -> str:
    """Journal root (``CYLON_TPU_DURABLE_DIR``); empty disables."""
    return str(config.knob("CYLON_TPU_DURABLE_DIR"))


def enabled() -> bool:
    return bool(durable_dir())


def require_off() -> None:
    """Raise `Code.NotImplemented` when ``CYLON_TPU_DURABLE_DIR`` asks for
    the run journal, which this package does not have."""
    if enabled():
        raise CylonError(
            Code.NotImplemented,
            f"CYLON_TPU_DURABLE_DIR={durable_dir()!r} asks for the durable "
            "run journal, which is not ported yet (ROADMAP.md queue A, "
            "item 10); unset it to run without journaling")


def deadline_s() -> float:
    """Per-pass wall-clock budget (``CYLON_TPU_PASS_DEADLINE_S``);
    0 (default) disables the watchdog."""
    return max(0.0, float(config.knob("CYLON_TPU_PASS_DEADLINE_S")))


def quarantine_after() -> int:
    """Consecutive same-code failures before a part is quarantined
    (``CYLON_TPU_QUARANTINE_AFTER``); 0 (default) disables."""
    return max(0, int(config.knob("CYLON_TPU_QUARANTINE_AFTER")))


# ---------------------------------------------------------------------------
# pass deadlines
# ---------------------------------------------------------------------------

class _NullDeadline:
    __slots__ = ()

    def __enter__(self) -> "_NullDeadline":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def raise_if_fired(self) -> None:
        return None

    def accept_late(self) -> None:
        return None


_NULL_DEADLINE = _NullDeadline()


class PassDeadline:
    """Watchdog for one pass: a timer thread fires ``deadline.fired``
    (obs instant + metric) the moment ``seconds`` elapses — real-time
    visibility even while the main thread is wedged in a native call —
    and :meth:`raise_if_fired` classifies the overrun as `Code.Timeout`,
    which the streaming loop retries like any transient.

    The raise is deliberately NOT in ``__exit__``: the caller decides
    between :meth:`raise_if_fired` (after journaling the late-but-correct
    frame, so the Timeout retry serves it from the journal instead of
    re-executing an identically-slow pass forever) and
    :meth:`accept_late` (no journal to serve the retry from — keep the
    completed frame, record the overrun, and move on; discarding it
    would condemn every consistently-slow pass to retry-until-fatal).
    Either way a late result is never lost work.  An exception already
    in flight wins over the deadline (its own classification is more
    specific than "late")."""

    def __init__(self, seconds: float, site: str):
        self.seconds = seconds
        self.site = site
        self.fired = threading.Event()
        self._timer: Optional[threading.Timer] = None
        self._trace: Optional[tracectx.TraceContext] = None

    def _fire(self) -> None:
        self.fired.set()
        with tracectx.activate(self._trace):
            obs_spans.instant("deadline.fired", site=self.site,
                              deadline_s=self.seconds)
        obs_metrics.counter_add("deadline.fired")
        log.warning("durable: pass deadline %.3fs exceeded at %s "
                    "(CYLON_TPU_PASS_DEADLINE_S)", self.seconds, self.site)

    def __enter__(self) -> "PassDeadline":
        # the request trace active on the ARMING thread, captured at
        # __enter__ (serve constructs the deadline BEFORE activating the
        # ticket's context): the watchdog fires on its own timer thread
        # (fresh contextvar state), so without this capture the terminal
        # `deadline.fired` instant could never be joined to the request
        # whose budget it killed
        self._trace = tracectx.current()
        self._timer = threading.Timer(self.seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        return False

    def raise_if_fired(self) -> None:
        """Classify a recorded overrun as `Code.Timeout` (call after the
        block — and after journaling any completed frame)."""
        if self.fired.is_set():
            raise CylonError(
                Code.Timeout,
                f"pass exceeded CYLON_TPU_PASS_DEADLINE_S="
                f"{self.seconds:g}s at {self.site}")

    def accept_late(self) -> None:
        """Keep a late-but-complete result: record the overrun (instant +
        metric) without raising — the path for work that is NOT journaled
        and would otherwise be discarded just to re-run identically."""
        if self.fired.is_set():
            obs_spans.instant("deadline.accepted_late", site=self.site,
                              deadline_s=self.seconds)
            obs_metrics.counter_add("deadline.accepted_late")
            log.warning("durable: pass exceeded its %.3fs deadline but "
                        "completed and is not journaled; keeping the late "
                        "result at %s", self.seconds, self.site)


def pass_deadline(site: str = "exec.pass"):
    """Armed :class:`PassDeadline` when ``CYLON_TPU_PASS_DEADLINE_S`` is
    set, else a shared no-op context (zero allocation on the hot path)."""
    s = deadline_s()
    if s <= 0:
        return _NULL_DEADLINE
    return PassDeadline(s, site)
