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

- **content fingerprints** (:func:`run_fingerprint`, copied from
  ``cylon_tpu/durable.py:163-256``): op x spec x every input column's full
  content x the knobs that change results, the key the planner's
  ``LogicalPlan.fingerprint`` and the statistics catalog use.

The run journal itself (spill files, manifests, crash resume; the
``CYLON_TPU_DURABLE_DIR`` knob) is not ported: :func:`require_off`
raises `Code.NotImplemented` when the knob asks for it, rather than
silently running without the journal it names (ROADMAP.md, queue A item
10).  Host-side only.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

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


# ---------------------------------------------------------------------------
# content fingerprints (cylon_tpu/durable.py:163-256)
# ---------------------------------------------------------------------------

_OBJ_SLAB = 1 << 20   # object elements decoded per slab
_MIX_SLAB = 1 << 22   # u64 words mixed per vectorized slab (32 MB)


def _mix_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (uint64 wraparound arithmetic)."""
    x = np.asarray(x, np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _update_spec(h, obj) -> None:
    """Feed a canonical encoding of a primitive/tuple spec into ``h``,
    type-tagged so ("1",) and (1,) hash apart."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        h.update(f"<{type(obj).__name__}:{obj!r}>".encode())
        return
    if isinstance(obj, (tuple, list)):
        h.update(b"<seq[")
        for item in obj:
            _update_spec(h, item)
        h.update(b"]>")
        return
    raise CylonError(Code.Invalid,
                     f"unhashable fingerprint spec element {type(obj)}")


def _update_array(h, name: str, a: np.ndarray) -> None:
    """Fold one input column into the fingerprint with full content
    coverage: changing any element changes the fingerprint.  Fixed-width
    columns reduce through a position-mixed splitmix64 xor-fold in bounded
    slabs; object columns hash their decoded codepoints slab-wise, with a
    kind tag per element (None, str, bytes, other)."""
    a = np.asarray(a)
    h.update(f"|col:{name}:{a.dtype.str}:{a.shape}".encode())
    if a.size == 0:
        return
    flat = a.reshape(-1)
    if a.dtype.kind == "O":
        for lo in range(0, flat.size, _OBJ_SLAB):
            sl = flat[lo:lo + _OBJ_SLAB]
            tags = np.fromiter(
                (0 if x is None
                 else 1 if isinstance(x, (str, np.str_))
                 else 2 if isinstance(x, (bytes, np.bytes_))
                 else 3 for x in sl), np.uint8, count=len(sl))
            h.update(tags.tobytes())
            h.update(np.asarray(sl.astype("U")).tobytes())
        return
    b = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    n_words = -(-b.size // 8)
    acc = np.uint64(0)
    for lo in range(0, n_words, _MIX_SLAB):
        hi = min(lo + _MIX_SLAB, n_words)
        chunk = b[lo * 8:min(hi * 8, b.size)]
        if len(chunk) < (hi - lo) * 8:  # zero-pad the final partial word
            chunk = np.concatenate(
                [chunk, np.zeros((hi - lo) * 8 - len(chunk), np.uint8)])
        words = np.ascontiguousarray(chunk).view(np.uint64)
        pos = np.arange(lo, hi, dtype=np.uint64)
        acc = acc ^ np.uint64(np.bitwise_xor.reduce(
            _mix_u64(words ^ _mix_u64(pos))))
    h.update(int(acc).to_bytes(8, "little"))


def run_fingerprint(op: str, spec, frames: Sequence[Tuple[Sequence[str],
                                                          Dict]]) -> str:
    """Hex fingerprint of one run: op kind x op spec x every input
    column's content x the knobs that change results
    (``config.trace_cache_token``) x the opaque ``CYLON_TPU_FP_SALT``."""
    h = hashlib.sha256()
    h.update(f"cylon_tpu.durable.v1|{op}".encode())
    salt = config.knob("CYLON_TPU_FP_SALT")
    if salt:
        h.update(f"|salt:{salt}".encode())
    _update_spec(h, spec)
    _update_spec(h, [list(kv) for kv in config.trace_cache_token()])
    for names, arrs in frames:
        h.update(b"|frame")
        for name in names:
            _update_array(h, str(name), np.asarray(arrs[name]))
    return h.hexdigest()
