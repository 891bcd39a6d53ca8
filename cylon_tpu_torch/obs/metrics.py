"""Process-local metrics: counters and gauges.

A copy of ``cylon_tpu/obs/metrics.py``: out-of-core refinements
(``oom.refinements``), transient retries (``retry.attempts``), parts run
(``exec.parts_run``), injected faults (``fault.injected``) and the device
memory watermark (``hbm.live_bytes``).  Plain dict arithmetic on the host;
``snapshot()`` is deterministic (keys sorted).  The watermark reads the
caching allocator (``torch.cuda.memory_allocated``) where the JAX package
sums ``jax.live_arrays``.
"""
from __future__ import annotations

from typing import Dict

import torch

_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}


def counter_add(name: str, value: float = 1) -> None:
    _counters[name] = _counters.get(name, 0) + value


def counter_value(name: str) -> float:
    return _counters.get(name, 0)


def gauge_max(name: str, value: float) -> None:
    """Watermark gauge: keeps the maximum ever set."""
    v = float(value)
    cur = _gauges.get(name)
    if cur is None or v > cur:
        _gauges[name] = v


def record_hbm_watermark(device=None) -> int:
    """Record the bytes the caching allocator holds in tensors on a CUDA
    ``device`` (``torch.cuda.memory_allocated``) into the
    ``hbm.live_bytes`` watermark gauge; returns the sampled total.  A CPU
    device (or None) records 0."""
    total = 0
    if device is not None and torch.device(device).type == "cuda":
        total = int(torch.cuda.memory_allocated(device))
    gauge_max("hbm.live_bytes", total)
    return total


def snapshot() -> Dict[str, object]:
    """Deterministic flat snapshot: {"counters": {...}, "gauges": {...}}
    with every key level sorted."""
    return {
        "counters": {k: _counters[k] for k in sorted(_counters)},
        "gauges": {k: _gauges[k] for k in sorted(_gauges)},
    }


def reset() -> None:
    _counters.clear()
    _gauges.clear()
