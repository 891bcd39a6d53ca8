"""Process-local metrics: counters, gauges and histograms.

A copy of ``cylon_tpu/obs/metrics.py``: the shuffle's accounting
(``shuffle.exchanges``, ``shuffle.collective_launches``,
``shuffle.bytes_sent``, ``shuffle.bytes_saved``, the
``shuffle.compress_ratio`` gauge, ``shuffle.broadcasts`` and the
``shuffle.bytes_per_exchange`` histogram), out-of-core refinements
(``oom.refinements``), transient retries (``retry.attempts``), parts run
(``exec.parts_run``), injected faults (``fault.injected``) and the device
memory watermark (``hbm.live_bytes``), and the serve layer's counters and
per-tenant latency histograms (``serve.*``), whose cumulative ``le``
buckets the OpenMetrics exposition renders.  Plain dict arithmetic on the
host; ``snapshot()`` is deterministic (keys sorted).  The watermark reads the
caching allocator (``torch.cuda.memory_allocated``) where the JAX package
sums ``jax.live_arrays``.
"""
from __future__ import annotations

import bisect
from typing import Dict, Optional

import torch

_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, "_Hist"] = {}

#: fixed cumulative-bucket boundaries (OpenMetrics ``le`` semantics), the
#: reference's (``cylon_tpu/obs/metrics.py:40``): a 1-2.5-5 ladder through
#: 1e6, decades beyond.  Fixed, so histograms of different processes or
#: runs merge by per-key addition (``fleet.merge_hist``) and render as
#: cumulative buckets without rebinning.
LE_BUCKETS: tuple = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                     5000, 10000, 25000, 50000, 100000, 250000, 500000,
                     1000000, 10000000, 100000000, 1000000000)


class _Hist:
    """count/sum/min/max and power-of-two bucket counts (bucket i holds
    [2**i, 2**(i+1)); values below 1 land in bucket 0).  ``as_dict`` also
    emits the CUMULATIVE ``le`` buckets (``LE_BUCKETS`` and "+Inf");
    per-boundary counts are kept non-cumulative and accumulated there."""

    __slots__ = ("count", "sum", "min", "max", "buckets", "le_counts")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: Dict[int, int] = {}
        # one slot per LE_BUCKETS boundary and the +Inf overflow slot
        self.le_counts = [0] * (len(LE_BUCKETS) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        b = max(0, int(v).bit_length() - 1) if v >= 1 else 0
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.le_counts[bisect.bisect_left(LE_BUCKETS, v)] += 1

    def le_dict(self) -> Dict[str, int]:
        """Cumulative {boundary: count of observations <= boundary}; keys
        are decimal strings plus "+Inf" (== count)."""
        out: Dict[str, int] = {}
        acc = 0
        for bound, n in zip(LE_BUCKETS, self.le_counts):
            acc += n
            out[str(bound)] = acc
        out["+Inf"] = acc + self.le_counts[-1]
        return out

    def as_dict(self) -> Dict[str, object]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "buckets": {str(k): self.buckets[k]
                            for k in sorted(self.buckets)},
                "le": self.le_dict()}


def counter_add(name: str, value: float = 1) -> None:
    _counters[name] = _counters.get(name, 0) + value


def counter_value(name: str) -> float:
    return _counters.get(name, 0)


def gauge_set(name: str, value: float) -> None:
    _gauges[name] = float(value)


def gauge_max(name: str, value: float) -> None:
    """Watermark gauge: keeps the maximum ever set."""
    v = float(value)
    cur = _gauges.get(name)
    if cur is None or v > cur:
        _gauges[name] = v


def hist_observe(name: str, value: float) -> None:
    h = _hists.get(name)
    if h is None:
        h = _hists[name] = _Hist()
    h.observe(value)


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
    """Deterministic flat snapshot: {"counters": {...}, "gauges": {...},
    "histograms": {...}} with every key level sorted."""
    return {
        "counters": {k: _counters[k] for k in sorted(_counters)},
        "gauges": {k: _gauges[k] for k in sorted(_gauges)},
        "histograms": {k: _hists[k].as_dict() for k in sorted(_hists)},
    }


def reset() -> None:
    _counters.clear()
    _gauges.clear()
    _hists.clear()
