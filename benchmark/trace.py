"""Device time from a ``torch.profiler`` trace of a few whole queries.

The profiler's Chrome trace is read back as intervals.  A card is busy
where a kernel, a copy or a memset runs on it (the event's
``args.device``): the union of their intervals, so that work on two
streams at once counts once.  An idle gap is a stretch of the traced
window in which a card runs nothing; it is named by what the host was
doing at its middle: the innermost span of the program's own tracing
(``cylon_tpu_torch.obs.spans``, buffered under ``CYLON_TPU_TRACE=1``),
the innermost operator and the innermost CUDA runtime call.  Busy time
and idle gaps are each card's own, averaged over the cell's cards;
kernel and family times are summed over every card.  ``FAMILIES`` sorts
kernels by the names PyTorch, CUB and the program's hand kernels give
them."""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# kernel family -> substrings of the profiler's kernel names; the first
# family that matches wins, anything else is "other elementwise"
FAMILIES = (
    ("CUDA hash kernel (cuda/murmur3.cu)", ("hash_partition_kernel",)),
    ("CUDA scan kernels (cuda/scan.cu)", ("lookback_scan_kernel",
                                          "tile_scan_kernel",
                                          "fixup_kernel")),
    ("sorts", ("DeviceRadixSort", "DeviceSegmentedRadixSort", "radixSort",
               "RadixSort", "bitonicSort", "sortKeyValueInplace",
               "segmented_sort", "SegmentedSort", "warpMergeSort")),
    ("torch.bincount", ("kernelHistogram1D",)),
    ("gathers and scatters", ("gpu_index_kernel", "indexFunc",
                              "indexSelect", "scatter", "gather",
                              "take_kernel")),
    ("dtype copies (.to)", ("direct_copy_kernel",)),
    ("arange", ("arange_cuda_out",)),
    ("cat, fills, cumsum, memcpy, memset", (
        "CatArrayBatchedCopy", "FillFunctor", "DeviceScan",
        "fill_reverse_indices", "Memcpy", "Memset", "memcpy", "memset")),
)
OTHER = "other elementwise"
SORTS, GATHERS = "sorts", "gathers and scatters"

_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_OP_CATS = {"cpu_op", "user_annotation", "operator"}
_RUNTIME_CATS = {"cuda_runtime", "runtime", "cuda_driver"}
QUERY_MARK = "benchmark.query"
CLOCK_MARK = "benchmark.clock"


def family(name: str) -> str:
    return next((f for f, keys in FAMILIES if any(k in name for k in keys)),
                OTHER)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Summary:
    """One traced window, in seconds."""

    window_s: float
    busy_s: float
    queries: int
    kernels: Dict[str, float] = field(default_factory=dict)
    families: Dict[str, float] = field(default_factory=dict)
    idle: Dict[str, float] = field(default_factory=dict)

    def per_query_ms(self, fam: str) -> float:
        return 1e3 * self.families.get(fam, 0.0) / self.queries


class _Cover:
    """Host intervals of one kind, to find the innermost one that covers
    each of a rising sequence of points: the covering one that started
    last."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.next = 0
        self.active: List[Tuple[float, float, str]] = []

    def innermost(self, t: float) -> Optional[str]:
        while self.next < len(self.spans) and self.spans[self.next][0] <= t:
            self.active.append(self.spans[self.next])
            self.next += 1
        self.active = [s for s in self.active if s[1] >= t]
        return max(self.active)[2] if self.active else None


def reduce(events: List[dict], spans: List[Tuple[float, float, str]],
           queries: int, cards: int = 1) -> Summary:
    """A Summary of the Chrome-trace ``events`` over the queries'
    annotations; ``spans`` are the program's spans as (start us, end us,
    name) on the trace's clock.  ``cards`` is the number of cards the
    cell uses: a card with no device event counts as idle throughout."""
    marks = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == QUERY_MARK
             and e.get("cat", "").lower() == "user_annotation"]
    if not marks:
        return Summary(0.0, 0.0, queries)
    lo, hi = min(a for a, _ in marks), max(b for _, b in marks)
    device: Dict[int, List[Tuple[float, float]]] = {}
    kernels, families = {}, {}
    ops, runtime = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in _DEVICE_CATS:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            card = int((e.get("args") or {}).get("device", 0))
            device.setdefault(card, []).append((a, b))
            name = str(e.get("name", "?"))
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
            fam = family(name)
            families[fam] = families.get(fam, 0.0) + (b - a) * 1e-6
        elif cat in _OP_CATS and e.get("name") not in (QUERY_MARK,
                                                        CLOCK_MARK):
            ops.append((a, b, str(e.get("name"))))
        elif cat in _RUNTIME_CATS:
            runtime.append((a, b, str(e.get("name"))))
    per_card = [union(device[c]) for c in sorted(device)]
    per_card += [[]] * max(0, cards - len(per_card))
    idle: Dict[str, float] = {}
    for busy in per_card:
        covers = [_Cover(spans), _Cover(ops), _Cover(runtime)]
        prev = lo
        for a, b in busy + [(hi, hi)]:
            if a > prev:
                mid = (prev + a) / 2
                label = " / ".join(n for n in (c.innermost(mid)
                                               for c in covers) if n) \
                    or "host"
                idle[label] = idle.get(label, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)
    n = len(per_card)
    busy_s = sum(sum(b - a for a, b in busy) * 1e-6 for busy in per_card)
    return Summary((hi - lo) * 1e-6, busy_s / n, queries, kernels, families,
                   {k: v / n for k, v in idle.items()})


def profile(run_query: Callable[[], object], devices: list,
            min_seconds: float, min_queries: int) -> Summary:
    """Run whole queries under ``torch.profiler`` until both minimums are
    met, with the program's span events buffered, and reduce the trace.
    ``devices`` are the cell's; each query's annotation ends once every
    card has finished its work."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    from cylon_tpu_torch import config
    from cylon_tpu_torch.obs import spans as obs_spans

    cards = sorted({d for d in map(torch.device, devices)
                    if d.type == "cuda"}, key=str)
    activities = [ProfilerActivity.CPU]
    if cards:
        activities.append(ProfilerActivity.CUDA)
    obs_spans.reset()
    n = 0
    with config.knob_env(CYLON_TPU_TRACE="1"), \
            torch.profiler.profile(activities=activities) as prof:
        with record_function(CLOCK_MARK):
            mark_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        while n < min_queries or time.perf_counter() - t0 < min_seconds:
            with record_function(QUERY_MARK):
                run_query()
                for d in cards:
                    torch.cuda.synchronize(d)
            n += 1
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    clock = [e["ts"] for e in events if e.get("name") == CLOCK_MARK]
    spans = []
    if clock:
        offset = float(clock[0]) - mark_ns / 1e3
        main = threading.get_ident()
        spans = [(ev.ts / 1e3 + offset, (ev.ts + ev.dur) / 1e3 + offset,
                  ev.name) for ev in obs_spans.events()
                 if ev.ph == "X" and ev.tid == main]
    obs_spans.reset()
    return reduce(events, spans, n, max(1, len(cards)))
