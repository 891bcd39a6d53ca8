"""The trace reduction: busy time is the union of device intervals, and
an idle gap is named by what the host was doing."""
from pytest import approx

from benchmark import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_union_and_idle_names():
    events = [
        ev(trace.QUERY_MARK, "user_annotation", 0, 100),
        # two streams overlap over [10, 20): counted once
        ev("void at::native::gpu_index_kernel<x>", "kernel", 0, 20),
        ev("cub::DeviceRadixSortOnesweepKernel", "kernel", 10, 20),
        ev("aten::nonzero", "cpu_op", 25, 50),
        ev("cudaStreamSynchronize", "cuda_runtime", 30, 40),
        ev("Memcpy DtoH", "gpu_memcpy", 70, 10),
    ]
    spans = [(0.0, 100.0, "join.gather"), (20.0, 85.0, "join.count")]
    s = trace.reduce(events, spans, queries=2)
    assert s.window_s == approx(100e-6)
    assert s.busy_s == approx(40e-6)  # [0, 30) and [70, 80)
    assert s.families[trace.SORTS] == approx(20e-6)
    assert s.per_query_ms(trace.GATHERS) == approx(1e3 * 20e-6 / 2)
    assert s.idle["join.count / aten::nonzero / cudaStreamSynchronize"] \
        == approx(40e-6)  # the gap [30, 70)
    assert s.idle["join.gather"] == approx(20e-6)  # the gap [80, 100)


def test_no_query_mark_reads_nothing():
    s = trace.reduce([ev("k", "kernel", 0, 5)], [], queries=1)
    assert s.busy_s == 0 and s.window_s == 0


def test_families():
    assert trace.family("void at::native::gpu_index_kernel<...>") == \
        trace.GATHERS
    assert trace.family("lookback_scan_kernel<int, 0>").startswith("CUDA scan")
    assert trace.family("vectorized_elementwise_kernel<...>") == trace.OTHER
