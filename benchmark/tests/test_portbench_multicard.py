"""The harness's path for a cell of several cards, on the CPU: the quota
of four-card cells in ``BENCHMARK.json``, the rows of a table held as one
shard a card, each card's own busy time in the trace, and a throwaway
multi-card cell run end to end."""
import time

import pytest
import torch
from pytest import approx

from benchmark import harness, trace

from . import multicard, test_portbench_spec
from .conftest import SEED


def _workload(i: int, chips: int) -> dict:
    return {"name": f"cell-{i}", "config": "join-groupby-2p28",
            "traffic": f"traffic-{i}", "chips": chips, "why": "synthetic"}


@pytest.mark.parametrize("chips,allowed", [
    ([1, 1, 1, 1], True),
    ([1, 1, 1, 4], True),
    ([1, 1, 1, 1, 4], True),            # one of five
    ([4], True),
    ([1] * 6 + [4, 4], True),           # 8 // 4 = 2
    ([1, 1, 1, 2], False),
    ([1, 1, 1, 3], False),
    ([1, 1, 1, 8], False),
    ([1, 1, 4, 4], False),              # a second among four
    ([1, 1, 1, 4, 4], False),           # a second among five
    ([1] * 6 + [4, 4, 4], False),
])
def test_four_card_quota(monkeypatch, chips, allowed):
    s = harness.spec()
    s["workloads"] = [_workload(i, c) for i, c in enumerate(chips)]
    monkeypatch.setattr(test_portbench_spec, "spec", lambda: s)
    if allowed:
        test_portbench_spec.test_names_units_and_keys()
    else:
        with pytest.raises(AssertionError):
            test_portbench_spec.test_names_units_and_keys()


@pytest.mark.parametrize("column,want", [
    (torch.zeros(7), 7),
    ((torch.zeros(5, 4, dtype=torch.uint8), torch.zeros(5)), 5),
    ([torch.zeros(3), torch.zeros(4), torch.zeros(0), torch.zeros(9)], 16),
    ([(torch.zeros(2, 4, dtype=torch.uint8), torch.zeros(2)),
      (torch.zeros(6, 4, dtype=torch.uint8), torch.zeros(6))], 8),
])
def test_rows_of_a_column(column, want):
    inputs = {"a": {"k": column, "v": None}, "b": {"k": torch.zeros(10)}}
    assert harness.rows(inputs, ("a",)) == want
    assert harness.rows(inputs, ("a", "b")) == want + 10


def ev(name, cat, ts, dur, device=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if device is not None:
        e["args"] = {"device": device, "stream": 7}
    return e


@pytest.mark.parametrize("cards,busy_us", [(1, 500), (2, 500), (4, 250)])
def test_busy_is_each_cards_own_averaged(cards, busy_us):
    """Card 0 runs 90% of the window and card 1 10%: their union would
    read 90% busy.  A card that ran nothing counts as idle throughout;
    ``cards`` under the cards seen counts those seen."""
    events = [
        ev(trace.QUERY_MARK, "user_annotation", 0, 1000),
        ev("void at::native::gpu_index_kernel<x>", "kernel", 0, 900, 0),
        ev("void at::native::gpu_index_kernel<x>", "kernel", 0, 100, 1),
        ev("aten::nonzero", "cpu_op", 0, 1000),
    ]
    s = trace.reduce(events, [(0.0, 1000.0, "join.count")], queries=1,
                     cards=cards)
    assert s.window_s == approx(1e-3)
    assert s.busy_s == approx(busy_us * 1e-6)
    assert s.families[trace.GATHERS] == approx(1e-3)  # summed over cards
    assert s.kernels == {"void at::native::gpu_index_kernel<x>": approx(1e-3)}
    assert s.idle == {"join.count / aten::nonzero":
                      approx((1000 - busy_us) * 1e-6)}


def _one_card_events():
    """A one-card trace: kernels with and without ``args.device``, events
    clipped at both marks' ends, host spans, operators, runtime calls."""
    return [
        ev(trace.QUERY_MARK, "user_annotation", 100, 400),
        ev(trace.QUERY_MARK, "user_annotation", 520, 300),
        ev(trace.CLOCK_MARK, "user_annotation", 90, 1),
        ev("void at::native::gpu_index_kernel<x>", "kernel", 80, 60, 0),
        ev("cub::DeviceRadixSortOnesweepKernel", "kernel", 120, 90, 0),
        ev("lookback_scan_kernel<int, 0>", "kernel", 260, 40),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 330, 15, 0),
        ev("Memset (Device)", "gpu_memset", 600, 5, 0),
        ev("vectorized_elementwise_kernel<4>", "kernel", 640, 120, 0),
        ev("direct_copy_kernel_cuda", "kernel", 700, 30, 0),
        ev("void at::native::gpu_index_kernel<x>", "kernel", 800, 50, 0),
        ev("aten::nonzero", "cpu_op", 210, 140),
        ev("aten::index", "cpu_op", 350, 200),
        ev("cudaStreamSynchronize", "cuda_runtime", 220, 100),
        ev("cudaLaunchKernel", "cuda_runtime", 560, 10),
        ev("aten::add", "cpu_op", 30, 20),
        ev("Memcpy HtoD", "gpu_memcpy", 900, 10, 0),
    ]


# trace.reduce's Summary of _one_card_events() before the per-card busy
# time (the reduction that took the union over every device interval)
BEFORE = trace.Summary(
    window_s=0.0007199999999999999, busy_s=0.00031, queries=2,
    kernels={"void at::native::gpu_index_kernel<x>": 5.9999999999999995e-05,
             "cub::DeviceRadixSortOnesweepKernel": 8.999999999999999e-05,
             "lookback_scan_kernel<int, 0>": 3.9999999999999996e-05,
             "Memcpy DtoH (Device -> Pinned)": 1.4999999999999999e-05,
             "Memset (Device)": 4.9999999999999996e-06,
             "vectorized_elementwise_kernel<4>": 0.00011999999999999999,
             "direct_copy_kernel_cuda": 2.9999999999999997e-05},
    families={"gathers and scatters": 5.9999999999999995e-05,
              "sorts": 8.999999999999999e-05,
              "CUDA scan kernels (cuda/scan.cu)": 3.9999999999999996e-05,
              "cat, fills, cumsum, memcpy, memset": 1.9999999999999998e-05,
              "other elementwise": 0.00011999999999999999,
              "dtype copies (.to)": 2.9999999999999997e-05},
    idle={"sync.join_count / aten::nonzero / cudaStreamSynchronize":
          7.999999999999999e-05,
          "join.count / aten::index": 0.00025499999999999996,
          "groupby": 7.5e-05})


@pytest.mark.parametrize("field", ["window_s", "busy_s", "queries",
                                   "kernels", "families", "idle"])
def test_one_card_trace_reads_as_before(field):
    spans = [(100.0, 500.0, "join.count"),
             (200.0, 340.0, "sync.join_count"), (520.0, 820.0, "groupby")]
    s = trace.reduce(_one_card_events(), spans, queries=2)
    assert getattr(s, field) == getattr(BEFORE, field)


@pytest.mark.parametrize("chips", [1, 4])
def test_a_multi_card_cell_runs_through_the_harness(monkeypatch, chips):
    """On the CPU a cell of ``chips`` runs on ``"cpu"`` once a card: its
    data and query files get the device itself for one card, the list
    for more, and the rows of every shard count."""
    name = multicard.install(monkeypatch, chips)
    out = harness.run_cell(name, SEED, 0.2, False, "cpu",
                           time.perf_counter(), chips=chips)
    assert out["correct"], out["checks"]
    want = "cpu" if chips == 1 else ["cpu"] * chips
    assert multicard.seen == {"generate": want, "prepare": want}
    assert out["device"]["count"] == chips
    assert ("memory_peak_bytes_per_card" in out["device"]) == (chips > 1)
    assert out["metrics"]["rows_per_s"]["value"] > 0
    rows = multicard.CONFIG["rows_per_card"] * chips * (chips + 1) // 2
    assert harness.rows(multicard.generate(multicard.CONFIG, SEED,
                                           ["cpu"] * chips), ("t",)) == rows
