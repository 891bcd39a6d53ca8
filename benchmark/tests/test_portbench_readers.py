"""The per-layer readers of the program's own spans and counters: the
host syncs per query, the device time of the join's count pass and of
the group-by, and the scan kernels' share of their bound at the path's
lengths.  Each reads nothing, and raises nothing, where the program
lacks what it reads."""
import time
from types import SimpleNamespace

import pytest

from benchmark import harness

from .conftest import SEED, TINY


def run_of(**kw):
    base = dict(queries=4, span_totals={}, trace=None,
                cell=SimpleNamespace(query=None))
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("name", ["host.syncs", "host.syncs.planned"])
def test_host_syncs_per_query(name):
    r = harness.reader(name)
    run = run_of(span_totals={"sync.join_count": (0.1, 4),
                              "sync.to_numpy": (0.2, 40),
                              "join.count": (1.0, 4)})
    assert r.read(run) == 11.0
    assert r.read(run_of(span_totals={"join.count": (1.0, 4)})) is None


@pytest.mark.parametrize("name,span", [
    ("join.count.device_ms", "join.count"),
    ("join.count.device_ms.planned", "join.count"),
    ("groupby.device_ms", "groupby")])
def test_device_ms_per_traced_query(monkeypatch, name, span):
    from cylon_tpu_torch.obs import spans

    seconds = [0.5]
    monkeypatch.setattr(spans, "device_report",
                        lambda: {span: (seconds[0], 3), "other": (9.0, 1)})
    r = harness.reader(name)
    run = run_of(trace=SimpleNamespace(queries=2))
    token = r.begin(run)
    seconds[0] = 0.9
    assert r.read(run, token) == pytest.approx(200.0)
    assert r.read(run_of(trace=SimpleNamespace(queries=2)),
                  r.begin(run)) is None  # nothing timed since
    monkeypatch.delattr(spans, "device_report")  # a program without it
    assert r.begin(run) is None and r.read(run, None) is None


def test_scan_path_roofline_counts_the_traced_queries_alone(monkeypatch):
    from cylon_tpu_torch.ops import scan

    monkeypatch.setitem(scan.BYTES, "scan_1d", 0)
    query = SimpleNamespace(
        run=lambda state: scan.BYTES.__setitem__(
            "scan_1d", scan.BYTES["scan_1d"] + state),
        answer=lambda result: "answered")
    r = harness.reader("cuda.scan_path_roofline")
    run = run_of(cell=SimpleNamespace(query=query))
    token = r.begin(run)
    run.cell.query.run(3.35e9)  # a traced query: 3.35 GB of scans
    scan.BYTES["scan_1d"] += 10 ** 12  # another reader's scans
    assert run.cell.query.answer(None) == "answered"
    run.trace = SimpleNamespace(
        families={"CUDA scan kernels (cuda/scan.cu)": 2e-3})
    assert r.read(run, token) == pytest.approx(50.0)
    assert run.cell.query is query  # unwrapped
    monkeypatch.delattr(scan, "BYTES")  # a program without the counter
    assert r.begin(run) is None and r.read(run, None) is None


def test_a_traced_cpu_run_reports_the_syncs():
    """The tiny hash-join cell on the CPU, traced: the syncs per query
    are two a hash round, one more for each build and probe of the count
    pass and of the gather, the join count's and the group count's; no
    device time is read on the CPU."""
    out = harness.run_cell("jg-hash-2p28", SEED, 0.2, True, "cpu",
                           time.perf_counter(), TINY["jg-hash-2p28"])
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"]
    assert m["host.syncs"] == 2 * m["hash_join.rounds"] + 4 + 2
    assert "join.count.device_ms" not in m and "groupby.device_ms" not in m
