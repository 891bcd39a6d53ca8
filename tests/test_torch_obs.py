"""The port's ``obs`` (spans, the event buffer and its cap, metrics, the
Chrome-trace export, ``tools/trace_report.py`` on its traces) against the
JAX package's on the same calls.

Twins of every test of ``tests/test_obs.py``: span nesting and
attributes, the buffer cap through ``CYLON_TPU_TRACE_BUFFER_CAP`` (drops
counted, never grown), the disabled mode's no-op singleton, the default
mode's aggregates, the ``utils`` timing shim, the
Perfetto round trip, per-rank export names, a deterministic metrics
snapshot, the device-memory watermark gauge, the shuffle's collective
launches, a distributed join's nested spans and the task shuffle's
exchange metrics.  The port's shuffle launch counts are the reference's:
13 per buffer and 1 packed on the 6-column frame (a distributed join:
26 and 2)."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cylon_tpu import config as rconfig
from cylon_tpu.obs import metrics as rmetrics
from cylon_tpu.obs import spans as rspans
from cylon_tpu_torch import CylonContext, MeshConfig, Table, config
from cylon_tpu_torch.obs import export as obs_export
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.obs import instant, span


@pytest.fixture()
def clean_obs():
    for mod in (obs_spans, obs_metrics, rspans, rmetrics):
        mod.reset()
    yield
    for mod in (obs_spans, obs_metrics, rspans, rmetrics):
        mod.reset()


@pytest.fixture(scope="module")
def pctx4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def _both(fn):
    """``fn(span, instant)`` with the port's and the reference's; both
    packages read the same knobs."""
    fn(span, instant)
    fn(rspans.span, rspans.instant)


def test_span_nesting_and_attrs(clean_obs):
    def body(span_, instant_):
        with span_("outer", table="t1") as s:
            with span_("inner"):
                pass
            s.set(rows=42)
        instant_("tick", kind="oom")

    with config.knob_env(CYLON_TPU_TRACE="1"):
        _both(body)
    for mod in (obs_spans, rspans):
        evs = mod.events()
        by_name = {e.name: e for e in evs}
        assert set(by_name) == {"outer", "inner", "tick"}
        outer, inner, tick = (by_name["outer"], by_name["inner"],
                              by_name["tick"])
        # children close first, so inner precedes outer in record order
        assert evs.index(inner) < evs.index(outer)
        assert inner.depth == outer.depth + 1
        assert outer.ts <= inner.ts
        assert inner.ts + inner.dur <= outer.ts + outer.dur
        assert outer.attrs == {"table": "t1", "rows": 42}
        assert tick.ph == "i" and tick.dur == 0
        assert tick.attrs == {"kind": "oom"}
        rep = mod.aggregate_report()
        assert rep["outer"][1] == 1 and rep["inner"][1] == 1


def test_buffer_cap_drops_and_counts(clean_obs, tmp_path):
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_BUFFER_CAP="4"):
        assert obs_spans.buffer_cap() == 4
        _both(lambda _, instant_: [instant_(f"e{i}") for i in range(10)])
    for mod in (obs_spans, rspans):
        assert len(mod.events()) == 4
        assert mod.dropped() == 6
    assert [e.name for e in obs_spans.events()] == ["e0", "e1", "e2", "e3"]
    # the drop counter rides the exports
    path = obs_export.export_trace(path=str(tmp_path / "cap.json"))
    assert obs_export.load_trace(path)["otherData"]["dropped_events"] == 6
    # the knob is read per record: a larger cap takes more, drops stay
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_BUFFER_CAP="5"):
        instant("e10")
        instant("e11")
    assert len(obs_spans.events()) == 5 and obs_spans.dropped() == 7
    with config.knob_env(CYLON_TPU_TRACE_BUFFER_CAP="0"):
        assert obs_spans.buffer_cap() == 1  # clamped, as the reference's
        assert rspans.buffer_cap() == 1
    assert obs_spans.buffer_cap() == rconfig.knob(
        "CYLON_TPU_TRACE_BUFFER_CAP") == 65536


def test_disabled_mode_is_alloc_free_noop(clean_obs):
    with config.knob_env(CYLON_TPU_TRACE="0"):
        s1 = span("x")
        s2 = span("y", attr=1)
        with s1:
            pass
        instant("z")
    # one process-wide singleton: nothing allocated, nothing recorded
    assert s1 is s2
    assert obs_spans.events() == ()
    assert obs_spans.ring_events() == ()
    assert obs_spans.aggregate_report() == {}
    assert s1.set(rows=1) is s1


def test_default_mode_aggregates_without_events(clean_obs):
    with config.knob_env(CYLON_TPU_TRACE=None):  # registry default: auto
        _both(lambda span_, _: span_("agg.only").__enter__().__exit__())
    for mod in (obs_spans, rspans):
        assert mod.events() == ()
        total, count = mod.aggregate_report()["agg.only"]
        assert count == 1 and total >= 0
    # the flight ring keeps it all the same (default 512 events)
    assert [e.name for e in obs_spans.ring_events()] == ["agg.only"]


def test_flight_ring_cap_knob(clean_obs):
    """``CYLON_TPU_FLIGHT_RING_CAP``: the ring keeps the newest N events
    in every enabled mode, and 0 turns the ring and the recorder off."""
    from cylon_tpu_torch.obs import fleet as obs_fleet

    with config.knob_env(CYLON_TPU_FLIGHT_RING_CAP="3"):
        for i in range(5):
            instant(f"r{i}")
        assert [e.name for e in obs_spans.ring_events()] == ["r2", "r3",
                                                              "r4"]
        assert obs_fleet.flight_enabled()
    with config.knob_env(CYLON_TPU_FLIGHT_RING_CAP="0"):
        obs_spans.reset()
        with span("off"):
            instant("off.tick")
        assert obs_spans.ring_events() == ()
        assert not obs_fleet.flight_enabled()
        assert obs_fleet.flight_record("unit_test") is None
        assert obs_spans.aggregate_report()["off"][1] == 1


def test_timing_shim_is_the_same_substrate(clean_obs):
    from cylon_tpu_torch.utils import span as shim_span
    from cylon_tpu_torch.utils import timing_report

    with shim_span("shimmed"):
        pass
    assert timing_report()["shimmed"][1] == 1
    assert obs_spans.aggregate_report()["shimmed"][1] == 1


def test_perfetto_schema_roundtrip(clean_obs, tmp_path):
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with span("phase.a", n=3):
            with span("phase.b"):
                pass
        instant("mark")
    p = obs_export.export_trace(path=str(tmp_path / "t.json"))
    doc = obs_export.load_trace(p)  # validates name/ph/ts/pid/tid (+dur)
    evs = doc["traceEvents"]
    assert len(evs) == 3
    complete = [e for e in evs if e["ph"] == "X"]
    insts = [e for e in evs if e["ph"] == "i"]
    assert {e["name"] for e in complete} == {"phase.a", "phase.b"}
    assert insts[0]["name"] == "mark" and insts[0]["s"] == "t"
    for e in complete:
        assert e["dur"] >= 0 and isinstance(e["ts"], float)
        assert e["args"]["depth"] in (0, 1)
    a = next(e for e in complete if e["name"] == "phase.a")
    assert a["args"]["n"] == 3
    # the reference's loader reads the port's export too
    from cylon_tpu.obs import export as rexport

    assert rexport.load_trace(p)["traceEvents"] == evs
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": []}))
    with pytest.raises(ValueError):
        obs_export.load_trace(str(bad))


def test_per_rank_export_naming(clean_obs, tmp_path):
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        instant("one")
        paths = [obs_export.export_trace(rank=r) for r in range(4)]
        mpaths = [obs_export.export_metrics(rank=r) for r in range(4)]
    assert len(set(paths)) == 4 and len(set(mpaths)) == 4
    for r, p in enumerate(paths):
        assert os.path.basename(p) == f"trace.r{r}.json"
        assert obs_export.load_trace(p)["traceEvents"][0]["pid"] == r
    for r, p in enumerate(mpaths):
        assert os.path.basename(p) == f"metrics.r{r}.json"
        assert obs_export.load_metrics(p)["rank"] == r
    # one process outside a group is rank 0
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        assert obs_export.export_trace().endswith("trace.r0.json")


def test_metrics_snapshot_deterministic(clean_obs):
    def record(mod, order):
        mod.reset()
        for name in order:
            mod.counter_add(name, 2)
        mod.gauge_max("g.w", 5)
        mod.gauge_max("g.w", 3)  # a watermark keeps the max
        mod.hist_observe("h.x", 10)
        mod.hist_observe("h.x", 3)
        return mod.snapshot()

    s1 = record(obs_metrics, ["b.two", "a.one", "c.three"])
    s2 = record(obs_metrics, ["c.three", "a.one", "b.two"])
    assert s1 == s2
    assert json.dumps(s1) == json.dumps(s2)
    assert list(s1["counters"]) == ["a.one", "b.two", "c.three"]
    assert s1["gauges"]["g.w"] == 5
    h = s1["histograms"]["h.x"]
    assert h["count"] == 2 and h["sum"] == 13 and h["min"] == 3
    assert h["max"] == 10
    assert s1 == record(rmetrics, ["b.two", "a.one", "c.three"])


def test_hbm_watermark_gauge(clean_obs, monkeypatch):
    """The gauge reads ``torch.cuda.memory_allocated`` of a card (the
    reference sums ``jax.live_arrays``); a CPU device records 0."""
    x = torch.zeros(1024, dtype=torch.float32)
    assert obs_metrics.record_hbm_watermark(x.device) == 0
    assert obs_metrics.snapshot()["gauges"]["hbm.live_bytes"] == 0
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 3 * x.nbytes)
    total = obs_metrics.record_hbm_watermark("cuda")
    assert total == 3 * x.nbytes >= x.nbytes
    assert obs_metrics.snapshot()["gauges"]["hbm.live_bytes"] == total
    assert obs_metrics.record_hbm_watermark("cpu") == 0
    assert obs_metrics.snapshot()["gauges"]["hbm.live_bytes"] == total


def _mixed_table(ctx, n=256):
    rng = np.random.default_rng(7)
    arrs = {
        "k32": rng.integers(0, 50, n).astype(np.int32),
        "v64": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "f64": rng.normal(size=n),
        "f32": rng.normal(size=n).astype(np.float32),
        "flag": (rng.integers(0, 2, n) == 1),
        "tag": np.array([f"s{i % 13:06d}" for i in range(n)]),
    }
    return Table.from_numpy(list(arrs), list(arrs.values()), ctx=ctx,
                            capacity=n)


@pytest.mark.parametrize("pack,launches", [("perbuf", 13), ("packed", 1)])
def test_shuffle_collective_launch_metric(pctx4, clean_obs, pack, launches):
    """One exchange's ``shuffle.collective_launches``: the reference's
    1 packed / 13 per buffer on the 6-column frame."""
    from cylon_tpu_torch.parallel import ops as par_ops

    t = _mixed_table(pctx4)
    with config.knob_env(CYLON_TPU_TRACE="1", CYLON_TPU_SHUFFLE_PACK=pack):
        out = par_ops.shuffle(t, (0,))
        assert out.row_count == t.row_count
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.exchanges"] == 1
    assert c["shuffle.collective_launches"] == launches
    assert c["shuffle.counts_gathers"] == 1
    assert c["shuffle.bytes_sent"] > 0
    names = {e.name for e in obs_spans.events()}
    assert {"shuffle.plan", "shuffle.exchange"} <= names


def test_distributed_join_trace_exports_nested_spans(pctx4, clean_obs,
                                                     tmp_path):
    t = _mixed_table(pctx4)
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        j = t.distributed_join(t, on="k32")
        assert j.row_count > 0
        tp, mp = obs_export.export_all(prefix="join")
    doc = obs_export.load_trace(tp)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"table.distributed_join", "shuffle.plan", "shuffle.exchange",
            "join.count", "join.gather"} <= names
    depth = {e["name"]: e["args"]["depth"] for e in doc["traceEvents"]
             if e["ph"] == "X"}
    assert depth["shuffle.exchange"] > depth["table.distributed_join"]
    m = obs_export.load_metrics(mp)
    assert m["counters"]["shuffle.exchanges"] == 2
    assert m["counters"]["shuffle.collective_launches"] in (2, 26)


def test_task_shuffle_records_exchange_metrics(pctx4, clean_obs):
    from cylon_tpu_torch.parallel.task import LogicalTaskPlan, task_shuffle

    rng = np.random.default_rng(42)
    plan = LogicalTaskPlan({0: 3, 1: 1}, world_size=4)
    tables = [Table.from_pydict(
        {"a": rng.integers(0, 100, 40).astype(np.int64),
         "b": rng.random(40)}, ctx=pctx4) for _ in range(2)]
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK="perbuf"):
        task_shuffle(tables, [0, 1], plan)
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.exchanges"] == 1
    # a + b + the int64 __task__ routing column: 3 data + 3 validity
    assert c["shuffle.collective_launches"] == 6
    assert c["shuffle.bytes_sent"] > 0


def test_trace_report_tool(clean_obs, tmp_path, capsys):
    """``tools/trace_report.py``, loaded by file, on a trace and metrics
    the port exported."""
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with span("work.outer"):
            with span("work.inner"):
                pass
        instant("retry", site="s")
    obs_metrics.counter_add("shuffle.collective_launches", 13)
    tp = obs_export.export_trace(path=str(tmp_path / "trace.r0.json"))
    mp = obs_export.export_metrics(path=str(tmp_path / "metrics.r0.json"))
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(os.path.dirname(__file__), "..",
                                     "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.print_report(tp, mp, top=5)
    out = capsys.readouterr().out
    assert "work.outer" in out and "work.inner" in out
    assert "retry" in out
    assert "collective launches" in out and "13" in out
    doc = obs_export.load_trace(tp)
    st = mod.self_times(doc["traceEvents"])
    _, outer_total, outer_self = st["work.outer"]
    _, inner_total, _ = st["work.inner"]
    assert outer_self <= outer_total - inner_total + 1e-6
    assert mod.self_times(doc["traceEvents"]) == st
