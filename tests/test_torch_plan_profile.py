"""The port's query profiler, EXPLAIN ANALYZE and statistics catalog
(``plan/profile.py``, ``obs/stats_catalog.py``) against the JAX
package's, the counterpart of the planner cases of
``tests/test_profile.py``.

The same numpy tables go to the reference on its 4-device CPU mesh
(``ctx4``) and to the port on ``MeshConfig(devices=["cpu"],
world_size=4)``.  Per-node row counts, the catalog's observed
cardinalities and selectivities, and the analyzed plan's node lines
(without their timings and shard skews: the packages place rows by
different hashes on the CPU) must agree.

The OpenMetrics cases render, parse and scrape the port's exposition and
hold it against the reference's (``obs/openmetrics.py``, cumulative
``le`` buckets, tenant and rank labels); ``trace_report`` reads the
port's plan profile and metrics, and the unchanged
``tools/fleet_status.py`` the port's coordinator's metrics verb.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from cylon_tpu import Table as RTable
from cylon_tpu.plan import col as rcol
from cylon_tpu.plan import lit as rlit
from cylon_tpu.plan import optimizer as roptimizer
from cylon_tpu_torch import (CylonContext, CylonError, MeshConfig, Table,
                             config, resilience)
from cylon_tpu_torch.obs import fleet as obs_fleet
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import openmetrics, stats_catalog
from cylon_tpu_torch.plan import PlanProfile, col, lit
from cylon_tpu_torch.plan import executor as plan_executor
from cylon_tpu_torch.plan import optimizer as plan_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


@pytest.fixture(scope="module")
def mesh4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def _raw(rng, n=400, nkeys=24):
    d = {"k": rng.integers(0, nkeys, n).astype(np.int32),
         "v": rng.random(n).astype(np.float32),
         "w": rng.random(n).astype(np.float32)}
    d2 = {"k2": rng.integers(0, nkeys, n).astype(np.int32),
          "u": rng.random(n).astype(np.float32)}
    return d, d2


def _tables(T, ctx, raw):
    return tuple(T.from_numpy(list(d), list(d.values()), ctx=ctx)
                 for d in raw)


def _q(t, t2, c=col, l=lit):
    return (t.plan().filter(c("v") > l(0.2))
            .join(t2.plan(), left_on="k", right_on="k2")
            .groupby(["k"], {"u": ["sum"]}))


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def _rows_by_kind(prof):
    """{(nid, kind): rows} of every recorded node."""
    return {(p.nid, p.node.kind): prof.nodes[p.nid]["rows"]
            for p in _walk(prof.phys.root) if p.nid in prof.nodes}


def test_plan_guard_epoch_resume_does_not_dump(mesh4, tmp_path):
    """A pass_guard raising EpochMismatch (an elastic resume) or
    Cancelled (a caller's cancel) leaves no plan_fatal dump."""
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(41)))
    for code in (plan_executor.Code.EpochMismatch,
                 plan_executor.Code.Cancelled):
        def guard():
            raise CylonError(code, "membership moved / cancelled")

        with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
            with pytest.raises(CylonError):
                plan_executor.execute(_q(t, t2), pass_guard=guard)
    flight = os.path.join(str(tmp_path), "flight")
    assert not (os.listdir(flight) if os.path.isdir(flight) else [])


def test_profile_actuals_join_groupby(ctx4, mesh4, tmp_path):
    raw = _raw(np.random.default_rng(7))
    d = raw[0]
    t, t2 = _tables(Table, mesh4, raw)
    rt, rt2 = _tables(RTable, ctx4, raw)
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        _, prof = _q(t, t2).profile()
        _, rprof = _q(rt, rt2, rcol, rlit).profile()
    # the same nodes recorded with the same row counts as the reference
    assert _rows_by_kind(prof) == _rows_by_kind(rprof)
    recs = prof.nodes
    byk = {p.nid: p for p in _walk(prof.phys.root)}
    scans = [n for n, p in byk.items() if p.node.kind == "scan"
             and n in recs]
    assert len(scans) == 2
    for nid in scans:
        assert recs[nid]["rows"] == 400 == sum(recs[nid]["shard_rows"])
    filt = [n for n, p in byk.items() if p.node.kind == "filter"
            and n in recs]
    assert recs[filt[0]]["rows"] == int((d["v"] > np.float32(0.2)).sum())
    joins = [n for n, p in byk.items() if p.node.kind == "join"
             and n in recs]
    assert len(joins) == 1 and recs[joins[0]].get("fused") is True
    root = prof.phys.root
    assert recs[root.nid]["self_metrics"].get("shuffle.bytes_sent", 0) > 0
    assert recs[root.nid].get("skew") is not None
    from cylon_tpu_torch.plan.profile import load_profile

    assert prof.artifact_path and os.path.exists(prof.artifact_path)
    assert os.path.basename(prof.artifact_path) == "plan_profile.r0.json"
    doc = load_profile(prof.artifact_path)
    assert doc["world"] == 4
    assert any(n["rows"] == 400 for n in doc["nodes"])


def test_profiled_run_bit_identical_to_unprofiled(mesh4, tmp_path):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(3)))
    plain = _q(t, t2).execute().to_pandas().sort_values("k")
    with config.knob_env(CYLON_TPU_PROFILE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        profiled = _q(t, t2).execute().to_pandas().sort_values("k")
    for c in plain.columns:
        np.testing.assert_array_equal(plain[c].to_numpy(),
                                      profiled[c].to_numpy())
    assert [f for f in os.listdir(tmp_path) if f.startswith("plan_profile")]


def test_profiler_off_writes_no_artifact(tmp_path):
    rng = np.random.default_rng(3)
    d = {"k": rng.integers(0, 8, 64).astype(np.int32),
         "v": rng.random(64).astype(np.float32)}
    t = Table.from_numpy(list(d), list(d.values()),
                         ctx=CylonContext.Init("cpu"))
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path),
                         CYLON_TPU_PROFILE=None):
        t.plan().filter(col("v") > lit(0.5)).execute()
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("plan_profile")]


_TIMING = re.compile(r" self=[0-9.]+ms| skew=[0-9.]+x@r[0-9]+|"
                     r"wall=[0-9.]+ms")


def test_explain_analyze_text(ctx4, mesh4, tmp_path):
    raw = _raw(np.random.default_rng(5))
    t, t2 = _tables(Table, mesh4, raw)
    rt, rt2 = _tables(RTable, ctx4, raw)
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        out = _q(t, t2).explain(analyze=True)
        ref = _q(rt, rt2, rcol, rlit).explain(analyze=True)
    assert "analyze: wall=" in out and "<- [rows=" in out
    assert "skew=" in out
    # node for node the reference's lines, timings and skews aside
    # (bytes_sent too: the reference's CPU exchange is the bucketed one;
    # and its jit-plan cache hits: the port traces nothing)
    strip = re.compile(r" bytes_sent=[0-9]+| plan_cache_hits=[0-9]+")
    assert strip.sub("", _TIMING.sub("", out)) == \
        strip.sub("", _TIMING.sub("", ref))
    assert "<- [" not in _q(t, t2).explain()


def test_profile_shared_scan_self_join(ctx4, mesh4, tmp_path):
    rng = np.random.default_rng(37)
    n = 320
    d = {"k": rng.integers(0, 16, n).astype(np.int32),
         "v": rng.random(n).astype(np.float32)}
    t = Table.from_numpy(list(d), list(d.values()), ctx=mesh4)
    rt = RTable.from_numpy(list(d), list(d.values()), ctx=ctx4)
    root = str(tmp_path / "stats")
    with config.knob_env(CYLON_TPU_STATS_DIR=root,
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        plan = t.plan().join(t.plan(), on="k")
        assert plan_optimizer.optimize(plan, enabled=True).root.ann.get(
            "shared")
        _, prof = plan.profile()
        scan_recs = [prof.nodes[p.nid] for p in _walk(prof.phys.root)
                     if p.node.kind == "scan" and p.nid in prof.nodes]
        assert scan_recs and scan_recs[0]["rows"] == n
        j = list(plan_optimizer.lookup_stats(plan)["joins"].values())
        assert j and j[0]["left_rows"] == j[0]["right_rows"] == n
        rplan = rt.plan().join(rt.plan(), on="k")
        rplan.profile()
        rj = list(roptimizer.lookup_stats(rplan)["joins"].values())
        assert j[0]["out_rows"] == rj[0]["out_rows"]
        assert j[0]["selectivity"] == rj[0]["selectivity"]


def test_profile_attaches_fleet_skew_ledger():
    """The coordinator's skew ledger rides the profile when the context
    runs under an elastic agent (stubbed); without one it is absent."""

    class _Agent:
        def status(self):
            return {"ok": True, "collectives": [
                {"collective": "elastic.pass", "epoch": 0,
                 "skew_ns": 2_000_000, "slowest_rank": 1}]}

    class _Ctx:
        def elastic_agent(self):
            return _Agent()

    prof = PlanProfile()
    prof.attach_fleet_skew(_Ctx())
    assert prof.fleet_skew and prof.fleet_skew[0]["slowest_rank"] == 1
    assert prof.as_dict()["fleet_skew"] == prof.fleet_skew
    p2 = PlanProfile()
    p2.attach_fleet_skew(CylonContext.Init("cpu"))  # the port's: no agent
    assert p2.fleet_skew is None


def test_stats_catalog_roundtrip_torn_tail_and_cap(tmp_path):
    root = str(tmp_path / "stats")
    with config.knob_env(CYLON_TPU_STATS_DIR=root,
                         CYLON_TPU_STATS_CAP="3"):
        stats_catalog.record("fp1", {"world": 2, "nodes": {}})
        stats_catalog.record("fp2", {"world": 4, "nodes": {}})
        assert stats_catalog.lookup("fp1") == {"world": 2, "nodes": {}}
        path = os.path.join(root, stats_catalog.STATS_FILE)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"v": 1, "key": "fp3", "stats": {"wor')
        assert stats_catalog.lookup("fp2") == {"world": 4, "nodes": {}}
        cat = stats_catalog.StatsCatalog.open(root)
        assert cat.torn and set(cat.entries) == {"fp1", "fp2"}
        for fp in ("fp3", "fp4", "fp5"):
            stats_catalog.record(fp, {"world": 1})
        assert set(stats_catalog.keys()) == {"fp3", "fp4", "fp5"}
        assert not stats_catalog.StatsCatalog.open(root).torn
        stats_catalog.record("fp3", {"world": 8})
        stats_catalog.record("fp6", {"world": 1})
        assert "fp3" in stats_catalog.keys()
        assert stats_catalog.lookup("fp3") == {"world": 8}
    # the file format is the reference's: its catalog reads the port's
    from cylon_tpu.obs import stats_catalog as rcat

    assert rcat.StatsCatalog.open(root).lookup("fp3") == {"world": 8}


def test_stats_catalog_disabled_is_noop(tmp_path):
    with config.knob_env(CYLON_TPU_STATS_DIR=None):
        assert not stats_catalog.enabled()
        assert stats_catalog.lookup("fp") is None
        stats_catalog.record("fp", {})
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           stats_catalog.STATS_FILE))


def test_profile_persists_stats_and_lookup(ctx4, mesh4, tmp_path):
    raw = _raw(np.random.default_rng(11))
    d = raw[0]
    t, t2 = _tables(Table, mesh4, raw)
    rt, rt2 = _tables(RTable, ctx4, raw)
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path / "stats"),
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        plan = _q(t, t2)
        _, prof = plan.profile()
        assert prof.fingerprint is not None
        st = plan_optimizer.lookup_stats(plan)
        assert st is not None and st["world"] == 4
        assert any(c["columns"].get("k", {}).get("nunique") == 24
                   for c in st["scans"].values())
        f = list(st["filters"].values())
        assert f[0]["out_rows"] == int((d["v"] > np.float32(0.2)).sum())
        j = list(st["joins"].values())
        assert j and j[0]["selectivity"] is not None
        out = plan.explain(analyze=True)
        assert "rows est=" in out and "estimates=catalog" in out
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path / "rstats"),
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        rplan = _q(rt, rt2, rcol, rlit)
        rplan.profile()
        rst = roptimizer.lookup_stats(rplan)
    # the observations are the reference's, node for node
    for part in ("scans", "filters", "joins"):
        assert st[part] == rst[part], part
    assert {k: v["rows"] for k, v in st["nodes"].items()} == \
        {k: v["rows"] for k, v in rst["nodes"].items()}


def test_stats_catalog_reloads_in_second_process(mesh4, tmp_path):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(13)))
    root = str(tmp_path / "stats")
    with config.knob_env(CYLON_TPU_STATS_DIR=root,
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        _, prof = _q(t, t2).profile()
    code = (
        "import json, sys\n"
        "from cylon_tpu_torch.obs import stats_catalog\n"
        "cat = stats_catalog.StatsCatalog.open(sys.argv[1])\n"
        "st = cat.lookup(sys.argv[2])\n"
        "assert st is not None, 'fingerprint missing'\n"
        "assert st['filters'] and st['joins'], st\n"
        "sel = list(st['filters'].values())[0]['selectivity']\n"
        "assert 0 < sel <= 1, sel\n"
        "print(json.dumps({'ok': True}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, root,
                          prof.fingerprint], capture_output=True, text=True,
                         env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip())["ok"] is True


def test_lookup_stats_advisory_bit_identity(mesh4, tmp_path):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(17)))
    base = _q(t, t2).execute().to_pandas().sort_values("k")
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path / "stats"),
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        _q(t, t2).profile()
        phys_with = plan_optimizer.optimize(_q(t, t2), enabled=True)
        got = _q(t, t2).execute().to_pandas().sort_values("k")
    phys_without = plan_optimizer.optimize(_q(t, t2), enabled=True)
    assert phys_with.shuffles_elided == phys_without.shuffles_elided
    assert phys_with.columns_pruned == phys_without.columns_pruned
    for c in base.columns:
        np.testing.assert_array_equal(base[c].to_numpy(),
                                      got[c].to_numpy())


def test_plan_fatal_produces_flight_dump(mesh4, tmp_path):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(23)))
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path),
                         CYLON_TPU_RETRY_MAX="0"):
        with resilience.fault_plan("shuffle+=unknown"):
            with pytest.raises((CylonError, resilience.InjectedFault)):
                _q(t, t2).execute()
    flight = os.path.join(str(tmp_path), "flight")
    dumps = [os.path.join(flight, f) for f in os.listdir(flight)]
    reasons = set()
    for p in dumps:
        doc = obs_fleet.load_flight(p)
        reasons.add(doc["reason"])
        reasons.update(e["reason"] for e in doc["terminal_events"])
    assert "plan_fatal" in reasons, reasons


def test_profile_cache_hit_path(ctx4, mesh4, tmp_path):
    """Under a durable dir the second profiled run of a plan is served
    from the journal, in both packages: ``plan_cache_hit`` False then
    True, and EXPLAIN ANALYZE says so."""
    from cylon_tpu import config as rconfig

    raw = _raw(np.random.default_rng(19))
    for T, ctx, c, l, cfg, root in (
            (Table, mesh4, col, lit, config, "port"),
            (RTable, ctx4, rcol, rlit, rconfig, "ref")):
        t, t2 = _tables(T, ctx, raw)
        with cfg.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / root / "j"),
                          CYLON_TPU_TRACE_DIR=str(tmp_path / root)):
            plan = _q(t, t2, c, l)
            _, p1 = plan.profile()
            assert p1.plan_cache_hit is False, root
            _, p2 = plan.profile()
            assert p2.plan_cache_hit is True, root
            assert "served from journal" in plan.explain(analyze=True)


# ---------------------------------------------------------------------------
# histogram le buckets, OpenMetrics render / parse / scrape
# ---------------------------------------------------------------------------


def test_hist_le_buckets_cumulative_and_merge():
    from cylon_tpu.obs import metrics as robs_metrics

    h, rh = obs_metrics._Hist(), robs_metrics._Hist()
    for v in (0.5, 1.0, 3.0, 70.0, 900.0, 1e6, 5e9):
        h.observe(v)
        rh.observe(v)
    d = h.as_dict()
    assert d == rh.as_dict()  # the reference's dict, key for key
    assert d["count"] == 7 and d["min"] == 0.5 and d["max"] == 5e9
    le = d["le"]
    assert le["1"] == 2
    assert le["5"] == 3
    assert le["100"] == 4
    assert le["1000"] == 5
    assert le["1000000"] == 6
    assert le["1000000000"] == 6
    assert le["+Inf"] == d["count"]
    vals = list(le.values())
    assert vals == sorted(vals), "cumulative buckets must be monotone"
    m = obs_fleet.merge_hist(d, d)
    assert m["count"] == 14
    assert m["le"]["1"] == 4 and m["le"]["+Inf"] == 14
    assert m["le"]["+Inf"] == m["count"]


def test_hist_le_merge_with_legacy_hist():
    legacy = {"count": 2, "sum": 3.0, "min": 1.0, "max": 2.0,
              "buckets": {"0": 2}}
    new = obs_metrics._Hist()
    new.observe(4.0)
    m = obs_fleet.merge_hist(legacy, new.as_dict())
    assert m["count"] == 3 and m["le"]["+Inf"] == 1


def test_openmetrics_render_matches_snapshot_and_parses():
    from cylon_tpu.obs import openmetrics as ropenmetrics

    snap = {"counters": {"shuffle.bytes_sent": 123,
                         "serve.admitted": 4},
            "gauges": {"elastic.epoch": 2.0},
            "histograms": {}}
    h = obs_metrics._Hist()
    for v in (3.0, 900.0):
        h.observe(v)
    snap["histograms"]["serve.run_ms[acme]"] = h.as_dict()
    text = openmetrics.render(snap)
    doc = openmetrics.parse(text)
    assert doc == ropenmetrics.parse(text)  # the two parsers agree
    c = doc["cylon_tpu_shuffle_bytes_sent_total"]
    assert c["type"] == "counter"
    assert c["samples"][0][2] == 123
    g = doc["cylon_tpu_elastic_epoch"]
    assert g["type"] == "gauge" and g["samples"][0][2] == 2
    hist = doc["cylon_tpu_serve_run_ms"]
    assert hist["type"] == "histogram"
    by_name = {}
    for sname, labels, value in hist["samples"]:
        assert labels.get("tenant") == "acme"
        by_name.setdefault(sname, []).append((labels, value))
    assert by_name["cylon_tpu_serve_run_ms_count"][0][1] == 2
    assert by_name["cylon_tpu_serve_run_ms_sum"][0][1] == 903.0
    inf = [v for lab, v in by_name["cylon_tpu_serve_run_ms_bucket"]
           if lab["le"] == "+Inf"]
    assert inf == [2]
    # sample for sample the reference's rendering (bar the identity gauge)
    strip = [ln for ln in text.splitlines() if "build_info" not in ln]
    rstrip = [ln for ln in ropenmetrics.render(snap).splitlines()
              if "build_info" not in ln]
    assert strip == rstrip


def test_openmetrics_parse_rejects_malformed():
    with pytest.raises(ValueError, match="EOF"):
        openmetrics.parse("# TYPE cylon_tpu_x counter\ncylon_tpu_x 1\n")
    with pytest.raises(ValueError, match="precedes"):
        openmetrics.parse("cylon_tpu_x 1\n# EOF\n")
    bad = ("# TYPE cylon_tpu_h histogram\n"
           'cylon_tpu_h_bucket{le="1"} 5\n'
           'cylon_tpu_h_bucket{le="+Inf"} 3\n'
           "cylon_tpu_h_sum 1\ncylon_tpu_h_count 3\n# EOF\n")
    with pytest.raises(ValueError, match="monotone"):
        openmetrics.parse(bad)


def test_openmetrics_hostile_tenant_roundtrip():
    h = obs_metrics._Hist()
    h.observe(3.0)
    for tenant in ('a}b', 'a"b', "a\nb", "a\\b"):
        snap = {"counters": {f"serve.shed[{tenant}]": 2}, "gauges": {},
                "histograms": {f"serve.run_ms[{tenant}]": h.as_dict()}}
        doc = openmetrics.parse(openmetrics.render(snap))
        _, labels, v = doc["cylon_tpu_serve_shed_total"]["samples"][0]
        assert labels["tenant"] == tenant and v == 2
        hs = doc["cylon_tpu_serve_run_ms"]["samples"]
        assert all(lab["tenant"] == tenant for _, lab, _ in hs)


def test_openmetrics_server_scrape():
    import urllib.error
    import urllib.request

    before = obs_metrics.counter_value("test.scrape_probe")
    obs_metrics.counter_add("test.scrape_probe", 11)
    srv = openmetrics.start_server(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5
        ).read().decode()
        doc = openmetrics.parse(body)
        samples = doc["cylon_tpu_test_scrape_probe_total"]["samples"]
        assert samples[0][2] == before + 11
        obs_metrics.counter_add("test.scrape_probe", 1)
        body2 = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=5
        ).read().decode()
        doc2 = openmetrics.parse(body2)
        assert doc2["cylon_tpu_test_scrape_probe_total"]["samples"][0][2] \
            == before + 12
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=5)
    finally:
        srv.close()


def test_openmetrics_knob_disabled_and_ensure(tmp_path):
    """Disabled by default; with ``CYLON_TPU_METRICS_PORT`` set the
    query service brings the knob-driven listener up once."""
    import socket
    import urllib.request

    from cylon_tpu_torch.serve import QueryService

    with config.knob_env(CYLON_TPU_METRICS_PORT=None):
        assert openmetrics.ensure_server() is None
    openmetrics.stop_server()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        with config.knob_env(CYLON_TPU_METRICS_PORT=str(port)):
            with QueryService(ctx=CylonContext.Init("cpu")):
                srv = openmetrics.ensure_server()
                assert srv is not None and srv.port == port
                assert openmetrics.ensure_server() is srv
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5
                ).read().decode()
        openmetrics.parse(body)
    finally:
        openmetrics.stop_server()


def test_render_fleet_rank_labels():
    snaps = {"0": {"counters": {"x.y": 1}},
             "1": {"counters": {"x.y": 2}},
             "coord": {"counters": {"x.y": 3}}}
    doc = openmetrics.parse(openmetrics.render_fleet(snaps))
    samples = doc["cylon_tpu_x_y_total"]["samples"]
    got = {lab["rank"]: v for _, lab, v in samples}
    assert got == {"0": 1, "1": 2, "coord": 3}


# ---------------------------------------------------------------------------
# trace_report over the port's artifacts; the serve path under the
# profiler knob
# ---------------------------------------------------------------------------


def _load_tool(name):
    import importlib.util

    p = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_port", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_report_plan_flag(mesh4, tmp_path, capsys):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(29)))
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        _, prof = _q(t, t2).profile()
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [], "otherData": {}}))
    tr = _load_tool("trace_report")
    rc = tr.main([str(trace), "--plan", prof.artifact_path])
    assert rc == 0
    out = capsys.readouterr().out
    assert "plan profile" in out
    assert "scan" in out and "groupby" in out
    rep = tr.report_dict(str(trace), None, 10, prof.artifact_path)
    assert rep["plan"]["kind"] == "cylon_tpu.plan_profile"
    assert any(n["rows"] == 400 for n in rep["plan"]["nodes"])
    with pytest.raises(ValueError, match="not a plan profile"):
        tr.load_plan_profile(str(trace))


def test_trace_report_compression_counters(tmp_path, capsys):
    """The port's own metrics export, read by trace_report."""
    from cylon_tpu_torch.obs import export as obs_export

    tr = _load_tool("trace_report")
    trace = tmp_path / "trace.r0.json"
    trace.write_text(json.dumps({"traceEvents": [], "otherData": {}}))
    saved = obs_metrics.snapshot()
    obs_metrics.reset()
    try:
        obs_metrics.counter_add("shuffle.bytes_sent", 1000)
        obs_metrics.counter_add("shuffle.bytes_saved", 4000)
        obs_metrics.gauge_set("shuffle.compress_ratio", 5.0)
        metrics_p = obs_export.export_metrics(
            path=str(tmp_path / "metrics.r0.json"))
    finally:
        obs_metrics.reset()
        for k, v in saved["counters"].items():
            obs_metrics.counter_add(k, v)
    rc = tr.main([str(trace), metrics_p])
    assert rc == 0
    out = capsys.readouterr().out
    assert "bytes saved (compression)" in out
    assert "4000" in out and "5.00x" in out
    rep = tr.report_dict(str(trace), metrics_p, 10)
    assert rep["counters"]["shuffle.bytes_saved"] == 4000
    assert rep["gauges"]["shuffle.compress_ratio"] == 5.0


def test_run_service_with_profiler_knob(mesh4, tmp_path):
    t, t2 = _tables(Table, mesh4, _raw(np.random.default_rng(31)))
    with config.knob_env(CYLON_TPU_PROFILE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        frame, stats = plan_executor.run_service(_q(t, t2))
    assert stats["rows"] == len(next(iter(frame.values())))
    assert [f for f in os.listdir(tmp_path)
            if f.startswith("plan_profile")]


# -- the coordinator's metrics verb and fleet_status ---------------------

def test_coordinator_metrics_verb_and_fleet_status(capsys):
    import time as time_mod

    from cylon_tpu_torch import elastic

    sys.path.insert(0, TOOLS)
    try:
        import fleet_status
    finally:
        sys.path.remove(TOOLS)

    obs_metrics.counter_add("test.fleet_probe", 5)
    c = elastic.Coordinator(2, heartbeat_timeout_s=5.0).start()
    a0 = elastic.Agent(c.address, 0, interval_s=0.05,
                       timeout_s=5.0).start()
    a1 = elastic.Agent(c.address, 1, interval_s=0.05,
                       timeout_s=5.0).start()
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        deadline = time_mod.monotonic() + 10.0
        st = {}
        while time_mod.monotonic() < deadline:
            # raw=True returns the per-rank snapshots (--json's shape);
            # the default reply carries ONLY the exposition text
            st = fleet_status.request(addr, {"cmd": "metrics",
                                             "raw": True})
            if {"0", "1"} <= set(st.get("ranks") or {}):
                break
            time_mod.sleep(0.05)
        assert {"0", "1", "coord"} <= set(st["ranks"]), list(st["ranks"])
        assert "openmetrics" not in st  # one representation per reply
        text_reply = fleet_status.request(addr, {"cmd": "metrics"})
        assert "ranks" not in text_reply
        doc = openmetrics.parse(text_reply["openmetrics"])
        samples = doc["cylon_tpu_test_fleet_probe_total"]["samples"]
        ranks = {lab["rank"] for _, lab, v in samples}
        assert {"0", "1"} <= ranks
        # CLI: --openmetrics prints the exposition text
        rc = fleet_status.main([addr, "--openmetrics"])
        assert rc == 0
        out = capsys.readouterr().out
        openmetrics.parse(out)
        # --max-reply-bytes degrade: a tiny cap warns instead of the
        # historical hard ConnectionError; a one-chunk reply still
        # parses (truncation only bites replies spanning reads)
        rc = fleet_status.main([addr, "--openmetrics",
                                "--max-reply-bytes", "64"])
        err = capsys.readouterr().err
        assert "WARNING" in err and "max-reply-bytes" in err
        # parseable one-chunk reply (rc 0, warned) vs a genuinely
        # truncated multi-read reply (rc 3 — distinct from rc 1
        # "unreachable": the coordinator DID answer)
        assert rc in (0, 3)
    finally:
        a0.leave()
        a1.leave()
        c.stop()


def test_metrics_pruned_with_dead_rank():
    import time as time_mod

    from cylon_tpu_torch import elastic
    from cylon_tpu_torch.net import control

    c = elastic.Coordinator(2, heartbeat_timeout_s=5.0).start()
    a0 = elastic.Agent(c.address, 0, interval_s=0.05,
                       timeout_s=5.0).start()
    a1 = elastic.Agent(c.address, 1, interval_s=0.05,
                       timeout_s=5.0).start()
    try:
        deadline = time_mod.monotonic() + 10.0
        while time_mod.monotonic() < deadline:
            resp = control.request(c.address,
                                   {"cmd": "metrics", "raw": True})
            if {"0", "1"} <= set(resp.get("ranks") or {}):
                break
            time_mod.sleep(0.05)
        a1.leave()  # clean death: rank 1's metrics must leave the view
        deadline = time_mod.monotonic() + 10.0
        while time_mod.monotonic() < deadline:
            resp = control.request(c.address,
                                   {"cmd": "metrics", "raw": True})
            if "1" not in (resp.get("ranks") or {}):
                break
            time_mod.sleep(0.05)
        assert "1" not in resp["ranks"], list(resp["ranks"])
        assert "0" in resp["ranks"]
    finally:
        a0.leave()
        c.stop()


def test_profile_waits_name_their_item():
    """Every case of test_profile.py is ported here under its own name:
    none waits."""
    import ast

    with open(os.path.join(REPO, "tests", "test_profile.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    ported = {n for n in globals() if n.startswith("test_")}
    assert names <= ported, names - ported
