"""The port's fleet observability (cylon_tpu_torch/obs/fleet.py read by
the unchanged tools/trace_merge.py, critical_path.py and
fleet_status.py), the counterpart of ``tests/test_obs_fleet.py``: clock
alignment, cross-rank trace merge, straggler/skew attribution, the
failure flight recorder, and the coordinator status endpoint, on CPU
contexts.

The acceptance-criterion path: a 3-process elastic gang with one member
carrying a seeded delay exports per-rank traces that ``trace_merge``
combines into ONE schema-valid Perfetto timeline on the coordinator
clock — monotone, ordered consistently with the run's barrier semantics
— with the straggler named in the per-collective skew table.  Flight
dumps appear on classified terminal events WITHOUT ``CYLON_TPU_TRACE=1``
ever having been set.
"""
import glob
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cylon_tpu_torch import CylonContext, config, elastic, resilience
from cylon_tpu_torch.exec import chunked_join
from cylon_tpu_torch.net import control
from cylon_tpu_torch.obs import export as obs_export
from cylon_tpu_torch.obs import fleet as obs_fleet
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = CylonContext.Init("cpu")

HB = dict(interval_s=0.05, timeout_s=0.5)
HB_TIMEOUT = 0.4


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def clean_fleet():
    obs_fleet.reset()
    obs_spans.reset()
    obs_metrics.reset()
    yield
    obs_fleet.reset()
    obs_spans.reset()
    obs_metrics.reset()


def _wait(cond, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

def test_measure_offset_recovers_a_known_clock_shift(clean_fleet):
    """The NTP-style handshake against a fake peer whose clock runs a
    known amount ahead recovers that offset to well within the reported
    uncertainty."""
    shift_ns = 123_000_000  # peer clock = local + 123ms

    def fake_rpc(obj):
        assert obj["cmd"] == "clock"
        t = time.perf_counter_ns() + shift_ns
        return {"ok": True, "t_recv": t, "t_send": t}

    info = obs_fleet.measure_offset(fake_rpc, ref="fake:0", rounds=8)
    assert abs(info.offset_ns - shift_ns) <= max(info.uncertainty_ns,
                                                 2_000_000)
    assert 0 < info.uncertainty_ns < 50_000_000
    assert info.rtt_ns >= 0 and info.ref == "fake:0"
    with pytest.raises(ValueError):
        obs_fleet.measure_offset(lambda o: {"ok": False}, rounds=1)


def test_agent_syncs_clock_and_status_reports_it(clean_fleet):
    """Joining agents measure offsets against the coordinator and the
    ``status`` verb exposes per-rank clocks + heartbeat ages + the
    initial (empty) serve aggregation."""
    c = elastic.Coordinator(2, heartbeat_timeout_s=HB_TIMEOUT).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agents = [elastic.Agent(addr, r, **HB).start() for r in range(2)]
    try:
        agents[0].wait_formed()
        for a in agents:
            assert a.clock is not None
            # same host, same clock domain: the offset is bounded by the
            # RTT scale, nowhere near a cross-host epoch difference
            assert abs(a.clock.offset_ns) < 100_000_000
            assert a.clock.uncertainty_ns > 0
        # the export-side identity follows the FIRST agent (rank 0)
        assert obs_fleet.current_rank() == 0
        assert obs_fleet.clock() is not None
        # a heartbeat carries the clock to the coordinator
        _wait(lambda: len(control.request(
            c.address, {"cmd": "status"}).get("ranks", {})) == 2,
            msg="status ranks")
        _wait(lambda: all(
            r.get("clock") for r in control.request(
                c.address, {"cmd": "status"})["ranks"].values()),
            msg="clocks on status")
        st = control.request(c.address, {"cmd": "status"})
        assert st["members"] == [0, 1] and st["epoch"] == 0
        for r in ("0", "1"):
            row = st["ranks"][r]
            assert row["hb_age_s"] >= 0
            assert row["clock"]["uncertainty_ns"] > 0
        assert st["serve"] == {"queue_depth": 0, "tenants": {}}
        assert st["collectives"] == []
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_barrier_records_arrivals_and_coordinator_skew(clean_fleet):
    """A delayed rank shows up as the slowest participant of the
    completed rendezvous: the coordinator's skew ledger (measured on its
    OWN clock — no alignment uncertainty) names it, and the
    ``collective.skew_ns`` histogram observes the spread."""
    c = elastic.Coordinator(2, heartbeat_timeout_s=2.0).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agents = [elastic.Agent(addr, r, **HB).start() for r in range(2)]
    try:
        agents[0].wait_formed()
        out = []

        def late():
            time.sleep(0.3)
            out.append(agents[1].barrier("x", 0))

        t = threading.Thread(target=late)
        t.start()
        agents[0].barrier("x", 0)
        t.join(5)
        assert out
        st = control.request(c.address, {"cmd": "status"})
        [row] = st["collectives"]
        assert row["collective"] == "x" and row["epoch"] == 0
        assert row["slowest_rank"] == 1
        assert row["skew_ns"] > 200_000_000  # the 0.3s seeded delay
        assert row["arrivals_ns"]["0"] == 0
        assert row["arrivals_ns"]["1"] == row["skew_ns"]
        h = obs_metrics.snapshot()["histograms"]["collective.skew_ns"]
        assert h["count"] == 1 and h["max"] == row["skew_ns"]
        # both ranks recorded arrive/depart instants in their ring even
        # though CYLON_TPU_TRACE=1 was never set
        names = [e.name for e in obs_spans.ring_events()]
        assert "collective.arrive" in names
        assert "collective.depart" in names
    finally:
        for a in agents:
            a.stop()
        c.stop()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_and_dump_without_trace_armed(clean_fleet, tmp_path):
    """Aggregate (default) mode buffers nothing for export — but the
    flight ring still holds the recent events, and a dump is loadable
    with events + metrics, never having set CYLON_TPU_TRACE=1."""
    with config.knob_env(CYLON_TPU_TRACE=None,
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        with obs_spans.span("work.phase", n=1):
            pass
        obs_spans.instant("work.tick", k="v")
        obs_metrics.counter_add("work.counter", 3)
        assert obs_spans.events() == ()  # nothing buffered for export
        ring = obs_spans.ring_events()
        assert {e.name for e in ring} == {"work.phase", "work.tick"}
        obs_fleet.set_rank(2)
        obs_fleet.set_run_id("runX")
        path = obs_fleet.flight_record("unit_test", probe=7)
    assert path is not None and os.path.basename(path) == "runX.r2.json"
    doc = obs_fleet.load_flight(path)
    assert doc["reason"] == "unit_test" and doc["rank"] == 2
    assert doc["attrs"] == {"probe": 7}
    assert {e["name"] for e in doc["traceEvents"]} >= {"work.phase",
                                                       "work.tick"}
    assert doc["metrics"]["counters"]["work.counter"] == 3
    assert doc["aggregates"]["work.phase"][1] == 1
    # the ring's size is CYLON_TPU_FLIGHT_RING_CAP (512 by default)
    assert obs_spans._ring.maxlen == obs_spans.ring_cap() == 512
    # corrupt dumps do not load silently
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "other"}))
    with pytest.raises(ValueError):
        obs_fleet.load_flight(str(bad))


@pytest.mark.fault
def test_quarantine_leaves_flight_dump(clean_fleet, tmp_path):
    """A poison-pass quarantine — a classified terminal event — dumps
    the flight recorder with tracing never armed."""
    rng = np.random.default_rng(3)
    n = 400
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path),
                         CYLON_TPU_QUARANTINE_AFTER="1",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("pass_dispatch@1+=comm"):
            _, stats = chunked_join(left, right, on="k", passes=2,
                                    mode="hash", ctx=CPU)
    assert stats["quarantined"]
    dumps = glob.glob(str(tmp_path / "flight" / "*.json"))
    assert dumps, "quarantine left no flight dump"
    doc = obs_fleet.load_flight(dumps[0])
    reasons = {r["reason"] for r in doc["terminal_events"]}
    assert "quarantine" in reasons
    assert doc["metrics"]["counters"]["quarantine.parts"] >= 1


def test_serve_shed_leaves_flight_dump(clean_fleet, tmp_path):
    """An admission shed dumps the flight recorder (the serve-side
    classified terminal event) — again without CYLON_TPU_TRACE=1."""
    from cylon_tpu_torch.serve import QueryService
    from cylon_tpu_torch.status import Code, CylonError

    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        svc = QueryService(ctx=CPU, queue_cap=1)
        try:
            svc.drain(timeout=5.0)
            with pytest.raises(CylonError) as ei:
                svc.submit("flighty", "join", {"k": np.arange(4)},
                           {"k": np.arange(4)}, on="k", passes=1,
                           mode="hash")
            assert ei.value.code == Code.Unavailable
        finally:
            svc.close()
    dumps = glob.glob(str(tmp_path / "flight" / "*.json"))
    assert dumps
    doc = obs_fleet.load_flight(dumps[0])
    assert doc["reason"] == "shed"
    assert doc["attrs"]["tenant"] == "flighty"


# ---------------------------------------------------------------------------
# export identity: elastic rank + run-id namespacing (the collision fix)
# ---------------------------------------------------------------------------

def test_export_names_by_fleet_rank_and_run_id(clean_fleet, tmp_path):
    """Two elastic agents on one host used to BOTH write trace.r0.json
    (a context's process rank is 0 on every one-process context): the
    fleet identity wins now, and a run id namespaces back-to-back runs
    sharing one trace dir."""
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path)):
        obs_spans.instant("mark")
        assert os.path.basename(obs_export.export_trace()) == "trace.r0.json"
        obs_fleet.set_rank(3)   # the elastic agent's join registration
        p = obs_export.export_trace()
        assert os.path.basename(p) == "trace.r3.json"
        assert obs_export.load_trace(p)["otherData"]["rank"] == 3
        obs_fleet.set_run_id("runA")
        pa = obs_export.export_trace()
        ma = obs_export.export_metrics()
        obs_fleet.set_run_id("runB")
        pb = obs_export.export_trace()
        assert os.path.basename(pa) == "trace.runA.r3.json"
        assert os.path.basename(ma) == "metrics.runA.r3.json"
        assert os.path.basename(pb) == "trace.runB.r3.json"
        assert obs_export.load_trace(pb)["otherData"]["run_id"] == "runB"
        # the knob is the env-driven spelling of the same namespace
        obs_fleet.reset()
        obs_fleet.set_rank(1)
        with config.knob_env(CYLON_TPU_RUN_ID="envrun"):
            pe = obs_export.export_trace()
        assert os.path.basename(pe) == "trace.envrun.r1.json"
    # first-wins: a second in-process agent must not steal the naming
    obs_fleet.reset()
    obs_fleet.set_rank(0)
    obs_fleet.set_rank(2)
    assert obs_fleet.current_rank() == 0


# ---------------------------------------------------------------------------
# trace_merge: alignment, refusal, skew attribution (synthetic traces)
# ---------------------------------------------------------------------------

def _fake_trace(path, rank, events, *, offset_ns=0, unc_ns=1000,
                ref="coord:1", clock=True, dropped=0, run_id="fake"):
    doc = {
        "traceEvents": events,
        "otherData": {
            "producer": "cylon_tpu_torch.obs", "rank": rank, "run_id": run_id,
            "dropped_events": dropped,
            "clock": ({"offset_ns": offset_ns, "uncertainty_ns": unc_ns,
                       "rtt_ns": 2 * unc_ns, "ref": ref,
                       "measured_unix": 0.0} if clock else None),
        },
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return str(path)


def _ev(name, ts, ph="X", dur=10.0, pid=0, **args):
    e = {"name": name, "cat": "cylon_tpu", "ph": ph, "ts": ts, "pid": pid,
         "tid": 1, "args": {"depth": 0, **args}}
    if ph == "X":
        e["dur"] = dur
    else:
        e["s"] = "t"
    return e


def test_trace_merge_aligns_clocks_and_attributes_skew(tmp_path):
    tm = _load_tool("trace_merge")
    # rank 0: coordinator-aligned already (offset 0); arrives at the
    # collective at t=2000us.  rank 1: local clock 1.5s BEHIND the
    # coordinator (offset +1.5e9 ns); arrives at local t=600us =>
    # aligned 1_500_600us — the straggler by ~1.4986s.
    p0 = _fake_trace(tmp_path / "t.r0.json", 0, [
        _ev("exec.pass", 1000.0, pid=0),
        _ev("collective.arrive", 2000.0, ph="i", pid=0,
            collective="done", epoch=0, rank=0),
    ])
    p1 = _fake_trace(tmp_path / "t.r1.json", 1, [
        _ev("exec.pass", 100.0, pid=1),
        _ev("collective.arrive", 600.0, ph="i", pid=1,
            collective="done", epoch=0, rank=1),
    ], offset_ns=1_500_000_000)
    merged, warnings = tm.merge([p0, p1])
    tm.validate_merged(merged)
    assert merged["otherData"]["ranks"] == [0, 1]
    assert merged["otherData"]["aligned"] is True
    # rank 1's events moved onto the coordinator clock
    evs = [e for e in merged["traceEvents"] if e["ph"] != "M"]
    r1_pass = next(e for e in evs if e["name"] == "exec.pass"
                   and e["pid"] == 1)
    assert r1_pass["ts"] == pytest.approx(100.0 + 1_500_000.0)
    # monotone on the aligned clock
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    [row] = tm.collective_skew(merged["traceEvents"])
    assert row["collective"] == "done" and row["slowest_rank"] == 1
    assert row["skew_us"] == pytest.approx(1_500_600.0 - 2000.0)
    assert row["wait_us"]["0"] == pytest.approx(row["skew_us"])
    assert row["wait_us"]["1"] == 0.0


def test_trace_merge_refuses_uncertain_or_unaligned_clocks(tmp_path):
    tm = _load_tool("trace_merge")
    p0 = _fake_trace(tmp_path / "a.r0.json", 0, [_ev("x", 1.0)])
    # uncertainty 50ms >> the 5ms default resolution
    p1 = _fake_trace(tmp_path / "a.r1.json", 1, [_ev("x", 2.0)],
                     unc_ns=50_000_000)
    with pytest.raises(tm.MergeError) as ei:
        tm.merge([p0, p1])
    assert "uncertainty" in str(ei.value)
    # force merges anyway — surfaced as a warning AND the output marked
    # unaligned, so consumers asserting on the flag reject the noise
    merged, warnings = tm.merge([p0, p1], force=True)
    assert any("uncertainty" in w for w in warnings)
    assert merged["otherData"]["aligned"] is False
    # a rank with NO clock block refuses too (elastic never ran there)
    p2 = _fake_trace(tmp_path / "b.r0.json", 0, [_ev("x", 1.0)])
    p3 = _fake_trace(tmp_path / "b.r1.json", 1, [_ev("x", 2.0)],
                     clock=False)
    with pytest.raises(tm.MergeError):
        tm.merge([p2, p3])
    # ...but a single trace merges without one
    merged, _ = tm.merge([p3])
    tm.validate_merged(merged)
    # different reference clocks are not comparable
    p4 = _fake_trace(tmp_path / "c.r1.json", 1, [_ev("x", 2.0)],
                     ref="other:9")
    with pytest.raises(tm.MergeError) as ei:
        tm.merge([p2, p4])
    assert "reference" in str(ei.value).lower()
    # duplicate ranks are an input error, not a silent overwrite
    with pytest.raises(tm.MergeError):
        tm.merge([p2, _fake_trace(tmp_path / "d.r0.json", 0,
                                  [_ev("y", 3.0)])])


def test_trace_merge_run_id_selects_one_run(tmp_path):
    """Back-to-back runs sharing one trace dir produce rank collisions
    across run ids: the error points at --run-id, and run_id= selects
    exactly one run's traces."""
    tm = _load_tool("trace_merge")
    pa = _fake_trace(tmp_path / "trace.run1.r0.json", 0,
                     [_ev("x", 1.0)], run_id="run1")
    pb = _fake_trace(tmp_path / "trace.run2.r0.json", 0,
                     [_ev("y", 2.0)], run_id="run2")
    with pytest.raises(tm.MergeError) as ei:
        tm.merge([pa, pb])
    assert "--run-id" in str(ei.value)
    merged, _ = tm.merge([pa, pb], run_id="run1")
    names = {e["name"] for e in merged["traceEvents"] if e["ph"] != "M"}
    assert names == {"x"}
    assert merged["otherData"]["run_id"] == "run1"
    with pytest.raises(tm.MergeError):
        tm.merge([pa, pb], run_id="run3")


def test_trace_merge_warns_loudly_on_dropped_events(tmp_path, capsys):
    tm = _load_tool("trace_merge")
    p0 = _fake_trace(tmp_path / "w.r0.json", 0, [_ev("x", 1.0)], dropped=7)
    merged, warnings = tm.merge([p0])
    assert any("DROPPED 7" in w for w in warnings)
    assert merged["otherData"]["dropped_events"] == 7
    # the CLI surfaces it on stderr
    rc = tm.main([p0, "-o", str(tmp_path / "m.json")])
    assert rc == 0
    assert "DROPPED 7" in capsys.readouterr().err


def test_trace_report_json_reports_dropped_skew_and_slo(tmp_path, capsys):
    tr = _load_tool("trace_report")
    p = _fake_trace(tmp_path / "trace.r0.json", 0, [
        _ev("work.outer", 0.0, dur=100.0),
        _ev("work.inner", 10.0, dur=40.0),
        _ev("collective.arrive", 50.0, ph="i", pid=0, collective="b",
            epoch=0, rank=0),
        _ev("collective.arrive", 80.0, ph="i", pid=1, collective="b",
            epoch=0, rank=1),
    ], dropped=5)
    mp = tmp_path / "metrics.r0.json"
    mp.write_text(json.dumps({
        "counters": {"serve.completed": 3},
        "gauges": {},
        "histograms": {
            "serve.queue_wait_ms[tA]": {"count": 2, "sum": 30.0,
                                        "min": 10.0, "max": 20.0,
                                        "buckets": {"3": 1, "4": 1}},
            "serve.run_ms[tA]": {"count": 2, "sum": 200.0, "min": 80.0,
                                 "max": 120.0, "buckets": {"6": 2}},
        }}))
    rc = tr.main([str(p), str(mp), "--json"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "DROPPED 5" in cap.err  # the loud truncation warning
    rep = json.loads(cap.out)
    assert rep["dropped_events"] == 5
    assert rep["totals"]["spans"] == 2
    [skew] = rep["skew"]
    assert skew["collective"] == "b" and skew["slowest_rank"] == 1
    assert skew["skew_us"] == pytest.approx(30.0)
    assert rep["slo"]["tA"]["queue_wait_ms"]["count"] == 2
    assert rep["slo"]["tA"]["run_ms"]["mean_ms"] == pytest.approx(100.0)
    assert rep["counters"]["serve.completed"] == 3
    # self-time attribution holds in the JSON form too
    outer = next(r for r in rep["self_times"] if r["span"] == "work.outer")
    assert outer["self_ms"] == pytest.approx(0.06)  # 100us - 40us child


# ---------------------------------------------------------------------------
# the coordinator status endpoint with a run in flight
# ---------------------------------------------------------------------------

def test_status_endpoint_aggregates_serve_telemetry(clean_fleet,
                                                    monkeypatch):
    """While a request runs and another queues, the coordinator's
    ``status`` verb shows membership, clocks, queue depth and the
    per-tenant SLO histograms carried by heartbeat telemetry."""
    from cylon_tpu_torch.serve import QueryService
    from cylon_tpu_torch.serve import service as service_mod

    started = threading.Event()
    release = threading.Event()
    orig = service_mod._RUNNERS["join"]

    def runner(*args, **kwargs):
        started.set()
        assert release.wait(60), "blocked runner never released"
        return orig(*args, **kwargs)

    monkeypatch.setitem(service_mod._RUNNERS, "join", runner)
    rng = np.random.default_rng(5)
    n = 300
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}

    c = elastic.Coordinator(1, heartbeat_timeout_s=2.0).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agent = elastic.Agent(addr, 0, **HB).start()
    svc = QueryService(ctx=CPU, queue_cap=4)
    agent.attach_telemetry(svc.telemetry)
    try:
        t1 = svc.submit("fleet-tA", "join", left, right, on="k",
                        passes=1, mode="hash")
        assert started.wait(60)
        t2 = svc.submit("fleet-tB", "join", left, right, on="k",
                        passes=1, mode="hash")

        def serving_visible():
            st = control.request(c.address, {"cmd": "status"})
            tenants = st["serve"]["tenants"]
            return (st["serve"]["queue_depth"] == 1
                    and "fleet-tA" in tenants
                    and tenants["fleet-tA"].get("queue_wait_ms",
                                                {}).get("count", 0) >= 1)

        _wait(serving_visible, timeout=10.0, msg="telemetry on status")
        st = control.request(c.address, {"cmd": "status"})
        assert st["members"] == [0]
        assert st["ranks"]["0"]["clock"] is not None
        release.set()
        t1.result(timeout=60)
        t2.result(timeout=60)

        def served_visible():
            tenants = control.request(
                c.address, {"cmd": "status"})["serve"]["tenants"]
            return (tenants.get("fleet-tA", {}).get("served") == 1
                    and tenants.get("fleet-tB", {}).get(
                        "run_ms", {}).get("count", 0) >= 1)

        _wait(served_visible, timeout=10.0, msg="served counts on status")
        # the rendering tool parses the same payload
        fs = _load_tool("fleet_status")
        text = fs.render(control.request(c.address, {"cmd": "status"}))
        assert "fleet-tA" in text and "queue wait" in text
    finally:
        release.set()
        svc.close()
        agent.stop()
        c.stop()


# ---------------------------------------------------------------------------
# the 3-process acceptance test: merged timeline + seeded straggler
# ---------------------------------------------------------------------------

def _worker_env(tmp_path, trace_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CYLON_TPU_FAULT_PLAN", "CYLON_TPU_DURABLE_DIR",
                        "CYLON_TPU_TRACE", "CYLON_TPU_TRACE_DIR",
                        "CYLON_TPU_FAULT_DELAY_S")}
    env["CYLON_TPU_DURABLE_DIR"] = str(tmp_path / "journal")
    env["CYLON_TPU_HEARTBEAT_S"] = "0.1"
    # nothing in this test exercises failure detection, and under full-
    # suite CPU contention a worker's heartbeat thread can starve for
    # several seconds behind torch's import — the timeout must be
    # far above any such stall or the gang reaps itself
    env["CYLON_TPU_HEARTBEAT_TIMEOUT_S"] = "60"
    env["CYLON_TPU_TRACE"] = "1"
    env["CYLON_TPU_TRACE_DIR"] = str(trace_dir)
    return env


@pytest.mark.fault
def test_three_process_gang_merged_trace_attributes_straggler(tmp_path):
    """3 OS processes, rank 1 carrying a seeded ``delay`` fault at every
    pass boundary: each rank exports a clock-aligned trace, trace_merge
    combines them into one monotone Perfetto timeline, and the skew
    table of the run's final rendezvous names rank 1 as the slowest
    participant with (at least) the seeded delay's worth of skew."""
    trace_dir = tmp_path / "traces"
    coord = elastic.Coordinator(3, heartbeat_timeout_s=60.0).start()
    try:
        addr = f"{coord.address[0]}:{coord.address[1]}"
        env = {r: _worker_env(tmp_path, trace_dir) for r in range(3)}
        # rank 1 sleeps 3s at EVERY pass boundary of its 2-part slice:
        # ~6s late at the final barrier, far above start-up noise
        env[1]["CYLON_TPU_FAULT_PLAN"] = "elastic.pass.r1@1+=delay"
        env[1]["CYLON_TPU_FAULT_DELAY_S"] = "3.0"
        procs = []
        for r in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_elastic_worker", str(r), "3",
                 addr, str(tmp_path / f"out_r{r}.npz"),
                 str(tmp_path / f"stats_r{r}.json")],
                cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, env=env[r]))
        outs = [b""] * 3
        try:
            for i, p in enumerate(procs):
                outs[i], _ = p.communicate(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r in range(3):
            assert procs[r].returncode == 0, (
                r, outs[r].decode(errors="replace")[-3000:])
        # the coordinator saw the straggler too, on its own clock
        done = [s for s in coord._skews
                if s["collective"].startswith("cylon-elastic-done/seed7/")
                and not s["collective"].endswith("/start")]
        assert done and done[-1]["slowest_rank"] == 1
        assert done[-1]["skew_ns"] > 2_000_000_000
    finally:
        coord.stop()

    paths = sorted(glob.glob(str(trace_dir / "trace.seed7.r*.json")))
    assert len(paths) == 3, sorted(os.listdir(trace_dir))
    for p in paths:  # every rank aligned itself before exporting
        other = json.load(open(p))["otherData"]
        assert other["clock"] is not None, p
        assert other["run_id"] == "seed7"

    tm = _load_tool("trace_merge")
    merged, warnings = tm.merge(paths, max_uncertainty_us=20_000.0)
    tm.validate_merged(merged)  # schema + monotone aligned timeline
    assert merged["otherData"]["ranks"] == [0, 1, 2]
    assert merged["otherData"]["aligned"] is True
    assert not any("DROPPED" in w for w in warnings), warnings

    rows = tm.collective_skew(merged["traceEvents"])
    done_rows = [r for r in rows
                 if r["collective"].startswith("cylon-elastic-done/seed7/")
                 and not r["collective"].endswith("/start")
                 and len(r["ranks"]) == 3]
    assert done_rows, rows
    row = done_rows[-1]
    assert row["slowest_rank"] == 1
    assert row["skew_us"] > 2_000_000  # >= ~6s seeded, 2s assertion floor
    assert row["wait_us"]["1"] == 0.0
    assert min(row["wait_us"]["0"], row["wait_us"]["2"]) > 2_000_000

    # cross-rank ordering consistent with barrier semantics: nobody
    # DEPARTS the rendezvous before the slowest rank ARRIVED (modulo the
    # offset uncertainty, which is microseconds against a >2s skew)
    evs = merged["traceEvents"]
    name = row["collective"]
    arrives = [e for e in evs if e["name"] == "collective.arrive"
               and e["args"].get("collective") == name]
    departs = [e for e in evs if e["name"] == "collective.depart"
               and e["args"].get("collective") == name]
    assert len(arrives) == 3 and len(departs) == 3
    last_arrival = max(e["ts"] for e in arrives)
    slack_us = 50_000.0
    for d in departs:
        assert d["ts"] >= last_arrival - slack_us, (d, last_arrival)


@pytest.mark.fault
def test_served_request_trace_spans_the_gang(tmp_path):
    """The causal-tracing drive on the port (``tests/torch_trace_worker.
    py``): rank 0 serves ONE request that drives the 3-process gang, rank
    2 is a seeded straggler; the unchanged ``tools/trace_merge.py``
    merges the three exports into one trace spanning every rank, rooted
    at ``serve.request``, whose critical path names rank 2."""
    trace_dir = tmp_path / "traces"
    coord = elastic.Coordinator(3, heartbeat_timeout_s=60.0).start()
    try:
        addr = f"{coord.address[0]}:{coord.address[1]}"
        env = {r: _worker_env(tmp_path, trace_dir) for r in range(3)}
        env[2]["CYLON_TPU_FAULT_PLAN"] = "elastic.pass.r2@1+=delay"
        env[2]["CYLON_TPU_FAULT_DELAY_S"] = "1.5"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_trace_worker", str(r), "3",
             addr, str(tmp_path / f"out_r{r}.npz"),
             str(tmp_path / f"stats_r{r}.json")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env[r]) for r in range(3)]
        outs = [b""] * 3
        try:
            for i, p in enumerate(procs):
                outs[i], _ = p.communicate(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r in range(3):
            assert procs[r].returncode == 0, (
                r, outs[r].decode(errors="replace")[-3000:])
    finally:
        coord.stop()
    st = json.loads((tmp_path / "stats_r0.json").read_text())
    assert st["state"] == "done" and st["trace_id"], st
    merged_path = tmp_path / "merged.json"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_merge.py"),
         str(trace_dir), "-o", str(merged_path), "--json"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout)
    assert summary["ranks"] == [0, 1, 2] and summary["aligned"] is True
    cp = summary["critical_path"]
    assert cp["trace_id"] == st["trace_id"]
    assert cp["root"]["name"] == "serve.request"
    merged = json.loads(merged_path.read_text())
    pids = sorted({e["pid"] for e in merged["traceEvents"]
                   if (e.get("args") or {}).get("trace_id")
                   == cp["trace_id"]})
    assert pids == [0, 1, 2]
    assert cp["coverage"] >= 0.9, cp["coverage"]
    assert cp["dominant"]["rank"] == 2, cp["dominant"]
