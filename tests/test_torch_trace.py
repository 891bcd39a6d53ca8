"""The port's causal request tracing (``cylon_tpu_torch/obs/tracectx.py``
and its wiring through spans, the engine, the query service, the control
verbs, pass deadlines, flight dumps and OpenMetrics) against the JAX
package's, the counterpart of the cases of ``tests/test_trace.py`` that
need no elastic gang.

Where a case is a pure function of its inputs (traceparent parsing, the
head-sampling sequence, tail-retention decisions, the OpenMetrics
identity surface) both packages run it and must agree exactly.  Where it
drives a request (serve -> exec -> shuffle, serve -> plan), the port's
exported trace must read in the repo's stdlib tools
(``tools/critical_path.py``, ``tools/trace_report.py``), unchanged.  The
critical-path cases feed the tool synthetic events through the port's
``export.load_trace``.

Every case of ``test_trace.py`` has a counterpart here, the trace across
an elastic barrier included.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from cylon_tpu.obs import openmetrics as ropenmetrics
from cylon_tpu.obs import tracectx as rtracectx
from cylon_tpu_torch import (CylonContext, MeshConfig, Table, config,
                             durable, elastic)
from cylon_tpu_torch.net import control
from cylon_tpu_torch.obs import export as obs_export
from cylon_tpu_torch.obs import fleet as obs_fleet
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import openmetrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.obs import tracectx
from cylon_tpu_torch.serve import QueryService
from cylon_tpu_torch.serve import service as service_mod
from cylon_tpu_torch.status import Code, CylonError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 180.0
CPU = CylonContext.Init("cpu")

#: elastic control-plane cadence of the barrier case (as test_trace.py's)
HB = dict(interval_s=0.05, timeout_s=0.5, reconnect_s=0.0)
HB_TIMEOUT = 0.4


@pytest.fixture()
def clean_trace():
    obs_spans.reset()
    obs_metrics.reset()
    tracectx.reset()
    rtracectx.reset()
    yield
    obs_spans.reset()
    obs_metrics.reset()
    tracectx.reset()
    rtracectx.reset()


def _inputs(seed, n=1200):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}
    return left, right


def _counter(name: str) -> float:
    return obs_metrics.snapshot()["counters"].get(name, 0)


def _tool(name):
    import importlib.util

    p = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}_port", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# traceparent parse / reject fuzz, both packages alike
# ---------------------------------------------------------------------------

def test_traceparent_roundtrip():
    ctx = tracectx.new_trace(sampled=True)
    back = tracectx.parse_traceparent(ctx.traceparent())
    assert back.trace_id == ctx.trace_id
    assert back.span_id == ctx.span_id
    assert back.sampled is True
    assert back.parent_span_id is None
    # the reference parses the port's wire form to the same context
    assert tuple(rtracectx.parse_traceparent(ctx.traceparent())) \
        == tuple(back)
    unsampled = tracectx.new_trace(sampled=False)
    assert unsampled.traceparent().endswith("-00")
    assert tracectx.parse_traceparent(
        unsampled.traceparent()).sampled is False


VALID = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"


@pytest.mark.parametrize("bad", [
    "",
    "00",
    VALID[:-1],
    VALID + "0",
    VALID + "-extra",
    VALID.replace("-", "_", 1),
    VALID.upper(),
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "00-" + "gg" * 16 + "-" + "cd" * 8 + "-01",
    "00 - " + "ab" * 16 + " - " + "cd" * 8 + " - 01",
    "traceparent: " + VALID,
])
def test_traceparent_fuzz_rejected(bad):
    for mod in (tracectx, rtracectx):
        with pytest.raises(ValueError):
            mod.parse_traceparent(bad)
        assert mod.parse_or_none(bad) is None


@pytest.mark.parametrize("notstr", [None, 7, b"00-aa-bb-01", ["x"], {}])
def test_traceparent_non_string_rejected(notstr):
    with pytest.raises(ValueError):
        tracectx.parse_traceparent(notstr)
    assert tracectx.parse_or_none(notstr) is None


def test_traceparent_unknown_version_accepted():
    tp = "cc-" + "ab" * 16 + "-" + "cd" * 8 + "-00"
    got = tracectx.parse_traceparent(tp)
    assert got.trace_id == "ab" * 16 and got.sampled is False
    assert tuple(got) == tuple(rtracectx.parse_traceparent(tp))


def test_child_keeps_trace_links_parent():
    root = tracectx.new_trace(sampled=True)
    kid = root.child()
    assert kid.trace_id == root.trace_id
    assert kid.parent_span_id == root.span_id
    assert kid.span_id != root.span_id
    assert kid.sampled is True


# ---------------------------------------------------------------------------
# span stamping (the causal triple on buffered events)
# ---------------------------------------------------------------------------

def test_spans_stamped_under_active_context(clean_trace, tmp_path):
    ctx = tracectx.new_trace()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with tracectx.activate(ctx):
            with obs_spans.span("outer"):
                with obs_spans.span("inner"):
                    pass
                obs_spans.instant("tick")
        obs_spans.instant("outside")
    by_name = {e.name: e for e in obs_spans.events()}
    outer, inner, tick = (by_name["outer"], by_name["inner"],
                          by_name["tick"])
    assert outer.trace[0] == inner.trace[0] == tick.trace[0] == ctx.trace_id
    assert outer.trace[2] == ctx.span_id
    assert inner.trace[2] == outer.trace[1]
    assert tick.trace[1] == outer.trace[1]
    assert by_name["outside"].trace is None
    path = obs_export.export_trace(path=str(tmp_path / "stamp.json"))
    doc = obs_export.load_trace(path)
    args = {e["name"]: e.get("args", {}) for e in doc["traceEvents"]}
    assert args["outer"]["trace_id"] == ctx.trace_id
    assert args["inner"]["parent_span_id"] == args["outer"]["span_id"]
    assert "trace_id" not in args["outside"]
    assert doc["otherData"]["producer"] == "cylon_tpu_torch.obs"


def test_ambient_traceparent_roots_process(clean_trace):
    ctx = tracectx.new_trace()
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACEPARENT=ctx.traceparent()):
        assert tracectx.current().trace_id == ctx.trace_id
        with obs_spans.span("ambient.work"):
            pass
    ev = obs_spans.events()[0]
    assert ev.trace[0] == ctx.trace_id
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACEPARENT="garbage"):
        assert tracectx.current() is None


# ---------------------------------------------------------------------------
# tail-based retention, decision for decision with the reference
# ---------------------------------------------------------------------------

def test_tail_retention_off_keeps_everything(clean_trace):
    ctx = tracectx.new_trace()
    with config.knob_env(CYLON_TPU_TRACE_TAIL_MS="0"):
        assert tracectx.tail_keep(ctx, 0.001) is True
        assert tracectx.finish_request(ctx, 0.001) is True
    assert _counter("trace.tail_kept") == 0
    assert _counter("trace.tail_dropped") == 0


def test_tail_retention_keeps_slow_failed_sampled(clean_trace):
    def decisions(mod):
        return [mod.finish_request(mod.new_trace(sampled=False), 1.0),
                mod.finish_request(mod.new_trace(sampled=False), 80.0),
                mod.finish_request(mod.new_trace(sampled=False), 1.0,
                                   failed=True),
                mod.finish_request(mod.new_trace(sampled=True), 1.0)]

    with config.knob_env(CYLON_TPU_TRACE_TAIL_MS="50"):
        got, want = decisions(tracectx), decisions(rtracectx)
    assert got == want == [False, True, True, True]
    assert _counter("trace.tail_kept") == 3
    assert _counter("trace.tail_dropped") == 1


def test_tail_retention_p99_estimate_kicks_in(clean_trace):
    def run(mod):
        out = [mod.tail_keep(mod.new_trace(), 50.0)]
        for _ in range(mod.P99_MIN_SAMPLES):
            mod.tail_keep(mod.new_trace(), 1.0)
        out.append(mod.tail_keep(mod.new_trace(), 50.0))
        out.append(mod.tail_keep(mod.new_trace(), 0.5))
        return out, mod.p99_estimate_ms()

    with config.knob_env(CYLON_TPU_TRACE_TAIL_MS="100000"):
        got, want = run(tracectx), run(rtracectx)
    assert got == want
    assert got[0] == [False, True, False]


def test_shed_storm_does_not_poison_p99_estimator(clean_trace):
    with config.knob_env(CYLON_TPU_TRACE_TAIL_MS="100000"):
        for _ in range(tracectx.P99_MIN_SAMPLES + 4):
            tracectx.tail_keep(tracectx.new_trace(), 10.0)
        before = tracectx.p99_estimate_ms()
        for _ in range(500):
            assert tracectx.finish_request(
                tracectx.new_trace(), 0.0, failed=True) is True
        assert tracectx.p99_estimate_ms() == before
        assert tracectx.tail_keep(tracectx.new_trace(), 5.0) is False


def test_head_sampling_one_in_n(clean_trace):
    with config.knob_env(CYLON_TPU_TRACE_SAMPLE_N="4"):
        flags = [tracectx.new_trace().sampled for _ in range(8)]
        rflags = [rtracectx.new_trace().sampled for _ in range(8)]
    assert flags == rflags == [True, False, False, False,
                               True, False, False, False]
    with config.knob_env(CYLON_TPU_TRACE_SAMPLE_N="0"):
        assert tracectx.new_trace().sampled is False


def test_sampled_slow_buffer_survives_fast_flood(clean_trace, monkeypatch):
    """A flood of fast requests discards its own events at close, so the
    32-event buffer never starves the sampled request, and the overflow
    drop counter stays monotone."""
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_BUFFER_CAP="32",
                         CYLON_TPU_TRACE_TAIL_MS="1000"):
        keeper = tracectx.new_trace(sampled=True)
        with tracectx.activate(keeper):
            for i in range(8):
                obs_spans.instant(f"keep{i}")
        assert tracectx.finish_request(keeper, 0.1) is True
        drops_seen = obs_spans.dropped()
        for n in range(10):
            fast = tracectx.new_trace(sampled=False)
            with tracectx.activate(fast):
                for i in range(4):
                    obs_spans.instant(f"fast{n}.{i}")
            assert tracectx.finish_request(fast, 0.1) is False
            assert obs_spans.dropped() >= drops_seen
            drops_seen = obs_spans.dropped()
        names = [e.name for e in obs_spans.events()]
        assert names == [f"keep{i}" for i in range(8)]
        assert obs_spans.dropped() == 0
        big = tracectx.new_trace()
        with tracectx.activate(big):
            for i in range(40):
                obs_spans.instant(f"big{i}")
        overflow = obs_spans.dropped()
        assert overflow > 0
        tracectx.finish_request(big, 0.1)
        assert obs_spans.dropped() == overflow
        assert [e.name for e in obs_spans.events()] == \
            [f"keep{i}" for i in range(8)]
    assert _counter("trace.tail_dropped") == 11
    assert _counter("trace.tail_kept") == 1
    assert _counter("trace.tail_events_discarded") > 0


# ---------------------------------------------------------------------------
# propagation: serve -> plan/exec -> shuffle (one process)
# ---------------------------------------------------------------------------

def test_serve_request_propagates_through_engine(clean_trace, tmp_path):
    mesh = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))
    left, right = _inputs(3)
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_DIR=str(tmp_path / "tr"),
                         CYLON_TPU_DURABLE_DIR=str(tmp_path / "j")):
        svc = QueryService(ctx=mesh)
        try:
            t = svc.submit("t0", "join", left, right, on="k", passes=2,
                           mode="hash")
            t.result(timeout=WAIT_S)
            raw = {"k": (left["k"] % 7).astype(np.int64), "v": left["a"]}
            tbl = Table.from_numpy(list(raw), list(raw.values()), ctx=mesh)
            q = tbl.plan().groupby(["k"], {"v": "sum"})
            tp = svc.submit("t0", "plan", q)
            tp.result(timeout=WAIT_S)
        finally:
            svc.close()
        assert t.trace_id is not None and tp.trace_id is not None
        assert t.trace_id != tp.trace_id
        evs = obs_spans.events()

        def names_of(trace_id):
            return {e.name for e in evs
                    if e.trace is not None and e.trace[0] == trace_id}

        traced = names_of(t.trace_id)
        assert "serve.request" in traced
        assert "exec.pass" in traced or "join.gather" in traced
        assert any(n.startswith("shuffle.") for n in traced)
        planned = names_of(tp.trace_id)
        assert "serve.request" in planned
        assert "plan.execute" in planned
        ids = {e.trace[1] for e in evs
               if e.trace is not None and e.trace[0] == t.trace_id}
        root = next(e for e in evs if e.name == "serve.request"
                    and e.trace[0] == t.trace_id)
        for e in evs:
            if e.trace is None or e.trace[0] != t.trace_id or e is root:
                continue
            assert e.trace[2] in ids | {root.trace[2]}, e.name
        path, mpath = obs_export.export_all()
        cp = _tool("critical_path").critical_path(
            obs_export.load_trace(path)["traceEvents"], t.trace_id)
        assert cp is not None
        assert cp["trace_id"] == t.trace_id
        assert cp["root"]["name"] == "serve.request"
        assert cp["coverage"] is not None and cp["coverage"] >= 0.5
        # the per-tenant SLO table of trace_report reads the port's export
        rep = _tool("trace_report").report_dict(path, mpath, 10)
        assert rep["counters"]["serve.completed"] == 2
        assert obs_export.load_metrics(mpath)["histograms"][
            "serve.run_ms[t0]"]["count"] == 2


def test_client_supplied_traceparent_adopted(clean_trace):
    left, right = _inputs(4)
    parent = tracectx.new_trace(sampled=True)
    svc = QueryService(ctx=CPU)
    try:
        t = svc.submit("t0", "join", left, right, on="k", passes=1,
                       mode="hash", traceparent=parent.traceparent())
        t.result(timeout=WAIT_S)
        assert t.trace.trace_id == parent.trace_id
        assert t.trace.parent_span_id == parent.span_id
        assert t.trace.sampled is True
        t2 = svc.submit("t0", "join", left, right, on="k", passes=1,
                        mode="hash", traceparent="not-a-traceparent")
        t2.result(timeout=WAIT_S)
        assert t2.trace_id is not None
        assert t2.trace.trace_id != parent.trace_id
    finally:
        svc.close()


def test_cancelled_and_shed_requests_close_their_trace(clean_trace,
                                                       monkeypatch):
    started, release = threading.Event(), threading.Event()
    orig = service_mod._RUNNERS["join"]

    def runner(*args, **kwargs):
        started.set()
        assert release.wait(WAIT_S), "blocked runner never released"
        return orig(*args, **kwargs)

    monkeypatch.setitem(service_mod._RUNNERS, "join", runner)
    left, right = _inputs(5)
    with config.knob_env(CYLON_TPU_TRACE="1",
                         CYLON_TPU_TRACE_TAIL_MS="100000"):
        svc = QueryService(ctx=CPU, queue_cap=1)
        try:
            t0 = svc.submit("a", "join", left, right, on="k", passes=1,
                            mode="hash")
            assert started.wait(WAIT_S)
            t1 = svc.submit("a", "join", left, right, on="k", passes=1,
                            mode="hash")
            with pytest.raises(CylonError) as exc:
                svc.submit("a", "join", left, right, on="k", passes=1,
                           mode="hash")
            assert exc.value.code in (Code.ResourceExhausted,
                                      Code.Unavailable)
            assert _counter("trace.tail_kept") == 1
            shed_evs = [e for e in obs_spans.events()
                        if e.name == "serve.shed"]
            assert shed_evs and shed_evs[-1].trace is not None
            t1.cancel()
            release.set()
            t0.result(timeout=WAIT_S)
            assert t1.state == service_mod.CANCELLED
            assert t1.trace_id is not None
        finally:
            release.set()
            svc.close()
    assert (_counter("trace.tail_kept")
            + _counter("trace.tail_dropped")) == 3


# ---------------------------------------------------------------------------
# the control verb carries the trace
# ---------------------------------------------------------------------------

def test_control_verb_carries_traceparent(clean_trace):
    seen = []

    def handler(req):
        seen.append((req.get("traceparent"), tracectx.current()))
        return {"ok": True}

    srv = control.JsonServer(handler).start()
    try:
        ctx = tracectx.new_trace()
        with tracectx.activate(ctx):
            control.request(srv.address, {"cmd": "ping"})
        control.request(srv.address, {"cmd": "ping"})  # no context
    finally:
        srv.close()
    tp, handler_ctx = seen[0]
    assert tracectx.parse_traceparent(tp).trace_id == ctx.trace_id
    assert handler_ctx is not None
    assert handler_ctx.trace_id == ctx.trace_id
    assert handler_ctx.parent_span_id == ctx.span_id
    assert seen[1] == (None, None)


# ---------------------------------------------------------------------------
# terminal instants + flight dumps carry the trace
# ---------------------------------------------------------------------------

def test_deadline_fired_instant_carries_arming_trace(clean_trace):
    ctx = tracectx.new_trace()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        dl = durable.PassDeadline(0.01, site="unit")
        with tracectx.activate(ctx):
            with dl:
                assert dl.fired.wait(5.0), "deadline never fired"
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline and not any(
                        e.name == "deadline.fired"
                        for e in obs_spans.events()):
                    time.sleep(0.005)
    fired = [e for e in obs_spans.events() if e.name == "deadline.fired"]
    assert fired and fired[-1].trace is not None
    assert fired[-1].trace[0] == ctx.trace_id


def test_flight_dump_carries_active_trace(clean_trace, tmp_path):
    ctx = tracectx.new_trace()
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        obs_fleet.set_run_id("trace_dump_test")
        try:
            with tracectx.activate(ctx):
                path = obs_fleet.flight_record("unit_test", probe=1)
            doc = obs_fleet.load_flight(path)
            untraced = obs_fleet.flight_record("unit_test2", probe=2)
        finally:
            obs_fleet.set_run_id(None)
    assert os.path.basename(path) == "trace_dump_test.r0.json"
    assert doc["trace_id"] == ctx.trace_id
    assert obs_fleet.load_flight(untraced)["trace_id"] is None


def test_fleet_identity_and_clock(clean_trace, tmp_path):
    """Rank and run id name the exports; ``measure_offset`` is a pure
    function of its request_fn's stamps and the reference's."""
    from cylon_tpu.obs import fleet as rfleet

    obs_fleet.reset()
    try:
        obs_fleet.set_rank(3)
        obs_fleet.set_rank(5)  # first registration wins
        assert obs_fleet.current_rank() == 3
        obs_fleet.set_run_id("runA")
        with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
            path = obs_export.export_metrics()
        assert os.path.basename(path) == "metrics.runA.r3.json"
        obs_fleet.set_incarnation(7)
        assert obs_fleet.current_incarnation() == 7

        def fake(req, t=[0]):
            # a peer 1 ms ahead answering at once
            t[0] += 1
            return {"ok": True, "t_recv": req["t0"] + 1_000_000,
                    "t_send": req["t0"] + 1_000_000}

        info = obs_fleet.measure_offset(fake, ref="peer", rounds=3)
        assert info.ref == "peer" and info.uncertainty_ns >= 1
        obs_fleet.set_clock(info)
        assert obs_fleet.clock_dict()["offset_ns"] == info.offset_ns
        with pytest.raises(ValueError):
            obs_fleet.measure_offset(lambda req: {"ok": False})
        a = {"count": 2, "sum": 3.0, "min": 1.0, "max": 2.0,
             "buckets": {"0": 2}, "le": {"1": 1, "+Inf": 2}}
        assert obs_fleet.merge_hist(a, a) == rfleet.merge_hist(a, a)
    finally:
        obs_fleet.reset()


# ---------------------------------------------------------------------------
# openmetrics: build_info + always-present retention counters
# ---------------------------------------------------------------------------

def test_openmetrics_build_info_and_retention_counters(clean_trace):
    text = openmetrics.render()
    parsed = openmetrics.parse(text)
    ropenmetrics.parse(text)  # the reference's parser accepts it too
    info = parsed["cylon_tpu_build_info"]
    assert info["type"] == "gauge"
    (_name, labels, value), = info["samples"]
    assert value == 1.0
    assert set(labels) >= {"version", "rank", "incarnation"}
    assert "cylon_tpu_trace_tail_kept_total 0" in text
    assert "cylon_tpu_trace_tail_dropped_total 0" in text
    with config.knob_env(CYLON_TPU_TRACE_TAIL_MS="50"):
        tracectx.finish_request(tracectx.new_trace(), 80.0)
    text2 = openmetrics.render()
    assert "cylon_tpu_trace_tail_kept_total 1" in text2
    openmetrics.parse(text2)
    fleet = openmetrics.render_fleet({0: {}, 1: {"counters": {}}})
    openmetrics.parse(fleet)
    assert "cylon_tpu_build_info" in fleet
    for r in (0, 1):
        assert (f'cylon_tpu_trace_tail_kept_total{{rank="{r}"}} 0'
                in fleet), fleet
    # the same snapshot renders the same samples in both packages
    snap = {"counters": {"serve.shed[a}b]": 2, "x.y": 1},
            "gauges": {"g": 2.5},
            "histograms": {"serve.run_ms[t]": {
                "count": 1, "sum": 3.0, "min": 3.0, "max": 3.0,
                "buckets": {"1": 1}, "le": {"1": 0, "5": 1, "+Inf": 1}}}}
    body = [ln for ln in openmetrics.render(snap).splitlines()
            if "build_info" not in ln]
    rbody = [ln for ln in ropenmetrics.render(snap).splitlines()
             if "build_info" not in ln]
    assert body == rbody


# ---------------------------------------------------------------------------
# critical-path walk over the port's trace export
# ---------------------------------------------------------------------------

def _ev(name, pid, tid, ts, dur, trace, span, parent, **attrs):
    return {"name": name, "ph": "X", "pid": pid, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {"trace_id": trace, "span_id": span,
                     "parent_span_id": parent, **attrs}}


T = "ab" * 16


def _walk(tmp_path, events, trace_id=None):
    """The tool over events loaded through the port's ``load_trace``."""
    p = tmp_path / f"cp{len(os.listdir(tmp_path))}.json"
    p.write_text(json.dumps({"traceEvents": events}))
    evs = obs_export.load_trace(str(p))["traceEvents"]
    return _tool("critical_path").critical_path(evs, trace_id)


def test_critical_path_redirects_wait_through_remote_work(tmp_path):
    events = [
        _ev("serve.request", 0, 1, 0.0, 100.0, T, "r0", None),
        _ev("exec.pass", 0, 1, 0.0, 40.0, T, "s1", "r0"),
        _ev("elastic.barrier", 0, 1, 40.0, 55.0, T, "s2", "r0"),
        _ev("elastic.pass_guard", 1, 9, 42.0, 50.0, T, "s3", "r0"),
        _ev("exec.pass", 0, 1, 95.0, 5.0, T, "s4", "r0"),
    ]
    cp = _walk(tmp_path, events)
    assert cp["trace_id"] == T
    assert cp["total_us"] == 100.0
    assert cp["coverage"] == 1.0
    assert cp["dominant"]["name"] == "elastic.pass_guard"
    assert cp["dominant"]["rank"] == 1
    assert cp["decomposition"]["wait_us"] == pytest.approx(5.0)
    assert cp["decomposition"]["compute_us"] == pytest.approx(95.0)


def test_critical_path_uncovered_wait_stays_wait(tmp_path):
    events = [
        _ev("serve.request", 0, 1, 0.0, 100.0, T, "r0", None),
        _ev("exec.pass", 0, 1, 0.0, 40.0, T, "s1", "r0"),
        _ev("elastic.barrier", 0, 1, 40.0, 55.0, T, "s2", "r0"),
        _ev("exec.pass", 0, 1, 95.0, 5.0, T, "s4", "r0"),
    ]
    cp = _walk(tmp_path, events)
    assert cp["coverage"] == 1.0
    assert cp["dominant"]["name"] == "elastic.barrier"
    assert cp["wait_fraction"] == pytest.approx(0.55)


def test_critical_path_self_time_not_wrapper(tmp_path):
    events = [
        _ev("serve.request", 0, 1, 0.0, 100.0, T, "r0", None),
        _ev("wrapper", 0, 1, 0.0, 100.0, T, "s1", "r0"),
        _ev("shuffle.exchange", 0, 1, 10.0, 80.0, T, "s2", "s1"),
    ]
    cp = _walk(tmp_path, events)
    assert cp["dominant"]["name"] == "shuffle.exchange"
    assert cp["dominant"]["class"] == "transfer"
    assert cp["decomposition"]["transfer_us"] == pytest.approx(80.0)


def test_critical_path_none_without_traced_request(tmp_path):
    assert _walk(tmp_path, [
        {"name": "x", "ph": "X", "pid": 0, "tid": 1, "ts": 0.0,
         "dur": 5.0, "args": {}}]) is None
    assert _walk(tmp_path, []) is None


def test_critical_path_selects_requested_trace(tmp_path):
    T2 = "cd" * 16
    events = [
        _ev("serve.request", 0, 1, 0.0, 10.0, T, "r0", None),
        _ev("serve.request", 0, 2, 0.0, 50.0, T2, "q0", None),
    ]
    cp = _walk(tmp_path, events, T)
    assert cp["trace_id"] == T and cp["total_us"] == 10.0
    assert _walk(tmp_path, events)["trace_id"] == T2


def test_trace_sync_fences_only_where_cuda_ran(clean_trace, monkeypatch):
    """``CYLON_TPU_TRACE_SYNC`` fences at every span boundary; a process
    that never initialized CUDA has nothing to drain, so the fence is a
    no-op there."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    with config.knob_env(CYLON_TPU_TRACE_SYNC="1"):
        with obs_spans.span("fenced"):
            pass
        assert calls == [] or torch.cuda.is_initialized()
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with obs_spans.span("fenced"):
            pass
    assert len(calls) == 2  # entry and exit
    with obs_spans.span("unfenced"):
        pass
    assert len(calls) == 2


# -- propagation across an elastic barrier (the coordinator wire) ------

def test_barrier_propagates_trace_across_ranks(clean_trace):
    """Rank 0 arrives at a rendezvous carrying a request context; the
    coordinator latches it, stamps its rendezvous bookkeeping with it,
    and echoes it to rank 1 — which arrived with NO context and adopts
    the requester's trace."""
    c = elastic.Coordinator(2, heartbeat_timeout_s=HB_TIMEOUT).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agents = [elastic.Agent(addr, r, **HB).start() for r in range(2)]
    ctx = tracectx.new_trace()
    try:
        for a in agents:
            a.wait_formed()
        epoch = agents[0].view().epoch
        with config.knob_env(CYLON_TPU_TRACE="1"):
            results = {}

            def other():  # rank 1: no context of its own
                results[1] = agents[1].barrier("b1", epoch)

            th = threading.Thread(target=other, daemon=True)
            th.start()
            with tracectx.activate(ctx):
                agents[0].barrier("b1", epoch)
            th.join(WAIT_S)
            assert 1 in results, "rank 1 never left the barrier"
        # rank 1 adopted the requester's trace over the wire
        adopted = agents[1].barrier_trace
        assert adopted is not None
        assert adopted.trace_id == ctx.trace_id
        # the coordinator's rendezvous bookkeeping joined the trace too
        skew = [e for e in obs_spans.events()
                if e.name == "collective.skew"]
        assert skew and skew[-1].attrs.get("trace_id") == ctx.trace_id
        st = control.request(c.address, {"cmd": "status"})
        assert st["collectives"][-1].get("trace_id") == ctx.trace_id
        # the latch is per-rendezvous: a later UNTRACED rendezvous must
        # not adopt the finished request's trace (stale adoption would
        # stamp an unrelated run's spans with a closed request's id)
        results.clear()
        th2 = threading.Thread(
            target=lambda: results.setdefault(
                1, agents[1].barrier("b2", epoch)), daemon=True)
        th2.start()
        agents[0].barrier("b2", epoch)
        th2.join(WAIT_S)
        assert 1 in results, "rank 1 never left barrier b2"
        assert agents[1].barrier_trace is None
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_trace_waits_name_their_item():
    """Every case of test_trace.py has a counterpart here: none
    waits."""
    import ast

    with open(os.path.join(REPO, "tests", "test_trace.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    ported = {n for n in globals() if n.startswith("test_")}
    assert names <= ported, names - ported
