"""The port's query service (``cylon_tpu_torch/serve/``) against the JAX
package's (``cylon_tpu/serve/``), the counterpart of the 23 cases of
``tests/test_serve.py``: admission control, bounded-queue load shedding,
per-tenant budgets, the journal-backed result cache, cancellation,
graceful drain, journal GC and the per-tenant SLO histograms.

The same numpy inputs go to the reference's service (or its direct
``exec.chunked_join``, whose equality with the served frame is the
reference's own ``test_serve.py``) on CPU JAX and to the port's service on
``CylonContext.Init("cpu")``; the 4-shard flood runs the port on
``MeshConfig(devices=["cpu"], world_size=4)`` against the reference on a
fresh murmur3-patched context (``torch_parity.murmur3_reference``), so
both place every row alike.  Served frames compare row for row with
``torch_parity.assert_frames_equal`` (keys and counts exact, float32
within rtol 1e-5: the reference's own float tolerance for sums).  A
port-only repeat compares bit for bit.

Timing: every queue-state case parks the scheduler in a blocked runner
(admission outcomes are then a pure function of the submission order);
the deadline cases slow each pass with the ``delay`` fault kind, and the
running-cancel case holds the first pass boundary until ``cancel()`` has
returned, so no case depends on how fast the port runs a pass.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cylon_tpu import exec as rexec
from cylon_tpu.serve import QueryService as RQueryService
from cylon_tpu_torch import (Code, CylonContext, CylonError, MeshConfig,
                             config, durable, resilience, serve)
from cylon_tpu_torch import exec as pexec
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.serve import QueryService, TenantBudget
from cylon_tpu_torch.serve import service as service_mod

from .torch_parity import assert_frames_equal, murmur3_reference

WAIT_S = 180.0
SHED_CODES = (Code.ResourceExhausted, Code.Unavailable)
CPU = CylonContext.Init("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, n=1500):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}
    return left, right


def _bit_identical(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), k


def _ref_join(left, right, passes, **kw):
    """The reference's frame of the request the cases submit."""
    return rexec.chunked_join(left, right, on="k", passes=passes,
                              mode="hash", **kw)[0]


def _submit_join(svc, tenant, left, right, passes=1, **kw):
    return svc.submit(tenant, "join", left, right, on="k", passes=passes,
                      mode="hash", **kw)


@pytest.fixture()
def svc():
    s = QueryService(ctx=CPU)
    yield s
    s.close()


@pytest.fixture()
def clean_obs():
    obs_spans.reset()
    obs_metrics.reset()
    yield
    obs_spans.reset()
    obs_metrics.reset()


def test_no_ctx_serves_on_the_card_or_raises(monkeypatch):
    """``QueryService()`` serves on the CUDA card; without one it raises,
    never falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CylonError, match="no CUDA device"):
        QueryService()


# ---------------------------------------------------------------------------
# deterministic admission control: the scheduler is pinned by a blocked
# runner, so queue state (and therefore every shed) is exact
# ---------------------------------------------------------------------------

@pytest.fixture()
def blocked_join(monkeypatch):
    started = threading.Event()
    release = threading.Event()
    orig = service_mod._RUNNERS["join"]

    def runner(*args, **kwargs):
        started.set()
        assert release.wait(WAIT_S), "blocked runner never released"
        return orig(*args, **kwargs)

    monkeypatch.setitem(service_mod._RUNNERS, "join", runner)
    yield started, release
    release.set()


def test_bounded_queue_sheds_resource_exhausted(blocked_join):
    started, release = blocked_join
    left, right = _inputs(0)
    svc = QueryService(ctx=CPU, queue_cap=2)
    try:
        t0 = _submit_join(svc, "a", left, right)
        assert started.wait(WAIT_S)  # scheduler busy; queue now exact
        admitted = [_submit_join(svc, "b", left, right),
                    _submit_join(svc, "c", left, right)]
        with pytest.raises(CylonError) as ei:
            _submit_join(svc, "d", left, right)
        assert ei.value.code == Code.ResourceExhausted
        assert "queue full" in ei.value.msg
        assert ei.value.retry_after_s is not None
        assert ei.value.retry_after_s > 0
        assert obs_metrics.counter_value("serve.shed") >= 1
        release.set()
        want = _ref_join(left, right, 1)
        for t in [t0] + admitted:
            assert_frames_equal(t.result(timeout=WAIT_S)[0], want)
        st = svc.stats()
        assert st["admitted"] == 3 and st["shed"] == 1
        assert st["tenants"]["d"]["shed"] == 1
    finally:
        release.set()
        svc.close()


def test_tenant_share_isolates_a_flooding_tenant(blocked_join):
    """One tenant may hold at most ceil(cap * share) queued slots: the
    flooder sheds while another tenant still admits into the SAME
    queue."""
    started, release = blocked_join
    left, right = _inputs(1)
    with config.knob_env(CYLON_TPU_SERVE_TENANT_SHARE="0.5"):
        svc = QueryService(ctx=CPU, queue_cap=4)
        try:
            first = _submit_join(svc, "flood", left, right)
            assert started.wait(WAIT_S)
            ok = [_submit_join(svc, "flood", left, right) for _ in range(2)]
            with pytest.raises(CylonError) as ei:
                _submit_join(svc, "flood", left, right)
            assert ei.value.code == Code.ResourceExhausted
            assert "share" in ei.value.msg
            other = _submit_join(svc, "quiet", left, right)
            release.set()
            want = _ref_join(left, right, 1)
            for t in [first] + ok + [other]:
                assert_frames_equal(t.result(timeout=WAIT_S)[0], want)
            assert svc.stats()["tenants"]["quiet"]["shed"] == 0
        finally:
            release.set()
            svc.close()


def test_hbm_budget_sheds_at_admission(svc):
    left, right = _inputs(2)
    svc.set_budget("mem", TenantBudget(hbm_bytes=1))
    with pytest.raises(CylonError) as ei:
        svc.submit("mem", "join", left, right, on="k")
    assert ei.value.code == Code.ResourceExhausted
    assert "HBM admission estimate" in ei.value.msg
    assert ei.value.retry_after_s is not None
    # the estimate is the reference's: twice the input bytes
    assert service_mod._estimate_request_bytes((left, right), {}) == \
        2 * sum(a.nbytes for d in (left, right) for a in d.values())
    r, _ = _submit_join(svc, "ok", left, right).result(timeout=WAIT_S)
    assert_frames_equal(r, _ref_join(left, right, 1))


@pytest.mark.fault
def test_tenant_flood_fault_kind_sheds_at_admission(svc):
    left, right = _inputs(3)
    with resilience.fault_plan("serve.admit@1=tenant_flood") as plan:
        with pytest.raises(CylonError) as ei:
            svc.submit("t", "join", left, right, on="k")
    assert plan.fired == [("serve.admit", "tenant_flood", 1)]
    assert ei.value.code == Code.ResourceExhausted
    assert ei.value.retry_after_s is not None
    r, _ = _submit_join(svc, "t", left, right).result(timeout=WAIT_S)
    assert_frames_equal(r, _ref_join(left, right, 1))


@pytest.mark.fault
def test_shed_fault_kind_sheds_queued_work_at_dispatch(svc):
    left, right = _inputs(4)
    with resilience.fault_plan("serve.dispatch@1=shed") as plan:
        t = _submit_join(svc, "t", left, right)
        with pytest.raises(CylonError) as ei:
            t.result(timeout=WAIT_S)
    assert plan.fired == [("serve.dispatch", "shed", 1)]
    assert ei.value.code == Code.Unavailable
    assert t.state == service_mod.SHED
    r, _ = _submit_join(svc, "t", left, right).result(timeout=WAIT_S)
    assert_frames_equal(r, _ref_join(left, right, 1))


# ---------------------------------------------------------------------------
# the flood: 3 tenants on a 4-shard mesh, bounded queue, zero hangs,
# admitted results equal to the reference's served frames
# ---------------------------------------------------------------------------

def test_flood_on_ctx4_sheds_classified_and_serves_exact():
    tenants = ["t0", "t1", "t2"]
    per_tenant = {t: _inputs(10 + i, n=1200) for i, t in
                  enumerate(tenants)}
    with murmur3_reference(4) as rctx:
        with RQueryService(ctx=rctx) as rsvc:
            oracle = {t: rsvc.submit(t, "join", l, r, on="k", passes=2,
                                     mode="hash").result(timeout=WAIT_S)[0]
                      for t, (l, r) in per_tenant.items()}
    mesh = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))
    svc = QueryService(ctx=mesh, queue_cap=1)
    admitted, shed = [], []
    try:
        for _ in range(4):
            for t in tenants:
                l, r = per_tenant[t]
                try:
                    admitted.append((t, svc.submit(t, "join", l, r, on="k",
                                                   passes=2, mode="hash")))
                except CylonError as e:
                    shed.append((t, e))
        for t, ticket in admitted:
            res, _stats = ticket.result(timeout=WAIT_S)  # zero hangs
            assert_frames_equal(res, oracle[t])
    finally:
        svc.close()
    assert len(admitted) + len(shed) == 12
    assert len(shed) > 0, "queue bound never tripped"
    for _, e in shed:
        assert e.code in SHED_CODES, e
        assert e.retry_after_s is None or e.retry_after_s > 0
    st = svc.stats()
    assert st["admitted"] == len(admitted)
    assert st["shed"] == len(shed)
    assert st["completed"] == len(admitted)
    assert st["failed"] == 0


# ---------------------------------------------------------------------------
# the journal as a result cache
# ---------------------------------------------------------------------------

def test_repeated_fingerprint_serves_from_cache_zero_compiles(tmp_path,
                                                              clean_obs):
    left, right = _inputs(20)
    want = _ref_join(left, right, 3)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_TRACE="1"):
        with QueryService(ctx=CPU) as svc:
            t1 = _submit_join(svc, "alice", left, right, passes=3)
            r1, _s1 = t1.result(timeout=WAIT_S)
            assert t1.cache_hit is False
            obs_spans.reset()
            obs_metrics.reset()
            t2 = _submit_join(svc, "alice", left, right, passes=3)
            r2, s2 = t2.result(timeout=WAIT_S)
    assert t2.cache_hit is True
    assert obs_metrics.counter_value("serve.cache_hit") == 1
    assert obs_metrics.counter_value("exec.parts_run") == 0
    assert s2["passes_skipped"] == s2["passes"]
    assert "parts_run" not in s2
    assert_frames_equal(r1, want)
    _bit_identical(r2, r1)
    reqs = [e for e in obs_spans.events() if e.name == "serve.request"]
    assert [e.attrs["tenant"] for e in reqs] == ["alice"]
    hits = [e for e in obs_spans.events() if e.name == "serve.cache_hit"]
    assert len(hits) == 1 and hits[0].attrs["tenant"] == "alice"


@pytest.mark.fault
def test_cache_evict_race_reexecutes_instead_of_torn_serve(tmp_path,
                                                           clean_obs):
    """A GC eviction racing a reader (spills deleted under a replayed
    manifest) degrades to re-execution, never a torn serve."""
    left, right = _inputs(21)
    want = _ref_join(left, right, 3)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        with QueryService(ctx=CPU) as svc:
            _submit_join(svc, "t", left, right, passes=3).result(
                timeout=WAIT_S)
            with resilience.fault_plan(
                    "serve.dispatch@1=cache_evict_race") as plan:
                t2 = _submit_join(svc, "t", left, right, passes=3)
                r2, s2 = t2.result(timeout=WAIT_S)
    assert plan.fired == [("serve.dispatch", "cache_evict_race", 1)]
    assert t2.cache_hit is False
    assert s2["passes_skipped"] == 0
    assert s2["parts_run"] == s2["passes"]
    assert obs_metrics.counter_value("durable.spills_rejected") \
        == s2["passes"]
    assert_frames_equal(r2, want)


_GC_LOOP_SRC = """\
import sys, time
from cylon_tpu_torch import durable
end = time.time() + float(sys.argv[2])
n = 0
while time.time() < end:
    ev, fr = durable.gc_journal(sys.argv[1], cap=1)
    n += ev
print("evictions", n)
"""


def test_cache_evict_race_with_cross_process_gc(tmp_path):
    """A service keeps replaying a journaled fingerprint while another
    process's GC loop (cap=1: evict everything it may) collects the
    shared root under the advisory lease: every replay is exact (a cache
    hit, or a re-execution of what the collector tore out) and the lock
    file does not leak."""
    left, right = _inputs(26)
    want = _ref_join(left, right, 3)
    env = dict(os.environ)
    env.pop("CYLON_TPU_DURABLE_DIR", None)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        with QueryService(ctx=CPU) as svc:
            first, _ = _submit_join(svc, "t", left, right, passes=3).result(
                timeout=WAIT_S)
            assert_frames_equal(first, want)
            proc = subprocess.Popen(
                [sys.executable, "-c", _GC_LOOP_SRC, str(tmp_path), "4"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            try:
                deadline = time.monotonic() + WAIT_S
                while time.monotonic() < deadline:
                    r2, _ = _submit_join(svc, "t", left, right,
                                         passes=3).result(timeout=WAIT_S)
                    _bit_identical(r2, first)
                    if proc.poll() is not None:
                        break
            finally:
                out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert "evictions" in out
    assert not os.path.exists(os.path.join(str(tmp_path), "GC_LOCK"))


# ---------------------------------------------------------------------------
# per-tenant budgets: deadline + quarantine
# ---------------------------------------------------------------------------

def test_request_deadline_classifies_timeout():
    """Every pass sleeps ``FAULT_DELAY_S`` (the ``delay`` kind), so the
    0.02 s budget fires during the first pass and the guard stops the
    run at the next boundary."""
    left, right = _inputs(22, n=4000)
    with config.knob_env(CYLON_TPU_RETRY_MAX="0",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with QueryService(ctx=CPU, budgets={"slow": TenantBudget(
                deadline_s=0.02)}) as svc:
            with resilience.fault_plan("pass_dispatch@1+=delay"):
                t = _submit_join(svc, "slow", left, right, passes=4)
                with pytest.raises(CylonError) as ei:
                    t.result(timeout=WAIT_S)
            assert ei.value.code == Code.Timeout
            assert "budget" in ei.value.msg
            assert t.state == service_mod.FAILED
            r, _ = _submit_join(svc, "fast", left, right,
                                passes=4).result(timeout=WAIT_S)
    assert_frames_equal(r, _ref_join(left, right, 4))


def test_request_deadline_never_truncates_via_engine_quarantine():
    """A request-budget overrun FAILS classified Timeout: the guard raise
    bypasses the engine's retry and quarantine, so with
    CYLON_TPU_QUARANTINE_AFTER=1 no healthy part is quarantined out."""
    left, right = _inputs(29, n=4000)
    q0 = obs_metrics.counter_value("quarantine.parts")
    with config.knob_env(CYLON_TPU_QUARANTINE_AFTER="1",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with QueryService(ctx=CPU, budgets={"slow": TenantBudget(
                deadline_s=0.02)}) as svc:
            with resilience.fault_plan("pass_dispatch@1+=delay"):
                t = _submit_join(svc, "slow", left, right, passes=4)
                with pytest.raises(CylonError) as ei:
                    t.result(timeout=WAIT_S)
    assert ei.value.code == Code.Timeout
    assert t.state == service_mod.FAILED
    assert obs_metrics.counter_value("quarantine.parts") == q0


@pytest.mark.fault
def test_poison_tenant_quarantined_others_served(svc):
    left, right = _inputs(23)
    with config.knob_env(CYLON_TPU_SERVE_QUARANTINE_AFTER="2",
                         CYLON_TPU_SERVE_QUARANTINE_S="600",
                         CYLON_TPU_RETRY_MAX="0",
                         CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("pass_dispatch@1+=unknown"):
            for _ in range(2):
                t = _submit_join(svc, "poison", left, right)
                with pytest.raises(CylonError):
                    t.result(timeout=WAIT_S)
        with pytest.raises(CylonError) as ei:
            svc.submit("poison", "join", left, right, on="k")
        assert ei.value.code == Code.Unavailable
        assert "quarantined" in ei.value.msg
        assert ei.value.retry_after_s is not None
        assert 0 < ei.value.retry_after_s <= 600
        assert obs_metrics.counter_value("serve.tenants_quarantined") >= 1
        r, _ = _submit_join(svc, "healthy", left, right).result(
            timeout=WAIT_S)
        assert_frames_equal(r, _ref_join(left, right, 1))
        assert svc.stats()["tenants"]["poison"]["quarantined"] is True


def test_quarantine_expires_and_streak_resets(svc, monkeypatch):
    """The service reads a clock the test moves: the quarantine holds
    until the clock passes the cooldown, however slowly the requests
    run, and then the tenant re-enters with a clean streak."""
    class Clock:
        now = 1000.0
        perf_counter = staticmethod(time.perf_counter)

        def monotonic(self):
            return self.now

    clock = Clock()
    monkeypatch.setattr(service_mod, "time", clock)
    left, right = _inputs(24)

    def fail_once():
        with resilience.fault_plan("pass_dispatch@1=unknown"):
            t = _submit_join(svc, "t", left, right)
            with pytest.raises(CylonError):
                t.result(timeout=WAIT_S)

    with config.knob_env(CYLON_TPU_SERVE_QUARANTINE_AFTER="2",
                         CYLON_TPU_SERVE_QUARANTINE_S="0.05",
                         CYLON_TPU_RETRY_MAX="0",
                         CYLON_TPU_RETRY_BASE_S="0"):
        fail_once()
        fail_once()
        with pytest.raises(CylonError) as ei:
            svc.submit("t", "join", left, right, on="k")
        assert ei.value.code == Code.Unavailable
        assert ei.value.retry_after_s == pytest.approx(0.05)
        clock.now += 0.08  # past the 0.05 s cooldown
        fail_once()
        r, _ = _submit_join(svc, "t", left, right).result(timeout=WAIT_S)
        assert svc.stats()["tenants"]["t"]["quarantined"] is False
    assert_frames_equal(r, _ref_join(left, right, 1))


# ---------------------------------------------------------------------------
# cancellation + graceful drain
# ---------------------------------------------------------------------------

def test_cancel_queued_request(blocked_join):
    started, release = blocked_join
    left, right = _inputs(25)
    svc = QueryService(ctx=CPU, queue_cap=4)
    try:
        first = _submit_join(svc, "a", left, right)
        assert started.wait(WAIT_S)
        queued = _submit_join(svc, "a", left, right)
        assert queued.cancel() is True
        with pytest.raises(CylonError) as ei:
            queued.result(timeout=WAIT_S)
        assert ei.value.code == Code.Cancelled
        assert queued.state == service_mod.CANCELLED
        release.set()
        assert_frames_equal(first.result(timeout=WAIT_S)[0],
                            _ref_join(left, right, 1))
        assert svc.stats()["cancelled"] == 1
    finally:
        release.set()
        svc.close()


def test_cancel_running_request_stops_at_pass_boundary(monkeypatch):
    """The first pass boundary waits until ``cancel()`` has returned; the
    guard then stops the run there (the remaining passes never run)."""
    at_boundary, cancelled = threading.Event(), threading.Event()
    boundaries = []
    orig = service_mod._RUNNERS["join"]

    def runner(*args, pass_guard=None, **kwargs):
        def guard():
            boundaries.append(1)
            if len(boundaries) == 2:
                at_boundary.set()
                assert cancelled.wait(WAIT_S)
            pass_guard()
        return orig(*args, pass_guard=guard, **kwargs)

    monkeypatch.setitem(service_mod._RUNNERS, "join", runner)
    left, right = _inputs(26, n=3000)
    with QueryService(ctx=CPU) as svc:
        t = _submit_join(svc, "c", left, right, passes=6)
        assert at_boundary.wait(WAIT_S)
        assert t.cancel() is True
        cancelled.set()
        with pytest.raises(CylonError) as ei:
            t.result(timeout=WAIT_S)
    assert ei.value.code == Code.Cancelled
    assert t.state == service_mod.CANCELLED
    assert len(boundaries) == 2


def test_drain_sheds_queued_finishes_inflight(blocked_join):
    started, release = blocked_join
    left, right = _inputs(27)
    svc = QueryService(ctx=CPU, queue_cap=4)
    try:
        running = _submit_join(svc, "a", left, right)
        assert started.wait(WAIT_S)
        queued = [_submit_join(svc, "b", left, right) for _ in range(2)]

        def release_once_shed():
            # drain() sheds the queue before it waits on the in-flight
            # request: the runner is released only once both queued
            # tickets have finished, so drain() has seen them queued
            for q in queued:
                assert q._event.wait(WAIT_S)
            release.set()
        threading.Thread(target=release_once_shed, daemon=True).start()
        shed = svc.drain(timeout=WAIT_S)
        assert set(shed) == set(queued)
        for q in queued:
            with pytest.raises(CylonError) as ei:
                q.result(timeout=WAIT_S)
            assert ei.value.code == Code.Unavailable
            assert "draining" in ei.value.msg
            assert q.state == service_mod.SHED
        res, _ = running.result(timeout=WAIT_S)
        assert running.state == service_mod.DONE
        assert_frames_equal(res, _ref_join(left, right, 1))
        with pytest.raises(CylonError) as ei:
            svc.submit("a", "join", left, right, on="k")
        assert ei.value.code == Code.Unavailable
    finally:
        release.set()
        svc.close()


def test_every_op_kind_serves(svc):
    """join, join_groupby, groupby and sort through both services: the
    port's served frames equal the reference's served frames."""
    left, right = _inputs(28)
    data = {"g": left["k"] % 7, "v": left["a"]}
    reqs = [
        ("join", (left, right), dict(on="k", passes=2, mode="hash")),
        ("join_groupby", (left, right),
         dict(on="k", group_by="l_k", agg={"a": ["sum"]}, passes=2,
              mode="hash")),
        ("groupby", (data, "g", {"v": ["sum"]}), dict(passes=2)),
        ("sort", (data, "v"), dict(passes=2)),
    ]
    with RQueryService() as rsvc:
        want = [rsvc.submit("t", op, *a, **kw).result(timeout=WAIT_S)[0]
                for op, a, kw in reqs]
    got = [svc.submit("t", op, *a, **kw).result(timeout=WAIT_S)[0]
           for op, a, kw in reqs]
    for g, w in zip(got, want):
        assert_frames_equal(g, w)
    assert len(got[0]["l_k"]) > 0 and len(got[1]["l_k"]) > 0
    assert len(got[2]["g"]) == 7
    assert np.all(np.diff(got[3]["v"]) >= 0)
    with pytest.raises(CylonError) as ei:
        svc.submit("t", "fuse", data)
    assert ei.value.code == Code.Invalid
    assert service_mod.OPS == ("join", "join_groupby", "groupby", "sort",
                               "plan", "refresh")


# ---------------------------------------------------------------------------
# durable-journal GC: size cap + LRU + manifest-last eviction
# ---------------------------------------------------------------------------

def _journal_three_runs(tmp_path, seed0=30):
    inputs = []
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        for i in range(3):
            l, r = _inputs(seed0 + i)
            pexec.chunked_join(l, r, on="k", passes=2, mode="hash", ctx=CPU)
            inputs.append((l, r))
    return inputs


def test_journal_gc_lru_eviction_respects_access_order(tmp_path):
    inputs = _journal_three_runs(tmp_path)
    runs = serve.contents(str(tmp_path))
    assert len(runs) == 3 and all(r["complete"] for r in runs)
    fps = [r["fingerprint"] for r in runs]  # LRU first = creation order
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        l0, r0 = inputs[0]
        time.sleep(0.02)
        _, s = pexec.chunked_join(l0, r0, on="k", passes=2, mode="hash",
                                  ctx=CPU)
        assert s["passes_skipped"] == s["passes"]
        total = serve.cache_bytes(str(tmp_path))
        biggest = max(r["bytes"] for r in runs)
        with config.knob_env(
                CYLON_TPU_DURABLE_CAP_BYTES=str(total - biggest + 1)):
            evicted, freed = serve.maybe_gc(str(tmp_path))
    assert evicted >= 1 and freed > 0
    left = {r["fingerprint"] for r in serve.contents(str(tmp_path))}
    assert fps[1] not in left
    assert fps[0] in left
    assert obs_metrics.counter_value("durable.gc_runs_evicted") >= 1
    assert obs_metrics.counter_value("serve.cache_evictions") >= 1
    obs_metrics.reset()


def test_journal_gc_cap_unset_is_noop(tmp_path):
    _journal_three_runs(tmp_path, seed0=40)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_DURABLE_CAP_BYTES=None):
        assert serve.maybe_gc(str(tmp_path)) == (0, 0)
    assert len(serve.contents(str(tmp_path))) == 3


def test_half_evicted_run_reexecutes_not_torn(tmp_path):
    left, right = _inputs(50)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        base, _s1 = pexec.chunked_join(left, right, on="k", passes=3,
                                       mode="hash", ctx=CPU)
        run = serve.contents(str(tmp_path))[0]
        for fn in os.listdir(run["dir"]):
            if fn != durable.MANIFEST:
                os.remove(os.path.join(run["dir"], fn))
        res, s2 = pexec.chunked_join(left, right, on="k", passes=3,
                                     mode="hash", ctx=CPU)
    assert s2["passes_skipped"] == 0
    assert s2["parts_run"] == s2["passes"]
    _bit_identical(res, base)
    assert_frames_equal(res, _ref_join(left, right, 3))


def test_gc_runs_after_service_requests(tmp_path):
    """A journaled run completing under the service triggers the cap GC
    (the engine runs it when it records the run done)."""
    l0, r0 = _inputs(60)
    l1, r1 = _inputs(61)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        pexec.chunked_join(l0, r0, on="k", passes=2, mode="hash", ctx=CPU)
        one = serve.cache_bytes(str(tmp_path))
        with config.knob_env(CYLON_TPU_DURABLE_CAP_BYTES=str(one + 1)):
            with QueryService(ctx=CPU) as svc:
                _submit_join(svc, "t", l1, r1, passes=2).result(
                    timeout=WAIT_S)
        runs = serve.contents(str(tmp_path))
    assert len(runs) == 1
    assert obs_metrics.counter_value("durable.gc_runs_evicted") >= 1
    obs_metrics.reset()


# ---------------------------------------------------------------------------
# per-tenant SLO latency histograms
# ---------------------------------------------------------------------------

def test_per_tenant_slo_latency_histograms():
    obs_metrics.reset()
    left, right = _inputs(70, n=600)
    with QueryService(ctx=CPU) as svc:
        for _ in range(2):
            _submit_join(svc, "slo-a", left, right).result(timeout=WAIT_S)
        tb = _submit_join(svc, "slo-b", left, right)
        tb.result(timeout=WAIT_S)
        tel = svc.telemetry()
    h = obs_metrics.snapshot()["histograms"]
    qa, ra = h["serve.queue_wait_ms[slo-a]"], h["serve.run_ms[slo-a]"]
    assert qa["count"] == 2 and ra["count"] == 2
    assert h["serve.queue_wait_ms[slo-b]"]["count"] == 1
    assert h["serve.run_ms[slo-b]"]["count"] == 1
    assert qa["min"] >= 0 and ra["min"] > 0
    assert ra["sum"] >= ra["max"] >= ra["min"]
    assert ra["le"]["+Inf"] == 2  # the cumulative buckets ride along
    assert tb.queue_wait_s is not None and tb.queue_wait_s >= 0
    assert tb.duration_s is not None and tb.duration_s > 0
    assert tel["queue_depth"] == 0
    a = tel["tenants"]["slo-a"]
    assert a["served"] == 2 and a["queue_wait_ms"]["count"] == 2
    assert a["run_ms"]["count"] == 2
    assert tel["tenants"]["slo-b"]["served"] == 1
    with QueryService(ctx=CPU) as svc2:
        assert svc2.telemetry()["tenants"] == {}

        class _Agent:
            rank = 3
            fn = None

            def attach_telemetry(self, fn):
                self.fn = fn

        agent = _Agent()
        assert svc2.attach_to_agent(agent) is svc2
        assert agent.fn() == svc2.telemetry()
    obs_metrics.reset()


def test_slo_histograms_record_failures_too(monkeypatch):
    """A failing request still lands a run_ms observation, and its
    failure is the ticket's classified error (an out-of-memory error
    classifies as ``Code.OutOfMemory``, never a silent retry)."""
    import torch

    obs_metrics.reset()

    def boom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 2.00 GiB")

    monkeypatch.setitem(service_mod._RUNNERS, "join", boom)
    left, right = _inputs(71, n=200)
    with config.knob_env(CYLON_TPU_SERVE_QUARANTINE_AFTER="0"):
        with QueryService(ctx=CPU) as svc:
            t = _submit_join(svc, "slo-f", left, right)
            with pytest.raises(CylonError) as ei:
                t.result(timeout=WAIT_S)
    assert ei.value.code == Code.OutOfMemory
    assert t.state == service_mod.FAILED
    h = obs_metrics.snapshot()["histograms"]
    assert h["serve.queue_wait_ms[slo-f]"]["count"] == 1
    assert h["serve.run_ms[slo-f]"]["count"] == 1
    obs_metrics.reset()


def test_register_op_runs_on_the_scheduler_thread():
    """A custom op registered on the service runs on its scheduler thread
    with the request's guard and the service's context, and
    ``idempotent=True`` lists it as hedge-safe."""
    seen = []

    def runner(x, *, ctx=None, pass_guard=None):
        pass_guard()
        seen.append((x, ctx.devices[0].type, threading.current_thread()
                     .name))
        return {"x": np.array([x])}, {"passes": 1}

    with QueryService(ctx=CPU, name="custom") as svc:
        svc.register_op("echo", runner, idempotent=True)
        r, st = svc.submit("t", "echo", 7).result(timeout=WAIT_S)
        assert svc.idempotent_ops() == ["echo"]
    assert r["x"].tolist() == [7] and st == {"passes": 1}
    assert seen == [(7, "cpu", "cylon-custom")]


def test_scheduler_thread_binds_the_context_card(monkeypatch):
    """The scheduler thread binds the context's card by index (a bare
    "cuda" is the constructing thread's current card) before its first
    request; a bind that fails fails each request classified, and a
    runner's malformed result fails its ticket: nothing hangs."""
    import torch
    from types import SimpleNamespace

    binds = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: binds.append(
        (i, threading.current_thread().name)))

    def noop(*, ctx=None, pass_guard=None):
        return {"x": np.arange(2)}, {"passes": 1}

    for dev, want in (("cuda", 3), ("cuda:1", 1)):
        binds.clear()
        ctx = SimpleNamespace(devices=[torch.device(dev)])
        with QueryService(ctx=ctx, name="bind") as svc:
            svc.register_op("noop", noop)
            r, _ = svc.submit("t", "noop").result(timeout=WAIT_S)
        assert binds == [(want, "cylon-bind")] and r["x"].tolist() == [0, 1]

    def refuse(i):
        raise RuntimeError("CUDA error: invalid device ordinal")

    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    with config.knob_env(CYLON_TPU_SERVE_QUARANTINE_AFTER="0"):
        with QueryService(ctx=SimpleNamespace(
                devices=[torch.device("cuda")])) as svc:
            svc.register_op("noop", noop)
            svc.register_op("bad", lambda *, ctx=None, pass_guard=None: 7)
            for _ in range(2):
                t = svc.submit("t", "noop")
                with pytest.raises(CylonError):
                    t.result(timeout=WAIT_S)
                assert t.state == service_mod.FAILED
    with QueryService(ctx=CPU) as svc:
        svc.register_op("bad", lambda *, ctx=None, pass_guard=None: 7)
        with pytest.raises(CylonError):
            svc.submit("t", "bad").result(timeout=WAIT_S)
        svc.register_op("noop", noop)
        assert svc.submit("t", "noop").result(timeout=WAIT_S)[1] == {
            "passes": 1}
