"""The port's fleet query router (cylon_tpu_torch/router/), the
counterpart of ``tests/test_router.py``: many serving replicas behind one
front door, every replica a `QueryService` on a CPU context.

The shapes: a tenant flood across two replicas is served with zero hangs and every shed classified with a
``retry_after_s`` hint; a repeated plan fingerprint is a cache hit on a
replica that never executed it (the shared durable journal as a
fleet-wide result cache — ``plan_cache.miss`` == 0, ``serve.cache_hit``
recorded); and killing one replica re-routes its queued-not-dispatched
requests to the survivor bit-identical to the single-replica oracle
while in-flight work is abandoned with a classified retryable error —
never a hang, never a silent loss.

Everything here is in-process (threads): the router, its replicas and
their agents share one interpreter, so death is rendered by stopping a
replica's heartbeats + data-plane server and letting the coordinator's
failure detector fence it.  The cross-process rendering is
``test_flood_with_a_replica_process_killed`` (two
``tests/torch_router_worker.py`` processes).  Then the cross-package
cases: a reference ``RouterClient`` routed through the port's router
gets the port's frames bit for bit, and the unchanged
``tools/fleet_status.py`` reads the port's router status.
"""
import json
import threading
import time

import numpy as np
import pytest

from cylon_tpu_torch import CylonContext, config, durable, elastic, resilience
from cylon_tpu_torch.router import replica as replica_mod
from cylon_tpu_torch.exec import chunked_join
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.router import (QueryRouter, ReplicaServer,
                                    RouterClient, wire)
from cylon_tpu_torch.serve import QueryService
from cylon_tpu_torch.status import Code, CylonError

from .torch_lock_record import port_lock_record  # noqa: F401

#: hard per-request wait — any miss is a hang, the exact failure mode
#: the router tier exists to eliminate
WAIT_S = 120.0

SHED_CODES = (Code.ResourceExhausted, Code.Unavailable)

CPU = CylonContext.Init("cpu")


def _inputs(seed, n=1200):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, n, n).astype(np.int64),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int64),
             "b": rng.random(n).astype(np.float32)}
    return left, right


def _assert_bit_identical(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

def test_wire_roundtrip_frames_arrays_scalars():
    rng = np.random.default_rng(0)
    frame = {"k": rng.integers(0, 50, 40).astype(np.int64),
             "v": rng.random(40).astype(np.float32),
             "s": np.array(["a", "bb", ""] * 13 + ["x"], dtype=object)}
    args = (frame, np.arange(7, dtype=np.int32), 3, "on", 2.5, None, True)
    kwargs = {"on": "k", "passes": 2, "opts": {"nested": [1, "two"]},
              "arr": np.float64(1.25)}
    payload = wire.encode_payload(args, kwargs)
    dargs, dkwargs = wire.decode_payload(payload)
    _assert_bit_identical(dargs[0], frame)
    np.testing.assert_array_equal(dargs[1], args[1])
    assert dargs[1].dtype == np.int32
    assert dargs[2:] == [3, "on", 2.5, None, True]
    assert dkwargs["on"] == "k" and dkwargs["passes"] == 2
    assert dkwargs["opts"] == {"nested": [1, "two"]}
    assert dkwargs["arr"] == 1.25


def test_wire_nan_payloads_roundtrip_bit_exact():
    a = np.array([1.0, np.nan, np.inf, -0.0], dtype=np.float64)
    # a specific NaN payload must survive the wire (journal discipline)
    a[1] = np.frombuffer(np.uint64(0x7FF80000DEADBEEF).tobytes(),
                         dtype=np.float64)[0]
    out = wire.decode_value(wire.encode_value({"x": a}))
    np.testing.assert_array_equal(out["x"].view(np.uint64),
                                  a.view(np.uint64))


def test_wire_refuses_unserializable_and_marker_collisions():
    with pytest.raises(CylonError) as ei:
        wire.encode_value(object())
    assert ei.value.code == Code.SerializationError
    # pyarrow's own refusals (2-D columns, structured dtypes) must come
    # out CLASSIFIED too, on both the bare-array and frame branches
    with pytest.raises(CylonError) as ei:
        wire.encode_value(np.ones((2, 2)))
    assert ei.value.code == Code.SerializationError
    with pytest.raises(CylonError) as ei:
        wire.encode_value({"m": np.ones((2, 2))})
    assert ei.value.code == Code.SerializationError
    with pytest.raises(CylonError) as ei:
        wire.encode_value({wire.FRAME_KEY: "spoof"})
    assert ei.value.code == Code.SerializationError
    with pytest.raises(CylonError) as ei:
        wire.decode_payload("not a dict")
    assert ei.value.code == Code.SerializationError
    # DECODE-side refusals are classified too: corrupt base64 and
    # malformed Arrow IPC must not escape as UnknownError through a
    # replica's submit handler
    with pytest.raises(CylonError) as ei:
        wire.decode_value({wire.FRAME_KEY: "!!not base64!!"})
    assert ei.value.code == Code.SerializationError
    with pytest.raises(CylonError) as ei:
        wire.decode_value({wire.ARRAY_KEY: wire._b64(b"not arrow ipc")})
    assert ei.value.code == Code.SerializationError


def test_request_key_is_content_only_and_stable():
    l, r = _inputs(1, n=64)
    p1 = wire.encode_payload((l, r), {"on": "k"})
    p2 = wire.encode_payload((l, r), {"on": "k"})
    assert wire.request_key("join", p1) == wire.request_key("join", p2)
    assert wire.request_key("sort", p1) != wire.request_key("join", p1)
    l2 = dict(l, a=l["a"] + 1)
    p3 = wire.encode_payload((l2, r), {"on": "k"})
    assert wire.request_key("join", p3) != wire.request_key("join", p1)


# ---------------------------------------------------------------------------
# an in-process fleet
# ---------------------------------------------------------------------------

class Fleet:
    """Router + N in-process replicas with fast heartbeats."""

    def __init__(self, n=2, queue_cap=16, hb_timeout=0.6):
        self.router = QueryRouter(world=n,
                                  heartbeat_timeout_s=hb_timeout).start()
        self.addr = f"{self.router.address[0]}:{self.router.address[1]}"
        self.client = RouterClient(self.addr)
        self.svcs, self.reps, self.agents = [], [], []
        for r in range(n):
            svc = QueryService(ctx=CPU, name=f"replica{r}",
                               queue_cap=queue_cap)
            rep = ReplicaServer(svc)
            agent = elastic.Agent(self.addr, r, interval_s=0.05,
                                  timeout_s=max(4 * 0.05, hb_timeout),
                                  reconnect_s=5.0).start()
            rep.attach(agent)
            self.svcs.append(svc)
            self.reps.append(rep)
            self.agents.append(agent)

    def kill(self, rank: int) -> None:
        """Process-death rendering: heartbeats stop, the data plane
        refuses — the detector fences the rank one timeout later."""
        self.agents[rank].stop()
        self.reps[rank].close()

    def close(self) -> None:
        for a in self.agents:
            try:
                a.leave()
            except Exception:
                pass
        for rep in self.reps:
            rep.close()
        for svc in self.svcs:
            svc.close(timeout=5.0)
        self.router.stop()


@pytest.fixture()
def fleet():
    with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="90"):
        f = Fleet()
        try:
            yield f
        finally:
            f.close()


def _gate_runner(release: threading.Event,
                 started: threading.Event = None):
    """An instance serve op that parks the replica's scheduler until
    released — placement outcomes become a pure function of the
    submission sequence."""
    def run(*args, ctx=None, pass_guard=None, **kw):
        if started is not None:
            started.set()
        assert release.wait(WAIT_S), "gate never released"
        return {"ok": np.array([1])}, {}
    return run


# ---------------------------------------------------------------------------
# routing basics: placement, affinity, classified shedding
# ---------------------------------------------------------------------------

def test_route_serves_bit_identical_and_counts(fleet):
    left, right = _inputs(10)
    base, _ = chunked_join(left, right, on="k", passes=1, mode="hash",
                           ctx=CPU)
    res, stats = fleet.client.route("acme", "join", left, right, on="k",
                                    passes=1, mode="hash",
                                    timeout_s=WAIT_S)
    _assert_bit_identical(res, base)
    assert stats["router"]["replica"] in (0, 1)
    assert stats["router"]["reroutes"] == 0
    st = fleet.client.status()["router"]
    assert st["routed"] == 1 and st["sheds"] == 0
    assert st["replicas_live"] == 2
    row = st["replicas"][str(stats["router"]["replica"])]
    assert row["served"] == 1
    assert "acme" in row["tenants_pinned"]
    assert obs_metrics.counter_value("router.requests_routed") >= 1


def test_tenant_affinity_sticks_under_load(fleet):
    left, right = _inputs(11)
    # prime: tenant t1's first request lands on the tie-break replica 0
    _, s1 = fleet.client.route("t1", "join", left, right, on="k",
                               passes=1, mode="hash", timeout_s=WAIT_S)
    assert s1["router"]["replica"] == 0
    # occupy replica 0 with a gated request so least-load says replica 1
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    gate_out = {}

    def gated():
        gate_out["stats"] = fleet.client.route(
            "gate-tenant", "gate", timeout_s=WAIT_S)[1]
    gt = threading.Thread(target=gated, daemon=True)
    gt.start()
    assert started.wait(WAIT_S)
    try:
        # t1 sticks to its pinned (busier) replica 0; a fresh tenant
        # follows least load to replica 1.  The fresh tenant sends other
        # content: the pin is taken at accept, so the same content would
        # race t1's accept for the warm-replica (cache) affinity
        l2, r2 = _inputs(12)
        l3, r3 = _inputs(14)
        done = {}

        def pinned():
            done["stats"] = fleet.client.route(
                "t1", "join", l2, r2, on="k", passes=1, mode="hash",
                timeout_s=WAIT_S)[1]
        pt = threading.Thread(target=pinned, daemon=True)
        pt.start()
        _, s3 = fleet.client.route("t2", "join", l3, r3, on="k",
                                   passes=1, mode="hash",
                                   timeout_s=WAIT_S)
        assert s3["router"]["replica"] == 1
    finally:
        release.set()
    pt.join(WAIT_S)
    gt.join(WAIT_S)
    assert not pt.is_alive() and not gt.is_alive()
    assert done["stats"]["router"]["replica"] == 0
    assert gate_out["stats"]["router"]["replica"] == 0


def test_cache_affinity_steers_repeat_fingerprint(fleet):
    """A repeated request fingerprint is steered to the replica whose
    caches are warm even when least-load prefers the other; with the
    knob off, least-load wins again."""
    left, right = _inputs(13)
    _, s1 = fleet.client.route("u1", "join", left, right, on="k",
                               passes=1, mode="hash", timeout_s=WAIT_S)
    assert s1["router"]["replica"] == 0
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    gt = threading.Thread(
        target=lambda: fleet.client.route("gate-tenant", "gate",
                                          timeout_s=WAIT_S),
        daemon=True)
    gt.start()
    assert started.wait(WAIT_S)
    try:
        done = {}

        def warm():
            # DIFFERENT tenant, identical content: the fingerprint pin
            # (not the tenant pin) must be what steers it to replica 0
            done["stats"] = fleet.client.route(
                "u2", "join", left, right, on="k", passes=1,
                mode="hash", timeout_s=WAIT_S)[1]
        wt = threading.Thread(target=warm, daemon=True)
        wt.start()
        # u2 must be ACCEPTED (queued behind the gate on replica 0)
        # before the knob-off control below re-pins the fingerprint
        deadline = time.monotonic() + WAIT_S
        while fleet.svcs[0].queue_depth() < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.svcs[0].queue_depth() == 1
        # knob off: the same repeat follows least load to replica 1
        with config.knob_env(CYLON_TPU_ROUTER_CACHE_AFFINITY="0"):
            _, s3 = fleet.client.route("u3", "join", left, right,
                                       on="k", passes=1, mode="hash",
                                       timeout_s=WAIT_S)
        assert s3["router"]["replica"] == 1
    finally:
        release.set()
    wt.join(WAIT_S)
    gt.join(WAIT_S)
    assert done["stats"]["router"]["replica"] == 0


def test_no_replicas_sheds_unavailable():
    with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="30"):
        router = QueryRouter(world=1, heartbeat_timeout_s=0.5).start()
        try:
            cli = RouterClient(
                f"{router.address[0]}:{router.address[1]}")
            left, right = _inputs(14, n=64)
            with pytest.raises(CylonError) as ei:
                cli.route("t", "join", left, right, on="k",
                          timeout_s=WAIT_S)
            assert ei.value.code == Code.Unavailable
            assert "no live serving replicas" in ei.value.msg
            assert ei.value.retry_after_s is not None
        finally:
            router.stop()


def test_fleet_saturation_sheds_classified_with_retry_after():
    """Both replicas at queue capacity: the router answers the fleet
    shed — classified ResourceExhausted + retry_after_s, never a
    hang."""
    with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="90"):
        f = Fleet(queue_cap=1)
        releases = []
        starteds = []
        threads = []
        try:
            for r in range(2):
                rel, st = threading.Event(), threading.Event()
                releases.append(rel)
                starteds.append(st)
                f.svcs[r].register_op("gate", _gate_runner(rel, st))

            # 2 running + 2 queued fill both single-slot queues.
            # Staggered: each fill is OBSERVED (running / queued)
            # before the next submits, so placement is a deterministic
            # function of the in-flight reservations — the shared
            # fingerprint's warm pin must NOT pile them onto replica 0
            # (the affinity gate counts router-held in-flight too).
            def fill(i):
                t = threading.Thread(
                    target=lambda: f.client.route(f"fill{i}", "gate",
                                                  timeout_s=WAIT_S),
                    daemon=True)
                t.start()
                threads.append(t)

            fill(0)
            assert starteds[0].wait(WAIT_S)  # running on replica 0
            fill(1)
            assert starteds[1].wait(WAIT_S)  # spread to replica 1
            fill(2)
            deadline = time.monotonic() + WAIT_S
            while (f.svcs[0].queue_depth() + f.svcs[1].queue_depth() < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            fill(3)
            deadline = time.monotonic() + WAIT_S
            while (f.svcs[0].queue_depth() + f.svcs[1].queue_depth() < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert f.svcs[0].queue_depth() == 1
            assert f.svcs[1].queue_depth() == 1
            t0 = time.monotonic()
            with pytest.raises(CylonError) as ei:
                f.client.route("over", "gate", timeout_s=WAIT_S)
            assert time.monotonic() - t0 < 30.0  # shed NOW, not a hang
            assert ei.value.code == Code.ResourceExhausted
            assert ei.value.retry_after_s is not None
            assert ei.value.retry_after_s > 0
            assert obs_metrics.counter_value("router.sheds") >= 1
            st = f.client.status()["router"]
            assert st["sheds"] >= 1
        finally:
            for rel in releases:
                rel.set()
            for t in threads:
                t.join(WAIT_S)
            f.close()
        assert all(not t.is_alive() for t in threads)


def test_hbm_headroom_guard_sheds_at_placement(fleet):
    """Replicas reporting no HBM headroom for the request are skipped;
    when none fits, the shed is classified at the router."""
    with config.knob_env(CYLON_TPU_SERVE_HBM_BUDGET_BYTES="1"):
        # push fresh telemetry carrying the 1-byte budget's headroom
        for rep, agent in zip(fleet.reps, fleet.agents):
            agent.beat_now()
        left, right = _inputs(15)
        with pytest.raises(CylonError) as ei:
            fleet.client.route("mem", "join", left, right, on="k",
                               timeout_s=WAIT_S)
    assert ei.value.code == Code.ResourceExhausted
    assert "headroom" in ei.value.msg
    assert ei.value.retry_after_s is not None


def test_unknown_op_propagates_invalid_not_rotated(fleet):
    left, right = _inputs(16, n=64)
    with pytest.raises(CylonError) as ei:
        fleet.client.route("t", "fuse", left, right, timeout_s=WAIT_S)
    assert ei.value.code == Code.Invalid
    # a deterministic failure is NOT a shed and is not retried around
    assert fleet.client.status()["router"]["sheds"] == 0


def test_oversized_request_classified_client_side(fleet):
    rng = np.random.default_rng(17)
    big = {"v": rng.random(3_000_000)}  # ~24MB -> ~32MB base64
    with config.knob_env(CYLON_TPU_ROUTER_MAX_LINE_BYTES=str(1 << 20)):
        with pytest.raises(CylonError) as ei:
            fleet.client.route("t", "sort", big, "v", timeout_s=WAIT_S)
    assert ei.value.code == Code.SerializationError
    assert "CYLON_TPU_ROUTER_MAX_LINE_BYTES" in ei.value.msg
    # the NON-payload fields count too: a pathological tenant string
    # past the cap is the same deterministic classified refusal, not a
    # server-side connection drop read back as retryable Unavailable
    l, r = _inputs(18, n=16)
    with config.knob_env(CYLON_TPU_ROUTER_MAX_LINE_BYTES=str(1 << 20)):
        with pytest.raises(CylonError) as ei:
            fleet.client.route("x" * (2 << 20), "join", l, r, on="k",
                               timeout_s=WAIT_S)
    assert ei.value.code == Code.SerializationError
    assert "CYLON_TPU_ROUTER_MAX_LINE_BYTES" in ei.value.msg


def test_stale_router_sheds_classified_retryable(fleet):
    """A superseded router incarnation (a split-brain) answers the
    route verb with its stand-down marker — the client must see a
    retryable Unavailable, never an UnknownError that reads as a bug."""
    left, right = _inputs(18, n=64)
    fleet.router.stale = True
    try:
        with pytest.raises(CylonError) as ei:
            fleet.client.route("t", "join", left, right, on="k",
                               timeout_s=30)
    finally:
        fleet.router.stale = False
    assert ei.value.code == Code.Unavailable
    assert "stale" in ei.value.msg
    assert ei.value.retry_after_s is not None


def test_route_deadline_classifies_timeout(fleet):
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    fleet.svcs[1].register_op("gate", _gate_runner(release, started))
    try:
        t0 = time.monotonic()
        with pytest.raises(CylonError) as ei:
            fleet.client.route("slow", "gate", deadline_s=0.3,
                               timeout_s=WAIT_S)
        assert ei.value.code == Code.Timeout
        assert time.monotonic() - t0 < 30.0
    finally:
        release.set()


# ---------------------------------------------------------------------------
# the shared journal as a fleet-wide result cache
# ---------------------------------------------------------------------------

def test_cross_replica_cache_hit_zero_compiles(fleet, tmp_path):
    """Replica 1 serves replica 0's journaled fingerprint with zero
    plan-cache misses and zero device passes: the shared
    CYLON_TPU_DURABLE_DIR is the fleet-wide result cache — affinity is
    a latency optimization, never a correctness requirement."""
    left, right = _inputs(20)
    base, _ = chunked_join(left, right, on="k", passes=3, mode="hash",
                           ctx=CPU)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        r1, s1 = fleet.client.route("a", "join", left, right, on="k",
                                    passes=3, mode="hash",
                                    timeout_s=WAIT_S)
        first = s1["router"]["replica"]
        assert first == 0 and s1["router"]["cache_hit"] is False
        _assert_bit_identical(r1, base)
        # the journaling replica leaves the fleet: the repeat MUST land
        # on the replica that never executed this fingerprint
        fleet.agents[0].leave()
        fleet.reps[0].close()
        deadline = time.monotonic() + WAIT_S
        while (0 in fleet.router.view().members
               and time.monotonic() < deadline):
            time.sleep(0.02)
        obs_metrics.reset()
        r2, s2 = fleet.client.route("b", "join", left, right, on="k",
                                    passes=3, mode="hash",
                                    timeout_s=WAIT_S)
    assert s2["router"]["replica"] == 1
    assert s2["router"]["cache_hit"] is True
    assert s2["passes_skipped"] == s2["passes"]
    # the acceptance meter: the serving replica never compiled or ran a
    # device pass for this fingerprint
    assert obs_metrics.counter_value("plan_cache.miss") == 0
    assert obs_metrics.counter_value("exec.parts_run") == 0
    assert obs_metrics.counter_value("serve.cache_hit") == 1
    _assert_bit_identical(r2, base)
    obs_metrics.reset()


# ---------------------------------------------------------------------------
# replica death: re-route queued, abandon in-flight — classified only
# ---------------------------------------------------------------------------

def test_replica_kill_reroutes_queued_abandons_inflight(fleet):
    """Kill a replica holding one running + two queued requests: the
    queued ones land on the survivor bit-identical to the oracle, the
    in-flight one gets a classified retryable error, nothing hangs."""
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    # deterministic "the router saw it running": spy on replica 0's
    # poll verb — the abandon-don't-retry branch requires the router to
    # have OBSERVED the running state before the kill
    observed_running = threading.Event()
    orig_poll = fleet.reps[0]._handle_poll

    def spy_poll(req):
        resp = orig_poll(req)
        if resp.get("state") == "running":
            observed_running.set()
        return resp

    fleet.reps[0]._handle_poll = spy_poll
    oracles, outs, errs = {}, {}, {}
    threads = []

    def do_route(name, *args, **kw):
        try:
            outs[name] = fleet.client.route(*args, timeout_s=WAIT_S,
                                            **kw)
        except CylonError as e:
            errs[name] = e

    # r0 runs (and blocks) on replica 0, pinning tenant "t" there
    t_run = threading.Thread(target=do_route,
                             args=("inflight", "t", "gate"), daemon=True)
    t_run.start()
    threads.append(t_run)
    assert started.wait(WAIT_S)
    # two joins queue behind it on replica 0 (tenant pin; not saturated)
    for i in range(2):
        left, right = _inputs(30 + i)
        oracles[f"q{i}"] = (chunked_join(left, right, on="k", passes=1,
                                         mode="hash", ctx=CPU)[0])
        t = threading.Thread(
            target=do_route,
            args=(f"q{i}", "t", "join", left, right),
            kwargs=dict(on="k", passes=1, mode="hash"), daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + WAIT_S
    while fleet.svcs[0].queue_depth() < 2 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert fleet.svcs[0].queue_depth() == 2
    assert observed_running.wait(WAIT_S)
    fleet.kill(0)
    for t in threads:
        t.join(WAIT_S)
    assert all(not t.is_alive() for t in threads), "a routed request hung"
    # queued-not-dispatched work re-routed to the survivor, bit-exact
    for i in range(2):
        res, stats = outs[f"q{i}"]
        assert stats["router"]["replica"] == 1
        assert stats["router"]["reroutes"] == 1
        _assert_bit_identical(res, oracles[f"q{i}"])
    # the in-flight request followed abandon-don't-retry: classified,
    # retryable, with a hint — never silently re-executed
    e = errs["inflight"]
    assert e.code == Code.Unavailable
    assert "abandoned" in e.msg
    assert e.retry_after_s is not None
    st = fleet.client.status()["router"]
    assert st["reroutes"] == 2 and st["abandoned"] == 1
    assert obs_metrics.counter_value("router.reroutes") >= 2
    release.set()


def test_router_restart_rebuilds_routing_from_heartbeats(fleet):
    """The router restarts in place (the coordinator's restart): replicas ride
    through, the next heartbeat round repopulates the routing table,
    and routing resumes — no replica-side re-registration
    choreography."""
    left, right = _inputs(40)
    base, _ = chunked_join(left, right, on="k", passes=1, mode="hash",
                           ctx=CPU)
    fleet.client.route("t", "join", left, right, on="k", passes=1,
                       mode="hash", timeout_s=WAIT_S)
    inc0 = fleet.router.incarnation
    fleet.router.restart(down_s=0.0)
    assert fleet.router.incarnation == inc0 + 1
    deadline = time.monotonic() + WAIT_S
    res = None
    while time.monotonic() < deadline:
        try:
            res, stats = fleet.client.route(
                "t", "join", left, right, on="k", passes=1,
                mode="hash", timeout_s=WAIT_S)
            break
        except CylonError as e:
            # classified Unavailable while the heartbeat round refills
            # the placement view — never an unclassified failure
            assert e.code in SHED_CODES, e
            time.sleep(0.05)
    assert res is not None, "routing never resumed after restart"
    _assert_bit_identical(res, base)


# ---------------------------------------------------------------------------
# the 2-replica acceptance flood
# ---------------------------------------------------------------------------

def test_flood_across_two_replicas_with_midflood_kill(tmp_path):
    """The acceptance scenario: a tenant flood across two replicas is
    served with zero hangs, every shed classified with
    retry_after_s, a repeated fingerprint is a cache hit on a replica
    that never executed it, and killing one replica mid-flood re-routes
    its queued requests to the survivor bit-identical to the
    single-replica oracle."""
    tenants = ["t0", "t1", "t2"]
    per_tenant = {t: _inputs(50 + i) for i, t in enumerate(tenants)}
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        oracle = {t: chunked_join(l, r, on="k", passes=2, mode="hash",
                                  ctx=CPU)[0]
                  for t, (l, r) in per_tenant.items()}
        with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="90"):
            # heartbeats must hold on a loaded box (the 0.6 s default
            # fenced both replicas before the gate was placed when the
            # suite's parallel workers shared the cores); the kill is
            # seen by the proxy path's refused polls, not by the
            # heartbeat timeout
            f = Fleet(queue_cap=3, hb_timeout=5.0)
            release, started = threading.Event(), threading.Event()
            # a gate on replica 0 guarantees queued work EXISTS there at
            # kill time (mid-flood, deterministically)
            f.svcs[0].register_op("gate", _gate_runner(release, started))
            served, shed, hung, gate_refused = [], [], [], []
            lock = threading.Lock()

            def one(tenant, i):
                l, r = per_tenant[tenant]
                try:
                    res, stats = f.client.route(
                        tenant, "join", l, r, on="k", passes=2,
                        mode="hash", timeout_s=WAIT_S)
                    with lock:
                        served.append((tenant, res, stats))
                except CylonError as e:
                    with lock:
                        shed.append((tenant, e))
                except Exception as e:  # noqa: BLE001 - accounting
                    with lock:
                        hung.append((tenant, i, e))
            threads = []
            try:
                # pin tenant t0 to replica 0 via the gate, then flood
                def gated():
                    try:
                        f.client.route("t0", "gate", timeout_s=WAIT_S)
                    except CylonError as e:
                        # abandoned at the kill, as designed; a refusal
                        # before it started is the fixture failing
                        gate_refused.append(e)
                        if not started.is_set():
                            started.set()
                gate_thread = threading.Thread(target=gated, daemon=True)
                gate_thread.start()
                threads.append(gate_thread)
                assert started.wait(WAIT_S)
                assert not gate_refused, gate_refused
                for wave in range(4):
                    for i, t in enumerate(tenants):
                        th = threading.Thread(target=one, args=(t, wave),
                                              daemon=True)
                        th.start()
                        threads.append(th)
                # kill replica 0 mid-flood, with t0's work queued on it
                deadline = time.monotonic() + WAIT_S
                while f.svcs[0].queue_depth() < 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.005)
                f.kill(0)
                for th in threads:
                    th.join(WAIT_S)
                assert all(not th.is_alive() for th in threads), \
                    "a flood request hung"
                assert not hung, hung
                # every request is accounted: served exact or shed
                # classified — nothing lost, nothing unclassified
                assert len(served) + len(shed) == 12
                for t, res, stats in served:
                    _assert_bit_identical(res, oracle[t])
                    assert stats["router"]["replica"] == 1 \
                        or stats["router"]["reroutes"] == 0
                for t, e in shed:
                    assert e.code in SHED_CODES, (t, e)
                    assert e.retry_after_s is None or e.retry_after_s > 0
                assert any(s[2]["router"]["reroutes"] >= 1
                           for s in served) or shed, \
                    "the kill left no observable trace"
                # the repeated-fingerprint leg: re-route the hottest
                # tenant's content again — it MUST be a cache hit on the
                # survivor (which may never have executed it)
                t0 = tenants[0]
                l, r = per_tenant[t0]
                res, stats = f.client.route(t0, "join", l, r, on="k",
                                            passes=2, mode="hash",
                                            timeout_s=WAIT_S)
                assert stats["router"]["replica"] == 1
                assert stats["router"]["cache_hit"] is True
                assert stats["passes_skipped"] == stats["passes"]
                _assert_bit_identical(res, oracle[t0])
                st = f.client.status()["router"]
                assert st["routed"] == len(served) + 1
                assert st["sheds"] == len(shed)
            finally:
                release.set()
                f.close()


def test_oversized_result_classified_not_replica_death():
    """A result past the wire cap is a DETERMINISTIC SerializationError
    naming the knob — not three 'transient' poll failures declaring a
    healthy replica dead and re-routing into the same wall forever."""
    n = 400  # all-same-key join: tiny request, 160k-row result (>1MiB)
    left = {"k": np.zeros(n, np.int64),
            "a": np.arange(n, dtype=np.float32)}
    right = {"k": np.zeros(n, np.int64),
             "b": np.arange(n, dtype=np.float32)}
    with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="90",
                         CYLON_TPU_ROUTER_MAX_LINE_BYTES=str(1 << 20)):
        f = Fleet()
        try:
            with pytest.raises(CylonError) as ei:
                f.client.route("t", "join", left, right, on="k",
                               passes=1, mode="hash", timeout_s=WAIT_S)
            assert ei.value.code == Code.SerializationError
            assert "CYLON_TPU_ROUTER_MAX_LINE_BYTES" in ei.value.msg
            st = f.client.status()["router"]
            assert st["reroutes"] == 0 and st["abandoned"] == 0
        finally:
            f.close()


def test_oversized_reply_at_client_cap_classified(fleet):
    """Knobs are read per process: when only the CLIENT's cap is low
    (the router's own server cap is the default), the reply chokes at
    the client's recv — still a deterministic SerializationError naming
    the knob, never a retryable 'router unreachable'."""
    n = 400  # all-same-key join: tiny request, 160k-row result (>1MiB)
    left = {"k": np.zeros(n, np.int64),
            "a": np.arange(n, dtype=np.float32)}
    right = {"k": np.zeros(n, np.int64),
             "b": np.arange(n, dtype=np.float32)}
    with config.knob_env(CYLON_TPU_ROUTER_MAX_LINE_BYTES=str(1 << 20)):
        with pytest.raises(CylonError) as ei:
            fleet.client.route("t", "join", left, right, on="k",
                               passes=1, mode="hash", timeout_s=WAIT_S)
    assert ei.value.code == Code.SerializationError
    assert "CYLON_TPU_ROUTER_MAX_LINE_BYTES" in ei.value.msg


# ---------------------------------------------------------------------------
# proxy delivery: terminal-until-ack, idempotent submit tokens
# ---------------------------------------------------------------------------

def test_terminal_reply_survives_until_acked(fleet):
    """A terminal poll does NOT drop the ticket: a reply lost on the
    wire (rendered here as simply polling again) is regenerated by the
    retried poll; the ticket drops only at the router's ack, after
    which the req_id answers classified Invalid."""
    left, right = _inputs(70, n=200)
    payload = wire.encode_payload(
        (left, right), {"on": "k", "passes": 1, "mode": "hash"})
    addr = fleet.reps[0].address
    resp = elastic.control.request(
        addr, {"cmd": "submit", "tenant": "t", "op": "join",
               "payload": payload})
    assert resp["ok"]
    rid = resp["req_id"]
    deadline = time.monotonic() + WAIT_S
    p1 = None
    while time.monotonic() < deadline:
        p1 = elastic.control.request(addr,
                                     {"cmd": "poll", "req_id": rid})
        if p1.get("state") == "done":
            break
        time.sleep(0.02)
    assert p1 is not None and p1["state"] == "done"
    p2 = elastic.control.request(addr, {"cmd": "poll", "req_id": rid})
    assert p2["state"] == "done"
    assert p2["result"] == p1["result"]
    ack = elastic.control.request(addr, {"cmd": "ack", "req_id": rid})
    assert ack["ok"] and ack["dropped"] is True
    p3 = elastic.control.request(addr, {"cmd": "poll", "req_id": rid})
    assert not p3["ok"]
    assert wire.classified_error(p3["classified"]).code == Code.Invalid


def test_reroute_cancels_queued_on_unreachable_replica(fleet):
    """The not-observed-running branch best-effort cancels the queued
    ticket before the caller re-routes: a replica that was merely
    unreachable (3 failed RPCs, never fenced) and recovers must not run
    work the survivor is about to run too."""
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    addr = fleet.reps[0].address
    try:
        elastic.control.request(
            addr, {"cmd": "submit", "tenant": "t", "op": "gate",
                   "payload": wire.encode_payload((), {})})
        assert started.wait(WAIT_S)
        left, right = _inputs(19, n=64)
        payload = wire.encode_payload((left, right), {"on": "k"})
        r = elastic.control.request(
            addr, {"cmd": "submit", "tenant": "t", "op": "join",
                   "payload": payload})
        assert r["ok"] and fleet.svcs[0].queue_depth() == 1
        out = fleet.router._on_replica_death("t", 0, addr, r["req_id"],
                                             False)
        assert out is None  # the caller re-routes...
        deadline = time.monotonic() + WAIT_S
        while fleet.svcs[0].queue_depth() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.svcs[0].queue_depth() == 0  # ...and this one died
    finally:
        release.set()


def test_ticket_cap_evicts_terminal_before_live(fleet, monkeypatch):
    """TICKET_CAP eviction drops delivered-but-unacked TERMINAL tickets
    first: a live running request — even when it is the OLDEST entry —
    is never cancelled while a terminal ticket can be evicted instead."""
    monkeypatch.setattr(replica_mod, "TICKET_CAP", 2)
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    addr = fleet.reps[0].address
    try:
        g = elastic.control.request(
            addr, {"cmd": "submit", "tenant": "t", "op": "gate",
                   "payload": wire.encode_payload((), {})})
        assert g["ok"] and started.wait(WAIT_S)
        l, r = _inputs(40, n=64)
        payload = wire.encode_payload((l, r), {"on": "k"})
        j2 = elastic.control.request(
            addr, {"cmd": "submit", "tenant": "t", "op": "join",
                   "payload": payload})
        assert j2["ok"]
        # j2 queued behind the gate: cancel it -> TERMINAL, unacked
        elastic.control.request(
            addr, {"cmd": "cancel", "req_id": j2["req_id"]})
        deadline = time.monotonic() + WAIT_S
        while True:
            p = elastic.control.request(
                addr, {"cmd": "poll", "req_id": j2["req_id"]})
            if p.get("state") in ("cancelled", "failed", "done"):
                break
            assert time.monotonic() < deadline, p
            time.sleep(0.01)
        # third submit pushes past cap=2: the TERMINAL j2 must be the
        # eviction victim, not the oldest-but-live gate
        j3 = elastic.control.request(
            addr, {"cmd": "submit", "tenant": "t", "op": "join",
                   "payload": payload})
        assert j3["ok"]
        pg = elastic.control.request(
            addr, {"cmd": "poll", "req_id": g["req_id"]})
        assert pg["ok"] and pg["state"] == "running", pg
        p2 = elastic.control.request(
            addr, {"cmd": "poll", "req_id": j2["req_id"]})
        assert p2.get("state") == "unknown", p2
        release.set()
        deadline = time.monotonic() + WAIT_S
        while True:   # the gate COMPLETES — it was never cancelled
            pg = elastic.control.request(
                addr, {"cmd": "poll", "req_id": g["req_id"]})
            if pg.get("state") == "done":
                break
            assert time.monotonic() < deadline, pg
            time.sleep(0.01)
    finally:
        release.set()


def test_stale_terminal_tickets_reaped_by_age(fleet, monkeypatch):
    """A terminal ticket no router came back for (its router died) is
    released by the telemetry-ride age reap — an idle replica must not
    pin result tables forever just because no new submit trips the
    count cap."""
    monkeypatch.setattr(replica_mod, "TICKET_TTL_MIN_S", 0.0)
    monkeypatch.setattr(replica_mod, "route_timeout_s", lambda: 0.05)
    addr = fleet.reps[0].address
    l, r = _inputs(41, n=64)
    resp = elastic.control.request(
        addr, {"cmd": "submit", "tenant": "t", "op": "join",
               "payload": wire.encode_payload((l, r), {"on": "k"})})
    assert resp["ok"]
    rid = resp["req_id"]
    deadline = time.monotonic() + WAIT_S
    while True:   # heartbeats (interval 0.05s) drive telemetry -> reap
        p = elastic.control.request(addr, {"cmd": "poll", "req_id": rid})
        if p.get("state") == "unknown":
            break
        assert p.get("state") in ("queued", "running", "done"), p
        assert time.monotonic() < deadline, p
        time.sleep(0.02)


def test_payload_nbytes_tracks_real_encoding():
    """The client's wire-cap pre-check runs on `wire.payload_nbytes`
    instead of a second json.dumps of the whole request: the estimate
    must track the real encoded length closely and never materially
    UNDERestimate it (an under-estimate would let an oversized request
    through to a mid-send failure)."""
    l, r = _inputs(5, n=300)
    for args, kwargs in [((l, r), {"on": "k", "passes": 2}),
                         ((), {}),
                         ((l, np.arange(7), "x", 2.5, None, True),
                          {"opts": {"nested": [1, "two"]}}),
                         # escape-heavy strings: ensure_ascii inflates
                         # non-ASCII 6x and newlines 2x — the estimate
                         # must track the ESCAPED length
                         (("\n" * 500, "é" * 500), {"q": 'a"b\\c' * 100}),
                         ((), {"big_int": 10 ** 60, "f": -1.5e-300})]:
        p = wire.encode_payload(args, kwargs)
        est = wire.payload_nbytes(p)
        real = len(json.dumps(p, sort_keys=True))
        assert est >= real - 64, (est, real)
        assert est <= real * 1.2 + 512, (est, real)


def test_submit_token_dedups_and_cancels_orphans(fleet):
    """The idempotency token: a retried submit of an already-admitted
    request (same token — control.request's transient-reset retry
    resends the same bytes) returns the SAME ticket, and cancel-by-token
    reaps a queued orphan whose accept reply the router never read."""
    release, started = threading.Event(), threading.Event()
    fleet.svcs[0].register_op("gate", _gate_runner(release, started))
    addr = fleet.reps[0].address
    payload = wire.encode_payload((), {})
    sub = {"cmd": "submit", "tenant": "t", "op": "gate",
           "payload": payload, "token": "tok-1"}
    try:
        r1 = elastic.control.request(addr, sub)
        assert r1["ok"] and not r1.get("duplicate")
        assert started.wait(WAIT_S)
        r2 = elastic.control.request(addr, sub)
        assert r2["ok"] and r2["duplicate"] is True
        assert r2["req_id"] == r1["req_id"]
        assert fleet.svcs[0].queue_depth() == 0  # ONE admission
        # orphan insurance: a second request queues behind the gate,
        # its accept reply is "lost" (the router knows only the token)
        r3 = elastic.control.request(addr, dict(sub, token="tok-2"))
        assert r3["ok"] and r3["req_id"] != r1["req_id"]
        assert fleet.svcs[0].queue_depth() == 1
        c = elastic.control.request(addr,
                                    {"cmd": "cancel", "token": "tok-2"})
        assert c["ok"] and c["cancelled"] is True
        deadline = time.monotonic() + WAIT_S
        while fleet.svcs[0].queue_depth() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.svcs[0].queue_depth() == 0
    finally:
        release.set()


# ---------------------------------------------------------------------------
# observability: OpenMetrics labels + the fleet_status routing table
# ---------------------------------------------------------------------------

def test_router_counters_in_openmetrics_with_labels(fleet):
    from cylon_tpu_torch.obs import openmetrics

    left, right = _inputs(60, n=300)
    fleet.client.route("acme", "join", left, right, on="k", passes=1,
                       mode="hash", timeout_s=WAIT_S)
    resp = elastic.control.request(fleet.router.address,
                                   {"cmd": "metrics"})
    assert resp["ok"]
    doc = openmetrics.parse(resp["openmetrics"])
    routed = doc["cylon_tpu_router_requests_routed_total"]
    assert routed["type"] == "counter"
    labeled = [(labels, v) for _, labels, v in routed["samples"]
               if labels.get("tenant") == "acme"]
    assert labeled, routed["samples"]
    labels, v = labeled[0]
    assert labels["replica"] in ("0", "1")
    assert v >= 1
    gauge = doc["cylon_tpu_router_replicas_live"]
    assert any(v == 2 for _, _, v in gauge["samples"])


def test_fleet_status_renders_routing_table(fleet, capsys):
    import importlib.util
    import os

    left, right = _inputs(61, n=300)
    fleet.client.route("acme", "join", left, right, on="k", passes=1,
                       mode="hash", timeout_s=WAIT_S)
    spec = importlib.util.spec_from_file_location(
        "fleet_status", os.path.join(os.path.dirname(__file__), "..",
                                     "tools", "fleet_status.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main([fleet.addr, "--replicas"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "2 live replica(s)" in out
    assert "routed=1" in out
    assert "acme" in out  # the tenant pin renders
    # a plain coordinator has no routing table: rc 1, said clearly
    coord = elastic.Coordinator(world=1, heartbeat_timeout_s=0.5).start()
    try:
        rc = mod.main([f"{coord.address[0]}:{coord.address[1]}",
                       "--replicas"])
    finally:
        coord.stop()
    out = capsys.readouterr().out
    assert rc == 1
    assert "not a query router" in out


def test_fleet_status_replicas_json_rc_parity(fleet, capsys):
    """--replicas --json follows the same rc contract as text mode: a
    plain coordinator (null router section) is rc 1, not a silent
    success printing 'null'."""
    import importlib.util
    import json as json_mod
    import os

    spec = importlib.util.spec_from_file_location(
        "fleet_status_jsonrc", os.path.join(
            os.path.dirname(__file__), "..", "tools", "fleet_status.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main([fleet.addr, "--replicas", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    assert json_mod.loads(out)["replicas_live"] == 2
    coord = elastic.Coordinator(world=1, heartbeat_timeout_s=0.5).start()
    try:
        rc = mod.main([f"{coord.address[0]}:{coord.address[1]}",
                       "--replicas", "--json"])
    finally:
        coord.stop()
    out = capsys.readouterr().out
    assert rc == 1
    assert json_mod.loads(out) is None


# ---------------------------------------------------------------------------
# tail tolerance: hedged requests + replica health breakers
# ---------------------------------------------------------------------------

def _sick_join(rank):
    """Passthrough join op behind a per-rank fault site: the seeded
    ``replica_sick`` kind stalls ONE replica's dispatch path while the
    handler stays alive and correct — the straggler shape hedging must
    absorb."""
    def run(left, right, *, ctx=None, pass_guard=None, **kw):
        resilience.fault_point(f"hedge.pass.r{rank}")
        if pass_guard is not None:
            pass_guard()  # a cancelled loser stops HERE, pre-execution
        return chunked_join(left, right, ctx=ctx, pass_guard=pass_guard,
                            **kw)
    return run


def _wait_hedge_safe(fleet, op, ranks=(0, 1)):
    """Block until every rank's heartbeat telemetry lists ``op`` as
    idempotent — registration happened after the agents' first beat."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        view = fleet.router._replica_view()
        if all(r in view and op in view[r]["idempotent_ops"]
               for r in ranks):
            return
        time.sleep(0.02)
    raise AssertionError(f"{op!r} never turned hedge-safe in telemetry")


def test_hedge_beats_sick_replica_bit_identical(fleet, tmp_path):
    """The acceptance shape: replica 0 turns sick (a seeded 3s dispatch
    stall), hedging is on — the routed request completes well under the
    stall via a speculative second placement, bit-identical to the
    oracle, with exactly one hedge fired, the loser proxy-cancelled at
    a pass boundary, and zero duplicate side effects (only the winner's
    run reaches the shared journal)."""
    left, right = _inputs(70)
    base, _ = chunked_join(left, right, on="k", passes=2, mode="hash",
                           ctx=CPU)
    for r in (0, 1):
        fleet.svcs[r].register_op("sjoin", _sick_join(r), idempotent=True)
    _wait_hedge_safe(fleet, "sjoin")
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_ROUTER_HEDGE_MS="100",
                         CYLON_TPU_FAULT_DELAY_S="3"):
        with resilience.fault_plan("hedge.pass.r0@1=replica_sick") as plan:
            t0 = time.monotonic()
            res, stats = fleet.client.route(
                "hedge", "sjoin", left, right, on="k", passes=2,
                mode="hash", timeout_s=WAIT_S)
            dur = time.monotonic() - t0
        st = fleet.client.status()["router"]
        assert st["hedging"] is True
    assert plan.fired == [("hedge.pass.r0", "replica_sick", 1)]
    _assert_bit_identical(res, base)
    assert dur < 2.5, f"the hedge never beat the 3s stall ({dur:.2f}s)"
    rt = stats["router"]
    assert rt["replica"] == 1
    assert rt["hedged"] == 1 and rt["hedge_won"] is True
    assert st["hedges_fired"] == 1
    assert st["hedges_won"] == 1
    assert st["hedges_lost_cancelled"] == 1
    assert st["replicas"]["0"]["hedged_away"] == 1
    assert obs_metrics.counter_value("router.hedges_fired") == 1
    assert obs_metrics.counter_value("router.hedges_won") == 1
    assert obs_metrics.counter_value("router.hedges_lost_cancelled") == 1
    # the loser stops at its next pass boundary: replica 0 records the
    # cancellation, and the shared journal holds ONLY the winner's run
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        if fleet.svcs[0].stats()["tenants"]["hedge"]["cancelled"] >= 1:
            break
        time.sleep(0.02)
    assert fleet.svcs[0].stats()["tenants"]["hedge"]["cancelled"] == 1
    assert fleet.svcs[0].stats()["tenants"]["hedge"]["served"] == 0
    runs = durable.scan_runs(str(tmp_path))
    assert len(runs) == 1 and runs[0]["complete"]
    obs_metrics.reset()


def test_non_idempotent_custom_op_never_hedges(fleet):
    """A custom op registered WITHOUT ``idempotent=True`` must never be
    speculated: even with an aggressive hedge floor the router waits
    out the slow primary rather than double-executing a handler with
    unknown side effects."""
    calls = []

    def slow_op(*args, ctx=None, pass_guard=None, **kw):
        calls.append(1)
        time.sleep(0.5)
        return {"ok": np.array([1])}, {}

    for r in (0, 1):
        fleet.svcs[r].register_op("sideeffect", slow_op)
    with config.knob_env(CYLON_TPU_ROUTER_HEDGE_MS="50"):
        _, stats = fleet.client.route("t", "sideeffect",
                                      timeout_s=WAIT_S)
    assert stats["router"]["hedged"] == 0
    assert stats["router"]["hedge_won"] is False
    assert len(calls) == 1  # executed exactly once, fleet-wide
    st = fleet.client.status()["router"]
    assert st["hedges_fired"] == 0


def test_breaker_opens_after_failures_and_probe_recloses(fleet):
    """The breaker contract: N consecutive classified failures OPEN a
    replica's breaker, placement skips it entirely (zero submits reach
    it while OPEN), and after the cooldown a single real request probes
    the replica and re-closes the breaker on success."""
    sick = {"on": True}

    def flaky(*args, ctx=None, pass_guard=None, **kw):
        if sick["on"]:
            raise CylonError(Code.UnknownError,
                             "injected flaky replica handler")
        return {"ok": np.array([1])}, {}

    def healthy(*args, ctx=None, pass_guard=None, **kw):
        return {"ok": np.array([2])}, {}

    fleet.svcs[0].register_op("flaky", flaky)
    fleet.svcs[1].register_op("flaky", healthy)
    submits = [0]
    orig_submit = fleet.reps[0]._handle_submit

    def spy_submit(req):
        submits[0] += 1
        return orig_submit(req)

    fleet.reps[0]._handle_submit = spy_submit
    with config.knob_env(CYLON_TPU_ROUTER_BREAKER_FAILURES="2",
                         CYLON_TPU_ROUTER_BREAKER_COOLDOWN_S="1.5"):
        for _ in range(2):
            with pytest.raises(CylonError) as ei:
                fleet.client.route("brk", "flaky", timeout_s=WAIT_S)
            assert ei.value.code == Code.UnknownError
        st = fleet.client.status()["router"]
        assert st["breakers"]["0"] == "open"
        assert st["replicas"]["0"]["breaker"] == "open"
        assert st["replicas"]["0"]["breaker_opens"] == 1
        # while OPEN, placement never touches replica 0 — despite the
        # tenant's affinity pin pointing there
        before = submits[0]
        for _ in range(3):
            _, stats = fleet.client.route("brk", "flaky",
                                          timeout_s=WAIT_S)
            assert stats["router"]["replica"] == 1
        assert submits[0] == before
        # heal, wait out the cooldown: ONE real request probes the
        # half-open replica and the breaker re-closes
        sick["on"] = False
        time.sleep(1.6)
        _, stats = fleet.client.route("brk", "flaky", timeout_s=WAIT_S)
        assert stats["router"]["replica"] == 0
        st = fleet.client.status()["router"]
        assert st["breakers"]["0"] == "closed"
        assert st["replicas"]["0"]["breaker"] == "closed"
        assert st["replicas"]["0"]["breaker_probes"] >= 1
        assert st["replicas"]["0"]["breaker_opens"] == 1


def test_queue_wait_is_not_a_breaker_strike(tmp_path):
    """The breaker judges a replica's SERVICE time, not the time a
    request sat in its admission queue.  Journal hits queued behind a
    long local request on the fleet's only replica run in no time once
    dispatched: they must not strike its breaker.  (Counting the queue
    wait opened the breaker of the flood's sole survivor under load —
    hits never move the route EWMA, so the cold 1 s floor judged them —
    and the router then shed every request.)"""
    left, right = _inputs(70)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_ROUTER_TIMEOUT_S="90"):
        base, _ = chunked_join(left, right, on="k", passes=1, mode="hash",
                               ctx=CPU)
        f = Fleet(n=1, hb_timeout=5.0)
        release, started = threading.Event(), threading.Event()
        f.svcs[0].register_op("gate", _gate_runner(release, started))
        outs, errs = [], []
        lock = threading.Lock()

        def route():
            try:
                out = f.client.route("q", "join", left, right, on="k",
                                     passes=1, mode="hash",
                                     timeout_s=WAIT_S)
                with lock:
                    outs.append(out)
            except CylonError as e:
                with lock:
                    errs.append(e)

        threads = []
        try:
            # a local request parks the replica's scheduler; the router
            # never sees it
            gate = f.svcs[0].submit("local", "gate")
            assert started.wait(WAIT_S)
            for _ in range(4):
                th = threading.Thread(target=route, daemon=True)
                th.start()
                threads.append(th)
            deadline = time.monotonic() + WAIT_S
            while f.svcs[0].queue_depth() < 4 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert f.svcs[0].queue_depth() == 4
            time.sleep(1.5)  # past the cold fleet's 1 s slow threshold
            release.set()
            gate.result(WAIT_S)
            for th in threads:
                th.join(WAIT_S)
            assert not errs and len(outs) == 4
            for res, stats in outs:
                assert stats["router"]["cache_hit"] is True
                _assert_bit_identical(res, base)
            st = f.client.status()["router"]
            assert st["breakers"]["0"] == "closed"
            assert st["replicas"]["0"]["breaker_opens"] == 0
        finally:
            release.set()
            f.close()


def test_fenced_replica_breaker_forced_open(fleet):
    """Fencing/breaker agreement: once the membership detector fences a
    dead replica, the status verb reports its breaker OPEN — the two
    subsystems must never disagree about a dead replica."""
    fleet.kill(0)
    deadline = time.monotonic() + WAIT_S
    while 0 in fleet.router.view().members \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert 0 not in fleet.router.view().members
    st = fleet.client.status()["router"]
    assert st["breakers"]["0"] == "open"
    assert "0" not in st["replicas"]  # fenced out of the serving set
    assert st["replicas_live"] == 1


def test_breaker_state_gauge_in_openmetrics(fleet):
    """`router.breaker_state[replica=N]` ships through the metrics verb
    as a labeled gauge (0 closed / 1 half-open / 2 open)."""
    from cylon_tpu_torch.obs import openmetrics

    with config.knob_env(CYLON_TPU_ROUTER_BREAKER_FAILURES="1"):
        fleet.router._breaker_force_open(0, "seeded by the gauge test")
        resp = elastic.control.request(fleet.router.address,
                                       {"cmd": "metrics"})
    assert resp["ok"]
    doc = openmetrics.parse(resp["openmetrics"])
    gauge = doc["cylon_tpu_router_breaker_state"]
    assert gauge["type"] == "gauge"
    vals = {labels.get("replica"): v for _, labels, v in gauge["samples"]}
    assert vals.get("0") == 2  # OPEN
    obs_metrics.reset()


def test_fleet_status_renders_breaker_and_hedge_columns(fleet, capsys):
    """--replicas renders the new hedged/breaker columns and the hedging
    header, with --json carrying the same fields (rc parity)."""
    import importlib.util
    import os

    left, right = _inputs(63, n=300)
    fleet.client.route("acme", "join", left, right, on="k", passes=1,
                       mode="hash", timeout_s=WAIT_S)
    with config.knob_env(CYLON_TPU_ROUTER_BREAKER_FAILURES="1"):
        fleet.router._breaker_force_open(1, "seeded by the column test")
    spec = importlib.util.spec_from_file_location(
        "fleet_status_tail", os.path.join(
            os.path.dirname(__file__), "..", "tools", "fleet_status.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main([fleet.addr, "--replicas"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "hedging=off" in out
    assert "hedged" in out and "breaker" in out  # the new columns
    assert "closed" in out and "open" in out     # per-replica states
    rc = mod.main([fleet.addr, "--replicas", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    j = json.loads(out)
    assert j["breakers"]["1"] == "open"
    assert j["replicas"]["1"]["breaker"] == "open"
    assert j["replicas"]["0"]["breaker"] == "closed"
    assert j["replicas"]["0"]["hedged_away"] == 0
    assert j["hedges_fired"] == 0 and j["hedges_won"] == 0
    assert j["hedging"] is False


# ---------------------------------------------------------------------------
# replicas as processes; across the packages
# ---------------------------------------------------------------------------

REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))


def _fleet_status(addr, *args):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, f"{REPO}/tools/fleet_status.py", addr, *args],
        capture_output=True, text=True, timeout=60)


@pytest.mark.fault
def test_flood_with_a_replica_process_killed(tmp_path):
    """Two replica processes (``tests/torch_router_worker.py``) share one
    journal behind the router; replica 1 dies (``rank_kill``,
    os._exit(137)) at its third dispatched ``kjoin`` of a 12-request
    flood from 3 tenants.  Every request is answered bit for bit as the
    direct call, or refused classified and retryable; the router
    re-routes at least once and fences replica 1; the unchanged
    ``tools/fleet_status.py`` reads the router's table."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("CYLON_TPU_FAULT_PLAN", "CYLON_TPU_TRACE",
                        "CYLON_TPU_TRACE_DIR")}
    env.update(CYLON_TPU_DURABLE_DIR=str(tmp_path / "journal"),
               CYLON_TPU_TRACE_DIR=str(tmp_path / "traces"),
               CYLON_TPU_HEARTBEAT_S="0.1",
               CYLON_TPU_HEARTBEAT_TIMEOUT_S="1.5",
               CYLON_TPU_COORD_RECONNECT_S="0")
    reqs = [(f"t{i % 3}", _inputs(70 + i, n=800)) for i in range(12)]
    oracle = [chunked_join(l, r, on="k", passes=2, mode="hash", ctx=CPU)[0]
              for _, (l, r) in reqs]
    procs = []
    with config.knob_env(CYLON_TPU_ROUTER_TIMEOUT_S="90",
                         CYLON_TPU_HEARTBEAT_TIMEOUT_S="1.5"):
        router = QueryRouter(world=2).start()
        try:
            addr = f"{router.address[0]}:{router.address[1]}"
            for r in range(2):
                e = dict(env)
                if r == 1:
                    e["CYLON_TPU_FAULT_PLAN"] = "router.pass.r1@3=rank_kill"
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_router_worker",
                     str(r), "2", addr], cwd=REPO, env=e,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + 60
            while len(router._replica_view()) < 2:
                assert time.monotonic() < deadline, "replicas never came up"
                time.sleep(0.05)
            client = RouterClient(addr)
            out, errs = [None] * 12, [None] * 12

            def one(i):
                tenant, (l, r) = reqs[i]
                try:
                    out[i] = client.route(tenant, "kjoin", l, r, on="k",
                                          passes=2, mode="hash",
                                          timeout_s=WAIT_S)
                except CylonError as err:
                    errs[i] = err

            ts = [threading.Thread(target=one, args=(i,), daemon=True)
                  for i in range(12)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WAIT_S)
            assert not any(t.is_alive() for t in ts), "a routed request hung"
            for i in range(12):
                if out[i] is not None:
                    _assert_bit_identical(out[i][0], oracle[i])
                else:
                    assert errs[i].code in SHED_CODES, errs[i]
                    assert errs[i].retry_after_s is not None
            assert sum(o is not None for o in out) >= 9
            st = router.router_status()
            assert st["reroutes"] + st["abandoned"] >= 1
            assert procs[1].wait(timeout=60) == 137
            deadline = time.monotonic() + 30
            while 1 not in router._dead:
                assert time.monotonic() < deadline, "replica 1 never fenced"
                time.sleep(0.05)
            assert router.router_status()["reroutes"] >= 1
            rs = _fleet_status(addr, "--json", "--replicas")
            assert rs.returncode == 0, rs.stderr
            table = json.loads(rs.stdout)
            # the live table holds the survivor; the breakers list both,
            # the fenced replica's forced open
            assert set(table["replicas"]) == {"0"}
            assert table["replicas_live"] == 1
            assert table["breakers"] == {"0": "closed", "1": "open"}
            st = json.loads(_fleet_status(addr, "--json").stdout)
            assert st["dead"]["1"] == "heartbeat timeout"
        finally:
            router.stop()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=10)


def test_reference_client_routes_through_the_port_router(fleet):
    """The JAX package's ``RouterClient`` speaks the port's route verb:
    the frames it gets are the port's, bit for bit, and the port's
    client sees the same; both clients' classified refusals agree."""
    from cylon_tpu.router import RouterClient as RefClient
    from cylon_tpu.status import CylonError as RefError

    left, right = _inputs(90)
    base, _ = chunked_join(left, right, on="k", passes=2, mode="hash",
                           ctx=CPU)
    ref_res, ref_stats = RefClient(fleet.addr).route(
        "ref-tenant", "join", left, right, on="k", passes=2, mode="hash",
        timeout_s=WAIT_S)
    _assert_bit_identical(ref_res, base)
    assert ref_stats["router"]["replica"] in (0, 1)
    res, _ = fleet.client.route("port-tenant", "join", left, right, on="k",
                                passes=2, mode="hash", timeout_s=WAIT_S)
    _assert_bit_identical(res, ref_res)
    with pytest.raises(RefError) as ei:
        RefClient(fleet.addr).route("ref-tenant", "no-such-op",
                                    timeout_s=WAIT_S)
    with pytest.raises(CylonError) as pe:
        fleet.client.route("port-tenant", "no-such-op", timeout_s=WAIT_S)
    assert ei.value.code.name == pe.value.code.name == "Invalid"


def test_fleet_status_reads_the_port_router(fleet):
    """``tools/fleet_status.py`` (unchanged, stdlib only) renders the
    port's router: ``--json`` the status verb, ``--replicas`` the
    routing table with both replicas."""
    left, right = _inputs(91)
    fleet.client.route("acme", "join", left, right, on="k", passes=1,
                       mode="hash", timeout_s=WAIT_S)
    js = _fleet_status(fleet.addr, "--json")
    assert js.returncode == 0, js.stderr
    doc = json.loads(js.stdout)
    assert doc["members"] == [0, 1] and doc["router"]["routed"] == 1
    table = _fleet_status(fleet.addr, "--replicas")
    assert table.returncode == 0, table.stderr
    assert "acme" in table.stdout
    assert all(f"{r}" in table.stdout for r in ("0", "1"))
