"""The port's elastic multi-process membership (cylon_tpu_torch/
elastic.py), the counterpart of ``tests/test_elastic.py``: epochs,
heartbeat failure detection, rendezvous barriers, and journal-backed
shrink-and-resume, on CPU contexts; then the cross-package cases (the
part assignment, the coordinator log, each package's agent against the
other's coordinator, and the gang's frame against the JAX package's
one-process run).

The acceptance-criterion path: a 3-process gang with one member killed
(``rank_kill`` = ``os._exit(137)`` at a pass boundary) mid-plan
completes on the 2 survivors with output bit-identical to the
single-process oracle, served partly from the shared durable journal.
Every recovery path — rank_kill, heartbeat_loss (silent straggler),
coordinator_loss, epoch-mismatch at the barrier, journaled-at-W
consumed at W-1 — runs deterministically on CPU via the resilience
fault plans.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from cylon_tpu_torch import config, elastic, resilience
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.status import Code, CylonError

from .torch_lock_record import port_lock_record  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tight-but-safe control-plane cadence for in-process tests: detection
# within ~0.5s, heartbeats every 50ms.  reconnect_s=0 pins the
# fail-after-3-missed-ticks contract (the acceptance criterion that
# CYLON_TPU_COORD_RECONNECT_S=0 reproduces it exactly); the ride-through
# tests pass an explicit window instead.
HB = dict(interval_s=0.05, timeout_s=0.5, reconnect_s=0.0)
HB_TIMEOUT = 0.4


def _gang(world, **kw):
    c = elastic.Coordinator(world, heartbeat_timeout_s=HB_TIMEOUT,
                            **kw).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agents = [elastic.Agent(addr, r, **HB).start() for r in range(world)]
    return c, addr, agents


def _wait(cond, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


def _assert_bit_identical(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)
        if x.dtype.kind == "f":
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# work assignment
# ---------------------------------------------------------------------------

def test_owned_parts_cover_disjoint_and_redistribute():
    members = [0, 1, 2]
    covers = [elastic.owned_parts(7, r, members) for r in members]
    assert sorted(p for c in covers for p in c) == list(range(7))
    assert all(len(set(c)) == len(c) for c in covers)
    # shrink: the dead rank's parts land on survivors, full cover kept
    shrunk = [elastic.owned_parts(7, r, [0, 2]) for r in (0, 2)]
    assert sorted(p for c in shrunk for p in c) == list(range(7))
    with pytest.raises(elastic.EpochChanged):
        elastic.owned_parts(7, 1, [0, 2])  # dead ranks own nothing


def test_epoch_codes_are_not_retryable():
    # retrying into a changed membership is the desync the no-retry
    # collectives policy bans: the
    # elastic loop must re-plan, so neither code may enter the retry path
    assert Code.EpochMismatch not in resilience.RETRYABLE_CODES
    assert Code.Unavailable not in resilience.RETRYABLE_CODES
    assert elastic.EpochChanged("x").code == Code.EpochMismatch
    assert elastic.CoordinatorLost("x").code == Code.Unavailable


# ---------------------------------------------------------------------------
# membership: formation, silence detection, epoch bumps
# ---------------------------------------------------------------------------

def test_silent_rank_bumps_epoch_and_shrinks_membership():
    obs_metrics.reset()
    c, _, agents = _gang(3)
    try:
        v = agents[0].wait_formed()
        assert v.epoch == 0 and v.members == (0, 1, 2) and v.world == 3
        agents[1].stop()  # process-death semantics: just goes silent
        _wait(lambda: agents[0].view().members == (0, 2),
              msg="rank 1 reaped")
        v2 = agents[0].view()
        assert v2.epoch == 1
        assert obs_metrics.counter_value("elastic.rank_lost") == 1
        with pytest.raises(elastic.EpochChanged) as ei:
            agents[0].ensure_epoch(0)
        assert ei.value.code == Code.EpochMismatch
        agents[0].ensure_epoch(1)  # current epoch passes the guard
    finally:
        for a in agents:
            a.stop()
        c.stop()
        obs_metrics.reset()


def test_reported_peer_failure_bumps_epoch():
    from cylon_tpu_torch.status import Status

    c, _, agents = _gang(2)
    try:
        agents[0].wait_formed()
        # a collective failure classified via Status indicts the peer
        agents[1].report_failure(
            Status(Code.ExecutionError, "UNAVAILABLE: peer unreachable"),
            peer=0)
        _wait(lambda: agents[1].view().members == (1,),
              msg="reported peer reaped")
        assert agents[1].view().epoch == 1
        assert "reported by rank 1" in c._dead[0]
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_barrier_rendezvous_and_epoch_change_mid_wait():
    import threading

    c, _, agents = _gang(2)
    try:
        agents[0].wait_formed()
        out = []
        t = threading.Thread(
            target=lambda: out.append(agents[1].barrier("done", 0)))
        t.start()
        v = agents[0].barrier("done", 0)
        t.join(5)
        assert out and v.epoch == 0 and out[0].epoch == 0
        # now rank 1 dies while rank 0 waits: the barrier must not hang —
        # the epoch bump converts the wait into EpochChanged
        agents[1].stop()
        with pytest.raises(elastic.EpochChanged):
            agents[0].barrier("again", 0)
        assert agents[0].view().members == (0,)
        # the survivor alone completes the epoch-1 barrier immediately
        assert agents[0].barrier("again", 1).members == (0,)
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_barrier_latch_is_per_name_and_not_reused_across_runs():
    """A completed rendezvous is LATCHED (a finished member's clean
    leave must not fake an epoch change for the still-polling peers) —
    but the latch is keyed by barrier NAME, so a second run's barrier
    (namespaced by run_id in elastic_run) starts fresh instead of
    rendezvousing instantly against the first run's latch."""
    import threading

    from cylon_tpu_torch.net import control

    c, _, agents = _gang(2)
    try:
        agents[0].wait_formed()
        out = []
        t = threading.Thread(
            target=lambda: out.append(agents[1].barrier("done/run1/6", 0)))
        t.start()
        agents[0].barrier("done/run1/6", 0)
        t.join(5)
        assert out
        # the latch keeps serving go for run1's name at epoch 0...
        resp = control.request(c.address, {"cmd": "barrier", "rank": 0,
                                           "name": "done/run1/6",
                                           "epoch": 0})
        assert resp["status"] == "go"
        # ...but a different run's name at the same epoch is NOT
        # pre-completed: the peer has not arrived, so rank 0 must wait
        resp = control.request(c.address, {"cmd": "barrier", "rank": 0,
                                           "name": "done/run2/6",
                                           "epoch": 0})
        assert resp["status"] == "wait"
    finally:
        for a in agents:
            a.stop()
        c.stop()


# ---------------------------------------------------------------------------
# fault kinds: heartbeat_loss (straggler), coordinator_loss
# ---------------------------------------------------------------------------

@pytest.mark.fault
def test_heartbeat_loss_straggler_rejected_at_barrier():
    """The heartbeat_loss kind silences rank 1's heartbeats while the
    process keeps computing: the coordinator declares it dead, and its
    eventual barrier — carrying the stale epoch — is REJECTED (fenced),
    never admitted into the shrunken world."""
    with resilience.fault_plan("elastic.heartbeat.r1@2=heartbeat_loss") as p:
        c, _, agents = _gang(2)
        try:
            agents[0].wait_formed()
            _wait(lambda: agents[0].view().members == (0,),
                  msg="silenced rank declared dead")
            assert ("elastic.heartbeat.r1", "heartbeat_loss", 2) in p.fired
            # the straggler still believes epoch 0 (it hears nothing; the
            # silenced flag is test-observable, guards never consult it —
            # a partitioned process cannot know it is partitioned)
            assert agents[1].silenced
            assert agents[1].view().epoch == 0
            with pytest.raises(elastic.EpochChanged) as ei:
                agents[1].barrier("done", 0)
            assert "dead" in ei.value.msg or "straggler" in ei.value.msg
            with pytest.raises(elastic.EpochChanged):
                agents[1].ensure_epoch(0)  # fenced: every guard refuses
        finally:
            for a in agents:
                a.stop()
            c.stop()


@pytest.mark.fault
def test_coordinator_loss_fails_clean_with_status():
    """The coordinator_loss kind kills the coordinator at its detector
    tick: agents must detect the silence within a bounded number of
    heartbeats and fail with a classified Status (Code.Unavailable) —
    never hang."""
    with resilience.fault_plan("elastic.coordinator@2=coordinator_loss"):
        c, _, agents = _gang(1)
        try:
            agents[0].wait_formed()
            _wait(lambda: c.died, msg="coordinator death")
            _wait(lambda: agents[0].coordinator_down,
                  msg="agent detects coordinator loss")
            with pytest.raises(elastic.CoordinatorLost) as ei:
                agents[0].ensure_epoch(0)
            assert ei.value.code == Code.Unavailable
            with pytest.raises(elastic.CoordinatorLost):
                agents[0].barrier("done", 0)
        finally:
            agents[0].stop()
            c.stop()


# ---------------------------------------------------------------------------
# context integration
# ---------------------------------------------------------------------------

def test_elastic_config_context_joins_and_leaves():
    from cylon_tpu_torch.context import CylonContext, ElasticConfig

    c = elastic.Coordinator(1, heartbeat_timeout_s=HB_TIMEOUT).start()
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        ctx = CylonContext.InitDistributed(
            ElasticConfig(rank=0, coordinator=addr, devices=["cpu"]))
        agent = ctx.elastic_agent()
        assert agent is not None and ctx.GetRank() == 0
        assert agent.wait_formed().members == (0,)
        ctx.Finalize()  # clean leave: the coordinator reaps us instantly
        _wait(lambda: c.view().members == (), msg="clean leave")
    finally:
        c.stop()


def test_env_driven_elastic_opt_in_joins_gang():
    """CYLON_TPU_ELASTIC=1 + _ELASTIC_COORD: a plain distributed
    context joins the gang at its process id with no code changes (the
    deployment path where hosts only get environment variables)."""
    from cylon_tpu_torch.context import CylonContext, MeshConfig

    c = elastic.Coordinator(1, heartbeat_timeout_s=HB_TIMEOUT).start()
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        with config.knob_env(CYLON_TPU_ELASTIC="1",
                             CYLON_TPU_ELASTIC_COORD=addr):
            ctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu"], world_size=1))
        agent = ctx.elastic_agent()
        assert agent is not None and agent.rank == 0
        assert agent.wait_formed().members == (0,)
        assert ctx.GetNeighbours(include_self=True) == [0]
        ctx.Finalize()
        _wait(lambda: c.view().members == (), msg="clean leave")
        # knob off (default): no gang join
        ctx2 = CylonContext.InitDistributed(MeshConfig(devices=["cpu"], world_size=1))
        assert ctx2.elastic_agent() is None
    finally:
        c.stop()


def test_elastic_context_requires_coordinator_address():
    from cylon_tpu_torch.context import CylonContext, ElasticConfig

    with config.knob_env(CYLON_TPU_ELASTIC_COORD=None):
        with pytest.raises(CylonError) as ei:
            CylonContext.InitDistributed(ElasticConfig(rank=0,
                                                       devices=["cpu"]))
    assert ei.value.code == Code.Invalid


# ---------------------------------------------------------------------------
# journal semantics across world sizes
# ---------------------------------------------------------------------------

# the op and inputs are the WORKER's own (tests/torch_elastic_worker.py): the
# in-process journal tests and the multi-process acceptance test must
# compute the identical run fingerprint, so there is exactly one
# definition of both
from tests.torch_elastic_worker import N_PASSES, inputs as _inputs, run_op as _run


def test_journaled_at_world_w_consumed_at_w_minus_1(tmp_path):
    """Shards journaled by a world-3 gang are consumed verbatim by the
    world-2 survivors (part ids are global key-domain positions, so the
    fingerprint is world-independent by design), and the manifest
    records per-pass world/epoch provenance for the shrink history."""
    left, right = _inputs()
    base, base_stats = _run(left, right)
    assert base_stats["passes"] == N_PASSES
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        # epoch 0, world 3: ranks 0 and 2 journal their slices; rank 1
        # "dies" before contributing (its parts stay unjournaled)
        for r in (0, 2):
            sl = elastic.ElasticSlice(
                parts=elastic.owned_parts(6, r, [0, 1, 2]), epoch=0,
                world=3, guard=lambda: None)
            _, st = _run(left, right, sl)
            assert st["parts_run"] == 2 and st["passes_skipped"] == 0
        # epoch 1, world 2: survivors re-derive their slices — parts
        # journaled at world 3 are CONSUMED, only rank 1's leftovers run
        ran = skipped = 0
        for r in (0, 2):
            sl = elastic.ElasticSlice(
                parts=elastic.owned_parts(6, r, [0, 2]), epoch=1,
                world=2, guard=lambda: None)
            _, st = _run(left, right, sl)
            ran += st.get("parts_run", 0)
            skipped += st["passes_skipped"]
        assert ran == 2 and skipped == 4  # exactly the dead rank's parts
        # assembly: the full run serves every pass from the journal and
        # is bit-identical to the single-process oracle
        out, st = _run(left, right)
        assert st["passes_skipped"] == st["passes"] == 6
        assert "parts_run" not in st
        _assert_bit_identical(out, base)
        # manifest provenance: both worlds appear on pass records
        fp_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
        entries = [json.loads(ln) for ln
                   in (fp_dir / "MANIFEST.jsonl").read_text().splitlines()]
        worlds = {e["world"] for e in entries if e["kind"] == "pass"}
        epochs = {e["epoch"] for e in entries if e["kind"] == "pass"}
        assert worlds == {3, 2} and epochs == {0, 1}


@pytest.mark.fault
def test_pass_guard_abandons_in_flight_work_on_epoch_change(tmp_path):
    """An EpochChanged raised by the engine's pass guard propagates OUT
    of the stream (no retry, no quarantine — Code.EpochMismatch is not
    retryable) with the already-completed parts journaled."""
    left, right = _inputs()
    calls = {"n": 0}

    def guard():
        calls["n"] += 1
        if calls["n"] == 3:
            raise elastic.EpochChanged("membership epoch moved 0 -> 1")

    sl = elastic.ElasticSlice(parts=[0, 1, 2, 3, 4, 5], epoch=0, world=3,
                              guard=guard)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_RETRY_BASE_S="0"):
        with pytest.raises(elastic.EpochChanged):
            _run(left, right, sl)
        # the two passes completed before the guard fired are journaled:
        # the resumed invocation consumes them
        sl2 = elastic.ElasticSlice(parts=[0, 1, 2, 3, 4, 5], epoch=1,
                                   world=2, guard=lambda: None)
        _, st = _run(left, right, sl2)
    assert st["passes_skipped"] == 2
    assert st["parts_run"] == 4


# ---------------------------------------------------------------------------
# survivable control plane: durable coordinator state,
# incarnation fencing, reconnect ride-through
# ---------------------------------------------------------------------------

def test_heartbeat_knob_coherence_validated():
    """A heartbeat timeout at or below the cadence would silently fence
    every rank between two ordinary beats: the agent refuses to start,
    classified, with BOTH values in the message."""
    with pytest.raises(CylonError) as ei:
        elastic.Agent("127.0.0.1:1", 0, interval_s=0.5, timeout_s=0.5)
    assert ei.value.code == Code.Invalid
    assert "0.5" in ei.value.msg
    assert "CYLON_TPU_HEARTBEAT_TIMEOUT_S" in ei.value.msg
    assert "CYLON_TPU_HEARTBEAT_S" in ei.value.msg


def test_coord_log_roundtrip_and_recovery(tmp_path):
    """The membership ledger, epoch, incarnation, fence set, latches and
    skew ledger journal to the fsync'd CoordLog and a successor recovers
    them — incarnation and epoch bumped exactly once."""
    td = str(tmp_path)
    with config.knob_env(CYLON_TPU_COORD_DIR=td):  # knob-driven, no arg
        c = elastic.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT).start()
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        agents = [elastic.Agent(addr, r, **HB).start() for r in range(3)]
        agents[0].wait_formed()
        agents[2].stop()  # silent death -> fenced by heartbeat timeout
        _wait(lambda: agents[0].view().members == (0, 1),
              msg="rank 2 reaped")
        # one completed rendezvous -> a latch + a skew row in the log
        import threading
        t = threading.Thread(target=lambda: agents[1].barrier("b1", 1))
        t.start()
        agents[0].barrier("b1", 1)
        t.join(5)
        for a in agents:
            a.stop()
    finally:
        c.stop()
    time.sleep(0.1)
    rec = elastic.CoordLog.recover(td)
    assert rec is not None
    assert rec["incarnation"] == 0 and rec["epoch"] == 1
    assert rec["members"] == {0, 1} and rec["dead"] == {2: "heartbeat "
                                                           "timeout"}
    assert ("b1", 1) in rec["latches"]
    assert any(s.get("collective") == "b1" for s in rec["skews"])
    # a successor adopts the ledger: incarnation + epoch bump ONCE, the
    # fence set carries over, the latch survives (completion is monotone)
    c2 = elastic.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT,
                             log_dir=td)
    try:
        assert c2.restored
        assert c2.incarnation == 1
        assert c2.view().epoch == 2 and c2.view().members == (0, 1)
        assert c2._dead == {2: "heartbeat timeout"}
        assert ("b1", 1) in c2._completed_barriers
    finally:
        c2.stop()


def test_coord_log_torn_tail_recovers_to_last_complete_entry(tmp_path):
    """A crash mid-append leaves a torn final line: recovery keeps every
    complete record before it and drops the tail — the durable.py
    manifest discipline on the control plane."""
    td = str(tmp_path)
    log = elastic.CoordLog.open(td)
    log.append({"kind": "open", "incarnation": 4, "epoch": 7, "world": 3})
    log.append({"kind": "member", "rank": 0})
    log.append({"kind": "member", "rank": 1})
    log.append({"kind": "dead", "rank": 1, "reason": "reported", "epoch": 8})
    path = tmp_path / elastic.COORD_LOG
    whole = path.read_bytes()
    # torn tail: the dead record loses its closing half mid-write
    path.write_bytes(whole[:-18])
    rec = elastic.CoordLog.recover(td)
    assert rec is not None
    assert rec["incarnation"] == 4 and rec["epoch"] == 7
    assert rec["members"] == {0, 1} and rec["dead"] == {}  # tail dropped
    # a wholly garbled line after valid records: same contract
    path.write_bytes(whole + b'{"kind": "dead", "rank":')
    rec = elastic.CoordLog.recover(td)
    assert rec["dead"] == {1: "reported"} and rec["epoch"] == 8
    # empty/absent logs recover to None (fresh start, incarnation 0)
    assert elastic.CoordLog.recover(str(tmp_path / "nope")) is None


def test_coord_log_compacts_to_snapshot_past_size_cap(tmp_path,
                                                      monkeypatch):
    """Bounded growth: past COORD_LOG_COMPACT_BYTES the log is rewritten
    as ONE snapshot `open` record (atomic tmp+rename) that recovery
    honors — a long run's per-collective latch/skew appends can never
    grow the file (or recovery's parse cost) without bound."""
    monkeypatch.setattr(elastic, "COORD_LOG_COMPACT_BYTES", 2048)
    c = elastic.Coordinator(2, heartbeat_timeout_s=HB_TIMEOUT,
                            log_dir=str(tmp_path))
    try:
        with c._lock:
            c._last_hb = {0: time.monotonic(), 1: time.monotonic()}
        for i in range(100):
            with c._lock:
                row = {"collective": f"b{i}", "epoch": 0,
                       "skew_ns": i, "slowest_rank": 0}
                c._skews.append(row)
                c._pending_log.append({"kind": "skew", "row": row,
                                       "inc": 0})
                c._pending_log.append({"kind": "latch", "name": f"b{i}",
                                       "epoch": 0, "inc": 0})
                c._completed_barriers[(f"b{i}", 0)] = True
            c._flush_log()
        size = c._log.size()
        assert size < 10 * 2048  # compacted, not 200 records' worth
        rec = elastic.CoordLog.recover(str(tmp_path))
        assert rec is not None and rec["incarnation"] == 0
        assert rec["members"] == {0, 1}
        # the snapshot keeps the bounded tail of the ledgers
        assert rec["skews"] and rec["skews"][-1]["collective"] == "b99"
        assert ("b99", 0) in rec["latches"]
    finally:
        c.stop()


def test_stale_coordinator_compaction_cannot_erase_successor_ledger(
        tmp_path, monkeypatch):
    """Appends from a stale writer are filtered at recovery; a REWRITE
    would erase the successor's ledger outright — so the compaction path
    re-reads the file first, and a higher incarnation on disk makes the
    would-be compactor stand down instead of rewriting."""
    monkeypatch.setattr(elastic, "COORD_LOG_COMPACT_BYTES", 512)
    c = elastic.Coordinator(2, heartbeat_timeout_s=HB_TIMEOUT,
                            log_dir=str(tmp_path))
    try:
        # a successor took over behind a partition: its snapshot (inc 3,
        # with its own fence set) lands on the shared log
        c._log.append({"kind": "open", "incarnation": 3, "epoch": 5,
                       "world": 2, "members": [0],
                       "dead": {"1": "heartbeat timeout"},
                       "latches": [], "skews": []})
        # the stale predecessor keeps staging records until its own
        # compaction threshold trips — it must NOT rewrite
        for i in range(30):
            with c._lock:
                c._pending_log.append({"kind": "latch", "name": f"x{i}",
                                       "epoch": 0, "inc": 0})
            c._flush_log()
        assert c.stale  # found the successor on its own log: stood down
        rec = elastic.CoordLog.recover(str(tmp_path))
        assert rec["incarnation"] == 3  # successor ledger intact
        assert rec["dead"] == {1: "heartbeat timeout"}
    finally:
        c.stop()


def test_restart_with_disabled_log_trusts_live_memory(tmp_path):
    """Once an IO failure disables the CoordLog, the on-disk ledger is
    stale relative to live memory: an in-place restart must bump from
    the LIVE state (fences recorded since the failure stay fenced, the
    epoch still bumps once) instead of adopting the stale snapshot."""
    c = elastic.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT,
                            log_dir=str(tmp_path))
    try:
        now = time.monotonic()
        with c._lock:
            c._last_hb = {r: now for r in range(3)}
            c._mark_dead_locked(2, "reported by rank 0: comm")
        c._flush_log()
        c._log.disabled = True  # disk full / IO failure mid-run
        with c._lock:
            c._mark_dead_locked(1, "heartbeat timeout")  # RAM-only fence
        c.restart()
        assert c.incarnation == 1
        v = c.view()
        assert v.members == (0,)         # both fences survive
        assert c._dead[1] == "heartbeat timeout"
        assert v.epoch == 3              # live epoch 2, bumped once
    finally:
        c.stop()


def test_coord_log_recovery_filters_stale_writer_records(tmp_path):
    """Split-brain through the disk: a partitioned-but-alive predecessor
    never hears the successor's fencing verb and keeps appending to the
    shared log — its post-takeover records carry the OLD incarnation and
    recovery must discard them."""
    td = str(tmp_path)
    log = elastic.CoordLog.open(td)
    log.append({"kind": "open", "incarnation": 0, "epoch": 0, "world": 2})
    log.append({"kind": "member", "rank": 0, "inc": 0})
    log.append({"kind": "member", "rank": 1, "inc": 0})
    log.append({"kind": "open", "incarnation": 1, "epoch": 1, "world": 2})
    # the partitioned incarnation-0 coordinator fences everyone it can
    # no longer hear — split-brain records a recovery must not fold in
    log.append({"kind": "dead", "rank": 0, "reason": "heartbeat timeout",
                "epoch": 7, "inc": 0})
    log.append({"kind": "latch", "name": "x", "epoch": 7, "inc": 0})
    rec = elastic.CoordLog.recover(td)
    assert rec["incarnation"] == 1
    assert rec["members"] == {0, 1} and rec["dead"] == {}
    assert rec["epoch"] == 1  # the stale epoch-7 bump is discarded
    assert ("x", 7) not in rec["latches"]


def test_stale_incarnation_verb_fences_coordinator():
    """Coordinator-side fencing: a verb claiming a NEWER incarnation
    proves a takeover happened — the stale coordinator stands down for
    good (every verb answered `stale_coordinator`, nobody gets fenced
    by its dead detector)."""
    from cylon_tpu_torch.net import control

    c, addr, agents = _gang(1)
    try:
        agents[0].wait_formed()
        resp = control.request(c.address, {"cmd": "heartbeat", "rank": 0,
                                           "coord_incarnation": 2})
        assert resp["ok"] is False
        assert resp["status"] == "stale_coordinator"
        assert c.stale
        # stood down: even an honest verb is refused now
        resp = control.request(c.address, {"cmd": "barrier", "rank": 0,
                                           "name": "x", "epoch": 0})
        assert resp["status"] == "stale_coordinator"
        # ... and its detector no longer fences silent ranks
        agents[0].stop()
        time.sleep(3 * HB_TIMEOUT)
        assert 0 not in c._dead
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_agent_rejects_stale_coordinator_response():
    """Agent-side fencing: a response carrying an incarnation OLDER than
    one already observed is a resurrected pre-takeover coordinator —
    discarded as `StaleCoordinatorError` (an OSError, so every failure-
    accounting path treats it as unreachable), never absorbed."""
    c_new, _, agents = _gang(1)
    c_old = elastic.Coordinator(1, heartbeat_timeout_s=HB_TIMEOUT).start()
    try:
        a = agents[0]
        a.wait_formed()
        # teach the agent a newer incarnation than c_old's 0
        with a._lock:
            a._coord_inc = 3
        a._addr = c_old.address  # the resurrected stale responder
        with pytest.raises(elastic.StaleCoordinatorError):
            a._rpc({"cmd": "heartbeat", "rank": 0})
        assert isinstance(elastic.StaleCoordinatorError("x"), OSError)
        # the view was never absorbed from the stale responder
        assert a.incarnation == 3
    finally:
        for a in agents:
            a.stop()
        c_old.stop()
        c_new.stop()


@pytest.mark.fault
def test_reconnect_window_rides_through_inplace_restart(tmp_path):
    """An in-place coordinator restart (socket dropped, ledger
    recovered, incarnation + epoch bumped, same address): agents inside
    their reconnect window ride it out — membership preserved, guards
    resume via the ordinary EpochChanged path, a barrier at the new
    epoch completes, coord.reconnect counted."""
    import threading

    obs_metrics.reset()
    # a realistic coordinator timeout: detection speed is not under test,
    # and a tight window would reap a GIL-starved beat thread mid-compile
    c = elastic.Coordinator(2, heartbeat_timeout_s=2.0,
                            log_dir=str(tmp_path)).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    agents = [elastic.Agent(addr, r, interval_s=0.05, timeout_s=0.5,
                            reconnect_s=8.0).start() for r in range(2)]
    try:
        agents[0].wait_formed()
        assert agents[0].incarnation == 0
        c.restart(down_s=0.3)
        assert c.incarnation == 1 and c.view().epoch == 1
        _wait(lambda: all(a.incarnation == 1 for a in agents),
              timeout=10.0, msg="agents observe the restart")
        for a in agents:
            assert not a.coordinator_down and not a.fenced
            assert a.members == (0, 1)
            with pytest.raises(elastic.EpochChanged):
                a.ensure_epoch(0)  # the ordinary resume trigger
            a.ensure_epoch(a.epoch)
        out = []
        t = threading.Thread(
            target=lambda: out.append(agents[1].barrier("post", 1)))
        t.start()
        v = agents[0].barrier("post", 1)
        t.join(5)
        assert out and v.epoch == 1
        assert obs_metrics.counter_value("coord.reconnect") >= 2
        assert obs_metrics.counter_value("coord.restart") >= 1
    finally:
        for a in agents:
            a.stop()
        c.stop()
        obs_metrics.reset()


@pytest.mark.fault
def test_reconnect_window_expiry_is_clean_coordinator_lost():
    """The window is BOUNDED: when no coordinator returns, the agent
    still fails clean with the classified CoordinatorLost — a short
    window, an expired deadline, never a hang."""
    c = elastic.Coordinator(1, heartbeat_timeout_s=HB_TIMEOUT).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    a = elastic.Agent(addr, 0, interval_s=0.05, timeout_s=0.5,
                      reconnect_s=0.8).start()
    try:
        a.wait_formed()
        c.stop()
        _wait(lambda: a.coordinator_down, timeout=10.0,
              msg="window expiry declares the coordinator lost")
        with pytest.raises(elastic.CoordinatorLost) as ei:
            a.ensure_epoch(0)
        assert ei.value.code == Code.Unavailable
    finally:
        a.stop()
        c.stop()


@pytest.mark.fault
def test_coord_partition_drops_one_way_and_window_bounds_it():
    """coord_partition drops agent->coordinator messages one-way: the
    process keeps running but none of its verbs arrive.  The coordinator
    (who hears nothing but owes nothing) is untouched; the agent rides
    its reconnect window and then fails CLEAN with CoordinatorLost —
    bounded, classified, never a hang."""
    with resilience.fault_plan("elastic.rpc.r0@2+=coord_partition") as p:
        c = elastic.Coordinator(1, heartbeat_timeout_s=30.0).start()
        addr = f"{c.address[0]}:{c.address[1]}"
        a = elastic.Agent(addr, 0, interval_s=0.05, timeout_s=0.5,
                          reconnect_s=0.8).start()
        try:
            _wait(lambda: a.coordinator_down, timeout=10.0,
                  msg="partitioned agent declares the coordinator lost")
            with pytest.raises(elastic.CoordinatorLost):
                a.ensure_epoch(0)
            # one-way: the coordinator never saw a failure to act on
            assert c.view().members == (0,) and not c._dead
            assert any(k == "coord_partition" for _, k, _h in p.fired)
        finally:
            a.stop()
            c.stop()


def test_serve_telemetry_reregisters_after_coordinator_restart(tmp_path):
    """A restarted coordinator comes up with an EMPTY telemetry
    aggregate (serve views are ephemeral, not journaled): the agent's
    reconnect path pushes an immediate heartbeat — clock + the
    QueryService telemetry attached via attach_to_agent — so the status
    verb's fleet serving view repopulates without waiting out a
    heartbeat interval, and the status reply carries the new
    incarnation."""
    from cylon_tpu_torch import CylonContext
    from cylon_tpu_torch.net import control
    from cylon_tpu_torch.serve import QueryService

    c = elastic.Coordinator(1, heartbeat_timeout_s=2.0,
                            log_dir=str(tmp_path)).start()
    addr = f"{c.address[0]}:{c.address[1]}"
    a = elastic.Agent(addr, 0, interval_s=0.05, timeout_s=0.5,
                      reconnect_s=8.0).start()
    svc = QueryService(ctx=CylonContext.Init("cpu"), queue_cap=2,
                       name="svc-restart")
    try:
        svc.attach_to_agent(a)
        a.wait_formed()
        _wait(lambda: 0 in c._telemetry, msg="telemetry on heartbeats")
        c.restart(down_s=0.3)
        assert c._telemetry == {}  # ephemeral state died with the old
        _wait(lambda: 0 in c._telemetry, timeout=10.0,
              msg="telemetry re-registered after reconnect")
        st = control.request(c.address, {"cmd": "status"})
        assert st["incarnation"] == 1
        assert st["serve"]["queue_depth"] == 0
        assert "0" in st["ranks"]
    finally:
        svc.close()
        a.stop()
        c.stop()


@pytest.mark.fault
def test_elastic_run_rides_through_coordinator_restart_fault(tmp_path):
    """The composed story, in process: a FaultSchedule fires
    coordinator_restart at the detector mid-run; the 1-member gang rides
    through its reconnect window, resumes at the bumped epoch through
    the ordinary shrink-and-resume loop, and the finished result is
    bit-identical to the no-fault oracle."""
    left, right = _inputs(11)
    base, _ = _run(left, right)
    # a COMPOSED timeline: every pass drags 0.4s (so the run is still in
    # flight when the restart lands) and the
    # coordinator restarts at its first detector tick
    sched = (resilience.FaultSchedule(seed=3)
             .at("elastic.coordinator", "coordinator_restart", nth=1)
             .at("elastic.pass.r0", "delay", nth=1, persistent=True))
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "j"),
                         CYLON_TPU_FAULT_DELAY_S="0.4"):
        with sched.install() as plan:
            c = elastic.Coordinator(
                1, heartbeat_timeout_s=2.0,
                log_dir=str(tmp_path / "coord")).start()
            addr = f"{c.address[0]}:{c.address[1]}"
            a = elastic.Agent(addr, 0, interval_s=0.05, timeout_s=0.5,
                              reconnect_s=10.0).start()
            try:
                out = elastic.elastic_run(
                    a, N_PASSES, lambda sl: _run(left, right, sl),
                    finalize=lambda: _run(left, right),
                    run_id="restart-ride")
            finally:
                a.stop()
                c.stop()
                # elastic_run registered the run id + rank as the
                # process-wide fleet identity: clear it so later tests'
                # default export naming is not run-id namespaced
                from cylon_tpu_torch.obs import fleet as obs_fleet_mod

                obs_fleet_mod.reset()
        assert ("elastic.coordinator", "coordinator_restart", 1) in \
            plan.fired
    res, stats = out
    _assert_bit_identical(res, base)
    assert stats["passes_skipped"] == N_PASSES  # assembled from journal
    assert a.incarnation >= 1  # the restart really was observed


# ---------------------------------------------------------------------------
# multi-OS-process integration (the acceptance criterion)
# ---------------------------------------------------------------------------

def _worker_env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CYLON_TPU_FAULT_PLAN", "CYLON_TPU_DURABLE_DIR",
                        "CYLON_TPU_TRACE", "CYLON_TPU_TRACE_DIR")}
    env["CYLON_TPU_DURABLE_DIR"] = str(tmp_path / "journal")
    env["CYLON_TPU_HEARTBEAT_S"] = "0.1"
    # 1.2s: quick detection with margin for beat threads starved by
    # torch's startup under CPU contention (3 worker processes at once)
    env["CYLON_TPU_HEARTBEAT_TIMEOUT_S"] = "1.2"
    # clean-fail semantics by default; the coordinator-restart
    # acceptance test overrides this with a real ride-through window
    env["CYLON_TPU_COORD_RECONNECT_S"] = "0"
    return env


def _spawn_workers(tmp_path, addr, world, env_by_rank):
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_elastic_worker", str(r),
             str(world), addr, str(tmp_path / f"out_r{r}.npz"),
             str(tmp_path / f"stats_r{r}.json")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env_by_rank[r]))
    return procs


def _communicate_all(procs, timeout=240):
    """Drain every worker with a hard bound: a hung worker is KILLED in
    the finally block so it can never leak past the tier-1 timeout."""
    outs = [b""] * len(procs)
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs[i] = out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [o.decode(errors="replace") for o in outs]


@pytest.mark.fault
def test_kill_one_of_three_survivors_bit_identical_to_oracle(tmp_path):
    """3 OS processes, rank 1 killed (os._exit(137), kill -9 semantics)
    at its 2nd pass boundary: the coordinator reaps it by heartbeat
    timeout, the epoch bumps, the 2 survivors re-derive the part
    assignment over the shrunken membership, re-run ONLY the dead
    rank's unjournaled parts, and assemble output bit-identical to the
    single-process oracle — served from the shared durable journal."""
    left, right = _inputs(7)
    base, _ = _run(left, right)
    order = np.argsort(base["l_k"], kind="stable")
    expected = {k: np.asarray(v)[order] for k, v in base.items()}

    coord = elastic.Coordinator(3, heartbeat_timeout_s=1.2).start()
    try:
        addr = f"{coord.address[0]}:{coord.address[1]}"
        env = {r: _worker_env(tmp_path) for r in range(3)}
        env[1]["CYLON_TPU_FAULT_PLAN"] = "elastic.pass.r1@2=rank_kill"
        procs = _spawn_workers(tmp_path, addr, 3, env)
        outs = _communicate_all(procs)
        assert procs[1].returncode == 137, (procs[1].returncode,
                                            outs[1][-2000:])
        for r in (0, 2):
            assert procs[r].returncode == 0, (r, outs[r][-3000:])
            got = dict(np.load(tmp_path / f"out_r{r}.npz",
                               allow_pickle=True))
            _assert_bit_identical(got, expected)
            stats = json.loads((tmp_path / f"stats_r{r}.json").read_text())
            # the final assembly is served ENTIRELY from the journal
            assert stats["passes_skipped"] == N_PASSES
            # the gang shrank at least once and the dead rank is gone
            # (the other survivor's clean leave may have bumped the
            # epoch further by stats-write time)
            assert stats["epoch"] >= 1
            assert 1 not in stats["members"] and r in stats["members"]
        # the coordinator's ledger shows the loss was a heartbeat reap
        # (survivors left cleanly afterwards)
        assert coord._dead[1] == "heartbeat timeout"
        assert coord._dead[0] == "left" and coord._dead[2] == "left"
    finally:
        coord.stop()
    # the JAX package's one-process run of the same inputs: keys and
    # counts exact, float sums and means within its own tolerance
    from tests.torch_parity import assert_frames_equal

    ref, _ = _reference_run(left, right)
    rorder = np.argsort(np.asarray(ref["l_k"]), kind="stable")
    assert_frames_equal(expected, {k: np.asarray(v)[rorder]
                                   for k, v in ref.items()})


@pytest.mark.fault
def test_coordinator_restart_mid_run_survivors_ride_through(tmp_path):
    """THE acceptance criterion: 3 OS processes mid-run, the coordinator
    is killed and a successor restarts from the durable log at the SAME
    address — every worker rides through its reconnect window (local
    passes kept executing and journaling during the outage), resumes at
    the bumped epoch/incarnation, and the assembled result is
    bit-identical to the single-process oracle.  Zero hangs: bounded by
    the reconnect window + communicate timeout + finally-kill."""
    left, right = _inputs(13)
    base, _ = _run(left, right)
    order = np.argsort(base["l_k"], kind="stable")
    expected = {k: np.asarray(v)[order] for k, v in base.items()}

    coord_dir = str(tmp_path / "coord")
    coord = elastic.Coordinator(3, heartbeat_timeout_s=2.5,
                                log_dir=coord_dir).start()
    coord2 = None
    procs = None
    try:
        addr = f"{coord.address[0]}:{coord.address[1]}"
        env = {r: _worker_env(tmp_path) for r in range(3)}
        for r in range(3):
            # a real ride-through window, generously past the outage
            env[r]["CYLON_TPU_COORD_RECONNECT_S"] = "30"
        procs = []
        for r in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_elastic_worker", str(r),
                 "3", addr, str(tmp_path / f"out_r{r}.npz"),
                 str(tmp_path / f"stats_r{r}.json"), "13"],
                cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, env=env[r]))
        deadline = time.monotonic() + 60
        while len(coord.view().members) < 3:
            if time.monotonic() > deadline:
                raise AssertionError("gang never formed")
            time.sleep(0.05)
        time.sleep(0.3)  # let the run get under way
        host, port = coord.address
        coord.stop()  # kill -9 semantics: no goodbye to anyone
        time.sleep(1.0)  # workers accumulate failures, enter the window
        coord2 = elastic.Coordinator(3, heartbeat_timeout_s=2.5,
                                     log_dir=coord_dir, host=host,
                                     port=port).start()
        assert coord2.restored and coord2.incarnation == 1
        outs = _communicate_all(procs)
        for r in range(3):
            assert procs[r].returncode == 0, (r, outs[r][-3000:])
            got = dict(np.load(tmp_path / f"out_r{r}.npz",
                               allow_pickle=True))
            _assert_bit_identical(got, expected)
            stats = json.loads((tmp_path / f"stats_r{r}.json").read_text())
            assert stats["incarnation"] == 1, stats  # restart observed
            assert stats["epoch"] >= 1, stats        # bumped exactly once
            assert stats["passes_skipped"] == N_PASSES
        # nobody was fenced by the restart: the recovered ledger kept
        # all three as members and gave them the window to reconnect
        assert all(coord2._dead.get(r) in (None, "left") for r in range(3))
    finally:
        if procs is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        coord.stop()
        if coord2 is not None:
            coord2.stop()


@pytest.mark.fault
def test_coordinator_death_mid_run_fails_workers_clean(tmp_path):
    """Coordinator dies while 2 workers run: every worker must fail
    CLEAN with the classified CoordinatorLost status (exit 3), never
    hang — bounded by the communicate timeout + finally-kill."""
    coord = elastic.Coordinator(2, heartbeat_timeout_s=1.2).start()
    procs = None
    try:
        addr = f"{coord.address[0]}:{coord.address[1]}"
        env = {r: _worker_env(tmp_path) for r in range(2)}
        procs = _spawn_workers(tmp_path, addr, 2, env)
        # wait for formation (both joined), then die mid-run: the
        # workers are still importing torch / running their first pass
        deadline = time.monotonic() + 60
        while len(coord.view().members) < 2:
            if time.monotonic() > deadline:
                raise AssertionError("gang never formed")
            time.sleep(0.05)
        time.sleep(0.2)
        coord.stop()
        outs = _communicate_all(procs, timeout=120)
        for r in (0, 1):
            assert procs[r].returncode == 3, (r, procs[r].returncode,
                                              outs[r][-3000:])
            assert "coordinator lost" in outs[r]
    finally:
        if procs is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        coord.stop()


# ---------------------------------------------------------------------------
# across the packages: the JAX package's gang pieces against the port's
# ---------------------------------------------------------------------------

def _reference_run(left, right):
    """The JAX package's one-process run of the gang's operation."""
    from cylon_tpu.exec import chunked_join_groupby_tables as ref_engine

    return ref_engine(left, right, on="k", how="inner", group_by="l_k",
                      agg={"a": ["sum"], "b": ["mean"]}, passes=N_PASSES,
                      mode="hash")


@pytest.mark.parametrize("seed", range(4))
def test_owned_parts_matches_reference(seed):
    """The part assignment is the reference's for random (n_parts, rank,
    members): a mixed-package gang would split the key domain alike."""
    from cylon_tpu import elastic as relastic

    rng = np.random.default_rng(seed)
    for _ in range(50):
        members = sorted(rng.choice(16, int(rng.integers(1, 9)),
                                    replace=False).tolist())
        n_parts = int(rng.integers(0, 40))
        for r in members:
            assert elastic.owned_parts(n_parts, r, members) == \
                relastic.owned_parts(n_parts, r, members)
        outsider = next(r for r in range(17) if r not in members)
        with pytest.raises(elastic.EpochChanged):
            elastic.owned_parts(n_parts, outsider, members)
        with pytest.raises(relastic.EpochChanged):
            relastic.owned_parts(n_parts, outsider, members)


def _drive_log(el, td):
    """A short lifetime under ``el``'s package: three ranks join, rank 2
    goes silent and is reaped, ranks 0 and 1 complete one rendezvous."""
    import threading

    c = el.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT,
                       log_dir=td).start()
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        agents = [el.Agent(addr, r, **HB).start() for r in range(3)]
        agents[0].wait_formed()
        agents[2].stop()
        _wait(lambda: agents[0].view().members == (0, 1),
              msg="rank 2 reaped")
        t = threading.Thread(target=lambda: agents[1].barrier("b1", 1))
        t.start()
        agents[0].barrier("b1", 1)
        t.join(5)
        for a in agents:
            a.stop()
    finally:
        c.stop()
    time.sleep(0.1)


def _ledger(rec):
    return {k: rec[k] for k in ("incarnation", "epoch", "world", "members",
                                "dead", "latches")}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_coord_log_recovers_across_packages(tmp_path, writer):
    """A COORD_LOG.jsonl written by either package recovers in the other
    to the same ledger (same record kinds, keys and fold), and a
    successor coordinator of the other package adopts it."""
    from cylon_tpu import elastic as relastic

    el, other = (relastic, elastic) if writer == "reference" \
        else (elastic, relastic)
    td = str(tmp_path)
    _drive_log(el, td)
    mine, theirs = el.CoordLog.recover(td), other.CoordLog.recover(td)
    assert _ledger(mine) == _ledger(theirs)
    assert mine["skews"] == theirs["skews"]
    assert theirs["dead"] == {2: "heartbeat timeout"}
    assert theirs["members"] == {0, 1} and ("b1", 1) in theirs["latches"]
    # every line of the log is one JSON object with sorted keys, as
    # both packages write it
    for line in (tmp_path / elastic.COORD_LOG).read_text().splitlines():
        obj = json.loads(line)
        assert line == json.dumps(obj, sort_keys=True)
    c2 = other.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT, log_dir=td)
    try:
        assert c2.restored and c2.incarnation == 1
        assert c2.view().epoch == 2 and c2.view().members == (0, 1)
        assert c2._dead == {2: "heartbeat timeout"}
    finally:
        c2.stop()


@pytest.mark.parametrize("agents_of", ["reference", "port"])
def test_agents_of_one_package_against_the_others_coordinator(agents_of):
    """The reference's Agent joins, heartbeats and passes barriers
    against the port's Coordinator, and the port's against the
    reference's, with the same views and epochs: one wire protocol."""
    import threading

    from cylon_tpu import elastic as relastic

    ael, cel = (relastic, elastic) if agents_of == "reference" \
        else (elastic, relastic)
    c = cel.Coordinator(3, heartbeat_timeout_s=HB_TIMEOUT).start()
    agents = []
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        agents = [ael.Agent(addr, r, **HB).start() for r in range(3)]
        v = agents[0].wait_formed()
        assert (v.epoch, v.members, v.world) == (0, (0, 1, 2), 3)
        assert c.view().members == (0, 1, 2)
        views = [None] * 3

        def arrive(r):
            views[r] = agents[r].barrier("cross", 0)

        ts = [threading.Thread(target=arrive, args=(r,)) for r in (1, 2)]
        for t in ts:
            t.start()
        arrive(0)
        for t in ts:
            t.join(5)
        assert [tuple(x.members) for x in views] == [(0, 1, 2)] * 3
        assert all(x.epoch == 0 for x in views)
        # a silent member: the coordinator reaps it and every agent's
        # guard sees the epoch move
        agents[2].stop()
        _wait(lambda: all(a.view().members == (0, 1) for a in agents[:2]),
              msg="rank 2 reaped in both views")
        assert agents[0].epoch == agents[1].epoch == c.view().epoch == 1
        with pytest.raises(ael.EpochChanged) as ei:
            agents[0].ensure_epoch(0)
        assert ei.value.code.name == "EpochMismatch"
        st = agents[1].status()
        assert st is not None and st["dead"] == {"2": "heartbeat timeout"}
        # the clock handshake rides the same verbs
        assert agents[0].clock is not None
        agents[1].leave()
        _wait(lambda: c.view().members == (0,), msg="clean leave")
    finally:
        for a in agents:
            a.stop()
        c.stop()


def test_plan_profile_reads_the_gang_skew_ledger():
    """A planned query's profile on an ElasticConfig context pulls the
    coordinator's skew ledger through the context's own agent (the
    gang's 2 ranks complete one rendezvous first)."""
    import threading

    from cylon_tpu_torch import CylonContext, ElasticConfig
    from cylon_tpu_torch.plan import PlanProfile

    # the context's agent beats at the knobs' default cadence (0.5 s):
    # the coordinator keeps the default 2.5 s timeout
    c = elastic.Coordinator(2).start()
    other = None
    try:
        addr = f"{c.address[0]}:{c.address[1]}"
        other = elastic.Agent(addr, 1, **HB).start()
        ctx = CylonContext.InitDistributed(
            ElasticConfig(rank=0, coordinator=addr, devices=["cpu"]))
        agent = ctx.elastic_agent()
        agent.wait_formed()
        assert ctx.GetRank() == 0 and ctx.GetNeighbours() == [1]
        t = threading.Thread(target=lambda: other.barrier("skew", 0))
        t.start()
        agent.barrier("skew", 0)
        t.join(5)
        prof = PlanProfile()
        prof.attach_fleet_skew(ctx)
        assert [r["collective"] for r in prof.fleet_skew] == ["skew"]
        # answered beats came at the cadence, well inside the timeout
        _wait(lambda: agent.beat_gap_max_s > 0, msg="two answered beats")
        assert agent.beat_gap_max_s < c.timeout
        ctx.Finalize()
        _wait(lambda: c.view().members == (1,), msg="rank 0 left")
    finally:
        if other is not None:
            other.stop()
        c.stop()
