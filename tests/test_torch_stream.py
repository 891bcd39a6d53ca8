"""The port's streaming tables (``cylon_tpu_torch/stream/``) against the
JAX package's (``cylon_tpu/stream/``), the counterpart of the cases of
``tests/test_stream.py``: the append/watermark contract, incremental
group-by and join refresh, durable crash-resume, GC pinning and the serve
layer's ``refresh`` op.

The load-bearing assertions: a port refresh at watermark N is
bit-identical to the port's ``recompute_cold()`` (and pinned across
worlds 1/2/4 and across a kill -9 mid-append) while executing only the
delta; and it equals the reference's refresh of the same batches on CPU
JAX, keys and counts exactly and float columns within rtol 1e-12 (both
packages accumulate float64 on the CPU, but their segmented sums add in
different association orders, so the last bits may differ;
``torch_parity.assert_frames_equal``).  Each package journals into its own
root, except in the cross-package case, where a log the reference
appended replays in the port (both fingerprints of the batch log are
knob-blind and keyed alike).

``test_stream.py``'s case that waits for a later item (``WAITING``): the
router's hedging gate (A11b); the serve path of that case runs here in
``test_serve_refresh_op_and_cache_hit``.
"""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cylon_tpu import config as rconfig
from cylon_tpu.stream import GroupByQuery as RGroupByQuery
from cylon_tpu.stream import JoinQuery as RJoinQuery
from cylon_tpu.stream import StreamTable as RStreamTable
from cylon_tpu_torch import (CylonContext, CylonError, MeshConfig, config,
                             durable)
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.serve.cache import served_from_journal
from cylon_tpu_torch.stream import (GroupByQuery, JoinQuery, StreamTable,
                                    run_refresh)

from .torch_parity import assert_frames_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = CylonContext.Init("cpu")

#: cases of tests/test_stream.py that wait for a later ROADMAP item
WAITING = {"test_serve_refresh_op_cache_and_hedge_safety": "A11b"}


def _digest(frame) -> str:
    h = hashlib.sha256()
    for name in frame:
        a = np.asarray(frame[name])
        h.update(f"{name}|{a.dtype}|{a.shape}".encode())
        h.update(repr(a.tolist()).encode() if a.dtype == object
                 else a.tobytes())
    return h.hexdigest()


def _assert_bit_identical(got, expected):
    assert set(got) == set(expected), (set(got), set(expected))
    for k in expected:
        a, b = np.asarray(got[k]), np.asarray(expected[k])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (k, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            assert a.tolist() == b.tolist(), k
        else:
            assert a.tobytes() == b.tobytes(), k


def _same_as_ref(got, want):
    assert_frames_equal(got, want, float_rtol=1e-12)


def _batches(rows=16, n=3, seed=19):
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 6, rows).astype(np.int64),
             "v": rng.random(rows)} for _ in range(n)]


def _ref_refreshes(root, name, batches, by, agg, **kw):
    """The reference's refresh frame after each append, journaled under
    its own ``root``."""
    out = []
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(root)):
        s = RStreamTable(name)
        q = None
        for b in batches:
            s.append(b)
            q = q or RGroupByQuery(s, by, agg, **kw)
            out.append(q.refresh()[0])
    return out


# ---------------------------------------------------------------------------
# append/watermark contract
# ---------------------------------------------------------------------------

def test_append_contract_validation():
    s = StreamTable("contract")
    with pytest.raises(CylonError):
        s.append({})  # no columns
    assert s.watermark == 0 and s.schema is None
    s.append({"k": np.arange(3), "v": np.ones(3)})
    assert s.watermark == 1 and s.schema == ("k", "v")
    with pytest.raises(CylonError):  # ragged
        s.append({"k": np.arange(3), "v": np.ones(2)})
    with pytest.raises(CylonError):  # reshape
        s.append({"k": np.arange(3), "x": np.ones(3)})
    with pytest.raises(CylonError):  # query before schema exists
        GroupByQuery(StreamTable("empty-one"), ["k"], {"v": "sum"},
                     ctx=CPU)


def test_query_without_ctx_runs_on_the_card_or_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = StreamTable("no-card")
    s.append({"k": np.arange(3), "v": np.ones(3)})
    with pytest.raises(CylonError, match="no CUDA device"):
        GroupByQuery(s, ["k"], {"v": "sum"})


def test_idempotent_replay_after_reopen(tmp_path):
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        b = _batches()
        s = StreamTable("replay")
        assert s.append(b[0]) == 0 and s.append(b[1]) == 1
        s2 = StreamTable("replay")
        assert s2.watermark == 2
        assert s2.append(b[0]) == 0  # replayed no-op
        assert s2.append(b[1]) == 1  # replayed no-op
        assert s2.watermark == 2
        assert s2.append(b[2]) == 2  # genuinely new
        assert s2.watermark == 3
        assert s2.batch_rows() == [16, 16, 16]


# ---------------------------------------------------------------------------
# incremental group-by: delta-only + bit-identity, pinned across worlds
# ---------------------------------------------------------------------------

_WORLD_DIGESTS = {}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_incremental_refresh_delta_only_bit_identical(world, tmp_path):
    """The query runs on a one-shard context of the mesh's first device
    whatever the mesh's width, so every world gives the same bits."""
    ctx = CPU if world == 1 else CylonContext.InitDistributed(
        MeshConfig(devices=["cpu"], world_size=world))
    b = _batches()
    agg = {"v": ["sum", "mean", "count"]}
    want = _ref_refreshes(tmp_path / "ref", f"orders-w{world}", b, ["k"],
                          agg)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable(f"orders-w{world}")
        s.append(b[0])
        q = GroupByQuery(s, ["k"], agg, ctx=ctx)
        f1, st1 = q.refresh()
        assert st1["mode"] == "incremental"
        assert st1["parts_run"] == 1 and st1["partial_rows"] == 16
        _assert_bit_identical(f1, q.recompute_cold())
        _same_as_ref(f1, want[0])

        s.append(b[1])
        f2, st2 = q.refresh()
        assert st2["parts_run"] == 1 and st2["partial_rows"] == 16
        _same_as_ref(f2, want[1])

        s.append(b[2])
        miss0 = obs_metrics.counter_value("plan_cache.miss")
        delta0 = obs_metrics.counter_value("stream.rows_delta")
        f3, st3 = q.refresh()
        assert obs_metrics.counter_value("plan_cache.miss") == miss0
        assert obs_metrics.counter_value("stream.rows_delta") - delta0 == 16
        assert st3["parts_run"] == 1 and st3["partial_rows"] == 16
        assert st3["passes_skipped"] == 2  # batches answered from state
        _assert_bit_identical(f3, q.recompute_cold())
        _same_as_ref(f3, want[2])
        _WORLD_DIGESTS.setdefault("groupby", _digest(f3))
        assert _WORLD_DIGESTS["groupby"] == _digest(f3), \
            f"stream refresh drifted across worlds at world={world}"

        f4, st4 = q.refresh()
        assert st4["parts_run"] == 0 and st4["passes_skipped"] == 1
        _assert_bit_identical(f4, f3)
        assert served_from_journal(st4) and not served_from_journal(st3)


def test_refresh_resumes_from_persisted_state(tmp_path):
    """Fresh handles reload the spilled partial state and fold only the
    delta, with zero drift against the cold oracle."""
    b = _batches(seed=23)
    agg = {"v": ["sum", "min", "var"]}
    want = _ref_refreshes(tmp_path / "ref", "resume", b, ["k"], agg)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable("resume")
        s.append(b[0])
        s.append(b[1])
        q = GroupByQuery(s, ["k"], agg, ctx=CPU)
        q.refresh()

        s2 = StreamTable("resume")
        assert s2.watermark == 2
        q2 = GroupByQuery(s2, ["k"], agg, ctx=CPU)
        s2.append(b[2])
        f, st = q2.refresh()
        assert st["parts_run"] == 1 and st["partial_rows"] == 16, st
        _assert_bit_identical(f, q2.recompute_cold())
    _same_as_ref(f, want[2])


def test_state_regrowth_restarts_the_fold_deterministically(tmp_path):
    """A combine overflowing the state capacity regrows it and refolds
    from batch 0; the refresh still equals the cold fold and the
    reference (new keys in every batch force the regrowth)."""
    rng = np.random.default_rng(5)
    b = [{"k": (np.arange(16) + 16 * i).astype(np.int64),
          "v": rng.random(16)} for i in range(3)]
    agg = {"v": ["sum", "max"]}
    want = _ref_refreshes(tmp_path / "ref", "grow", b, ["k"], agg)
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable("grow")
        q = None
        for i, batch in enumerate(b):
            s.append(batch)
            q = q or GroupByQuery(s, ["k"], agg, ctx=CPU)
            f, st = q.refresh()
            _same_as_ref(f, want[i])
        _assert_bit_identical(f, q.recompute_cold())
    assert st["state_cap"] >= 48
    assert obs_metrics.counter_value("stream.state_regrown") >= 1
    obs_metrics.reset()


def test_nunique_refreshes_in_full_mode(tmp_path):
    b = [{"k": np.array([1, 1, 2]), "v": np.array([3, 4, 3])},
         {"k": np.array([2, 1]), "v": np.array([9, 3])}]
    want = _ref_refreshes(tmp_path / "ref", "nu", b, ["k"],
                          {"v": "nunique"})
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable("nu")
        for batch in b:
            s.append(batch)
        q = GroupByQuery(s, ["k"], {"v": "nunique"}, ctx=CPU)
        f, st = q.refresh()
        assert st["mode"] == "full" and not q.incremental
        assert f["k"].tolist() == [1, 2]
        assert f["nunique_v"].tolist() == [2, 2]
        assert "FULL" in q.explain() and "NUNIQUE" in q.explain()
        _assert_bit_identical(f, q.recompute_cold())
    _same_as_ref(f, want[1])


# ---------------------------------------------------------------------------
# incremental join over a static dim table
# ---------------------------------------------------------------------------

def test_incremental_join_probes_only_delta(tmp_path):
    b = [{"k": np.array([1, 2, 3]), "x": np.array([10., 20., 30.])},
         {"k": np.array([2, 5, 9]), "x": np.array([40., 50., 60.])}]
    dim = {"k": np.array([1, 2, 5]),
           "name": np.array(["a", "b", "e"], dtype=object)}
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "ref")):
        rs = RStreamTable("fact")
        for batch in b:
            rs.append(batch)
        want = RJoinQuery(rs, dim, on="k", how="inner").refresh()[0]
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable("fact")
        s.append(b[0])
        j = JoinQuery(s, dim, on="k", how="inner", ctx=CPU)
        f1, st1 = j.refresh()
        assert st1["parts_run"] == 1
        s.append(b[1])
        f2, st2 = j.refresh()
        assert st2["parts_run"] == 1 and st2["passes_skipped"] == 1
        assert st2["partial_rows"] == 3
        _assert_bit_identical(f2, j.recompute_cold())
        assert f2["name"].tolist() == ["a", "b", "b", "e"]
        assert "INCREMENTAL" in j.explain()
        assert "broadcast" in j.explain()
    _same_as_ref(f2, want)


# ---------------------------------------------------------------------------
# kill -9 mid-append, fresh-process resume
# ---------------------------------------------------------------------------

def _worker_env(tmp_path, **knobs):
    env = dict(os.environ)
    env.pop("CYLON_TPU_FAULT_PLAN", None)
    env["CYLON_TPU_DURABLE_DIR"] = str(tmp_path / "journal")
    env.update({k: v for k, v in knobs.items() if v is not None})
    return env


@pytest.mark.fault
def test_killhard_mid_append_resume_bit_identical(tmp_path):
    """kill -9 inside the third append's spill/manifest window, then a
    FRESH process re-runs the identical script: committed appends replay
    as no-ops, the torn batch lands cleanly, and the final refresh is
    bit-identical to the cold recompute while folding only the delta."""
    from tests import torch_stream_worker as worker

    killed = subprocess.run(
        [sys.executable, "-m", "tests.torch_stream_worker",
         str(tmp_path / "k.npz"), str(tmp_path / "k.json"), "--append-only"],
        cwd=REPO, env=_worker_env(
            tmp_path, CYLON_TPU_FAULT_PLAN="journal_commit@3=killhard"),
        capture_output=True, text=True, timeout=300)
    assert killed.returncode == 137, (killed.returncode, killed.stderr[-2000:])

    out, stats_path = tmp_path / "r.npz", tmp_path / "r.json"
    resumed = subprocess.run(
        [sys.executable, "-m", "tests.torch_stream_worker", str(out),
         str(stats_path)],
        cwd=REPO, env=_worker_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]

    stats = json.loads(stats_path.read_text())
    assert stats["watermark"] == 3
    assert stats["batches_appended"] == 1  # only the torn batch was new
    last = stats["refreshes"][-1]
    assert last["rows_delta"] == worker.ROWS, last
    assert last["partial_rows"] == worker.ROWS, last
    assert last["parts_run"] == 1 and last["plan_cache_miss"] == 0, last

    with config.knob_env(CYLON_TPU_DURABLE_DIR=""):
        s = StreamTable("golden")
        for b in worker.batches():
            s.append(b)
        golden = GroupByQuery(s, ["k"], {"v": ["sum", "mean", "count"]},
                              ctx=CPU).recompute_cold()
    got = dict(np.load(out, allow_pickle=True))
    _assert_bit_identical(got, golden)
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=""):
        rs = RStreamTable("golden")
        for b in worker.batches():
            rs.append(b)
        want = RGroupByQuery(rs, ["k"], {"v": ["sum", "mean", "count"]}
                             ).recompute_cold()
    _same_as_ref(got, want)


# ---------------------------------------------------------------------------
# the log across packages
# ---------------------------------------------------------------------------

def test_reference_appended_log_replays_in_the_port(tmp_path):
    """A batch log the reference appended replays in the port's
    StreamTable with the same watermark and frames (the batch log's
    fingerprints are knob-blind and keyed alike), the port's appends of
    the same batches are no-ops, and its refresh equals the reference's."""
    b = _batches(seed=41)
    agg = {"v": ["sum", "count"]}
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        rs = RStreamTable("shared")
        for batch in b[:2]:
            rs.append(batch)
        want2 = RGroupByQuery(rs, ["k"], agg).refresh()[0]
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable("shared")
        assert s.watermark == 2 and s.schema == ("k", "v")
        assert s.fingerprint == rs.fingerprint
        for (_, got, rows), (_, ref, rrows) in zip(s.frames(), rs.frames()):
            assert rows == rrows
            _assert_bit_identical(got, ref)
        assert s.append(b[0]) == 0 and s.append(b[1]) == 1  # replayed
        assert s.watermark == 2
        q = GroupByQuery(s, ["k"], agg, ctx=CPU)
        f2, st = q.refresh()
        assert st["parts_run"] == 2
        _same_as_ref(f2, want2)
        assert s.append(b[2]) == 2
        f3, _ = q.refresh()
        _assert_bit_identical(f3, q.recompute_cold())
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        rs2 = RStreamTable("shared")  # the port's append reads back too
        assert rs2.watermark == 3
        want3 = RGroupByQuery(rs2, ["k"], agg).recompute_cold()
    _same_as_ref(f3, want3)


# ---------------------------------------------------------------------------
# GC pinning: live stream state survives the LRU sweep
# ---------------------------------------------------------------------------

def test_pinned_stream_state_survives_gc(tmp_path):
    obs_metrics.reset()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable("hot-dashboard")
        s.append({"k": np.arange(64), "v": np.ones(64)})
        q = GroupByQuery(s, ["k"], {"v": "sum"}, ctx=CPU)
        q.refresh()
        j = durable.open_run("f" * 64, "victim")
        j.record_pass(0, 0, {"x": np.arange(32)}, 32)
        j.record_done(1, 32)
        old = os.path.join(str(tmp_path), "f" * 64)
        os.utime(os.path.join(old, durable.MANIFEST), (1, 1))
        q.refresh()  # cache hit; moves the live-journal guard off victim

        pinned_dirs = [r["dir"] for r in durable.scan_runs(str(tmp_path))
                       if r["pinned"]]
        assert len(pinned_dirs) >= 2  # the batch log + the state run

        evicted, _ = durable.gc_journal(str(tmp_path), cap=1)
        assert evicted >= 1 and not os.path.exists(old)
        for d in pinned_dirs:
            assert os.path.exists(d), f"pinned run {d} was evicted"
        assert obs_metrics.counter_value("durable.gc_skipped_pinned") >= 2

        s.close(unpin=True)
        q.close(unpin=True)
        assert not any(r["pinned"] for r in durable.scan_runs(str(tmp_path)))
    obs_metrics.reset()


# ---------------------------------------------------------------------------
# the serve layer's refresh op
# ---------------------------------------------------------------------------

def test_serve_refresh_op_and_cache_hit(tmp_path):
    """The serve path of ``test_serve_refresh_op_cache_and_hedge_safety``
    (its router half waits for A11b): a spec submitted to the service
    rebuilds the stream from the journal on the service's device, a
    repeat at an unchanged watermark is a result-cache hit, and a fresh
    ``run_refresh`` of the spec replays it."""
    from cylon_tpu.serve.service import QueryService as RQueryService
    from cylon_tpu_torch.serve.service import OPS, QueryService

    assert "refresh" in OPS
    spec = {"kind": "groupby", "stream": "served", "by": ["k"],
            "agg": {"v": ["sum", "count"]}}
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "ref")):
        rs = RStreamTable("served")
        for b in _batches(seed=31):
            rs.append(b)
        with RQueryService() as rsvc:
            want = rsvc.submit("tenant-a", "refresh", spec).result(
                timeout=300)[0]
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        s = StreamTable("served")
        for b in _batches(seed=31):
            s.append(b)
        with QueryService(ctx=CPU) as svc:
            tk = svc.submit("tenant-a", "refresh", spec)
            frame, stats = tk.result(timeout=300)
            assert stats["watermark"] == 3 and stats["parts_run"] >= 1
            tk2 = svc.submit("tenant-a", "refresh", spec)
            frame2, stats2 = tk2.result(timeout=300)
            assert tk2.cache_hit, stats2
            _assert_bit_identical(frame2, frame)
        frame3, stats3 = run_refresh(spec, ctx=CPU)
        assert stats3["parts_run"] == 0 and stats3["passes_skipped"] == 1
        _assert_bit_identical(frame3, frame)
        golden = GroupByQuery(StreamTable("served"), ["k"],
                              {"v": ["sum", "count"]},
                              ctx=CPU).recompute_cold()
        _assert_bit_identical(frame, golden)
    _same_as_ref(frame, want)


# ---------------------------------------------------------------------------
# observability surfaces
# ---------------------------------------------------------------------------

def test_stream_counters_always_scrape():
    from cylon_tpu_torch.obs import openmetrics

    text = openmetrics.render({"counters": {}, "gauges": {}})
    assert "cylon_tpu_stream_batches_appended_total 0" in text
    assert "cylon_tpu_stream_rows_delta_total 0" in text


def test_explain_refresh_renders_decision(tmp_path):
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable("exp")
        s.append({"k": np.arange(4), "v": np.ones(4)})
        q = GroupByQuery(s, ["k"], {"v": ["sum", "mean"]}, ctx=CPU)
        text = q.explain()
        assert "INCREMENTAL" in text and "watermark=1" in text
        assert "finalize" in text and "sum(v)" in text
        assert q.to_spec() == {"kind": "groupby", "stream": "exp",
                               "by": ["k"], "agg": {"v": ["sum", "mean"]},
                               "ddof": 0}


def test_stream_waits_name_their_item():
    """The cases that wait are test_stream.py's own, each names its
    ROADMAP item, and every other case has a counterpart here."""
    import ast

    with open(os.path.join(REPO, "tests", "test_stream.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    ported = {n for n in globals() if n.startswith("test_")}
    assert set(WAITING) <= names
    assert names - set(WAITING) <= ported, names - set(WAITING) - ported
    assert set(WAITING.values()) == {"A11b"}
