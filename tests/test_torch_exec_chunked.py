"""The port's out-of-core engine (``cylon_tpu_torch/exec.py``) against the
JAX package's (``cylon_tpu/exec.py``) on the same numpy inputs, on the
CPU, mirroring ``tests/test_exec_chunked.py``: the fixed-schema
``chunked_join_groupby`` at several pass counts, skewed and narrow key
domains, negative int64 keys, empty inputs; the host planning (pass ids,
refinement levels) bit for bit; and the resilience paths (an injected OOM
that splits the remaining passes, transient faults that retry, the fatal
OOM past the split budget).

Both precisions: wide against the reference's default, narrow against the
reference under ``torch_parity.modes("narrow")`` (its scans on the Pallas
kernels in interpret mode).  Tolerances: pass ids, keys, counts, capacities
and stats exact; float32 sums and means rtol=1e-5 (prefix sums and
segmented scans round in different orders, ``tests/test_torch_segments.py``);
float64 results rtol=1e-12.
"""
import os

import numpy as np
import pytest
import torch

from cylon_tpu import config as rconfig
from cylon_tpu import exec as rexec
from cylon_tpu import resilience as rresilience
from cylon_tpu_torch import CylonContext
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import exec as pexec
from cylon_tpu_torch import resilience as presilience
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.ops import scan
from cylon_tpu_torch.status import Code, CylonError

from .torch_parity import assert_frames_equal, modes

CPU = CylonContext.Init("cpu")
STATS = ("passes", "mode", "chunk_cap", "cap_l", "cap_r", "out_cap",
         "world", "parts_run", "groups", "rows", "oom_splits", "retries")


def _data(rng, n, lo=0, hi=None, dtype=np.int32):
    hi = n if hi is None else hi
    return (rng.integers(lo, hi, n).astype(dtype),
            rng.random(n).astype(np.float32),
            rng.integers(lo, hi, n).astype(dtype),
            rng.random(n).astype(np.float32))


def _both(data, passes, mode="wide", **kw):
    with modes(mode):
        want, wstats = rexec.chunked_join_groupby(*data, passes, **kw)
        got, gstats = pexec.chunked_join_groupby(*data, passes, ctx=CPU, **kw)
    return got, gstats, want, wstats


def _assert_same_run(got, gstats, want, wstats):
    """Equal frames (row for row) and equal planning/run stats."""
    assert_frames_equal(got, want)
    for k in STATS:
        assert gstats.get(k) == wstats.get(k), (k, gstats, wstats)


# -- key_range_bounds ---------------------------------------------------------

@pytest.mark.parametrize("lo,hi,passes", [(3, 103, 7), (0, 10, 1),
                                          (-50, 50, 16), (0, 5, 9)])
def test_key_range_bounds_match_reference(lo, hi, passes):
    got = pexec.key_range_bounds(lo, hi, passes)
    assert got == rexec.key_range_bounds(lo, hi, passes)
    assert got[0][0] == lo and got[-1][1] == hi
    assert all(got[i][1] == got[i + 1][0] for i in range(passes - 1))


def test_key_range_bounds_rejects_zero_passes():
    with pytest.raises(ValueError):
        pexec.key_range_bounds(0, 10, 0)


# -- the fixed-schema main path -----------------------------------------------

@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("passes", [1, 2, 4, 7])
def test_chunked_join_groupby_matches_reference(rng, mode, passes):
    got, gstats, want, wstats = _both(_data(rng, 6000), passes, mode)
    _assert_same_run(got, gstats, want, wstats)
    assert gstats["passes"] == passes
    assert gstats["mode"] == "range"


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_skewed_keys(rng, mode):
    """Heavy skew: one pass carries most rows; capacity must still hold."""
    n = 6000
    lk = np.where(rng.random(n) < 0.7, 5, rng.integers(0, 1000, n)) \
        .astype(np.int32)
    rk = rng.integers(0, 1000, n).astype(np.int32)
    data = (lk, rng.random(n).astype(np.float32), rk,
            rng.random(n).astype(np.float32))
    _assert_same_run(*_both(data, 8, mode))


def test_chunked_empty_inputs():
    z_i = np.zeros(0, np.int32)
    z_f = np.zeros(0, np.float32)
    got, gstats, want, wstats = _both((z_i, z_f, z_i, z_f), 4)
    _assert_same_run(got, gstats, want, wstats)
    assert gstats["groups"] == 0 and got["key"].size == 0


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_narrow_key_domain(rng, mode):
    """More passes than distinct keys: passes clamp, result stays right."""
    got, gstats, want, wstats = _both(_data(rng, 3000, 0, 3), 16, mode)
    _assert_same_run(got, gstats, want, wstats)
    assert gstats["passes"] <= 3


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_negative_int64_keys(rng, mode):
    """Signed 64-bit key domains chunk correctly (bounds span negatives)."""
    data = _data(rng, 4000, -5000, 5000, np.int64)
    _assert_same_run(*_both(data, 6, mode))


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("passes", [1, 4, 7])
def test_chunked_hash_join_groupby_matches_reference(rng, mode, passes):
    """The fused key-grouped pass program with ``algo="hash"``: groups
    come out in chain-head order, row for row with the reference."""
    got, gstats, want, wstats = _both(_data(rng, 6000), passes, mode,
                                      algo="hash")
    _assert_same_run(got, gstats, want, wstats)
    assert gstats["passes"] == passes


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_hash_algo_matches_reference(rng, mode):
    """``algo="hash"`` runs, once refused, through the other two pass
    programs, row for row against the reference: the plain join (every
    join type) and the hash group-by of a non-key column (partials
    combined across passes)."""
    lk, lv, rk, rv = _data(rng, 3000, 0, 500)
    left = {"k": lk, "lv": lv, "g": (lk % 7).astype(np.int32)}
    right = {"k": rk[rk % 5 != 3], "rv": rv[rk % 5 != 3]}
    for how in ("inner", "left", "right", "outer"):
        with modes(mode):
            want, wstats = rexec.chunked_join(left, right, on="k", how=how,
                                              passes=4, algo="hash")
            got, gstats = pexec.chunked_join(left, right, on="k", how=how,
                                             passes=4, algo="hash", ctx=CPU)
        assert_frames_equal(got, want)
        assert gstats["rows"] == wstats["rows"] > 0
    agg = {"lv": "sum", "rv": ["mean", "count"]}
    with modes(mode):
        want, wstats = rexec.chunked_join_groupby_tables(
            left, right, on="k", group_by="g", agg=agg, passes=4,
            algo="hash")
        got, gstats = pexec.chunked_join_groupby_tables(
            left, right, on="k", group_by="g", agg=agg, passes=4,
            algo="hash", ctx=CPU)
    assert_frames_equal(got, want)
    assert gstats["groups"] == wstats["groups"] == 7


def test_engine_refuses_the_journal(rng, tmp_path):
    """A mesh engine runs unjournaled under a durable dir, as the
    reference's does (its mesh path returns before the journal opens): no
    run directory is written, and the result is the unjournaled one."""
    from cylon_tpu_torch import MeshConfig

    mesh = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=2))
    data = _data(rng, 400)
    want, _ = pexec.chunked_join_groupby(*data, 2, ctx=mesh)
    with pconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        got, stats = pexec.chunked_join_groupby(*data, 2, ctx=mesh)
        g, gstats = pexec.chunked_groupby(
            {"k": data[0], "v": data[1]}, "k", {"v": "sum"}, passes=2,
            ctx=mesh)
    assert os.listdir(tmp_path) == []
    assert "passes_skipped" not in stats and "passes_skipped" not in gstats
    assert_frames_equal(got, want)


def test_one_shard_engine_journals(rng, tmp_path):
    """The one-shard engine journals every pass under a durable dir and a
    repeat serves them all from the journal, bit for bit."""
    data = _data(rng, 400)
    with pconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        first, s1 = pexec.chunked_join_groupby(*data, 2, ctx=CPU)
        again, s2 = pexec.chunked_join_groupby(*data, 2, ctx=CPU)
    assert len(os.listdir(tmp_path)) == 1
    assert (s1["passes_skipped"], s1["parts_run"]) == (0, 2)
    assert s2["passes_skipped"] == 2 and "parts_run" not in s2
    for k in first:
        np.testing.assert_array_equal(again[k].view(np.uint8),
                                      first[k].view(np.uint8))


def test_engine_without_a_card_raises(rng, monkeypatch):
    """No ctx means the CUDA card; without one the engine raises, never
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CylonError, match="no CUDA device"):
        pexec.chunked_join_groupby(*_data(rng, 100), 2)


def test_narrow_passes_launch_nothing_on_the_cpu(rng):
    """On CPU tensors the scan wrappers take their plain versions: a
    narrow run counts no kernel launch."""
    scan.reset_launches()
    with modes("narrow"):
        pexec.chunked_join_groupby(*_data(rng, 2000), 4, ctx=CPU)
    assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}


# -- host planning, bit for bit -----------------------------------------------

def _plan_keys(rng, kind, n):
    if kind == "int32":
        return [rng.integers(0, 500, n).astype(np.int32)]
    if kind == "int64_neg":
        return [rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)]
    if kind == "float":
        v = rng.standard_normal(n).astype(np.float64)
        v[::7] = -0.0
        v[1::7] = 0.0
        v[2::11] = np.nan
        return [v]
    if kind == "uint":
        return [rng.integers(0, 1 << 32, n).astype(np.uint32)]
    if kind == "string":
        ids = rng.integers(0, 10**6, n)
        return [np.asarray([f"k{i % 97:03d}" for i in ids], object)]
    if kind == "datetime":
        return [(np.datetime64("2020-01-01") + rng.integers(0, 900, n)
                 .astype("timedelta64[D]")).astype("datetime64[ns]")]
    return [rng.integers(0, 30, n).astype(np.int64),
            np.asarray([f"s{i % 5}" for i in range(n)], object)]


KINDS = ["int32", "int64_neg", "float", "uint", "string", "datetime",
         "multi"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["range", "hash", "auto"])
def test_plan_pass_ids_bit_for_bit(rng, kind, mode):
    kl, kr = _plan_keys(rng, kind, 3000), _plan_keys(rng, kind, 1700)
    got = pexec._plan_pass_ids(kl, kr, 6, mode)
    want = rexec._plan_pass_ids(kl, kr, 6, mode)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for a in (kl[0], kr[0]):
        np.testing.assert_array_equal(pexec._key_prefix_u64(a),
                                      rexec._key_prefix_u64(a))
    np.testing.assert_array_equal(pexec._hash_u64_cols(kl),
                                  rexec._hash_u64_cols(kl))


@pytest.mark.parametrize("kind", ["int32", "float", "string", "multi"])
@pytest.mark.parametrize("mode", ["range", "hash"])
def test_refinable_plan_pids_bit_for_bit(rng, kind, mode):
    kl, kr = _plan_keys(rng, kind, 2500), _plan_keys(rng, kind, 900)
    pl, pr, n, used = rexec._plan_pass_ids(kl, kr, 3, mode)
    got = pexec._RefinablePlan(pl, pr, n, used, kl, kr)
    want = rexec._RefinablePlan(pl, pr, n, used, kl, kr)
    for level in range(4):
        for g, w in zip(got.pids(level), want.pids(level)):
            np.testing.assert_array_equal(g, w)
        parts = list(range(got.part_count(level)))
        assert got.split(parts, level) == want.split(parts, level)
        assert got.max_part_rows(parts, level) \
            == want.max_part_rows(parts, level)
        np.testing.assert_array_equal(
            got.parts_redistributing(parts, level),
            want.parts_redistributing(parts, level))


def test_null_mask_matches_reference():
    for a in (np.array([1.0, np.nan, 2.0]),
              np.array(["2020-01-01", "NaT"], "datetime64[ns]"),
              np.array(["a", None, np.nan], object),
              np.arange(3)):
        got, want = pexec._null_mask(a), rexec._null_mask(a)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


# -- resilience ---------------------------------------------------------------

def _both_under_fault(data, passes, spec, **env):
    with rconfig.knob_env(CYLON_TPU_FAULT_PLAN=spec, **env):
        want, wstats = rexec.chunked_join_groupby(*data, passes)
    with pconfig.knob_env(CYLON_TPU_FAULT_PLAN=spec, **env):
        got, gstats = pexec.chunked_join_groupby(*data, passes, ctx=CPU)
    return got, gstats, want, wstats


def test_injected_oom_refines_and_matches_the_unfaulted_run(rng):
    """``pass_dispatch@2=oom`` fails the second pass: every remaining part
    splits in two, the first pass's frame is kept, and the result equals
    the unfaulted run (and the reference's faulted run, stat for stat)."""
    data = _data(rng, 8000)
    base, _ = pexec.chunked_join_groupby(*data, 4, ctx=CPU)
    obs_spans.reset()
    obs_metrics.reset()
    try:
        with pconfig.knob_env(CYLON_TPU_TRACE="1"):
            got, gstats, want, wstats = _both_under_fault(
                data, 4, "pass_dispatch@2=oom")
        assert gstats["oom_splits"] == 1
        _assert_same_run(got, gstats, want, wstats)
        order = np.argsort(got["key"], kind="stable")
        border = np.argsort(base["key"], kind="stable")
        for k in base:
            np.testing.assert_array_equal(got[k][order], base[k][border])
        by_name = {}
        for e in obs_spans.events():
            by_name.setdefault(e.name, []).append(e)
        assert [e.attrs["site"] for e in by_name["fault.injected"]] \
            == ["pass_dispatch"]
        splits = by_name["exec.oom_split"]
        assert len(splits) == 1 and splits[0].attrs["level"] == 1
        done = [e for e in by_name["exec.pass"] if "rows" in (e.attrs or {})]
        assert len(done) == gstats["parts_run"] == 7  # 1 + 3 parts x 2
        assert len(by_name["exec.pass"]) == 8  # and the failed attempt
        counters = obs_metrics.snapshot()["counters"]
        assert counters["oom.refinements"] == 1
        assert counters["exec.parts_run"] == 7
    finally:
        obs_spans.reset()
        obs_metrics.reset()


@pytest.mark.parametrize("spec", ["pass_dispatch@1=comm",
                                  "host_fetch@2=timeout"])
def test_transient_fault_retries_in_place(rng, spec):
    data = _data(rng, 4000)
    got, gstats, want, wstats = _both_under_fault(
        data, 3, spec, CYLON_TPU_RETRY_BASE_S="0")
    assert gstats["retries"] == 1 and "oom_splits" not in gstats
    _assert_same_run(got, gstats, want, wstats)


def test_persistent_oom_past_the_split_budget_is_fatal(rng):
    data = _data(rng, 2000)
    for pkg, env in ((pexec, pconfig), (rexec, rconfig)):
        kw = {"ctx": CPU} if pkg is pexec else {}
        with env.knob_env(CYLON_TPU_FAULT_PLAN="pass_dispatch@1+=oom",
                          CYLON_TPU_MAX_OOM_SPLITS="2"):
            with pytest.raises(Exception) as e:
                pkg.chunked_join_groupby(*data, 2, **kw)
        assert e.value.code.name == "OutOfMemory"
        assert "after 2 pass-doublings" in str(e.value)


def test_quarantine_isolates_a_poisoned_part(rng):
    """CYLON_TPU_QUARANTINE_AFTER=2: the part that keeps failing is
    dropped into stats["quarantined"] instead of failing the run."""
    data = _data(rng, 3000)
    got, gstats, want, wstats = _both_under_fault(
        data, 3, "host_fetch@2+=comm", CYLON_TPU_QUARANTINE_AFTER="2",
        CYLON_TPU_RETRY_BASE_S="0")
    _assert_same_run(got, gstats, want, wstats)
    assert [q["part"] for q in gstats["quarantined"]] \
        == [q["part"] for q in wstats["quarantined"]]


def test_run_passes_streams_positional_passes_with_retry():
    """``_run_passes``: warm on an empty chunk, then passes 0..n-1 in
    order; a transient fault retries the pass in place."""
    seen = []

    def chunk(p):
        return (torch.full((4,), p),)

    def prog(x):
        return x * 2

    def fetch(out):
        seen.append(int(out[0]))
        return {"v": out.numpy()}, 4

    stats = {}
    with presilience.fault_plan("host_fetch@2=comm"):
        with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0"):
            _, _, frames, total = pexec._run_passes(
                prog, lambda: (torch.zeros(4),), chunk, 3, fetch, 0.0,
                stats=stats)
    assert [int(f["v"][0]) for f in frames] == [0, 2, 4]
    assert total == 12 and stats["retries"] == 1 and stats["passes"] == 3


def test_fault_plan_hook_kinds_match_reference():
    """The port keeps every kind of the reference (the engine's probes',
    the run journal's, the serve layer's, the elastic gang's and the
    router's), each with the reference's message."""
    assert set(presilience.FAULT_KINDS) == {
        "oom", "timeout", "comm", "unknown", "hang", "delay", "killhard",
        "journal_corrupt", "cache_evict_race", "disk_full", "bitrot",
        "sync_partial", "tenant_flood", "shed", "rank_kill",
        "heartbeat_loss", "coordinator_loss", "coordinator_restart",
        "coord_partition", "coord_slow", "replica_sick"}
    assert set(rresilience.FAULT_KINDS) == set(presilience.FAULT_KINDS)
    for kind in presilience.FAULT_KINDS:
        assert presilience._KIND_MESSAGES[kind] \
            == rresilience._KIND_MESSAGES[kind]
