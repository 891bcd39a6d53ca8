"""The port's standalone out-of-core operators (``exec.chunked_groupby``,
``chunked_unique``, ``chunked_sort``, ``chunked_repartition``) and
``Table``'s one-shot OOM fallback against the JAX package's, on the same
numpy inputs, on the CPU, mirroring the standalone cases of
``tests/test_exec_tables.py`` and the fallback cases of
``tests/test_resilience.py``; then ``pass_guard`` and ``elastic=``.

One shard: both engines plan the same pass ids (asserted bit for bit),
run the same per-pass kernels and concatenate passes in the same order,
so results compare row for row.  A 4-shard mesh: the reference runs on a
fresh murmur3-patched context (``torch_parity.murmur3_reference``), so
both packages place every row on the same shard and results again compare
row for row, repartition shards slot for slot.  Wide mode against the
reference's default, narrow under ``torch_parity.modes("narrow")``.
Tolerances: keys, counts, rows, strings, extremes and distinct counts
exact; float32 sums rtol=1e-5, float64 rtol=1e-12
(``torch_parity.assert_frames_equal``).
"""
import contextlib

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

from cylon_tpu import exec as rexec
from cylon_tpu.resilience import fault_plan as ref_fault_plan
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import exec as pexec
from cylon_tpu_torch import resilience as presilience
from cylon_tpu_torch.config import JoinConfig
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.status import Code, CylonError

from .torch_parity import assert_frames_equal, modes, murmur3_reference

CPU = CylonContext.Init("cpu")
STATS = ("passes", "mode", "world", "groups", "rows", "parts_run",
         "per_target", "oom_splits", "retries")


def _mesh(world=4):
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


def _same_stats(gstats, wstats):
    for k in STATS:
        assert gstats.get(k) == wstats.get(k), (k, gstats, wstats)


def _ref_mesh(world, string_keys):
    """A fresh reference mesh placing rows as the port does: on murmur3
    for fixed-width key sets, on its unpatched row hash (the port's
    ``ops/hashing.py`` copy) for key sets holding a string."""
    if string_keys:
        from cylon_tpu.context import CylonContext as RContext, TPUConfig

        return contextlib.nullcontext(
            RContext.InitDistributed(TPUConfig(world_size=world)))
    return murmur3_reference(world)


def _both(fn, *args, precision="wide", world=1, string_keys=False, **kw):
    """``fn`` of both packages on the same inputs: one shard (the port on
    the CPU), or a ``world``-shard mesh with the reference placing rows as
    the port does (``_ref_mesh``).  Asserts equal frames (row for row) and
    stats."""
    with modes(precision):
        if world == 1:
            want, wstats = getattr(rexec, fn)(*args, **kw)
            got, gstats = getattr(pexec, fn)(*args, ctx=CPU, **kw)
        else:
            with _ref_mesh(world, string_keys) as rctx:
                want, wstats = getattr(rexec, fn)(*args, ctx=rctx, **kw)
            got, gstats = getattr(pexec, fn)(*args, ctx=_mesh(world), **kw)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_frames_equal(g, w)
    else:
        assert_frames_equal(got, want)
    _same_stats(gstats, wstats)
    return got, gstats


def _groupby_frame(rng, n=6000):
    return pd.DataFrame({"g": rng.integers(0, 200, n).astype(np.int64),
                         "v": rng.random(n).round(3),
                         "w": rng.integers(0, 10, n).astype(np.int64),
                         "f": rng.random(n).astype(np.float32)})


# -- chunked_groupby ----------------------------------------------------------

@pytest.mark.parametrize("precision", ["wide", "narrow"])
@pytest.mark.parametrize("mode", ["range", "hash", "auto"])
def test_chunked_groupby_standalone(rng, precision, mode):
    """Partitioned on the group key, every pass is final, NUNIQUE
    included; against pandas too."""
    df = _groupby_frame(rng)
    got, stats = _both("chunked_groupby", df, "g",
                       {"v": ["sum", "mean"], "w": ["nunique", "max"],
                        "f": ["sum", "count"]},
                       passes=5, mode=mode, precision=precision)
    ref = (df.groupby("g", as_index=False)
           .agg(sum_v=("v", "sum"), nunique_w=("w", "nunique")))
    assert stats["groups"] == len(ref)
    assert stats["mode"] == mode or mode == "auto"
    order = np.argsort(got["g"], kind="stable")
    ref = ref.sort_values("g").reset_index(drop=True)
    np.testing.assert_array_equal(got["g"][order], ref["g"])
    np.testing.assert_allclose(np.asarray(got["sum_v"][order], np.float64),
                               ref["sum_v"], rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(got["nunique_w"][order], np.int64), ref["nunique_w"])


def test_chunked_groupby_pass_ids_bit_for_bit(rng):
    """The group-by's plan (its keys against an empty right side) and its
    refinement levels equal the reference's."""
    keys = [rng.integers(0, 300, 5000).astype(np.int64),
            np.asarray([f"s{i % 7}" for i in range(5000)], object)]
    empty = [np.zeros(0, k.dtype) for k in keys]
    for mode in ("range", "hash", "auto"):
        got = pexec._plan_pass_ids(keys, empty, 6, mode)
        want = rexec._plan_pass_ids(keys, empty, 6, mode)
        assert got[2:] == want[2:]
        np.testing.assert_array_equal(got[0], want[0])
        gplan = pexec._RefinablePlan(got[0], got[1], got[2], got[3], keys, [])
        wplan = rexec._RefinablePlan(want[0], want[1], want[2], want[3],
                                     keys, [])
        for level in range(3):
            np.testing.assert_array_equal(gplan.pids(level)[0],
                                          wplan.pids(level)[0])


@pytest.mark.parametrize("precision", ["wide", "narrow"])
def test_chunked_groupby_string_key(rng, precision):
    n = 3000
    df = pd.DataFrame({
        "g": np.asarray([f"grp-{rng.integers(0, 40):02d}" for _ in range(n)],
                        dtype=object),
        "v": rng.random(n).round(3)})
    got, stats = _both("chunked_groupby", df, "g", {"v": ["sum", "count"]},
                       passes=4, precision=precision)
    assert stats["groups"] == df["g"].nunique()


@pytest.mark.parametrize("precision", ["wide", "narrow"])
def test_chunked_groupby_on_a_mesh(rng, precision):
    """Each pass a distributed ``Table.groupby`` over 4 shards."""
    df = _groupby_frame(rng, 3000)
    got, stats = _both("chunked_groupby", df, "g",
                       {"v": ["sum", "mean"], "w": ["min", "count"]},
                       passes=3, precision=precision, world=4)
    assert stats["world"] == 4 and stats["groups"] == df["g"].nunique()


def test_chunked_groupby_oom_refines_and_matches(rng):
    """An injected OOM on the first pass splits every part (the partition
    keys are the group keys), as the reference's does, and the result
    equals the unfaulted run."""
    data = {"k": rng.integers(0, 300, 4000).astype(np.int32),
            "v": rng.integers(0, 1 << 20, 4000).astype(np.int64)}
    base, _ = pexec.chunked_groupby(data, "k", {"v": ["sum"]}, passes=4,
                                    ctx=CPU)
    with ref_fault_plan("pass_dispatch@1=oom"):
        want, wstats = rexec.chunked_groupby(data, "k", {"v": ["sum"]},
                                             passes=4)
    with presilience.fault_plan("pass_dispatch@1=oom") as plan:
        got, gstats = pexec.chunked_groupby(data, "k", {"v": ["sum"]},
                                            passes=4, ctx=CPU)
    assert plan.fired == [("pass_dispatch", "oom", 1)]
    assert gstats["oom_splits"] == 1 and gstats["parts_run"] == 8
    assert_frames_equal(got, want)
    _same_stats(gstats, wstats)
    order, border = np.argsort(got["k"]), np.argsort(base["k"])
    for k in base:
        np.testing.assert_array_equal(got[k][order], base[k][border])


# -- chunked_unique -----------------------------------------------------------

@pytest.mark.parametrize("world", [1, 4])
def test_chunked_unique(rng, world):
    n = 4000
    df = pd.DataFrame({"a": rng.integers(0, 60, n).astype(np.int64),
                       "b": np.asarray([f"s{rng.integers(0, 4)}"
                                        for _ in range(n)], dtype=object)})
    got, stats = _both("chunked_unique", df, passes=5, world=world,
                       string_keys=True)
    assert stats["rows"] == len(df.drop_duplicates()) and "groups" not in stats
    got1, st1 = _both("chunked_unique", df, "a", passes=3, world=world)
    assert st1["rows"] == df["a"].nunique()


# -- chunked_sort -------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("passes", [1, 5])
def test_chunked_sort_global_order(rng, world, passes):
    n = 8000
    df = pd.DataFrame({"k": rng.integers(-500, 500, n).astype(np.int64),
                       "v": rng.random(n).round(3)})
    got, stats = _both("chunked_sort", df, "k", passes=passes, world=world)
    assert stats["rows"] == n
    np.testing.assert_array_equal(got["k"], np.sort(df["k"].to_numpy()))


@pytest.mark.parametrize("world", [1, 4])
def test_chunked_sort_descending_and_nans(rng, world):
    n = 2000
    k = rng.standard_normal(n)
    k[::37] = np.nan
    df = pd.DataFrame({"k": k, "v": np.arange(n)})
    got, stats = _both("chunked_sort", df, "k", ascending=False,
                       nulls_first=True, passes=4, world=world)
    n_nan = int(np.isnan(k).sum())
    assert all(v is None for v in got["k"][:n_nan])   # nulls first
    body = np.asarray(got["k"][n_nan:], np.float64)
    assert (np.diff(body) <= 0).all() and stats["rows"] == n


def test_chunked_sort_multi_key_mixed_directions(rng):
    n = 3000
    df = {"a": rng.integers(0, 20, n).astype(np.int32),
          "b": rng.integers(-50, 50, n).astype(np.int64),
          "s": np.asarray([f"t{i % 13}" for i in range(n)], object)}
    _both("chunked_sort", df, ["a", "b", "s"], ascending=[False, True, False],
          nulls_first=False, passes=4)


def test_chunked_sort_datetime_nat_routing(rng):
    """NaT keys obey nulls_first like NaN and None."""
    base = np.datetime64("2020-01-01", "us")
    k = base + (rng.integers(0, 1000, 500) * np.timedelta64(1, "D")).astype(
        "timedelta64[us]")
    k = k.astype("datetime64[us]")
    k[::41] = np.datetime64("NaT")
    got, stats = _both("chunked_sort", {"k": k, "v": np.arange(500)}, "k",
                       nulls_first=False, passes=4)
    n_nat = int(np.isnat(k).sum())
    assert all(v is None for v in got["k"][len(k) - n_nat:])
    assert stats["rows"] == len(k)


# -- chunked_repartition ------------------------------------------------------

def _repartition_frame(rng, n):
    return pd.DataFrame({
        "k": rng.integers(-1000, 1000, n).astype(np.int32),
        "v": rng.random(n).astype(np.float32),
        "s": np.asarray([f"x{rng.integers(0, 9)}" for _ in range(n)],
                        dtype=object)})


def _read_shards(out, world):
    """Per target, its parquet parts read back in part order."""
    back = []
    for w in range(world):
        files = sorted((out / f"shard_{w}").glob("part_*.parquet"))
        assert files, f"no files for shard {w}"
        tables = [pq.read_table(f).to_pydict() for f in files]
        back.append({c: sum((t[c] for t in tables), []) for c in tables[0]})
    return back


@pytest.mark.parametrize("world", [1, 4])
def test_chunked_repartition_matches_device_hash(rng, tmp_path, world):
    """Per-target frames slot for slot with the reference's on murmur3
    placement (the one-shard branch: the hash kernel, the stable grouping
    by target, its counts); then the file mode, read back with pyarrow."""
    n = 6000
    df = _repartition_frame(rng, n)
    if world == 1:
        with murmur3_reference(4):
            want, wstats = rexec.chunked_repartition(df, "k", 4, passes=5)
        got, gstats = pexec.chunked_repartition(df, "k", 4, passes=5,
                                                ctx=CPU)
        for g, w in zip(got, want):
            assert_frames_equal(g, w)
        _same_stats(gstats, wstats)
    else:
        got, gstats = _both("chunked_repartition", df, "k", world, passes=5,
                            world=world)
        assert gstats["shuffle_pack"] is False
    assert gstats["rows"] == sum(gstats["per_target"]) == n
    out = tmp_path / "parts"
    none_res, st2 = pexec.chunked_repartition(
        df, "k", 4, passes=3, out_dir=str(out),
        ctx=CPU if world == 1 else _mesh(world))
    assert none_res is None and st2["per_target"] == gstats["per_target"]
    back = _read_shards(out, 4)
    for w in range(4):
        assert back[w]["k"] == got[w]["k"].tolist()
        assert back[w]["s"] == got[w]["s"].tolist()
        np.testing.assert_array_equal(np.asarray(back[w]["v"], np.float32),
                                      got[w]["v"])


def test_chunked_repartition_distributed_layout(rng, tmp_path):
    """The mesh branch: a world other than the mesh's raises; the
    shard_{t}/part_{p}.parquet layout holds; a rerun with fewer passes in
    the same directory leaves no stale part behind."""
    ctx = _mesh(4)
    n = 3000
    df = pd.DataFrame({"k": rng.integers(0, 500, n).astype(np.int32),
                       "v": rng.random(n).astype(np.float32)})
    with pytest.raises(CylonError, match="world") as e:
        pexec.chunked_repartition(df, "k", 8, passes=2, ctx=ctx)
    assert e.value.code == Code.Invalid
    parts, st = pexec.chunked_repartition(df, "k", 4, passes=3, ctx=ctx)
    seen = {}
    for t, p in enumerate(parts):
        for kid in np.unique(p["k"]):
            assert seen.setdefault(int(kid), t) == t
    out = tmp_path / "dist"
    (out / "shard_0").mkdir(parents=True)
    (out / "shard_0" / "notes.txt").write_text("not ours")
    pexec.chunked_repartition(df, "k", 4, passes=3, ctx=ctx, out_dir=str(out))
    _, st3 = pexec.chunked_repartition(df, "k", 4, passes=1, ctx=ctx,
                                       out_dir=str(out))
    assert all(len(list((out / f"shard_{w}").glob("part_*.parquet"))) == 1
               for w in range(4))
    assert (out / "shard_0" / "notes.txt").exists()
    assert sum(len(b["k"]) for b in _read_shards(out, 4)) == n
    assert st3["per_target"] == st["per_target"]


# -- the one-shot OOM fallback ------------------------------------------------

def _join_inputs(rng, n=1500, dom=200):
    left = {"k": rng.integers(0, dom, n).astype(np.int32),
            "a": rng.integers(0, 1 << 20, n).astype(np.int64)}
    right = {"k": rng.integers(0, dom, n).astype(np.int32),
             "b": rng.integers(0, 1 << 20, n).astype(np.int64)}
    return left, right


def _sorted_rows(res):
    names = sorted(res)
    order = np.lexsort(tuple(np.asarray(res[n]) for n in names))
    return {n: np.asarray(res[n])[order] for n in names}


def _assert_same_rows(a, b):
    assert sorted(a) == sorted(b)
    sa, sb = _sorted_rows(a), _sorted_rows(b)
    for n in sa:
        np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)


def _tables(left, right, names_r=("k", "b")):
    lt = Table.from_numpy(["k", "a"], [left["k"], left["a"]], ctx=CPU)
    rt = Table.from_numpy(list(names_r), [right["k"], right["b"]], ctx=CPU)
    rlt = RTable.from_numpy(["k", "a"], [left["k"], left["a"]])
    rrt = RTable.from_numpy(list(names_r), [right["k"], right["b"]])
    return lt, rt, rlt, rrt


@pytest.mark.parametrize("algorithm", ["sort", "hash"])
def test_oneshot_join_falls_back_to_chunked(rng, algorithm):
    """An injected OOM in the one-shot join runs the chunked engine on the
    table's own device: the reference's fallback frame row for row, the
    one-shot result's rows and schema, and a ``table.oneshot_fallback``
    instant."""
    lt, rt, rlt, rrt = _tables(*_join_inputs(rng))
    base = lt.join(rt, on="k", how="inner", algorithm=algorithm)
    obs_spans.reset()
    try:
        with pconfig.knob_env(CYLON_TPU_TRACE="1"):
            with presilience.fault_plan("oneshot_join@1=oom") as plan:
                res = lt.join(rt, on="k", how="inner", algorithm=algorithm)
            names = [e.name for e in obs_spans.events()]
    finally:
        obs_spans.reset()
    assert plan.fired == [("oneshot_join", "oom", 1)]
    assert "table.oneshot_fallback" in names
    assert res.names == base.names and res.ctx is CPU
    with ref_fault_plan("oneshot_join@1=oom"):
        want = rlt.join(rrt, on="k", how="inner", algorithm=algorithm)
    assert_frames_equal(res.to_numpy(), want.to_numpy())
    _assert_same_rows(res.to_numpy(), base.to_numpy())


def test_oneshot_join_fallback_keeps_custom_prefixes(rng):
    left, right = _join_inputs(rng, n=400, dom=50)
    lt, rt, rlt, rrt = _tables(left, right, names_r=("k", "a"))
    cfg = JoinConfig.of("inner", "sort", ("k",), ("k",),
                        left_prefix="left.", right_prefix="right.")
    base = lt.join(rt, config=cfg)
    with presilience.fault_plan("oneshot_join@1=oom"):
        res = lt.join(rt, config=cfg)
    assert res.names == base.names
    assert "left.a" in res.names and "right.a" in res.names
    _assert_same_rows(res.to_numpy(), base.to_numpy())


def test_oneshot_join_fallback_disabled_by_knob(rng):
    lt, rt, _, _ = _tables(*_join_inputs(rng, n=200))
    with pconfig.knob_env(CYLON_TPU_ONESHOT_FALLBACK="0"):
        with presilience.fault_plan("oneshot_join@1=oom"):
            with pytest.raises(presilience.InjectedFault):
                lt.join(rt, on="k", how="inner")


def test_oneshot_join_on_a_mesh_never_falls_back(rng):
    """Multi-shard tables never fall back: the mesh's recovery is its
    own."""
    left, right = _join_inputs(rng, n=300)
    ctx = _mesh(2)
    lt = Table.from_numpy(["k", "a"], [left["k"], left["a"]], ctx=ctx)
    rt = Table.from_numpy(["k", "b"], [right["k"], right["b"]], ctx=ctx)
    with presilience.fault_plan("oneshot_join@1=oom"):
        with pytest.raises(presilience.InjectedFault):
            lt.join(rt, on="k")


def test_oneshot_fallback_passes_knob():
    from cylon_tpu_torch import table as ptable

    assert ptable._fallback_passes() == 4
    with pconfig.knob_env(CYLON_TPU_FALLBACK_PASSES="1"):
        assert ptable._fallback_passes() == 2
    with pconfig.knob_env(CYLON_TPU_FALLBACK_PASSES="7"):
        assert ptable._fallback_passes() == 7
    for name in ("CYLON_TPU_ONESHOT_FALLBACK", "CYLON_TPU_FALLBACK_PASSES"):
        from cylon_tpu import config as rconfig

        assert pconfig.KNOBS[name].default == rconfig.KNOBS[name].default


@pytest.mark.parametrize("aggs", [{"v": ["sum"]},
                                  {"v": ["sum", "max"], "f": ["mean"]}])
def test_oneshot_groupby_falls_back_to_chunked(rng, aggs):
    n = 2000
    k = rng.integers(0, 150, n).astype(np.int32)
    v = rng.integers(0, 1 << 20, n).astype(np.int64)
    f = rng.random(n)
    t = Table.from_numpy(["k", "v", "f"], [k, v, f], ctx=CPU)
    rt = RTable.from_numpy(["k", "v", "f"], [k, v, f])
    base = t.groupby(["k"], aggs)
    with presilience.fault_plan("oneshot_groupby@1=oom") as plan:
        res = t.groupby(["k"], aggs)
    assert plan.fired == [("oneshot_groupby", "oom", 1)]
    assert res.names == base.names
    with ref_fault_plan("oneshot_groupby@1=oom"):
        want = rt.groupby(["k"], aggs)
    assert_frames_equal(res.to_numpy(), want.to_numpy())
    got_rows, base_rows = _sorted_rows(res.to_numpy()), _sorted_rows(
        base.to_numpy())
    for name in base_rows:
        np.testing.assert_allclose(np.asarray(got_rows[name], np.float64),
                                   np.asarray(base_rows[name], np.float64),
                                   rtol=1e-12, err_msg=name)


def test_oneshot_pipeline_groupby_never_falls_back():
    """The chunked engine is hash-based: substituting it for a pipeline
    (run-length) group-by would merge non-adjacent key runs."""
    t = Table.from_numpy(["k", "v"], [np.array([1, 1, 2, 1], np.int32),
                                      np.array([10, 20, 30, 40], np.int64)],
                         ctx=CPU)
    base = t.groupby(["k"], {"v": ["sum"]}, groupby_type="pipeline")
    assert base.row_count == 3
    with presilience.fault_plan("oneshot_groupby@1=oom"):
        with pytest.raises(presilience.InjectedFault):
            t.groupby(["k"], {"v": ["sum"]}, groupby_type="pipeline")


def test_oneshot_fallback_only_on_oom(rng):
    """A transient or unknown failure of the one-shot op is not an OOM:
    it propagates, and no fallback runs."""
    lt, rt, _, _ = _tables(*_join_inputs(rng, n=200))
    for kind in ("comm", "unknown"):
        with presilience.fault_plan(f"oneshot_join@1={kind}"):
            with pytest.raises(presilience.InjectedFault):
                lt.join(rt, on="k")


# -- pass_guard and elastic= --------------------------------------------------

class _StopAtPass(Exception):
    pass


def _guard(stop_at):
    calls = []

    def guard():
        calls.append(len(calls) + 1)
        if len(calls) == stop_at:
            raise _StopAtPass(len(calls))
    return guard, calls


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("op", ["groupby", "sort", "join_groupby"])
def test_pass_guard_stops_the_stream_at_the_third_pass(rng, world, op):
    df = _groupby_frame(rng, 3000)
    ctx = CPU if world == 1 else _mesh(world)
    guard, calls = _guard(3)
    with pytest.raises(_StopAtPass):
        if op == "groupby":
            pexec.chunked_groupby(df, "g", {"v": "sum"}, passes=5, ctx=ctx,
                                  pass_guard=guard)
        elif op == "sort":
            pexec.chunked_sort(df, "g", passes=5, ctx=ctx, pass_guard=guard)
        else:
            pexec.chunked_join_groupby_tables(
                df, df[["g", "w"]], on="g", group_by="l_g",
                agg={"v": "sum"}, passes=5, ctx=ctx, pass_guard=guard)
    assert calls == [1, 2, 3]
    guard, calls = _guard(99)
    pexec.chunked_groupby(df, "g", {"v": "sum"}, passes=5, ctx=ctx,
                          pass_guard=guard)
    assert len(calls) == 5


def test_elastic_is_not_ported(rng):
    df = _groupby_frame(rng, 100)
    for call in (
            lambda: pexec.chunked_join(df, df, on="g", ctx=CPU, elastic=1),
            lambda: pexec.chunked_join_groupby_tables(
                df, df, on="g", group_by="l_g", agg={"l_v": "sum"},
                ctx=CPU, elastic=1),
            lambda: pexec.chunked_groupby(df, "g", {"v": "sum"}, ctx=CPU,
                                          elastic=1)):
        with pytest.raises(CylonError, match="item 11") as e:
            call()
        assert e.value.code == Code.NotImplemented


def test_standalone_operators_without_a_card_raise(rng, monkeypatch):
    """No ctx means the CUDA card; without one every operator raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = _groupby_frame(rng, 100)
    for call in (lambda: pexec.chunked_groupby(df, "g", {"v": "sum"}),
                 lambda: pexec.chunked_unique(df),
                 lambda: pexec.chunked_sort(df, "g"),
                 lambda: pexec.chunked_repartition(df, "g", 4)):
        with pytest.raises(CylonError, match="no CUDA device"):
            call()

