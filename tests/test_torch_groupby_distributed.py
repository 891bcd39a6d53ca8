"""The port's distributed group-bys and broadcast
(``cylon_tpu_torch/parallel/ops.py``) on 2- and 4-shard CPU meshes against
the JAX package's on its CPU meshes, on the same numpy inputs.

- The pipeline group-by (``groupby_type="pipeline"``), NUNIQUE alone or
  beside other aggregates, the salted NUNIQUE group-by (salt 2, 4, 8) and
  the pre-partitioned group-by compare gathered and key-sorted with the
  unpatched reference, whose CPU hash places rows elsewhere; and shard for
  shard, slot for slot, with the reference forced onto its murmur3
  placement (``torch_parity.murmur3_reference``).  Float value columns
  hash folded in the port (-0.0 as +0.0), so salted buckets of float
  values are compared gathered only.
- ``broadcast_gather`` compares slot for slot with the reference's
  per-buffer path (its CPU meshes do not pack), strings included.
- Tolerances: keys, counts, NUNIQUE and integer results exact; float64
  sums and means rtol 1e-12 (wide), float32 rtol 1e-5 (narrow: partial
  sums added in another order, as ``test_torch_distributed.py`` states).
"""
import numpy as np
import pytest

from cylon_tpu.ops.groupby import AggOp as RAggOp
from cylon_tpu.parallel import ops as rpar
from cylon_tpu.status import CylonError as RCylonError
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, interop
from cylon_tpu_torch.ops.groupby import AggOp
from cylon_tpu_torch.parallel import ops as par_ops
from cylon_tpu_torch.status import Code, CylonError

from .torch_parity import (assert_shards_equal, modes, murmur3_reference,
                           ref_table_shards)

WORLDS = [2, 4]
MODES = ["wide", "narrow"]
RTOL = {"wide": 1e-12, "narrow": 1e-5}


@pytest.fixture(scope="module")
def pmesh():
    return {w: CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                       world_size=w))
            for w in (1, 2, 4)}


def _both(names, arrays, rctx, pctx):
    return (RTable.from_numpy(names, arrays, ctx=rctx),
            Table.from_numpy(names, arrays, ctx=pctx))


def _float(v):
    """A host column as float64, nulls (None) as NaN."""
    if v.dtype == object:
        return np.array([np.nan if x is None else x for x in v], np.float64)
    return v.astype(np.float64)


def _gathered(t, key: str):
    """A table's live rows on the host, sorted by its non-null key."""
    f = t.to_numpy()
    order = np.argsort(f[key], kind="stable")
    return {n: np.asarray(v)[order] for n, v in f.items()}


def _assert_gathered(got, want, key: str, rtol: float):
    """Gathered and key-sorted: names, keys and integer columns exact,
    floats within ``rtol`` (NaN where the other has NaN)."""
    g, w = _gathered(got, key), _gathered(want, key)
    assert list(g) == list(w)
    for n in w:
        if w[n].dtype.kind == "f" or w[n].dtype == object:
            np.testing.assert_allclose(_float(g[n]), _float(w[n]), rtol=rtol,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(g[n], w[n], err_msg=n)


def _assert_shards_close(pt, rt, rtol: float):
    """Shard for shard, slot for slot: counts, validity and integer data
    exact, float data within ``rtol``."""
    names, p_shards, p_counts = interop.table_shards_to_arrays(pt)
    r_shards, r_counts = ref_table_shards(rt)
    assert tuple(names) == tuple(rt.names)
    np.testing.assert_array_equal(p_counts, r_counts)
    for p_cols, r_cols in zip(p_shards, r_shards):
        for (pd_, pv, _, _), (rd, rv, _) in zip(p_cols, r_cols):
            np.testing.assert_array_equal(pv, rv)
            assert pd_.dtype == rd.dtype
            if rd.dtype.kind == "f":
                np.testing.assert_allclose(pd_, rd, rtol=rtol)
            else:
                np.testing.assert_array_equal(pd_, rd)


def _sorted_frame(seed, n=400, keys=40):
    """``tests/test_groupby.py``'s pipeline input: pre-sorted int64 keys,
    so every shard's runs of a key are contiguous."""
    rng = np.random.default_rng(seed)
    return ["k", "v"], [np.sort(rng.integers(0, keys, n)).astype(np.int64),
                        rng.random(n)]


PIPE_AGG = {"v": ["sum", "mean", "count"]}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_groupby_matches_reference(request, pmesh, world, mode):
    rctx = request.getfixturevalue(f"ctx{world}")
    rt, pt = _both(*_sorted_frame(world), rctx, pmesh[world])
    with modes(mode):
        want = rt.groupby("k", PIPE_AGG, groupby_type="pipeline")
        got = pt.groupby("k", PIPE_AGG, groupby_type="pipeline")
        hashed = pt.groupby("k", PIPE_AGG)
    assert got.row_count == want.row_count == hashed.row_count > 0
    _assert_gathered(got, want, "k", RTOL[mode])
    _assert_gathered(got, hashed, "k", RTOL[mode])


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_groupby_shard_for_shard(pmesh, world):
    names, arrays = _sorted_frame(world + 10)
    with murmur3_reference(world) as rctx:
        rt = RTable.from_numpy(names, arrays, ctx=rctx)
        want = rt.groupby("k", PIPE_AGG, groupby_type="pipeline")
    got = Table.from_numpy(names, arrays, ctx=pmesh[world]).groupby(
        "k", PIPE_AGG, groupby_type="pipeline")
    _assert_shards_close(got, want, RTOL["wide"])


def _nunique_frame(case, seed):
    rng = np.random.default_rng(seed)
    # the cases of tests/test_partition_nunique.py
    if case == "only":  # ::test_distributed_nunique_only
        n = 3000
        return ["k", "v"], [rng.integers(0, 30, n).astype(np.int64),
                            rng.integers(0, 12, n).astype(np.int64)], \
            {"v": ["nunique"]}
    if case == "mixed":  # ::test_distributed_nunique_mixed_aggs
        n = 2500
        return ["k", "v", "w"], [rng.integers(0, 25, n).astype(np.int64),
                                 rng.integers(0, 9, n).astype(np.int64),
                                 rng.random(n)], \
            {"v": ["nunique"], "w": ["sum", "mean"]}
    n = 1200  # ::test_distributed_nunique_with_nulls
    v = rng.integers(0, 6, n).astype(float)
    v[rng.random(n) < 0.2] = np.nan
    return ["k", "v"], [rng.integers(0, 10, n).astype(np.int64), v], \
        {"v": ["nunique"]}


NUNIQUE_CASES = [("only", 1), ("only", 2), ("only", 4), ("mixed", 2),
                 ("mixed", 4), ("nulls", 4)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case,world", NUNIQUE_CASES)
def test_nunique_matches_reference(request, pmesh, case, world, mode):
    rctx = request.getfixturevalue("local_ctx" if world == 1
                                   else f"ctx{world}")
    names, arrays, agg = _nunique_frame(case, world)
    rt, pt = _both(names, arrays, rctx, pmesh[world])
    with modes(mode):
        want = rt.groupby("k", agg)
        got = pt.groupby("k", agg)
    _assert_gathered(got, want, "k", RTOL[mode])
    # against numpy: distinct non-null values per key
    f = _gathered(got, "k")
    k, v = arrays[0], arrays[1]
    keys = np.unique(k)
    np.testing.assert_array_equal(f["k"], keys)
    np.testing.assert_array_equal(f["nunique_v"], [
        np.unique(v[(k == x) & ~np.isnan(v.astype(float))]).size
        for x in keys])


@pytest.mark.parametrize("case,world", [("only", 4), ("mixed", 2)])
def test_nunique_shard_for_shard(pmesh, case, world):
    names, arrays, agg = _nunique_frame(case, world + 20)
    with murmur3_reference(world) as rctx:
        want = RTable.from_numpy(names, arrays, ctx=rctx).groupby("k", agg)
    got = Table.from_numpy(names, arrays, ctx=pmesh[world]).groupby("k", agg)
    _assert_shards_close(got, want, RTOL["wide"])


def _salt_frame(seed, value_dtype):
    rng = np.random.default_rng(seed)
    n = 2000
    k = np.where(rng.random(n) < 0.6, 3, rng.integers(0, 40, n))  # hot key
    v = rng.integers(0, 50, n)
    if value_dtype == "float":
        v = v.astype(np.float64) - 25.0
        v[::11] = -0.0
        v[::17] = np.nan
    return ["k", "v"], [k.astype(np.int64), v.astype(
        np.int64 if value_dtype == "int" else np.float64)]


NUNIQUE_V = ((1, AggOp.NUNIQUE),)
R_NUNIQUE_V = ((1, RAggOp.NUNIQUE),)


@pytest.mark.parametrize("value_dtype", ["int", "float"])
@pytest.mark.parametrize("salt", [2, 4, 8])
@pytest.mark.parametrize("world", WORLDS)
def test_salted_nunique_equals_unsalted_and_reference(request, pmesh, world,
                                                      salt, value_dtype):
    """Salted equals unsalted, in the port and against the reference's
    unsalted group-by; for int values also against the reference's salted
    one (for float values that one splits 0.0 from -0.0, see below)."""
    rctx = request.getfixturevalue(f"ctx{world}")
    rt, pt = _both(*_salt_frame(salt, value_dtype), rctx, pmesh[world])
    got = par_ops.distributed_groupby(pt, (0,), NUNIQUE_V, 0, salt=salt)
    assert got.names == ("k", "nunique_v")
    _assert_gathered(got, par_ops.distributed_groupby(pt, (0,), NUNIQUE_V,
                                                      0), "k", 0)
    _assert_gathered(got, rt.groupby("k", {"v": "nunique"}), "k", 0)
    if value_dtype == "int":
        _assert_gathered(got, rpar.distributed_groupby(
            rt, (0,), R_NUNIQUE_V, 0, salt=salt), "k", 0)


@pytest.mark.parametrize("salt", [2, 8])
def test_salted_nunique_counts_signed_zero_once(ctx4, pmesh, salt):
    """0.0 == -0.0, so key 1 has 3 distinct values and key 2 has 2.  Its
    0.0 and -0.0 sit on different shards, so the per-shard distinct pass
    keeps both; the reference's salted group-by then buckets them by their
    raw float bits into different buckets and counts them twice (4), while
    its unsalted group-by counts them once.  The port folds float values
    before bucketing (``hashing.hash_columns``), so salted equals
    unsalted."""
    arrays = [np.array([1, 1, 1, 1, 2, 2], np.int64),
              np.array([0.0, 1.0, -0.0, 2.0, -0.0, 5.0])]
    rt, pt = _both(["k", "v"], arrays, ctx4, pmesh[4])
    got = par_ops.distributed_groupby(pt, (0,), NUNIQUE_V, 0, salt=salt)
    assert pt.row_counts.tolist() == [2, 2, 2, 0]
    assert _gathered(got, "k")["nunique_v"].tolist() == [3, 2]
    assert _gathered(rt.groupby("k", {"v": "nunique"}),
                     "k")["nunique_v"].tolist() == [3, 2]
    assert _gathered(rpar.distributed_groupby(
        rt, (0,), R_NUNIQUE_V, 0, salt=salt), "k")["nunique_v"].tolist() \
        == [4, 2]  # the reference's split


@pytest.mark.parametrize("salt", [2, 8])
def test_salted_nunique_shard_for_shard(pmesh, salt):
    names, arrays = _salt_frame(salt + 30, "int")
    with murmur3_reference(4) as rctx:
        want = rpar.distributed_groupby(RTable.from_numpy(
            names, arrays, ctx=rctx), (0,), R_NUNIQUE_V, 0, salt=salt)
    got = par_ops.distributed_groupby(Table.from_numpy(
        names, arrays, ctx=pmesh[4]), (0,), NUNIQUE_V, 0, salt=salt)
    assert_shards_equal(got, want)


PRE_AGGS = ((1, AggOp.SUM), (1, AggOp.MEAN), (2, AggOp.MAX),
            (1, AggOp.STDDEV))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", WORLDS)
def test_pre_partitioned_equals_shuffled_path(request, pmesh, world, mode):
    rctx = request.getfixturevalue(f"ctx{world}")
    rng = np.random.default_rng(41)
    n = 1500
    arrays = [rng.integers(0, 60, n).astype(np.int64), rng.random(n),
              rng.integers(-50, 50, n).astype(np.int32)]
    rt, pt = _both(["k", "x", "y"], arrays, rctx, pmesh[world])
    r_aggs = tuple((c, RAggOp(int(op))) for c, op in PRE_AGGS)
    with modes(mode):
        shuffled = pt.shuffle("k")
        got = par_ops.distributed_groupby(shuffled, (0,), PRE_AGGS, 1,
                                          pre_partitioned=True)
        want = par_ops.distributed_groupby(shuffled, (0,), PRE_AGGS, 1)
        ref = rpar.distributed_groupby(rt.shuffle("k"), (0,), r_aggs, 1,
                                       pre_partitioned=True)
    # every group sits on the shard the key's shuffle put it on
    np.testing.assert_array_equal(got.row_counts, want.row_counts)
    _assert_gathered(got, want, "k", RTOL[mode])
    _assert_gathered(got, ref, "k", RTOL[mode])


INVALID = [
    ("pre-partitioned NUNIQUE", dict(pre_partitioned=True), NUNIQUE_V),
    ("salt with a SUM", dict(salt=2), ((1, AggOp.NUNIQUE), (1, AggOp.SUM))),
    ("salt over two columns", dict(salt=4),
     ((1, AggOp.NUNIQUE), (2, AggOp.NUNIQUE))),
    ("salt and pre-partitioned", dict(salt=2, pre_partitioned=True),
     ((1, AggOp.SUM),)),
]


@pytest.mark.parametrize("label,kw,aggs", INVALID,
                         ids=[c[0] for c in INVALID])
def test_invalid_shapes_raise_as_the_reference(ctx2, pmesh, label, kw, aggs):
    arrays = [np.arange(20, dtype=np.int64), np.arange(20, dtype=np.int64),
              np.arange(20.0)]
    rt, pt = _both(["k", "v", "w"], arrays, ctx2, pmesh[2])
    r_aggs = tuple((c, RAggOp(int(op))) for c, op in aggs)
    with pytest.raises(RCylonError, match="Invalid"):
        rpar.distributed_groupby(rt, (0,), r_aggs, 0, **kw)
    with pytest.raises(CylonError) as e:
        par_ops.distributed_groupby(pt, (0,), aggs, 0, **kw)
    assert e.value.code == Code.Invalid


def _broadcast_frame(n):
    rng = np.random.default_rng(n)
    v = rng.random(n).astype(np.float32)
    v[::7] = np.nan  # nulls
    s = rng.choice(["a", "bb", "Customer#000000042", None], n).astype(object)
    return ["k", "v", "s"], [rng.integers(0, 100, n).astype(np.int32), v, s]


@pytest.mark.parametrize("world,n", [(2, 37), (4, 101), (4, 3)])
def test_broadcast_gather_slot_for_slot(request, pmesh, world, n):
    rctx = request.getfixturevalue(f"ctx{world}")
    rt, pt = _both(*_broadcast_frame(n), rctx, pmesh[world])
    want = rpar.broadcast_gather(rt)
    got = par_ops.broadcast_gather(pt)
    assert got.row_counts.tolist() == [n] * world
    assert got.shard_capacity == pt.shard_capacity * world
    assert_shards_equal(got, want)
    # every shard holds every row, in source-rank order
    for s in range(world):
        one = Table(got.shards[s:s + 1], got.counts[s:s + 1], got.names,
                    pmesh[1])
        f, want_f = one.to_numpy(), pt.to_numpy()
        for name in want_f:
            np.testing.assert_array_equal(f[name].astype(object),
                                          want_f[name].astype(object))


def test_broadcast_gather_one_shard_is_identity(pmesh):
    t = Table.from_numpy(*_broadcast_frame(9), ctx=pmesh[1])
    assert par_ops.broadcast_gather(t) is t
