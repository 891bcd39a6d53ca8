"""The port's hash join (``cylon_tpu_torch/ops/hash_join.py``) against the
JAX package's (``cylon_tpu/ops/hash_join.py``) on the same numpy inputs,
in both precisions (narrow: the reference's scans on its Pallas kernels;
wide: its default), mirroring ``tests/test_hash_join.py`` and the
``algo="hash"`` cases of ``tests/test_key_grouped_join.py``.

- ``match_ranges_hash``'s five outputs compare element for element, and
  every join (local, key-grouped, the main-path pipeline) slot for slot:
  the port hashes keys as the reference does, with float keys folded
  first, so wherever no key is -0.0 or a NaN payload the table, the chain
  heads and the ranges are the reference's.
- Distributed joins place rows by murmur3 in the port and by the jnp hash
  in the reference on the CPU, so they compare gathered and sorted.
- Tolerances: everything exact except the pipeline's float32 SUM and MEAN,
  rtol 1e-5 (prefix sums in another order, ``test_torch_join_groupby.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from cylon_tpu.config import JoinType as RJoinType
from cylon_tpu.ops import groupby as rgb
from cylon_tpu.ops import hash_join as rhj
from cylon_tpu.ops import join as rjoin
from cylon_tpu.table import Table as RTable
from cylon_tpu.table import _cap_round
from cylon_tpu_torch import CylonContext, MeshConfig, Table, pipeline
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import groupby, hash_join, join, scan

from .torch_parity import (assert_columns_equal, assert_tables_equal,
                           columns, modes, np_of)

HOWS = ["inner", "left", "right", "outer"]
MODES = ["wide", "narrow"]
CPU = CylonContext.Init("cpu")


def _both(names, arrays, ctx_r, ctx_p=CPU):
    return (RTable.from_numpy(names, arrays, ctx=ctx_r),
            Table.from_numpy(names, arrays, ctx=ctx_p))


def _assert_same(a, b):
    """Two of the port's one-shard tables, slot for slot."""
    assert tuple(a.names) == tuple(b.names)
    assert int(a.counts[0]) == int(b.counts[0])
    assert_columns_equal(a.shards[0], b.shards[0])


def _rows(frame):
    """A host frame's rows as a sorted multiset; nulls (None, NaN) as
    None, floats as float64 values."""
    def norm(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return None
        return v.item() if isinstance(v, np.generic) else v

    cols = [np.asarray(frame[n]).tolist() for n in frame]
    return sorted((tuple(norm(v) for v in row) for row in zip(*cols)),
                  key=repr)


def _local_data(rng, nl=80, nr=65, keys=12):
    l = [rng.integers(0, keys, nl).astype(np.int64), rng.random(nl)]
    r = [rng.integers(0, keys, nr).astype(np.int64), rng.random(nr)]
    return l, r


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("how", HOWS)
def test_hash_join_types_local(local_ctx, mode, how):
    rng = np.random.default_rng(5)
    l, r = _local_data(rng)
    rl, pl = _both(["k", "x"], l, local_ctx)
    rr, pr = _both(["k", "y"], r, local_ctx)
    with modes(mode):
        want = rl.join(rr, on="k", how=how, algorithm="hash")
        got = pl.join(pr, on="k", how=how, algorithm="hash")
    assert_tables_equal(got, want)  # slot for slot


@pytest.fixture(scope="module")
def pmesh():
    return {w: CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                       world_size=w))
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("how", HOWS)
def test_hash_join_distributed(request, pmesh, world, how):
    ctx = request.getfixturevalue(f"ctx{world}")
    rng = np.random.default_rng(world)
    l, r = _local_data(rng, 180, 140, 25)
    rl, pl = _both(["k", "x"], l, ctx, pmesh[world])
    rr, pr = _both(["k", "y"], r, ctx, pmesh[world])
    want = rl.distributed_join(rr, on="k", how=how, algorithm="hash")
    got = pl.distributed_join(pr, on="k", how=how, algorithm="hash")
    assert got.num_shards == world
    assert got.row_count == want.row_count
    assert _rows(got.to_numpy()) == _rows(want.to_numpy())
    # and the port's own sort join, gathered and sorted
    assert _rows(got.to_numpy()) == _rows(pl.distributed_join(
        pr, on="k", how=how).to_numpy())


@pytest.mark.parametrize("mode", MODES)
def test_hash_join_duplicates_both_sides(local_ctx, mode):
    rl, pl = _both(["k", "x"], [np.array([1, 1, 1, 2]),
                                np.array([1.0, 2.0, 3.0, 4.0])], local_ctx)
    rr, pr = _both(["k", "y"], [np.array([1, 1, 3]),
                                np.array([10.0, 20.0, 30.0])], local_ctx)
    with modes(mode):
        for how, n in (("inner", 6), ("outer", 8)):
            got = pl.join(pr, on="k", how=how, algorithm="hash")
            assert got.row_count == n
            assert_tables_equal(got, rl.join(rr, on="k", how=how,
                                             algorithm="hash"))


def test_hash_join_all_one_key(local_ctx):
    """Total duplication: the build finishes in its claim and chain
    rounds."""
    n = 300
    rl, pl = _both(["k", "x"], [np.full(n, 7), np.arange(n, dtype=float)],
                   local_ctx)
    rr, pr = _both(["k", "y"], [np.full(5, 7), np.arange(5, dtype=float)],
                   local_ctx)
    hash_join.reset_rounds()
    got = pl.join(pr, on="k", how="inner", algorithm="hash")
    assert got.row_count == n * 5
    # two calls (count, gather): 2 build rounds and 1 probe round each
    assert hash_join.ROUNDS == {"build": 4, "probe": 2}
    assert_tables_equal(got, rl.join(rr, on="k", how="inner",
                                     algorithm="hash"))


@pytest.mark.parametrize("mode", MODES)
def test_hash_join_string_and_multi_key(local_ctx, mode):
    rng = np.random.default_rng(11)
    l = [rng.choice(["a", "bb", "ccc"], 60).astype(object),
         rng.integers(0, 4, 60).astype(np.int64), rng.random(60)]
    r = [rng.choice(["a", "bb", "dddd"], 50).astype(object),
         rng.integers(0, 4, 50).astype(np.int64), rng.random(50)]
    rl, pl = _both(["k1", "k2", "x"], l, local_ctx)
    rr, pr = _both(["k1", "k2", "y"], r, local_ctx)
    with modes(mode):
        want = rl.join(rr, left_on=["k1", "k2"], right_on=["k1", "k2"],
                       how="inner", algorithm="hash")
        got = pl.join(pr, left_on=["k1", "k2"], right_on=["k1", "k2"],
                      how="inner", algorithm="hash")
    assert got.row_count > 0
    assert_tables_equal(got, want)


def test_hash_join_null_keys_match_sort_semantics(local_ctx):
    """Null keys join with null keys in both algorithms."""
    l = [np.array([1.0, np.nan, 3.0]), np.array([1.0, 2.0, 3.0])]
    r = [np.array([np.nan, 3.0]), np.array([10.0, 30.0])]
    rl, pl = _both(["k", "x"], l, local_ctx)
    rr, pr = _both(["k", "y"], r, local_ctx)
    got = pl.join(pr, on="k", how="inner", algorithm="hash")
    assert got.row_count == 2
    assert_tables_equal(got, rl.join(rr, on="k", how="inner",
                                     algorithm="hash"))
    _assert_same(got, pl.join(pr, on="k", how="inner"))


def test_hash_join_empty_sides(local_ctx):
    e = [np.zeros(0, np.int64), np.zeros(0)]
    one_l, one_r = [np.array([1]), np.array([1.0])], [np.array([1]),
                                                      np.array([1.0])]
    rl, pl = _both(["k", "x"], e, local_ctx)
    rr, pr = _both(["k", "y"], one_r, local_ctx)
    ro, po = _both(["k", "x"], one_l, local_ctx)
    for (a, b, ra, rb), how, n in (((pl, pr, rl, rr), "inner", 0),
                                   ((pl, pr, rl, rr), "right", 1),
                                   ((po, pl, ro, rl), "left", 1)):
        got = a.join(b, on="k", how=how, algorithm="hash")
        assert got.row_count == n
        assert_tables_equal(got, ra.join(rb, on="k", how=how,
                                         algorithm="hash"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("how", HOWS)
def test_hash_vs_sort_agree_random(local_ctx, mode, how):
    """Mid-size random keys with nulls: the port's hash join equals the
    reference's, and also the port's sort join slot for slot (both emit
    left rows in order, each key's right rows in row order)."""
    rng = np.random.default_rng(17)
    n = 400
    k = rng.integers(0, 40, n).astype(float)
    k[rng.random(n) < 0.05] = np.nan
    k2 = rng.integers(0, 40, n // 2).astype(float)
    rl, pl = _both(["k", "x"], [k, rng.random(n)], local_ctx)
    rr, pr = _both(["k", "y"], [k2, rng.random(n // 2)], local_ctx)
    with modes(mode):
        got = pl.join(pr, on="k", how=how, algorithm="hash")
        assert_tables_equal(got, rl.join(rr, on="k", how=how,
                                         algorithm="hash"))
        _assert_same(got, pl.join(pr, on="k", how=how))


def test_signed_zero_keys_join_as_the_sort_join_does(local_ctx):
    """0.0 == -0.0, so an inner join of these keys has 7 rows, as the
    reference's SORT join gives.  The port is not held to the reference's
    hash join here: it hashes raw float bits, so 0.0 and -0.0 land in
    different slots and it finds 5 rows; the port folds float keys before
    hashing (``hashing.hash_columns``)."""
    l = [np.array([0.0, -0.0, np.nan, 1.0, 2.0]), np.arange(5.0)]
    r = [np.array([-0.0, np.nan, 1.0, 1.0, 0.0]), np.arange(5.0) + 10]
    rl, pl = _both(["k", "x"], l, local_ctx)
    rr, pr = _both(["k", "y"], r, local_ctx)
    want = rl.join(rr, on="k", how="inner", algorithm="sort")
    assert want.row_count == 7
    assert rl.join(rr, on="k", how="inner",
                   algorithm="hash").row_count == 5  # the reference's fault
    for mode in MODES:
        with modes(mode):
            assert_tables_equal(pl.join(pr, on="k", how="inner",
                                        algorithm="hash"), want)


@pytest.mark.parametrize("p0", [(1 << 16) - 3, (1 << 17) - 2,
                                (1 << 31) - 5])
def test_step_offset_matches_reference_uint32(p0):
    p = np.arange(p0, p0 + 8, dtype=np.int64)
    want = np.asarray(rhj._step_offset(jnp.asarray(p.astype(np.uint32))))
    want = want.astype(np.int64)
    got = hash_join._step_offset(torch.from_numpy(p)).numpy()
    mask = (1 << 31) - 1  # the slot bits of a table of up to 2^31 slots
    np.testing.assert_array_equal(got & mask, want & mask)
    exact = p * (p + 1) < (1 << 32)  # no uint32 wrap: every bit agrees
    np.testing.assert_array_equal(got[exact], want[exact])
    assert exact.any() == (p0 < 1 << 16)


def _range_inputs(rng, case):
    cap_l, cnt_l, cap_r, cnt_r = 300, 260, 250, 230

    def side(cap, cnt):
        k = rng.integers(0, 40, cnt).astype(np.int32)
        k2 = rng.integers(0, 3, cnt).astype(np.int64)
        s = rng.choice(["x", "yy", "zzz"], cnt).astype(object)
        v = rng.random(cnt).astype(np.float32)
        valid = [rng.random(cnt) > 0.1, np.ones(cnt, bool),
                 np.ones(cnt, bool), np.ones(cnt, bool)]
        return columns([k, k2, s, v], valid, capacity=cap), cnt

    (rl, pl), cl = side(cap_l, cnt_l)
    (rr, pr), cr = side(cap_r, cnt_r)
    on = {"int": (0,), "multi": (0, 1), "string": (2, 1)}[case]
    return rl, pl, cl, rr, pr, cr, on


@pytest.mark.parametrize("case", ["int", "multi", "string"])
@pytest.mark.parametrize("jt", ["INNER", "LEFT", "RIGHT", "FULL_OUTER"])
def test_match_ranges_hash_element_for_element(case, jt):
    rl, pl, cl, rr, pr, cr, on = _range_inputs(np.random.default_rng(23),
                                               case)
    want = rhj.match_ranges_hash(rl, jnp.int32(cl), rr, jnp.int32(cr), on,
                                 on, RJoinType[jt])
    got = hash_join.match_ranges_hash(pl, torch.tensor(cl), pr,
                                      torch.tensor(cr), on, on, JoinType[jt])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key_grouped", [False, True])
def test_join_gather_hash_matches_reference(mode, key_grouped):
    rl, pl, cl, rr, pr, cr, on = _range_inputs(np.random.default_rng(29),
                                               "int")
    with modes(mode):
        m = int(rjoin.join_row_count(rl, jnp.int32(cl), rr, jnp.int32(cr),
                                     on, on, RJoinType.INNER, "hash"))
        assert int(join.join_row_count(pl, torch.tensor(cl), pr,
                                       torch.tensor(cr), on, on,
                                       JoinType.INNER, "hash")) == m
        want, wm = rjoin.join_gather(rl, jnp.int32(cl), rr, jnp.int32(cr),
                                     on, on, RJoinType.INNER, m + 7, "hash",
                                     key_grouped=key_grouped)
        got, gm = join.join_gather(pl, torch.tensor(cl), pr,
                                   torch.tensor(cr), on, on, JoinType.INNER,
                                   m + 7, "hash", key_grouped=key_grouped)
    assert int(gm) == int(wm) == m
    assert_columns_equal(got, want)  # row for row


@pytest.mark.parametrize("mode", MODES)
def test_key_grouped_hash_join_pipeline_groupby(mode):
    """``test_key_grouped_join.py``'s pipeline shape with algo="hash":
    the key-grouped hash join feeding the boundary-scan group-by, against
    the reference's, group for group."""
    rng = np.random.default_rng(31)
    n = 1200
    lk = rng.integers(0, 150, n).astype(np.int32)
    rk = rng.integers(0, 150, n // 2).astype(np.int32)
    (rlk, rlv, rrk, rrv), (plk, plv, prk, prv) = columns(
        [lk, rng.random(n), rk, rng.random(n // 2)])
    cap = 1 << 15
    aggs = ((1, groupby.AggOp.SUM), (3, groupby.AggOp.MEAN))
    r_aggs = tuple((c, rgb.AggOp(int(op))) for c, op in aggs)
    with modes(mode):
        rc, rm = rjoin.join_gather((rlk, rlv), jnp.int32(n), (rrk, rrv),
                                   jnp.int32(n // 2), (0,), (0,),
                                   RJoinType.INNER, cap, "hash",
                                   key_grouped=True)
        want, wg = rgb.pipeline_groupby(rc, rm, (0,), r_aggs, 0)
        pc, pm = join.join_gather((plk, plv), torch.tensor(n), (prk, prv),
                                  torch.tensor(n // 2), (0,), (0,),
                                  JoinType.INNER, cap, "hash",
                                  key_grouped=True)
        got, gg = groupby.pipeline_groupby(pc, pm, (0,), aggs, 0)
    assert int(pm) == int(rm) and int(gg) == int(wg) > 0
    assert_columns_equal(pc, rc)
    # float32 sums in narrow mode, float64 in wide
    assert_columns_equal(got, want,
                         float_rtol=1e-5 if mode == "narrow" else 1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_hash_matches_bench_pipeline(mode):
    """``pipeline.join_groupby(..., algo="hash")`` against
    ``bench.make_bench_pipeline(out_cap, "hash")`` at 2^12 rows per side:
    join and group counts, keys and validity exact, float32 SUM and MEAN
    rtol 1e-5."""
    rows = 1 << 12
    lk, lv, rk, rv = pipeline.make_data(rows)
    (rkc, rlv, rrk, rrv), _ = columns([lk, lv, rk, rv])
    rcl, rcr = (rkc, rlv), (rrk, rrv)
    cnt = jnp.int32(rows)
    tables = pipeline.tables(lk, lv, rk, rv, device="cpu")
    with modes(mode):
        m = int(rjoin.join_row_count(rcl, cnt, rcr, cnt, (0,), (0,),
                                     RJoinType.INNER, "hash"))
        assert pipeline.join_count(*tables, algo="hash") == m
        assert pipeline.join_count(*tables) == m
        out_cap = _cap_round(m)
        r_sum, r_mean, r_g, r_jm = bench.make_bench_pipeline(
            out_cap, "hash")(rcl, cnt, rcr, cnt)
        joined, jm = rjoin.join_gather(rcl, cnt, rcr, cnt, (0,), (0,),
                                       RJoinType.INNER, out_cap, "hash",
                                       key_grouped=True, project=(0, 1, 3))
        r_cols, _ = rgb.pipeline_groupby(
            joined, jm, (0,), ((1, rgb.AggOp.SUM), (2, rgb.AggOp.MEAN)), 0)
        scan.reset_launches()
        hash_join.reset_rounds()
        p_cols, p_g, p_jm = pipeline.join_groupby(*tables, out_cap,
                                                  algo="hash")
        assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU
        assert hash_join.ROUNDS["build"] > 0 and hash_join.ROUNDS["probe"] > 0
    assert int(p_jm) == int(r_jm) == m
    assert int(p_g) == int(r_g) > 0
    assert_columns_equal(p_cols[:1], r_cols[:1])  # keys, validity: exact
    for p, r in zip(p_cols, r_cols):
        np.testing.assert_array_equal(np_of(p.validity),
                                      np.asarray(r.validity))
    np.testing.assert_allclose(np_of(p_cols[1].data), np.asarray(r_sum),
                               rtol=1e-5)  # float32 SUM
    np.testing.assert_allclose(np_of(p_cols[2].data), np.asarray(r_mean),
                               rtol=1e-5)  # float32 MEAN
