"""The slice as a whole: cylon_tpu_torch's join, group-bys and main-path
pipeline against cylon_tpu's on the same numpy inputs, in both precisions
(narrow: the reference's scans on its Pallas kernels; wide: its default).

Tolerances: exact for keys, counts, gathers, integer results and min/max;
float32 sums and means rtol=1e-5, the reference's own bound
(tests/test_pallas_scan.py); variances in float32 rtol=1e-4, since
s2 - s*s/n cancels about one more digit; float64 results rtol=1e-12."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from cylon_tpu.config import JoinType as RJoinType
from cylon_tpu.ops import groupby as rgb
from cylon_tpu.ops import join as rjoin
from cylon_tpu.table import _cap_round
from cylon_tpu_torch import pipeline
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import groupby, join, scan

from .torch_parity import assert_columns_equal, columns, modes, np_of

JOIN_TYPES = ["INNER", "LEFT", "RIGHT", "FULL_OUTER"]


def _join_tables(rng, multi_key=False):
    cap_l, cnt_l, cap_r, cnt_r = 300, 260, 250, 230

    def side(cap, cnt):
        k = rng.integers(0, 40, cnt).astype(np.int32)
        k2 = rng.integers(0, 3, cnt).astype(np.int64)
        v = rng.random(cnt).astype(np.float32)
        w = rng.integers(-100, 100, cnt).astype(np.int64)
        valid = [rng.random(cnt) > 0.1 for _ in range(4)]
        ref, port = columns([k, k2, v, w], valid, capacity=cap)
        return ref, port, cnt

    rl, pl, cl = side(cap_l, cnt_l)
    rr, pr, cr = side(cap_r, cnt_r)
    on = (0, 1) if multi_key else (0,)
    return rl, pl, cl, rr, pr, cr, on


def _run_join(rl, pl, cl, rr, pr, cr, on, jt, key_grouped=False,
              project=None):
    rjt = RJoinType[jt]
    pjt = JoinType[jt]
    m = int(rjoin.join_row_count(rl, jnp.int32(cl), rr, jnp.int32(cr), on,
                                 on, rjt))
    pm = join.join_row_count(pl, torch.tensor(cl), pr, torch.tensor(cr), on,
                             on, pjt)
    assert int(pm) == m
    out_cap = m + 7  # spare slots: padding rows must match too
    r_cols, r_cnt = rjoin.join_gather(rl, jnp.int32(cl), rr, jnp.int32(cr),
                                      on, on, rjt, out_cap, "sort",
                                      key_grouped=key_grouped,
                                      project=project)
    p_cols, p_cnt = join.join_gather(pl, torch.tensor(cl), pr,
                                     torch.tensor(cr), on, on, pjt, out_cap,
                                     "sort", key_grouped=key_grouped,
                                     project=project)
    assert int(p_cnt) == int(r_cnt) == m
    assert_columns_equal(p_cols, r_cols)  # gathers: exact


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_gather_matches_reference(jt, mode):
    rng = np.random.default_rng(53)
    with modes(mode):
        _run_join(*_join_tables(rng), jt)


@pytest.mark.parametrize("jt", ["INNER", "FULL_OUTER"])
def test_multi_key_join_matches_reference(jt):
    """Two key columns (int32, int64): the multi-word lexsort path."""
    rng = np.random.default_rng(59)
    with modes("narrow"):
        _run_join(*_join_tables(rng, multi_key=True), jt)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_key_grouped_projected_join_matches_reference(mode):
    rng = np.random.default_rng(61)
    with modes(mode):
        _run_join(*_join_tables(rng), "INNER", key_grouped=True,
                  project=(0, 2, 6, 3))


def test_join_rejects_unported_and_invalid_options():
    """``algorithm="hash"``, refused until the hash join was ported, now
    counts what the sort join counts; the invalid options still raise."""
    rng = np.random.default_rng(67)
    _, pl, cl, _, pr, cr, on = _join_tables(rng)
    for jt in JOIN_TYPES:
        assert int(join.join_row_count(pl, cl, pr, cr, on, on, JoinType[jt],
                                       "hash")) == \
            int(join.join_row_count(pl, cl, pr, cr, on, on, JoinType[jt]))
    with pytest.raises(Exception, match="bad join algorithm"):
        join.join_row_count(pl, cl, pr, cr, on, on, JoinType.INNER, "merge")
    with pytest.raises(ValueError, match="requires INNER"):
        join.join_gather(pl, cl, pr, cr, on, on, JoinType.LEFT, 64,
                         key_grouped=True)
    with pytest.raises(ValueError, match="out of range"):
        join.join_gather(pl, cl, pr, cr, on, on, JoinType.INNER, 64,
                         project=(9,))


_AGGS_BY_COL = {
    1: (groupby.AggOp.SUM, groupby.AggOp.MIN, groupby.AggOp.MAX,
        groupby.AggOp.COUNT, groupby.AggOp.MEAN, groupby.AggOp.VAR,
        groupby.AggOp.STDDEV, groupby.AggOp.NUNIQUE, groupby.AggOp.SUMSQ),
    2: (groupby.AggOp.SUM, groupby.AggOp.MIN, groupby.AggOp.MAX,
        groupby.AggOp.MEAN, groupby.AggOp.VAR),
    3: (groupby.AggOp.SUM, groupby.AggOp.MIN, groupby.AggOp.MAX,
        groupby.AggOp.NUNIQUE, groupby.AggOp.COUNTSUM),
    4: (groupby.AggOp.SUM, groupby.AggOp.MIN, groupby.AggOp.MAX,
        groupby.AggOp.COUNT),
}
AGGS = tuple((c, op) for c, ops in _AGGS_BY_COL.items() for op in ops)


def _groupby_data(rng, sort_keys: bool):
    cap, cnt = 600, 550
    k = rng.integers(0, 30, cnt).astype(np.int32)
    kv = rng.random(cnt) > 0.05
    f32 = (rng.integers(0, 8, cnt) / 8 + rng.random(cnt)).astype(np.float32)
    f64 = rng.random(cnt)
    i32 = rng.integers(-20, 20, cnt).astype(np.int32)
    i64 = rng.integers(-(1 << 40), 1 << 40, cnt).astype(np.int64)
    vals = [k, f32, f64, i32, i64]
    valid = [kv] + [rng.random(cnt) > 0.15 for _ in range(4)]
    if sort_keys:  # key-grouped input, nulls first
        order = np.lexsort((np.where(kv, k, 0), kv))
        vals = [v[order] for v in vals]
        valid = [m[order] for m in valid]
    rc, pc = columns(vals, valid, capacity=cap)
    return rc, pc, cnt


def _assert_groupby(p_cols, r_cols):
    assert_columns_equal(p_cols[:1], r_cols[:1])  # keys: exact
    for (col, op), p, r in zip(AGGS, p_cols[1:], r_cols[1:]):
        np.testing.assert_array_equal(np_of(p.validity),
                                      np.asarray(r.validity))
        pd_, rd = np_of(p.data), np.asarray(r.data)
        assert pd_.dtype == rd.dtype, (col, op, pd_.dtype, rd.dtype)
        if rd.dtype.kind != "f" or op in (groupby.AggOp.MIN,
                                          groupby.AggOp.MAX):
            np.testing.assert_array_equal(pd_, rd)  # exact
        elif rd.dtype == np.float64:
            np.testing.assert_allclose(pd_, rd, rtol=1e-12)  # float64
        elif op in (groupby.AggOp.VAR, groupby.AggOp.STDDEV):
            np.testing.assert_allclose(pd_, rd, rtol=1e-4)  # f32 variance
        else:
            np.testing.assert_allclose(pd_, rd, rtol=1e-5)  # f32 sum/mean


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("fn", ["hash_groupby", "pipeline_groupby"])
def test_groupby_every_agg_matches_reference(fn, mode):
    rng = np.random.default_rng(71)
    rc, pc, cnt = _groupby_data(rng, sort_keys=fn == "pipeline_groupby")
    r_aggs = tuple((c, rgb.AggOp(int(op))) for c, op in AGGS)
    with modes(mode):
        r_cols, r_g = getattr(rgb, fn)(rc, jnp.int32(cnt), (0,), r_aggs, 0)
        p_cols, p_g = getattr(groupby, fn)(pc, torch.tensor(cnt), (0,), AGGS,
                                           0)
        assert int(p_g) == int(r_g)
        _assert_groupby(p_cols, r_cols)


def test_two_phase_decomposition_matches_reference():
    from cylon_tpu import dtypes as rdt
    from cylon_tpu_torch import dtypes as pdt

    for name in ("sum", "min", "max", "count", "mean", "avg", "var", "std",
                 "stddev", "nunique"):
        assert int(groupby.AggOp.of(name)) == int(rgb.AggOp.of(name))
    for op in groupby.AggOp:
        r_op = rgb.AggOp(int(op))
        if op == groupby.AggOp.NUNIQUE:  # no two-phase form on either side
            with pytest.raises(KeyError):
                rgb.partial_ops(r_op)
            with pytest.raises(KeyError):
                groupby.partial_ops(op)
        else:
            assert [int(o) for o in groupby.partial_ops(op)] == \
                [int(o) for o in rgb.partial_ops(r_op)]
        assert int(groupby.combine_op(op)) == int(rgb.combine_op(r_op))
        for dt in ("float_", "double", "int32", "int64"):
            for mode in ("narrow", "wide"):
                with modes(mode):
                    r = rgb._agg_out_dtype(r_op, getattr(rdt, dt))
                p = groupby._agg_out_dtype(op, getattr(pdt, dt),
                                           mode == "narrow")
                assert int(p.type) == int(r.type)


@pytest.mark.parametrize("mode", ["narrow", "wide"])
def test_slice_gate_matches_bench_pipeline(mode):
    """The port's main path against bench.make_bench_pipeline on
    bench._make_data at 2^12 rows per side: keys, group count and join
    count bit-identical, SUM and MEAN within rtol=1e-5 (float32), validity
    over the whole capacity."""
    rows = 1 << 12
    data = pipeline.make_data(rows)
    for a, b in zip(data, bench._make_data(rows)):
        np.testing.assert_array_equal(a, b)
    lk, lv, rk, rv = data
    (rkc, rlv, rrk, rrv), _ = columns([lk, lv, rk, rv])
    rcl, rcr = (rkc, rlv), (rrk, rrv)
    cnt = jnp.int32(rows)
    tables = pipeline.tables(lk, lv, rk, rv, device="cpu")
    with modes(mode):
        m = int(rjoin.join_row_count(rcl, cnt, rcr, cnt, (0,), (0,),
                                     RJoinType.INNER))
        assert pipeline.join_count(*tables) == m
        out_cap = _cap_round(m)
        assert pipeline.cap_round(m) == out_cap
        r_sum, r_mean, r_g, r_jm = bench.make_bench_pipeline(out_cap)(
            rcl, cnt, rcr, cnt)
        joined, jm = rjoin.join_gather(rcl, cnt, rcr, cnt, (0,), (0,),
                                       RJoinType.INNER, out_cap,
                                       key_grouped=True, project=(0, 1, 3))
        r_cols, _ = rgb.pipeline_groupby(
            joined, jm, (0,), ((1, rgb.AggOp.SUM), (2, rgb.AggOp.MEAN)), 0)
        scan.reset_launches()
        p_cols, p_g, p_jm = pipeline.join_groupby(*tables, out_cap)
        assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU
    assert int(p_jm) == int(r_jm) == m
    assert int(p_g) == int(r_g)
    g = int(r_g)
    assert g > 0
    assert_columns_equal(p_cols[:1], r_cols[:1])  # keys, validity: exact
    for p, r in zip(p_cols, r_cols):
        np.testing.assert_array_equal(np_of(p.validity),
                                      np.asarray(r.validity))
    np.testing.assert_allclose(np_of(p_cols[1].data), np.asarray(r_sum),
                               rtol=1e-5)  # float32 SUM
    np.testing.assert_allclose(np_of(p_cols[2].data), np.asarray(r_mean),
                               rtol=1e-5)  # float32 MEAN
