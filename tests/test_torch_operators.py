"""The port's relational operators on one shard (``Table.sort``,
``unique``, ``union`` / ``intersect`` / ``subtract``, ``select``,
``filter``, ``merge``, ``join``, the scalar aggregates, the ``compute``
surface and the pipeline group-by) against the JAX package's, on the same
numpy inputs through ``tests/torch_parity.py``.

Both precisions: wide against the reference's default, narrow against
``torch_parity.modes("narrow")`` (the reference's scans on its Pallas
kernels in interpret mode).  Tolerance: exact over the whole capacity
(data, validity, count, dtype) wherever the reference is exact, which is
every case here but float sums; float32 sums are within rtol 1e-5 (each
package adds in its own order, the bound ``test_torch_join_groupby.py``
states) and float64 sums within rtol 1e-12.
"""
import numpy as np
import pytest

from cylon_tpu.ops.aggregates import ReduceOp as RReduceOp
from cylon_tpu_torch import compute, pipeline
from cylon_tpu_torch.ops import aggregates, scan
from cylon_tpu_torch.status import CylonError

from .torch_parity import (assert_tables_equal, local_tables, modes,
                           port_table_of)

MODES = ["wide", "narrow"]
N = 60


def _frame(n=N, seed=3):
    """int32 keys with repeats and nulls, float32 with NaN, -0.0, +0.0
    and nulls (NaN stays a value: validity is explicit), int64 with nulls,
    and a bool column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n).astype(np.int32)
    f = rng.integers(-3, 4, n).astype(np.float32) / 2
    f[::7] = np.nan
    f[1::9] = -0.0
    f[2::9] = 0.0
    w = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    b = rng.random(n) > 0.5
    valid = [rng.random(n) > 0.15, rng.random(n) > 0.15,
             rng.random(n) > 0.1, np.ones(n, bool)]
    return ["k", "f", "w", "b"], [k, f, w, b], valid


def _tables(cols=None, n=N, seed=3, capacity=None):
    names, values, valid = _frame(n, seed)
    idx = range(len(names)) if cols is None else [names.index(c)
                                                  for c in cols]
    return local_tables([names[i] for i in idx], [values[i] for i in idx],
                        [valid[i] for i in idx], capacity)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", [
    ("k", True, True), ("k", False, True), ("f", True, True),
    ("f", False, True), ("f", False, False), ("f", True, False),
    (["k", "f"], [True, False], True), (["f", "w"], [False, True], False),
    (["b", "k", "w"], True, False)],
    ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_sort_matches_reference(mode, case):
    """One and several columns, ascending and descending, both null
    placements, NaN and -0.0 in a float key: exact."""
    by, asc, nulls_first = case
    rt, pt = _tables(capacity=N + 5)
    with modes(mode):
        want = rt.sort(by, ascending=asc, nulls_first=nulls_first)
        got = pt.sort(by, ascending=asc, nulls_first=nulls_first)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("keep", ["first", "last"])
@pytest.mark.parametrize("cols", [["k"], ["k", "f"], None],
                         ids=["k", "k,f", "all"])
def test_unique_matches_reference(mode, keep, cols):
    rt, pt = _tables(capacity=N + 3)
    with modes(mode):
        assert_tables_equal(pt.unique(cols, keep=keep),
                            rt.unique(cols, keep=keep))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
@pytest.mark.parametrize("cols", [["k"], ["f"], ["k", "f"]],
                         ids=["int", "float", "int,float"])
def test_set_ops_match_reference(mode, op, cols):
    """Columns with nulls (and NaN, -0.0 in the float column), tables of
    different capacities; compared over the whole output capacity."""
    ra, pa = _tables(cols, n=N, seed=3, capacity=N + 4)
    rb, pb = _tables(cols, n=40, seed=4)
    with modes(mode):
        scan.reset_launches()
        got = getattr(pa, op)(pb)
        want = getattr(ra, op)(rb)
    assert got.shard_capacity == 128  # pow2ceil(64 + 40)
    assert_tables_equal(got, want)
    assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU


def test_set_op_rejects_schema_mismatch():
    _, pa = _tables(["k", "f"])
    _, pb = _tables(["f", "k"])
    with pytest.raises(CylonError, match=r"\[Invalid\] schema mismatch"):
        pa.union(pb)
    with pytest.raises(CylonError, match=r"\[Invalid\] column count"):
        pa.intersect(pb.project("k"))


@pytest.mark.parametrize("mode", MODES)
def test_select_filter_merge_match_reference(mode):
    rt, pt = _tables(capacity=N + 2)
    rb, pb = _tables(n=25, seed=9)
    with modes(mode):
        assert_tables_equal(pt.select(lambda e: e["k"] > 5),
                            rt.select(lambda e: e["k"] > 5))
        assert_tables_equal(
            pt.select(lambda e: (e.f < 1.0) & e.validity("w")),
            rt.select(lambda e: (e.f < 1.0) & e.validity("w")))
        assert_tables_equal(pt.filter(pt["k"] >= 4), rt.filter(rt["k"] >= 4))
        assert_tables_equal(pt[pt["f"] < 0.5], rt[rt["f"] < 0.5])
        assert_tables_equal(pt.merge(pb), rt.merge(rb))
        assert_tables_equal(pt[2:40:3], rt[2:40:3])


def test_column_surface_matches_reference():
    rt, pt = _tables()
    assert_tables_equal(pt["f"], rt["f"])
    assert_tables_equal(pt[["w", "k"]], rt[["w", "k"]])
    assert_tables_equal(pt.drop(["f", "b"]), rt.drop(["f", "b"]))
    assert_tables_equal(pt.rename({"k": "key"}), rt.rename({"k": "key"}))
    assert_tables_equal(pt.add_prefix("a_"), rt.add_prefix("a_"))
    assert_tables_equal(pt.add_suffix("_z"), rt.add_suffix("_z"))
    with pytest.raises(CylonError, match="rename length"):
        pt.rename(["x"])
    with pytest.raises(CylonError, match="KeyError"):
        pt["nope"]


def _compute_cases(cm, t, u, bools):
    """(label, fn) pairs of compute operations, run on each package's
    tables with its ``compute`` module ``cm``: ``t`` numeric (k, f, w),
    ``u`` the same schema at another seed, ``bools`` two bool columns."""
    return [
        ("eq", lambda: t == 3), ("ne", lambda: t != 3),
        ("lt_float", lambda: t < 2.5), ("ge", lambda: t >= 1),
        ("gt_table", lambda: t > u), ("le_table", lambda: t <= u),
        ("add", lambda: t + 2), ("add_float", lambda: t + 2.5),
        ("sub", lambda: t - 1), ("mul", lambda: t * 3),
        ("div", lambda: t / 2), ("div_table", lambda: t / u),
        ("add_table", lambda: t + u), ("neg", lambda: -t),
        ("isnull", lambda: t.isnull()), ("notnull", lambda: t.notnull()),
        ("isna", lambda: t.isna()), ("fillna", lambda: t.fillna(7)),
        ("where", lambda: t.where(t > 2)),
        ("where_other", lambda: t.where(t > 2, 5)),
        ("isin", lambda: t.isin([1, 3, 5])),
        ("isin_float", lambda: t.isin([1.5, 2.0])),
        ("isin_null", lambda: t.isin([2, None], skip_null=False)),
        ("dropna_any", lambda: t.dropna()),
        ("dropna_all", lambda: t.dropna(how="all")),
        ("dropna_cols", lambda: t.dropna(axis=1)),
        ("and", lambda: bools & (bools == False)),  # noqa: E712
        ("or", lambda: bools | True), ("invert", lambda: ~bools),
        ("xor", lambda: cm.logical_op(bools, True, "xor")),
        ("nunique", lambda: cm.nunique(t.project("k"))),
    ]


def test_compute_matches_reference():
    """Comparison, arithmetic (with the reference's scalar promotion:
    an int column plus 2.5 is float64), logical ops, null handling and
    membership, with nulls: exact."""
    names, values, valid = _frame()
    idx = [0, 1, 2]
    rt, pt = local_tables([names[i] for i in idx], [values[i] for i in idx],
                          [valid[i] for i in idx])
    names2, values2, valid2 = _frame(seed=5)
    ru, pu = local_tables([names2[i] for i in idx],
                          [values2[i] for i in idx],
                          [valid2[i] for i in idx])
    rng = np.random.default_rng(2)
    bvals = [rng.random(N) > 0.5, rng.random(N) > 0.3]
    bvalid = [rng.random(N) > 0.2, np.ones(N, bool)]
    rb, pb = local_tables(["x", "y"], bvals, bvalid)
    from cylon_tpu import compute as rcompute

    want = dict(_compute_cases(rcompute, rt, ru, rb))
    for label, fn in _compute_cases(compute, pt, pu, pb):
        got, exp = fn(), want[label]()
        try:
            if label == "nunique":
                assert got == exp
            else:
                assert_tables_equal(got, exp)
        except AssertionError as e:
            raise AssertionError(f"compute case {label}") from e
    with pytest.raises(CylonError, match="division by zero"):
        pt / 0
    with pytest.raises(CylonError, match="non-bool"):
        ~pt


SCALAR_DTYPES = [np.int32, np.int64, np.float32, np.float64, np.bool_]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", SCALAR_DTYPES,
                         ids=lambda d: np.dtype(d).name)
def test_scalar_aggregates_match_reference(mode, dtype):
    """Every ReduceOp, with nulls, and on an empty table (SUM 0, PROD 1,
    MIN/MAX the dtype's extremes, COUNT 0): value and dtype; float32
    SUM/PROD rtol 1e-5, float64 rtol 1e-12, the rest exact."""
    from cylon_tpu.ops import aggregates as ragg

    rng = np.random.default_rng(8)
    for n in (37, 0):
        v = (rng.random(n) * 3).astype(dtype) if dtype != np.bool_ \
            else rng.random(n) > 0.4
        if np.dtype(dtype).kind in "iu":
            v = rng.integers(-50, 50, n).astype(dtype)
        rt, pt = local_tables(["x"], [v], [rng.random(n) > 0.2])
        with modes(mode):
            for op in aggregates.ReduceOp:
                got, gn = aggregates.scalar_agg(pt.shards[0][0],
                                                pt.counts[0], op)
                want, wn = ragg.scalar_agg(rt.columns[0], rt.row_counts[0],
                                           RReduceOp(int(op)))
                want, wn = np.asarray(want), np.asarray(wn)
                got, gn = got.numpy(), gn.numpy()
                assert got.dtype == want.dtype and gn.dtype == wn.dtype
                assert gn == wn  # count, exact
                if want.dtype.kind == "f" and op in (
                        aggregates.ReduceOp.SUM, aggregates.ReduceOp.PROD):
                    rtol = 1e-5 if want.dtype == np.float32 else 1e-12
                    np.testing.assert_allclose(got, want, rtol=rtol)
                else:
                    np.testing.assert_array_equal(got, want)
            for name in ("sum", "count", "min", "max"):
                g, w = getattr(pt, name)("x"), getattr(rt, name)("x")
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_groupby_on_one_shard_matches_reference(mode):
    """``Table.groupby(groupby_type="pipeline")`` on key-sorted rows:
    keys and counts exact, SUM/MEAN rtol 1e-5 (float32 prefix sums)."""
    rt, pt = _tables(capacity=N + 4)
    agg = {"f": ["sum", "count", "mean", "min"], "w": "max"}
    with modes(mode):
        rs, ps = rt.sort("k"), pt.sort("k")
        scan.reset_launches()
        got = ps.groupby("k", agg, groupby_type="pipeline")
        want = rs.groupby("k", agg, groupby_type="pipeline")
    assert_tables_equal(got, want, float_rtol=1e-5)
    assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_local_join_matches_reference(how):
    rt, pt = _tables(["k", "f"])
    ru, pu = _tables(["k", "w"], n=30, seed=6)
    assert_tables_equal(pt.join(pu, on="k", how=how),
                        rt.join(ru, on="k", how=how))


def test_operators_pipeline_matches_numpy():
    """``pipeline.operators`` on ``make_data`` tables against numpy."""
    n = 700
    lk, lv, rk, rv = pipeline.make_data(n)
    left, right = pipeline.local_tables(*pipeline.tables(lk, lv, rk, rv,
                                                         device="cpu"))
    out = pipeline.operators(left, right)
    order = np.argsort(lk, kind="stable")
    np.testing.assert_array_equal(out["sort"].to_numpy()["k"], lk[order])
    np.testing.assert_array_equal(out["sort"].to_numpy()["lv"], lv[order])
    o2 = np.lexsort((lv, -lk.astype(np.int64)))
    np.testing.assert_array_equal(out["sort_k_desc_lv"].to_numpy()["lv"],
                                  lv[o2])
    _, first = np.unique(lk, return_index=True)
    np.testing.assert_array_equal(out["unique_first"].to_numpy()["k"],
                                  lk[np.sort(first)])
    for op, fn in (("union", np.union1d), ("intersect", np.intersect1d),
                   ("subtract", np.setdiff1d)):
        np.testing.assert_array_equal(out[op].to_numpy()["k"], fn(lk, rk))
    packed = lambda k, v: ((k.astype(np.uint64) << np.uint64(32))  # noqa
                           | v.view(np.uint32).astype(np.uint64))
    rows = out["union_rows"].to_numpy()
    np.testing.assert_array_equal(packed(rows["k"], rows["lv"]),
                                  np.union1d(packed(lk, lv), packed(rk, rv)))
    np.testing.assert_array_equal(out["select"].to_numpy()["lv"],
                                  lv[lv > 0.5])
    np.testing.assert_array_equal(out["filter"].to_numpy()["k"],
                                  lk[lv > 0.5])
    np.testing.assert_allclose(float(out["sum"]), lv.astype(np.float64)
                               .sum(), rtol=1e-12)
    assert (int(out["min"]), int(out["max"]), int(out["count"])) == \
        (lk.min(), lk.max(), n)
    g = out["groupby_pipeline"].to_numpy()
    np.testing.assert_array_equal(g["k"], np.unique(lk))
    np.testing.assert_allclose(g["sum_lv"], np.bincount(
        lk, weights=lv.astype(np.float64))[np.unique(lk)], rtol=1e-5)


def _string_table():
    """(reference, port) one-shard Tables with a string column ``s`` (nulls,
    repeats) and an int32 column ``k``."""
    s = np.array(["b", "a", None, "ab", "b", "", "zz", "a"], object)
    return local_tables(["s", "k"], [s, np.arange(8, dtype=np.int32)])


@pytest.mark.parametrize("op", [
    lambda t: t.sort("s"), lambda t: t.unique("s"), lambda t: t.union(t),
    lambda t: t.intersect(t), lambda t: t.subtract(t),
    lambda t: t.merge(t), lambda t: t.select(lambda e: e["k"] > 1),
    lambda t: t.sum("s"), lambda t: t.min("s"), lambda t: t == 1,
    lambda t: t + 1, lambda t: t.distributed_sort("s")],
    ids=["sort", "unique", "union", "intersect", "subtract", "merge",
         "select", "sum", "min", "compare", "add", "distributed_sort"])
def test_string_columns_raise_not_implemented(op):
    """String columns are ported: each operator gives the reference's table,
    or raises the reference's error (TypeError for a numeric aggregate of
    a string, Invalid for arithmetic or a compare with a number); none
    raises NotImplemented.  (A one-shard ``distributed_sort`` is the local
    sort.)"""
    rt, pt = _string_table()
    try:
        want = op(rt)
    except Exception as e:  # noqa: BLE001 - the reference's own error
        with pytest.raises(type(e) if isinstance(e, TypeError)
                           else CylonError, match=str(e).split("] ")[-1]):
            op(pt)
        assert not isinstance(e, NotImplementedError)
        return
    assert_tables_equal(op(pt), want)


def test_bad_arguments_raise():
    _, pt = _tables()
    with pytest.raises(ValueError, match="keep"):
        pt.unique("k", keep="middle")
    with pytest.raises(CylonError, match="bad groupby_type"):
        pt.groupby("k", {"f": "sum"}, groupby_type="nope")
    with pytest.raises(CylonError, match="filter mask must be boolean"):
        pt.filter(pt["k"])
    with pytest.raises(CylonError, match="where\\(\\) condition"):
        pt.where(3)


def test_reference_tables_round_trip():
    """The harness itself: a port table built from a reference table's
    buffers equals it."""
    rt, _ = _tables()
    assert_tables_equal(port_table_of(rt), rt)
