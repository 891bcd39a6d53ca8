"""The port's distributed operators on a 4-shard CPU mesh against the JAX
package on its 4-device CPU mesh, on the same numpy inputs.

- ``distributed_sort`` compares shard by shard, slot for slot, with the
  unpatched reference: range placement involves no hash, and the port
  bins with the same operations in the same precision, so the targets
  agree bit for bit (wide: float64 bins, narrow: float32).
- ``distributed_unique`` and the distributed set ops compare shard by
  shard with the reference forced onto its murmur3 placement
  (``torch_parity.murmur3_reference``, a fresh context), and gathered and
  sorted against the unpatched reference (``ctx4``), whose CPU hash
  places rows elsewhere.
- The scalar aggregates: every ReduceOp; float32 sums rtol 1e-5, float64
  sums rtol 1e-12, everything else exact.
- The verify skill's probes: a schema mismatch, fewer rows than shards,
  every row one key, empty tables, a string lead column (now sorted).
"""
import numpy as np
import pytest
import torch

from cylon_tpu.config import SortOptions as RSortOptions
from cylon_tpu.ops.aggregates import ReduceOp as RReduceOp
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, pipeline
from cylon_tpu_torch.config import SortOptions
from cylon_tpu_torch.ops import aggregates, hash_kernels, scan
from cylon_tpu_torch.parallel import ops as par_ops
from cylon_tpu_torch.status import CylonError

from .torch_parity import assert_shards_equal, modes, murmur3_reference

WORLD = 4
N = 2000


def _frame(seed=7, n=N, nulls=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 300, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    w = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    if nulls:
        v[::13] = np.nan  # nulls
        v[5::31] = -0.0
    return ["k", "v", "w"], [k, v, w]


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=WORLD))


def _both(ctx_r, pctx, names, arrays):
    return (RTable.from_numpy(names, arrays, ctx=ctx_r),
            Table.from_numpy(names, arrays, ctx=pctx))


SORT_CASES = [
    ("k", None, SortOptions()),
    ("v", None, SortOptions(ascending=False)),
    ("v", None, SortOptions(nulls_first=False)),
    (["k", "w"], [False, True], SortOptions(num_bins=7, num_samples=50)),
    (["w", "v"], None, SortOptions(ascending=False, nulls_first=False,
                                   num_samples=100000)),
]


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("case", SORT_CASES,
                         ids=["k", "v-desc", "v-nulls-last", "k,w-bins",
                              "w,v-desc-samples"])
def test_distributed_sort_matches_reference_shard_by_shard(pctx, ctx4, mode,
                                                           case):
    by, asc, opts = case
    names, arrays = _frame()
    ropts = RSortOptions(opts.ascending, opts.num_bins, opts.num_samples,
                         opts.nulls_first)
    rt, pt = _both(ctx4, pctx, names, arrays)
    with modes(mode):
        want = rt.distributed_sort(by, ropts, ascending=asc)
        got = pt.distributed_sort(by, opts, ascending=asc)
    assert got.row_count == N
    assert_shards_equal(got, want)  # exact, slot for slot


def test_distributed_sort_is_globally_ordered(pctx):
    names, arrays = _frame(nulls=False)
    got = Table.from_numpy(names, arrays, ctx=pctx).distributed_sort("w")
    shards = [s[2].data[:int(n)] for s, n in zip(got.shards, got.counts)]
    for a, b in zip(shards, shards[1:]):
        if len(a) and len(b):
            assert int(a.max()) <= int(b.min())
    np.testing.assert_array_equal(torch.cat(shards).numpy(),
                                  np.sort(arrays[2]))


def test_range_targets_match_reference(pctx, ctx4):
    """The partitioner alone: every row's target equals the reference's,
    shard by shard, in both precisions, both directions and both null
    placements."""
    from cylon_tpu.parallel import ops as rpar_ops
    from cylon_tpu.table import _host_shard_pieces
    from cylon_tpu_torch.parallel import partition

    names, arrays = _frame()
    rt, pt = _both(ctx4, pctx, names, arrays)
    for mode in ("wide", "narrow"):
        for asc, nulls_first in ((True, True), (False, False)):
            opts = RSortOptions(ascending=asc, nulls_first=nulls_first)
            with modes(mode):
                want, _ = rpar_ops._targets_and_counts(rt, (1,), "range",
                                                       opts)
                got = partition.range_targets(
                    [s[1] for s in pt.shards], pt.counts, pctx.devices,
                    num_bins=16 * WORLD, num_samples=4096, ascending=asc,
                    nulls_first=nulls_first)
            want = _host_shard_pieces(want, rt.shard_capacity)
            for s in range(WORLD):
                np.testing.assert_array_equal(got[s].numpy(), want[s])


@pytest.fixture(scope="module")
def murmur3_results():
    """The reference's distributed unique and set ops under murmur3
    placement, built once."""
    names, arrays = _frame()
    _, arrays_b = _frame(seed=8, n=1500)
    with murmur3_reference(WORLD) as rctx:
        a = RTable.from_numpy(names, arrays, ctx=rctx)
        b = RTable.from_numpy(names, arrays_b, ctx=rctx)
        ka, kb = a.project(["k", "v"]), b.project(["k", "v"])
        return {"unique_first": a.distributed_unique("k"),
                "unique_last": a.distributed_unique(["k", "v"],
                                                    keep="last"),
                "union": ka.distributed_union(kb),
                "intersect": ka.distributed_intersect(kb),
                "subtract": ka.distributed_subtract(kb)}


def _port_results(pctx):
    names, arrays = _frame()
    _, arrays_b = _frame(seed=8, n=1500)
    a = Table.from_numpy(names, arrays, ctx=pctx)
    b = Table.from_numpy(names, arrays_b, ctx=pctx)
    ka, kb = a.project(["k", "v"]), b.project(["k", "v"])
    return {"unique_first": lambda: a.distributed_unique("k"),
            "unique_last": lambda: a.distributed_unique(["k", "v"],
                                                        keep="last"),
            "union": lambda: ka.distributed_union(kb),
            "intersect": lambda: ka.distributed_intersect(kb),
            "subtract": lambda: ka.distributed_subtract(kb)}


@pytest.mark.parametrize("name", ["unique_first", "unique_last", "union",
                                  "intersect", "subtract"])
def test_hash_shuffled_ops_match_murmur3_reference(pctx, murmur3_results,
                                                   name):
    hash_kernels.reset_launches()
    got = _port_results(pctx)[name]()
    assert_shards_equal(got, murmur3_results[name])  # exact, slot for slot
    assert hash_kernels.LAUNCHES == {"hash_partition": 0}  # CPU


def _gathered(t):
    """Gathered rows sorted by every column (nulls as NaN), as float64."""
    d = t.to_numpy()
    cols = [np.array([np.nan if x is None else x for x in d[n]],
                     np.float64) for n in t.names]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_distributed_set_ops_match_reference_gathered(pctx, ctx4, mode, op):
    names, arrays = _frame()
    _, arrays_b = _frame(seed=8, n=1500)
    ra, pa = _both(ctx4, pctx, names, arrays)
    rb, pb = _both(ctx4, pctx, names, arrays_b)
    with modes(mode):
        want = getattr(ra.project(["k", "v"]), f"distributed_{op}")(
            rb.project(["k", "v"]))
        got = getattr(pa.project(["k", "v"]), f"distributed_{op}")(
            pb.project(["k", "v"]))
    assert got.row_count == want.row_count
    for g, w in zip(_gathered(got), _gathered(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_distributed_unique_key_set_matches_reference(pctx, ctx4, mode):
    names, arrays = _frame()
    rt, pt = _both(ctx4, pctx, names, arrays)
    with modes(mode):
        want = rt.distributed_unique("k").to_numpy()["k"]
        got = pt.distributed_unique("k").to_numpy()["k"]
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    np.testing.assert_array_equal(np.sort(got), np.unique(arrays[0]))


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("col", ["k", "v", "w"])
def test_distributed_scalar_aggregates_match_reference(pctx, ctx4, mode,
                                                       col):
    from cylon_tpu.parallel import ops as rpar_ops

    names, arrays = _frame()
    rt, pt = _both(ctx4, pctx, names, arrays)
    ci = names.index(col)
    with modes(mode):
        for op in aggregates.ReduceOp:
            if op == aggregates.ReduceOp.PROD and col == "w":
                continue  # int64 products wrap: compared below on k
            got = par_ops.distributed_scalar_agg(pt, ci, op).numpy()
            want = np.asarray(rpar_ops.distributed_scalar_agg(
                rt, ci, RReduceOp(int(op))))
            assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
            if want.dtype.kind == "f" and op in (aggregates.ReduceOp.SUM,
                                                 aggregates.ReduceOp.PROD):
                np.testing.assert_allclose(
                    got, want, rtol=1e-5 if want.dtype == np.float32
                    else 1e-12)
            else:
                np.testing.assert_array_equal(got, want)
        for name in ("sum", "count", "min", "max"):
            g, w = getattr(pt, name)(col), getattr(rt, name)(col)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def _edge(case):
    if case == "fewer_rows_than_shards":
        return np.array([3, 1, 3], np.int32), np.array([1, 5], np.int32)
    if case == "total_skew":
        return np.full(200, 7, np.int32), np.full(150, 7, np.int32)
    return np.zeros(0, np.int32), np.zeros(0, np.int32)


@pytest.mark.parametrize("case", ["fewer_rows_than_shards", "total_skew",
                                  "empty"])
def test_edge_cases_match_reference(pctx, ctx4, case):
    ka, kb = _edge(case)
    ra, pa = _both(ctx4, pctx, ["k"], [ka])
    rb, pb = _both(ctx4, pctx, ["k"], [kb])
    assert_shards_equal(pa.distributed_sort("k"), ra.distributed_sort("k"))
    for op in ("union", "intersect", "subtract"):
        got = getattr(pa, f"distributed_{op}")(pb)
        want = getattr(ra, f"distributed_{op}")(rb)
        np.testing.assert_array_equal(np.sort(got.to_numpy()["k"]),
                                      np.sort(want.to_numpy()["k"]))
    got = pa.distributed_unique("k").to_numpy()["k"]
    np.testing.assert_array_equal(np.sort(got), np.unique(ka))
    assert int(pa.count("k")) == len(ka)
    if len(ka):
        assert int(pa.min("k")) == ka.min() and int(pa.max("k")) == ka.max()
    if case == "total_skew":  # every row on one shard
        assert sorted(pa.distributed_sort("k").row_counts.tolist()) == \
            [0, 0, 0, 200]


def test_schema_mismatch_and_string_lead_column(pctx):
    names, arrays = _frame(n=40)
    t = Table.from_numpy(names, arrays, ctx=pctx)
    with pytest.raises(CylonError, match=r"\[Invalid\] schema mismatch"):
        t.project(["k", "v"]).distributed_union(t.project(["v", "k"]))
    with pytest.raises(CylonError, match=r"\[Invalid\] schema mismatch"):
        t.project(["k"]).distributed_intersect(t.project(["w"]))
    # a string lead column range-partitions on its 4-byte prefix: the
    # shards come out globally ordered, and hold the input's strings
    words = np.array(["pear", "apple", "fig", None, "zz", "kiwi", "date",
                      "plum", "lime", "yuzu"], object)
    st = Table.from_numpy(["s"], [words[np.arange(40) % 10]], ctx=pctx)
    out = st.distributed_sort("s")
    flat = list(out.to_numpy()["s"])
    assert flat[:4] == [None] * 4  # nulls first
    assert flat[4:] == sorted(w for w in words[np.arange(40) % 10] if w)
    from cylon_tpu_torch.parallel import partition

    targets = partition.range_targets([c[0] for c in st.shards], st.counts,
                                      pctx.devices, num_bins=4, num_samples=8)
    assert all(int(t[:int(n)].max()) < WORLD
               for t, n in zip(targets, st.counts))
    with pytest.raises(CylonError, match="ascending length"):
        t.distributed_sort(["k", "w"], ascending=[True])


def test_distributed_operators_pipeline_matches_numpy(pctx):
    """``pipeline.distributed_operators`` on ``make_data`` tables."""
    n = 1500
    lk, lv, rk, rv = pipeline.make_data(n)
    left, right = pipeline.distributed_tables(pctx, lk, lv, rk, rv)
    scan.reset_launches()
    out = pipeline.distributed_operators(left, right)
    s = out["distributed_sort"]
    got = np.concatenate([c[0].data[:int(m)].numpy()
                          for c, m in zip(s.shards, s.counts)])
    np.testing.assert_array_equal(got, np.sort(lk))
    np.testing.assert_array_equal(
        np.sort(out["distributed_unique"].to_numpy()["k"]), np.unique(lk))
    for op, fn in (("union", np.union1d), ("intersect", np.intersect1d),
                   ("subtract", np.setdiff1d)):
        np.testing.assert_array_equal(
            np.sort(out[f"distributed_{op}"].to_numpy()["k"]), fn(lk, rk))
    np.testing.assert_allclose(float(out["sum"]),
                               lv.astype(np.float64).sum(), rtol=1e-12)
    assert int(out["min"]) == lk.min()
    assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU
