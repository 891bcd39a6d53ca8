"""The distributed rung of the port (``context``, ``parallel/``, ``Table``)
on a 4-shard CPU mesh against the JAX package on its 4-device CPU mesh,
on the same numpy inputs.

- Shuffle and HashPartition compare shard by shard, slot for slot, with
  the reference's ``hash_targets`` forced onto its murmur3 (TPU) branch
  (``torch_parity.murmur3_reference``): exact.
- The slice gate (distributed join -> two-phase group-by) and the edge
  cases compare gathered, key-sorted results with the unpatched reference,
  whose CPU hash places rows elsewhere: keys, join and group counts and
  validity exact; SUM and MEAN rtol=1e-5 in both precisions (each is a
  float32 partial sum, added in another order on each side, as
  ``test_torch_join_groupby.py`` states for float32 sums and means)."""
import numpy as np
import pytest
import torch

from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, interop, pipeline
from cylon_tpu_torch.context import LocalConfig
from cylon_tpu_torch.ops import hash_kernels, scan
from cylon_tpu_torch.parallel import collectives, shuffle
from cylon_tpu_torch.status import CylonError

from .torch_parity import assert_shards_equal, modes, murmur3_reference

WORLD = 4
N = 3000


def _frame(seed=7, n=N):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 500, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    v[::17] = np.nan  # nulls, also as a shuffle key
    w = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    return ["k", "v", "w"], [k, v, w]


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=WORLD))


@pytest.fixture(scope="module")
def murmur3_results():
    """The reference's shuffles and HashPartitions under murmur3
    placement, built once (each distributed program compiles once)."""
    names, arrays = _frame()
    with murmur3_reference(WORLD) as rctx:
        rt = RTable.from_numpy(names, arrays, ctx=rctx)
        return {"k": rt.shuffle("k"), "k,w": rt.shuffle(["k", "w"]),
                "v": rt.shuffle("v"),
                "hp3": rt.hash_partition("k", 3),
                "hp4": rt.hash_partition(["k", "w"], 4)}


@pytest.mark.parametrize("key", ["k", "k,w", "v"])
def test_shuffle_matches_murmur3_reference_slot_for_slot(pctx,
                                                         murmur3_results,
                                                         key):
    names, arrays = _frame()
    pt = Table.from_numpy(names, arrays, ctx=pctx)
    assert_shards_equal(pt, RTable.from_numpy(names, arrays,
                                              ctx=murmur3_results["k"].ctx))
    out = pt.shuffle(key.split(","))
    assert out.num_shards == WORLD and out.row_count == N
    assert_shards_equal(out, murmur3_results[key])  # exact


@pytest.mark.parametrize("case", [("hp3", "k", 3), ("hp4", "k,w", 4)])
def test_hash_partition_matches_murmur3_reference(pctx, murmur3_results,
                                                  case):
    name, key, parts = case
    names, arrays = _frame()
    got = Table.from_numpy(names, arrays, ctx=pctx).hash_partition(
        key.split(","), parts)
    want = murmur3_results[name]
    assert sorted(got) == sorted(want) == list(range(parts))
    assert sum(t.row_count for t in got.values()) == N
    for p in range(parts):
        assert_shards_equal(got[p], want[p])  # exact


def _sorted(d, key):
    """Rows of a gathered result dict ordered by key, nulls first."""
    k = d[key]
    isnull = np.array([x is None for x in k]) if k.dtype == object \
        else np.zeros(len(k), bool)
    kv = np.array([0 if x is None else x for x in k], np.float64)
    order = np.lexsort((kv, ~isnull))
    return {n: v[order] for n, v in d.items()}


def _assert_results(got: Table, want, got_join_rows, want_join_rows):
    assert got_join_rows == want_join_rows  # exact
    g, w = got.to_numpy(), want.to_numpy()
    assert tuple(got.names) == tuple(want.names)
    assert len(g["l_k"]) == len(w["l_k"])  # group count, exact
    g, w = _sorted(g, "l_k"), _sorted(w, "l_k")
    np.testing.assert_array_equal(g["l_k"], w["l_k"])  # keys, exact
    for name in ("sum_lv", "mean_rv"):
        gv, wv = g[name], w[name]
        gnull = np.array([x is None for x in gv]) if gv.dtype == object \
            else np.zeros(len(gv), bool)
        wnull = np.array([x is None for x in wv]) if wv.dtype == object \
            else np.zeros(len(wv), bool)
        np.testing.assert_array_equal(gnull, wnull)  # validity, exact
        np.testing.assert_allclose(gv[~gnull].astype(np.float64),
                                   wv[~wnull].astype(np.float64),
                                   rtol=1e-5)  # float32 partial sums


def _ref_slice(ctx, lk, lv, rk, rv):
    rl = RTable.from_numpy(["k", "lv"], [lk, lv], ctx=ctx)
    rr = RTable.from_numpy(["k", "rv"], [rk, rv], ctx=ctx)
    j = rl.distributed_join(rr, on="k")
    return j.groupby("l_k", {"lv": "sum", "rv": "mean"}), j.row_count


@pytest.mark.parametrize("mode", ["narrow", "wide"])
def test_slice_gate_matches_reference(pctx, ctx4, mode):
    """pipeline.distributed_join_groupby on bench._make_data tables, 2^12
    rows per side in 4 shards, against the reference's distributed join
    and group-by."""
    data = pipeline.make_data(1 << 12)
    with modes(mode):
        want, want_rows = _ref_slice(ctx4, *data)
        scan.reset_launches()
        hash_kernels.reset_launches()
        got, joined = pipeline.distributed_join_groupby(
            *pipeline.distributed_tables(pctx, *data))
        assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU
        assert hash_kernels.LAUNCHES == {"hash_partition": 0}
        _assert_results(got, want, joined.row_count, want_rows)


def _edge_data(case):
    rng = np.random.default_rng(11)
    if case == "fewer_rows_than_shards":
        lk, rk = np.array([1, 2, 1], np.int32), np.array([1, 1, 3], np.int32)
    elif case == "total_skew":
        lk, rk = np.full(200, 7, np.int32), np.full(150, 7, np.int32)
    elif case == "empty":
        lk, rk = np.zeros(0, np.int32), np.zeros(0, np.int32)
    else:  # null keys: NaN float keys on both sides
        lk = rng.integers(0, 20, 300).astype(np.float32)
        rk = rng.integers(0, 20, 250).astype(np.float32)
        lk[::9] = np.nan
        rk[::7] = np.nan
    lv = rng.random(len(lk)).astype(np.float32)
    rv = rng.random(len(rk)).astype(np.float32)
    return lk, lv, rk, rv


@pytest.mark.parametrize("case", ["fewer_rows_than_shards", "total_skew",
                                  "empty", "null_key"])
def test_edge_cases_match_reference(pctx, ctx4, case):
    data = _edge_data(case)
    want, want_rows = _ref_slice(ctx4, *data)
    got, joined = pipeline.distributed_join_groupby(
        *pipeline.distributed_tables(pctx, *data))
    _assert_results(got, want, joined.row_count, want_rows)
    if case == "total_skew":  # every row on one shard
        assert sorted(joined.row_counts.tolist()) == [0, 0, 0, 200 * 150]


def test_single_shard_context_runs_locally():
    ctx = CylonContext.Init("cpu")
    assert ctx.GetWorldSize() == 1 and not ctx.is_distributed()
    data = pipeline.make_data(300)
    got, joined = pipeline.distributed_join_groupby(
        *pipeline.distributed_tables(ctx, *data))
    lk, rk = data[0], data[2]
    cl, cr = np.bincount(lk, minlength=300), np.bincount(rk, minlength=300)
    assert joined.row_count == int((cl * cr).sum())  # exact
    assert got.row_count == int(((cl > 0) & (cr > 0)).sum())
    assert got.shuffle("l_k") is got


def test_shard_arrays_round_trip(pctx):
    names, arrays = _frame()
    t = Table.from_numpy(names, arrays, ctx=pctx)
    assert t.row_counts.tolist() == [750] * 4 and t.shard_capacity == 750
    nm, shards, counts = interop.table_shards_to_arrays(t)
    back = interop.table_from_shard_arrays(nm, shards, counts, pctx)
    for a, b in zip(t.to_numpy().values(), back.to_numpy().values()):
        np.testing.assert_array_equal(a.astype(object), b.astype(object))
    proj = back.project(["w", "k"])
    assert proj.names == ("w", "k")
    np.testing.assert_array_equal(proj.to_numpy()["k"], arrays[0])


def test_all_to_all_delivers_in_source_rank_order():
    world = 3
    sizes = np.array([[2, 0, 1], [1, 1, 0], [0, 2, 2]])
    send = [torch.arange(10 * s, 10 * s + int(sizes[s].sum()))
            for s in range(world)]
    out = [torch.full((5,), -1, dtype=torch.int64) for _ in range(world)]
    collectives.all_to_all(send, sizes, out)
    assert out[0].tolist() == [0, 1, 10, -1, -1]
    assert out[1].tolist() == [11, 20, 21, -1, -1]
    assert out[2].tolist() == [2, 22, 23, -1, -1]
    with pytest.raises(ValueError, match="receives"):
        collectives.all_to_all(send, sizes * 3, out)
    devs = [torch.device("cpu")] * world
    xs = [torch.tensor([s, 10 - s]) for s in range(world)]
    assert collectives.allgather(xs, devs)[1].tolist() == [0, 10, 1, 9, 2, 8]
    assert collectives.allreduce_sum(xs, devs)[2].tolist() == [3, 27]
    assert collectives.allreduce_min(xs, devs)[0].tolist() == [0, 8]
    assert collectives.allreduce_max(xs, devs)[0].tolist() == [2, 10]


def test_shuffle_helpers():
    t = torch.tensor([2, 0, 4, -1, 9, 2, 1], dtype=torch.int32)
    # out-of-range targets (9, -1) fall into the padding bucket (== 4)
    assert shuffle.target_counts(t, 4).tolist() == [1, 1, 2, 0]
    assert shuffle._perm_by_target(t, 4).tolist() == [1, 6, 0, 5, 2, 3, 4]
    assert shuffle.plan_shuffle(np.array([[3, 9], [0, 20]])) == 32
    assert shuffle.pow2ceil(0) == 8 and shuffle.pow2ceil(1025) == 2048


def test_context_devices_and_unported_paths(pctx, monkeypatch):
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu", "meta"],
                                                  world_size=3))
    assert [d.type for d in ctx.devices] == ["cpu", "meta", "cpu"]
    assert ctx.GetRank() == 0 and ctx.GetWorldSize() == 3
    with pytest.raises(ValueError, match="Local"):
        CylonContext.InitDistributed(LocalConfig())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CylonError, match="no CUDA device"):
        CylonContext.InitDistributed(MeshConfig(world_size=4))
    with pytest.raises(CylonError, match="no CUDA device"):
        CylonContext.Init()
    pctx.Barrier()

    names, arrays = _frame(n=40)
    t = Table.from_numpy(names, arrays, ctx=pctx)
    # the pipeline and NUNIQUE group-bys and broadcast_gather, once
    # refused on a mesh, now run
    k = arrays[0]
    piped = t.distributed_sort("k").groupby("k", {"w": "count"},
                                            groupby_type="pipeline")
    assert piped.row_count == len(np.unique(k))
    nu = t.groupby("k", {"w": "nunique"}).to_numpy()
    assert dict(zip(nu["k"].tolist(), nu["nunique_w"].tolist())) == {
        int(x): len(np.unique(arrays[2][k == x])) for x in np.unique(k)}
    from cylon_tpu_torch.parallel import ops as par_ops

    everywhere = par_ops.broadcast_gather(t)
    assert everywhere.row_counts.tolist() == [40] * WORLD
    with pytest.raises(CylonError, match="KeyError"):
        t.shuffle("nope")
    with pytest.raises(CylonError, match="Invalid"):
        t.distributed_join(t, left_on="k", right_on="w")  # int32 vs int64
    from cylon_tpu_torch.ops.groupby import AggOp

    # a salted SUM is refused as the reference refuses it (Invalid)
    with pytest.raises(CylonError, match="Invalid"):
        par_ops.distributed_groupby(t, (0,), ((1, AggOp.SUM),), 0, salt=2)
    # the out-of-core engine over a mesh, once refused, now runs: its
    # groups are the one-shard engine's
    from cylon_tpu_torch import exec as pexec

    args = (arrays[0], arrays[1], arrays[0], arrays[1], 2)
    res, stats = pexec.chunked_join_groupby(*args, ctx=pctx)
    one, one_stats = pexec.chunked_join_groupby(
        *args, ctx=CylonContext.Init("cpu"))
    assert stats["world"] == WORLD and stats["groups"] == one_stats["groups"]
    np.testing.assert_array_equal(np.sort(res["key"]), np.sort(one["key"]))
