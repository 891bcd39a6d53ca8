"""String keys on the port's 4-shard CPU mesh against the JAX package on
its 4-device CPU mesh, on the same numpy inputs.

- The string shuffle and the distributed join -> group-by on a string key
  compare shard by shard, slot for slot, with the UNPATCHED reference: a
  key set holding a string hashes with the jnp row hash in the reference
  on every device, and with its copy (``ops/hashing.py``) in the port.
- ``distributed_sort`` on a string column compares shard by shard, and the
  string range targets bit for bit, in both precisions (float32 bins in
  narrow mode, float64 in wide); the 4-byte prefixes lie above 2^24, so
  float32 bins round.
- TPC-H Q1 at a small scale factor on one shard and on 4, against the
  query of ``examples/tpch_q1.py`` run on the reference over
  ``examples/tpch_data.py``'s lineitem: keys and counts exact, float32
  sums and means rtol 1e-5 (each side adds in its own order).
"""
import numpy as np
import pytest
import torch

from cylon_tpu.config import SortOptions as RSortOptions
from cylon_tpu.context import CylonContext as RContext
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, pipeline
from cylon_tpu_torch.config import SortOptions
from cylon_tpu_torch.ops import hash_kernels, scan

from .torch_parity import assert_shards_equal, modes

WORLD = 4
N = 1200
NAMES = np.array(["Customer#%09d" % k for k in range(0, 4000, 7)], object)
# leading bytes spread over the whole byte range: 4-byte prefixes past 2^24
PREFIXED = np.array([chr(c) + "%03d" % i for c in range(33, 127, 3)
                     for i in range(12)] + ["ÿü", "Ω", "", "a"], object)


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=WORLD))


def _frame(seed=7, n=N, words=NAMES):
    rng = np.random.default_rng(seed)
    s = words[rng.integers(0, len(words), n)]
    s[rng.random(n) < 0.05] = None
    v = rng.random(n).astype(np.float32)
    k = rng.integers(0, 50, n).astype(np.int32)
    return ["s", "v", "k"], [s, v, k]


def _both(ctx_r, pctx, names, arrays):
    return (RTable.from_numpy(names, arrays, ctx=ctx_r),
            Table.from_numpy(names, arrays, ctx=pctx))


@pytest.mark.parametrize("keys", [["s"], ["s", "k"]])
def test_string_shuffle_matches_reference_shard_by_shard(pctx, ctx4, keys):
    rt, pt = _both(ctx4, pctx, *_frame())
    hash_kernels.reset_launches()
    assert_shards_equal(pt.shuffle(keys), rt.shuffle(keys))  # slot for slot
    assert hash_kernels.LAUNCHES == {"hash_partition": 0}


def _assert_shards_close(got, want, rtol):
    """Shard by shard: counts and every column over the whole shard
    capacity, exact except float data (within ``rtol``)."""
    from cylon_tpu_torch import interop

    from .torch_parity import ref_table_shards

    names, p_shards, p_counts = interop.table_shards_to_arrays(got)
    r_shards, r_counts = ref_table_shards(want)
    assert tuple(names) == tuple(want.names)
    np.testing.assert_array_equal(p_counts, r_counts)
    for p_cols, r_cols in zip(p_shards, r_shards):
        for (pd_, pv, pl, _), (rd, rv, rl) in zip(p_cols, r_cols):
            np.testing.assert_array_equal(pv, rv)
            if rl is not None:
                np.testing.assert_array_equal(pl, rl)
            if rd.dtype.kind == "f":
                np.testing.assert_allclose(pd_, rd, rtol=rtol)
            else:
                np.testing.assert_array_equal(pd_, rd)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_distributed_string_join_groupby_matches_reference(pctx, ctx4, mode):
    """The join shard for shard exactly; the group-by shard for shard,
    keys and maxima exact, float sums and means rtol 1e-5."""
    ra, pa = _both(ctx4, pctx, *_frame(seed=7))
    rb, pb = _both(ctx4, pctx, *_frame(seed=8, n=900))
    with modes(mode):
        pj = pa.distributed_join(pb, on="s")
        rj = ra.distributed_join(rb, on="s")
        assert_shards_equal(pj, rj)  # exact, slot for slot
        got = pj.groupby("l_s", {"l_v": ["sum", "mean"], "r_k": "max"})
        want = rj.groupby("l_s", {"l_v": ["sum", "mean"], "r_k": "max"})
    _assert_shards_close(got, want, 1e-5)


def test_string_pipeline_drive_matches_numpy(pctx):
    """``pipeline.string_tables`` -> ``string_join_groupby`` on 4 shards and
    on one: group keys decode back to the int keys, in order on every
    shard, and match the int-key oracle."""
    lk, lv, rk, rv = pipeline.make_data(1500)
    cl = np.bincount(lk, minlength=1500)
    cr = np.bincount(rk, minlength=1500)
    both = np.flatnonzero((cl > 0) & (cr > 0))
    sums = np.bincount(lk, weights=lv.astype(np.float64), minlength=1500)
    for ctx in (pctx, CylonContext.Init("cpu")):
        scan.reset_launches()
        groups, joined = pipeline.string_join_groupby(
            *pipeline.string_tables(ctx, lk, lv, rk, rv))
        assert joined.row_count == int((cl * cr).sum())
        keys, got_sums = [], []
        for cols, n in zip(groups.shards, groups.counts):
            k = pipeline.name_keys(cols[0], n).numpy()
            assert (np.diff(k) > 0).all()  # key order within a shard
            keys.append(k)
            got_sums.append(cols[1].data[:int(n)].numpy())
        order = np.argsort(np.concatenate(keys))
        np.testing.assert_array_equal(np.concatenate(keys)[order], both)
        np.testing.assert_allclose(np.concatenate(got_sums)[order],
                                   (sums * cr)[both], rtol=1e-5)
        assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}  # CPU


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("words", ["names", "prefixed"])
@pytest.mark.parametrize("asc", [True, False])
def test_distributed_string_sort_matches_reference(pctx, ctx4, mode, words,
                                                   asc):
    names, arrays = _frame(words=NAMES if words == "names" else PREFIXED)
    rt, pt = _both(ctx4, pctx, names, arrays)
    with modes(mode):
        got = pt.distributed_sort("s", SortOptions(ascending=asc))
        want = rt.distributed_sort("s", RSortOptions(ascending=asc))
    assert got.row_count == N
    assert_shards_equal(got, want)  # exact, slot for slot


def test_string_range_targets_match_reference_bit_for_bit(pctx, ctx4):
    from cylon_tpu.parallel import ops as rpar_ops
    from cylon_tpu.table import _host_shard_pieces
    from cylon_tpu_torch.parallel import partition

    names, arrays = _frame(words=PREFIXED)
    rt, pt = _both(ctx4, pctx, names, arrays)
    prefixes = torch.cat([partition.string_prefix(s[0]) for s in pt.shards])
    assert int(prefixes.max()) > (1 << 24)  # float32 bins must round
    for mode in ("wide", "narrow"):
        for asc, nulls_first, bins in ((True, True, 0), (False, False, 0),
                                       (True, False, 1000)):
            opts = RSortOptions(ascending=asc, nulls_first=nulls_first,
                                num_bins=bins)
            with modes(mode):
                want, _ = rpar_ops._targets_and_counts(rt, (0,), "range",
                                                       opts)
                got = partition.range_targets(
                    [s[0] for s in pt.shards], pt.counts, pctx.devices,
                    num_bins=bins or 16 * WORLD, num_samples=4096,
                    ascending=asc, nulls_first=nulls_first)
            want = _host_shard_pieces(want, rt.shard_capacity)
            for s in range(WORLD):
                np.testing.assert_array_equal(got[s].numpy(), want[s])


def _reference_q1(raw, ctx):
    """``examples/tpch_q1.py:28-39`` on the reference."""
    from examples import tpch_data
    from examples.util import table_from_arrays

    t = table_from_arrays(raw, ctx)
    f = t.select(lambda r: r.l_shipdate <= tpch_data.Q1_CUTOFF)
    f["disc_price"] = (f["l_extendedprice"] * (f["l_discount"] * -1.0 + 1.0))
    f["charge"] = f["disc_price"] * (f["l_tax"] + 1.0)
    return f.groupby(["l_returnflag", "l_linestatus"], pipeline.Q1_AGGS)


@pytest.mark.parametrize("world", [1, WORLD])
def test_tpch_q1_matches_reference(pctx, ctx4, world):
    from examples import tpch_data

    sf, seed = 0.002, 5
    raw = tpch_data.lineitem(sf, np.random.default_rng(seed))
    data = pipeline.lineitem(sf, seed)
    for name, want in raw.items():  # the port's generator draws the same
        got = data[name]
        if isinstance(got, tuple):
            got = np.array([bytes(r).decode() for r in got[0]], object)
        np.testing.assert_array_equal(got, want)
    ctx = pctx if world == WORLD else CylonContext.Init("cpu")
    got = pipeline.tpch_q1(pipeline.lineitem_table(ctx, data)).to_numpy()
    want = _reference_q1(raw, ctx4 if world == WORLD
                         else RContext.Init()).to_numpy()
    order_g = np.lexsort((got["l_linestatus"], got["l_returnflag"]))
    order_w = np.lexsort((want["l_linestatus"], want["l_returnflag"]))
    assert list(got) == list(want) and len(order_g) == 6
    for name in got:
        g, w = got[name][order_g], want[name][order_w]
        if g.dtype == object or name.startswith("count"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), rtol=1e-5)
