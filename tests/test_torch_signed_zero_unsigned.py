"""Two repaired faults of the port, against the JAX package on the CPU.

- Signed zero and NaN keys on a mesh: the port folds float keys before it
  hashes them (``keys.canonical_float``; the murmur3 kernel and its plain
  version, and ``ops/hashing.py``), so +0.0 and -0.0 (and, in a table
  built with an explicit validity, every NaN payload) land on one shard
  and form one key in the hash-shuffled group-by, join, unique and set
  ops at worlds 2, 4 and 8.  Each result equals the one-shard result and,
  for the signed zeros, the reference's CPU result at world 4.
- Unsigned columns: descending sort, group-by MIN/MAX and scalar min/max
  of uint8/16/32/64 columns, on one shard and on four, equal the
  reference.  Torch on the CPU lacks ``~``, ``min``/``max`` and
  ``scatter_reduce_`` "amin"/"amax" for the wider unsigned types, so the
  port carries them through a signed view (``keys.signed_carrier``).

Rows compare gathered and sorted, numerically (-0.0 == +0.0 and NaN ==
NaN: which sign a group's key keeps depends on row order, which differs
between shard layouts); counts, keys and integer values exact, float32
sums rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, column
from cylon_tpu_torch.table import _shard_plan

from .torch_parity import modes

WORLDS = (2, 4, 8)


def _pctx(world):
    if world == 1:
        return CylonContext.Init("cpu")
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


def _zero_frame(seed, n):
    """Float32 keys full of +0.0 and -0.0 (and a few other values) and an
    int32 row id."""
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, 2.25, -0.0],
                            np.float32), n)
    k[:18] = np.array([0.0, -0.0] * 8 + [1.5, -1.5], np.float32)
    return ["k", "v"], [k, np.arange(n, dtype=np.int32) % 7]


def _rows(d, names=None):
    """Gathered columns as float64, rows sorted by every column (None as
    NaN); -0.0 sorts with +0.0."""
    names = names or list(d)
    cols = [np.array([np.nan if x is None else x for x in d[n]], np.float64)
            for n in names]
    cols = [np.where(c == 0, 0.0, c) for c in cols]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True)


def _zero_ops(a, b):
    """name -> the gathered host frame of each hash-shuffled operator on
    tables ``a`` and ``b``: the group-by (by the float key), the four
    joins, unique of the key, and the three set ops on (k, v) rows."""
    out = {"groupby": a.groupby("k", {"v": ["count", "sum"]}).to_numpy()}
    dist = a.num_shards > 1
    for how in ("inner", "left", "right", "outer"):
        j = (a.distributed_join(b, on="k", how=how) if dist
             else a.join(b, on="k", how=how))
        out[f"join_{how}"] = j.to_numpy()
    ka = a.project(["k"])
    out["unique"] = (ka.distributed_unique() if dist else ka.unique()
                     ).to_numpy()
    for op in ("union", "intersect", "subtract"):
        fn = getattr(a, f"distributed_{op}" if dist else op)
        out[op] = fn(b).to_numpy()
    return out


@pytest.fixture(scope="module")
def zero_frames():
    return _zero_frame(1, 300), _zero_frame(2, 120)


@pytest.fixture(scope="module")
def one_shard(zero_frames):
    (names, a), (_, b) = zero_frames
    ctx = _pctx(1)
    return _zero_ops(Table.from_numpy(names, a, ctx=ctx),
                     Table.from_numpy(names, b, ctx=ctx))


@pytest.mark.parametrize("world", WORLDS)
def test_signed_zero_keys_form_one_key_at_every_world(zero_frames, one_shard,
                                                      world):
    (names, a), (_, b) = zero_frames
    ctx = _pctx(world)
    got = _zero_ops(Table.from_numpy(names, a, ctx=ctx),
                    Table.from_numpy(names, b, ctx=ctx))
    assert got.keys() == one_shard.keys()
    for name in got:
        _assert_rows_equal(_rows(got[name]), _rows(one_shard[name]))
    groups = got["groupby"]
    zeros = [c for k, c in zip(groups["k"], groups["count_v"]) if k == 0]
    assert zeros == [int((a[0] == 0).sum())]  # one group of every zero
    assert len(got["unique"]["k"]) == len(set(a[0].tolist()))


def test_signed_zero_keys_match_the_reference_at_world_4(zero_frames,
                                                         one_shard, ctx4):
    (names, a), (_, b) = zero_frames
    ra = RTable.from_numpy(names, a, ctx=ctx4)
    rb = RTable.from_numpy(names, b, ctx=ctx4)
    want = {"groupby": ra.groupby("k", {"v": ["count", "sum"]}).to_numpy()}
    for how in ("inner", "left", "right", "outer"):
        want[f"join_{how}"] = ra.distributed_join(rb, on="k",
                                                  how=how).to_numpy()
    want["unique"] = ra.project(["k"]).distributed_unique().to_numpy()
    for op in ("union", "intersect", "subtract"):
        want[op] = getattr(ra, f"distributed_{op}")(rb).to_numpy()
    ctx = _pctx(4)
    got = _zero_ops(Table.from_numpy(names, a, ctx=ctx),
                    Table.from_numpy(names, b, ctx=ctx))
    for name, w in want.items():
        _assert_rows_equal(_rows(got[name], list(w)), _rows(w))


NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FC0BEEF,
                     0xFF800002], np.uint32)


def _nan_table(ctx, seed=3, n=200):
    """(k, v) with float32 keys holding five NaN payloads, every row valid
    (an explicit validity keeps NaN a value), split as ``Table.from_numpy``
    splits rows."""
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array([1.0, 2.0, 0.0, -0.0], np.float32), n)
    nan_rows = rng.random(n) < 0.4
    k[nan_rows] = NAN_BITS[rng.integers(0, len(NAN_BITS),
                                        int(nan_rows.sum()))].view(np.float32)
    v = np.arange(n, dtype=np.int32)
    world = ctx.GetWorldSize()
    chunk, counts, cap = _shard_plan(n, world)
    shards = []
    for s, (m, dev) in enumerate(zip(counts, ctx.devices)):
        sl = slice(s * chunk, s * chunk + m)
        shards.append(tuple(column.from_numpy(x[sl], validity=np.ones(m, bool),
                                              capacity=cap, device=dev)
                            for x in (k, v)))
    cnts = tuple(torch.tensor(m, dtype=torch.int32) for m in counts)
    return Table(tuple(shards), cnts, ("k", "v"), ctx), k


@pytest.mark.parametrize("world", WORLDS)
def test_nan_payload_keys_form_one_key_at_every_world(world):
    one, k = _nan_table(_pctx(1))
    t, _ = _nan_table(_pctx(world))
    b, _ = _nan_table(_pctx(world), seed=4, n=80)
    b1, _ = _nan_table(_pctx(1), seed=4, n=80)
    got = {"groupby": t.groupby("k", {"v": ["count"]}).to_numpy(),
           "unique": t.project(["k"]).distributed_unique().to_numpy(),
           "join": t.distributed_join(b, on="k").to_numpy()}
    want = {"groupby": one.groupby("k", {"v": ["count"]}).to_numpy(),
            "unique": one.project(["k"]).unique().to_numpy(),
            "join": one.join(b1, on="k").to_numpy()}
    for name in want:
        _assert_rows_equal(_rows(got[name]), _rows(want[name]))
    g = got["groupby"]
    nan_groups = [c for x, c in zip(g["k"], g["count_v"]) if np.isnan(x)]
    assert nan_groups == [int(np.isnan(k).sum())]


UNSIGNED = (np.uint8, np.uint16, np.uint32, np.uint64)


def _unsigned_frame(dtype, n=400):
    rng = np.random.default_rng(5)
    top = np.iinfo(dtype).max
    k = rng.integers(0, top, n, dtype=dtype, endpoint=True)
    k[:4] = [0, top, top - 1, 1 << (8 * np.dtype(dtype).itemsize - 1)]
    g = rng.integers(0, 9, n).astype(np.int32)
    return ["g", "k"], [g, k]


@pytest.mark.parametrize("dtype", UNSIGNED, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("world", [1, 4])
def test_unsigned_descending_sort_matches_reference(dtype, world, local_ctx,
                                                    ctx4):
    names, arrays = _unsigned_frame(dtype)
    rt = RTable.from_numpy(names, arrays,
                           ctx=local_ctx if world == 1 else ctx4)
    pt = Table.from_numpy(names, arrays, ctx=_pctx(world))
    if world == 1:
        want = rt.sort("k", ascending=False).to_numpy()
        got = pt.sort("k", ascending=False).to_numpy()
    else:
        want = rt.distributed_sort("k", ascending=False).to_numpy()
        got = pt.distributed_sort("k", ascending=False).to_numpy()
    np.testing.assert_array_equal(got["k"], want["k"])  # exact, in order
    assert got["k"].dtype == want["k"].dtype == dtype
    np.testing.assert_array_equal(got["k"], np.sort(arrays[1])[::-1])


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("dtype", UNSIGNED, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("world", [1, 4])
def test_unsigned_groupby_min_max_matches_reference(dtype, world, mode,
                                                    local_ctx, ctx4):
    names, arrays = _unsigned_frame(dtype)
    rt = RTable.from_numpy(names, arrays,
                           ctx=local_ctx if world == 1 else ctx4)
    pt = Table.from_numpy(names, arrays, ctx=_pctx(world))
    with modes(mode):
        want = rt.groupby("g", {"k": ["min", "max"]}).to_numpy()
        got = pt.groupby("g", {"k": ["min", "max"]}).to_numpy()
    wo, go = np.argsort(want["g"]), np.argsort(got["g"])
    for name in ("g", "min_k", "max_k"):
        np.testing.assert_array_equal(got[name][go], want[name][wo])
        assert got[name].dtype == want[name].dtype


@pytest.mark.parametrize("dtype", UNSIGNED, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("world", [1, 4])
def test_unsigned_scalar_min_max_match_reference(dtype, world, local_ctx,
                                                 ctx4):
    names, arrays = _unsigned_frame(dtype)
    rt = RTable.from_numpy(names, arrays,
                           ctx=local_ctx if world == 1 else ctx4)
    pt = Table.from_numpy(names, arrays, ctx=_pctx(world))
    for op in ("min", "max"):
        got, want = getattr(pt, op)("k"), getattr(rt, op)("k")
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        assert int(got.numpy()) == int(np.asarray(want))
