"""The port's two realizations of ``ops/compact.py`` (``CYLON_TPU_PERMUTE``
scatter / sort) against each other and against the JAX package's.

Twins of every test of ``tests/test_permute_modes.py``.  Both packages
read the one knob, so each case runs both under the same realization
(the reference's jit caches are cleared between realizations: it reads
the knob at trace time).  Under ``sort`` the port's ``compact_indices``
and ``partition_indices`` equal the reference's entry for entry, the
filler past ``new_count`` included; every consumer (joins, unique,
NUNIQUE, the shuffle's target counts, the range partition's histogram)
gives bit-identical outputs under both realizations.  Every comparison
is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu import column as rcolmod
from cylon_tpu.config import JoinType as RJoinType
from cylon_tpu.ops import compact as rcompact
from cylon_tpu.ops import groupby as rgroupby
from cylon_tpu.ops import join as rjoin
from cylon_tpu.ops import unique as runique
from cylon_tpu.parallel import shuffle as rshuffle
from cylon_tpu_torch import CylonContext, MeshConfig, config
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import compact, groupby, join, radix, unique
from cylon_tpu_torch.parallel import partition
from cylon_tpu_torch.parallel import shuffle

from .torch_parity import assert_columns_equal, np_of, port_column

MODES = ("scatter", "sort")


def _under(mode, fn):
    """``fn()`` with both packages under the realization ``mode``."""
    with config.knob_env(CYLON_TPU_PERMUTE=mode):
        jax.clear_caches()
        try:
            return fn()
        finally:
            jax.clear_caches()


def _per_mode(fn):
    return tuple(_under(m, fn) for m in MODES)


def _cols(*arrays, capacity=None):
    ref = tuple(rcolmod.from_numpy(a, capacity=capacity) for a in arrays)
    return ref, tuple(port_column(c) for c in ref)


@pytest.mark.parametrize("cap", [1, 7, 256, 1 << 12, 1000])
def test_compact_partition_agree(cap):
    rng = np.random.default_rng(cap)
    mask = rng.integers(0, 2, cap).astype(bool)

    def run():
        r_idx, r_n = rcompact.compact_indices(jnp.asarray(mask))
        r_perm, r_nt = rcompact.partition_indices(jnp.asarray(mask))
        p_idx, p_n = compact.compact_indices(torch.from_numpy(mask))
        p_perm, p_nt = compact.partition_indices(torch.from_numpy(mask))
        assert p_idx.dtype == p_perm.dtype == torch.int32
        assert int(p_n) == int(r_n) and int(p_nt) == int(r_nt)
        # entry for entry, the filler past new_count included
        np.testing.assert_array_equal(np_of(p_idx), np.asarray(r_idx))
        np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))
        return np_of(p_idx), int(p_n), np_of(p_perm)

    a, b = _per_mode(run)
    n = a[1]
    assert a[1] == b[1]
    np.testing.assert_array_equal(a[0][:n], b[0][:n])
    np.testing.assert_array_equal(a[2], b[2])
    # sort-mode filler: the False rows in order; scatter's: zeros
    np.testing.assert_array_equal(b[0][n:], np.flatnonzero(~mask))
    assert not a[0][n:].any()


def test_mask_sort_word_at_the_int32_sign_bit(monkeypatch):
    """At ``bits + 1 == 32`` the flag would sit in int32's sign bit and
    invert the order: the word widens to int64 there, and past 32 bits
    the stable flag sort takes over."""
    mask = torch.tensor([False, True, False, True, True])
    for bits in (3, 30, 31, 32):
        monkeypatch.setattr(compact, "index_bits", lambda cap, b=bits: b)
        got = compact._mask_sort_perm(mask)
        assert got.dtype == (torch.int64 if bits + 1 > 32 else torch.int32)
        assert got.tolist() == [1, 3, 4, 0, 2], bits


@pytest.mark.parametrize("invperm", ["sort", "gather"])
def test_inverse_permute_agree(invperm):
    rng = np.random.default_rng(42)
    n = 1 << 11
    perm = rng.permutation(n).astype(np.int32)
    f1 = rng.integers(-1000, 1000, n).astype(np.int32)
    f2 = rng.integers(0, 5, n).astype(np.int32)
    f3 = rng.random(n).astype(np.float32)
    want = np.empty(n, np.int32)
    want[perm] = f1

    def run():
        r = rcompact.inverse_permute(jnp.asarray(perm), jnp.asarray(f1),
                                     jnp.asarray(f2), jnp.asarray(f3))
        p = compact.inverse_permute(torch.from_numpy(perm),
                                    torch.from_numpy(f1),
                                    torch.from_numpy(f2),
                                    torch.from_numpy(f3))
        for x, y in zip(p, r):
            np.testing.assert_array_equal(np_of(x), np.asarray(y))
        return [np_of(x) for x in p]

    with config.knob_env(CYLON_TPU_INVPERM=invperm):
        a, b = _per_mode(run)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[0], want)


def _join_inputs(seed, cap, domain, cut):
    rng = np.random.default_rng(seed)
    rl, pl = _cols(rng.integers(0, domain, cap).astype(np.int32),
                   rng.random(cap).astype(np.float32))
    rr, pr = _cols(rng.integers(0, domain, cap).astype(np.int32),
                   rng.random(cap).astype(np.float32))
    return rl, pl, rr, pr, cap - cut


def _join_both(rl, pl, rr, pr, count, jt, out_cap, algo="sort",
               key_grouped=False, project=None):
    """The port's and the reference's ``join_gather``, compared over the
    whole capacity; returns the port's (columns, count)."""
    r_cols, r_n = rjoin.join_gather(rl, jnp.int32(count), rr,
                                    jnp.int32(count), (0,), (0,),
                                    RJoinType[jt.name], out_cap, algo,
                                    key_grouped=key_grouped, project=project)
    p_cols, p_n = join.join_gather(pl, torch.tensor(count), pr,
                                   torch.tensor(count), (0,), (0,), jt,
                                   out_cap, algo, key_grouped=key_grouped,
                                   project=project)
    assert int(p_n) == int(r_n)
    assert_columns_equal(p_cols, r_cols)
    return p_cols, int(p_n)


def _same_outputs(a, b):
    (ca, na), (cb, nb) = a, b
    assert na == nb
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(np_of(x.validity), np_of(y.validity))
        np.testing.assert_array_equal(np_of(x.data), np_of(y.data))


@pytest.mark.parametrize("jt", list(JoinType))
def test_join_gather_agree(jt):
    rl, pl, rr, pr, count = _join_inputs(int(jt.value) + 1, 1 << 10, 200, 13)

    def run():
        m = int(join.join_row_count(pl, torch.tensor(count), pr,
                                    torch.tensor(count), (0,), (0,), jt))
        out = _join_both(rl, pl, rr, pr, count, jt, m + 9)
        assert out[1] == m
        return out

    _same_outputs(*_per_mode(run))


def test_join_key_grouped_agree():
    rl, pl, rr, pr, count = _join_inputs(99, 1 << 10, 64, 0)
    _same_outputs(*_per_mode(lambda: _join_both(
        rl[:1], pl[:1], rr[:1], pr[:1], count, JoinType.INNER, 1 << 15,
        key_grouped=True)))


@pytest.mark.parametrize("keep", ["first", "last"])
def test_unique_agree(keep):
    rng = np.random.default_rng(7 if keep == "first" else 8)
    cap = 1 << 11
    rc, pc = _cols(rng.integers(0, 100, cap).astype(np.int32))
    count = cap - 9

    def run():
        r_out, r_m = runique.unique(rc, jnp.int32(count), (0,), keep=keep)
        p_out, p_m = unique.unique(pc, torch.tensor(count), (0,), keep=keep)
        assert int(p_m) == int(r_m)
        assert_columns_equal(p_out, r_out)
        return p_out, int(p_m)

    _same_outputs(*_per_mode(run))


def test_count_leq_dense_matches_searchsorted():
    rng = np.random.default_rng(3)
    for cap_l, out_cap in ((1, 4), (100, 256), (1000, 2048), (777, 1000)):
        emit = rng.integers(0, 4, cap_l).astype(np.int32)
        csum = np.cumsum(emit).astype(np.int32)
        out_cap = max(out_cap, int(csum[-1]))
        want = np.searchsorted(csum, np.arange(out_cap), side="right")
        ref = np.asarray(rcompact.count_leq_dense(jnp.asarray(csum), out_cap))
        for mode in MODES:
            with config.knob_env(CYLON_TPU_PERMUTE=mode):
                got = compact.count_leq_dense(torch.from_numpy(csum),
                                              out_cap)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(np_of(got), want.astype(np.int32))
            np.testing.assert_array_equal(np_of(got), ref)
    # any input order, values clipped to [0, num_queries]
    vals = torch.tensor([5, -3, 2, 9, 2, 0], dtype=torch.int32)
    got = compact.count_leq_dense(vals, 6)
    ref = rcompact.count_leq_dense(jnp.asarray(vals.numpy()), 6)
    np.testing.assert_array_equal(np_of(got), np.asarray(ref))
    assert got.tolist() == [2, 2, 4, 4, 4, 5]


def test_nunique_agree_across_modes():
    rng = np.random.default_rng(21)
    cap = 1 << 11
    n = cap - 30
    keys_np = rng.integers(0, 40, cap).astype(np.int32)
    vals_np = rng.integers(0, 15, cap).astype(np.int32)
    rc, pc = _cols(keys_np, vals_np)
    aggs = ((1, groupby.AggOp.NUNIQUE),)

    def run():
        r_out, r_g = rgroupby.hash_groupby(
            rc, jnp.int32(n), (0,), ((1, rgroupby.AggOp.NUNIQUE),))
        p_out, p_g = groupby.hash_groupby(pc, torch.tensor(n), (0,), aggs)
        assert int(p_g) == int(r_g)
        assert_columns_equal(p_out, r_out)
        return p_out, int(p_g)

    a, b = _per_mode(run)
    _same_outputs(a, b)
    g = a[1]
    want = (pd.DataFrame({"k": keys_np[:n], "v": vals_np[:n]})
            .groupby("k")["v"].nunique())
    np.testing.assert_array_equal(np_of(a[0][1].data)[:g], want.to_numpy())


def test_permute_mode_default_and_overrides():
    """The port's defaults: ``auto`` is scatter on every device the port
    runs on (CUDA and the CPU; the reference sorts only on a TPU), the
    sort is ``cmp``; a scatter-realized compaction leaves zero filler on
    a CPU tensor."""
    with config.knob_env(CYLON_TPU_PERMUTE=None, CYLON_TPU_SORT=None,
                         CYLON_TPU_INVPERM=None, CYLON_TPU_RADIX_BITS=None):
        assert compact.permute_mode() == "scatter"
        assert radix.sort_mode() == "cmp"
        assert compact.invperm_mode() == "sort"
        assert radix.radix_bits() == 1
        idx, n = compact.compact_indices(torch.tensor([False, True, False]))
        assert idx.tolist() == [1, 0, 0] and int(n) == 1
    for mode in ("auto", "bogus"):
        with config.knob_env(CYLON_TPU_PERMUTE=mode):
            assert compact.permute_mode() == "scatter"
    for mode in MODES:
        with config.knob_env(CYLON_TPU_PERMUTE=mode):
            assert compact.permute_mode() == mode
    for raw, want in (("0", 1), ("3", 3), ("20", 8)):
        with config.knob_env(CYLON_TPU_RADIX_BITS=raw):
            assert radix.radix_bits() == want
    # realization knobs never move plan or journal fingerprints
    for name in ("CYLON_TPU_PERMUTE", "CYLON_TPU_INVPERM", "CYLON_TPU_SORT",
                 "CYLON_TPU_RADIX_BITS", "CYLON_TPU_RADIX_SCAN"):
        assert name not in config.RESULT_KNOBS
        assert config.KNOBS[name].scope == config.RUNTIME


@pytest.mark.parametrize("kg,algo", [(True, "sort"), (True, "hash"),
                                     (False, "sort"), (False, "hash")])
def test_join_projection_key_grouped_and_hash(kg, algo):
    rl, pl, rr, pr, count = _join_inputs(11, 1 << 9, 60, 3)

    def run():
        full, n = _join_both(rl, pl, rr, pr, count, JoinType.INNER, 1 << 12,
                             algo, key_grouped=kg)
        proj, n2 = _join_both(rl, pl, rr, pr, count, JoinType.INNER,
                              1 << 12, algo, key_grouped=kg,
                              project=(0, 1, 3))
        assert n == n2
        for want_idx, got in zip((0, 1, 3), proj):
            np.testing.assert_array_equal(np_of(full[want_idx].data)[:n],
                                          np_of(got.data)[:n])
        return proj, n

    _same_outputs(*_per_mode(run))
    with pytest.raises(ValueError, match="project"):
        join.join_gather(pl, torch.tensor(count), pr, torch.tensor(count),
                         (0,), (0,), JoinType.INNER, 1 << 12, algo,
                         project=(-1,))


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.FULL_OUTER])
def test_join_projection_pushdown(jt):
    rl, pl, rr, pr, count = _join_inputs(5, 1 << 9, 80, 7)

    def run():
        full, n = _join_both(rl, pl, rr, pr, count, jt, 1 << 12)
        proj, n2 = _join_both(rl, pl, rr, pr, count, jt, 1 << 12,
                              project=(3, 0, 1))
        assert n == n2
        for want_idx, got in zip((3, 0, 1), proj):
            np.testing.assert_array_equal(np_of(full[want_idx].data)[:n],
                                          np_of(got.data)[:n])
            np.testing.assert_array_equal(
                np_of(full[want_idx].validity)[:n], np_of(got.validity)[:n])
        return proj, n

    _same_outputs(*_per_mode(run))


@pytest.mark.parametrize("world", [1, 3, 8, 31, 40])
def test_target_counts_and_perm_by_target_agree(world):
    """Both ``target_counts`` forms under sort (compare-and-reduce while
    ``world + 1 <= 32``, ``count_leq_dense`` past it) and the histogram
    under scatter; out-of-range targets count toward no target."""
    rng = np.random.default_rng(world)
    t = rng.integers(-2, world + 3, 3000).astype(np.int32)
    t[:50] = world  # padding

    def run():
        got = shuffle.target_counts(torch.from_numpy(t), world)
        want = rshuffle.target_counts(jnp.asarray(t), world)
        np.testing.assert_array_equal(np_of(got), np.asarray(want))
        assert got.dtype == torch.int32
        perm = shuffle._perm_by_target(torch.from_numpy(t), world)
        rperm = rshuffle._perm_by_target(jnp.asarray(t), world)
        np.testing.assert_array_equal(np_of(perm), np.asarray(rperm))
        return np_of(got), np_of(perm)

    (ca, pa), (cb, pb) = _per_mode(run)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(pa, pb)
    live = t[(t >= 0) & (t < world)]
    np.testing.assert_array_equal(ca, np.bincount(live, minlength=world))


def test_range_partition_histogram_agree(ctx4):
    """The range partition's sample histogram from ``count_leq_dense``
    (sort) or ``index_add_`` (scatter): the same targets, equal to the
    reference's, shard by shard."""
    from cylon_tpu.parallel import ops as rpar_ops
    from cylon_tpu.config import SortOptions as RSortOptions
    from cylon_tpu.table import Table as RTable, _host_shard_pieces
    from cylon_tpu_torch import Table

    pctx = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))
    rng = np.random.default_rng(17)
    n = 2000
    arrays = [rng.integers(0, 300, n).astype(np.int32),
              rng.random(n).astype(np.float32)]
    arrays[1][::13] = np.nan
    rt = RTable.from_numpy(["k", "v"], arrays, ctx=ctx4)
    pt = Table.from_numpy(["k", "v"], arrays, ctx=pctx)

    def run():
        want, _ = rpar_ops._targets_and_counts(rt, (1,), "range",
                                               RSortOptions())
        got = partition.range_targets([s[1] for s in pt.shards], pt.counts,
                                      pctx.devices, num_bins=64,
                                      num_samples=4096)
        want = _host_shard_pieces(want, rt.shard_capacity)
        for s in range(4):
            np.testing.assert_array_equal(got[s].numpy(), want[s])
        return [g.numpy() for g in got]

    a, b = _per_mode(run)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
