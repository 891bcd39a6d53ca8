"""The port's one realization of ``ops/compact.py`` (cumsum destinations
and one permuting scatter) against the JAX package under each of its
realizations (``CYLON_TPU_PERMUTE`` scatter / sort).

Twins of every test of ``tests/test_permute_modes.py``.  Only the
reference reads the knob: each case runs the port once per reference
realization (the reference's jit caches are cleared between them: it
reads the knob at trace time).  ``compact_indices`` equals the
reference's on ``[0, new_count)`` and leaves zeros past it;
``partition_indices`` equals the reference's in full; every consumer
(joins, unique, NUNIQUE, the shuffle's target counts, the range
partition's histogram) gives the reference's outputs bit for bit.  The
knobs that once chose a second realization in the port are gone from its
registry and move none of its results.  Every comparison is exact."""
import contextlib
import os

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
from cylon_tpu_torch import CylonContext, MeshConfig, config, durable
from cylon_tpu_torch import pipeline
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import compact, groupby, join, keys, unique
from cylon_tpu_torch.parallel import partition
from cylon_tpu_torch.parallel import shuffle

from .torch_parity import assert_columns_equal, np_of, port_column

MODES = ("scatter", "sort")
#: the knobs that chose the port's second realization, each at a value the
#: reference still reads and the port no longer does
REMOVED_KNOBS = {"CYLON_TPU_PERMUTE": "sort", "CYLON_TPU_INVPERM": "gather",
                 "CYLON_TPU_SORT": "radix", "CYLON_TPU_RADIX_BITS": "4",
                 "CYLON_TPU_RADIX_SCAN": "xla"}


@contextlib.contextmanager
def _ref_env(**values):
    """Set the reference's environment knobs for the block (the port's
    ``config.knob_env`` refuses names it does not register), and restore
    them after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        os.environ.update(values)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _under(mode, fn):
    """``fn()`` with the reference under the realization ``mode``."""
    with _ref_env(CYLON_TPU_PERMUTE=mode):
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
        n = int(r_n)
        assert int(p_n) == n and int(p_nt) == int(r_nt)
        np.testing.assert_array_equal(np_of(p_idx)[:n], np.asarray(r_idx)[:n])
        assert not np_of(p_idx)[n:].any()  # the filler is zeros
        np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))

    _per_mode(run)


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
        np.testing.assert_array_equal(np_of(p[0]), want)

    with _ref_env(CYLON_TPU_INVPERM=invperm):
        _per_mode(run)


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


@pytest.mark.parametrize("jt", list(JoinType))
def test_join_gather_agree(jt):
    rl, pl, rr, pr, count = _join_inputs(int(jt.value) + 1, 1 << 10, 200, 13)

    def run():
        m = int(join.join_row_count(pl, torch.tensor(count), pr,
                                    torch.tensor(count), (0,), (0,), jt))
        out = _join_both(rl, pl, rr, pr, count, jt, m + 9)
        assert out[1] == m

    _per_mode(run)


def test_join_key_grouped_agree():
    rl, pl, rr, pr, count = _join_inputs(99, 1 << 10, 64, 0)
    _per_mode(lambda: _join_both(
        rl[:1], pl[:1], rr[:1], pr[:1], count, JoinType.INNER, 1 << 15,
        key_grouped=True))


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

    _per_mode(run)


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

    a, _ = _per_mode(run)
    g = a[1]
    want = (pd.DataFrame({"k": keys_np[:n], "v": vals_np[:n]})
            .groupby("k")["v"].nunique())
    np.testing.assert_array_equal(np_of(a[0][1].data)[:g], want.to_numpy())


def test_permute_mode_default_and_overrides():
    """A compaction leaves zero filler past ``new_count`` on a CPU tensor,
    and the reference's realization knobs move no plan or journal
    fingerprint of the port."""
    idx, n = compact.compact_indices(torch.tensor([False, True, False]))
    assert idx.tolist() == [1, 0, 0] and int(n) == 1
    cols = {"k": np.arange(5, dtype=np.int32)}
    frames = ((list(cols), cols),)
    token = config.trace_cache_token()
    fp = durable.run_fingerprint("join", (1, "sort"), frames)
    with _ref_env(**REMOVED_KNOBS):
        assert config.trace_cache_token() == token
        assert durable.run_fingerprint("join", (1, "sort"), frames) == fp


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

    _per_mode(run)
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

    _per_mode(run)


@pytest.mark.parametrize("world", [1, 3, 8, 31, 32, 40])
def test_target_counts_and_perm_by_target_agree(world):
    """The port's ``target_counts`` (compare-and-reduce while ``world + 1
    <= 32``, the histogram past it) against the reference's forms under
    each realization; out-of-range targets count toward no target."""
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
        return np_of(got)

    ca, _ = _per_mode(run)
    live = t[(t >= 0) & (t < world)]
    np.testing.assert_array_equal(ca, np.bincount(live, minlength=world))


def test_range_partition_histogram_agree(ctx4):
    """The range partition's sample histogram by ``index_add_``: the same
    targets as the reference's under each of its realizations, shard by
    shard."""
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

    _per_mode(run)


@pytest.mark.parametrize("name", sorted(REMOVED_KNOBS))
def test_removed_realization_knob_moves_nothing(name):
    """A removed knob is not registered, and set to the value that once
    chose the port's second realization it changes no bit of
    ``pipeline.join_groupby`` at 2^12 rows or of ``lexsort_indices``."""
    assert name not in config.KNOBS
    rows = 1 << 12
    tables = pipeline.tables(*pipeline.make_data(rows, seed=3), device="cpu")
    out_cap = pipeline.cap_round(pipeline.join_count(*tables))
    lk = tables[0][0]
    ops = keys.build_operands([lk], torch.tensor(rows - 5), rows)

    def run():
        gcols, g, jm = pipeline.join_groupby(*tables, out_cap)
        perm, words = keys.lexsort_indices(ops, rows)
        return [int(g), int(jm)], [*gcols], [perm, *words]

    want = run()
    with _ref_env(**{name: REMOVED_KNOBS[name]}):
        got = run()
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a.validity, b.validity)
        assert torch.equal(a.data.view(torch.uint8), b.data.view(torch.uint8))
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
