"""Key encoding, lexsort and compaction: cylon_tpu_torch.ops.keys /
compact against cylon_tpu.ops.keys / compact on the same numpy inputs.
Everything here is exact: permutations, packed words, masks and counts."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import compact as rcompact
from cylon_tpu.ops import keys as rkeys
from cylon_tpu_torch.ops import compact, keys

from .torch_parity import columns, np_of


def _floats(rng, n, dtype):
    """Values with nulls, -0.0, +0.0 and NaN payloads, and many ties."""
    x = rng.integers(-20, 20, n).astype(dtype) / 4
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = np.nan
    return x


def _ref_words(words):
    """Reference words (uint32 / uint64) as the port carries them (int64)."""
    out = []
    for w in words:
        w = np.asarray(w)
        out.append(w.view(np.int64) if w.dtype == np.uint64
                   else w.astype(np.int64))
    return out


def _operands(rng, n, count, kinds):
    """(reference operands, port operands) for a key of the given column
    kinds, padding flag first, the float columns carrying NaN/-0.0 (which
    the JAX Column keeps as values when validity is given explicitly)."""
    vals, valid = [], []
    for kind in kinds:
        if kind in ("f32", "f64"):
            vals.append(_floats(rng, n, np.float32 if kind == "f32"
                                else np.float64))
        else:
            vals.append(rng.integers(-50, 50, n).astype(np.dtype(kind)))
        valid.append(rng.random(n) > 0.1)
    rc, pc = columns(vals, valid)
    r_ops = rkeys.build_operands(list(rc), jnp.int32(count), n)
    p_ops = keys.build_operands(list(pc), torch.tensor(count), n)
    return r_ops, p_ops


# (key column kinds, capacity): packed bits + index bits
CASES = {
    "fast_32": (["int8"], 1000),              # 1+9 +10 idx = 20 <= 32
    "fast_64_below": (["int32"], 3000),       # 1+33 +12 idx = 46
    "fast_64_exact": (["f32", "int16"], 8192),  # 1+33+17 +13 idx = 64
    "multi_32": (["int32", "int32"], 2000),   # 67 bits of 32-bit words
    "multi_64": (["int64", "f64", "int8"], 2000),  # 64-bit words too
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lexsort_indices_matches_reference(case):
    kinds, n = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + n)
    count = n - n // 10  # a padding tail: the MSB set on the 64-bit key
    r_ops, p_ops = _operands(rng, n, count, kinds)
    r_perm, r_words = rkeys.lexsort_indices(r_ops, n)
    p_perm, p_words = keys.lexsort_indices(p_ops, n)
    np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))
    assert p_perm.dtype == torch.int32
    assert len(p_words) == len(r_words)
    for pw, rw in zip(p_words, _ref_words(r_words)):
        np.testing.assert_array_equal(np_of(pw), rw)
    # adjacency and dense group ids over the sorted words
    np.testing.assert_array_equal(
        np_of(keys.rows_equal_adjacent(p_words)),
        np.asarray(rkeys.rows_equal_adjacent(r_words)))
    p_gid, p_num = keys.dense_group_ids(p_words)
    r_gid, r_num = rkeys.dense_group_ids(r_words)
    np.testing.assert_array_equal(np_of(p_gid), np.asarray(r_gid))
    assert int(p_num) == int(r_num)


def test_fast_path_64_bits_is_exercised():
    """The 'fast_64_exact' case really packs 64 bits, so its padding rows
    carry the sign bit that the port flips before its signed sort."""
    _, n = CASES["fast_64_exact"]
    rng = np.random.default_rng(0)
    _, p_ops = _operands(rng, n, n - 5, ["f32", "int16"])
    total = sum(w for _, w in (keys._ordered_unsigned(o) for o in p_ops))
    assert total + compact.index_bits(n) == 64


def test_pack_operands_and_ordered_unsigned_match_reference():
    rng = np.random.default_rng(3)
    n = 777
    r_ops, p_ops = _operands(rng, n, n - 17,
                             ["f32", "int64", "uint8", "int16", "f64"])
    for pw, rw in zip(keys.pack_operands(p_ops),
                      _ref_words(rkeys.pack_operands(r_ops))):
        np.testing.assert_array_equal(np_of(pw), rw)
    for po, ro in zip(p_ops, r_ops):
        p_bits, pw = keys._ordered_unsigned(po)
        r_bits, rw = rkeys._ordered_unsigned(ro)
        assert pw == rw
        np.testing.assert_array_equal(np_of(p_bits),
                                      _ref_words([r_bits])[0])


def test_descending_operands_match_reference():
    rng = np.random.default_rng(5)
    n = 500
    vals = [rng.integers(-9, 9, n).astype(np.int32),
            _floats(rng, n, np.float32)]
    valid = [rng.random(n) > 0.1, rng.random(n) > 0.1]
    rc, pc = columns(vals, valid)
    r_ops = rkeys.build_operands(list(rc), jnp.int32(n), n,
                                 ascending=[False, True], nulls_first=False)
    p_ops = keys.build_operands(list(pc), torch.tensor(n), n,
                                ascending=[False, True], nulls_first=False)
    r_perm, _ = rkeys.lexsort_indices(r_ops, n)
    p_perm, _ = keys.lexsort_indices(p_ops, n)
    np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))


@pytest.mark.parametrize("mode", ["scatter", "sort"])
def test_compaction_matches_both_reference_realizations(mode, monkeypatch):
    """The port's scatter realization against each of the reference's:
    scatter (bit-identical everywhere) and sort (identical wherever the
    contract defines the output: the first new_count entries)."""
    monkeypatch.setenv("CYLON_TPU_PERMUTE", mode)
    rng = np.random.default_rng(11)
    for n in (1, 2, 130, 4099):
        mask = rng.random(n) < 0.4
        r_idx, r_cnt = rcompact.compact_indices(jnp.asarray(mask))
        p_idx, p_cnt = compact.compact_indices(torch.from_numpy(mask))
        k = int(r_cnt)
        assert int(p_cnt) == k and p_cnt.dtype == torch.int32
        np.testing.assert_array_equal(np_of(p_idx)[:k], np.asarray(r_idx)[:k])
        if mode == "scatter":
            np.testing.assert_array_equal(np_of(p_idx), np.asarray(r_idx))

        r_perm, r_nt = rcompact.partition_indices(jnp.asarray(mask))
        p_perm, p_nt = compact.partition_indices(torch.from_numpy(mask))
        assert int(p_nt) == int(r_nt)
        np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))

        perm = rng.permutation(n).astype(np.int32)
        f1 = rng.integers(0, 100, n).astype(np.int32)
        f2 = rng.random(n).astype(np.float32)
        r_out = rcompact.inverse_permute(jnp.asarray(perm), jnp.asarray(f1),
                                         jnp.asarray(f2))
        p_out = compact.inverse_permute(torch.from_numpy(perm),
                                        torch.from_numpy(f1),
                                        torch.from_numpy(f2))
        for p, r in zip(p_out, r_out):
            np.testing.assert_array_equal(np_of(p), np.asarray(r))


def test_index_width_and_live_mask():
    assert compact.index_bits(1) == rcompact.index_bits(1)
    for cap in (2, 3, 1 << 20, (1 << 31) + 5):
        assert compact.index_bits(cap) == rcompact.index_bits(cap)
    assert compact.idx_dtype(1 << 20) == torch.int32
    assert compact.idx_dtype((1 << 31) + 5) == torch.int64  # past 2^31 rows
    np.testing.assert_array_equal(
        np_of(compact.live_mask(10, torch.tensor(4), "cpu")),
        np.asarray(rcompact.live_mask(10, jnp.int32(4))))
