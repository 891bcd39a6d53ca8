"""The port's one ``keys.lexsort_indices`` (``torch.sort`` of the packed
key) against the JAX package's LSD radix realization.

Twins of the sort tests of ``tests/test_radix.py``.  Each case sets the
reference's ``CYLON_TPU_SORT=radix`` with its digit width
(``CYLON_TPU_RADIX_BITS``: 1, 2 or 4) and its cumsum
(``CYLON_TPU_RADIX_SCAN``: the matmul scan or ``xla``); the port reads
none of them.  The port's permutation and words must equal the
reference's exactly: the one-word and two-word branches, a key that
fills all 64 bits, ties, floats with negatives and NaNs, sizes off the
reference's scan block."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu import column as rcolmod
from cylon_tpu.config import JoinType as RJoinType
from cylon_tpu.ops import join as rjoin
from cylon_tpu.ops import keys as rkeys
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import join, keys

from .torch_parity import assert_columns_equal, np_of, port_column


def _operands(vals: np.ndarray, count: int, capacity: int):
    rcol = rcolmod.from_numpy(vals, capacity=capacity)
    pcol = port_column(rcol)
    return (rkeys.build_operands([rcol], jnp.int32(count), capacity),
            keys.build_operands([pcol], torch.tensor(count), capacity))


def _ab(ops, capacity, monkeypatch, bits="1", scan=None):
    """The reference under radix with ``bits``-bit digits and ``scan``;
    the port's permutation and words equal its.  Returns the port's
    permutation."""
    r_ops, p_ops = ops
    monkeypatch.setenv("CYLON_TPU_SORT", "radix")
    monkeypatch.setenv("CYLON_TPU_RADIX_BITS", bits)
    if scan is None:
        monkeypatch.delenv("CYLON_TPU_RADIX_SCAN", raising=False)
    else:
        monkeypatch.setenv("CYLON_TPU_RADIX_SCAN", scan)
    perm, words = keys.lexsort_indices(p_ops, capacity)
    r_perm, r_words = rkeys.lexsort_indices(r_ops, capacity)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(np_of(perm), np.asarray(r_perm))
    assert len(words) == len(r_words)
    for a, r in zip(words, r_words):
        np.testing.assert_array_equal(np_of(a), np.asarray(r))
    return perm


@pytest.mark.parametrize("bits", ["1", "2", "4"])
def test_radix_matches_cmp_64bit_branch(monkeypatch, bits):
    # padding(1) + validity(1) + i32 key(32) + idx -> the two-word branch
    rng = np.random.default_rng(7)
    cap, count = 1 << 12, (1 << 12) - 37
    vals = rng.integers(-(1 << 30), 1 << 30, cap).astype(np.int32)
    ops = _operands(vals, count, cap)
    assert sum(keys._ordered_unsigned(o)[1] for o in ops[1]) + 12 > 32
    _ab(ops, cap, monkeypatch, bits=bits)


@pytest.mark.parametrize("scan", ["matmul", "xla"])
def test_radix_matches_cmp_32bit_branch(monkeypatch, scan):
    # padding(1) + validity(1) + u8 key(8) + idx(<=22) -> one word
    rng = np.random.default_rng(8)
    cap, count = 1 << 10, 900
    vals = rng.integers(0, 256, cap).astype(np.uint8)
    ops = _operands(vals, count, cap)
    total = sum(keys._ordered_unsigned(o)[1] for o in ops[1])
    assert total + 10 <= 32
    _ab(ops, cap, monkeypatch, scan=(None if scan == "matmul" else "xla"))


@pytest.mark.parametrize("bits", ["1", "4"])
def test_radix_key_filling_all_64_bits(monkeypatch, bits):
    """i32 + i16 + i8 fields and 8 index bits: exactly 64 bits, so the
    port flips the sign bit where the reference's radix path reads bit 63
    as an unsigned digit."""
    rng = np.random.default_rng(5)
    cap = 256
    arrays = [rng.integers(-(1 << 31), 1 << 31, cap).astype(np.int32),
              rng.integers(-(1 << 15), 1 << 15, cap).astype(np.int16),
              rng.integers(-128, 128, cap).astype(np.int8)]
    arrays[0][:40] = arrays[0][40:80]  # ties on the leading field
    r_ops = [jnp.asarray(a) for a in arrays]
    p_ops = [torch.from_numpy(a) for a in arrays]
    assert sum(keys._ordered_unsigned(o)[1] for o in p_ops) + 8 == 64
    perm = _ab((r_ops, p_ops), cap, monkeypatch, bits=bits)
    want = np.lexsort(tuple(reversed(arrays)), axis=0)
    np.testing.assert_array_equal(np_of(perm), want)


def test_radix_stability_ties(monkeypatch):
    # heavy duplicates: the tie-break must be the embedded index order
    rng = np.random.default_rng(9)
    cap, count = 1 << 11, (1 << 11) - 5
    vals = rng.integers(0, 7, cap).astype(np.int32)
    perm = _ab(_operands(vals, count, cap), cap, monkeypatch)
    p = np_of(perm)[:count]
    v = vals[p]
    assert (np.diff(v) >= 0).all()
    for val in range(7):
        assert (np.diff(p[v == val]) > 0).all()  # stable within a key


def test_radix_floats_negatives_nans(monkeypatch):
    rng = np.random.default_rng(10)
    cap = 1 << 10
    vals = rng.standard_normal(cap).astype(np.float32)
    vals[::17] = np.nan
    vals[::13] = -0.0
    _ab(_operands(vals, cap, cap), cap, monkeypatch)


@pytest.mark.parametrize("scan", ["matmul", "xla"])
def test_radix_nonblock_sizes(monkeypatch, scan):
    # capacities off the reference's matmul scan block: its fallback cumsum
    rng = np.random.default_rng(11)
    for cap in (8, 100, 257, 1000, 1280):
        vals = rng.integers(0, 50, cap).astype(np.int32)
        _ab(_operands(vals, cap, cap), cap, monkeypatch,
            scan=(None if scan == "matmul" else "xla"))


def test_join_level_radix_agreement(monkeypatch):
    """Join -> gather: the port's rows equal the reference's slot for
    slot under each of its sorts, cmp and radix."""
    rng = np.random.default_rng(13)
    cap = 1 << 10
    rl = (rcolmod.from_numpy(rng.integers(0, 300, cap).astype(np.int32)),)
    rr = (rcolmod.from_numpy(rng.integers(0, 300, cap).astype(np.int32)),)
    pl = tuple(port_column(c) for c in rl)
    pr = tuple(port_column(c) for c in rr)
    for mode in ("cmp", "radix"):
        monkeypatch.setenv("CYLON_TPU_SORT", mode)
        jax.clear_caches()
        m = int(join.join_row_count(pl, torch.tensor(cap), pr,
                                    torch.tensor(cap), (0,), (0,),
                                    JoinType.INNER))
        out, n = join.join_gather(pl, torch.tensor(cap), pr,
                                  torch.tensor(cap), (0,), (0,),
                                  JoinType.INNER, 1 << 14, "sort")
        r_out, r_n = rjoin.join_gather(rl, jnp.int32(cap), rr, jnp.int32(cap),
                                       (0,), (0,), RJoinType.INNER, 1 << 14,
                                       "sort")
        assert int(n) == int(r_n) == m
        assert_columns_equal(out, r_out)
    jax.clear_caches()
