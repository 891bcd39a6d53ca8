"""Short string keys as narrow sort fields: ``keys.build_operands`` turns
a string key of at most 4 bytes a row into one narrow operand, so that a
key of CHAR(1) columns fits the one-sort fast path of
``keys.lexsort_indices``.  Against the JAX package on the same byte
matrices, at widths on both sides of the cut (1-4 narrow, 5 and 8 in
64-bit words): ``sort_rows``, ``hash_groupby`` and ``unique`` give
exactly the reference's outputs over the whole capacity, and the lexsort
over ``build_operands`` gives the reference's permutation, ascending and
descending, nulls first and last.  The bytes hold nulls, NULs, bytes at
and above 0x80, zero padding past each row's length, and padding rows
past the live count.  ``keys.SORTS`` counts the sorts by path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cylon_tpu import column as rcol
from cylon_tpu import dtypes as rdtypes
from cylon_tpu.ops import groupby as rgroupby
from cylon_tpu.ops import keys as rkeys
from cylon_tpu.ops import sort as rsort
from cylon_tpu.ops import unique as runique
from cylon_tpu_torch.ops import groupby, keys, sort, unique

from .torch_parity import (assert_columns_equal, columns, np_of,
                           port_column)

WIDTHS = [1, 2, 3, 4, 5, 8]
CAP = 600
COUNT = CAP - 37  # padding rows past the live count
# NUL, low bytes, the signed byte boundary 0x7F / 0x80 and 0xFF
ALPHABET = np.array([0x00, 0x01, 0x41, 0x61, 0x7F, 0x80, 0xC3, 0xFF],
                    np.uint8)


def _string_column(rng, width):
    """(reference Column, port Column) of a uint8[CAP, width] byte matrix:
    rows of random length over ``ALPHABET``, zero past the length, about
    15% null (zero bytes, length 0), padding rows left as drawn."""
    mat = ALPHABET[rng.integers(0, len(ALPHABET), (CAP, width))]
    lens = rng.integers(0, width + 1, CAP).astype(np.int32)
    mat[np.arange(width)[None, :] >= lens[:, None]] = 0
    valid = rng.random(CAP) > 0.15
    live_null = ~valid & (np.arange(CAP) < COUNT)
    mat[live_null] = 0
    lens[live_null] = 0
    ref = rcol.Column(jnp.asarray(mat), jnp.asarray(valid),
                      jnp.asarray(lens), rdtypes.string)
    return ref, port_column(ref)


def _table(width, seed):
    """Two string keys (``width`` bytes, then CHAR(1)) and an int32
    value column: (reference columns, port columns)."""
    rng = np.random.default_rng(seed)
    r0, p0 = _string_column(rng, width)
    r1, p1 = _string_column(rng, 1)
    (rv,), (pv,) = columns([rng.integers(-1000, 1000, CAP).astype(np.int32)],
                           [rng.random(CAP) > 0.1])
    return (r0, r1, rv), (p0, p1, pv)


def _sorts():
    return dict(keys.SORTS)


def _delta(before):
    return {k: keys.SORTS[k] - before[k] for k in before}


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_lexsort_permutation_matches_reference(width, asc, nulls_first):
    rc, pc = _table(width, 10 * width + 2 * asc + nulls_first)
    kw = dict(ascending=[asc, not asc], nulls_first=nulls_first)
    r_ops = rkeys.build_operands(list(rc[:2]), jnp.int32(COUNT), CAP, **kw)
    p_ops = keys.build_operands(list(pc[:2]), torch.tensor(COUNT), CAP, **kw)
    if width <= 4:  # one narrow operand a short string, not 64-bit words
        assert len(p_ops) == 5 and len(r_ops) == 1 + 2 * 2
        assert p_ops[2].dtype.itemsize == {1: 1, 2: 2}.get(width, 4)
    r_perm, r_words = rkeys.lexsort_indices(r_ops, CAP)
    p_perm, p_words = keys.lexsort_indices(p_ops, CAP)
    np.testing.assert_array_equal(np_of(p_perm), np.asarray(r_perm))
    np.testing.assert_array_equal(
        np_of(keys.rows_equal_adjacent(p_words)),
        np.asarray(rkeys.rows_equal_adjacent(r_words)))


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("asc", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_sort_rows_matches_reference(width, asc, nulls_first):
    rc, pc = _table(width, 100 + 10 * width + 2 * asc + nulls_first)
    kw = dict(ascending=[asc, True], nulls_first=nulls_first)
    r_out, r_n = rsort.sort_rows(rc, jnp.int32(COUNT), (0, 1), **kw)
    p_out, p_n = sort.sort_rows(pc, torch.tensor(COUNT), (0, 1), **kw)
    assert int(p_n) == int(r_n) == COUNT
    assert_columns_equal(p_out, r_out)


@pytest.mark.parametrize("width", WIDTHS)
def test_hash_groupby_matches_reference(width):
    rc, pc = _table(width, 200 + width)
    ops = ("SUM", "COUNT", "MIN", "MAX")
    r_out, r_g = rgroupby.hash_groupby(
        rc, jnp.int32(COUNT), (0, 1),
        tuple((2, rgroupby.AggOp[o]) for o in ops))
    p_out, p_g = groupby.hash_groupby(
        pc, torch.tensor(COUNT), (0, 1),
        tuple((2, groupby.AggOp[o]) for o in ops))
    assert int(p_g) == int(r_g) > 1
    assert_columns_equal(p_out, r_out)


@pytest.mark.parametrize("keep", ["first", "last"])
@pytest.mark.parametrize("width", WIDTHS)
def test_unique_matches_reference(width, keep):
    rc, pc = _table(width, 300 + width)
    r_out, r_m = runique.unique(rc, jnp.int32(COUNT), (0,), keep=keep)
    p_out, p_m = unique.unique(pc, torch.tensor(COUNT), (0,), keep=keep)
    assert int(p_m) == int(r_m)
    assert_columns_equal(p_out, r_out)


def test_two_char1_keys_take_one_packed_sort():
    """Q1's key: two CHAR(1) columns are 19 bits, so with the row index
    one int64 sort, and no word sorts."""
    _, pc = _table(1, 400)
    before = _sorts()
    groupby.hash_groupby(pc, torch.tensor(COUNT), (0, 1),
                         ((2, groupby.AggOp.SUM),))
    assert _delta(before) == {"packed": 1, "words": 0}


@pytest.mark.parametrize("width", [5, 8])
def test_a_string_past_4_bytes_keeps_its_words(width):
    """A 5- or 8-byte key is one 64-bit word: with its padding and
    validity flags, two words sorted one after the other."""
    _, pc = _table(width, 500 + width)
    ops = keys.build_operands([pc[0]], torch.tensor(COUNT), CAP)
    assert ops[-1].dtype == torch.uint64
    before = _sorts()
    keys.lexsort_indices(ops, CAP)
    assert _delta(before) == {"packed": 0, "words": 2}
