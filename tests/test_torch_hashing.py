"""The port's row hash (``ops/hashing.py``) and hash placement of string
keys against the JAX package, bit for bit, on the same numpy inputs.

- ``hash_column`` for every fixed-width dtype, strings of several widths,
  nulls and an all-null column; ``hash_columns`` over mixed key sets.
- ``parallel/partition.hash_targets`` on string and mixed key sets, slot
  for slot against the UNPATCHED reference: the reference hashes every key
  set holding a string with its jnp hash on every device, and so does the
  port, so no murmur3 patch is involved.  Fixed-width key sets still take
  the murmur3 kernel's placement (its plain version here).

The port folds float keys before hashing (-0.0 as +0.0, one NaN) and the
reference does not, so the reference side hashes the folded columns
(``torch_parity.folded_floats``); the inputs keep their -0.0 rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu import column as rcol
from cylon_tpu.ops import hashing as rhashing
from cylon_tpu.parallel import partition as rpartition
from cylon_tpu_torch.ops import hash_kernels, hashing
from cylon_tpu_torch.parallel import partition

from .torch_parity import folded_floats, port_column

DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
          np.uint32, np.uint64, np.float16, np.float32, np.float64, np.bool_)
WORDS = np.array(["", "a", "Customer#000000001", "Customer#000000002",
                  "été", "x" * 40, "a\x00b", "zz"], object)


def _fixed(rng, dtype, n=97):
    if dtype == np.bool_:
        v = rng.random(n) > 0.5
    elif np.dtype(dtype).kind == "f":
        v = (rng.standard_normal(n) * 1e3).astype(dtype)
        v[:3] = [0.0, -0.0, np.inf]
    else:
        info = np.iinfo(dtype)
        v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    return rcol.from_numpy(v, validity=rng.random(n) > 0.15, capacity=n + 7)


def _strings(rng, n=97):
    s = WORDS[rng.integers(0, len(WORDS), n)]
    s[rng.random(n) < 0.15] = None
    return rcol.from_numpy(s, capacity=n + 7)


def _ref_hash(ref_cols):
    return np.asarray(rhashing.hash_columns(ref_cols)).astype(np.int64)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash_column_fixed_width_bit_for_bit(dtype):
    ref = _fixed(np.random.default_rng(1), dtype)
    got = hashing.hash_column(port_column(ref)).numpy()
    want = np.asarray(rhashing.hash_column(folded_floats(ref))).astype(
        np.int64)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < (1 << 32)
    if np.dtype(dtype).kind == "f":
        # rows 0 and 1 hold +0.0 and -0.0: equal keys, one hash
        zeros = port_column(rcol.from_numpy(np.array([0.0, -0.0], dtype)))
        h = hashing.hash_column(zeros).numpy()
        assert h[0] == h[1]


@pytest.mark.parametrize("case", ["default_width", "width_1", "wide",
                                  "all_null"])
def test_hash_column_strings_bit_for_bit(case):
    rng = np.random.default_rng(2)
    if case == "all_null":
        ref = rcol.from_numpy(np.array([None] * 9, object))
    elif case == "width_1":
        ref = rcol.from_native_buffers(
            np.frombuffer(b"ANRANRNNA", np.uint8).reshape(9, 1), None,
            np.ones(9, np.int32))
    elif case == "wide":
        ref = rcol.from_numpy(WORDS, string_width=61)
    else:
        ref = _strings(rng)
    got = hashing.hash_column(port_column(ref)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(rhashing.hash_column(ref)).astype(np.int64))
    if case == "all_null":
        assert (got == hashing.NULL_HASH).all()


def test_hash_columns_mixed_bit_for_bit():
    rng = np.random.default_rng(3)
    ref = [_strings(rng), _fixed(rng, np.int32), _fixed(rng, np.float64),
           _strings(rng), _fixed(rng, np.bool_)]
    port = [port_column(c) for c in ref]
    for k in range(1, len(ref) + 1):
        np.testing.assert_array_equal(
            hashing.hash_columns(port[:k]).numpy(),
            _ref_hash([folded_floats(c) for c in ref[:k]]))


@pytest.mark.parametrize("world", [1, 3, 4, 8])
@pytest.mark.parametrize("keys", ["string", "string+int", "int+string+float"])
def test_hash_targets_string_keys_match_unpatched_reference(world, keys):
    rng = np.random.default_rng(4)
    cols = {"string": _strings(rng), "int": _fixed(rng, np.int64),
            "float": _fixed(rng, np.float32)}
    ref = [cols[k] for k in keys.split("+")]
    port = [port_column(c) for c in ref]
    count = 90  # rows past it are padding: target ``world``
    key_idx = tuple(range(len(ref)))
    want = np.asarray(rpartition.hash_targets(
        tuple(folded_floats(c) for c in ref), jnp.int32(count), key_idx,
        world))
    hash_kernels.reset_launches()
    got = partition.hash_targets(port, torch.tensor(count, dtype=torch.int32),
                                 key_idx, world)
    np.testing.assert_array_equal(got.numpy(), want)  # slot for slot
    assert (got.numpy()[count:] == world).all()
    assert hash_kernels.LAUNCHES == {"hash_partition": 0}


def test_fixed_width_keys_keep_the_murmur3_placement():
    rng = np.random.default_rng(5)
    port = [port_column(_fixed(rng, np.int32)),
            port_column(_fixed(rng, np.float64))]
    got = partition.hash_targets(port, torch.tensor(97, dtype=torch.int32),
                                 (0, 1), 4)
    _, want = hash_kernels.hash_partition_plain(port, 4)
    np.testing.assert_array_equal(got.numpy()[:97], want.numpy()[:97])
