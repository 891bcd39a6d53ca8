"""The port's murmur3 hash partition (``ops/hash_kernels.py``, plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode (``cylon_tpu/ops/pallas_kernels.py``) and the native host hasher, on
the same numpy inputs.

Tolerance: none.  Hashes and targets are integers and must be bit-exact."""
import numpy as np
import pytest

from cylon_tpu import native
from cylon_tpu.ops import pallas_kernels
from cylon_tpu_torch import column
from cylon_tpu_torch.ops import hash_kernels
from cylon_tpu_torch.status import CylonError

from .torch_parity import columns

DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32,
          np.float64, np.bool_)
# 40,000 rows pass one reference grid block (256 x 128 rows)
SIZES = (1, 127, 1025, 40_000)
WORLDS = (4, 8, 3, 6)  # mask, mask, modulo, modulo


def _values(rng, dtype, n):
    if dtype == np.bool_:
        return rng.random(n) > 0.5
    if dtype in (np.float32, np.float64):
        return (rng.standard_normal(n) * 1e6).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _both(ref_cols, port_cols, world):
    rh, rt = pallas_kernels.hash_partition(list(ref_cols), world,
                                           interpret=True)
    ph, pt = hash_kernels.hash_partition(list(port_cols), world)
    return (np.asarray(rh), np.asarray(rt)), (ph.numpy(), pt.numpy())


def _assert_same(ref, port):
    (rh, rt), (ph, pt) = ref, port
    assert ph.dtype == np.uint32 and pt.dtype == np.int32
    np.testing.assert_array_equal(ph, rh)  # exact
    np.testing.assert_array_equal(pt, rt)  # exact


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_single_column_hash_matches_pallas(dtype, n):
    rng = np.random.default_rng(n)
    vals = _values(rng, dtype, n)
    valid = rng.random(n) > 0.2  # null rows hash as zero words
    ref, port = columns([vals], [valid], capacity=n + 5)
    for world in WORLDS:
        _assert_same(*_both(ref, port, world))


@pytest.mark.parametrize("n", (127, 40_000))
def test_multi_column_hash_matches_pallas(n):
    rng = np.random.default_rng(17)
    vals = [_values(rng, d, n) for d in (np.int32, np.float64, np.bool_,
                                         np.int16, np.uint32)]
    valid = [rng.random(n) > 0.1 for _ in vals]
    ref, port = columns(vals, valid)
    for k in (2, 5):
        for world in WORLDS:
            _assert_same(*_both(ref[:k], port[:k], world))


@pytest.mark.skipif(not native.available(), reason="native hasher not built")
def test_hash_matches_native_row_hash():
    rng = np.random.default_rng(23)
    n = 1025
    vals = [_values(rng, np.int32, n), _values(rng, np.float64, n),
            _values(rng, np.int64, n)]
    _, port = columns(vals)
    h, t = hash_kernels.hash_partition(list(port), 6)
    expect = native.row_hash(vals)
    np.testing.assert_array_equal(h.numpy()[:n], expect)  # exact
    np.testing.assert_array_equal(t.numpy()[:n], expect % 6)


def test_column_words_views_and_zero_extension():
    c32 = column.from_numpy(np.array([-1, 7], np.int32), device="cpu")
    (w,) = hash_kernels.column_words(c32)
    assert w.data_ptr() == c32.data.data_ptr()  # a view, no copy
    c64 = column.from_numpy(np.array([-2, 1 << 40], np.int64), device="cpu")
    lo, hi = hash_kernels.column_words(c64)
    assert lo.data_ptr() == c64.data.data_ptr()
    np.testing.assert_array_equal(lo.numpy()[:2].view(np.uint32),
                                  [0xFFFFFFFE, 0])
    np.testing.assert_array_equal(hi.numpy()[:2].view(np.uint32),
                                  [0xFFFFFFFF, 1 << 8])
    c8 = column.from_numpy(np.array([-1, 3], np.int8), device="cpu")
    np.testing.assert_array_equal(hash_kernels.column_words(c8)[0][:2],
                                  [255, 3])  # zero-, not sign-extended
    c16 = column.from_numpy(np.array([-1, 3], np.int16), device="cpu")
    np.testing.assert_array_equal(hash_kernels.column_words(c16)[0][:2],
                                  [0xFFFF, 3])


def test_wrapper_validates_and_counts_no_cpu_launch():
    col = column.from_numpy(np.arange(10, dtype=np.int32), device="cpu")
    hash_kernels.reset_launches()
    h, t = hash_kernels.hash_partition([col], 4)
    assert h.shape == t.shape == (10,)
    assert hash_kernels.LAUNCHES == {"hash_partition": 0}  # CPU: plain
    with pytest.raises(ValueError, match="world must be"):
        hash_kernels.hash_partition([col], 0)
    with pytest.raises(ValueError, match="at least one"):
        hash_kernels.hash_partition([], 4)
    meta = column.Column(col.data.to("meta"), col.validity.to("meta"), None,
                         col.dtype)
    with pytest.raises(ValueError, match="unsupported device"):
        hash_kernels.hash_partition([meta], 4)
    short = column.from_numpy(np.arange(3, dtype=np.int32), device="cpu")
    with pytest.raises(ValueError, match="one capacity"):
        hash_kernels.hash_partition([col, short], 4)
    empty = column.from_numpy(np.zeros(0, np.int32), capacity=0,
                              device="cpu")
    h, t = hash_kernels.hash_partition([empty], 4)
    assert h.shape == t.shape == (0,)
    string = column.Column(col.data, col.validity, None,
                           column.dtypes.DataType(column.dtypes.Type.STRING))
    with pytest.raises(CylonError, match="NotImplemented"):
        hash_kernels.hash_partition([string], 4)
