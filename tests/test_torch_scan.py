"""The scan family (cylon_tpu_torch.ops.scan): its plain PyTorch versions
against the JAX package's Pallas scans (cylon_tpu.ops.pallas_scan, in
interpret mode, 256-lane blocks) on the same inputs.  The CUDA kernels
are held against the plain versions on the card by test_torch_gpu.py.

Tolerances: exact for integers and for min/max; float32 sums rtol=1e-5,
the reference's own bound (tests/test_pallas_scan.py), because both sides
round in their own combine-tree order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu.ops import pallas_scan
from cylon_tpu_torch.ops import scan

SIZES = (1, 127, 129, 4096, 33000)
DTYPES = {"f32": np.float32, "i32": np.int32}


def _assert_match(got, exp, dt, op):
    got = got.numpy()
    assert got.dtype == exp.dtype
    if dt == np.float32 and op == "sum":
        np.testing.assert_allclose(got, exp, rtol=1e-5)  # float32 sum
    else:
        np.testing.assert_array_equal(got, exp)  # exact


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", scan.OPS)
def test_scan_1d_matches_pallas(op, dtype, reverse):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    for n in SIZES:
        x = (rng.random(n) * 1000 - 300).astype(dt)
        exp = np.asarray(pallas_scan.scan_1d(
            jnp.asarray(x), op, reverse=reverse, interpret=True,
            block_lanes=256))
        _assert_match(scan.scan_1d(torch.from_numpy(x), op, reverse), exp,
                      dt, op)


@pytest.mark.parametrize("dtype", sorted(DTYPES) + ["u32"])
@pytest.mark.parametrize("op", scan.OPS)
def test_segmented_scan_matches_pallas(op, dtype):
    dt = DTYPES.get(dtype, np.uint32)
    rng = np.random.default_rng(23)
    for n in SIZES:
        x = (rng.random(n) * 50).astype(dt)
        r = rng.random(n) < 0.02
        r[0] = True
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op)
        _assert_match(got, exp, dt, op)


@pytest.mark.parametrize("resets", ["none", "all"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_segmented_scan_no_resets_and_all_resets(resets, dtype):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(29)
    n = 5000
    x = (rng.random(n) * 10).astype(dt)
    r = np.full(n, resets == "all")
    for op in scan.OPS:
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op)
        _assert_match(got, exp, dt, op)
        if resets == "all":
            np.testing.assert_array_equal(got.numpy(), x)  # identity


def test_uint32_plain_versions_wrap_and_order_as_unsigned():
    x = np.array([4294967290, 3, 7, 4294967295, 1], np.uint32)
    r = np.array([True, False, True, False, False])
    got = scan.scan_1d(torch.from_numpy(x), "sum").numpy()
    np.testing.assert_array_equal(got, np.cumsum(x, dtype=np.uint32))
    got = scan.scan_1d(torch.from_numpy(x), "max", reverse=True).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(x[::-1])[::-1])
    got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                              "min").numpy()
    np.testing.assert_array_equal(got, [4294967290, 3, 7, 7, 1])


def test_float_min_max_propagate_nan_like_reference():
    x = np.array([3.0, np.nan, 1.0, 5.0, -2.0], np.float32)
    r = np.array([True, False, False, True, False])
    for op in ("min", "max"):
        exp = np.asarray(pallas_scan.segmented_scan(
            jnp.asarray(x), jnp.asarray(r), op, interpret=True,
            block_lanes=256))
        got = scan.segmented_scan(torch.from_numpy(x), torch.from_numpy(r),
                                  op).numpy()
        np.testing.assert_array_equal(got, exp)
