"""Columns: cylon_tpu_torch.column / interop against cylon_tpu.column on the
same numpy inputs.  Everything here is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu import column as rcol
from cylon_tpu_torch import column, dtypes, interop

from .torch_parity import np_of, port_column


@pytest.mark.parametrize("kind", ["int32", "int64", "float32", "float64",
                                  "bool", "uint8", "datetime"])
def test_from_numpy_and_to_numpy_match_reference(kind):
    rng = np.random.default_rng(3)
    n = 37
    if kind == "datetime":
        x = (np.datetime64("2026-01-01") + rng.integers(0, 1000, n)
             .astype("timedelta64[D]")).astype("datetime64[us]")
        x[3] = np.datetime64("NaT")
    elif kind.startswith("float"):
        x = rng.random(n).astype(kind)
        x[[2, 9]] = np.nan  # NaN ingests as null
    else:
        x = rng.integers(0, 100, n).astype(kind)
    validity = None if kind in ("datetime", "float32", "float64") \
        else rng.random(n) > 0.2
    r = rcol.from_numpy(x, validity=validity, capacity=50)
    p = column.from_numpy(x, validity=validity, capacity=50, device="cpu")
    assert p.capacity == r.capacity == 50
    assert int(p.dtype.type) == int(r.dtype.type)
    np.testing.assert_array_equal(np_of(p.data), np.asarray(r.data))
    np.testing.assert_array_equal(np_of(p.validity), np.asarray(r.validity))
    got, exp = column.to_numpy(p, n), rcol.to_numpy(r, n)
    assert got.dtype == exp.dtype
    assert [v is None for v in got] == [v is None for v in exp]
    np.testing.assert_array_equal(got[[v is not None for v in exp]],
                                  exp[[v is not None for v in exp]])


def test_take_clamps_and_null_fills_like_reference():
    rng = np.random.default_rng(5)
    x = rng.integers(-50, 50, 20).astype(np.int32)
    r = rcol.from_numpy(x, validity=rng.random(20) > 0.3, capacity=24)
    p = port_column(r)
    idx = np.array([0, 5, -3, 23, 40, 7], np.int32)  # out of range both ways
    mask = np.array([True, False, True, True, True, False])
    for valid_mask in (None, mask):
        rt = r.take(jnp.asarray(idx), None if valid_mask is None
                    else jnp.asarray(valid_mask))
        pt = p.take(torch.from_numpy(idx), None if valid_mask is None
                    else torch.from_numpy(valid_mask))
        np.testing.assert_array_equal(np_of(pt.data), np.asarray(rt.data))
        np.testing.assert_array_equal(np_of(pt.validity),
                                      np.asarray(rt.validity))


def test_interop_round_trip_keeps_buffers_bit_for_bit():
    x = np.array([1.5, -0.0, np.nan, 4.0], np.float32)
    r = rcol.from_numpy(x, validity=np.array([True, True, True, False]))
    p = port_column(r)
    data, valid, lengths, dt = interop.column_to_arrays(p)
    assert lengths is None and dt == dtypes.float_
    np.testing.assert_array_equal(data.view(np.int32),
                                  np.asarray(r.data).view(np.int32))
    np.testing.assert_array_equal(valid, np.asarray(r.validity))
    s = rcol.from_numpy(np.array(["ab", None, "xyz\x00"], object),
                        capacity=4)
    data, valid, lengths, dt = interop.column_to_arrays(port_column(s))
    assert dt == dtypes.string and data.shape == (4, 32)
    for got, want in ((data, s.data), (valid, s.validity),
                      (lengths, s.lengths)):
        np.testing.assert_array_equal(got, np.asarray(want))
