"""Shared harness for the PyTorch port's parity tests: the same numpy
inputs go through the JAX package (on the CPU, Pallas in interpret mode)
and through ``cylon_tpu_torch`` on the CPU."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from cylon_tpu import column as rcol
from cylon_tpu import precision as rprec
from cylon_tpu.ops import segments as rseg
from cylon_tpu_torch import interop
from cylon_tpu_torch import precision as pprec


@contextlib.contextmanager
def modes(mode: str):
    """Both packages in ``mode`` ("wide" | "narrow").  Narrow puts the
    reference's scans on its Pallas kernels (``set_segsum("pallas")``,
    ``set_scan("pallas")``), the path the port's scan kernels replace."""
    try:
        rprec.set_accumulation(mode)
        pprec.set_accumulation(mode)
        if mode == "narrow":
            rseg.set_segsum("pallas")
            rseg.set_scan("pallas")
        yield
    finally:
        rprec.set_accumulation(None)
        pprec.set_accumulation(None)
        rseg.set_segsum(None)
        rseg.set_scan(None)


def ref_column(values, validity=None, capacity=None):
    return rcol.from_numpy(np.asarray(values), validity=validity,
                           capacity=capacity)


def port_column(ref):
    """The port's Column holding exactly a reference Column's buffers."""
    return interop.column_from_arrays(np.asarray(ref.data),
                                      np.asarray(ref.validity), None,
                                      ref.dtype, device="cpu")


def columns(values_list, validity_list=None, capacity=None):
    """(reference columns, port columns) built from the same arrays."""
    validity_list = validity_list or [None] * len(values_list)
    ref = tuple(ref_column(v, m, capacity)
                for v, m in zip(values_list, validity_list))
    return ref, tuple(port_column(c) for c in ref)


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_columns_equal(port_cols, ref_cols, float_rtol=None):
    """Data and validity over the whole capacity: exact, or within
    ``float_rtol`` for float data."""
    assert len(port_cols) == len(ref_cols)
    for p, r in zip(port_cols, ref_cols):
        np.testing.assert_array_equal(np_of(p.validity), np_of(r.validity))
        assert p.dtype.type == int(r.dtype.type)
        pd_, rd = np_of(p.data), np_of(r.data)
        assert pd_.dtype == rd.dtype, (pd_.dtype, rd.dtype)
        if float_rtol is not None and rd.dtype.kind == "f":
            np.testing.assert_allclose(pd_, rd, rtol=float_rtol)
        else:
            np.testing.assert_array_equal(pd_, rd)
