"""Shared harness for the PyTorch port's parity tests: the same numpy
inputs go through the JAX package (on the CPU, Pallas in interpret mode)
and through ``cylon_tpu_torch`` on the CPU."""
from __future__ import annotations

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from cylon_tpu import column as rcol
from cylon_tpu import precision as rprec
from cylon_tpu.ops import compact as rcompact
from cylon_tpu.ops import pallas_kernels
from cylon_tpu.ops import segments as rseg
from cylon_tpu.parallel import partition as rpartition
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
    """The port's Column holding exactly a reference Column's buffers (a
    string's byte matrix and lengths included)."""
    return interop.column_from_arrays(
        np.asarray(ref.data), np.asarray(ref.validity),
        None if ref.lengths is None else np.asarray(ref.lengths), ref.dtype,
        device="cpu")


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
    """Data, validity and string lengths over the whole capacity: exact,
    or within ``float_rtol`` for float data."""
    assert len(port_cols) == len(ref_cols)
    for p, r in zip(port_cols, ref_cols):
        np.testing.assert_array_equal(np_of(p.validity), np_of(r.validity))
        assert (p.lengths is None) == (r.lengths is None)
        if r.lengths is not None:
            np.testing.assert_array_equal(np_of(p.lengths), np_of(r.lengths))
        assert p.dtype.type == int(r.dtype.type)
        pd_, rd = np_of(p.data), np_of(r.data)
        assert pd_.dtype == rd.dtype, (pd_.dtype, rd.dtype)
        if float_rtol is not None and rd.dtype.kind == "f":
            np.testing.assert_allclose(pd_, rd, rtol=float_rtol)
        else:
            np.testing.assert_array_equal(pd_, rd)


def folded_floats(col):
    """A reference Column whose float data has -0.0 folded into +0.0 and
    every NaN payload into the one NaN ``float("nan")`` gives, as the port
    folds float keys before hashing them (``keys.canonical_float``); any
    other column as it is.  The JAX package hashes raw bits, so it splits
    equal float keys across shards; the port places a key as the
    reference places its folded form."""
    data = col.data
    if not jnp.issubdtype(data.dtype, jnp.floating):
        return col
    data = jnp.where(data == 0, jnp.zeros((), data.dtype), data)
    data = jnp.where(jnp.isnan(data), jnp.array(jnp.nan, data.dtype), data)
    return dataclasses.replace(col, data=data)


def _murmur3_hash_targets(cols, count, key_idx, world):
    """The TPU branch of ``cylon_tpu/parallel/partition.py:50-59
    hash_targets``: the Pallas murmur3 kernel (interpret mode here) over
    the key columns with float keys folded (``folded_floats``, as the
    port's kernel folds them), then padding rows set to ``world``."""
    _, t = pallas_kernels.hash_partition(
        [folded_floats(cols[i]) for i in key_idx], world, interpret=True)
    live = rcompact.live_mask(cols[0].data.shape[0], count)
    return jnp.where(live, t, jnp.int32(world))


@contextlib.contextmanager
def murmur3_reference(world: int):
    """A FRESH reference context of ``world`` shards whose
    ``hash_targets`` takes its TPU (murmur3) branch over folded float keys,
    as the port does on every device; restored on exit.

    On the CPU the reference places rows with its jnp hash, so only under
    this patch do its shards hold the port's rows.  The context must be
    new: the reference caches shard programs per context, keyed by op and
    shapes but not by the hash function, so a shared context (the
    ``ctx4`` fixture of ``tests/conftest.py``) could serve a program
    traced with the jnp hash."""
    from cylon_tpu.context import CylonContext, TPUConfig

    orig = rpartition.hash_targets
    rpartition.hash_targets = _murmur3_hash_targets
    try:
        yield CylonContext.InitDistributed(TPUConfig(world_size=world))
    finally:
        rpartition.hash_targets = orig


def ref_table_shards(t):
    """(per shard the (data, validity) of every column, per-shard row
    counts) of a reference Table, on the host: the layout
    ``interop.table_shards_to_arrays`` gives for the port's."""
    from cylon_tpu.table import _host_row_counts, _host_shard_pieces

    cap = t.shard_capacity
    pieces = [(_host_shard_pieces(c.data, cap),
               _host_shard_pieces(c.validity, cap),
               None if c.lengths is None
               else _host_shard_pieces(c.lengths, cap)) for c in t.columns]
    shards = [[(d[s], v[s], None if ln is None else ln[s])
               for d, v, ln in pieces]
              for s in range(t.num_shards)]
    return shards, _host_row_counts(t)


def assert_shards_equal(port_table, ref_table):
    """Slot for slot: per-shard counts, capacity, data, validity and
    string lengths over the whole shard capacity (exact)."""
    names, p_shards, p_counts = interop.table_shards_to_arrays(port_table)
    r_shards, r_counts = ref_table_shards(ref_table)
    assert tuple(names) == tuple(ref_table.names)
    np.testing.assert_array_equal(p_counts, r_counts)
    assert len(p_shards) == len(r_shards)
    for p_cols, r_cols in zip(p_shards, r_shards):
        for (pd_, pv, pl, pdt), (rd, rv, rl), rc in zip(p_cols, r_cols,
                                                        ref_table.columns):
            assert int(pdt.type) == int(rc.dtype.type)
            np.testing.assert_array_equal(pv, rv)
            assert (pl is None) == (rl is None)
            if rl is not None:
                np.testing.assert_array_equal(pl, rl)
            assert pd_.dtype == rd.dtype, (pd_.dtype, rd.dtype)
            np.testing.assert_array_equal(pd_, rd)


def local_tables(names, values_list, validity_list=None, capacity=None,
                 ctx=None):
    """(reference Table, port Table): one shard each, holding the same
    columns (``columns``) and live-row count.  ``ctx`` is the reference's
    context (default: a new local one)."""
    from cylon_tpu.context import CylonContext as RContext
    from cylon_tpu.table import Table as RTable
    from cylon_tpu_torch import CylonContext, Table

    ref, port = columns(values_list, validity_list, capacity)
    n = len(values_list[0])
    rt = RTable.from_columns(dict(zip(names, ref)), n,
                             ctx=ctx or RContext.Init())
    pt = Table((tuple(port),), (torch.tensor(n, dtype=torch.int32),),
               tuple(names), CylonContext.Init("cpu"))
    return rt, pt


def port_table_of(rt):
    """The port's one-shard Table holding exactly a one-shard reference
    Table's buffers and count."""
    from cylon_tpu_torch import CylonContext, Table

    return Table((tuple(port_column(c) for c in rt.columns),),
                 (torch.tensor(int(rt.row_counts[0]), dtype=torch.int32),),
                 tuple(rt.names), CylonContext.Init("cpu"))


def assert_tables_equal(pt, rt, float_rtol=None):
    """One-shard tables: names, live-row count, and every column's data and
    validity over the whole capacity (``assert_columns_equal``)."""
    assert pt.num_shards == 1 and rt.num_shards == 1
    assert tuple(pt.names) == tuple(rt.names)
    assert int(pt.counts[0]) == int(rt.row_counts[0])
    assert_columns_equal(pt.shards[0], rt.columns, float_rtol)


def assert_frames_equal(got, want, float_rtol=None):
    """Host frames (dicts of numpy columns, as the chunked engines return
    them), row for row: the same names in the same order, the same dtypes,
    objects (strings, None nulls) equal, ints exact, floats within
    ``float_rtol`` (default: rtol 1e-5 for float32, 1e-12 for float64)
    with NaN where the reference has NaN."""
    assert list(got) == list(want), (list(got), list(want))
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if w.dtype == object:
            assert [None if v is None else v for v in g.tolist()] \
                == w.tolist(), name
        elif w.dtype.kind == "f":
            rtol = float_rtol or (1e-5 if w.dtype.itemsize <= 4 else 1e-12)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
