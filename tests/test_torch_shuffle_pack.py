"""The port's exchange plane (``parallel/plane.py``), its compression and
the exchange accounting, against the JAX package on the same inputs.

Counterparts of every test of ``tests/test_shuffle_pack.py`` and of the
shuffle-accounting cases of ``tests/test_obs.py:221-279``:

- planes compare with the reference's ``pack_plane`` bit for bit (the
  port's ``int32`` words viewed as ``uint32``), at caps 1, 7 and 256 and
  under a compression spec with the same dictionary codes; specs compare
  tuple for tuple;
- the port's per-buffer, packed and compressed shuffles give bit-identical
  shards (floats compared by their bits), and equal the reference's shards
  slot for slot under murmur3 placement (``torch_parity.murmur3_reference``;
  the reference's ``CYLON_TPU_PERMUTE`` realizations are both run, the
  port has one);
- collective launches are counted by wrapping ``collectives.all_to_all``
  and ``allgather`` (the reference inspects its jaxpr);
- ``shuffle.bytes_sent`` is checked against the exact-traffic formula:
  rows moved times ``_row_bytes``.

Every comparison is exact: bits, counts or specs."""
import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu import column as rcol
from cylon_tpu.parallel import ops as rops
from cylon_tpu.parallel import plane as rplane
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, config
from cylon_tpu_torch import exec as exec_mod
from cylon_tpu_torch import interop
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.parallel import collectives, partition
from cylon_tpu_torch.parallel import ops as par_ops
from cylon_tpu_torch.parallel import plane
from cylon_tpu_torch.parallel import shuffle as shuffle_mod
from cylon_tpu_torch.parallel.task import LogicalTaskPlan, task_shuffle

from .torch_parity import (assert_shards_equal, murmur3_reference, np_of,
                           port_column)

PACK_MODES = ("0", "1")
PERMUTE_MODES = ("scatter", "sort")
ARMS = {"perbuf": ("0", "0"), "packed": ("1", "0"), "comp": ("1", "1")}


@pytest.fixture(scope="module")
def meshes():
    return {w: (CylonContext.Init("cpu") if w == 1 else
                CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                        world_size=w)))
            for w in (1, 2, 4, 8)}


@pytest.fixture()
def clean_obs():
    obs_spans.reset()
    obs_metrics.reset()
    yield
    obs_spans.reset()
    obs_metrics.reset()


# -- plane round trip -------------------------------------------------------

def _mixed_columns(cap: int, rng) -> tuple:
    """One reference column of every physical layout: 64/32/16/8-bit ints,
    floats of all three widths (with NaN / -0.0 payloads), bool, strings
    with nulls and empty values."""
    f32 = rng.random(cap).astype(np.float32)
    f32[0] = np.nan
    f32[1 % cap] = -0.0
    words = np.array(["alpha", None, "", "z" * 37, "beta"], object)
    return (
        rcol.from_numpy(rng.integers(-2**62, 2**62, cap).astype(np.int64)),
        rcol.from_numpy(rng.integers(0, 2**32, cap).astype(np.uint32)),
        rcol.from_numpy(rng.integers(-2**15, 2**15, cap).astype(np.int16)),
        rcol.from_numpy(rng.integers(0, 2**8, cap).astype(np.uint8)),
        rcol.from_numpy(f32),
        rcol.from_numpy(rng.random(cap).astype(np.float64)),
        rcol.from_numpy(rng.random(cap).astype(np.float16)),
        rcol.from_numpy(rng.integers(0, 2, cap).astype(bool)),
        rcol.from_numpy(words[rng.integers(0, 5, cap)]),
    )


def _bits(x) -> np.ndarray:
    """A host array as raw bytes per row: floats compare by their bits."""
    a = np.ascontiguousarray(np_of(x))
    return a.view(np.uint8).reshape(a.shape[0], -1)


def _assert_cols_bits_equal(a, b, ctx=""):
    """Data (bit for bit), validity and lengths over the whole capacity."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np_of(x.data).dtype == np_of(y.data).dtype, (ctx, i)
        np.testing.assert_array_equal(_bits(x.data), _bits(y.data),
                                      err_msg=f"{ctx} col {i}")
        np.testing.assert_array_equal(np_of(x.validity), np_of(y.validity),
                                      err_msg=f"{ctx} col {i} validity")
        assert (x.lengths is None) == (y.lengths is None)
        if x.lengths is not None:
            np.testing.assert_array_equal(np_of(x.lengths), np_of(y.lengths),
                                          err_msg=f"{ctx} col {i} lengths")


def _assert_plane_equal(port_plane, ref_plane):
    assert port_plane.dtype == torch.int32
    np.testing.assert_array_equal(np_of(port_plane).view(np.uint32),
                                  np.asarray(ref_plane))


@pytest.mark.parametrize("cap", [1, 7, 256])
def test_plane_roundtrip_all_dtypes(cap, rng):
    rcols = _mixed_columns(cap, rng)
    cols = tuple(port_column(c) for c in rcols)
    packed = plane.pack_plane(cols)
    # from_numpy pads capacity to >= 8; the plane covers the full capacity
    assert tuple(packed.shape) == (cols[0].capacity, plane.plane_words(cols))
    assert plane.plane_words(cols) == rplane.plane_words(rcols)
    _assert_plane_equal(packed, rplane.pack_plane(rcols))
    # float payloads travel as raw bits, so even NaN survives exactly
    _assert_cols_bits_equal(cols, plane.unpack_plane(packed, cols),
                            "roundtrip")


@pytest.mark.parametrize("cap", [7, 256])
def test_unpacked_columns_own_their_storage(cap, rng):
    """Every decoded buffer holds a storage of its own size: no column
    keeps the plane (or its transposed copy) alive once the caller drops
    it."""
    cols = tuple(port_column(c) for c in _mixed_columns(cap, rng))
    for c in plane.unpack_plane(plane.pack_plane(cols), cols):
        for buf in (c.data, c.validity, c.lengths):
            if buf is not None:
                assert buf.untyped_storage().nbytes() == \
                    buf.numel() * buf.element_size(), (c.dtype, buf.shape)


def test_plane_valid_mask_zeroes_tail(rng):
    cap = 64
    rcols = _mixed_columns(cap, rng)
    cols = tuple(port_column(c) for c in rcols)
    mask = torch.arange(cap) < 10
    out = plane.unpack_plane(plane.pack_plane(cols), cols, valid_mask=mask)
    for c in out:
        assert not np_of(c.validity)[10:].any()
        assert (np_of(c.data)[10:] == 0).all()
        if c.lengths is not None:
            assert (np_of(c.lengths)[10:] == 0).all()
    want = rplane.unpack_plane(rplane.pack_plane(rcols), rcols,
                               valid_mask=jnp.arange(cap) < 10)
    _assert_cols_bits_equal(out, want, "valid-mask vs reference")


def test_plane_preserves_null_rows_raw_bits():
    """Unmasked decode reproduces null rows' buffers exactly: the
    per-buffer exchange moves raw bytes, so the packed one must too."""
    n = 16
    data = torch.arange(1, n + 1, dtype=torch.int64) * -7
    validity = torch.as_tensor((np.arange(n) % 3) != 0)
    smat = torch.as_tensor((np.arange(n * 8) % 251 + 1).reshape(n, 8),
                           dtype=torch.uint8)
    slen = torch.full((n,), 8, dtype=torch.int32)
    from cylon_tpu_torch import dtypes

    cols = (Column(data, validity, None, dtypes.int64),
            Column(smat, validity, slen, dtypes.string))
    packed = plane.pack_plane(cols)
    out = plane.unpack_plane(packed, cols)
    _assert_cols_bits_equal(cols, out, "null-rows-raw")
    # the junk on validity=False rows really is nonzero: the test bites
    assert (np_of(out[0].data)[~np_of(validity)] != 0).all()
    from cylon_tpu.column import Column as RColumn
    from cylon_tpu import dtypes as rdtypes

    rcols = (RColumn(jnp.asarray(np_of(data)), jnp.asarray(np_of(validity)),
                     None, rdtypes.int64),
             RColumn(jnp.asarray(np_of(smat)), jnp.asarray(np_of(validity)),
                     jnp.asarray(np_of(slen)), rdtypes.string))
    _assert_plane_equal(packed, rplane.pack_plane(rcols))


def test_plane_word_count_is_dense(rng):
    """First-fit-decreasing: 10 int32 columns travel as 11 words."""
    rcols = tuple(rcol.from_numpy(rng.integers(0, 100, 32).astype(np.int32))
                  for _ in range(10))
    cols = tuple(port_column(c) for c in rcols)
    assert plane.plane_words(cols) == rplane.plane_words(rcols) == 11


def test_pack_enabled_default_by_backend(monkeypatch):
    """``auto`` is off on the CPU and on CUDA (neither is TPU-family), for
    packing and for compression; 1/0 override."""
    monkeypatch.delenv("CYLON_TPU_SHUFFLE_PACK", raising=False)
    monkeypatch.delenv("CYLON_TPU_SHUFFLE_COMPRESS", raising=False)
    assert not plane.pack_enabled()
    assert not plane.compress_enabled()
    for on in ("1", "on", "packed"):
        monkeypatch.setenv("CYLON_TPU_SHUFFLE_PACK", on)
        assert plane.pack_enabled()
    for off in ("0", "off", "perbuf", "auto", "junk"):
        monkeypatch.setenv("CYLON_TPU_SHUFFLE_PACK", off)
        assert not plane.pack_enabled()
    monkeypatch.setenv("CYLON_TPU_SHUFFLE_COMPRESS", "1")
    assert plane.compress_enabled()
    monkeypatch.setenv("CYLON_TPU_SHUFFLE_COMPRESS", "0")
    assert not plane.compress_enabled()


# -- packed vs per-buffer exchange: bit-identical shard contents ------------

def _mixed_df(n, rng, keys=50):
    words = np.array(["alpha", "beta", None, "g" * 40, ""], object)
    return pd.DataFrame({
        "k": rng.integers(0, keys, n).astype(np.int64),
        "v": rng.random(n).astype(np.float32),
        "w": rng.random(n).astype(np.float64),
        "b": rng.integers(0, 2, n).astype(bool),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "s": words[rng.integers(0, 5, n)],
    })


def _shard_bits(t):
    """Per shard, its count and every column's buffers as raw bytes."""
    names, shards, counts = interop.table_shards_to_arrays(t)
    return names, [(int(n), [(_bits(d), v, ln) for d, v, ln, _ in cols])
                   for cols, n in zip(shards, counts)]


def _assert_tables_bits_equal(a, b, ctx=""):
    (na, sa), (nb, sb) = _shard_bits(a), _shard_bits(b)
    assert na == nb and len(sa) == len(sb)
    for s, ((ca, xa), (cb, xb)) in enumerate(zip(sa, sb)):
        assert ca == cb, (ctx, s)
        for name, x, y in zip(na, xa, xb):
            for u, w in zip(x, y):
                assert (u is None) == (w is None)
                if u is not None:
                    np.testing.assert_array_equal(
                        u, w, err_msg=f"{ctx} shard {s} {name}")


@contextlib.contextmanager
def _env(**values):
    """Set environment variables (both packages read the same knobs) for
    the block, and restore them after."""
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


def _arm(pack: str, comp: str = "0"):
    return _env(CYLON_TPU_SHUFFLE_PACK=pack, CYLON_TPU_SHUFFLE_COMPRESS=comp)


def _port_arms(t, keys, arms=ARMS):
    """The port's shuffle under each arm; all bit-identical."""
    outs = {}
    for label, (pack, comp) in arms.items():
        with _arm(pack, comp):
            outs[label] = t.shuffle(keys)
    first = next(iter(outs.values()))
    for label, out in outs.items():
        assert out.row_count == first.row_count
        _assert_tables_bits_equal(first, out, label)
    return first


def _reference_shuffle(df, world, keys, pack="1", comp="0",
                       permute="scatter"):
    """The reference's shuffle of ``df`` under murmur3 placement, in the
    given realization; (input table, output table)."""
    with murmur3_reference(world) as rctx, _arm(pack, comp), \
            _env(CYLON_TPU_PERMUTE=permute):
        rt = RTable.from_pandas(df, ctx=rctx)
        return rt, rt.shuffle(keys)


def _ab_against_reference(meshes, world, df, keys, arms=ARMS, pack="1",
                          comp="0", permute="scatter"):
    t = Table.from_pandas(df, ctx=meshes[world])
    got = _port_arms(t, keys, arms)
    rt, want = _reference_shuffle(df, world, keys, pack, comp, permute)
    assert_shards_equal(t, rt)
    assert_shards_equal(got, want)
    return got.row_count


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("permute", PERMUTE_MODES)
def test_packed_vs_perbuffer_worlds(world, permute, meshes, rng):
    n = 2000
    arms = {k: ARMS[k] for k in ("perbuf", "packed")}
    assert _ab_against_reference(meshes, world, _mixed_df(n, rng), ["k"],
                                 arms, permute=permute) == n


@pytest.mark.parametrize("world", [4, 8])
def test_packed_vs_perbuffer_skewed(world, meshes, rng):
    """One hot key: every row lands on one shard, the rest get none."""
    n = 1500
    df = _mixed_df(n, rng)
    df["k"] = np.int64(7)
    arms = {k: ARMS[k] for k in ("perbuf", "packed")}
    assert _ab_against_reference(meshes, world, df, ["k"], arms,
                                 pack="0") == n


def test_packed_vs_perbuffer_tiny_and_empty(meshes, rng):
    """Fewer rows than shards, and a zero-row table."""
    arms = {k: ARMS[k] for k in ("perbuf", "packed")}
    assert _ab_against_reference(meshes, 8, _mixed_df(3, rng), ["k"],
                                 arms) == 3
    empty = Table.from_pandas(_mixed_df(0, rng), ctx=meshes[8])
    assert _port_arms(empty, ["k"], arms).row_count == 0


def test_packed_hash_partition_agrees(meshes, rng):
    """hash_partition under the packed knob equals its split under the
    per-buffer knob on every partition, and the reference's packed split:
    the port splits shard-locally with ``Column.take`` under both."""
    df = _mixed_df(800, rng)
    t = Table.from_pandas(df, ctx=meshes[4])
    parts = {}
    for mode in PACK_MODES:
        with _arm(mode):
            parts[mode] = t.hash_partition(["k"], 3)
    with murmur3_reference(4) as rctx, _arm("1"):
        want = RTable.from_pandas(df, ctx=rctx).hash_partition(["k"], 3)
    assert parts["0"].keys() == parts["1"].keys() == want.keys()
    for p in parts["0"]:
        a, b = parts["0"][p], parts["1"][p]
        assert a.row_count == b.row_count
        _assert_tables_bits_equal(a, b, f"partition {p}")
        assert_shards_equal(b, want[p])


def test_packed_task_shuffle_agrees(meshes, ctx4, rng):
    plan = LogicalTaskPlan({0: 1, 1: 3, 2: 0}, 4)
    frames = [pd.DataFrame({
        "a": rng.integers(0, 100, 200).astype(np.int64),
        "x": rng.random(200).astype(np.float32)}) for _ in range(3)]
    tables = [Table.from_pandas(f, ctx=meshes[4]) for f in frames]
    outs = {}
    for mode in PACK_MODES:
        with _arm(mode):
            outs[mode] = task_shuffle(tables, [0, 1, 2], plan)
    from cylon_tpu.parallel.task import (LogicalTaskPlan as RPlan,
                                         task_shuffle as rtask_shuffle)

    with _arm("1"):
        want = rtask_shuffle([RTable.from_pandas(f, ctx=ctx4)
                              for f in frames], [0, 1, 2],
                             RPlan({0: 1, 1: 3, 2: 0}, 4))
    for a, b, w in zip(outs["0"], outs["1"], want):
        assert a.row_count == b.row_count == 200
        _assert_tables_bits_equal(a, b, "task")
        assert_shards_equal(b, w)


# -- the launch counts: one exchange per buffer -> one ---------------------

@contextlib.contextmanager
def _counting_collectives():
    """Count the calls of ``collectives.all_to_all`` / ``allgather``."""
    counts = {"all_to_all": 0, "allgather": 0}
    originals = {name: getattr(collectives, name) for name in counts}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return counted

    try:
        for name in counts:
            setattr(collectives, name, wrap(name))
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(collectives, name, fn)


def _launch_counts(meshes, rng, fn):
    counts = {}
    for mode in PACK_MODES:
        with _arm(mode), _counting_collectives() as c:
            fn()
        counts[mode] = dict(c)
    return counts


def test_collective_launch_count(meshes, rng):
    """The packed shuffle runs ONE data exchange whatever the column
    count, where the per-buffer one runs one per buffer per column (6
    columns: 6 data + 6 validity + 1 lengths = 13).  The count matrix is
    one host copy, not a collective."""
    t = Table.from_pandas(_mixed_df(256, rng), ctx=meshes[4])
    counts = _launch_counts(meshes, rng, lambda: par_ops.shuffle(t, (0,)))
    assert counts["0"] == {"all_to_all": 13, "allgather": 0}
    assert counts["1"] == {"all_to_all": 1, "allgather": 0}
    assert shuffle_mod.buffer_count(t.shards[0]) == 13


def test_collective_launch_count_ragged(meshes, rng):
    """The same meter on the exchange body itself, with given targets."""
    world, cap = 4, 64
    t = Table.from_pandas(_mixed_df(world * cap, rng), ctx=meshes[4])
    targets = [torch.as_tensor(rng.integers(0, world, c.capacity)
                               .astype(np.int32)) for c, *_ in t.shards]
    cm = shuffle_mod.count_matrix([shuffle_mod.target_counts(tg, world)
                                   for tg in targets])
    out_cap = shuffle_mod.plan_shuffle(cm)
    counts, results = {}, {}
    for mode in PACK_MODES:
        with _counting_collectives() as c:
            results[mode] = shuffle_mod.shuffle_shard_ragged(
                t.shards, targets, cm, world, out_cap, t.ctx.devices,
                packed=mode == "1")
        counts[mode] = c["all_to_all"]
    assert counts == {"0": 13, "1": 1}
    assert results["0"][1] == results["1"][1]
    for a, b in zip(results["0"][0], results["1"][0]):
        _assert_cols_bits_equal(a, b, "ragged body")


# -- compressed payloads: bit-identical to both uncompressed realizations --

def _edge_df(n, rng):
    """The compression edge grid: extreme 64-bit ranges (cannot narrow),
    negative ranges, a single-value column, an all-null float column,
    empty strings, and a low-cardinality category column."""
    cats = np.array(["AA", "B", "CCC"], object)
    return pd.DataFrame({
        "k": rng.integers(-20, 20, n).astype(np.int64),
        "ext": np.where(rng.integers(0, 2, n) == 0,
                        np.iinfo(np.int64).min,
                        np.iinfo(np.int64).max).astype(np.int64),
        "neg": rng.integers(-5000, -4000, n).astype(np.int64),
        "one": np.full(n, 42, np.int32),
        "nul": np.full(n, np.nan, np.float64),
        "empty_s": np.array([""] * n, object),
        "cat": cats[rng.integers(0, 3, n)],
        "ts": (rng.integers(0, 1000, n) + 1_600_000_000_000).astype(np.int64),
    })


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("permute", PERMUTE_MODES)
def test_compressed_vs_uncompressed_worlds(world, permute, meshes, rng):
    n = 1200
    assert _ab_against_reference(meshes, world, _mixed_df(n, rng), ["k"],
                                 comp="1", permute=permute) == n


@pytest.mark.parametrize("world", [1, 2, 4])
def test_compressed_edge_columns(world, meshes, rng):
    """INT64_MIN/MAX, negative ranges, single-value, all-null, width-0
    strings, low-cardinality categories, across worlds 1/2/4."""
    n = 700
    assert _ab_against_reference(meshes, world, _edge_df(n, rng), ["k"],
                                 comp="1") == n


def test_compressed_skew_and_empty(meshes, rng):
    df = _mixed_df(900, rng)
    df["k"] = np.int64(7)  # one hot key
    assert _ab_against_reference(meshes, 4, df, ["k"], comp="1") == 900
    empty = Table.from_pandas(_mixed_df(0, rng), ctx=meshes[4])
    assert _port_arms(empty, ["k"]).row_count == 0


def test_compressed_launch_count(meshes, rng):
    """The compressed exchange is 1 packed all_to_all + at most 1
    dictionary all-gather, whatever the column count; its spec, estimated
    on one shard, is the reference's."""
    world, shard_cap = 4, 64
    n = world * shard_cap
    df = _mixed_df(n, rng)
    rcols = tuple(rcol.from_numpy(df[c].to_numpy(), capacity=n)
                  for c in df.columns)
    cols = tuple(port_column(c) for c in rcols)
    spec = plane.estimate_spec(cols, world=world, shard_cap=shard_cap)
    assert spec == rplane.estimate_spec(rcols, world=world,
                                        shard_cap=shard_cap)
    assert any(e[0] == "dict" for e in spec)  # the string column encodes
    t = Table.from_pandas(df, ctx=meshes[4])
    with _arm("1", "1"), _counting_collectives() as c:
        par_ops.shuffle(t, (0,))
    assert c == {"all_to_all": 1, "allgather": 1}


def test_compressed_bytes_drop_low_cardinality(meshes, rng, clean_obs):
    """At least 1.5x fewer ``shuffle.bytes_sent`` on narrow int keys and
    category strings, with the shards bit-identical."""
    n = 2000
    cats = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE"], object)
    df = pd.DataFrame({
        "k": rng.integers(0, 100, n).astype(np.int64),
        "seg": cats[rng.integers(0, 3, n)],
        "date": rng.integers(0, 2556, n).astype(np.int32),
        "price": rng.random(n).astype(np.float32),
    })
    t = Table.from_pandas(df, ctx=meshes[4])
    sent, outs = {}, {}
    for label, comp in (("plain", "0"), ("comp", "1")):
        before = obs_metrics.counter_value("shuffle.bytes_sent")
        with _arm("1", comp):
            outs[label] = t.shuffle(["k"])
        sent[label] = obs_metrics.counter_value("shuffle.bytes_sent") - before
    _assert_tables_bits_equal(outs["plain"], outs["comp"], "bytes-drop")
    assert sent["comp"] > 0
    assert sent["plain"] / sent["comp"] >= 1.5, sent
    assert obs_metrics.counter_value("shuffle.bytes_saved") == \
        sent["plain"] - sent["comp"]
    assert obs_metrics.snapshot()["gauges"]["shuffle.compress_ratio"] == \
        sent["plain"] / sent["comp"]


def test_build_spec_units(rng):
    """Host-side spec math: narrowing, raw fallbacks, dictionary vs
    truncation; the same stats give the reference's spec tuple."""
    n = 64
    rcols = (
        rcol.from_numpy(rng.integers(100, 300, n).astype(np.int64)),
        rcol.from_numpy(np.array([np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max] * 32, np.int64)),
        rcol.from_numpy(np.full(n, -9, np.int64)),
        rcol.from_numpy(rng.random(n).astype(np.float32)),
        rcol.from_numpy(np.array(["x", "yy"], object)[rng.integers(0, 2,
                                                                   n)]),
        rcol.from_numpy((rng.integers(0, 100, n).astype(np.uint64)
                         + np.uint64(2**64 - 200))),
        rcol.from_numpy((rng.integers(0, 100, n) + 2**32 - 200)
                        .astype(np.uint32)),
    )
    cols = tuple(port_column(c) for c in rcols)
    spec = plane.estimate_spec(cols, world=4, shard_cap=n)
    assert spec == rplane.estimate_spec(rcols, world=4, shard_cap=n)
    assert spec[0][0] == "narrow" and spec[0][2] <= 12   # range 200
    assert spec[1] == ("raw",)                           # full i64 span
    assert spec[2][0] == "narrow" and spec[2][1] == -9 and spec[2][2] == 0
    assert spec[3] == ("raw",)                           # float: raw bits
    assert spec[4][0] == "dict"                          # 2 distinct values
    assert spec[5][0] == "narrow" and spec[5][1] >= 2**64 - 200
    # all-raw normalizes to None
    raw = (rcol.from_numpy(np.array([np.iinfo(np.int64).min,
                                     np.iinfo(np.int64).max] * 32, np.int64)),)
    assert plane.estimate_spec(tuple(port_column(c) for c in raw), world=4,
                               shard_cap=n) is None
    # the same flat stats through both build_specs, edge values included
    for stats in ([5, 3, 0, 0, 0], [0, 1, 3, 7, 1], [-9, -9, 40, 40, 4096],
                  [-2**63, 2**63 - 1, 2, 2, 2], [0, 2**32, 33, 300, 9]):
        assert plane.build_spec(cols[:1] + cols[4:5], stats, 4, n) == \
            rplane.build_spec(rcols[:1] + rcols[4:5], stats, 4, n)


def test_column_stats_match_reference(meshes, ctx4, rng):
    """The replicated stats pass equals the reference's on one table
    (integer ranges, unsigned ones included, string extents, lengths and
    distinct counts with the padding group)."""
    n = 600
    df = _edge_df(n, rng)
    df["u64"] = rng.integers(0, 2**62, n).astype(np.uint64) \
        + np.uint64(2**63)
    df["u32"] = rng.integers(2**31, 2**32, n).astype(np.uint32)
    rt = RTable.from_pandas(df, ctx=ctx4)
    t = Table.from_pandas(df, ctx=meshes[4])
    _, _, rstats = rops._targets_counts_stats(rt, (0,), "hash", None)
    want = tuple(int(np.asarray(s).reshape(-1)[0]) for s in rstats)
    got = partition.column_stats(t.shards, t.counts, t.ctx.devices)
    assert got == want
    assert len(got) == partition.stats_arity(t.shards[0])
    assert plane.build_spec(t.shards[0], got, 4, t.shard_capacity) == \
        rplane.build_spec(rt.columns, list(rstats), 4, rt.shard_capacity)


def test_plane_roundtrip_with_spec(rng):
    """Narrow and truncated encodings round-trip bit-exactly; under one
    spec, dictionary codes included, the plane is the reference's."""
    n = 64
    rcols = (
        rcol.from_numpy(rng.integers(-50, 1000, n).astype(np.int64)),
        rcol.from_numpy(rng.integers(0, 7, n).astype(np.int16)),
        rcol.from_numpy(np.array(["ab", "", "c"], object)[
            rng.integers(0, 3, n)]),
    )
    cols = tuple(port_column(c) for c in rcols)
    spec = rplane.estimate_spec(rcols, world=4, shard_cap=n)
    assert spec[2][0] == "dict"
    codes = rng.integers(0, spec[2][3], cols[0].capacity)
    _assert_plane_equal(
        plane.pack_plane(cols, spec, {2: torch.as_tensor(codes)}),
        rplane.pack_plane(rcols, spec, {2: jnp.asarray(codes, jnp.uint32)}))
    # force the string column onto the truncation arm
    spec = tuple(("trunc", e[1], 8) if e[0] == "dict" else e for e in spec)
    assert plane.plane_words(cols, spec) < plane.plane_words(cols)
    packed = plane.pack_plane(cols, spec)
    _assert_plane_equal(packed, rplane.pack_plane(rcols, spec))
    _assert_cols_bits_equal(cols, plane.unpack_plane(packed, cols,
                                                     spec=spec),
                            "spec-roundtrip")


# -- the exchange accounting (tests/test_obs.py:221-279) -------------------

def _obs_arrays(n=256):
    """The 6-column frame of the reference's accounting tests."""
    rng = np.random.default_rng(7)
    return {
        "k32": rng.integers(0, 50, n).astype(np.int32),
        "v64": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "f64": rng.normal(size=n),
        "f32": rng.normal(size=n).astype(np.float32),
        "flag": (rng.integers(0, 2, n) == 1),
        "tag": np.array([f"s{i % 13:06d}" for i in range(n)]),
    }


def _obs_table(ctx, n=256):
    arrs = _obs_arrays(n)
    return Table.from_numpy(list(arrs), list(arrs.values()), ctx=ctx,
                            capacity=n)


@pytest.mark.parametrize("pack,launches", [("perbuf", 13), ("packed", 1)])
def test_shuffle_collective_launch_metric(meshes, ctx4, clean_obs, pack,
                                         launches):
    """One exchange: ``shuffle.collective_launches`` 1 packed, 13 per
    buffer; ``shuffle.bytes_sent`` the rows moved times the row bytes of
    the reference's formula."""
    t = _obs_table(meshes[4])
    arrs = _obs_arrays()
    rt = RTable.from_numpy(list(arrs), list(arrs.values()), ctx=ctx4,
                           capacity=256)
    with config.knob_env(CYLON_TPU_TRACE="1", CYLON_TPU_SHUFFLE_PACK=pack):
        out = par_ops.shuffle(t, (0,))
        assert out.row_count == t.row_count
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.exchanges"] == 1
    assert c["shuffle.collective_launches"] == launches
    assert c["shuffle.counts_gathers"] == 1
    # per buffer: k32 5, v64 9, f64 9, f32 5, flag 2, tag 32+1+4 = 67 B;
    # packed: 16 plane words = 64 B
    row_bytes = par_ops._row_bytes(t.shards[0], pack == "packed")
    assert row_bytes == rops._row_bytes(rt.columns, pack == "packed") \
        == (64 if pack == "packed" else 67)
    assert c["shuffle.bytes_sent"] == t.row_count * row_bytes
    h = obs_metrics.snapshot()["histograms"]["shuffle.bytes_per_exchange"]
    assert h["count"] == 1 and h["sum"] == c["shuffle.bytes_sent"]
    names = {e.name for e in obs_spans.events()}
    assert {"shuffle.plan", "shuffle.exchange", "shuffle.collective",
            "shuffle.exchange_done"} <= names
    if pack == "packed":
        assert {"shuffle.pack", "shuffle.unpack"} <= names


@pytest.mark.parametrize("pack,launches", [("perbuf", 26), ("packed", 2)])
def test_distributed_join_records_two_exchanges(meshes, clean_obs, pack,
                                                launches):
    t = _obs_table(meshes[4])
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack):
        j = t.distributed_join(t, on="k32")
        assert j.row_count > 0
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.exchanges"] == 2
    assert c["shuffle.collective_launches"] == launches


def test_task_shuffle_records_exchange_metrics(meshes, clean_obs, rng):
    """The task exchange is accounted like every exchange: per buffer,
    a + b + the int64 routing column, 3 data + 3 validity launches; its
    bytes are the rows that exist (exact traffic), 9 B each per column."""
    plan = LogicalTaskPlan({0: 3, 1: 1}, world_size=4)
    tables = [Table.from_pydict(
        {"a": rng.integers(0, 100, 40).astype(np.int64),
         "b": rng.random(40)}, ctx=meshes[4]) for _ in range(2)]
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK="perbuf"):
        task_shuffle(tables, [0, 1], plan)
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.exchanges"] == 1
    assert c["shuffle.collective_launches"] == 6
    assert c["shuffle.bytes_sent"] == 80 * 27


@pytest.mark.parametrize("pack,launches", [("perbuf", 14), ("packed", 1)])
def test_broadcast_records_metrics(meshes, clean_obs, pack, launches):
    """A broadcast counts under ``shuffle.broadcasts``, never
    ``shuffle.exchanges``: one all-gather packed (the plane and its meta
    row), the counts' plus one per buffer otherwise."""
    t = _obs_table(meshes[4])
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack), \
            _counting_collectives() as calls:
        out = par_ops.broadcast_gather(t)
    assert out.row_counts.tolist() == [t.row_count] * 4
    c = obs_metrics.snapshot()["counters"]
    assert c["shuffle.broadcasts"] == 1
    assert "shuffle.exchanges" not in c
    assert c["shuffle.collective_launches"] == launches == calls["allgather"]
    rows = t.shard_capacity + (1 if pack == "packed" else 0)
    assert c["shuffle.bytes_sent"] == rows * 4 * par_ops._row_bytes(
        t.shards[0], pack == "packed")


def test_packed_broadcast_equals_per_buffer(meshes, rng):
    t = Table.from_pandas(_mixed_df(300, rng), ctx=meshes[4])
    outs = {}
    for mode in PACK_MODES:
        with _arm(mode):
            outs[mode] = par_ops.broadcast_gather(t)
    assert outs["0"].row_counts.tolist() == [300] * 4
    _assert_tables_bits_equal(outs["0"], outs["1"], "broadcast")


def test_compress_ratio_of_the_main_path_shape(meshes, clean_obs):
    """The distributed path's tables (int32 keys spanning [0, 2^26),
    float32 values): 10 B per row per buffer, 12 packed (3 words), 8
    compressed (the key narrows to 28 bits and shares its word with both
    validity bits), so the ratio reads 1.5."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 1 << 26, 1000).astype(np.int32)
    k[:2] = (0, (1 << 26) - 1)
    t = Table.from_numpy(["k", "v"], [k, rng.random(1000).astype(
        np.float32)], ctx=meshes[4])
    assert par_ops._row_bytes(t.shards[0], False) == 10
    assert par_ops._row_bytes(t.shards[0], True) == 12
    with _arm("1", "1"):
        t.shuffle(["k"])
    c = obs_metrics.snapshot()
    assert c["gauges"]["shuffle.compress_ratio"] == 1.5
    assert c["counters"]["shuffle.bytes_sent"] == 1000 * 8


def test_out_of_core_stats_report_the_exchange(meshes):
    """The out-of-core engine's stats say which exchange its mesh passes
    ran (they reported per buffer whatever the knob)."""
    rng = np.random.default_rng(5)
    frame = {"k": rng.integers(0, 64, 400).astype(np.int32),
             "v": rng.random(400).astype(np.float32)}
    for pack, want in (("1", True), ("0", False)):
        with _arm(pack):
            _, stats = exec_mod.chunked_repartition(
                frame, ["k"], 4, passes=2, ctx=meshes[4])
            assert stats["shuffle_pack"] is want
            _, stats = exec_mod.chunked_join(
                frame, frame, on="k", passes=2, ctx=meshes[4])
            assert stats["shuffle_pack"] is want
