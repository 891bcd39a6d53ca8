"""The CUDA kernels (scan family, murmur3 hash partition) against their
plain PyTorch versions on the card, and the relational operators (string
keys and TPC-H Q1 included) on the card against the same operators on the
CPU.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode.  This file imports neither jax nor cylon_tpu, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: exact for integers, min/max and hashes; float32 sums rtol=1e-5
against a float64 oracle (tree-order rounding)."""
import numpy as np
import pytest
import torch

from cylon_tpu_torch import column
from cylon_tpu_torch.ops import hash_kernels, scan

# across one tile (4096) and its edges, and past 4096^2: three levels of
# the segmented scan's recursion over tile totals, 12,289 look-back tiles
SIZES = (1, 4095, 4096, 4097, 3 * 4096 * 4096 + 5)
TILE = scan.SCAN_1D_TILE


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(1)


@pytest.mark.gpu
@pytest.mark.parametrize("op", scan.OPS)
def test_scan_1d_kernel_matches_plain(gen, op):
    for n in SIZES:
        x = torch.randint(-1000, 1000, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        for rev in (False, True):
            assert torch.equal(scan.scan_1d(x, op, rev),
                               scan.scan_1d_plain(x, op, rev))  # exact


@pytest.mark.gpu
@pytest.mark.parametrize("op", scan.OPS)
def test_scan_1d_tile_edges_and_alignment(gen, op):
    """The look-back kernel's vector and element-wise paths: one tile and
    its edges, n % 4 in 0-3 over 40 tiles (past one 32-tile look-back
    window), in both directions, and views at 4, 8 and 12 bytes past a
    16-byte boundary."""
    sizes = (TILE - 1, TILE, TILE + 1, TILE + 2) + tuple(
        40 * TILE + r for r in range(4))
    for n in sizes:
        for off in (0, 1, 2, 3):
            x = torch.randint(-1000, 1000, (n + off,), generator=gen,
                              device="cuda", dtype=torch.int32)[off:]
            for rev in (False, True):
                assert torch.equal(scan.scan_1d(x, op, rev),
                                   scan.scan_1d_plain(x, op, rev))  # exact


@pytest.mark.gpu
def test_scan_1d_many_tiles_repeatable(gen):
    """Several thousand tiles, int32 sums that wrap, and 20 calls on one
    input bit-equal: integer look-back results do not depend on the order
    blocks run in."""
    n = 5000 * TILE + 3
    x = torch.randint(-(1 << 30), 1 << 30, (n,), generator=gen,
                      device="cuda", dtype=torch.int32)
    for op in scan.OPS:
        for rev in (False, True):
            first = scan.scan_1d(x, op, rev)
            assert torch.equal(first, scan.scan_1d_plain(x, op, rev))
            if (op, rev) == ("sum", False):
                for _ in range(19):
                    assert torch.equal(scan.scan_1d(x, op, rev), first)


@pytest.mark.gpu
@pytest.mark.parametrize("n", (TILE + 1, 40 * TILE + 3, 5000 * TILE + 2))
def test_scan_1d_float_sums_against_float64_oracle(gen, n):
    """float32 sums within rtol=1e-5, atol=1e-6 of a float64 cumsum, in
    both directions; the rounding order is not reproducible, so only the
    tolerance is asserted."""
    x = torch.rand(n, generator=gen, device="cuda") * 2 - 0.5
    for rev in (False, True):
        xd = x.double().flip(0) if rev else x.double()
        want = torch.cumsum(xd, 0)
        want = want.flip(0) if rev else want
        got = scan.scan_1d(x, "sum", rev).double()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("op", scan.OPS)
def test_segmented_scan_kernel_matches_plain(gen, op):
    for n in SIZES:
        x = torch.randint(-1000, 1000, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        for p in (0.0, 0.001, 0.4, 1.0):
            r = torch.rand(n, generator=gen, device="cuda") < p
            assert torch.equal(scan.segmented_scan(x, r, op),
                               scan.segmented_scan_plain(x, r, op))  # exact


@pytest.mark.gpu
def test_float_sums_uint32_and_launch_counts(gen):
    n = 3 * 4096 * 4096 + 5
    x = torch.rand(n, generator=gen, device="cuda")
    r = torch.rand(n, generator=gen, device="cuda") < 0.01
    scan.reset_launches()
    got = scan.segmented_scan(x, r, "sum").double()
    want = scan.segmented_scan_plain(x.double(), r, "sum")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got = scan.scan_1d(x, "sum", reverse=True).double()
    want = scan.scan_1d_plain(x.double(), "sum", reverse=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert scan.LAUNCHES == {"scan_1d": 1, "segmented_scan": 1}
    xu = torch.randint(0, 1 << 31, (4097,), generator=gen, device="cuda",
                       dtype=torch.int32).view(torch.uint32)
    for op in scan.OPS:  # compared as bit patterns
        assert torch.equal(scan.scan_1d(xu, op).view(torch.int32),
                           scan.scan_1d_plain(xu, op).view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        scan.scan_1d(x[::2], "sum")


HASH_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint32, np.float32,
               np.float64, np.bool_)
# below, at and past one block of 256 threads, and past one grid of
# 132*16 blocks (the grid-stride loop)
HASH_SIZES = (1, 255, 256, 257, 3 * 2**20 + 5)


def _hash_column(rng, dtype, n):
    if dtype == np.bool_:
        v = rng.random(n) > 0.5
    else:
        v = rng.integers(-(1 << 62), 1 << 62, n).astype(dtype)
    valid = rng.random(n) > 0.1
    return column.from_numpy(v, validity=valid, capacity=n + 3,
                             device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HASH_DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash_partition_kernel_matches_plain(gen, dtype):
    rng = np.random.default_rng(3)
    for n in HASH_SIZES:
        col = _hash_column(rng, dtype, n)
        for world in (1, 3, 4, 6, 8):
            h, t = hash_kernels.hash_partition([col], world)
            ph, pt = hash_kernels.hash_partition_plain([col], world)
            # exact: compared as bit patterns
            assert torch.equal(h.view(torch.int32), ph.view(torch.int32))
            assert torch.equal(t, pt)


@pytest.mark.gpu
def test_hash_partition_multi_column_and_launch_count(gen):
    rng = np.random.default_rng(5)
    n = 3 * 2**20 + 5
    cols = [_hash_column(rng, d, n) for d in (np.int32, np.float64, np.bool_,
                                              np.int16)]
    hash_kernels.reset_launches()
    for k in (2, 4):
        for world in (4, 6):
            h, t = hash_kernels.hash_partition(cols[:k], world)
            ph, pt = hash_kernels.hash_partition_plain(cols[:k], world)
            assert torch.equal(h.view(torch.int32), ph.view(torch.int32))
            assert torch.equal(t, pt)
    assert hash_kernels.LAUNCHES == {"hash_partition": 4}
    empty = column.from_numpy(np.zeros(0, np.int32), capacity=0,
                              device="cuda")
    h, t = hash_kernels.hash_partition([empty], 4)
    assert h.shape == (0,) and t.shape == (0,)
    assert hash_kernels.LAUNCHES == {"hash_partition": 4}


def _operator_tables(device, rows=5000):
    from cylon_tpu_torch import pipeline

    data = pipeline.make_data(rows)
    return pipeline.local_tables(*pipeline.tables(*data, device=device))


def _assert_same_table(got, want, float_rtol=None):
    """Two tables of one layout, got on the card, want on the CPU: names,
    counts, and every shard's validity and data over the whole capacity,
    exact unless ``float_rtol`` is given for float data (whose dtype then
    may differ: narrow on the card, wide on the CPU)."""
    assert got.names == want.names
    assert got.row_counts.tolist() == want.row_counts.tolist()
    for gs, ws in zip(got.shards, want.shards):
        for g, w in zip(gs, ws):
            assert torch.equal(g.validity.cpu(), w.validity)
            if float_rtol is not None and w.data.is_floating_point():
                torch.testing.assert_close(g.data.cpu().double(),
                                           w.data.double(), rtol=float_rtol,
                                           atol=0)
            else:
                assert torch.equal(g.data.cpu(), w.data)


@pytest.mark.gpu
def test_operators_on_the_card_equal_the_cpu(gen):
    """``pipeline.operators`` on the card against the same run on the CPU:
    tables exact (sort, unique, set ops, select, filter), float sums
    rtol 1e-5 (float32 on the card, float64 on the CPU)."""
    from cylon_tpu_torch import pipeline

    got = pipeline.operators(*_operator_tables("cuda"))
    want = pipeline.operators(*_operator_tables("cpu"))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            torch.testing.assert_close(g.cpu().double(), w.double(),
                                       rtol=1e-5, atol=0)
        else:
            _assert_same_table(g, w, 1e-5 if name == "groupby_pipeline"
                               else None)


@pytest.mark.gpu
def test_local_set_op_launches_scan_1d_six_times(gen):
    """Two run_extents calls of three scans each, all on the kernel."""
    left, right = _operator_tables("cuda")
    a, b = left.project("k"), right.project("k")
    for op in ("union", "intersect", "subtract"):
        scan.reset_launches()
        getattr(a, op)(b)
        assert scan.LAUNCHES["scan_1d"] == 6


@pytest.mark.gpu
def test_distributed_operators_on_the_card_equal_the_cpu(gen):
    """4 shards on the card against 4 on the CPU: the hash-shuffled
    unique and set ops shard for shard (murmur3 places rows alike on both),
    the range-partitioned sort after gathering (its bins are float32 on
    the card and float64 on the CPU); every distributed set op launches
    the hash kernel 4 times per table."""
    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline

    data = pipeline.make_data(6000)
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                      world_size=4))
        out[dev] = pipeline.distributed_operators(
            *pipeline.distributed_tables(ctx, *data))
    for name in ("distributed_unique", "distributed_union",
                 "distributed_intersect", "distributed_subtract"):
        _assert_same_table(out["cuda"][name], out["cpu"][name])
    for col in ("k", "lv"):
        np.testing.assert_array_equal(
            out["cuda"]["distributed_sort"].to_numpy()[col],
            out["cpu"]["distributed_sort"].to_numpy()[col])
    torch.testing.assert_close(out["cuda"]["sum"].cpu().double(),
                               out["cpu"]["sum"].double(), rtol=1e-5, atol=0)
    assert int(out["cuda"]["min"]) == int(out["cpu"]["min"])
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                  world_size=4))
    left, right = pipeline.distributed_tables(ctx, *data)
    hash_kernels.reset_launches()
    left.project("k").distributed_union(right.project("k"))
    assert hash_kernels.LAUNCHES == {"hash_partition": 8}


# -- string columns -----------------------------------------------------------

def _string_keys(device, n=5000, seed=9):
    """A string column with nulls and an int64 column, from one seed."""
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "Customer#000000001", "été", "x" * 40,
                      "a\x00b", "zz", None], object)
    return (column.from_numpy(words[rng.integers(0, len(words), n)],
                              capacity=n + 5, device=device),
            column.from_numpy(rng.integers(-9, 9, n).astype(np.int64),
                              capacity=n + 5, device=device))


@pytest.mark.gpu
def test_string_words_and_row_hash_on_the_card_equal_the_cpu(gen):
    """``pack_string_words`` and the row hash of string and mixed keys,
    bit for bit: the hash is plain PyTorch on both devices."""
    from cylon_tpu_torch.ops import hashing, keys

    (s_gpu, i_gpu), (s_cpu, i_cpu) = _string_keys("cuda"), _string_keys("cpu")
    for g, w in zip(keys.pack_string_words(s_gpu.data),
                    keys.pack_string_words(s_cpu.data)):
        assert torch.equal(g.cpu(), w)
    for k_gpu, k_cpu in (([s_gpu], [s_cpu]), ([s_gpu, i_gpu], [s_cpu, i_cpu])):
        assert torch.equal(hashing.hash_columns(k_gpu).cpu(),
                           hashing.hash_columns(k_cpu))


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_string_join_groupby_on_the_card_equals_the_cpu(gen, world):
    """``pipeline.string_join_groupby`` on the card against the CPU: group
    keys and counts exact, sums and means rtol 1e-5; on the card it
    launches both scan kernels and, with string keys, no murmur3."""
    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline

    data = pipeline.make_data(6000)
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = (CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                       world_size=world))
               if world > 1 else CylonContext.Init(dev))
        scan.reset_launches()
        hash_kernels.reset_launches()
        groups, joined = pipeline.string_join_groupby(
            *pipeline.string_tables(ctx, *data))
        out[dev] = (groups.to_numpy(), joined.row_count,
                    dict(scan.LAUNCHES), dict(hash_kernels.LAUNCHES))
    (g, jm, scans, hashes), (w, wm, _, _) = out["cuda"], out["cpu"]
    assert jm == wm
    og, ow = np.argsort(g["l_k"]), np.argsort(w["l_k"])
    np.testing.assert_array_equal(g["l_k"][og], w["l_k"][ow])
    for name in ("sum_lv", "mean_rv"):
        np.testing.assert_allclose(g[name][og].astype(np.float64),
                                   w[name][ow].astype(np.float64), rtol=1e-5)
    assert scans["scan_1d"] > 0 and scans["segmented_scan"] > 0
    assert hashes == {"hash_partition": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_tpch_q1_on_the_card_equals_the_cpu(gen, world):
    from cylon_tpu_torch import CylonContext, MeshConfig, pipeline

    data = pipeline.lineitem(0.01, 5)
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = (CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                       world_size=world))
               if world > 1 else CylonContext.Init(dev))
        out[dev] = pipeline.tpch_q1(pipeline.lineitem_table(ctx, data)) \
            .to_numpy()
    g, w = out["cuda"], out["cpu"]
    og = np.lexsort((g["l_linestatus"], g["l_returnflag"]))
    ow = np.lexsort((w["l_linestatus"], w["l_returnflag"]))
    for name in w:
        if w[name].dtype == object or name.startswith("count"):
            np.testing.assert_array_equal(g[name][og], w[name][ow])
        else:
            np.testing.assert_allclose(g[name][og].astype(np.float64),
                                       w[name][ow].astype(np.float64),
                                       rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_hash_partition_folds_signed_zero_and_nan_on_the_card(gen, dtype):
    """The kernel folds float keys in registers as the plain version does:
    -0.0 hashes as +0.0, every NaN payload as one NaN, bit for bit with
    the plain version."""
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 1.5,
                         float("nan"), -float("nan")] * 300, dtype=dtype)
    if dtype == torch.float32:  # NaN payloads a cast would not make
        bits = vals.view(torch.int32)
        bits[5::7] = 0x7FC0BEEF
        bits[6::7] = 0x7F800001
    col = column.Column(vals.to("cuda"),
                        torch.ones(len(vals), dtype=torch.bool,
                                   device="cuda"), None,
                        column.dtypes.float_)
    for world in (4, 6):
        h, t = hash_kernels.hash_partition([col], world)
        ph, pt = hash_kernels.hash_partition_plain([col], world)
        assert torch.equal(h.view(torch.int32), ph.view(torch.int32))
        assert torch.equal(t, pt)
    h = h.view(torch.int32).cpu()
    assert h[0] == h[1] and h[5] == h[6]


UNSIGNED = (np.uint8, np.uint16, np.uint32, np.uint64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", UNSIGNED, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("world", [1, 4])
def test_unsigned_operators_on_the_card_equal_the_cpu(gen, dtype, world):
    """Descending sort, group-by MIN/MAX and scalar min/max of unsigned
    columns on the card equal the same calls on the CPU, exactly (the
    values span the type's top bit)."""
    from cylon_tpu_torch import CylonContext, MeshConfig, Table

    rng = np.random.default_rng(11)
    top = np.iinfo(dtype).max
    n = 3000
    k = rng.integers(0, top, n, dtype=dtype, endpoint=True)
    k[:4] = [0, top, top - 1, 1 << (8 * np.dtype(dtype).itemsize - 1)]
    g = rng.integers(0, 40, n).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                      world_size=world))
        t = Table.from_numpy(["g", "k"], [g, k], ctx=ctx)
        s = (t.sort("k", ascending=False) if world == 1
             else t.distributed_sort("k", ascending=False))
        gb = t.groupby("g", {"k": ["min", "max"]}).to_numpy()
        order = np.argsort(gb["g"])
        out[dev] = (s.to_numpy()["k"], gb["min_k"][order],
                    gb["max_k"][order], int(t.min("k").cpu().numpy()),
                    int(t.max("k").cpu().numpy()))
    np.testing.assert_array_equal(out["cuda"][0], np.sort(k)[::-1])
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a, b)
    assert out["cuda"][3:] == (int(k.min()), int(k.max()))


def _engine_results(device, data, passes):
    from cylon_tpu_torch import CylonContext, pipeline

    return pipeline.out_of_core_join_groupby(
        data, passes, ctx=CylonContext.Init(device))


@pytest.mark.gpu
def test_out_of_core_engine_on_the_card_equals_the_cpu(gen):
    """2^20 rows per side in 4 passes: the card (narrow, the default for
    CUDA tensors) against the CPU port in narrow mode, row for row: keys
    and stats exact, SUM and MEAN rtol 1e-5; both scan kernels launch in
    every pass on the card."""
    from cylon_tpu_torch import pipeline, precision

    data = pipeline.make_data(1 << 20)
    scan.reset_launches()
    got, gstats = _engine_results("cuda", data, 4)
    assert scan.LAUNCHES["scan_1d"] >= 4
    assert scan.LAUNCHES["segmented_scan"] >= 4
    precision.set_accumulation("narrow")
    try:
        want, wstats = _engine_results("cpu", data, 4)
    finally:
        precision.set_accumulation(None)
    for k in ("passes", "mode", "cap_l", "cap_r", "out_cap", "groups"):
        assert gstats[k] == wstats[k]
    np.testing.assert_array_equal(got["key"], want["key"])
    for k in ("agg0", "agg1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_out_of_core_engine_refines_under_a_capped_allocator(gen):
    """A real device OOM, no injected fault: capped between the peaks of
    the 2-pass and 4-pass runs, the 2-pass run splits at least once and
    gives the uncapped result (keys exact, sums and means rtol 1e-5)."""
    from cylon_tpu_torch import pipeline

    data = pipeline.make_data(1 << 20)
    peaks, results = {}, {}
    for passes in (2, 4):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        results[passes] = _engine_results("cuda", data, passes)[0]
        peaks[passes] = torch.cuda.max_memory_reserved()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(
            (peaks[2] + peaks[4]) / 2 / total)
        got, stats = _engine_results("cuda", data, 2)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    assert stats.get("oom_splits", 0) >= 1
    want = results[2]
    go, wo = np.argsort(got["key"]), np.argsort(want["key"])
    np.testing.assert_array_equal(got["key"][go], want["key"][wo])
    for k in ("agg0", "agg1"):
        np.testing.assert_allclose(got[k][go], want[k][wo], rtol=1e-5,
                                   atol=1e-6)


# -- the hash join and the distributed group-bys ------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_hash_join_on_the_card_equals_the_cpu(gen, how):
    """``Table.join(..., algorithm="hash")`` on the card against the same
    join on the CPU, slot for slot (the table, chain heads and ranges are
    integer work), with float keys holding -0.0, +0.0 and NaN (null)."""
    from cylon_tpu_torch import CylonContext, Table, pipeline
    from cylon_tpu_torch.ops import hash_join

    lk, lv, rk, rv = pipeline.make_data(20000)
    fk_l = (lk % 300).astype(np.float32)
    fk_r = (rk % 300).astype(np.float32)
    fk_l[::13], fk_r[::11] = -0.0, 0.0
    fk_l[::17], fk_r[::19] = np.nan, np.nan
    out = {}
    for dev in ("cuda", "cpu"):
        ctx = CylonContext.Init(dev)
        left = Table.from_numpy(["k", "lv"], [fk_l, lv], ctx=ctx)
        right = Table.from_numpy(["k", "rv"], [fk_r, rv], ctx=ctx)
        hash_join.reset_rounds()
        out[dev] = left.join(right, on="k", how=how, algorithm="hash")
        assert hash_join.ROUNDS["build"] > 0
        if dev == "cpu":
            sort = left.join(right, on="k", how=how)
    _assert_same_table(out["cuda"], out["cpu"])
    _assert_same_table(out["cuda"], sort)  # the sort join's rows


@pytest.mark.gpu
def test_hash_join_pipeline_on_the_card_equals_the_cpu(gen):
    """``pipeline.join_groupby(..., algo="hash")`` at 2^20 rows per side:
    group keys and counts exact, SUM and MEAN rtol 1e-5; both scan kernels
    launch on the card."""
    from cylon_tpu_torch import pipeline, precision

    data = pipeline.make_data(1 << 20)
    res = {}
    for dev in ("cuda", "cpu"):
        tables = pipeline.tables(*data, device=dev)
        precision.set_accumulation("narrow")
        try:
            m = pipeline.join_count(*tables, algo="hash")
            scan.reset_launches()
            res[dev] = pipeline.join_groupby(*tables, pipeline.cap_round(m),
                                             algo="hash")
            if dev == "cuda":
                assert scan.LAUNCHES["scan_1d"] >= 2
                assert scan.LAUNCHES["segmented_scan"] >= 1
        finally:
            precision.set_accumulation(None)
    (gc_, gg, gj), (wc, wg, wj) = res["cuda"], res["cpu"]
    assert int(gj) == int(wj) and int(gg) == int(wg) > 0
    n = int(wg)
    assert torch.equal(gc_[0].data[:n].cpu(), wc[0].data[:n])
    for g, w in zip(gc_[1:], wc[1:]):
        torch.testing.assert_close(g.data[:n].cpu().double(),
                                   w.data[:n].double(), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_distributed_groupbys_on_the_card_equal_the_cpu(gen):
    """4 shards on the card against 4 on the CPU, both narrow: the
    pipeline group-by of a range-sorted table and the NUNIQUE (plain and
    salted) group-bys, shard for shard (murmur3 places rows alike on
    both); float sums rtol 1e-5; ``broadcast_gather`` exact."""
    from cylon_tpu_torch import pipeline, precision

    lk, lv, _, _ = pipeline.make_data(8000)
    w = (lk % 37).astype(np.int64)
    out = {}
    precision.set_accumulation("narrow")
    try:
        _distributed_groupbys(out, lk, lv, w)
    finally:
        precision.set_accumulation(None)
    _assert_same_table(out["cuda"]["pipeline"], out["cpu"]["pipeline"],
                       1e-5)
    for name in ("nunique", "salted", "broadcast"):
        _assert_same_table(out["cuda"][name], out["cpu"][name])


def _distributed_groupbys(out, lk, lv, w):
    from cylon_tpu_torch import CylonContext, MeshConfig, Table
    from cylon_tpu_torch.ops.groupby import AggOp
    from cylon_tpu_torch.parallel import ops as par_ops

    for dev in ("cuda", "cpu"):
        ctx = CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                      world_size=4))
        t = Table.from_numpy(["k", "lv", "w"], [lk % 500, lv, w], ctx=ctx)
        hash_kernels.reset_launches()
        out[dev] = {
            "pipeline": t.distributed_sort("k").groupby(
                "k", {"lv": ["sum", "mean"]}, groupby_type="pipeline"),
            "nunique": t.groupby("k", {"w": "nunique"}),
            "salted": par_ops.distributed_groupby(
                t, (0,), ((2, AggOp.NUNIQUE),), 0, salt=4),
            "broadcast": par_ops.broadcast_gather(t.project(["k", "w"])),
        }
        if dev == "cuda":
            assert hash_kernels.LAUNCHES["hash_partition"] >= 12


# -- the rest of the out-of-core rung and the collective retries --------------

def _standalone_results(device, lk, lv, passes):
    from cylon_tpu_torch import CylonContext, pipeline

    ctx = CylonContext.Init(device)
    return {"groupby": pipeline.out_of_core_groupby(lk, lv, passes, ctx=ctx),
            "sort": pipeline.out_of_core_sort(lk, lv, passes, ctx=ctx),
            "repartition": pipeline.out_of_core_repartition(
                lk, lv, 4, passes, ctx=ctx)}


@pytest.mark.gpu
def test_standalone_out_of_core_operators_on_the_card_equal_the_cpu(gen):
    """``chunked_groupby``, ``chunked_sort`` and ``chunked_repartition`` at
    2^20 rows in 4 passes: the card (narrow) against the CPU port in
    narrow mode, row for row.  Keys, counts, sorted rows and repartition
    shards exact (murmur3 places rows alike on both devices); float32
    sums and means rtol 1e-5.  Every pass launches both scan kernels in
    the group-by and the hash kernel in the repartition."""
    from cylon_tpu_torch import pipeline, precision

    lk, lv, _, _ = pipeline.make_data(1 << 20)
    scan.reset_launches()
    hash_kernels.reset_launches()
    got = _standalone_results("cuda", lk, lv, 4)
    assert scan.LAUNCHES["scan_1d"] >= 4
    assert scan.LAUNCHES["segmented_scan"] >= 4
    assert hash_kernels.LAUNCHES["hash_partition"] >= 4
    precision.set_accumulation("narrow")
    try:
        want = _standalone_results("cpu", lk, lv, 4)
    finally:
        precision.set_accumulation(None)
    (g, gs), (w, ws) = got["groupby"], want["groupby"]
    assert gs["groups"] == ws["groups"] == len(np.unique(lk))
    np.testing.assert_array_equal(g["k"], w["k"])
    np.testing.assert_array_equal(g["count_v"], w["count_v"])
    for k in ("sum_v", "mean_v"):
        np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6)
    (s, _), (t, _) = got["sort"], want["sort"]
    np.testing.assert_array_equal(s["k"], np.sort(lk))
    for k in ("k", "v"):
        np.testing.assert_array_equal(s[k], t[k])
    (parts, ps), (wparts, wps) = got["repartition"], want["repartition"]
    assert ps["per_target"] == wps["per_target"]
    assert sum(ps["per_target"]) == len(lk)
    for a, b in zip(parts, wparts):
        for k in ("k", "v"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.gpu
def test_cuda_shuffle_heals_an_injected_comm_fault(gen):
    """The shuffle's exchange on CUDA tensors retries a ``comm`` fault
    under the context's policy and equals the unfaulted shuffle."""
    from cylon_tpu_torch import CylonContext, MeshConfig, Table
    from cylon_tpu_torch import config, resilience

    rng = np.random.default_rng(3)
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                  world_size=4))
    t = Table.from_numpy(["k", "v"], [rng.integers(0, 1000, 50000),
                                      rng.random(50000)], ctx=ctx)
    base = t.shuffle("k")
    with config.knob_env(CYLON_TPU_RETRY_BASE_S="0"):
        with resilience.fault_plan("shuffle@1=comm") as plan:
            res = t.shuffle("k")
    assert plan.fired == [("shuffle", "comm", 1)]
    assert plan.hits["shuffle"] == 2
    assert res.row_counts.tolist() == base.row_counts.tolist()
    for a, b in zip(res.shards, base.shards):
        for x, y in zip(a, b):
            assert torch.equal(x.data, y.data)
            assert torch.equal(x.validity, y.validity)


@pytest.mark.gpu
def test_oneshot_join_falls_back_on_the_card(gen):
    """An injected OOM in the one-shot join on the card runs the chunked
    engine on the card: the same rows as the one-shot join."""
    from cylon_tpu_torch import CylonContext, Table, resilience

    rng = np.random.default_rng(4)
    ctx = CylonContext.Init("cuda")
    lt = Table.from_numpy(["k", "a"], [rng.integers(0, 5000, 20000),
                                       rng.integers(0, 99, 20000)], ctx=ctx)
    rt = Table.from_numpy(["k", "b"], [rng.integers(0, 5000, 20000),
                                       rng.integers(0, 99, 20000)], ctx=ctx)
    base = lt.join(rt, on="k").to_numpy()
    with resilience.fault_plan("oneshot_join@1=oom"):
        res = lt.join(rt, on="k")
    assert res.shards[0][0].device.type == "cuda"
    got = res.to_numpy()
    names = sorted(base)
    go = np.lexsort(tuple(got[n] for n in names))
    bo = np.lexsort(tuple(base[n] for n in names))
    for n in names:
        np.testing.assert_array_equal(got[n][go], base[n][bo])


def _frame_csv(tmp_path, n=5000, seed=5):
    import pandas as pd

    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"id": np.arange(n, dtype=np.int64),
                       "v": rng.random(n),
                       "name": [f"row_{i % 37}" for i in range(n)]})
    df.loc[3, "v"] = np.nan
    path = tmp_path / "t.csv"
    df.to_csv(path, index=False)
    return df, path


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_csv_read_on_the_card_equals_the_cpu_read(gen, tmp_path, world):
    """The native reader's buffers uploaded to the card hold what the same
    read puts on the CPU, slot for slot."""
    from cylon_tpu_torch import CylonContext, MeshConfig, Table, interop, io

    _, path = _frame_csv(tmp_path)

    def ctx(dev):
        return (CylonContext.Init(dev) if world == 1 else
                CylonContext.InitDistributed(MeshConfig(devices=[dev],
                                                        world_size=world)))

    io.reset_reader_counts()
    card = Table.from_csv(path, ctx=ctx("cuda"))
    cpu = Table.from_csv(path, ctx=ctx("cpu"))
    assert io.reader_counts()["csv_read_native"] == 2
    assert all(c.device.type == "cuda" for s in card.shards for c in s)
    n1, s1, c1 = interop.table_shards_to_arrays(card)
    n2, s2, c2 = interop.table_shards_to_arrays(cpu)
    assert n1 == n2 and list(c1) == list(c2)
    for a, b in zip(s1, s2):
        for x, y in zip(a, b):
            for u, v in zip(x[:3], y[:3]):
                if u is None:
                    assert v is None
                else:
                    np.testing.assert_array_equal(u, v)


@pytest.mark.gpu
def test_to_pandas_from_the_card(gen, tmp_path):
    import pandas as pd

    from cylon_tpu_torch import CylonContext, MeshConfig, Table

    df, path = _frame_csv(tmp_path)
    ctx = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                  world_size=4))
    t = Table.from_csv(path, ctx=ctx)
    pd.testing.assert_frame_equal(t.to_pandas(), df)
    pd.testing.assert_frame_equal(Table.from_pandas(df, ctx=ctx).to_pandas(),
                                  df)


@pytest.mark.gpu
def test_loc_and_iloc_on_the_card(gen, tmp_path):
    from cylon_tpu_torch import CylonContext, Table

    df, path = _frame_csv(tmp_path)
    t = Table.from_csv(path, ctx=CylonContext.Init("cuda"))
    t.set_index("name")
    got = t.loc["row_5"]
    assert got.shards[0][0].device.type == "cuda"
    assert got.to_pydict()["id"] == df.index[df["name"] == "row_5"].tolist()
    assert t.iloc[10:20].to_pydict()["id"] == list(range(10, 20))
    assert t.iloc[[7, 3, -1]].to_pydict()["id"] == [7, 3, len(df) - 1]
    t.set_index("id")
    assert t.loc[100:104].to_pydict()["name"] == \
        df["name"][100:105].tolist()


# -- the exchange plane (parallel/plane.py) -----------------------------------

def _mixed_frame(n, seed=21):
    """Every physical layout: 64/32/16/8-bit ints, unsigned ones, floats
    of three widths with NaN and -0.0, bool, low-cardinality and wide
    strings with nulls."""
    rng = np.random.default_rng(seed)
    f32 = rng.random(n).astype(np.float32)
    f32[:2] = (np.nan, -0.0)
    cats = np.array(["AA", "B", None, "CCC", ""], object)
    wide = np.array(["alpha", None, "z" * 37, "beta", "été"], object)
    return {
        "k": rng.integers(0, 1 << 20, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n).astype(np.int64),
        "u64": rng.integers(0, 2**62, n).astype(np.uint64)
        + np.uint64(2**63),
        "u32": rng.integers(0, 2**32, n).astype(np.uint32),
        "i16": rng.integers(-2**15, 2**15, n).astype(np.int16),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "f32": f32,
        "f64": rng.random(n),
        "f16": rng.random(n).astype(np.float16),
        "b": rng.integers(0, 2, n).astype(bool),
        "cat": cats[rng.integers(0, 5, n)],
        "wide": wide[rng.integers(0, 5, n)],
    }


def _assert_same_bits(got, want):
    """Two tables of one layout, bit for bit (floats by their bits, NaN
    and -0.0 included): counts, and every shard's validity, data and
    lengths over the whole capacity, wherever each lies."""
    assert got.names == want.names
    assert got.row_counts.tolist() == want.row_counts.tolist()
    for gs, ws in zip(got.shards, want.shards):
        for g, w in zip(gs, ws):
            assert torch.equal(g.validity.cpu(), w.validity.cpu())
            assert torch.equal(g.data.cpu().contiguous().view(torch.uint8),
                               w.data.cpu().contiguous().view(torch.uint8))
            assert (g.lengths is None) == (w.lengths is None)
            if g.lengths is not None:
                assert torch.equal(g.lengths.cpu(), w.lengths.cpu())


@pytest.mark.gpu
def test_packed_compressed_and_per_buffer_shuffles_on_the_card(gen):
    """A mixed-dtype table of 2^16 rows on 4 shards of the card: per
    buffer, packed and packed + compressed shuffles are bit-identical to
    each other and to the CPU's per-buffer shuffle; the packed exchange
    launches one all_to_all, the plane of a shard is the CPU's bit for bit
    (64-bit columns split low word first), and the broadcast and
    HashPartition agree across realizations."""
    from cylon_tpu_torch import CylonContext, MeshConfig, Table, config
    from cylon_tpu_torch.obs import metrics
    from cylon_tpu_torch.parallel import ops as par_ops, plane, shuffle

    frame = _mixed_frame(1 << 16)
    tables = {dev: Table.from_pydict(frame, ctx=CylonContext.InitDistributed(
        MeshConfig(devices=[dev], world_size=4))) for dev in ("cuda", "cpu")}
    cuda_plane = plane.pack_plane(tables["cuda"].shards[0])
    assert cuda_plane.is_cuda
    assert torch.equal(cuda_plane.cpu(),
                       plane.pack_plane(tables["cpu"].shards[0]))
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK="0"):
        want = tables["cpu"].shuffle(["k"])
    arms = {"perbuf": ("0", "0"), "packed": ("1", "0"), "comp": ("1", "1")}
    for label, (pack, comp) in arms.items():
        metrics.reset()
        hash_kernels.reset_launches()
        with config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack,
                             CYLON_TPU_SHUFFLE_COMPRESS=comp):
            got = tables["cuda"].shuffle(["k"])
            bc = par_ops.broadcast_gather(tables["cuda"].project(["k", "cat"]))
            hp = tables["cuda"].hash_partition(["k"], 3)
        assert hash_kernels.LAUNCHES["hash_partition"] == 8, label
        c = metrics.snapshot()["counters"]
        per_buffer = (shuffle.buffer_count(tables["cuda"].shards[0]) + 1
                      + shuffle.buffer_count(bc.shards[0]))
        assert c["shuffle.collective_launches"] == (
            per_buffer if pack == "0" else 2), (label, c)
        if comp == "1":
            assert metrics.snapshot()["gauges"]["shuffle.compress_ratio"] > 1
        _assert_same_bits(got, want)
        assert bc.row_counts.tolist() == [1 << 16] * 4
        if label == "perbuf":
            bc0, hp0 = bc, hp
        else:
            _assert_same_bits(bc, bc0)
            for p in hp0:
                _assert_same_bits(hp[p], hp0[p])


@pytest.mark.gpu
def test_nccl_group_of_one_rank_equals_the_mesh(gen):
    """A context over an NCCL group of one rank holding 4 shards on the
    card: the distributed join -> group-by equals the in-process mesh's
    shard for shard (the collectives go through NCCL, self included),
    under both exchange realizations, and launches the hash and scan
    kernels."""
    from cylon_tpu_torch import CylonContext, MeshConfig, config, pipeline

    data = pipeline.make_data(1 << 16)
    mesh = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                   world_size=4))
    group = CylonContext.InitDistributed(MeshConfig(
        devices=["cuda"], world_size=4, num_processes=1))
    try:
        assert group.group.backend == "nccl" and group.GetWorldSize() == 4
        assert not group.multi_process() and group.GetRank() == 0
        for pack in ("0", "1"):
            with config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack):
                want = pipeline.distributed_join_groupby(
                    *pipeline.distributed_tables(mesh, *data))
                hash_kernels.reset_launches()
                scan.reset_launches()
                got = pipeline.distributed_join_groupby(
                    *pipeline.distributed_tables(group, *data))
            assert hash_kernels.LAUNCHES["hash_partition"] >= 12
            assert scan.LAUNCHES["scan_1d"] >= 1
            assert scan.LAUNCHES["segmented_scan"] >= 1
            for g, w in zip(got, want):
                _assert_same_bits(g, w)
        group.Barrier()
    finally:
        group.Finalize()


@pytest.mark.gpu
def test_cuda_shards_refuse_a_gloo_group(gen):
    """CUDA shards never ride gloo through host copies: given a gloo
    group already formed, the context raises."""
    import socket

    import torch.distributed as dist

    from cylon_tpu_torch import CylonContext, CylonError, MeshConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(CylonError, match="rides gloo"):
            CylonContext.InitDistributed(MeshConfig(
                devices=["cuda"], world_size=2, num_processes=1))
    finally:
        dist.destroy_process_group()


def _tpch_q10_tables(ctx, sf: float):
    """Q10's four tables drawn by ``examples/tpch_data.py`` on ``ctx``."""
    from cylon_tpu_torch import Table
    from examples import tpch_data

    rng = np.random.default_rng(0)
    raw = [tpch_data.customer(sf, rng), tpch_data.orders(sf, rng)]
    line = tpch_data.lineitem(sf, rng, q5_keys=True,
                              orders_rows=len(raw[1]["o_orderkey"]))
    line.pop("l_suppkey")
    raw += [line, tpch_data.nation()]
    return [Table.from_numpy(list(d), list(d.values()), ctx=ctx)
            for d in raw]


@pytest.mark.gpu
def test_planned_tpch_q10_on_the_card_equals_eager(gen):
    """TPC-H Q10 at sf 0.01 through the planner on 4 shards of the card:
    at least one shuffle elided, bit for bit the eager lowering's table,
    and the CPU's planned result (floats within rtol 1e-5: the card sums
    in float32 by the scan kernels)."""
    from cylon_tpu_torch import CylonContext, MeshConfig, config, pipeline
    from cylon_tpu_torch.obs import metrics as obs_metrics

    card = CylonContext.InitDistributed(MeshConfig(devices=["cuda"],
                                                   world_size=4))
    plan = pipeline.tpch_q10_plan(*_tpch_q10_tables(card, 0.01))
    before = obs_metrics.counter_value("plan.shuffles_elided")
    scan.reset_launches()
    hash_kernels.reset_launches()
    planned = plan.execute().to_pandas()
    assert obs_metrics.counter_value("plan.shuffles_elided") > before
    assert hash_kernels.LAUNCHES["hash_partition"] > 0
    assert scan.LAUNCHES["scan_1d"] > 0 and scan.LAUNCHES["segmented_scan"] > 0
    with config.knob_env(CYLON_TPU_PLAN="0"):
        eager = plan.execute().to_pandas()
    assert len(planned) == pipeline.Q10_TOP
    for c in planned.columns:
        np.testing.assert_array_equal(planned[c].to_numpy(),
                                      eager[c].to_numpy(), err_msg=c)
    cpu = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                  world_size=4))
    want = pipeline.tpch_q10_plan(*_tpch_q10_tables(cpu, 0.01)).execute(
    ).to_pandas()
    np.testing.assert_array_equal(planned["c_custkey"], want["c_custkey"])
    np.testing.assert_allclose(planned["sum_revenue"], want["sum_revenue"],
                               rtol=1e-5)


@pytest.mark.gpu
def test_plan_fingerprint_on_the_card(gen):
    """A plan over tables on the card fingerprints alike across two calls
    (and alike to the same plan over CPU tables: the content, not the
    device, is hashed), and changes when a kept column's content does."""
    from cylon_tpu_torch import CylonContext, MeshConfig, Table
    from cylon_tpu_torch.plan import col

    d = {"k": np.arange(64, dtype=np.int32) % 9,
         "v": np.linspace(0, 1, 64, dtype=np.float32)}

    def fp(devices, data):
        ctx = CylonContext.InitDistributed(MeshConfig(devices=devices,
                                                      world_size=2))
        t = Table.from_numpy(list(data), list(data.values()), ctx=ctx)
        return (t.plan().filter(col("v") > 0.25)
                .groupby(["k"], {"v": ["sum"]}).fingerprint())

    first = fp(["cuda"], d)
    assert first == fp(["cuda"], d) == fp(["cpu"], d)
    assert fp(["cuda"], dict(d, v=d["v"] + 1)) != first


@pytest.mark.gpu
def test_journaled_engine_resumes_on_the_card(gen, tmp_path):
    """A journaled 4-pass engine run on the card: killed (a persistent
    injected comm fault, no retries) after two committed passes, then
    resumed in-process from its journal, bit for bit the unjournaled run;
    a full journal hit then launches no kernel.  Every frame reaches the
    journal as host numpy (``record_pass`` raises on a tensor)."""
    from cylon_tpu_torch import CylonContext, config, resilience
    from cylon_tpu_torch.exec import chunked_join_groupby_tables

    rng = np.random.default_rng(13)
    n = 1 << 18
    left = {"k": rng.integers(0, n, n).astype(np.int32),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int32),
             "b": rng.random(n).astype(np.float32)}
    ctx = CylonContext.Init("cuda")

    def run():
        return chunked_join_groupby_tables(
            left, right, on="k", group_by="l_k",
            agg={"a": ["sum"], "b": ["mean"]}, passes=4, ctx=ctx)

    def launches():
        return {**scan.LAUNCHES, **hash_kernels.LAUNCHES}

    base, _ = run()
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path),
                         CYLON_TPU_RETRY_MAX="0"):
        with resilience.fault_plan("host_fetch@3+=comm"):
            with pytest.raises(Exception):
                run()
        resumed, s1 = run()
        scan.reset_launches()
        hash_kernels.reset_launches()
        hit, s2 = run()
        assert all(v == 0 for v in launches().values()), launches()
    assert (s1["passes_skipped"], s1["parts_run"]) == (2, 2)
    assert s2["passes_skipped"] == 4 and "parts_run" not in s2
    for got in (resumed, hit):
        assert list(got) == list(base)
        for k in base:
            assert np.array_equal(got[k].view(np.uint8),
                                  base[k].view(np.uint8)), k


@pytest.mark.gpu
def test_served_join_groupby_on_the_card_equals_the_direct_call(gen,
                                                                tmp_path):
    """A ``join_groupby`` served by ``QueryService()`` (the card's default
    context; its scheduler thread binds that card) equals the direct
    engine call bit for bit and launches the kernels; its repeat under a
    durable dir is a result-cache hit that launches none."""
    from cylon_tpu_torch import config
    from cylon_tpu_torch.exec import chunked_join_groupby_tables
    from cylon_tpu_torch.serve import QueryService

    rng = np.random.default_rng(17)
    n = 1 << 18
    left = {"k": rng.integers(0, n, n).astype(np.int32),
            "a": rng.random(n).astype(np.float32)}
    right = {"k": rng.integers(0, n, n).astype(np.int32),
             "b": rng.random(n).astype(np.float32)}
    kw = dict(on="k", group_by="l_k", agg={"a": ["sum", "mean"]},
              passes=4)
    direct, _ = chunked_join_groupby_tables(left, right, **kw)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        with QueryService() as svc:
            scan.reset_launches()
            served, _ = svc.submit("t", "join_groupby", left, right,
                                   **kw).result(timeout=300)
            assert scan.LAUNCHES["scan_1d"] > 0
            scan.reset_launches()
            hit = svc.submit("t", "join_groupby", left, right, **kw)
            again, _ = hit.result(timeout=300)
            assert hit.cache_hit
            assert scan.LAUNCHES == {"scan_1d": 0, "segmented_scan": 0}
    for frame in (served, again):
        assert list(frame) == list(direct)
        for k in direct:
            assert np.asarray(frame[k]).tobytes() == \
                np.asarray(direct[k]).tobytes(), k


@pytest.mark.gpu
def test_stream_refresh_on_the_card_equals_recompute_cold(gen, tmp_path):
    """An incremental group-by on the card (float32 sums through the scan
    kernels): each refresh equals ``recompute_cold()`` bit for bit, the
    second folds only the new batches, and the sums agree with a float64
    oracle within rtol 1e-5."""
    from cylon_tpu_torch import config
    from cylon_tpu_torch.stream import GroupByQuery, StreamTable

    rng = np.random.default_rng(23)
    batches = [{"k": rng.integers(0, 1 << 15, 1 << 16).astype(np.int64),
                "v": rng.random(1 << 16)} for _ in range(6)]
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        s = StreamTable("card")
        for b in batches[:4]:
            s.append(b)
        q = GroupByQuery(s, ["k"], {"v": ["sum", "mean", "count"]})
        f4, st4 = q.refresh()
        for b in batches[4:]:
            s.append(b)
        scan.reset_launches()
        f6, st6 = q.refresh()
        assert scan.LAUNCHES["segmented_scan"] > 0
        assert st4["parts_run"] == 4 and st6["parts_run"] == 2
        cold = q.recompute_cold()
    for k in cold:
        assert np.asarray(f6[k]).tobytes() == np.asarray(cold[k]).tobytes()
    k = np.concatenate([b["k"] for b in batches])
    v = np.concatenate([b["v"] for b in batches])
    keys, inv = np.unique(k, return_inverse=True)
    np.testing.assert_array_equal(f6["k"], keys)
    np.testing.assert_allclose(f6["sum_v"], np.bincount(inv, v), rtol=1e-5)
    np.testing.assert_array_equal(f6["count_v"], np.bincount(inv))
