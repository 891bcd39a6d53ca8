"""CSV/Parquet I/O of the PyTorch port against the JAX package, on the same
files in ``tmp_path``: every case of ``tests/test_io.py``, each read
compared shard for shard, slot for slot, with the reference's read of the
same file (a file read onto a mesh needs no hash, so shards compare
directly) and against the pandas oracle the reference test uses.  Files
the two packages write from the same table compare byte for byte: both
write through the same native writer.  Then what the port adds to check:
its native reader against its pyarrow reader (``CYLON_TPU_NO_NATIVE_IO``),
the reader counts, and the IPC frame codec's round trip, bit for bit,
dtype included."""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu import CylonError as RCylonError
from cylon_tpu import Table as RTable
from cylon_tpu.io import CSVReadOptions as RCSVReadOptions
from cylon_tpu.io import CSVWriteOptions as RCSVWriteOptions
from cylon_tpu.io import arrow_io as rarrow_io
from cylon_tpu_torch import CylonContext, CylonError, MeshConfig, Table, io
from cylon_tpu_torch.config import knob_env
from cylon_tpu_torch.io import CSVReadOptions, CSVWriteOptions

from .torch_parity import assert_shards_equal
from .utils import assert_rows_equal


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.Init("cpu")


def _mesh(world):
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


@pytest.fixture(scope="module")
def pctx2():
    return _mesh(2)


@pytest.fixture(scope="module")
def pctx4():
    return _mesh(4)


def _frame(rng, n=60):
    return pd.DataFrame({
        "id": np.arange(n, dtype=np.int64),
        "v": rng.random(n),
        "name": [f"row_{i % 7}" for i in range(n)],
    })


def test_csv_roundtrip_local(tmp_path, local_ctx, pctx, rng):
    df = _frame(rng)
    p = tmp_path / "t.csv"
    df.to_csv(p, index=False)
    t = Table.from_csv(p, ctx=pctx)
    assert_shards_equal(t, RTable.from_csv(p, ctx=local_ctx))
    assert t.row_count == len(df)
    assert t.column_names == ["id", "v", "name"]
    pd.testing.assert_frame_equal(t.to_pandas(), df)

    out, ref_out = tmp_path / "out.csv", tmp_path / "ref_out.csv"
    t.to_csv(out)
    RTable.from_csv(p, ctx=local_ctx).to_csv(ref_out)
    assert out.read_bytes() == ref_out.read_bytes()
    pd.testing.assert_frame_equal(pd.read_csv(out), df)


def test_csv_options_delimiter_and_types(tmp_path, local_ctx, pctx, rng):
    df = _frame(rng, 20)
    p = tmp_path / "t.psv"
    df.to_csv(p, index=False, sep="|")
    opts = (CSVReadOptions().WithDelimiter("|").UseThreads(False)
            .WithColumnTypes({"id": np.int32}))
    ropts = (RCSVReadOptions().WithDelimiter("|").UseThreads(False)
             .WithColumnTypes({"id": np.int32}))
    t = Table.from_csv(p, options=opts, ctx=pctx)
    assert_shards_equal(t, RTable.from_csv(p, options=ropts, ctx=local_ctx))
    assert t.shards[0][0].data.numpy().dtype == np.int32
    assert t.row_count == len(df)

    out, ref_out = tmp_path / "o.psv", tmp_path / "ref_o.psv"
    t.to_csv(out, options=CSVWriteOptions().WithDelimiter("|"))
    RTable.from_csv(p, options=ropts, ctx=local_ctx).to_csv(
        ref_out, options=RCSVWriteOptions().WithDelimiter("|"))
    assert out.read_bytes() == ref_out.read_bytes()
    got = pd.read_csv(out, sep="|")
    assert list(got.columns) == list(df.columns)
    assert len(got) == len(df)


def test_csv_null_values(tmp_path, local_ctx, pctx):
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,x\nNA,y\n3,NA\n")
    opts = CSVReadOptions().NullValues(["NA"]).StringsCanBeNull()
    ropts = RCSVReadOptions().NullValues(["NA"]).StringsCanBeNull()
    t = Table.from_csv(p, options=opts, ctx=pctx)
    assert_shards_equal(t, RTable.from_csv(p, options=ropts, ctx=local_ctx))
    d = t.to_pydict()
    assert d["a"] == [1, None, 3]
    assert d["b"] == ["x", "y", None]


def test_csv_distributed_single_file(tmp_path, ctx4, pctx4, rng):
    df = _frame(rng, 101)
    p = tmp_path / "t.csv"
    df.to_csv(p, index=False)
    t = Table.from_csv(p, ctx=pctx4)
    assert_shards_equal(t, RTable.from_csv(p, ctx=ctx4))
    assert t.num_shards == 4
    assert t.row_count == len(df)
    pd.testing.assert_frame_equal(t.to_pandas(), df)


def test_csv_multi_file_per_shard(tmp_path, ctx4, pctx4, rng):
    paths, frames = [], []
    for s in range(4):
        df = _frame(rng, 10 + 3 * s)
        p = tmp_path / f"part_{s}.csv"
        df.to_csv(p, index=False)
        paths.append(p)
        frames.append(df)
    t = Table.from_csv(paths, ctx=pctx4)
    assert_shards_equal(t, RTable.from_csv(paths, ctx=ctx4))
    assert t.num_shards == 4
    assert list(t.row_counts) == [len(f) for f in frames]
    pd.testing.assert_frame_equal(
        t.to_pandas(), pd.concat(frames, ignore_index=True))


def test_csv_multi_file_wrong_count(tmp_path, ctx4, pctx4, rng):
    df = _frame(rng, 10)
    p = tmp_path / "one.csv"
    df.to_csv(p, index=False)
    with pytest.raises(RCylonError):
        RTable.from_csv([p, p], ctx=ctx4)
    with pytest.raises(CylonError, match="2 files for a 4-shard mesh"):
        Table.from_csv([p, p], ctx=pctx4)


def test_parquet_roundtrip(tmp_path, local_ctx, pctx, rng):
    df = _frame(rng, 44)
    p = tmp_path / "t.parquet"
    df.to_parquet(p)
    t = Table.from_parquet(p, ctx=pctx)
    assert_shards_equal(t, RTable.from_parquet(p, ctx=local_ctx))
    pd.testing.assert_frame_equal(t.to_pandas(), df)
    out = tmp_path / "o.parquet"
    t.to_parquet(out)
    pd.testing.assert_frame_equal(pd.read_parquet(out), df)


def test_parquet_multi_file_distributed(tmp_path, ctx2, pctx2, rng):
    frames, paths = [], []
    for s in range(2):
        df = _frame(rng, 15 + s)
        p = tmp_path / f"p{s}.parquet"
        df.to_parquet(p)
        frames.append(df)
        paths.append(p)
    t = Table.from_parquet(paths, ctx=pctx2)
    assert_shards_equal(t, RTable.from_parquet(paths, ctx=ctx2))
    assert t.row_count == sum(len(f) for f in frames)
    pd.testing.assert_frame_equal(
        t.to_pandas(), pd.concat(frames, ignore_index=True))


def test_csv_per_shard_roundtrip_world4(tmp_path, ctx4, pctx4, rng):
    """world-4 per-shard write -> per-shard read; each shard's file is
    the reference's, byte for byte (reference: rank-local WriteCSV,
    table.cpp:243-256)."""
    df = _frame(rng, 101)
    t = Table.from_pandas(df, ctx=pctx4)
    ref = RTable.from_pandas(df, ctx=ctx4)
    assert_shards_equal(t, ref)
    t.to_csv(tmp_path / "part_{shard}.csv", per_shard=True)
    ref.to_csv(tmp_path / "ref_{shard}.csv", per_shard=True)
    paths = sorted(tmp_path.glob("part_*.csv"))
    assert len(paths) == 4
    for s, p in enumerate(paths):
        assert p.read_bytes() == (tmp_path / f"ref_{s}.csv").read_bytes()
    back = Table.from_csv(paths, ctx=pctx4)
    assert_shards_equal(back, RTable.from_csv(paths, ctx=ctx4))
    assert back.num_shards == 4
    assert_rows_equal(back, df)
    sizes = [len(pd.read_csv(p)) for p in paths]
    assert sum(sizes) == len(df)
    assert sizes == [int(c) for c in t.row_counts]


def test_csv_per_shard_requires_placeholder(tmp_path, ctx4, pctx4, rng):
    df = _frame(rng, 16)
    with pytest.raises(RCylonError):
        RTable.from_pandas(df, ctx=ctx4).to_csv(tmp_path / "flat.csv",
                                                per_shard=True)
    with pytest.raises(CylonError, match="placeholder"):
        Table.from_pandas(df, ctx=pctx4).to_csv(tmp_path / "flat.csv",
                                                per_shard=True)


def test_parquet_per_shard_roundtrip_world4(tmp_path, ctx4, pctx4, rng):
    df = _frame(rng, 77)
    df.loc[5, "v"] = np.nan  # nulls survive the parquet path
    t = Table.from_pandas(df, ctx=pctx4)
    t.to_parquet(tmp_path / "part_{shard}.parquet", per_shard=True)
    paths = sorted(tmp_path.glob("part_*.parquet"))
    assert len(paths) == 4
    back = Table.from_parquet(paths, ctx=pctx4)
    assert_shards_equal(back, RTable.from_parquet(paths, ctx=ctx4))
    assert_rows_equal(back, df)


def test_per_shard_write_local_table(tmp_path, local_ctx, pctx, rng):
    """per_shard on a 1-shard table writes exactly one file (shard 0)."""
    df = _frame(rng, 12)
    Table.from_pandas(df, ctx=pctx).to_csv(tmp_path / "p_{shard}.csv",
                                           per_shard=True)
    RTable.from_pandas(df, ctx=local_ctx).to_csv(tmp_path / "r_{shard}.csv",
                                                 per_shard=True)
    assert (tmp_path / "p_0.csv").read_bytes() == \
        (tmp_path / "r_0.csv").read_bytes()
    got = pd.read_csv(tmp_path / "p_0.csv")
    assert len(got) == len(df)


# -- what the port adds to check ----------------------------------------------

@pytest.mark.parametrize("world", [1, 4])
def test_native_and_pyarrow_readers_agree(tmp_path, rng, world):
    """The port's native reader and its pyarrow reader give the same
    table, and the reader counts say which served each file."""
    df = _frame(rng, 203)
    df.loc[7, "v"] = np.nan
    p = tmp_path / "t.csv"
    df.to_csv(p, index=False)
    ctx = CylonContext.Init("cpu") if world == 1 else _mesh(world)
    io.reset_reader_counts()
    native = Table.from_csv(p, ctx=ctx)
    with knob_env(CYLON_TPU_NO_NATIVE_IO="1"):
        arrow = Table.from_csv(p, ctx=ctx)
        arrow.to_csv(tmp_path / "pandas.csv")
    native.to_csv(tmp_path / "native.csv")
    counts = io.reader_counts()
    assert (counts["csv_read_native"], counts["csv_read_arrow"]) == (1, 1)
    assert (counts["csv_write_native"], counts["csv_write_pandas"]) == (1, 1)
    pd.testing.assert_frame_equal(native.to_pandas(), arrow.to_pandas())
    pd.testing.assert_frame_equal(native.to_pandas(), df)
    for name in ("pandas.csv", "native.csv"):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / name), df)
    assert list(native.row_counts) == list(arrow.row_counts)
    for a, b in zip(native.shards, arrow.shards):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.capacity == y.capacity


def _ipc_frames():
    nan_payload = np.array([0x7FF8000000000001], np.uint64).view(np.float64)
    strs = np.array(["a", None, "ünï", ""], object)
    byts = np.array([b"\x00x", None, b"", b"yz"], object)
    # the shape ``column.to_numpy`` emits for a nullable int32 column
    fixed = np.array([4, 0, -7, 0], np.int32).astype(object)
    fixed[1] = None
    return {
        "ints": {"i32": np.array([1, -2, 3, 4], np.int32),
                 "u64": np.array([0, 2**64 - 1, 5, 6], np.uint64),
                 "b": np.array([True, False, True, False])},
        "floats": {"f32": np.array([0.5, -0.0, np.inf, 1e-30], np.float32),
                   "f64": np.concatenate([nan_payload,
                                          [-0.0, 1.0 / 3, -np.inf]])},
        "strings": {"u": np.array(["x", "yy", "", "zzz"]),
                    "s": np.array([b"p", b"qq", b"", b"r"]),
                    "obj_str": strs, "obj_bytes": byts,
                    "obj_fixed": fixed,
                    "obj_null": np.array([None] * 4, object)},
        "empty": {"i64": np.zeros(0, np.int64),
                  "obj": np.zeros(0, object)},
    }


@pytest.mark.parametrize("case", sorted(_ipc_frames()))
def test_ipc_frame_roundtrip_bit_for_bit(case):
    """The frame codec the run journal will use: the port's bytes are the
    reference's, and the round trip restores every column bit for bit,
    dtype included (NaN payloads, -0.0, None cells, str vs bytes)."""
    frame = _ipc_frames()[case]
    payload = io.frame_to_ipc_bytes(frame)
    assert payload == rarrow_io.frame_to_ipc_bytes(frame)
    back = io.frame_from_ipc_bytes(payload)
    ref = rarrow_io.frame_from_ipc_bytes(payload)
    assert list(back) == list(frame) == list(ref)
    for name, want in frame.items():
        got = back[name]
        assert got.dtype == want.dtype == ref[name].dtype, name
        if want.dtype == object:
            assert [type(v) for v in got] == [type(v) for v in want], name
            assert got.tolist() == want.tolist(), name
        else:
            assert got.tobytes() == want.tobytes(), name


def test_ipc_frame_refuses_mixed_object_dtypes():
    frame = {"mix": np.array([np.float32(1.0), np.float64(2.0)], object)}
    with pytest.raises(CylonError, match="mixed object-column"):
        io.frame_to_ipc_bytes(frame)
