"""The port's twin of ``tests/test_strings_scale.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.  The reference marks the
suite slow for its 4M-row cases; the twin runs them at 1M rows (250k per
shard of 4), so every case runs in the tier-1 suite.

String memory story + scale/adversarial property tests (VERDICT r1 #8/#9):
width cap with explicit overflow policy, vectorized arrow-boundary ingest,
width-boundary round trips, all-null columns, and >=1M-rows-per-shard
property checks vs pandas."""
import time

import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import Table
from cylon_tpu_torch import column as colmod
from cylon_tpu_torch.status import CylonError


def _from_numpy(values, **kw):
    return colmod.from_numpy(values, device="cpu", **kw)


def _from_arrow(array, **kw):
    return colmod.from_arrow(array, device="cpu", **kw)


# -- the port's contexts, on the CPU (the conftest's are the JAX package's)
@pytest.fixture(scope="module")
def local_ctx():
    from cylon_tpu_torch import CylonContext

    return CylonContext.Init("cpu")


def _mesh(world):
    from cylon_tpu_torch import CylonContext, MeshConfig

    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


@pytest.fixture(scope="module")
def ctx2():
    return _mesh(2)


@pytest.fixture(scope="module")
def ctx4():
    return _mesh(4)


@pytest.fixture(scope="module")
def ctx8():
    return _mesh(8)


def test_width_cap_raises_with_guidance():
    big = "x" * 10_000
    with pytest.raises(CylonError) as ei:
        _from_numpy(np.array(["small", big], object))
    assert "string_width" in str(ei.value)
    assert "CYLON_TPU_MAX_STRING_WIDTH" in str(ei.value)


def test_width_cap_explicit_override():
    big = "x" * 10_000
    c = _from_numpy(np.array([big], object), string_width=10_000)
    assert c.string_width == 10_000
    out = colmod.to_numpy(c, 1)
    assert out[0] == big


def test_env_cap_override(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_MAX_STRING_WIDTH", "20000")
    big = "y" * 12_000
    c = _from_numpy(np.array([big], object))
    assert colmod.to_numpy(c, 1)[0] == big


def test_string_roundtrip_width_boundaries():
    vals = ["", "a", "ab" * 16, "é" * 10, None, "end"]
    c = _from_numpy(np.array(vals, object))
    out = colmod.to_numpy(c, len(vals))
    assert list(out) == vals


def test_bytes_with_nul_roundtrip():
    vals = [b"ab\x00", b"\x00\x00", b"plain", b""]
    c = _from_numpy(np.array(vals, object))
    out = colmod.to_numpy(c, len(vals))
    got = [v.encode() if isinstance(v, str) else v for v in out]
    assert got == vals


def test_trailing_nul_str_roundtrip_all_boundaries():
    """Values ending in NUL must survive numpy->column->numpy AND ->arrow
    (numpy's U/S item access strips trailing NULs; the exact path must
    engage)."""
    import pyarrow as pa

    vals = ["ab\x00", "x", "\x00"]
    c = _from_numpy(np.array(vals, object))
    assert list(colmod.to_numpy(c, 3)) == vals
    assert colmod.to_arrow(c, 3).to_pylist() == vals
    # and arriving FROM arrow
    c2 = _from_arrow(pa.array(vals))
    assert list(colmod.to_numpy(c2, 3)) == vals


def test_fixed_size_binary_with_nulls():
    """Null FSB slots hold spec-undefined bytes; they must ingest as zeroed
    rows with zero lengths so null keys group together."""
    import pyarrow as pa

    fsb = pa.array([b"abc", None, b"def"], type=pa.binary(3))
    c = _from_arrow(fsb)
    assert list(np.asarray(c.lengths[:3])) == [3, 0, 3]
    assert not np.asarray(c.data[1]).any()
    out = colmod.to_numpy(c, 3)
    assert out[1] is None
    got = [v.encode() if isinstance(v, str) else v for v in out if v is not None]
    assert got == [b"abc", b"def"]


def test_arrow_string_roundtrip_with_nulls_and_slices():
    import pyarrow as pa

    arr = pa.array(["aa", None, "bbb", "", "cccc", None, "d"])
    sliced = arr.slice(1, 5)  # exercises arr.offset handling
    c = _from_arrow(sliced)
    out = colmod.to_numpy(c, len(sliced))
    assert list(out) == [None, "bbb", "", "cccc", None]
    back = colmod.to_arrow(c, len(sliced))
    assert back.to_pylist() == sliced.to_pylist()


def test_large_string_and_fixed_size_binary():
    import pyarrow as pa

    arr = pa.array(["x", "yy", "zzz"], type=pa.large_string())
    c = _from_arrow(arr)
    assert list(colmod.to_numpy(c, 3)) == ["x", "yy", "zzz"]
    fsb = pa.array([b"abc", b"def"], type=pa.binary(3))
    c2 = _from_arrow(fsb)
    out = [v.encode() if isinstance(v, str) else v for v in colmod.to_numpy(c2, 2)]
    assert out == [b"abc", b"def"]


def test_million_row_string_ingest_is_fast(ctx4):
    """1M-row string column must ingest via the vectorized path in seconds
    (the round-1 per-row loop took minutes at this size)."""
    n = 1_000_000
    base = np.array([f"key_{i % 5000:05d}" for i in range(50_000)], object)
    vals = np.tile(base, n // 50_000)
    t0 = time.perf_counter()
    c = _from_numpy(vals)
    ingest = time.perf_counter() - t0
    assert c.capacity >= n and c.string_width >= 9
    t0 = time.perf_counter()
    out = colmod.to_numpy(c, n)
    export = time.perf_counter() - t0
    assert out[0] == "key_00000" and out[n - 1] == vals[n - 1]
    # generous bounds: the old loops were >60s each at this size
    assert ingest < 20, f"string ingest too slow: {ingest:.1f}s"
    assert export < 20, f"string export too slow: {export:.1f}s"


def test_all_null_columns_through_ops(ctx4):
    n = 500
    df = pd.DataFrame({
        "k": np.arange(n, dtype=np.int64) % 7,
        "v": np.full(n, np.nan),
        "s": np.array([None] * n, object),
    })
    t = Table.from_pandas(df, ctx=ctx4)
    g = t.groupby("k", {"v": ["sum", "count"]})
    got = g.to_pandas().sort_values("k").reset_index(drop=True)
    assert (got["count_v"] == 0).all()
    s = t.shuffle(["k"])
    assert s.row_count == n
    assert s.to_pandas()["s"].isna().all()


def test_scale_1m_rows_groupby(ctx4):
    """Property test at 250k rows/shard (1M total on the 4-shard mesh):
    distributed two-phase groupby must match pandas exactly on counts and
    within fp tolerance on sums."""
    n = 1_000_000
    rng = np.random.default_rng(123)
    k = rng.integers(0, 10_000, n).astype(np.int32)
    v = rng.random(n).astype(np.float64)
    t = Table.from_numpy(["k", "v"], [k, v], ctx=ctx4)
    g = t.groupby("k", {"v": ["sum", "count"]})
    got = g.to_pandas().sort_values("k").reset_index(drop=True)
    df = pd.DataFrame({"k": k, "v": v})
    exp = df.groupby("k").agg(sum_v=("v", "sum"),
                              count_v=("v", "count")).reset_index()
    assert len(got) == len(exp)
    assert np.array_equal(got["k"], exp["k"])
    assert np.array_equal(got["count_v"], exp["count_v"])
    np.testing.assert_allclose(got["sum_v"], exp["sum_v"], rtol=1e-9)


def test_scale_1m_rows_join_count(ctx4):
    """1M-row distributed join row count matches pandas merge."""
    n = 1_000_000
    rng = np.random.default_rng(7)
    lk = rng.integers(0, n, n).astype(np.int32)
    rk = rng.integers(0, n, n).astype(np.int32)
    tl = Table.from_numpy(["k"], [lk], ctx=ctx4)
    tr = Table.from_numpy(["k"], [rk], ctx=ctx4)
    j = tl.distributed_join(tr, on="k", how="inner")
    exp = pd.DataFrame({"k": lk}).merge(pd.DataFrame({"k": rk}), on="k")
    assert j.row_count == len(exp)
