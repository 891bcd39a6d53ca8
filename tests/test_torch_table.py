"""The port's twin of ``tests/test_table.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.

Core Table tests: construction, round trips, local ops.

Mirrors the reference's create-table / table-op suites
(cpp/test/create_table_test.cpp, table_op_test.cpp and
python/test/test_table.py surface).
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import Table, CylonError


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


def test_from_pydict_roundtrip(local_ctx):
    d = {"a": [3, 1, 2], "b": [1.5, 2.5, 3.5], "s": ["x", "yy", "zzz"]}
    t = Table.from_pydict(d, ctx=local_ctx)
    assert t.row_count == 3
    assert t.column_count == 3
    assert t.column_names == ["a", "b", "s"]
    assert t.to_pydict() == d


def test_from_pandas_roundtrip(local_ctx):
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["p", "q", "r"]})
    t = Table.from_pandas(df, ctx=local_ctx)
    pd.testing.assert_frame_equal(t.to_pandas(), df)


def test_from_arrow_roundtrip(local_ctx):
    pa = pytest.importorskip("pyarrow")
    at = pa.table({"x": pa.array([1, None, 3], pa.int64()),
                   "y": pa.array(["a", "b", None])})
    t = Table.from_arrow(at, ctx=local_ctx)
    back = t.to_arrow()
    assert back.column("x").to_pylist() == [1, None, 3]
    assert back.column("y").to_pylist() == ["a", "b", None]


def test_nulls_preserved(local_ctx):
    pa = pytest.importorskip("pyarrow")
    at = pa.table({"x": pa.array([1.0, None, 3.0])})
    t = Table.from_arrow(at, ctx=local_ctx)
    assert t.to_pydict()["x"] == [1.0, None, 3.0]


def test_project_zero_copy(local_ctx):
    t = Table.from_pydict({"a": [1], "b": [2], "c": [3]}, ctx=local_ctx)
    p = t.project(["c", "a"])
    assert p.column_names == ["c", "a"]
    p2 = t.project([1])
    assert p2.column_names == ["b"]


def test_rename_prefix_suffix(local_ctx):
    t = Table.from_pydict({"a": [1], "b": [2]}, ctx=local_ctx)
    assert t.rename({"a": "z"}).column_names == ["z", "b"]
    assert t.add_prefix("p_").column_names == ["p_a", "p_b"]
    assert t.add_suffix("_s").column_names == ["a_s", "b_s"]


def test_select_predicate(local_ctx):
    t = Table.from_pydict({"a": [1, 2, 3, 4], "b": [10.0, 20.0, 30.0, 40.0]},
                          ctx=local_ctx)
    f = t.select(lambda r: (r["a"] % 2) == 0)
    assert f.to_pydict() == {"a": [2, 4], "b": [20.0, 40.0]}


def test_merge(local_ctx):
    a = Table.from_pydict({"x": [1, 2]}, ctx=local_ctx)
    b = Table.from_pydict({"x": [3]}, ctx=local_ctx)
    m = a.merge(b)
    assert m.to_pydict() == {"x": [1, 2, 3]}


def test_bad_column_raises(local_ctx):
    t = Table.from_pydict({"a": [1]}, ctx=local_ctx)
    with pytest.raises(CylonError):
        t.project(["nope"])
    with pytest.raises(CylonError):
        t.project([5])


def test_join_numeric_key_dtype_mismatch_raises(local_ctx):
    """int64-vs-int32 keys silently corrupted join output before round 4
    (concat promoted, packed operands mis-ordered); must raise instead."""
    a = Table.from_pandas(pd.DataFrame({"k": np.arange(5, dtype=np.int64),
                                        "v": np.ones(5)}), ctx=local_ctx)
    b = Table.from_pandas(pd.DataFrame({"k": np.arange(5, dtype=np.int32),
                                        "w": np.ones(5)}), ctx=local_ctx)
    with pytest.raises(CylonError, match="type mismatch"):
        a.join(b, on="k", how="inner")
    with pytest.raises(CylonError, match="type mismatch"):
        a.join(b, on="k", how="inner", algorithm="hash")
    # same dtype joins fine
    j = a.join(a, on="k", how="inner")
    assert j.row_count == 5


def test_distributed_construction_and_gather(ctx4):
    n = 103
    df = pd.DataFrame({"a": np.arange(n), "b": np.arange(n) * 0.5})
    t = Table.from_pandas(df, ctx=ctx4)
    assert t.num_shards == 4
    assert t.row_count == n
    got = t.to_pandas().sort_values("a").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, df)


def test_distributed_select(ctx4):
    n = 100
    t = Table.from_pydict({"a": list(range(n))}, ctx=ctx4)
    f = t.select(lambda r: r["a"] < 10)
    assert sorted(f.to_pydict()["a"]) == list(range(10))


def test_empty_table(local_ctx):
    t = Table.from_pydict({"a": []}, ctx=local_ctx)
    assert t.row_count == 0
    assert t.to_pydict() == {"a": []}


def test_string_unicode_roundtrip(local_ctx):
    vals = ["héllo", "wörld", "日本語", ""]
    t = Table.from_pydict({"s": vals}, ctx=local_ctx)
    assert t.to_pydict()["s"] == vals


def test_distributed_from_arrow_nulls(ctx4):
    """Regression: multi-shard from_arrow must keep dtypes and null validity
    (previously detoured through str(None))."""
    pa = pytest.importorskip("pyarrow")
    at = pa.table({"k": pa.array([1, None, 3, 4, None, 6], pa.int64()),
                   "s": pa.array(["a", None, "c", "d", "e", None])})
    t = Table.from_arrow(at, ctx=ctx4)
    assert t.shards[0][0].dtype.type.name == "INT64"
    back = t.to_arrow()
    assert sorted(back.column("k").to_pylist(), key=lambda v: (v is None, v)) == \
        [1, 3, 4, 6, None, None]
    assert back.column("s").null_count == 2


def test_from_arrow_large_int_precision(local_ctx):
    """Regression: nullable int64 must not round-trip through float64."""
    pa = pytest.importorskip("pyarrow")
    big = 2**60 + 1
    at = pa.table({"x": pa.array([big, None], pa.int64())})
    t = Table.from_arrow(at, ctx=local_ctx)
    assert t.to_arrow().column("x").to_pylist() == [big, None]


def test_distributed_sort_mixed_ascending(ctx4):
    import numpy as np

    rng = np.random.default_rng(3)
    df = pd.DataFrame({"a": rng.integers(0, 10, 200), "b": rng.random(200)})
    t = Table.from_pandas(df, ctx=ctx4).distributed_sort(["a", "b"],
                                                         ascending=[True, False])
    got = t.to_pandas()
    exp = df.sort_values(["a", "b"], ascending=[True, False]).reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp)
