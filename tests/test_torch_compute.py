"""The port's twin of ``tests/test_compute.py``: the same cases and pandas
oracles, run on ``cylon_tpu_torch`` on the CPU.

Element-wise compute: comparisons, math, logical, nulls, isin, dropna.

Mirrors python/test/test_compute.py + test_table_properties.py coverage of
the reference (data/compute.pyx, table.pyx dunders).
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu_torch import CylonError, Table


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


@pytest.fixture()
def t(local_ctx):
    return Table.from_pydict(
        {"a": [1, 2, 3, 4, 5], "b": [10.0, 20.0, 30.0, 40.0, 50.0]},
        ctx=local_ctx)


def test_compare_scalar(t):
    m = (t > 3).to_pydict()
    assert m["a"] == [False, False, False, True, True]
    assert m["b"] == [True, True, True, True, True]
    assert (t == 2).to_pydict()["a"] == [False, True, False, False, False]
    assert (t <= 2).to_pydict()["a"] == [True, True, False, False, False]


def test_compare_table(t, local_ctx):
    u = Table.from_pydict({"a": [5, 4, 3, 2, 1], "b": [0.0] * 5}, ctx=local_ctx)
    m = (t < u).to_pydict()
    assert m["a"] == [True, True, False, False, False]


def test_math_scalar(t):
    assert (t + 1).to_pydict()["a"] == [2, 3, 4, 5, 6]
    assert (t - 1).to_pydict()["a"] == [0, 1, 2, 3, 4]
    assert (t * 2).to_pydict()["b"] == [20.0, 40.0, 60.0, 80.0, 100.0]
    assert np.allclose((t / 2).to_pydict()["a"], [0.5, 1.0, 1.5, 2.0, 2.5])
    assert (-t).to_pydict()["a"] == [-1, -2, -3, -4, -5]


def test_math_table(t, local_ctx):
    u = Table.from_pydict({"a": [1, 1, 1, 1, 1], "b": [2.0] * 5}, ctx=local_ctx)
    assert (t + u).to_pydict()["a"] == [2, 3, 4, 5, 6]
    assert (t * u).to_pydict()["b"] == [20.0, 40.0, 60.0, 80.0, 100.0]


def test_division_by_zero_scalar(t):
    with pytest.raises(CylonError):
        t / 0


def test_division_table_zero_gives_null(t, local_ctx):
    u = Table.from_pydict({"a": [1, 0, 1, 0, 1], "b": [2.0] * 5}, ctx=local_ctx)
    d = (t / u).to_pydict()
    assert d["a"] == [1.0, None, 3.0, None, 5.0]


def test_logical_and_invert(t):
    m1 = t > 2
    m2 = t < 5
    both = (m1 & m2).to_pydict()
    assert both["a"] == [False, False, True, True, False]
    either = (m1 | m2).to_pydict()
    assert either["a"] == [True] * 5
    inv = (~m1).to_pydict()
    assert inv["a"] == [True, True, False, False, False]


def test_logical_on_non_bool_raises(t):
    with pytest.raises(CylonError):
        t & t


def test_getitem_setitem(t):
    sub = t["a"]
    assert sub.column_names == ["a"]
    sub2 = t[["b", "a"]]
    assert sub2.column_names == ["b", "a"]
    t["c"] = 7
    assert t.to_pydict()["c"] == [7] * 5
    t["a"] = np.array([9, 8, 7, 6, 5])
    assert t.to_pydict()["a"] == [9, 8, 7, 6, 5]


def test_filter_mask(t):
    got = t[t["a"] > 2].to_pydict()
    assert got["a"] == [3, 4, 5]
    assert got["b"] == [30.0, 40.0, 50.0]


def test_row_slice(t):
    assert t[1:4].to_pydict()["a"] == [2, 3, 4]
    assert t[::2].to_pydict()["a"] == [1, 3, 5]


def test_fillna_isnull(local_ctx):
    df = pd.DataFrame({"x": [1.0, np.nan, 3.0], "y": [np.nan, 5.0, 6.0]})
    t = Table.from_pandas(df, ctx=local_ctx)
    nulls = t.isnull().to_pydict()
    assert nulls["x"] == [False, True, False]
    assert nulls["y"] == [True, False, False]
    notn = t.notnull().to_pydict()
    assert notn["x"] == [True, False, True]
    filled = t.fillna(0.0).to_pydict()
    assert filled["x"] == [1.0, 0.0, 3.0]
    assert filled["y"] == [0.0, 5.0, 6.0]


def test_dropna_rows_and_cols(local_ctx):
    df = pd.DataFrame({"x": [1.0, np.nan, 3.0], "y": [4.0, 5.0, 6.0]})
    t = Table.from_pandas(df, ctx=local_ctx)
    assert t.dropna().to_pydict() == {"x": [1.0, 3.0], "y": [4.0, 6.0]}
    assert t.dropna(axis=1).column_names == ["y"]


def test_isin(t):
    m = t.isin([2, 4, 40.0]).to_pydict()
    assert m["a"] == [False, True, False, True, False]
    assert m["b"] == [False, False, False, True, False]


def test_where(t):
    cond = t > 2
    w = t.where(cond).to_pydict()
    assert w["a"] == [None, None, 3, 4, 5]
    w2 = t.where(cond, 0).to_pydict()
    assert w2["a"] == [0, 0, 3, 4, 5]


def test_where_other_replaces_nulls(local_ctx):
    # null rows whose condition is False take `other` (pandas / reference
    # table.pyx where() semantics)
    t = Table.from_pandas(pd.DataFrame({"x": [1.0, np.nan]}), ctx=local_ctx)
    cond = t.notnull() & (t > 100)
    assert t.where(cond, 5.0).to_pydict() == {"x": [5.0, 5.0]}


def test_dropna_cols_empty_table(local_ctx):
    t = Table.from_pandas(pd.DataFrame({"x": [1.0], "y": [2.0]}).head(0),
                          ctx=local_ctx)
    assert t.dropna(axis=1, how="all").column_names == ["x", "y"]


def test_drop(t):
    assert t.drop("a").column_names == ["b"]
    assert t.drop(["b"]).column_names == ["a"]


def test_applymap(t):
    got = t.applymap(lambda x: x * x).to_pydict()
    assert got["a"] == [1, 4, 9, 16, 25]


def test_string_compare(local_ctx):
    t = Table.from_pydict({"s": ["apple", "fig", "pear"]}, ctx=local_ctx)
    assert (t == "fig").to_pydict()["s"] == [False, True, False]
    assert (t < "fig").to_pydict()["s"] == [True, False, False]
    assert (t >= "fig").to_pydict()["s"] == [False, True, True]
    m = t.isin(["apple", "pear"]).to_pydict()
    assert m["s"] == [True, False, True]


def test_string_fillna(local_ctx):
    t = Table.from_pydict({"s": ["a", None, "c"]}, ctx=local_ctx)
    assert t.fillna("zz").to_pydict()["s"] == ["a", "zz", "c"]


def test_distributed_elementwise(request, ctx4, rng):
    df = pd.DataFrame({"a": rng.integers(0, 50, 37).astype(np.int64),
                       "b": rng.random(37)})
    t = Table.from_pandas(df, ctx=ctx4)
    got = (t + 1).to_pandas()
    assert (got["a"].to_numpy() == df["a"].to_numpy() + 1).all()
    m = t[t["a"] > 25].to_pandas()
    exp = df[df["a"] > 25]
    assert sorted(m["a"]) == sorted(exp["a"])


def test_float_scalar_promotion_on_int_column(local_ctx):
    t = Table.from_pydict({"a": [1, 2, 3]}, ctx=local_ctx)
    assert (t >= 2.5).to_pydict()["a"] == [False, False, True]
    assert (t + 2.5).to_pydict()["a"] == [3.5, 4.5, 5.5]
    assert t.isin([2.5]).to_pydict()["a"] == [False, False, False]


def test_isin_null_semantics(local_ctx):
    t = Table.from_pydict({"s": ["a", None, "b"]}, ctx=local_ctx)
    assert t.isin(["", "a"]).to_pydict()["s"] == [True, False, False]
    assert t.isin(["a", None], skip_null=False).to_pydict()["s"] == [True, True, False]


def test_where_other_keeps_padding_invalid(local_ctx):
    """where(other=) must not mark capacity-padding rows valid."""
    t = Table.from_pydict({"a": [1.0, 2.0]}, ctx=local_ctx, capacity=8)
    cond = t > 5.0
    out = t.where(cond, 9.0)
    col = out.shards[0][0]
    assert not bool(col.validity[2:].any())
    assert out.to_pydict()["a"] == [9.0, 9.0]
