"""The port's DataFrame / Series / Index facade against the JAX package's,
on the same inputs: every case of ``tests/test_frame.py``, each run through
both packages (the port on a CPU context) and compared with the reference's
result exactly, floats within rtol 1e-12 in wide mode; the group-by cases
also in narrow mode (float32 sums, rtol 1e-5 against the reference's
narrow run)."""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu import DataFrame as RDataFrame
from cylon_tpu import RangeIndex as RRangeIndex
from cylon_tpu import Series as RSeries
from cylon_tpu_torch import (CylonContext, DataFrame, MeshConfig, RangeIndex,
                             Series)

from .torch_parity import modes


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.Init("cpu")


@pytest.fixture(scope="module")
def pctx4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


def _same(port, ref, rtol=1e-12):
    """Two frames (or their pandas) hold the same columns and rows."""
    got = port.to_pandas() if hasattr(port, "to_pandas") else port
    want = ref.to_pandas() if hasattr(ref, "to_pandas") else ref
    pd.testing.assert_frame_equal(got, want, rtol=rtol, check_exact=False)


def test_ctor_from_dict(local_ctx, pctx):
    data = {"a": [1, 2, 3], "b": [4.0, 5.0, 6.0]}
    df = DataFrame(data, ctx=pctx)
    assert df.shape == (3, 2) == RDataFrame(data, ctx=local_ctx).shape
    assert df.columns == ["a", "b"]
    assert not df.is_distributed
    _same(df, RDataFrame(data, ctx=local_ctx))


def test_ctor_from_list_of_columns(local_ctx, pctx):
    df = DataFrame([[1, 2, 3], [4, 5, 6]], ctx=pctx)
    assert df.columns == ["0", "1"]
    assert df.to_dict() == {"0": [1, 2, 3], "1": [4, 5, 6]}
    assert df.to_dict() == RDataFrame([[1, 2, 3], [4, 5, 6]],
                                      ctx=local_ctx).to_dict()


def test_ctor_from_pandas_and_numpy(local_ctx, pctx, rng):
    pdf = pd.DataFrame({"x": rng.random(10), "y": rng.integers(0, 5, 10)})
    df = DataFrame(pdf, ctx=pctx)
    pd.testing.assert_frame_equal(df.to_pandas(), pdf)
    _same(df, RDataFrame(pdf, ctx=local_ctx))

    arr = rng.random((6, 3))
    df2 = DataFrame(arr, columns=["a", "b", "c"], ctx=pctx)
    assert df2.columns == ["a", "b", "c"]
    np.testing.assert_array_equal(
        df2.to_numpy(),
        RDataFrame(arr, columns=["a", "b", "c"], ctx=local_ctx).to_numpy())
    assert np.allclose(df2.to_numpy(), arr)


def test_getitem_setitem_filter(local_ctx, pctx):
    for make, ctx in ((DataFrame, pctx), (RDataFrame, local_ctx)):
        df = make({"a": [1, 2, 3, 4], "b": [10, 20, 30, 40]}, ctx=ctx)
        assert df["a"].to_dict() == {"a": [1, 2, 3, 4]}
        assert df[["b", "a"]].columns == ["b", "a"]
        got = df[df["a"] > 2]
        assert got.to_dict() == {"a": [3, 4], "b": [30, 40]}
        df["c"] = 5
        assert df.to_dict()["c"] == [5] * 4
        df["a"] = np.array([9, 9, 9, 9])
        assert df.to_dict()["a"] == [9] * 4


def test_dunders_math(local_ctx, pctx):
    df = DataFrame({"a": [1, 2, 3]}, ctx=pctx)
    ref = RDataFrame({"a": [1, 2, 3]}, ctx=local_ctx)
    assert (df + 1).to_dict()["a"] == [2, 3, 4] == (ref + 1).to_dict()["a"]
    assert (df * 3).to_dict()["a"] == [3, 6, 9] == (ref * 3).to_dict()["a"]
    assert (-df).to_dict()["a"] == [-1, -2, -3] == (-ref).to_dict()["a"]
    m = (df >= 2) & (df <= 2)
    assert m.to_dict()["a"] == [False, True, False] == \
        ((ref >= 2) & (ref <= 2)).to_dict()["a"]


def test_cleaning(local_ctx, pctx):
    pdf = pd.DataFrame({"x": [1.0, np.nan, 3.0], "y": [4.0, 5.0, 6.0]})
    df, ref = DataFrame(pdf, ctx=pctx), RDataFrame(pdf, ctx=local_ctx)
    assert df.isnull().to_dict()["x"] == [False, True, False]
    assert df.fillna(0.0).to_dict()["x"] == [1.0, 0.0, 3.0]
    assert df.dropna().to_dict()["x"] == [1.0, 3.0]
    assert df.drop("x").columns == ["y"]
    assert df.rename({"x": "z"}).columns == ["z", "y"]
    assert df.add_prefix("p_").columns == ["p_x", "p_y"]
    assert df.add_suffix("_s").columns == ["x_s", "y_s"]
    for op in (lambda d: d.isnull(), lambda d: d.notnull(),
               lambda d: d.fillna(0.0), lambda d: d.dropna(),
               lambda d: d.drop("x"), lambda d: d.rename({"x": "z"}),
               lambda d: d.add_prefix("p_"), lambda d: d.add_suffix("_s")):
        assert op(df).to_dict() == op(ref).to_dict()


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_merge_groupby_sort(local_ctx, pctx, mode):
    lk = {"k": [1, 2, 3, 4], "a": [1.0, 2.0, 3.0, 4.0]}
    rk = {"k": [2, 3, 4, 5], "b": [20.0, 30.0, 40.0, 50.0]}
    gk = {"k": [1, 1, 2], "v": [1.0, 2.0, 10.0]}
    with modes(mode):
        j = DataFrame(lk, ctx=pctx).merge(DataFrame(rk, ctx=pctx), on="k")
        rj = RDataFrame(lk, ctx=local_ctx).merge(
            RDataFrame(rk, ctx=local_ctx), on="k")
        g = DataFrame(gk, ctx=pctx).groupby("k", {"v": "sum"})
        rg = RDataFrame(gk, ctx=local_ctx).groupby("k", {"v": "sum"})
    assert sorted(j.to_dict()["l_k"]) == [2, 3, 4]
    assert j.to_dict() == rj.to_dict()
    d = dict(zip(g.to_dict()["k"], g.to_dict()["sum_v"]))
    assert d == {1: 3.0, 2: 10.0}
    _same(g, rg, rtol=1e-5 if mode == "narrow" else 1e-12)
    s = DataFrame({"a": [3, 1, 2]}, ctx=pctx).sort_values("a")
    assert s.to_dict()["a"] == [1, 2, 3]
    u = DataFrame({"a": [1, 1, 2]}, ctx=pctx).drop_duplicates()
    assert sorted(u.to_dict()["a"]) == [1, 2]
    assert u.to_dict() == RDataFrame({"a": [1, 1, 2]},
                                     ctx=local_ctx).drop_duplicates().to_dict()


def test_series_and_index(local_ctx, pctx):
    df = DataFrame({"a": [1, 2, 3]}, ctx=pctx)
    s = df.a
    assert isinstance(s, Series)
    assert s.shape == (3,)
    assert list(s.to_numpy()) == [1, 2, 3]
    assert s[1] == 2
    assert isinstance(df.index, RangeIndex)
    assert len(df.index) == 3
    rs = RDataFrame({"a": [1, 2, 3]}, ctx=local_ctx).a
    np.testing.assert_array_equal(s.to_numpy(), rs.to_numpy())
    assert s.dtype.type == int(rs.dtype.type)

    s2 = Series("v", data=[1.5, 2.5], device="cpu")
    assert s2.id == "v"
    assert list(s2.to_numpy()) == [1.5, 2.5]
    np.testing.assert_array_equal(s2.to_numpy(),
                                  RSeries("v", data=[1.5, 2.5]).to_numpy())


def test_range_index_negative_step():
    idx = RangeIndex(range(5, 0, -1))
    assert len(idx) == 5
    assert len(idx) == len(idx.index_values)
    np.testing.assert_array_equal(idx.index_values,
                                  RRangeIndex(range(5, 0, -1)).index_values)


def test_where(local_ctx, pctx):
    df = DataFrame({"a": [1, 2, 3, 4]}, ctx=pctx)
    ref = RDataFrame({"a": [1, 2, 3, 4]}, ctx=local_ctx)
    w = df.where(df > 2)
    assert w.to_dict()["a"] == [None, None, 3, 4] == \
        ref.where(ref > 2).to_dict()["a"]
    w2 = df.where(df > 2, 0)
    assert w2.to_dict()["a"] == [0, 0, 3, 4] == \
        ref.where(ref > 2, 0).to_dict()["a"]


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_distributed_frame(ctx4, pctx4, rng, mode):
    pdf = pd.DataFrame({"k": rng.integers(0, 10, 64), "v": rng.random(64)})
    df = DataFrame(pdf, ctx=pctx4, distributed=True)
    assert df.is_distributed
    with modes(mode):
        g = df.groupby("k", {"v": "sum"})
        rg = RDataFrame(pdf, ctx=ctx4, distributed=True).groupby(
            "k", {"v": "sum"})
    exp = pdf.groupby("k").agg(sum_v=("v", "sum")).reset_index()
    got = g.to_pandas().sort_values("k").reset_index(drop=True)
    rtol = 1e-5 if mode == "narrow" else 1e-12
    np.testing.assert_allclose(got["sum_v"], exp["sum_v"], rtol=rtol)
    _same(got, rg.to_pandas().sort_values("k").reset_index(drop=True),
          rtol=rtol)
    srt = df.sort_values("k")
    assert (np.diff(srt.to_pandas()["k"].to_numpy()) >= 0).all()
    assert srt.to_pandas()["k"].tolist() == \
        RDataFrame(pdf, ctx=ctx4, distributed=True).sort_values(
            "k").to_pandas()["k"].tolist()
