"""Index machinery and loc/iloc row access of the PyTorch port against the
JAX package: every case of ``tests/test_indexing.py``, each run on the
same table in both packages (the port on a CPU context) with the same
results, and the selected rows compared exactly: values, column names and
the labels of the carried index."""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu import CylonError as RCylonError
from cylon_tpu import Table as RTable
from cylon_tpu.frame import DataFrame as RDataFrame
from cylon_tpu.index import ColumnIndex as RColumnIndex
from cylon_tpu_torch import CylonContext, CylonError, DataFrame, MeshConfig
from cylon_tpu_torch import Table
from cylon_tpu_torch.index import (CategoricalIndex, ColumnIndex, Int64Index,
                                   RangeIndex, range_calculator)

FRAME = {"max_speed": [1, 4, 7, 10], "shield": [2, 5, 8, 11],
         "name": ["cobra", "viper", "sidewinder", "viper"]}


@pytest.fixture(scope="module")
def pctx():
    return CylonContext.Init("cpu")


class Both:
    """The same table in both packages; ``do(fn)`` runs ``fn`` on each and
    checks that they agree, returning the port's result."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref

    def do(self, fn):
        got, want = fn(self.port), fn(self.ref)
        _agree(got, want)
        return got

    def raises(self, fn, match):
        with pytest.raises(RCylonError, match=match):
            fn(self.ref)
        with pytest.raises(CylonError, match=match):
            fn(self.port)


def _agree(got, want):
    if got is None:
        assert want is None
        return
    assert got.column_names == want.column_names
    assert got.to_pydict() == want.to_pydict()
    assert type(got.index).__name__ == type(want.index).__name__
    gv, wv = got.index.index_values, want.index.index_values
    if isinstance(got.index, ColumnIndex) and len(got.index.names) > 1:
        for g, w in zip(gv, wv):
            assert list(g) == list(w)
    else:
        assert list(gv) == list(wv)


@pytest.fixture
def t(local_ctx, pctx):
    df = pd.DataFrame(FRAME)
    return Both(Table.from_pandas(df, ctx=pctx),
                RTable.from_pandas(df, ctx=local_ctx))


# -- reference test_index.py scenarios ---------------------------------------

def test_range_index_values_and_len():
    r = RangeIndex(range(0, 10, 2))
    assert list(r.index_values) == list(range(0, 10, 2))
    assert len(r) == 5
    for rg in [range(0, 10), range(0, 10, 2), range(0, 11, 2), range(0, 14, 3)]:
        assert range_calculator(RangeIndex(rg)) == sum(1 for _ in rg)


def test_set_index_by_labels_categorical(t):
    labels = ["a", "b", "c", "d"]
    t.do(lambda x: x.set_index(labels))
    assert isinstance(t.port.index, CategoricalIndex)
    assert list(t.port.index.index_values) == labels
    _agree(t.port, t.ref)


def test_set_index_by_column_name(t):
    t.do(lambda x: x.set_index("name"))
    assert isinstance(t.port.index, ColumnIndex)
    assert list(t.port.index.index_values) == ["cobra", "viper",
                                               "sidewinder", "viper"]
    _agree(t.port, t.ref)


def test_set_index_by_column_names_multi(t):
    t.do(lambda x: x.set_index(["max_speed", "shield"]))
    assert isinstance(t.port.index, ColumnIndex)
    vals = t.port.index.index_values
    assert list(vals[0]) == [1, 4, 7, 10]
    assert list(vals[1]) == [2, 5, 8, 11]
    _agree(t.port, t.ref)


def test_default_index_is_range(t):
    assert isinstance(t.port.index, RangeIndex)
    assert len(t.port.index) == 4
    _agree(t.port, t.ref)


def test_reset_index(t):
    t.do(lambda x: x.set_index("name"))
    t.do(lambda x: x.reset_index())
    assert isinstance(t.port.index, RangeIndex)
    _agree(t.port, t.ref)


def test_set_index_bad_key(t):
    for x in (t.port, t.ref):
        with pytest.raises(KeyError):
            x.set_index("nope")


# -- loc (label) -------------------------------------------------------------

def test_loc_single_label_all_matches(t):
    t.do(lambda x: x.set_index("name"))
    out = t.do(lambda x: x.loc["viper"])
    assert out.to_pydict()["max_speed"] == [4, 10]
    assert list(out.index.index_values) == ["viper", "viper"]


def test_loc_label_list_in_order(t):
    t.do(lambda x: x.set_index("name"))
    out = t.do(lambda x: x.loc[["sidewinder", "cobra"]])
    assert out.to_pydict()["max_speed"] == [7, 1]


def test_loc_label_slice_inclusive(t):
    t.do(lambda x: x.set_index("name"))
    out = t.do(lambda x: x.loc["cobra":"sidewinder"])
    assert out.to_pydict()["max_speed"] == [1, 4, 7]


def test_loc_missing_label_raises(t):
    t.do(lambda x: x.set_index("name"))
    t.raises(lambda x: x.loc["python"], "KeyError")


def test_loc_with_column_selection(t):
    t.do(lambda x: x.set_index("name"))
    out = t.do(lambda x: x.loc["viper", "shield"])
    assert out.column_names == ["shield"]
    assert out.to_pydict()["shield"] == [5, 11]


def test_loc_boolean_mask(t):
    t.do(lambda x: x.set_index("name"))
    out = t.do(lambda x: x.loc[np.array([True, False, False, True])])
    assert out.to_pydict()["max_speed"] == [1, 10]


def test_loc_on_range_index_is_label_arithmetic(t):
    out = t.do(lambda x: x.loc[1:2])
    assert out.to_pydict()["max_speed"] == [4, 7]
    t.raises(lambda x: x.loc[99], "KeyError")


def test_loc_categorical_index(t):
    t.do(lambda x: x.set_index(["w", "x", "y", "z"]))
    assert t.do(lambda x: x.loc["x"]).to_pydict()["max_speed"] == [4]
    assert t.do(lambda x: x.loc["x":"z"]).to_pydict()["max_speed"] == \
        [4, 7, 10]


def test_loc_multi_column_index_tuple_label(t):
    t.do(lambda x: x.set_index(["max_speed", "shield"]))
    out = t.do(lambda x: x.loc[(4, 5)])
    assert out.to_pydict()["name"] == ["viper"]
    t.raises(lambda x: x.loc[(4, 99)], "KeyError")


# -- iloc (position) ---------------------------------------------------------

def test_iloc_int_and_negative(t):
    assert t.do(lambda x: x.iloc[2]).to_pydict()["name"] == ["sidewinder"]
    assert t.do(lambda x: x.iloc[-1]).to_pydict()["name"] == ["viper"]


def test_iloc_slice_and_list(t):
    assert t.do(lambda x: x.iloc[1:3]).to_pydict()["max_speed"] == [4, 7]
    assert t.do(lambda x: x.iloc[[3, 0]]).to_pydict()["max_speed"] == [10, 1]


def test_iloc_scalar_scalar_is_cell_access(t):
    """iloc[0, 1] means (row 0, col 1) — never rows (0, 1)."""
    out = t.do(lambda x: x.iloc[0, 1])
    assert out.column_names == ["shield"]
    assert out.to_pydict() == {"shield": [2]}
    out2 = t.do(lambda x: x.iloc[1, "name"])
    assert out2.to_pydict() == {"name": ["viper"]}


def test_set_index_bare_column_index_materializes(t):
    """set_index(ColumnIndex('name')) carries no values; it resolves loc
    like set_index('name')."""
    t.port.set_index(ColumnIndex("name"))
    t.ref.set_index(RColumnIndex("name"))
    assert t.do(lambda x: x.loc["viper"]).to_pydict()["max_speed"] == [4, 10]
    assert t.do(lambda x: x.iloc[0]).to_pydict()["name"] == ["cobra"]


def test_iloc_bool_mask_and_cols(t):
    out = t.do(lambda x: x.iloc[np.array([False, True, True, False]), 0])
    assert out.column_names == ["max_speed"]
    assert out.to_pydict()["max_speed"] == [4, 7]


def test_iloc_out_of_bounds(t):
    t.raises(lambda x: x.iloc[9], "IndexError")


def test_bool_mask_wrong_length_raises(t):
    t.raises(lambda x: x.iloc[np.array([True, False, False, True, True])],
             "mask length")
    t.raises(lambda x: x.loc[np.array([True])], "mask length")


def test_iloc_preserves_positional_labels(t):
    sub = t.do(lambda x: x.iloc[[1, 3]])
    assert isinstance(sub.index, Int64Index)
    assert list(sub.index.index_values) == [1, 3]
    chained = Both(sub, t.ref.iloc[[1, 3]])
    assert chained.do(lambda x: x.loc[3]).to_pydict()["name"] == ["viper"]


def test_loc_with_cols_keeps_index(t):
    t.do(lambda x: x.set_index("name"))
    sub = t.do(lambda x: x.loc[["viper", "cobra"], "shield"])
    assert list(sub.index.index_values) == ["viper", "viper", "cobra"]
    chained = Both(sub, t.ref.loc[["viper", "cobra"], "shield"])
    assert chained.do(lambda x: x.loc["cobra"]).to_pydict()["shield"] == [2]


# -- DataFrame facade --------------------------------------------------------

def _frames(local_ctx, pctx, data, **kw):
    return (DataFrame(data, ctx=pctx, **kw), RDataFrame(data, ctx=local_ctx,
                                                        **kw))


def _same_frames(a, b):
    pd.testing.assert_frame_equal(a.to_pandas(), b.to_pandas())
    assert type(a.index).__name__ == type(b.index).__name__


def test_frame_loc_iloc_roundtrip(local_ctx, pctx):
    pdf = pd.DataFrame({"k": ["a", "b", "c"], "v": [1, 2, 3]})
    df, ref = _frames(local_ctx, pctx, pdf)
    df.set_index("k")
    ref.set_index("k")
    assert df.loc["b"].to_pandas()["v"].tolist() == [2]
    assert df.iloc[0:2].to_pandas()["v"].tolist() == [1, 2]
    assert isinstance(df.index, ColumnIndex)
    _same_frames(df.loc["b"], ref.loc["b"])
    _same_frames(df.iloc[0:2], ref.iloc[0:2])


def test_frame_set_index_drop(local_ctx, pctx):
    pdf = pd.DataFrame({"k": ["a", "b"], "v": [1, 2]})
    df, ref = _frames(local_ctx, pctx, pdf)
    df.set_index("k", drop=True)
    ref.set_index("k", drop=True)
    assert df.columns == ["v"] == ref.columns
    assert df.loc["a"].to_pandas()["v"].tolist() == [1]
    _same_frames(df.loc["a"], ref.loc["a"])


def test_frame_constructor_index_labels(local_ctx, pctx):
    df, ref = _frames(local_ctx, pctx, {"v": [10, 20, 30]},
                      index=["x", "y", "z"])
    assert isinstance(df.index, CategoricalIndex)
    assert df.loc["y"].to_pandas()["v"].tolist() == [20]
    _same_frames(df.loc["y"], ref.loc["y"])


def test_frame_constructor_labels_colliding_with_column_names(local_ctx,
                                                              pctx):
    """Constructor index= is ALWAYS row labels, even when the labels
    coincide with column names (pandas semantics)."""
    df, ref = _frames(local_ctx, pctx, {"x": [1, 2], "y": [3, 4]},
                      index=["x", "y"])
    assert isinstance(df.index, CategoricalIndex)
    assert df.loc["x"].to_pandas()["x"].tolist() == [1]
    _same_frames(df.loc["x"], ref.loc["x"])


def test_frame_set_index_drops_by_default(local_ctx, pctx):
    pdf = pd.DataFrame({"k": ["a", "b"], "v": [1, 2]})
    df, ref = _frames(local_ctx, pctx, pdf)
    df.set_index("k")
    ref.set_index("k")
    assert df.columns == ["v"] == ref.columns
    assert df.loc["b"].to_pandas()["v"].tolist() == [2]
    _same_frames(df.loc["b"], ref.loc["b"])


def test_multishard_row_access_raises(ctx4):
    pdf = pd.DataFrame({"a": np.arange(50)})
    pctx4 = CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                    world_size=4))
    Both(Table.from_pandas(pdf, ctx=pctx4),
         RTable.from_pandas(pdf, ctx=ctx4)).raises(lambda x: x.iloc[3],
                                                   "1-shard")
