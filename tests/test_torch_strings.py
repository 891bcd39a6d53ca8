"""String columns in the port against the JAX package, on one shard, on the
same numpy inputs through ``tests/torch_parity.py``.

- Column round trips: ``from_numpy`` (object, U and S arrays, nulls,
  trailing NULs, bytes, all-null, wider than the default width, the width
  cap and its error text), ``from_native_buffers``, ``from_arrow`` /
  ``to_arrow`` and ``to_numpy``: buffers bit for bit against the
  reference's, exports equal.
- ``pack_string_words`` bit for bit.
- String keys through ``sort``, ``unique``, the set ops, ``join`` (inner,
  left, right, outer) and both group-bys, the string compares, ``isin``,
  ``fillna`` and ``where``: exact over the whole capacity (data, bytes,
  lengths, validity, counts) in both precisions; float sums rtol 1e-5 in
  float32 and 1e-12 in float64, the bound of ``test_torch_operators.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cylon_tpu import column as rcol
from cylon_tpu.ops import keys as rkeys
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import column, compute, dtypes, interop
from cylon_tpu_torch.ops import keys
from cylon_tpu_torch.status import CylonError

from .torch_parity import (assert_columns_equal, assert_tables_equal, modes,
                           port_column, port_table_of)

MODES = ["wide", "narrow"]

WORDS = ["apple", "banana", "", "cherry", "app", "applesauce", "Zebra",
         "éclair", "banana ", "a\x00b", "Customer#000000042",
         "a much longer value past eight bytes", "zz", "Ωmega"]


def _strings(n, seed, nulls=True, words=WORDS):
    rng = np.random.default_rng(seed)
    s = np.array(words, object)[rng.integers(0, len(words), n)]
    if nulls:
        s[rng.random(n) < 0.15] = None
    return s


# -- column round trips -------------------------------------------------------

FROM_NUMPY_CASES = {
    "object_nulls": lambda: _strings(40, 1),
    "unicode_array": lambda: np.array(["x", "été", "", "abc"]),
    "bytes_array": lambda: np.array([b"a\x00", b"", b"xyz", b"\x00\x00"],
                                    "S3"),
    "object_bytes": lambda: np.array([b"raw\x00", b"\xff\xfe", None, b""],
                                     object),
    "trailing_nul_str": lambda: np.array(["ab\x00", "c", None], object),
    "trailing_nul_unicode": lambda: np.array(["ab\x00", "c"]),
    "all_null": lambda: np.array([None, None, None], object),
    "empty": lambda: np.array([], object),
    "wider_than_default": lambda: np.array(["y" * 45, "short", None], object),
}


@pytest.mark.parametrize("case", sorted(FROM_NUMPY_CASES))
def test_from_numpy_matches_reference_and_round_trips(case):
    values = FROM_NUMPY_CASES[case]()
    ref = rcol.from_numpy(values, capacity=len(values) + 5)
    got = column.from_numpy(values, capacity=len(values) + 5, device="cpu")
    assert_columns_equal([got], [ref])  # bytes, lengths, validity: exact
    assert got.string_width == ref.string_width
    want = rcol.to_numpy(ref, len(values))
    out = column.to_numpy(got, len(values))
    assert out.dtype == object and len(out) == len(want)
    for a, b in zip(out, want):
        assert a == b and type(a) is type(b)


def test_width_cap_and_explicit_width(monkeypatch):
    """A cell wider than both the cap and the requested width raises; a
    requested width that holds it lifts the cap."""
    monkeypatch.setenv("CYLON_TPU_MAX_STRING_WIDTH", "16")
    values = np.array(["x" * 40, "ok"], object)
    with pytest.raises(CylonError, match=r"\[Invalid\] string cell of 40 "
                       r"bytes exceeds the column width cap 16.*"
                       r"string_width>=40.*CYLON_TPU_MAX_STRING_WIDTH"):
        column.from_numpy(values, device="cpu")
    with pytest.raises(Exception, match="exceeds the column width cap 16"):
        rcol.from_numpy(values)
    got = column.from_numpy(values, string_width=44, device="cpu")
    assert_columns_equal([got], [rcol.from_numpy(values, string_width=44)])
    assert got.string_width == 44
    monkeypatch.setenv("CYLON_TPU_MAX_STRING_WIDTH", "not a number")
    assert column.max_string_width() == 4096  # the default


def test_from_native_buffers_matches_reference():
    rng = np.random.default_rng(5)
    mat = rng.integers(1, 256, (30, 6)).astype(np.uint8)
    lens = rng.integers(0, 7, 30).astype(np.int32)
    mat[np.arange(6)[None, :] >= lens[:, None]] = 0
    valid = rng.random(30) > 0.2
    mat[~valid] = 0
    lens[~valid] = 0
    for width in (None, 4, 11):
        ref = rcol.from_native_buffers(mat, valid, lens, capacity=33,
                                       string_width=width)
        got = column.from_native_buffers(mat, valid, lens, capacity=33,
                                         string_width=width, device="cpu")
        assert_columns_equal([got], [ref])
    ints = np.arange(9, dtype=np.int64)
    assert_columns_equal(
        [column.from_native_buffers(ints, None, device="cpu")],
        [rcol.from_native_buffers(ints, None)])


def _arrow_arrays():
    pa = pytest.importorskip("pyarrow")
    base = pa.array(["a", None, "été", "", "longer value here",
                     "zz"])
    return {
        "string": base,
        "large_string": base.cast(pa.large_string()),
        "binary": pa.array([b"\x00\x01", None, b"", b"\xff"], pa.binary()),
        "fixed_size_binary": pa.array([b"abc", None, b"\x00\x00\x01"],
                                      pa.binary(3)),
        "dictionary": pa.array(["x", "y", None, "x"]).dictionary_encode(),
        "sliced": base.slice(1, 4),
        "chunked": pa.chunked_array([base, pa.array(["q", None])]),
    }


@pytest.mark.parametrize("name", ["string", "large_string", "binary",
                                  "fixed_size_binary", "dictionary",
                                  "sliced", "chunked"])
def test_arrow_round_trip_matches_reference(name):
    arr = _arrow_arrays()[name]
    ref = rcol.from_arrow(arr, capacity=len(arr) + 2)
    got = column.from_arrow(arr, capacity=len(arr) + 2, device="cpu")
    assert_columns_equal([got], [ref])
    assert got.dtype == interop._as_datatype(ref.dtype)
    assert column.to_arrow(got, len(arr)).equals(rcol.to_arrow(ref, len(arr)))
    assert dtypes.to_arrow_type(got.dtype) == \
        dtypes.to_arrow_type(dtypes.from_arrow_type(
            dtypes.to_arrow_type(got.dtype)))


def test_interop_carries_strings_bit_for_bit():
    ref = rcol.from_numpy(_strings(20, 3), capacity=24)
    p = port_column(ref)
    data, valid, lengths, dt = interop.column_to_arrays(p)
    assert dt == dtypes.string and data.shape == (24, ref.string_width)
    np.testing.assert_array_equal(data, np.asarray(ref.data))
    np.testing.assert_array_equal(lengths, np.asarray(ref.lengths))
    np.testing.assert_array_equal(valid, np.asarray(ref.validity))
    with pytest.raises(CylonError, match=r"\[Invalid\].*2-D data"):
        interop.column_from_arrays(data[:, 0], valid, lengths, dt,
                                   device="cpu")


@pytest.mark.parametrize("width", [1, 7, 8, 13, 32])
def test_pack_string_words_bit_for_bit(width):
    rng = np.random.default_rng(width)
    mat = rng.integers(0, 256, (64, width)).astype(np.uint8)
    got = keys.pack_string_words(torch.from_numpy(mat))
    want = rkeys.pack_string_words(jnp.asarray(mat))
    assert len(got) == len(want) == -(-width // 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))


def test_column_take_with_capacity_and_null_fill():
    ref = rcol.from_numpy(_strings(12, 4), capacity=16)
    p = port_column(ref)
    idx = np.array([3, 0, 15, 7, 2, 40, 1, 1], np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1, 0], bool)
    assert_columns_equal(
        [p.take(torch.from_numpy(idx), torch.from_numpy(mask))],
        [ref.take(jnp.asarray(idx), jnp.asarray(mask))])
    for cap in (10, 16, 21):
        assert_columns_equal([p.with_capacity(cap)],
                             [ref.with_capacity(cap)])


# -- operators ---------------------------------------------------------------

def _tables(n=50, seed=9, words=WORDS, cap_extra=6):
    """(reference Table, port Table) of one shard: a string key ``s``, an
    int32 ``k``, a float32 ``v`` with nulls and a second string ``t``."""
    rng = np.random.default_rng(seed)
    s = _strings(n, seed, words=words)
    k = rng.integers(0, 4, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    v[rng.random(n) < 0.1] = np.nan
    t = _strings(n, seed + 1, words=WORDS[:5])
    rt = RTable.from_numpy(["s", "k", "v", "t"], [s, k, v, t],
                           capacity=n + cap_extra)
    return rt, port_table_of(rt)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("by,asc,nulls_first", [
    ("s", True, True), ("s", False, True), ("s", True, False),
    (["t", "s"], [False, True], True), (["k", "s"], True, False)],
    ids=["s", "s-desc", "s-nulls-last", "t-desc,s", "k,s"])
def test_string_sort_matches_reference(mode, by, asc, nulls_first):
    rt, pt = _tables()
    with modes(mode):
        assert_tables_equal(pt.sort(by, asc, nulls_first),
                            rt.sort(by, asc, nulls_first))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("keep", ["first", "last"])
def test_string_unique_matches_reference(mode, keep):
    rt, pt = _tables()
    with modes(mode):
        for cols in ("s", ["t", "k"], None):
            assert_tables_equal(pt.unique(cols, keep), rt.unique(cols, keep))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_string_set_ops_match_reference(mode, op):
    """The two tables' string columns differ in width (32 and 45 bytes),
    so both pass through ``widen_strings``."""
    ra, pa = _tables(seed=9)
    rb, pb = _tables(n=40, seed=11, words=WORDS + ["w" * 45])
    cols = ["s", "t"]
    with modes(mode):
        got = getattr(pa.project(cols), op)(pb.project(cols))
        want = getattr(ra.project(cols), op)(rb.project(cols))
    assert pa.shards[0][0].string_width != pb.shards[0][0].string_width
    assert_tables_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_string_merge_matches_reference(mode):
    ra, pa = _tables(seed=9)
    rb, pb = _tables(n=40, seed=11, words=WORDS + ["w" * 45])
    with modes(mode):
        assert_tables_equal(pa.merge(pb), ra.merge(rb))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_string_join_matches_reference(mode, how):
    ra, pa = _tables(seed=9)
    rb, pb = _tables(n=40, seed=11, words=WORDS + ["w" * 45])
    with modes(mode):
        for on in ("s", ["s", "k"], ["t", "s"]):
            assert_tables_equal(pa.join(pb, on=on, how=how),
                                ra.join(rb, on=on, how=how))


GROUPBY_AGGS = {"v": ["sum", "mean", "min", "max", "count", "var"],
                "k": ["sum", "nunique"], "t": ["nunique"]}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("by", ["s", ["s", "t"], ["k", "s"]])
def test_string_hash_groupby_matches_reference(mode, by):
    rt, pt = _tables()
    with modes(mode):
        got = pt.groupby(by, GROUPBY_AGGS)
        want = rt.groupby(by, GROUPBY_AGGS)
    assert_tables_equal(got, want, float_rtol=1e-5 if mode == "narrow"
                        else 1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_string_pipeline_groupby_matches_reference(mode):
    rt, pt = _tables()
    with modes(mode):
        rs, ps = rt.sort(["s", "t"]), pt.sort(["s", "t"])
        got = ps.groupby(["s", "t"], {"v": ["sum", "max"], "k": "count"},
                         groupby_type="pipeline")
        want = rs.groupby(["s", "t"], {"v": ["sum", "max"], "k": "count"},
                          groupby_type="pipeline")
    assert_tables_equal(got, want, float_rtol=1e-5 if mode == "narrow"
                        else 1e-12)


@pytest.mark.parametrize("groupby_type", ["hash", "pipeline"])
def test_count_of_a_string_column(groupby_type):
    """COUNT of a string column counts its non-null rows: equal to the
    reference's COUNT of a numeric column with the same validity (the
    reference itself refuses COUNT of a string with TypeError)."""
    rt, pt = _tables()
    rt, pt = rt.sort("k"), pt.sort("k")
    s_valid = np.asarray(rt.columns[0].validity)
    proxy = np.where(s_valid, 1.0, np.nan)[:rt.row_count]
    rproxy = RTable.from_numpy(["k", "c"], [rt.to_numpy()["k"], proxy],
                               capacity=rt.capacity)
    want = rproxy.groupby("k", {"c": "count"}, groupby_type=groupby_type)
    got = pt.groupby("k", {"s": "count"}, groupby_type=groupby_type)
    np.testing.assert_array_equal(got.to_numpy()["count_s"],
                                  want.to_numpy()["count_c"])
    with pytest.raises(TypeError, match="COUNT unsupported on strings"):
        rt.groupby("k", {"s": "count"})
    assert int(pt.count("s")) == int(rt.count("s")) == int(s_valid.sum())


COMPARE_VALUES = ["apple", "app", "", "banana ", "zz", "éclair",
                  "a much longer value past eight bytes",
                  "x" * 40, "Customer#000000042", "a\x00b"]


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_string_compare_matches_reference(op):
    rt, pt = _tables()
    for value in COMPARE_VALUES:
        got = compute.compare(pt.project(["s", "t"]), value, op)
        want = getattr(rt.project(["s", "t"]), f"__{op}__")(value)
        assert_tables_equal(got, want)


def test_string_isin_fillna_where_match_reference():
    rt, pt = _tables()
    for vals, skip in ((["apple", "zz", 3], True), (["", None], False),
                       ([], True)):
        assert_tables_equal(pt.isin(vals, skip), rt.isin(vals, skip))
    for fill in ("FILL", 7, 2.5):
        assert_tables_equal(pt.fillna(fill), rt.fillna(fill))
    cond_r = rt.project(["s", "k", "v", "t"]).isnull()
    cond_p = pt.project(["s", "k", "v", "t"]).isnull()
    assert_tables_equal(pt.where(~cond_p), rt.where(~cond_r))
    assert_tables_equal(pt.isnull(), rt.isnull())
    assert_tables_equal(pt.dropna(), rt.dropna())
    assert_tables_equal(pt.select(lambda e: e["k"] > 1),
                        rt.select(lambda e: e["k"] > 1))
    with pytest.raises(CylonError, match="fill string longer"):
        pt.fillna("x" * 33)
    with pytest.raises(CylonError, match=r"where\(other=\) on string"):
        pt.where(~cond_p, 0)


@pytest.mark.parametrize("case", ["add", "neg", "compare_number",
                                  "compare_columns", "join_int_vs_string",
                                  "groupby_sum", "scalar_sum"])
def test_string_errors_match_reference(case):
    rt, pt = _tables()
    calls = {
        "add": (lambda t: t.project("s") + 1, CylonError,
                r"\[Invalid\] arithmetic on string"),
        "neg": (lambda t: -t.project("s"), CylonError,
                r"\[Invalid\] neg on string"),
        "compare_number": (lambda t: t.project("s") == 1, CylonError,
                           r"\[Invalid\] cannot compare string column to"),
        "compare_columns": (lambda t: t.project("s") == t.project("t"),
                            CylonError, r"\[Invalid\] string column-vs-"),
        "join_int_vs_string": (
            lambda t: t.join(t, left_on="s", right_on="k"), CylonError,
            r"\[Invalid\] join key type mismatch"),
        "groupby_sum": (lambda t: t.groupby("k", {"s": "sum"}), TypeError,
                        "SUM unsupported on strings"),
        "scalar_sum": (lambda t: t.sum("s"), TypeError, "string"),
    }
    fn, exc, msg = calls[case]
    with pytest.raises(exc, match=msg):
        fn(pt)
    # the reference raises its own package's CylonError
    with pytest.raises(TypeError if exc is TypeError else Exception,
                       match=msg):
        fn(rt)


def test_table_host_boundary_and_setitem():
    from cylon_tpu_torch import CylonContext, Table

    s = _strings(30, 21)
    v = np.arange(30, dtype=np.float32)
    pt = Table.from_numpy(["s", "v"], [s, v], ctx=CylonContext.Init("cpu"))
    rt = RTable.from_numpy(["s", "v"], [s, v])
    assert_tables_equal(pt, rt)
    for name, col in pt.to_numpy().items():
        np.testing.assert_array_equal(col, rt.to_numpy()[name])
    pt["w"], rt["w"] = pt["v"] * 2.0, rt["v"] * 2.0
    pt["s"], rt["s"] = np.array(["r"] * 30), np.array(["r"] * 30)
    pt["c"], rt["c"] = "const", "const"
    assert pt.names == rt.names
    assert_tables_equal(pt, rt)
    with pytest.raises(CylonError, match="value length"):
        pt["x"] = np.arange(3)
