"""The port's general out-of-core engine (``exec.chunked_join`` /
``chunked_join_groupby_tables``) against the JAX package's on the same
pandas frames, on the CPU, mirroring the join and group-by cases of
``tests/test_exec_tables.py``: every join type, string and multi-key joins,
final group-bys in the range, hash and auto modes, the cross-pass partial
combine (MEAN/VAR/STDDEV by a non-key column), a string group key, a left
join grouped finally, unequal string widths, deep common-prefix strings,
the key-dtype mismatch, and the presorted chunk builder against masking.

Results compare row for row: both engines plan the same pass ids, run the
same per-pass kernels, and concatenate passes in the same order.  Wide
mode against the reference's default, narrow under
``torch_parity.modes("narrow")``.  Tolerances: keys, counts, strings and
stats exact; float64 rtol=1e-12 (the combined VAR/STDDEV included: the
host derives them in float64); float32 sums and means rtol=1e-5
(``tests/test_torch_segments.py``).
"""
import numpy as np
import pandas as pd
import pytest

from cylon_tpu import column as rcol
from cylon_tpu import exec as rexec
from cylon_tpu_torch import CylonContext
from cylon_tpu_torch import column as pcol
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import exec as pexec
from cylon_tpu_torch.status import CylonError

from .torch_parity import assert_frames_equal, modes

CPU = CylonContext.Init("cpu")
STATS = ("passes", "mode", "chunk_cap", "cap_l", "cap_r", "out_cap",
         "world", "parts_run", "groups", "rows")


def _both(fn, left, right, precision="wide", float_rtol=None, **kw):
    with modes(precision):
        want, wstats = getattr(rexec, fn)(left, right, **kw)
        got, gstats = getattr(pexec, fn)(left, right, ctx=CPU, **kw)
    assert_frames_equal(got, want, float_rtol)
    for k in STATS:
        assert gstats.get(k) == wstats.get(k), (k, gstats, wstats)
    return got, gstats


def _mk_orders(rng, n, ncust=50, with_strings=False):
    d = {"cust": rng.integers(0, ncust, n).astype(np.int64),
         "amount": rng.random(n).astype(np.float64).round(3),
         "qty": rng.integers(1, 9, n).astype(np.int64)}
    if with_strings:
        d["tag"] = np.asarray([f"t{int(x) % 7}" for x in d["cust"]],
                              dtype=object)
    return pd.DataFrame(d)


def _mk_custs(rng, ncust=50):
    return pd.DataFrame({
        "cust": np.arange(ncust, dtype=np.int64),
        "nation": rng.integers(0, 5, ncust).astype(np.int64),
        "name": np.asarray([f"cust-{i:03d}" for i in range(ncust)],
                           dtype=object)})


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_chunked_join_all_types(rng, how, mode):
    left = _mk_orders(rng, 1500)
    right = _mk_custs(rng)
    # drop some custs so outer variants have unmatched rows on both sides
    right = right[right["cust"] % 5 != 3].reset_index(drop=True)
    got, stats = _both("chunked_join", left, right, mode, on="cust", how=how,
                       passes=5)
    assert stats["passes"] >= 2
    ref = left.merge(right, on="cust", how=how)
    assert stats["rows"] == len(ref)


def test_chunked_join_string_key(rng):
    n = 1500
    lk = np.asarray([f"key-{rng.integers(0, 60):02d}" for _ in range(n)],
                    dtype=object)
    left = pd.DataFrame({"sk": lk, "v": rng.random(n).round(3)})
    rk = np.asarray([f"key-{i:02d}" for i in range(60)], dtype=object)
    right = pd.DataFrame({"sk": rk, "w": rng.random(60).round(3)})
    _, stats = _both("chunked_join", left, right, on="sk", how="inner",
                     passes=6)
    assert stats["rows"] == len(left.merge(right, on="sk", how="inner"))


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_join_multi_key_mixed_types(rng, mode):
    n = 1500
    left = pd.DataFrame({
        "k1": rng.integers(0, 12, n).astype(np.int64),
        "k2": np.asarray([f"s{rng.integers(0, 4)}" for _ in range(n)],
                         dtype=object),
        "v": rng.random(n).round(3)})
    right = pd.DataFrame({
        "k1": rng.integers(0, 12, 400).astype(np.int64),
        "k2": np.asarray([f"s{rng.integers(0, 4)}" for _ in range(400)],
                         dtype=object),
        "w": rng.random(400).round(3)})
    _, stats = _both("chunked_join", left, right, mode, on=["k1", "k2"],
                     how="inner", passes=4)
    assert stats["rows"] == len(left.merge(right, on=["k1", "k2"]))


@pytest.mark.parametrize("precision", ["wide", "narrow"])
@pytest.mark.parametrize("mode", ["range", "hash", "auto"])
def test_chunked_groupby_final_modes(rng, mode, precision):
    """Group key == join key: per-pass finality in every partition mode."""
    left = _mk_orders(rng, 2000)
    right = _mk_custs(rng)
    _, stats = _both("chunked_join_groupby_tables", left, right, precision,
                     on="cust", how="inner", group_by="l_cust",
                     agg={"amount": ["sum", "mean"], "qty": ["count"]},
                     passes=5, mode=mode)
    assert stats["mode"] == ("range" if mode == "auto" else mode)
    assert stats["groups"] == left["cust"].nunique()


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_groupby_partial_combine(rng, mode):
    """Group key != join key (join on cust, group by nation): groups span
    passes, so per-pass partials and one device combine on the engine's
    context."""
    left = _mk_orders(rng, 2500)
    right = _mk_custs(rng)
    got, stats = _both(
        "chunked_join_groupby_tables", left, right, mode, on="cust",
        how="inner", group_by="nation",
        agg={"amount": ["sum", "mean", "count", "min", "max", "var",
                        "std"]}, passes=6)
    assert stats["groups"] == len(got["nation"]) == right["nation"].nunique()


def test_chunked_groupby_string_group_key_partial(rng):
    """String group key off the join key: a partial combine over string
    groups (the string partial table re-uploads for the final phase)."""
    left = _mk_orders(rng, 1500, with_strings=True)
    right = _mk_custs(rng)
    _both("chunked_join_groupby_tables", left, right, on="cust", how="inner",
          group_by="name", agg={"amount": ["sum", "count"]}, passes=4,
          mode="hash")


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_chunked_groupby_left_join_final(rng, mode):
    """LEFT join grouped by the left key: final per pass (unmatched rows
    stay in their key's pass), with all-null groups in the right column."""
    left = _mk_orders(rng, 1500, ncust=80)
    right = _mk_custs(rng, ncust=40)  # half the custs unmatched
    _both("chunked_join_groupby_tables", left, right, mode, on="cust",
          how="left", group_by="l_cust",
          agg={"amount": ["sum"], "nation": ["count", "max"]}, passes=4)


def test_chunked_hash_mode_unequal_string_widths():
    """The row hash must not depend on each side's max string length:
    equal keys with different array widths land in the same pass."""
    left = pd.DataFrame({"k": np.asarray(["ab", "cd", "ab", "xy"], object),
                         "v": np.arange(4.0)})
    right = pd.DataFrame({"k": np.asarray(["ab", "wxyz", "cd"], object),
                          "w": np.arange(3.0)})
    _, stats = _both("chunked_join", left, right, on="k", how="inner",
                     passes=2, mode="hash")
    assert stats["mode"] == "hash" and stats["rows"] == 3


def test_chunked_deep_common_prefix_strings_fan_out(rng):
    """Strings sharing a >8-codepoint prefix: range planning degenerates;
    auto flips to full-content hashing and still chunks."""
    keys = np.asarray([f"warehouse/region-7/shelf-{i % 37:04d}"
                       for i in range(800)], dtype=object)
    left = pd.DataFrame({"k": keys, "v": rng.random(800).round(3)})
    right = pd.DataFrame({"k": np.asarray(sorted(set(keys.tolist())), object),
                          "w": rng.random(37).round(3)})
    _, stats = _both("chunked_join", left, right, on="k", how="inner",
                     passes=5)
    assert stats["mode"] == "hash" and stats["passes"] >= 4, stats


def test_chunked_join_key_dtype_mismatch():
    left = pd.DataFrame({"k": np.arange(5, dtype=np.int32)})
    right = pd.DataFrame({"k": np.arange(5, dtype=np.int64)})
    with pytest.raises(CylonError, match="type mismatch"):
        pexec.chunked_join(left, right, on="k", how="inner", passes=2,
                           ctx=CPU)


def test_chunked_nunique_partial_rejected(rng):
    left = _mk_orders(rng, 300)
    right = _mk_custs(rng)
    with pytest.raises(CylonError, match="NUNIQUE"):
        pexec.chunked_join_groupby_tables(
            left, right, on="cust", how="inner", group_by="nation",
            agg={"amount": ["nunique"]}, passes=4, ctx=CPU)


def test_chunked_join_takes_dicts_and_tables(rng):
    """Host frames as dicts of arrays and as the port's own Tables (its
    ``to_numpy``) give the pandas frame's result."""
    from cylon_tpu_torch import Table

    left = _mk_orders(rng, 500)
    right = _mk_custs(rng)
    want, _ = pexec.chunked_join(left, right, on="cust", passes=3, ctx=CPU)
    as_dict = {c: left[c].to_numpy() for c in left.columns}
    as_table = Table.from_numpy(list(right.columns),
                                [right[c].to_numpy() for c in right.columns],
                                ctx=CPU)
    got, _ = pexec.chunked_join(as_dict, as_table, on="cust", passes=3,
                                ctx=CPU)
    assert_frames_equal(got, want)


@pytest.mark.parametrize("presort", ["0", "1"])
def test_side_builder_presort_equivalence(rng, presort):
    """The presort (contiguous-slice) and mask chunk builders emit the
    reference's chunks: pass order, string columns, passes past the
    planned id range."""
    n = 2000
    arrs = {"k": rng.integers(0, 90, n).astype(np.int64),
            "v": rng.random(n).astype(np.float32),
            "s": np.asarray([f"row{rng.integers(0, 20)}" for _ in range(n)],
                            dtype=object)}
    pid = rng.integers(0, 5, n).astype(np.int32)
    with pconfig.knob_env(CYLON_TPU_CHUNK_PRESORT=presort):
        b = pexec._SideBuilder(list(arrs), arrs, pid, 2048, "cpu")
        r = rexec._SideBuilder(list(arrs), arrs, pid, 2048)
    assert b.presort == r.presort == (presort == "1")
    for p in (0, 1, 4, 7):  # 7 is past every planned id: empty
        cols, cnt = b.chunk(p)
        rcols, rcnt = r.chunk(p)
        assert int(cnt) == int(rcnt) == int((pid == p).sum())
        for c, rc in zip(cols, rcols):
            assert c.capacity == 2048 and c.string_width == \
                (rc.data.shape[1] if rc.data.ndim == 2 else 0)
            got = pcol.to_numpy(c, int(cnt))
            want = rcol.to_numpy(rc, int(rcnt))
            assert list(got) == list(want)
    empty, n0 = b.empty_chunk(only=["s"])
    assert int(n0) == 0 and empty[0].capacity == 2048
    # a single-pass plan never pays the grouped copy
    b1 = pexec._SideBuilder(list(arrs), arrs, np.zeros(n, np.int32), 2048,
                            "cpu")
    assert not b1.presort and int(b1.chunk(0)[1]) == n


@pytest.mark.parametrize("top", [3, (1 << 15) - 1, 1 << 15, 1 << 20])
def test_grouping_order_equals_the_stable_argsort(rng, top):
    """The presort's int16 fast path gives numpy's stable argsort of the
    pass ids exactly; ids at or past 2^15 keep their own dtype."""
    pid = rng.integers(0, top + 1, 5000).astype(np.int64)
    pid[:3] = top
    np.testing.assert_array_equal(pexec._grouping_order(pid),
                                  np.argsort(pid, kind="stable"))
