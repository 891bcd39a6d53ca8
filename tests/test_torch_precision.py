"""Narrow (32-bit) accumulation in the port, against pandas and the JAX
package's narrow mode on the same inputs.

Twins of every test of ``tests/test_precision.py``.  Its two "the jaxpr
is 64-bit free" checks become ``analysis/dtype_audit.py`` runs of the
narrow ``hash_groupby`` (SUM/MEAN/VAR/COUNT, 2048 rows) and of the bench
pipeline (key-grouped join -> pipeline group-by, 1024 rows): the port
does carry 64-bit tensors there, so each run's set of 64-bit sites must
EQUAL the committed ``KNOWN_64BIT_SITES``, every site with its reason.
A new 64-bit op anywhere in those paths fails the check (a planted one
does, below)."""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cylon_tpu import precision as rprec
from cylon_tpu.table import Table as RTable
from cylon_tpu_torch import CylonContext, MeshConfig, Table, column
from cylon_tpu_torch import dtypes, precision
from cylon_tpu_torch.analysis.dtype_audit import dtype_audit
from cylon_tpu_torch.config import JoinType
from cylon_tpu_torch.ops import compact
from cylon_tpu_torch.ops import groupby as gmod
from cylon_tpu_torch.ops import join as jmod

from .torch_parity import modes

_CARRIER = ("32-bit key fields ride in int64: torch on the CPU has no "
            "uint32 <<, >> or %")
_KEY = "the one int64 sort key of the packed fast path (fields + row index)"

#: per audited path, its 64-bit sites (module:function, aten op, dtype)
#: with the reason each is 64-bit; all come from ops/keys.py's int64
#: carriers (ROADMAP, known differences)
KNOWN_64BIT_SITES = {
    "hash_groupby": {
        ("ops.keys:_ordered_unsigned", "aten._to_copy.default", "int64"):
            "each operand's order-preserving encoding; " + _CARRIER,
        ("ops.keys:_ordered_unsigned", "aten.add.Tensor", "int64"):
            "the sign bias of a signed key, in its int64 carrier",
        ("ops.keys:lexsort_indices", "aten.zeros.default", "int64"):
            "the empty sort key, " + _KEY,
        ("ops.keys:lexsort_indices", "aten.__lshift__.Scalar", "int64"):
            "shifting each field into " + _KEY,
        ("ops.keys:lexsort_indices", "aten.bitwise_or.Tensor", "int64"):
            "or-ing each field into " + _KEY,
        ("ops.keys:lexsort_indices", "aten.arange.default", "int64"):
            "the row index packed into the key's low bits",
        ("ops.keys:lexsort_indices", "aten.sort.stable", "int64"):
            "torch.sort of " + _KEY + "; its indices are int64 always",
        ("ops.keys:lexsort_indices", "aten.bitwise_and.Scalar", "int64"):
            "masking the permutation and the words out of the sorted key",
        ("ops.keys:lexsort_indices", "aten.__rshift__.Scalar", "int64"):
            "shifting the words out of the sorted key",
        ("ops.keys:rows_equal_adjacent", "aten.slice.Tensor", "int64"):
            "views of the int64 words compared with their neighbours",
    },
}
KNOWN_64BIT_SITES["bench_pipeline"] = {
    **KNOWN_64BIT_SITES["hash_groupby"],
    ("ops.keys:_pack_encoded", "aten.__lshift__.Scalar", "int64"):
        "packing the group-by's key fields into one word; " + _CARRIER,
    ("ops.keys:_pack_encoded", "aten.bitwise_or.Tensor", "int64"):
        "packing the group-by's key fields into one word; " + _CARRIER,
}


@pytest.fixture()
def narrow_mode():
    with modes("narrow"):
        yield


@pytest.fixture(scope="module")
def pctx4():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=4))


@pytest.fixture(scope="module")
def pctx2():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=2))


def _check_sites(audit, path):
    """The audit's sites equal the committed ones of ``path``."""
    got = audit.site_keys()
    want = set(KNOWN_64BIT_SITES[path])
    assert got == want, (f"64-bit sites of the narrow {path}: new "
                         f"{sorted(got - want)}, gone {sorted(want - got)}")
    assert all(KNOWN_64BIT_SITES[path][k] for k in got)
    assert 0 < audit.wide_bytes < audit.total_bytes


def test_mode_resolution():
    cpu = torch.device("cpu")
    assert precision.accumulation_mode(cpu) == "wide"  # the CPU default
    assert precision.accumulation_mode(torch.device("cuda")) == "narrow"
    precision.set_accumulation("narrow")
    try:
        assert precision.narrow(cpu)
        assert precision.float_acc(cpu) == torch.float32
        assert precision.float_acc_for(torch.float64, cpu) == torch.float32
        assert precision.int_acc() == torch.int64
        assert precision.count_acc() == torch.int32
    finally:
        precision.set_accumulation(None)
    with pytest.raises(ValueError):
        precision.set_accumulation("huge")


def _groupby_frame(rng, n=4000):
    return pd.DataFrame({
        "k": rng.integers(0, 50, n),
        "v": rng.random(n).astype(np.float32),
        "w": rng.integers(0, 1000, n).astype(np.int64),
    })


def test_narrow_groupby_matches_pandas(pctx4, ctx4, narrow_mode):
    df = _groupby_frame(np.random.default_rng(42))
    aggs = {"v": ["sum", "mean", "std"], "w": ["sum", "count"]}
    g = Table.from_pandas(df, ctx=pctx4).groupby("k", aggs)
    got = g.to_pandas().sort_values("k").reset_index(drop=True)
    ref = (RTable.from_pandas(df, ctx=ctx4).groupby("k", aggs).to_pandas()
           .sort_values("k").reset_index(drop=True))
    exp = df.groupby("k").agg(
        sum_v=("v", "sum"), mean_v=("v", "mean"), std_v=("v", "std"),
        sum_w=("w", "sum"), count_w=("w", "count")).reset_index()
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(exp) == len(ref)
    np.testing.assert_allclose(got["sum_v"], exp["sum_v"], rtol=1e-4)
    np.testing.assert_allclose(got["mean_v"], exp["mean_v"], rtol=1e-4)
    for c in ("sum_v", "mean_v", "stddev_v"):
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-5)
    assert np.array_equal(got["sum_w"], exp["sum_w"])  # int64 exact
    assert np.array_equal(got["count_w"], exp["count_w"])
    assert np.array_equal(got["sum_w"], ref["sum_w"])
    # narrow outputs: f32 statistics; counts are int32 partials combined
    # by an integer SUM, which widens to int64
    by_name = dict(g.schema)
    assert by_name["mean_v"].type == dtypes.Type.FLOAT
    assert by_name["count_w"].type == dtypes.Type.INT64
    assert by_name["sum_w"].type == dtypes.Type.INT64


def _narrow_groupby(k, v, n):
    return gmod.hash_groupby(
        (k, v), torch.tensor(n, dtype=torch.int32), (0,),
        ((1, gmod.AggOp.SUM), (1, gmod.AggOp.MEAN), (1, gmod.AggOp.VAR),
         (0, gmod.AggOp.COUNT)), 0)


def _groupby_columns(seed=42, n=2048):
    rng = np.random.default_rng(seed)
    return (column.from_numpy(rng.integers(0, 9, n).astype(np.int32),
                              device="cpu"),
            column.from_numpy(rng.random(n).astype(np.float32),
                              device="cpu"))


def test_narrow_groupby_64bit_sites_are_the_known_ones(narrow_mode):
    """The audit of the narrow group-by: every 64-bit output is one of
    ``KNOWN_64BIT_SITES``, and every known one still happens; its
    float outputs stay 32-bit."""
    k, v = _groupby_columns()
    (cols, g), audit = dtype_audit(_narrow_groupby, k, v, 2048)
    _check_sites(audit, "hash_groupby")
    assert int(g) == 9
    assert [c.data.dtype for c in cols[1:]] == [torch.float32] * 3 \
        + [torch.int32]


def test_planted_64bit_op_fails_the_check(narrow_mode, monkeypatch):
    """One int64 op added inside the group-by's path is a new site."""
    k, v = _groupby_columns()
    real = compact.compact_indices

    def planted(mask):
        torch.arange(mask.shape[0], dtype=torch.int64)
        return real(mask)

    monkeypatch.setattr(compact, "compact_indices", planted)
    _, audit = dtype_audit(_narrow_groupby, k, v, 2048)
    with pytest.raises(AssertionError, match="new"):
        _check_sites(audit, "hash_groupby")
    assert ("ops.segments:segment_spans", "aten.arange.default",
            "int64") in audit.site_keys()


def test_narrow_bench_pipeline_64bit_sites_are_the_known_ones(narrow_mode):
    """The bench shape (key-grouped join -> pipeline group-by) in narrow
    mode: its 64-bit sites are the committed ones, its outputs 32-bit,
    and its results the reference's."""
    from cylon_tpu import column as rcolmod
    from cylon_tpu.config import JoinType as RJoinType
    from cylon_tpu.ops import groupby as rgmod
    from cylon_tpu.ops import join as rjmod

    from .torch_parity import port_column

    rng = np.random.default_rng(42)
    n = 1024
    rk = rcolmod.from_numpy(rng.integers(0, 200, n).astype(np.int32))
    rv = rcolmod.from_numpy(rng.random(n).astype(np.float32))
    k, v = port_column(rk), port_column(rv)

    def pipeline(cl, c1, cr, c2):
        joined, jm = jmod.join_gather(cl, c1, cr, c2, (0,), (0,),
                                      JoinType.INNER, 4 * n, "sort",
                                      key_grouped=True)
        gcols, g = gmod.pipeline_groupby(
            joined, jm, (0,), ((1, gmod.AggOp.SUM), (3, gmod.AggOp.MEAN)), 0)
        return gcols[1].data, gcols[2].data, g

    cnt = torch.tensor(n, dtype=torch.int32)
    (s, m, g), audit = dtype_audit(pipeline, (k, v), cnt, (k, v), cnt)
    _check_sites(audit, "bench_pipeline")
    assert s.dtype == m.dtype == torch.float32

    joined, jm = rjmod.join_gather((rk, rv), jnp.int32(n), (rk, rv),
                                   jnp.int32(n), (0,), (0,),
                                   RJoinType.INNER, 4 * n, "sort",
                                   key_grouped=True)
    rcols, rg = rgmod.pipeline_groupby(
        joined, jm, (0,), ((1, rgmod.AggOp.SUM), (3, rgmod.AggOp.MEAN)), 0)
    assert int(g) == int(rg)
    np.testing.assert_allclose(s.numpy(), np.asarray(rcols[1].data),
                               rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(rcols[2].data),
                               rtol=1e-5)


def test_narrow_distributed_sort(pctx4, ctx4, narrow_mode):
    rng = np.random.default_rng(42)
    n = 3000
    df = pd.DataFrame({"a": rng.random(n), "b": rng.integers(0, 9, n)})
    vals = Table.from_pandas(df, ctx=pctx4).distributed_sort(
        "a").to_pandas()["a"].to_numpy()
    ref = RTable.from_pandas(df, ctx=ctx4).distributed_sort(
        "a").to_pandas()["a"].to_numpy()
    assert len(vals) == n and np.all(np.diff(vals) >= 0)
    np.testing.assert_array_equal(vals, ref)


def test_narrow_scalar_aggs(pctx2, ctx2, narrow_mode):
    rng = np.random.default_rng(42)
    n = 2048
    df = pd.DataFrame({"x": rng.random(n).astype(np.float32)})
    t = Table.from_pandas(df, ctx=pctx2)
    rt = RTable.from_pandas(df, ctx=ctx2)
    assert abs(float(t.sum("x")) - df["x"].sum()) < 1e-2
    assert abs(float(t.sum("x")) - float(rt.sum("x"))) < 1e-3
    assert int(t.count("x")) == int(rt.count("x")) == n
    assert float(t.min("x")) == float(rt.min("x")) == df["x"].min()
    assert float(t.max("x")) == float(rt.max("x")) == df["x"].max()


def test_narrow_join_groupby_pipeline(pctx4, ctx4, narrow_mode):
    rng = np.random.default_rng(42)
    n = 3000
    left = pd.DataFrame({"k": rng.integers(0, 200, n),
                         "a": rng.random(n).astype(np.float32)})
    right = pd.DataFrame({"k": rng.integers(0, 200, n),
                          "b": rng.random(n).astype(np.float32)})
    exp = (left.merge(right, on="k").groupby("k")
           .agg(s=("a", "sum")).reset_index())
    outs = []
    for T, ctx in ((Table, pctx4), (RTable, ctx4)):
        j = T.from_pandas(left, ctx=ctx).distributed_join(
            T.from_pandas(right, ctx=ctx), on="k", how="inner")
        got = j.groupby(j.column_names[0], {j.column_names[1]: ["sum"]}) \
            .to_pandas()
        outs.append(got.sort_values(got.columns[0]).reset_index(drop=True))
    got, ref = outs
    assert len(got) == len(exp) == len(ref)
    np.testing.assert_array_equal(got.iloc[:, 0], exp["k"])
    np.testing.assert_allclose(got.iloc[:, 1], exp["s"], rtol=1e-3)
    np.testing.assert_allclose(got.iloc[:, 1], ref.iloc[:, 1], rtol=1e-5)


def test_narrow_segmented_reductions_match_pandas(pctx4, ctx4, narrow_mode):
    """The twin of the reference's ``CYLON_TPU_SEGSUM=prefix`` case: the
    port has one segmented path in narrow mode (the scan kernels' plain
    versions on the CPU), and every float op, min/max and the two-phase
    distributed group-by agree with pandas and the reference's narrow
    default."""
    rng = np.random.default_rng(42)
    n = 6000
    df = pd.DataFrame({"k": rng.integers(0, 40, n),
                       "v": rng.random(n).astype(np.float32)})
    df.loc[rng.integers(0, n, 60), "v"] = np.nan
    ops = ["sum", "mean", "min", "max", "std", "var"]
    got = (Table.from_pandas(df, ctx=pctx4).groupby(["k"], {"v": ops})
           .to_pandas().sort_values("k").reset_index(drop=True))
    ref = (RTable.from_pandas(df, ctx=ctx4).groupby(["k"], {"v": ops})
           .to_pandas().sort_values("k").reset_index(drop=True))
    gb = df.groupby("k")["v"]
    exp = pd.DataFrame({
        "sum": gb.sum(min_count=1), "mean": gb.mean(),
        "min": gb.min(), "max": gb.max(),
        "std": gb.std(ddof=0), "var": gb.var(ddof=0),
    }).reset_index()
    assert len(got) == len(exp) == len(ref)
    np.testing.assert_array_equal(got.iloc[:, 0].to_numpy(),
                                  exp["k"].to_numpy())
    for i, c in enumerate(ops, start=1):
        np.testing.assert_allclose(got.iloc[:, i].to_numpy(),
                                   exp[c].to_numpy().astype(np.float32),
                                   rtol=2e-4, atol=1e-5, err_msg=c)
        np.testing.assert_allclose(got.iloc[:, i].to_numpy(),
                                   ref.iloc[:, i].to_numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=c)
    assert rprec.accumulation_mode() == "narrow"
