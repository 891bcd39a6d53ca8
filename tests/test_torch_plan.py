"""The port's query planner (``cylon_tpu_torch/plan/``) against the JAX
package's (``cylon_tpu/plan/``), the counterpart of ``tests/test_plan.py``.

The same numpy tables go to the reference on its CPU mesh (the
``local_ctx`` / ``ctx2`` / ``ctx4`` fixtures of ``tests/conftest.py``) and
to the port on ``MeshConfig(devices=["cpu"], world_size=...)``:

- the optimizer's decisions agree: ``explain()`` renders the same text,
  and ``plan.shuffles_elided`` moves by the same count;
- planned and eager (``CYLON_TPU_PLAN=0``) give bit-identical tables in
  the port, as in the reference;
- gathered and sorted, the port's tables equal the reference's (exact
  for keys and counts, float sums within rtol 1e-5: the two packages
  place rows by different hashes on the CPU, so partial sums meet in
  another order) and a pandas oracle;
- under ``CYLON_TPU_SHUFFLE_PACK=1`` both packages run the same number
  of exchanges, collective launches and count gathers.

The plan-granularity journal replay runs in both packages under a
durable dir (``test_journal_replay_zero_compiles``), and so does the
serve layer's plan op (``test_serve_plan_op_and_cache_hit``).  No case of
``tests/test_plan.py`` waits for a later item (``WAITING`` is empty).
"""
import contextlib

import numpy as np
import pandas as pd
import pytest

from cylon_tpu import Table as RTable
from cylon_tpu import config as rconfig
from cylon_tpu.obs import metrics as robs_metrics
from cylon_tpu.plan import col as rcol
from cylon_tpu.plan import lit as rlit
from cylon_tpu.plan import optimizer as roptimizer
from cylon_tpu_torch import (CylonContext, CylonError, MeshConfig, Table,
                             config)
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.parallel import collectives
from cylon_tpu_torch.plan import col, lit, optimizer
from cylon_tpu_torch.plan import executor as plan_executor

#: cases of tests/test_plan.py that wait for a later ROADMAP item
WAITING: dict = {}

WORLDS = (1, 2, 4)
REF_FIXTURE = {1: "local_ctx", 2: "ctx2", 4: "ctx4"}


@pytest.fixture(scope="module")
def meshes():
    return {w: (CylonContext.Init("cpu") if w == 1 else
                CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                        world_size=w)))
            for w in WORLDS}


@pytest.fixture
def pair(meshes, request):
    """world -> (reference context, port context)."""
    return lambda w: (request.getfixturevalue(REF_FIXTURE[w]), meshes[w])


def _raw(rng, n=240, nkeys=24, wide=False):
    d = {"k": rng.integers(0, nkeys, n).astype(np.int32),
         "v": rng.random(n).astype(np.float32),
         "w": rng.random(n).astype(np.float32)}
    if wide:
        for i in range(9):
            d[f"pad{i}"] = rng.random(n).astype(np.float32)
    return d


def _raw_right(rng, n=240, nkeys=24):
    return {"k2": rng.integers(0, nkeys, n).astype(np.int32),
            "u": rng.random(n).astype(np.float32)}


def _tables(raw, rctx, pctx):
    """(reference Table, port Table) of the same numpy columns."""
    return (RTable.from_numpy(list(raw), list(raw.values()), ctx=rctx),
            Table.from_numpy(list(raw), list(raw.values()), ctx=pctx))


def _sorted_pd(t, by):
    return t.to_pandas().sort_values(by).reset_index(drop=True)


def _both(build, rt, pt):
    """``build`` over (reference tables, col, lit) and (port tables, col,
    lit): the two plans of one query."""
    return build(*rt, rcol, rlit), build(*pt, col, lit)


def _assert_like_reference(port, ref, by):
    """Gathered and sorted: names, dtypes, keys and counts exact, floats
    within rtol 1e-5 of the reference's."""
    a, b = _sorted_pd(port, by), _sorted_pd(ref, by)
    pd.testing.assert_frame_equal(a, b, check_exact=False, rtol=1e-5,
                                  atol=1e-6)


def _planned_and_eager(q):
    planned = q.execute()
    with config.knob_env(CYLON_TPU_PLAN="0"):
        eager = q.execute()
    return planned, eager


def _counters(metrics, names):
    snap = metrics.snapshot()["counters"]
    return {n: snap.get(n, 0) for n in names}


@contextlib.contextmanager
def _deltas(metrics, names):
    before = _counters(metrics, names)
    out = {}
    yield out
    after = _counters(metrics, names)
    out.update({n: after[n] - before[n] for n in names})


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


def test_expr_spec_columns_render():
    from cylon_tpu.plan.expr import render as rrender
    from cylon_tpu_torch.plan.expr import render

    e = (col("a") * (lit(1.0) - col("b"))) >= lit(2)
    r = (rcol("a") * (rlit(1.0) - rcol("b"))) >= rlit(2)
    assert e.columns() == r.columns() == {"a", "b"}
    # the spec is what the fingerprint hashes: the same tuple in both
    assert e.spec() == r.spec() and e.spec()[:2] == ("bin", "ge")
    assert render(e) == rrender(r) == "((a * (1.0 - b)) >= 2)"


def test_expr_literal_subtrees_constant_fold(pair):
    from cylon_tpu_torch.plan.expr import render

    e = col("v") * (lit(1.0) - lit(0.1))
    assert render(e) == "(v * 0.9)"
    raw = _raw(np.random.default_rng(0), n=32)
    rt, pt = _tables(raw, *pair(1))
    got = pt.plan().with_column("net", e).execute()
    want = rt.plan().with_column(
        "net", rcol("v") * (rlit(1.0) - rlit(0.1))).execute()
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    np.testing.assert_allclose(got.to_pandas()["net"],
                               raw["v"] * np.float32(0.9), rtol=1e-6)


def test_logical_with_folded_literal_operand(pair):
    raw = _raw(np.random.default_rng(0), n=64)
    rt, pt = _tables(raw, *pair(1))
    out = pt.plan().filter((col("k") > 2) & (lit(1) < lit(2))).execute()
    ref = rt.plan().filter((rcol("k") > 2) & (rlit(1) < rlit(2))).execute()
    assert out.row_count == ref.row_count == int((raw["k"] > 2).sum())
    pd.testing.assert_frame_equal(out.to_pandas(), ref.to_pandas())
    none = pt.plan().filter((col("k") > 2) & (lit(1) > lit(2))).execute()
    assert none.row_count == 0
    with pytest.raises(CylonError, match="constant"):
        pt.plan().filter(lit(1) < lit(2))


def test_expr_no_truth_value():
    with pytest.raises(CylonError):
        bool(col("a") > 1)


def test_plan_filter_rejects_lambda(pair):
    _, pt = _tables(_raw(np.random.default_rng(0)), *pair(1))
    with pytest.raises(CylonError):
        pt.plan().filter(lambda r: r.k > 1)


def test_expr_filter_matches_eager_select(pair):
    raw = _raw(np.random.default_rng(1))
    rt, pt = _tables(raw, *pair(1))
    planned = pt.plan().filter((col("k") >= lit(5))
                               & (col("v") < lit(0.5))).execute()
    eager = pt.select(lambda r: (r.k >= 5) & (r.v < 0.5))
    pd.testing.assert_frame_equal(_sorted_pd(planned, ["k", "v"]),
                                  _sorted_pd(eager, ["k", "v"]))
    ref = rt.plan().filter((rcol("k") >= rlit(5))
                           & (rcol("v") < rlit(0.5))).execute()
    pd.testing.assert_frame_equal(_sorted_pd(planned, ["k", "v"]),
                                  _sorted_pd(ref, ["k", "v"]))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "neg",
                                "lit_sub", "lit_div", "and", "or", "not"])
def test_expr_operators_promote_as_the_reference(pair, op):
    """Every operator the compute layer has, with a literal and column
    operands of int32, int64 and float32: the derived column's dtype and
    values equal the reference's (``lit / col`` materializes an int32 or
    float32 literal column; negation zeroes null rows)."""
    rng = np.random.default_rng(40)
    raw = {"i": rng.integers(-9, 9, 64).astype(np.int32),
           "j": rng.integers(1, 9, 64).astype(np.int64),
           "f": rng.random(64).astype(np.float32) + 0.5}
    rt, pt = _tables(raw, *pair(1))

    def build(c, l):
        return {"add": c("i") + 2.5, "sub": c("j") - c("i"),
                "mul": c("f") * c("i"), "truediv": c("i") / c("j"),
                "neg": -c("f"), "lit_sub": l(3) - c("j"),
                "lit_div": l(2.0) / c("f"),
                "and": (c("i") > 0) & (c("f") < l(1.0)),
                "or": (c("i") > 0) | l(False),
                "not": ~(c("j") >= 4)}[op]

    got = pt.plan().with_column("x", build(col, lit)).execute()
    want = rt.plan().with_column("x", build(rcol, rlit)).execute()
    g, w = got.to_pandas()["x"], want.to_pandas()["x"]
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g.to_numpy(), w.to_numpy())


# ---------------------------------------------------------------------------
# builder / schema
# ---------------------------------------------------------------------------


def test_builder_schema_and_errors(pair):
    rng = np.random.default_rng(2)
    _, pt = _tables(_raw(rng), *pair(1))
    _, pr = _tables(_raw_right(rng), *pair(1))
    p = pt.plan().join(pr, left_on="k", right_on="k2")
    assert p.names == ("k", "v", "w", "k2", "u")
    assert pt.plan().join(pt, on="k").names[:3] == ("l_k", "l_v", "l_w")
    assert p.groupby(["k"], {"u": ["sum", "mean"]}).names == (
        "k", "sum_u", "mean_u")
    with pytest.raises(CylonError):
        p.project(["nope"])
    with pytest.raises(CylonError):
        p.groupby(["nope"], {"u": "sum"})
    with pytest.raises(CylonError):
        pt.plan().filter(col("missing") > 1)


def _join_groupby(lt, rt, c, l):
    return (lt.plan().join(rt, left_on="k", right_on="k2")
            .groupby(["k"], {"u": "sum"}))


def test_explain_renders_decisions(pair):
    rng = np.random.default_rng(3)
    lt = _tables(_raw(rng, wide=True), *pair(4))
    rt = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (lt[0], rt[0]), (lt[1], rt[1]))
    s = q.explain()
    assert "shuffle ELIDED" in s and "FUSED with join" in s
    assert "pruned 12->1 cols" in s, s
    assert s == rq.explain()
    e = q.explain(optimized=False)
    assert "ELIDED" not in e and "mode=eager" in e
    assert e == rq.explain(optimized=False)


# ---------------------------------------------------------------------------
# optimizer decisions
# ---------------------------------------------------------------------------


def test_optimizer_annotations(pair):
    rng = np.random.default_rng(4)
    lt = _tables(_raw(rng, wide=True), *pair(4))
    rt = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (lt[0], rt[0]), (lt[1], rt[1]))
    phys = optimizer.optimize(q, enabled=True)
    assert phys.shuffles_elided == 1
    assert phys.columns_pruned == 11
    agg = phys.root
    assert agg.ann["mode"] == "elided" and agg.ann.get("fuse")
    assert agg.children[0].ann["left"][0] == "shuffle"
    assert agg.children[0].ann["right"][0] == "shuffle"
    eager = optimizer.optimize(q, enabled=False)
    assert eager.shuffles_elided == 0 and eager.columns_pruned == 0
    assert eager.root.ann["mode"] == "eager"
    for enabled in (True, False):
        ref = roptimizer.optimize(rq, enabled=enabled)
        mine = optimizer.optimize(q, enabled=enabled)
        assert (mine.shuffles_elided, mine.columns_pruned, mine.nodes) == (
            ref.shuffles_elided, ref.columns_pruned, ref.nodes)


def _self_join(t, c, l):
    return (t.plan().project(["k", "v"])
            .join(t.plan().project(["k"]), on="k")
            .groupby(["l_k"], {"v": "sum"}))


def test_optimizer_shares_self_join_scan(pair):
    rt, pt = _tables(_raw(np.random.default_rng(5)), *pair(4))
    rq, q = _both(_self_join, (rt,), (pt,))
    phys = optimizer.optimize(q, enabled=True)
    assert phys.root.children[0].ann.get("shared") is True
    assert phys.shuffles_elided == 2
    assert q.explain() == rq.explain()


def test_optimizer_respects_prepartitioned_scan(pair):
    rng = np.random.default_rng(6)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    ts = pt.shuffle(["k"])
    assert getattr(ts, "_partitioning", None) == ("hash", (("k",),), 4)
    phys = optimizer.optimize(ts.plan().join(pr, left_on="k",
                                             right_on="k2"), enabled=True)
    assert phys.root.ann["left"][0] == "elide"
    assert phys.root.ann["right"] == ("shuffle", ("k2",))


def test_outer_join_output_not_treated_partitioned(pair):
    rng = np.random.default_rng(7)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    q = (pt.plan().join(pr, left_on="k", right_on="k2", how="outer")
         .groupby(["k"], {"u": "sum"}))
    assert optimizer.optimize(q, enabled=True).root.ann["mode"] == "eager"


def test_nunique_never_elides(pair):
    rng = np.random.default_rng(8)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    q = (pt.plan().join(pr, left_on="k", right_on="k2")
         .groupby(["k"], {"u": "nunique"}))
    phys = optimizer.optimize(q, enabled=True)
    assert phys.root.ann["mode"] == "eager"
    assert not phys.root.ann.get("fuse")


# ---------------------------------------------------------------------------
# execution: bit-identity, the reference and the oracle across worlds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_join_groupby_planner_vs_eager_vs_pandas(pair, world):
    rng = np.random.default_rng(9)
    raw_l, raw_r = _raw(rng), _raw_right(rng)
    lt, rt = _tables(raw_l, *pair(world)), _tables(raw_r, *pair(world))

    def build(a, b, c, l):
        return (a.plan().join(b, left_on="k", right_on="k2")
                .with_column("rev", c("v") * (l(1.0) - c("u")))
                .groupby(["k"], {"rev": ["sum"], "w": ["mean"],
                                 "u": ["min"]}))

    rq, q = _both(build, (lt[0], rt[0]), (lt[1], rt[1]))
    planned, eager = _planned_and_eager(q)
    a = _sorted_pd(planned, ["k"])
    pd.testing.assert_frame_equal(a, _sorted_pd(eager, ["k"]))
    _assert_like_reference(planned, rq.execute(), ["k"])
    j = pd.DataFrame(raw_l).merge(pd.DataFrame(raw_r), left_on="k",
                                  right_on="k2")
    j["rev"] = j.v * (1.0 - j.u)
    exp = j.groupby("k").agg(sum_rev=("rev", "sum"), mean_w=("w", "mean"),
                             min_u=("u", "min")).reset_index()
    assert len(a) == len(exp)
    np.testing.assert_allclose(a["sum_rev"], exp["sum_rev"], rtol=1e-4)
    np.testing.assert_allclose(a["mean_w"], exp["mean_w"], rtol=1e-4)
    np.testing.assert_allclose(a["min_u"], exp["min_u"], rtol=1e-6)


def test_fused_filter_in_chain_matches_eager(pair):
    rng = np.random.default_rng(10)
    raw_l, raw_r = _raw(rng), _raw_right(rng)
    lt, rt = _tables(raw_l, *pair(4)), _tables(raw_r, *pair(4))

    def build(a, b, c, l):
        return (a.plan().join(b, left_on="k", right_on="k2")
                .filter(c("u") < l(0.6))
                .with_column("rev", c("v") * c("u"))
                .groupby(["k"], {"rev": "sum"}))

    rq, q = _both(build, (lt[0], rt[0]), (lt[1], rt[1]))
    planned, eager = _planned_and_eager(q)
    pd.testing.assert_frame_equal(_sorted_pd(planned, ["k"]),
                                  _sorted_pd(eager, ["k"]))
    _assert_like_reference(planned, rq.execute(), ["k"])
    j = pd.DataFrame(raw_l).merge(pd.DataFrame(raw_r), left_on="k",
                                  right_on="k2")
    j = j[j.u < 0.6]
    exp = (j.v * j.u).groupby(j.k).sum().reset_index(drop=True)
    np.testing.assert_allclose(_sorted_pd(planned, ["k"])["sum_rev"], exp,
                               rtol=1e-4)


def test_sort_limit_pipeline(pair):
    rng = np.random.default_rng(11)
    raw_l, raw_r = _raw(rng), _raw_right(rng)
    lt, rt = _tables(raw_l, *pair(4)), _tables(raw_r, *pair(4))

    def build(a, b, c, l):
        return (a.plan().join(b, left_on="k", right_on="k2")
                .groupby(["k"], {"u": "sum"})
                .sort(["sum_u", "k"], ascending=[False, True]).limit(5))

    rq, q = _both(build, (lt[0], rt[0]), (lt[1], rt[1]))
    planned, eager = _planned_and_eager(q)
    pa = planned.to_pandas().reset_index(drop=True)
    pd.testing.assert_frame_equal(pa, eager.to_pandas().reset_index(
        drop=True))
    ra = rq.execute().to_pandas().reset_index(drop=True)
    np.testing.assert_array_equal(pa["k"], ra["k"])
    np.testing.assert_allclose(pa["sum_u"], ra["sum_u"], rtol=1e-5)
    j = pd.DataFrame(raw_l).merge(pd.DataFrame(raw_r), left_on="k",
                                  right_on="k2")
    exp = (j.groupby("k").u.sum().reset_index()
           .sort_values(["u", "k"], ascending=[False, True]).head(5))
    np.testing.assert_array_equal(pa["k"].to_numpy(), exp["k"].to_numpy())


# ---------------------------------------------------------------------------
# collective accounting: the 1-vs-3 headline, against the reference
# ---------------------------------------------------------------------------

_LAUNCH_KEYS = ("shuffle.exchanges", "shuffle.collective_launches",
                "shuffle.counts_gathers")


def _exchange_deltas(rq, q, keys=_LAUNCH_KEYS, **knobs):
    """{"planned"/"eager": (reference deltas, port deltas)} of ``keys``
    for one query under ``knobs``; plus the port's two tables."""
    out, tables = {}, {}
    for arm, plan_knob in (("planned", None), ("eager", "0")):
        with config.knob_env(CYLON_TPU_PLAN=plan_knob, **knobs):
            with _deltas(robs_metrics, keys) as rd:
                rq.execute()
            with _deltas(obs_metrics, keys) as pd_:
                tables[arm] = q.execute()
        out[arm] = (rd, pd_)
    return out, tables


def test_self_join_groupby_one_packed_exchange(pair):
    """The acceptance shape: join -> groupby on the same key runs ONE
    packed exchange with the planner on (scan sharing + elision) against
    three eager, as in the reference."""
    rt, pt = _tables(_raw(np.random.default_rng(12)), *pair(4))
    rq, q = _both(_self_join, (rt,), (pt,))
    d, tables = _exchange_deltas(rq, q, CYLON_TPU_SHUFFLE_PACK="1")
    assert d["planned"][1] == {"shuffle.exchanges": 1,
                               "shuffle.collective_launches": 1,
                               "shuffle.counts_gathers": 1}, d
    assert d["eager"][1]["shuffle.exchanges"] == 3, d
    assert d["eager"][1]["shuffle.collective_launches"] == 3, d
    for arm in d:
        assert d[arm][0] == d[arm][1], (arm, d[arm])
    pd.testing.assert_frame_equal(_sorted_pd(tables["planned"], ["l_k"]),
                                  _sorted_pd(tables["eager"], ["l_k"]))


def test_two_table_join_groupby_two_vs_three_exchanges(pair):
    rng = np.random.default_rng(13)
    lt = _tables(_raw(rng), *pair(4))
    rt = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (lt[0], rt[0]), (lt[1], rt[1]))
    d, _ = _exchange_deltas(rq, q, keys=("shuffle.exchanges",),
                            CYLON_TPU_SHUFFLE_PACK="1")
    assert d["planned"][1]["shuffle.exchanges"] == 2, d
    assert d["eager"][1]["shuffle.exchanges"] == 3, d
    assert d["planned"][0] == d["planned"][1]
    assert d["eager"][0] == d["eager"][1]


def test_pruning_shrinks_bytes_sent(pair):
    """A projected 3-of-12-column query moves under half the eager run's
    bytes through the packed exchange."""
    rng = np.random.default_rng(14)
    _, pt = _tables(_raw(rng, wide=True), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    q = (pt.plan().join(pr, left_on="k", right_on="k2")
         .groupby(["k"], {"v": "sum", "w": "sum"}))
    sent = {}
    for arm, plan_knob in (("planned", None), ("eager", "0")):
        with config.knob_env(CYLON_TPU_SHUFFLE_PACK="1",
                             CYLON_TPU_PLAN=plan_knob):
            with _deltas(obs_metrics, ("shuffle.bytes_sent",)) as d:
                q.execute()
        sent[arm] = d["shuffle.bytes_sent"]
    assert sent["planned"] * 2 < sent["eager"], sent


def test_shuffles_elided_counter(pair):
    rng = np.random.default_rng(15)
    lt = _tables(_raw(rng), *pair(4))
    rt = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (lt[0], rt[0]), (lt[1], rt[1]))
    with _deltas(obs_metrics, ("plan.shuffles_elided",)) as d:
        q.execute()
    with _deltas(robs_metrics, ("plan.shuffles_elided",)) as rd:
        rq.execute()
    assert d == rd == {"plan.shuffles_elided": 1}


# ---------------------------------------------------------------------------
# what waits for later items; the fingerprint
# ---------------------------------------------------------------------------


def test_plan_waits_name_their_item(pair, tmp_path):
    """Nothing of test_plan.py waits: the serve layer's plan op runs
    (``run_service`` returns the host frame and the journal-replay stats
    the service reads), and every case of test_plan.py has a
    counterpart here."""
    import ast
    import os

    from cylon_tpu_torch.plan import run_service

    rng = np.random.default_rng(16)
    rt, pt = _tables(_raw(rng), *pair(4))
    rr, pr = _tables(_raw_right(rng), *pair(4))
    q = _join_groupby(pt, pr, col, lit)
    rq = _join_groupby(rt, rr, rcol, rlit)
    assert WAITING == {}
    frame, stats = run_service(q)
    assert stats["parts_run"] == 1 and stats["cache_hit"] is False
    assert stats["rows"] == len(frame["k"])
    got = pd.DataFrame(frame).sort_values("k").reset_index(drop=True)
    want = _sorted_pd(rq.execute(), "k")
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-5,
                                  atol=1e-6)
    assert q.approx_input_bytes() > 0
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "test_plan.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    ported = {n for n in globals() if n.startswith("test_")}
    assert "test_serve_plan_op_and_cache_hit" in names & ported


def test_serve_plan_op_and_cache_hit(pair, tmp_path):
    """A planned Q submitted to both services: the first run executes on
    the plan inputs' own 4-shard mesh (the service's context is the CPU
    device), the repeat is a result-cache hit, and the frames agree with
    each other and with the reference's."""
    from cylon_tpu.serve import QueryService as RQueryService
    from cylon_tpu_torch.serve import QueryService

    rng = np.random.default_rng(18)
    rt, pt = _tables(_raw(rng), *pair(4))
    rr, pr = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (rt, rr), (pt, pr))
    assert q.approx_input_bytes() > 0
    with rconfig.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "ref")):
        with RQueryService() as rsvc:
            want = rsvc.submit("tenant-a", "plan", rq).result(
                timeout=300)[0]
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        with QueryService(ctx=CylonContext.Init("cpu")) as svc:
            tk = svc.submit("tenant-a", "plan", q)
            frame, stats = tk.result(timeout=300)
            assert stats["parts_run"] == 1 and not stats["cache_hit"]
            tk2 = svc.submit("tenant-a", "plan", q)
            frame2, stats2 = tk2.result(timeout=300)
            assert tk2.cache_hit, stats2
            st = svc.stats()
    assert st["completed"] == 2 and st["cache_hits"] == 1, st
    a = pd.DataFrame(frame).sort_values("k").reset_index(drop=True)
    b = pd.DataFrame(frame2).sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(a, b)
    w = pd.DataFrame(want).sort_values("k").reset_index(drop=True)
    pd.testing.assert_frame_equal(a, w, check_exact=False, rtol=1e-5,
                                  atol=1e-6)


def test_journal_replay_zero_compiles(pair, tmp_path):
    """A repeated plan fingerprint under a durable dir is served from the
    journal in both packages: ``plan.cache_hit`` 1, zero exchanges (no
    device pass; the reference also compiles nothing), and the same
    rows as the first call, which equal the reference's."""
    rng = np.random.default_rng(16)
    rt, pt = _tables(_raw(rng), *pair(4))
    rr, pr = _tables(_raw_right(rng), *pair(4))
    rq, q = _both(_join_groupby, (rt, rr), (pt, pr))
    keys = ("plan.cache_hit", "shuffle.exchanges")
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "port")):
        first = q.execute()
        with _deltas(obs_metrics, keys) as d:
            stats = {}
            second = plan_executor.execute(q, stats_out=stats)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path / "ref")):
        rfirst = rq.execute()
        with _deltas(robs_metrics, keys + ("plan_cache.miss",
                                           "plan_cache.hit")) as rd:
            rsecond = rq.execute()
    assert d == {"plan.cache_hit": 1, "shuffle.exchanges": 0}, d
    assert rd == {"plan.cache_hit": 1, "shuffle.exchanges": 0,
                  "plan_cache.miss": 0, "plan_cache.hit": 0}, rd
    assert stats["cache_hit"] and stats["passes_skipped"] == 1
    assert second.num_shards == 1
    assert second.shards[0][0].data.device.type == "cpu"
    pd.testing.assert_frame_equal(_sorted_pd(first, ["k"]),
                                  _sorted_pd(second, ["k"]))
    _assert_like_reference(second, rsecond, ["k"])
    _assert_like_reference(first, rfirst, ["k"])


def test_plan_evicted_journal_falls_through_to_execution(pair, tmp_path):
    """``cache_evict_race`` (the run's spills deleted, its manifest kept)
    between two calls: the second call misses and executes, never serves
    a torn journal, and its rows equal the first call's."""
    from cylon_tpu_torch import resilience

    rng = np.random.default_rng(21)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    q = _join_groupby(pt, pr, col, lit)
    with config.knob_env(CYLON_TPU_DURABLE_DIR=str(tmp_path)):
        first = q.execute()
        with resilience.fault_plan("evict@1=cache_evict_race"):
            resilience.fault_point("evict")
        with _deltas(obs_metrics, ("plan.cache_hit",
                                   "shuffle.exchanges")) as d:
            second = q.execute()
        third = q.execute()
    assert d["plan.cache_hit"] == 0 and d["shuffle.exchanges"] > 0, d
    assert third.num_shards == 1  # the re-executed run re-journaled
    for t in (second, third):
        pd.testing.assert_frame_equal(_sorted_pd(first, ["k"]),
                                      _sorted_pd(t, ["k"]))


def test_fingerprint_tracks_content_and_knobs(pair):
    rng = np.random.default_rng(17)
    raw = _raw(rng)
    _, pt = _tables(raw, *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    q = _join_groupby(pt, pr, col, lit)
    fp1 = q.fingerprint()
    assert fp1 == q.fingerprint()
    raw2 = dict(raw, v=raw["v"] + 1.0)   # v is pruned: the key holds
    _, t2 = _tables(raw2, *pair(4))
    assert _join_groupby(t2, pr, col, lit).fingerprint() == fp1
    raw3 = dict(raw, k=(raw["k"] + 1).astype(np.int32))  # a kept column
    _, t3 = _tables(raw3, *pair(4))
    assert _join_groupby(t3, pr, col, lit).fingerprint() != fp1
    # the knobs that change results ride the fingerprint
    with config.knob_env(CYLON_TPU_ACCUM="wide"):
        assert q.fingerprint() != fp1
    with config.knob_env(CYLON_TPU_FP_SALT="x"):
        assert q.fingerprint() != fp1


# ---------------------------------------------------------------------------
# misc semantics
# ---------------------------------------------------------------------------


def test_string_filter_and_group_key(pair):
    rng = np.random.default_rng(19)
    n = 160
    raw = {"k": rng.integers(0, 12, n).astype(np.int32),
           "tag": np.array(["A", "N", "R"], object)[rng.integers(0, 3, n)],
           "v": rng.random(n).astype(np.float32)}
    rt, pt = _tables(raw, *pair(4))
    rq, q = _both(lambda t, c, l: t.plan().filter(c("tag") == "R")
                  .groupby(["k"], {"v": "sum"}), (rt,), (pt,))
    planned, eager = _planned_and_eager(q)
    pd.testing.assert_frame_equal(_sorted_pd(planned, ["k"]),
                                  _sorted_pd(eager, ["k"]))
    _assert_like_reference(planned, rq.execute(), ["k"])
    j = pd.DataFrame(raw)
    exp = j[j.tag == "R"].groupby("k").v.sum().reset_index()
    np.testing.assert_allclose(_sorted_pd(planned, ["k"])["sum_v"],
                               exp["v"], rtol=1e-4)


def test_dead_derive_is_pruned(pair):
    _, pt = _tables(_raw(np.random.default_rng(20)), *pair(4))
    q = pt.plan().with_column("dead", col("v") * 2.0).project(["k", "w"])
    phys = optimizer.optimize(q, enabled=True)
    assert phys.root.children[0].ann.get("dead") is True
    assert q.execute().column_names == ["k", "w"]


def test_plan_result_partitioning_stamp(pair):
    rng = np.random.default_rng(21)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    out = _join_groupby(pt, pr, col, lit).execute()
    part = getattr(out, "_partitioning", None)
    assert part is not None and part[0] == "hash" and part[2] == 4
    q2 = out.plan().groupby(["k"], {"sum_u": "max"})
    assert optimizer.optimize(q2, enabled=True).root.ann["mode"] == "elided"


def test_eager_stamps_describe_placement(pair):
    """The stamps the planner elides on describe placement exactly: a
    stamped table is where a fresh shuffle on its keys would put it, so
    re-shuffling moves no row (shard for shard the same)."""
    from cylon_tpu_torch import interop
    from cylon_tpu_torch.parallel import ops as par_ops

    rng = np.random.default_rng(22)
    _, pt = _tables(_raw(rng), *pair(4))
    _, pr = _tables(_raw_right(rng), *pair(4))
    j = pt.distributed_join(pr, left_on="k", right_on="k2")
    assert j._partitioning == ("hash", (("k",), ("k2",)), 4)
    g = pt.groupby("k", {"v": "sum"})
    assert g._partitioning == ("hash", (("k",),), 4)
    outer = pt.distributed_join(pr, left_on="k", right_on="k2",
                                how="outer")
    assert getattr(outer, "_partitioning", None) is None
    assert getattr(j.project(["k"]), "_partitioning", None) is None
    for t, keys in ((j, (0,)), (j, (3,)), (g, (0,))):
        _, shards, counts = interop.table_shards_to_arrays(t)
        _, again, counts2 = interop.table_shards_to_arrays(
            par_ops.shuffle(t, keys))
        np.testing.assert_array_equal(counts, counts2)
        for cols, cols2, n in zip(shards, again, counts):
            for c, c2 in zip(cols, cols2):
                np.testing.assert_array_equal(c[0][:n], c2[0][:n])


# ---------------------------------------------------------------------------
# adaptive planning (broadcast-hash joins + skew salting)
# ---------------------------------------------------------------------------


def _raw_fact(rng, n=960, nkeys=64, zipf=False):
    if zipf:
        k = (np.minimum(rng.zipf(1.3, n), nkeys) - 1).astype(np.int32)
    else:
        k = rng.integers(0, nkeys, n).astype(np.int32)
    return {"k": k, "v": rng.random(n).astype(np.float64),
            "u": rng.integers(0, 97, n).astype(np.int64)}


def _raw_dim(n=64):
    return {"k": np.arange(n, dtype=np.int32),
            "w": (np.arange(n) % 7).astype(np.int64)}


def test_adaptive_off_is_the_rule_only_planner(pair):
    _, t = _tables(_raw_fact(np.random.default_rng(31)), *pair(4))
    _, d = _tables(_raw_dim(), *pair(4))
    q = t.plan().join(d, on="k", how="inner")
    for mode in (None, "0", "auto"):
        with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE=mode):
            phys = optimizer.optimize(q, enabled=True)
            assert not phys.adaptive
            assert phys.broadcast_joins == 0 and phys.keys_salted == 0
            assert optimizer.strategy_spec(phys) == ()
            assert q.fingerprint() == q.base_fingerprint()
            assert "adaptive" not in q.explain()


@pytest.mark.parametrize("world", WORLDS)
def test_adaptive_bit_identity_across_worlds(pair, world):
    rng = np.random.default_rng(32)
    raw_f, raw_d = _raw_fact(rng), _raw_dim()
    ft, dt = _tables(raw_f, *pair(world)), _tables(raw_d, *pair(world))

    def build(f, d, c, l):
        return (f.plan().join(d, on="k", how="inner")
                .groupby(["l_k"], {"v": ["sum"], "w": ["max"]}))

    rq, q = _both(build, (ft[0], dt[0]), (ft[1], dt[1]))
    with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="1"):
        adaptive = q.execute()
        assert q.explain() == rq.explain()
    with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="0"):
        plain = q.execute()
    with config.knob_env(CYLON_TPU_PLAN="0"):
        eager = q.execute()
    a = _sorted_pd(adaptive, ["l_k"])
    pd.testing.assert_frame_equal(a, _sorted_pd(plain, ["l_k"]))
    pd.testing.assert_frame_equal(a, _sorted_pd(eager, ["l_k"]))
    with rconfig.knob_env(CYLON_TPU_PLAN_ADAPTIVE="1"):
        _assert_like_reference(adaptive, rq.execute(), ["l_k"])
    j = pd.DataFrame(raw_f).merge(pd.DataFrame(raw_d), on="k")
    exp = j.groupby("k").agg(sum_v=("v", "sum"),
                             max_w=("w", "max")).reset_index()
    np.testing.assert_allclose(a["sum_v"], exp["sum_v"], rtol=1e-6)
    np.testing.assert_array_equal(a["max_w"], exp["max_w"])


@contextlib.contextmanager
def _counting_collectives():
    """Count the calls of ``collectives.all_to_all`` / ``allgather``."""
    counts = {"all_to_all": 0, "allgather": 0}
    originals = {name: getattr(collectives, name) for name in counts}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return counted

    try:
        for name in counts:
            setattr(collectives, name, wrap(name))
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(collectives, name, fn)


def test_broadcast_join_one_gather_pin(pair):
    """The broadcast arm moves the dimension with exactly one packed
    all-gather and no all-to-all (the reference's budget pin, counted
    here by wrapping the port's collectives)."""
    _, t = _tables(_raw_fact(np.random.default_rng(33)), *pair(4))
    _, d = _tables(_raw_dim(), *pair(4))
    q = t.plan().join(d, on="k", how="inner")
    with config.knob_env(CYLON_TPU_PLAN_ADAPTIVE="1",
                         CYLON_TPU_SHUFFLE_PACK="1"):
        assert "BROADCAST(k)" in q.explain()
        with _deltas(obs_metrics, ("plan.broadcast_joins",)) as dd:
            with _counting_collectives() as launches:
                out = q.execute()
    assert dd == {"plan.broadcast_joins": 1}
    assert launches == {"all_to_all": 0, "allgather": 1}, launches
    with config.knob_env(CYLON_TPU_PLAN="0"):
        eager = q.execute()
    pd.testing.assert_frame_equal(_sorted_pd(out, ["l_k", "v"]),
                                  _sorted_pd(eager, ["l_k", "v"]))


def _nunique_query(t, d, c, l):
    return (t.plan().join(d, on="k", how="inner")
            .groupby(["l_k"], {"u": ["nunique"]}))


def test_salted_groupby_bit_identity_with_catalog(pair, tmp_path):
    rng = np.random.default_rng(34)
    ft = _tables(_raw_fact(rng, zipf=True), *pair(4))
    dt = _tables(_raw_dim(), *pair(4))
    rq, q = _both(_nunique_query, (ft[0], dt[0]), (ft[1], dt[1]))
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path),
                         CYLON_TPU_PLAN_ADAPTIVE="0",
                         CYLON_TPU_PROFILE="1"):
        plain = q.execute()
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path),
                         CYLON_TPU_PLAN_ADAPTIVE="1",
                         CYLON_TPU_PLAN_BROADCAST_BYTES="0",
                         CYLON_TPU_PLAN_SKEW_SALT="1.2"):
        txt = q.explain()
        assert "salted x4" in txt and "catalog" in txt
        with _deltas(obs_metrics, ("plan.keys_salted",)) as dd:
            salted = q.execute()
    assert dd == {"plan.keys_salted": 1}
    pd.testing.assert_frame_equal(_sorted_pd(salted, ["l_k"]),
                                  _sorted_pd(plain, ["l_k"]))
    _assert_like_reference(salted, rq.execute(), ["l_k"])


def test_adaptive_salt_needs_catalog_evidence(pair, tmp_path):
    rng = np.random.default_rng(35)
    _, t = _tables(_raw_fact(rng, zipf=True), *pair(4))
    _, d = _tables(_raw_dim(), *pair(4))
    q = _nunique_query(t, d, col, lit)
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path),
                         CYLON_TPU_PLAN_ADAPTIVE="1",
                         CYLON_TPU_PLAN_BROADCAST_BYTES="0",
                         CYLON_TPU_PLAN_SKEW_SALT="1.2"):
        txt = q.explain()
    assert "salted x" not in txt and "keys_salted=0" in txt


def test_catalog_strategy_folds_into_fingerprint(pair, tmp_path):
    from cylon_tpu_torch.obs import stats_catalog

    _, t = _tables(_raw_fact(np.random.default_rng(36)), *pair(4))
    _, d = _tables(_raw_dim(), *pair(4))
    q = t.plan().join(d, on="k", how="inner")
    with config.knob_env(CYLON_TPU_STATS_DIR=str(tmp_path),
                         CYLON_TPU_PLAN_ADAPTIVE="1"):
        base = q.base_fingerprint()
        fp_meta = q.fingerprint()
        assert fp_meta != base
        stats_catalog.record(base, {"nodes": {"1": {"rows": 960},
                                              "2": {"rows": 64}}})
        assert q.base_fingerprint() == base
        assert q.fingerprint() == fp_meta
        stats_catalog.record(base, {"nodes": {"1": {"rows": 10 ** 9},
                                              "2": {"rows": 10 ** 9}}})
        assert q.base_fingerprint() == base
        assert q.fingerprint() == base
