"""The port's out-of-core engine over a mesh (``exec._chunked_distributed``,
reached through ``chunked_join``, ``chunked_join_groupby_tables`` and
``chunked_distributed_join_groupby`` with a ``ctx`` of several shards) and
its collective retries, against the JAX package on the same numpy inputs,
on the CPU, mirroring ``tests/test_exec_chunked.py::
test_chunked_distributed_matches_pandas``,
``tests/test_exec_tables.py::test_chunked_distributed_general`` and the
retry cases of ``tests/test_resilience.py``.

Meshes of 4 shards on the CPU.  The reference runs on a fresh
murmur3-patched context (``torch_parity.murmur3_reference``), so both
packages place every row on the same shard, every pass's frame is
gathered in the same shard order, and results compare row for row.  Wide
mode against the reference's default, narrow under
``torch_parity.modes("narrow")``.  Tolerances: keys, counts and stats
exact; float32 sums and means rtol=1e-5, float64 rtol=1e-12
(``torch_parity.assert_frames_equal``).
"""
import contextlib

import numpy as np
import pandas as pd
import pytest

from cylon_tpu import config as rconfig
from cylon_tpu import exec as rexec
from cylon_tpu import resilience as rresilience
from cylon_tpu.context import CylonContext as RContext
from cylon_tpu_torch import CylonContext, MeshConfig, Table
from cylon_tpu_torch import config as pconfig
from cylon_tpu_torch import exec as pexec
from cylon_tpu_torch import resilience as presilience
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.parallel import ops as par_ops
from cylon_tpu_torch.resilience import RetryPolicy, retry_call
from cylon_tpu_torch.status import Code, CylonError

from .torch_parity import assert_frames_equal, modes, murmur3_reference

STATS = ("passes", "mode", "world", "shard_cap", "retries", "shuffle_pack",
         "groups", "rows")


def _mesh(world=4):
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"],
                                                   world_size=world))


def _data(rng, n):
    return (rng.integers(0, n, n).astype(np.int32),
            rng.random(n).astype(np.float32),
            rng.integers(0, n, n).astype(np.int32),
            rng.random(n).astype(np.float32))


def _both(fn, *args, precision="wide", world=4, spec=None, **kw):
    """``fn`` of both packages on a ``world``-shard mesh, the reference on
    murmur3 placement, optionally both under the fault plan ``spec``."""
    with modes(precision):
        with murmur3_reference(world) as rctx:
            with (rresilience.fault_plan(spec) if spec
                  else contextlib.nullcontext()):
                want, wstats = getattr(rexec, fn)(*args, ctx=rctx, **kw)
        with (presilience.fault_plan(spec) if spec
              else contextlib.nullcontext()):
            got, gstats = getattr(pexec, fn)(*args, ctx=_mesh(world), **kw)
    assert_frames_equal(got, want)
    for k in STATS:
        assert gstats.get(k) == wstats.get(k), (k, gstats, wstats)
    return got, gstats


# -- the engine over a mesh ---------------------------------------------------

@pytest.mark.parametrize("precision", ["wide", "narrow"])
@pytest.mark.parametrize("passes", [1, 5])
def test_chunked_distributed_matches_reference(rng, precision, passes):
    """The benchmark's shape, every pass sharded over the mesh, against
    the reference and against pandas."""
    n = 4000
    lk, lv, rk, rv = data = _data(rng, n)
    out, stats = _both("chunked_distributed_join_groupby", *data, passes,
                       precision=precision)
    assert stats["world"] == 4 and stats["passes"] == passes
    g = (pd.DataFrame({"k": lk, "a": lv})
         .merge(pd.DataFrame({"k": rk, "b": rv}), on="k")
         .groupby("k", as_index=False)
         .agg(sum_a=("a", "sum"), mean_b=("b", "mean")))
    order = np.argsort(out["l_k"], kind="stable")
    np.testing.assert_array_equal(out["l_k"][order], g["k"].to_numpy())
    np.testing.assert_allclose(out["sum_a"][order], g["sum_a"], rtol=1e-4)
    np.testing.assert_allclose(out["mean_b"][order], g["mean_b"], rtol=1e-4)
    assert stats["groups"] == len(g)


def _mk_orders(rng, n, ncust=50):
    return pd.DataFrame({"cust": rng.integers(0, ncust, n).astype(np.int64),
                         "amount": rng.random(n).astype(np.float64).round(3),
                         "qty": rng.integers(1, 9, n).astype(np.int64)})


def _mk_custs(rng, ncust=50):
    return pd.DataFrame({"cust": np.arange(ncust, dtype=np.int64),
                         "nation": rng.integers(0, 5, ncust).astype(np.int64)})


@pytest.mark.parametrize("precision", ["wide", "narrow"])
def test_chunked_distributed_general(rng, precision):
    """A group key that is not the join key: every pass emits partial
    states over the mesh and one distributed group-by combines them."""
    left, right = _mk_orders(rng, 3000), _mk_custs(rng)
    got, stats = _both("chunked_join_groupby_tables", left, right, on="cust",
                       how="inner", group_by="nation",
                       agg={"amount": ["sum", "count", "mean"],
                            "qty": ["max"]},
                       passes=3, precision=precision)
    ref = (left.merge(right, on="cust").groupby("nation", as_index=False)
           .agg(sum_amount=("amount", "sum")))
    assert stats["groups"] == len(ref)
    order = np.argsort(got["nation"], kind="stable")
    np.testing.assert_allclose(np.asarray(got["sum_amount"][order],
                                          np.float64),
                               ref.sort_values("nation")["sum_amount"],
                               rtol=1e-9 if precision == "wide" else 1e-5)


@pytest.mark.parametrize("algo", ["sort", "hash"])
@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_chunked_join_on_a_mesh(rng, how, algo):
    left = {"k": rng.integers(0, 400, 2000).astype(np.int32),
            "a": rng.integers(0, 1 << 20, 2000).astype(np.int64)}
    right = {"k": rng.integers(0, 400, 1500).astype(np.int32),
             "a": rng.random(1500)}
    got, stats = _both("chunked_join", left, right, on="k", how=how,
                       algo=algo, passes=4)
    assert list(got) == ["l_k", "l_a", "r_k", "r_a"]
    assert stats["rows"] > 0 and stats["shuffle_pack"] is False
    # custom prefixes name the mesh passes' columns too (the reference's
    # mesh passes keep l_/r_ whatever it is given: "Known differences")
    named, _ = pexec.chunked_join(left, right, on="k", how=how, algo=algo,
                                  passes=4, ctx=_mesh(4), left_prefix="L.",
                                  right_prefix="R.")
    assert list(named) == ["L.k", "L.a", "R.k", "R.a"]
    assert_frames_equal(dict(zip(got, named.values())), got)


def test_engine_takes_a_mesh_context():
    """A mesh ctx no longer raises: the engine shards every pass over it
    (ctx=None still means the card, and a one-shard ctx its device)."""
    x = np.arange(64, dtype=np.int32)
    res, stats = pexec.chunked_join_groupby(x, x.astype(np.float32), x,
                                            x.astype(np.float32), 2,
                                            ctx=_mesh(4))
    assert stats["world"] == 4 and stats["groups"] == 64
    np.testing.assert_array_equal(np.sort(res["key"]), x)


def test_mesh_pass_ids_bit_for_bit(rng):
    """The mesh passes are the one-shard plan's: same ids, same count."""
    lk, _, rk, _ = _data(rng, 3000)
    with murmur3_reference(4) as rctx:
        _, wstats = rexec.chunked_distributed_join_groupby(
            lk, lk.astype(np.float32), rk, rk.astype(np.float32), 6, rctx)
    _, gstats = pexec.chunked_distributed_join_groupby(
        lk, lk.astype(np.float32), rk, rk.astype(np.float32), 6, _mesh(4))
    got = pexec._plan_pass_ids([lk], [rk], 6, "auto")
    want = rexec._plan_pass_ids([lk], [rk], 6, "auto")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert gstats["passes"] == wstats["passes"] == got[2]
    assert gstats["shard_cap"] == wstats["shard_cap"]


# -- retry_call and the collective retry policy -------------------------------

def test_retry_call_heals_transient():
    for pkg_retry, pkg_policy in ((retry_call, RetryPolicy),
                                  (rresilience.retry_call,
                                   rresilience.RetryPolicy)):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("DEADLINE_EXCEEDED: operation timed out")
            return "ok"

        out, attempts = pkg_retry(flaky, policy=pkg_policy(
            max_retries=2, sleep=lambda s: None))
        assert out == "ok" and attempts == 3


def test_retry_call_exhaustion_raises_classified():
    obs_metrics.reset()
    seen = []
    with pytest.raises(CylonError) as ei:
        retry_call(lambda: (_ for _ in ()).throw(
            RuntimeError("UNAVAILABLE: connection reset by peer")),
            policy=RetryPolicy(max_retries=1, sleep=lambda s: None),
            site="probe", on_retry=lambda a, st: seen.append((a, st.code)))
    assert ei.value.code == Code.ExecutionError
    assert "probe" in ei.value.msg and "2 attempts" in ei.value.msg
    assert seen == [(1, Code.ExecutionError)]
    assert obs_metrics.snapshot()["counters"]["retry.attempts"] == 1
    obs_metrics.reset()


def test_retry_call_never_retries_bugs_or_oom():
    policy = RetryPolicy(max_retries=5, sleep=lambda s: None)
    calls = {"n": 0}

    def bug():
        calls["n"] += 1
        raise TypeError("a bug must stay a bug")

    with pytest.raises(TypeError):
        retry_call(bug, policy=policy)
    assert calls["n"] == 1

    def oom():
        calls["n"] += 1
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        retry_call(oom, policy=policy)
    assert calls["n"] == 2
    assert presilience.RETRYABLE_CODES == rresilience.RETRYABLE_CODES


def test_collective_retry_policy_single_process():
    """One process drives every shard: collectives retry under the
    context's policy, as the reference's single-process contexts do."""
    rlocal = RContext.Init()
    for ctx in (CylonContext.Init("cpu"), _mesh(4)):
        assert not ctx.multi_process()
        pol = ctx.collective_retry_policy()
        assert pol.max_retries == ctx.retry_policy().max_retries \
            == rlocal.collective_retry_policy().max_retries
        with pconfig.knob_env(CYLON_TPU_RETRY_MAX="5"):
            assert ctx.collective_retry_policy().max_retries == 5
        pinned = RetryPolicy(max_retries=7)
        ctx.set_retry_policy(pinned)
        assert ctx.collective_retry_policy() is pinned


def test_collective_retry_policy_never_retries_across_processes(monkeypatch):
    """The no-retry branch, reached once a context spans processes."""
    ctx = _mesh(2)
    monkeypatch.setattr(ctx, "multi_process", lambda: True)
    assert ctx.collective_retry_policy().max_retries == 0


def _tables(rng, ctx, n=1000):
    lk = rng.integers(0, 100, n).astype(np.int32)
    la = rng.integers(0, 1 << 20, n).astype(np.int64)
    rk = rng.integers(0, 100, n).astype(np.int32)
    rb = rng.integers(0, 1 << 20, n).astype(np.int64)
    return (Table.from_numpy(["k", "a"], [lk, la], ctx=ctx),
            Table.from_numpy(["k", "b"], [rk, rb], ctx=ctx))


@pytest.mark.parametrize("kind", ["comm", "timeout"])
def test_shuffle_transient_fault_retried(rng, kind):
    lt, rt = _tables(rng, _mesh(2))
    base = lt.distributed_join(rt, on="k", how="inner")
    with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0"):
        with presilience.fault_plan(f"shuffle@1={kind}") as plan:
            res = lt.distributed_join(rt, on="k", how="inner")
    assert plan.hits["shuffle"] == 3  # the first failed and retried
    assert plan.fired == [("shuffle", kind, 1)]
    assert_frames_equal(res.to_numpy(), base.to_numpy())


def test_shuffle_persistent_fault_exhausts_retries(rng):
    lt, _ = _tables(rng, _mesh(2))
    with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0", CYLON_TPU_RETRY_MAX="1"):
        with presilience.fault_plan("shuffle@1+=comm") as plan:
            with pytest.raises(CylonError) as ei:
                lt.shuffle("k")
    assert ei.value.code == Code.ExecutionError
    assert "shuffle: retries exhausted after 2 attempts" in ei.value.msg
    assert plan.hits["shuffle"] == 2


def test_broadcast_transient_fault_retried(rng):
    lt, _ = _tables(rng, _mesh(4), n=300)
    base = par_ops.broadcast_gather(lt)
    with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0"):
        with presilience.fault_plan("broadcast@1=comm") as plan:
            res = par_ops.broadcast_gather(lt)
    assert plan.hits["broadcast"] == 2
    for s in range(4):
        for a, b in zip(res.shards[s], base.shards[s]):
            assert a.data.equal(b.data) and a.validity.equal(b.validity)
    assert res.row_counts.tolist() == [300] * 4


def test_broadcast_bug_is_not_retried(rng):
    lt, _ = _tables(rng, _mesh(2), n=50)
    with presilience.fault_plan("broadcast@1=unknown") as plan:
        with pytest.raises(presilience.InjectedFault):
            par_ops.broadcast_gather(lt)
    assert plan.hits["broadcast"] == 1


@pytest.mark.parametrize("spec", ["pass_dispatch@2=comm",
                                  "pass_dispatch@1=timeout"])
def test_faulted_mesh_pass_retries_and_matches(rng, spec):
    """A transient failure of one mesh pass retries that pass only: the
    result equals the unfaulted run's, and the reference's faulted run,
    with ``stats["retries"]`` 1."""
    data = _data(rng, 3000)
    base, _ = pexec.chunked_distributed_join_groupby(*data, 4, _mesh(4))
    with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0"), \
            rconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0"):
        got, gstats = _both("chunked_distributed_join_groupby", *data, 4,
                            spec=spec)
    assert gstats["retries"] == 1
    assert_frames_equal(got, base)


def test_faulted_mesh_pass_exhausts_to_a_classified_error(rng):
    data = _data(rng, 500)
    with pconfig.knob_env(CYLON_TPU_RETRY_BASE_S="0", CYLON_TPU_RETRY_MAX="1"):
        with presilience.fault_plan("pass_dispatch@2+=comm"):
            with pytest.raises(CylonError) as ei:
                pexec.chunked_distributed_join_groupby(*data, 3, _mesh(4))
    assert ei.value.code == Code.ExecutionError
    assert "distributed pass 1/3" in ei.value.msg
