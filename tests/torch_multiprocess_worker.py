"""Worker of the port's multi-process tests (not a pytest module).

One process of a gloo gang over the CPU: ``num_processes`` processes, each
holding ``local`` shards of a ``CylonContext`` over a ``torch.distributed``
process group, the port's counterpart of ``tests/multihost_worker.py``.
It runs every case of ``run_cases`` under the three exchange realizations
and the out-of-core engines and ``DataFrame`` cases of ``run_engine``,
and pickles its local shards under their global ids, with the results of
the multihost checks (pandas oracles), to ``<out_dir>/r<process_id>.pkl``.
``tests/test_torch_multiprocess.py`` holds them against a one-process mesh
of the same world.  Imports no jax and nothing of ``cylon_tpu``.

Usage: python torch_multiprocess_worker.py <process_id> <num_processes>
       <port> <local shards> <out_dir>
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: exit code for a lost rendezvous-port race (EX_TEMPFAIL): the parent
#: retries the gang on a fresh port (``tests/test_multihost.py``)
BIND_RACE_RC = 75

#: (label, CYLON_TPU_SHUFFLE_PACK, CYLON_TPU_SHUFFLE_COMPRESS)
ARMS = (("per_buffer", "0", "0"), ("packed", "1", "0"),
        ("compressed", "1", "1"))

ROWS_L, ROWS_R = 400, 300

#: the cases ``run_cases`` returns, in order
CASES = ("join_sort", "join_hash", "join_left", "groupby_hash",
         "groupby_pipeline", "nunique", "scalars", "sort", "unique",
         "intersect", "shuffle", "string_join", "string_groupby",
         "broadcast", "task", "tiny_join", "tiny_groupby", "empty_join",
         "skew_groupby", "skew_shuffle")


def inputs() -> dict:
    """The global data every process (and the one-process run) builds."""
    rng = np.random.default_rng(7)
    names = np.array([f"name{i % 23:03d}" for i in range(ROWS_L)], object)
    return {
        "l": {"k": rng.integers(0, 60, ROWS_L).astype(np.int64),
              "x": rng.random(ROWS_L),
              "y": rng.integers(0, 9, ROWS_L).astype(np.int32)},
        "r": {"k": rng.integers(0, 60, ROWS_R).astype(np.int64),
              "z": rng.random(ROWS_R).astype(np.float32)},
        "s": {"name": names, "v": rng.integers(0, 100, ROWS_L)},
        "tiny": {"k": np.array([5, 1, 5], np.int64),
                 "x": np.array([0.5, 1.5, 2.5])},
        "skew": {"k": np.full(50, 3, np.int64),
                 "x": np.arange(50, dtype=np.float64)},
    }


def run_cases(ctx, package: str = "cylon_tpu_torch") -> dict:
    """Every case's output on ``ctx``: a Table, or host scalars.  The
    tests also run it on the JAX package (``package="cylon_tpu"``), whose
    surface is the same; this worker never does."""
    import importlib

    api = importlib.import_module(package)
    par_ops = importlib.import_module(f"{package}.parallel.ops")
    task = importlib.import_module(f"{package}.parallel.task")
    JoinAlgorithm, JoinConfig, Table = (api.JoinAlgorithm, api.JoinConfig,
                                        api.Table)
    LogicalTaskPlan, task_shuffle = task.LogicalTaskPlan, task.task_shuffle

    d = inputs()

    def table(name):
        return Table.from_pydict(d[name], ctx=ctx)

    l, r, s = table("l"), table("r"), table("s")
    tiny, skew = table("tiny"), table("skew")
    empty = Table.from_pydict({"k": np.zeros(0, np.int64),
                               "z": np.zeros(0, np.float32)}, ctx=ctx)
    out = {
        "join_sort": l.distributed_join(r, on="k"),
        "join_hash": l.distributed_join(
            r, JoinConfig.InnerJoin("k", "k", JoinAlgorithm.HASH)),
        "join_left": l.distributed_join(r, on="k", how="left"),
        "groupby_hash": l.groupby("k", {"x": ["sum", "mean"]}),
        "groupby_pipeline": l.distributed_sort("k").groupby(
            "k", {"x": ["sum", "mean"]}, groupby_type="pipeline"),
        "nunique": l.groupby("k", {"y": "nunique"}),
        "scalars": {f"{op}_{c}": getattr(l, op)(c).item()
                    for op in ("sum", "min", "max", "count")
                    for c in ("x", "y")},
        "sort": l.distributed_sort("x"),
        "unique": l.distributed_unique(["k"]),
        "intersect": l.project(["k"]).distributed_intersect(
            r.project(["k"])),
        "shuffle": l.shuffle("k"),
        "string_join": s.distributed_join(
            s.project(["name"]).distributed_unique(["name"]), on="name"),
        "string_groupby": s.groupby("name", {"v": "sum"}),
        "broadcast": par_ops.broadcast_gather(r),
        "task": task_shuffle(
            [l.project(["k", "x"]), skew], [0, 1],
            LogicalTaskPlan({0: 1, 1: ctx.GetWorldSize() - 1},
                            ctx.GetWorldSize())),
        "tiny_join": tiny.distributed_join(tiny, on="k"),
        "tiny_groupby": tiny.groupby("k", {"x": "sum"}),
        "empty_join": r.distributed_join(empty, on="k"),
        "skew_groupby": skew.groupby("k", {"x": ["sum", "mean"]}),
        "skew_shuffle": skew.shuffle("k"),
    }
    assert tuple(out) == CASES
    return out


#: the cases ``run_engine`` returns, in order
ENGINE_CASES = ("ooc_join_groupby", "ooc_groupby", "ooc_unique", "ooc_sort",
                "ooc_repartition", "ooc_repartition_counts",
                "df_merge_groupby", "df_sort", "df_loc", "df_iloc")

#: rows per side of the out-of-core join's ``pipeline.make_data`` tables
ENGINE_ROWS = 3000


def _stats_of(stats: dict) -> dict:
    """An engine's stats without its timings (those differ per process)."""
    return {k: np.asarray(v) for k, v in stats.items()
            if not k.endswith("_seconds")}


def _frame_case(frame: dict, stats: dict) -> dict:
    """An engine's host frame and counts as one record of host arrays."""
    out = {f"col:{k}": np.asarray(v) for k, v in frame.items()}
    out.update({f"stat:{k}": v for k, v in _stats_of(stats).items()})
    return out


def run_engine(ctx) -> dict:
    """The out-of-core engines' mesh passes and ``DataFrame`` on ``ctx``:
    host records (equal on every process) or, for the repartition's
    targets and the frame's merge, local shards as ``shards_of``."""
    from cylon_tpu_torch import DataFrame, exec as exec_mod, pipeline

    d = inputs()
    out = {}
    res, st = pipeline.out_of_core_distributed_join_groupby(
        pipeline.make_data(ENGINE_ROWS), 3, ctx)
    out["ooc_join_groupby"] = _frame_case(res, st)
    res, st = exec_mod.chunked_groupby(d["l"], "k", {"x": ["sum", "mean"],
                                                     "y": ["max"]},
                                       passes=3, ctx=ctx)
    out["ooc_groupby"] = _frame_case(res, st)
    res, st = exec_mod.chunked_unique(d["l"], ["k", "y"], passes=3, ctx=ctx)
    out["ooc_unique"] = _frame_case(res, st)
    res, st = exec_mod.chunked_sort(d["l"], ["y", "x"], ascending=[False,
                                                                    True],
                                    passes=3, ctx=ctx)
    out["ooc_sort"] = _frame_case(res, st)
    world = ctx.GetWorldSize()
    res, st = exec_mod.chunked_repartition(d["l"], "k", world, passes=3,
                                           ctx=ctx)
    names = list(d["l"])
    out["ooc_repartition"] = {
        "names": names, "dtypes": [str(np.asarray(d["l"][n]).dtype)
                                   for n in names],
        "shards": {t: [(np.asarray(f[n]), None, None) for n in names]
                   for t, f in enumerate(res) if f is not None},
        "counts": {t: len(f[names[0]]) for t, f in enumerate(res)
                   if f is not None}}
    out["ooc_repartition_counts"] = _stats_of(st)
    left, right = DataFrame(d["l"], ctx=ctx), DataFrame(d["r"], ctx=ctx)
    merged = left.merge(right, on="k")
    out["df_merge_groupby"] = shards_of(merged.groupby(
        "l_k", {"x": ["sum"], "z": ["mean"]}).to_table())
    out["df_sort"] = {k: np.asarray(v) for k, v in
                      left.sort_values("x").to_dict().items()}
    keyed = DataFrame(d["l"], ctx=ctx).set_index("k")
    out["df_loc"] = {k: np.asarray(v) for k, v in
                     keyed.loc[[7, 11]].to_dict().items()}
    out["df_iloc"] = {k: np.asarray(v) for k, v in
                      left.iloc[[3, 150, ROWS_L - 1]].to_dict().items()}
    assert tuple(out) == ENGINE_CASES
    return out


def shards_of(t) -> dict:
    """A Table's local shards under their global ids, whole buffers, or a
    case's host scalars as they are."""
    if isinstance(t, dict):
        return t
    if isinstance(t, list):
        return [shards_of(x) for x in t]

    def host(x):
        return None if x is None else x.cpu().numpy()

    return {"names": list(t.names),
            "dtypes": [c.dtype for c in t.shards[0]],
            "shards": {sid: [(host(c.data), host(c.validity),
                              host(c.lengths)) for c in cols]
                       for sid, cols in zip(t.shard_ids, t.shards)},
            "counts": dict(zip(t.shard_ids,
                               (int(n) for n in t._local_row_counts())))}


def run_arms(ctx) -> dict:
    """Every case under each exchange realization, as ``shards_of``."""
    from cylon_tpu_torch import config

    res = {}
    for label, pack, comp in ARMS:
        with config.knob_env(CYLON_TPU_SHUFFLE_PACK=pack,
                             CYLON_TPU_SHUFFLE_COMPRESS=comp):
            res[label] = {k: shards_of(v) for k, v in run_cases(ctx).items()}
    return res


def multihost_checks(ctx, pid: int, nprocs: int, local: int,
                     out_dir: str) -> dict:
    """``tests/multihost_worker.py``'s checks, and the retry policy and a
    fault injected into the shuffle, each as (ok, detail)."""
    import glob

    import pandas as pd

    from cylon_tpu_torch import CylonError, DataFrame, Table, resilience

    d = inputs()
    pl, pr = pd.DataFrame(d["l"]), pd.DataFrame(d["r"])
    l, r = Table.from_pandas(pl, ctx=ctx), Table.from_pandas(pr, ctx=ctx)
    checks = {}

    def check(name, ok, detail=""):
        checks[name] = (bool(ok), str(detail))

    check("rank", ctx.GetRank() == pid, ctx.GetRank())
    check("world", ctx.GetWorldSize() == local * nprocs, ctx.GetWorldSize())
    check("multi_process", ctx.multi_process() == (nprocs > 1))
    check("no_retry", ctx.collective_retry_policy().max_retries == 0,
          ctx.collective_retry_policy())
    ctx.Barrier()
    j = l.distributed_join(r, on="k", how="inner")
    exp = len(pl.merge(pr, on="k"))
    check("join_count", j.row_count == exp, (j.row_count, exp))
    full = j.to_pandas()
    check("to_pandas_every_row", len(full) == exp, len(full))
    want = pl.merge(pr, on="k").sort_values(["k", "x", "z"])
    got = full.rename(columns={"l_k": "k"}).drop(columns="r_k").sort_values(
        ["k", "x", "z"])
    check("to_pandas_rows", np.array_equal(got.to_numpy(), want.to_numpy()))
    g = l.groupby("k", {"x": ["sum", "mean"]})
    check("groups", g.row_count == pl.k.nunique(), g.row_count)
    s = float(l.sum("x"))
    check("sum", abs(s - pl.x.sum()) < 1e-9, (s, pl.x.sum()))
    srt = l.distributed_sort("x").to_pandas()
    check("sort", np.array_equal(srt["x"].to_numpy(),
                                 np.sort(pl.x.to_numpy())))
    l["w"] = np.arange(len(pl), dtype=np.int64)
    check("setitem_host", int(l.sum("w")) == int(np.arange(len(pl)).sum())
          and np.array_equal(l.to_pandas()["w"].to_numpy(),
                             np.arange(len(pl))))
    ids = [sid for sid, _, _ in l._addressable_host_shards()]
    check("addressable_ids", ids == list(range(local * pid,
                                               local * (pid + 1))), ids)
    l.to_csv(os.path.join(out_dir, "part_{shard}.csv"), per_shard=True)
    mine = sorted(glob.glob(os.path.join(out_dir, "part_*.csv")))
    ctx.Barrier()  # every process has written its own files
    every = sorted(glob.glob(os.path.join(out_dir, "part_*.csv")))
    check("csv_per_shard", len(mine) >= local and
          len(every) == local * nprocs and
          sum(len(pd.read_csv(f)) for f in every) == len(pl),
          (len(mine), len(every)))
    try:
        with resilience.fault_plan("shuffle@1=comm"):
            l.shuffle("k")
        check("fault_surfaces", nprocs == 1, "healed by a retry")
    except CylonError as e:  # the first failure, not retried
        check("fault_surfaces", nprocs > 1 and "after 1 attempts" in str(e),
              e)
    ctx.Barrier()
    # a process handed other arrays plans other passes: every process
    # raises Invalid from the pass-plan agreement, none waits in a pass
    from cylon_tpu_torch import Code, exec as exec_mod

    n = 120 + 7 * pid
    try:
        exec_mod.chunked_groupby({"k": np.arange(n) % 13,
                                  "v": np.ones(n)}, "k", {"v": ["sum"]},
                                 passes=3, ctx=ctx)
        check("mismatched_passes_raise", nprocs == 1, "no error")
    except CylonError as e:
        check("mismatched_passes_raise", nprocs > 1
              and e.code == Code.Invalid and "different passes" in str(e), e)
    ctx.Barrier()
    merged = (DataFrame(d["l"], ctx=ctx).merge(DataFrame(d["r"], ctx=ctx),
                                              on="k")
              .groupby("l_k", {"x": ["sum"]}).to_pandas())
    want = pl.merge(pr, on="k").groupby("k").x.sum()
    got = merged.set_index("l_k").sort_index()["sum_x"]
    check("dataframe_merge_groupby",
          np.array_equal(got.index.to_numpy(), want.index.to_numpy())
          and np.allclose(got.to_numpy(), want.to_numpy(), rtol=1e-12),
          (len(got), len(want)))
    return checks


def main() -> int:
    pid, nprocs, port, local, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         sys.argv[3], int(sys.argv[4]),
                                         sys.argv[5])
    import torch

    torch.set_num_threads(2)
    from cylon_tpu_torch import CylonContext, MeshConfig

    try:
        ctx = CylonContext.InitDistributed(MeshConfig(
            devices=["cpu"], world_size=local,
            coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs,
            process_id=pid, timeout_s=120))
    except Exception as e:  # noqa: BLE001 - a lost port race retries
        low = str(e).lower()
        if "address already in use" in low or "bind" in low:
            print(f"proc {pid}: rendezvous port race on {port}: {e}",
                  flush=True)
            return BIND_RACE_RC
        raise
    try:
        result = {"arms": run_arms(ctx), "engine": run_engine(ctx),
                  "checks": multihost_checks(ctx, pid, nprocs, local,
                                             out_dir)}
    except Exception:
        traceback.print_exc()
        return 1
    with open(os.path.join(out_dir, f"r{pid}.pkl"), "wb") as f:
        pickle.dump(result, f)
    ctx.Finalize()
    print(f"proc {pid}/{nprocs} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
