"""Worker for the port's elastic multi-process tests (not a pytest
module), the counterpart of ``tests/elastic_worker.py`` on the CPU:
imports neither jax nor the JAX package.

One gang member: joins the coordinator the parent started, runs its
slice of a deterministic chunked join+groupby through the shared durable
journal via ``elastic.elastic_run``, and — once the gang's rendezvous
confirms every key-domain part is journaled — assembles the full result
from the journal and writes it to the given paths.  The parent injects
faults per rank through each worker's environment
(``CYLON_TPU_FAULT_PLAN``): ``elastic.pass.r<rank>@N=rank_kill`` dies at
a pass boundary (kill -9 semantics), ``elastic.heartbeat.r<rank>@N=
heartbeat_loss`` goes silent while still computing (the straggler).

Exit codes: 0 ok; 137 rank_kill; 3 coordinator lost (clean classified
failure, never a hang); 4 fenced off as a dead straggler.

Usage: python -m tests.torch_elastic_worker <rank> <world> <host:port>
           <out.npz> <stats.json> [seed]
"""
import json
import os
import sys

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cylon_tpu_torch import CylonContext, elastic  # noqa: E402
from cylon_tpu_torch.exec import chunked_join_groupby_tables  # noqa: E402
from cylon_tpu_torch.obs import export as obs_export  # noqa: E402
from cylon_tpu_torch.obs import spans as obs_spans  # noqa: E402

N_ROWS = 3000
N_PASSES = 6


def inputs(seed: int = 7):
    """Deterministic inputs — every rank (and the in-test oracle) sees
    identical data, so the run fingerprint agrees and the journal is
    shared (the part assignment slices out each member's work)."""
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, N_ROWS, N_ROWS).astype(np.int64),
            "a": rng.random(N_ROWS).astype(np.float32)}
    right = {"k": rng.integers(0, N_ROWS, N_ROWS).astype(np.int64),
             "b": rng.random(N_ROWS).astype(np.float32)}
    return left, right


def run_op(left, right, sl=None):
    """The gang's one fingerprinted operation — shared with
    tests/test_torch_elastic.py so the in-process journal tests, the
    oracle, and every worker compute the IDENTICAL run fingerprint
    (mode="hash": the splitmix64 partitioner, whose part ids are the
    global positions the assignment and the journal key on).  On the
    CPU, as every test of the port."""
    return chunked_join_groupby_tables(
        left, right, on="k", how="inner", group_by="l_k",
        agg={"a": ["sum"], "b": ["mean"]}, passes=N_PASSES,
        mode="hash", elastic=sl, ctx=CylonContext.Init("cpu"))


def _export_trace(rank: int) -> None:
    """Ship this rank's event buffer when tracing is armed (the fleet
    identity set by the agent names the artifact, the elastic run id
    namespaces it) — on EVERY exit path: a fenced straggler's trace is
    exactly what the survivors' traces cannot show."""
    if not obs_spans.events_enabled():
        return
    try:
        tp, _ = obs_export.export_all()
        print(f"rank {rank}: trace exported to {tp}", flush=True)
    except OSError as e:
        print(f"rank {rank}: trace export failed: {e}", flush=True)


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    address, out_path, stats_path = sys.argv[3], sys.argv[4], sys.argv[5]
    seed = int(sys.argv[6]) if len(sys.argv) > 6 else 7
    left, right = inputs(seed)

    def run(sl=None):
        return run_op(left, right, sl)

    agent = elastic.Agent(address, rank).start()
    try:
        final = elastic.elastic_run(
            agent, N_PASSES, lambda sl: run(sl), finalize=run,
            run_id=f"seed{seed}")
    except elastic.CoordinatorLost as e:
        print(f"rank {rank}: coordinator lost: {e}", flush=True)
        _export_trace(rank)
        return 3
    except elastic.EpochChanged as e:
        print(f"rank {rank}: fenced as straggler: {e}", flush=True)
        _export_trace(rank)
        return 4
    res, stats = final
    order = np.argsort(res["l_k"], kind="stable")
    np.savez(out_path, **{k: np.asarray(v)[order] for k, v in res.items()})
    with open(stats_path, "w", encoding="utf-8") as fh:
        json.dump({"rank": rank, "epoch": agent.epoch,
                   "members": list(agent.members),
                   "incarnation": agent.incarnation,
                   **{k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str, list))}}, fh)
    agent.leave()
    _export_trace(rank)
    print(f"rank {rank}/{world} OK: epoch={agent.epoch} "
          f"skipped={stats.get('passes_skipped')}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
