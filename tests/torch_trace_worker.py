"""Worker for the port's cross-rank causal-tracing test (not a pytest
module), the counterpart of ``tests/trace_worker.py`` on the CPU: imports
neither jax nor the JAX package.

A 3-process elastic gang where rank 0 fronts the work with a
QueryService: ONE serve request (one minted trace context) drives the
whole gang's chunked join+groupby through ``elastic.elastic_run``.  The
request's traceparent rides rank 0's barrier verbs, the coordinator
latches and echoes it, and ranks 1..N adopt it for their epoch's work —
so after ``tools/trace_merge.py`` the three traces form ONE causally
linked request tree, and ``tools/critical_path.py`` can name the seeded
straggler (``CYLON_TPU_FAULT_PLAN=elastic.pass.r<R>@1+=delay``) as the
dominant path segment.

Exit codes: 0 ok; 3 coordinator lost; 4 fenced; 5 serve request failed.

Usage: python -m tests.torch_trace_worker <rank> <world> <host:port>
           <out.npz> <stats.json> [seed]
"""
import json
import os
import sys

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cylon_tpu_torch import CylonContext, elastic  # noqa: E402
from cylon_tpu_torch.serve import service as serve_mod  # noqa: E402
from tests.torch_elastic_worker import (  # noqa: E402
    N_PASSES, _export_trace, inputs, run_op)


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    address, out_path, stats_path = sys.argv[3], sys.argv[4], sys.argv[5]
    seed = int(sys.argv[6]) if len(sys.argv) > 6 else 7
    left, right = inputs(seed)

    agent = elastic.Agent(address, rank).start()

    # untraced WARM-UP epoch over different data (different fingerprint,
    # same shapes): the first pass's one-time costs are paid here, so the
    # seeded per-pass delay dominates the traced request's critical path
    wleft, wright = inputs(seed + 1000)
    try:
        elastic.elastic_run(agent, N_PASSES,
                            lambda sl: run_op(wleft, wright, sl),
                            finalize=lambda: run_op(wleft, wright),
                            run_id=f"warm{seed}")
    except elastic.CoordinatorLost:
        return 3
    except elastic.EpochChanged:
        return 4

    if rank != 0:
        # a plain gang member: its spans join the request trace through
        # barrier adoption — this process never sees a serve layer
        try:
            elastic.elastic_run(
                agent, N_PASSES, lambda sl: run_op(left, right, sl),
                finalize=lambda: run_op(left, right),
                run_id=f"seed{seed}")
        except elastic.CoordinatorLost as e:
            print(f"rank {rank}: coordinator lost: {e}", flush=True)
            _export_trace(rank)
            return 3
        except elastic.EpochChanged as e:
            print(f"rank {rank}: fenced as straggler: {e}", flush=True)
            _export_trace(rank)
            return 4
        agent.leave()
        _export_trace(rank)
        print(f"rank {rank}/{world} OK (member)", flush=True)
        return 0

    # rank 0: the serving front door.  The custom op runs the elastic
    # gang from the scheduler thread, under the request's trace context.
    def run_elastic(*args, ctx=None, pass_guard=None, **kwargs):
        return elastic.elastic_run(
            agent, N_PASSES, lambda sl: run_op(left, right, sl),
            finalize=lambda: run_op(left, right), run_id=f"seed{seed}")

    serve_mod.register_op("elastic_join_groupby", run_elastic)
    svc = serve_mod.QueryService(ctx=CylonContext.Init("cpu"),
                                 name="trace-smoke")
    try:
        ticket = svc.submit("trace-tenant", "elastic_join_groupby")
        res, stats = ticket.result(timeout=240)
    except Exception as e:
        print(f"rank 0: serve request failed: {type(e).__name__}: {e}",
              flush=True)
        _export_trace(rank)
        return 5
    finally:
        svc.close(timeout=5.0)
    order = np.argsort(res["l_k"], kind="stable")
    np.savez(out_path, **{k: np.asarray(v)[order] for k, v in res.items()})
    with open(stats_path, "w", encoding="utf-8") as fh:
        json.dump({"rank": rank, "trace_id": ticket.trace_id,
                   "state": ticket.state,
                   "duration_s": ticket.duration_s,
                   **{k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str, list))}}, fh)
    agent.leave()
    _export_trace(rank)
    print(f"rank 0/{world} OK: served trace {ticket.trace_id}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
