"""Worker for the port's fleet-router tests (not a pytest module), the
counterpart of ``tests/router_worker.py`` on the CPU: imports neither jax
nor the JAX package.

One serving replica: an elastic `Agent` joining the `QueryRouter`'s
control plane, a `QueryService` + `ReplicaServer` pair on an ephemeral
data-plane port, and a registered ``kjoin`` op — chunked join behind the
seeded fault site ``router.pass.r<rank>`` so the parent test can
``rank_kill`` one replica mid-flood (``CYLON_TPU_FAULT_PLAN=router.pass.r1@N=rank_kill``
-> ``os._exit(137)`` exactly at its Nth dispatched flood request).

Traces export INCREMENTALLY (tmp + atomic rename every 0.2s): the
killed replica's completed-request spans survive its own death, which
is what lets the merged timeline show one trace spanning router + both
replicas even though ``os._exit`` flushes nothing.

Exit codes: 0 clean stand-down (the router is gone: the test is over),
137 injected kill.

Usage: python -m tests.torch_router_worker <rank> <world> <host:port>
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cylon_tpu_torch import CylonContext, elastic, resilience  # noqa: E402
from cylon_tpu_torch.exec import chunked_join  # noqa: E402
from cylon_tpu_torch.obs import export  # noqa: E402
from cylon_tpu_torch.router import ReplicaServer  # noqa: E402
from cylon_tpu_torch.serve import QueryService  # noqa: E402


def _export_snapshot(rank: int) -> None:
    """Atomic incremental trace + metrics export: a rank_kill mid-write
    must never leave a torn file for trace_merge to choke on, and the
    metrics artifact keeps this replica's durable.* counters after the
    fleet stands down."""
    for prefix, exporter in (("trace", export.export_trace),
                             ("metrics", export.export_metrics)):
        final = export._artifact_path(None, prefix, rank)
        tmp = final + f".tmp.{os.getpid()}"
        try:
            exporter(path=tmp, rank=rank)
            os.replace(tmp, final)
        except OSError:
            pass  # exports are best-effort; the next tick retries


def main() -> int:
    rank = int(sys.argv[1])
    world = int(sys.argv[2])
    address = sys.argv[3]

    agent = elastic.Agent(address, rank).start()
    svc = QueryService(ctx=CylonContext.Init("cpu"), name=f"replica{rank}")

    def kjoin(left, right, *, ctx=None, pass_guard=None, **kw):
        # the seeded kill site: rank_kill here is a replica dying at a
        # request dispatch boundary, with its queue full of re-routable
        # work
        resilience.fault_point(f"router.pass.r{rank}")
        return chunked_join(left, right, ctx=ctx, pass_guard=pass_guard,
                            **kw)

    # idempotent=True: kjoin is a pure journaled join, so hedges are
    # allowed to speculate it onto a second replica
    svc.register_op("kjoin", kjoin, idempotent=True)
    rep = ReplicaServer(svc)
    rep.attach(agent)
    print(f"router_worker r{rank}: serving at "
          f"{rep.address[0]}:{rep.address[1]} (world {world})",
          flush=True)
    try:
        while not (agent.coordinator_down or agent.fenced):
            time.sleep(0.2)
            _export_snapshot(rank)
    finally:
        _export_snapshot(rank)
        rep.close()
        svc.close(timeout=10.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
