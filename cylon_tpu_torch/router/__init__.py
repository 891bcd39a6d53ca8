"""Fleet query routing: many serving replicas behind one front door,
with a shared fleet-wide result cache (``cylon_tpu/router/``).

The elastic coordinator promoted into a query router
(:class:`QueryRouter`): N serving replicas, each its own process on its
own card context, register (`ReplicaServer` wrapping a `QueryService`,
heartbeat telemetry carrying serve address, capacity and live load); the
``route`` verb places requests by tenant affinity with a live-load
tiebreak and proxies them with classified fleet-scope shedding (never a
hang); the shared durable journal serves any replica's fingerprint from
any replica; and a dead replica's queued work is re-routed while
in-flight work is abandoned classified.  ``wire.py`` encodes frames,
arrays, checksummed journal blobs and classified errors on one JSON
line; the journal's peer server and replication pulls
(``durable_sync.py``) use it too.
"""
from .replica import ReplicaServer
from .service import (QueryRouter, RouteShed, RouterClient,
                      cache_affinity_enabled, poll_interval_s,
                      route_timeout_s, router_max_line, rpc_timeout_s)
from .wire import request_key

__all__ = [
    "QueryRouter", "RouterClient", "ReplicaServer", "RouteShed",
    "request_key", "cache_affinity_enabled", "poll_interval_s",
    "rpc_timeout_s", "route_timeout_s", "router_max_line",
]
