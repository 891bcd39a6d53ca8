"""Streaming ingestion: append-only micro-batches with durable,
incremental refresh.

A copy of ``cylon_tpu/stream/``.  ``StreamTable`` journals each appended
micro-batch as an fsync'd pass in the durable manifest;
``GroupByQuery`` / ``JoinQuery`` refresh incrementally over the frozen
batch log on one device, persisting partial-aggregate state between
refreshes.  The refresh result at watermark N is bit-identical to a cold
recompute over batches 0..N-1 (``recompute_cold()`` on either query).
"""
from .incremental import (GroupByQuery, JoinQuery, batch_cap,  # noqa: F401
                          query_from_spec, run_refresh, state_cap)
from .state import (STATE_SCHEMA_VERSION, VERSION_FIELD,  # noqa: F401
                    require_state_version, state_provenance)
from .table import StreamTable  # noqa: F401

__all__ = [
    "StreamTable", "GroupByQuery", "JoinQuery", "run_refresh",
    "query_from_spec", "batch_cap", "state_cap",
    "STATE_SCHEMA_VERSION", "VERSION_FIELD", "require_state_version",
    "state_provenance",
]
