"""The durable journal exposed as a result cache.

A copy of ``cylon_tpu/serve/cache.py``.  ``durable.py`` fingerprints
every journaled run (op x full input content x result knobs) and replays
journaled passes instead of running them, so a REPEATED query is a cache
hit: a complete journal means zero device passes and zero kernel
launches.  This module is the serving side's view of it:

- :func:`served_from_journal`: the post-run predicate the service counts
  ``serve.cache_hit`` by (a pass replayed from spill, none executed);
- :func:`contents`: the cache inventory (fingerprint, bytes, LRU mtime,
  completeness) off the journal root;
- :func:`maybe_gc`: the ``CYLON_TPU_DURABLE_CAP_BYTES`` LRU eviction
  (``durable.gc_journal``), counted under ``serve.cache_evictions``.

Eviction is manifest-LAST: a reader racing an eviction sees spills that
fail their checksums and re-executes those passes, a slower answer and
never a torn one (fault kind ``cache_evict_race``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .. import durable
from ..obs import metrics as obs_metrics


def served_from_journal(stats: dict) -> bool:
    """True when a run's stats show it was answered ENTIRELY from the
    journal: at least one pass replayed from spill and zero passes
    executed on device — the serving layer's definition of a result-
    cache hit."""
    return (stats.get("passes_skipped", 0) > 0
            and stats.get("parts_run", 0) == 0)


def contents(root: Optional[str] = None) -> List[dict]:
    """Cache inventory, least-recently-used first: one dict per journaled
    run (``fingerprint``, ``bytes``, ``mtime``, ``complete`` — complete
    runs are servable end-to-end; incomplete ones only shorten a
    re-execution)."""
    return durable.scan_runs(root)


def cache_bytes(root: Optional[str] = None) -> int:
    return sum(r["bytes"] for r in durable.scan_runs(root))


def maybe_gc(root: Optional[str] = None) -> Tuple[int, int]:
    """Run the size-cap LRU eviction when ``CYLON_TPU_DURABLE_CAP_BYTES``
    is set; ``(runs_evicted, bytes_freed)``.  Safe to call after every
    request — without a cap it is a single knob read."""
    evicted, freed = durable.gc_journal(root)
    if evicted:
        obs_metrics.counter_add("serve.cache_evictions", evicted)
    return evicted, freed
