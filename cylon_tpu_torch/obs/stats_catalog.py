"""Persistent statistics catalog: what queries OBSERVED, for the next
optimization.

The adaptive planner (broadcast joins, skew salting) needs observed
cardinalities, selectivities and per-shard skew, not just the one-shot
``column_stats`` pre-pass a compressed shuffle runs.
This module is that substrate's storage half: the query profiler
(``plan/profile.py``) distills each profiled run into a compact record
— per-scan/per-column cardinality, per-join key selectivity, per-node
row counts and partition skew — and persists it here, keyed by the
plan's content FINGERPRINT (``LogicalPlan.fingerprint()``: op chain ×
world × pruned input content × trace knobs), so a stat can never be
consumed against data it was not observed on.

Storage discipline is ``durable.py``'s: one append-only fsync'd
``STATS.jsonl`` under ``CYLON_TPU_STATS_DIR``, one JSON object per
line, torn tail tolerated (a crash mid-append costs that record, never
the file), atomic tmp+fsync+rename compaction once the distinct-key
count passes ``CYLON_TPU_STATS_CAP`` (most-recently-written entries
survive — the write-recency LRU, matching the journal GC's clock).  A
fresh process reloads the catalog by reading the file; there is no
in-memory daemon to lose.

Consumption is ``optimizer.lookup_stats()``: the adaptive planner's
cost model (``plan/cost.py``, ``CYLON_TPU_PLAN_ADAPTIVE``) steers on it,
and ``explain(analyze=True)`` renders the looked-up record as per-node
estimates next to the fresh actuals.

A copy of ``cylon_tpu/obs/stats_catalog.py``; host-side only.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict, List, Optional

from .. import config

log = logging.getLogger("cylon_tpu_torch")

STATS_FILE = "STATS.jsonl"
VERSION = 1


def stats_dir() -> str:
    """Catalog root (``CYLON_TPU_STATS_DIR``); empty disables."""
    return str(config.knob("CYLON_TPU_STATS_DIR"))


def enabled() -> bool:
    return bool(stats_dir())


def stats_cap() -> int:
    """Distinct fingerprints kept (``CYLON_TPU_STATS_CAP``): past it the
    file compacts to the most recently written entries."""
    return max(1, int(config.knob("CYLON_TPU_STATS_CAP")))


class StatsCatalog:
    """One loaded view of ``<root>/STATS.jsonl``: a fingerprint ->
    record dict in write order (later writes win)."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, STATS_FILE)
        self.entries: Dict[str, dict] = {}
        self.torn = False

    @classmethod
    def open(cls, root: Optional[str] = None) -> Optional["StatsCatalog"]:
        """Load the catalog (None when disabled or the root is
        unusable — the catalog is advisory and must never fail the
        query it profiles)."""
        root = stats_dir() if root is None else root
        if not root:
            return None
        cat = cls(root)
        try:
            cat._load()
        except OSError as e:
            log.warning("stats_catalog: cannot read %r (%s: %s); catalog "
                        "disabled for this operation", root,
                        type(e).__name__, e)
            return None
        return cat

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as fh:
            for raw in fh:
                if not raw.strip():
                    continue
                try:
                    entry = json.loads(raw)
                except ValueError:
                    # a torn line is the expected shape of a crash
                    # mid-append.  Unlike the run journal, the catalog
                    # OUTLIVES the crash — a later process repairs the
                    # newline and keeps appending — so a bad line is
                    # skipped, not a stop: records after it are real
                    self.torn = True
                    continue
                key = entry.get("key")
                if not isinstance(key, str):
                    continue
                # re-insert so iteration order is write-recency order
                self.entries.pop(key, None)
                self.entries[key] = entry.get("stats") or {}

    def lookup(self, fingerprint: str) -> Optional[dict]:
        return self.entries.get(fingerprint)

    def record(self, fingerprint: str, stats: dict) -> None:
        """Append one fsync'd record; compacts past the cap.  IO
        failures are warned and swallowed — persisting statistics is
        best-effort by contract."""
        entry = {"v": VERSION, "key": fingerprint, "stats": stats}
        line = json.dumps(entry, sort_keys=True, default=_js) + "\n"
        try:
            os.makedirs(self.root, exist_ok=True)
            with open(self.path, "a+", encoding="utf-8") as fh:
                # repair a predecessor's torn tail: an append must start
                # on its own line or it merges into the torn record and
                # both are lost to every future reader
                fh.seek(0, os.SEEK_END)
                if fh.tell() > 0:
                    fh.seek(fh.tell() - 1)
                    if fh.read(1) != "\n":
                        fh.write("\n")
                fh.write(line)
                fh.flush()
                os.fsync(fh.fileno())
        except OSError as e:
            log.warning("stats_catalog: record failed (%s: %s); dropping",
                        type(e).__name__, e)
            return
        self.entries.pop(fingerprint, None)
        self.entries[fingerprint] = stats
        if len(self.entries) > stats_cap():
            self._compact()

    def _compact(self) -> None:
        """Rewrite the file with the ``stats_cap()`` most recently
        written entries (atomic tmp + fsync + rename, the durable.py
        discipline: a crash at any point leaves either the old complete
        file or the new complete file).

        Re-reads the file FIRST (the CoordLog ownership-re-read
        discipline): this catalog's in-memory view may predate another
        process's fsync'd appends, and a destructive rewrite from a
        stale view would erase them.  A write landing between the
        re-read and the rename can still lose (last-writer-wins on the
        whole file) — acceptable for advisory statistics, documented
        here rather than papered over with cross-process locks."""
        fresh = StatsCatalog(self.root)
        try:
            fresh._load()
        except OSError:
            return  # can't see the ground truth: don't rewrite over it
        self.entries = fresh.entries
        keep_keys = list(self.entries)[-stats_cap():]
        keep = {k: self.entries[k] for k in keep_keys}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                for k in keep_keys:
                    fh.write(json.dumps(
                        {"v": VERSION, "key": k, "stats": keep[k]},
                        sort_keys=True, default=_js) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except OSError as e:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            log.warning("stats_catalog: compaction failed (%s: %s); the "
                        "append-only file keeps growing until the next "
                        "attempt", type(e).__name__, e)
            return
        self.entries = keep


def _js(o):
    """JSON default: numpy scalars and other numerics label themselves
    instead of crashing the record."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


# ---------------------------------------------------------------------------
# module-level convenience (fresh view per call: the file is small and a
# concurrent writer's appends must be visible to this process's lookups)
# ---------------------------------------------------------------------------


def lookup(fingerprint: str) -> Optional[dict]:
    cat = StatsCatalog.open()
    return None if cat is None else cat.lookup(fingerprint)


def record(fingerprint: str, stats: dict) -> None:
    cat = StatsCatalog.open()
    if cat is not None:
        cat.record(fingerprint, stats)


def keys() -> List[str]:
    cat = StatsCatalog.open()
    return [] if cat is None else list(cat.entries)
