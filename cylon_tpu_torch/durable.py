"""Durable execution: journaled spill-to-disk checkpoints, cross-process
crash-resume, pass deadlines, and poison-pass quarantine.

The port of ``cylon_tpu/durable.py``.  Three primitives:

- **run journal** (`RunJournal`): every one-shard chunked run and every
  planned query is fingerprinted (op spec x input content x the knobs
  that change results, :func:`run_fingerprint`); each completed pass's
  host frame spills to an Arrow IPC file (``io.arrow_io.
  frame_to_ipc_bytes``, the JAX package's bytes exactly) with a sha256
  checksum and an atomic rename under ``CYLON_TPU_DURABLE_DIR``, and pass
  completion lands in an append-only ``MANIFEST.jsonl`` (fsync'd per
  line).  A fresh process re-invoking the same run loads completed parts
  from the spills and resumes mid-plan: a ``kill -9`` costs at most the
  in-flight pass.  A truncated or corrupt spill fails its checksum and is
  read-repaired from a peer journal (``durable_sync.py``) or re-executed;
  a manifest whose recorded fingerprint disagrees with the run's is
  refused outright.  The layout (directory per fingerprint, spill names,
  manifest lines, the ``GC_LOCK`` lease) is the JAX package's, so each
  package loads a run the other wrote and ``tools/journal_fsck.py``
  checks either.  A size cap (``CYLON_TPU_DURABLE_CAP_BYTES``) evicts
  whole runs least-recently-used first under the walker lease
  (``durable_lease.py``); a quota (``CYLON_TPU_DURABLE_QUOTA_BYTES``) or a
  full disk degrades a run to journal-off execution, never fails it.

- **pass deadlines** (:func:`pass_deadline`): a watchdog thread armed per
  pass fires ``deadline.fired`` (obs instant + metric) the moment
  ``CYLON_TPU_PASS_DEADLINE_S`` elapses, and the overrun is classified
  `Code.Timeout`, which the streaming loop retries like any transient
  (served from the journal when the late frame was already committed).
  The watchdog cannot preempt a wedged native call; it makes the hang
  visible and classified.

- **poison-pass quarantine** (:func:`quarantine_after`): a part failing
  the same way ``CYLON_TPU_QUARANTINE_AFTER`` consecutive times is
  isolated into the run report (``stats["quarantined"]`` + a manifest
  record) instead of wedging refinement.  Only classified-recoverable
  codes (OOM / transient / timeout) are quarantinable.

Host-side only: the frames a pass hands to the journal are host numpy.
The ``killhard`` fault kind (``os._exit`` mid-journal), ``journal_corrupt``
(truncates the last committed spill), ``bitrot`` (flips one spill byte)
and ``cache_evict_race`` (deletes a run's spills, keeps its manifest)
drive the crash-resume and integrity tests on the CPU
(``tests/test_torch_durable.py``).
"""
from __future__ import annotations

import contextlib
import errno
import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import config
from . import durable_lease
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .obs import tracectx
from .status import Code, CylonError

log = logging.getLogger("cylon_tpu_torch")

MANIFEST = "MANIFEST.jsonl"

#: marker file exempting a run dir from the size-cap LRU GC: live state
#: (a stream's batch log, a standing query's partial-aggregate spills) is
#: consulted on every refresh, and evicting it between refreshes silently
#: degrades each refresh to a full recompute, so a pinned run is skipped
#: by ``gc_journal`` even when it is the LRU victim.  Honored UNDER the GC
#: lease (re-checked per victim immediately before eviction), so a pin
#: racing a concurrent sweep still protects the run.
PINNED = "PINNED"

#: advisory cross-process walker lease (journal root), from
#: `durable_lease` (stdlib only, so tools/journal_fsck.py can load the
#: JAX package's copy by file path)
GC_LOCK = durable_lease.GC_LOCK
_GC_LEASE_TTL_S = durable_lease.LEASE_TTL_S

#: minimum seconds between load-time manifest-mtime freshens (the LRU
#: clock a long replay must keep advancing under a shared journal)
_FRESHEN_MIN_S = 5.0


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def durable_dir() -> str:
    """Journal root (``CYLON_TPU_DURABLE_DIR``); empty disables."""
    return str(config.knob("CYLON_TPU_DURABLE_DIR"))


def enabled() -> bool:
    return bool(durable_dir())


def deadline_s() -> float:
    """Per-pass wall-clock budget (``CYLON_TPU_PASS_DEADLINE_S``);
    0 (default) disables the watchdog."""
    return max(0.0, float(config.knob("CYLON_TPU_PASS_DEADLINE_S")))


def quarantine_after() -> int:
    """Consecutive same-code failures before a part is quarantined
    (``CYLON_TPU_QUARANTINE_AFTER``); 0 (default) disables."""
    return max(0, int(config.knob("CYLON_TPU_QUARANTINE_AFTER")))


def cap_bytes() -> int:
    """Journal size cap (``CYLON_TPU_DURABLE_CAP_BYTES``); 0 (default)
    means unbounded — the grow-without-bound behavior."""
    return max(0, int(config.knob("CYLON_TPU_DURABLE_CAP_BYTES")))


def quota_bytes() -> int:
    """Hard disk budget for NEW spill writes
    (``CYLON_TPU_DURABLE_QUOTA_BYTES``); 0 (default) disables.  Unlike
    ``cap_bytes`` (which the GC enforces *after* the fact by evicting),
    the quota refuses the write up front — the run degrades to
    journal-off execution instead of filling a shared disk."""
    return max(0, int(config.knob("CYLON_TPU_DURABLE_QUOTA_BYTES")))


def replication_factor() -> int:
    """Target copies of every completed run across the fleet's journal
    roots (``CYLON_TPU_DURABLE_RF``, default 2).  1 disables anti-entropy
    replication entirely — byte-identical to the single-root
    behavior (pinned by tests).  Only meaningful when replicas journal to
    DISTINCT roots; replicas sharing one filesystem root are one copy."""
    return max(1, int(config.knob("CYLON_TPU_DURABLE_RF")))


def scrub_interval_s() -> float:
    """Seconds between background integrity-scrub passes
    (``CYLON_TPU_SCRUB_S``); 0 (default) disables the scrubber thread —
    corruption is then detected lazily at load time.
    ``durable_sync.scrub_once`` can always be called directly
    (tools/journal_fsck.py is the offline twin)."""
    return max(0.0, float(config.knob("CYLON_TPU_SCRUB_S")))


# ---------------------------------------------------------------------------
# content fingerprints (cylon_tpu/durable.py:163-256)
# ---------------------------------------------------------------------------

_OBJ_SLAB = 1 << 20   # object elements decoded per slab
_MIX_SLAB = 1 << 22   # u64 words mixed per vectorized slab (32 MB)


def _mix_u64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (uint64 wraparound arithmetic)."""
    x = np.asarray(x, np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _update_spec(h, obj) -> None:
    """Feed a canonical encoding of a primitive/tuple spec into ``h``,
    type-tagged so ("1",) and (1,) hash apart."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        h.update(f"<{type(obj).__name__}:{obj!r}>".encode())
        return
    if isinstance(obj, (tuple, list)):
        h.update(b"<seq[")
        for item in obj:
            _update_spec(h, item)
        h.update(b"]>")
        return
    raise CylonError(Code.Invalid,
                     f"unhashable fingerprint spec element {type(obj)}")


def _update_array(h, name: str, a: np.ndarray) -> None:
    """Fold one input column into the fingerprint with full content
    coverage: changing any element changes the fingerprint.  Fixed-width
    columns reduce through a position-mixed splitmix64 xor-fold in bounded
    slabs; object columns hash their decoded codepoints slab-wise, with a
    kind tag per element (None, str, bytes, other)."""
    a = np.asarray(a)
    h.update(f"|col:{name}:{a.dtype.str}:{a.shape}".encode())
    if a.size == 0:
        return
    flat = a.reshape(-1)
    if a.dtype.kind == "O":
        for lo in range(0, flat.size, _OBJ_SLAB):
            sl = flat[lo:lo + _OBJ_SLAB]
            tags = np.fromiter(
                (0 if x is None
                 else 1 if isinstance(x, (str, np.str_))
                 else 2 if isinstance(x, (bytes, np.bytes_))
                 else 3 for x in sl), np.uint8, count=len(sl))
            h.update(tags.tobytes())
            h.update(np.asarray(sl.astype("U")).tobytes())
        return
    b = np.ascontiguousarray(flat).view(np.uint8).reshape(-1)
    n_words = -(-b.size // 8)
    acc = np.uint64(0)
    for lo in range(0, n_words, _MIX_SLAB):
        hi = min(lo + _MIX_SLAB, n_words)
        chunk = b[lo * 8:min(hi * 8, b.size)]
        if len(chunk) < (hi - lo) * 8:  # zero-pad the final partial word
            chunk = np.concatenate(
                [chunk, np.zeros((hi - lo) * 8 - len(chunk), np.uint8)])
        words = np.ascontiguousarray(chunk).view(np.uint64)
        pos = np.arange(lo, hi, dtype=np.uint64)
        acc = acc ^ np.uint64(np.bitwise_xor.reduce(
            _mix_u64(words ^ _mix_u64(pos))))
    h.update(int(acc).to_bytes(8, "little"))


def run_fingerprint(op: str, spec, frames: Sequence[Tuple[Sequence[str],
                                                          Dict]]) -> str:
    """Hex fingerprint of one run: op kind x op spec x every input
    column's content x the knobs that change results
    (``config.trace_cache_token``) x the opaque ``CYLON_TPU_FP_SALT``."""
    with obs_spans.span("durable.fingerprint", op=op):
        h = hashlib.sha256()
        h.update(f"cylon_tpu.durable.v1|{op}".encode())
        salt = config.knob("CYLON_TPU_FP_SALT")
        if salt:
            h.update(f"|salt:{salt}".encode())
        _update_spec(h, spec)
        _update_spec(h, [list(kv) for kv in config.trace_cache_token()])
        for names, arrs in frames:
            h.update(b"|frame")
            for name in names:
                _update_array(h, str(name), np.asarray(arrs[name]))
        return h.hexdigest()


# ---------------------------------------------------------------------------
# the run journal
# ---------------------------------------------------------------------------

# most recently opened journal — the handle the `journal_corrupt` fault
# kind corrupts (deterministic crash-resume tests, resilience.fault_point)
_LAST_JOURNAL: Optional["RunJournal"] = None


class RunJournal:
    """Append-only manifest + checksummed Arrow IPC spills for one
    fingerprinted run under ``<CYLON_TPU_DURABLE_DIR>/<fingerprint>/``.

    Crash-safety contract: a pass is *completed* iff its manifest line
    was fully written AND its spill file matches the recorded sha256.
    The spill is written first (tmp file + fsync + atomic ``os.replace``),
    the manifest line second (fsync'd append), so every crash point
    leaves either a resumable state or an orphan spill that is simply
    re-executed — never a manifest entry pointing at absent/garbage data
    that would silently corrupt a resumed run (garbage fails the
    checksum and is re-executed too)."""

    def __init__(self, root: str, fingerprint: str, op: str,
                 world: Optional[int] = None, epoch: Optional[int] = None):
        self.fingerprint = fingerprint
        self.op = op
        self.dir = os.path.join(root, fingerprint)
        # provenance: the membership world size and epoch this PROCESS
        # is journaling under.  Part ids are global
        # positions in the key-domain plan — world-INDEPENDENT — so the
        # fingerprint deliberately excludes world/epoch (a shard
        # journaled at world W must be consumed, not refused, at world
        # W-1); world/epoch ride the manifest as per-pass provenance so
        # the shrink history is auditable after the fact.
        self.world = world
        self.epoch = epoch
        self._passes: Dict[Tuple[int, int], dict] = {}
        self._quarantined: List[dict] = []
        self._last_committed: Optional[str] = None
        self._spill_disabled = False
        self._degraded = False
        self._done: Optional[dict] = None
        # lazy journal-root byte inventory for the quota guard (scanned
        # once per journal, then tracked incrementally for our own writes)
        self._root_seen_bytes: Optional[int] = None
        self._freshened_at = 0.0

    # -- open / manifest replay -----------------------------------------

    @classmethod
    def open_run(cls, fingerprint: str, op: str,
                 world: Optional[int] = None,
                 epoch: Optional[int] = None) -> Optional["RunJournal"]:
        """Open (creating if needed) the journal for ``fingerprint``, or
        None when durability is disabled — or when the journal root is
        unusable (unwritable, not a directory, IO errors): best-effort
        durability must never fail the run it exists to protect.  The
        foreign-fingerprint refusal is NOT best-effort and propagates.
        Replays the manifest so ``load_pass`` can serve completed
        parts."""
        global _LAST_JOURNAL
        root = durable_dir()
        if not root:
            return None
        j = cls(root, fingerprint, op, world=world, epoch=epoch)
        try:
            j._open()
        except OSError as e:
            obs_metrics.counter_add("durable.journal_errors")
            log.warning("durable: cannot open journal under %r (%s: %s); "
                        "journaling disabled for this run", root,
                        type(e).__name__, e)
            return None
        _LAST_JOURNAL = j
        return j

    def _open(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, MANIFEST)
        header = None
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                for raw in fh:
                    try:
                        entry = json.loads(raw)
                    except ValueError:
                        # a torn tail line is the expected shape of a
                        # crash mid-append; everything before it stands
                        break
                    kind = entry.get("kind")
                    if kind == "run":
                        header = entry
                    elif kind == "pass":
                        self._passes[(int(entry["level"]),
                                      int(entry["part"]))] = entry
                    elif kind == "quarantine":
                        self._quarantined.append(entry)
                    elif kind == "done":
                        self._done = entry
        if header is not None and header.get("fingerprint") != self.fingerprint:
            # the dir is named by the fingerprint, so this means tampering
            # or a collision — stale spills must never serve another run
            raise CylonError(
                Code.Invalid,
                f"durable journal {self.dir} records fingerprint "
                f"{header.get('fingerprint')!r} != this run's "
                f"{self.fingerprint!r}: refusing stale spills")
        if header is None:
            entry = {"kind": "run", "fingerprint": self.fingerprint,
                     "op": self.op}
            if self.world is not None:
                entry["world"] = int(self.world)
            if self.epoch is not None:
                entry["epoch"] = int(self.epoch)
            try:
                self._append(entry)
            except OSError as e:
                # journaling is best-effort: an unwritable journal must
                # never fail the run it was meant to protect — loads (the
                # resume path) still work, new spills are skipped
                self._spill_disabled = True
                log.warning("durable: manifest header write failed (%s: "
                            "%s); journaling disabled for this run",
                            type(e).__name__, e)
        # LRU clock for the size-cap GC: every open (a fresh run, a
        # resume, a cache serve) freshens the manifest mtime, so eviction
        # order is least-recently-USED, not least-recently-written
        with contextlib.suppress(OSError):
            os.utime(path)
        if self._passes:
            log.info("durable: resuming run %s from %d journaled passes",
                     self.fingerprint[:12], len(self._passes))
            obs_spans.instant("durable.resume", op=self.op,
                              journaled_passes=len(self._passes))
            obs_metrics.counter_add("durable.resumes")

    def _append(self, entry: dict) -> None:
        with open(os.path.join(self.dir, MANIFEST), "a",
                  encoding="utf-8") as fh:
            fh.write(json.dumps(entry, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    # -- pass completion --------------------------------------------------

    def completed_count(self) -> int:
        return len(self._passes)

    def completed(self, level: int, part: int) -> bool:
        """True when the pass has a manifest record (cheap — no spill
        read; the checksum is still verified at load time)."""
        return (int(level), int(part)) in self._passes

    def record_pass(self, level: int, part: int, frame: Dict[str, np.ndarray],
                    rows: int,
                    provenance: Optional[dict] = None) -> bool:
        """Spill one completed pass's host frame and commit it to the
        manifest; True iff the pass is now durably journaled.  Spill/
        serialize failures disable journaling for the rest of the run
        (counted, warned) — durability is best-effort and must never
        fail a pass that already computed.

        ``provenance``: an optional JSON-safe dict folded into
        the manifest pass entry — the streaming layer records each
        micro-batch's id, row count, content fingerprint and state
        schema version here, so a resumed process can audit WHAT a pass
        holds without decoding the spill (``pass_provenance``).

        Every column must be a host ``numpy`` array: a tensor (on the
        card or not) is the caller's bug, so it raises TypeError instead
        of being taken for a spill failure that quietly turns the journal
        off."""
        bad = {str(k): type(v).__name__ for k, v in frame.items()
               if not isinstance(v, np.ndarray)}
        if bad:
            raise TypeError(f"record_pass: columns that are not host numpy "
                            f"arrays: {bad}")
        if self._spill_disabled:
            return False
        from . import resilience
        from .io import arrow_io

        name = f"pass_L{level}_P{part}.arrow"
        path = os.path.join(self.dir, name)
        with obs_spans.span("durable.spill", level=level, part=part,
                            rows=rows):
            try:
                payload = arrow_io.frame_to_ipc_bytes(frame)
            except Exception as e:
                self._spill_failed("serialize", name, e)
                return False
            if self._quota_exceeded(len(payload)):
                self._degrade("quota", name,
                              f"CYLON_TPU_DURABLE_QUOTA_BYTES="
                              f"{quota_bytes()} would be exceeded by "
                              f"{len(payload)} more bytes")
                return False
            digest = hashlib.sha256(payload).hexdigest()
            tmp = path + f".tmp.{os.getpid()}"
            try:
                # the injected ENOSPC site (fault kind `disk_full`) sits
                # INSIDE the guarded region: a full disk — real or
                # seeded — degrades the run, it never fails the pass
                resilience.fault_point("journal_spill")
                with open(tmp, "wb") as fh:
                    fh.write(payload)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
            except OSError as e:
                with contextlib.suppress(OSError):
                    os.remove(tmp)
                self._spill_failed("write", name, e)
                return False
            self._last_committed = path
            # the killhard crash window the subprocess tests aim at:
            # spill durable, completion not yet recorded -> the pass
            # re-runs on resume (at-least-once, never lost)
            resilience.fault_point("journal_commit")
            entry = {"kind": "pass", "level": int(level), "part": int(part),
                     "rows": int(rows), "file": name, "sha256": digest,
                     "bytes": len(payload)}
            if provenance:
                entry["provenance"] = dict(provenance)
            if self.world is not None:
                entry["world"] = int(self.world)
            if self.epoch is not None:
                entry["epoch"] = int(self.epoch)
            try:
                self._append(entry)
            except OSError as e:
                self._spill_failed("manifest commit", name, e)
                return False
            self._passes[(int(level), int(part))] = entry
        obs_metrics.counter_add("durable.passes_journaled")
        obs_metrics.counter_add("durable.spill_bytes", len(payload))
        return True

    def _spill_failed(self, stage: str, name: str, e: Exception) -> None:
        if getattr(e, "errno", None) == errno.ENOSPC:
            # a full shared disk is a fleet condition, not a bug: classify
            # it ResourceExhausted and degrade instead of counting it with
            # the anonymous spill errors an operator would page on
            self._degrade(stage, name, f"disk full (ENOSPC): {e}")
            return
        self._spill_disabled = True
        obs_metrics.counter_add("durable.spill_errors")
        log.warning("durable: %s of %s failed (%s: %s); journaling disabled "
                    "for the rest of this run", stage, name,
                    type(e).__name__, e)

    def _quota_exceeded(self, nbytes: int) -> bool:
        """True when writing ``nbytes`` more would push the journal root
        past ``CYLON_TPU_DURABLE_QUOTA_BYTES``.  The root inventory is
        scanned once per journal and then tracked incrementally for this
        writer's own spills — best-effort under concurrent writers, which
        is fine: the quota is a budget, ENOSPC is the backstop."""
        q = quota_bytes()
        if q <= 0:
            return False
        if self._root_seen_bytes is None:
            root = os.path.dirname(self.dir)
            self._root_seen_bytes = sum(
                r["bytes"] for r in scan_runs(root))
        if self._root_seen_bytes + nbytes > q:
            return True
        self._root_seen_bytes += nbytes
        return False

    def _degrade(self, stage: str, name: str, why: str) -> None:
        """Degraded mode: the shared cache is out of disk (ENOSPC or the
        quota) — stop journaling for this run and keep executing.  The
        answer is still served; only durability/cache-ability is lost.
        Classified `Code.ResourceExhausted` in the trace, counted under
        ``durable.degraded`` — distinct from ``durable.spill_errors``
        (unexpected IO bugs) so fleet dashboards can alert on disk
        pressure specifically."""
        self._spill_disabled = True
        if self._degraded:
            return
        self._degraded = True
        obs_metrics.counter_add("durable.degraded")
        obs_spans.instant("durable.degraded", stage=stage, spill=name,
                          code=Code.ResourceExhausted.name, reason=why)
        log.warning("durable: %s of %s hit the disk budget (%s); run "
                    "degrades to journal-off execution [%s]", stage, name,
                    why, Code.ResourceExhausted.name)

    def load_pass(self, level: int, part: int):
        """(frame, rows) for a journaled pass, or None when the pass is
        not recorded — or its spill is missing/truncated/corrupt (checksum
        mismatch) AND no peer holds a good copy, in which case the record
        is dropped so the pass simply re-executes.

        Read-repair: a local checksum failure first degrades to
        fetching the spill from a peer replica's journal
        (`durable_sync.attempt_read_repair`) — the fetched bytes must
        match the SAME manifest sha256, are rewritten locally tmp+fsync+
        rename, and are served bit-identically.  A request never fails
        over corruption any replica can still repair; only when no peer
        holds a good copy does the pass fall back to re-execution."""
        entry = self._passes.get((int(level), int(part)))
        if entry is None:
            return None
        from .io import arrow_io

        # LRU clock, load-time half: `_open` freshens the manifest mtime
        # once, but under the SHARED fleet journal a long replay keeps
        # reading spills for minutes after its open — without periodic
        # re-freshening a concurrent replica's GC sees a stale clock and
        # evicts the hottest run first (throttled: one utime per
        # _FRESHEN_MIN_S, not per pass)
        self._freshen()
        path = os.path.join(self.dir, entry["file"])
        with obs_spans.span("durable.load", level=level, part=part):
            why = None
            try:
                with open(path, "rb") as fh:
                    payload = fh.read()
            except OSError as e:
                payload, why = None, f"unreadable spill: {e}"
            if (payload is not None
                    and hashlib.sha256(payload).hexdigest()
                    != entry["sha256"]):
                payload, why = None, "checksum mismatch (truncated/corrupt)"
            if payload is None:
                payload = self._read_repair(entry, why)
                if payload is None:
                    return self._reject(level, part, why)
            try:
                frame = arrow_io.frame_from_ipc_bytes(payload)
            except Exception as e:
                # a decode failure UNDER a passing checksum is a recorded
                # bad payload — a peer's copy would be the same bytes, so
                # repair cannot help; re-execute
                return self._reject(level, part,
                                    f"undecodable spill: "
                                    f"{type(e).__name__}: {e}")
        return frame, int(entry["rows"])

    def _read_repair(self, entry: dict, why: str) -> Optional[bytes]:
        """Fetch one bad spill's bytes from a peer journal (verified
        against OUR manifest sha256, rewritten locally) — None when no
        peer is registered or none holds a good copy.  Guarded: repair
        is an optimization over re-execution and must never raise."""
        try:
            from . import durable_sync
            return durable_sync.attempt_read_repair(
                self.dir, self.fingerprint, entry, why)
        except Exception as e:  # pragma: no cover - defensive
            log.warning("durable: read-repair attempt failed (%s: %s)",
                        type(e).__name__, e)
            return None

    def _freshen(self) -> None:
        now = time.monotonic()
        if now - self._freshened_at < _FRESHEN_MIN_S:
            return
        self._freshened_at = now
        with contextlib.suppress(OSError):
            os.utime(os.path.join(self.dir, MANIFEST))

    def _reject(self, level: int, part: int, why: str):
        self._passes.pop((int(level), int(part)), None)
        log.warning("durable: rejecting journaled pass L%d/P%d: %s "
                    "(the pass will re-execute)", level, part, why)
        obs_spans.instant("durable.spill_rejected", level=level, part=part,
                          reason=why)
        obs_metrics.counter_add("durable.spills_rejected")
        return None

    def pass_provenance(self, level: int, part: int) -> Optional[dict]:
        """The ``provenance`` dict a pass was recorded with, or None when
        the pass is absent or carried none.  Manifest-only (no spill
        read): the streaming layer's watermark replay and schema-version
        gate both decide from provenance before any decode."""
        entry = self._passes.get((int(level), int(part)))
        if entry is None:
            return None
        return entry.get("provenance")

    def parts_at_level(self, level: int) -> List[int]:
        """Sorted part ids journaled at ``level`` — the streaming
        layer's batch inventory (batch i == pass (0, i))."""
        return sorted(p for (lv, p) in self._passes if lv == int(level))

    # -- GC pinning (live stream state) -----------------------------------

    def pin(self) -> bool:
        """Exempt this run from ``gc_journal`` LRU eviction: write an
        fsync'd ``PINNED`` marker in the run dir.  Best-effort like
        every other journal write; True iff the marker is durable."""
        path = os.path.join(self.dir, PINNED)
        try:
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(json.dumps({"pid": os.getpid(),
                                     "fingerprint": self.fingerprint}) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError as e:
            log.warning("durable: cannot pin run %s (%s: %s)",
                        self.fingerprint[:12], type(e).__name__, e)
            return False
        return True

    def unpin(self) -> None:
        """Re-admit this run to LRU eviction (stream closed/retired)."""
        with contextlib.suppress(OSError):
            os.remove(os.path.join(self.dir, PINNED))

    def pinned(self) -> bool:
        return os.path.exists(os.path.join(self.dir, PINNED))

    # -- quarantine record ------------------------------------------------

    def record_quarantine(self, level: int, part: int, code: str,
                          msg: str) -> None:
        entry = {"kind": "quarantine", "level": int(level),
                 "part": int(part), "code": code, "msg": msg}
        self._quarantined.append(entry)
        try:
            self._append(entry)
        except OSError as e:
            log.warning("durable: quarantine record failed: %s", e)

    # -- run completion (the result-cache contract) -----------------------

    def record_done(self, passes: int, rows: int) -> None:
        """Mark the run complete: every pass the plan needed is journaled
        (the streaming loop finished with nothing remaining and nothing
        quarantined).  A complete journal IS a result-cache entry — a
        repeated fingerprint replays entirely from spill.  Best-effort
        like every other write here."""
        if self._spill_disabled or self._done is not None:
            return
        entry = {"kind": "done", "passes": int(passes), "rows": int(rows)}
        try:
            self._append(entry)
        except OSError as e:
            log.warning("durable: done record failed: %s", e)
            return
        self._done = entry

    def is_complete(self) -> bool:
        """True when a prior invocation recorded the run done — the
        serving layer's cheap cache-hit probe (spill checksums are still
        verified pass-by-pass at load time)."""
        return self._done is not None


def open_run(fingerprint: str, op: str, world: Optional[int] = None,
             epoch: Optional[int] = None) -> Optional[RunJournal]:
    """Module-level convenience over :meth:`RunJournal.open_run`."""
    return RunJournal.open_run(fingerprint, op, world=world, epoch=epoch)


def scan_runs(root: Optional[str] = None) -> List[dict]:
    """Inventory of the journal root for GC/cache introspection: one dict
    per run dir — ``fingerprint``, ``bytes`` (all files), ``mtime`` (the
    manifest's, the LRU clock), ``complete`` (a ``done`` manifest record
    exists), ``pinned`` (a ``PINNED`` marker exempts the run from LRU
    eviction) — sorted least-recently-used first.  Pure filesystem walk;
    unreadable entries are skipped (a racing eviction is not an error)."""
    root = durable_dir() if root is None else root
    out: List[dict] = []
    if not root or not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        manifest = os.path.join(d, MANIFEST)
        if not os.path.isdir(d):
            continue
        total = 0
        complete = False
        try:
            for fn in os.listdir(d):
                with contextlib.suppress(OSError):
                    total += os.path.getsize(os.path.join(d, fn))
            mtime = os.path.getmtime(manifest) if os.path.exists(manifest) \
                else os.path.getmtime(d)
            if os.path.exists(manifest):
                with open(manifest, "r", encoding="utf-8") as fh:
                    for raw in fh:
                        try:
                            if json.loads(raw).get("kind") == "done":
                                complete = True
                        except ValueError:
                            break
        except OSError:
            continue
        out.append({"fingerprint": name, "dir": d, "bytes": total,
                    "mtime": mtime, "complete": complete,
                    "pinned": os.path.exists(os.path.join(d, PINNED))})
    out.sort(key=lambda r: (r["mtime"], r["fingerprint"]))
    return out


def read_manifest(d: str) -> Optional[dict]:
    """Structured, integrity-aware parse of one run dir's manifest (the
    scrubber's view — `RunJournal._open` keeps its own minimal replay):
    ``header`` / ``passes`` ({(level, part): entry}) / ``done`` /
    ``quarantined``, plus two corruption classifications the replay
    deliberately conflates:

    - ``torn_tail`` — the LAST line(s) fail to parse with nothing
      parseable after them: the expected shape of a crash mid-append,
      clean by contract (everything before the tear stands).
    - ``midline_corrupt`` — an unparseable line FOLLOWED by parseable
      lines: impossible under the fsync'd append-only discipline, so it
      is bitrot inside committed history; entries after the bad line
      cannot be trusted to be complete and the run must quarantine.

    None when the dir has no readable manifest at all."""
    path = os.path.join(d, MANIFEST)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw_lines = fh.read().splitlines()
    except OSError:
        return None
    out = {"header": None, "passes": {}, "done": None, "quarantined": [],
           "torn_tail": False, "midline_corrupt": False,
           "lines": len(raw_lines)}
    bad_seen = False
    for raw in raw_lines:
        try:
            entry = json.loads(raw)
            if not isinstance(entry, dict):
                raise ValueError("manifest line is not an object")
        except ValueError:
            bad_seen = True
            out["torn_tail"] = True
            continue
        if bad_seen:
            # a good line after a bad one: committed history was torn
            out["midline_corrupt"] = True
            out["torn_tail"] = False
            break
        kind = entry.get("kind")
        if kind == "run":
            out["header"] = entry
        elif kind == "pass":
            try:
                out["passes"][(int(entry["level"]),
                               int(entry["part"]))] = entry
            except (KeyError, TypeError, ValueError):
                out["midline_corrupt"] = True
                break
        elif kind == "quarantine":
            out["quarantined"].append(entry)
        elif kind == "done":
            out["done"] = entry
    return out


# run-digest cache: dir -> ((manifest mtime_ns, size), digest record).
# The digest is pure manifest content, so the (mtime, size) pair is a
# sound invalidation key under the fsync'd append-only discipline.
_DIGEST_CACHE: Dict[str, Tuple[Tuple[int, int], dict]] = {}
_DIGEST_CACHE_MAX = 4096


def run_digest(d: str) -> Optional[dict]:
    """Replication identity of one run dir, from the manifest ALONE (no
    spill reads — this runs on every heartbeat): ``digest`` folds the
    sorted (file, sha256) pass pairs plus the done flag, so two roots
    agree on a digest exactly when they hold the same committed content.
    Also carries ``complete`` / ``pinned`` / ``passes`` for the
    coordinator's placement math.  None for unreadable or header-less
    dirs (a mid-sync run not yet visible — by design)."""
    path = os.path.join(d, MANIFEST)
    try:
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None
    cached = _DIGEST_CACHE.get(d)
    if cached is not None and cached[0] == key:
        rec = dict(cached[1])
        rec["pinned"] = os.path.exists(os.path.join(d, PINNED))
        return rec
    m = read_manifest(d)
    if m is None or m["header"] is None:
        return None
    h = hashlib.sha256()
    for (level, part), entry in sorted(m["passes"].items()):
        h.update(f"{level}:{part}:{entry.get('file')}:"
                 f"{entry.get('sha256')}\n".encode())
    h.update(b"done" if m["done"] is not None else b"open")
    rec = {"digest": h.hexdigest(),
           "complete": m["done"] is not None,
           "passes": len(m["passes"]),
           "bytes": sum(int(e.get("bytes", 0))
                        for e in m["passes"].values())}
    if len(_DIGEST_CACHE) >= _DIGEST_CACHE_MAX:
        _DIGEST_CACHE.clear()
    _DIGEST_CACHE[d] = (key, dict(rec))
    rec["pinned"] = os.path.exists(os.path.join(d, PINNED))
    return rec


def journal_digests(root: Optional[str] = None, cap: int = 512) -> Dict[str, dict]:
    """Per-run digests for heartbeat advertisement: fingerprint ->
    :func:`run_digest` record, most-recently-used runs first when the
    root holds more than ``cap`` (the hot runs are the ones worth
    replicating first; the rest ride later beats as the set churns)."""
    root = durable_dir() if root is None else root
    runs = scan_runs(root)
    out: Dict[str, dict] = {}
    for r in reversed(runs):  # scan_runs sorts LRU-first; advertise MRU
        if len(out) >= max(1, int(cap)):
            break
        rec = run_digest(r["dir"])
        if rec is not None:
            out[r["fingerprint"]] = rec
    return out


def _evict_run_dir(d: str) -> None:
    """Remove one run dir MANIFEST-LAST: spills go first, the manifest
    after them, the dir itself at the end.  A crash (or a concurrent
    reader) at any point sees either a manifest whose spills fail their
    checksums — so the affected passes simply re-execute — or no
    manifest at all; never a torn journal served as a result."""
    names = []
    with contextlib.suppress(OSError):
        names = os.listdir(d)
    for fn in sorted(names):
        if fn != MANIFEST:
            with contextlib.suppress(OSError):
                os.remove(os.path.join(d, fn))
    with contextlib.suppress(OSError):
        os.remove(os.path.join(d, MANIFEST))
    with contextlib.suppress(OSError):
        os.rmdir(d)


def _acquire_gc_lease(root: str) -> Optional[str]:
    """Advisory cross-process walker lease over ``root`` — delegated to
    the shared stdlib-only implementation in :mod:`durable_lease` (GC,
    scrubber and fsck exclude each other through ONE lease).  Returns the lease path, or None when another
    walker holds a lease younger than the TTL (counted
    ``durable.gc_lease_busy``)."""
    return durable_lease.acquire_lease(
        root, ttl_s=_GC_LEASE_TTL_S,
        on_busy=lambda: obs_metrics.counter_add("durable.gc_lease_busy"))


def _release_gc_lease(path: str) -> None:
    durable_lease.release_lease(path)


# fingerprint -> bool guard installed by the replication syncer:
# True means the coordinator still counts OUR copy of this run toward
# CYLON_TPU_DURABLE_RF (holders <= RF), so LRU-evicting it here would
# silently drop the fleet below its replication target on a peer-less
# (or not-yet-caught-up) fleet.  None (default, and whenever no fleet
# syncer is attached) leaves the GC as it is without replication.
_REPLICATION_GUARD = None


def set_gc_replication_guard(fn) -> None:
    """Install (or clear, with None) the fingerprint->bool guard
    ``gc_journal`` consults before evicting a run (see
    ``_REPLICATION_GUARD``).  Called by `durable_sync.JournalSyncer` from
    heartbeat replies; the guard must be cheap and non-raising."""
    global _REPLICATION_GUARD
    _REPLICATION_GUARD = fn


def gc_journal(root: Optional[str] = None,
               cap: Optional[int] = None) -> Tuple[int, int]:
    """Size-cap LRU eviction over the journal root: whole runs are
    evicted least-recently-used first until total bytes fit under
    ``CYLON_TPU_DURABLE_CAP_BYTES`` (or ``cap``).  Returns
    ``(runs_evicted, bytes_freed)``; (0, 0) when no cap is set, the root
    is unused, everything already fits, or another replica's GC holds
    the advisory lease.  The currently-open journal (an in-flight run)
    is never evicted from under its own writer.

    Fleet discipline (every replica GCs the SHARED root concurrently):
    destructive eviction runs only under the ``GC_LOCK`` lease, and each
    victim's manifest mtime is RE-READ immediately before eviction — the
    CoordLog ownership-re-read pattern — so a run that a third replica
    opened or replayed (freshening its LRU clock) after our scan is
    skipped this round instead of half-evicted under a reader.  A
    ``PINNED`` marker (live stream state) is likewise re-checked
    per victim UNDER the lease: a pinned run is never evicted no matter
    how cold its LRU clock (``durable.gc_skipped_pinned``)."""
    root = durable_dir() if root is None else root
    cap = cap_bytes() if cap is None else max(0, int(cap))
    if not root or cap <= 0:
        return 0, 0
    runs = scan_runs(root)
    total = sum(r["bytes"] for r in runs)
    if total <= cap:
        return 0, 0
    lease = _acquire_gc_lease(root)
    if lease is None:
        return 0, 0
    live = _LAST_JOURNAL.dir if _LAST_JOURNAL is not None else None
    evicted = 0
    freed = 0
    try:
        for r in runs:
            if total - freed <= cap:
                break
            if r["dir"] == live:
                continue
            if os.path.exists(os.path.join(r["dir"], PINNED)):
                # re-checked under the lease, not trusted from the scan:
                # a stream that pinned its state after our inventory
                # must still survive this sweep
                obs_metrics.counter_add("durable.gc_skipped_pinned")
                continue
            guard = _REPLICATION_GUARD
            if guard is not None and guard(r["fingerprint"]):
                # the coordinator still counts our copy toward
                # CYLON_TPU_DURABLE_RF: evicting it would silently drop
                # the fleet below its replication target
                obs_metrics.counter_add("durable.gc_skipped_replication")
                continue
            manifest = os.path.join(r["dir"], MANIFEST)
            try:
                now_mtime = os.path.getmtime(manifest)
            except OSError:
                now_mtime = None  # already gone — nothing left to tear
            if now_mtime is not None and now_mtime > r["mtime"] + 1e-6:
                # freshened since our scan: a replica is using this run
                obs_metrics.counter_add("durable.gc_skipped_fresh")
                continue
            _evict_run_dir(r["dir"])
            evicted += 1
            freed += r["bytes"]
            obs_spans.instant("durable.gc_evict",
                              fingerprint=r["fingerprint"],
                              bytes=r["bytes"], complete=r["complete"])
    finally:
        _release_gc_lease(lease)
    if evicted:
        obs_metrics.counter_add("durable.gc_runs_evicted", evicted)
        obs_metrics.counter_add("durable.gc_bytes_freed", freed)
        log.info("durable: GC evicted %d run(s), %d bytes (cap %d)",
                 evicted, freed, cap)
    return evicted, freed


def _evict_last_run_spills() -> None:
    """Test hook behind the ``cache_evict_race`` fault kind: delete the
    most recently opened run's SPILL files while keeping its manifest —
    the exact window a concurrent GC eviction exposes to a reader that
    already replayed the manifest.  Every load then fails (missing
    spill) and the pass re-executes; the run must still complete."""
    j = _LAST_JOURNAL
    if j is None or not os.path.isdir(j.dir):
        return
    n = 0
    for fn in sorted(os.listdir(j.dir)):
        if fn != MANIFEST:
            with contextlib.suppress(OSError):
                os.remove(os.path.join(j.dir, fn))
                n += 1
    log.warning("durable: injected evict race removed %d spill(s) under %s",
                n, j.dir)


def _corrupt_last_spill() -> None:
    """Test hook behind the ``journal_corrupt`` fault kind: truncate the
    most recently committed spill to half its size, so its manifest
    checksum no longer matches — the corruption a resume must reject."""
    j = _LAST_JOURNAL
    path = j._last_committed if j is not None else None
    if path is None or not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)
    log.warning("durable: injected corruption truncated %s to %d bytes",
                path, size // 2)


def _bitrot_last_run(hit: int = 0) -> None:  # cylint: disable=CY117 -- deliberate fault injector: flips a spill byte to MANUFACTURE the bitrot CY117 guards against; verifying a checksum here would defeat the test hook
    """Test hook behind the ``bitrot`` fault kind: XOR-flip ONE
    mid-file byte of a committed spill in the most recently opened run —
    the silent-decay failure the scrubber and read-repair exist to catch
    (vs ``journal_corrupt``'s blunt truncation).  The victim spill is
    chosen deterministically from the fault hit counter so subprocess
    chaos tests replay identically."""
    j = _LAST_JOURNAL
    if j is None or not os.path.isdir(j.dir):
        return
    spills = sorted(fn for fn in os.listdir(j.dir) if fn.endswith(".arrow"))
    if not spills:
        return
    victim = os.path.join(
        j.dir, spills[(int(hit) * 2654435761) % len(spills)])
    try:
        size = os.path.getsize(victim)
        if size == 0:
            return
        with open(victim, "r+b") as fh:
            fh.seek(size // 2)
            b = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([b[0] ^ 0xFF]))
            fh.flush()
            os.fsync(fh.fileno())
    except OSError:
        return
    log.warning("durable: injected bitrot flipped byte %d of %s",
                size // 2, victim)


# ---------------------------------------------------------------------------
# pass deadlines
# ---------------------------------------------------------------------------

class _NullDeadline:
    __slots__ = ()

    def __enter__(self) -> "_NullDeadline":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def raise_if_fired(self) -> None:
        return None

    def accept_late(self) -> None:
        return None


_NULL_DEADLINE = _NullDeadline()


class PassDeadline:
    """Watchdog for one pass: a timer thread fires ``deadline.fired``
    (obs instant + metric) the moment ``seconds`` elapses — real-time
    visibility even while the main thread is wedged in a native call —
    and :meth:`raise_if_fired` classifies the overrun as `Code.Timeout`,
    which the streaming loop retries like any transient.

    The raise is deliberately NOT in ``__exit__``: the caller decides
    between :meth:`raise_if_fired` (after journaling the late-but-correct
    frame, so the Timeout retry serves it from the journal instead of
    re-executing an identically-slow pass forever) and
    :meth:`accept_late` (no journal to serve the retry from — keep the
    completed frame, record the overrun, and move on; discarding it
    would condemn every consistently-slow pass to retry-until-fatal).
    Either way a late result is never lost work.  An exception already
    in flight wins over the deadline (its own classification is more
    specific than "late")."""

    def __init__(self, seconds: float, site: str):
        self.seconds = seconds
        self.site = site
        self.fired = threading.Event()
        self._timer: Optional[threading.Timer] = None
        self._trace: Optional[tracectx.TraceContext] = None

    def _fire(self) -> None:
        self.fired.set()
        with tracectx.activate(self._trace):
            obs_spans.instant("deadline.fired", site=self.site,
                              deadline_s=self.seconds)
        obs_metrics.counter_add("deadline.fired")
        log.warning("durable: pass deadline %.3fs exceeded at %s "
                    "(CYLON_TPU_PASS_DEADLINE_S)", self.seconds, self.site)

    def __enter__(self) -> "PassDeadline":
        # the request trace active on the ARMING thread, captured at
        # __enter__ (serve constructs the deadline BEFORE activating the
        # ticket's context): the watchdog fires on its own timer thread
        # (fresh contextvar state), so without this capture the terminal
        # `deadline.fired` instant could never be joined to the request
        # whose budget it killed
        self._trace = tracectx.current()
        self._timer = threading.Timer(self.seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._timer is not None:
            self._timer.cancel()
        return False

    def raise_if_fired(self) -> None:
        """Classify a recorded overrun as `Code.Timeout` (call after the
        block — and after journaling any completed frame)."""
        if self.fired.is_set():
            raise CylonError(
                Code.Timeout,
                f"pass exceeded CYLON_TPU_PASS_DEADLINE_S="
                f"{self.seconds:g}s at {self.site}")

    def accept_late(self) -> None:
        """Keep a late-but-complete result: record the overrun (instant +
        metric) without raising — the path for work that is NOT journaled
        and would otherwise be discarded just to re-run identically."""
        if self.fired.is_set():
            obs_spans.instant("deadline.accepted_late", site=self.site,
                              deadline_s=self.seconds)
            obs_metrics.counter_add("deadline.accepted_late")
            log.warning("durable: pass exceeded its %.3fs deadline but "
                        "completed and is not journaled; keeping the late "
                        "result at %s", self.seconds, self.site)


def pass_deadline(site: str = "exec.pass"):
    """Armed :class:`PassDeadline` when ``CYLON_TPU_PASS_DEADLINE_S`` is
    set, else a shared no-op context (zero allocation on the hot path)."""
    s = deadline_s()
    if s <= 0:
        return _NULL_DEADLINE
    return PassDeadline(s, site)
