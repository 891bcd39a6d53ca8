"""Self-healing durable journal: integrity scrubbing, read-repair,
anti-entropy replication and disaster recovery.

The port of ``cylon_tpu/durable_sync.py``, over the port's own transport
(``net/control.py``) and wire codec (``router/wire.py``).  Three
cooperating mechanisms, all host-side:

- **scrubbing** (:func:`scrub_once`, :class:`Scrubber`): a walk over
  `durable.scan_runs` re-verifying every committed spill's sha256 and the
  manifest's structural integrity UNDER the shared walker lease
  (``durable_lease``: the lease GC and ``tools/journal_fsck.py`` take, so
  destructive passes exclude each other).  Findings classify three ways:
  *repairable* (a peer holds a good copy: fetched, verified, rewritten in
  place), *quarantined* (no good copy anywhere: the run is evicted
  manifest-LAST and simply re-executes), *torn* (the legal crash shapes:
  a torn manifest tail, an orphan dir from a sync killed mid-copy; clean
  by contract, reported not repaired).

- **read-repair** (:func:`attempt_read_repair`, called from
  `RunJournal.load_pass`): a checksum failure on the serving path
  degrades to fetching the spill from a peer's journal over the
  checksum-verified blob verb, rewriting it locally tmp+fsync+rename,
  and serving bit-identically.  The fetched bytes must match the LOCAL
  manifest's sha256: a diverged peer is refused as loudly as a torn
  transfer (``wire.blob_from_b64``'s two-digest contract).

- **anti-entropy replication** (:class:`JournalPeerServer`,
  :class:`JournalSyncer`, :func:`pull_run`): each replica advertises
  per-run manifest digests (:meth:`JournalSyncer.telemetry`); a
  coordinator diffs them against ``CYLON_TPU_DURABLE_RF`` and hands
  under-replicated fingerprints back in its heartbeat replies, which
  :meth:`JournalSyncer.on_heartbeat` takes as plain JSON (the coordinator
  itself is ROADMAP.md queue A item 11b's ``elastic.Coordinator``).  The
  syncer pulls whole runs, every spill first (each verified against the
  peer manifest's sha256) and the manifest LAST via atomic rename, so a
  sync killed at ANY point (fault kind ``sync_partial``) leaves no
  visible run, only an orphan dir the next pull overwrites.  PINNED runs
  sync at priority.  :func:`journal_restore` points an EMPTY root at its
  peers and rebuilds it into a serving journal.

Replication and repair never change a fingerprint or a served byte:
pulls copy spills verbatim (digest-checked end to end) and repair only
installs bytes matching the local manifest's recorded sha256.  With the
scrubber off and no peers registered, nothing here runs.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import durable
from . import durable_lease
from . import resilience
from .net import control
from .obs import fleet as obs_fleet
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .router import wire
from .status import Code, CylonError

log = logging.getLogger("cylon_tpu_torch")

#: per-file injection probe for the replication pull path: `sync_partial`
#: (os._exit mid-copy) armed here proves the manifest-LAST order makes a
#: half-pulled run invisible
SYNC_FAULT_SITE = "journal_sync_file"

#: verb timeout for peer journal fetches (data plane: whole spills)
_FETCH_TIMEOUT_S = 30.0


def _data_max_line() -> int:
    """Wire cap for one journal blob message: the data-plane cap
    (``CYLON_TPU_ROUTER_MAX_LINE_BYTES``)."""
    return wire.router_max_line()


# ---------------------------------------------------------------------------
# peer registry (read-repair's fetch targets)
# ---------------------------------------------------------------------------

_PEERS_LOCK = threading.Lock()
_PEERS: Tuple[Tuple[str, int], ...] = ()


def set_peers(addrs: Sequence[Sequence]) -> None:
    """Install the peer journal endpoints read-repair may fetch from
    (the syncer refreshes this from every heartbeat reply; () clears)."""
    global _PEERS
    cleaned = tuple((str(a[0]), int(a[1])) for a in addrs)
    with _PEERS_LOCK:
        _PEERS = cleaned


def peers() -> Tuple[Tuple[str, int], ...]:
    with _PEERS_LOCK:
        return _PEERS


# ---------------------------------------------------------------------------
# peer data-plane server (verbs over net/control.py framing)
# ---------------------------------------------------------------------------

def _safe_name(s) -> Optional[str]:
    """One path component, no traversal, no empties — the only names the
    peer verbs accept (fingerprints are hex, spill names are flat)."""
    s = str(s)
    if not s or s in (".", "..") or os.path.basename(s) != s:
        return None
    return s


class JournalPeerServer:
    """Read-only data-plane server over one journal root: peers (and the
    offline fsck's ``--repair-from``) fetch manifests and spill bytes by
    fingerprint.  Three verbs, one JSON line each (net/control framing,
    data-plane line cap):

    - ``journal_runs``                      -> per-run digest inventory
    - ``journal_manifest {fingerprint}``    -> manifest blob + file list
    - ``journal_fetch {fingerprint, file}`` -> one file's verified blob

    Read-ONLY by design: replication is pull-based (each replica owns
    its root's writes), so serving bytes can never corrupt the server's
    journal, and a malicious/confused peer can at worst read what the
    shared cache already shares."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.root = root
        self._server = control.JsonServer(self._handle, host=host,
                                          port=port,
                                          max_line=_data_max_line())
        self.address: Tuple[str, int] = self._server.address
        self._server.start()

    def close(self) -> None:
        self._server.close()

    # -- verb dispatch ----------------------------------------------------

    def _handle(self, req: Dict) -> Dict:
        cmd = req.get("cmd")
        try:
            if cmd == "journal_runs":
                return {"ok": True,
                        "runs": durable.journal_digests(self.root)}
            if cmd == "journal_manifest":
                return self._manifest(req)
            if cmd == "journal_fetch":
                return self._fetch(req)
            raise CylonError(Code.Invalid,
                             f"unknown journal verb {cmd!r}")
        except CylonError as e:
            return {"ok": False, "error": wire.classified(e)}
        except OSError as e:
            return {"ok": False, "error": wire.classified(CylonError(
                Code.IOError, f"journal read failed: "
                              f"{type(e).__name__}: {e}"))}

    def _run_dir(self, req: Dict) -> str:
        fp = _safe_name(req.get("fingerprint"))
        if fp is None:
            raise CylonError(Code.Invalid,
                             f"bad fingerprint {req.get('fingerprint')!r}")
        d = os.path.join(self.root, fp)
        if not os.path.isdir(d):
            raise CylonError(Code.KeyError,
                             f"no journaled run {fp[:12]} on this peer")
        return d

    def _manifest(self, req: Dict) -> Dict:
        d = self._run_dir(req)
        m = durable.read_manifest(d)
        if m is None:
            raise CylonError(Code.KeyError,
                             "run dir holds no readable manifest "
                             "(mid-sync orphan — not a run yet)")
        if m["midline_corrupt"]:
            # never replicate corruption: a manifest torn INSIDE its
            # committed history is this peer's problem, not a template
            raise CylonError(Code.IOError,
                             "manifest corrupt on this peer (mid-line); "
                             "refusing to serve it for replication")
        with open(os.path.join(d, durable.MANIFEST), "rb") as fh:
            raw = fh.read()
        files = [{"file": e["file"], "sha256": e["sha256"],
                  "bytes": int(e.get("bytes", 0))}
                 for e in m["passes"].values()]
        return {"ok": True, "manifest": wire.blob_b64(raw),
                "files": sorted(files, key=lambda f: f["file"]),
                "complete": m["done"] is not None,
                "pinned": os.path.exists(os.path.join(d, durable.PINNED))}

    def _fetch(self, req: Dict) -> Dict:
        d = self._run_dir(req)
        name = _safe_name(req.get("file"))
        if name is None or name == durable_lease.GC_LOCK:
            raise CylonError(Code.Invalid, f"bad file {req.get('file')!r}")
        path = os.path.join(d, name)
        if not os.path.isfile(path):
            raise CylonError(Code.KeyError,
                             f"no spill {name!r} in run "
                             f"{req.get('fingerprint')!r:.14}")
        with open(path, "rb") as fh:
            data = fh.read()
        return {"ok": True, **wire.blob_b64(data)}


def _verb(addr, obj: Dict, timeout: float = _FETCH_TIMEOUT_S) -> Dict:
    """One peer-journal verb round trip; protocol-level failures re-raise
    classified."""
    resp = control.request((str(addr[0]), int(addr[1])), obj,
                           timeout=timeout, retries=1,
                           max_line=_data_max_line())
    if not resp.get("ok"):
        err = resp.get("error")
        if isinstance(err, dict):
            raise wire.classified_error(err)
        raise CylonError(Code.Unavailable,
                         f"journal peer refused {obj.get('cmd')!r}: {err}")
    return resp


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + atomic rename — the journal's one write discipline,
    reused for every byte replication installs."""
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


# ---------------------------------------------------------------------------
# read-repair (the load_pass degradation path)
# ---------------------------------------------------------------------------

def fetch_spill(addr, fingerprint: str, file: str,
                expect_sha: Optional[str] = None) -> bytes:
    """One spill's bytes from a peer, digest-verified (transfer AND —
    when given — against the caller's own manifest expectation)."""
    resp = _verb(addr, {"cmd": "journal_fetch", "fingerprint": fingerprint,
                        "file": file})
    return wire.blob_from_b64(resp, expect_sha=expect_sha)


def attempt_read_repair(run_dir: str, fingerprint: str, entry: Dict,
                        why: str) -> Optional[bytes]:
    """Heal one bad local spill from the first peer holding a good copy:
    fetch, verify against the LOCAL manifest's sha256, rewrite in place
    (tmp+fsync+rename), return the verified bytes for the caller to
    serve bit-identically.  None when no registered peer can help — the
    caller then drops the record and the pass re-executes.  Never raises:
    repair is an optimization."""
    targets = peers()
    if not targets:
        return None
    name, want = entry.get("file"), entry.get("sha256")
    obs_fleet.flight_record("journal.corruption", fingerprint=fingerprint,
                            file=name, why=why)
    with obs_spans.span("durable.read_repair", fingerprint=fingerprint[:12],
                        file=name):
        for addr in targets:
            try:
                data = fetch_spill(addr, fingerprint, name, expect_sha=want)
            except Exception as e:
                log.info("durable: read-repair fetch of %s/%s from %s "
                         "failed (%s: %s)", fingerprint[:12], name, addr,
                         type(e).__name__, e)
                continue
            try:
                _atomic_write(os.path.join(run_dir, name), data)
            except OSError as e:
                # the verified bytes still serve this request; only the
                # local heal failed (disk trouble — the scrubber retries)
                log.warning("durable: read-repair rewrite of %s failed "
                            "(%s: %s); serving fetched bytes unpersisted",
                            name, type(e).__name__, e)
            obs_metrics.counter_add("durable.read_repair")
            obs_spans.instant("durable.read_repair", file=name,
                              fingerprint=fingerprint[:12],
                              peer=f"{addr[0]}:{addr[1]}", why=why)
            log.warning("durable: read-repaired %s/%s from peer %s:%s (%s)",
                        fingerprint[:12], name, addr[0], addr[1], why)
            return data
    obs_metrics.counter_add("durable.read_repair_failed")
    return None


# ---------------------------------------------------------------------------
# anti-entropy pulls + disaster recovery
# ---------------------------------------------------------------------------

def pull_run(addr, root: str, fingerprint: str) -> bool:
    """Replicate one whole run from a peer into ``root``: every spill
    first (each digest-verified, atomically renamed), the ``PINNED``
    marker next when the peer pins it, the manifest LAST — so a pull
    killed at ANY point (``sync_partial``) leaves a manifest-less orphan
    dir that is not a run, serves nothing, and is simply overwritten by
    the next pull.  False when the run already exists locally (pulls
    never clobber a journal that has its own history).  Bytes land
    verbatim — the fingerprint, every spill and the manifest are
    bit-identical to the peer's by construction."""
    fp = _safe_name(fingerprint)
    if fp is None:
        raise CylonError(Code.Invalid, f"bad fingerprint {fingerprint!r}")
    dest = os.path.join(root, fp)
    if os.path.exists(os.path.join(dest, durable.MANIFEST)):
        return False
    with obs_spans.span("durable.sync_pull", fingerprint=fp[:12]):
        resp = _verb(addr, {"cmd": "journal_manifest", "fingerprint": fp})
        manifest_bytes = wire.blob_from_b64(resp["manifest"])
        os.makedirs(dest, exist_ok=True)
        pulled_bytes = 0
        for f in resp.get("files", ()):
            resilience.fault_point(SYNC_FAULT_SITE)
            data = fetch_spill(addr, fp, f["file"], expect_sha=f["sha256"])
            _atomic_write(os.path.join(dest, str(f["file"])), data)
            pulled_bytes += len(data)
        if resp.get("pinned"):
            # pin BEFORE the manifest: the instant the run becomes
            # visible it is already exempt from LRU eviction
            _atomic_write(os.path.join(dest, durable.PINNED), b"{}\n")
        resilience.fault_point(SYNC_FAULT_SITE)
        _atomic_write(os.path.join(dest, durable.MANIFEST), manifest_bytes)
    obs_metrics.counter_add("durable.sync_runs_pulled")
    obs_metrics.counter_add("durable.sync_bytes_pulled",
                            pulled_bytes + len(manifest_bytes))
    log.info("durable: pulled run %s (%d bytes) from peer %s:%s",
             fp[:12], pulled_bytes, addr[0], addr[1])
    return True


def journal_restore(root: str, peer_addrs: Sequence[Sequence]) -> Dict:
    """Disaster recovery: rebuild ``root`` (typically empty — a lost
    disk, a fresh replica) from peer journals.  Pulls every complete or
    pinned run each peer advertises, pinned stream-state first; runs the
    root already holds are left untouched.  The restored root serves
    journal hits at once (``plan.cache_hit``, skipped passes)."""
    os.makedirs(root, exist_ok=True)
    stats = {"pulled": 0, "bytes": 0, "skipped": 0, "failed": 0}
    for addr in peer_addrs:
        try:
            runs = _verb(addr, {"cmd": "journal_runs"}).get("runs", {})
        except Exception as e:
            log.warning("durable: restore cannot inventory peer %s "
                        "(%s: %s)", addr, type(e).__name__, e)
            stats["failed"] += 1
            continue
        order = sorted(runs.items(),
                       key=lambda kv: (not kv[1].get("pinned"),
                                       kv[0]))
        for fp, rec in order:
            if not (rec.get("complete") or rec.get("pinned")):
                continue
            try:
                if pull_run(addr, root, fp):
                    stats["pulled"] += 1
                    stats["bytes"] += int(rec.get("bytes", 0))
                else:
                    stats["skipped"] += 1
            except Exception as e:
                stats["failed"] += 1
                log.warning("durable: restore pull of %s from %s failed "
                            "(%s: %s)", fp[:12], addr,
                            type(e).__name__, e)
    obs_spans.instant("durable.restore", **stats)
    log.info("durable: journal_restore pulled %d run(s) into %r (%d "
             "skipped, %d failed)", stats["pulled"], root,
             stats["skipped"], stats["failed"])
    return stats


# ---------------------------------------------------------------------------
# the scrubber
# ---------------------------------------------------------------------------

def _verify_entry(run_dir: str, entry: Dict) -> Optional[str]:
    """None when the spill matches its manifest sha256, else a reason."""
    path = os.path.join(run_dir, str(entry.get("file")))
    h = hashlib.sha256()
    try:
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    except OSError as e:
        return f"unreadable spill: {type(e).__name__}: {e}"
    if h.hexdigest() != entry.get("sha256"):
        return "checksum mismatch (bitrot/truncation)"
    return None


def scrub_once(root: Optional[str] = None, repair: bool = True) -> Dict:
    """One full integrity pass over the journal root, under the shared
    walker lease.  Re-verifies every committed spill's sha256 against
    its manifest and classifies every finding (module docstring); a
    busy lease skips the round cleanly (``skipped_busy`` — the GC or a
    peer's scrub is walking; corruption waits one interval).

    Classification per run:

    - manifest-less dir         -> ``orphans`` (a sync killed mid-copy;
      clean by contract, the next pull overwrites it)
    - torn manifest tail        -> ``torn`` (legal crash shape; entries
      before the tear are verified like any others)
    - mid-line manifest damage / foreign-fingerprint header
                                -> quarantine (committed history is
      untrustworthy; manifest-LAST eviction, the run re-executes)
    - bad spill, peer good copy -> repaired in place (bit-identical)
    - bad spill, no good copy   -> quarantine; for PINNED runs the run
      is left standing (never evict live stream state — the corrupt
      pass re-executes via load-time rejection) but counted corrupt

    Quarantine honors the GC's victim discipline: the manifest mtime
    is re-read UNDER the lease and a freshened run is skipped this
    round (a live reader/writer is on it)."""
    root = durable.durable_dir() if root is None else root
    stats = {"runs": 0, "checked": 0, "corrupt": 0, "repaired": 0,
             "quarantined": 0, "torn": 0, "orphans": 0,
             "skipped_busy": 0, "skipped_live": 0, "skipped_fresh": 0}
    if not root or not os.path.isdir(root):
        return stats
    lease = durable_lease.acquire_lease(
        root, on_busy=lambda: obs_metrics.counter_add(
            "durable.scrub_lease_busy"))
    if lease is None:
        stats["skipped_busy"] = 1
        return stats
    try:
        live = (durable._LAST_JOURNAL.dir
                if durable._LAST_JOURNAL is not None else None)
        for r in durable.scan_runs(root):
            if r["dir"] == live:
                # never scrub under our own writer: its uncommitted
                # tail looks exactly like damage
                stats["skipped_live"] += 1
                continue
            stats["runs"] += 1
            obs_metrics.counter_add("durable.scrub_runs")
            m = durable.read_manifest(r["dir"])
            if m is None:
                stats["orphans"] += 1
                continue
            header_fp = (m["header"] or {}).get("fingerprint")
            structural = None
            if m["midline_corrupt"]:
                structural = "manifest corrupt mid-line"
            elif m["header"] is not None \
                    and header_fp != r["fingerprint"]:
                structural = (f"manifest records foreign fingerprint "
                              f"{str(header_fp)[:12]!r}")
            if m["torn_tail"]:
                stats["torn"] += 1
            bad_entries = []
            if structural is None:
                for key in sorted(m["passes"]):
                    entry = m["passes"][key]
                    stats["checked"] += 1
                    why = _verify_entry(r["dir"], entry)
                    if why is not None:
                        bad_entries.append((entry, why))
            if structural is None and not bad_entries:
                continue
            stats["corrupt"] += 1
            obs_metrics.counter_add("durable.scrub_corrupt")
            obs_fleet.flight_record(
                "journal.scrub_corruption", fingerprint=r["fingerprint"],
                structural=structural,
                bad=[{"file": e.get("file"), "why": w}
                     for e, w in bad_entries[:8]])
            healed = 0
            if repair and structural is None and peers():
                for entry, why in bad_entries:
                    data = attempt_read_repair(
                        r["dir"], r["fingerprint"], entry,
                        f"scrub: {why}")
                    if data is not None:
                        healed += 1
            if structural is None and healed == len(bad_entries):
                stats["repaired"] += 1
                obs_metrics.counter_add("durable.scrub_repaired")
                continue
            # unrepairable -> quarantine (PINNED runs stand: live stream
            # state is never evicted; its bad passes re-execute at load)
            if os.path.exists(os.path.join(r["dir"], durable.PINNED)):
                log.warning("durable: scrub found unrepairable damage in "
                            "PINNED run %s (%s); leaving it for load-time "
                            "re-execution", r["fingerprint"][:12],
                            structural or f"{len(bad_entries)} bad spills")
                continue
            manifest = os.path.join(r["dir"], durable.MANIFEST)
            try:
                now_mtime = os.path.getmtime(manifest)
            except OSError:
                now_mtime = None
            if now_mtime is not None and now_mtime > r["mtime"] + 1e-6:
                # freshened since the scan: someone is replaying it;
                # their loads reject bad spills themselves — next round
                stats["skipped_fresh"] += 1
                continue
            durable._evict_run_dir(r["dir"])
            stats["quarantined"] += 1
            obs_metrics.counter_add("durable.scrub_quarantined")
            obs_spans.instant("durable.scrub_quarantine",
                              fingerprint=r["fingerprint"],
                              reason=structural
                              or f"{len(bad_entries)} unrepairable "
                                 f"spill(s)")
            log.warning("durable: scrub quarantined run %s (%s); it will "
                        "re-execute", r["fingerprint"][:12],
                        structural or f"{len(bad_entries)} bad spill(s)")
    finally:
        durable_lease.release_lease(lease)
    return stats


class Scrubber:
    """Background scrub thread: one :func:`scrub_once` every
    ``CYLON_TPU_SCRUB_S`` seconds (constructor override for tests).
    Guarded — a scrub failure is logged and the cadence continues; the
    scrubber must never take down the replica it protects."""

    def __init__(self, root: Optional[str] = None,
                 interval_s: Optional[float] = None):
        self.root = durable.durable_dir() if root is None else root
        self.interval_s = (durable.scrub_interval_s()
                           if interval_s is None else float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cylon-journal-scrub")

    def start(self) -> "Scrubber":
        if self.interval_s > 0:
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                scrub_once(self.root)
            except Exception as e:  # pragma: no cover - defensive
                log.warning("durable: scrub round failed (%s: %s)",
                            type(e).__name__, e)


# ---------------------------------------------------------------------------
# the per-replica syncer (heartbeat-driven)
# ---------------------------------------------------------------------------

class JournalSyncer:
    """Consumes a coordinator's journal fields from heartbeat replies
    (plain JSON documents, :meth:`on_heartbeat`) and turns them into
    local state:

    - ``journal_peers``  -> the read-repair peer registry (set_peers)
    - ``journal_guard``  -> the GC replication guard (fingerprints whose
      local copy the coordinator still counts toward RF — `gc_journal`
      skips them, ``durable.gc_skipped_replication``)
    - ``journal_sync``   -> pull hints, executed on a dedicated worker
      thread (NEVER on the heartbeat thread — a slow pull must not
      starve the liveness signal), pinned stream-state first.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = durable.durable_dir() if root is None else root
        self.root_id = os.path.realpath(self.root) if self.root else ""
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "collections.OrderedDict[str, Tuple[bool, Tuple[str, int]]]" = \
            collections.OrderedDict()
        self._guard: frozenset = frozenset()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cylon-journal-sync")
        self._thread.start()
        durable.set_gc_replication_guard(self._guarded)

    def _guarded(self, fingerprint: str) -> bool:
        return fingerprint in self._guard

    # -- heartbeat callback (runs on the agent's beat thread: cheap) ------

    def on_heartbeat(self, doc: Dict) -> None:
        peers_map = doc.get("journal_peers")
        if isinstance(peers_map, dict):
            set_peers([a for a in peers_map.values()
                       if isinstance(a, (list, tuple)) and len(a) == 2])
        guard = doc.get("journal_guard")
        if isinstance(guard, (list, tuple)):
            self._guard = frozenset(str(f) for f in guard)
        hints = doc.get("journal_sync")
        if not isinstance(hints, (list, tuple)) or not hints:
            return
        with self._cond:
            for h in hints:
                try:
                    fp = str(h["fingerprint"])
                    addr = (str(h["from"][0]), int(h["from"][1]))
                    pinned = bool(h.get("pinned"))
                except (KeyError, IndexError, TypeError, ValueError):
                    continue
                if fp not in self._queue:
                    self._queue[fp] = (pinned, addr)
                    if pinned:
                        self._queue.move_to_end(fp, last=False)
            self._cond.notify()

    # -- worker -----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                fp, (pinned, addr) = self._queue.popitem(last=False)
            try:
                pull_run(addr, self.root, fp)
            except Exception as e:
                log.info("durable: anti-entropy pull of %s from %s failed "
                         "(%s: %s); the coordinator will re-hint",
                         fp[:12], addr, type(e).__name__, e)

    def telemetry(self) -> Dict:
        """The per-beat journal advertisement riding replica telemetry:
        this root's identity and per-run digests (manifest-only — no
        spill reads on the heartbeat path)."""
        return {"root": self.root_id,
                "digests": durable.journal_digests(self.root)}

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=2.0)
        durable.set_gc_replication_guard(None)
        set_peers(())
