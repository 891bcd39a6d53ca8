"""Elastic multi-process membership: epochs, failure detection, and
journal-backed shrink-and-resume.

The port of ``cylon_tpu/elastic.py``.  The gang's control plane is host
code (sockets and threads, no device work); what it drives is the
engine's passes, each gang member in its own process with its own
context on a card.  The durable journal (``durable.py``) already makes
one process's death cost at most one pass; this module adds the control
plane so a cluster of processes survives losing a member:

- one **Coordinator** (TCP, ``net/control.py`` one-shot JSON requests)
  owns the membership ledger: which ranks are alive, and the **epoch**,
  a counter bumped on every membership change.  Failure detection is
  heartbeat-based (``CYLON_TPU_HEARTBEAT_S`` cadence, declared dead
  after ``CYLON_TPU_HEARTBEAT_TIMEOUT_S`` of silence) plus explicit
  reports (an agent classifying a collective failure via `Status` can
  indict a peer);
- one **Agent** per process heartbeats, mirrors the coordinator's view,
  and exposes :meth:`Agent.ensure_epoch`, the guard the streaming
  engine calls between passes so in-flight work is abandoned the moment
  membership changes (`EpochChanged`), never retried into a desynced
  world.  Its heartbeat thread makes no CUDA call;
- a **rendezvous barrier** (polled, so heartbeats keep flowing while a
  rank waits) that completes only when every live member of the same
  epoch arrives; a straggler carrying a stale epoch, or a rank the
  coordinator already declared dead, is rejected;
- :func:`elastic_run` drives the shrink-and-resume loop: parts of the
  key domain (the splitmix64 partitioning of ``exec.py``,
  ``mode="hash"``) are assigned to live members (``owned_parts``); on
  `EpochChanged` the survivors re-derive the assignment over the
  shrunken membership and re-enter (a gang re-init: each member keeps
  its own one-card context, nothing is resharded), and the journal,
  with per-pass world/epoch provenance, makes the re-entry cheap: every
  part journaled before the failure, by any rank at any world size, is
  loaded instead of re-executed.  Part ids are world-independent
  (global positions in the key-domain plan), so a part journaled at
  world W is consumed verbatim at world W-1.

Coordinator death is survivable:

- **durable coordinator state**: with ``CYLON_TPU_COORD_DIR`` set, the
  membership ledger, epoch counter, incarnation number, fence set
  (dead ranks), rendezvous latches and skew ledger are journaled to an
  fsync'd append-only log (:class:`CoordLog`, byte-compatible with the
  JAX package's).  A restarted coordinator recovers the ledger, bumps
  its **incarnation**, and bumps the epoch once, so survivors resume
  through the same shrink-and-resume loop;
- **incarnation fencing**: every control verb response carries
  ``(incarnation, epoch)`` and every agent request carries the highest
  incarnation the agent has observed.  A stale coordinator that
  resurrects after a takeover is rejected on both sides: agents discard
  its responses (`StaleCoordinatorError`), and it stands down the
  moment any verb claims a newer incarnation;
- **client-side ride-through**: agent RPC failures open a bounded
  reconnect window (``CYLON_TPU_COORD_RECONNECT_S``, full-jitter
  backoff so a restart does not thundering-herd the accept loop) during
  which local passes keep executing and journaling; only membership
  changes stall.  `CoordinatorLost` (`Code.Unavailable`) fires when the
  window expires; a window of 0 fails after three missed ticks.

Every recovery path runs deterministically on the CPU through the fault
kinds ``rank_kill`` (``os._exit(137)`` at a pass boundary),
``heartbeat_loss`` (the agent goes silent but keeps computing),
``coordinator_loss``, ``coordinator_restart``, ``coord_partition`` and
``coord_slow`` (``resilience.py``), composable into seeded timelines
with ``resilience.FaultSchedule`` (``tests/test_torch_elastic.py``,
``tests/torch_elastic_worker.py``).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from collections import deque

from . import config
from . import resilience
from .net import control
from .obs import fleet as obs_fleet
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .obs import tracectx
from .status import Code, CylonError, Status

log = logging.getLogger("cylon_tpu_torch")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def elastic_enabled() -> bool:
    """``CYLON_TPU_ELASTIC``: opt-in switch for elastic membership."""
    return bool(config.knob("CYLON_TPU_ELASTIC"))


def coordinator_address() -> str:
    """``CYLON_TPU_ELASTIC_COORD``: coordinator ``host:port``."""
    return str(config.knob("CYLON_TPU_ELASTIC_COORD"))


def heartbeat_interval() -> float:
    """``CYLON_TPU_HEARTBEAT_S``: agent heartbeat cadence (seconds)."""
    return max(0.01, float(config.knob("CYLON_TPU_HEARTBEAT_S")))


def heartbeat_timeout() -> float:
    """``CYLON_TPU_HEARTBEAT_TIMEOUT_S``: silence after which a rank is
    declared dead."""
    return max(0.05, float(config.knob("CYLON_TPU_HEARTBEAT_TIMEOUT_S")))


def clock_sync_rounds() -> int:
    """``CYLON_TPU_CLOCK_SYNC_N``: round trips per clock handshake."""
    return max(1, int(config.knob("CYLON_TPU_CLOCK_SYNC_N")))


def coord_dir() -> str:
    """``CYLON_TPU_COORD_DIR``: durable coordinator state root (the
    fsync'd append-only `CoordLog`); empty disables durability — a
    restarted coordinator then has nothing to recover."""
    return str(config.knob("CYLON_TPU_COORD_DIR"))


def reconnect_window_s() -> float:
    """``CYLON_TPU_COORD_RECONNECT_S``: how long an agent rides out an
    unreachable coordinator (bounded reconnect window, full-jitter
    backoff) before declaring `CoordinatorLost`.  0 fails after three
    missed ticks."""
    return max(0.0, float(config.knob("CYLON_TPU_COORD_RECONNECT_S")))


#: a kept clock offset older than this is replaced even by a noisier
#: measurement — bounded staleness beats a lucky-but-ancient RTT
CLOCK_MAX_AGE_S = 30.0


def _parse_address(addr) -> Tuple[str, int]:
    if isinstance(addr, (tuple, list)):
        return str(addr[0]), int(addr[1])
    host, _, port = str(addr).rpartition(":")
    if not host or not port:
        raise CylonError(Code.Invalid,
                         f"bad coordinator address {addr!r} (want host:port)")
    return host, int(port)


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

class EpochChanged(CylonError):
    """Membership moved (a rank died, or WE were declared dead): abandon
    in-flight work and re-derive the assignment.  `Code.EpochMismatch`
    is deliberately outside `RETRYABLE_CODES` — retrying the same pass
    into a changed world is exactly the desync the no-retry-collectives
    policy (``CylonContext.collective_retry_policy``) exists to prevent; the elastic loop must re-plan,
    not re-try."""

    def __init__(self, msg: str):
        super().__init__(Code.EpochMismatch, msg)


class CoordinatorLost(CylonError):
    """The membership ground truth is gone: fail clean with a classified
    `Status` (`Code.Unavailable`, non-retryable) instead of hanging on a
    barrier no one will ever complete."""

    def __init__(self, msg: str):
        super().__init__(Code.Unavailable, msg)


class StaleCoordinatorError(ConnectionError):
    """The responder carried an incarnation OLDER than one this agent
    has already observed (or confessed staleness itself): whatever is
    answering at the coordinator address is a resurrected pre-takeover
    coordinator, and absorbing its view would be split-brain.  A
    ``ConnectionError`` subclass on purpose — every failure-accounting
    path (heartbeat streaks, barrier polls, the reconnect window)
    already treats an unreachable coordinator correctly, and a stale
    one must be *exactly as dead* to this agent."""


# ---------------------------------------------------------------------------
# durable coordinator state
# ---------------------------------------------------------------------------

COORD_LOG = "COORD_LOG.jsonl"

#: compact the coordinator log once it grows past this many bytes: the
#: whole durable state is small by construction (bounded members/fences/
#: latches/skews), so the log is rewritten as ONE snapshot `open` record
#: — without this, a long run appending a latch + skew row per completed
#: collective would grow the file (and recovery's parse cost) forever
COORD_LOG_COMPACT_BYTES = 4 << 20


class CoordLog:
    """Append-only fsync'd journal of the coordinator's control state
    under ``CYLON_TPU_COORD_DIR`` — the control-plane twin of
    durable.py's run manifest, with the same crash contract: each record
    is one JSON line, appended + flushed + fsync'd, and recovery is
    torn-tail tolerant (a line that fails to parse is the expected
    shape of a crash mid-append; every complete line before it stands).

    Record kinds::

        open    {incarnation, epoch, world}    coordinator (re)started
        member  {rank, inc}                     rank joined the gang
        dead    {rank, reason, epoch, inc}      rank fenced, epoch bumped
        latch   {name, epoch, inc}              rendezvous completed
        skew    {row, inc}                      skew-ledger entry

    Every record carries the WRITER's incarnation (``inc``), and
    recovery discards records whose incarnation is below the highest
    ``open`` folded so far: a partitioned-but-alive predecessor that
    never hears the successor's fencing verb (nothing reaches it) may
    keep appending to the shared log, and without the filter its
    split-brain ``dead``/epoch records would be folded into a later
    recovery — exactly the split-brain the verb-level incarnation
    fencing exists to prevent, smuggled through the disk.

    Writes are best-effort like every durable.py write: an IO failure
    disables the log for this coordinator (counted, warned) but never
    fails the membership operation it was recording — durability
    degrades, the control plane does not."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, COORD_LOG)
        self.disabled = False
        self._lock = threading.Lock()

    @classmethod
    def open(cls, root: str) -> Optional["CoordLog"]:
        if not root:
            return None
        try:
            os.makedirs(root, exist_ok=True)
        except OSError as e:
            obs_metrics.counter_add("coord.log_errors")
            log.warning("elastic: cannot open coordinator log under %r "
                        "(%s: %s); coordinator durability disabled",
                        root, type(e).__name__, e)
            return None
        return cls(root)

    def append(self, entry: Dict) -> bool:
        return self.append_many([entry])

    def append_many(self, entries: Sequence[Dict]) -> bool:
        """Write records in order, one fsync for the batch (they are
        staged under the membership lock and flushed outside it — a slow
        disk must never stall heartbeat processing into false
        timeouts)."""
        if self.disabled or not entries:
            return not self.disabled
        try:
            with self._lock, open(self.path, "a", encoding="utf-8") as fh:
                for entry in entries:
                    fh.write(json.dumps(entry, sort_keys=True) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            return True
        except OSError as e:
            self.disabled = True
            obs_metrics.counter_add("coord.log_errors")
            log.warning("elastic: coordinator log append failed (%s: %s); "
                        "durability disabled for this coordinator",
                        type(e).__name__, e)
            return False

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def rewrite(self, entries: Sequence[Dict]) -> bool:
        """Atomically replace the whole log with ``entries`` (tmp +
        fsync + rename — the durable.py spill discipline): compaction.
        A crash at any point leaves either the old log or the new one,
        never a mix."""
        if self.disabled:
            return False
        tmp = self.path + f".tmp.{os.getpid()}"
        try:
            with self._lock:
                with open(tmp, "w", encoding="utf-8") as fh:
                    for entry in entries:
                        fh.write(json.dumps(entry, sort_keys=True) + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.path)
            return True
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            self.disabled = True
            obs_metrics.counter_add("coord.log_errors")
            log.warning("elastic: coordinator log rewrite failed (%s: "
                        "%s); durability disabled for this coordinator",
                        type(e).__name__, e)
            return False

    @staticmethod
    def recover(root: str) -> Optional[Dict]:
        """Fold the log into the last durable coordinator state, or None
        when there is no (usable) log.  The returned dict carries
        ``incarnation``/``epoch``/``world``/``members``/``dead``/
        ``latches``/``skews`` exactly as of the last complete record.
        An ``open`` record may carry a full state SNAPSHOT (compaction,
        restart) — it replaces everything folded so far."""
        if not root:
            return None
        path = os.path.join(root, COORD_LOG)
        state: Dict = {"incarnation": -1, "epoch": 0, "world": 0,
                       "members": set(), "dead": {}, "latches": [],
                       "skews": []}
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for raw in fh:
                    try:
                        e = json.loads(raw)
                    except ValueError:
                        # a torn line: the expected crash-mid-append
                        # shape at the TAIL — but SKIPPED, not a replay
                        # stop, so a garbled mid-file line (two writers
                        # interleaving buffered appends) cannot silently
                        # drop every later valid record (a fence entry
                        # lost here would un-fence a dead rank)
                        if raw.strip():
                            log.warning("elastic: coordinator log %s: "
                                        "skipping malformed record %r",
                                        path, raw[:80])
                        continue
                    kind = e.get("kind")
                    try:
                        if kind == "open":
                            e_inc = int(e["incarnation"])
                            if e_inc < state["incarnation"]:
                                # a stale writer's open/snapshot never
                                # outranks already-folded state
                                continue
                            state["incarnation"] = e_inc
                            state["world"] = int(e.get("world", 0))
                            state["epoch"] = max(state["epoch"],
                                                 int(e.get("epoch", 0)))
                            if "members" in e:  # snapshot open record
                                state["members"] = {
                                    int(r) for r in e["members"]}
                                state["dead"] = {
                                    int(r): str(w) for r, w
                                    in (e.get("dead") or {}).items()}
                                state["latches"] = [
                                    (str(n), int(ep)) for n, ep
                                    in (e.get("latches") or [])]
                                state["skews"] = [
                                    r for r in (e.get("skews") or [])
                                    if isinstance(r, dict)]
                            continue
                        inc = e.get("inc")
                        if isinstance(inc, int) \
                                and inc < state["incarnation"]:
                            # a stale (superseded, possibly partitioned)
                            # coordinator kept writing after a takeover:
                            # its records are split-brain and must not
                            # fold into the recovered ledger
                            continue
                        if kind == "member":
                            state["members"].add(int(e["rank"]))
                        elif kind == "dead":
                            r = int(e["rank"])
                            state["members"].discard(r)
                            state["dead"][r] = str(e.get("reason", "?"))
                            state["epoch"] = max(state["epoch"],
                                                 int(e.get("epoch", 0)))
                        elif kind == "latch":
                            state["latches"].append(
                                (str(e["name"]), int(e["epoch"])))
                        elif kind == "skew":
                            row = e.get("row")
                            if isinstance(row, dict):
                                state["skews"].append(row)
                    except (KeyError, TypeError, ValueError):
                        log.warning("elastic: coordinator log %s: "
                                    "skipping half-shaped %r record",
                                    path, kind)
                        continue
        except OSError:
            return None
        if state["incarnation"] < 0:
            return None  # no complete `open` record: nothing durable
        state["latches"] = state["latches"][-256:]
        state["skews"] = state["skews"][-64:]
        return state


@dataclass(frozen=True)
class MemberView:
    """One consistent observation of the membership ledger."""

    epoch: int
    members: Tuple[int, ...]   # sorted live ranks
    world: int                 # initial gang size (epoch-0 world)

    def require_member(self, rank: int) -> None:
        if rank not in self.members:
            raise EpochChanged(
                f"rank {rank} is not a member at epoch {self.epoch} "
                f"(declared dead; members={list(self.members)})")


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------

class Coordinator:
    """Membership ledger + failure detector + rendezvous barriers.

    One per gang.
    State transitions are shrink-only: a rank joins once (``hello``),
    heartbeats while alive, and is moved to ``dead`` — bumping the epoch
    — on heartbeat timeout, an explicit peer report, or a clean
    ``leave``.  Dead ranks stay dead: a late heartbeat or barrier from
    one is *rejected* (the straggler learns it was fenced off and must
    not touch shared state as a member).
    """

    #: per-request line bound of the coordinator's JsonServer: control
    #: verbs are small, so the control default stands — the query router
    #: subclass (cylon_tpu/router), whose `route` verb carries whole
    #: encoded tables, overrides this with its wire cap
    SERVER_MAX_LINE = control.MAX_LINE

    def __init__(self, world: int, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: Optional[float] = None,
                 log_dir: Optional[str] = None):
        if world < 1:
            raise CylonError(Code.Invalid, f"world must be >= 1, got {world}")
        self.world = int(world)
        self.timeout = (heartbeat_timeout() if heartbeat_timeout_s is None
                        else max(0.05, float(heartbeat_timeout_s)))
        self._lock = threading.Lock()
        self._epoch = 0
        self.incarnation = 0                     # fencing token, bumped
        self.stale = False                       # superseded: stand down
        self._last_hb: Dict[int, float] = {}     # alive ranks -> monotonic
        self._dead: Dict[int, str] = {}          # rank -> reason (FENCE set)
        # barrier arrival instants (coordinator clock, perf_counter_ns):
        # rank -> first-arrival timestamp; on completion the spread is the
        # collective's SKEW — the slowest participant's cost to everyone
        # (measured on one real clock)
        self._barriers: Dict[Tuple[str, int], Dict[int, int]] = {}
        # per-barrier causal trace: the first arrival presenting a
        # traceparent names the trace the rendezvous belongs to; every
        # poll reply echoes it, so ranks that arrived WITHOUT a context
        # adopt the requester's trace (cross-rank propagation rides the
        # rendezvous — the one point every member passes through)
        self._barrier_traces: Dict[Tuple[str, int], str] = {}
        self._clocks: Dict[int, Dict] = {}       # rank -> offset/uncertainty
        self._telemetry: Dict[int, Dict] = {}    # rank -> serve telemetry
        self._metrics: Dict[int, Dict] = {}      # rank -> metrics snapshot
        self._skews: "deque[Dict]" = deque(maxlen=64)
        self._pending_flight: List[Tuple[str, Dict]] = []  # staged dumps
        self._pending_log: List[Dict] = []       # staged CoordLog records
        self._log_flush_lock = threading.Lock()  # keeps batches ordered
        # latched completed rendezvous, insertion-ordered dict-as-set so
        # the bound evicts oldest-first (a slow member only ever polls a
        # RECENTLY completed barrier)
        self._completed_barriers: Dict[Tuple[str, int], bool] = {}
        self._stop = threading.Event()
        self.died = False                        # coordinator_loss fired
        # durable state: recover the ledger a predecessor journaled under
        # CYLON_TPU_COORD_DIR (or the explicit log_dir), then journal our
        # own `open` — a plain fresh start (no log) opens at incarnation 0
        self._log_dir = coord_dir() if log_dir is None else str(log_dir)
        recovered = CoordLog.recover(self._log_dir)
        self.restored = recovered is not None
        if recovered is not None:
            self._adopt_recovered(recovered)
        self._log = CoordLog.open(self._log_dir)
        if self._log is not None:
            # the open record is a full SNAPSHOT and REPLACES the log:
            # history before this incarnation is already folded into it,
            # so the file never accumulates dead lifetimes
            self._log.rewrite([self._snapshot_locked()])
        self._server = control.JsonServer(self._handle, host=host, port=port,
                                          max_line=self.SERVER_MAX_LINE)
        self.address: Tuple[str, int] = self._server.address
        self._detector: Optional[threading.Thread] = None

    def _adopt_recovered(self, rec: Dict) -> None:
        """Fold a recovered `CoordLog` state in: restart-with-takeover.
        The incarnation bumps (the fencing token a stale predecessor can
        never present) and the epoch bumps ONCE — every survivor's next
        guard raises `EpochChanged` and the ordinary shrink-and-resume
        loop re-derives the assignment; the fence set carries over, so a
        rank fenced before the crash stays fenced after it.  Recovered
        members get a fresh heartbeat stamp: a full timeout window to
        reconnect before the detector may reap them."""
        if rec.get("world") and int(rec["world"]) != self.world:
            log.warning("elastic: recovered coordinator log records "
                        "world=%d (constructor said %d); trusting the log",
                        int(rec["world"]), self.world)
            self.world = int(rec["world"])
        self.incarnation = int(rec["incarnation"]) + 1
        self._epoch = int(rec["epoch"]) + 1
        self._dead = {int(r): str(w) for r, w in rec["dead"].items()}
        # recovered members are stamped one full timeout INTO THE FUTURE:
        # this coordinator cannot have heard anyone before it existed,
        # and the survivors it owes a reconnect window to are busy
        # riding out the very outage it is recovering from — reaping one
        # for silence accrued against a dead predecessor would turn a
        # survivable restart into a fencing
        grace = time.monotonic() + self.timeout
        self._last_hb = {int(r): grace for r in sorted(rec["members"])}
        self._completed_barriers = {
            (str(n), int(e)): True for n, e in rec["latches"]}
        self._skews = deque(rec["skews"], maxlen=64)

    def _snapshot_locked(self) -> Dict:
        """The full durable state as ONE `open` record — what the log is
        compacted to, and what a successor recovers from."""
        return {"kind": "open", "incarnation": self.incarnation,
                "epoch": self._epoch, "world": self.world,
                "members": sorted(self._last_hb),
                "dead": {str(r): w for r, w in sorted(self._dead.items())},
                "latches": [[n, e] for n, e in self._completed_barriers],
                "skews": list(self._skews),
                "ts_unix": time.time()}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Coordinator":
        self._server.start()
        self._detector = threading.Thread(target=self._detect, daemon=True,
                                          name="cylon-elastic-detector")
        self._detector.start()
        obs_metrics.gauge_set("elastic.incarnation", self.incarnation)
        if self.restored:
            obs_spans.instant("coord.restart", incarnation=self.incarnation,
                              epoch=self._epoch,
                              members=sorted(self._last_hb))
            obs_metrics.counter_add("coord.restart")
            obs_fleet.flight_record(
                "coord_restart", rank="coord",
                incarnation=self.incarnation, epoch=self._epoch,
                members=sorted(self._last_hb), dead=dict(self._dead))
            log.warning("elastic: coordinator RESTARTED at %s:%d from "
                        "durable log (incarnation=%d, epoch=%d, "
                        "members=%s, fenced=%s)", *self.address,
                        self.incarnation, self._epoch,
                        sorted(self._last_hb), sorted(self._dead))
        else:
            log.info("elastic: coordinator up at %s:%d (world=%d, "
                     "heartbeat timeout %.2fs, incarnation=%d)",
                     *self.address, self.world, self.timeout,
                     self.incarnation)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.close()

    def _die(self) -> None:
        """Simulated coordinator crash (the ``coordinator_loss`` fault
        kind): drop the socket without ceremony — agents must detect the
        silence and fail clean."""
        with self._lock:  # restart() clears the flag under the same lock
            self.died = True
        log.warning("elastic: coordinator dying (injected coordinator_loss)")
        self.stop()

    # -- failure detector ------------------------------------------------

    def _detect(self) -> None:
        tick = max(self.timeout / 4.0, 0.02)
        while not self._stop.wait(tick):
            try:
                resilience.fault_point("elastic.coordinator")
            except resilience.InjectedFault as e:
                if e.kind == "coordinator_loss":
                    self._die()
                    return
                if e.kind == "coordinator_restart":
                    # crash + takeover, compressed: down for the injected
                    # outage, then back at the SAME address with the
                    # durable ledger, a bumped incarnation and epoch —
                    # exactly what agents must ride through
                    self.restart(down_s=resilience.fault_delay_s())
                    continue
                raise
            now = time.monotonic()
            with self._lock:
                # a superseded coordinator must not fence anyone: its
                # ledger is no longer the ground truth
                late = [] if self.stale else \
                    [r for r, hb in self._last_hb.items()
                     if now - hb > self.timeout]
                for rank in late:
                    self._mark_dead_locked(rank, "heartbeat timeout")
            self._flush_log()
            self._flush_flight()

    def _mark_dead_locked(self, rank: int, reason: str) -> None:
        if rank in self._dead or rank not in self._last_hb:
            return
        del self._last_hb[rank]
        # a dead rank's telemetry/clock must leave the status aggregate
        # with it — otherwise its last-reported queue depth haunts the
        # fleet view forever
        self._clocks.pop(rank, None)
        self._telemetry.pop(rank, None)
        self._metrics.pop(rank, None)
        self._dead[rank] = reason
        self._epoch += 1
        # the fence + epoch bump is durable state: a coordinator that
        # restarts must remember who it fenced (STAGED like the flight
        # dumps — fsync latency never holds the membership lock)
        self._pending_log.append({"kind": "dead", "rank": int(rank),
                                  "reason": reason, "epoch": self._epoch,
                                  "inc": self.incarnation})
        # the trace the fleet was rendezvousing in when the rank died:
        # joining the rank-loss instant/dump to the request trace it
        # killed is exactly what a post-mortem needs (resolved BEFORE the
        # stale-barrier sweep below discards the pending arrival sets).
        # Prefer a pending barrier the dead rank never ARRIVED at — that
        # is the rendezvous the survivors are stalled in because of it;
        # with concurrent traced rendezvous (multi-tenant serve) this
        # picks the request the death actually wounded, not whichever
        # barrier registered its trace first
        pending = sorted(self._barriers, key=lambda k: k[1], reverse=True)
        stalled = [k for k in pending if rank not in self._barriers[k]]
        lost_tp = next(
            (self._barrier_traces[k] for k in stalled + pending
             if k in self._barrier_traces), None)
        if lost_tp is None and self._barrier_traces:
            # a trace can be latched before the gang forms (no arrival
            # set yet): fall back to the latest-epoch registered trace
            lost_tp = self._barrier_traces[
                max(self._barrier_traces, key=lambda k: k[1])]
        lost_trace = tracectx.parse_or_none(lost_tp)
        # rank loss is a classified terminal event: the coordinator's
        # flight dump records WHO died, WHY, and the control-plane events
        # leading up to it — even when the dead process took its own
        # trace down with it (rank_kill is os._exit: nothing flushes).
        # STAGED here, written by _flush_flight outside the lock — a
        # slow disk must never block heartbeat processing into
        # cascading false timeouts.  A clean leave is not a failure and
        # does not dump.
        if reason != "left":
            self._pending_flight.append(("rank_lost", dict(
                lost_rank=rank, loss_reason=reason, epoch=self._epoch,
                incarnation=self.incarnation,
                members=sorted(self._last_hb),
                **({"trace_id": lost_trace.trace_id}
                   if lost_trace is not None else {}))))
        # pending barriers from earlier epochs can never complete (their
        # pollers get epoch_changed and re-enter at the new epoch): drop
        # them so arrival sets don't accumulate across a long shrink
        for key in [k for k in self._barriers if k[1] < self._epoch]:
            del self._barriers[key]
        for key in [k for k in self._barrier_traces if k[1] < self._epoch]:
            del self._barrier_traces[key]
        obs_spans.instant(
            "elastic.rank_lost", rank=rank, reason=reason,
            epoch=self._epoch,
            **({"trace_id": lost_trace.trace_id}
               if lost_trace is not None else {}))
        obs_metrics.counter_add("elastic.rank_lost")
        obs_metrics.gauge_set("elastic.epoch", self._epoch)
        log.warning("elastic: rank %d declared dead (%s); epoch -> %d, "
                    "members -> %s", rank, reason, self._epoch,
                    sorted(self._last_hb))

    # -- request handling ------------------------------------------------

    def _view_locked(self) -> Dict:
        return {"epoch": self._epoch,
                "members": sorted(self._last_hb),
                "world": self.world,
                "incarnation": self.incarnation}

    def _record_skew_locked(self, name: str, epoch: int,
                            arrived: Dict[int, int],
                            traceparent: Optional[str] = None) -> None:
        """Account one completed rendezvous: the arrival spread IS the
        collective's skew (everyone waits for the last arrival), on the
        coordinator's single clock — no alignment uncertainty at all.
        The barrier's causal trace (first arrival presenting one) rides
        the row and the instant, joining the skew ledger to the request
        that paid for the wait."""
        first = min(arrived.values())
        slowest = max(arrived, key=arrived.get)
        skew_ns = arrived[slowest] - first
        tctx = tracectx.parse_or_none(traceparent)
        obs_metrics.hist_observe("collective.skew_ns", skew_ns)
        obs_spans.instant("collective.skew", collective=name, epoch=epoch,
                          skew_ns=skew_ns, slowest_rank=slowest,
                          **({"trace_id": tctx.trace_id}
                             if tctx is not None else {}))
        row = {
            "collective": name, "epoch": epoch, "skew_ns": int(skew_ns),
            "slowest_rank": int(slowest),
            "arrivals_ns": {str(r): int(t - first)
                            for r, t in sorted(arrived.items())}}
        if tctx is not None:
            row["trace_id"] = tctx.trace_id
        self._skews.append(row)
        self._pending_log.append({"kind": "skew", "row": row,
                                   "inc": self.incarnation})

    def _serve_status_locked(self) -> Dict:
        """Aggregate the per-rank serve telemetry heartbeats carry: total
        queue depth plus per-tenant SLO latency histograms (queue-wait vs
        run split), merged across ranks."""
        agg: Dict[str, object] = {"queue_depth": 0, "tenants": {}}
        tenants: Dict[str, Dict] = agg["tenants"]  # type: ignore[assignment]
        for _rank, tel in sorted(self._telemetry.items()):
            agg["queue_depth"] += int(tel.get("queue_depth", 0) or 0)
            for t, row in sorted((tel.get("tenants") or {}).items()):
                dst = tenants.setdefault(t, {})
                for key in ("queue_wait_ms", "run_ms"):
                    h = row.get(key)
                    if isinstance(h, dict):
                        dst[key] = obs_fleet.merge_hist(dst.get(key), h)
                for key in ("served", "shed", "failed", "cache_hits"):
                    if key in row:
                        dst[key] = int(dst.get(key, 0)) + int(row[key])
        return agg

    #: caps on the journal-replication reply fields: hints are a
    #: per-beat pull burst bound (the next beat carries more — anti-
    #: entropy converges incrementally), the guard cap only bounds a
    #: pathological advertisement (the digest cap upstream is smaller)
    JOURNAL_SYNC_HINTS_MAX = 8
    JOURNAL_GUARD_MAX = 4096

    def _journal_reply_locked(self, rank: int) -> Dict:
        """Journal anti-entropy placement for one heartbeat reply.

        Replicas advertise ``{"journal": {"addr", "root", "digests"}}``
        in their heartbeat telemetry; this diffs those advertisements
        against ``CYLON_TPU_DURABLE_RF`` and answers THIS rank with:

        - ``journal_peers`` — live peers' journal data-plane addresses
          (the read-repair fetch targets);
        - ``journal_sync``  — pull hints for under-replicated runs this
          rank should replicate (pinned stream-state first; deterministic
          assignment: the first ``RF - holders`` non-holder ranks in
          rank order pull, so two beats never double-assign);
        - ``journal_guard`` — fingerprints whose LOCAL copy is load-
          bearing (holders < RF: the fleet is ALREADY at or below its
          replication target without losing ours), which this rank's
          ``gc_journal`` must not evict: on a peer-less fleet every run
          is guarded, because this root holds the only copy the
          coordinator knows about.  At RF=1 nothing is ever guarded —
          plain size-cap GC, exactly.

        Holder counting is by DISTINCT root (realpath): replicas sharing
        one filesystem journal are one copy, not two.  Empty when no
        replica advertises a journal — the whole feature costs nothing
        on fleets that never turned it on."""
        recs: Dict[int, Dict] = {}
        for r, tel in self._telemetry.items():
            if r in self._dead or r not in self._last_hb:
                continue
            j = tel.get("journal") if isinstance(tel, dict) else None
            if isinstance(j, dict) and j.get("addr") and j.get("root"):
                recs[r] = j
        me = recs.get(rank)
        if me is None:
            return {}
        from . import durable

        rf = durable.replication_factor()
        out: Dict = {"journal_peers": {
            str(r): list(j["addr"]) for r, j in sorted(recs.items())
            if r != rank}}
        my_root = me.get("root")
        # fingerprint -> {root -> (rank, addr)} over complete/pinned runs
        holders: Dict[str, Dict] = {}
        for r, j in sorted(recs.items()):
            digests = j.get("digests")
            if not isinstance(digests, dict):
                continue
            for fp, rec in digests.items():
                if not isinstance(rec, dict) \
                        or not (rec.get("complete") or rec.get("pinned")):
                    continue
                h = holders.setdefault(str(fp), {"roots": {},
                                                 "pinned": False})
                h["roots"].setdefault(j["root"], (r, j["addr"]))
                h["pinned"] = h["pinned"] or bool(rec.get("pinned"))
        guard: List[str] = []
        hints: List[Dict] = []
        for fp, h in sorted(holders.items()):
            roots = h["roots"]
            if my_root in roots:
                if len(roots) < rf and len(guard) < self.JOURNAL_GUARD_MAX:
                    guard.append(fp)
                continue
            missing = rf - len(roots)
            if missing <= 0:
                continue
            pullers = [r for r in sorted(recs)
                       if recs[r].get("root") not in roots][:missing]
            if rank in pullers:
                src_rank, src_addr = sorted(roots.values())[0]
                hints.append({"fingerprint": fp, "from": list(src_addr),
                              "pinned": h["pinned"]})
        if guard:
            out["journal_guard"] = guard
        if hints:
            hints.sort(key=lambda x: (not x["pinned"], x["fingerprint"]))
            out["journal_sync"] = hints[:self.JOURNAL_SYNC_HINTS_MAX]
        return out

    def view(self) -> MemberView:
        with self._lock:
            v = self._view_locked()
        return MemberView(v["epoch"], tuple(v["members"]), v["world"])

    def _flush_flight(self) -> None:
        """Write the staged flight dumps (rank losses, stale fencing)
        OUTSIDE the membership lock (called after each detector sweep
        and each handled request)."""
        if not self._pending_flight:  # unlocked fast path (hot verbs)
            return
        while True:
            with self._lock:
                if not self._pending_flight:
                    return
                reason, kw = self._pending_flight.pop(0)
            # the incarnation was stamped when the event was STAGED: a
            # dump flushed after a restart must attribute its terminal
            # event to the coordinator lifetime that recorded it
            obs_fleet.flight_record(reason, rank="coord", **kw)

    def _flush_log(self) -> None:
        """Drain the staged `CoordLog` records OUTSIDE the membership
        lock.  The flush lock serializes concurrent drains so batches
        land in staging order (a `dead` record may never precede its
        rank's `member` record)."""
        if self._log is None or not self._pending_log:
            return  # unlocked empty check: this runs after EVERY verb
        with self._log_flush_lock:
            with self._lock:
                entries, self._pending_log = self._pending_log, []
            self._log.append_many(entries)
            if self._log.size() > COORD_LOG_COMPACT_BYTES \
                    and not self.stale:
                # bounded growth: fold everything into one snapshot
                # `open` record (a long run appends a latch + skew row
                # per collective; recovery only ever wants the tail).
                # A rewrite is DESTRUCTIVE where plain appends are not
                # (a stale writer's appends are filtered at recovery by
                # incarnation; a stale rewrite would erase the
                # successor's ledger outright) — so before compacting,
                # re-read the file and verify this coordinator still
                # OWNS it; a higher incarnation on disk means a
                # takeover happened behind a partition and this
                # coordinator must stand down instead
                on_disk = CoordLog.recover(self._log_dir)
                if on_disk is not None \
                        and on_disk["incarnation"] > self.incarnation:
                    with self._lock:
                        self.stale = True
                    obs_spans.instant("coord.stale_fenced",
                                      incarnation=self.incarnation,
                                      superseded_by=on_disk["incarnation"])
                    obs_metrics.counter_add("coord.stale_fenced")
                    log.warning(
                        "elastic: coordinator incarnation %d found "
                        "incarnation %d on its own log at compaction: "
                        "superseded behind a partition; standing down",
                        self.incarnation, on_disk["incarnation"])
                    return
                with self._lock:
                    snap = self._snapshot_locked()
                if self._log.rewrite([snap]):
                    obs_spans.instant("coord.log_compacted",
                                      bytes=self._log.size())
                    obs_metrics.counter_add("coord.log_compactions")

    def restart(self, down_s: float = 0.0) -> "Coordinator":
        """Crash + restart-with-takeover compressed into one object (the
        ``coordinator_restart`` fault kind and the in-process tests):
        drop the socket, stay dark for ``down_s`` (agents accumulate
        failures and enter their reconnect windows), then recover the
        durable ledger, bump incarnation and epoch once, and rebind the
        SAME address.  Without a coordinator log the live in-memory
        state stands in for the recovered ledger (a state-transfer
        takeover) — incarnation and epoch still bump, so agents observe
        an indistinguishable restart."""
        host, port = self.address
        self._server.close()
        if down_s > 0:
            time.sleep(down_s)
        self._flush_flight()  # staged dumps carry their stamped (old)
        #                       incarnation; write them out pre-bump
        with self._log_flush_lock:
            # drain + recover + bump under ONE membership-lock hold (a
            # cold path; the server socket is already closed): a fence
            # record staged by an in-flight handler must land in the log
            # BEFORE the incarnation bumps — flushed after the new open
            # it would carry the old incarnation and the stale-writer
            # filter would durably drop it, un-fencing a dead rank
            with self._lock:
                entries, self._pending_log = self._pending_log, []
                if self._log is not None:
                    self._log.append_many(entries)
                # adopt the disk ledger only while the log is HEALTHY:
                # once an IO failure disabled it, the file is stale
                # relative to live memory (fences recorded since are
                # only in RAM) — recovering it would un-fence dead
                # ranks and skip the epoch bump survivors resume on
                recovered = (CoordLog.recover(self._log_dir)
                             if self._log is not None
                             and not self._log.disabled else None)
                if recovered is not None:
                    self._adopt_recovered(recovered)
                else:
                    self.incarnation += 1
                    self._epoch += 1
                    now = time.monotonic()
                    self._last_hb = {r: now
                                     for r in sorted(self._last_hb)}
                self._barriers.clear()   # pending arrivals died with the
                self._barrier_traces.clear()
                self._clocks.clear()     # old incarnation; latches are
                self._telemetry.clear()  # durable
                self._metrics.clear()
                self.stale = False
                self.died = False
                self.restored = True
                inc, epoch = self.incarnation, self._epoch
                members = sorted(self._last_hb)
                snap = self._snapshot_locked()
            if self._log is not None:
                self._log.rewrite([snap])
        # re-bind with a bounded retry: agents hammering the closed
        # port during the outage can transiently OCCUPY it (the
        # localhost self-connect quirk — a connect to a closed port may
        # pick source port == destination port and succeed against
        # itself); such a socket dies within one rpc timeout when the
        # agent's recv times out, so the address frees itself
        bind_deadline = time.monotonic() + max(5.0, 2 * self.timeout)
        while True:
            try:
                # bind OUTSIDE the membership lock (the retry sleeps);
                # only the publication of the bound server takes it
                srv = control.JsonServer(
                    self._handle, host=host, port=port,
                    max_line=self.SERVER_MAX_LINE)
                break
            except OSError:
                if time.monotonic() >= bind_deadline:
                    raise
                time.sleep(0.05)
        with self._lock:
            self._server = srv
        srv.start()
        obs_spans.instant("coord.restart", incarnation=inc, epoch=epoch,
                          members=members, down_s=down_s)
        obs_metrics.counter_add("coord.restart")
        obs_metrics.gauge_set("elastic.incarnation", inc)
        obs_fleet.flight_record("coord_restart", rank="coord",
                                incarnation=inc, epoch=epoch,
                                members=members, dead=dict(self._dead))
        log.warning("elastic: coordinator RESTARTED in place at %s:%d "
                    "(incarnation=%d, epoch=%d, members=%s)", host, port,
                    inc, epoch, members)
        return self

    def _handle(self, req: Dict) -> Dict:
        try:
            return self._handle_inner(req)
        finally:
            # report_failure / leave mark ranks dead under the lock;
            # their log records + dumps are written here, after release
            self._flush_log()
            self._flush_flight()

    def _handle_inner(self, req: Dict) -> Dict:
        t_recv = time.perf_counter_ns()
        cmd = req.get("cmd")
        rank = req.get("rank")
        # coord_slow injection: a delayed reply, not a lost one
        resilience.fault_point("elastic.coord.verb")
        claim = req.get("coord_incarnation")
        if cmd == "clock":
            # the NTP-style handshake leg: lock-free, so a blocked
            # membership operation cannot inflate the apparent one-way
            # delay (uncertainty IS the product here).  Fenced ranks may
            # still sync — a straggler's post-mortem trace needs
            # alignment more than anyone's.  Staleness is checked with a
            # plain attribute read (a superseded clock reference must
            # not be merged against), and the stand-down WRITE is left
            # to the membership verbs so this path never takes the lock.
            if self.stale:
                return {"ok": False, "status": "stale_coordinator",
                        "incarnation": self.incarnation,
                        "error": "superseded coordinator incarnation"}
            return {"ok": True, "t_recv": t_recv,
                    "t_send": time.perf_counter_ns()}
        if cmd == "metrics":
            # fleet-wide OpenMetrics: the per-rank snapshots heartbeats
            # ship (live members only — a dead rank's metrics left with
            # its telemetry) plus this coordinator's own registry.  The
            # lock hold is ONE dict copy; the multi-rank string render
            # runs outside it (a Prometheus scrape must never stall
            # heartbeats), which is safe because heartbeat handling
            # REPLACES a rank's snapshot wholesale, never mutates it.
            # One representation per reply: the exposition text by
            # default, raw snapshots under `raw` (fleet_status --json)
            # — shipping both doubled every scrape.
            with self._lock:
                if self.stale:
                    return {"ok": False, "status": "stale_coordinator",
                            "incarnation": self.incarnation,
                            "error": "superseded coordinator incarnation"}
                snaps: Dict[str, Dict] = {
                    str(r): m for r, m in sorted(self._metrics.items())}
                view = self._view_locked()
            snaps["coord"] = obs_metrics.snapshot()
            if req.get("raw"):
                return {"ok": True, "ranks": snaps, **view}
            from .obs import openmetrics

            return {"ok": True,
                    "openmetrics": openmetrics.render_fleet(snaps),
                    **view}
        with self._lock:
            # incarnation fencing, coordinator side, under the SAME lock
            # hold as the verb dispatch below (one acquisition, and the
            # "stale answers only stale_coordinator" invariant holds
            # atomically): a request claiming a NEWER incarnation proves
            # a takeover happened and THIS coordinator is the stale
            # resurrection — it stands down for good (stops fencing
            # ranks, answers only its own staleness) rather than run a
            # split-brain membership ledger
            if isinstance(claim, int) and claim > self.incarnation \
                    and not self.stale:
                self.stale = True
                obs_spans.instant("coord.stale_fenced",
                                  incarnation=self.incarnation,
                                  superseded_by=claim)
                obs_metrics.counter_add("coord.stale_fenced")
                self._pending_flight.append(("stale_coordinator", dict(
                    superseded_by=claim, epoch=self._epoch,
                    incarnation=self.incarnation)))
                log.warning("elastic: coordinator incarnation %d fenced "
                            "off by a verb from incarnation %s: standing "
                            "down", self.incarnation, claim)
            if self.stale:
                return {"ok": False, "status": "stale_coordinator",
                        "incarnation": self.incarnation,
                        "error": "superseded coordinator incarnation"}
            if cmd == "status":
                now = time.monotonic()
                # clamp: recovered members carry a grace stamp in the
                # FUTURE, which must not surface as a negative age
                return {"ok": True, "dead": dict(self._dead),
                        "ranks": {str(r): {
                            "hb_age_s": round(max(0.0, now - hb), 6),
                            "clock": self._clocks.get(r)}
                            for r, hb in sorted(self._last_hb.items())},
                        "serve": self._serve_status_locked(),
                        "collectives": list(self._skews),
                        **self._view_locked()}
            if not isinstance(rank, int):
                return {"ok": False, "error": f"bad rank {rank!r}"}
            if rank in self._dead and cmd != "status":
                # fenced: the rank was declared dead; it must stand down
                return {"ok": False, "status": "rejected",
                        "reason": self._dead[rank], **self._view_locked()}
            if cmd == "hello":
                if rank in self._last_hb:
                    return {"ok": True, **self._view_locked()}
                if not 0 <= rank < self.world:
                    return {"ok": False,
                            "error": f"rank {rank} outside world "
                                     f"{self.world}"}
                self._last_hb[rank] = time.monotonic()
                self._pending_log.append({"kind": "member",
                                          "rank": int(rank),
                                          "inc": self.incarnation})
                log.info("elastic: rank %d joined (%d/%d)", rank,
                         len(self._last_hb) + len(self._dead), self.world)
                return {"ok": True, **self._view_locked()}
            if cmd == "heartbeat":
                if rank not in self._last_hb:
                    if 0 <= rank < self.world:
                        # implicit re-join: a live rank this ledger does
                        # not know (its member record fell past a torn
                        # tail on recovery) must not read as fenced —
                        # fencing is only ever recorded in the dead set
                        self._pending_log.append({"kind": "member",
                                                  "rank": int(rank),
                                                  "inc": self.incarnation})
                    else:
                        return {"ok": False, "status": "rejected",
                                "reason": "unknown rank",
                                **self._view_locked()}
                self._last_hb[rank] = time.monotonic()
                ci = req.get("clock")
                if isinstance(ci, dict):
                    self._clocks[rank] = {
                        "offset_ns": int(ci.get("offset_ns", 0)),
                        "uncertainty_ns": int(ci.get("uncertainty_ns", 0))}
                tel = req.get("telemetry")
                if isinstance(tel, dict):
                    self._telemetry[rank] = tel
                m = req.get("metrics")
                if isinstance(m, dict):
                    self._metrics[rank] = m
                try:
                    extra = self._journal_reply_locked(rank)
                except Exception as e:  # never fail a beat over placement
                    log.debug("elastic: journal reply computation failed "
                              "(%s: %s)", type(e).__name__, e)
                    extra = {}
                return {"ok": True, **extra, **self._view_locked()}
            if cmd == "barrier":
                name, epoch = str(req.get("name")), req.get("epoch")
                if (name, epoch) in self._completed_barriers:
                    # latched: every live member of `epoch` once arrived.
                    # Completion is monotone, so a member that finished,
                    # got "go" and LEFT (bumping the epoch) must not
                    # convert the others' still-pending polls into a
                    # spurious epoch_changed resume
                    latched = self._completed_barriers[(name, epoch)]
                    return {"ok": True, "status": "go",
                            **({"traceparent": latched}
                               if isinstance(latched, str) else {}),
                            **self._view_locked()}
                if epoch != self._epoch:
                    return {"ok": True, "status": "epoch_changed",
                            **self._view_locked()}
                # causal propagation: the first arrival PRESENTING a
                # traceparent names this rendezvous's trace, and every
                # poll reply echoes it — ranks that arrived without a
                # context adopt it, so one request's trace spans the
                # whole gang (registered before the formed check: the
                # early joiner's context must not be lost to a wait)
                tp = req.get("traceparent")
                if tracectx.parse_or_none(tp) is not None:
                    # only a VALID header may occupy the latch: garbage
                    # must never block a later real context or be echoed
                    # to the whole gang
                    self._barrier_traces.setdefault((name, epoch), tp)
                btp = self._barrier_traces.get((name, epoch))
                becho = {"traceparent": btp} if btp else {}
                if len(self._last_hb) + len(self._dead) < self.world:
                    # the gang has not fully formed: a premature barrier
                    # among the early joiners must not "go" before the
                    # remaining ranks exist to be counted
                    return {"ok": True, "status": "wait", **becho,
                            **self._view_locked()}
                arrived = self._barriers.setdefault((name, epoch), {})
                # first arrival wins: re-polls of a waiting rank must not
                # slide its arrival instant forward
                arrived.setdefault(rank, t_recv)
                if set(self._last_hb) <= set(arrived):
                    del self._barriers[(name, epoch)]
                    self._barrier_traces.pop((name, epoch), None)
                    # the latch keeps the barrier's trace so stragglers
                    # polling a completed rendezvous still adopt it
                    self._completed_barriers[(name, epoch)] = btp or True
                    while len(self._completed_barriers) > 256:
                        self._completed_barriers.pop(
                            next(iter(self._completed_barriers)))
                    # the latch is durable: completion is monotone even
                    # across a coordinator restart (a finished member's
                    # leave must not fake an epoch change for peers that
                    # poll the restarted coordinator)
                    self._pending_log.append({"kind": "latch",
                                              "name": name,
                                              "epoch": int(epoch),
                                              "inc": self.incarnation})
                    self._record_skew_locked(name, epoch, arrived, btp)
                    return {"ok": True, "status": "go", **becho,
                            **self._view_locked()}
                return {"ok": True, "status": "wait", **becho,
                        **self._view_locked()}
            if cmd == "report_failure":
                peer = req.get("peer")
                if isinstance(peer, int) and peer in self._last_hb:
                    self._mark_dead_locked(
                        peer, f"reported by rank {rank}: "
                              f"{req.get('code', '?')}: "
                              f"{req.get('msg', '')[:200]}")
                return {"ok": True, **self._view_locked()}
            if cmd == "leave":
                if rank in self._last_hb:
                    self._mark_dead_locked(rank, "left")
                return {"ok": True, **self._view_locked()}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}


# ---------------------------------------------------------------------------
# agent
# ---------------------------------------------------------------------------

class Agent:
    """Per-process membership client: heartbeats on a daemon thread,
    mirrors the coordinator's (epoch, members) view, and guards work
    against membership drift.

    Thread model: the heartbeat thread only ever *advances* the local
    view; readers (:meth:`view`, :meth:`ensure_epoch`) take the same
    lock, so a guard never observes a torn epoch/members pair.
    """

    #: consecutive failed round trips before the coordinator is presumed
    #: dead — one lost packet must not fail a run
    MAX_RPC_FAILURES = 3

    #: largest metrics snapshot a heartbeat will carry (the control
    #: line is capped at net/control.MAX_LINE; the beat must fit with
    #: telemetry + clock beside the snapshot)
    METRICS_MAX_BYTES = 256 * 1024

    #: ship the metrics snapshot on every Nth beat only: serializing a
    #: busy process's registry (hundreds of histogram entries) per beat
    #: is pure overhead at scrape granularity — a snapshot a couple of
    #: heartbeat intervals old is exactly as good to Prometheus, and
    #: the beat itself must stay cheap (GIL-starved beats read as
    #: silence and fence the rank)
    METRICS_EVERY_BEATS = 4

    def __init__(self, address, rank: int,
                 interval_s: Optional[float] = None,
                 timeout_s: Optional[float] = None,
                 join_timeout_s: float = 20.0,
                 reconnect_s: Optional[float] = None):
        self.rank = int(rank)
        self._addr = _parse_address(address)
        self.interval = (heartbeat_interval() if interval_s is None
                         else max(0.01, float(interval_s)))
        self._rpc_timeout = (heartbeat_timeout() if timeout_s is None
                             else max(0.05, float(timeout_s)))
        # knob-coherence gate: a timeout at or below the cadence means
        # every rank misses its window BETWEEN two ordinary beats — the
        # whole gang silently fences itself the moment it forms.  Fail
        # loud at construction with both values in the message instead.
        if self._rpc_timeout <= self.interval:
            raise CylonError(
                Code.Invalid,
                f"rank {self.rank}: CYLON_TPU_HEARTBEAT_TIMEOUT_S="
                f"{self._rpc_timeout:g} must exceed CYLON_TPU_HEARTBEAT_S="
                f"{self.interval:g} — a timeout at or below the heartbeat "
                f"cadence instantly fences every rank")
        self.reconnect_s = (reconnect_window_s() if reconnect_s is None
                            else max(0.0, float(reconnect_s)))
        self._join_timeout = join_timeout_s
        self._lock = threading.Lock()
        self._epoch = -1
        self._coord_inc = -1        # highest coordinator incarnation seen
        self._members: Tuple[int, ...] = ()
        self._world = 0
        self._stop = threading.Event()
        self._coord_down = False
        self._fenced = False        # coordinator declared US dead
        self._silenced = False      # heartbeat_loss fault: stop beating
        # reconnect-window expiry (monotonic), opened when a failure
        # streak crosses MAX_RPC_FAILURES — NOT at the first failure:
        # slow RPC timeouts accruing the streak must not eat the window
        # before a single reconnect attempt is made
        self._window_until: Optional[float] = None
        self._reconnecting = False
        self._thread: Optional[threading.Thread] = None
        self.clock: Optional[obs_fleet.ClockInfo] = None
        self._telemetry_fn: Optional[Callable[[], Dict]] = None
        # journal-replication reply consumer: receives the
        # coordinator's journal_peers/journal_sync/journal_guard fields
        self._journal_fn: Optional[Callable[[Dict], None]] = None
        self._beat_n = 0  # metrics ship every METRICS_EVERY_BEATS
        # the longest gap between two answered heartbeats this agent
        # saw: a starved beat thread (a GIL-holding host pass, a busy
        # card's process) shows here before it turns into a false reap
        self._beat_gap_max_s = 0.0
        self._barrier_trace: Optional[tracectx.TraceContext] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Agent":
        """Join the gang (``hello``, retried while the coordinator comes
        up) and start heartbeating."""
        deadline = time.monotonic() + self._join_timeout
        while True:
            try:
                resp = self._rpc({"cmd": "hello", "rank": self.rank})
                break
            except OSError as e:
                if time.monotonic() >= deadline:
                    raise CoordinatorLost(
                        f"rank {self.rank}: coordinator at "
                        f"{self._addr[0]}:{self._addr[1]} unreachable for "
                        f"{self._join_timeout:g}s joining the gang: "
                        f"{type(e).__name__}: {e}") from e
                time.sleep(min(self.interval, 0.2))
        self._absorb(resp)
        if not resp.get("ok"):
            raise CylonError(Code.Invalid,
                             f"rank {self.rank}: join rejected: {resp}")
        # fleet identity: exports name artifacts by the ELASTIC rank (a
        # context's process rank is 0 on every one-process context) —
        # first agent wins in multi-agent test processes
        obs_fleet.set_rank(self.rank)
        try:
            self.sync_clock()
        except (OSError, ValueError) as e:
            # clock alignment is best-effort at join: the per-heartbeat
            # refinement keeps trying, and a missing offset only degrades
            # trace MERGING, never the run
            log.warning("elastic: rank %d initial clock sync failed: "
                        "%s: %s", self.rank, type(e).__name__, e)
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name=f"cylon-elastic-hb-r{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop heartbeating WITHOUT telling the coordinator — process
        death semantics (the detector will reap us).  Use :meth:`leave`
        for a clean goodbye."""
        self._stop.set()

    def leave(self) -> None:
        self._stop.set()
        try:
            self._rpc({"cmd": "leave", "rank": self.rank})
        except OSError:
            pass  # coordinator already gone; nothing to say goodbye to

    # -- protocol --------------------------------------------------------

    def _rpc(self, obj: Dict) -> Dict:
        """One control verb with incarnation fencing on both edges: the
        request carries the highest coordinator incarnation this agent
        has observed (a stale resurrected coordinator stands down on
        seeing it), and a response carrying an OLDER incarnation — or a
        staleness confession — raises `StaleCoordinatorError`, which
        every failure-accounting path treats exactly like an
        unreachable coordinator.  Any success closes the reconnect
        window the failure-streak paths may have opened."""
        try:
            resilience.fault_point(f"elastic.rpc.r{self.rank}")
        except resilience.InjectedFault as e:
            if e.kind == "coord_partition":
                # one-way drop: the request never reaches the wire
                raise ConnectionError(str(e)) from e
            raise
        with self._lock:
            known = self._coord_inc
        if known >= 0:
            obj = dict(obj, coord_incarnation=known)
        resp = control.request(self._addr, obj,
                               timeout=self._rpc_timeout)
        if resp.get("status") == "stale_coordinator":
            raise StaleCoordinatorError(
                f"rank {self.rank}: responder at {self._addr[0]}:"
                f"{self._addr[1]} is a superseded coordinator "
                f"(incarnation {resp.get('incarnation')})")
        inc = resp.get("incarnation")
        with self._lock:
            stale = isinstance(inc, int) and inc < self._coord_inc
            if not stale:
                self._window_until = None  # a real success closes the
                #                            reconnect window
        if stale:
            raise StaleCoordinatorError(
                f"rank {self.rank}: response carries coordinator "
                f"incarnation {inc} < observed {self._coord_inc} "
                f"(stale resurrection; discarding)")
        return resp

    def _open_window(self) -> float:
        """Open (or read) the reconnect-window deadline: the FULL
        ``reconnect_s`` measured from the moment a failure streak
        crossed ``MAX_RPC_FAILURES`` — shared between the heartbeat and
        barrier threads, so whichever crosses first anchors it."""
        with self._lock:
            if self._window_until is None:
                self._window_until = time.monotonic() + self.reconnect_s
            return self._window_until

    def _declare_lost(self, why: str) -> None:
        with self._lock:
            already = self._coord_down
            self._coord_down = True
        if already:
            return
        obs_spans.instant("elastic.coordinator_lost", rank=self.rank,
                          reason=why[:200])
        obs_fleet.flight_record("coordinator_lost", rank=self.rank,
                                error=why[:500])
        log.warning("elastic: rank %d lost the coordinator: %s",
                    self.rank, why)

    # -- clock alignment + telemetry -------------------------------------

    def sync_clock(self, rounds: Optional[int] = None
                   ) -> Optional[obs_fleet.ClockInfo]:
        """One clock handshake against the coordinator (best of
        ``rounds``, default ``CYLON_TPU_CLOCK_SYNC_N``).  The kept offset
        only improves — a noisier later measurement is discarded unless
        the current one has aged past ``CLOCK_MAX_AGE_S`` (bounded
        staleness under drift).  Returns the kept `ClockInfo`."""
        info = obs_fleet.measure_offset(
            self._rpc, ref=f"{self._addr[0]}:{self._addr[1]}",
            rank=self.rank,
            rounds=clock_sync_rounds() if rounds is None else rounds)
        with self._lock:
            cur = self.clock
            if (cur is None or info.uncertainty_ns < cur.uncertainty_ns
                    or time.monotonic() - cur.measured_mono
                    > CLOCK_MAX_AGE_S):
                self.clock = info
            kept = self.clock
        # publish to the process-wide fleet identity only when we ARE it
        # (in-process multi-agent tests: rank 0 owns the export naming,
        # so it must own the exported clock too)
        if obs_fleet.current_rank() in (None, self.rank):
            obs_fleet.set_clock(kept)
        return kept

    def beat_now(self) -> bool:
        """Push one full heartbeat (clock + telemetry + metrics payload)
        immediately, outside the cadence — the registration fast path a
        serving replica uses right after :meth:`start` so the router's
        placement view carries its serve address and capacity BEFORE the
        first scheduled beat.  Best-effort: False when the coordinator
        was unreachable or answered stale (the beat loop's ordinary
        failure accounting takes over from there)."""
        try:
            self._absorb(self._rpc(self._heartbeat_payload()))
            return True
        except (OSError, ValueError):
            return False

    def attach_telemetry(self, fn: Optional[Callable[[], Dict]]) -> None:
        """Install a callable whose dict result rides every heartbeat
        (e.g. ``QueryService.telemetry``): the coordinator aggregates it
        into the ``status`` verb's fleet-wide serving view."""
        with self._lock:
            self._telemetry_fn = fn

    def attach_journal_sync(self, fn: Optional[Callable[[Dict], None]]) -> None:
        """Install the consumer for the coordinator's journal-replication
        reply fields (``journal_peers`` / ``journal_sync`` /
        ``journal_guard``) — `durable_sync.JournalSyncer.on_heartbeat`.
        The callback runs on the beat thread and must be CHEAP (enqueue
        only); exceptions are swallowed — replication must never cost
        the liveness signal it rides on."""
        with self._lock:
            self._journal_fn = fn

    def _heartbeat_payload(self) -> Dict:
        obj: Dict = {"cmd": "heartbeat", "rank": self.rank}
        with self._lock:
            ci, fn = self.clock, self._telemetry_fn
        if ci is not None:
            obj["clock"] = {"offset_ns": ci.offset_ns,
                            "uncertainty_ns": ci.uncertainty_ns}
        if fn is not None:
            try:
                obj["telemetry"] = fn()
            except Exception as e:  # telemetry must never kill the beat
                log.debug("elastic: rank %d telemetry fn failed: %s: %s",
                          self.rank, type(e).__name__, e)
        # metrics snapshot for the coordinator's fleet-wide OpenMetrics
        # verb, shipped every METRICS_EVERY_BEATS beats (first beat
        # included).  Size-guarded — a pathological registry must cost
        # the METRICS, never the beat (an oversized line trips
        # net/control's MAX_LINE and the rank reads as dead).  The
        # guard serializes with the SAME strict encoder the wire uses
        # (no default=): a registry value only a lenient encoder could
        # handle must be caught HERE, where it costs the metrics, not
        # later in control.request where the TypeError would escape
        # _beat's OSError handling and kill the heartbeat thread.
        # the cadence counter is bumped by the beat thread AND by the
        # immediate caller-side heartbeats (join, telemetry attach) — an
        # unguarded += here is a lost-update race on the ship cadence
        with self._lock:
            ship = self._beat_n % max(1, self.METRICS_EVERY_BEATS) == 0
            self._beat_n += 1
        if ship:
            try:
                m = obs_metrics.snapshot()
                if len(json.dumps(m, sort_keys=True)) \
                        <= self.METRICS_MAX_BYTES:
                    obj["metrics"] = m
                else:
                    log.debug("elastic: rank %d metrics snapshot over %d "
                              "bytes; omitted from heartbeat", self.rank,
                              self.METRICS_MAX_BYTES)
            except Exception as e:  # accounting must never kill the beat
                log.debug("elastic: rank %d metrics snapshot failed: "
                          "%s: %s", self.rank, type(e).__name__, e)
        return obj

    def _absorb(self, resp: Dict) -> None:
        """Fold a coordinator response's view into the local mirror.
        Same-epoch responses still refresh members (ranks JOINING during
        formation don't bump the epoch — only losses do).  An advanced
        incarnation means the coordinator restarted: adopt it (the epoch
        advanced with it, so the ordinary guards drive the resume)."""
        advanced = None
        with self._lock:
            inc = resp.get("incarnation")
            if isinstance(inc, int) and inc > self._coord_inc:
                if self._coord_inc >= 0:
                    advanced = (self._coord_inc, inc)
                self._coord_inc = inc
            epoch = int(resp.get("epoch", -1))
            if epoch > self._epoch:
                self._epoch = epoch
                self._members = tuple(resp.get("members", ()))
                obs_metrics.gauge_set("elastic.epoch", epoch)
            elif epoch == self._epoch and "members" in resp:
                self._members = tuple(resp["members"])
            self._world = int(resp.get("world", self._world))
            if resp.get("status") == "rejected":
                self._fenced = True
        if isinstance(inc, int):
            obs_fleet.set_incarnation(inc)
        if advanced is not None:
            obs_spans.instant("coord.restart_observed", rank=self.rank,
                              from_incarnation=advanced[0],
                              to_incarnation=advanced[1])
            obs_metrics.gauge_set("elastic.incarnation", advanced[1])
            log.warning("elastic: rank %d observed coordinator restart "
                        "(incarnation %d -> %d)", self.rank, *advanced)
        # journal-replication fields ride heartbeat replies;
        # hand them to the syncer OUTSIDE the lock (the callback only
        # enqueues, but a slow consumer must not hold membership state)
        fn = self._journal_fn
        if fn is not None:
            doc = {k: resp[k] for k in ("journal_peers", "journal_sync",
                                        "journal_guard") if k in resp}
            if doc:
                try:
                    fn(doc)
                except Exception as e:  # never cost the beat
                    log.debug("elastic: rank %d journal-sync consumer "
                              "failed: %s: %s", self.rank,
                              type(e).__name__, e)

    def _beat(self) -> None:
        fails = 0
        last_ok = time.monotonic()
        while not self._stop.wait(self.interval):
            try:
                resilience.fault_point(f"elastic.heartbeat.r{self.rank}")
            except resilience.InjectedFault as e:
                if e.kind == "heartbeat_loss":
                    # network partition simulation: the process keeps
                    # computing but the coordinator hears nothing
                    self._silenced = True
                    log.warning("elastic: rank %d heartbeats silenced "
                                "(injected heartbeat_loss)", self.rank)
                    return
                raise
            try:
                resp = self._rpc(self._heartbeat_payload())
            except OSError as e:
                fails += 1
                if fails >= self.MAX_RPC_FAILURES:
                    if not self._ride_out(e, fails):
                        return
                    fails = 0
                continue
            fails = 0
            now = time.monotonic()
            with self._lock:
                self._beat_gap_max_s = max(self._beat_gap_max_s,
                                           now - last_ok)
            last_ok = now
            self._absorb(resp)
            if resp.get("status") == "rejected":
                return  # fenced off: no point heartbeating further
            try:
                # per-heartbeat clock refinement: one cheap round trip,
                # kept only if its uncertainty beats the current offset
                self.sync_clock(rounds=1)
            except (OSError, ValueError):
                pass  # the next beat's failure accounting will notice

    def _ride_out(self, err: Exception, fails: int) -> bool:
        """The bounded reconnect window: with no window the agent fires
        `CoordinatorLost` right here, after ``MAX_RPC_FAILURES`` missed
        ticks; with ``CYLON_TPU_COORD_RECONNECT_S`` > 0 the agent
        instead keeps re-joining (``hello`` — idempotent for a live
        member, and the re-registration a RESTARTED coordinator needs)
        under seeded full-jitter backoff while in-flight local passes
        keep executing and journaling.  Returns True when reconnected
        (the beat loop resumes), False when the window expired, the
        agent was fenced, or it was stopped — `coordinator_down` /
        `fenced` then carry the terminal state to every guard."""
        why = (f"{self.MAX_RPC_FAILURES} heartbeats failed "
               f"({type(err).__name__}: {err})")
        if self.reconnect_s <= 0:
            self._declare_lost(why)
            return False
        # the FULL window, measured from this streak declaration — not
        # from the first failure (whose slow RPC timeouts already cost
        # up to MAX_RPC_FAILURES round trips); the loop below re-reads
        # it every round, so only the opening side effect matters here
        self._open_window()
        with self._lock:
            self._reconnecting = True
        obs_spans.instant("coord.reconnect_wait", rank=self.rank,
                          window_s=self.reconnect_s, failures=fails)
        log.warning("elastic: rank %d coordinator unreachable (%s); "
                    "riding through a %.1fs reconnect window",
                    self.rank, why, self.reconnect_s)
        # full jitter, seeded by rank: survivors of one restart spread
        # their re-joins instead of thundering into the accept loop in
        # lockstep — and each rank's schedule replays deterministically
        policy = resilience.RetryPolicy(
            max_retries=0, base_s=max(self.interval, 0.02),
            max_s=max(4 * self.interval, 0.25), jitter="full",
            jitter_seed=self.rank + 1)
        attempt = 0
        try:
            while True:
                # re-read the SHARED window each round: a concurrent
                # thread's successful RPC (a barrier poll doubling as a
                # reconnect probe) closes it, and declaring the
                # coordinator lost against a stale local deadline after
                # someone else already reconnected would fail a healthy
                # run
                with self._lock:
                    deadline = self._window_until
                now = time.monotonic()
                if deadline is None:
                    log.info("elastic: rank %d reconnect window closed "
                             "by a concurrent successful round trip",
                             self.rank)
                    return True
                if now >= deadline:
                    self._declare_lost(
                        f"reconnect window "
                        f"(CYLON_TPU_COORD_RECONNECT_S="
                        f"{self.reconnect_s:g}s) expired after {attempt} "
                        f"attempts; last error: {why}")
                    return False
                # the raw attempt index keeps the jitter draw advancing
                # (delay() saturates the exponential internally) — a
                # capped index would freeze every late retry at one
                # fixed per-rank delay
                d = min(policy.delay(attempt), max(0.0, deadline - now))
                if self._stop.wait(d):
                    return False
                attempt += 1
                try:
                    resp = self._rpc({"cmd": "hello", "rank": self.rank})
                except OSError as e:
                    why = f"{type(e).__name__}: {e}"
                    continue
                self._absorb(resp)
                if resp.get("status") == "rejected" \
                        or not resp.get("ok", False):
                    # the (possibly restarted) coordinator fenced us off
                    with self._lock:
                        self._fenced = True
                    log.warning("elastic: rank %d rejected on reconnect "
                                "(fenced): %s", self.rank, resp)
                    return False
                obs_spans.instant("coord.reconnect", rank=self.rank,
                                  attempts=attempt,
                                  incarnation=self.incarnation,
                                  epoch=self.epoch)
                obs_metrics.counter_add("coord.reconnect")
                log.warning("elastic: rank %d reconnected to the "
                            "coordinator after %d attempt(s) "
                            "(incarnation=%d, epoch=%d)", self.rank,
                            attempt, self.incarnation, self.epoch)
                # re-registration: push clock + telemetry NOW so the
                # restarted coordinator's status view repopulates without
                # waiting out a full heartbeat interval
                try:
                    self.sync_clock()
                    self._absorb(self._rpc(self._heartbeat_payload()))
                except (OSError, ValueError):
                    pass  # the beat loop's accounting takes over
                return True
        finally:
            with self._lock:
                self._reconnecting = False

    # -- views + guards --------------------------------------------------

    def status(self) -> Optional[Dict]:
        """One read-only ``status`` verb round trip — the coordinator's
        fleet view (per-rank heartbeat ages, clock offsets, the recent
        per-collective skew ledger, serve aggregate).  None when the
        coordinator is unreachable or the reply is not ok; never
        raises (consumers are observability paths — the query profiler
        attaches the skew ledger with this)."""
        try:
            resp = self._rpc({"cmd": "status"})
        except (OSError, ValueError):
            return None
        return resp if resp.get("ok") else None

    def view(self) -> MemberView:
        with self._lock:
            return MemberView(self._epoch, self._members, self._world)

    def wait_formed(self, timeout_s: Optional[float] = None) -> MemberView:
        """Block until every rank of the initial world has JOINED (or
        already been declared dead — a gang can form short-handed if a
        member died during startup).  The formation analog of a
        process group's rendezvous."""
        deadline = time.monotonic() + (self._join_timeout
                                       if timeout_s is None else timeout_s)
        while True:
            if self.coordinator_down:
                raise CoordinatorLost(
                    f"rank {self.rank}: coordinator lost while waiting "
                    f"for the gang to form")
            try:
                resp = self._rpc({"cmd": "status"})
            except OSError:
                resp = None
            if resp is not None:
                self._absorb(resp)
                world = int(resp.get("world", 0))
                if world and (len(resp.get("members", ()))
                              + len(resp.get("dead", {})) >= world):
                    return self.view()
            if time.monotonic() >= deadline:
                raise CylonError(
                    Code.ExecutionError,
                    f"rank {self.rank}: gang did not form (members="
                    f"{list(self.members)} of world {self._world})")
            time.sleep(self.interval)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def incarnation(self) -> int:
        """Highest coordinator incarnation this agent has observed (-1
        before the first response): the fencing token a stale
        resurrected coordinator can never present."""
        with self._lock:
            return self._coord_inc

    @property
    def reconnecting(self) -> bool:
        """True while the agent is inside its bounded reconnect window
        (the coordinator is unreachable but not yet declared lost):
        local passes keep executing and journaling; only membership
        changes stall."""
        with self._lock:
            return self._reconnecting

    @property
    def members(self) -> Tuple[int, ...]:
        with self._lock:
            return self._members

    @property
    def coordinator_down(self) -> bool:
        with self._lock:
            return self._coord_down

    @property
    def fenced(self) -> bool:
        """True once the coordinator explicitly rejected this rank as
        dead: every guard refuses from then on, and the elastic loop
        must stand down instead of resuming — even when the members
        list is empty because the survivors already finished and left
        (the case a membership-only check cannot distinguish from a
        clean shutdown)."""
        with self._lock:
            return self._fenced

    @property
    def barrier_trace(self) -> Optional[tracectx.TraceContext]:
        """The causal trace context the last rendezvous carried (the
        first arrival presenting a ``traceparent`` names it; the
        coordinator echoes it on every poll reply).  A rank arriving
        WITHOUT its own context adopts this one — ``elastic_run``
        activates it around the epoch's work, which is how one serve
        request's trace comes to span every rank of the gang."""
        with self._lock:
            return self._barrier_trace

    @property
    def beat_gap_max_s(self) -> float:
        """The longest gap, in seconds, between two answered heartbeats
        of this agent (its cadence when nothing starves the beat
        thread; the coordinator reaps past its timeout)."""
        with self._lock:
            return self._beat_gap_max_s

    @property
    def silenced(self) -> bool:
        """True once the ``heartbeat_loss`` fault silenced this agent's
        heartbeats (test-observable only): guards deliberately do NOT
        consult it — a genuinely partitioned process cannot know it is
        partitioned, so the silenced agent keeps computing on its stale
        view until the coordinator's rejection fences it."""
        return self._silenced

    def ensure_epoch(self, epoch: int) -> None:
        """The per-pass guard: raise if membership moved under us (or we
        lost the coordinator / were fenced) since ``epoch`` was read."""
        with self._lock:
            if self._coord_down:
                raise CoordinatorLost(
                    f"rank {self.rank}: coordinator at "
                    f"{self._addr[0]}:{self._addr[1]} unreachable "
                    f"({self.MAX_RPC_FAILURES} heartbeats failed)")
            if self._fenced:
                raise EpochChanged(
                    f"rank {self.rank} was declared dead at epoch "
                    f"{self._epoch} (straggler fenced off)")
            if self._epoch != epoch:
                raise EpochChanged(
                    f"membership epoch moved {epoch} -> {self._epoch} "
                    f"(members now {list(self._members)})")

    def barrier(self, name: str, epoch: int) -> MemberView:
        """Rendezvous with every live member of ``epoch``.  Polled (one
        short RPC per heartbeat interval) so failure detection keeps
        running while we wait; raises `EpochChanged` the moment the
        epoch moves — or if we arrive carrying a stale epoch — and
        `CoordinatorLost` when the coordinator stops answering.

        The whole wait is one ``elastic.barrier`` SPAN: the critical-
        path decomposition (tools/critical_path.py) classifies it as
        WAIT time, and — when this rank carries a request trace — the
        span's context is what the barrier verbs present on the wire,
        so the spans remote ranks stamp under the adopted trace hang
        directly off this rank's barrier span in the merged tree."""
        # the span is entered only when the rank can buffer events; the
        # barrier poll itself stays identical either way
        with obs_spans.span("elastic.barrier", collective=name,
                            epoch=epoch, rank=self.rank):
            return self._barrier_inner(name, epoch)

    def _barrier_inner(self, name: str, epoch: int) -> MemberView:
        fails = 0
        # arrival/departure instants are the raw material of cross-rank
        # skew attribution: after trace_merge aligns the clocks, the
        # spread of `collective.arrive` over ranks decomposes each
        # collective's cost into "own work" vs "waiting for the slowest"
        t_arrive = time.perf_counter_ns()
        # the adoption latch is per-rendezvous: cleared on entry and
        # re-latched from this barrier's echo, so a finished request's
        # trace never leaks into a later untraced run's adoption (a
        # straggler polling a completed barrier still re-latches — the
        # coordinator echoes the completed rendezvous's trace)
        with self._lock:
            self._barrier_trace = None
        obs_spans.instant("collective.arrive", collective=name,
                          epoch=epoch, rank=self.rank)
        while True:
            # NOT ensure_epoch: whether a barrier at `epoch` still stands
            # is the COORDINATOR's call (a completed barrier is latched —
            # a finished member's clean leave bumps the local epoch
            # mirror without invalidating it); only local terminal states
            # short-circuit the poll
            with self._lock:
                if self._coord_down:
                    raise CoordinatorLost(
                        f"rank {self.rank}: coordinator unreachable at "
                        f"barrier {name!r}")
                if self._fenced:
                    raise EpochChanged(
                        f"rank {self.rank} was declared dead "
                        f"(straggler fenced off at barrier {name!r})")
            try:
                resp = self._rpc({"cmd": "barrier", "rank": self.rank,
                                  "name": name, "epoch": epoch})
            except OSError as e:
                fails += 1
                if fails >= self.MAX_RPC_FAILURES:
                    # inside the reconnect window the rendezvous STALLS
                    # instead of failing (the heartbeat thread is
                    # re-joining; this poll keeps trying too — barrier
                    # polls double as reconnect probes); past it, or
                    # with the window disabled, the clean fail
                    if (self.reconnect_s <= 0
                            or time.monotonic() >= self._open_window()
                            or self.coordinator_down):
                        self._declare_lost(
                            f"unreachable at barrier {name!r} "
                            f"({fails} attempts: {type(e).__name__}: {e})")
                        raise CoordinatorLost(
                            f"rank {self.rank}: coordinator unreachable "
                            f"at barrier {name!r} ({fails} attempts: "
                            f"{type(e).__name__}: {e})") from e
                time.sleep(self.interval)
                continue
            fails = 0
            self._absorb(resp)
            btp = tracectx.parse_or_none(resp.get("traceparent"))
            if btp is not None:
                with self._lock:
                    self._barrier_trace = btp
            status = resp.get("status")
            if status == "go":
                # the depart instant closes this rank's wait window; when
                # the rank has no context of its own, it is stamped under
                # the barrier's adopted trace so the merged timeline
                # carries the causal edge even before elastic_run
                # activates the adoption for the epoch's work
                adopt = (btp or self.barrier_trace) \
                    if tracectx.current() is None else None
                with tracectx.activate(adopt):
                    obs_spans.instant(
                        "collective.depart", collective=name, epoch=epoch,
                        rank=self.rank,
                        wait_ns=time.perf_counter_ns() - t_arrive)
                return self.view()
            if status in ("epoch_changed", "rejected"):
                obs_spans.instant("elastic.straggler_rejected"
                                  if status == "rejected"
                                  else "elastic.epoch_bump",
                                  rank=self.rank, barrier=name,
                                  stale_epoch=epoch)
                self.ensure_epoch(epoch)  # raises with the precise reason
                raise EpochChanged(      # fenced before any view advanced
                    f"rank {self.rank} rejected at barrier {name!r} "
                    f"(stale epoch {epoch})")
            time.sleep(self.interval)

    def report_failure(self, status: Status, peer: Optional[int] = None
                       ) -> None:
        """Indict a peer (or record a local classified failure) with the
        coordinator — the `Status`-classified path for collective
        failures that implicate a specific rank."""
        try:
            resp = self._rpc({"cmd": "report_failure", "rank": self.rank,
                              "peer": peer, "code": status.code.name,
                              "msg": status.msg})
        except OSError:
            return  # detection falls back to heartbeat timeout
        self._absorb(resp)


def connect(rank: int, address: Optional[str] = None) -> Agent:
    """Agent from the knob configuration (``CYLON_TPU_ELASTIC_COORD``),
    started."""
    addr = address or coordinator_address()
    if not addr:
        raise CylonError(Code.Invalid,
                         "CYLON_TPU_ELASTIC_COORD is unset: an elastic "
                         "context needs a coordinator address")
    return Agent(addr, rank).start()


# ---------------------------------------------------------------------------
# work assignment + the shrink-and-resume loop
# ---------------------------------------------------------------------------

def owned_parts(n_parts: int, rank: int,
                members: Sequence[int]) -> List[int]:
    """The key-domain parts ``rank`` owns under ``members``: part ``p``
    belongs to ``members[p % len(members)]`` (members sorted).  Purely a
    function of (n_parts, membership), so every survivor derives the
    SAME cover of 0..n_parts-1 with no extra coordination — a dead
    rank's parts redistribute onto survivors by construction."""
    ms = sorted(members)
    if rank not in ms:
        raise EpochChanged(f"rank {rank} not in members {ms}")
    i = ms.index(rank)
    return [p for p in range(n_parts) if p % len(ms) == i]


@dataclass
class ElasticSlice:
    """One epoch's slice of an elastic run, handed to the engine: the
    owned part ids, the epoch/world they were derived at (journaled as
    per-pass provenance), and the guard the engine calls between passes
    to abandon in-flight work on membership drift."""

    parts: List[int]
    epoch: int
    world: int
    guard: Callable[[], None]


def elastic_run(agent: Agent, n_parts: int,
                run_parts: Callable[[ElasticSlice], object],
                finalize: Optional[Callable[[], object]] = None,
                run_id: str = "",
                barrier_name: str = "cylon-elastic-done"):
    """Drive one fingerprinted run to completion across membership
    changes.

    Each iteration (one epoch): derive this rank's parts over the live
    membership, execute them through ``run_parts`` (the journaled
    engine — completed parts spill to the shared journal, parts any
    rank already journaled are consumed instead of re-executed), then
    rendezvous.  `EpochChanged` anywhere in that sequence restarts the
    iteration at the new membership — the gang re-init (survivors
    re-form rather than patch a live context).  When
    the rendezvous completes, every part of the run is durably
    journaled and ``finalize`` (typically the same engine invocation
    over ALL parts, which then serves everything from the journal)
    assembles the bit-identical result.

    Raises `CoordinatorLost` (clean, classified) when the control plane
    dies, and `EpochChanged` when THIS rank was fenced off as dead — a
    straggler must stand down, not assemble output.

    ``run_id`` MUST be identical on every rank and unique per logical
    run (the durable run fingerprint is the natural choice): completed
    rendezvous are LATCHED per (barrier name, epoch) on the coordinator
    so a finished member's clean leave cannot fake an epoch change for
    the others — which means a SECOND run reusing the same name at the
    same epoch would rendezvous instantly against the stale latch,
    before its peers journaled anything.  The name is therefore
    namespaced by ``run_id``."""
    resumes = 0
    barrier_name = f"{barrier_name}/{run_id}/{n_parts}"
    if run_id:
        # exports + flight dumps from here on are namespaced by the run
        obs_fleet.set_run_id(run_id)
    agent.wait_formed()
    max_iters = 4 * max(agent.view().world, 1) + 8
    # cross-rank causal adoption: when this rank has no trace context of
    # its own and a rendezvous carried one (a peer rooted in a serve
    # request or an ambient CYLON_TPU_TRACEPARENT), the epoch's work —
    # passes, shuffles, journal IO — runs as a CHILD of that trace, so
    # one request yields one causally-linked trace across the whole gang
    adopted: Optional[tracectx.TraceContext] = None
    with obs_spans.span("elastic.run", rank=agent.rank, n_parts=n_parts):
        for _ in range(max_iters):
            try:
                # the WHOLE derivation sits inside the try: an epoch bump
                # absorbed by the heartbeat thread between view() and
                # ensure_epoch() is an ordinary resume for a healthy
                # survivor, not a reason to escape the loop (the except
                # arm's membership re-check decides true fencing)
                view = agent.view()
                agent.ensure_epoch(view.epoch)  # coordinator/fencing
                view.require_member(agent.rank)
                # start rendezvous: every member proves it derived the
                # SAME epoch before any work dispatches (split-brain at
                # derivation becomes an ordinary resume, not divergent
                # slices), and its cross-rank arrival instants anchor
                # the merged timeline even for runs a straggler never
                # finishes
                agent.barrier(f"{barrier_name}/start", view.epoch)
                if adopted is None and tracectx.current() is None:
                    # adopt the barrier's context AS-IS (no child hop):
                    # spans this rank records become direct children of
                    # the span that presented the traceparent on the
                    # requesting rank, so the merged tree is walkable
                    # edge by edge — a synthetic intermediate span_id
                    # with no event would orphan the whole subtree
                    adopted = agent.barrier_trace
                with tracectx.activate(adopted):
                    sl = ElasticSlice(
                        parts=owned_parts(n_parts, agent.rank,
                                          view.members),
                        epoch=view.epoch, world=len(view.members),
                        guard=_make_guard(agent, view.epoch))
                    run_parts(sl)
                    agent.barrier(barrier_name, view.epoch)
            except EpochChanged as e:
                # fencing dominates the membership check: a straggler
                # whose survivors ALREADY finished and left sees an
                # empty members list, which must not read as "resume"
                if agent.fenced or (agent.view().members and
                                    agent.rank not in agent.view().members):
                    # we are the straggler: stand down — and leave the
                    # post-mortem behind (the fenced rank's view of its
                    # final moments is exactly what the survivor traces
                    # cannot show)
                    obs_fleet.flight_record(
                        "fenced", rank=agent.rank, epoch=agent.epoch,
                        run_id=run_id or None, fence_reason=e.msg[:200])
                    raise
                resumes += 1
                obs_spans.instant("elastic.resume", rank=agent.rank,
                                  from_epoch=view.epoch,
                                  to_epoch=agent.epoch, reason=e.msg[:120])
                obs_metrics.counter_add("elastic.resume")
                log.warning("elastic: rank %d resuming at epoch %d "
                            "(was %d): %s", agent.rank, agent.epoch,
                            view.epoch, e.msg)
                continue
            with tracectx.activate(adopted):
                # the adopted context covers finalize too: journal
                # consumption assembling the result is the request's
                # work, and its stats carry the trace_id
                return finalize() if finalize is not None else None
    raise CylonError(
        Code.ExecutionError,
        f"elastic run did not stabilize after {resumes} membership "
        f"changes ({max_iters} iterations)")


def _make_guard(agent: Agent, epoch: int) -> Callable[[], None]:
    """Per-pass guard bound to the epoch the slice was derived at.  The
    fault probe runs FIRST so ``rank_kill`` fires at exactly the pass
    boundary a preemption would."""
    def guard() -> None:
        # the guard is a SPAN, not free time: an injected `delay` fault
        # (the seeded-straggler harness) sleeps inside the fault probe,
        # and without a span that sleep would be an unattributable gap
        # on the slow rank's timeline — exactly the segment the
        # critical-path decomposition must be able to name
        with obs_spans.span("elastic.pass_guard", rank=agent.rank,
                            epoch=epoch):
            resilience.fault_point(f"elastic.pass.r{agent.rank}")
            agent.ensure_epoch(epoch)
    return guard
