"""Replica side of the fleet query router: one card's `QueryService`
behind a data-plane `JsonServer`.

The port of ``cylon_tpu/router/replica.py``.  A replica is three pieces
wired together:

- a :class:`~cylon_tpu_torch.serve.QueryService` owning the context and
  the admission/shed/deadline/cancel contract;
- a ``net/control.py`` `JsonServer` (with the router's data-plane line
  cap: submit/poll replies carry whole encoded tables) speaking the
  proxy protocol the router drives: ``submit`` admits one decoded
  request and answers a ticket id, ``poll`` reports its state (terminal
  states carry the wire-encoded result or the classified error),
  ``cancel`` forwards `Ticket.cancel`, ``ack`` drops a delivered
  ticket, ``replica_status`` ships `QueryService.stats`;
- an `elastic.Agent` heartbeating the router: :meth:`attach` installs
  :meth:`telemetry` (the service's telemetry extended with this
  replica's ``replica`` record: serve address, capacity, device-memory
  headroom) and pushes one immediate beat, so the replica is in the
  router's placement view before the first scheduled heartbeat.

Tickets live in a bounded table until their terminal state is
acknowledged (the router's ``ack`` verb after it read a terminal poll
reply): a terminal poll does not drop the ticket, so a reply lost on the
wire is regenerated by the retried poll.  Submits carry a router-minted
idempotency ``token``: a retry of an already-admitted submit returns the
same ticket instead of admitting a duplicate, and the router's
cancel-by-token reaps the orphan when a submit reply was lost for good.
Unacknowledged terminal tickets are bounded by count (``TICKET_CAP``,
oldest terminal first) and by age (a terminal ticket nobody polled for
within ~2x the route timeout belongs to a dead router; the reap rides
:meth:`telemetry`).  A dropped request's work is journaled, so a
re-submit replays it.

:meth:`telemetry` runs on the agent's heartbeat thread: it reads the
device-memory watermark with ``torch.cuda.memory_allocated`` of the
service's own card (no synchronize, no device switch).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional

from .. import durable
from .. import durable_sync
from ..net import control
from ..obs import metrics as obs_metrics
from ..serve import service as serve_mod
from ..status import Code, CylonError
from . import wire
from .service import route_timeout_s
from .wire import router_max_line


#: undelivered terminal tickets kept at most this many: a router that
#: died mid-poll must not leak its tickets forever (oldest TERMINAL
#: first — a live ticket is only evicted in the pathological
#: more-than-cap-live-requests case; the dropped request's work is
#: journaled — a re-submit replays it)
TICKET_CAP = 1024

#: floor for the terminal-ticket age reap: a terminal ticket unpolled
#: for max(2x route timeout, this) has no living router waiting on it —
#: its result table is released even on an otherwise idle replica
TICKET_TTL_MIN_S = 60.0

#: minimum seconds between device-memory samples for the heartbeat's
#: headroom record: a GIL-starved beat streak reads as replica death,
#: and the watermark is advisory placement input, so a slightly stale
#: value costs nothing
HBM_SAMPLE_MIN_S = 0.5


class ReplicaServer:
    """Serve one `QueryService` to a query router over the data-plane
    wire.  ``host``/``port`` follow `JsonServer` (port 0 = ephemeral;
    the bound address is ``.address`` and rides :meth:`telemetry`)."""

    def __init__(self, service: serve_mod.QueryService,
                 host: str = "127.0.0.1", port: int = 0,
                 capacity: Optional[int] = None):
        self.service = service
        self.capacity = int(capacity) if capacity is not None \
            else int(service.stats()["queue_cap"])
        self._tickets: Dict[str, serve_mod.Ticket] = {}
        self._by_token: Dict[str, str] = {}   # idempotency token -> req_id
        self._done_seen: Dict[str, float] = {}  # req_id -> first-seen-done ts
        self._hbm_sample: tuple = (0.0, None)  # (monotonic ts, headroom)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._server = control.JsonServer(self._handle, host=host,
                                          port=port,
                                          max_line=router_max_line())
        self.address = self._server.address
        self._server.start()
        # journal self-healing, only when this replica journals:
        # a read-only peer data-plane server over the root, the
        # heartbeat-driven anti-entropy syncer (also the GC replication
        # guard + read-repair peer registry), and — when
        # CYLON_TPU_SCRUB_S > 0 — the background integrity scrubber.
        # With CYLON_TPU_DURABLE_RF=1 the coordinator never hints a pull
        # and never guards a run, so the machinery is inert scaffolding.
        self._journal_server: Optional[durable_sync.JournalPeerServer] = None
        self._journal_syncer: Optional[durable_sync.JournalSyncer] = None
        self._scrubber: Optional[durable_sync.Scrubber] = None
        if durable.enabled():
            self._journal_server = durable_sync.JournalPeerServer(
                durable.durable_dir(), host=host)
            self._journal_syncer = durable_sync.JournalSyncer()
            if durable.scrub_interval_s() > 0:
                self._scrubber = durable_sync.Scrubber().start()

    # -- registration ------------------------------------------------------

    def telemetry(self) -> Dict:
        """The heartbeat payload: `QueryService.telemetry` (queue depth,
        per-tenant SLO) plus this replica's placement record — the
        router's whole routing table is built from these."""
        self._reap_stale_tickets()
        tel = self.service.telemetry()
        budget = serve_mod.hbm_budget_bytes()
        headroom = None
        if budget > 0:
            now = time.monotonic()
            ts, cached = self._hbm_sample
            if cached is None or now - ts >= HBM_SAMPLE_MIN_S:
                cached = max(0, budget - obs_metrics.record_hbm_watermark(
                    self.service.device))
                self._hbm_sample = (now, cached)
            headroom = cached
        tel["replica"] = {
            "addr": [self.address[0], self.address[1]],
            "capacity": self.capacity,
            "hbm_headroom_bytes": headroom,
            # custom ops whose registration declared idempotent=True —
            # the router's hedge-safety gate rides the heartbeat, so a
            # hedge can only land where the registration promised safety
            "idempotent_ops": self.service.idempotent_ops(),
        }
        if self._journal_server is not None \
                and self._journal_syncer is not None:
            # journal advertisement: this root's identity +
            # per-run manifest digests, the coordinator's anti-entropy
            # input (manifest-only — no spill reads on the beat path)
            j = self._journal_syncer.telemetry()
            j["addr"] = [self._journal_server.address[0],
                         self._journal_server.address[1]]
            tel["journal"] = j
        return tel

    def attach(self, agent) -> "ReplicaServer":
        """Register with the router's control plane: telemetry on every
        heartbeat + one immediate beat so placement sees this replica
        NOW (the ``hello`` the agent already sent carried no serve
        address)."""
        agent.attach_telemetry(self.telemetry)
        if self._journal_syncer is not None:
            agent.attach_journal_sync(self._journal_syncer.on_heartbeat)
        agent.beat_now()
        return self

    # -- the proxy verbs ---------------------------------------------------

    def _handle(self, req: Dict) -> Dict:
        cmd = req.get("cmd")
        if cmd == "submit":
            return self._handle_submit(req)
        if cmd == "poll":
            return self._handle_poll(req)
        if cmd == "cancel":
            return self._handle_cancel(req)
        if cmd == "ack":
            return self._handle_ack(req)
        if cmd == "replica_status":
            return {"ok": True, "stats": wire.jsonable(self.service.stats()),
                    "capacity": self.capacity}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def _handle_submit(self, req: Dict) -> Dict:
        tenant = str(req.get("tenant", "default"))
        op = str(req.get("op", ""))
        token = str(req["token"]) if req.get("token") else None
        if token is not None:
            with self._lock:
                known = self._by_token.get(token)
                ticket = self._tickets.get(known) if known else None
            if ticket is not None:
                # idempotent re-submit: a transient-reset retry of an
                # ALREADY-ADMITTED submit (the accept reply was lost)
                # returns the same ticket instead of a duplicate
                return {"ok": True, "req_id": known,
                        "state": ticket.state, "duplicate": True}
        try:
            args, kwargs = wire.decode_payload(req.get("payload"))
        except CylonError as e:
            return {"ok": False, "classified": wire.classified(e)}
        if req.get("deadline_s") is not None:
            kwargs["deadline_s"] = float(req["deadline_s"])
        tp = req.get("traceparent")
        if tp:
            # the route verb's context, forwarded: the serve request is
            # minted as a CHILD of the router's hop, so one routed
            # request is one causally-linked trace across both tiers
            kwargs["traceparent"] = tp
        try:
            ticket = self.service.submit(tenant, op, *args, **kwargs)
        except CylonError as e:
            return {"ok": False, "classified": wire.classified(e),
                    "shed": True}
        with self._lock:
            req_id = f"t{next(self._ids)}"
            self._tickets[req_id] = ticket
            if token is not None:
                self._by_token[token] = req_id
            while len(self._tickets) > TICKET_CAP:
                # evict delivered-but-unacked TERMINAL tickets first; a
                # live queued/running ticket is cancelled only in the
                # pathological more-than-cap-live case (admission sheds
                # long before that), so eviction never converts a
                # healthy in-flight run into an unknown req_id
                stale_id = next((r for r, t in self._tickets.items()
                                 if t.done),
                                next(iter(self._tickets)))
                stale = self._tickets.pop(stale_id)
                if not stale.done:
                    stale.cancel()
                self._purge_locked(stale_id)
        return {"ok": True, "req_id": req_id, "state": ticket.state}

    def _purge_locked(self, rid: str) -> None:
        """Drop a popped ticket's token + reap bookkeeping (lock held)."""
        self._done_seen.pop(rid, None)
        for t, r in list(self._by_token.items()):
            if r == rid:
                del self._by_token[t]

    def _ticket(self, req: Dict) -> Optional[serve_mod.Ticket]:
        with self._lock:
            rid = req.get("req_id")
            if rid is None and req.get("token"):
                rid = self._by_token.get(str(req["token"]))
            return self._tickets.get(str(rid))

    def _drop(self, req: Dict) -> bool:
        with self._lock:
            rid = req.get("req_id")
            if rid is None and req.get("token"):
                rid = self._by_token.get(str(req["token"]))
            ticket = self._tickets.pop(str(rid), None)
            self._purge_locked(str(rid))
        return ticket is not None

    def _reap_stale_tickets(self) -> None:
        """Release terminal tickets no router came back for: an unacked
        terminal ticket pins its whole result table, and the count cap
        only fires on NEW submits — this age-based reap rides the
        heartbeat (telemetry) so an idle replica reclaims the memory
        too.  The TTL is ~2x the route timeout: past that, every caller
        that could have polled has already timed out classified."""
        ttl = max(2.0 * route_timeout_s(), TICKET_TTL_MIN_S)
        now = time.monotonic()
        with self._lock:
            for rid, ticket in list(self._tickets.items()):
                if not ticket.done:
                    continue
                seen = self._done_seen.setdefault(rid, now)
                if now - seen > ttl:
                    del self._tickets[rid]
                    self._purge_locked(rid)

    def _handle_poll(self, req: Dict) -> Dict:
        ticket = self._ticket(req)
        if ticket is None:
            return {"ok": False, "state": "unknown",
                    "classified": wire.classified(CylonError(
                        Code.Invalid,
                        f"unknown req_id {req.get('req_id')!r} (already "
                        f"acknowledged, dropped past TICKET_CAP, or "
                        f"submitted to a prior replica incarnation)"))}
        if not ticket.done:
            return {"ok": True, "state": ticket.state}
        # the ticket STAYS until the router acks: a terminal reply lost
        # on the wire is regenerated by the retried poll, never turned
        # into an unknown-req_id failure for a completed request
        if ticket.error is not None:
            return {"ok": True, "state": ticket.state,
                    "classified": wire.classified(
                        ticket.error if isinstance(ticket.error, CylonError)
                        else CylonError(Code.UnknownError,
                                        str(ticket.error)))}
        try:
            result = wire.encode_value(ticket.result_value)
        except CylonError as e:
            return {"ok": True, "state": "failed",
                    "classified": wire.classified(e)}
        return {"ok": True, "state": "done", "result": result,
                "stats": wire.jsonable(ticket.stats or {}),
                "cache_hit": bool(ticket.cache_hit),
                # how long it sat admitted before it ran: load, which the
                # router's health breaker must not read as sickness
                "queue_wait_s": ticket.queue_wait_s}

    def _handle_cancel(self, req: Dict) -> Dict:
        """Cancel by ``req_id`` OR by idempotency ``token`` — the token
        form is the router's orphan insurance when a submit's accept
        reply was lost (it never learned the req_id)."""
        ticket = self._ticket(req)
        if ticket is None:
            return {"ok": True, "cancelled": False}
        return {"ok": True, "cancelled": bool(ticket.cancel())}

    def _handle_ack(self, req: Dict) -> Dict:
        """The router read a terminal poll reply: the ticket (and its
        token) may drop now.  Best-effort on the router side — an
        unacked terminal ticket still ages out by count (TICKET_CAP)
        or by age (the telemetry-ride reap)."""
        return {"ok": True, "dropped": self._drop(req)}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Stop accepting proxy verbs (the wrapped service is the
        caller's to drain/close — a replica server restart must not
        shed the queue)."""
        if self._scrubber is not None:
            self._scrubber.close()
        if self._journal_syncer is not None:
            self._journal_syncer.close()
        if self._journal_server is not None:
            self._journal_server.close()
        self._server.close()
