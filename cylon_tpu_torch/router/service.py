"""Fleet query router: many serving replicas behind one front door.

The port of ``cylon_tpu/router/service.py``.  One `QueryService` serves
concurrent tenants on one context through one scheduler thread, so its
throughput is capped at that context's card.  This module makes the
elastic coordinator a **query router** fronting N independent serving
replicas, each its own process with its own card context:

- **registration rides the control plane**: each replica runs a
  `QueryService` behind a :class:`~cylon_tpu_torch.router.replica.
  ReplicaServer` and joins the router like an elastic rank (``hello``
  and heartbeats), with its serve address, capacity and live
  queue-depth/device-memory telemetry on the heartbeat payload
  (`ReplicaServer.telemetry`).  ``Agent.beat_now()`` pushes the first
  full beat at once, so a replica is placeable the moment it starts;
- **the `route` verb admits or sheds, never hangs**: a request is placed
  by tenant affinity with a live-load tiebreak (least queue depth, a
  device-memory headroom guard) and proxied to the chosen replica's data
  plane (submit/poll, the ``router.wire`` codec).  When every live
  replica sheds or reports saturation the router answers a classified
  `Code.ResourceExhausted` / `Code.Unavailable` with ``retry_after_s``.
  ``CYLON_TPU_ROUTER_TIMEOUT_S`` bounds a request whose replica wedges
  mid-run with a classified `Code.Timeout`;
- **the shared journal is a fleet-wide result cache**: run fingerprints
  are world-independent, so with one shared ``CYLON_TPU_DURABLE_DIR``
  any replica replays any replica's journaled run.
  ``CYLON_TPU_ROUTER_CACHE_AFFINITY`` additionally steers a repeated
  request (`wire.request_key`, content only) to the replica whose
  in-memory caches are warm, a latency optimization, never a
  correctness requirement;
- **replica death is handled by the membership ledger**: the dead
  replica is fenced by the epoch/incarnation ledger (the router IS the
  coordinator), its queued-not-dispatched requests are re-routed to a
  survivor (``router.reroutes``; never silently lost), and in-flight
  work is abandoned, not retried: the client gets a classified
  retryable `Code.Unavailable` instead of a re-execution.  The router
  itself restarts from `CoordLog` with the routing table rebuilt from
  the next heartbeat round (affinity pins are soft state);
- **hedging and breakers**: with ``CYLON_TPU_ROUTER_HEDGE_MS`` a slow
  hedge-safe request is re-placed on a second replica and the first
  terminal ticket wins; per-replica health breakers skip a replica that
  keeps failing and probe it back after a cooldown;
- **causality flows through the hop**: the route verb runs under the
  caller's presented traceparent (``net/control.py``), every proxied
  submit/poll carries the active context, and the replica's serve
  request becomes a child span: one request, one causally-linked trace
  across router and replicas.

Everything here is host-side stdlib and numpy: no route, placement or
re-route path touches a device.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Set, Tuple

from .. import config
from ..elastic import Coordinator
from ..net import control
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..status import Code, CylonError
from . import wire
from .wire import router_max_line


# ---------------------------------------------------------------------------
# knob accessors (registry rows in config.py::KNOBS)
# ---------------------------------------------------------------------------

def cache_affinity_enabled() -> bool:
    """``CYLON_TPU_ROUTER_CACHE_AFFINITY``: steer repeated request
    fingerprints to the replica that last served them."""
    return bool(config.knob("CYLON_TPU_ROUTER_CACHE_AFFINITY"))


def poll_interval_s() -> float:
    """``CYLON_TPU_ROUTER_POLL_S``: router->replica poll cadence."""
    return max(0.005, float(config.knob("CYLON_TPU_ROUTER_POLL_S")))


def rpc_timeout_s() -> float:
    """``CYLON_TPU_ROUTER_RPC_TIMEOUT_S``: one proxy verb's socket
    timeout."""
    return max(0.05, float(config.knob("CYLON_TPU_ROUTER_RPC_TIMEOUT_S")))


def route_timeout_s() -> float:
    """``CYLON_TPU_ROUTER_TIMEOUT_S``: the absolute per-request bound
    when the caller supplied no deadline."""
    return max(0.1, float(config.knob("CYLON_TPU_ROUTER_TIMEOUT_S")))


def hedge_floor_ms() -> float:
    """``CYLON_TPU_ROUTER_HEDGE_MS``: floor (and cold-start value) for
    the per-fingerprint hedge delay; 0 (default) disables hedging."""
    return max(0.0, float(config.knob("CYLON_TPU_ROUTER_HEDGE_MS")))


def breaker_failures() -> int:
    """``CYLON_TPU_ROUTER_BREAKER_FAILURES``: consecutive classified
    failures (or sustained-slow observations) before a replica's health
    breaker OPENs; 0 disables the breakers entirely."""
    return max(0, int(config.knob("CYLON_TPU_ROUTER_BREAKER_FAILURES")))


def breaker_cooldown_s() -> float:
    """``CYLON_TPU_ROUTER_BREAKER_COOLDOWN_S``: seconds an OPEN breaker
    holds before HALF_OPEN admits one real probe request."""
    return max(0.05,
               float(config.knob("CYLON_TPU_ROUTER_BREAKER_COOLDOWN_S")))


#: consecutive failed proxy verbs against a replica the membership
#: ledger still believes alive before the router treats it as dead
#: anyway (the detector will fence it one heartbeat-timeout later; a
#: routed request must not wait that long to make progress)
MAX_PROXY_FAILURES = 3

#: affinity maps are soft state: bounded, oldest pin evicted first
AFFINITY_CAP = 4096

#: the per-replica counter row, single-sourced: every increment site
#: and the status fallback share this shape
_PER_REPLICA_ZERO = {"served": 0, "shed": 0, "rerouted_away": 0,
                     "hedged_away": 0}

#: the journaled built-in serve ops: fingerprint-idempotent and
#: bit-identical across replicas by the journal's contract, hence
#: always hedge-safe.  A literal twin of serve.service.OPS on purpose —
#: importing serve here would drag the engine (and torch's device
#: runtime) into the router process, which is host-only by design.
HEDGE_SAFE_OPS = frozenset({"join", "join_groupby", "groupby", "sort",
                            "plan", "refresh"})

# breaker states — also the `router.breaker_state[replica=N]` gauge
# values (0 scrapes as healthy, higher is worse)
BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0, 1, 2
_BREAKER_NAMES = {BREAKER_CLOSED: "closed",
                  BREAKER_HALF_OPEN: "half_open",
                  BREAKER_OPEN: "open"}

#: one replica's breaker row (under ``_router_lock``): transitions are
#: host-only dict flips — never an RPC or fsync under the lock
_BREAKER_ZERO = {"state": BREAKER_CLOSED, "strikes": 0, "opened_at": 0.0,
                 "probing": False, "opens": 0, "probes": 0}

#: classified codes that count as a replica-health strike: transient /
#: infrastructure failures.  Deterministic codes (Invalid, a caller's
#: oversize payload) are the CALLER's problem and never open a breaker.
_STRIKE_CODES = (Code.Timeout, Code.Unavailable, Code.UnknownError)


class _Attempt:
    """One placed execution of a routed request (the primary, or its
    hedge): the replica it landed on, the admitted ticket, and the
    per-attempt poll/failure bookkeeping."""

    __slots__ = ("rank", "addr", "req_id", "token", "probe", "is_hedge",
                 "fails", "observed_running", "t_submit", "released")

    def __init__(self, rank: int, addr: Tuple[str, int], req_id: str,
                 token: str, probe: bool, is_hedge: bool):
        self.rank = rank
        self.addr = addr
        self.req_id = req_id
        self.token = token
        self.probe = probe
        self.is_hedge = is_hedge
        self.fails = 0
        self.observed_running = False
        self.t_submit = time.monotonic()
        self.released = False


def _safe_label(s: str) -> str:
    """A tenant/op id as spelled inside a labeled metric key: the
    bracket-pair grammar (``router.x[tenant=a,replica=1]``) reserves
    ``[ ] , =`` — remap them so an adversarial tenant id cannot corrupt
    the exposition (lossy on purpose, labels are reporting)."""
    return (s.replace("[", "(").replace("]", ")")
             .replace(",", ";").replace("=", ":"))


class RouteShed(CylonError):
    """A route-scope admission rejection: the whole fleet (not one
    replica) had no room — same classified contract as a service shed."""


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class QueryRouter(Coordinator):
    """The elastic coordinator, promoted: everything a `Coordinator`
    does (membership, heartbeats, fencing, durable `CoordLog`, the
    ``status``/``metrics`` verbs) plus the ``route`` verb placing and
    proxying query requests over the registered serving replicas.

    One process-level object; replicas connect with ordinary
    `elastic.Agent`\\ s whose telemetry carries a ``replica`` record
    (`ReplicaServer.telemetry`).  Ranks without a replica record are
    plain elastic members — a mixed gang routes only over the serving
    subset.
    """

    def __init__(self, world: int, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout_s: Optional[float] = None,
                 log_dir: Optional[str] = None):
        # instance override BEFORE super().__init__ creates the server:
        # the route verb and its replies carry whole encoded tables, so
        # the router's JsonServer needs the data-plane line cap
        self.SERVER_MAX_LINE = router_max_line()
        self._router_lock = threading.Lock()
        self._tenant_affinity: Dict[str, int] = {}
        self._key_affinity: Dict[str, int] = {}
        self._inflight: Dict[int, int] = {}    # rank -> router-held count
        self._route_ewma_s: Optional[float] = None
        self._route_counts = {"routed": 0, "sheds": 0, "reroutes": 0,
                              "abandoned": 0, "hedges_fired": 0,
                              "hedges_won": 0, "hedges_lost_cancelled": 0}
        self._per_replica: Dict[int, Dict[str, int]] = {}
        self._breakers: Dict[int, Dict] = {}
        # per-fingerprint asymmetric-EWMA p99 of observed route latency
        # (rises fast toward outliers, decays slowly — the tracing
        # layer's tail estimator), bounded like the affinity maps
        self._key_p99_s: Dict[str, float] = {}
        super().__init__(world, host=host, port=port,
                         heartbeat_timeout_s=heartbeat_timeout_s,
                         log_dir=log_dir)

    # -- request handling --------------------------------------------------

    def _handle_inner(self, req: Dict) -> Dict:
        cmd = req.get("cmd")
        if cmd == "route":
            if self.stale:
                return {"ok": False, "status": "stale_coordinator",
                        "incarnation": self.incarnation,
                        "error": "superseded coordinator incarnation"}
            return self._handle_route(req)
        resp = super()._handle_inner(req)
        if cmd == "status" and resp.get("ok"):
            resp["router"] = self.router_status()
        return resp

    # -- placement (host-only decisions) ------------------------------------

    def _replica_view(self) -> Dict[int, Dict]:
        """Snapshot the live serving replicas from heartbeat telemetry:
        rank -> {addr, capacity, reported_depth, headroom}.  One short
        membership-lock hold; the proxy loops never touch shared state
        while blocked on a socket."""
        with self._lock:
            tel = {r: self._telemetry.get(r) for r in self._last_hb}
        view: Dict[int, Dict] = {}
        for rank, t in sorted(tel.items()):
            if not isinstance(t, dict):
                continue
            rep = t.get("replica")
            if not isinstance(rep, dict) or not rep.get("addr"):
                continue  # a plain elastic member, not a serving replica
            try:
                host, port = str(rep["addr"][0]), int(rep["addr"][1])
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            view[rank] = {
                "addr": (host, port),
                "capacity": max(1, int(rep.get("capacity", 1) or 1)),
                "reported_depth": int(t.get("queue_depth", 0) or 0),
                "headroom": rep.get("hbm_headroom_bytes"),
                # custom ops the replica declared hedge-safe
                # (register_op(..., idempotent=True)), heartbeat-shipped
                "idempotent_ops": frozenset(
                    str(x) for x in (rep.get("idempotent_ops") or ())),
            }
        obs_metrics.gauge_set("router.replicas_live", len(view))
        return view

    def _retry_after(self, depth: int) -> float:
        with self._router_lock:
            per = self._route_ewma_s
        return max(0.05, (per if per is not None else 0.25)
                   * max(1, depth + 1))

    def _shed_route(self, tenant: str, code: Code, reason: str,
                    retry_after: Optional[float]) -> RouteShed:
        """Build (don't count) a fleet-scope shed: a rotation candidate
        may still be accepted elsewhere — only the shed actually
        RETURNED to the client is accounted (`_handle_route`)."""
        hint = "" if retry_after is None \
            else f"; retry after ~{retry_after:.2f}s"
        return RouteShed(code, f"request shed at the router for tenant "
                               f"{tenant!r}: {reason}{hint}",
                         retry_after_s=retry_after)

    def _place(self, tenant: str, key: str, est_bytes: int,
               exclude: Set[int]) -> Tuple[int, Tuple[str, int], bool]:
        """Choose AND reserve one replica, or raise a classified
        `RouteShed`; returns ``(rank, addr, probe)`` where ``probe``
        marks the request as a HALF_OPEN breaker's one live health
        probe.  Order: cache affinity (a warm replica, when the knob is
        on), then the tenant's pin, then least live load — affinity
        never overrides saturation or the HBM-headroom guard, it only
        breaks ties among replicas that can actually take the request.
        Health breakers COMPOSE with that order (they never override
        fencing, affinity or saturation): an OPEN replica is dropped
        from the candidate set exactly like a fenced one, a HALF_OPEN
        replica admits one probe request (preferred to the front, so
        recovery is not starved by a healthy pin), and when the breakers
        leave nothing the request sheds classified with the shortest
        remaining cooldown as its retry hint.

        The live-load tiebreak adds the router-held in-flight count to
        the (heartbeat-lagged) reported depth, and the chosen replica's
        count is incremented under the SAME lock hold as the decision —
        a reservation, so a burst of concurrent routes spreads over the
        fleet instead of every placement reading the same stale zero
        and piling onto one replica.  The caller releases it
        (`_note_inflight(rank, -1)`) at terminal state or submit
        failure.  The fleet-saturation pre-check uses reported depth
        only (conservative): the replica's own admission control is the
        authority, and its shed rotates the router onward."""
        view = self._replica_view()
        cands = {r: v for r, v in view.items() if r not in exclude}
        if not cands:
            raise self._shed_route(
                tenant, Code.Unavailable,
                f"no live serving replicas "
                f"({len(view)} registered, {len(exclude)} excluded)",
                self.timeout)
        fits = {r: v for r, v in cands.items()
                if not (isinstance(v["headroom"], (int, float))
                        and est_bytes > 0 and v["headroom"] < est_bytes)}
        if not fits:
            raise self._shed_route(
                tenant, Code.ResourceExhausted,
                f"no replica reports {est_bytes} bytes of HBM headroom",
                self._retry_after(min(v["reported_depth"]
                                      for v in cands.values())))
        if all(v["reported_depth"] >= v["capacity"]
               for v in fits.values()):
            raise self._shed_route(
                tenant, Code.ResourceExhausted,
                f"every serving replica is saturated "
                f"({len(fits)} replicas at capacity)",
                self._retry_after(
                    min(v["reported_depth"] for v in fits.values())))
        breakers_on = breaker_failures() > 0
        with self._router_lock:
            now = time.monotonic()
            admit: Dict[int, bool] = {}   # rank -> is-probe
            for r in fits:
                ok, as_probe = (self._breaker_admit_locked(r, now)
                                if breakers_on else (True, False))
                if ok:
                    admit[r] = as_probe
            if not admit:
                # every fit replica's breaker is open: classified shed
                # with the shortest remaining cooldown as the hint
                cd = breaker_cooldown_s()
                wait = min((max(0.05, cd - (now - self._breakers[r]
                                            ["opened_at"]))
                            for r in fits if r in self._breakers),
                           default=cd)
                raise self._shed_route(
                    tenant, Code.Unavailable,
                    f"every live replica's health breaker is open "
                    f"({len(fits)} replicas)", wait)
            order = sorted(
                admit, key=lambda r: (fits[r]["reported_depth"]
                                      + self._inflight.get(r, 0), r))
            pin = self._tenant_affinity.get(tenant)
            warm = self._key_affinity.get(key) \
                if cache_affinity_enabled() else None
            for preferred in (pin, warm):  # last to front wins: warm
                # the saturation gate counts the router's own in-flight
                # reservations too: a burst sharing a tenant within one
                # heartbeat period must not all read the same stale
                # reported-zero and pile onto the pinned replica
                if preferred in order \
                        and fits[preferred]["reported_depth"] \
                        + self._inflight.get(preferred, 0) \
                        < fits[preferred]["capacity"]:
                    order.remove(preferred)
                    order.insert(0, preferred)
            # a HALF_OPEN replica's probe outranks even the pin: the
            # fleet gets its capacity back only if one real request
            # actually lands there
            probe_rank = next((r for r in order if admit[r]), None)
            if probe_rank is not None:
                order.remove(probe_rank)
                order.insert(0, probe_rank)
            chosen = order[0]
            probe = admit[chosen]
            if probe:
                b = self._breaker_locked(chosen)
                b["probing"] = True
                b["probes"] += 1
            self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
        return chosen, fits[chosen]["addr"], probe

    def _pin(self, table: Dict, key, rank: int) -> None:
        table.pop(key, None)
        table[key] = rank
        while len(table) > AFFINITY_CAP:
            table.pop(next(iter(table)))

    def _replica_dead(self, rank: int) -> bool:
        with self._lock:
            return rank in self._dead or rank not in self._last_hb

    # -- replica health breakers (host-only transitions) -------------------

    def _breaker_locked(self, rank: int) -> Dict:
        """One replica's breaker row; call holding ``_router_lock``."""
        return self._breakers.setdefault(rank, dict(_BREAKER_ZERO))

    def _breaker_set_locked(self, b: Dict, rank: int, state: int) -> None:
        b["state"] = state
        obs_metrics.gauge_set(f"router.breaker_state[replica={rank}]",
                              state)

    def _breaker_admit_locked(self, rank: int, now: float
                              ) -> Tuple[bool, bool]:
        """``(admit, as_probe)`` for one placement candidate; call
        holding ``_router_lock``.  OPEN past its cooldown transitions to
        HALF_OPEN here (the timed probe window opens lazily, on the next
        placement that wants the replica)."""
        b = self._breakers.get(rank)
        if b is None or b["state"] == BREAKER_CLOSED:
            return True, False
        if b["state"] == BREAKER_OPEN:
            if now - b["opened_at"] < breaker_cooldown_s():
                return False, False
            self._breaker_set_locked(b, rank, BREAKER_HALF_OPEN)
            b["probing"] = False
        # HALF_OPEN: exactly one real request probes at a time
        if b["probing"]:
            return False, False
        return True, True

    def _breaker_outcome(self, rank: int, ok: bool, slow: bool = False,
                         probe: bool = False) -> None:
        """Feed one classified outcome into a replica's breaker.  A
        clean completion resets the strike streak (and re-closes a
        HALF_OPEN breaker when it was the probe); a failure or a
        sustained-slow observation strikes, and ``breaker_failures()``
        consecutive strikes — or any failed probe — OPEN the breaker."""
        if breaker_failures() <= 0:
            return
        now = time.monotonic()
        with self._router_lock:
            b = self._breaker_locked(rank)
            if probe:
                b["probing"] = False
            if ok and not slow:
                b["strikes"] = 0
                if b["state"] == BREAKER_HALF_OPEN and probe:
                    self._breaker_set_locked(b, rank, BREAKER_CLOSED)
                    opened = False
                else:
                    return
            else:
                b["strikes"] += 1
                opened = (b["state"] == BREAKER_HALF_OPEN or probe
                          or b["strikes"] >= breaker_failures())
                if opened:
                    b["strikes"] = 0
                    b["probing"] = False
                    b["opened_at"] = now
                    b["opens"] += 1
                    self._breaker_set_locked(b, rank, BREAKER_OPEN)
                else:
                    return
        # transitions only, outside the lock: one instant per flip
        obs_spans.instant("router.breaker",
                          replica=rank,
                          state=_BREAKER_NAMES[BREAKER_OPEN if opened
                                               else BREAKER_CLOSED])

    def _breaker_force_open(self, rank: int, why: str) -> None:
        """Fencing/breaker agreement: a replica the membership ledger
        fenced (or the proxy path declared unreachable) is OPEN by
        definition — the two subsystems must never disagree on a dead
        replica."""
        if breaker_failures() <= 0:
            return
        with self._router_lock:
            b = self._breaker_locked(rank)
            if b["state"] == BREAKER_OPEN:
                return
            b["strikes"] = 0
            b["probing"] = False
            b["opened_at"] = time.monotonic()
            b["opens"] += 1
            self._breaker_set_locked(b, rank, BREAKER_OPEN)
        obs_spans.instant("router.breaker", replica=rank, state="open",
                          reason=why)

    def _breaker_clear_probe(self, rank: int) -> None:
        """Release a probe slot without a health verdict (the probe
        request was shed at admission or never started) so the next
        request can probe instead of the window staying wedged."""
        with self._router_lock:
            b = self._breakers.get(rank)
            if b is not None:
                b["probing"] = False

    def _slow_threshold_locked(self) -> float:
        """Latency past which a completion counts as p99 inflation (a
        strike): well past the fleet's own route EWMA, with a floor so
        a cold fleet never strikes on its first compile."""
        per = self._route_ewma_s
        return max(0.25, 4.0 * (per if per is not None else 0.25))

    def _is_slow(self, dur: float) -> bool:
        with self._router_lock:
            return dur > self._slow_threshold_locked()

    # -- the route verb ----------------------------------------------------

    def _handle_route(self, req: Dict) -> Dict:
        tenant = str(req.get("tenant", "default"))
        op = str(req.get("op", ""))
        payload = req.get("payload")
        t0 = time.monotonic()
        try:
            if not op or not isinstance(payload, dict):
                raise CylonError(
                    Code.Invalid,
                    f"malformed route request (op={op!r}, payload is "
                    f"{type(payload).__name__})")
            with obs_spans.span("router.route", tenant=tenant, op=op):
                out = self._route(tenant, op, payload, req, t0)
        except CylonError as e:
            if isinstance(e, RouteShed):
                with self._router_lock:
                    self._route_counts["sheds"] += 1
                obs_metrics.counter_add("router.sheds")
                obs_metrics.counter_add(
                    f"router.sheds[tenant={_safe_label(tenant)}]")
                obs_spans.instant("router.shed", tenant=tenant,
                                  code=e.code.name, reason=e.msg[:200])
            return {"ok": False, "classified": wire.classified(e),
                    **self._ie()}
        dur = time.monotonic() - t0
        with self._router_lock:
            self._route_counts["routed"] += 1
            rank = out["replica"]
            self._per_locked(rank)["served"] += 1
            if not out.get("cache_hit"):
                self._route_ewma_s = dur if self._route_ewma_s is None \
                    else 0.7 * self._route_ewma_s + 0.3 * dur
        obs_metrics.counter_add("router.requests_routed")
        obs_metrics.counter_add(
            f"router.requests_routed[tenant={_safe_label(tenant)},"
            f"replica={out['replica']}]")
        return {"ok": True, **out, **self._ie()}

    def _ie(self) -> Dict:
        return {"incarnation": self.incarnation, "epoch": self._epoch}

    def _route(self, tenant: str, op: str, payload: Dict, req: Dict,
               t0: float) -> Dict:
        """Place + proxy one request to completion (or a classified
        failure) — never a hang: the caller's ``deadline_s`` (or the
        ``CYLON_TPU_ROUTER_TIMEOUT_S`` default) bounds the whole
        journey including re-routes."""
        caller_deadline = req.get("deadline_s")
        deadline_s = float(caller_deadline) \
            if caller_deadline is not None else route_timeout_s()
        deadline = t0 + max(0.05, deadline_s)
        key = wire.request_key(op, payload)
        est = max(0, int(req.get("est_bytes", 0) or 0))
        submit = {"cmd": "submit", "tenant": tenant, "op": op,
                  "payload": payload}
        if caller_deadline is not None:
            # only an EXPLICIT caller budget overrides the replica's
            # tenant deadline table; the router's default bound stays a
            # router-side watchdog, not a per-request budget rewrite
            submit["deadline_s"] = float(caller_deadline)
        exclude: Set[int] = set()
        reroutes = 0
        last_shed: Optional[CylonError] = None
        while True:
            if time.monotonic() >= deadline:
                raise last_shed or CylonError(
                    Code.Timeout,
                    f"route exceeded its {deadline_s:g}s bound before "
                    f"any replica accepted (tenant {tenant!r})")
            try:
                rank, addr, probe = self._place(tenant, key, est, exclude)
            except RouteShed as e:
                # replicas excluded for SHEDDING make "nothing is left"
                # the fleet-saturation case: the last replica-level
                # classified shed (with its retry hint) explains it
                # better than the bare placement view
                raise last_shed or e
            # a fresh idempotency token per placement attempt: the
            # replica dedups control.request's transient-reset retry of
            # an ALREADY-ADMITTED submit (same bytes, same token) back
            # to the same ticket instead of admitting a duplicate
            submit["token"] = token = uuid.uuid4().hex
            try:
                resp = control.request(addr, submit,
                                       timeout=rpc_timeout_s(),
                                       max_line=self.SERVER_MAX_LINE)
            except OSError:
                # no reply — but the submit MAY have been admitted (a
                # reply lost for good, past the token-dedup'd retry).
                # Reap the possible orphan by token; trying the next
                # replica then stays placement, not a re-route.
                self._note_inflight(rank, -1)
                self._breaker_outcome(rank, ok=False, probe=probe)
                self._try_cancel(addr, None, token=token)
                exclude.add(rank)
                continue
            if not resp.get("ok"):
                self._note_inflight(rank, -1)
                if probe:
                    # an admission shed says nothing about health —
                    # release the probe slot, don't judge
                    self._breaker_clear_probe(rank)
                c = resp.get("classified")
                if c is None and resp.get("error"):
                    c = {"msg": str(resp["error"])}
                err = wire.classified_error(c)
                if err.code in (Code.ResourceExhausted, Code.Unavailable):
                    # one replica's shed is not the fleet's: rotate to
                    # the next candidate (_place raises the fleet-wide
                    # classified shed once every replica is excluded)
                    with self._router_lock:
                        self._per_locked(rank)["shed"] += 1
                    last_shed = self._shed_route(
                        tenant, err.code,
                        f"replica {rank} shed: {err.msg}",
                        err.retry_after_s)
                    exclude.add(rank)
                    continue
                raise err  # deterministic (Invalid etc.): propagate
            req_id = str(resp.get("req_id"))
            if reroutes == 0:
                # pin at ACCEPT, not completion: the very next request
                # of this tenant (or of this fingerprint) should land
                # where the queue is forming
                with self._router_lock:
                    self._pin(self._tenant_affinity, tenant, rank)
                    self._pin(self._key_affinity, key, rank)
            primary = _Attempt(rank, addr, req_id, token, probe=probe,
                               is_hedge=False)
            done = self._drive(tenant, op, key, primary, deadline,
                               submit, est, exclude)
            if done is not None:
                with self._router_lock:
                    self._pin(self._key_affinity, key, done["replica"])
                return {**done, "reroutes": reroutes}
            # every attempt died with the request queued-not-dispatched:
            # re-route it to a survivor — never silently lost
            reroutes += 1
            exclude.add(rank)
            with self._router_lock:
                self._route_counts["reroutes"] += 1
                self._per_locked(rank)["rerouted_away"] += 1
            obs_metrics.counter_add("router.reroutes")
            obs_metrics.counter_add(f"router.reroutes[replica={rank}]")
            obs_spans.instant("router.reroute", tenant=tenant, op=op,
                              dead_replica=rank)

    def _per_locked(self, rank: int) -> Dict[str, int]:
        """One replica's counter row; call holding ``_router_lock``."""
        return self._per_replica.setdefault(rank,
                                            dict(_PER_REPLICA_ZERO))

    def _note_inflight(self, rank: int, delta: int) -> None:
        with self._router_lock:
            n = self._inflight.get(rank, 0) + delta
            if n > 0:
                self._inflight[rank] = n
            else:
                self._inflight.pop(rank, None)

    # -- the proxy drive loop (hedged requests live here) ------------------

    def _note_latency(self, key: str, dur: float) -> None:
        """Fold one observed route latency into the per-fingerprint
        asymmetric-EWMA p99 (rises fast toward outliers, decays slowly
        — the tracing layer's tail estimator): the hedge delay for the NEXT
        request of this fingerprint."""
        with self._router_lock:
            est = self._key_p99_s.pop(key, None)
            if est is None:
                est = dur
            elif dur > est:
                est += 0.5 * (dur - est)
            else:
                est -= 0.01 * (est - dur)
            self._key_p99_s[key] = est
            while len(self._key_p99_s) > AFFINITY_CAP:
                self._key_p99_s.pop(next(iter(self._key_p99_s)))

    def _hedge_delay_s(self, op: str, key: str,
                       primary_rank: int) -> Optional[float]:
        """Seconds after the primary submit before a hedge may fire, or
        None when this request must never hedge: hedging off (the
        ``CYLON_TPU_ROUTER_HEDGE_MS`` floor is 0), or a custom op whose
        registration on the PRIMARY replica did not declare
        ``idempotent=True`` — a speculative duplicate of a handler with
        unknown side effects is exactly the bug the opt-in exists to
        prevent.  The built-in journaled ops are always safe (the
        journal's fingerprint-idempotency contract)."""
        floor = hedge_floor_ms()
        if floor <= 0:
            return None
        if op not in HEDGE_SAFE_OPS:
            v = self._replica_view().get(primary_rank)
            if v is None or op not in v["idempotent_ops"]:
                return None
        with self._router_lock:
            est = self._key_p99_s.get(key)
        return max(floor / 1000.0, est if est is not None else 0.0)

    def _release(self, a: _Attempt) -> None:
        if not a.released:
            a.released = True
            self._note_inflight(a.rank, -1)

    def _try_hedge(self, tenant: str, op: str, key: str, submit: Dict,
                   est: int, attempts: List[_Attempt], exclude: Set[int],
                   hedge_exclude: Set[int]) -> Optional[_Attempt]:
        """Speculatively place the request on a SECOND replica.  Returns
        the admitted hedge attempt, or None when no eligible replica
        could take it right now (the caller may try again next tick).
        Custom ops restrict the target set to replicas whose telemetry
        declares the op idempotent — a hedge lands only where the
        registration promised safety."""
        avoid = exclude | hedge_exclude | {a.rank for a in attempts}
        if op not in HEDGE_SAFE_OPS:
            view = self._replica_view()
            avoid |= {r for r, v in view.items()
                      if op not in v["idempotent_ops"]}
        try:
            rank, addr, probe = self._place(tenant, key, est, avoid)
        except RouteShed:
            return None
        sub = dict(submit)
        sub["token"] = token = uuid.uuid4().hex
        try:
            resp = control.request(addr, sub, timeout=rpc_timeout_s(),
                                   max_line=self.SERVER_MAX_LINE)
        except OSError:
            self._note_inflight(rank, -1)
            self._breaker_outcome(rank, ok=False, probe=probe)
            self._try_cancel(addr, None, token=token)
            hedge_exclude.add(rank)
            return None
        if not resp.get("ok"):
            # a shed (or any refusal) of the SPECULATIVE copy never
            # fails or sheds the request — the primary is still running
            self._note_inflight(rank, -1)
            if probe:
                self._breaker_clear_probe(rank)
            hedge_exclude.add(rank)
            return None
        return _Attempt(rank, addr, str(resp.get("req_id")), token,
                        probe=probe, is_hedge=True)

    def _drive(self, tenant: str, op: str, key: str, primary: _Attempt,
               deadline: float, submit: Dict, est: int,
               exclude: Set[int]) -> Optional[Dict]:
        """Drive one admitted request to a terminal state, hedging onto
        a second replica when the primary outlives the fingerprint's
        hedge delay.  Returns the winner's terminal dict (with
        ``replica``/``hedged``/``hedge_won``), raises the classified
        error, or returns None when EVERY attempt died with the request
        queued-not-dispatched (the caller re-routes).

        First terminal ticket wins; losers are proxy-cancelled (the
        serve layer stops them at a pass boundary) and their replicas
        take a sustained-slow breaker strike — losing your own request
        to a hedge IS the p99-inflation signal.  A death after a ticket
        was observed ``running`` abandons that ATTEMPT; the request
        itself survives as long as another attempt lives (the hedge
        exists only for idempotent ops, so the duplicate execution the
        abandon contract bans was already declared safe).

        Two contracts the wire imposes: (a) the queued-vs-running
        distinction is observed at POLLING granularity — exact for the
        journaled built-in ops (a survivor consumes the dead replica's
        journaled passes bit-identically); (b) a terminal reply read
        here is ACKNOWLEDGED back to the replica — the ticket survives
        a reply lost on the wire and drops only on the ack."""
        attempts: List[_Attempt] = [primary]
        hedge_exclude: Set[int] = set()
        hedge_fired = False
        hedge_tries = 0
        delay = self._hedge_delay_s(op, key, primary.rank)
        hedge_at = None if delay is None else primary.t_submit + delay
        try:
            while True:
                now = time.monotonic()
                if now >= deadline:
                    for a in attempts:
                        self._try_cancel(a.addr, a.req_id)
                        self._breaker_outcome(a.rank, ok=False,
                                              probe=a.probe)
                    raise CylonError(
                        Code.Timeout,
                        f"routed request exceeded its deadline on "
                        f"replica(s) "
                        f"{sorted(a.rank for a in attempts)} (tenant "
                        f"{tenant!r}); proxied ticket(s) cancelled at "
                        f"the next pass boundary")
                if hedge_at is not None and not hedge_fired \
                        and now >= hedge_at and len(attempts) == 1:
                    hedge_tries += 1
                    if hedge_tries > 3:
                        hedge_at = None  # stop shopping a hedge around
                    else:
                        a2 = self._try_hedge(tenant, op, key, submit,
                                             est, attempts, exclude,
                                             hedge_exclude)
                        if a2 is not None:
                            attempts.append(a2)
                            hedge_fired = True
                            with self._router_lock:
                                self._route_counts["hedges_fired"] += 1
                            obs_metrics.counter_add("router.hedges_fired")
                            obs_spans.instant(
                                "router.hedge_fired", tenant=tenant,
                                op=op, primary=primary.rank,
                                hedge=a2.rank, delay_s=round(delay, 4))
                for a in list(attempts):
                    kind, val = self._poll_attempt_once(tenant, a)
                    if kind == "done":
                        return self._settle(tenant, key, attempts, a,
                                            val, hedge_fired)
                    if kind == "error":
                        if isinstance(val, CylonError) \
                                and val.code in _STRIKE_CODES:
                            self._breaker_outcome(a.rank, ok=False,
                                                  probe=a.probe)
                        elif a.probe:
                            self._breaker_clear_probe(a.rank)
                        if len(attempts) > 1:
                            # the OTHER attempt may still win: a
                            # per-replica transient must not fail a
                            # request whose hedge is healthy
                            attempts.remove(a)
                            self._release(a)
                            exclude.add(a.rank)
                            continue
                        raise val
                    if kind == "dead":
                        self._breaker_force_open(
                            a.rank, "unreachable from the proxy path")
                        if len(attempts) > 1:
                            self._try_cancel(a.addr, a.req_id)
                            attempts.remove(a)
                            self._release(a)
                            exclude.add(a.rank)
                            continue
                        # sole attempt: the plain replica-death contract
                        # (None re-routes queued work; observed-running
                        # raises the abandon-don't-retry classified)
                        return self._on_replica_death(
                            tenant, a.rank, a.addr, a.req_id,
                            a.observed_running)
                time.sleep(poll_interval_s())
        finally:
            for a in attempts:
                self._release(a)

    def _settle(self, tenant: str, key: str, attempts: List[_Attempt],
                winner: _Attempt, done: Dict, hedge_fired: bool) -> Dict:
        """First terminal ticket wins: cancel every loser (the serve
        layer stops it at a pass boundary), strike its replica's breaker
        (losing to a hedge is the latency-inflation signal), and feed
        the winner's latency into the fingerprint's hedge clock.  The
        breaker judges the winner's SERVICE time: the time it sat in the
        replica's admission queue is load (placement and admission
        answer it), and striking on it would open the breaker of the
        busiest replica — the sole survivor of a fleet — exactly when
        the fleet needs it most."""
        dur = time.monotonic() - winner.t_submit
        waited = float(done.pop("queue_wait_s", None) or 0.0)
        self._note_latency(key, dur)
        for o in attempts:
            if o is winner:
                continue
            self._try_cancel(o.addr, o.req_id)
            self._release(o)
            self._breaker_outcome(o.rank, ok=False, slow=True,
                                  probe=o.probe)
            with self._router_lock:
                self._route_counts["hedges_lost_cancelled"] += 1
                self._per_locked(o.rank)["hedged_away"] += 1
            obs_metrics.counter_add("router.hedges_lost_cancelled")
            obs_spans.instant("router.hedge_lost", tenant=tenant,
                              replica=o.rank, winner=winner.rank)
        self._breaker_outcome(winner.rank, ok=True,
                              slow=self._is_slow(max(0.0, dur - waited)),
                              probe=winner.probe)
        if winner.is_hedge:
            with self._router_lock:
                self._route_counts["hedges_won"] += 1
            obs_metrics.counter_add("router.hedges_won")
        return {**done, "replica": winner.rank,
                "hedged": 1 if hedge_fired else 0,
                "hedge_won": winner.is_hedge}

    def _poll_attempt_once(self, tenant: str,
                           a: _Attempt) -> Tuple[str, Optional[object]]:
        """One poll round for one attempt: ``("pending", None)``,
        ``("done", terminal-dict)``, ``("error", CylonError)`` (already
        acked when terminal), or ``("dead", None)`` — the replica is
        fenced/unreachable and the caller decides what that means for
        the request (re-route, abandon, or drop-the-attempt)."""
        if self._replica_dead(a.rank):
            return "dead", None
        try:
            resp = control.request(a.addr,
                                   {"cmd": "poll", "req_id": a.req_id},
                                   timeout=rpc_timeout_s(),
                                   max_line=self.SERVER_MAX_LINE)
        except control.ProtocolError as e:
            # DETERMINISTIC, not a death: the reply exceeds the
            # data-plane line cap — every retry would fail the same
            # way, and counting it toward MAX_PROXY_FAILURES would
            # declare a healthy replica dead and re-route into the
            # same wall.  Same classification the request path gives
            # oversize, naming the knob; the terminal ticket is acked
            # away so the replica doesn't hold it forever.
            self._try_ack(a.addr, a.req_id)
            return "error", CylonError(
                Code.SerializationError,
                f"replica {a.rank}'s reply exceeds the "
                f"{self.SERVER_MAX_LINE}-byte "
                f"CYLON_TPU_ROUTER_MAX_LINE_BYTES wire cap (tenant "
                f"{tenant!r}); raise the knob (router AND replicas) "
                f"or ship less data per request")
        except OSError:
            a.fails += 1
            if a.fails >= MAX_PROXY_FAILURES or self._replica_dead(a.rank):
                return "dead", None
            return "pending", None
        a.fails = 0
        state = resp.get("state")
        if not resp.get("ok"):
            if state == "unknown":
                # the replica lost track of an ADMITTED ticket
                # (TICKET_CAP eviction, a data-plane restart): the
                # replica's failure, not the caller's — classified
                # RETRYABLE, never the replica's unknown-req_id
                # Code.Invalid (which would read as a caller bug)
                return "error", CylonError(
                    Code.Unavailable,
                    f"replica {a.rank} lost track of an admitted "
                    f"request (ticket evicted or replica restarted; "
                    f"tenant {tenant!r}) — resubmit to replay "
                    f"journaled passes",
                    retry_after_s=self._retry_after(0))
            return "error", wire.classified_error(resp.get("classified"))
        if state == "done":
            self._try_ack(a.addr, a.req_id)
            return "done", {"result": resp.get("result"),
                            "stats": resp.get("stats"),
                            "cache_hit": bool(resp.get("cache_hit")),
                            "queue_wait_s": resp.get("queue_wait_s")}
        if state in ("failed", "cancelled", "shed"):
            self._try_ack(a.addr, a.req_id)
            return "error", wire.classified_error(resp.get("classified"))
        if state == "running":
            a.observed_running = True
        return "pending", None

    def _on_replica_death(self, tenant: str, rank: int,
                          addr: Tuple[str, int], req_id: str,
                          observed_running: bool) -> Optional[Dict]:
        if not observed_running:
            # queued-not-dispatched: the caller re-routes.  The replica
            # may be merely UNREACHABLE (3 failed RPCs, not yet fenced)
            # rather than dead — best-effort cancel the queued ticket
            # first, so a replica that recovers does not run work the
            # survivor is about to run too (swallowed if it really died)
            self._try_cancel(addr, req_id)
            return None
        # in-flight on a dead replica: abandon, don't retry — re-running
        # half-finished device work into a fresh replica is the desync
        # the elastic contract bans; the CALLER retries with a fresh
        # classified hint (completed passes are journaled, so the retry
        # is cheap)
        self._try_cancel(addr, req_id)
        with self._router_lock:
            self._route_counts["abandoned"] += 1
        obs_metrics.counter_add("router.abandoned")
        obs_spans.instant("router.abandoned", tenant=tenant,
                          dead_replica=rank)
        raise CylonError(
            Code.Unavailable,
            f"replica {rank} died with this request in flight (tenant "
            f"{tenant!r}); in-flight work is abandoned, not retried — "
            f"resubmit to replay journaled passes",
            retry_after_s=self._retry_after(0))

    def _try_cancel(self, addr: Tuple[str, int],
                    req_id: Optional[str],
                    token: Optional[str] = None) -> None:
        """Best-effort cancel by ``req_id`` or by idempotency ``token``
        — the token form reaps an orphan whose submit accept reply was
        lost (the router never learned its req_id)."""
        obj: Dict = {"cmd": "cancel"}
        if req_id is not None:
            obj["req_id"] = req_id
        if token is not None:
            obj["token"] = token
        try:
            control.request(addr, obj, timeout=rpc_timeout_s(),
                            retries=0, max_line=self.SERVER_MAX_LINE)
        except OSError:
            pass  # the replica is gone; nothing to cancel

    def _try_ack(self, addr: Tuple[str, int], req_id: str) -> None:
        """Terminal reply read: tell the replica the ticket may drop.
        Best-effort — an unacked terminal ticket ages out past the
        replica's TICKET_CAP."""
        try:
            control.request(addr, {"cmd": "ack", "req_id": req_id},
                            timeout=rpc_timeout_s(), retries=0,
                            max_line=self.SERVER_MAX_LINE)
        except OSError:
            pass  # ack is insurance, not a contract

    # -- introspection -----------------------------------------------------

    def router_status(self) -> Dict:
        """The routing table the ``status`` verb ships and
        ``tools/fleet_status.py --replicas`` renders: per-replica
        capacity/depth/headroom plus served/shed/re-route/hedge
        counters, breaker state, and the current affinity pins.
        ``breakers`` lists EVERY known breaker (dead replicas included,
        forced open first — fencing and breaker state must never
        disagree on a dead replica), while ``replicas`` rows cover the
        live serving set."""
        view = self._replica_view()
        with self._lock:
            fenced = set(self._dead)
        for r in fenced:
            self._breaker_force_open(r, "fenced by the membership "
                                        "detector")
        with self._router_lock:
            counts = dict(self._route_counts)
            per = {r: dict(c) for r, c in sorted(self._per_replica.items())}
            tenants = dict(self._tenant_affinity)
            keys = len(self._key_affinity)
            inflight = dict(self._inflight)
            breakers = {r: dict(b) for r, b in sorted(self._breakers
                                                      .items())}
        replicas = {}
        for rank, v in sorted(view.items()):
            b = breakers.get(rank, _BREAKER_ZERO)
            replicas[str(rank)] = {
                "addr": f"{v['addr'][0]}:{v['addr'][1]}",
                "capacity": v["capacity"],
                "queue_depth": v["reported_depth"],
                "router_inflight": inflight.get(rank, 0),
                "hbm_headroom_bytes": v["headroom"],
                **per.get(rank, _PER_REPLICA_ZERO),
                "breaker": _BREAKER_NAMES[b["state"]],
                "breaker_opens": b["opens"],
                "breaker_probes": b["probes"],
                "tenants_pinned": sorted(
                    t for t, r in tenants.items() if r == rank),
            }
        return {"replicas": replicas, "replicas_live": len(view),
                "cache_affinity": cache_affinity_enabled(),
                "key_pins": keys,
                "hedging": hedge_floor_ms() > 0,
                "breakers": {str(r): _BREAKER_NAMES[b["state"]]
                             for r, b in breakers.items()},
                **counts}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RouterClient:
    """Caller-side handle for the ``route`` verb: encodes the request
    onto the wire (`cylon_tpu.router.wire`), ships it, blocks for the
    reply, and re-raises classified failures as `CylonError` —
    callers see the same contract `QueryService.submit(...).result()`
    gives them locally, with the fleet behind it."""

    def __init__(self, address, timeout_s: Optional[float] = None):
        if isinstance(address, (tuple, list)):
            self._addr: Tuple[str, int] = (str(address[0]),
                                           int(address[1]))
        else:
            host, _, port = str(address).rpartition(":")
            if not host or not port:
                raise CylonError(Code.Invalid,
                                 f"bad router address {address!r} "
                                 f"(want host:port)")
            self._addr = (host, int(port))
        self._timeout = timeout_s

    def route(self, tenant: str, op: str, *args,
              deadline_s: Optional[float] = None,
              timeout_s: Optional[float] = None, **kwargs):
        """One routed request: returns ``(result, stats)`` with
        ``stats["router"]`` carrying the serving replica, re-route
        count, and cache-hit flag; raises the classified `CylonError`
        on shed/failure/timeout.  The active trace context rides the
        verb (net/control.py), so the routed run joins the caller's
        trace."""
        payload = wire.encode_payload(args, kwargs)
        obj: Dict = {"cmd": "route", "tenant": str(tenant),
                     "op": str(op)}
        if deadline_s is not None:
            obj["deadline_s"] = float(deadline_s)
        cap = router_max_line()
        # the base64 payload dominates the encoded line; estimating its
        # size skips a second json.dumps of the whole object on the hot
        # path (send_json performs the ONLY full serialization).  The
        # non-payload fields are measured EXACTLY — a pathological
        # tenant/op string must hit this classified refusal too, not a
        # server-side connection drop read as retryable
        nbytes = (wire.payload_nbytes(payload)
                  + len(json.dumps(obj, sort_keys=True)))
        obj["payload"] = payload
        if nbytes + 1024 > cap:
            raise CylonError(
                Code.SerializationError,
                f"encoded route request is ~{nbytes} bytes — past the "
                f"{cap}-byte CYLON_TPU_ROUTER_MAX_LINE_BYTES wire cap; "
                f"raise the knob (router AND replicas) or ship less "
                f"data per request")
        # ~2x input residency is the serve layer's admission estimate;
        # base64 already inflated the frames 4/3, so the encoded line
        # length is the right order of magnitude for the headroom guard
        obj["est_bytes"] = 2 * nbytes
        budget = deadline_s if deadline_s is not None \
            else route_timeout_s()
        timeout = timeout_s if timeout_s is not None \
            else (self._timeout if self._timeout is not None
                  else budget + 30.0)
        try:
            # retries=0 ON PURPOSE: the route verb blocks server-side
            # for the whole proxied run, so a transparent resend of the
            # line would start a SECOND placement while the first
            # handler thread may still be driving the original to
            # completion.  A dropped connection surfaces classified and
            # retryable instead — the caller's resubmit replays
            # journaled passes, it does not double device work.
            resp = control.request(self._addr, obj, timeout=timeout,
                                   retries=0, max_line=cap)
        except control.ProtocolError as e:
            # the REPLY outgrew this client's cap (the router's own cap
            # may be higher — knobs are read per process): deterministic,
            # a retry hits the same wall, so never classified retryable
            raise CylonError(
                Code.SerializationError,
                f"routed reply exceeds this client's {cap}-byte "
                f"CYLON_TPU_ROUTER_MAX_LINE_BYTES wire cap ({e}); raise "
                f"the knob (client, router AND replicas) or ship less "
                f"data per request") from e
        except OSError as e:
            raise CylonError(
                Code.Unavailable,
                f"query router at {self._addr[0]}:{self._addr[1]} "
                f"unreachable or dropped mid-route "
                f"({type(e).__name__}: {e}); the routed request may "
                f"still complete server-side — a resubmit replays "
                f"journaled passes, never re-executes them") from e
        if not resp.get("ok"):
            if resp.get("status") == "stale_coordinator":
                # split-brain: a superseded router incarnation is
                # still bound — retryable, not a caller bug
                raise CylonError(
                    Code.Unavailable,
                    f"query router at {self._addr[0]}:{self._addr[1]} "
                    f"answered stale (superseded by incarnation "
                    f"{resp.get('incarnation')}); re-resolve the router "
                    f"address and retry", retry_after_s=1.0)
            if "classified" in resp:
                raise wire.classified_error(resp["classified"])
            raise CylonError(Code.UnknownError,
                             f"route failed: {resp.get('error', resp)}")
        result = wire.decode_value(resp.get("result"))
        stats = dict(resp.get("stats") or {})
        stats["router"] = {"replica": resp.get("replica"),
                           "reroutes": resp.get("reroutes", 0),
                           "cache_hit": bool(resp.get("cache_hit")),
                           "hedged": int(resp.get("hedged", 0) or 0),
                           "hedge_won": bool(resp.get("hedge_won"))}
        return result, stats

    def status(self, timeout_s: float = 5.0) -> Dict:
        return control.request(self._addr, {"cmd": "status"},
                               timeout=timeout_s,
                               max_line=router_max_line())
