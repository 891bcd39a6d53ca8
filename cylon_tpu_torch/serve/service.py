"""Multi-tenant query service: admission control, per-tenant budgets,
load shedding, cancellation and graceful drain over ONE context.

A copy of ``cylon_tpu/serve/service.py``.  Overload is a classified,
recoverable condition:

- **admission control**: a submission passes host-side checks on the
  CALLER's thread and either enters a BOUNDED queue or is shed at once
  with `Code.ResourceExhausted` / `Code.Unavailable` and a
  ``retry_after_s`` hint.  The queue cap (``CYLON_TPU_SERVE_QUEUE_CAP``),
  a per-tenant share of it (``CYLON_TPU_SERVE_TENANT_SHARE``: one
  flooding tenant sheds alone) and an optional per-tenant device-memory
  estimate (``CYLON_TPU_SERVE_HBM_BUDGET_BYTES``, checked against the
  ``hbm.live_bytes`` watermark, which reads the caching allocator's
  ``torch.cuda.memory_allocated`` without a sync) all reject
  deterministically.
- **one scheduler, one context**: a single daemon thread pops admitted
  tickets and runs them serially through the out-of-core engine
  (``exec.py``), the planner (``plan``) or a stream refresh
  (``refresh``).  The thread binds the context's card
  (``torch.cuda.set_device``) before its first request, so its launches
  land on the context's device and not on whatever a fresh thread
  defaults to.  Scheduling decisions (``_dispatch_next``) are
  device-free: a wedged device delays RESULTS, never admission or
  shedding.  A CUDA error or an out-of-memory error in a request becomes
  that ticket's classified failure (``Status.from_exception``).
- **per-tenant budgets**: a deadline arms the `Code.Timeout` watchdog
  (``durable.PassDeadline``) over the whole request and stops it at the
  next pass boundary; repeated failures quarantine the TENANT
  (``CYLON_TPU_SERVE_QUARANTINE_AFTER`` / ``_QUARANTINE_S``).
- **the journal as a result cache**: with ``CYLON_TPU_DURABLE_DIR`` set a
  repeated fingerprint replays entirely from spill, with zero device
  passes and zero kernel launches (``serve.cache_hit``;
  ``serve/cache.py``).
- **cancellation and graceful drain**: ``Ticket.cancel()`` removes queued
  work (`Code.Cancelled`) or stops a running request at the next pass
  boundary; ``drain()`` sheds the queue with `Code.Unavailable` and lets
  the in-flight request finish.

Every request mints a causal trace (``obs.tracectx``) that its spans
join; per-tenant queue-wait and run histograms
(``serve.queue_wait_ms[<tenant>]``, ``serve.run_ms[<tenant>]``) feed
:meth:`QueryService.telemetry` and the OpenMetrics exposition, whose
knob-driven listener (``CYLON_TPU_METRICS_PORT``) the service starts.
``QueryService()`` with no ``ctx`` serves on the CUDA card and raises
without one; pass ``ctx=CylonContext.Init("cpu")`` to serve on the CPU.
Attaching to an elastic agent waits for the gang (ROADMAP.md queue A,
item 11b).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

import torch

from .. import config
from .. import durable
from .. import exec as exec_mod
from .. import resilience
from ..context import CylonContext
from ..obs import fleet as obs_fleet
from ..obs import metrics as obs_metrics
from ..obs import openmetrics
from ..obs import spans as obs_spans
from ..obs import tracectx
from ..status import Code, CylonError, Status
from . import cache as cache_mod


# ---------------------------------------------------------------------------
# knob accessors (registry rows in config.py::KNOBS)
# ---------------------------------------------------------------------------

def queue_cap() -> int:
    return max(1, int(config.knob("CYLON_TPU_SERVE_QUEUE_CAP")))


def tenant_share() -> float:
    return min(1.0, max(0.0, float(config.knob("CYLON_TPU_SERVE_TENANT_SHARE"))))


def hbm_budget_bytes() -> int:
    return max(0, int(config.knob("CYLON_TPU_SERVE_HBM_BUDGET_BYTES")))


def default_deadline_s() -> float:
    return max(0.0, float(config.knob("CYLON_TPU_SERVE_DEADLINE_S")))


def tenant_quarantine_after() -> int:
    return max(0, int(config.knob("CYLON_TPU_SERVE_QUARANTINE_AFTER")))


def tenant_quarantine_s() -> float:
    return max(0.0, float(config.knob("CYLON_TPU_SERVE_QUARANTINE_S")))


# the ctor's ``queue_cap=`` parameter shadows the accessor's name
_default_queue_cap = queue_cap


def _slo_tenant(tenant: str) -> str:
    """The tenant id as spelled inside an SLO histogram key: brackets
    are remapped because every parser of these keys (``telemetry``,
    ``tools/trace_report.py slo_rows``) splits on the first ``[`` and
    strips one trailing ``]``, so a raw ``t[1]`` would vanish from the
    SLO view."""
    return tenant.replace("[", "(").replace("]", ")")


def _slo_key(kind: str, tenant: str) -> str:
    """Metric key of one tenant's SLO latency histogram:
    ``serve.<kind>[<tenant>]`` — kind is ``queue_wait_ms`` (admission to
    dispatch) or ``run_ms`` (dispatch to terminal).  Consumers split on
    the first ``[``; ``tools/trace_report.py`` renders these as the
    per-tenant SLO table, and the OpenMetrics exposition as histograms
    with a ``tenant`` label."""
    return f"serve.{kind}[{_slo_tenant(tenant)}]"


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

#: ops the service admits: each maps to a runner accepting ``ctx=`` and
#: ``pass_guard=`` (the cancellation hook)
OPS = ("join", "join_groupby", "groupby", "sort", "plan", "refresh")


def _run_plan(plan, *, ctx=None, pass_guard=None, **kw):
    """Serve runner for whole logical plans (``submit(tenant, "plan",
    table.plan()...)``): executes through the plan optimizer/executor on
    the plan inputs' own context, and journals at PLAN granularity (one
    fingerprint for the whole op chain).  Lazy import: a serve-only
    process may never need the optimizer stack."""
    from .. import plan as plan_mod

    return plan_mod.run_service(plan, ctx=ctx, pass_guard=pass_guard, **kw)


def _run_refresh(query_or_spec, *args, ctx=None, pass_guard=None, **kw):
    """Serve runner for streaming refreshes (``submit(tenant, "refresh",
    query_or_spec)``): a built stream query, or its JSON spec, which is
    rebuilt from the durable journal on the service context's device.
    Idempotent by construction: the result fingerprint folds the
    stream's high watermark, so a refresh with no new batches is a pure
    cache hit.  Lazy import: a process that never streams does not load
    the stream package."""
    from .. import stream as stream_mod

    return stream_mod.run_refresh(query_or_spec, *args, ctx=ctx,
                                  pass_guard=pass_guard, **kw)


_RUNNERS = {
    "join": exec_mod.chunked_join,
    "join_groupby": exec_mod.chunked_join_groupby_tables,
    "groupby": exec_mod.chunked_groupby,
    "sort": exec_mod.chunked_sort,
    "plan": _run_plan,
    "refresh": _run_refresh,
}


#: custom ops whose registration declared ``idempotent=True`` (built-in
#: OPS are fingerprint-idempotent by the journal contract and need no
#: declaration)
_IDEMPOTENT_OPS: set = set()


def register_op(op: str, runner, *, idempotent: bool = False) -> None:
    """Register a custom serve op: ``runner(*args, ctx=, pass_guard=,
    **kwargs) -> (result, stats)``.  The runner executes on the
    scheduler thread under the request's trace context, with the same
    cancellation/deadline guard every built-in op gets.

    ``idempotent=True`` declares that re-running the op with the same
    arguments is side-effect-safe and bit-identical (the opt-in a fleet
    router reads before hedging a request onto a second replica)."""
    op = str(op)
    _RUNNERS[op] = runner
    if idempotent:
        _IDEMPOTENT_OPS.add(op)
    else:
        _IDEMPOTENT_OPS.discard(op)

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
SHED = "shed"


@dataclass(frozen=True)
class TenantBudget:
    """Per-tenant overrides of the service-wide budget knobs.  None
    inherits the knob default."""

    deadline_s: Optional[float] = None    # request wall-clock budget
    hbm_bytes: Optional[int] = None       # admission HBM estimate cap
    max_queued: Optional[int] = None      # queued-request cap (share
                                          # of the queue otherwise)


class Ticket:
    """One admitted request: a caller-side handle carrying the result
    event, the terminal state, the cancel signal, and the request's
    causal trace context (``trace.trace_id`` joins this request to its
    spans across every rank it touched)."""

    def __init__(self, service: "QueryService", tenant: str, op: str,
                 args, kwargs,
                 trace: Optional[tracectx.TraceContext] = None,
                 deadline_s: Optional[float] = None):
        self._service = service
        self.tenant = tenant
        self.op = op
        self.args = args
        self.kwargs = kwargs
        self.deadline_s = deadline_s  # per-request budget override
        self.state = QUEUED
        self.result_value = None
        self.stats: Optional[dict] = None
        self.error: Optional[CylonError] = None
        self.cache_hit = False
        self.duration_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        self.t_submit = time.perf_counter()
        self.trace = trace
        self._trace_closed = False
        self._event = threading.Event()
        self._cancel = threading.Event()

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outcome: ``(result, stats)`` on success, the
        classified `CylonError` re-raised on failure/cancel/shed.  A
        ``timeout`` miss raises `Code.Timeout` WITHOUT cancelling the
        request — call :meth:`cancel` for that."""
        if not self._event.wait(timeout):
            raise CylonError(Code.Timeout,
                             f"no result within {timeout}s (request "
                             f"{self.op} for tenant {self.tenant!r} is "
                             f"still {self.state})")
        if self.error is not None:
            raise self.error
        return self.result_value, self.stats

    def cancel(self) -> bool:
        """Cancel: a queued request is removed immediately; a running one
        stops at the next pass boundary (the in-flight pass finishes —
        and journals — first).  False when already finished."""
        return self._service._cancel_ticket(self)

    def _finish(self, state: str, *, result=None, stats=None,
                error: Optional[CylonError] = None) -> None:
        self.state = state
        self.result_value = result
        self.stats = stats
        self.error = error
        # EVERY terminal path — completed, failed, cancelled, shed —
        # closes the request's trace exactly once: the tail-retention
        # decision runs here (keep the buffered events, or discard them
        # and keep only the aggregate stopwatch).  Anything that did not
        # complete counts as "failed" for retention — a cancelled or
        # shed request's trace is precisely what the caller will ask
        # about.
        if self.trace is not None and not self._trace_closed:
            self._trace_closed = True
            dur = self.duration_s if self.duration_s is not None \
                else max(0.0, time.perf_counter() - self.t_submit)
            tracectx.finish_request(self.trace, dur * 1e3,
                                    failed=state != DONE)
        self._event.set()


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def _estimate_request_bytes(args, kwargs) -> int:
    """Host-side device-memory admission estimate: the input frames' byte
    size times a pack factor of 2 (power-of-two chunk capacities and the
    join output roughly double residency).  Positional AND keyword values
    are scanned.  Advisory by design: the engine's OOM recovery remains
    the backstop; this check only keeps a request that PLAINLY cannot
    fit from ever touching the device."""
    total = 0
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dict):
            for v in a.values():
                nb = getattr(np.asarray(v), "nbytes", 0)
                total += int(nb)
        elif hasattr(a, "approx_input_bytes"):
            # a LogicalPlan: pruned-scan buffer metadata, host-only
            total += int(a.approx_input_bytes())
        else:
            nbytes = getattr(a, "nbytes", None)
            if isinstance(nbytes, (int, np.integer)):
                total += int(nbytes)
    return 2 * total


def _load_arrow_here() -> None:
    """Import pyarrow on the caller's thread, before the scheduler thread
    exists.  The journal's spills go through pyarrow on the scheduler
    thread, which ends with its service; with pyarrow 25 (mimalloc), a
    process whose FIRST pyarrow import ran on a thread that has since
    ended crashed (SIGSEGV) at a later spill write on another thread.
    Without pyarrow the journal is off and nothing needs it."""
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        pass


class _TenantState:
    __slots__ = ("queued", "admitted", "served", "shed", "failed",
                 "cancelled", "cache_hits", "streak", "quarantined_until")

    def __init__(self):
        self.queued = 0
        self.admitted = 0
        self.served = 0
        self.shed = 0
        self.failed = 0
        self.cancelled = 0
        self.cache_hits = 0
        self.streak = 0              # consecutive classified failures
        self.quarantined_until = 0.0


class QueryService:
    """Single-process multi-tenant query service over one context
    (``ctx`` = None for the CUDA card, raising without one; or any
    `CylonContext`: one shard, a mesh, a CPU device).

    Usage::

        svc = QueryService()
        t = svc.submit("tenant-a", "join", left, right, on="k", passes=2)
        result, stats = t.result(timeout=60)
        svc.close()

    ``submit`` raises `CylonError` (`Code.ResourceExhausted` /
    `Code.Unavailable`, ``retry_after_s`` set) when the request is shed
    at admission; an admitted `Ticket` ALWAYS terminates — completed,
    failed classified, cancelled, or shed by a drain — never a hang.
    """

    def __init__(self, ctx=None, *, queue_cap: Optional[int] = None,
                 budgets: Optional[Dict[str, TenantBudget]] = None,
                 name: str = "serve"):
        self._ctx = ctx if ctx is not None else CylonContext.Init()
        # the card the scheduler thread binds: the context's, by index
        # (a bare "cuda" names the caller's current card), resolved here
        # so a bad device raises at construction, not on the thread
        dev = self._ctx.devices[0]
        self._card: Optional[int] = None
        if dev.type == "cuda":
            self._card = dev.index if dev.index is not None \
                else torch.cuda.current_device()
        self._cap = int(queue_cap) if queue_cap is not None \
            else _default_queue_cap()
        self._budgets: Dict[str, TenantBudget] = dict(budgets or {})
        self.name = name
        self._lock = threading.Condition()
        self._queue: "deque[Ticket]" = deque()
        self._running: Optional[Ticket] = None
        self._tenants: Dict[str, _TenantState] = {}
        self._draining = False
        self._closed = False
        self._ewma_s: Optional[float] = None
        self._runners: Dict[str, object] = {}  # instance op overrides
        self._idempotent_ops: set = set()      # declared-hedgeable ops
        self._pending_flight: List[dict] = []  # staged shed dumps
        self._counts = {"admitted": 0, "shed": 0, "completed": 0,
                        "failed": 0, "cancelled": 0, "cache_hits": 0,
                        "tenants_quarantined": 0}
        openmetrics.ensure_server()  # CYLON_TPU_METRICS_PORT, once
        _load_arrow_here()
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        name=f"cylon-{name}", daemon=True)
        self._thread.start()

    # -- context manager --------------------------------------------------

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- admission (caller threads; device-free) ----------------------------

    def set_budget(self, tenant: str, budget: TenantBudget) -> None:
        with self._lock:
            self._budgets[str(tenant)] = budget

    def _tenant(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState()
        return st

    def _retry_after(self, ahead: int) -> float:
        """When capacity plausibly returns: the request-duration EWMA
        times the work ahead of the caller.  A hint, not a promise."""
        per = self._ewma_s if self._ewma_s is not None else 0.25
        return max(0.05, per * max(1, ahead))

    def _shed(self, tenant: str, code: Code, reason: str,
              retry_after: Optional[float],
              trace: Optional[tracectx.TraceContext] = None) -> CylonError:
        st = self._tenant(tenant)
        st.shed += 1
        self._counts["shed"] += 1
        obs_metrics.counter_add("serve.shed")
        # the shed instant is stamped under the request's trace (the
        # caller's thread has no ambient context during submit — the
        # trace was only just minted), so a shed request's terminal
        # instant joins the trace the caller was handed
        with tracectx.activate(trace):
            obs_spans.instant("serve.shed", tenant=tenant, code=code.name,
                              reason=reason)
        # a shed is a classified terminal event for the caller: the
        # flight dump records the admission state that forced it —
        # STAGED here (every _shed call site holds the service lock) and
        # written by _flush_flight after release, so disk latency never
        # serializes admission under the exact overload being recorded
        self._pending_flight.append(dict(
            tenant=tenant, code=code.name, shed_reason=reason,
            queue_depth=len(self._queue),
            **({"trace_id": trace.trace_id} if trace is not None else {})))
        hint = "" if retry_after is None else f"; retry after ~{retry_after:.2f}s"
        return CylonError(code, f"request shed for tenant {tenant!r}: "
                                f"{reason}{hint}",
                          retry_after_s=retry_after)

    def _flush_flight(self) -> None:
        """Write the shed dumps `_shed` staged under the service lock,
        OUTSIDE it — host-side file IO only, never device work."""
        while True:
            with self._lock:
                if not self._pending_flight:
                    return
                kw = self._pending_flight.pop(0)
            obs_fleet.flight_record("shed", **kw)

    def submit(self, tenant: str, op: str, *args, **kwargs) -> Ticket:
        """Admit one table op (``op`` in :data:`OPS`; ``args``/``kwargs``
        forwarded to the chunked engine) or shed it NOW with a
        classified `CylonError` carrying ``retry_after_s``.  Runs
        entirely on the caller's thread and never blocks on the device
        or the queue."""
        try:
            return self._submit_inner(tenant, op, *args, **kwargs)
        finally:
            self._flush_flight()  # staged shed dumps, lock released

    def _submit_inner(self, tenant: str, op: str, *args,
                      **kwargs) -> Ticket:
        tenant = str(tenant)
        if op not in _RUNNERS and op not in self._runners:
            raise CylonError(Code.Invalid,
                             f"unknown op {op!r} (expected one of {OPS})")
        # mint the request's causal trace BEFORE any admission decision,
        # so even a shed request has an identity the caller can chase
        # through the merged timeline.  A client-supplied ``traceparent=``
        # (the W3C wire form) is adopted as the parent — the request
        # becomes a child span of the caller's own trace; a malformed
        # header is rejected leniently (fresh trace, never a failed
        # submit).
        parent = tracectx.parse_or_none(kwargs.pop("traceparent", None))
        trace = parent.child() if parent is not None \
            else tracectx.new_trace()
        # reserved kwarg: a per-REQUEST wall-clock budget that overrides
        # the tenant/knob default — the router forwards a client's
        # deadline through its extra hop with it, so the budget that
        # fires is the one the CALLER set, not whatever the replica's
        # tenant table happens to say
        deadline_override = kwargs.pop("deadline_s", None)
        if deadline_override is not None:
            deadline_override = max(0.0, float(deadline_override))

        def shed_now(err: CylonError) -> CylonError:
            # an admission shed has no Ticket to close the trace through:
            # close it here (duration = time spent in admission, ~0)
            tracectx.finish_request(trace, 0.0, failed=True)
            return err

        est = _estimate_request_bytes(args, kwargs)
        try:
            resilience.fault_point("serve.admit")
        except Exception as e:
            # an injected admission fault (`tenant_flood`) sheds exactly
            # like a real budget trip — same code, same hint
            with self._lock:
                err = self._shed(tenant, Code.ResourceExhausted,
                                 Status.from_exception(e).msg,
                                 self._retry_after(len(self._queue) + 1),
                                 trace)
            raise shed_now(err)
        with self._lock:
            if self._closed or self._draining:
                raise shed_now(self._shed(tenant, Code.Unavailable,
                                          "service is draining", None,
                                          trace))
            st = self._tenant(tenant)
            now = time.monotonic()
            if st.quarantined_until > now:
                raise shed_now(self._shed(
                    tenant, Code.Unavailable,
                    f"tenant quarantined after {st.streak} "
                    f"consecutive failures",
                    st.quarantined_until - now, trace))
            if st.quarantined_until:
                # cooldown elapsed: the tenant re-enters with a CLEAN
                # failure streak (the knob's contract) — otherwise one
                # transient post-cooldown failure would re-quarantine
                # instantly
                st.quarantined_until = 0.0
                st.streak = 0
            depth = len(self._queue) + (1 if self._running is not None else 0)
            if len(self._queue) >= self._cap:
                raise shed_now(self._shed(
                    tenant, Code.ResourceExhausted,
                    f"admission queue full "
                    f"({len(self._queue)}/{self._cap})",
                    self._retry_after(depth + 1), trace))
            budget = self._budgets.get(tenant)
            tcap = budget.max_queued if budget is not None \
                and budget.max_queued is not None \
                else max(1, int(-(-self._cap * tenant_share() // 1)))
            if st.queued >= tcap:
                raise shed_now(self._shed(
                    tenant, Code.ResourceExhausted,
                    f"tenant queue share full "
                    f"({st.queued}/{tcap} of {self._cap})",
                    self._retry_after(st.queued + 1), trace))
            hbm_cap = budget.hbm_bytes if budget is not None \
                and budget.hbm_bytes is not None else hbm_budget_bytes()
            if hbm_cap > 0:
                # the allocator's running count: a host read, no sync
                live = obs_metrics.record_hbm_watermark(self._ctx.devices[0])
                if est + live > hbm_cap:
                    raise shed_now(self._shed(
                        tenant, Code.ResourceExhausted,
                        f"HBM admission estimate {est} + live {live} "
                        f"exceeds the {hbm_cap}-byte tenant budget",
                        self._retry_after(depth + 1), trace))
            ticket = Ticket(self, tenant, op, args, kwargs, trace=trace,
                            deadline_s=deadline_override)
            self._queue.append(ticket)
            st.queued += 1
            st.admitted += 1
            self._counts["admitted"] += 1
            obs_metrics.counter_add("serve.admitted")
            obs_metrics.gauge_set("serve.queue_depth", len(self._queue))
            self._lock.notify_all()
        return ticket

    def _cancel_ticket(self, ticket: Ticket) -> bool:
        with self._lock:
            if ticket.done:
                return False
            if ticket in self._queue:
                self._queue.remove(ticket)
                st = self._tenant(ticket.tenant)
                st.queued -= 1
                st.cancelled += 1
                self._counts["cancelled"] += 1
                obs_metrics.counter_add("serve.cancelled")
                obs_metrics.gauge_set("serve.queue_depth", len(self._queue))
                ticket._finish(CANCELLED, error=CylonError(
                    Code.Cancelled,
                    f"request cancelled while queued (tenant "
                    f"{ticket.tenant!r})"))
                return True
        # running (or about to): the pass_guard stops it at the next
        # pass boundary — completed passes stay journaled
        ticket._cancel.set()
        return not ticket.done

    # -- scheduling (the one worker thread) --------------------------------

    _STOP = object()

    def _dispatch_next(self):
        """Pick the next admitted ticket: scheduling decisions ONLY, no
        device work on this path, so a wedged device never blocks
        shedding or drain.  Returns a ticket, None (nothing actionable
        this tick), or ``_STOP``."""
        try:
            return self._dispatch_inner()
        finally:
            self._flush_flight()

    def _dispatch_inner(self):
        with self._lock:
            while not self._queue:
                if self._closed:
                    return self._STOP
                self._lock.wait(0.05)
            ticket = self._queue.popleft()
            st = self._tenant(ticket.tenant)
            st.queued -= 1
            obs_metrics.gauge_set("serve.queue_depth", len(self._queue))
            self._running = ticket
        if ticket._cancel.is_set():
            self._finish_cancelled(ticket, "before dispatch")
            with self._lock:
                self._running = None
                self._lock.notify_all()
            return None
        try:
            resilience.fault_point("serve.dispatch")
        except Exception as e:
            with self._lock:
                err = self._shed(ticket.tenant, Code.Unavailable,
                                 Status.from_exception(e).msg,
                                 self._retry_after(1), ticket.trace)
                self._running = None
                self._lock.notify_all()
            ticket._finish(SHED, error=err)
            return None
        return ticket

    def _scheduler_loop(self) -> None:
        bind_error: Optional[Exception] = None
        if self._card is not None:
            # a fresh thread's current card is cuda:0: bind the
            # context's, so every launch (and a TRACE_SYNC fence) lands
            # on the device the context names.  Should the bind fail,
            # every request fails with its classified error; none hangs
            try:
                torch.cuda.set_device(self._card)
            except Exception as e:
                bind_error = e
        while True:
            ticket = self._dispatch_next()
            if ticket is self._STOP:
                return
            if ticket is None:
                continue
            try:
                if bind_error is not None:
                    ticket.state = RUNNING
                    self._finish_failed(ticket, bind_error)
                    continue
                self._run_ticket(ticket)
            except Exception as e:
                # a fault after the runner returned (a custom runner's
                # malformed stats): the ticket still terminates, and the
                # thread lives on for the next one
                if not ticket.done:
                    self._finish_failed(ticket, e)
            finally:
                with self._lock:
                    self._running = None
                    self._lock.notify_all()

    def _finish_cancelled(self, ticket: Ticket, where: str) -> None:
        with self._lock:
            st = self._tenant(ticket.tenant)
            st.cancelled += 1
            self._counts["cancelled"] += 1
            obs_metrics.counter_add("serve.cancelled")
        ticket._finish(CANCELLED, error=CylonError(
            Code.Cancelled, f"request cancelled {where} (tenant "
                            f"{ticket.tenant!r})"))

    # -- execution (device work lives here and only here) ------------------

    def _request_deadline_s(self, tenant: str) -> float:
        b = self._budgets.get(tenant)
        if b is not None and b.deadline_s is not None:
            return max(0.0, float(b.deadline_s))
        return default_deadline_s()

    def register_op(self, op: str, runner, *,
                    idempotent: bool = False) -> "QueryService":
        """Instance-scoped op registration: like the module-level
        :func:`register_op` but visible only to THIS service — two
        replicas in one process (the router tests' rendering) can serve
        the same op name through different runners.  ``idempotent=True``
        declares the op hedge-safe (see the module-level docstring)."""
        op = str(op)
        with self._lock:
            self._runners[op] = runner
            if idempotent:
                self._idempotent_ops.add(op)
            else:
                self._idempotent_ops.discard(op)
        return self

    def idempotent_ops(self) -> List[str]:
        """Custom ops this service may be hedged on: every registration
        (module or instance scope) that declared ``idempotent=True``.
        Shipped to the router via replica telemetry — placement-time
        ground truth, so a hedge can never land on a replica whose
        registration made no safety promise."""
        with self._lock:
            return sorted(_IDEMPOTENT_OPS | self._idempotent_ops)

    def _run_ticket(self, ticket: Ticket) -> None:
        tenant = ticket.tenant
        deadline_s = ticket.deadline_s if ticket.deadline_s is not None \
            else self._request_deadline_s(tenant)
        dl = durable.PassDeadline(deadline_s, f"serve.request.{tenant}") \
            if deadline_s > 0 else None

        def guard():
            # the engine calls this before every pass: cancellation and
            # the request budget both stop the run at a pass BOUNDARY, so
            # completed (journaled) work is never abandoned mid-flight
            if ticket._cancel.is_set():
                raise CylonError(Code.Cancelled,
                                 f"request cancelled (tenant {tenant!r})")
            if dl is not None and dl.fired.is_set():
                raise CylonError(Code.Timeout,
                                 f"request exceeded its {deadline_s:g}s "
                                 f"budget (tenant {tenant!r})")

        ticket.state = RUNNING
        t0 = time.perf_counter()
        # the SLO split: how long the request sat admitted (queue wait)
        # vs how long it ran — recorded for every dispatched request,
        # succeed or fail, so the histograms describe the service's
        # latency, not just its successes
        ticket.queue_wait_s = max(0.0, t0 - ticket.t_submit)
        obs_metrics.hist_observe(_slo_key("queue_wait_ms", tenant),
                                 ticket.queue_wait_s * 1e3)
        runner = self._runners.get(ticket.op) or _RUNNERS[ticket.op]
        # the request's trace context is ACTIVE for the whole execution:
        # every span the engine records on this thread (plan passes,
        # exec passes, shuffle collectives) becomes a child span of this
        # request, and every control verb the run issues carries its
        # traceparent
        with tracectx.activate(ticket.trace), \
                obs_spans.span("serve.request", tenant=tenant,
                               op=ticket.op) as sp:
            try:
                with (dl if dl is not None else contextlib.nullcontext()):
                    result, stats = runner(*ticket.args, ctx=self._ctx,
                                           pass_guard=guard,
                                           **ticket.kwargs)
            except Exception as e:
                # duration BEFORE _finish_failed closes the trace: the
                # tail-retention p99 estimator must see run time, never
                # queue wait + run (the except body runs ahead of the
                # finally that normally stamps it)
                ticket.duration_s = time.perf_counter() - t0
                self._finish_failed(ticket, e)
                return
            finally:
                dur = time.perf_counter() - t0
                ticket.duration_s = dur
                obs_metrics.hist_observe(_slo_key("run_ms", tenant),
                                         dur * 1e3)
                if obs_spans.events_enabled():
                    sp.set(seconds=round(dur, 6), state=ticket.state)
        hit = cache_mod.served_from_journal(stats)
        with self._lock:
            st = self._tenant(tenant)
            st.streak = 0
            st.served += 1
            self._counts["completed"] += 1
            if hit:
                st.cache_hits += 1
                self._counts["cache_hits"] += 1
            # request-duration EWMA drives the retry-after hints; cache
            # hits are excluded (they predict nothing about device cost)
            if not hit:
                d = ticket.duration_s
                self._ewma_s = d if self._ewma_s is None \
                    else 0.7 * self._ewma_s + 0.3 * d
        obs_metrics.counter_add("serve.completed")
        if hit:
            obs_metrics.counter_add("serve.cache_hit")
            obs_spans.instant("serve.cache_hit", tenant=tenant,
                              op=ticket.op)
        ticket.cache_hit = hit
        ticket._finish(DONE, result=result, stats=stats)
        # no GC here: the engine already runs the CYLON_TPU_DURABLE_CAP_
        # BYTES eviction when it records a journaled run complete;
        # cache.maybe_gc() stays available as a manual sweep

    def _finish_failed(self, ticket: Ticket, exc: Exception) -> None:
        st_code = Status.from_exception(exc)
        if st_code.code == Code.Cancelled:
            self._finish_cancelled(ticket, "at a pass boundary")
            return
        err = exc if isinstance(exc, CylonError) \
            else CylonError(st_code.code, st_code.msg)
        quarantined = False
        with self._lock:
            st = self._tenant(ticket.tenant)
            st.failed += 1
            st.streak += 1
            self._counts["failed"] += 1
            qn = tenant_quarantine_after()
            if qn > 0 and st.streak >= qn:
                st.quarantined_until = time.monotonic() + tenant_quarantine_s()
                self._counts["tenants_quarantined"] += 1
                quarantined = True
        obs_metrics.counter_add("serve.failed")
        if quarantined:
            obs_metrics.counter_add("serve.tenants_quarantined")
            obs_spans.instant("serve.tenant_quarantined",
                              tenant=ticket.tenant, streak=st.streak,
                              code=err.code.name)
        # classified terminal failure (deadline overruns included): the
        # flight dump carries the ring + metrics so the post-mortem does
        # not depend on the caller having pre-armed tracing
        obs_fleet.flight_record("request_failed", tenant=ticket.tenant,
                                op=ticket.op, code=err.code.name,
                                quarantined=quarantined,
                                error=err.msg[:200],
                                **({"trace_id": ticket.trace.trace_id}
                                   if ticket.trace is not None else {}))
        ticket._finish(FAILED, error=err)

    # -- drain / close ------------------------------------------------------

    def drain(self, timeout: Optional[float] = 60.0) -> List[Ticket]:
        """Graceful drain: stop admitting (subsequent submits shed with
        `Code.Unavailable`), shed everything QUEUED with the same code,
        and wait up to ``timeout`` for the in-flight request to finish
        or journal.  Returns the shed tickets.  Idempotent."""
        with self._lock:
            self._draining = True
            shed = list(self._queue)
            self._queue.clear()
            for t in shed:
                st = self._tenant(t.tenant)
                st.queued -= 1
                err = self._shed(t.tenant, Code.Unavailable,
                                 "service draining", None, t.trace)
                t._finish(SHED, error=err)
            obs_metrics.gauge_set("serve.queue_depth", 0)
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while self._running is not None:
                rem = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if rem == 0.0:
                    break
                self._lock.wait(rem if rem is not None else 0.1)
        self._flush_flight()
        return shed

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Drain, then stop the scheduler thread."""
        self.drain(timeout)
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=5.0)

    # -- fleet integration --------------------------------------------------

    def attach_to_agent(self, agent) -> "QueryService":
        """Wire :meth:`telemetry` onto an elastic agent's heartbeats: the
        agent and its coordinator are not ported yet."""
        raise CylonError(Code.NotImplemented,
                         "attach_to_agent needs the elastic agent, not "
                         "ported yet (ROADMAP.md queue A, item 11b); read "
                         "telemetry() directly")

    # -- introspection ------------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    #: largest tenant set one telemetry payload carries (tenant ids are
    #: caller-supplied strings); the busiest tenants win, the rest are
    #: counted in ``tenants_omitted``
    TELEMETRY_MAX_TENANTS = 64

    def telemetry(self) -> dict:
        """Control-plane telemetry: queue depth plus per-tenant counters
        and SLO latency histograms (queue-wait vs run split).  Host-only:
        a snapshot of already-recorded metrics, never device work.

        Scoped to THIS service's tenants (the metrics registry is
        process-global, and a second QueryService in the process must
        not double-report the first one's histograms) and bounded to the
        ``TELEMETRY_MAX_TENANTS`` busiest tenants."""
        with self._lock:
            depth = len(self._queue)
            mine = {t: dict(served=s.served, shed=s.shed, failed=s.failed,
                            cache_hits=s.cache_hits)
                    for t, s in sorted(self._tenants.items())}
        omitted = 0
        if len(mine) > self.TELEMETRY_MAX_TENANTS:
            busiest = sorted(
                mine, key=lambda t: -(mine[t]["served"] + mine[t]["shed"]
                                      + mine[t]["failed"]))
            omitted = len(mine) - self.TELEMETRY_MAX_TENANTS
            mine = {t: mine[t]
                    for t in sorted(busiest[:self.TELEMETRY_MAX_TENANTS])}
        tenants: Dict[str, dict] = dict(mine)
        by_slo_name = {_slo_tenant(t): t for t in tenants}
        for key, h in obs_metrics.snapshot()["histograms"].items():
            if not key.startswith("serve.") or "[" not in key:
                continue
            kind, t = key[len("serve."):].split("[", 1)
            t = by_slo_name.get(t.rstrip("]"))
            if t is not None:
                tenants[t][kind] = h
        out = {"queue_depth": depth, "tenants": tenants}
        if omitted:
            out["tenants_omitted"] = omitted
        return out

    def stats(self) -> dict:
        """Deterministic service report: per-service counts, queue state
        and per-tenant counts."""
        with self._lock:
            per = {
                t: {"admitted": s.admitted, "served": s.served,
                    "shed": s.shed, "failed": s.failed,
                    "cancelled": s.cancelled, "cache_hits": s.cache_hits,
                    "quarantined": s.quarantined_until > time.monotonic()}
                for t, s in sorted(self._tenants.items())
            }
            return {**self._counts, "queue_depth": len(self._queue),
                    "queue_cap": self._cap, "draining": self._draining,
                    "tenants": per}
