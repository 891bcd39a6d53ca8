"""Resilience layer: error classification, bounded retry, and a
deterministic fault-injection harness for the out-of-core engine.

A copy of ``cylon_tpu/resilience.py``, with only the fault kinds the
engine's probes act on.  The engine (``exec.py``) streams
key-domain passes, which makes device memory pressure a recoverable
condition: when a pass exceeds memory, the remaining parts split into
more, smaller passes.  Three primitives:

- **classification**: `Status.from_exception` (status.py) maps a failure
  into the `Code` taxonomy (a CUDA allocator failure is
  `Code.OutOfMemory`, transient comm/deadline failures
  `Code.ExecutionError`); `RETRYABLE_CODES` names the codes a plain retry
  may heal (not OOM: that is healed by splitting);
- **RetryPolicy** and **retry_call**: bounded exponential backoff driven
  by ``CYLON_TPU_RETRY_MAX`` / ``CYLON_TPU_RETRY_BASE_S`` /
  ``CYLON_TPU_RETRY_MAX_S``, around a pass or a collective (the shuffle's
  exchange, the broadcast's gather);
- **fault injection**: named `fault_point(site)` probes (pass_dispatch,
  host_fetch, ...) driven by a ``CYLON_TPU_FAULT_PLAN`` spec, so every
  recovery path runs deterministically on the CPU.  Injected faults carry
  the message shapes real failures do and take the same classification
  path.

Fault-plan spec grammar (';'- or ','-separated entries)::

    site            fire an OOM on the 1st hit of `site`
    site@N          fire an OOM on the Nth hit (1-based)
    site@N=kind     kind in FAULT_KINDS (oom, timeout, comm, unknown, hang,
                    delay, the journal's killhard, journal_corrupt,
                    cache_evict_race, disk_full, bitrot, sync_partial,
                    the serve layer's tenant_flood, shed, the elastic
                    gang's rank_kill, heartbeat_loss, coordinator_loss,
                    coordinator_restart, coord_partition, coord_slow,
                    and the router's replica_sick)
    site@N+=kind    fire on EVERY hit >= N (persistent fault)

e.g. ``CYLON_TPU_FAULT_PLAN="pass_dispatch@2=oom;journal_commit@3=killhard"``.
The serve layer's ``tenant_flood`` (at ``serve.admit``) and ``shed`` (at
``serve.dispatch``) are kinds too, and `FaultSchedule` composes a seeded
multi-event timeline into one spec.
"""
from __future__ import annotations

import contextlib
import errno
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import config
from .obs import metrics as obs_metrics
from .obs import spans as obs_spans
from .status import Code, CylonError, Status

# Codes a plain bounded retry may heal.  OutOfMemory is deliberately
# absent: repeating an identical allocation cannot succeed — the engine
# heals OOM by splitting the remaining key-domain parts instead.
# Timeout (a pass-deadline overrun, durable.PassDeadline) retries like
# any transient: the hung collective/fetch may simply have been late.
RETRYABLE_CODES = frozenset({Code.ExecutionError, Code.Timeout})


def max_oom_splits() -> int:
    """How many times the engine may double the pass count before a device
    OOM becomes fatal (``CYLON_TPU_MAX_OOM_SPLITS``, default 4 — a 16x
    refinement of the original plan)."""
    return max(0, int(config.knob("CYLON_TPU_MAX_OOM_SPLITS")))


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

_U64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """splitmix64 finalizer on plain ints — the stateless hash behind
    seeded full-jitter (no RNG object, no hidden state: ``(seed, i)``
    always yields the same draw)."""
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def _jitter_u01(seed: int, i: int) -> float:
    """Deterministic uniform draw in [0, 1) for the ``i``-th retry under
    ``seed``."""
    return _splitmix64((seed & _U64) ^ _splitmix64(i)) / float(1 << 64)


@dataclass
class RetryPolicy:
    """Bounded exponential backoff for transient (`Code.ExecutionError`)
    failures.  ``max_retries`` is the number of RE-tries: an operation is
    attempted at most ``max_retries + 1`` times.

    ``jitter="full"`` draws each delay uniformly from ``[0, exp_delay]``
    (AWS full-jitter): when MANY clients back off from the same event —
    every survivor of a coordinator restart reconnecting at once — pure
    exponential backoff keeps them in lockstep and the whole herd
    thunders into the one-shot TCP accept loop on the same tick.  The
    draw is seeded-deterministic per (seed, retry_index): give each
    client a distinct ``jitter_seed`` (its rank) and the herd spreads,
    while tests replay the exact same schedule."""

    max_retries: int = 2
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: str = "none"            # "none" | "full"
    jitter_seed: int = 0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            max_retries=max(0, int(config.knob("CYLON_TPU_RETRY_MAX"))),
            base_s=max(0.0, float(config.knob("CYLON_TPU_RETRY_BASE_S"))),
            max_s=max(0.0, float(config.knob("CYLON_TPU_RETRY_MAX_S"))))

    def delay(self, retry_index: int) -> float:
        """Backoff before the ``retry_index``-th retry (0-based).  Safe
        for unbounded indices (long reconnect loops): the exponential
        saturates at ``max_s`` instead of overflowing, while the jitter
        draw keeps advancing with the index — a capped draw would freeze
        every late retry at one fixed per-seed delay."""
        if retry_index >= 64:
            d = self.max_s  # multiplier**i would overflow; it's capped
        else:
            d = min(self.base_s * (self.multiplier ** retry_index),
                    self.max_s)
        if self.jitter == "full":
            return d * _jitter_u01(self.jitter_seed, retry_index)
        return d

    def delays(self):
        for i in range(self.max_retries):
            yield self.delay(i)


def retry_call(fn, *, policy: Optional[RetryPolicy] = None, site: str = "op",
               retryable: frozenset = RETRYABLE_CODES,
               on_retry: Optional[Callable] = None) -> Tuple[object, int]:
    """Run ``fn()`` under ``policy``'s bounded backoff.

    Returns ``(result, attempts)``.  Exceptions whose classified code is
    not in ``retryable`` propagate unchanged (a TypeError must stay a
    TypeError); exhausting the retries raises `CylonError` with the
    classified code and the last failure's message.
    """
    policy = policy or RetryPolicy.from_env()
    attempts = 0
    while True:
        attempts += 1
        try:
            return fn(), attempts
        except Exception as e:
            st = Status.from_exception(e)
            if st.code not in retryable:
                raise
            retry_index = attempts - 1
            if retry_index >= policy.max_retries:
                raise CylonError(
                    st.code,
                    f"{site}: retries exhausted after {attempts} attempts: "
                    f"{st.msg}") from e
            # a retry is an event the trace must show: which site, which
            # attempt, and how the failure classified
            obs_spans.instant("retry", site=site, attempt=attempts,
                              code=st.code.name)
            obs_metrics.counter_add("retry.attempts")
            if on_retry is not None:
                on_retry(attempts, st)
            d = policy.delay(retry_index)
            if d > 0:
                policy.sleep(d)


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

# Message shapes mirror real PJRT/collective failure text so injected
# faults exercise the SAME classification path genuine failures take.
# The kinds the port's probes act on (the engine's pass_dispatch and
# host_fetch, the collectives' shuffle and broadcast, the one-shot
# oneshot_join and oneshot_groupby, the journal's journal_spill and
# journal_commit, the replication pull's journal_sync_file): the raising
# kinds, `hang` (sleeps the probe past the active pass deadline), `delay`
# (sleeps FAULT_DELAY_S and continues, a seeded straggler) and the
# journal's kinds:
# - `killhard` os._exit(137)s at the probe (a kill -9 cannot be raised
#   past); `sync_partial` is the same death at the replication copy
#   probe, which the spills-first/manifest-LAST pull order must make
#   invisible;
# - `journal_corrupt` truncates the last committed spill and continues;
#   `bitrot` XOR-flips one mid-file byte of a committed spill in the most
#   recently opened run (silent decay, for the scrubber and read-repair);
# - `cache_evict_race` deletes the last-opened run's spills while keeping
#   its manifest (a GC eviction racing a reader, which must re-execute,
#   never serve a torn journal);
# - `disk_full` raises OSError(ENOSPC) at the spill write, the real errno
#   of a full journal disk, so the degraded mode runs end to end.
# The serve layer's kinds: `tenant_flood` raises at the admission probe
# (serve.admit), which the service turns into a classified shed; `shed`
# raises at the dispatch probe (serve.dispatch), so a QUEUED request
# sheds instead of running.
# The elastic gang's kinds (elastic.py):
# - `rank_kill` is killhard under the gang's name: os._exit(137) at a
#   pass boundary (`elastic.pass.r<rank>`), a preempted member the
#   survivors must detect, shrink past and resume without;
# - `heartbeat_loss` raises at the agent's heartbeat probe, which catches
#   it and goes silent for good (a partition: the process computes on);
# - `coordinator_loss` raises at the coordinator's detector probe, which
#   drops the control socket; `coordinator_restart` there restarts the
#   coordinator in place from its durable log (incarnation and epoch
#   bump, same address);
# - `coord_partition` raises at the agent's RPC probe, which turns it
#   into a ConnectionError (control messages dropped one way);
#   `coord_slow` sleeps the coordinator's verb handler for
#   fault_delay_s() and continues.
# The router's `replica_sick` sleeps its probe for fault_delay_s() and
# continues: a replica that turns slow while staying alive and correct.
_KIND_MESSAGES = {
    "oom": ("RESOURCE_EXHAUSTED: injected fault at {site} (hit {hit}): "
            "attempting to allocate past HBM capacity"),
    "timeout": ("DEADLINE_EXCEEDED: injected fault at {site} (hit {hit}): "
                "operation timed out"),
    "comm": ("UNAVAILABLE: injected fault at {site} (hit {hit}): "
             "connection reset by peer"),
    "unknown": "INTERNAL: injected fault at {site} (hit {hit})",
    "hang": "injected hang at {site} (hit {hit})",
    "delay": "injected delay at {site} (hit {hit})",
    "killhard": "injected hard kill at {site} (hit {hit})",
    "journal_corrupt": "injected spill corruption at {site} (hit {hit})",
    "cache_evict_race": "injected cache evict race at {site} (hit {hit})",
    "disk_full": ("RESOURCE_EXHAUSTED: injected disk full at {site} "
                  "(hit {hit}): no space left on device"),
    "bitrot": "injected spill bitrot at {site} (hit {hit})",
    "sync_partial": "injected partial journal sync at {site} (hit {hit})",
    "tenant_flood": ("RESOURCE_EXHAUSTED: injected tenant flood at {site} "
                     "(hit {hit}): admission budget exceeded"),
    "shed": ("UNAVAILABLE: injected shed at {site} (hit {hit}): "
             "request shed under load"),
    "rank_kill": "injected rank kill at {site} (hit {hit})",
    "heartbeat_loss": ("UNAVAILABLE: injected heartbeat loss at {site} "
                       "(hit {hit}): network error"),
    "coordinator_loss": ("UNAVAILABLE: injected coordinator loss at {site} "
                         "(hit {hit}): connection closed"),
    "coordinator_restart": ("UNAVAILABLE: injected coordinator restart at "
                            "{site} (hit {hit}): takeover in progress"),
    "coord_partition": ("UNAVAILABLE: injected control partition at {site} "
                        "(hit {hit}): packet dropped"),
    "coord_slow": "injected slow control verb at {site} (hit {hit})",
    "replica_sick": "injected sick replica at {site} (hit {hit})",
}

FAULT_KINDS = tuple(_KIND_MESSAGES)


def fault_delay_s() -> float:
    """Seconds the ``delay``, ``coord_slow`` and ``replica_sick`` kinds
    sleep the probe (``CYLON_TPU_FAULT_DELAY_S``)."""
    return max(0.0, float(config.knob("CYLON_TPU_FAULT_DELAY_S")))


class InjectedFault(RuntimeError):
    """Synthetic failure raised at a named `fault_point`."""

    def __init__(self, site: str, kind: str, hit: int):
        self.site = site
        self.kind = kind
        self.hit = hit
        super().__init__(_KIND_MESSAGES[kind].format(site=site, hit=hit))


@dataclass
class _FaultRule:
    site: str
    nth: int          # 1-based hit index on which to fire
    kind: str
    persistent: bool  # fire on every hit >= nth


class FaultPlan:
    """Parsed ``CYLON_TPU_FAULT_PLAN``: per-site hit counters + rules.

    Deterministic by construction: a site's Nth hit either always fires
    or never does, independent of timing.  ``hits`` and ``fired`` are
    exposed so tests can assert a site was actually exercised.

    Grammar extensions for chaos schedules (`FaultSchedule`): a
    ``seed=<int>`` entry anywhere in the spec seeds the plan, and a hit
    index may carry ``~J`` (``site@N~J=kind``) — the rule fires on a hit
    drawn deterministically from ``[N, N+J]`` by the seed and the rule's
    position, so one seed replays one exact multi-event timeline while
    different seeds explore different interleavings."""

    def __init__(self, rules: List[_FaultRule], spec: str = "",
                 seed: int = 0):
        self.rules = rules
        self.spec = spec
        self.seed = seed
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []  # (site, kind, hit)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        raw_rules: List[Tuple[str, int, int, str, bool, str]] = []
        seed = 0
        for raw in spec.replace(",", ";").split(";"):
            entry = raw.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                try:
                    seed = int(entry[len("seed="):])
                except ValueError:
                    raise CylonError(Code.Invalid,
                                     f"bad seed in CYLON_TPU_FAULT_PLAN "
                                     f"entry {raw!r}")
                continue
            persistent = False
            kind = "oom"
            if "=" in entry:
                entry, kind = entry.split("=", 1)
                kind = kind.strip().lower()
                if entry.endswith("+"):
                    persistent = True
                    entry = entry[:-1]
            if kind not in _KIND_MESSAGES:
                raise CylonError(Code.Invalid,
                                 f"bad fault kind {kind!r} in "
                                 f"CYLON_TPU_FAULT_PLAN entry {raw!r} "
                                 f"(expected one of {FAULT_KINDS})")
            nth, jit = 1, 0
            if "@" in entry:
                entry, n = entry.split("@", 1)
                if "~" in n:
                    n, j = n.split("~", 1)
                    try:
                        jit = int(j)
                    except ValueError:
                        raise CylonError(Code.Invalid,
                                         f"bad hit jitter {j!r} in "
                                         f"CYLON_TPU_FAULT_PLAN entry "
                                         f"{raw!r}")
                    if jit < 0:
                        raise CylonError(Code.Invalid,
                                         f"hit jitter must be >= 0 in "
                                         f"{raw!r}")
                try:
                    nth = int(n)
                except ValueError:
                    raise CylonError(Code.Invalid,
                                     f"bad hit index {n!r} in "
                                     f"CYLON_TPU_FAULT_PLAN entry {raw!r}")
                if nth < 1:
                    raise CylonError(Code.Invalid,
                                     f"hit index must be >= 1 in {raw!r}")
            site = entry.strip()
            if not site:
                raise CylonError(Code.Invalid,
                                 f"empty site in CYLON_TPU_FAULT_PLAN "
                                 f"entry {raw!r}")
            raw_rules.append((site, nth, jit, kind, persistent, raw))
        rules: List[_FaultRule] = []
        for idx, (site, nth, jit, kind, persistent, _raw) in \
                enumerate(raw_rules):
            if jit:
                # the seed + rule position pick the exact hit: one spec
                # string is one timeline, replayable byte-for-byte
                nth += _splitmix64((seed & _U64) ^ _splitmix64(idx + 1)) \
                    % (jit + 1)
            rules.append(_FaultRule(site, nth, kind, persistent))
        return cls(rules, spec, seed=seed)

    def check(self, site: str) -> Optional[str]:
        """Record one hit of ``site``; return the fault kind to raise, or
        None."""
        hit = self.hits.get(site, 0) + 1
        self.hits[site] = hit
        for r in self.rules:
            if r.site != site:
                continue
            if hit == r.nth or (r.persistent and hit >= r.nth):
                self.fired.append((site, r.kind, hit))
                return r.kind
        return None


# Override plan (tests, via the fault_plan() context manager) wins over the
# env-driven plan; the env plan object persists while the spec string is
# unchanged so its hit counters accumulate across sites in one process.
_OVERRIDE_PLAN: Optional[FaultPlan] = None
_ENV_PLAN: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    global _ENV_PLAN
    if _OVERRIDE_PLAN is not None:
        return _OVERRIDE_PLAN
    spec = config.knob_raw("CYLON_TPU_FAULT_PLAN") or ""
    if not spec:
        _ENV_PLAN = None
        return None
    if _ENV_PLAN is None or _ENV_PLAN.spec != spec:
        _ENV_PLAN = FaultPlan.parse(spec)
    return _ENV_PLAN


def fault_point(site: str) -> None:
    """Injection probe: no-op unless an active fault plan names ``site``
    and its hit counter matches.  Costs one dict lookup when no plan is
    active — safe on hot paths."""
    plan = _OVERRIDE_PLAN
    if plan is None:
        if not config.knob_raw("CYLON_TPU_FAULT_PLAN"):
            return
        plan = active_plan()
        if plan is None:
            return
    kind = plan.check(site)
    if kind is not None:
        obs_spans.instant("fault.injected", site=site, kind=kind,
                          hit=plan.hits[site])
        obs_metrics.counter_add("fault.injected")
        if kind in ("killhard", "rank_kill", "sync_partial"):
            # simulate kill -9 / preemption: no cleanup, no atexit, no
            # flushed buffers (and no CUDA teardown) — exactly what the
            # journal must survive (rank_kill: what the gang's survivors
            # must detect, shrink past and resume without)
            os._exit(137)
        if kind in ("journal_corrupt", "bitrot", "cache_evict_race", "hang"):
            from . import durable

            if kind == "journal_corrupt":
                durable._corrupt_last_spill()
            elif kind == "bitrot":
                durable._bitrot_last_run(plan.hits[site])
            elif kind == "cache_evict_race":
                durable._evict_last_run_spills()
            else:
                time.sleep(max(1.5 * durable.deadline_s(), 0.05))
            return
        if kind in ("delay", "coord_slow", "replica_sick"):
            time.sleep(fault_delay_s())
            return
        if kind == "disk_full":
            # the genuine errno, so classification (and any errno-based
            # handling) is identical to a really-full disk
            raise OSError(errno.ENOSPC, _KIND_MESSAGES[kind].format(
                site=site, hit=plan.hits[site]))
        raise InjectedFault(site, kind, plan.hits[site])


@contextlib.contextmanager
def fault_plan(spec: str):
    """Install a fresh fault plan for the duration of the block (tests).
    Yields the `FaultPlan` so callers can assert on ``hits``/``fired``."""
    global _OVERRIDE_PLAN
    prev = _OVERRIDE_PLAN
    plan = FaultPlan.parse(spec)
    _OVERRIDE_PLAN = plan
    try:
        yield plan
    finally:
        _OVERRIDE_PLAN = prev


class FaultSchedule:
    """Composable, seeded multi-event chaos timeline.

    Chain :meth:`at` calls to compose any of the registered fault kinds
    (the engine's, the journal's and the serve layer's) into one
    `FaultPlan` spec string, which ``CYLON_TPU_FAULT_PLAN`` (a worker's
    environment) or :meth:`install` (an in-process test) drives.  The
    schedule's ``seed`` resolves every jittered hit index at parse
    time, so a timeline is a pure function of (spec, seed): re-running
    it replays the exact same event order, and sweeping seeds explores
    different interleavings deterministically.

        sched = (FaultSchedule(seed=11)
                 .at("serve.admit", "tenant_flood", nth=2)
                 .at("pass_dispatch", "oom", nth=3, jitter=4)
                 .at("host_fetch", "delay", nth=1, persistent=True))
        env["CYLON_TPU_FAULT_PLAN"] = sched.spec()
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._events: List[Tuple[str, str, int, int, bool]] = []

    def at(self, site: str, kind: str, nth: int = 1, jitter: int = 0,
           persistent: bool = False) -> "FaultSchedule":
        """Add one event: fire ``kind`` on a hit of ``site`` drawn from
        ``[nth, nth+jitter]`` by the schedule's seed.  Returns self for
        chaining.  The kind is checked now, by `FaultPlan.parse`: an
        unknown kind is `Code.Invalid`."""
        FaultPlan.parse(f"{site}@1={kind}")
        self._events.append((site, kind, int(nth), int(jitter),
                             bool(persistent)))
        return self

    def spec(self) -> str:
        """The composed ``CYLON_TPU_FAULT_PLAN`` spec string."""
        parts = [f"seed={self.seed}"] if self.seed else []
        for site, kind, nth, jitter, persistent in self._events:
            at = f"@{nth}" + (f"~{jitter}" if jitter else "")
            parts.append(f"{site}{at}{'+' if persistent else ''}={kind}")
        return ";".join(parts)

    def plan(self) -> FaultPlan:
        """The parsed (jitter-resolved) plan this schedule compiles to."""
        return FaultPlan.parse(self.spec())

    def install(self):
        """Context manager installing the schedule as the active fault
        plan (tests); yields the `FaultPlan` for hit/fired asserts."""
        return fault_plan(self.spec())


def classify(exc: BaseException) -> Code:
    """Shorthand: the classified `Code` of an exception."""
    return Status.from_exception(exc).code
