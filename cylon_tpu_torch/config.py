"""Join types and configs, sort options, and the environment-knob registry.

``JoinType``, ``JoinAlgorithm``, ``JoinConfig`` and ``SortOptions`` mirror
the JAX package's ``cylon_tpu/config.py:29``, ``:38``, ``:67`` and ``:107``
(reference: join/join_config.hpp, table.hpp).
``KNOBS`` is the one place this package reads a
``CYLON_TPU_*`` environment variable; ``knob()`` and ``knob_raw()`` are its
accessors, as in ``cylon_tpu/config.py:649``.  It holds only the knobs the
ported modules read, with the JAX package's names and defaults.
"""
from __future__ import annotations

import contextlib
import enum
import os
from dataclasses import dataclass
from typing import Optional, Tuple, Union


class JoinType(enum.IntEnum):
    """reference: join/join_config.hpp JoinType."""

    INNER = 0
    LEFT = 1
    RIGHT = 2
    FULL_OUTER = 3


class JoinAlgorithm(enum.IntEnum):
    """reference: join/join_config.hpp JoinAlgorithm {SORT, HASH}: the
    sort-merge join (``ops/join.py``) or the hash join
    (``ops/hash_join.py``)."""

    SORT = 0
    HASH = 1


_JOIN_TYPE_OF = {
    "inner": JoinType.INNER, "left": JoinType.LEFT, "right": JoinType.RIGHT,
    "fullouter": JoinType.FULL_OUTER, "full_outer": JoinType.FULL_OUTER,
    "outer": JoinType.FULL_OUTER,
}
_ALGO_OF = {"sort": JoinAlgorithm.SORT, "hash": JoinAlgorithm.HASH}


def join_algorithm(algorithm) -> JoinAlgorithm:
    """THE normalizer of a join algorithm: a ``JoinAlgorithm``, or
    ``"sort"`` / ``"hash"`` in any case.  Every reader compares the enum,
    so a string never silently picks the sort join."""
    if isinstance(algorithm, str):
        try:
            return _ALGO_OF[algorithm.lower()]
        except KeyError:
            raise ValueError(f"join algorithm must be sort/hash, got "
                             f"{algorithm!r}") from None
    return JoinAlgorithm(algorithm)


@dataclass(frozen=True)
class JoinConfig:
    """Join type x algorithm x key columns x output-name prefixes
    (``cylon_tpu/config.py:67``; reference: join/join_config.hpp:29-89).
    ``algorithm`` is stored as a ``JoinAlgorithm``; ``"sort"`` and
    ``"hash"`` are accepted and normalized."""

    join_type: JoinType = JoinType.INNER
    algorithm: JoinAlgorithm = JoinAlgorithm.SORT
    left_on: Tuple = ()
    right_on: Tuple = ()
    left_prefix: str = "l_"
    right_prefix: str = "r_"

    def __post_init__(self):
        object.__setattr__(self, "join_type", JoinType(self.join_type))
        object.__setattr__(self, "algorithm",
                           join_algorithm(self.algorithm))

    @staticmethod
    def of(join_type, algorithm: Union[str, JoinAlgorithm] = "sort",
           left_on=(), right_on=(), left_prefix: str = "l_",
           right_prefix: str = "r_") -> "JoinConfig":
        if isinstance(join_type, str):
            join_type = _JOIN_TYPE_OF[join_type.lower().replace("-", "_")]
        return JoinConfig(join_type, algorithm, _as_tuple(left_on),
                          _as_tuple(right_on), left_prefix, right_prefix)

    # the factories of join_config.hpp (``cylon_tpu/config.py:88-104``)
    @staticmethod
    def InnerJoin(left_on, right_on, algorithm="sort") -> "JoinConfig":
        return JoinConfig.of("inner", algorithm, left_on, right_on)

    @staticmethod
    def LeftJoin(left_on, right_on, algorithm="sort") -> "JoinConfig":
        return JoinConfig.of("left", algorithm, left_on, right_on)

    @staticmethod
    def RightJoin(left_on, right_on, algorithm="sort") -> "JoinConfig":
        return JoinConfig.of("right", algorithm, left_on, right_on)

    @staticmethod
    def FullOuterJoin(left_on, right_on, algorithm="sort") -> "JoinConfig":
        return JoinConfig.of("full_outer", algorithm, left_on, right_on)


def _as_tuple(v) -> Tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


@dataclass(frozen=True)
class SortOptions:
    """Options of the distributed sort's sampled-histogram range
    partitioner (``cylon_tpu/config.py:107``; reference: table.hpp:365-373
    SortOptions)."""

    ascending: bool = True
    num_bins: int = 0        # 0 -> 16 * world_size (reference default)
    num_samples: int = 0     # 0 -> 4096 per shard
    nulls_first: bool = True


@dataclass(frozen=True)
class Knob:
    """An environment knob of one ``kind``: "str", "int", "float", "bool",
    or "enum" (one of ``choices``), as ``cylon_tpu/config.py:133``."""

    name: str
    kind: str
    default: object
    help: str
    choices: Tuple[str, ...] = ()


_K = Knob

KNOBS = {k.name: k for k in [
    # -- the shuffle's exchange (parallel/plane.py) ------------------------
    _K("CYLON_TPU_SHUFFLE_PACK", "enum", "auto",
       "Shuffle exchange realization: one bit-packed plane of 32-bit words "
       "per collective (packed) or one collective per buffer per column "
       "(perbuf); auto packs only on TPU-family backends, so it is perbuf "
       "on CUDA and on the CPU.",
       ("1", "on", "packed", "0", "off", "perbuf", "auto")),
    _K("CYLON_TPU_SHUFFLE_COMPRESS", "enum", "auto",
       "Compress the packed plane before it travels: integer columns "
       "narrow to their observed range, string columns truncate to their "
       "observed byte extent, low-cardinality string columns travel as "
       "codes into one all-gathered dictionary; bit-exact.  Rides "
       "CYLON_TPU_SHUFFLE_PACK; auto is off on CUDA and on the CPU.",
       ("1", "on", "0", "off", "auto")),
    _K("CYLON_TPU_ACCUM", "enum", "auto",
       "Accumulation precision: wide (f64/int64 accumulators), narrow "
       "(f32/int32, scans through the CUDA scan kernels), or auto "
       "(narrow for CUDA tensors, wide for CPU tensors).",
       ("auto", "wide", "narrow")),
    _K("CYLON_TPU_MAX_STRING_WIDTH", "int", 4096,
       "Widest byte matrix a string column may ingest without an explicit "
       "string_width= (device memory = capacity x width)."),
    # -- the host C++ library (native/) and the I/O layer (io/) ------------
    _K("CYLON_TPU_NO_NATIVE_IO", "bool", False,
       "Disable the native (C++) CSV reader and writer; use pyarrow."),
    _K("CYLON_TPU_NO_NATIVE", "bool", False,
       "Disable loading the native host library entirely."),
    # -- the out-of-core engine (exec.py) and its resilience layer --------
    _K("CYLON_TPU_ONESHOT_FALLBACK", "bool", True,
       "Allow a single-shard one-shot op that dies of device OOM to "
       "fall back to the chunked out-of-core engine."),
    _K("CYLON_TPU_FALLBACK_PASSES", "int", 4,
       "Initial pass count for the one-shot -> chunked OOM fallback."),
    _K("CYLON_TPU_CHUNK_PRESORT", "bool", True,
       "Pre-group host rows by pass id once (O(n)) instead of masking "
       "per pass (O(n x passes)) in the chunked engine."),
    _K("CYLON_TPU_PREFETCH", "bool", True,
       "Overlap host slicing and upload of pass p+1 with device execution "
       "of pass p in the chunked engine."),
    _K("CYLON_TPU_MAX_OOM_SPLITS", "int", 4,
       "How many times the out-of-core engine may double the pass count "
       "before a device OOM becomes fatal."),
    _K("CYLON_TPU_RETRY_MAX", "int", 2,
       "Transient-failure retry budget (RetryPolicy.from_env)."),
    _K("CYLON_TPU_RETRY_BASE_S", "float", 0.05,
       "Base backoff seconds for transient retries."),
    _K("CYLON_TPU_RETRY_MAX_S", "float", 2.0,
       "Backoff ceiling seconds for transient retries."),
    _K("CYLON_TPU_FAULT_PLAN", "str", "",
       "Deterministic fault-injection plan: `site[@N][+][=kind]` entries "
       "joined by `;` (resilience.FaultPlan.parse), e.g. "
       "`pass_dispatch@2=oom;host_fetch@1=timeout`; empty disables."),
    _K("CYLON_TPU_PASS_DEADLINE_S", "float", 0.0,
       "Per-pass wall-clock budget: a watchdog thread fires "
       "deadline.fired when a pass runs past it; 0 (default) disables."),
    _K("CYLON_TPU_QUARANTINE_AFTER", "int", 0,
       "Poison-pass quarantine: a part failing with the same classified "
       "code this many consecutive times is isolated into the run report "
       "(stats['quarantined']); 0 (default) disables."),
    _K("CYLON_TPU_DURABLE_DIR", "str", "",
       "Root directory for the durable-execution run journal: each "
       "fingerprinted one-shard chunked run (and each planned query) "
       "spills completed passes as checksummed Arrow IPC files + an "
       "append-only manifest, so a fresh process re-invoking the same run "
       "resumes mid-plan (kill -9 safe).  Empty (default) disables "
       "journaling."),
    _K("CYLON_TPU_DURABLE_CAP_BYTES", "int", 0,
       "Size cap for the durable journal root: past it, whole runs are "
       "evicted least-recently-used first (spills before the manifest, so "
       "a half-evicted run re-executes instead of serving a torn "
       "journal).  0 (default) = unbounded."),
    _K("CYLON_TPU_DURABLE_RF", "int", 2,
       "Target copies of every completed journal run across the fleet's "
       "DISTINCT journal roots (anti-entropy replication: replicas "
       "advertise per-run digests on heartbeats, the coordinator hints "
       "under-replicated runs back, replicas pull them spills-first/"
       "manifest-last).  gc_journal never evicts a run while fewer than "
       "this many roots hold it.  1 disables replication entirely."),
    _K("CYLON_TPU_SCRUB_S", "float", 0.0,
       "Seconds between background journal-integrity scrub passes "
       "(re-verify every committed spill's sha256 under the GC lease; "
       "repair from a peer when one holds a good copy, quarantine "
       "manifest-LAST otherwise).  0 (default) disables the scrubber "
       "thread; durable_sync.scrub_once can always be called directly."),
    _K("CYLON_TPU_DURABLE_QUOTA_BYTES", "int", 0,
       "Hard disk budget for new journal spills under the shared "
       "CYLON_TPU_DURABLE_DIR: a spill that would push the root past it "
       "(or a write hitting real ENOSPC) classifies Code.ResourceExhausted "
       "and the run degrades to journal-off execution (counted "
       "durable.degraded); the query never fails for disk.  0 (default) "
       "disables."),
    _K("CYLON_TPU_ROUTER_MAX_LINE_BYTES", "int", 64 << 20,
       "Wire cap for one data-plane message (a journal peer's spill or "
       "manifest blob; the router's encoded tables once it is ported).  "
       "A message larger than this is refused as a ProtocolError, never "
       "silently truncated."),
    # -- the query service (serve/) -----------------------------------------
    _K("CYLON_TPU_SERVE_QUEUE_CAP", "int", 64,
       "Bounded admission queue of the multi-tenant query service: "
       "submissions past this depth are shed with Code.ResourceExhausted "
       "and a retry-after hint, never an unbounded wait."),
    _K("CYLON_TPU_SERVE_TENANT_SHARE", "float", 0.5,
       "Largest fraction of the admission queue one tenant may occupy: "
       "beyond ceil(cap * share) queued requests the TENANT is shed while "
       "others keep admitting."),
    _K("CYLON_TPU_SERVE_HBM_BUDGET_BYTES", "int", 0,
       "Per-tenant device-memory admission budget: a request whose "
       "input-size estimate plus the live hbm.live_bytes watermark "
       "exceeds it is shed with Code.ResourceExhausted at admission, "
       "before any device allocation.  0 (default) disables."),
    _K("CYLON_TPU_SERVE_DEADLINE_S", "float", 0.0,
       "Default per-request wall-clock budget of the query service "
       "(per-tenant overridable): the Code.Timeout watchdog arms over the "
       "whole run and the scheduler stops it at the next pass boundary.  "
       "0 (default) disables."),
    _K("CYLON_TPU_SERVE_QUARANTINE_AFTER", "int", 3,
       "Per-tenant quarantine: a tenant whose requests fail this many "
       "consecutive times is shed (Code.Unavailable + retry-after) for "
       "CYLON_TPU_SERVE_QUARANTINE_S.  0 disables."),
    _K("CYLON_TPU_SERVE_QUARANTINE_S", "float", 30.0,
       "How long a quarantined tenant stays shed before its failure "
       "streak resets."),
    # -- streams (stream/) ---------------------------------------------------
    _K("CYLON_TPU_STREAM_BATCH_CAP", "int", 0,
       "Fixed device capacity per streaming micro-batch (rows); 0 "
       "(default) derives pow2ceil(batch rows) per batch.  A result knob: "
       "the padded batch shape is part of the stream's cached callables "
       "and of its persisted-state namespace."),
    _K("CYLON_TPU_STREAM_STATE_CAP", "int", 0,
       "Floor for the incremental group-by's persisted-state group "
       "capacity (rows); 0 (default) derives it from the first batch's "
       "group count.  A result knob, as CYLON_TPU_STREAM_BATCH_CAP."),
    # -- observability (obs/) ----------------------------------------------
    _K("CYLON_TPU_TRACE", "enum", "auto",
       "Tracing mode: auto (aggregate stopwatch only), 1/on (plus the "
       "bounded event buffer), 0/off (no-op).",
       ("auto", "0", "off", "1", "on")),
    _K("CYLON_TPU_TRACE_DIR", "str", "traces",
       "Directory for exported traces and metrics "
       "(trace[.<run_id>].r<rank>.json), flight-recorder dumps "
       "(flight/<run_id>.r<rank>.json) and plan-profile artifacts "
       "(plan_profile.r<rank>.json)."),
    _K("CYLON_TPU_TRACE_SYNC", "bool", False,
       "Fence device work (torch.cuda.synchronize) at span boundaries so "
       "device time lands in the span that launched it instead of the "
       "span doing the blocking fetch.  Off by default: the fence "
       "serializes the pipeline."),
    _K("CYLON_TPU_TRACE_TAIL_MS", "float", 0.0,
       "Tail-based trace retention: a closing serve request KEEPS its "
       "buffered span events only when it was slow (above this many "
       "milliseconds, or above the rolling p99 estimate), failed, or "
       "head-sampled (CYLON_TPU_TRACE_SAMPLE_N); the others' events are "
       "discarded at close and counted in trace.tail_dropped.  0 "
       "(default) keeps every event."),
    _K("CYLON_TPU_TRACE_SAMPLE_N", "int", 0,
       "1-in-N head sampling of the request traces the serve layer mints: "
       "a sampled trace survives tail-based retention regardless of "
       "latency.  0 (default) disables."),
    _K("CYLON_TPU_TRACEPARENT", "str", "",
       "Ambient W3C traceparent adopted as this process's root trace "
       "context whenever no request context is active.  Empty (default) "
       "leaves spans unstamped outside requests."),
    _K("CYLON_TPU_RUN_ID", "str", "",
       "Logical run id namespacing trace/metrics exports "
       "(trace.<run_id>.r<rank>.json) and flight-recorder dumps; empty "
       "(default) keeps the flat per-rank naming."),
    _K("CYLON_TPU_DEBUG", "bool", False,
       "Log every span's duration at INFO (cylon_tpu_torch.obs.spans)."),
    _K("CYLON_TPU_METRICS_PORT", "int", 0,
       "Per-process OpenMetrics scrape port: a stdlib HTTP listener "
       "answers GET /metrics with the obs.metrics snapshot in the "
       "Prometheus text format, started by obs.openmetrics.ensure_server "
       "(QueryService calls it).  0 (default) disables; a failed bind "
       "warns and skips."),
    # -- the query planner (plan/) and its statistics catalog -------------
    _K("CYLON_TPU_PLAN", "enum", "auto",
       "Logical-plan optimizer for Table.plan() pipelines: shuffle "
       "elision, column pruning, scan sharing and the fused join -> "
       "aggregate shard body (auto/on, default) vs the eager per-op "
       "lowering (off, the A/B baseline).  Results are bit-identical "
       "either way.", ("1", "on", "0", "off", "auto")),
    _K("CYLON_TPU_PLAN_ADAPTIVE", "enum", "auto",
       "Statistics-driven physical strategies on top of CYLON_TPU_PLAN: "
       "broadcast-hash joins for dimension-sized sides and skew-salted "
       "NUNIQUE repartition (plan/cost.py).  auto (default) is off; 1/on "
       "opts in.", ("1", "on", "0", "off", "auto")),
    _K("CYLON_TPU_PLAN_BROADCAST_BYTES", "int", 1 << 20,
       "Adaptive planner: the largest estimated join-side payload (bytes) "
       "a broadcast-hash join may replicate to every shard."),
    _K("CYLON_TPU_PLAN_SKEW_SALT", "float", 4.0,
       "Adaptive planner: salt a NUNIQUE repartition when the catalog's "
       "observed shard skew (max/mean shard rows) reaches this factor."),
    _K("CYLON_TPU_PROFILE", "bool", False,
       "Query profiler: collect per-plan-node actuals (rows, self time, "
       "exchange bytes, shard skew) on every plan.execute and export a "
       "plan_profile artifact; explain(analyze=True) forces one profiled "
       "run regardless."),
    _K("CYLON_TPU_STATS_DIR", "str", "",
       "Persistent statistics catalog root (STATS.jsonl, keyed by the plan "
       "fingerprint); profiled plan runs append what they observed.  Empty "
       "(default) disables."),
    _K("CYLON_TPU_STATS_CAP", "int", 256,
       "Distinct plan fingerprints the statistics catalog keeps before "
       "compacting to the most recently written."),
    _K("CYLON_TPU_FP_SALT", "str", "",
       "Opaque salt mixed into every plan fingerprint; empty (default) "
       "keeps fingerprints stable across runs."),
]}

#: the knobs whose values change what a computation returns (the
#: accumulation precision, the exchange realization and the stream's
#: capacities), folded into every plan fingerprint and every cached
#: stream callable's key by ``trace_cache_token``.  The reference's
#: segsum, scan and sort modes have no counterpart here: the port always
#: runs its scan kernels and its one sort.
RESULT_KNOBS = ("CYLON_TPU_ACCUM", "CYLON_TPU_SHUFFLE_PACK",
                "CYLON_TPU_SHUFFLE_COMPRESS", "CYLON_TPU_STREAM_BATCH_CAP",
                "CYLON_TPU_STREAM_STATE_CAP")

_FALSE_WORDS = ("0", "false", "off", "no")


def knob_raw(name: str) -> Optional[str]:
    """The knob's raw environment value, or None when unset; ``name`` must
    be registered."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}; add it to "
                       "cylon_tpu_torch.config.KNOBS")
    return os.environ.get(name)


def knob(name: str):
    """The knob's parsed value: the environment's when it is set and
    parses for the knob's kind, else the registered default (as
    ``cylon_tpu/config.py:649``)."""
    k = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return k.default
    if k.kind == "str":
        return raw
    if k.kind == "enum":
        return raw if raw in k.choices else k.default
    if k.kind == "bool":
        return raw.lower() not in _FALSE_WORDS
    try:
        return int(raw) if k.kind == "int" else float(raw)
    except ValueError:
        return k.default


def trace_cache_token() -> Tuple[Tuple[str, Optional[str]], ...]:
    """The (name, raw value) vector of every knob that can change results
    (``RESULT_KNOBS``), and the accumulation mode set in code
    (``precision.set_accumulation``), the counterpart of
    ``cylon_tpu/config.py:682 trace_cache_token``.  Raw values suffice:
    ``auto`` resolves alike for a process's lifetime."""
    from . import precision

    return tuple((n, os.environ.get(n)) for n in RESULT_KNOBS) + (
        ("precision.set_accumulation", precision._MODE),)


@contextlib.contextmanager
def knob_env(**overrides: Optional[str]):
    """Temporarily set (or, with None, unset) registered knobs in the
    process environment."""
    for name in overrides:
        if name not in KNOBS:
            raise KeyError(f"unregistered knob {name!r}")
    saved = {name: os.environ.get(name) for name in overrides}
    try:
        for name, val in overrides.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
        yield
    finally:
        for name, val in saved.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
