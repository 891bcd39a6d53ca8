"""Plan executor: lowers an (optimized) physical plan onto the engine.

The port of ``cylon_tpu/plan/executor.py`` on torch.  Two lowering modes
share one interpreter, so the A/B is exact:

- ``CYLON_TPU_PLAN`` off — the EAGER plan: no pruning, every
  distributed join/group-by pays its full shuffle, every intermediate
  materializes (the same ``_local_join`` / ``distributed_groupby`` /
  shuffle code paths the ``Table`` method chain runs, in the same
  order);
- on (default) — the optimized plan: pruned scans, elided/shared
  exchanges, and the fused join→aggregate shard body.

Bit-identity between the two modes is a hard invariant (the reference's
``cylon_tpu/plan/executor.py:14-19``): elision never changes which rows
meet, only where; the fused body runs the same kernels in the same order
on the same values; and an elided group-by's final combine folds exactly
one partial per group (co-location guarantees it), which is the identity
for every combine op.

Where the reference traces one ``shard_map`` program per stage, the port
runs each stage shard by shard (``table._shard_wise``).  The fused body
sizes its output with ONE host sync (every shard's exact join count in
one stacked fetch, maxed over a process group) and rounds it with
``table.cap_round``, as the eager ``_local_join`` does.

Durable integration is at PLAN granularity (``cylon_tpu/plan/
executor.py:73-108``): with ``CYLON_TPU_DURABLE_DIR`` set, one fingerprint
for the whole op chain (``LogicalPlan.fingerprint``), one journaled result
frame — a repeated plan replays from spill with zero device passes and
zero kernel launches (``plan.cache_hit``), served as a one-shard ``Table``
on the plan's device.  A plan over a process group runs unjournaled (each
process would race the others to the cache).  :func:`run_service` is
the serve layer's runner of the ``plan`` op.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import config, durable
from ..config import JoinConfig
from ..context import CylonContext
from ..obs import fleet as obs_fleet
from ..obs import metrics as obs_metrics
from ..obs import spans as obs_spans
from ..obs import stats_catalog
from ..status import Code, CylonError, Status
from . import ir, optimizer
from . import profile as profile_mod


def planner_enabled() -> bool:
    """Whether plan.execute() runs the optimizer (``CYLON_TPU_PLAN``;
    auto/on = optimize, off = eager per-op lowering)."""
    return str(config.knob("CYLON_TPU_PLAN")) not in ("0", "off")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def execute(plan: "ir.LogicalPlan", ctx=None, pass_guard=None,
            stats_out: Optional[dict] = None,
            profile: Optional["profile_mod.PlanProfile"] = None):
    """Run the plan, returning a Table.

    ``profile=`` (or the ``CYLON_TPU_PROFILE`` knob) collects per-node
    actuals into a :class:`~cylon_tpu_torch.plan.profile.PlanProfile` —
    the EXPLAIN ANALYZE substrate — and, with ``CYLON_TPU_STATS_DIR``
    set, persists the observed statistics to the catalog under the plan
    fingerprint.  Over a process group every process must call it alike
    (every stage is collective, the fingerprint included).

    With ``CYLON_TPU_DURABLE_DIR`` set (and one process) the run is
    journaled at plan granularity; a repeated fingerprint is served
    entirely from spill as a one-shard ``Table`` on the plan's device
    (``stats_out["cache_hit"]``, counter ``plan.cache_hit``): no exchange,
    no kernel launch."""
    from ..table import Table

    if ctx is None:
        ctx = plan._ctx()
    if ctx is None:
        ctx = CylonContext.Init()
    world = plan._world()
    enabled = planner_enabled()
    stats = stats_out if stats_out is not None else {}
    stats.update(passes=1, passes_skipped=0, parts_run=0)
    prof = profile
    if prof is None and profile_mod.profiler_enabled():
        prof = profile_mod.PlanProfile()

    fp: Optional[str] = None
    sfp: Optional[str] = None
    journal = None
    journaled = durable.enabled() and ctx.group is None
    if journaled or (prof is not None and stats_catalog.enabled()):
        fp = plan.fingerprint()
    if prof is not None and fp is not None and stats_catalog.enabled():
        # the catalog is keyed by the strategy-independent base
        # fingerprint: observations describe what the query IS, not what
        # the planner chose (with the adaptive knob off they agree)
        sfp = (plan.base_fingerprint() if optimizer.planner_adaptive()
               else fp)
    if prof is not None:
        prof.fingerprint = fp
        if sfp is not None:
            prof.estimates = stats_catalog.lookup(sfp)
    if journaled:
        journal = durable.open_run(fp, "plan", world=world)
        if journal is not None and journal.is_complete():
            # a complete journal is a cache entry; a spill that fails its
            # checksum (or was evicted under us) misses and falls through
            # to execution, never to a torn serve
            got = journal.load_pass(0, 0)
            if got is not None:
                frame, rows = got
                obs_metrics.counter_add("plan.cache_hit")
                obs_spans.instant("plan.cache_hit", fingerprint=fp[:12],
                                  rows=rows)
                stats.update(passes_skipped=1, rows=rows, cache_hit=True)
                if prof is not None:
                    prof.plan_cache_hit = True
                    prof.finalize(optimizer.optimize(plan, enabled=enabled),
                                  0)
                    prof.export()
                return Table.from_numpy(
                    list(frame), list(frame.values()),
                    ctx=CylonContext.Init(ctx.devices[0]))

    t_run0 = time.perf_counter_ns()
    try:
        with obs_spans.span("plan.optimize", world=world, enabled=enabled):
            phys = optimizer.optimize(plan, enabled=enabled)
        if enabled:
            obs_metrics.counter_add("plan.shuffles_elided",
                                    phys.shuffles_elided)
            obs_metrics.counter_add("plan.columns_pruned",
                                    phys.columns_pruned)
        if phys.adaptive:
            obs_metrics.counter_add("plan.broadcast_joins",
                                    phys.broadcast_joins)
            obs_metrics.counter_add("plan.keys_salted", phys.keys_salted)
        with obs_spans.span("plan.execute", world=world, nodes=phys.nodes,
                            elided=phys.shuffles_elided,
                            pruned=phys.columns_pruned, optimized=enabled):
            result = _Executor(plan, phys, ctx, pass_guard, prof).run()
    except Exception as e:
        # a terminal planner failure dumps the flight recorder; a
        # deliberate cancel or an elastic resume is not terminal
        st = Status.from_exception(e)
        if st.code not in (Code.EpochMismatch, Code.Cancelled):
            obs_spans.instant("plan.fatal", code=st.code.name,
                              fingerprint=fp[:12] if fp else None,
                              world=world)
            obs_fleet.flight_record(
                "plan_fatal", code=st.code.name,
                fingerprint=fp[:12] if fp else None, world=world,
                error=f"{type(e).__name__}: {e}"[:200])
        raise
    stats.update(parts_run=1, rows=result.row_count, cache_hit=False)
    if prof is not None:
        prof.finalize(phys, time.perf_counter_ns() - t_run0)
        prof.attach_fleet_skew(ctx)
        if sfp is not None:
            stats_catalog.record(sfp, prof.catalog_record(plan))
        prof.export()
    if journal is not None:
        journal.record_pass(0, 0, result.to_numpy(), int(stats["rows"]))
        journal.record_done(1, int(stats["rows"]))
        durable.gc_journal()
    if phys.root.part is not None:
        result._partitioning = phys.root.part
    return result


def run_service(plan: "ir.LogicalPlan", *, ctx=None, pass_guard=None,
                **_kw):
    """The serve layer's runner (op ``"plan"``,
    ``cylon_tpu/plan/executor.py:182``): executes on the plan inputs' own
    context (the service ``ctx`` is accepted for signature parity: a plan
    over a 4-shard mesh shuffles across that mesh) and returns ``(host
    frame, stats)`` with the journal-replay stats shape
    ``serve.cache.served_from_journal`` reads."""
    stats: dict = {}
    t = execute(plan, pass_guard=pass_guard, stats_out=stats)
    return t.to_numpy(), stats


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


def _join_counts(ctx, counts) -> np.ndarray:
    """Every shard's exact join count on the host, in global shard order:
    ONE host sync (the counts stacked on the first shard's device), then
    one all-gather over a process group."""
    from ..parallel import collectives

    dev = counts[0].device
    local = torch.stack([torch.as_tensor(c).to(dev).reshape(())
                         .to(torch.int64) for c in counts]).cpu().numpy()
    return collectives.process_allgather(local, ctx.group)


class _Executor:
    def __init__(self, plan, phys: optimizer.PhysPlan, ctx, pass_guard,
                 profile: Optional["profile_mod.PlanProfile"] = None):
        self.plan = plan
        self.phys = phys
        self.ctx = ctx
        self.world = phys.world
        self.pass_guard = pass_guard
        self.profile = profile

    def run(self):
        return self._exec(self.phys.root)

    def _guard(self) -> None:
        if self.pass_guard is not None:
            self.pass_guard()

    # -- generic dispatch ------------------------------------------------
    def _exec(self, p: optimizer.Phys):
        prof = self.profile
        if prof is None:
            return self._exec_node(p)
        # profiled: two clock reads + a handful of counter reads around
        # the node, plus one row-count fetch of the ALREADY-materialized
        # result — the node's subtree deltas; finalize() subtracts
        # recorded descendants for self values.
        before = profile_mod.counters_now()
        t0 = time.perf_counter_ns()
        t = self._exec_node(p)
        prof.record_node(p, t, time.perf_counter_ns() - t0, before)
        return t

    def _exec_node(self, p: optimizer.Phys):
        n = p.node
        if isinstance(n, ir.Scan):
            return self._project_to(self.plan.inputs[n.idx], p.keep)
        if isinstance(n, ir.Project):
            return self._project_to(self._exec(p.children[0]), p.keep)
        if isinstance(n, ir.Filter):
            t = self._filter_table(self._exec(p.children[0]), n.pred)
            return self._project_to(t, p.keep)
        if isinstance(n, ir.Derive):
            t = self._exec(p.children[0])
            if not p.ann.get("dead"):
                t = self._derive_table(t, n.name, n.value)
            return self._project_to(t, p.keep)
        if isinstance(n, ir.Join):
            return self._project_to(self._exec_join(p), p.keep)
        if isinstance(n, ir.Aggregate):
            if p.ann.get("fuse"):
                return self._project_to(self._fused_join_agg(p), p.keep)
            return self._project_to(self._exec_agg(p), p.keep)
        if isinstance(n, ir.Sort):
            return self._project_to(self._exec_sort(p), p.keep)
        if isinstance(n, ir.Limit):
            return self._project_to(self._exec_limit(p), p.keep)
        raise CylonError(Code.Invalid, f"unknown node {n.kind!r}")

    @staticmethod
    def _project_to(t, keep: Tuple[str, ...]):
        if tuple(t.names) == tuple(keep):
            return t
        return t.project(list(keep))

    # -- scans / local row ops -------------------------------------------
    @staticmethod
    def _filter_table(t, pred):
        from ..table import _compact_rows, _shard_wise

        names = t.names

        def fn(cols, n):
            c = pred.evaluate(dict(zip(names, cols)))
            return _compact_rows(cols, _keep_mask(c, n))

        return _shard_wise(fn, t)

    @staticmethod
    def _derive_table(t, name: str, value):
        from ..table import _shard_wise

        names = t.names

        def fn(cols, n):
            return tuple(cols) + (value.evaluate(dict(zip(names, cols))),), n

        out = _shard_wise(fn, t)
        return out._like(out.shards, out.counts, names + (name,))

    def _exec_chain(self, p: optimizer.Phys, keep: Tuple[str, ...]):
        """Execute a pure scan chain with an overridden column set (the
        shared-scan rule's union keep).  Profiled like ``_exec`` — a
        self-join the shared-scan rule merged must still feed scan
        cardinality and filter selectivity to the catalog (the chain
        runs ONCE for both sides, so records land on the LEFT child's
        subtree; the right twin stays unannotated)."""
        prof = self.profile
        if prof is None:
            return self._exec_chain_node(p, keep)
        before = profile_mod.counters_now()
        t0 = time.perf_counter_ns()
        t = self._exec_chain_node(p, keep)
        if p.nid not in prof.nodes:
            prof.record_node(p, t, time.perf_counter_ns() - t0, before)
        return t

    def _exec_chain_node(self, p: optimizer.Phys, keep: Tuple[str, ...]):
        n = p.node
        if isinstance(n, ir.Scan):
            t = self.plan.inputs[n.idx]
            want = set(keep)
            return t.project([c for c in t.names if c in want])
        child = p.children[0]
        if isinstance(n, ir.Project):
            return self._exec_chain(child, keep)
        if isinstance(n, ir.Filter):
            below = tuple(dict.fromkeys(tuple(keep)
                                        + tuple(sorted(n.pred.columns()))))
            t = self._exec_chain(child, below)
            t = self._filter_table(t, n.pred)
            return self._project_to(t, tuple(c for c in t.names
                                             if c in set(keep)))
        if isinstance(n, ir.Derive):
            below = tuple(dict.fromkeys(
                tuple(c for c in keep if c != n.name)
                + tuple(sorted(n.value.columns()))))
            t = self._exec_chain(child, below)
            if n.name in set(keep):
                t = self._derive_table(t, n.name, n.value)
            return self._project_to(t, tuple(c for c in t.names
                                             if c in set(keep)))
        raise AssertionError(n.kind)

    # -- shuffles ---------------------------------------------------------
    def _shuffle(self, t, keys: Tuple[str, ...], side: str):
        from ..parallel import ops as par_ops

        self._guard()
        idx = tuple(t.names.index(k) for k in keys)
        with obs_spans.span("plan.stage", kind="shuffle", side=side,
                            keys=len(idx), columns=len(t.names)):
            return par_ops.shuffle(t, idx)

    @staticmethod
    def _note_elided(side: str, keys: Tuple[str, ...]) -> None:
        obs_spans.instant("plan.shuffle_elided", side=side,
                          keys=",".join(keys))

    def _broadcast(self, t, side: str, p: optimizer.Phys):
        from ..parallel import ops as par_ops

        self._guard()
        est = p.ann.get("broadcast") or {}
        with obs_spans.span("plan.stage", kind="broadcast", side=side,
                            columns=len(t.names),
                            est_bytes=est.get("bytes"),
                            source=est.get("source")):
            return par_ops.broadcast_gather(t)

    def _join_inputs(self, p: optimizer.Phys):
        lc, rc = p.children
        if p.ann.get("shared"):
            union = tuple(dict.fromkeys(tuple(lc.keep) + tuple(rc.keep)))
            base = self._exec_chain(lc, union)
            shuffled = self._shuffle(base, p.ann["left"][1], side="shared")
            self._note_elided("shared", p.ann["right"][1])
            return (self._project_to(shuffled, lc.keep),
                    self._project_to(shuffled, rc.keep))
        lt = self._exec(lc)
        rt = self._exec(rc)
        la, ra = (p.ann.get("left", ("local",)),
                  p.ann.get("right", ("local",)))
        for side, ann in (("left", la), ("right", ra)):
            t = lt if side == "left" else rt
            if ann[0] == "shuffle":
                t = self._shuffle(t, ann[1], side=side)
            elif ann[0] == "elide":
                self._note_elided(side, ann[1])
            elif ann[0] == "broadcast":
                t = self._broadcast(t, side, p)
            # ("keep", keys): the broadcast join's probe side stays
            # exactly where it is — zero bytes moved
            if side == "left":
                lt = t
            else:
                rt = t
        return lt, rt

    @staticmethod
    def _join_cfg(node: ir.Join, lt, rt):
        from ..table import _check_join_keys

        cfg = JoinConfig.of(node.how, node.algorithm,
                            tuple(lt.names.index(k) for k in node.left_on),
                            tuple(rt.names.index(k) for k in node.right_on),
                            node.left_prefix, node.right_prefix)
        return _check_join_keys(lt, rt, cfg)

    def _exec_join(self, p: optimizer.Phys):
        from ..table import _local_join

        node: ir.Join = p.node  # type: ignore[assignment]
        lc, rc = p.children
        lt, rt = self._join_inputs(p)
        cfg = self._join_cfg(node, lt, rt)
        self._guard()
        with obs_spans.span("plan.stage", kind="join", how=node.how,
                            algorithm=node.algorithm):
            joined = _local_join(lt, rt, cfg)
        # rename the pruned physical output to the LOGICAL names (the
        # collision set of the full schemas, not the pruned ones)
        logical = tuple(node.out_name("left", n) for n in lc.keep) \
            + tuple(node.out_name("right", n) for n in rc.keep)
        return joined.rename(list(logical))

    # -- aggregates -------------------------------------------------------
    @staticmethod
    def _agg_spec(node: ir.Aggregate, names: Tuple[str, ...]):
        by_idx = tuple(names.index(n) for n in node.by)
        aggs = tuple((names.index(n), op) for n, op in node.aggs)
        return by_idx, aggs

    def _exec_agg(self, p: optimizer.Phys):
        from ..parallel import ops as par_ops
        from ..table import _local_groupby

        node: ir.Aggregate = p.node  # type: ignore[assignment]
        t = self._exec(p.children[0])
        by_idx, aggs = self._agg_spec(node, tuple(t.names))
        mode = p.ann.get("mode", "eager")
        self._guard()
        with obs_spans.span("plan.stage", kind="aggregate", mode=mode,
                            keys=len(by_idx), aggs=len(aggs)):
            if mode == "local" or t.num_shards == 1:
                out = _local_groupby(t, by_idx, aggs, node.ddof)
            elif mode == "elided":
                self._note_elided("aggregate", node.by)
                out = par_ops.distributed_groupby(t, by_idx, aggs,
                                                  node.ddof,
                                                  pre_partitioned=True)
            else:
                out = par_ops.distributed_groupby(
                    t, by_idx, aggs, node.ddof,
                    salt=int(p.ann.get("salt", 0)))
        return out.rename(list(node.names))

    def _fused_join_agg(self, p: optimizer.Phys):
        """ONE shard body per shard: join probe + chained derives/filters
        + local aggregate — the join intermediate never materializes as a
        Table.  An exact count pass sizes the join output first (ONE host
        sync for every shard's count), rounded as ``_local_join`` rounds
        it, so the kernels see the eager path's shapes."""
        from ..ops import groupby as groupby_mod
        from ..ops import join as join_mod
        from ..parallel import ops as par_ops
        from ..table import _compact_rows, _shard_wise, cap_round

        node: ir.Aggregate = p.node  # type: ignore[assignment]
        jphys: optimizer.Phys = p.ann["fuse_join"]  # type: ignore
        chain: List[optimizer.Phys] = p.ann["fuse_chain"]  # type: ignore
        jnode: ir.Join = jphys.node  # type: ignore[assignment]
        lc, rc = jphys.children

        lt, rt = self._join_inputs(jphys)
        cfg = self._join_cfg(jnode, lt, rt)
        join_names = tuple(jnode.out_name("left", n) for n in lc.keep) \
            + tuple(jnode.out_name("right", n) for n in rc.keep)
        mode = p.ann.get("mode", "local")
        if mode == "elided":
            self._note_elided("aggregate", node.by)
        self._guard()

        with obs_spans.span("plan.stage", kind="join_count"):
            counts = _join_counts(lt.ctx, [
                join_mod.join_row_count(a, ca, b, cb, cfg.left_on,
                                        cfg.right_on, cfg.join_type,
                                        cfg.algorithm)
                for a, ca, b, cb in zip(lt.shards, lt.counts, rt.shards,
                                        rt.counts)])
            out_cap = cap_round(max(1, int(counts.max(initial=0))))
        if self.profile is not None:
            # the fused join never materializes, but the exact count
            # pass that sizes it IS its observed cardinality
            self.profile.record_fused_join(jphys, counts)

        # the aggregate's partial/final split mirrors distributed_groupby
        # exactly (bit-identity with the eager path); 1-shard worlds run
        # the requested aggs directly, matching _local_groupby
        by_names, aggs_by_name, ddof = node.by, node.aggs, node.ddof
        split = mode == "elided"
        in_names = tuple(dict.fromkeys(tuple(by_names)
                                       + tuple(n for n, _ in aggs_by_name)))
        by_idx = tuple(in_names.index(n) for n in by_names)
        aggs_i = tuple((in_names.index(n), op) for n, op in aggs_by_name)
        nkeys = len(by_idx)
        if split:
            partial_list, partial_index = par_ops.groupby_partial_plan(
                aggs_i)

        def fused_fn(a, ca, b, cb):
            cols, count = join_mod.join_gather(
                a, ca, b, cb, cfg.left_on, cfg.right_on, cfg.join_type,
                out_cap, cfg.algorithm)
            env = dict(zip(join_names, cols))
            for ph in reversed(chain):
                cn = ph.node
                if isinstance(cn, ir.Derive):
                    if not ph.ann.get("dead"):
                        env[cn.name] = cn.value.evaluate(env)
                elif isinstance(cn, ir.Filter):
                    keys = list(env)
                    kept, count = _compact_rows(
                        [env[k] for k in keys],
                        _keep_mask(cn.pred.evaluate(env), count))
                    env = dict(zip(keys, kept))
                # Project: column selection is implicit in env-by-name
            in_cols = tuple(env[n] for n in in_names)
            if not split:
                return groupby_mod.hash_groupby(in_cols, count, by_idx,
                                                aggs_i, ddof)
            pcols, pm = groupby_mod.hash_groupby(in_cols, count, by_idx,
                                                 tuple(partial_list), ddof)
            final_aggs = tuple(
                (nkeys + i, groupby_mod.combine_op(pop))
                for i, (_, pop) in enumerate(partial_list))
            fcols, fm = groupby_mod.hash_groupby(pcols, pm,
                                                 tuple(range(nkeys)),
                                                 final_aggs, ddof)
            return par_ops.finalize_groupby_columns(
                fcols, nkeys, aggs_i, partial_index, ddof), fm

        with obs_spans.span("plan.stage", kind="fused_join_agg",
                            mode=mode, out_cap=out_cap):
            out = _shard_wise(fused_fn, lt, rt)
        return out._like(out.shards, out.counts, tuple(node.names))

    # -- sort / limit -----------------------------------------------------
    def _exec_sort(self, p: optimizer.Phys):
        from ..config import SortOptions

        node: ir.Sort = p.node  # type: ignore[assignment]
        t = self._exec(p.children[0])
        self._guard()
        opts = SortOptions(ascending=node.ascending[0],
                           nulls_first=node.nulls_first)
        with obs_spans.span("plan.stage", kind="sort",
                            keys=len(node.by)):
            return t.distributed_sort(list(node.by), options=opts,
                                      ascending=list(node.ascending))

    def _exec_limit(self, p: optimizer.Phys):
        node: ir.Limit = p.node  # type: ignore[assignment]
        t = self._exec(p.children[0])
        self._guard()
        with obs_spans.span("plan.stage", kind="limit", n=node.n):
            local = t._gathered_table()
            n = min(node.n, local.row_count)
            return local.take_rows(np.arange(n, dtype=np.int64))


def _keep_mask(pred_col, count) -> torch.Tensor:
    """A filter's keep mask: the predicate True AND valid, on a live
    row."""
    from ..ops import compact

    cap = pred_col.data.shape[0]
    return (pred_col.data & pred_col.validity
            & compact.live_mask(cap, count, pred_col.data.device))
