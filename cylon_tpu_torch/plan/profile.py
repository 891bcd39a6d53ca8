"""Per-plan-node execution profile: the EXPLAIN ANALYZE substrate.

Spans say where a process's wall-clock went and ``explain`` says what
the optimizer decided, but nothing attributes cost to a *plan node*: which
join moved the bytes, which filter kept 2% of its input, which stage's
shards ran 5× skewed.  This module records exactly that, riding the
execution primitives that already exist (measurement composes with the
program, no side-channel):

- the executor wraps each physical node's ``_exec`` with two
  ``perf_counter_ns`` reads and a handful of ``obs.metrics`` counter
  reads (``shuffle.bytes_sent``/``bytes_saved``, launches), so a node's
  ACTUALS are the deltas its subtree
  produced — exchange bytes land on the node that shuffled; on a CUDA
  card also two CUDA timing events on the card's current stream, whose
  stream time (``device_ns``: the subtree's device work plus any stream
  idle inside it) resolves at :meth:`PlanProfile.finalize` (None on the
  CPU);
- row counts come from the node's materialized Table (per-shard counts,
  gathered over a process group, so per-node partition SKEW — max/mean
  shard rows and the slowest shard — falls out of data the engine
  already holds);
- :meth:`PlanProfile.finalize` turns subtree totals into SELF values by
  subtracting each node's nearest recorded descendants (the same
  flame-graph attribution a span report applies).

The profile renders through ``explain(plan, analyze=True)`` as
estimate→actual annotations (estimates come from the persistent
statistics catalog when a prior run observed this plan), exports as a
JSON artifact (``plan_profile.r<rank>.json``), and distills into the
:mod:`cylon_tpu_torch.obs.stats_catalog` record — observed per-scan
column cardinality, join-key selectivity, filter selectivity, per-node
skew — that the adaptive cost model (``plan/cost.py``) consumes.

Profiling is host-side by construction (counter reads, host timestamps,
row-count fetches of already-materialized tables, timing events that
never sync): the kernels and their launches are untouched, and with the
profiler off
(``CYLON_TPU_PROFILE`` unset, no ``analyze=True``) the executor does no
profiling work.  A copy of ``cylon_tpu/plan/profile.py``.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..obs import metrics as obs_metrics
from . import ir

log = logging.getLogger("cylon_tpu_torch")

PROFILE_KIND = "cylon_tpu.plan_profile"

#: counters whose per-node deltas the profiler attributes (subtree
#: totals at record time, SELF deltas after finalize)
PROFILED_COUNTERS: Tuple[str, ...] = (
    "shuffle.exchanges", "shuffle.collective_launches",
    "shuffle.bytes_sent", "shuffle.bytes_saved", "shuffle.counts_gathers",
    "plan_cache.hit", "plan_cache.miss",
)


def profiler_enabled() -> bool:
    """``CYLON_TPU_PROFILE``: collect per-node actuals on every
    ``plan.execute`` (``explain(analyze=True)`` forces one profiled run
    regardless)."""
    return bool(config.knob("CYLON_TPU_PROFILE"))


def counters_now() -> Tuple[float, ...]:
    return tuple(obs_metrics.counter_value(n) for n in PROFILED_COUNTERS)


def device_event(ctx) -> "Optional[torch.cuda.Event]":
    """A CUDA timing event recorded now on the current stream of ``ctx``'s
    first card, or None where the context runs on the CPU."""
    dev = torch.device(ctx.devices[0])
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def describe(node: ir.Node) -> str:
    """One-line human label for a plan node (artifact + report tables)."""
    if isinstance(node, ir.Scan):
        return f"scan {node.label}"
    if isinstance(node, ir.Join):
        return (f"join {node.how}/{node.algorithm} on "
                f"{','.join(node.left_on)}={','.join(node.right_on)}")
    if isinstance(node, ir.Aggregate):
        return f"groupby [{', '.join(node.by)}]"
    if isinstance(node, ir.Filter):
        from . import expr as expr_mod

        return f"filter {expr_mod.render(node.pred)}"
    if isinstance(node, ir.Derive):
        return f"derive {node.name}"
    if isinstance(node, ir.Sort):
        return f"sort [{', '.join(node.by)}]"
    if isinstance(node, ir.Limit):
        return f"limit {node.n}"
    return node.kind


class PlanProfile:
    """Actuals of ONE executed plan, keyed by physical-node id (the
    optimizer's stable preorder numbering, so estimate lookups from a
    prior run's catalog record line up node-for-node)."""

    def __init__(self):
        self.nodes: Dict[int, dict] = {}
        self.phys = None                      # optimizer.PhysPlan
        self.world: int = 1
        self.plan_cache_hit = False
        self.wall_ns: int = 0
        self.fingerprint: Optional[str] = None
        self.estimates: Optional[dict] = None  # prior catalog record
        self.fleet_skew: Optional[List[dict]] = None  # coordinator rows
        self.artifact_path: Optional[str] = None
        self._finalized = False

    # -- recording (executor hot path) -----------------------------------

    def record_node(self, p, table, wall_ns: int,
                    before: Tuple[float, ...], events=None) -> None:
        """Store one node's subtree actuals (called as ``_exec(p)``
        returns, so children recorded first); ``events`` is the (start,
        end) pair of :func:`device_event` around the node, or None."""
        deltas = {n: obs_metrics.counter_value(n) - b
                  for n, b in zip(PROFILED_COUNTERS, before)}
        rec: Dict[str, object] = {
            "rows": 0,
            "wall_ns": int(wall_ns),
            "device_ns": None,
            "metrics": {k: v for k, v in deltas.items() if v},
        }
        if events is not None:
            rec["events"] = events
        rc = table.row_counts  # global, in shard order (collective)
        rec["rows"] = int(rc.sum())
        if table.num_shards > 1:
            rec["shard_rows"] = [int(x) for x in rc]
        self.nodes[int(p.nid)] = rec

    def record_fused_join(self, p, shard_counts) -> None:
        """Observed cardinality of a join fused into a parent's shard
        body: the exact count pass that sizes the fused program is the
        join's row count (per shard), even though the join intermediate
        never materializes.  Wall/bytes stay with the parent — only the
        rows are the join's own."""
        sc = [int(x) for x in np.asarray(shard_counts).reshape(-1)]
        rec: Dict[str, object] = {"rows": int(sum(sc)), "wall_ns": 0,
                                  "device_ns": None, "metrics": {},
                                  "fused": True}
        if len(sc) > 1:
            rec["shard_rows"] = sc
        self.nodes[int(p.nid)] = rec

    # -- finalize ---------------------------------------------------------

    def _recorded_children(self, p) -> List:
        """Nearest recorded descendants of ``p`` — a fused group-by's
        direct child chain has no records, but the scans underneath do,
        and their time/bytes must not double-count as the group-by's
        self cost."""
        out = []
        for c in p.children:
            if c.nid in self.nodes:
                out.append(c)
            else:
                out.extend(self._recorded_children(c))
        return out

    def _eff_wall(self, p) -> int:
        """Wall a subtree ACCOUNTS for toward its parent's self-time
        subtraction: the node's own measured wall when it was timed; a
        fused record (rows only, wall 0) or an unrecorded node passes
        its children's accounting through — the scans under a fused
        join still ran inside the parent's window."""
        rec = self.nodes.get(p.nid)
        if rec is not None and not rec.get("fused"):
            return int(rec["wall_ns"])
        return sum(self._eff_wall(c) for c in p.children)

    def _eff_device(self, p) -> Optional[int]:
        """``_eff_wall`` on the device clock (None: not timed there)."""
        rec = self.nodes.get(p.nid)
        if rec is not None and not rec.get("fused"):
            return rec["device_ns"]
        kids = [self._eff_device(c) for c in p.children]
        return None if None in kids else sum(kids)

    def _eff_metric(self, p, name: str) -> float:
        rec = self.nodes.get(p.nid)
        if rec is not None and not rec.get("fused"):
            return rec["metrics"].get(name, 0)
        return sum(self._eff_metric(c, name) for c in p.children)

    def finalize(self, phys, wall_ns: int) -> None:
        """Attach the physical plan, compute self times/deltas and skew."""
        self.phys = phys
        self.world = phys.world
        self.wall_ns = int(wall_ns)
        if self._finalized:
            return
        self._finalized = True
        for rec in self.nodes.values():
            events = rec.pop("events", None)
            if events is not None:
                events[1].synchronize()
                rec["device_ns"] = int(events[0].elapsed_time(events[1])
                                       * 1e6)

        def walk(p, depth: int) -> None:
            rec = self.nodes.get(p.nid)
            if rec is not None:
                rec["depth"] = depth
                rec["kind"] = p.node.kind
                rec["desc"] = describe(p.node)
                rec["device_self_ns"] = None
                if rec.get("fused"):
                    # rows-only record: cost lives with the fusing parent
                    rec["self_ns"] = 0
                    rec["self_metrics"] = {}
                else:
                    kid_wall = sum(self._eff_wall(c) for c in p.children)
                    rec["self_ns"] = max(0, rec["wall_ns"] - kid_wall)
                    kid_dev = [self._eff_device(c) for c in p.children]
                    if rec["device_ns"] is not None and None not in kid_dev:
                        rec["device_self_ns"] = max(
                            0, rec["device_ns"] - sum(kid_dev))
                    self_m: Dict[str, float] = {}
                    for name in PROFILED_COUNTERS:
                        v = rec["metrics"].get(name, 0) - sum(
                            self._eff_metric(c, name) for c in p.children)
                        if v > 0:
                            self_m[name] = v
                    rec["self_metrics"] = self_m
                sr = rec.get("shard_rows")
                if sr and sum(sr) > 0:
                    mean = sum(sr) / len(sr)
                    rec["skew"] = round(max(sr) / mean, 4) if mean else None
                    rec["slowest_shard"] = int(np.argmax(sr))
            for c in p.children:
                walk(c, depth + 1)

        walk(phys.root, 0)

    def attach_fleet_skew(self, ctx) -> None:
        """Pull the coordinator's recent per-collective skew ledger (the
        slowest-participant attribution) into the profile when the
        context runs under an elastic agent — the fleet-level complement
        to the per-node shard-row skew.  Best-effort and read-only: no
        agent (``ctx.elastic_agent()`` is None) leaves the ledger
        absent."""
        get = getattr(ctx, "elastic_agent", None)
        agent = get() if callable(get) else None
        if agent is None:
            return
        st = agent.status()
        if st:
            self.fleet_skew = list(st.get("collectives") or [])

    # -- the statistics-catalog record ------------------------------------

    def catalog_record(self, plan) -> dict:
        """Distill the profile into the persistent statistics record:
        per-scan column cardinalities (exact host nunique over the
        PRUNED columns — the same host gather the plan fingerprint
        already paid), join/filter selectivities from observed in/out
        rows, per-node rows and skew.  Called only when the catalog is
        enabled; the host gather is the documented profiling cost."""
        rec: dict = {"world": self.world, "wall_ms": self.wall_ms(),
                     "nodes": {}, "scans": {}, "joins": {}, "filters": {}}
        if self.phys is not None:
            from . import optimizer as optimizer_mod

            # which adaptive strategies produced these observations —
            # diagnostic provenance (the record itself is keyed by the
            # strategy-independent base fingerprint)
            strat = optimizer_mod.strategy_spec(self.phys)
            if strat:
                rec["strategies"] = [list(s) for s in strat]
        for nid, n in self.nodes.items():
            rec["nodes"][str(nid)] = {
                "kind": n.get("kind"), "rows": n["rows"],
                "self_ms": round(n.get("self_ns", 0) / 1e6, 3),
                "bytes_sent": n.get("self_metrics", {}).get(
                    "shuffle.bytes_sent", 0),
                **({"skew": n["skew"],
                    "slowest_shard": n["slowest_shard"]}
                   if n.get("skew") is not None else {}),
            }

        def walk(p) -> None:
            node = p.node
            me = self.nodes.get(p.nid)
            if isinstance(node, ir.Scan) and me is not None:
                cols: Dict[str, dict] = {}
                try:
                    t = plan.inputs[node.idx].project(list(p.keep))
                    frame = t.to_numpy()
                    for name, arr in frame.items():
                        cols[name] = {"nunique": int(len(np.unique(arr)))}
                except Exception as e:  # advisory: never fail the run
                    log.warning("profile: scan cardinality for %s failed "
                                "(%s: %s); omitting", node.label,
                                type(e).__name__, e)
                rec["scans"][str(p.nid)] = {
                    "label": node.label, "rows": me["rows"],
                    "columns": cols}
            if isinstance(node, ir.Join) and me is not None:
                kids = self._recorded_children(p)
                rows = None
                if len(kids) == 2:
                    rows = tuple(self.nodes[k.nid]["rows"] for k in kids)
                elif len(kids) == 1 and p.ann.get("shared"):
                    # shared-scan self-join: ONE chain fed both sides,
                    # so the single record IS both input cardinalities
                    one = self.nodes[kids[0].nid]["rows"]
                    rows = (one, one)
                if rows is not None:
                    l, r = rows
                    sel = (me["rows"] / (l * r)) if l and r else None
                    rec["joins"][str(p.nid)] = {
                        "left_rows": l, "right_rows": r,
                        "out_rows": me["rows"],
                        "selectivity": sel,
                        "keys": list(node.left_on)}
            if isinstance(node, ir.Filter) and me is not None:
                kids = self._recorded_children(p)
                if len(kids) == 1:
                    n_in = self.nodes[kids[0].nid]["rows"]
                    rec["filters"][str(p.nid)] = {
                        "in_rows": n_in, "out_rows": me["rows"],
                        "selectivity": (me["rows"] / n_in) if n_in
                        else None}
            for c in p.children:
                walk(c)

        if self.phys is not None:
            walk(self.phys.root)
        return rec

    # -- rendering / export ------------------------------------------------

    def wall_ms(self) -> float:
        return round(self.wall_ns / 1e6, 3)

    def est_rows(self, nid: int) -> Optional[int]:
        """Prior-run row estimate for a node (the catalog record the
        executor looked up before running), or None."""
        if not self.estimates:
            return None
        n = (self.estimates.get("nodes") or {}).get(str(nid))
        return None if n is None else int(n.get("rows", 0))

    def annotation(self, nid: int) -> str:
        """The estimate→actual suffix ``explain(analyze=True)`` appends
        to a node line; empty when the node has no record (fused into a
        parent, or served from cache)."""
        rec = self.nodes.get(nid)
        if rec is None:
            return ""
        est = self.est_rows(nid)
        rows = (f"rows={rec['rows']}" if est is None
                else f"rows est={est} actual={rec['rows']}")
        parts = [rows]
        if rec.get("fused"):
            parts.append("fused(count pass)")
        else:
            parts.append(f"self={rec.get('self_ns', 0) / 1e6:.1f}ms")
            if rec.get("device_self_ns") is not None:
                parts.append(
                    f"device_self={rec['device_self_ns'] / 1e6:.1f}ms")
        sm = rec.get("self_metrics", {})
        if sm.get("shuffle.bytes_sent"):
            parts.append(f"bytes_sent={int(sm['shuffle.bytes_sent'])}")
        if sm.get("shuffle.bytes_saved"):
            parts.append(f"bytes_saved={int(sm['shuffle.bytes_saved'])}")
        if sm.get("plan_cache.hit"):
            parts.append(f"plan_cache_hits={int(sm['plan_cache.hit'])}")
        if rec.get("skew") is not None:
            parts.append(f"skew={rec['skew']:.2f}x"
                         f"@r{rec['slowest_shard']}")
        return "  <- [" + " ".join(parts) + "]"

    def as_dict(self) -> dict:
        nodes = []
        for nid in sorted(self.nodes):
            n = self.nodes[nid]
            nodes.append({
                "nid": nid, "depth": n.get("depth", 0),
                "kind": n.get("kind"), "desc": n.get("desc"),
                "rows": n["rows"], "est_rows": self.est_rows(nid),
                "wall_ms": round(n["wall_ns"] / 1e6, 3),
                "self_ms": round(n.get("self_ns", 0) / 1e6, 3),
                "device_ms": _ms(n.get("device_ns")),
                "device_self_ms": _ms(n.get("device_self_ns")),
                "metrics": n.get("self_metrics", {}),
                "shard_rows": n.get("shard_rows"),
                "skew": n.get("skew"),
                "slowest_shard": n.get("slowest_shard"),
            })
        return {"kind": PROFILE_KIND, "v": 1, "world": self.world,
                "wall_ms": self.wall_ms(),
                "plan_cache_hit": self.plan_cache_hit,
                "fingerprint": self.fingerprint,
                "had_estimates": self.estimates is not None,
                "fleet_skew": self.fleet_skew,
                "nodes": nodes}

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the profile artifact (``plan_profile[.run].rN.json``
        beside the trace exports) for ``tools/trace_report.py --plan``.
        Best-effort: a failed write is warned, never raised."""
        from ..obs import export as export_mod

        try:
            out = export_mod._artifact_path(path, "plan_profile", None)
            tmp = f"{out}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.as_dict(), fh, default=str)
            os.replace(tmp, out)
            self.artifact_path = out
            return out
        except OSError as e:
            log.warning("profile: artifact export failed (%s: %s)",
                        type(e).__name__, e)
            return None


def _ms(ns: Optional[int]) -> Optional[float]:
    return None if ns is None else round(ns / 1e6, 3)


def load_profile(path: str) -> dict:
    """Load and validate a plan-profile artifact."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("kind") != PROFILE_KIND:
        raise ValueError(f"{path}: not a plan profile "
                         f"(kind={doc.get('kind')!r})")
    if not isinstance(doc.get("nodes"), list):
        raise ValueError(f"{path}: nodes is not a list")
    return doc
