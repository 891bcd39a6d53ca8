"""Calibrated shuffle cost model: the adaptive planner's arithmetic.

The rule-based optimizer is data-blind; this module gives it
numbers.  A :class:`CostModel` is built once per :func:`optimize` call
(adaptive mode only) from three feeds, in order of preference:

1. the **statistics catalog** (``obs/stats_catalog.py``) — per-node
   observed rows and shard-placement skew a prior profiled run of the
   SAME plan recorded under its base fingerprint;
2. **input metadata** — buffer bytes of the pruned scan columns (the
   same accounting as ``LogicalPlan.approx_input_bytes``), a
   capacity-level upper bound that needs no catalog and no device sync;
3. **observed collective costs** — the process-wide ratio of
   ``shuffle.bytes_sent`` to ``shuffle.collective_launches`` obs
   counters calibrates the per-launch byte-equivalent cost (how many
   payload bytes one extra collective launch is worth), with a
   conservative fallback when this process has not shuffled yet.

Everything here is host-side arithmetic over plan + metadata: nothing
is traced, nothing syncs a device, and a wrong estimate can only cost
performance, never correctness (both strategies are exact; tests pin
bit-identity).

A copy of ``cylon_tpu/plan/cost.py``; a scan's bytes come from
``ir.table_buffer_bytes`` over the port's per-shard buffers.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .. import config
from . import ir

#: byte-equivalent cost of ONE collective launch when the process has
#: no observed shuffle history to calibrate from.  Deliberately high
#: (64 KiB): with no evidence, prefer the rule-only plan shape
#: unless the byte win is decisive.
DEFAULT_LAUNCH_BYTES = 64 * 1024

#: clamp band for the calibrated per-launch cost — one weird observed
#: ratio (empty exchanges, a single giant exchange) must not swing
#: planning by orders of magnitude.
_LAUNCH_BYTES_MIN = 4 * 1024
_LAUNCH_BYTES_MAX = 4 * 1024 * 1024


def broadcast_threshold_bytes() -> int:
    """``CYLON_TPU_PLAN_BROADCAST_BYTES``: largest estimated join-side
    payload the broadcast-hash rule may replicate."""
    return int(config.knob("CYLON_TPU_PLAN_BROADCAST_BYTES"))


def skew_salt_factor() -> float:
    """``CYLON_TPU_PLAN_SKEW_SALT``: max/mean shard-rows skew at which
    the salt rule fires."""
    return float(config.knob("CYLON_TPU_PLAN_SKEW_SALT"))


def calibrated_launch_bytes() -> int:
    """Per-collective launch cost in payload-byte equivalents,
    calibrated from this process's observed exchanges (mean bytes per
    launch), clamped; :data:`DEFAULT_LAUNCH_BYTES` when no exchange has
    run yet."""
    from ..obs import metrics

    launches = metrics.counter_value("shuffle.collective_launches")
    sent = metrics.counter_value("shuffle.bytes_sent")
    if launches <= 0 or sent <= 0:
        return DEFAULT_LAUNCH_BYTES
    mean = sent / launches
    return int(min(max(mean, _LAUNCH_BYTES_MIN), _LAUNCH_BYTES_MAX))


def _logical_nids(root: ir.Node) -> Dict[int, int]:
    """``id(logical node) -> stable preorder nid``.  The phys tree
    mirrors the logical tree 1:1 in child order, so this numbering
    matches ``optimizer._assign_nids`` — per-node catalog records are
    addressable DURING the bottom-up build, before nids are stamped."""
    out: Dict[int, int] = {}

    def walk(n: ir.Node, nxt: int) -> int:
        out[id(n)] = nxt
        nxt += 1
        for c in n.children:
            nxt = walk(c, nxt)
        return nxt

    walk(root, 0)
    return out


class CostModel:
    """Per-plan estimates for one :func:`optimizer.optimize` call.

    ``record`` is the catalog entry for this plan's BASE fingerprint
    (strategy-independent — the adaptive planner must read stats keyed
    by what the query IS, not by what it previously chose), or None
    when the catalog is disabled/cold; every estimate then degrades to
    the metadata bound."""

    def __init__(self, plan, world: int,
                 record: Optional[dict] = None):
        self.plan = plan
        self.world = int(world)
        self.record = record if isinstance(record, dict) else None
        self._nids = _logical_nids(plan.root)
        self.threshold = broadcast_threshold_bytes()
        self.salt_factor = skew_salt_factor()
        self.launch_bytes = calibrated_launch_bytes()

    # -- catalog access ---------------------------------------------------

    def node_record(self, node: ir.Node) -> Optional[dict]:
        """The prior run's per-node actuals for ``node`` (rows, self_ms,
        bytes_sent, skew), or None."""
        if self.record is None:
            return None
        nodes = self.record.get("nodes")
        if not isinstance(nodes, dict):
            return None
        rec = nodes.get(str(self._nids.get(id(node), -1)))
        return rec if isinstance(rec, dict) else None

    # -- size estimates ---------------------------------------------------

    def side_estimate(self, p) -> Tuple[int, str]:
        """Estimated payload bytes of physical subtree ``p``'s output,
        with its provenance: ``("catalog", ...)`` when a prior run
        observed this node's row count (metadata bytes scaled by
        observed-rows / capacity), else ``("metadata", ...)`` — the
        pruned scan buffer bytes of the subtree, a capacity upper
        bound."""
        meta_bytes, caps = self._subtree_meta(p)
        rec = self.node_record(p.node)
        rows = None
        if rec is not None:
            try:
                rows = int(rec.get("rows"))
            except (TypeError, ValueError):
                rows = None
        if rows is not None and rows >= 0 and caps > 0:
            return max(0, int(round(meta_bytes * rows / caps))), "catalog"
        return int(meta_bytes), "metadata"

    def _subtree_meta(self, p) -> Tuple[int, int]:
        """(kept scan buffer bytes, summed scan capacities) of ``p``'s
        subtree — the ``approx_input_bytes`` accounting, restricted to
        one side."""
        total = 0
        caps = 0
        stack = [p]
        while stack:
            cur = stack.pop()
            if isinstance(cur.node, ir.Scan):
                t = self.plan.inputs[cur.node.idx]
                caps += int(t.capacity)
                total += ir.table_buffer_bytes(t, cur.keep)
            stack.extend(cur.children)
        return total, caps

    # -- decisions ---------------------------------------------------------

    def broadcast_wins(self, small_bytes: int, big_bytes: int,
                       exchanges_saved: int) -> bool:
        """Broadcast-vs-shuffle cost comparison for one join.

        Broadcast replicates the small side to every rank (one gather,
        ``small x world`` wire bytes); shuffling moves each side's
        payload once but pays ``exchanges_saved`` packed exchanges, each
        two launches (counts gather + payload all_to_all).  The small
        side's own shuffle bytes count only when broadcasting actually
        removes that exchange (saved == 2)."""
        cost_b = small_bytes * self.world + self.launch_bytes
        cost_s = (big_bytes
                  + (small_bytes if exchanges_saved >= 2 else 0)
                  + exchanges_saved * 2 * self.launch_bytes)
        return cost_b < cost_s

    def skew_estimate(self, p) -> Tuple[float, str]:
        """Worst observed shard-placement skew (max/mean shard rows)
        over ``p``'s subtree from the catalog, with provenance; (1.0,
        "none") when the catalog never saw this plan — no evidence, no
        salt."""
        best = 0.0
        stack = [p]
        while stack:
            cur = stack.pop()
            rec = self.node_record(cur.node)
            if rec is not None:
                try:
                    best = max(best, float(rec.get("skew", 0.0)))
                except (TypeError, ValueError):
                    pass
            stack.extend(cur.children)
        if best > 0.0:
            return best, "catalog"
        return 1.0, "none"
