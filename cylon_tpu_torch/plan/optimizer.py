"""Rule-based optimizer: logical plan -> annotated physical plan.

Four rules carry the win, in the order they run:

1. **column pruning** (``_rule_required_columns``) — the required-column
   set propagates top-down; every Scan keeps only what some ancestor
   actually reads, so dead columns are dropped BEFORE plane packing and
   ``parallel/plane.py``'s word layout (hence ``shuffle.bytes_sent``)
   shrinks with projected width.
2. **shuffle elision** (``_rule_shuffle_elision``) — partitioning is a
   tracked *property* of data (the arxiv 2112.01075 argument), not a
   side effect of each op: every node derives its output partitioning
   (``hash(keys) % world``, stamped by ``parallel/ops.shuffle``), and a
   join/group-by whose keys are already compatibly partitioned skips
   its partition→pack→all_to_all stage entirely.  Compatibility is
   positional-subset: data hash-partitioned on ``(a,)`` is co-located
   for a join on ``(a, b)`` (equal pairs have equal ``a``), and for a
   group-by whose key SET contains every partition key.
3. **scan sharing** (``_rule_share_scans``) — two join sides that are
   the same scan chain (table, filters) shuffled on the same source
   keys execute ONE exchange over the union of their columns (the
   self-join shape: 2x -> 1x packed exchange).
4. **local fusion** (``_rule_fuse_local``) — a group-by whose input
   chain is join → (derive/filter/project)* with no intervening
   exchange runs as ONE shard body (join probe + derives + local
   aggregate), never materializing the join intermediate.

Everything here is host-side static analysis over plan + input
metadata; nothing runs on a device, so ``explain()`` can render every
decision without running.  A copy of ``cylon_tpu/plan/optimizer.py``;
``plane_annotation`` reads the port's ``parallel/plane.py`` over a
scan's first shard.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import config
from ..parallel import plane as plane_mod
from ..status import Code, CylonError
from . import ir

#: partitioning property: ("hash", alternatives, world) where each
#: alternative is an ordered tuple of column names the rows were
#: hash-placed by — a join output is compatibly partitioned by EITHER
#: side's key names, hence alternatives.
Partitioning = Tuple[str, Tuple[Tuple[str, ...], ...], int]


@dataclass
class Phys:
    """One physical node: the logical node + pruning/shuffle/fusion
    annotations the executor and explain() consume.  ``nid`` is the
    stable preorder id :func:`optimize` assigns — the profiler
    (``plan/profile.py``) and the statistics catalog key per-node
    actuals by it, so estimate lookups from a prior run line up
    node-for-node (the numbering is a pure function of the plan tree
    and the enabled flag)."""

    node: ir.Node
    children: List["Phys"] = field(default_factory=list)
    keep: Tuple[str, ...] = ()
    part: Optional[Partitioning] = None
    ann: Dict[str, object] = field(default_factory=dict)
    nid: int = -1


@dataclass
class PhysPlan:
    root: Phys
    world: int
    enabled: bool
    shuffles_elided: int = 0
    columns_pruned: int = 0
    nodes: int = 0
    #: adaptive (statistics-driven) strategy selection was active for
    #: this optimization — False reproduces the rule-only planner.
    adaptive: bool = False
    broadcast_joins: int = 0
    keys_salted: int = 0
    #: the plan/cost.py CostModel the adaptive rules consulted (None
    #: when adaptive is off) — explain() renders its estimates.
    model: object = field(default=None, repr=False)


def hash_partitioning(names: Sequence[str], world: int) -> Partitioning:
    return ("hash", (tuple(names),), world)


def join_partition_alternatives(how: str, left_names: Sequence[str],
                                right_names: Sequence[str],
                                left_keys: Sequence[str],
                                right_keys: Sequence[str],
                                left_prefix: str = "l_",
                                right_prefix: str = "r_",
                                ) -> Tuple[Tuple[str, ...], ...]:
    """Output-name key alternatives a shuffled join's result is
    hash-placed by.  THE single source of the validity rule — the eager
    stamp (``table._stamp_join_partitioning``) and the planner's
    derived property (``_join_out_partitioning``) both call this, so
    they can never disagree: a side's key names are valid only when its
    unmatched rows still carry real key values (INNER both, LEFT left
    keys, RIGHT right keys, FULL_OUTER neither — either side's null
    keys break the placement property), with the eager join's
    collision-prefix naming applied."""
    collide = set(left_names) & set(right_names)

    def out(prefix: str, name: str) -> str:
        return prefix + name if name in collide else name

    alts: List[Tuple[str, ...]] = []
    if how in ("inner", "left"):
        alts.append(tuple(out(left_prefix, k) for k in left_keys))
    if how in ("inner", "right"):
        alts.append(tuple(out(right_prefix, k) for k in right_keys))
    return tuple(alts)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def planner_adaptive() -> bool:
    """Whether :func:`optimize` additionally runs the statistics-driven
    strategy rules (``CYLON_TPU_PLAN_ADAPTIVE``; 1/on = adaptive,
    auto/off = the rule-only planner).  Chosen strategies ride the plan
    fingerprint."""
    return str(config.knob("CYLON_TPU_PLAN_ADAPTIVE")) in ("1", "on")


def optimize(plan: "ir.LogicalPlan", enabled: bool = True,
             adaptive: Optional[bool] = None) -> PhysPlan:
    """Annotate the plan.  ``enabled=False`` produces the EAGER physical
    plan: no pruning, every distributed join/group-by shuffles, no
    sharing, no fusion — the per-op baseline the A/B arms and the
    bit-identity gates compare against.

    ``adaptive`` layers the statistics-driven strategy rules (broadcast
    joins, skew salting) on top; None defers to the
    ``CYLON_TPU_PLAN_ADAPTIVE`` knob.  Adaptive mode NEVER changes the
    tree shape or the column-pruning/nid numbering — only per-node
    strategy annotations — so the base (``adaptive=False``) and
    adaptive plans stay node-for-node comparable."""
    world = plan._world()
    if adaptive is None:
        adaptive = planner_adaptive()
    adaptive = bool(adaptive) and enabled and world > 1
    out = PhysPlan(root=None, world=world, enabled=enabled,  # type: ignore
                   adaptive=adaptive)
    if adaptive:
        from . import cost

        out.model = cost.CostModel(plan, world, record=lookup_stats(plan))
    req = tuple(plan.root.names) if enabled else None
    out.root = _build(plan, plan.root, req, world, enabled, out)
    if enabled:
        _rule_fuse_local(out.root, world, out)
    out.nodes = _count(out.root)
    _assign_nids(out.root, 0)
    return out


def strategy_spec(phys: PhysPlan) -> tuple:
    """The adaptive strategy choices of an optimized plan as a sorted,
    hashable spec — ``()`` when no rule fired (or adaptive is off).
    ``LogicalPlan.fingerprint`` folds this into the plan fingerprint so
    a stats-dependent choice can never serve a cached program built for
    a different strategy."""
    out: List[tuple] = []

    def walk(p: Phys) -> None:
        b = p.ann.get("broadcast")
        if isinstance(b, dict):
            out.append((p.nid, "broadcast_join", b.get("side")))
        s = p.ann.get("salt")
        if s:
            out.append((p.nid, "salted_groupby", int(s)))
        for c in p.children:
            walk(c)

    walk(phys.root)
    return tuple(sorted(out))


def _assign_nids(p: Phys, next_id: int) -> int:
    """Stable preorder node ids: the profiler/statistics-catalog key.
    Deterministic per (plan tree, enabled), so two optimizations of the
    same plan — this process's or a prior run's — number identically."""
    p.nid = next_id
    next_id += 1
    for c in p.children:
        next_id = _assign_nids(c, next_id)
    return next_id


def lookup_stats(plan) -> Optional[dict]:
    """Observed-statistics lookup for this exact plan: the persistent
    catalog record a prior profiled run left under the plan's BASE
    content fingerprint (per-scan column cardinality, join-key
    selectivity, per-node rows/skew), or None when the catalog is
    disabled or has never seen the plan.

    This is the adaptive planner's cost-model feed: :func:`optimize`
    consults it (adaptive mode) to size join sides and read observed
    skew.  Keyed by :meth:`LogicalPlan.base_fingerprint` — the
    strategy-INDEPENDENT fingerprint — so the lookup describes what the
    query is, not what a prior planner chose, and the
    fingerprint→optimize recursion is impossible (the base fingerprint
    optimizes with ``adaptive=False``, which never calls back here).
    Plans without adaptive mode remain bit-identical with the catalog
    present or absent (tests pin it).  Note the fingerprint hashes
    pruned input CONTENT, so the lookup costs one host gather of the
    scan columns — call it on planning/profiling paths, not per-row hot
    paths."""
    from ..obs import stats_catalog

    if not stats_catalog.enabled():
        return None
    return stats_catalog.lookup(plan.base_fingerprint())


def scan_prunes(phys: PhysPlan) -> List[Tuple[ir.Scan, Tuple[str, ...]]]:
    """Every (Scan node, kept columns) pair of the physical plan — the
    pruned inputs the fingerprint hashes and the admission estimator
    sizes."""
    out: List[Tuple[ir.Scan, Tuple[str, ...]]] = []

    def walk(p: Phys) -> None:
        if isinstance(p.node, ir.Scan):
            out.append((p.node, p.keep))
        for c in p.children:
            walk(c)

    walk(phys.root)
    return out


def _count(p: Phys) -> int:
    return 1 + sum(_count(c) for c in p.children)


# ---------------------------------------------------------------------------
# rule 1: required columns (top-down), interleaved with the bottom-up
# partitioning/elision pass — one recursion computes both
# ---------------------------------------------------------------------------


def _ordered(names: Sequence[str], want: Set[str]) -> Tuple[str, ...]:
    return tuple(n for n in names if n in want)


def _build(plan, node: ir.Node, req: Optional[Tuple[str, ...]], world: int,
           enabled: bool, out: PhysPlan) -> Phys:
    """req = ordered output columns an ancestor needs (None = keep all,
    the eager mode)."""
    keep_all = req is None
    req_set = set(node.names if keep_all else req)

    if isinstance(node, ir.Scan):
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        p = Phys(node, [], keep)
        stamp = getattr(plan.inputs[node.idx], "_partitioning", None)
        if (enabled and stamp and stamp[0] == "hash"
                and int(stamp[2]) == world and world > 1):
            alts = stamp[1] if isinstance(stamp[1][0], tuple) else (stamp[1],)
            p.part = ("hash", tuple(tuple(a) for a in alts), world)
        if enabled:
            out.columns_pruned += len(node.names) - len(keep)
            p.ann["pruned"] = len(node.names) - len(keep)
        return p

    if isinstance(node, ir.Project):
        child_req = None if keep_all else _rule_required_columns(
            node, req_set)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        return Phys(node, [c], keep, _restrict_part(c.part, keep))

    if isinstance(node, ir.Filter):
        child_req = None if keep_all else _rule_required_columns(
            node, req_set)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        return Phys(node, [c], keep, c.part)

    if isinstance(node, ir.Derive):
        alive = keep_all or node.name in req_set
        child_req = None if keep_all else _rule_required_columns(
            node, req_set)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        p = Phys(node, [c], keep, c.part)
        p.ann["dead"] = not alive
        return p

    if isinstance(node, ir.Join):
        return _build_join(plan, node, req, world, enabled, out)

    if isinstance(node, ir.Aggregate):
        child_req = None if keep_all else _rule_required_columns(
            node, req_set)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        p = Phys(node, [c], tuple(node.names))
        _rule_shuffle_elision_agg(p, c, world, enabled, out)
        if out.model is not None:
            _rule_salt_agg(p, c, world, out)
        return p

    if isinstance(node, ir.Sort):
        child_req = None if keep_all else _rule_required_columns(
            node, req_set)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        return Phys(node, [c], keep, None)  # range-partitioned, untracked

    if isinstance(node, ir.Limit):
        child_req = None if keep_all else tuple(req)
        c = _build(plan, node.children[0], child_req, world, enabled, out)
        keep = tuple(node.names) if keep_all else _ordered(node.names,
                                                           req_set)
        return Phys(node, [c], keep, None)

    raise CylonError(Code.Invalid, f"unknown plan node {node.kind!r}")


def _rule_required_columns(node: ir.Node,
                           req_set: Set[str]) -> Tuple[str, ...]:
    """The ordered column set ``node``'s child must produce for ``node``
    to emit ``req_set`` — the pruning rule's per-node transfer
    function."""
    child = node.children[0]
    if isinstance(node, ir.Project):
        return _ordered(child.names, req_set)
    if isinstance(node, ir.Filter):
        return _ordered(child.names, req_set | node.pred.columns())
    if isinstance(node, ir.Derive):
        want = set(req_set) - {node.name}
        if node.name in req_set:
            want |= node.value.columns()
        return _ordered(child.names, want)
    if isinstance(node, ir.Aggregate):
        want = set(node.by) | {n for n, _ in node.aggs}
        return _ordered(child.names, want)
    if isinstance(node, ir.Sort):
        return _ordered(child.names, req_set | set(node.by))
    raise AssertionError(node.kind)


def _restrict_part(part: Optional[Partitioning],
                   keep: Tuple[str, ...]) -> Optional[Partitioning]:
    """Partitioning survives a projection as a placement property even
    when key columns are projected away — but an alternative whose keys
    are gone is useless to every downstream compat check, so drop it."""
    if part is None:
        return None
    ks = set(keep)
    alts = tuple(a for a in part[1] if set(a) <= ks)
    return (part[0], alts, part[2]) if alts else None


# ---------------------------------------------------------------------------
# rules 2+3: shuffle elision & scan sharing (joins)
# ---------------------------------------------------------------------------


def _subset_positions(part_keys: Tuple[str, ...],
                      side_keys: Tuple[str, ...]) -> Optional[Tuple[int, ...]]:
    """Positions making ``part_keys`` an ordered positional subset of
    ``side_keys`` (data partitioned on the subset co-locates rows with
    equal full keys), or None."""
    pos: List[int] = []
    start = 0
    for pk in part_keys:
        for i in range(start, len(side_keys)):
            if side_keys[i] == pk:
                pos.append(i)
                start = i + 1
                break
        else:
            return None
    return tuple(pos)


def _compat_positions(part: Optional[Partitioning],
                      side_keys: Tuple[str, ...],
                      world: int) -> Optional[Tuple[int, ...]]:
    if part is None or part[0] != "hash" or part[2] != world:
        return None
    for alt in part[1]:
        pos = _subset_positions(alt, side_keys)
        if pos is not None:
            return pos
    return None


def _scan_chain(p: Phys):
    """(input_idx, op-spec tuple) when ``p`` is a pure scan chain
    (Scan under Project/Filter/Derive only), else None — the scan-
    sharing rule's identity key (projections excluded: column sets are
    unioned by the rule)."""
    specs: List[tuple] = []
    cur = p
    while True:
        n = cur.node
        if isinstance(n, ir.Scan):
            return n.idx, tuple(specs)
        if isinstance(n, ir.Filter):
            specs.append(("filter", n.pred.spec()))
        elif isinstance(n, ir.Derive):
            specs.append(("derive", n.name, n.value.spec()))
        elif not isinstance(n, ir.Project):
            return None
        cur = cur.children[0]


def _build_join(plan, node: ir.Join, req: Optional[Tuple[str, ...]],
                world: int, enabled: bool, out: PhysPlan) -> Phys:
    keep_all = req is None
    req_set = set(node.names if keep_all else req)
    left, right = node.children
    # map required output names back to child columns (+ join keys)
    want_l: Set[str] = set(node.left_on)
    want_r: Set[str] = set(node.right_on)
    for name in left.names:
        if node.out_name("left", name) in req_set:
            want_l.add(name)
    for name in right.names:
        if node.out_name("right", name) in req_set:
            want_r.add(name)
    lc = _build(plan, left, None if keep_all else _ordered(left.names,
                                                           want_l),
                world, enabled, out)
    rc = _build(plan, right, None if keep_all else _ordered(right.names,
                                                            want_r),
                world, enabled, out)
    keep = tuple(node.names) if keep_all else _ordered(node.names, req_set)
    p = Phys(node, [lc, rc], keep)
    _rule_shuffle_elision_join(p, lc, rc, world, enabled, out)
    if enabled:
        _rule_share_scans(p, lc, rc, world, out)
    if out.model is not None:
        _rule_broadcast_join(p, lc, rc, world, out)
    _join_out_partitioning(p, world)
    return p


def _rule_shuffle_elision_join(p: Phys, lc: Phys, rc: Phys, world: int,
                               enabled: bool, out: PhysPlan) -> None:
    node: ir.Join = p.node  # type: ignore[assignment]
    if world == 1:
        p.ann["left"] = p.ann["right"] = ("local",)
        return
    lo, ro = tuple(node.left_on), tuple(node.right_on)
    if not enabled:
        p.ann["left"] = ("shuffle", lo)
        p.ann["right"] = ("shuffle", ro)
        return
    lpos = _compat_positions(lc.part, lo, world)
    rpos = _compat_positions(rc.part, ro, world)
    if lpos is not None and rpos is not None and lpos == rpos:
        p.ann["left"] = ("elide", tuple(lo[i] for i in lpos))
        p.ann["right"] = ("elide", tuple(ro[i] for i in rpos))
        out.shuffles_elided += 2
    elif lpos is not None:
        p.ann["left"] = ("elide", tuple(lo[i] for i in lpos))
        p.ann["right"] = ("shuffle", tuple(ro[i] for i in lpos))
        out.shuffles_elided += 1
    elif rpos is not None:
        p.ann["left"] = ("shuffle", tuple(lo[i] for i in rpos))
        p.ann["right"] = ("elide", tuple(ro[i] for i in rpos))
        out.shuffles_elided += 1
    else:
        p.ann["left"] = ("shuffle", lo)
        p.ann["right"] = ("shuffle", ro)


def _rule_share_scans(p: Phys, lc: Phys, rc: Phys, world: int,
                      out: PhysPlan) -> None:
    """Self-join shape: both sides shuffle the SAME scan chain on the
    same source columns -> ONE exchange over the union of columns."""
    node: ir.Join = p.node  # type: ignore[assignment]
    if world == 1:
        return
    if p.ann.get("left", ())[:1] != ("shuffle",) \
            or p.ann.get("right", ())[:1] != ("shuffle",):
        return
    a, b = _scan_chain(lc), _scan_chain(rc)
    if a is None or b is None or a != b:
        return
    lkeys = p.ann["left"][1]
    rkeys = p.ann["right"][1]
    if lkeys != rkeys:  # same chain => same column namespace
        return
    p.ann["shared"] = True
    out.shuffles_elided += 1


def _rule_broadcast_join(p: Phys, lc: Phys, rc: Phys, world: int,
                         out: PhysPlan) -> None:
    """Adaptive rule: broadcast-hash join.  When the cost model says one
    side is dimension-sized (estimate at or under the broadcast
    threshold AND cheaper on the wire than shuffling), replicate that
    side to every rank with ONE all_gather and probe locally — the big
    side moves ZERO bytes.

    Validity mirrors :func:`join_partition_alternatives`' null-keys
    argument with sides swapped: the KEPT side's rows must each live on
    exactly one rank and be emitted there exactly once, so the
    broadcast side must never be null-extended (its unmatched rows are
    replicated on every rank) — broadcast left only for inner/right
    joins, broadcast right only for inner/left, never outer."""
    node: ir.Join = p.node  # type: ignore[assignment]
    model = out.model
    if model is None or p.ann.get("shared"):
        return
    la = p.ann.get("left", ())
    ra = p.ann.get("right", ())
    if not la or la[0] == "local":
        return
    # (side to broadcast, its child, the other side's current ann) —
    # profitable only when the OTHER side currently pays an exchange
    cands = []
    if node.how in ("inner", "right") and ra[:1] == ("shuffle",):
        cands.append(("left", lc))
    if node.how in ("inner", "left") and la[:1] == ("shuffle",):
        cands.append(("right", rc))
    best = None
    for side, child in cands:
        est, src = model.side_estimate(child)
        if est > model.threshold:
            continue
        if best is None or est < best[2]:
            best = (side, child, est, src)
    if best is None:
        return
    side, child, est, src = best
    own_ann = la if side == "left" else ra
    saved = 2 if own_ann[:1] == ("shuffle",) else 1
    big_child = rc if side == "left" else lc
    big_est, _ = model.side_estimate(big_child)
    if not model.broadcast_wins(est, big_est, saved):
        return
    lo, ro = tuple(node.left_on), tuple(node.right_on)
    if side == "left":
        p.ann["left"] = ("broadcast", lo)
        p.ann["right"] = ("keep", ro)
    else:
        p.ann["left"] = ("keep", lo)
        p.ann["right"] = ("broadcast", ro)
    p.ann["broadcast"] = {"side": side, "bytes": int(est), "source": src}
    out.broadcast_joins += 1


def _rule_salt_agg(p: Phys, c: Phys, world: int, out: PhysPlan) -> None:
    """Adaptive rule: skew-salted NUNIQUE repartition.  When the catalog
    observed the aggregate's input placing ``max/mean >= salt factor``
    rows on one rank (the zipfian-key shape), spread the exchange over
    value-hash salt buckets and COUNTSUM-combine the per-bucket partial
    distinct counts — exact by construction (buckets partition the
    value space, so per-(key, bucket) distinct counts sum to the
    per-key distinct count; integer combine).  Gated to the
    single-distinct-column all-NUNIQUE shape the salted physical path
    supports; no catalog evidence → no salt (conservative)."""
    node: ir.Aggregate = p.node  # type: ignore[assignment]
    from ..ops.groupby import AggOp

    model = out.model
    if model is None or p.ann.get("mode") != "eager":
        return
    if not node.aggs or any(op != AggOp.NUNIQUE for _, op in node.aggs):
        return
    if len({n for n, _ in node.aggs}) != 1:
        return
    # the estimate spans the aggregate's OWN record too: a plain
    # groupby-on-scan has a balanced (round-robin) input, so the only
    # observed placement skew lives on the aggregate node itself
    skew, src = model.skew_estimate(p)
    if skew < model.salt_factor:
        return
    p.ann["salt"] = world
    p.ann["salt_est"] = {"skew": skew, "source": src,
                         "factor": model.salt_factor}
    out.keys_salted += 1


def _join_out_partitioning(p: Phys, world: int) -> None:
    """Output partitioning of a join: rows land by hash of the keys the
    sides were exchanged (or already placed) on; which side's names are
    valid is :func:`join_partition_alternatives`' single-sourced
    rule."""
    node: ir.Join = p.node  # type: ignore[assignment]
    if world == 1:
        p.part = None
        return
    la = p.ann.get("left", ())
    ra = p.ann.get("right", ())
    if not la or la[0] == "local":
        p.part = None
        return
    if la[0] in ("broadcast", "keep"):
        # broadcast join: every output row derives from a KEPT-side row
        # in place (the broadcast side is the one replicated), so the
        # kept child's placement property survives, renamed through the
        # join's collision-prefix rule.  Kept rows are never
        # null-extended (the broadcast rule's validity gate), so their
        # key values stay real.
        kept_side = "left" if la[0] == "keep" else "right"
        kc = p.children[0] if kept_side == "left" else p.children[1]
        if kc.part is None or kc.part[0] != "hash" or kc.part[2] != world:
            p.part = None
            return
        keep_set = set(p.keep)
        alts = []
        for alt in kc.part[1]:
            mapped = tuple(node.out_name(kept_side, n) for n in alt)
            if set(mapped) <= keep_set:
                alts.append(mapped)
        p.part = ("hash", tuple(alts), world) if alts else None
        return
    lkeys = la[1] if len(la) > 1 else tuple(node.left_on)
    rkeys = ra[1] if len(ra) > 1 else tuple(node.right_on)
    alts = join_partition_alternatives(
        node.how, node.children[0].names, node.children[1].names,
        lkeys, rkeys, node.left_prefix, node.right_prefix)
    keep_set = set(p.keep)
    alts = tuple(a for a in alts if set(a) <= keep_set)
    p.part = ("hash", alts, world) if alts else None


def _rule_shuffle_elision_agg(p: Phys, c: Phys, world: int, enabled: bool,
                              out: PhysPlan) -> None:
    node: ir.Aggregate = p.node  # type: ignore[assignment]
    from ..ops.groupby import AggOp

    has_nunique = any(op == AggOp.NUNIQUE for _, op in node.aggs)
    if world == 1:
        p.ann["mode"] = "local"
        p.part = None
        return
    if enabled and not has_nunique and c.part is not None:
        by_set = set(node.by)
        for alt in c.part[1]:
            if c.part[0] == "hash" and c.part[2] == world \
                    and set(alt) <= by_set:
                p.ann["mode"] = "elided"
                p.ann["part_keys"] = alt
                p.part = ("hash", (alt,), world)
                out.shuffles_elided += 1
                return
    p.ann["mode"] = "eager"
    p.part = ("hash", (tuple(node.by),), world) if not has_nunique else None


# ---------------------------------------------------------------------------
# rule 4: local fusion
# ---------------------------------------------------------------------------


def _rule_fuse_local(p: Phys, world: int, out: PhysPlan) -> None:
    """Mark group-bys whose input chain is join → (derive/filter/
    project)* with no exchange in between: the post-shuffle local probe,
    the derived columns, the filters and the local aggregate run inside
    ONE shard body instead of materializing each intermediate.
    Applies when the group-by itself needs no shuffle (elided, or a
    1-shard world) — the final combine then lives in the same body."""
    if isinstance(p.node, ir.Aggregate) \
            and p.ann.get("mode") in ("elided", "local"):
        chain: List[Phys] = []
        cur = p.children[0]
        while isinstance(cur.node, (ir.Derive, ir.Filter, ir.Project)):
            chain.append(cur)
            cur = cur.children[0]
        if isinstance(cur.node, ir.Join) and cur.node.algorithm in (
                "sort", "hash"):
            from ..ops.groupby import AggOp

            if not any(op == AggOp.NUNIQUE for _, op in
                       p.node.aggs):
                p.ann["fuse"] = True
                p.ann["fuse_chain"] = chain
                p.ann["fuse_join"] = cur
    for c in p.children:
        _rule_fuse_local(c, world, out)


# ---------------------------------------------------------------------------
# explain support: plane width of a pruned scan
# ---------------------------------------------------------------------------


def plane_annotation(table, keep: Tuple[str, ...]) -> Dict[str, int]:
    """Packed-plane word width of the full vs pruned column set — the
    explain() annotation making the pruning win concrete in bytes.
    Consults the pack/compress knobs (the realization the exchange would
    actually use); the plan FINGERPRINT covers them via
    durable.run_fingerprint.

    When compression is active, ``words_comp`` additionally reports the
    pruned set's width under the host-ESTIMATED compression spec
    (plane.estimate_spec over addressable buffers — advisory, like the
    rest of explain), so pruning and compression savings attribute
    separately: full -> pruned is the planner's win, pruned -> comp the
    payload encoder's."""
    cols = list(table.shards[0])
    kept = [c for n, c in zip(table.names, cols) if n in set(keep)]
    packed = plane_mod.pack_enabled()
    comp = packed and plane_mod.compress_enabled()
    ann = {
        "words_full": plane_mod.plane_words(cols) if cols else 0,
        "words_pruned": plane_mod.plane_words(kept) if kept else 0,
        "packed": int(packed),
        "compressed": int(comp),
    }
    # estimate_spec reads one shard's buffers on the host: advisory, like
    # the rest of explain (the REAL exchange derives its spec from every
    # shard's device stats, never from this estimate)
    if comp and kept:
        spec = plane_mod.estimate_spec(kept, world=table.num_shards,
                                       shard_cap=table.shard_capacity,
                                       count=table.counts[0])
        ann["words_comp"] = plane_mod.plane_words(kept, spec)
    return ann
