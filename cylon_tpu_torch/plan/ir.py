"""The logical plan IR: scan → project/filter/derive → join → aggregate
→ sort/limit.

A ``LogicalPlan`` is the lazy twin of the eager ``Table`` method chain:
``Table.plan()`` starts one at a Scan node, each builder method appends
a node, and nothing touches the device until :meth:`execute`.  The tree
is the unit three consumers share:

- the **optimizer** (``plan/optimizer.py``) rewrites it — column
  pruning, shuffle elision from tracked partitioning, scan sharing,
  local fusion — into an annotated physical plan;
- the **executor** (``plan/executor.py``) lowers either the optimized
  plan or (``CYLON_TPU_PLAN=off``) the eager per-op chain;
- the **statistics catalog** keys runs at PLAN granularity:
  :meth:`fingerprint` hashes the op spec chain × pruned input content ×
  the knobs that change results, so a repeated multi-op query is one
  entry, not N per-op entries (the durable journal and the serve result
  cache that key by it too wait for ROADMAP.md queue A, items 10-11).

Every node knows its output schema (names), computed with the same
naming rules the eager ops use (join collision prefixes, ``sum_col``
aggregate names), so a planned query and its eager per-op twin agree on
schema by construction.

A copy of ``cylon_tpu/plan/ir.py``.  The port's Table holds one tuple of
Columns per shard (``Table.shards``), so a scan's dtypes come from the
first shard and its bytes from ``table_buffer_bytes``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..ops.groupby import AggOp
from ..status import Code, CylonError
from . import expr as expr_mod

ColumnRef = Union[int, str]


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------


class Node:
    """Base logical node; ``names`` is the output schema."""

    kind: str = "?"
    children: Tuple["Node", ...] = ()
    names: Tuple[str, ...] = ()

    def spec(self) -> tuple:
        raise NotImplementedError


class Scan(Node):
    kind = "scan"

    def __init__(self, idx: int, names: Tuple[str, ...],
                 dtype_tags: Tuple[str, ...], label: str = ""):
        self.idx = idx
        self.names = names
        self.dtype_tags = dtype_tags
        self.label = label or f"input{idx}"

    def spec(self) -> tuple:
        return ("scan", self.idx, tuple(self.names), tuple(self.dtype_tags))


class Project(Node):
    kind = "project"

    def __init__(self, child: Node, names: Tuple[str, ...]):
        missing = [n for n in names if n not in child.names]
        if missing:
            raise CylonError(Code.KeyError,
                             f"project of unknown column(s) {missing}")
        self.children = (child,)
        self.names = tuple(names)

    def spec(self) -> tuple:
        return ("project", tuple(self.names), self.children[0].spec())


class Filter(Node):
    kind = "filter"

    def __init__(self, child: Node, pred: expr_mod.Expr):
        unknown = sorted(pred.columns() - set(child.names))
        if unknown:
            raise CylonError(Code.KeyError,
                             f"filter reads unknown column(s) {unknown}")
        self.children = (child,)
        self.names = child.names
        self.pred = pred

    def spec(self) -> tuple:
        return ("filter", self.pred.spec(), self.children[0].spec())


class Derive(Node):
    kind = "derive"

    def __init__(self, child: Node, name: str, value: expr_mod.Expr):
        unknown = sorted(value.columns() - set(child.names))
        if unknown:
            raise CylonError(Code.KeyError,
                             f"derive reads unknown column(s) {unknown}")
        if name in child.names:
            raise CylonError(Code.Invalid,
                             f"derived column {name!r} already exists")
        self.children = (child,)
        self.names = child.names + (name,)
        self.name = name
        self.value = value

    def spec(self) -> tuple:
        return ("derive", self.name, self.value.spec(),
                self.children[0].spec())


class Join(Node):
    kind = "join"

    def __init__(self, left: Node, right: Node, left_on: Tuple[str, ...],
                 right_on: Tuple[str, ...], how: str, algorithm: str,
                 left_prefix: str = "l_", right_prefix: str = "r_"):
        if len(left_on) != len(right_on) or not left_on:
            raise CylonError(Code.Invalid,
                             "join needs equal-length non-empty key lists")
        for n in left_on:
            if n not in left.names:
                raise CylonError(Code.KeyError, f"left join key {n!r} missing")
        for n in right_on:
            if n not in right.names:
                raise CylonError(Code.KeyError,
                                 f"right join key {n!r} missing")
        if how not in ("inner", "left", "right", "outer", "full_outer",
                       "fullouter"):
            raise CylonError(Code.Invalid, f"bad join how {how!r}")
        if algorithm not in ("sort", "hash"):
            raise CylonError(Code.Invalid, f"bad join algorithm {algorithm!r}")
        self.children = (left, right)
        self.left_on = left_on
        self.right_on = right_on
        self.how = "outer" if how in ("full_outer", "fullouter") else how
        self.algorithm = algorithm
        self.left_prefix = left_prefix
        self.right_prefix = right_prefix
        self.names = join_names(left.names, right.names, left_prefix,
                                right_prefix)

    def out_name(self, side: str, name: str) -> str:
        """The output name of child column ``name`` from ``side`` —
        the same collision-prefix rule the eager join applies."""
        l, r = self.children[0].names, self.children[1].names
        collide = set(l) & set(r)
        if name not in collide:
            return name
        return (self.left_prefix if side == "left"
                else self.right_prefix) + name

    def spec(self) -> tuple:
        return ("join", tuple(self.left_on), tuple(self.right_on), self.how,
                self.algorithm, self.left_prefix, self.right_prefix,
                self.children[0].spec(), self.children[1].spec())


class Aggregate(Node):
    kind = "aggregate"

    def __init__(self, child: Node, by: Tuple[str, ...],
                 aggs: Tuple[Tuple[str, AggOp], ...], ddof: int):
        for n in by:
            if n not in child.names:
                raise CylonError(Code.KeyError, f"group key {n!r} missing")
        for n, _ in aggs:
            if n not in child.names:
                raise CylonError(Code.KeyError, f"agg column {n!r} missing")
        if not by or not aggs:
            raise CylonError(Code.Invalid, "groupby needs keys and aggs")
        self.children = (child,)
        self.by = by
        self.aggs = aggs
        self.ddof = int(ddof)
        self.names = tuple(by) + tuple(
            f"{op.name.lower()}_{n}" for n, op in aggs)

    def spec(self) -> tuple:
        return ("aggregate", tuple(self.by),
                tuple((n, op.name) for n, op in self.aggs), self.ddof,
                self.children[0].spec())


class Sort(Node):
    kind = "sort"

    def __init__(self, child: Node, by: Tuple[str, ...],
                 ascending: Tuple[bool, ...], nulls_first: bool):
        for n in by:
            if n not in child.names:
                raise CylonError(Code.KeyError, f"sort key {n!r} missing")
        if len(ascending) != len(by):
            raise CylonError(Code.Invalid, "ascending length mismatch")
        self.children = (child,)
        self.names = child.names
        self.by = by
        self.ascending = ascending
        self.nulls_first = bool(nulls_first)

    def spec(self) -> tuple:
        return ("sort", tuple(self.by), tuple(self.ascending),
                self.nulls_first, self.children[0].spec())


class Limit(Node):
    kind = "limit"

    def __init__(self, child: Node, n: int):
        if n < 0:
            raise CylonError(Code.Invalid, f"bad limit {n}")
        self.children = (child,)
        self.names = child.names
        self.n = int(n)

    def spec(self) -> tuple:
        return ("limit", self.n, self.children[0].spec())


def join_names(lnames: Sequence[str], rnames: Sequence[str],
               lp: str = "l_", rp: str = "r_") -> Tuple[str, ...]:
    """left ++ right with collision prefixes — the name-level twin of
    ``table._join_output_names`` (must stay in agreement)."""
    collide = set(lnames) & set(rnames)
    out_l = [lp + n if n in collide else n for n in lnames]
    out_r = [rp + n if n in collide else n for n in rnames]
    return tuple(out_l + out_r)


# ---------------------------------------------------------------------------
# the lazy builder
# ---------------------------------------------------------------------------


class LogicalPlan:
    """Immutable builder: every method returns a NEW plan sharing the
    input tables.  ``inputs[i]`` backs ``Scan(i)``."""

    def __init__(self, root: Node, inputs: List):
        self.root = root
        self.inputs = inputs

    # -- construction ----------------------------------------------------
    @staticmethod
    def scan(table, label: str = "") -> "LogicalPlan":
        tags = tuple(str(c.dtype) for c in table.shards[0])
        return LogicalPlan(Scan(0, tuple(table.names), tags, label), [table])

    @property
    def names(self) -> Tuple[str, ...]:
        return self.root.names

    def _wrap(self, node: Node) -> "LogicalPlan":
        return LogicalPlan(node, self.inputs)

    def project(self, refs) -> "LogicalPlan":
        names = self._resolve_many(refs)
        return self._wrap(Project(self.root, names))

    def filter(self, pred: expr_mod.Expr) -> "LogicalPlan":
        if not isinstance(pred, expr_mod.Expr):
            raise CylonError(
                Code.Invalid,
                "plan filters take a cylon_tpu_torch.plan expression "
                "(col()/lit() combinators), not a lambda — plans must "
                "fingerprint")
        if isinstance(pred, expr_mod.Lit):
            raise CylonError(Code.Invalid,
                             "filter predicate is a constant "
                             f"({pred.value!r}); it reads no columns")
        return self._wrap(Filter(self.root, pred))

    select = filter

    def with_column(self, name: str, value: expr_mod.Expr) -> "LogicalPlan":
        if not isinstance(value, expr_mod.Expr):
            raise CylonError(Code.Invalid,
                             "with_column takes a plan expression")
        return self._wrap(Derive(self.root, str(name), value))

    def join(self, other, *, on=None, left_on=None, right_on=None,
             how: str = "inner", algorithm: str = "sort") -> "LogicalPlan":
        other_plan = _as_plan(other)
        if on is not None:
            left_on = right_on = on
        if left_on is None or right_on is None:
            raise CylonError(Code.Invalid,
                             "join requires on= or left_on=/right_on=")
        lo = self._resolve_many(left_on)
        if isinstance(right_on, (int, str)):
            right_on = [right_on]
        ro = tuple(_resolve_names(other_plan.root.names, right_on))
        # merge input lists, deduping shared tables by identity
        inputs = list(self.inputs)
        remap: Dict[int, int] = {}
        for i, t in enumerate(other_plan.inputs):
            for j, mine in enumerate(inputs):
                if mine is t:
                    remap[i] = j
                    break
            else:
                remap[i] = len(inputs)
                inputs.append(t)
        right_root = _remap_scans(other_plan.root, remap)
        node = Join(self.root, right_root, lo, ro, how, algorithm)
        return LogicalPlan(node, inputs)

    def groupby(self, by, agg: Dict[ColumnRef, Union[str, Sequence[str]]],
                ddof: int = 0) -> "LogicalPlan":
        by_n = self._resolve_many(by)
        aggs: List[Tuple[str, AggOp]] = []
        for ref, ops in agg.items():
            name = _resolve_names(self.root.names, [ref])[0]
            if isinstance(ops, (str, AggOp)):
                ops = [ops]
            for op in ops:
                aggs.append((name, AggOp.of(op)))
        return self._wrap(Aggregate(self.root, by_n, tuple(aggs), ddof))

    def sort(self, by, ascending: Union[bool, Sequence[bool]] = True,
             nulls_first: bool = True) -> "LogicalPlan":
        by_n = self._resolve_many(by)
        if isinstance(ascending, bool):
            asc = tuple([ascending] * len(by_n))
        else:
            asc = tuple(bool(a) for a in ascending)
        return self._wrap(Sort(self.root, by_n, asc, nulls_first))

    def limit(self, n: int) -> "LogicalPlan":
        return self._wrap(Limit(self.root, n))

    # -- execution surface ----------------------------------------------
    def execute(self, ctx=None):
        """Run the plan and return a Table (optimized when
        ``CYLON_TPU_PLAN`` allows, eager per-op otherwise)."""
        from . import executor

        return executor.execute(self, ctx=ctx)

    def explain(self, optimized: Optional[bool] = None,
                analyze: bool = False) -> str:
        """Pretty-print the (optimized) plan: stages, elided shuffles,
        pruned columns, plane widths.  Pure host-side — nothing runs —
        UNLESS ``analyze=True`` (EXPLAIN ANALYZE): the plan executes
        once with the profiler on and every node line gains an
        estimate→actual suffix (rows, self time, exchange bytes,
        per-shard skew; estimates from the statistics catalog when a
        prior run observed this plan)."""
        from . import explain as explain_mod

        return explain_mod.explain(self, optimized=optimized,
                                   analyze=analyze)

    def profile(self, ctx=None):
        """Execute once with the profiler on; returns ``(Table,
        PlanProfile)`` — the programmatic EXPLAIN ANALYZE surface
        (per-node rows/bytes/skew as data instead of rendered text)."""
        from . import executor
        from . import profile as profile_mod

        prof = profile_mod.PlanProfile()
        t = executor.execute(self, ctx=ctx, profile=prof)
        return t, prof

    def fingerprint(self) -> str:
        """Plan-granularity content fingerprint: op spec chain × world ×
        pruned input content × trace-knob config.  The durable journal
        and the serve result cache key planned runs by this — one entry
        per multi-op query.

        When the adaptive planner chose physical strategies (broadcast
        joins, salted repartitions), ``optimizer.strategy_spec`` is
        folded into the header — a stats-dependent choice the cache key
        omitted would serve the wrong result).  With no strategies
        chosen the header is byte-identical to the rule-only
        fingerprint.

        Over a process group this is collective (it gathers the pruned
        scans' rows to every process): every process must call it."""
        from . import optimizer

        phys = optimizer.optimize(self, enabled=True)
        world = self._world()
        strat = optimizer.strategy_spec(phys)
        header = ((self.root.spec(), world) if not strat
                  else (self.root.spec(), world, ("adaptive", strat)))
        return self._content_fingerprint(phys, header)

    def base_fingerprint(self) -> str:
        """Strategy-INDEPENDENT content fingerprint: like
        :meth:`fingerprint` but optimized with ``adaptive=False``, so
        the header never carries strategy choices.  The statistics
        catalog keys observations by this — the cost model must read
        stats describing what the query IS regardless of what a prior
        planner chose, and the fingerprint→optimize→lookup recursion is
        structurally impossible (``adaptive=False`` never consults the
        catalog).  Equal to :meth:`fingerprint` whenever no adaptive
        strategy fired."""
        from . import optimizer

        phys = optimizer.optimize(self, enabled=True, adaptive=False)
        return self._content_fingerprint(
            phys, (self.root.spec(), self._world()))

    def _content_fingerprint(self, phys, header) -> str:
        """``durable.run_fingerprint`` over the pruned scans' live rows,
        hashed as their buffers (values or byte matrix, validity, string
        lengths, with the logical type), not as decoded host values: a
        string column costs one copy to the host and the bandwidth-bound
        fold instead of a Python object per row.  Equal buffers are equal
        content, so a hit is never wrong; the same content in other
        buffers (another string width, other bytes under a null) only
        misses."""
        from .. import durable
        from . import optimizer

        frames = []
        for scan, keep in optimizer.scan_prunes(phys):
            t = self.inputs[scan.idx].project(list(keep))
            cols, n = t._gathered_columns()
            bufs = {}
            for name, c in zip(keep, cols):
                tag = f"{name}:{c.dtype!r}"
                bufs[f"{tag}:data"] = c.data[:n].cpu().numpy()
                bufs[f"{tag}:valid"] = c.validity[:n].cpu().numpy()
                if c.lengths is not None:
                    bufs[f"{tag}:lengths"] = c.lengths[:n].cpu().numpy()
            frames.append((tuple(bufs), bufs))
        return durable.run_fingerprint("plan", header, frames)

    def approx_input_bytes(self) -> int:
        """Static HBM admission estimate (serve layer): buffer bytes of
        the pruned scan columns — array metadata only, no device sync.
        Strategy choices never change the pruned column sets, so the
        base (non-adaptive) optimization suffices and costs no catalog
        lookup."""
        from . import optimizer

        phys = optimizer.optimize(self, enabled=True, adaptive=False)
        return sum(table_buffer_bytes(self.inputs[scan.idx], keep)
                   for scan, keep in optimizer.scan_prunes(phys))

    # -- helpers ---------------------------------------------------------
    def _world(self) -> int:
        worlds = {t.num_shards for t in self.inputs}
        if len(worlds) > 1:
            raise CylonError(Code.Invalid,
                             f"plan inputs span different worlds {worlds}")
        return worlds.pop() if worlds else 1

    def _ctx(self):
        return self.inputs[0].ctx if self.inputs else None

    def _resolve_many(self, refs) -> Tuple[str, ...]:
        if isinstance(refs, (int, str)):
            refs = [refs]
        return tuple(_resolve_names(self.root.names, refs))


def table_buffer_bytes(table, keep) -> int:
    """Buffer bytes (data, validity, string lengths) of ``table``'s
    columns named in ``keep`` over every shard: this process's shards
    times the processes (each holds as many, at one capacity).  Array
    metadata only, no device sync."""
    keep = set(keep)
    total = 0
    for cols in table.shards:
        for name, c in zip(table.names, cols):
            if name in keep:
                total += c.data.nbytes + c.validity.nbytes
                if c.lengths is not None:
                    total += c.lengths.nbytes
    return int(total) * table.ctx.num_processes()


def _resolve_names(names: Tuple[str, ...], refs) -> List[str]:
    out = []
    for r in refs:
        if isinstance(r, str):
            if r not in names:
                raise CylonError(Code.KeyError, f"no column named {r!r}")
            out.append(r)
        else:
            i = int(r)
            if not 0 <= i < len(names):
                raise CylonError(Code.IndexError,
                                 f"column index {i} out of range")
            out.append(names[i])
    return out


def _remap_scans(node: Node, remap: Dict[int, int]) -> Node:
    """Rewrite Scan input indices after an input-list merge (join of two
    plans).  Rebuilds only the spine that changes."""
    if isinstance(node, Scan):
        new_idx = remap.get(node.idx, node.idx)
        if new_idx == node.idx:
            return node
        label = (f"input{new_idx}" if node.label == f"input{node.idx}"
                 else node.label)
        return Scan(new_idx, node.names, node.dtype_tags, label)
    new_children = tuple(_remap_scans(c, remap) for c in node.children)
    if all(n is o for n, o in zip(new_children, node.children)):
        return node
    import copy

    clone = copy.copy(node)
    clone.children = new_children
    return clone


def _as_plan(other) -> LogicalPlan:
    if isinstance(other, LogicalPlan):
        return other
    # duck-typed Table (avoid the import cycle)
    if hasattr(other, "shards") and hasattr(other, "names"):
        return LogicalPlan.scan(other)
    raise CylonError(Code.Invalid,
                     f"cannot join a plan with {type(other).__name__}")
