"""plan.explain(): render the optimized tree — and, with
``analyze=True``, run it and annotate every node with actuals.

The plain mode is stdlib-only string assembly over the optimizer's
annotations: every elided shuffle, shared scan, fused stage and pruned
column set is spelled out, with the packed-plane word width a pruned
scan would actually exchange (the bytes the pruning rule saves).

``analyze=True`` is EXPLAIN ANALYZE: the plan executes once with the
profiler on (``plan/profile.py``) and each node line gains an
estimate→actual suffix — rows (the estimate is the persistent
statistics catalog's prior observation when one exists), self time,
exchange ``bytes_sent``/``bytes_saved``, and per-shard row skew with
the slowest shard named.  Nodes fused into a parent's shard body (the
join under a fused group-by chain) carry no record of their own — their
cost is the parent's, exactly as executed.  A copy of
``cylon_tpu/plan/explain.py``; :func:`explain_refresh` renders a stream
query's refresh plan (``stream/incremental.py``).
"""
from __future__ import annotations

from typing import List, Optional

from . import expr as expr_mod
from . import ir, optimizer


def explain(plan, optimized: Optional[bool] = None,
            analyze: bool = False) -> str:
    from . import executor

    if analyze:
        from . import profile as profile_mod

        prof = profile_mod.PlanProfile()
        executor.execute(plan, profile=prof)
        phys = prof.phys
        assert phys is not None
        lines = [_header(phys)]
        if prof.plan_cache_hit:
            lines[0] += "  [served from journal: plan.cache_hit]"
        lines.append(
            f"analyze: wall={prof.wall_ms():.1f}ms  "
            f"estimates={'catalog' if prof.estimates is not None else '-'}"
            + (f"  fingerprint={prof.fingerprint[:12]}"
               if prof.fingerprint else ""))
        if prof.fleet_skew:
            worst = max(prof.fleet_skew,
                        key=lambda c: c.get("skew_ns", 0) or 0)
            lines.append(
                f"fleet: {len(prof.fleet_skew)} recent collectives on "
                f"the coordinator ledger, worst skew "
                f"{(worst.get('skew_ns', 0) or 0) / 1e6:.3f}ms "
                f"(slowest r{worst.get('slowest_rank')})")
        _render(plan, phys.root, lines, 1, prof)
        return "\n".join(lines)

    enabled = executor.planner_enabled() if optimized is None else bool(
        optimized)
    phys = optimizer.optimize(plan, enabled=enabled)
    lines = [_header(phys)]
    _render(plan, phys.root, lines, 1, None)
    return "\n".join(lines)


def explain_refresh(info: dict) -> str:
    """Render a streaming refresh plan from its ``describe()`` dict (a
    plain dict, so the plan package never imports the stream package),
    as ``cylon_tpu/plan/explain.py:64``: the incremental-vs-full decision
    and WHY."""
    mode = str(info.get("mode", "full")).upper()
    lines = [f"refresh [stream={info.get('stream')} "
             f"watermark={info.get('watermark')} mode={mode} "
             f"durable={'on' if info.get('durable') else 'off'}]",
             f"  {mode}: {info.get('reason', '-')}"]
    if info.get("kind") == "groupby":
        lines.append(
            f"  groupby [{', '.join(info.get('by', ()))}] "
            f"{', '.join(info.get('aggs', ()))}  "
            f"[{info.get('partials', 0)} persisted partial columns]")
        if mode == "INCREMENTAL":
            lines.append("  delta batches -> partial group-by -> one "
                         "combine with persisted state -> finalize "
                         "(unchanged)")
        else:
            lines.append("  frozen batches 0..N-1 -> concat -> one local "
                         "group-by (no reusable partial state)")
    elif info.get("kind") == "join":
        lines.append(
            f"  join {info.get('how')} on {', '.join(info.get('on', ()))}  "
            f"[dim: {info.get('dim_rows')} rows, broadcast once]")
        lines.append("  delta fact batches probe the static dim; committed "
                     "probe outputs replay from the journal")
    return "\n".join(lines)


def _header(phys: optimizer.PhysPlan) -> str:
    # adaptive fields render ONLY when the adaptive planner ran — the
    # default header stays byte-identical to the rule-only renderer
    adaptive = (f" adaptive=on broadcast_joins={phys.broadcast_joins} "
                f"keys_salted={phys.keys_salted}" if phys.adaptive else "")
    return (f"plan [world={phys.world} mode="
            f"{'optimized' if phys.enabled else 'eager'} "
            f"nodes={phys.nodes} "
            f"shuffles_elided={phys.shuffles_elided} "
            f"columns_pruned={phys.columns_pruned}{adaptive}]")


def _shuffle_note(ann: tuple) -> str:
    if not ann or ann[0] == "local":
        return "local"
    if ann[0] == "elide":
        return f"ELIDED (already hash({','.join(ann[1])}))"
    if ann[0] == "broadcast":
        return f"BROADCAST({','.join(ann[1])})"
    if ann[0] == "keep":
        return "kept in place"
    return f"shuffle({','.join(ann[1])})"


def _render(plan, p: optimizer.Phys, lines: List[str], depth: int,
            prof) -> None:
    n = p.node
    pad = "  " * depth
    suffix = prof.annotation(p.nid) if prof is not None else ""
    if isinstance(n, ir.Scan):
        t = plan.inputs[n.idx]
        note = ""
        pruned = len(p.keep) < len(n.names)
        ann = optimizer.plane_annotation(t, p.keep)
        comp = ann.get("words_comp")
        if pruned or (comp is not None and comp < ann["words_pruned"]):
            # pruning and compression attribute separately: full->pruned
            # words are the planner's column elimination, pruned->comp
            # the payload encoder's bit-width/dictionary win
            words = f"plane {ann['words_full']}->{ann['words_pruned']}"
            if comp is not None:
                words += f"->{comp}"
            note = (f"  [pruned {len(n.names)}->{len(p.keep)} cols, "
                    f"{words} words/row"
                    + (" (compressed)" if comp is not None else "") + "]")
        lines.append(f"{pad}scan {n.label}: "
                     f"{', '.join(p.keep)}{note}{suffix}")
        return
    if isinstance(n, ir.Project):
        lines.append(f"{pad}project [{', '.join(p.keep)}]{suffix}")
    elif isinstance(n, ir.Filter):
        lines.append(f"{pad}filter {expr_mod.render(n.pred)}{suffix}")
    elif isinstance(n, ir.Derive):
        dead = "  [DEAD: pruned]" if p.ann.get("dead") else ""
        lines.append(f"{pad}derive {n.name} = "
                     f"{expr_mod.render(n.value)}{dead}{suffix}")
    elif isinstance(n, ir.Join):
        shared = "  [SHARED SCAN: one exchange feeds both sides]" \
            if p.ann.get("shared") else ""
        bcast = ""
        b = p.ann.get("broadcast")
        if isinstance(b, dict):
            bcast = (f"  [ADAPTIVE: broadcast {b.get('side')} side, "
                     f"est {b.get('bytes')}B ({b.get('source')})]")
        lines.append(
            f"{pad}join {n.how}/{n.algorithm} on "
            f"{','.join(n.left_on)} = {','.join(n.right_on)}  "
            f"[left: {_shuffle_note(p.ann.get('left', ()))}, "
            f"right: {_shuffle_note(p.ann.get('right', ()))}]"
            f"{shared}{bcast}{suffix}")
    elif isinstance(n, ir.Aggregate):
        mode = p.ann.get("mode", "eager")
        if mode == "elided":
            note = (f"  [shuffle ELIDED: hash("
                    f"{','.join(p.ann.get('part_keys', ()))}) covers the "
                    f"group keys]")
        elif mode == "local":
            note = "  [local]"
        else:
            note = f"  [shuffle({','.join(n.by)})]"
        if p.ann.get("salt"):
            se = p.ann.get("salt_est") or {}
            note += (f"  [ADAPTIVE: salted x{p.ann['salt']}, observed "
                     f"skew {se.get('skew')} >= {se.get('factor')} "
                     f"({se.get('source')})]")
        if p.ann.get("fuse"):
            note += "  [FUSED with join: one shard body]"
        aggs = ", ".join(f"{op.name.lower()}({c})" for c, op in n.aggs)
        lines.append(f"{pad}groupby [{', '.join(n.by)}] "
                     f"{aggs}{note}{suffix}")
    elif isinstance(n, ir.Sort):
        keys = ", ".join(f"{k}{'^' if a else 'v'}"
                         for k, a in zip(n.by, n.ascending))
        lines.append(f"{pad}sort [{keys}]  [range shuffle]{suffix}")
    elif isinstance(n, ir.Limit):
        lines.append(f"{pad}limit {n.n}  [gather]{suffix}")
    else:
        lines.append(f"{pad}{n.kind}{suffix}")
    for c in p.children:
        _render(plan, c, lines, depth + 1, prof)
