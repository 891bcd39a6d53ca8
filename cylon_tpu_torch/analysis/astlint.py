"""Level-1 (AST) rules of cylint, the port's copy.

The port of ``cylon_tpu/analysis/astlint.py``: pure-stdlib AST analysis,
importable with no torch present.  The pass is two-phase: phase 1 parses
every file into a ``_Module`` and collects per-function facts (resolved
call edges, knob-accessor uses, env reads, cached-callable builder
shape); phase 2 propagates knob use and collective reach over the
cross-module call graph and emits findings.

What changed from the reference: every module prefix names
``cylon_tpu_torch``; the blocking device calls are torch's
(``synchronize``, ``item``, ``tolist``, ``cpu``, ``numpy``) and the
port's ``to_numpy``; the collectives are the entry points of
``cylon_tpu_torch.parallel.collectives`` and torch.distributed's own.
The three rules that name JAX idioms take the port's counterparts:

- CY101: nothing is traced, so the hazard is the one that a traced
  body's host sync stood for: every process of a group must issue the
  same collectives.  A Python branch on a rank-local device value (a
  value that came from ``torch``, read on the host by ``.item()``,
  ``.tolist()``, ``bool()``/``int()``/``float()`` or truthiness) must
  not decide whether a collective runs.  The values a gather or a
  reduction returns are the same on every process, and clear the taint;
  an exchange's (``all_to_all``, ``reduce_scatter``) differ per process,
  and carry it.
- CY103 and CY109: the port compiles nothing; its cached callables
  (``stream/incremental.py::_cached_kernel(key, build)``: a function
  with a ``key`` parameter that calls a callable parameter to build the
  cached value) play the jit-plan cache's part.  A trace-scope knob read
  by the built callable (or any function nested in it) must ride the
  key, or ``trace_cache_token()`` must; a realized-layout spec the
  callable closes over must ride the key at the call site.

Scope notes (what the analysis can and cannot prove):

- Call edges resolve through module aliases (``from . import plane as
  plane_mod``) and bare local names; method calls on objects
  (``t.shuffle(...)``) do not resolve — reachability through them is out
  of scope.
- CY101's taint starts at ``torch.*`` calls and methods called on their
  results, at an exchange's result, and at any ``.item()`` or
  ``.tolist()`` whose receiver is not a gather's or a reduction's result
  (a parameter's too).  A parameter read any other way
  (``bool(x)``, ``if x:``) is not tainted: that trades a class of
  parameter-direct hazards for few false positives on host flags.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .. import config

RULES: Dict[str, str] = {
    "CY001": "cylint suppression without a justification",
    "CY101": "branch on a rank-local device value decides whether a "
             "collective runs",
    "CY102": "environment read outside the knob registry",
    "CY103": "trace-scope knob missing from a cached callable's key",
    "CY104": "retry wrapper lexically enclosing a collective",
    "CY105": "swallowed exception classification",
    "CY106": "collective reachable from an elastic recovery path without "
             "an epoch guard",
    "CY107": "blocking device call reachable from the serve "
             "admission/scheduler control path",
    "CY108": "plan optimizer/executor reads a trace-scope knob the plan "
             "fingerprint does not cover",
    "CY109": "realized-data layout missing from a cached callable's key",
    "CY110": "blocking device call reachable from a router "
             "route/placement/reroute control path",
    "CY111": "blocking RPC or fsync reachable while a placement/"
             "membership lock is held",
    "CY112": "optimizer rule reads observed statistics but no plan "
             "fingerprint builder folds the strategy choice",
    "CY113": "lock-order cycle / inconsistent pairwise lock ordering "
             "(potential deadlock)",
    "CY114": "blocking primitive (sleep / Thread.join / Condition.wait "
             "on the wrong lock / unbounded queue.get) reachable while "
             "a lock is held",
    "CY115": "instance attribute written from >=2 thread roots with no "
             "common guarding lock",
    "CY116": "stream-package reader decodes a persisted partial-"
             "aggregate spill without validating the state schema "
             "version first",
    "CY117": "persisted .arrow spill bytes read outside a checksum-"
             "verifying loader",
    "CY201": "missing collective-budget golden file",
    "CY202": "collective-budget regression against the golden file",
    "CY203": "missing lock-order golden file",
    "CY204": "observed lock-order edge not covered by the golden or the "
             "static lock graph",
}

#: the one file allowed to read os.environ directly: the registry (the
#: port has no compile-cache enabler)
ENV_READ_ALLOWED = ("cylon_tpu_torch/config.py",)

#: the port's collectives module: its entry points are the collective
#: families (CY101, CY104, CY106, and the budgets of ``budgets.py``)
COLLECTIVES_MODULE = "cylon_tpu_torch.parallel.collectives"
COLLECTIVE_ENTRY_POINTS = ("allgather", "process_allgather",
                           "allreduce_sum", "allreduce_min",
                           "allreduce_max", "all_to_all")

#: collective call names (final identifier): the entry points above and
#: torch.distributed's own collectives
COLLECTIVE_NAMES = frozenset(COLLECTIVE_ENTRY_POINTS) | frozenset({
    "all_gather", "all_gather_into_tensor", "all_reduce",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "barrier",
})

#: the elastic control-plane module and its recovery entry points, for
#: CY106 reachability: any function there named elastic_*, plus any
#: reconnect/ride-through path of the survivable control plane
#: (functions whose name contains "reconnect" or "ride_out"): a
#: reconnected agent resumes against a possibly-restarted coordinator,
#: so a collective issued from its reconnect path is the same
#: stale-world hazard as one issued from a resume path
ELASTIC_MODULE = "cylon_tpu_torch.elastic"
ELASTIC_ROOT_PREFIX = "elastic_"
ELASTIC_ROOT_SUBSTRINGS = ("reconnect", "ride_out")


def _is_elastic_recovery_root(name: str) -> bool:
    return (name.startswith(ELASTIC_ROOT_PREFIX)
            or any(s in name for s in ELASTIC_ROOT_SUBSTRINGS))

#: calls that count as an epoch guard on a recovery path: the agent's
#: membership check, or an engine-level guard hook
EPOCH_GUARD_NAMES = frozenset({"ensure_epoch", "epoch_guard"})

#: the serving package and its control-path roots, for CY107: admission,
#: shedding, cancellation and dispatch DECISIONS must stay device-free —
#: a wedged device may delay results, never admission or drain.  Roots
#: are matched by bare function name (exact, or one of the prefixes).
SERVE_MODULE_PREFIX = "cylon_tpu_torch.serve"
SERVE_CONTROL_ROOTS = frozenset({"submit", "cancel", "drain"})
SERVE_CONTROL_PREFIXES = ("_dispatch", "_admit", "_shed", "_cancel")

#: call names (final identifier) that block the calling thread on device
#: work, for CY107/CY110 reachability: torch's device fences and host
#: reads, the port's ``to_numpy`` (``column.to_numpy``, the table
#: exports) and its named host syncs (``obs.spans.host_read`` and
#: ``host_select``)
BLOCKING_DEVICE_NAMES = frozenset({
    "synchronize", "item", "tolist", "cpu", "numpy", "to_numpy",
    "host_read", "host_select"})

#: modules the CY107/CY110 walk treats as host-only leaves: pyarrow's
#: ``Array.to_numpy`` (the IPC decode in io/arrow_io.py) and numpy's
#: ``.item()``/``.tolist()`` (the router wire codec's JSON scalars) share
#: a final identifier with a device read but never touch a device —
#: name-level matching cannot tell them apart, so the known-host-only
#: modules are declared barriers.  Neither imports torch (a test holds
#: them to it).
HOST_ONLY_MODULES = frozenset({"cylon_tpu_torch.io.arrow_io",
                               "cylon_tpu_torch.router.wire"})

#: the router package and its control-path roots, for CY110 — the CY107
#: invariant one tier up: route admission, placement, re-route decisions
#: and the heartbeat/verb handlers feeding the routing table run on
#: caller/handler threads, and a blocking device call reachable from
#: any of them lets ONE wedged replica's device stall placement for the
#: whole fleet.  Roots: the ``route`` verb, ``_place*``/``_reroute*``/
#: ``_proxy*``/``_route*``/``_shed*`` helpers, and the ``_handle*`` verb
#: handlers (heartbeats build the placement view).
ROUTER_MODULE_PREFIX = "cylon_tpu_torch.router"
ROUTER_CONTROL_ROOTS = frozenset({"route"})
ROUTER_CONTROL_PREFIXES = ("_place", "_reroute", "_proxy", "_route",
                           "_shed", "_handle", "_on_replica")

#: modules in scope for CY111 — the router tier (placement lock
#: ``_router_lock`` + the inherited membership lock ``_lock``) and the
#: durable journal (the GC-lease eviction path).  The hedge,
#: breaker and lease control paths all mutate shared dicts under a
#: lock; a blocking RPC or an fsync issued while that lock is held
#: turns one slow replica or one slow disk into a fleet-wide placement
#: stall — exactly the tail the hedging exists to cut off
CY111_MODULE_PREFIXES = ("cylon_tpu_torch.router",
                         "cylon_tpu_torch.durable")

#: call finals that block the lock holder for CY111: the one-shot
#: control-plane RPC (``net/control.request``) and the journal's
#: ``os.fsync`` — both wait on a peer or a disk, neither belongs under
#: a lock every routing decision shares
LOCK_HELD_BLOCKING_NAMES = frozenset({"request", "fsync"})

#: the planner package and its rule/executor roots, for CY108: the plan
#: FINGERPRINT is the durable/serve result-cache key for whole planned
#: runs — if an optimizer rule or executor path reads a trace-scope knob
#: (the computation, hence the result, can change with it), the
#: fingerprint must cover every trace knob (trace_cache_token) or a knob
#: flip would serve a stale cached result (the CY103 bug class, lifted
#: from cached callables to the plan cache)
PLAN_MODULE_PREFIX = "cylon_tpu_torch.plan"
PLAN_ROOT_NAMES = frozenset({"optimize", "execute", "run_service"})
PLAN_ROOT_PREFIXES = ("_rule_", "_lower", "_stage", "_exec", "_fused",
                      "plane_annotation")
PLAN_FP_TOKEN = "fingerprint"

#: observed-statistics readers an optimizer rule may steer on, for
#: CY112: a strategy picked FROM statistics is part of the program the
#: plan compiles to — if no plan fingerprint builder folds the chosen
#: strategies (strategy_spec) into the fingerprint, a catalog change
#: flips the strategy under a stale cache key and the journal/serve
#: caches replay the wrong program's result (the CY103/CY109 bug class,
#: lifted from knobs and realized layouts to planner decisions)
ADAPTIVE_STATS_READS = frozenset({"lookup_stats", "column_stats"})
STRATEGY_FOLD_TOKEN = "strategy_spec"

#: producers whose RESULT is a layout derived from REALIZED data
#: (observed bit widths, dictionary sizes — the plane's compression
#: spec), for CY109: a cached callable closing over such a value bakes a
#: data-dependent layout into what the cache serves, so the value must
#: ride the cache key alongside it — trace_cache_token() cannot cover it
#: (it is data, not a knob), hence key-complete builders are NOT exempt.
#: Matched by final call identifier.
REALIZED_LAYOUT_PRODUCERS = frozenset({"build_spec", "estimate_spec"})

#: the streaming layer's persisted-state decode discipline, for CY116:
#: a checksum proves the BYTES of a partial-aggregate spill are intact,
#: but not that their MEANING held — the partial column order, the
#: identity-fill convention and the combine layout are an on-disk
#: contract (stream/state.py), and a layout change silently misreading
#: an old spill corrupts a refresh no checksum can catch.  So any
#: stream-package function that lexically performs a spill decode
#: (``load_pass`` / ``frame_from_ipc_bytes``) must ALSO lexically call
#: the version gate — validation at a distance (a caller checked) is
#: exactly the refactoring hazard the rule exists to kill.
STREAM_MODULE_PREFIX = "cylon_tpu_torch.stream"
STATE_DECODE_NAMES = frozenset({"load_pass", "frame_from_ipc_bytes"})
STATE_VERSION_GUARD = "require_state_version"

#: CY117: a package function that lexically reads persisted
#: ``.arrow`` spill bytes — a binary-mode ``open`` call plus an
#: ``.arrow`` string constant in the same function, or a direct
#: ``frame_from_ipc_bytes`` decode — must ALSO lexically verify a
#: checksum.  Bitrot on disk is silent; the journal's discipline is
#: that every byte served off a spill passed a sha256 first, and like
#: CY116 the pairing is LEXICAL on purpose: validation at a distance
#: dies quietly in a refactor.  Verification counts as ``sha256``
#: itself, the journal's verifying loader (``load_pass``), or the
#: wire's digest-checked blob decode (``blob_from_b64``).  The IPC
#: codec module is exempt: it is handed bytes already in memory — the
#: loader above it owns verification.
SPILL_DECODE_NAME = "frame_from_ipc_bytes"
SPILL_SUFFIX = ".arrow"
SPILL_VERIFY_NAMES = frozenset({"sha256", "load_pass", "blob_from_b64"})
SPILL_EXEMPT_MODULES = frozenset({"cylon_tpu_torch.io.arrow_io"})

#: the package the module names and site keys are rooted at
PACKAGE = "cylon_tpu_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*cylint:\s*disable=([A-Z0-9,\s]+?)(?:\s*--\s*(\S.*))?\s*$")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    msg: str
    hint: str = ""

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.msg}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


# ---------------------------------------------------------------------------
# phase 1: per-module facts
# ---------------------------------------------------------------------------


def _module_name(path: str) -> str:
    parts = path.replace("\\", "/").split("/")
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    else:
        parts = parts[-1:]
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    elif parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


@dataclass
class _Func:
    qual: str                    # module.name (nested defs flattened by name)
    module: str
    node: ast.AST                # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    calls: Set[str] = field(default_factory=set)        # resolved quals
    call_finals: Set[str] = field(default_factory=set)  # final identifiers
    knobs: Set[str] = field(default_factory=set)        # knob names used
    # cached-callable builder shape: the param index of the callable it
    # calls to build the cached value, where the cache key arrives
    # (positional index, or keyword-only), and whether the key
    # computation includes trace_cache_token()
    builder_fn_idx: Optional[int] = None
    builder_key_idx: Optional[int] = None
    builder_key_kw: bool = False
    key_complete: bool = False


@dataclass
class _Module:
    path: str
    name: str
    tree: ast.Module
    lines: List[str]
    aliases: Dict[str, str] = field(default_factory=dict)  # local -> qual
    funcs: Dict[str, _Func] = field(default_factory=dict)  # simple name -> f
    all_funcs: List[_Func] = field(default_factory=list)   # every def
    nodes: List[ast.AST] = field(default_factory=list)     # ast.walk(tree)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)


def _accessor_map() -> Dict[str, str]:
    """qualified accessor -> knob name, from the registry's declarative
    ``accessors`` column."""
    return {acc: k.name
            for k in config.KNOBS.values() for acc in k.accessors}


_ACC_BY_QUAL = _accessor_map()
_TRACE_KNOBS = frozenset(k.name for k in config.KNOBS.values()
                         if k.scope == config.TRACE)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _resolve(dotted: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    """Rewrite the leading alias of a dotted path to its import target."""
    if not dotted:
        return None
    head, _, rest = dotted.partition(".")
    base = aliases.get(head)
    if base is None:
        return dotted
    return base + ("." + rest if rest else "")


def _collect_aliases(tree: ast.Module, module: str,
                     is_package: bool) -> Dict[str, str]:
    # level-1 relative imports resolve against the containing package: the
    # module itself when this file IS a package (__init__.py), else its
    # parent
    if is_package:
        pkg = module
    else:
        pkg = module.rsplit(".", 1)[0] if "." in module else module
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.partition(".")[0]] = (
                    a.name if a.asname else a.name.partition(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                parts = parts[: len(parts) - (node.level - 1)]
                base = ".".join(parts)
                if node.module:
                    base += "." + node.module
            else:
                base = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = (
                    f"{base}.{a.name}" if base else a.name)
    return aliases


def _knob_of_call(call: ast.Call, aliases: Dict[str, str],
                  module: str) -> Optional[str]:
    """Knob name a call consumes: a registry accessor, or a literal
    ``config.knob("NAME")`` / ``knob_raw("NAME")``."""
    dotted = _dotted(call.func)
    resolved = _resolve(dotted, aliases)
    final = (dotted or "").rsplit(".", 1)[-1]
    if resolved in _ACC_BY_QUAL:
        return _ACC_BY_QUAL[resolved]
    # bare local call to an accessor defined in this very module
    if dotted and "." not in dotted and f"{module}.{dotted}" in _ACC_BY_QUAL:
        return _ACC_BY_QUAL[f"{module}.{dotted}"]
    if final in ("knob", "knob_raw") and call.args:
        arg = call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


class _FuncScanner(ast.NodeVisitor):
    """Fills one _Func's call edges, knob uses and builder shape."""

    def __init__(self, func: _Func, mod: _Module):
        self.f = func
        self.mod = mod
        params, kwonly = [], []
        node = func.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params = [a.arg for a in node.args.posonlyargs + node.args.args]
            kwonly = [a.arg for a in node.args.kwonlyargs]
        self.params = params
        self.kwonly = kwonly

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is self.f.node:
            self.generic_visit(node)
        # nested defs get their own _Func; don't descend here

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        if node is self.f.node:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        resolved = _resolve(dotted, self.mod.aliases)
        final = (dotted or "").rsplit(".", 1)[-1]
        if final:
            self.f.call_finals.add(final)
        if dotted and "." not in dotted:
            self.f.calls.add(f"{self.mod.name}.{dotted}")
        elif resolved:
            self.f.calls.add(resolved)
        knob = _knob_of_call(node, self.mod.aliases, self.mod.name)
        if knob:
            self.f.knobs.add(knob)
        if final == "trace_cache_token":
            self.f.key_complete = True
        # builder shape: one of OUR params called to build the value a
        # ``key`` param caches (``_cached_kernel(key, build)``)
        if dotted in self.params and ("key" in self.params
                                      or "key" in self.kwonly):
            self.f.builder_fn_idx = self.params.index(dotted)
            if "key" in self.params:
                self.f.builder_key_idx = self.params.index("key")
            else:
                self.f.builder_key_kw = True
        self.generic_visit(node)


def _parse_module(path: str) -> Optional[_Module]:
    with open(path, "r", encoding="utf-8") as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        mod = _Module(path, _module_name(path), ast.Module(body=[],
                      type_ignores=[]), src.splitlines())
        mod.findings.append(Finding("CY001", path, e.lineno or 1,
                                    f"file does not parse: {e.msg}"))
        return mod
    mod = _Module(path, _module_name(path), tree, src.splitlines())
    mod.nodes = list(ast.walk(tree))
    mod.aliases = _collect_aliases(
        tree, mod.name, path.replace("\\", "/").endswith("/__init__.py"))

    for i, line in enumerate(mod.lines, 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not m.group(2):
            mod.findings.append(Finding(
                "CY001", path, i,
                f"suppression of {', '.join(sorted(rules))} carries no "
                f"justification",
                "write `# cylint: disable=RULE -- <why this is safe>`"))
            continue
        mod.suppressions[i] = rules

    for node in mod.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            f = _Func(qual=f"{mod.name}.{node.name}", module=mod.name,
                      node=node, lineno=node.lineno)
            _FuncScanner(f, mod).visit(node)
            # last def under a name wins for resolution; collisions are
            # rare (nested helper fns) and union-ed via call_finals anyway
            mod.funcs[node.name] = f
            mod.all_funcs.append(f)
    return mod


# ---------------------------------------------------------------------------
# phase 2: cross-module propagation
# ---------------------------------------------------------------------------


class _Program:
    def __init__(self, modules: Sequence[_Module]):
        self.modules = list(modules)
        self.by_qual: Dict[str, _Func] = {}
        self._coll: Optional[Set[str]] = None
        for m in self.modules:
            for f in m.funcs.values():
                self.by_qual[f.qual] = f

    def reachable(self, root: _Func) -> Set[str]:
        seen: Set[str] = set()
        stack = [root.qual]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            f = self.by_qual.get(q)
            if f is None:
                continue
            stack.extend(f.calls)
        return seen

    def knobs_of(self, root: _Func) -> Set[str]:
        out: Set[str] = set()
        for q in self.reachable(root):
            f = self.by_qual.get(q)
            if f is not None:
                out |= f.knobs
        return out

    def reaches_collective(self, f: _Func) -> bool:
        """Whether any collective is reachable from ``f`` (one reverse
        fixpoint over the call graph, computed on first use)."""
        if self._coll is None:
            hot = {q for q, g in self.by_qual.items()
                   if g.call_finals & COLLECTIVE_NAMES}
            callers: Dict[str, Set[str]] = {}
            for q, g in self.by_qual.items():
                for c in g.calls:
                    callers.setdefault(_self_call(g.module, c),
                                       set()).add(q)
            stack = list(hot)
            while stack:
                q = stack.pop()
                for c in callers.get(q, ()):
                    if c not in hot:
                        hot.add(c)
                        stack.append(c)
            self._coll = hot
        return f.qual in self._coll or bool(f.call_finals & COLLECTIVE_NAMES) \
            or any(_self_call(f.module, c) in self._coll for c in f.calls)

    def collectives_reached(self, root: _Func) -> Set[str]:
        """Collective names reachable from ``root`` with ``self.``/``cls.``
        calls resolved to same-module functions (CY101's walk)."""
        seen: Set[str] = set()
        stack = [root.qual]
        hit: Set[str] = set()
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            g = self.by_qual.get(q)
            if g is not None:
                hit |= g.call_finals & COLLECTIVE_NAMES
                stack.extend(_self_call(g.module, c) for c in g.calls)
        return hit

    def collective_reach(self, root: _Func) -> Set[str]:
        out: Set[str] = set()
        for q in self.reachable(root):
            f = self.by_qual.get(q)
            if f is not None:
                out |= f.call_finals & COLLECTIVE_NAMES
        return out

    def knobs_of_built(self, mod: _Module, fn: _Func) -> Set[str]:
        """Knobs a cached callable's build function reaches, through
        every def nested in it too: what the build returns (a closure)
        runs later under the key."""
        out: Set[str] = set()
        for g in mod.all_funcs:
            if fn.lineno <= g.lineno <= fn.node.end_lineno:
                out |= self.knobs_of(g)
        return out

    def _builder_for(self, dotted: Optional[str], resolved: Optional[str],
                     mod: _Module) -> Optional[_Func]:
        """The plan-builder _Func a call site targets, if any."""
        if dotted and "." not in dotted:
            f = mod.funcs.get(dotted)
            if f is not None and f.builder_fn_idx is not None:
                return f
            f = self.by_qual.get(f"{mod.name}.{dotted}")
        else:
            f = self.by_qual.get(resolved or "")
        if f is not None and f.builder_fn_idx is not None:
            return f
        return None


# ---------------------------------------------------------------------------
# rule CY101: a rank-local device value decides whether a collective runs
# ---------------------------------------------------------------------------

_TORCH_ROOTS = ("torch",)

#: tensor metadata: the same on every process of a group for a given
#: program, so reading it never yields a rank-local value
_STATIC_ATTRS = frozenset({
    "shape", "dtype", "ndim", "device", "is_cuda", "layout", "itemsize",
    "nbytes", "requires_grad"})

#: tensor methods answering metadata questions, not reading values
_STATIC_METHODS = frozenset({
    "size", "dim", "numel", "nelement", "element_size", "is_floating_point",
    "is_contiguous", "get_device", "data_ptr", "stride", "storage_offset"})

#: torch callables answering static dtype/device questions, not tensors
_STATIC_TORCH_FNS = frozenset({
    "device", "dtype", "iinfo", "finfo", "is_tensor", "is_floating_point",
    "is_available", "device_count", "current_device", "get_default_dtype",
    "promote_types", "result_type", "can_cast", "Size", "get_rank",
    "get_world_size", "get_backend", "is_initialized", "get_device_name",
    "get_device_properties", "set_device", "Generator", "manual_seed"})

#: collectives whose result differs per process (each receives its own
#: rows): they carry the taint, where a gather's or a reduction's result,
#: the same on every process, clears it
RANK_LOCAL_COLLECTIVES = frozenset({
    "all_to_all", "all_to_all_single", "reduce_scatter",
    "reduce_scatter_tensor"})

#: host reads of a device value (the sync itself), for the message
_HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_READ_BUILTINS = frozenset({"bool", "int", "float"})

#: host reads that taint whatever they read, unless it is known to be
#: the same on every process
_SCALAR_READS = frozenset({"item", "tolist"})


def _lexical(nodes: Iterable[ast.AST]) -> Iterable[ast.AST]:
    """Every node lexically in ``nodes``, nested def/lambda/class bodies
    skipped (they run later, not here)."""
    stack: List[ast.AST] = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _own_calls(nodes: Iterable[ast.AST]) -> Iterable[ast.Call]:
    """Calls lexically in ``nodes``."""
    return (n for n in _lexical(nodes) if isinstance(n, ast.Call))


class _RankLocal:
    """CY101 over one function: which names hold rank-local device values
    (straight-line taint from ``torch`` calls), and which branches on them
    decide a collective."""

    def __init__(self, func: _Func, mod: _Module, prog: "_Program",
                 out: List[Finding]):
        self.f = func
        self.mod = mod
        self.prog = prog
        self.out = out
        self.tainted: Set[str] = set()
        self.uniform: Set[str] = set()

    def _root_of(self, dotted: Optional[str]) -> Optional[str]:
        if not dotted:
            return None
        resolved = _resolve(dotted, self.mod.aliases) or dotted
        return resolved.rsplit(".", 1)[0] if "." in resolved else resolved

    def _is_torch_call(self, node: ast.Call) -> bool:
        root = self._root_of(_dotted(node.func))
        return bool(root) and any(
            root == r or root.startswith(r + ".") for r in _TORCH_ROOTS)

    def _is_collective_call(self, node: ast.Call) -> bool:
        dotted = _dotted(node.func) or ""
        if dotted.rsplit(".", 1)[-1] in COLLECTIVE_NAMES:
            return True
        return self._root_of(dotted) == COLLECTIVES_MODULE

    def _collective_final(self, node: ast.Call) -> Optional[str]:
        if not self._is_collective_call(node):
            return None
        return (_dotted(node.func) or "").rsplit(".", 1)[-1]

    def _is_uniform(self, node: ast.AST) -> bool:
        """Whether ``node`` is a gather's or a reduction's result, or read
        from one by subscripts, attributes and method calls."""
        if isinstance(node, ast.Name):
            return node.id in self.uniform and node.id not in self.tainted
        if isinstance(node, ast.Call):
            final = self._collective_final(node)
            if final is not None:
                return final not in RANK_LOCAL_COLLECTIVES
            return (isinstance(node.func, ast.Attribute)
                    and self._is_uniform(node.func.value)
                    and not any(self._expr_tainted(a) for a in node.args))
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            return self._is_uniform(node.value)
        return False

    def _expr_tainted(self, node: ast.AST) -> bool:
        """Whether evaluating ``node`` can yield a rank-local device
        value.  Static barriers: tensor metadata, identity tests, ``len()``;
        a gather's or a reduction's result is the same on every process,
        an exchange's is not; a scalar read is tainted unless what it
        reads is known to be the same everywhere."""
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self._expr_tainted(node.value)
        if isinstance(node, ast.Name):
            return (isinstance(node.ctx, ast.Load)
                    and node.id in self.tainted)
        if isinstance(node, ast.Call):
            final = (_dotted(node.func) or "").rsplit(".", 1)[-1]
            if final in ("len", "isinstance", "hasattr", "getattr", "range",
                         "type", "id", "callable"):
                return False
            coll = self._collective_final(node)
            if coll is not None:
                return coll in RANK_LOCAL_COLLECTIVES
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SCALAR_READS:
                return not self._is_uniform(node.func.value)
            if self._is_torch_call(node):
                return final not in _STATIC_TORCH_FNS
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _STATIC_METHODS:
                    return False
                if self._expr_tainted(node.func.value):
                    return True
            return (any(self._expr_tainted(a) for a in node.args)
                    or any(self._expr_tainted(k.value)
                           for k in node.keywords))
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self._expr_tainted(node.left)
                    or any(self._expr_tainted(c) for c in node.comparators))
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        return any(self._expr_tainted(c) for c in ast.iter_child_nodes(node))

    def _collectives_in(self, nodes: Iterable[ast.AST]) -> Set[str]:
        hit: Set[str] = set()
        for c in _own_calls(nodes):
            dotted = _dotted(c.func)
            final = (dotted or "").rsplit(".", 1)[-1]
            if final in COLLECTIVE_NAMES:
                hit.add(final)
            q = None
            if dotted and "." not in dotted:
                q = f"{self.mod.name}.{dotted}"
            elif dotted:
                q = _self_call(self.mod.name,
                               _resolve(dotted, self.mod.aliases) or "")
            fn = self.prog.by_qual.get(q or "")
            if fn is not None and self.prog.reaches_collective(fn):
                hit |= self.prog.collectives_reached(fn)
        return hit

    def _how(self, test: ast.AST) -> str:
        for c in _own_calls([test]):
            fin = (_dotted(c.func) or "").rsplit(".", 1)[-1]
            if isinstance(c.func, ast.Attribute) \
                    and fin in _HOST_READ_METHODS \
                    and self._expr_tainted(c.func.value):
                return f"`.{fin}()`"
            if fin in _HOST_READ_BUILTINS and isinstance(c.func, ast.Name) \
                    and any(self._expr_tainted(a) for a in c.args):
                return f"`{fin}()`"
        return "truthiness"

    def run(self) -> None:
        node = self.f.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if not self.prog.reaches_collective(self.f):
            return
        own = list(_own_nodes(self.f))
        if not any(isinstance(n, (ast.If, ast.While, ast.IfExp))
                   for n in own):
            return
        # names bound from a gather's or a reduction's result, then the
        # fixpoint over straight-line taint (loops converge in 2-3 passes)
        for _ in range(3):
            before = len(self.uniform)
            for n in own:
                if isinstance(n, ast.Assign) and self._is_uniform(n.value):
                    for t in n.targets:
                        self.uniform |= _bound_names(t)
                elif isinstance(n, (ast.For, ast.comprehension)) \
                        and self._is_uniform(n.iter):
                    self.uniform |= _bound_names(n.target)
            if len(self.uniform) == before:
                break
        for _ in range(4):
            before = len(self.tainted)
            for n in own:
                if isinstance(n, ast.Assign) and self._expr_tainted(n.value):
                    targets = n.targets
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)) \
                        and n.value is not None \
                        and self._expr_tainted(n.value):
                    targets = [n.target]
                elif isinstance(n, (ast.For, ast.comprehension)) \
                        and self._expr_tainted(n.iter):
                    targets = [n.target]
                else:
                    continue
                for t in targets:
                    self.tainted |= _bound_names(t)
            if len(self.tainted) == before:
                break
        stmts = [n for n in own if isinstance(n, ast.stmt)]
        for n in own:
            if isinstance(n, (ast.If, ast.While)):
                arms = list(n.body) + list(n.orelse)
                kind = "if" if isinstance(n, ast.If) else "while"
            elif isinstance(n, ast.IfExp):
                arms = [n.body, n.orelse]
                kind = "conditional expression"
            else:
                continue
            if not self._expr_tainted(n.test):
                continue
            hit = self._collectives_in(arms)
            if isinstance(n, ast.If) and any(
                    isinstance(x, (ast.Return, ast.Raise))
                    for x in _lexical(arms)):
                # an early exit decides whether what follows runs
                hit |= self._collectives_in(
                    [x for x in stmts if x.lineno > n.end_lineno])
            if not hit:
                continue
            self.out.append(Finding(
                "CY101", self.mod.path, n.test.lineno,
                f"`{kind}` on a rank-local device value "
                f"({self._how(n.test)}) decides whether collective(s) "
                f"{', '.join(sorted(hit))} run in "
                f"`{self.f.qual.rsplit('.', 1)[-1]}` — a process of the "
                f"group that takes the other arm skips them and its peers "
                f"hang",
                "branch on a value every process shares (a collective's "
                "result, a shape, a host argument), or issue the "
                "collective on every arm"))


def _self_call(module: str, qual: str) -> str:
    """``self.m`` / ``cls.m`` as the same-module function ``module.m``
    (the CY107/CY110 walk's resolution of method calls)."""
    if qual.startswith(("self.", "cls.")):
        return f"{module}.{qual.split('.', 1)[1]}"
    return qual


def _bound_names(target: ast.AST) -> Set[str]:
    """Names an assignment target binds: a name, or the names of a tuple
    or list target; a subscript or attribute target mutates an object
    and binds none."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in target.elts:
            out |= _bound_names(e)
        return out
    return set()


# ---------------------------------------------------------------------------
# remaining per-module rules
# ---------------------------------------------------------------------------


def _check_env_reads(mod: _Module) -> None:
    norm = mod.path.replace("\\", "/")
    if any(norm.endswith(suffix) for suffix in ENV_READ_ALLOWED):
        return
    for node in mod.nodes:
        dotted = None
        if isinstance(node, ast.Call):
            dotted = _resolve(_dotted(node.func), mod.aliases)
            if dotted not in ("os.environ.get", "os.getenv"):
                continue
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
            dotted = _resolve(_dotted(node.value), mod.aliases)
            if dotted != "os.environ":
                continue
        elif isinstance(node, ast.Compare):
            ok = any(_resolve(_dotted(c), mod.aliases) == "os.environ"
                     for c in node.comparators)
            if not (ok and any(isinstance(op, (ast.In, ast.NotIn))
                               for op in node.ops)):
                continue
            dotted = "os.environ"
        else:
            continue
        mod.findings.append(Finding(
            "CY102", mod.path, node.lineno,
            f"`{dotted}` read outside the knob registry",
            "declare the knob in cylon_tpu_torch.config.KNOBS and read it "
            "via config.knob()/knob_raw(); only config.py may touch "
            "os.environ"))


def _check_excepts(mod: _Module) -> None:
    for node in mod.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            mod.findings.append(Finding(
                "CY105", mod.path, node.lineno,
                "bare `except:` swallows Status classification (and "
                "KeyboardInterrupt/SystemExit)",
                "catch a concrete type, or `except Exception as e` and "
                "route e through Status.from_exception"))
            continue
        names = {t.id for t in ast.walk(node.type) if isinstance(t, ast.Name)}
        if not names & {"Exception", "BaseException"}:
            continue
        used = node.name and any(
            isinstance(n, ast.Name) and n.id == node.name
            for s in node.body for n in ast.walk(s))
        reraises = any(isinstance(n, ast.Raise)
                       for s in node.body for n in ast.walk(s))
        if not used and not reraises:
            mod.findings.append(Finding(
                "CY105", mod.path, node.lineno,
                "overbroad `except Exception` ignores the caught exception "
                "— the Status classification (OOM vs transient vs bug) is "
                "silently discarded",
                "bind it (`as e`) and classify via Status.from_exception, "
                "re-raise, or narrow the type"))


def _check_retries(prog: _Program, mod: _Module) -> None:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        final = (_dotted(node.func) or "").rsplit(".", 1)[-1]
        if final != "retry_call" or not node.args:
            continue
        policy_ok = False
        for kw in node.keywords:
            if kw.arg == "policy" and any(
                    isinstance(n, ast.Attribute)
                    and n.attr == "collective_retry_policy"
                    for n in ast.walk(kw.value)):
                policy_ok = True
        if policy_ok:
            continue
        target = node.args[0]
        hit: Set[str] = set()
        if isinstance(target, ast.Name) and target.id in mod.funcs:
            hit = prog.collective_reach(mod.funcs[target.id])
        elif isinstance(target, ast.Lambda):
            finals = {(_dotted(c.func) or "").rsplit(".", 1)[-1]
                      for c in ast.walk(target) if isinstance(c, ast.Call)}
            hit = finals & COLLECTIVE_NAMES
            for c in ast.walk(target):
                if isinstance(c, ast.Call):
                    d = _dotted(c.func)
                    if d and "." not in d and d in mod.funcs:
                        hit |= prog.collective_reach(mod.funcs[d])
        if hit:
            mod.findings.append(Finding(
                "CY104", mod.path, node.lineno,
                f"retry wrapper encloses collective(s) "
                f"{', '.join(sorted(hit))} — single-host re-entry desyncs "
                f"a multi-process mesh (the no-retry invariant)",
                "pass policy=ctx.collective_retry_policy() (no-retry on "
                "multi-process meshes) or move the collective out of the "
                "retried callable"))


def _check_plan_keys(prog: _Program, mod: _Module) -> None:
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        resolved = _resolve(dotted, mod.aliases)
        b = prog._builder_for(dotted, resolved, mod)
        if b is None or b.key_complete:
            continue
        if not (b.builder_key_idx is not None or b.builder_key_kw):
            continue
        # the cache key at this call site: positional, or passed as key=
        key_expr = None
        if (b.builder_key_idx is not None
                and len(node.args) > b.builder_key_idx):
            key_expr = node.args[b.builder_key_idx]
        if key_expr is None:
            for kw in node.keywords:
                if kw.arg == "key":
                    key_expr = kw.value
        if key_expr is None or len(node.args) <= b.builder_fn_idx:
            continue
        fn_arg = node.args[b.builder_fn_idx]
        if not isinstance(fn_arg, ast.Name) or fn_arg.id not in mod.funcs:
            continue
        knobs = {k for k in prog.knobs_of_built(mod, mod.funcs[fn_arg.id])
                 if k in _TRACE_KNOBS}
        if not knobs:
            continue
        covered: Set[str] = set()
        token = False
        for n in ast.walk(key_expr):
            if isinstance(n, ast.Call):
                d = _dotted(n.func) or ""
                fin = d.rsplit(".", 1)[-1]
                if fin == "trace_cache_token":
                    token = True
                k = _knob_of_call(n, mod.aliases, mod.name)
                if k:
                    covered.add(k)
            elif isinstance(n, ast.Name):
                # a name assigned from an accessor call in this module
                covered |= _names_bound_to_knobs(mod).get(n.id, set())
        missing = set() if token else knobs - covered
        if missing:
            mod.findings.append(Finding(
                "CY103", mod.path, node.lineno,
                f"cached callable's key omits trace-scope knob(s) "
                f"{', '.join(sorted(missing))} read inside "
                f"`{fn_arg.id}` — flipping the knob would serve a callable "
                f"built under the other setting (the "
                f"CYLON_TPU_SHUFFLE_PACK bug class)",
                "include the accessor value in the key tuple, or fold "
                "config.trace_cache_token() into the key inside the "
                "builder"))


def _check_realized_layout_keys(prog: _Program, mod: _Module) -> None:
    """CY109: a cached-callable builder call whose built callable closes
    over a value produced by a realized-layout producer
    (``plane.build_spec`` / ``estimate_spec`` — observed bit widths,
    dictionary sizes), while the cache-key expression at that call site
    never mentions the value.

    The invariant (the reference's stale-program bug class, on the
    port's callable cache): the compression spec is layout baked into
    the cached callable, but unlike a knob it changes with the DATA —
    ``trace_cache_token()`` cannot cover it, so a key-complete builder
    is not exempt.  Omitting it would decode a new value range under a
    stale callable's field layout: silently wrong bytes, not a crash."""
    bound = _names_bound_to_realized(mod)
    if not bound:
        return
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        resolved = _resolve(dotted, mod.aliases)
        b = prog._builder_for(dotted, resolved, mod)
        if b is None:
            continue
        if not (b.builder_key_idx is not None or b.builder_key_kw):
            continue
        key_expr = None
        if (b.builder_key_idx is not None
                and len(node.args) > b.builder_key_idx):
            key_expr = node.args[b.builder_key_idx]
        if key_expr is None:
            for kw in node.keywords:
                if kw.arg == "key":
                    key_expr = kw.value
        if key_expr is None or len(node.args) <= b.builder_fn_idx:
            continue
        fn_arg = node.args[b.builder_fn_idx]
        if not isinstance(fn_arg, ast.Name) or fn_arg.id not in mod.funcs:
            continue
        body = mod.funcs[fn_arg.id].node
        used = {n.id for n in ast.walk(body)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
        realized = used & set(bound)
        if not realized:
            continue
        covered: Set[str] = set()
        for n in ast.walk(key_expr):
            if isinstance(n, ast.Name):
                covered.add(n.id)
            elif isinstance(n, ast.Call):
                fin = (_dotted(n.func) or "").rsplit(".", 1)[-1]
                if fin in REALIZED_LAYOUT_PRODUCERS:
                    covered |= realized
        missing = realized - covered
        if missing:
            mod.findings.append(Finding(
                "CY109", mod.path, node.lineno,
                f"cached callable's key omits realized-data layout "
                f"value(s) {', '.join(sorted(missing))} baked into "
                f"`{fn_arg.id}` — a data change would decode under a stale "
                f"field layout (trace_cache_token cannot cover "
                f"data-derived specs)",
                "add the spec value to the key tuple at this call site; "
                "observed bit-widths/dictionary sizes are layout and must "
                "rebuild the callable when the data moves"))


def _names_bound_to_realized(mod: _Module) -> Dict[str, bool]:
    """Names assigned (anywhere in the module, nested functions included)
    from a realized-layout producer call."""
    cached = getattr(mod, "_realized_names", None)
    if cached is not None:
        return cached
    out: Dict[str, bool] = {}
    for node in mod.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fin = (_dotted(node.value.func) or "").rsplit(".", 1)[-1]
            if fin in REALIZED_LAYOUT_PRODUCERS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = True
    mod._realized_names = out  # type: ignore[attr-defined]
    return out


def _names_bound_to_knobs(mod: _Module) -> Dict[str, Set[str]]:
    cached = getattr(mod, "_knob_names", None)
    if cached is not None:
        return cached
    out: Dict[str, Set[str]] = {}
    for node in mod.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            k = _knob_of_call(node.value, mod.aliases, mod.name)
            if k:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(t.id, set()).add(k)
    mod._knob_names = out  # type: ignore[attr-defined]
    return out


def _check_elastic_guards(prog: _Program, mod: _Module) -> None:
    """CY106: an elastic recovery entry point (``cylon_tpu_torch.elastic``
    function named ``elastic_*``, or a reconnect/ride-through path —
    name containing ``reconnect``/``ride_out``) from which a collective
    is reachable must also reach an epoch guard
    (``ensure_epoch``/``epoch_guard``).

    The invariant behind it: after a membership change, re-issuing a
    collective derived from the OLD world desyncs whoever survived —
    the no-retry rule generalized to recovery control flow.  The
    check is reachability-level, not path-sensitive: a guard anywhere
    under the root satisfies it (the guard hook runs per pass, so
    lexical placement inside the loop is the engine's contract)."""
    if mod.name != ELASTIC_MODULE:
        return
    for f in mod.funcs.values():
        name = f.qual.rsplit(".", 1)[-1]
        if not _is_elastic_recovery_root(name):
            continue
        colls = prog.collective_reach(f)
        if not colls:
            continue
        guards: Set[str] = set()
        for q in prog.reachable(f):
            fn = prog.by_qual.get(q)
            if fn is not None:
                guards |= fn.call_finals & EPOCH_GUARD_NAMES
        if not guards:
            mod.findings.append(Finding(
                "CY106", mod.path, f.lineno,
                f"elastic recovery path `{name}` reaches collective(s) "
                f"{', '.join(sorted(colls))} with no epoch guard — after "
                f"a membership change the collective would be issued "
                f"against the old world and desync the survivors",
                "call agent.ensure_epoch(epoch) (or install it as the "
                "engine's pass_guard) before dispatching work on the "
                "recovery path"))


def _check_serve_blocking(prog: _Program, mod: _Module) -> None:
    """CY107: a serve-layer control-path root (``submit`` / ``cancel`` /
    ``drain`` / ``_dispatch*`` / ``_admit*`` / ``_shed*`` / ``_cancel*``
    in any module under ``cylon_tpu_torch.serve``) from which a blocking
    device call is reachable.

    The invariant: admission, shedding, cancellation and dispatch
    decisions run on caller threads and the scheduler tick — if any of
    them waits on the device, a wedged query stops the service from
    SHEDDING, which is the exact hang the serving layer exists to
    prevent.  Device work belongs in the executor (``_run_ticket``)
    only.  Reachability resolves ``self.X`` calls against same-module
    functions so class methods participate in the walk."""
    if not mod.name.startswith(SERVE_MODULE_PREFIX):
        return
    for f in mod.funcs.values():
        name = f.qual.rsplit(".", 1)[-1]
        if not (name in SERVE_CONTROL_ROOTS
                or name.startswith(SERVE_CONTROL_PREFIXES)):
            continue
        hit = _blocking_device_reach(prog, f)
        if hit:
            mod.findings.append(Finding(
                "CY107", mod.path, f.lineno,
                f"serve control path `{name}` reaches blocking device "
                f"call(s) {', '.join(sorted(hit))} — a wedged device "
                f"would stop the service from admitting or shedding",
                "move the device work into the executor (_run_ticket); "
                "admission/dispatch decisions must be host-only"))


def _blocking_device_reach(prog: _Program, f: _Func) -> Set[str]:
    """Blocking device calls reachable from ``f`` (the CY107/CY110
    shared walk): ``self.X``/``cls.X`` calls resolve against
    same-module functions so class methods participate."""
    seen: Set[str] = set()
    stack = [f.qual]
    hit: Set[str] = set()
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        fn = prog.by_qual.get(q)
        if fn is None or fn.module in HOST_ONLY_MODULES:
            continue
        hit |= fn.call_finals & BLOCKING_DEVICE_NAMES
        for c in fn.calls:
            if c.startswith(("self.", "cls.")):
                c = f"{fn.module}.{c.split('.', 1)[1]}"
            stack.append(c)
    return hit


def _check_router_blocking(prog: _Program, mod: _Module) -> None:
    """CY110: a router control-path root (``route`` / ``_place*`` /
    ``_reroute*`` / ``_proxy*`` / ``_route*`` / ``_shed*`` /
    ``_handle*`` / ``_on_replica*`` in any module under
    ``cylon_tpu_torch.router``) from which a blocking device call is
    reachable — the CY107 root-set mechanism extended one tier up.

    The invariant: placement, admission, re-route decisions and every
    verb handler (heartbeats feed the routing table) run on router
    threads that the WHOLE fleet's requests share.  A blocking device
    call reachable from any of them means one wedged replica's device
    can stall routing for every tenant on every healthy replica — the
    exact failure isolation the router tier exists to provide.  Device
    work belongs on the replicas, behind the proxy verbs."""
    if not mod.name.startswith(ROUTER_MODULE_PREFIX):
        return
    for f in mod.funcs.values():
        name = f.qual.rsplit(".", 1)[-1]
        if not (name in ROUTER_CONTROL_ROOTS
                or name.startswith(ROUTER_CONTROL_PREFIXES)):
            continue
        hit = _blocking_device_reach(prog, f)
        if hit:
            mod.findings.append(Finding(
                "CY110", mod.path, f.lineno,
                f"router control path `{name}` reaches blocking device "
                f"call(s) {', '.join(sorted(hit))} — one wedged "
                f"replica's device would stall placement for the whole "
                f"fleet",
                "device work belongs on the replicas behind the proxy "
                "verbs; route/placement/reroute decisions must be "
                "host-only"))


def _lock_ctx_name(item: ast.withitem) -> Optional[str]:
    """The dotted name of a with-item whose final attribute names a
    lock (``self._router_lock``, ``self._lock``, ``some_lock``), else
    None.  Matching is lexical by design: the placement and membership
    locks are attributes, never passed around, so the name IS the
    identity — and a lock-protocol object hidden behind a non-lock name
    is its own review finding, not this rule's."""
    expr = item.context_expr
    if isinstance(expr, ast.Call):
        expr = expr.func
    dotted = _dotted(expr)
    if dotted and "lock" in dotted.rsplit(".", 1)[-1].lower():
        return dotted
    return None


def _calls_in_block(body: Sequence[ast.AST], mod: _Module):
    """(resolved quals, final identifiers) of calls LEXICALLY inside
    the statements — nested function/lambda bodies are skipped (they
    run later, not under the lock)."""
    quals: Set[str] = set()
    finals: Set[str] = set()
    stack: List[ast.AST] = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            dotted = _dotted(n.func)
            resolved = _resolve(dotted, mod.aliases)
            final = (dotted or "").rsplit(".", 1)[-1]
            if final:
                finals.add(final)
            if dotted and "." not in dotted:
                quals.add(f"{mod.name}.{dotted}")
            elif resolved:
                quals.add(resolved)
        stack.extend(ast.iter_child_nodes(n))
    return quals, finals


def _lock_held_blocking_reach(prog: _Program, module: str,
                              quals: Set[str],
                              finals: Set[str]) -> Set[str]:
    """Blocking-under-lock calls reachable from a with-lock body: the
    CY110 walk (self/cls resolution, host-only barriers) re-aimed at
    the RPC/fsync final set, seeded from the block's lexical calls."""
    hit: Set[str] = set(finals & LOCK_HELD_BLOCKING_NAMES)
    seen: Set[str] = set()
    stack: List[str] = []
    for c in quals:
        if c.startswith(("self.", "cls.")):
            c = f"{module}.{c.split('.', 1)[1]}"
        stack.append(c)
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        fn = prog.by_qual.get(q)
        if fn is None or fn.module in HOST_ONLY_MODULES:
            continue
        hit |= fn.call_finals & LOCK_HELD_BLOCKING_NAMES
        for c in fn.calls:
            if c.startswith(("self.", "cls.")):
                c = f"{fn.module}.{c.split('.', 1)[1]}"
            stack.append(c)
    return hit


def _check_lock_held_blocking(prog: _Program, mod: _Module) -> None:
    """CY111: a ``with <lock>:`` body in the router tier or the
    durable journal from which a blocking control-plane RPC
    (``request``) or an ``fsync`` is reachable — the CY110 walk turned
    inward, at lock-held regions instead of control-path roots.

    The invariant: the placement lock (``_router_lock``) and the
    inherited membership lock (``_lock``) serialize EVERY routing
    decision; the hedge/breaker/GC-lease paths take them on every
    request.  An RPC or an fsync issued while one is
    held converts one slow peer or one slow disk into a fleet-wide
    placement stall — breaker transitions and lease bookkeeping must
    be host-only dict flips, with the blocking work outside the
    ``with``."""
    if not mod.name.startswith(CY111_MODULE_PREFIXES):
        return
    for f in mod.funcs.values():
        # lexical With scan that does NOT descend into nested defs —
        # each nested def is its own _Func and scans its own body
        stack: List[ast.AST] = (list(ast.iter_child_nodes(f.node))
                                if isinstance(
                                    f.node,
                                    (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) else [])
        withs: List[ast.With] = []
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, (ast.With, ast.AsyncWith)):
                withs.append(n)
            stack.extend(ast.iter_child_nodes(n))
        for w in withs:
            locks = [nm for nm in (_lock_ctx_name(i) for i in w.items)
                     if nm]
            if not locks:
                continue
            quals, finals = _calls_in_block(w.body, mod)
            hit = _lock_held_blocking_reach(prog, f.module, quals,
                                            finals)
            if hit:
                name = f.qual.rsplit(".", 1)[-1]
                mod.findings.append(Finding(
                    "CY111", mod.path, w.lineno,
                    f"`with {locks[0]}:` in `{name}` reaches blocking "
                    f"call(s) {', '.join(sorted(hit))} while the lock "
                    f"is held — one slow peer or disk would stall "
                    f"every routing decision behind it",
                    "do the RPC/fsync outside the with block; "
                    "lock-held regions must be host-only dict flips "
                    "(snapshot under the lock, block after release)"))


def _check_plan_fingerprint(prog: _Program, mod: _Module) -> None:
    """CY108: a plan-optimizer rule or executor path (module under
    ``cylon_tpu_torch.plan``; roots ``optimize``/``execute``/``run_service``
    or ``_rule_*``/``_exec*``/``_fused*``/``_lower*``/``_stage*``)
    from which a TRACE-scope knob read is reachable, while no plan
    fingerprint builder (a ``*fingerprint*`` function under the plan
    package) reaches ``trace_cache_token``.

    The invariant: the plan fingerprint is the durable-journal / serve
    result-cache key for WHOLE planned runs.  A trace knob changes the
    traced computation, hence the cached result — if the executor can
    see the knob but the fingerprint cannot, flipping it replays a
    stale result from spill.  The fix is structural (cover all trace
    knobs via config.trace_cache_token() in the fingerprint), so the
    check is package-level: one complete fingerprint builder clears
    every root."""
    if not mod.name.startswith(PLAN_MODULE_PREFIX):
        return
    roots = [f for f in mod.funcs.values()
             if f.qual.rsplit(".", 1)[-1] in PLAN_ROOT_NAMES
             or f.qual.rsplit(".", 1)[-1].startswith(PLAN_ROOT_PREFIXES)]
    hot = []
    for f in roots:
        knobs = {k for k in prog.knobs_of(f) if k in _TRACE_KNOBS}
        if knobs:
            hot.append((f, knobs))
    if not hot:
        return
    complete = False
    for f in prog.by_qual.values():
        if not f.module.startswith(PLAN_MODULE_PREFIX):
            continue
        if PLAN_FP_TOKEN not in f.qual.rsplit(".", 1)[-1]:
            continue
        for q in prog.reachable(f):
            fn = prog.by_qual.get(q)
            if fn is not None and "trace_cache_token" in fn.call_finals:
                complete = True
                break
        if complete:
            break
    if complete:
        return
    for f, knobs in hot:
        mod.findings.append(Finding(
            "CY108", mod.path, f.lineno,
            f"plan path `{f.qual.rsplit('.', 1)[-1]}` reads trace-scope "
            f"knob(s) {', '.join(sorted(knobs))} but no plan fingerprint "
            f"builder covers the trace-knob vector — flipping the knob "
            f"would replay a stale cached plan result",
            "hash config.trace_cache_token() into the plan fingerprint "
            "(durable.run_fingerprint already does) or stop reading the "
            "knob on the optimizer/executor path"))


def _check_adaptive_fingerprint(prog: _Program, mod: _Module) -> None:
    """CY112: an optimizer rule or planner root (module under
    ``cylon_tpu_torch.plan``; roots ``optimize``/``execute``/``run_service``
    or ``_rule_*``) from which an observed-statistics read
    (``lookup_stats``/``column_stats``) is reachable, while no plan
    fingerprint builder (a ``*fingerprint*`` function under the plan
    package) reaches ``strategy_spec``.

    The invariant: a strategy the planner picked FROM statistics
    changes the physical program, so it must ride the plan fingerprint
    — the durable-journal / serve result-cache key.  If the rule can
    see the catalog but the fingerprint cannot see the choice, a
    catalog update flips the strategy under an unchanged key and the
    cache replays the other strategy's program.  Like CY108 the fix is
    structural (fold optimizer.strategy_spec(phys) into the fingerprint
    header), so one complete fingerprint builder clears every root
    package-wide."""
    if not mod.name.startswith(PLAN_MODULE_PREFIX):
        return
    roots = [f for f in mod.funcs.values()
             if f.qual.rsplit(".", 1)[-1] in PLAN_ROOT_NAMES
             or f.qual.rsplit(".", 1)[-1].startswith("_rule_")]
    hot = []
    for f in roots:
        reads: Set[str] = set()
        for q in prog.reachable(f):
            fn = prog.by_qual.get(q)
            if fn is not None:
                reads |= fn.call_finals & ADAPTIVE_STATS_READS
        if reads:
            hot.append((f, reads))
    if not hot:
        return
    folded = False
    for f in prog.by_qual.values():
        if not f.module.startswith(PLAN_MODULE_PREFIX):
            continue
        if PLAN_FP_TOKEN not in f.qual.rsplit(".", 1)[-1]:
            continue
        for q in prog.reachable(f):
            fn = prog.by_qual.get(q)
            if fn is not None and STRATEGY_FOLD_TOKEN in fn.call_finals:
                folded = True
                break
        if folded:
            break
    if folded:
        return
    for f, reads in hot:
        mod.findings.append(Finding(
            "CY112", mod.path, f.lineno,
            f"planner path `{f.qual.rsplit('.', 1)[-1]}` reads observed "
            f"statistics ({', '.join(sorted(reads))}) but no plan "
            f"fingerprint builder folds the strategy choice — a catalog "
            f"update would flip the physical strategy under an unchanged "
            f"cache key",
            "fold optimizer.strategy_spec(phys) into the fingerprint "
            "header (LogicalPlan.fingerprint already shows the shape) or "
            "stop steering on catalog statistics in this rule"))


def _check_state_version(prog: _Program, mod: _Module) -> None:
    """CY116: a stream-package function (module under
    ``cylon_tpu_torch.stream``) that lexically decodes a persisted spill
    (``load_pass`` / ``frame_from_ipc_bytes`` in its own calls) without
    lexically calling ``require_state_version``.

    The invariant: persisted partial-aggregate state is a layout
    contract, not just bytes — the spill checksum (durable.py) proves
    integrity, the schema version proves INTERPRETABILITY.  Requiring
    the gate in the SAME function as the decode (not merely reachable
    from it) is deliberate: a reachable-guard rule goes quiet when a
    distant caller validates, and then a refactor that lifts the decode
    into a new helper silently drops the guard.  Lexical pairing makes
    the discipline survive refactors."""
    if not mod.name.startswith(STREAM_MODULE_PREFIX):
        return
    for f in mod.funcs.values():
        decodes = f.call_finals & STATE_DECODE_NAMES
        if not decodes:
            continue
        if STATE_VERSION_GUARD in f.call_finals:
            continue
        mod.findings.append(Finding(
            "CY116", mod.path, f.lineno,
            f"`{f.qual.rsplit('.', 1)[-1]}` decodes persisted stream "
            f"state ({', '.join(sorted(decodes))}) without validating "
            f"the state schema version — a combine-layout change would "
            f"silently misread old spills (intact bytes, moved meaning)",
            f"call stream.state.{STATE_VERSION_GUARD}(...) on the "
            f"spill's pass provenance in this function, BEFORE the "
            f"decode"))


def _own_nodes(f: _Func) -> Iterable[ast.AST]:
    """The nodes lexically belonging to ONE function, skipping nested
    def/lambda bodies (they carry their own _Func) — the same scoping
    _FuncScanner applies to ``call_finals``."""
    stack: List[ast.AST] = [f.node]
    while stack:
        n = stack.pop()
        if n is not f.node and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _reads_spill_bytes(f: _Func) -> bool:
    """Lexical evidence of a raw spill read: a binary-mode ``open``
    AND an ``.arrow`` string constant in the same function body."""
    has_suffix = bin_open = False
    for n in _own_nodes(f):
        if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and SPILL_SUFFIX in n.value):
            has_suffix = True
        elif isinstance(n, ast.Call):
            if (_dotted(n.func) or "").rsplit(".", 1)[-1] != "open":
                continue
            mode = None
            if len(n.args) >= 2 and isinstance(n.args[1], ast.Constant):
                mode = n.args[1].value
            for kw in n.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if (isinstance(mode, str) and "b" in mode
                    and ("r" in mode or "+" in mode)):
                bin_open = True
        if has_suffix and bin_open:
            return True
    return False


def _check_spill_reads(prog: _Program, mod: _Module) -> None:
    """CY117: see the SPILL_* constants block — any package function
    that lexically reads persisted ``.arrow`` spill bytes (raw binary
    open, or the IPC decode) without lexically verifying a checksum."""
    if (not mod.name.startswith(PACKAGE)
            or mod.name in SPILL_EXEMPT_MODULES):
        return
    for f in mod.funcs.values():
        if f.call_finals & SPILL_VERIFY_NAMES:
            continue
        if SPILL_DECODE_NAME in f.call_finals:
            how = f"decodes spill IPC bytes ({SPILL_DECODE_NAME})"
        elif _reads_spill_bytes(f):
            how = "reads .arrow spill bytes with a binary-mode open"
        else:
            continue
        mod.findings.append(Finding(
            "CY117", mod.path, f.lineno,
            f"`{f.qual.rsplit('.', 1)[-1]}` {how} without verifying a "
            f"checksum — silent bitrot in a persisted spill would be "
            f"served as truth instead of triggering read-repair or "
            f"quarantine",
            f"verify hashlib.sha256 against the manifest entry in THIS "
            f"function, or go through a verifying loader "
            f"({', '.join(sorted(SPILL_VERIFY_NAMES - {'sha256'}))})"))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _iter_py_files(paths: Iterable[str]) -> List[str]:
    import os as _os

    files: List[str] = []
    for p in paths:
        if _os.path.isdir(p):
            for root, dirs, names in _os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                files.extend(_os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def parse_paths(paths: Sequence[str]) -> List["_Module"]:
    """The .py files under ``paths``, parsed (a file that does not parse
    is left out)."""
    return [m for m in (_parse_module(f) for f in _iter_py_files(paths))
            if m is not None]


def scan_paths(paths: Sequence[str]) -> List[Finding]:
    """Run every level-1 rule over the .py files under ``paths`` and
    return surviving (non-suppressed) findings sorted by location."""
    return scan_modules(parse_paths(paths))


def scan_modules(modules: Sequence["_Module"]) -> List[Finding]:
    """``scan_paths`` over modules ``parse_paths`` returned, each scanned
    once."""
    prog = _Program(modules)

    for mod in modules:
        _check_env_reads(mod)
        _check_excepts(mod)
        _check_retries(prog, mod)
        _check_plan_keys(prog, mod)
        _check_realized_layout_keys(prog, mod)
        _check_elastic_guards(prog, mod)
        _check_serve_blocking(prog, mod)
        _check_router_blocking(prog, mod)
        _check_lock_held_blocking(prog, mod)
        _check_plan_fingerprint(prog, mod)
        _check_adaptive_fingerprint(prog, mod)
        _check_state_version(prog, mod)
        _check_spill_reads(prog, mod)
        for f in mod.all_funcs:
            _RankLocal(f, mod, prog, mod.findings).run()

    # level 3 (concurrency): lock-order graph, blocking-under-lock,
    # cross-thread shared state — class-aware, so it runs its own pass
    from . import locks as _locks

    _locks.check_concurrency(modules)

    out: List[Finding] = []
    for mod in modules:
        for fd in mod.findings:
            sup = mod.suppressions.get(fd.line, ())
            if fd.rule in sup and fd.rule != "CY001":
                continue
            out.append(fd)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))
