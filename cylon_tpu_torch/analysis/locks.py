"""Level-3 (concurrency) rules of cylint, plus the lock-order golden.

The port's copy of ``cylon_tpu/analysis/locks.py``, over
``cylon_tpu_torch/``: its lock ids are ``cylon_tpu_torch.*`` qualnames,
its site keys ``cylon_tpu_torch/...py:line``, the ``JsonServer`` handler
root is ``cylon_tpu_torch.net.control``'s, and the smoke drives the
port's ``QueryService`` (on the context it is given: the CPU in tests,
the card in ``chip_smoke.py``), ``Coordinator``/``Agent`` and
``QueryRouter``.

Pure-stdlib AST analysis over the package's threading surface — the
multi-threaded host control plane (elastic coordinator/agents, the serve
scheduler, the router's placement paths, deadline watchdogs, flight
flushes).  Three rules:

- **CY113** — lock-order hazard: the acquires-while-holding digraph over
  every discovered ``threading.Lock``/``RLock``/``Condition`` attribute
  has a cycle (two code paths take the same pair of locks in opposite
  orders ⇒ potential deadlock), or a non-reentrant lock is re-entered
  lexically.
- **CY114** — blocking-under-lock: ``time.sleep``, ``Thread.join``, an
  unbounded ``queue.get`` or a ``Condition.wait`` that cannot release a
  *different* held lock, reachable (lexically or through the call graph)
  while a discovered lock is held.  Generalizes CY111 (RPC/fsync in the
  router/durable tier) to the whole package and all blocking primitives.
- **CY115** — cross-thread shared state: an instance attribute written
  from ≥2 distinct thread roots (``Thread(target=)``, ``Timer``, the
  ``JsonServer`` handler loop, plus the public caller surface) with no
  common guarding lock across every write path.

The analysis is class-aware (astlint's function table flattens methods):
lock identity is ``module.Class.attr`` resolved through single-package
inheritance (``QueryRouter`` takes ``Coordinator._lock``), method calls
resolve through ``self.``/``cls.``/``super().``, constructor-typed
attributes (``self._log = CoordLog(...)`` ⇒ ``self._log.append_many()``
resolves into ``CoordLog``) and constructor-typed locals.  Held-lock
sets propagate two ways: lexically down ``with`` bodies, and a
must-hold-at-entry fixpoint (the intersection over all resolved call
sites) so ``*_locked`` helpers inherit their callers' locks.  Nested
``def``/``lambda`` bodies are skipped (their call time is not their
definition time).

The **runtime twin** (budgets.py-style): :func:`record_locks` monkey-
patches the ``threading`` lock factories so every acquisition records
(held → acquired) edges keyed by each lock's *creation site*, which maps
back to the static inventory (the ``self._x = threading.Lock()`` line).
The merged DAG observed while the elastic/serve/router smokes run is
committed as ``analysis/lockgraph/lock_order.json``; the static graph
must cover every observed edge, a new observed edge fails (CY204) until
``python -m cylon_tpu_torch.analysis --write-lockgraph`` regenerates, and
static-only edges ride the golden informationally.
"""
from __future__ import annotations

import ast
import contextlib
import json
import os as _os
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Set, Tuple

from .astlint import PACKAGE, Finding, _Module, _dotted, _resolve

#: lock-constructor finals -> lock kind (reentrancy matters for CY113
#: self-edges: re-entering an RLock is legal, a Lock self-deadlocks)
_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

#: constructor quals that spawn a thread running a stored callable; the
#: value is the positional index of that callable (JsonServer(handler)
#: calls it from per-connection server threads — a thread root every
#: verb handler runs under)
_HANDLER_CLASSES = {"cylon_tpu_torch.net.control.JsonServer": 0}

#: the implicit thread root covering the class's public entry points
_CALLER_ROOT = "caller"


def _site(path: str, line: int) -> str:
    """Stable creation/witness-site key: path from ``cylon_tpu_torch``
    down plus the line — identical for the static scan (repo-relative or
    absolute paths) and the runtime recorder (module ``__file__``)."""
    parts = path.replace("\\", "/").split("/")
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
    else:
        parts = parts[-1:]
    return "/".join(parts) + f":{line}"


# ---------------------------------------------------------------------------
# inventory: classes, locks, typed attributes, spawn sites
# ---------------------------------------------------------------------------


@dataclass
class _Class:
    qual: str                       # module.ClassName
    module: str
    path: str
    bases: List[str] = field(default_factory=list)   # resolved quals
    locks: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    #                                 attr -> (kind, creation line)
    attr_types: Dict[str, str] = field(default_factory=dict)
    #                                 attr -> constructor qual
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    spawns: List[Tuple[str, int]] = field(default_factory=list)
    #                                 (target method name, line)


@dataclass
class _LFunc:
    qual: str                       # module.Class.meth | module.func
    module: str
    path: str
    cls: Optional[_Class]
    name: str
    lineno: int
    # (lock id, line, held-at-acquisition)
    acquisitions: List[Tuple[str, int, FrozenSet[str]]] = \
        field(default_factory=list)
    # (callee qual, line, lexical held)
    calls: List[Tuple[str, int, FrozenSet[str]]] = field(default_factory=list)
    # (kind, detail, line, lexical held); kind in sleep|join|wait|get
    blocking: List[Tuple[str, str, int, FrozenSet[str]]] = \
        field(default_factory=list)
    # (attr, line, lexical held)
    writes: List[Tuple[str, int, FrozenSet[str]]] = field(default_factory=list)


class _Inventory:
    """Phase-1 result over a module set: class registry, module-level
    locks, and the per-function concurrency facts."""

    def __init__(self) -> None:
        self.classes: Dict[str, _Class] = {}
        self.mod_locks: Dict[str, Tuple[str, int, str]] = {}
        #                 module.NAME -> (kind, line, path)
        self.funcs: Dict[str, _LFunc] = {}
        self.sites: Dict[str, str] = {}     # creation site -> lock id

    def mro(self, cls: _Class) -> List[_Class]:
        out, stack, seen = [], [cls], set()
        while stack:
            c = stack.pop(0)
            if c.qual in seen:
                continue
            seen.add(c.qual)
            out.append(c)
            stack.extend(self.classes[b] for b in c.bases
                         if b in self.classes)
        return out

    def lock_of(self, cls: Optional[_Class], attr: str) \
            -> Optional[Tuple[str, str]]:
        """(lock id, kind) for ``self.<attr>`` resolved through the MRO
        — identity is the *defining* class's qual."""
        if cls is None:
            return None
        for c in self.mro(cls):
            if attr in c.locks:
                kind, _line = c.locks[attr]
                return f"{c.qual}.{attr}", kind
        return None

    def attr_type(self, cls: Optional[_Class], attr: str) -> Optional[str]:
        if cls is None:
            return None
        for c in self.mro(cls):
            if attr in c.attr_types:
                return c.attr_types[attr]
        return None

    def method_qual(self, cls: Optional[_Class], name: str,
                    skip_self: bool = False) -> Optional[str]:
        if cls is None:
            return None
        for c in self.mro(cls)[(1 if skip_self else 0):]:
            if name in c.methods:
                return f"{c.qual}.{name}"
        return None


def _ctor_qual(call: ast.Call, mod: _Module) -> Optional[str]:
    d = _dotted(call.func)
    if not d:
        return None
    if d.split(".", 1)[0] not in mod.aliases:
        # head is a module-local name (a class defined here, or a
        # classmethod factory on one): qualify it so cross-reference
        # against the class registry works
        return f"{mod.name}.{d}"
    return _resolve(d, mod.aliases)


def _lock_kind_of_call(call: ast.Call, mod: _Module) -> Optional[str]:
    """'lock'/'rlock'/'condition' when the call constructs a threading
    lock (``threading.Lock()``, aliased or from-imported)."""
    d = _dotted(call.func) or ""
    final = d.rsplit(".", 1)[-1]
    if final not in _LOCK_CTORS:
        return None
    r = _resolve(d, mod.aliases) or d
    if r.startswith("threading.") or r in _LOCK_CTORS:
        # a Condition(existing_lock) aliases that lock's identity for
        # ordering purposes; still inventoried under its own attr
        return _LOCK_CTORS[final]
    return None


def _collect_classes(mod: _Module, inv: _Inventory) -> None:
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign,)) and isinstance(
                node.value, ast.Call):
            kind = _lock_kind_of_call(node.value, mod)
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lid = f"{mod.name}.{t.id}"
                        inv.mod_locks[lid] = (kind, node.lineno, mod.path)
                        inv.sites[_site(mod.path, node.lineno)] = lid
        if not isinstance(node, ast.ClassDef):
            continue
        cls = _Class(qual=f"{mod.name}.{node.name}", module=mod.name,
                     path=mod.path)
        for b in node.bases:
            r = _resolve(_dotted(b), mod.aliases)
            if r and "." not in r:
                r = f"{mod.name}.{r}"
            if r:
                cls.bases.append(r)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[item.name] = item
        # attribute facts from every method body (locks are usually
        # minted in __init__, but watchdog timers re-arm in start())
        for meth in cls.methods.values():
            for n in ast.walk(meth):
                if not (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)):
                    continue
                for t in n.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    kind = _lock_kind_of_call(n.value, mod)
                    if kind:
                        cls.locks.setdefault(t.attr, (kind, n.lineno))
                        inv.sites[_site(mod.path, n.lineno)] = \
                            f"{cls.qual}.{t.attr}"
                        continue
                    ctor = _ctor_qual(n.value, mod)
                    if ctor:
                        cls.attr_types.setdefault(t.attr, ctor)
        inv.classes[cls.qual] = cls


# ---------------------------------------------------------------------------
# per-function lexical walk
# ---------------------------------------------------------------------------


_BODY_FIELDS = ("body", "orelse", "finalbody")


class _Ctx:
    def __init__(self, inv: _Inventory, mod: _Module, cls: Optional[_Class],
                 fn: _LFunc):
        self.inv, self.mod, self.cls, self.fn = inv, mod, cls, fn
        self.local_types: Dict[str, str] = {}

    def lock_id(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        d = _dotted(expr)
        if not d:
            return None
        if d.startswith(("self.", "cls.")) and d.count(".") == 1:
            return self.inv.lock_of(self.cls, d.split(".", 1)[1])
        if "." not in d:
            lid = f"{self.mod.name}.{d}"
            if lid in self.inv.mod_locks:
                return lid, self.inv.mod_locks[lid][0]
        r = _resolve(d, self.mod.aliases)
        if r in self.inv.mod_locks:
            return r, self.inv.mod_locks[r][0]
        return None

    def type_of(self, expr: ast.AST) -> Optional[str]:
        d = _dotted(expr)
        if not d:
            return None
        if d.startswith(("self.", "cls.")) and d.count(".") == 1:
            return self.inv.attr_type(self.cls, d.split(".", 1)[1])
        if "." not in d:
            return self.local_types.get(d)
        return None

    def _as_class(self, t: Optional[str]) -> Optional[str]:
        """Normalize a constructor qual to a class qual: a direct
        ``Class(...)`` or a classmethod factory ``Class.open(...)``
        (the value is an instance of the class either way)."""
        if t is None:
            return None
        if t in self.inv.classes:
            return t
        head = t.rpartition(".")[0]
        return head if head in self.inv.classes else None

    def callee(self, call: ast.Call) -> Optional[str]:
        f = call.func
        # super().m(...)
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call)
                and isinstance(f.value.func, ast.Name)
                and f.value.func.id == "super"):
            return self.inv.method_qual(self.cls, f.attr, skip_self=True)
        d = _dotted(f)
        if not d:
            return None
        if d.startswith(("self.", "cls.")):
            rest = d.split(".", 1)[1]
            if "." not in rest:
                return self.inv.method_qual(self.cls, rest)
            attr, meth = rest.split(".", 1)
            if "." not in meth:
                t = self._as_class(self.inv.attr_type(self.cls, attr))
                if t is not None:
                    return self.inv.method_qual(self.inv.classes[t], meth)
            return None
        if "." not in d:
            return f"{self.mod.name}.{d}"
        head, _, meth = d.rpartition(".")
        t = self._as_class(self.local_types.get(head)) \
            if "." not in head else None
        if t is not None and "." not in meth:
            return self.inv.method_qual(self.inv.classes[t], meth)
        return _resolve(d, self.mod.aliases)


def _is_unbounded_get(call: ast.Call) -> bool:
    for a in call.args[:2]:
        if isinstance(a, ast.Constant) and a.value is False:
            return False
    if len(call.args) >= 2:
        return False
    for kw in call.keywords:
        if kw.arg == "timeout":
            return False
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return False
    return True


def _classify_blocking(call: ast.Call, ctx: _Ctx) \
        -> Optional[Tuple[str, str]]:
    """(kind, detail) when the call blocks the thread: time.sleep,
    Thread/Timer.join, unbounded queue.get, Condition.wait/wait_for.
    ``detail`` carries the condition's lock id for the wrong-lock test."""
    d = _dotted(call.func) or ""
    final = d.rsplit(".", 1)[-1]
    if final == "sleep":
        r = _resolve(d, ctx.mod.aliases) or d
        if r == "time.sleep":
            return "sleep", "time.sleep"
        return None
    if final in ("wait", "wait_for") and isinstance(call.func,
                                                    ast.Attribute):
        lk = ctx.lock_id(call.func.value)
        if lk and lk[1] == "condition":
            return "wait", lk[0]
        return None
    if final == "join" and isinstance(call.func, ast.Attribute):
        t = ctx.type_of(call.func.value)
        if t in ("threading.Thread", "threading.Timer"):
            return "join", f"{t.rsplit('.', 1)[-1]}.join"
        return None
    if final == "get" and isinstance(call.func, ast.Attribute):
        t = ctx.type_of(call.func.value)
        if t == "queue.Queue" and _is_unbounded_get(call):
            return "get", "queue.Queue.get"
    return None


def _scan_func(node: ast.AST, ctx: _Ctx) -> None:
    fn = ctx.fn

    def note_acquire(lid: str, line: int, held: List[str]) -> None:
        fn.acquisitions.append((lid, line, frozenset(held)))

    def expr_walk(n: ast.AST, held: List[str]) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            return
        if isinstance(n, ast.Call):
            # constructor-typed locals ride Assign below; spawns here
            ctor = _ctor_qual(n, ctx.mod)
            if ctor in ("threading.Thread", "threading.Timer") \
                    or ctor in _HANDLER_CLASSES:
                target = None
                if ctor == "threading.Thread" or ctor in _HANDLER_CLASSES:
                    idx = _HANDLER_CLASSES.get(ctor, None)
                    for kw in n.keywords:
                        if kw.arg == "target":
                            target = _dotted(kw.value)
                    if target is None and idx is not None \
                            and len(n.args) > idx:
                        target = _dotted(n.args[idx])
                elif len(n.args) >= 2:
                    target = _dotted(n.args[1])
                if target and target.startswith(("self.", "cls.")) \
                        and target.count(".") == 1 and ctx.cls is not None:
                    ctx.cls.spawns.append((target.split(".", 1)[1],
                                           n.lineno))
            blk = _classify_blocking(n, ctx)
            if blk:
                fn.blocking.append((blk[0], blk[1], n.lineno,
                                    frozenset(held)))
            q = ctx.callee(n)
            if q:
                fn.calls.append((q, n.lineno, frozenset(held)))
        for c in ast.iter_child_nodes(n):
            expr_walk(c, held)

    def note_write(target: ast.AST, line: int, held: List[str]) -> None:
        t = target
        while isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                note_write(e, line, held)
            return
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == "self":
            fn.writes.append((t.attr, line, frozenset(held)))

    def scan_stmts(stmts: Sequence[ast.stmt], held0: List[str]) -> None:
        held = list(held0)
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in st.items:
                    expr_walk(item.context_expr, inner)
                    lk = ctx.lock_id(item.context_expr)
                    if lk:
                        note_acquire(lk[0], st.lineno, inner)
                        inner.append(lk[0])
                scan_stmts(st.body, inner)
                continue
            # bare acquire()/release() lexical tracking
            call = None
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                call = st.value
            elif isinstance(st, ast.Assign) and isinstance(st.value,
                                                           ast.Call):
                call = st.value
            if call is not None and isinstance(call.func, ast.Attribute) \
                    and call.func.attr in ("acquire", "release"):
                lk = ctx.lock_id(call.func.value)
                if lk:
                    if call.func.attr == "acquire":
                        note_acquire(lk[0], st.lineno, held)
                        held.append(lk[0])
                    elif lk[0] in held:
                        held.remove(lk[0])
                    if isinstance(st, ast.Assign):
                        for t in st.targets:
                            note_write(t, st.lineno, held)
                    continue
            if isinstance(st, ast.Assign):
                if isinstance(st.value, ast.Call):
                    ctor = _ctor_qual(st.value, ctx.mod)
                    if ctor:
                        for t in st.targets:
                            if isinstance(t, ast.Name):
                                ctx.local_types[t.id] = ctor
                for t in st.targets:
                    note_write(t, st.lineno, held)
            elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
                if st.target is not None:
                    note_write(st.target, st.lineno, held)
            # walk this statement's expressions (not its nested bodies)
            for name, val in ast.iter_fields(st):
                if name in _BODY_FIELDS or name == "handlers":
                    continue
                if isinstance(val, ast.AST):
                    expr_walk(val, held)
                elif isinstance(val, list):
                    for v in val:
                        if isinstance(v, ast.AST):
                            expr_walk(v, held)
            for f in _BODY_FIELDS:
                body = getattr(st, f, None)
                if body:
                    scan_stmts(body, held)
            for h in getattr(st, "handlers", None) or []:
                scan_stmts(h.body, held)

    body = getattr(node, "body", [])
    if isinstance(body, list):
        scan_stmts(body, [])


def build_inventory(modules: Sequence[_Module]) -> _Inventory:
    inv = _Inventory()
    for mod in modules:
        _collect_classes(mod, inv)
    for mod in modules:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{mod.name}.{node.name}"
                fn = _LFunc(q, mod.name, mod.path, None, node.name,
                            node.lineno)
                inv.funcs[q] = fn
                _scan_func(node, _Ctx(inv, mod, None, fn))
        for cls in [c for c in inv.classes.values()
                    if c.module == mod.name and c.path == mod.path]:
            for name, meth in cls.methods.items():
                q = f"{cls.qual}.{name}"
                fn = _LFunc(q, mod.name, mod.path, cls, name, meth.lineno)
                inv.funcs[q] = fn
                _scan_func(meth, _Ctx(inv, mod, cls, fn))
    return inv


# ---------------------------------------------------------------------------
# propagation: entry-held fixpoint, transitive acquisitions/blocking
# ---------------------------------------------------------------------------


def _entry_held(inv: _Inventory) -> Dict[str, FrozenSet[str]]:
    """Must-hold-at-entry per function: the intersection over all
    resolved call sites of (lexical held at the site ∪ the caller's own
    entry set).  Roots — public names, spawn/handler targets, functions
    with no resolved in-package call site — enter with ∅."""
    sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for fn in inv.funcs.values():
        if fn.name == "__init__":
            # construction precedes every thread spawn: an unlocked
            # __init__ call site must not dilute a helper's must-hold
            # set (the restart path calls the same helper under the
            # membership lock; __init__ calls it before threads exist)
            continue
        for q, _line, held in fn.calls:
            if q in inv.funcs:
                sites.setdefault(q, []).append((fn.qual, held))
    spawn_targets = set()
    for cls in inv.classes.values():
        for name, _line in cls.spawns:
            for c in inv.mro(cls):
                if name in c.methods:
                    spawn_targets.add(f"{c.qual}.{name}")
    all_locks = frozenset(
        [f"{c.qual}.{a}" for c in inv.classes.values() for a in c.locks]
        + list(inv.mod_locks))
    entry: Dict[str, FrozenSet[str]] = {}
    for q, fn in inv.funcs.items():
        public = not fn.name.startswith("_") or fn.name.startswith("__")
        if public or q in spawn_targets or q not in sites:
            entry[q] = frozenset()
        else:
            entry[q] = all_locks
    changed = True
    while changed:
        changed = False
        for q, ss in sites.items():
            if not entry[q]:
                continue
            new = entry[q]
            for caller, held in ss:
                new = new & (held | entry.get(caller, frozenset()))
            if new != entry[q]:
                entry[q] = new
                changed = True
    return entry


def _transitive(inv: _Inventory):
    """(acq_all, blk_all): lock ids acquired / blocking ops performed in
    a function or any of its resolved callees (worklist fixpoint)."""
    acq: Dict[str, Set[str]] = {
        q: {a for a, _l, _h in fn.acquisitions}
        for q, fn in inv.funcs.items()}
    blk: Dict[str, Set[Tuple[str, str]]] = {
        q: {(k, d) for k, d, _l, _h in fn.blocking}
        for q, fn in inv.funcs.items()}
    changed = True
    while changed:
        changed = False
        for q, fn in inv.funcs.items():
            for c, _line, _held in fn.calls:
                if c not in inv.funcs:
                    continue
                if not acq[c] <= acq[q]:
                    acq[q] |= acq[c]
                    changed = True
                if not blk[c] <= blk[q]:
                    blk[q] |= blk[c]
                    changed = True
    return acq, blk


def lock_order_edges(inv: _Inventory) \
        -> Dict[Tuple[str, str], Tuple[str, int]]:
    """The acquires-while-holding digraph: edge (held → acquired) with
    its first witness (path, line).  Call edges expand through each
    callee's transitive acquisition set; self-edges through calls are
    dropped (reentrant helper chains under one lock are pervasive and
    legal for the RLock/Condition kinds — the lexical self-nesting check
    in :func:`check` covers the non-reentrant case)."""
    entry = _entry_held(inv)
    acq_all, _blk = _transitive(inv)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def add(src: str, dst: str, path: str, line: int) -> None:
        if src != dst and (src, dst) not in edges:
            edges[(src, dst)] = (path, line)

    for q, fn in inv.funcs.items():
        base = entry.get(q, frozenset())
        for lid, line, held in fn.acquisitions:
            for h in held | base:
                add(h, lid, fn.path, line)
        for c, line, held in fn.calls:
            if c not in inv.funcs:
                continue
            for h in held | base:
                for lid in acq_all[c]:
                    add(h, lid, fn.path, line)
    return edges


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _sccs(nodes: Set[str], succ: Dict[str, Set[str]]) -> List[List[str]]:
    """Tarjan, iterative; returns SCCs with >1 node."""
    idx: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v0: str) -> None:
        work = [(v0, iter(sorted(succ.get(v0, ()))))]
        idx[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while work:
            v, it = work[-1]
            adv = False
            for w in it:
                if w not in idx:
                    idx[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(succ.get(w, ())))))
                    adv = True
                    break
                if w in on:
                    low[v] = min(low[v], idx[w])
            if adv:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == idx[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))

    for n in sorted(nodes):
        if n not in idx:
            strong(n)
    return out


def _lock_kind(inv: _Inventory, lid: str) -> str:
    if lid in inv.mod_locks:
        return inv.mod_locks[lid][0]
    cq, _, attr = lid.rpartition(".")
    c = inv.classes.get(cq)
    if c is not None and attr in c.locks:
        return c.locks[attr][0]
    return "lock"


def _mod_by_path(modules: Sequence[_Module]) -> Dict[str, _Module]:
    return {m.path: m for m in modules}


def check_concurrency(modules: Sequence[_Module]) -> None:
    """Run CY113/CY114/CY115 over ``modules``, appending findings to
    each module's list (astlint's suppression filter applies after)."""
    inv = build_inventory(modules)
    by_path = _mod_by_path(modules)
    entry = _entry_held(inv)
    _acq_all, blk_all = _transitive(inv)

    def emit(path: str, fd: Finding) -> None:
        m = by_path.get(path)
        if m is not None:
            m.findings.append(fd)

    # -- CY113: cycles + lexical self-nesting of a non-reentrant lock --
    edges = lock_order_edges(inv)
    succ: Dict[str, Set[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        succ.setdefault(a, set()).add(b)
        nodes.update((a, b))
    for comp in _sccs(nodes, succ):
        witness = sorted((edges[(a, b)], (a, b))
                         for a in comp for b in succ.get(a, ())
                         if b in comp)
        (path, line), _e = witness[0]
        desc = "; ".join(
            f"{a} -> {b} at {_site(p, ln)}"
            for (p, ln), (a, b) in witness)
        emit(path, Finding(
            "CY113", path, line,
            f"lock-order cycle over {{{', '.join(comp)}}}: two paths "
            f"take these locks in opposite orders ({desc}) — a "
            f"potential deadlock",
            "pick one global order for this lock set and restructure "
            "the minority path (stage under one lock, act after "
            "release)"))
    for q, fn in inv.funcs.items():
        for lid, line, held in fn.acquisitions:
            if lid in held and _lock_kind(inv, lid) == "lock":
                emit(fn.path, Finding(
                    "CY113", fn.path, line,
                    f"`{lid}` re-acquired while already held in "
                    f"`{fn.name}` — threading.Lock is not reentrant; "
                    f"this self-deadlocks",
                    "use an RLock, or hoist the inner acquisition out "
                    "of the held region"))

    # -- CY114: blocking primitive reachable while a lock is held -------
    seen114: Set[Tuple[str, int, str, str]] = set()

    def fire114(path: str, line: int, fname: str, kind: str, detail: str,
                eff: FrozenSet[str], via: str = "") -> None:
        if kind == "wait":
            eff = eff - {detail}
            what = f"Condition.wait on `{detail}`"
        else:
            what = f"`{detail}`"
        if not eff:
            return
        lock = sorted(eff)[0]
        key = (path, line, detail, lock)
        if key in seen114:
            return
        seen114.add(key)
        hint = {
            "sleep": "sleep outside the held region (snapshot under the "
                     "lock, wait after release)",
            "join": "release the lock before joining — the joined thread "
                    "may need this very lock to exit",
            "wait": "wait on the lock you hold, or drop the other lock "
                    "first — Condition.wait only releases its own lock",
            "get": "use get(timeout=...) or drain outside the lock",
        }[kind]
        emit(path, Finding(
            "CY114", path, line,
            f"{what}{via} while `{lock}` is held in `{fname}` — every "
            f"thread contending on the lock stalls behind this wait",
            hint))

    for q, fn in inv.funcs.items():
        base = entry.get(q, frozenset())
        for kind, detail, line, held in fn.blocking:
            fire114(fn.path, line, fn.name, kind, detail, held | base)
        for c, line, held in fn.calls:
            eff = held | base
            if not eff or c not in inv.funcs:
                continue
            for kind, detail in blk_all[c]:
                fire114(fn.path, line, fn.name, kind, detail, eff,
                        via=f" (via `{c.rsplit('.', 1)[-1]}`)")

    # -- CY115: attribute written from >=2 thread roots, no common lock -
    _check_shared_state(inv, entry, emit)


def _check_shared_state(inv: _Inventory, entry: Dict[str, FrozenSet[str]],
                        emit) -> None:
    reported: Set[Tuple[str, int, str]] = set()
    for cls in inv.classes.values():
        fam = inv.mro(cls)
        fam_quals = {c.qual for c in fam}
        spawns: Dict[str, int] = {}
        for c in fam:
            for name, line in c.spawns:
                spawns.setdefault(name, line)
        has_lock = any(c.locks for c in fam)
        if not spawns or not has_lock:
            continue
        methods: Dict[str, str] = {}   # name -> qual (MRO-resolved)
        for c in fam:
            for name in c.methods:
                methods.setdefault(name, f"{c.qual}.{name}")

        def reach(roots: Iterable[str]) -> Set[str]:
            seen: Set[str] = set()
            stack = [methods[r] for r in roots if r in methods]
            while stack:
                q = stack.pop()
                if q in seen or q not in inv.funcs:
                    continue
                seen.add(q)
                for c2, _line, _h in inv.funcs[q].calls:
                    if c2.rpartition(".")[0] in fam_quals:
                        stack.append(c2)
            return seen

        roots: Dict[str, Set[str]] = {
            name: reach([name]) for name in spawns}
        pub = [n for n in methods
               if not n.startswith("_") and n != "__init__"]
        roots[_CALLER_ROOT] = reach(pub)
        # attr -> [(root, qual, line, effective held)]
        writes: Dict[str, List[Tuple[str, str, int, FrozenSet[str]]]] = {}
        for rname, qs in roots.items():
            for q in qs:
                fn = inv.funcs[q]
                if fn.name == "__init__":
                    continue
                base = entry.get(q, frozenset())
                for attr, line, held in fn.writes:
                    # lock/thread attrs are infrastructure, not state
                    if inv.lock_of(cls, attr):
                        continue
                    writes.setdefault(attr, []).append(
                        (rname, q, line, held | base))
        for attr, ws in sorted(writes.items()):
            wroots = {r for r, _q, _l, _h in ws}
            if len(wroots) < 2:
                continue
            common = frozenset.intersection(*[h for _r, _q, _l, h in ws])
            if common:
                continue
            unguarded = sorted(
                (l, q) for _r, q, l, h in ws if not h)
            path = cls.path
            if unguarded:
                line, q = unguarded[0]
                path = inv.funcs[q].path
            else:
                line = ws[0][2]
                path = inv.funcs[ws[0][1]].path
            key = (path, line, attr)
            if key in reported:
                continue
            reported.add(key)
            emit(path, Finding(
                "CY115", path, line,
                f"`self.{attr}` on {cls.qual} is written from "
                f"{len(wroots)} thread roots ({', '.join(sorted(wroots))}) "
                f"with no common guarding lock on every write path",
                "guard every write with one lock (take it in the "
                "unguarded writer), or confine the attribute to a "
                "single thread"))


# ---------------------------------------------------------------------------
# runtime twin: the lock-acquisition recorder
# ---------------------------------------------------------------------------


def record_enabled() -> bool:
    """CYLON_TPU_LOCK_RECORD: opt-in for the runtime lock recorder
    (test/CI-only instrumentation; never on in production paths)."""
    from .. import config
    return bool(config.knob("CYLON_TPU_LOCK_RECORD"))


class LockRecorder:
    """Observed (held → acquired) lock-order edges, keyed by each lock's
    creation site (``cylon_tpu_torch/...py:line``) — the same key the static
    inventory derives from the ``self._x = threading.Lock()`` line, so
    observed edges map onto static lock ids with no runtime naming."""

    def __init__(self) -> None:
        self.edges: Dict[Tuple[str, str], int] = {}
        self._tls = threading.local()
        self._mu = threading.Lock()

    def _stack(self) -> List[str]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def on_acquire(self, site: str) -> None:
        s = self._stack()
        held = [h for h in dict.fromkeys(s) if h != site]
        if held:
            with self._mu:
                for h in held:
                    k = (h, site)
                    self.edges[k] = self.edges.get(k, 0) + 1
        s.append(site)

    def on_release(self, site: str) -> None:
        s = self._stack()
        for i in range(len(s) - 1, -1, -1):
            if s[i] == site:
                del s[i]
                return

    def observed(self, inv: Optional[_Inventory] = None) \
            -> Set[Tuple[str, str]]:
        """Edges mapped to static lock ids; endpoints with no inventory
        site (test-local or interpreter-internal locks) are dropped."""
        if inv is None:
            inv = package_inventory()
        out = set()
        with self._mu:
            pairs = list(self.edges)
        for a, b in pairs:
            la, lb = inv.sites.get(a), inv.sites.get(b)
            if la and lb and la != lb:
                out.add((la, lb))
        return out


class _RecordingLock:
    """Proxy over one real lock primitive; forwards everything, records
    acquire/release transitions (Condition.wait releases around the
    blocking region, mirroring the primitive's contract)."""

    def __init__(self, real, site: str, rec: LockRecorder):
        self._real, self._site, self._rec = real, site, rec

    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            self._rec.on_acquire(self._site)
        return got

    def release(self):
        self._rec.on_release(self._site)
        return self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def wait(self, timeout=None):
        self._rec.on_release(self._site)
        try:
            return self._real.wait(timeout)
        finally:
            self._rec.on_acquire(self._site)

    def wait_for(self, predicate, timeout=None):
        self._rec.on_release(self._site)
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            self._rec.on_acquire(self._site)

    def notify(self, n=1):
        return self._real.notify(n)

    def notify_all(self):
        return self._real.notify_all()

    def __getattr__(self, name):
        return getattr(self._real, name)


def _creation_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    return _site(f.f_code.co_filename, f.f_lineno)


@contextlib.contextmanager
def record_locks(recorder: Optional[LockRecorder] = None):
    """Monkey-patch the ``threading`` lock factories so locks created
    inside the block record their ordering into ``recorder`` (yielded).
    Pre-existing locks are untouched — record around the *construction*
    of the objects under test, budgets.py-style."""
    rec = recorder or LockRecorder()
    orig = (threading.Lock, threading.RLock, threading.Condition)

    def make(factory):
        def wrapped(*a, **kw):
            site = _creation_site()
            real_args = tuple(x._real if isinstance(x, _RecordingLock)
                              else x for x in a)
            return _RecordingLock(factory(*real_args, **kw), site, rec)
        return wrapped

    threading.Lock = make(orig[0])
    threading.RLock = make(orig[1])
    threading.Condition = make(orig[2])
    try:
        yield rec
    finally:
        (threading.Lock, threading.RLock, threading.Condition) = orig


# ---------------------------------------------------------------------------
# the lock-order golden (budgets.py pattern)
# ---------------------------------------------------------------------------

LOCKGRAPH_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                              "lockgraph")


def golden_path(lock_dir: Optional[str] = None) -> str:
    return _os.path.join(lock_dir or LOCKGRAPH_DIR, "lock_order.json")


def _package_modules() -> List[_Module]:
    from .astlint import parse_paths
    return parse_paths(
        [_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))])


def package_inventory() -> _Inventory:
    return build_inventory(_package_modules())


def static_edges(inv: Optional[_Inventory] = None) -> Set[Tuple[str, str]]:
    return set(lock_order_edges(inv or package_inventory()))


def load_golden(lock_dir: Optional[str] = None) -> Optional[Dict]:
    path = golden_path(lock_dir)
    if not _os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_lockgraph(observed: Set[Tuple[str, str]],
                    static: Optional[Set[Tuple[str, str]]] = None,
                    lock_dir: Optional[str] = None) -> str:
    """Write the golden: the observed DAG, with static-only edges listed
    informationally (paths the smokes did not drive; they still
    participate in CY113 cycle detection)."""
    static = static if static is not None else static_edges()
    payload = {
        "edges": [{"src": a, "dst": b} for a, b in sorted(observed)],
        "static_only": [{"src": a, "dst": b}
                        for a, b in sorted(static - observed)],
    }
    path = golden_path(lock_dir)
    _os.makedirs(_os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def check_lockgraph(observed: Set[Tuple[str, str]],
                    static: Optional[Set[Tuple[str, str]]] = None,
                    lock_dir: Optional[str] = None) -> List[Finding]:
    """Compare observed edges against the committed golden AND the
    static graph: a new observed edge fails (CY204) until
    ``--write-lockgraph`` regenerates; an observed edge the static
    analysis cannot derive also fails (the analyzer lost coverage)."""
    path = golden_path(lock_dir)
    golden = load_golden(lock_dir)
    if golden is None:
        return [Finding("CY203", path, 1,
                        "missing lock-order golden file",
                        "run `python -m cylon_tpu_torch.analysis "
                        "--write-lockgraph` and commit the result")]
    static = static if static is not None else static_edges()
    gold = {(e["src"], e["dst"]) for e in golden.get("edges", ())}
    out: List[Finding] = []
    for a, b in sorted(observed - gold):
        out.append(Finding(
            "CY204", path, 1,
            f"observed lock-order edge {a} -> {b} is not in the "
            f"committed golden",
            "a new acquires-while-holding pair appeared at runtime; "
            "review the ordering, then regenerate with "
            "`python -m cylon_tpu_torch.analysis --write-lockgraph`"))
    for a, b in sorted(observed - static):
        out.append(Finding(
            "CY204", path, 1,
            f"observed lock-order edge {a} -> {b} is not derivable by "
            f"the static lock graph",
            "the Level-3 analyzer lost coverage of this path (an "
            "unresolved call edge?); extend locks.py rather than the "
            "golden"))
    return out


# ---------------------------------------------------------------------------
# the smoke workload the golden is recorded under
# ---------------------------------------------------------------------------


def smoke_observed(ctx=None) -> Set[Tuple[str, str]]:
    """Drive the serve, elastic and router control planes briefly under
    the recorder and return the observed edge set mapped to static lock
    ids (``cylon_tpu/analysis/locks.py:1117``).  ``ctx`` is the context
    the ``QueryService`` serves on: ``None`` means the card, as the
    service's own default (it raises without one), so a CPU caller
    passes a CPU context.  The serve op is an instance-registered
    identity runner that launches nothing; deterministic enough for a
    golden — every edge it can produce is a static edge, and the check
    only fails on NEW edges, so under-observation on a slow box is
    safe."""
    import tempfile
    import time as _time
    from .. import elastic as el
    from ..net import control
    from ..router import service as router_mod
    from ..serve import service as serve_mod

    rec = LockRecorder()
    with tempfile.TemporaryDirectory(prefix="cylint-lockgraph-") as td:
        with record_locks(rec):
            svc = serve_mod.QueryService(ctx, queue_cap=4, name="lockgraph")
            svc.register_op("echo", lambda payload, ctx=None,
                            pass_guard=None: (payload, {}),
                            idempotent=True)
            t = svc.submit("t0", "echo", {"v": 1})
            t.result(timeout=30)
            svc.telemetry()
            svc.stats()
            svc.close(timeout=10)

            coord = el.Coordinator(world=1, log_dir=td).start()
            try:
                agent = el.Agent(coord.address, rank=0)
                agent.start()
                try:
                    _time.sleep(0.2)  # a couple of heartbeat flushes
                    control.request(coord.address, {"cmd": "status"},
                                    timeout=5.0)
                finally:
                    agent.stop()
            finally:
                coord.stop()

            router = router_mod.QueryRouter(world=1,
                                            heartbeat_timeout_s=0.5).start()
            try:
                control.request(router.address, {"cmd": "status"},
                                timeout=5.0)
                router.router_status()
            finally:
                router.stop()
    return rec.observed()


# ---------------------------------------------------------------------------
# standalone scan entry (tests / fixtures)
# ---------------------------------------------------------------------------


def scan_paths(paths: Sequence[str]) -> List[Finding]:
    """Level-3 rules only, over ``paths`` — the astlint driver calls
    :func:`check_concurrency` in-process; this entry is for fixtures."""
    from .astlint import parse_paths
    modules = parse_paths(paths)
    check_concurrency(modules)
    out: List[Finding] = []
    for mod in modules:
        for fd in mod.findings:
            sup = mod.suppressions.get(fd.line, ())
            if fd.rule in sup and fd.rule != "CY001":
                continue
            if fd.rule in ("CY113", "CY114", "CY115"):
                out.append(fd)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))
