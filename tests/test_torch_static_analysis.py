"""cylint on the port (cylon_tpu_torch.analysis): the twins of
``tests/test_static_analysis.py``.

Each rule has a seeded known-bad fixture asserted to fire with the right
rule ID and line, and a clean counterpart.  Where the rule names a JAX
idiom (CY101, CY103, CY109) the fixture is rewritten in the port's terms:
a branch on a rank-local device value deciding a collective, and the
port's cached callables (``_cached_kernel(key, build)``).  For every
framework-neutral rule (CY001, CY102, CY104-CY117) the fixture is written
once and scanned by both analyzers — the reference's under
``cylon_tpu/``, the port's under ``cylon_tpu_torch/`` with the module
names swapped — and the ``(rule, line)`` findings must be the same.

Then the package gates: the port scans clean, its collective budgets
equal the committed goldens (and how they differ from the reference's is
recorded entry by entry), and the lock-order edges its smoke observes on
the CPU are in its golden and its static graph.
"""
import json
import os
import re
import textwrap
import threading

import pytest

from cylon_tpu.analysis import astlint as ref_astlint
from cylon_tpu.analysis import locks as ref_locks
from cylon_tpu_torch import CylonContext, config
from cylon_tpu_torch.analysis import astlint, budgets, locks

from . import torch_lock_record

PKG_DIR = os.path.dirname(os.path.abspath(astlint.__file__))
PACKAGE = os.path.dirname(PKG_DIR)
REF_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(
    ref_astlint.__file__)), "budgets")


def _rules_at(findings):
    return sorted((f.rule, f.line) for f in findings)


def _write(path, src):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return str(path)


def _scan(tmp_path, src, name="snippet.py"):
    """The port's scan of one fixture outside any package."""
    return astlint.scan_paths([_write(tmp_path / name, src)])


def _scan_port(tmp_path, rel, src, extra=()):
    """The port's scan of a fixture at ``cylon_tpu_torch/<rel>`` (plus
    sibling fixtures), so module names resolve into the package."""
    root = tmp_path / "port" / "cylon_tpu_torch"
    paths = [_write(root / rel, src)]
    paths += [_write(root / r, s) for r, s in extra]
    return astlint.scan_paths(paths)


def _to_port(src):
    return re.sub(r"\bcylon_tpu\b", "cylon_tpu_torch", src)


def _both(tmp_path, src, rel=None, extra=()):
    """Scan one framework-neutral fixture with both analyzers: the
    reference's at ``cylon_tpu/<rel>``, the port's at
    ``cylon_tpu_torch/<rel>`` with ``cylon_tpu`` swapped for
    ``cylon_tpu_torch`` (``rel=None``: a snippet outside any package).
    Returns the port's findings after asserting that both agree on every
    ``(rule, line)``."""
    out = []
    for side, pkg, scan, conv in (
            ("ref", "cylon_tpu", ref_astlint.scan_paths, lambda s: s),
            ("port", "cylon_tpu_torch", astlint.scan_paths, _to_port)):
        base = tmp_path / side
        root = base if rel is None else base / pkg
        name = rel or "snippet.py"
        paths = [_write(root / name, conv(src))]
        paths += [_write(base / pkg / r, conv(s)) for r, s in extra]
        out.append(scan(paths))
    ref, port = out
    assert _rules_at(ref) == _rules_at(port), (_rules_at(ref),
                                               _rules_at(port))
    return port


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------


def test_rule_table_has_every_reference_id():
    """Every ID of the reference's table is in the port's; every rule the
    port runs has a fixture below (none is out of scope: CY101, CY103 and
    CY109 run their torch counterparts)."""
    assert set(astlint.RULES) == set(ref_astlint.RULES)
    for rule, desc in astlint.RULES.items():
        assert desc and "out of scope" not in desc, rule


# ---------------------------------------------------------------------------
# CY101: a rank-local device value decides a collective
# ---------------------------------------------------------------------------


def test_cy101_host_sync_hazards(tmp_path):
    found = _scan(tmp_path, """\
        import torch
        from cylon_tpu_torch.parallel import collectives


        def exchange(xs, devices, group):
            n = torch.sum(xs[0])
            if n.item() > 0:
                xs = collectives.allgather(xs, devices, group)
            while bool(n):
                collectives.allreduce_sum(xs, devices, group)
            k = n.tolist()
            if k:
                return xs
            out = collectives.all_to_all(xs, None, xs, group) if int(n) else xs
            return out
        """)
    assert _rules_at(found) == [("CY101", 7), ("CY101", 9),
                                ("CY101", 12), ("CY101", 14)]
    assert "`.item()`" in found[0].msg and "allgather" in found[0].msg
    assert "`bool()`" in found[1].msg
    # the early return decides whether the all_to_all after it runs
    assert "truthiness" in found[2].msg and "all_to_all" in found[2].msg
    assert "`int()`" in found[3].msg and "hang" in found[3].msg


def test_cy101_static_predicates_are_legal(tmp_path):
    # shapes, dtypes, is-None tests, len() and a collective's own result
    # are the same on every process: branching on them is legal
    assert _scan(tmp_path, """\
        import torch
        from cylon_tpu_torch.parallel import collectives


        def exchange(xs, devices, group, other):
            n = torch.sum(xs[0])
            if xs[0].shape[0] > 4:
                xs = collectives.allgather(xs, devices, group)
            if n.dtype == torch.float32:
                xs = collectives.allgather(xs, devices, group)
            if other is None:
                return xs
            tot = collectives.allreduce_sum([n], devices, group)[0]
            if tot.item() > 0:
                xs = collectives.all_to_all(xs, None, xs, group)
            if len(xs) > 1:
                xs = collectives.allgather(xs, devices, group)
            return xs
        """) == []


#: (source, line of the finding or None): an exchange's result differs
#: per process and carries the taint; a parameter's scalar read is
#: rank-local; a value read from a gather or a reduction is not
_CY101_READS = {
    "exchange_result": ("""\
        from cylon_tpu_torch.parallel import collectives


        def exchange(xs, sizes, out, devices, group):
            recv = collectives.all_to_all(xs, sizes, out, group)
            if recv[0].sum().item():
                collectives.allgather(recv, devices, group)
            return recv
        """, 6),
    "parameter_item": ("""\
        from cylon_tpu_torch.parallel import collectives


        def reduce(x, xs, devices, group):
            if x.sum().item():
                return collectives.allreduce_sum(xs, devices, group)
            return xs
        """, 5),
    "parameter_tolist": ("""\
        from cylon_tpu_torch.parallel import collectives


        def reduce(counts, xs, devices, group):
            sizes = counts.tolist()
            while sizes[0]:
                xs = collectives.allreduce_max(xs, devices, group)
                sizes = sizes[1:]
            return xs
        """, 6),
    "gathered_read": ("""\
        from cylon_tpu_torch.parallel import collectives


        def reduce(x, xs, devices, group, flag):
            g = collectives.allgather([x], devices, group)
            total = g[0].sum()
            if total.item() and flag:
                return collectives.allreduce_sum(xs, devices, group)
            return xs
        """, None),
}


@pytest.mark.parametrize("case", sorted(_CY101_READS))
def test_cy101_exchange_results_and_parameter_reads(tmp_path, case):
    src, line = _CY101_READS[case]
    found = _scan(tmp_path, src)
    assert _rules_at(found) == ([] if line is None else [("CY101", line)])


def test_cy101_follows_method_calls(tmp_path):
    # the collective sits behind a method of the same class
    found = _scan(tmp_path, """\
        import torch
        from cylon_tpu_torch.parallel import collectives

        class Exchange:
            def run(self, xs, devices):
                n = torch.count_nonzero(xs[0])
                if n.item():
                    self._gather(xs, devices)

            def _gather(self, xs, devices):
                return collectives.allgather(xs, devices)
        """)
    assert _rules_at(found) == [("CY101", 7)]
    assert "allgather" in found[0].msg


def test_cy101_untraced_function_not_scanned(tmp_path):
    # a device-value branch that decides no collective is host code: legal
    assert _scan(tmp_path, """\
        import torch

        def host(x):
            y = torch.sum(x)
            if y.item() > 0:
                return float(y)
            return 0.0
        """) == []


# ---------------------------------------------------------------------------
# CY102: stray environment reads
# ---------------------------------------------------------------------------


def test_cy102_stray_env_reads(tmp_path):
    found = _both(tmp_path, """\
        import os

        def f():
            return os.environ.get("CYLON_TPU_WHATEVER")

        def g():
            return os.getenv("CYLON_TPU_OTHER")

        def h():
            return os.environ["CYLON_TPU_THIRD"]
        """)
    assert _rules_at(found) == [("CY102", 4), ("CY102", 7), ("CY102", 10)]
    assert "knob registry" in found[0].msg


def test_cy102_allows_registry_files():
    # the registry is the one sanctioned reader (the port has no
    # compile-cache enabler)
    found = astlint.scan_paths([os.path.join(PACKAGE, "config.py")])
    assert [f for f in found if f.rule == "CY102"] == []
    assert astlint.ENV_READ_ALLOWED == ("cylon_tpu_torch/config.py",)


# ---------------------------------------------------------------------------
# CY103: a trace-scope knob missing from a cached callable's key
# ---------------------------------------------------------------------------


def test_cy103_uncached_trace_knob(tmp_path):
    found = _scan(tmp_path, """\
        from cylon_tpu_torch.parallel import plane as plane_mod

        _cache = {}

        def my_builder(key, build):
            entry = _cache.get(key)
            if entry is None:
                entry = build()
                _cache[key] = entry
            return entry

        def plan(t):
            def build():
                def run(tt):
                    if plane_mod.pack_enabled():
                        return tt + 1
                    return tt
                return run
            return my_builder(("shuffle", 1), build)(t)

        def plan_keyed(t):
            def build2():
                def run2(tt):
                    if plane_mod.pack_enabled():
                        return tt + 1
                    return tt
                return run2
            return my_builder(("shuffle", plane_mod.pack_enabled()),
                              build2)(t)
        """)
    assert _rules_at(found) == [("CY103", 19)]
    assert "CYLON_TPU_SHUFFLE_PACK" in found[0].msg


def test_cy103_keyword_only_key_param(tmp_path):
    # the key arrives as a keyword-only param and the call site passes
    # key= — the rule must still see it
    found = _scan(tmp_path, """\
        from cylon_tpu_torch.stream import incremental

        _cache = {}

        def cached(build, *, key):
            entry = _cache.get(key)
            if entry is None:
                entry = build()
                _cache[key] = entry
            return entry

        def refresh(t):
            def build():
                def run(tt):
                    if incremental.batch_cap() > 0:
                        return tt
                    return tt
                return run
            return cached(build, key=("refresh", 1))(t)
        """)
    assert _rules_at(found) == [("CY103", 19)]
    assert "CYLON_TPU_STREAM_BATCH_CAP" in found[0].msg


def test_cy103_token_complete_builder_is_exempt(tmp_path):
    # a builder that folds config.trace_cache_token() into its key covers
    # every trace-scope knob (stream/incremental.py::_cached_kernel)
    assert _scan(tmp_path, """\
        from cylon_tpu_torch import config
        from cylon_tpu_torch.parallel import plane as plane_mod

        _cache = {}

        def my_builder(key, build):
            full = (key, config.trace_cache_token())
            entry = _cache.get(full)
            if entry is None:
                entry = build()
                _cache[full] = entry
            return entry

        def plan(t):
            def build():
                def run(tt):
                    if plane_mod.pack_enabled():
                        return tt + 1
                    return tt
                return run
            return my_builder(("shuffle", 1), build)(t)
        """) == []


# ---------------------------------------------------------------------------
# CY104, CY105: retried collectives, swallowed classification
# ---------------------------------------------------------------------------


def test_cy104_retried_collective(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import resilience
        from cylon_tpu.parallel import collectives

        def exchange(xs, devices):
            return collectives.allreduce_sum(xs, devices)

        def bad(policy):
            return resilience.retry_call(exchange, policy=policy, site="s")

        def bad_lambda(xs, sizes, out, policy):
            return resilience.retry_call(
                lambda: collectives.all_to_all(xs, sizes, out), policy=policy)

        def sanctioned(ctx):
            return resilience.retry_call(
                exchange, policy=ctx.collective_retry_policy(), site="s")
        """)
    assert _rules_at(found) == [("CY104", 8), ("CY104", 11)]
    assert "allreduce_sum" in found[0].msg
    assert "all_to_all" in found[1].msg


def test_cy105_swallowed_exceptions(tmp_path):
    found = _both(tmp_path, """\
        def f():
            try:
                return 1
            except:
                return 2

        def g():
            try:
                return 1
            except Exception:
                return 2

        def ok_used():
            try:
                return 1
            except Exception as e:
                return repr(e)

        def ok_reraise():
            try:
                return 1
            except Exception:
                raise
        """)
    assert _rules_at(found) == [("CY105", 4), ("CY105", 10)]
    assert "bare" in found[0].msg


# ---------------------------------------------------------------------------
# CY106: collectives on an elastic recovery path need an epoch guard
# ---------------------------------------------------------------------------


def test_cy106_unguarded_collective_on_recovery_path(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.parallel import collectives

        def _reform_mesh(xs, devices):
            return collectives.allreduce_sum(xs, devices)

        def elastic_resume(agent, xs, devices):
            return _reform_mesh(xs, devices)
        """, rel="elastic.py")
    assert _rules_at(found) == [("CY106", 6)]
    assert "allreduce_sum" in found[0].msg
    assert "epoch guard" in found[0].msg


def test_cy106_guarded_recovery_path_is_clean(tmp_path):
    assert _both(tmp_path, """\
        from cylon_tpu.parallel import collectives

        def _reform_mesh(xs, devices):
            return collectives.allreduce_sum(xs, devices)

        def elastic_resume(agent, epoch, xs, devices):
            agent.ensure_epoch(epoch)
            return _reform_mesh(xs, devices)

        def elastic_no_collectives(agent):
            return agent.view()
        """, rel="elastic.py") == []


def test_cy106_covers_reconnect_paths(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.parallel import collectives

        def _reconnect_loop(agent, xs, devices):
            return collectives.allgather(xs, devices)

        def _ride_out_window(agent, epoch, xs, devices):
            agent.ensure_epoch(epoch)
            return collectives.allgather(xs, devices)
        """, rel="elastic.py")
    assert _rules_at(found) == [("CY106", 3)]
    assert "allgather" in found[0].msg


def test_cy106_only_fires_in_the_elastic_module(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.parallel import collectives

        def elastic_resume(xs, devices):
            return collectives.allreduce_sum(xs, devices)
        """)
    assert "CY106" not in {f.rule for f in found}


# ---------------------------------------------------------------------------
# CY107: the serve control path stays device-free
# ---------------------------------------------------------------------------


def test_cy107_blocking_device_call_on_control_path(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import column

        def _fetch(x):
            return column.to_numpy(x)

        class Service:
            def submit(self, x):
                return self._admit_check(x)

            def _admit_check(self, x):
                return _fetch(x)
        """, rel="serve/service.py")
    assert _rules_at(found) == [("CY107", 7), ("CY107", 10)]
    assert "to_numpy" in found[0].msg and "shedding" in found[0].msg
    # torch's own device reads fire in the port
    found = _scan_port(tmp_path, "serve/service.py", """\
        import torch

        class Service:
            def submit(self, x):
                torch.cuda.synchronize()

            def _shed_check(self, t):
                return t.item() > 0
        """)
    assert _rules_at(found) == [("CY107", 4), ("CY107", 7)]
    assert "synchronize" in found[0].msg and "item" in found[1].msg


def test_cy107_executor_device_work_is_clean(tmp_path):
    assert _both(tmp_path, """\
        from cylon_tpu import column

        class Service:
            def submit(self, x):
                self._queue.append(x)

            def _dispatch_next(self):
                return self._queue.popleft()

            def _run_ticket(self, x):
                return column.to_numpy(x)
        """, rel="serve/service.py") == []


def test_cy107_only_fires_under_the_serve_package(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import column

        def submit(x):
            return column.to_numpy(x)
        """)
    assert "CY107" not in {f.rule for f in found}


# ---------------------------------------------------------------------------
# CY110: router control paths stay device-free
# ---------------------------------------------------------------------------


def test_cy110_blocking_device_call_on_route_path(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import column

        def _fetch(x):
            return column.to_numpy(x)

        class Router:
            def route(self, req):
                return self._place_candidates(req)

            def _place_candidates(self, req):
                return _fetch(req)
        """, rel="router/service.py")
    assert _rules_at(found) == [("CY110", 7), ("CY110", 10)]
    assert "to_numpy" in found[0].msg and "placement" in found[0].msg
    found = _scan_port(tmp_path, "router/service.py", """\
        class Router:
            def _reroute(self, t):
                return t.cpu()
        """)
    assert _rules_at(found) == [("CY110", 2)]


def test_cy110_replica_executor_device_work_is_clean(tmp_path):
    assert _both(tmp_path, """\
        from cylon_tpu import column

        class Router:
            def route(self, req):
                return self._place(req)

            def _place(self, req):
                return sorted(req)

            def run_ticket_on_replica(self, x):
                return column.to_numpy(x)
        """, rel="router/service.py") == []


def test_cy110_only_fires_under_the_router_package(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import column

        def route(req):
            return column.to_numpy(req)
        """)
    assert "CY110" not in {f.rule for f in found}


def test_cy110_arrow_ipc_decode_is_a_host_only_barrier(tmp_path):
    """pyarrow's ``Array.to_numpy`` shares its final identifier with the
    port's device fetch: the declared host-only barrier keeps the handler
    paths riding it clean, while a DIRECT device read still fires."""
    arrow = ("io/arrow_io.py", """\
        def frame_from_ipc_bytes(payload):
            return {f.name: arr.to_numpy() for f, arr in payload}
        """)
    found = _both(tmp_path, """\
        from cylon_tpu.io.arrow_io import frame_from_ipc_bytes

        def _handle_submit(req):
            return frame_from_ipc_bytes(req["payload"])
        """, rel="router/service.py", extra=[arrow])
    assert "CY110" not in {f.rule for f in found}
    found = _both(tmp_path, """\
        from cylon_tpu import column
        from cylon_tpu.io.arrow_io import frame_from_ipc_bytes

        def _handle_submit(req):
            return column.to_numpy(frame_from_ipc_bytes(req["payload"]))
        """, rel="router/service.py", extra=[arrow])
    cy110 = [f for f in found if f.rule == "CY110"]
    assert [f.rule for f in cy110] == ["CY110"]
    assert "to_numpy" in cy110[0].msg


def test_host_only_barriers_import_no_torch():
    """A declared host-only module is a barrier only while it never
    touches a device: neither imports torch."""
    import ast

    for name in astlint.HOST_ONLY_MODULES:
        path = os.path.join(os.path.dirname(PACKAGE),
                            *name.split(".")) + ".py"
        tree = ast.parse(open(path).read())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and not n.level}
        assert "torch" not in mods, name


# ---------------------------------------------------------------------------
# CY111: no RPC or fsync under a placement or journal lock
# ---------------------------------------------------------------------------


def test_cy111_rpc_under_placement_lock(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.net import control

        class Router:
            def _settle(self, addr, obj):
                with self._router_lock:
                    self._counts["hedges_won"] = 1
                    control.request(addr, obj)
        """, rel="router/service.py")
    assert _rules_at(found) == [("CY111", 5)]
    assert "request" in found[0].msg and "_router_lock" in found[0].msg


def test_cy111_transitive_rpc_under_membership_lock(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.net import control

        def _notify(addr):
            return control.request(addr, {"cmd": "x"})

        class Router:
            def _breaker_flip(self, addr):
                with self._lock:
                    _notify(addr)
        """, rel="router/service.py")
    assert _rules_at(found) == [("CY111", 8)]


def test_cy111_blocking_after_lock_release_is_clean(tmp_path):
    assert _both(tmp_path, """\
        from cylon_tpu.net import control

        class Router:
            def _settle(self, addr, obj):
                with self._router_lock:
                    snap = dict(self._counts)
                return control.request(addr, obj)
        """, rel="router/service.py") == []


def test_cy111_closure_defined_under_lock_runs_later(tmp_path):
    assert _both(tmp_path, """\
        from cylon_tpu.net import control

        class Router:
            def _arm(self, addr):
                with self._router_lock:
                    def fire():
                        return control.request(addr, {})
                    self._pending.append(fire)
        """, rel="router/service.py") == []


def test_cy111_fsync_under_lock_in_durable(tmp_path):
    dur = ("durable.py", """\
        import os

        class RunJournal:
            def _commit(self, fh):
                with self._lock:
                    os.fsync(fh.fileno())
        """)
    found = _both(tmp_path, "X = 1\n", rel="router/service.py", extra=[dur])
    assert _rules_at(found) == [("CY111", 5)]
    assert "fsync" in found[0].msg


def test_cy111_only_fires_in_scoped_modules(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.net import control

        def flip(lock, addr):
            with lock:
                return control.request(addr, {})
        """)
    assert "CY111" not in {f.rule for f in found}


# ---------------------------------------------------------------------------
# CY108, CY112: the plan fingerprint covers knobs and strategies
# ---------------------------------------------------------------------------


def test_cy108_knob_read_without_fingerprint_coverage(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.parallel.plane import pack_enabled

        def optimize(plan):
            return pack_enabled()

        def plan_fingerprint(plan):
            return hash(plan)  # trace knobs NOT covered
        """, rel="plan/executor.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY108"] \
        == [("CY108", 3)]
    assert "CYLON_TPU_SHUFFLE_PACK" in found[0].msg
    assert "stale" in found[0].msg


def test_cy108_token_complete_fingerprint_is_clean(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu import config
        from cylon_tpu.parallel.plane import pack_enabled

        def optimize(plan):
            return pack_enabled()

        def plan_fingerprint(plan):
            return hash((plan, config.trace_cache_token()))
        """, rel="plan/executor.py")
    assert "CY108" not in {f.rule for f in found}


def test_cy108_missing_fingerprint_builder_fires(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.precision import narrow

        def _exec_agg(t):
            return narrow()
        """, rel="plan/executor.py")
    assert any(f.rule == "CY108" for f in found)


def test_cy108_only_fires_under_the_plan_package(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.parallel.plane import pack_enabled

        def optimize(plan):
            return pack_enabled()
        """)
    assert "CY108" not in {f.rule for f in found}


def test_cy112_stats_read_without_strategy_fold(tmp_path):
    found = _both(tmp_path, """\
        def lookup_stats(plan):
            return None

        def _rule_broadcast_join(p):
            return lookup_stats(p)

        def plan_fingerprint(plan):
            return hash(plan)  # strategy choice NOT folded
        """, rel="plan/optimizer.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY112"] \
        == [("CY112", 4)]
    assert "lookup_stats" in found[0].msg and "unchanged" in found[0].msg


def test_cy112_strategy_folded_fingerprint_is_clean(tmp_path):
    found = _both(tmp_path, """\
        def strategy_spec(phys):
            return ()

        def lookup_stats(plan):
            return None

        def _rule_broadcast_join(p):
            return lookup_stats(p)

        def plan_fingerprint(plan, phys):
            return hash((plan, strategy_spec(phys)))
        """, rel="plan/optimizer.py")
    assert "CY112" not in {f.rule for f in found}


def test_cy112_missing_fingerprint_builder_fires(tmp_path):
    found = _both(tmp_path, """\
        def _rule_salt_agg(p, stats):
            return stats.column_stats("k")
        """, rel="plan/optimizer.py")
    assert any(f.rule == "CY112" for f in found)


def test_cy112_only_fires_under_the_plan_package(tmp_path):
    found = _both(tmp_path, """\
        def _rule_broadcast_join(p, stats):
            return stats.column_stats("k")
        """)
    assert "CY112" not in {f.rule for f in found}


# ---------------------------------------------------------------------------
# CY116, CY117: persisted state is version-checked and checksummed
# ---------------------------------------------------------------------------


def test_cy116_decode_without_version_gate(tmp_path):
    found = _both(tmp_path, """\
        def load_state(journal, part):
            frame, rows = journal.load_pass(0, part)
            return frame, rows
        """, rel="stream/loader.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY116"] \
        == [("CY116", 1)]
    assert "load_pass" in found[0].msg and "schema version" in found[0].msg


def test_cy116_gated_decode_is_clean(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.stream.state import require_state_version

        def load_state(journal, part):
            require_state_version(journal.pass_provenance(0, part))
            frame, rows = journal.load_pass(0, part)
            return frame, rows
        """, rel="stream/loader.py")
    assert "CY116" not in {f.rule for f in found}


def test_cy116_gate_at_a_distance_still_fires(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.stream.state import require_state_version

        def refresh(journal, part):
            require_state_version(journal.pass_provenance(0, part))
            return _decode(journal, part)

        def _decode(journal, part):
            from cylon_tpu.io.arrow_io import frame_from_ipc_bytes
            return frame_from_ipc_bytes(journal.read_spill(part))
        """, rel="stream/loader.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY116"] \
        == [("CY116", 7)]
    assert "frame_from_ipc_bytes" in found[0].msg


def test_cy116_only_fires_under_the_stream_package(tmp_path):
    found = _both(tmp_path, """\
        def resume(journal):
            return journal.load_pass(0, 0)
        """)
    assert "CY116" not in {f.rule for f in found}


def test_cy117_raw_binary_spill_read_fires(tmp_path):
    found = _both(tmp_path, """\
        import os

        def read_spill(run_dir, level, part):
            path = os.path.join(run_dir, f"pass_L{level}_P{part}.arrow")
            with open(path, "rb") as fh:
                return fh.read()
        """, rel="durable_helper.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY117"] \
        == [("CY117", 3)]
    assert "bitrot" in found[0].msg


def test_cy117_sha256_verified_read_is_clean(tmp_path):
    found = _both(tmp_path, """\
        import hashlib, os

        def read_spill(run_dir, entry):
            path = os.path.join(run_dir, entry["file"])  # a .arrow spill
            with open(path, "rb") as fh:
                data = fh.read()
            if hashlib.sha256(data).hexdigest() != entry["sha256"]:
                raise IOError("spill corrupt")
            return data
        """, rel="durable_helper.py")
    assert "CY117" not in {f.rule for f in found}


def test_cy117_unverified_ipc_decode_fires_and_loader_is_clean(tmp_path):
    found = _both(tmp_path, """\
        from cylon_tpu.io.arrow_io import frame_from_ipc_bytes

        def decode(blob):
            return frame_from_ipc_bytes(blob)

        def sanctioned(journal, part):
            return journal.load_pass(0, part)
        """, rel="durable_helper.py")
    assert [(f.rule, f.line) for f in found if f.rule == "CY117"] \
        == [("CY117", 3)]
    assert "frame_from_ipc_bytes" in found[0].msg


def test_cy117_outside_package_and_write_mode_are_out_of_scope(tmp_path):
    src = """\
        def read_spill(path):
            with open(path + ".arrow", "rb") as fh:
                return fh.read()
        """
    assert "CY117" not in {f.rule for f in _both(tmp_path / "a", src)}
    found = _both(tmp_path / "b", """\
        def write_spill(run_dir, name, data):
            with open(run_dir + "/" + name + ".arrow", "wb") as fh:
                fh.write(data)
        """, rel="durable_helper.py")
    assert "CY117" not in {f.rule for f in found}


# ---------------------------------------------------------------------------
# CY109: a realized-data layout missing from a cached callable's key
# ---------------------------------------------------------------------------

_CY109_BUILDER = """\
    from cylon_tpu_torch import config
    from cylon_tpu_torch.parallel import plane

    _cache = {}

    def my_builder(key, build):
        full = (key, config.trace_cache_token())
        if full not in _cache:
            _cache[full] = build()
        return _cache[full]
"""


def test_cy109_realized_layout_missing_from_key(tmp_path):
    # an observed (data-derived) compression spec closed over by a cached
    # callable while the key omits it; the builder is token-complete,
    # which must NOT exempt it (the token covers knobs, not data)
    found = _scan(tmp_path, _CY109_BUILDER + """\

    def bad(t, stats):
        spec = plane.build_spec(t.columns, stats, 4, 64)
        def build():
            return lambda tt: plane.pack_plane(tt.columns, spec)
        return my_builder(("shuffle", 4), build)
    """)
    hits = [(f.rule, f.line) for f in found if f.rule == "CY109"]
    assert hits == [("CY109", 16)], _rules_at(found)
    assert "spec" in found[0].msg and "stale field layout" in found[0].msg


def test_cy109_spec_in_key_is_clean(tmp_path):
    found = _scan(tmp_path, _CY109_BUILDER + """\

    def good(t):
        spec = plane.estimate_spec(t.columns, 4, 64)
        def build():
            return lambda tt: plane.pack_plane(tt.columns, spec)
        return my_builder(("shuffle", 4, spec), build)
    """)
    assert "CY109" not in {f.rule for f in found}, _rules_at(found)


def test_cy109_no_realized_values_is_clean(tmp_path):
    found = _scan(tmp_path, _CY109_BUILDER + """\

    def plain(t):
        def build():
            return lambda tt: plane.pack_plane(tt.columns)
        return my_builder(("shuffle",), build)
    """)
    assert "CY109" not in {f.rule for f in found}, _rules_at(found)


# ---------------------------------------------------------------------------
# CY001: suppressions carry a justification
# ---------------------------------------------------------------------------


def test_cy001_suppression_requires_justification(tmp_path):
    found = _both(tmp_path / "a", """\
        import os

        def f():
            return os.getenv("CYLON_TPU_X")  # cylint: disable=CY102
        """)
    assert sorted(f.rule for f in found) == ["CY001", "CY102"]
    assert _both(tmp_path / "b", """\
        import os

        def f():
            return os.getenv("CYLON_TPU_X")  # cylint: disable=CY102 -- fixture exercising the suppression syntax
        """) == []


# ---------------------------------------------------------------------------
# the package itself is clean
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def package_modules():
    """The package parsed once (the scan and the static lock graph)."""
    return astlint.parse_paths([PACKAGE])


def test_zero_findings_on_package():
    found = astlint.scan_paths([PACKAGE])
    assert found == [], "\n".join(f.render() for f in found)


def test_cli_main_smoke(tmp_path, capsys):
    from cylon_tpu_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    assert main(["--knobs"]) == 0
    out = capsys.readouterr().out
    assert "CY101" in out and "CYLON_TPU_SHUFFLE_PACK" in out
    assert "CYLON_TPU_LOCK_RECORD" in out
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nV = os.getenv('CYLON_TPU_Y')\n")
    assert main([str(bad)]) == 1
    capsys.readouterr()
    assert main([str(bad), "--json"]) == 1
    assert json.loads(capsys.readouterr().out)[0]["rule"] == "CY102"
    with pytest.raises(SystemExit) as ei:
        main(["--no-such-flag"])
    assert ei.value.code == 2


# ---------------------------------------------------------------------------
# knob registry
# ---------------------------------------------------------------------------


def test_knob_defaults_and_parsing(monkeypatch):
    for k in config.KNOBS.values():
        monkeypatch.delenv(k.name, raising=False)
        assert config.knob(k.name) == k.default, k.name
    monkeypatch.setenv("CYLON_TPU_PREFETCH", "0")
    assert config.knob("CYLON_TPU_PREFETCH") is False
    monkeypatch.setenv("CYLON_TPU_RETRY_MAX", "7")
    assert config.knob("CYLON_TPU_RETRY_MAX") == 7
    monkeypatch.setenv("CYLON_TPU_RETRY_MAX", "junk")
    assert config.knob("CYLON_TPU_RETRY_MAX") == 2  # parse error -> default
    monkeypatch.setenv("CYLON_TPU_ACCUM", "bogus")
    assert config.knob("CYLON_TPU_ACCUM") == "auto"  # enum guard
    with pytest.raises(KeyError):
        config.knob_raw("CYLON_TPU_NOT_A_KNOB")


def test_knob_env_roundtrip(monkeypatch):
    monkeypatch.delenv("CYLON_TPU_SHUFFLE_PACK", raising=False)
    before = config.trace_cache_token()
    with config.knob_env(CYLON_TPU_SHUFFLE_PACK="1"):
        during = config.trace_cache_token()
        assert ("CYLON_TPU_SHUFFLE_PACK", "1") in during
    assert config.trace_cache_token() == before
    with pytest.raises(KeyError):
        with config.knob_env(CYLON_TPU_NOT_A_KNOB="1"):
            pass


def test_registry_covers_every_trace_accessor():
    """Every trace-scope knob names an accessor; every accessor of every
    knob exists in the package; the trace scope is exactly the knobs
    ``trace_cache_token`` folds (one list, ``RESULT_KNOBS``), and the
    lock recorder's knob is the reference's."""
    import importlib

    trace = [k for k in config.KNOBS.values() if k.scope == config.TRACE]
    assert [k.name for k in trace] == sorted(
        config.RESULT_KNOBS, key=list(config.KNOBS).index)
    assert [k.name for k in config.trace_knobs()] == list(config.RESULT_KNOBS)
    assert [n for n, _ in config.trace_cache_token()[:-1]] \
        == list(config.RESULT_KNOBS)
    for k in config.KNOBS.values():
        assert k.cache_key == (k.scope == config.TRACE), k.name
        if k.scope == config.TRACE:
            assert k.accessors, f"{k.name}: trace-scope knob without accessors"
        for acc in k.accessors:
            mod_name, fn_name = acc.rsplit(".", 1)
            mod = importlib.import_module(mod_name)
            assert hasattr(mod, fn_name), f"{acc} does not exist"
    rec = config.KNOBS["CYLON_TPU_LOCK_RECORD"]
    assert (rec.kind, rec.default, rec.scope) == ("bool", False,
                                                  config.RUNTIME)
    with config.knob_env(CYLON_TPU_LOCK_RECORD="1"):
        assert locks.record_enabled()
    assert not locks.record_enabled()
    assert "| `CYLON_TPU_ACCUM` |" in config.knob_table()


# ---------------------------------------------------------------------------
# collective budgets (level 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced():
    return budgets.trace_budgets()


def test_budget_gate_against_committed_goldens(traced):
    found = budgets.check_budgets(traced=traced)
    assert found == [], "\n".join(f.render() for f in found)
    assert sorted(traced) == sorted(
        os.path.splitext(f)[0] for f in os.listdir(REF_BUDGETS))


def test_committed_golden_pins_single_collective():
    """Packed exchange = exactly one exchange; per buffer = 13 for the
    6-column grid (2 buffers a column, 3 for the string); over a process
    group each exchange also gathers its count matrix once; the task
    shuffle's packed exchange is one; a chunked pass runs none."""
    golden = budgets.load_golden("shuffle_bucketed")
    assert golden is not None, "shuffle_bucketed.json not committed"
    assert golden["group"] == budgets.GROUP
    packed = golden["realizations"]["packed"]
    perbuf = golden["realizations"]["perbuf"]
    assert packed["collectives"]["all_to_all"] == 1
    assert packed["collectives"]["allgather"] == 0
    assert packed["group_collectives"]["all_to_all"] == 1
    assert packed["group_collectives"]["allgather"] == 1
    assert perbuf["collectives"]["all_to_all"] == 13
    assert perbuf["group_collectives"]["all_to_all"] == 13
    task = budgets.load_golden("task_shuffle")["realizations"]
    assert task["packed"]["collectives"]["all_to_all"] == 1
    chunk = budgets.load_golden("chunked_pass")["realizations"]["pass"]
    assert sum(chunk["collectives"].values()) == 0
    assert sum(chunk["group_collectives"].values()) == 0


def test_budget_write_read_roundtrip(tmp_path, traced):
    paths = budgets.write_budgets(str(tmp_path), traced=traced)
    assert len(paths) == 7 and all(os.path.exists(p) for p in paths)
    assert budgets.check_budgets(str(tmp_path), traced=traced) == []
    for p in paths:
        doc = json.load(open(p))
        assert doc["grid"] == budgets.GRID
        assert doc["group"] == budgets.GROUP
        assert doc["realizations"] == traced[doc["entry"]]
        for counts in doc["realizations"].values():
            assert set(counts) == {"collectives", "group_collectives",
                                   "informational"}


def test_budget_regression_detected(tmp_path, traced):
    """An extra all_to_all in an entry point (the packed shuffle's one
    exchange becoming two) must fail the gate, on the mesh and on the
    group."""
    from cylon_tpu_torch.parallel import collectives, ops as par_ops

    budgets.write_budgets(str(tmp_path), traced=traced)
    real = par_ops.shuffle

    def shuffled_twice(t, key_idx):
        out = real(t, key_idx)
        empty = [s[0].data[:0] for s in t.shards]
        collectives.all_to_all(empty, [[0] * len(empty)] * len(empty),
                               empty)
        return out

    par_ops.shuffle = shuffled_twice
    try:
        tampered = budgets.trace_budgets(["shuffle_bucketed"], group=False)
    finally:
        par_ops.shuffle = real
    assert tampered["shuffle_bucketed"]["packed"]["collectives"][
        "all_to_all"] == 2
    found = budgets.check_budgets(
        str(tmp_path), traced=dict(traced, **tampered), group=False)
    assert sorted(f.rule for f in found) == ["CY202"] * 3
    assert any("`shuffle_bucketed/packed` launches 2 x `all_to_all` on "
               "the mesh but the committed budget is 1" in f.msg
               for f in found)
    # the mesh-only run holds no group counts: the full gate says so
    found = budgets.check_budgets(str(tmp_path),
                                  traced=dict(traced, **tampered))
    assert sorted(f.rule for f in found) == ["CY201"] * 3 + ["CY202"] * 3


#: a change that adds a collective only where a process group exists
#: (``if group is not None``): the one-process mesh never reaches it
_GROUP_ONLY_GATHER = """
def apply():
    from cylon_tpu_torch.parallel import collectives, shuffle

    real = shuffle.count_matrix

    def gathered_twice(counts, group=None):
        if group is not None:
            collectives.allgather([counts[0]], [group.device], group)
        return real(counts, group)

    shuffle.count_matrix = gathered_twice
"""


def test_budget_group_only_collective_detected(tmp_path, monkeypatch,
                                               traced):
    """A collective added on the process-group path alone passes the
    mesh and fails the group's budget."""
    (tmp_path / "group_only_gather.py").write_text(_GROUP_ONLY_GATHER)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH")) if p))
    entries = ["shuffle_bucketed"]
    got = budgets.trace_group_budgets(entries,
                                      prelude="group_only_gather:apply")
    tampered = {e: {r: dict(c, group_collectives=got[e][r])
                    for r, c in traced[e].items()} for e in entries}
    found = budgets.check_budgets(traced=dict(traced, **tampered))
    msgs = sorted(f.msg for f in found)
    assert [f.rule for f in found] == ["CY202"] * 3, msgs
    assert all("on the group, per process" in m for m in msgs), msgs
    assert "`shuffle_bucketed/packed` launches 2 x `allgather` on the " \
        "group, per process but the committed budget is 1" in msgs
    assert budgets.check_budgets(traced=dict(traced, **tampered),
                                 group=False) == []


def test_budget_missing_golden_detected(tmp_path, traced):
    found = budgets.check_budgets(str(tmp_path), traced=traced)
    assert len(found) == 7 and all(f.rule == "CY201" for f in found)
    # and a committed golden whose entry no longer runs
    budgets.write_budgets(str(tmp_path), traced=traced)
    less = {k: v for k, v in traced.items() if k != "task_shuffle"}
    found = budgets.check_budgets(str(tmp_path), traced=less)
    assert [f.rule for f in found] == ["CY201"]
    assert "task_shuffle" in found[0].msg


def test_launch_meter_agrees_with_the_exchange_counters():
    """One meter, two consumers: the budget meter's count of a per-buffer
    shuffle's exchanges equals the exchange layer's own
    ``shuffle.collective_launches`` counter, and a name bound from the
    collectives module is counted as well (the count lives where the
    family launches)."""
    from cylon_tpu_torch.obs import metrics as obs_metrics
    from cylon_tpu_torch.parallel import ops as par_ops
    from cylon_tpu_torch.parallel.collectives import all_to_all

    t = budgets._canonical_table(budgets.budget_context())
    for label, env in budgets._PACK_MODES.items():
        before = obs_metrics.counter_value("shuffle.collective_launches")
        with config.knob_env(**env), budgets.LaunchMeter() as meter:
            par_ops.shuffle(t, (0,))
        launched = obs_metrics.counter_value(
            "shuffle.collective_launches") - before
        assert meter.collectives["all_to_all"] == launched, label
        assert meter.kernels["hash_partition"] == t.num_shards
    empty = [s[0].data[:0] for s in t.shards]
    with budgets.LaunchMeter() as meter:
        all_to_all(empty, [[0] * len(empty)] * len(empty), empty)
    assert meter.collectives["all_to_all"] == 1


#: how the port's goldens differ from the reference's on the same GRID,
#: entry by entry, family by family (non-zero counts only): (reference,
#: port's mesh, port's group per process, reasons).  The reference
#: counts collective primitives in one traced program per realization;
#: the port counts launches in ``parallel/collectives.py`` over one whole
#: run.  Every all_to_all count is the reference's, on both paths.  The
#: gathers differ for five stated reasons:
#: (a) the ragged exchange's count-matrix ``all_gather``: the group's one
#:     ``allgather`` per exchange, as the reference's; in one process a
#:     host copy (``shuffle.count_matrix``), no launch;
#: (b) the compressed spec's column statistics are the port's
#:     ``allreduce_min`` / ``_max`` inside the entry point (2 int
#:     columns: min and max; 3 strings' extents: max), where the
#:     reference computes them in a separate stats program outside the
#:     recorded one; its dictionary ``all_gather`` is the port's one
#:     ``allgather``;
#: (c) the task shuffle's, the planner's and the eager path's global row
#:     counts are the port's ``process_allgather`` over a group (no
#:     launch in one process), where the reference gathers counts with
#:     ``all_gather`` inside each shuffle program;
#: (d) the broadcast join's one gather of the dimension is ``allgather``
#:     in both;
#: (e) ``hash_partition`` sizes its output from the global count matrix,
#:     which a group gathers; the reference's partition gathers nothing.
REFERENCE_DIFFERENCES = {
    ("shuffle_bucketed", "perbuf"): (
        {"all_to_all": 13, "all_gather": 1}, {"all_to_all": 13},
        {"all_to_all": 13, "allgather": 1}, "a"),
    ("shuffle_bucketed", "packed"): (
        {"all_to_all": 1, "all_gather": 1}, {"all_to_all": 1},
        {"all_to_all": 1, "allgather": 1}, "a"),
    ("shuffle_bucketed", "compressed"): (
        {"all_to_all": 1, "all_gather": 2},
        {"all_to_all": 1, "allgather": 1, "allreduce_min": 2,
         "allreduce_max": 5},
        {"all_to_all": 1, "allgather": 2, "allreduce_min": 2,
         "allreduce_max": 5}, "a, b"),
    ("task_shuffle", "perbuf"): (
        {"all_to_all": 15, "all_gather": 1}, {"all_to_all": 15},
        {"all_to_all": 15, "allgather": 1, "process_allgather": 6},
        "a, c"),
    ("task_shuffle", "packed"): (
        {"all_to_all": 1, "all_gather": 1}, {"all_to_all": 1},
        {"all_to_all": 1, "allgather": 1, "process_allgather": 6},
        "a, c"),
    ("hash_partition", "perbuf"): ({}, {}, {"allgather": 1}, "e"),
    ("hash_partition", "packed"): ({}, {}, {"allgather": 1}, "e"),
    ("chunked_pass", "pass"): ({}, {}, {}, ""),
    ("plan_join_groupby", "planner"): (
        {"all_to_all": 1, "all_gather": 2}, {"all_to_all": 1},
        {"all_to_all": 1, "allgather": 1, "process_allgather": 2},
        "a, c"),
    ("plan_join_groupby", "eager"): (
        {"all_to_all": 3, "all_gather": 6}, {"all_to_all": 3},
        {"all_to_all": 3, "allgather": 3, "process_allgather": 2},
        "a, c"),
    ("plan_broadcast_join", "broadcast"): (
        {"all_gather": 1}, {"allgather": 1},
        {"allgather": 1, "process_allgather": 2}, "c, d"),
    ("plan_broadcast_join", "shuffle"): (
        {"all_to_all": 2, "all_gather": 4}, {"all_to_all": 2},
        {"all_to_all": 2, "allgather": 2, "process_allgather": 2},
        "a, c"),
    ("plan_salted_groupby", "salted"): (
        {"all_to_all": 4, "all_gather": 8}, {"all_to_all": 4},
        {"all_to_all": 4, "allgather": 4, "process_allgather": 10},
        "a, c"),
    ("plan_salted_groupby", "plain"): (
        {"all_to_all": 3, "all_gather": 6}, {"all_to_all": 3},
        {"all_to_all": 3, "allgather": 3, "process_allgather": 2},
        "a, c"),
}


def test_port_budgets_differ_from_reference_as_recorded():
    seen = set()
    for fn in sorted(os.listdir(REF_BUDGETS)):
        entry = os.path.splitext(fn)[0]
        ref = json.load(open(os.path.join(REF_BUDGETS, fn)))
        port = budgets.load_golden(entry)
        assert port["grid"] == ref["grid"] == budgets.GRID
        assert set(port["realizations"]) == set(ref["realizations"])
        for real, counts in ref["realizations"].items():
            want_ref, want_mesh, want_group, why = \
                REFERENCE_DIFFERENCES[(entry, real)]
            mine = port["realizations"][real]
            got_ref = {p: n for p, n in counts["collectives"].items() if n}
            got_mesh = {p: n for p, n in mine["collectives"].items() if n}
            got_group = {p: n for p, n in mine["group_collectives"].items()
                         if n}
            assert got_ref == want_ref, (entry, real, got_ref)
            assert got_mesh == want_mesh, (entry, real, got_mesh)
            assert got_group == want_group, (entry, real, got_group)
            assert got_ref.get("all_to_all") == got_mesh.get("all_to_all") \
                == got_group.get("all_to_all")
            assert bool(why) == (want_ref != want_mesh
                                 or want_ref != want_group), (entry, real)
            seen.add((entry, real))
    assert seen == set(REFERENCE_DIFFERENCES)


# ---------------------------------------------------------------------------
# Level 3: concurrency (CY113/CY114/CY115 + lock-graph golden + recorder)
# ---------------------------------------------------------------------------


def test_cy113_lock_order_cycle(tmp_path):
    found = _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def fwd(self):
                with self._a:
                    with self._b:
                        pass

            def rev(self):
                with self._b:
                    with self._a:
                        pass
        """)
    assert [f.rule for f in found] == ["CY113"]
    assert found[0].line in (10, 14)


def test_cy113_transitive_inversion_through_calls(tmp_path):
    found = _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def _take_a(self):
                with self._a:
                    pass

            def fwd(self):
                with self._a:
                    with self._b:
                        pass

            def rev(self):
                with self._b:
                    self._take_a()
        """)
    assert [f.rule for f in found] == ["CY113"]


def test_cy113_self_reacquire_non_reentrant(tmp_path):
    found = _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def f(self):
                with self._a:
                    with self._a:
                        pass
        """)
    assert _rules_at(found) == [("CY113", 9)]


def test_cy113_consistent_ordering_is_clean(tmp_path):
    assert _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def f(self):
                with self._a:
                    with self._b:
                        pass

            def g(self):
                with self._a:
                    with self._b:
                        pass
        """) == []


def test_cy114_sleep_under_lock(tmp_path):
    found = _both(tmp_path, """\
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    time.sleep(0.1)
        """)
    assert _rules_at(found) == [("CY114", 10)]


def test_cy114_transitive_sleep_through_callee(tmp_path):
    found = _both(tmp_path, """\
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def _nap(self):
                time.sleep(0.1)

            def f(self):
                with self._lock:
                    self._nap()
        """)
    assert found and all(f.rule == "CY114" for f in found)


def test_cy114_wait_on_own_condition_is_legal(tmp_path):
    found = _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._cv = threading.Condition()
                self._other = threading.Lock()

            def ok(self):
                with self._cv:
                    self._cv.wait(0.1)

            def bad(self):
                with self._other:
                    with self._cv:
                        self._cv.wait(0.1)
        """)
    assert [f.rule for f in found] == ["CY114"]
    assert found[0].line == 15


def test_cy114_sleep_after_release_is_clean(tmp_path):
    assert _both(tmp_path, """\
        import threading
        import time

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    pass
                time.sleep(0.1)
        """) == []


def test_cy114_unbounded_queue_get_and_thread_join(tmp_path):
    found = _both(tmp_path, """\
        import queue
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue()
                self._t = threading.Thread(target=self._loop, daemon=True)

            def _loop(self):
                pass

            def f(self):
                with self._lock:
                    self._q.get()
                    self._q.get(timeout=1.0)
                    self._t.join()
        """)
    assert _rules_at(found) == [("CY114", 15), ("CY114", 17)]


def test_cy115_unguarded_cross_thread_write(tmp_path):
    found = _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(target=self._loop, daemon=True)

            def _loop(self):
                self.count += 1

            def bump(self):
                self.count += 1
        """)
    assert [f.rule for f in found] == ["CY115"]
    assert found[0].line in (10, 13)
    assert "count" in found[0].msg


def test_cy115_guarded_writes_are_clean(tmp_path):
    assert _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(target=self._loop, daemon=True)

            def _loop(self):
                with self._lock:
                    self.count += 1

            def bump(self):
                with self._lock:
                    self.count += 1
        """) == []


def test_cy115_single_root_is_clean(tmp_path):
    assert _both(tmp_path, """\
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def bump(self):
                self.count += 1

            def reset(self):
                self.count = 0
        """) == []


def test_cy115_json_server_handler_is_a_thread_root(tmp_path):
    """The port's ``net.control.JsonServer(handler)`` runs its handler on
    server threads: a write there and on the caller's surface, with no
    common lock, fires."""
    found = _both(tmp_path, """\
        import threading
        from cylon_tpu.net.control import JsonServer

        class Coord:
            def __init__(self):
                self._lock = threading.Lock()
                self.epoch = 0
                self._srv = JsonServer(self._handle)

            def _handle(self, req):
                self.epoch += 1

            def bump(self):
                with self._lock:
                    self.epoch += 1
        """, rel="coord.py")
    assert _rules_at(found) == [("CY115", 11)]


# ---------------------------------------------------------------------------
# lock-graph golden round trip + recorder
# ---------------------------------------------------------------------------


def test_lockgraph_roundtrip_and_injected_inversion(tmp_path):
    a = "m.S._a"
    b = "m.S._b"
    observed = {(a, b)}
    static = {(a, b), (a, "m.S._c")}
    path = locks.write_lockgraph(observed, static, str(tmp_path))
    doc = json.load(open(path))
    assert doc["edges"] == [{"src": a, "dst": b}]
    assert doc["static_only"] == [{"src": a, "dst": "m.S._c"}]
    assert locks.check_lockgraph(observed, static, str(tmp_path)) == []
    found = locks.check_lockgraph({(a, b), (b, a)}, static | {(b, a)},
                                  str(tmp_path))
    assert [f.rule for f in found] == ["CY204"]
    assert f"{b} -> {a}" in found[0].msg
    found = locks.check_lockgraph({(a, b), (b, a)}, static, str(tmp_path))
    assert [f.rule for f in found] == ["CY204", "CY204"]
    assert "not derivable" in found[1].msg


def test_lockgraph_missing_golden(tmp_path):
    found = locks.check_lockgraph({("x", "y")}, set(),
                                  str(tmp_path / "nope"))
    assert [f.rule for f in found] == ["CY203"]
    assert "cylon_tpu_torch.analysis" in found[0].hint


def _inversion():
    """Two threads forcing A->B and B->A on two locks made here."""
    a = threading.Lock()
    b = threading.Lock()

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    for target in (fwd, rev):
        t = threading.Thread(target=target)
        t.start()
        t.join()


def test_lock_recorder_observes_inversion():
    rec = locks.LockRecorder()
    with locks.record_locks(rec):
        _inversion()
    edges = set(rec.edges)
    assert len({s for e in edges for s in e}) == 2
    (sa, sb) = sorted({s for e in edges for s in e})
    assert (sa, sb) in edges and (sb, sa) in edges
    succ = {}
    for s, d in edges:
        succ.setdefault(s, set()).add(d)
    cycles = [c for c in locks._sccs({sa, sb}, succ) if len(c) > 1]
    assert cycles, "the A->B / B->A inversion must form a cycle"


def test_both_recorders_see_the_same_edges():
    """The reference's recorder and the port's, each around the same
    inversion snippet, record the same creation-site edges."""
    port_rec, ref_rec = locks.LockRecorder(), ref_locks.LockRecorder()
    with locks.record_locks(port_rec):
        _inversion()
    with ref_locks.record_locks(ref_rec):
        _inversion()
    assert set(port_rec.edges) == set(ref_rec.edges)
    assert len(port_rec.edges) == 2


def test_lock_recorder_ignores_unknown_sites(package_modules):
    rec = locks.LockRecorder()
    with locks.record_locks(rec):
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
    assert rec.edges
    assert rec.observed(locks.build_inventory(package_modules)) == set()


def test_committed_lockgraph_matches_static(package_modules):
    """The committed golden agrees with the static graph (every golden
    edge derivable, the merged graph acyclic), and the smoke, with its
    service on a CPU context, observes nothing outside either."""
    golden = locks.load_golden()
    assert golden is not None, "lock_order.json must be committed"
    inv = locks.build_inventory(package_modules)
    static = locks.static_edges(inv)
    gold = {(e["src"], e["dst"]) for e in golden["edges"]}
    assert gold <= static, sorted(gold - static)
    assert {(e["src"], e["dst"]) for e in golden["static_only"]} \
        == static - gold
    succ, nodes = {}, set()
    for s, d in static | gold:
        succ.setdefault(s, set()).add(d)
        nodes.update((s, d))
    assert [c for c in locks._sccs(nodes, succ) if len(c) > 1] == []
    observed = locks.smoke_observed(CylonContext.Init("cpu"))
    assert observed, "the smoke observed no lock-order edge"
    assert locks.check_lockgraph(observed, static) == []


def test_lock_record_knob_off_records_nothing():
    """With CYLON_TPU_LOCK_RECORD off the fleet suites' fixture patches
    nothing and checks nothing."""
    real = threading.Lock
    with config.knob_env(CYLON_TPU_LOCK_RECORD=None):
        with torch_lock_record.recording() as rec:
            assert rec is None and threading.Lock is real


def test_lock_record_knob_on_fails_a_new_edge(package_modules):
    """With the knob on, the fixture records under the port's recorder
    and fails on an observed edge that is not in the golden (CY204)."""
    inv = locks.build_inventory(package_modules)
    golden = locks.load_golden()
    gold = {(e["src"], e["dst"]) for e in golden["edges"]}
    by_id = {}
    for site, lock_id in sorted(inv.sites.items()):
        by_id.setdefault(lock_id, site)
    ids = sorted(by_id)
    a, b = next((x, y) for x in ids for y in ids
                if x != y and (x, y) not in gold)
    real = threading.Lock
    with config.knob_env(CYLON_TPU_LOCK_RECORD="1"):
        with torch_lock_record.recording() as rec:
            assert isinstance(rec, locks.LockRecorder)
            assert threading.Lock is not real
        assert threading.Lock is real
        with pytest.raises(AssertionError, match="CY204"):
            with torch_lock_record.recording() as rec:
                rec.edges[(by_id[a], by_id[b])] = 1


def test_recorded_sites_map_to_port_lock_ids(package_modules):
    """A port lock made under the recorder carries its creation site,
    which the static inventory maps to the lock's id."""
    from cylon_tpu_torch.serve import QueryService

    inv = locks.build_inventory(package_modules)
    with locks.record_locks(locks.LockRecorder()):
        svc = QueryService(CylonContext.Init("cpu"), name="sites")
    try:
        assert svc._lock._site.startswith("cylon_tpu_torch/serve/service.py:")
        assert inv.sites[svc._lock._site] \
            == "cylon_tpu_torch.serve.service.QueryService._lock"
    finally:
        svc.close(timeout=10)
