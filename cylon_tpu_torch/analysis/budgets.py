"""Level-2 collective-launch budgets, read from the port's launch
counters.

The port's counterpart of ``cylon_tpu/analysis/budgets.py``.  The
reference traces jaxprs and counts collective primitives in them; the
port traces nothing, so this module runs each entry point for real at
the reference's canonical grid (``GRID``: world 4, shard capacity 64,
columns ``i32,i64,f64,f32,bool,str8``) and reads the launch counters of
``cylon_tpu_torch/parallel/collectives.py`` (``collectives.LAUNCHES``)
around the call.  A launch is one call of a family that moves data:
``all_to_all`` (one exact-size exchange), ``allgather``,
``process_allgather``, ``allreduce_sum`` / ``_min`` / ``_max``.

Each entry runs on both realizations of a mesh, since the package
branches on them (``if group is not None``): an in-process world-4 mesh
of one device (the CPU, or the card), and ``GROUP``, two CPU processes
joined over gloo on the loopback with two shards each (world 4 again),
whose per-process counts must agree.  Both are compared exactly against
the committed goldens (``cylon_tpu_torch/analysis/budgets/*.json``,
``collectives`` and ``group_collectives``, CY201/CY202), so a change that
adds a collective to a distributed entry point, on either path, fails
tier-1 on the CPU instead of waiting for chip time.  The group runs on
the CPU only: one card cannot hold a two-rank NCCL group.

The hand-kernel wrappers' calls (``ops/scan.py::scan_1d``,
``segmented_scan``, ``ops/hash_kernels.py::hash_partition``; their
``CALLS`` counters, kernel or plain version) are informational, read on
the mesh and never enforced: they play the part of the reference's
gather/scatter/sort counts.

The reference's realizations are programs (bucketed or ragged, per
buffer, packed, compressed); the port's exchange is ragged only, with
``CYLON_TPU_SHUFFLE_PACK`` and ``_COMPRESS`` read per exchange
(``parallel/shuffle.py:1-7``), so "perbuf", "packed" and "compressed"
are settings of those knobs around the same entry point.
"""
from __future__ import annotations

import json
import os.path as _osp
from typing import Dict, List, Optional, Sequence, Tuple

from .. import config
from .astlint import COLLECTIVE_ENTRY_POINTS, Finding

#: collective families whose launch counts are enforced exactly: the
#: entry points of ``parallel/collectives.py``
ENFORCED: Tuple[str, ...] = COLLECTIVE_ENTRY_POINTS

#: hand-kernel wrappers counted for trend reading, never enforced:
#: (module under ``cylon_tpu_torch``, function)
INFORMATIONAL: Tuple[Tuple[str, str], ...] = (
    ("ops.scan", "scan_1d"), ("ops.scan", "segmented_scan"),
    ("ops.hash_kernels", "hash_partition"))

BUDGET_DIR = _osp.join(_osp.dirname(_osp.abspath(__file__)), "budgets")

#: the reference's canonical grid (``cylon_tpu/analysis/budgets.py:47``)
GRID = {"world": 4, "shard_cap": 64, "columns": "i32,i64,f64,f32,bool,str8"}

#: the process-group realization of GRID's world
GROUP = {"processes": 2, "shards_per_process": 2}

#: the counts of one realization, as a golden holds them: the mesh's,
#: and each process's of the group
MESH, PER_PROCESS = "collectives", "group_collectives"


class LaunchMeter:
    """The launches of every collective family and the calls of every
    hand-kernel wrapper between ``__enter__`` and ``__exit__``: a
    difference of the counters the package keeps where it launches, so
    no caller can go round it."""

    def __init__(self):
        self.collectives: Dict[str, int] = {p: 0 for p in ENFORCED}
        self.kernels: Dict[str, int] = {f: 0 for _, f in INFORMATIONAL}
        self._start: Dict[str, int] = {}

    @staticmethod
    def _read() -> Dict[str, int]:
        import importlib

        from ..parallel import collectives

        out = {p: collectives.LAUNCHES[p] for p in ENFORCED}
        for mod_name, name in INFORMATIONAL:
            mod = importlib.import_module(f"cylon_tpu_torch.{mod_name}")
            out[name] = mod.CALLS[name]
        return out

    def __enter__(self) -> "LaunchMeter":
        self._start = self._read()
        return self

    def __exit__(self, *exc) -> bool:
        now = self._read()
        for p in self.collectives:
            self.collectives[p] = now[p] - self._start[p]
        for name in self.kernels:
            self.kernels[name] = now[name] - self._start[name]
        return False

    def counts(self) -> Dict[str, Dict[str, int]]:
        return {MESH: dict(self.collectives),
                "informational": dict(self.kernels)}


# ---------------------------------------------------------------------------
# canonical inputs
# ---------------------------------------------------------------------------


def _mixed_frame(n: int):
    """The reference's deterministic n-row frame covering every plane
    field layout: 32-bit, 64-bit, sub-word (bool) and strings."""
    import numpy as np

    rng = np.random.default_rng(7)
    return {
        "k32": rng.integers(0, 50, n).astype(np.int32),
        "v64": rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64),
        "f64": rng.normal(size=n).astype(np.float64),
        "f32": rng.normal(size=n).astype(np.float32),
        "flag": (rng.integers(0, 2, n) == 1),
        "tag": np.array([f"s{i % 13:06d}" for i in range(n)]),
    }


def _canonical_table(ctx):
    from ..table import Table

    n = GRID["world"] * GRID["shard_cap"]
    arrs = _mixed_frame(n)
    return Table.from_numpy(list(arrs), list(arrs.values()), ctx=ctx,
                            capacity=n)


def budget_context(device="cpu"):
    """GRID's world-4 in-process mesh on one device (the CPU, or a card:
    the four shards share it)."""
    from ..context import CylonContext, MeshConfig

    return CylonContext.InitDistributed(
        MeshConfig(devices=[device], world_size=GRID["world"]))


def _metered(fn) -> Dict[str, Dict[str, int]]:
    with LaunchMeter() as meter:
        fn()
    return meter.counts()


# ---------------------------------------------------------------------------
# entry points (one golden file each)
# ---------------------------------------------------------------------------

#: the exchange realizations, as knob settings (packed, compressed ride
#: CYLON_TPU_SHUFFLE_PACK / _COMPRESS; per buffer is both off)
_PACK_MODES = {"perbuf": dict(CYLON_TPU_SHUFFLE_PACK="0",
                              CYLON_TPU_SHUFFLE_COMPRESS="0"),
               "packed": dict(CYLON_TPU_SHUFFLE_PACK="1",
                              CYLON_TPU_SHUFFLE_COMPRESS="0")}
_COMPRESSED = dict(CYLON_TPU_SHUFFLE_PACK="1", CYLON_TPU_SHUFFLE_COMPRESS="1")


def _entry_shuffle_bucketed(ctx) -> Dict[str, Dict]:
    """The hash shuffle on the first column (``parallel/ops.py::shuffle``)
    under each realization.  The reference's name is kept; the port's
    exchange is the exact-traffic one."""
    from ..parallel import ops as par_ops

    t = _canonical_table(ctx)
    out = {}
    for label, env in list(_PACK_MODES.items()) + [("compressed",
                                                    _COMPRESSED)]:
        with config.knob_env(**env):
            out[label] = _metered(lambda: par_ops.shuffle(t, (0,)))
    return out


def _entry_task_shuffle(ctx) -> Dict[str, Dict]:
    """Two logical tables to two task workers in one exchange."""
    import numpy as np

    from ..parallel.task import LogicalTaskPlan, task_shuffle
    from ..table import Table

    n = GRID["world"] * GRID["shard_cap"] // 2
    arrs = _mixed_frame(n)
    plan = LogicalTaskPlan({3: 0, 5: 2}, GRID["world"])
    out = {}
    for label, env in _PACK_MODES.items():
        with config.knob_env(**env):
            ta = Table.from_numpy(list(arrs), list(arrs.values()), ctx=ctx)
            tb = Table.from_numpy(
                list(arrs), [np.concatenate([v[1:], v[:1]])
                             for v in arrs.values()], ctx=ctx)
            out[label] = _metered(lambda: task_shuffle([ta, tb], [3, 5],
                                                       plan))
    return out


def _entry_hash_partition(ctx) -> Dict[str, Dict]:
    """``Table.hash_partition`` into 3: shard-local, no exchange."""
    from ..parallel import ops as par_ops

    t = _canonical_table(ctx)
    out = {}
    for label, env in _PACK_MODES.items():
        with config.knob_env(**env):
            out[label] = _metered(lambda: par_ops.hash_partition(t, (0,), 3))
    return out


def _entry_chunked_pass(ctx) -> Dict[str, Dict]:
    """The out-of-core engine's pass programs on one shard of the budget
    device (``exec.chunked_groupby``, 2 passes): ZERO collectives — a
    pass is strictly single-device, and a collective there would wedge
    the out-of-core stream on a mesh."""
    from .. import exec as exec_mod
    from ..context import CylonContext

    one = CylonContext.Init(ctx.devices[0])
    frame = _mixed_frame(GRID["shard_cap"])
    run = (lambda: exec_mod.chunked_groupby(
        {k: frame[k] for k in ("k32", "v64", "f32")}, ["k32"],
        {"v64": ["sum"], "f32": ["mean"]}, passes=2, ctx=one))
    return {"pass": _metered(run)}


def _plan_join_groupby_query(ctx):
    """The reference's canonical join -> group-by on the join key: a
    self-join grouped on its key, where the planner's scan sharing and
    shuffle elision leave one exchange of the eager three."""
    t = _canonical_table(ctx)
    left = t.plan().project(["k32", "f64"])
    right = t.plan().project(["k32"])
    return (left.join(right, on="k32", how="inner")
            .groupby(["l_k32"], {"f64": ["sum"]}))


def _entry_plan_join_groupby(ctx) -> Dict[str, Dict]:
    """Per-plan budget: every collective of one whole run, planner on
    vs off, on the packed exchange (the reference's setting)."""
    out = {}
    for label, mode in (("planner", "1"), ("eager", "0")):
        with config.knob_env(CYLON_TPU_PLAN=mode, **_PACK_MODES["packed"]):
            q = _plan_join_groupby_query(ctx)
            out[label] = _metered(q.execute)
    return out


def _plan_broadcast_query(ctx):
    """A fact join a 64-row dimension: the adaptive planner's
    broadcast-hash shape, picked from metadata alone."""
    import numpy as np

    from ..table import Table

    n = GRID["world"] * GRID["shard_cap"] * 4
    rng = np.random.default_rng(17)
    fact = Table.from_numpy(
        ["k", "v"],
        [rng.integers(0, 64, size=n).astype(np.int32),
         rng.standard_normal(n)],
        ctx=ctx, capacity=n)
    dim = Table.from_numpy(
        ["k", "w"],
        [np.arange(64, dtype=np.int32),
         (np.arange(64) % 7).astype(np.int64)],
        ctx=ctx, capacity=64)
    return fact.plan().join(dim.plan(), on="k", how="inner")


def _plan_salted_query(ctx):
    """Zipf-skewed fact join a dimension, then NUNIQUE grouped on the
    join key: the shape the skew-salt rule accepts."""
    import numpy as np

    from ..table import Table

    n = GRID["world"] * GRID["shard_cap"] * 4
    rng = np.random.default_rng(23)
    k = (np.minimum(rng.zipf(1.3, size=n), 50) - 1).astype(np.int32)
    fact = Table.from_numpy(
        ["k", "u"],
        [k, rng.integers(0, 97, size=n).astype(np.int64)],
        ctx=ctx, capacity=n)
    dim = Table.from_numpy(
        ["k", "w"],
        [np.arange(64, dtype=np.int32), np.arange(64, dtype=np.int64)],
        ctx=ctx, capacity=64)
    return (fact.plan().join(dim.plan(), on="k", how="inner")
            .groupby(["l_k"], {"u": ["nunique"]}))


def _entry_plan_broadcast_join(ctx) -> Dict[str, Dict]:
    """The broadcast arm moves the dimension with one gather and no
    exchange; the shuffle arm (adaptive off, same plan) pays two."""
    out = {}
    for label, adaptive in (("broadcast", "1"), ("shuffle", "0")):
        with config.knob_env(CYLON_TPU_PLAN="1",
                             CYLON_TPU_PLAN_ADAPTIVE=adaptive,
                             **_PACK_MODES["packed"]):
            q = _plan_broadcast_query(ctx)
            out[label] = _metered(q.execute)
    return out


def _entry_plan_salted_groupby(ctx) -> Dict[str, Dict]:
    """Skew-salted NUNIQUE.  The statistics catalog is seeded outside the
    meter by one profiled adaptive-off run into a throwaway stats dir
    (the salt rule fires only on observed skew); the broadcast threshold
    is 0 in both arms so the join stays shuffled and the difference is
    the salt pipeline alone."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as stats_dir:
        with config.knob_env(CYLON_TPU_PLAN="1",
                             CYLON_TPU_PLAN_ADAPTIVE="0",
                             CYLON_TPU_PROFILE="1",
                             CYLON_TPU_STATS_DIR=stats_dir,
                             **_PACK_MODES["packed"]):
            _plan_salted_query(ctx).execute()
        for label, adaptive in (("salted", "1"), ("plain", "0")):
            with config.knob_env(CYLON_TPU_PLAN="1",
                                 CYLON_TPU_PLAN_ADAPTIVE=adaptive,
                                 CYLON_TPU_PLAN_BROADCAST_BYTES="0",
                                 CYLON_TPU_PLAN_SKEW_SALT="1.2",
                                 CYLON_TPU_STATS_DIR=stats_dir,
                                 **_PACK_MODES["packed"]):
                q = _plan_salted_query(ctx)
                out[label] = _metered(q.execute)
    return out


ENTRIES = {
    "shuffle_bucketed": _entry_shuffle_bucketed,
    "task_shuffle": _entry_task_shuffle,
    "hash_partition": _entry_hash_partition,
    "chunked_pass": _entry_chunked_pass,
    "plan_join_groupby": _entry_plan_join_groupby,
    "plan_broadcast_join": _entry_plan_broadcast_join,
    "plan_salted_groupby": _entry_plan_salted_groupby,
}


def _run_entries(ctx, entries: Optional[Sequence[str]]) -> Dict[str, Dict]:
    """Every entry on ``ctx``, with the run journal and the fault plan
    off (a journal hit would skip the work being counted)."""
    out: Dict[str, Dict] = {}
    with config.knob_env(CYLON_TPU_DURABLE_DIR=None,
                         CYLON_TPU_FAULT_PLAN=None):
        for name in entries or ENTRIES:
            out[name] = ENTRIES[name](ctx)
    return out


def trace_budgets(entries: Optional[Sequence[str]] = None, device="cpu",
                  group: bool = True) -> Dict[str, Dict]:
    """Run every entry point at the canonical grid on the mesh of
    ``device`` and, with ``group``, on ``GROUP`` (CPU processes), and
    return {entry: {realization: {"collectives": ..., "group_collectives":
    ..., "informational": ...}}}."""
    out = _run_entries(budget_context(device), entries)
    if group:
        per_process = trace_group_budgets(entries)
        for name, reals in out.items():
            for real, counts in reals.items():
                counts[PER_PROCESS] = per_process[name][real]
    return out


def trace_group_budgets(entries: Optional[Sequence[str]] = None,
                        prelude: Optional[str] = None,
                        timeout_s: float = 240.0) -> Dict[str, Dict]:
    """Run the entries on ``GROUP``: that many CPU processes joined over
    gloo on the loopback, GRID's world dealt over them.  Returns
    {entry: {realization: {family: launches}}} of one process, after
    checking that every process launched the same.  ``prelude``
    (``"module:function"``) is called in each process before the entries
    run: a seam for tests that alter the package there."""
    import os
    import socket
    import subprocess
    import sys
    import tempfile

    nprocs = GROUP["processes"]
    root = _osp.dirname(_osp.dirname(_osp.dirname(_osp.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    code = ("import sys; from cylon_tpu_torch.analysis import budgets; "
            "sys.exit(budgets._group_main(sys.argv[1:]))")
    logs: List[str] = []
    for _attempt in range(3):
        with socket.socket() as sock:  # a lost race retries on a new port
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        with tempfile.TemporaryDirectory(prefix="cylint-group-") as td:
            log_paths = [_osp.join(td, f"log{pid}") for pid in range(nprocs)]
            procs = []
            try:
                for pid, log_path in enumerate(log_paths):
                    with open(log_path, "wb") as log:
                        procs.append(subprocess.Popen(
                            [sys.executable, "-c", code, str(pid),
                             str(nprocs), str(port), td,
                             ",".join(entries or ENTRIES), prelude or ""],
                            cwd=root, env=env, stdout=log,
                            stderr=subprocess.STDOUT))
                for p in procs:
                    try:
                        p.wait(timeout=timeout_s)
                    except subprocess.TimeoutExpired:
                        pass
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(timeout=30)
            logs = []
            for log_path in log_paths:
                with open(log_path, "r", encoding="utf-8",
                          errors="replace") as fh:
                    logs.append(fh.read())
            if all(p.returncode == 0 for p in procs):
                counts = []
                for pid in range(nprocs):
                    with open(_osp.join(td, f"r{pid}.json"), "r",
                              encoding="utf-8") as fh:
                        counts.append(json.load(fh))
                if any(c != counts[0] for c in counts[1:]):
                    raise RuntimeError(
                        "the processes of the budget group launched "
                        f"different collectives: {counts}")
                return counts[0]
        if not any("address already in use" in log.lower()
                   for log in logs):
            break
    raise RuntimeError("the budget group failed:\n" + "\n".join(
        f"--- process {pid}\n{log[-3000:]}" for pid, log in enumerate(logs)))


def _group_main(argv: Sequence[str]) -> int:
    """One process of ``trace_group_budgets``: ``pid nprocs port out_dir
    entries prelude``."""
    import importlib

    import torch

    from ..context import CylonContext, MeshConfig

    pid, nprocs, port, out_dir, entries, prelude = argv
    torch.set_num_threads(1)
    ctx = CylonContext.InitDistributed(MeshConfig(
        devices=["cpu"], world_size=GROUP["shards_per_process"],
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=int(nprocs), process_id=int(pid), timeout_s=120))
    try:
        if prelude:
            mod_name, fn = prelude.split(":")
            getattr(importlib.import_module(mod_name), fn)()
        counts = {name: {real: c[MESH] for real, c in reals.items()}
                  for name, reals in _run_entries(
                      ctx, entries.split(",")).items()}
    finally:
        ctx.Finalize()
    with open(_osp.join(out_dir, f"r{pid}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(counts, fh)
    return 0


# ---------------------------------------------------------------------------
# golden files
# ---------------------------------------------------------------------------


def golden_path(entry: str, budget_dir: Optional[str] = None) -> str:
    return _osp.join(budget_dir or BUDGET_DIR, f"{entry}.json")


def load_golden(entry: str, budget_dir: Optional[str] = None
                ) -> Optional[Dict]:
    path = golden_path(entry, budget_dir)
    if not _osp.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_budgets(budget_dir: Optional[str] = None,
                  traced: Optional[Dict[str, Dict]] = None) -> List[str]:
    """(Re)generate the golden files from a live run; returns the paths."""
    import os as _os

    budget_dir = budget_dir or BUDGET_DIR
    _os.makedirs(budget_dir, exist_ok=True)
    traced = traced if traced is not None else trace_budgets()
    paths = []
    for entry, counts in traced.items():
        doc = {"entry": entry, "grid": GRID, "group": GROUP,
               "realizations": counts}
        path = golden_path(entry, budget_dir)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        paths.append(path)
    return paths


def check_budgets(budget_dir: Optional[str] = None,
                  traced: Optional[Dict[str, Dict]] = None,
                  group: bool = True) -> List[Finding]:
    """Run live (unless ``traced`` is given), compare the enforced
    collective counts of the mesh and, with ``group``, of each process of
    the group against the goldens, and return CY201/CY202 findings
    (empty = within budget)."""
    import glob as _glob

    budget_dir = budget_dir or BUDGET_DIR
    traced = traced if traced is not None else trace_budgets(group=group)
    findings: List[Finding] = []
    # a committed golden whose entry point no longer runs is an
    # evaporated pin, not a pass
    for path in sorted(_glob.glob(_osp.join(budget_dir, "*.json"))):
        entry = _osp.splitext(_osp.basename(path))[0]
        if entry not in traced:
            findings.append(Finding(
                "CY201", path, 1,
                f"committed golden `{entry}` has no live entry point — "
                f"its collective budget is no longer enforced",
                "re-point the entry in budgets.ENTRIES or delete the "
                "golden deliberately"))
    where = {MESH: "mesh", PER_PROCESS: "group, per process"}
    for entry, counts in traced.items():
        path = golden_path(entry, budget_dir)
        golden = load_golden(entry, budget_dir)
        if golden is None:
            findings.append(Finding(
                "CY201", path, 1,
                f"no golden budget for entry `{entry}`",
                "run `python -m cylon_tpu_torch.analysis --write-budgets` "
                "and commit the generated file"))
            continue
        for realization, got in counts.items():
            want = golden.get("realizations", {}).get(realization)
            for key in (MESH, PER_PROCESS) if group else (MESH,):
                if want is None or key not in want or key not in got:
                    findings.append(Finding(
                        "CY201", path, 1,
                        f"`{entry}/{realization}` has no {where[key]} "
                        f"counts in the golden or in the run",
                        "regenerate with --write-budgets"))
                    continue
                for fam in sorted(set(want[key]) | set(got[key])):
                    n_want = want[key].get(fam, 0)
                    n_got = got[key].get(fam, 0)
                    if n_got != n_want:
                        findings.append(Finding(
                            "CY202", path, 1,
                            f"`{entry}/{realization}` launches {n_got} x "
                            f"`{fam}` on the {where[key]} but the "
                            f"committed budget is {n_want}",
                            "an intentional change must update the golden "
                            "(--write-budgets) with the reason in the "
                            "commit; an unintentional one just added "
                            "collectives to a distributed entry point"))
    return findings
