"""One run of one cell: set-up, the measured window, the traced queries,
the comparison with the plain reference, and the result line.

Everything a cell needs is found by name: the cell and its metrics in
``BENCHMARK.json``; the configuration at the entry's ``file``, whose
``generator`` names ``benchmark/data/<generator>.py``; the traffic mix
at ``benchmark/traffic/<traffic>.json``, whose ``query`` names
``benchmark/queries/<query>.py`` and ``benchmark/reference/<query>.py``,
and whose ``loop`` names the client loop ``benchmark/clients/<loop>.py``;
the cell's limits at ``benchmark/workloads/<cell>.json``; each metric's
reader, end-to-end or per-layer, at ``benchmark/metrics/<metric>.py``."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cylon_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(metric: str):
    """``benchmark/metrics/<metric>.py`` (metric names hold dots)."""
    path = BENCH / "metrics" / f"{metric}.py"
    name = "benchmark.metrics._" + "".join(
        c if c.isalnum() else "_" for c in metric)
    mod = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(m)
    return m


def metrics_of(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def rows(inputs: dict, tables) -> int:
    """Rows of the first column of each table: a column is a tensor, a
    ``(bytes, lengths)`` tuple, or a ``list`` of either, one a card."""
    def length(col):
        if isinstance(col, list):
            return sum(length(c) for c in col)
        return int((col[0] if isinstance(col, tuple) else col).shape[0])

    return sum(length(next(iter(inputs[t].values()))) for t in tables)


def quantile(values: list, q: float) -> float:
    """The ``q``-quantile of ``values`` by linear interpolation."""
    s = sorted(values)
    pos = (len(s) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class Cell:
    """A cell's files, resolved by name."""

    def __init__(self, name: str, overrides: dict | None = None):
        self.spec = spec()
        self.entry = find(self.spec["workloads"], name, "workload")
        self.name = name
        cfg_entry = find(self.spec["configs"], self.entry["config"],
                         "configuration")
        self.config = {**load_json(ROOT / cfg_entry["file"]),
                       **(overrides or {})}
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.client = module("clients", self.traffic["loop"])
        self.limits = load_json(BENCH / "workloads" / f"{name}.json")[
            "limits"]
        self.generator = module("data", self.config["generator"])
        self.query = module("queries", self.traffic["query"])
        self.reference = module("reference", self.traffic["query"])
        self.end_to_end = metrics_of(self.spec["end_to_end"], name)
        self.per_layer = metrics_of(self.spec["per_layer"], name)


def cards(device, chips: int) -> list:
    """The cell's devices: ``device`` for a one-card cell; for more, cards
    0 to ``chips`` - 1, or on the CPU ``device`` once a card, so that a
    multi-card cell's files run on the CPU at a tiny size."""
    import torch

    if chips == 1:
        return [device]
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [device] * chips


def _cuda(devices) -> list:
    """The distinct CUDA cards among ``devices`` (a device or a list)."""
    import torch

    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


def sync(devices) -> None:
    """Waits for every card of ``devices`` (a device or a list)."""
    import torch

    for d in _cuda(devices):
        torch.cuda.synchronize(d)


def peaks(devices) -> list:
    """Each card's peak allocated bytes since its last reset."""
    import torch

    return [torch.cuda.max_memory_allocated(d) for d in _cuda(devices)]


def free_cached(devices) -> None:
    """Returns every card's cached, unused blocks to the driver."""
    import torch

    for d in _cuda(devices):
        with torch.cuda.device(d):
            torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None,
             chips: int = 1) -> dict:
    """One run; returns the result line's object.  ``t_start`` is the
    ``time.perf_counter()`` reading of the process's start.  A cell of
    more than one chip runs on ``cards(device, chips)``: its data and
    query files get that list where a one-card cell's get ``device``,
    every card is synced and its memory read, and the trace's busy time
    is each card's own, averaged."""
    import torch

    phases = {"start_to_cell": time.perf_counter() - t_start}
    t = time.perf_counter()
    cell = Cell(name, overrides)
    devices = cards(device, chips)
    place = device if chips == 1 else devices
    cuda = torch.device(device).type == "cuda"
    traffic = cell.traffic
    phases["cell_files"] = time.perf_counter() - t

    # -- set-up: inputs from the seed, the program's tables, warm-up -------
    t = time.perf_counter()
    inputs = cell.generator.generate(cell.config, seed, place)
    sync(devices)
    phases["generate"] = time.perf_counter() - t
    t = time.perf_counter()
    state = cell.query.prepare(inputs, traffic.get("params", {}), place)
    query_rows = rows(inputs, cell.query.TABLES)
    sync(devices)
    phases["prepare"] = time.perf_counter() - t
    for i in range(traffic["warmup_queries"]):
        t = time.perf_counter()
        cell.query.run(state)
        sync(devices)
        phases[f"warmup_{i}"] = time.perf_counter() - t
    from cylon_tpu_torch.obs import spans as obs_spans

    setup_peaks = peaks(devices)
    for d in _cuda(devices):
        torch.cuda.reset_peak_memory_stats(d)
    obs_spans.reset_aggregates()
    setup_s = time.perf_counter() - t_start
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))

    # -- the measured window: the traffic's client loop --------------------
    keep_all = traffic["check"] == "all"
    sampled = set() if keep_all else set(random.Random(seed).sample(
        range(traffic["check"]["draw_from"]), traffic["check"]["sampled"]))
    kept = {}

    def call():
        result = cell.query.run(state)
        sync(devices)
        return result

    def done(index, result):
        if keep_all or index in sampled:
            kept[index] = cell.query.keep(result)

    window = cell.client.drive(call, seconds, traffic, done, log)
    if window.last is not None and window.last[0] not in kept:
        kept[window.last[0]] = cell.query.keep(window.last[1])  # judged
    window.last = None
    window_peaks = peaks(devices)
    window_peak = max(window_peaks, default=0)
    span_totals = obs_spans.aggregate_report()
    failed = window.failed
    run = SimpleNamespace(cell=cell, device=device, devices=devices,
                          config=cell.config,
                          queries=len(window.latencies),
                          latencies=window.latencies, failed=failed,
                          window_s=window.window_s, setup_s=setup_s,
                          query_rows=query_rows, peak_bytes=window_peak,
                          span_totals=span_totals, trace=None)
    log(f"[window] {run.queries} queries, {failed} failed, "
        f"{run.window_s:.3f} s; set-up {setup_s:.3f} s; window peak "
        f"{window_peak} B"
        + (f" (per card {window_peaks})" if chips > 1 else ""))

    # -- the traced queries and the per-layer readers ----------------------
    readers = {m["name"]: reader(m["name"])
               for m in (cell.per_layer if trace else cell.end_to_end)}
    tokens = {n: r.begin(run) for n, r in readers.items()
              if hasattr(r, "begin")}
    values, breakdown = {}, None
    if trace:
        from . import trace as trace_mod

        run.trace = trace_mod.profile(lambda: cell.query.run(state), devices,
                                      traffic["trace_seconds"],
                                      traffic["trace_queries"])
        t = run.trace
        breakdown = {
            "device_ops": sorted(([k[:160], v] for k, v in t.kernels.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([k[:160], v] for k, v in t.idle.items()),
                                key=lambda x: -x[1])[:10]}
        log(f"[trace] {t.queries} queries, busy {t.busy_s:.4f} of "
            f"{t.window_s:.4f} s; families (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        sorted(t.families.items(), key=lambda x: -x[1])))

    for n, r in readers.items():
        v = r.read(run, tokens.get(n))
        if v is not None:
            values[n] = v

    # -- the answers, the program's state freed, the reference -------------
    answers = [cell.query.answer(r) for r in kept.values()]
    del kept, state, window
    gc.collect()
    free_cached(devices)
    want = cell.reference.compute(inputs, cell.config)
    numbers: dict = {}
    for got in answers:
        for k, v in cell.reference.compare(got, want).items():
            numbers[k] = max(numbers.get(k, v), v)
    del answers, want, inputs
    gc.collect()
    free_cached(devices)
    # a number that could not be worked out (no answer, or groups that
    # differ) is null, and fails
    checks = {k: {"value": numbers[k] if math.isfinite(numbers.get(
        k, math.inf)) else None, "limit": lim}
        for k, lim in cell.limits.items()}
    checks["failed_queries"] = {"value": failed, "limit": 0}
    correct = all(passed(c) for c in checks.values())

    # -- the result line ----------------------------------------------------
    metrics = {n: {"value": values[n], "unit": m["unit"]}
               for m in (cell.per_layer if trace else cell.end_to_end)
               if (n := m["name"]) in values}
    card_peaks = [max(p) for p in zip(setup_peaks, window_peaks)]
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": max(card_peaks, default=0)}
    if chips > 1:
        dev["memory_peak_bytes_per_card"] = card_peaks
    if trace:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    out = {"correct": correct, "attempted": run.queries, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["latency_ms"] = {"median": 1e3 * statistics.median(run.latencies),
                         "p95": 1e3 * quantile(run.latencies, 0.95),
                         "queries": run.queries}
    out["setup_phases_s"] = phases
    out["checks"] = checks
    return out


def passed(check: dict) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]


def check_lines(out: dict) -> list:
    """Each number compared beside its limit, one line each."""
    return [f"check {k}: {c['value']!r} <= {c['limit']!r} "
            f"{'ok' if passed(c) else 'FAILED'}"
            for k, c in out["checks"].items()]
