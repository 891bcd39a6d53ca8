"""A throwaway cell of several cards, defined in memory for the tests of
the harness's multi-card path: no file of it exists under
``benchmark/configs``, ``traffic``, ``workloads``, ``data``, ``queries``
or ``reference``.

Its table ``t`` holds one column as a list of per-card tensors, card
``i`` holding ``(i + 1) * rows_per_card`` float32 rows, so each card's
peak differs.  A query sums each card's shard, doubles it into a
temporary, and queues ``torch.cuda._sleep`` of ``sleep_cycles`` on the
last card alone (``sleep_on`` "last") or on every card at once ("all");
it reads nothing back, so only the harness's sync of every card makes
its latency cover the sleep.  The reference sums each shard in
float64."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import harness

NAME = "multicard-sleep"
CONFIG = {"name": NAME, "generator": NAME, "precision": "float32",
          "rows_per_card": 1 << 12}
TRAFFIC = {"query": NAME, "params": {}, "clients": 1,
           "loop": "closed", "warmup_queries": 1, "check": "all",
           "trace_seconds": 0.3, "trace_queries": 3}
LIMITS = {"limits": {"shard_sum_gap": 1e-4, "shards_differing": 0}}


def generate(config: dict, seed: int, devices) -> dict:
    """One shard a card; a one-card cell gets its device alone."""
    seen["generate"] = devices
    shards = []
    for i, d in enumerate(devices if isinstance(devices, list)
                          else [devices]):
        g = torch.Generator(device=d)
        g.manual_seed(seed + i)
        shards.append(torch.rand((i + 1) * config["rows_per_card"],
                                 generator=g, device=d))
    return {"t": {"x": shards}}


def prepare(inputs: dict, params: dict, devices):
    seen["prepare"] = devices
    sleepers = inputs["t"]["x"][-1:] if params["sleep_on"] == "last" \
        else inputs["t"]["x"]
    return {"x": inputs["t"]["x"], "cycles": params["sleep_cycles"],
            "sleepers": [x.device for x in sleepers]}


def run(state):
    """Each shard's sum, left on its card; then the sleepers sleep."""
    sums = [(x * 2).sum() / 2 for x in state["x"]]
    for d in state["sleepers"]:
        if d.type == "cuda" and state["cycles"]:
            with torch.cuda.device(d):
                torch.cuda._sleep(state["cycles"])
    return sums


def keep(result):
    return [float(s) for s in result]


def answer(kept):
    return kept


def compute(inputs: dict, config: dict, dtype=torch.float64):
    return [float(x.to(dtype).sum()) for x in inputs["t"]["x"]]


def compare(got, want) -> dict:
    if len(got) != len(want):
        return {"shard_sum_gap": float("inf"), "shards_differing": len(want)}
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    return {"shard_sum_gap": max(gaps),
            "shards_differing": sum(g > 1e-4 for g in gaps)}


seen: dict = {}
_MODULE = SimpleNamespace(generate=generate, TABLES=("t",), prepare=prepare,
                          run=run, keep=keep, answer=answer, compute=compute,
                          compare=compare)


def install(monkeypatch, chips: int, sleep_cycles: int = 0,
            sleep_on: str = "last") -> str:
    """Makes ``harness.Cell(NAME)`` find the throwaway cell of ``chips``
    cards; returns its name."""
    real = harness.spec()
    fake = {**real,
            "configs": [{"name": NAME, "source": "in memory",
                         "file": f"benchmark/configs/{NAME}.json",
                         "reduced": [], "why": "a test of the harness"}],
            "workloads": [{"name": NAME, "config": NAME, "traffic": NAME,
                           "chips": chips, "why": "a test of the harness"}],
            "end_to_end": [m for m in real["end_to_end"]
                           if m["name"] in ("setup_s", "rows_per_s",
                                            "query_p95_ms")],
            "per_layer": [m for m in real["per_layer"]
                          if m["name"] in ("device.idle_pct",
                                           "device.peak_gib")]}
    for m in fake["end_to_end"] + fake["per_layer"]:
        m.pop("workloads", None)
    files = {
        harness.ROOT / "benchmark" / "configs" / f"{NAME}.json": CONFIG,
        harness.BENCH / "traffic" / f"{NAME}.json": {
            **TRAFFIC, "params": {"sleep_cycles": sleep_cycles,
                                  "sleep_on": sleep_on}},
        harness.BENCH / "workloads" / f"{NAME}.json": LIMITS}
    real_load, real_module = harness.load_json, harness.module
    monkeypatch.setattr(harness, "spec", lambda: fake)
    monkeypatch.setattr(harness, "load_json",
                        lambda path: files.get(path) or real_load(path))
    monkeypatch.setattr(
        harness, "module",
        lambda kind, name: _MODULE if name == NAME else real_module(kind,
                                                                    name))
    seen.clear()
    return NAME
