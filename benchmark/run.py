"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints what it does on standard error, then each number compared with
the plain reference beside its limit, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``.  Exits with 2 and prints no result without enough CUDA
cards, or when JAX or the JAX package is loaded once the window has
closed."""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``time.perf_counter()`` reading of this process's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Bytecode of every module imported from here on (torch's thousands among
# them) is cached at a fixed path inside the checkout, whatever the
# environment says (PYTHONDONTWRITEBYTECODE, a read-only site-packages):
# only a checkout's first run compiles it, so set-up does not pay for
# compiling torch's sources in every run.
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "pycache")


def _settle_environment() -> None:
    """The program runs at its defaults: no ``CYLON_TPU_*`` setting of the
    caller's environment reaches it.  Its kernel builds stay in the
    checkout (``build/cylon_tpu_torch/``, a fixed path), as does the
    bytecode cache (``build/pycache/``)."""
    for k in [k for k in os.environ if k.startswith("CYLON_TPU_")]:
        del os.environ[k]


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _settle_environment()

    t0 = time.perf_counter()
    import torch

    from . import harness

    t1 = time.perf_counter()
    cell = harness.find(harness.spec()["workloads"], args.workload,
                        "workload")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"needs {cell['chips']} CUDA card(s); found "
                    f"{torch.cuda.device_count()}: no result")
        return 2
    device = torch.device("cuda", 0)
    contexts = []
    for card in harness.cards(device, cell["chips"]):
        t = time.perf_counter()
        if card == device:
            torch.cuda.set_device(device)
            torch.cuda.init()
        torch.empty(1, device=card)  # the card's CUDA context
        contexts.append(f"{card} {time.perf_counter() - t:.3f} s")
    t2 = time.perf_counter()
    harness.log(f"[start] interpreter {t0 - T_START:.3f} s, torch import "
                f"{t1 - t0:.3f} s, CUDA context {t2 - t1:.3f} s "
                f"({', '.join(contexts)})")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START,
                           chips=cell["chips"])
    found = harness.forbidden_modules()
    if found:
        harness.log(f"JAX or the JAX package is loaded: {found}; no result")
        return 2
    harness.log(f"[card] {_card()}")
    for line in harness.check_lines(out):
        harness.log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
