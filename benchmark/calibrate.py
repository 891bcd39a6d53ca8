"""The readings a cell's limits are set from, at the cell's own size, in
one process: each number compared, for sound runs of the program on
every seed (``harness.run_cell`` with a short window), and for the
control on the first ``--control-seeds`` seeds.  The control is the
plain reference put in the program's place and worked out in the
precision below the configuration's (bfloat16 for float32), judged
against the reference in float64.

    python3 -m benchmark.calibrate --workload <cell> --seconds 5 \
        --seeds 11 12 13 ... --control-seeds 3 --out <cell>.cal.json

Writes every reading and, per number, the largest program reading and
the smallest control reading."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

LOWER = {"float64": "float32", "float32": "bfloat16"}


def control_numbers(cell, seed: int, device) -> dict:
    """The control's numbers on the cell's inputs, made on ``device`` (a
    one-card cell) or on the cell's list of cards."""
    import torch

    from . import harness

    inputs = cell.generator.generate(cell.config, seed, device)
    want = cell.reference.compute(inputs, cell.config)
    lower = getattr(torch, LOWER[cell.config["precision"]])
    got = cell.reference.compute(inputs, cell.config, dtype=lower)
    out = cell.reference.compare(got, want)
    del inputs, want, got
    gc.collect()
    harness.free_cached(device)
    return out


def calibrate(name: str, seeds, control_seeds: int, seconds: float, device,
              overrides: dict | None = None) -> dict:
    from . import harness

    program, control = [], []
    chips = harness.find(harness.spec()["workloads"], name,
                         "workload")["chips"]
    place = device if chips == 1 else harness.cards(device, chips)
    for i, seed in enumerate(seeds):
        out = harness.run_cell(name, seed, seconds, False, device,
                               time.perf_counter(), overrides, chips)
        program.append({"seed": seed, "correct": out["correct"],
                        "queries": out["attempted"],
                        "numbers": {k: c["value"]
                                    for k, c in out["checks"].items()}})
        harness.log(f"[calibrate] {name} seed {seed}: {program[-1]}")
        if i < control_seeds:
            cell = harness.Cell(name, overrides)
            control.append({"seed": seed,
                            "numbers": control_numbers(cell, seed, place)})
            harness.log(f"[calibrate] {name} control seed {seed}: "
                        f"{control[-1]}")
    names = program[0]["numbers"]
    return {"cell": name, "program": program, "control": control,
            "lower": {k: max(p["numbers"][k] for p in program)
                      for k in names},
            "upper": {k: min(c["numbers"][k] for c in control)
                      for k in names if control and k in control[0]["numbers"]}}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from . import harness

    chips = harness.find(harness.spec()["workloads"], args.workload,
                         "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    rec = calibrate(args.workload, args.seeds, args.control_seeds,
                    args.seconds, torch.device("cuda", 0))
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"lower": rec["lower"], "upper": rec["upper"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
