"""Run every BASELINE.json workload config on the port and print one JSON
line each: the port's twin of ``examples/run_baselines.py``.

Scale presets:
  small — CI-sized runs (default)
  full  — card-sized runs (SF-1 Q1, 2^27-row shuffle, out-of-core Q5 at
          SF-10, the 1B-row out-of-core shuffle)

Usage: python -m cylon_tpu_torch.examples.run_baselines [small|full]

``CYLON_Q5_SF`` sets the full preset's Q5 scale and
``CYLON_SHUFFLE_OOC_ROWS`` its out-of-core shuffle's rows.  A config
that raises is reported and the harness goes on; the exit code is 1 if
any failed.
"""
from __future__ import annotations

import os
import sys
import tempfile

from . import (etl_to_torch, join_csv, shuffle_bench, tpch_q1, tpch_q3,
               tpch_q5, tpch_q6)
from .util import log

PRESETS = {
    "small": dict(join_rows=100_000, q1_sf=0.05, shuffle_rows=1 << 20,
                  q5_sf=0.01, q3_sf=0.01, q6_sf=0.05, events=100_000),
    # full: BASELINE stated-scale single-card runs.  Q5 goes through the
    # out-of-core chain (config 4 states SF-100 on a pod; SF-10 is the
    # one-card equivalent, and CYLON_Q5_SF raises it)
    "full": dict(join_rows=5_000_000, q1_sf=1.0, shuffle_rows=1 << 27,
                 q5_sf=float(os.environ.get("CYLON_Q5_SF", "10")),  # cylint: disable=CY102 -- the full preset's scale override, read as examples/run_baselines.py reads it; a setting of this script, not a package knob
                 q3_sf=0.5, q6_sf=1.0, events=2_000_000),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    preset = argv[0] if argv else "small"
    p = PRESETS[preset]
    log(f"preset={preset}")
    results = []
    q5 = (lambda: tpch_q5.run_ooc(p["q5_sf"])) if preset == "full" \
        else (lambda: tpch_q5.run(p["q5_sf"]))

    def shuffle():
        if preset != "full":
            return shuffle_bench.run(p["shuffle_rows"])
        with tempfile.TemporaryDirectory(prefix="shuffle_out_") as d:
            return shuffle_bench.run(p["shuffle_rows"], out_dir=d)

    for name, fn in [
        ("join_csv", lambda: join_csv.run(p["join_rows"])),
        ("tpch_q1", lambda: tpch_q1.run(p["q1_sf"])),
        ("shuffle", shuffle),
        # config 3 at stated scale (1B rows): one-card out of core
        ("shuffle_ooc", (lambda: shuffle_bench.run_ooc(
            int(os.environ.get("CYLON_SHUFFLE_OOC_ROWS", str(1 << 30)))))  # cylint: disable=CY102 -- the full preset's scale override, read as examples/run_baselines.py reads it; a setting of this script, not a package knob
            if preset == "full" else (lambda: shuffle_bench.run_ooc(
                1 << 18, world=4, passes=4))),
        ("tpch_q3", lambda: tpch_q3.run(p["q3_sf"])),
        ("tpch_q6", lambda: tpch_q6.run(p["q6_sf"])),
        ("tpch_q5", q5),
        ("etl_to_torch", lambda: etl_to_torch.run(p["events"])),
    ]:
        log(f"running {name} ...")
        try:
            results.append(fn())
        except Exception as e:  # keep the harness going; report the failure
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            results.append({"config": name, "error": str(e)[:200]})
    failures = [r for r in results if "error" in r]
    log(f"done: {len(results) - len(failures)}/{len(results)} configs ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
