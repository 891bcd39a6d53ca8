"""cylint CLI on the port: ``python -m cylon_tpu_torch.analysis [paths...]``.

Exit codes: 0 — clean; 1 — findings; 2 — usage error.

With no path the scan covers the ``cylon_tpu_torch`` package.
``--budgets`` runs the distributed entry points at the canonical grid on
an in-process world-4 mesh of one device (the CPU, or the card with
``--device cuda``) and on a group of two CPU processes over gloo (two
shards each), and holds both runs' collective counts to the committed
goldens; ``--lockgraph`` drives the serve, elastic and router smoke under
the lock recorder (the service on ``--device``) and holds the observed
lock-order edges to the golden and the static graph.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cylint",
        description="the port's static analysis: AST and concurrency "
                    "rules, collective budgets and the lock-order golden")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to scan (default: the "
                         "cylon_tpu_torch package)")
    ap.add_argument("--budgets", action="store_true",
                    help="also run the distributed entry points on a "
                         "mesh and on a process group and enforce the "
                         "committed collective budgets")
    ap.add_argument("--write-budgets", action="store_true",
                    help="regenerate cylon_tpu_torch/analysis/budgets/"
                         "*.json from a live run (commit the result)")
    ap.add_argument("--lockgraph", action="store_true",
                    help="also run the serve/elastic/router smoke under "
                         "the runtime lock recorder and check the observed "
                         "lock-order edges against the committed golden "
                         "and the static lock graph")
    ap.add_argument("--write-lockgraph", action="store_true",
                    help="regenerate cylon_tpu_torch/analysis/lockgraph/"
                         "lock_order.json from a recorded smoke run "
                         "(commit the result)")
    ap.add_argument("--device", default="cpu",
                    help="device of the budget mesh and the smoke's "
                         "service: cpu (default) or cuda")
    ap.add_argument("--knobs", action="store_true",
                    help="print the CYLON_TPU_* knob table and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    args = ap.parse_args(argv)

    from .. import config
    from .astlint import RULES, scan_paths

    if args.knobs:
        print(config.knob_table())
        return 0
    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule}  {desc}")
        return 0

    findings = []
    paths = args.paths
    if not paths and not (args.write_budgets or args.write_lockgraph):
        paths = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    if paths:
        findings.extend(scan_paths(paths))

    if args.write_budgets:
        from .budgets import trace_budgets, write_budgets

        for p in write_budgets(traced=trace_budgets(device=args.device)):
            print(f"wrote {p}", file=sys.stderr)
    elif args.budgets:
        from .budgets import check_budgets, trace_budgets

        findings.extend(check_budgets(
            traced=trace_budgets(device=args.device)))

    if args.write_lockgraph or args.lockgraph:
        from ..context import CylonContext
        from .locks import (check_lockgraph, smoke_observed, static_edges,
                            write_lockgraph)

        static = static_edges()
        observed = smoke_observed(CylonContext.Init(args.device))
        if args.write_lockgraph:
            print(f"wrote {write_lockgraph(observed, static)}",
                  file=sys.stderr)
        else:
            findings.extend(check_lockgraph(observed, static))

    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"\ncylint: {len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
