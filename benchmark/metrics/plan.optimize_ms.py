"""Milliseconds of the planner's optimizer per query: the program's
``plan.optimize`` span (host work only), total over count, over the
measured window."""


def read(run, token=None):
    total, count = run.span_totals.get("plan.optimize", (0.0, 0))
    return 1e3 * total / count if count else None
