"""Device milliseconds per query in sort kernels (CUB's radix sorts and
``torch.sort``'s), from the traced queries."""
from benchmark import trace


def read(run, token=None):
    t = run.trace
    return t.per_query_ms(trace.SORTS) if t and t.busy_s > 0 else None
