"""Device milliseconds per query in gathers and scatters (indexing,
``index_select``, ``index_add_``, ``scatter``, ``gather``), from the
traced queries."""
from benchmark import trace


def read(run, token=None):
    t = run.trace
    return t.per_query_ms(trace.GATHERS) if t and t.busy_s > 0 else None
