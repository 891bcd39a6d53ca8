"""Device milliseconds per traced query in the exchange: the program's
``shuffle.plan`` (the hash partition, the per-target counts and the count
matrix) and ``shuffle.exchange`` (the grouping by target and the copies
between cards) spans, each timed on every card of the table's mesh and
summed over the cards (``obs.spans.device_report``), over the traced
queries."""
from benchmark import harness

SPANS = ("shuffle.plan", "shuffle.exchange")
_count = harness.reader("join.count.device_ms")


def _seconds():
    seconds = [_count.device_seconds(span) for span in SPANS]
    return None if None in seconds else sum(seconds)


def begin(run):
    return _seconds()


def read(run, token=None):
    now = _seconds()
    if token is None or now is None or not run.trace \
            or not run.trace.queries or now <= token:
        return None
    return 1e3 * (now - token) / run.trace.queries
