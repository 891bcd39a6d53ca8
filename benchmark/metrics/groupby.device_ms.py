"""Device milliseconds per traced query in the group-by: the program's
``groupby`` span (``ops.groupby.hash_groupby`` and ``pipeline_groupby``)
timed on the card as ``join.count.device_ms`` times the join's count
pass."""
from benchmark import harness

SPAN = "groupby"
_count = harness.reader("join.count.device_ms")


def begin(run):
    return _count.device_seconds(SPAN)


def read(run, token=None):
    return _count.per_query_ms(run, token, SPAN)
