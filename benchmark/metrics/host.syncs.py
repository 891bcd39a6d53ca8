"""Host syncs per query in the measured window: the counts of the
program's ``sync.<site>`` spans (``obs.spans.host_read`` and
``host_select``, one span around each device-to-host read) over the
window's queries.  The query file's own reads (the join cells' group
count on the host) are the benchmark's, not the program's, and are not
counted."""


def read(run, token=None):
    syncs = sum(n for name, (_, n) in run.span_totals.items()
                if name.startswith("sync."))
    return syncs / run.queries if syncs and run.queries else None
