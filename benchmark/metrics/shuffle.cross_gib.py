"""GiB per traced query that the exchange moves between cards: the
program's ``shuffle.bytes_cross`` counter (the rows off the count
matrix's diagonal times the bytes a row moves), over the traced queries.
None where the program has no such counter."""
COUNTER = "shuffle.bytes_cross"


def _total():
    from cylon_tpu_torch.obs import metrics

    return metrics.snapshot()["counters"].get(COUNTER)


def begin(run):
    return _total() or 0


def read(run, token=None):
    total = _total()
    if total is None or token is None or not run.trace \
            or not run.trace.queries or total <= token:
        return None
    return (total - token) / 2 ** 30 / run.trace.queries
