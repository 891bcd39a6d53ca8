"""Sorts the lexsort launches per traced query, from the program's
``ops.keys.SORTS`` counter: one a call on the packed one-key path, one a
word on the word-by-word path.  None where the program has no counter."""


def _total():
    from cylon_tpu_torch.ops import keys

    sorts = getattr(keys, "SORTS", None)
    return None if sorts is None else sum(sorts.values())


def begin(run):
    return _total()


def read(run, token=None):
    total = _total()
    if token is None or total is None:
        return None
    sorts = total - token
    return sorts / run.trace.queries if sorts and run.trace.queries \
        else None
