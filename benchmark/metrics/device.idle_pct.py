"""Per cent of the traced queries' wall time in which no kernel, copy or
memset ran on the card: 100 x (1 - union of device intervals / wall); in
a cell of several cards, the mean over the cards of each card's own."""


def read(run, token=None):
    t = run.trace
    if not t or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
