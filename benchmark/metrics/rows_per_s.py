"""Input rows of every query completed in the window over the window's
seconds: each query counts the rows of every base table it reads."""


def read(run, token=None):
    done = len(run.latencies) - run.failed
    return run.query_rows * done / run.window_s if done else None
