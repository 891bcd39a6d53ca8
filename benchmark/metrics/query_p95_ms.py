"""The 95th percentile, by linear interpolation, of every query's latency
in the window (as the traffic's client loop counts it), in ms."""
from benchmark import harness


def read(run, token=None):
    return 1e3 * harness.quantile(run.latencies, 0.95) \
        if run.latencies else None
