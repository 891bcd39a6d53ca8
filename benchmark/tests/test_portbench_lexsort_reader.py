"""The `lexsort.sorts` reader: the sorts the program's lexsort launches
per traced query, read from its `ops.keys.SORTS` counter.  It reads
nothing, and raises nothing, where the program has no such counter."""
import time
from types import SimpleNamespace

from benchmark import harness

from .conftest import SEED, TINY


def run_of(**kw):
    base = dict(queries=4, span_totals={}, trace=None,
                cell=SimpleNamespace(query=None))
    return SimpleNamespace(**{**base, **kw})


def test_lexsort_sorts_per_traced_query(monkeypatch):
    from cylon_tpu_torch.ops import keys

    monkeypatch.setattr(keys, "SORTS", {"packed": 5, "words": 40})
    r = harness.reader("lexsort.sorts")
    run = run_of(trace=SimpleNamespace(queries=3))
    token = r.begin(run)
    keys.SORTS["packed"] += 3  # three traced queries, one sort each
    keys.SORTS["words"] += 3  # and a three-word sort in one of them
    assert r.read(run, token) == 2.0
    assert r.read(run, r.begin(run)) is None  # nothing sorted since
    monkeypatch.delattr(keys, "SORTS")  # a program without the counter
    assert r.begin(run) is None and r.read(run, None) is None
    assert r.read(run, token) is None


def test_a_traced_cpu_q1_run_sorts_once_a_query():
    """The tiny Q1 cell on the CPU, traced: its group-by on two CHAR(1)
    keys is the query's one lexsort, one packed sort."""
    out = harness.run_cell("tpch-q1-sf10", SEED, 0.2, True, "cpu",
                           time.perf_counter(), TINY["tpch-q1-sf10"])
    assert out["correct"]
    assert out["metrics"]["lexsort.sorts"]["value"] == 1.0
