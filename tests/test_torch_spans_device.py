"""Device time on the port's spans, the host syncs of the benchmark's
paths as named spans, and the join's and the group-by's spans, on the
CPU.

- ``obs.spans.device_report`` is empty on the CPU and in ``auto`` mode;
  with CUDA's runtime stood in for by fakes, events mode records a pair
  per span, resolves it without waiting once its end event has completed
  and waits only in the report, keeps its totals through ``reset`` and
  lands ``device_ms`` in the Chrome export;
- ``host_read`` and ``host_select`` lift
  ``torch.cuda.set_sync_debug_mode`` around their own read only;
- the sort join's count is one ``sync.join_count``, and the group-by
  after it reads nothing on the host; the hash join makes
  two ``sync.hash_*`` spans a round and one more for each of its build
  and its probe;
- ``join.count``, ``join.gather`` and ``groupby`` open once per join or
  group-by from each entry (``pipeline``, ``Table``, the planner's
  stages), never inside themselves;
- the hash join's results are bit for bit the same in every tracing
  mode;
- a plan profile's device times are None on the CPU, and the scan
  kernels' byte counter counts each launch's least bytes.

The CUDA-only twin (every sync of the benchmark cells' paths named,
under ``torch.cuda.set_sync_debug_mode("error")``) is
``benchmark/tests/test_portbench_syncs_gpu.py``.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cylon_tpu_torch import CylonContext, Table, config, pipeline
from cylon_tpu_torch.obs import export as obs_export
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.ops import hash_join, scan
from cylon_tpu_torch.plan import col, lit

ROWS = 3000


@pytest.fixture()
def clean():
    obs_spans.reset()
    obs_spans.reset_device()
    yield
    obs_spans.reset()
    obs_spans.reset_device()


@pytest.fixture(scope="module")
def data():
    return pipeline.tables(*pipeline.make_data(ROWS, 11), device="cpu")


class _FakeEvent:
    """A CUDA timing event on a fake clock: recording advances the clock
    by 1 ms; it completes when ``ready`` or once synchronized."""

    clock = 0.0
    ready = True
    syncs = 0
    made = 0

    def __init__(self, enable_timing=False):
        self.t = None
        self.synced = False
        _FakeEvent.made += 1

    def record(self, stream=None):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def query(self):
        return _FakeEvent.ready or self.synced

    def synchronize(self):
        _FakeEvent.syncs += 1
        self.synced = True

    def elapsed_time(self, end):
        assert end.query()  # a stream completes its events in order
        return end.t - self.t


@pytest.fixture()
def fake_cuda(monkeypatch, clean):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    stream = SimpleNamespace(device_index=0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "ready", True)
    monkeypatch.setattr(_FakeEvent, "syncs", 0)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    return _FakeEvent


def _counts(prefix=""):
    return {k: n for k, (_, n) in obs_spans.aggregate_report().items()
            if k.startswith(prefix)}


def _join_groupby(data, algo):
    m = pipeline.join_count(*data, algo=algo)
    return m, pipeline.join_groupby(*data, pipeline.cap_round(m), algo=algo)


# -- device time ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "1", "0"])
def test_device_report_empty_on_the_cpu(clean, data, mode):
    with config.knob_env(CYLON_TPU_TRACE=mode):
        _join_groupby(data, "sort")
    assert obs_spans.device_report() == {}
    assert obs_spans.device_dropped() == 0


def test_device_pairs_only_in_events_mode(fake_cuda):
    with config.knob_env(CYLON_TPU_TRACE="auto"):
        with obs_spans.span("a"):
            pass
    assert fake_cuda.clock == 0.0 and obs_spans.device_report() == {}
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with obs_spans.span("a"):
            with obs_spans.span("b"):
                pass
    # entry a, entry b, exit b, exit a: 1 ms apart on the fake clock
    assert obs_spans.device_report() == {"a": (3e-3, 1), "b": (1e-3, 1)}
    assert fake_cuda.made == 4
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with obs_spans.span("a"):
            pass
    assert fake_cuda.made == 4  # resolved events are recorded again
    assert obs_spans.device_report()["a"] == (4e-3, 2)


def test_pairs_resolve_without_waiting_and_the_report_waits(fake_cuda,
                                                            tmp_path):
    fake_cuda.ready = False
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with obs_spans.span("first", rows=3):
            pass
        with obs_spans.span("second"):
            pass
        assert fake_cuda.syncs == 0  # closing a span never waits
        p = obs_export.export_trace(path=str(tmp_path / "t.json"))
        args = [e["args"] for e in json.load(open(p))["traceEvents"]]
        assert all("device_ms" not in a for a in args)  # nothing resolved
        fake_cuda.ready = True
        with obs_spans.span("third"):  # its close polls the others
            pass
    assert fake_cuda.syncs == 0
    first = obs_spans.events()[0]
    assert first.attrs == {"rows": 3, "device_ms": 1.0}
    p = obs_export.export_trace(path=str(tmp_path / "t.json"))
    args = {e["name"]: e["args"] for e in json.load(open(p))["traceEvents"]}
    assert args["second"]["device_ms"] == 1.0
    fake_cuda.ready = False
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with obs_spans.span("fourth"):
            pass
    obs_spans.reset()  # the event buffer and aggregates go; device stays
    rep = obs_spans.device_report()
    assert fake_cuda.syncs == 1  # the report waited on the one left
    assert set(rep) == {"first", "second", "third", "fourth"}
    assert all(n == 1 for _, n in rep.values())
    obs_spans.reset_device()
    assert obs_spans.device_report() == {}


def test_pending_pairs_are_bounded(fake_cuda, monkeypatch):
    fake_cuda.ready = False
    monkeypatch.setattr(obs_spans, "DEVICE_PENDING_CAP", 3)
    with config.knob_env(CYLON_TPU_TRACE="1"):
        for _ in range(5):
            with obs_spans.span("x"):
                pass
    assert obs_spans.device_dropped() == 2
    assert obs_spans.device_report() == {"x": (3e-3, 3)}


# -- host syncs ----------------------------------------------------------


class _CudaTensor:
    """A tensor that says it is on a card and checks, when read, the sync
    debug mode it is read under."""

    is_cuda = True

    def __init__(self, seen):
        self.seen = seen

    def cpu(self):
        self.seen.append(torch.cuda.get_sync_debug_mode())
        return torch.tensor(7)

    def __getitem__(self, mask):
        self.seen.append(torch.cuda.get_sync_debug_mode())
        return torch.tensor([1])


@pytest.mark.parametrize("read", [
    lambda t: obs_spans.host_read(t, "x"),
    lambda t: obs_spans.host_select(t, "x", t),
])
def test_helpers_lift_the_sync_debug_mode_for_their_read(clean, monkeypatch,
                                                         read):
    mode = [2]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    seen = []
    read(_CudaTensor(seen))
    assert seen == [0] and mode == [2]
    assert _counts("sync.") == {"sync.x": 1}


def test_host_select_is_nonzero_or_a_mask_index(clean):
    mask = torch.tensor([True, False, True, True])
    x = torch.arange(4) * 10
    assert torch.equal(obs_spans.host_select(mask, "s"),
                       torch.nonzero(mask).squeeze(1))
    assert torch.equal(obs_spans.host_select(mask, "s", x), x[mask])
    assert _counts("sync.") == {"sync.s": 2}


def test_sort_join_count_is_one_named_sync(clean, data):
    pipeline.join_count(*data, algo="sort")
    assert _counts("sync.") == {"sync.join_count": 1}
    obs_spans.reset()
    _join_groupby(data, "sort")
    assert _counts("sync.") == {"sync.join_count": 1}


def test_hash_join_syncs_are_two_a_round_and_two_a_match(clean, data):
    before = sum(hash_join.ROUNDS.values())
    _join_groupby(data, "hash")
    rounds = sum(hash_join.ROUNDS.values()) - before
    syncs = _counts("sync.hash_")
    # the count pass and the gather each run one build and one probe
    assert syncs["sync.hash_build_rows"] == syncs["sync.hash_probe_rows"] \
        == 2
    assert sum(syncs.values()) == 2 * rounds + 2 * 2
    assert rounds > 0


@pytest.mark.parametrize("mode", ["0", "auto", "1"])
def test_hash_join_bit_for_bit_in_every_mode(clean, data, mode):
    with config.knob_env(CYLON_TPU_TRACE="0"):
        m0, (g0, n0, j0) = _join_groupby(data, "hash")
    with config.knob_env(CYLON_TPU_TRACE=mode):
        m, (g, n, j) = _join_groupby(data, "hash")
    assert m == m0 and torch.equal(n, n0) and torch.equal(j, j0)
    for a, b in zip(g, g0):
        assert torch.equal(a.data, b.data)
        assert torch.equal(a.validity, b.validity)


# -- the join's and the group-by's spans ----------------------------------


def _opened(names):
    """{name: count} of the buffered spans named, after checking that no
    span of one of the names runs inside another of the same name."""
    evs = [e for e in obs_spans.events() if e.name in names]
    for a in evs:
        for b in evs:
            if a is not b and a.name == b.name:
                assert not (a.ts <= b.ts and b.ts + b.dur <= a.ts + a.dur)
    return {n: sum(e.name == n for e in evs) for n in names}


NAMES = ("join.count", "join.gather", "groupby")


def _frames():
    rng = np.random.default_rng(5)
    left = {"k": rng.integers(0, 50, 400).astype(np.int32),
            "v": rng.random(400).astype(np.float32)}
    right = {"k": np.arange(50, dtype=np.int32),
             "w": rng.random(50).astype(np.float32)}
    ctx = CylonContext.Init("cpu")
    return (Table.from_numpy(list(left), list(left.values()), ctx=ctx),
            Table.from_numpy(list(right), list(right.values()), ctx=ctx))


@pytest.mark.parametrize("entry", ["pipeline", "table", "plan_join",
                                   "plan_fused"])
def test_join_and_groupby_spans_open_once_per_entry(clean, data, entry):
    lt, rt = _frames()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        if entry == "pipeline":
            _join_groupby(data, "sort")
            want = {"join.count": 1, "join.gather": 1, "groupby": 1}
        elif entry == "table":
            lt.join(rt, on="k").groupby("l_k", {"v": ["sum"]})
            want = {"join.count": 1, "join.gather": 1, "groupby": 1}
        elif entry == "plan_join":
            lt.plan().join(rt.plan(), on="k").execute()
            want = {"join.count": 1, "join.gather": 1, "groupby": 0}
        else:
            (lt.plan().join(rt.plan(), on="k")
             .filter(col("w") > lit(0.25))
             .groupby(["l_k"], {"v": ["sum"]}).execute())
            stages = [e.attrs["kind"] for e in obs_spans.events()
                      if e.name == "plan.stage"]
            assert "fused_join_agg" in stages
            want = {"join.count": 1, "join.gather": 1, "groupby": 1}
    assert _opened(NAMES) == want


# -- plan profile and scan bytes ------------------------------------------


def test_plan_profile_device_time_is_none_on_the_cpu(clean, tmp_path):
    lt, rt = _frames()
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        plan = lt.plan().join(rt.plan(), on="k").sort(["l_k"])
        _, prof = plan.profile()
        text = plan.explain(analyze=True)
    assert prof.nodes and all(n["device_ns"] is None
                              and n["device_self_ns"] is None
                              for n in prof.nodes.values())
    assert all(n["device_ms"] is None and n["device_self_ms"] is None
               for n in prof.as_dict()["nodes"])
    assert "device_self=" not in text and "self=" in text


def test_plan_profile_device_self_time(clean, monkeypatch, tmp_path):
    """With a fake card's events, each node's device time is its events'
    distance and its self time that less its recorded children's."""
    from cylon_tpu_torch.plan import profile as profile_mod

    clock = iter(range(0, 10 ** 6, 5))
    monkeypatch.setattr(profile_mod, "device_event",
                        lambda ctx: _ClockEvent(next(clock)))
    lt, rt = _frames()
    with config.knob_env(CYLON_TPU_TRACE_DIR=str(tmp_path)):
        _, prof = lt.plan().join(rt.plan(), on="k").sort(["l_k"]).profile()
    nodes = prof.as_dict()["nodes"]
    root = next(n for n in nodes if n["depth"] == 0)
    kids = [n for n in nodes if n["depth"] == 1]
    assert all(n["device_ms"] > 0 for n in nodes)
    assert root["device_self_ms"] == pytest.approx(
        root["device_ms"] - sum(n["device_ms"] for n in kids))


class _ClockEvent:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.mark.parametrize("kind,dtype,flag,per", [
    ("scan_1d", torch.int32, 0, 8), ("segmented_scan", torch.float32, 1, 9),
    ("scan_1d", torch.uint32, 0, 8)])
def test_scan_counts_elements_and_least_bytes(monkeypatch, kind, dtype, flag,
                                              per):
    for d in (scan.LAUNCHES, scan.ELEMENTS, scan.BYTES):
        monkeypatch.setitem(d, kind, 0)
    scan._count(kind, torch.zeros(1000, dtype=dtype), flag)
    scan._count(kind, torch.zeros(24, dtype=dtype), flag)
    assert (scan.LAUNCHES[kind], scan.ELEMENTS[kind], scan.BYTES[kind]) \
        == (2, 1024, 1024 * per)
    scan.reset_launches()
    assert scan.BYTES[kind] == scan.ELEMENTS[kind] == 0
