"""The distributed join -> group-by on four CPU shards against the plain
blocked reference (``benchmark/reference/distributed_join_groupby.py``),
the join's narrowed inputs, and the exchange's and the murmur3 kernel's
accounting.

- ``pipeline.distributed_join_groupby`` through the four-card cell's own
  query file equals the reference on several seeds, with a key on one
  side only, an empty shard, a skewed key and junk past every shard's
  count: counts, keys and validity exactly, SUM and MEAN within ``TOL``,
  which the program run on values rounded to bfloat16, and the reference
  worked out in bfloat16, both fail;
- ``Table.distributed_join`` sorts each shuffled side at ``cap_round``
  of the most rows a shard received, as views of the receive buffers
  whose rows past the count are invalid, and its result is bit for bit
  the join over the whole receive buffers;
- ``pipeline.distributed_join_groupby`` reads the host only for the
  three count matrices and the join count of each shard: neither phase
  of the group-by reads its group count;
- the count matrix's host read is one ``sync.shuffle_counts``; the rows
  off its diagonal are ``shuffle.bytes_cross``; each murmur3 launch
  counts 13 B a row for an int32 key.
"""
import numpy as np
import pytest
import torch

from benchmark.queries import distributed_join_groupby as query
from benchmark.reference import distributed_join_groupby as reference
from cylon_tpu_torch import CylonContext, MeshConfig, Table, dtypes, pipeline
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.config import JoinConfig
from cylon_tpu_torch.obs import metrics as obs_metrics
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.ops import hash_kernels
from cylon_tpu_torch.parallel import ops as par_ops
from cylon_tpu_torch.parallel import partition
from cylon_tpu_torch.table import _local_join, cap_round

CARDS = 4
DOMAIN = 1 << 10
# float32 values summed over one key's joined rows: the program's gaps
# from the float64 reference are float32 roundings (about 1e-7); values
# rounded to bfloat16 (8 bits of mantissa) move a sum by about 1e-3
TOL = 1e-4
HOT = 7  # the skewed key: many rows on both sides


@pytest.fixture(scope="module")
def ctx():
    return CylonContext.InitDistributed(MeshConfig(devices=["cpu"] * CARDS))


def _side(seed: int, live, hot: int, only: int):
    """Per shard: int32 keys and float32 values of capacity ``live[s] +
    5``, junk past the live rows; ``hot`` extra rows of the skewed key on
    shard 0, and key ``only`` on shard 3 (on one side only)."""
    g = torch.Generator().manual_seed(seed)
    ks, vs = [], []
    for s, n in enumerate(live):
        k = torch.randint(0, DOMAIN - 1, (n + 5,), generator=g,
                          dtype=torch.int32)
        if s == 0 and n:
            k[:min(hot, n)] = HOT
        if s == 3 and only and n:
            k[n - 1] = DOMAIN - 1
        k[n:] = torch.randint(0, DOMAIN, (5,), generator=g,
                              dtype=torch.int32)
        ks.append(k)
        vs.append(torch.rand(n + 5, generator=g))
    return ks, vs


def _table(ctx, ks, vs, live, name):
    shards = tuple((Column(k, torch.arange(k.shape[0]) < n, None,
                           dtypes.int32),
                    Column(v, torch.arange(v.shape[0]) < n, None,
                           dtypes.float_))
                   for k, v, n in zip(ks, vs, live))
    counts = tuple(torch.tensor(n, dtype=torch.int32) for n in live)
    return Table(shards, counts, ("k", name), ctx)


LIVE_L, LIVE_R = (300, 0, 257, 410), (220, 380, 199, 301)


def _sides(seed: int):
    """The left and right shards' keys and values; shard 1 of the left
    is empty."""
    return (_side(seed, LIVE_L, 60, only=1),
            _side(seed + 1, LIVE_R, 25, only=0))


def _inputs(sides) -> dict:
    """The live rows, one tensor a shard, as the reference takes them."""
    return {name: {"k": [k[:n] for k, n in zip(ks, live)],
                   "v": [v[:n] for v, n in zip(vs, live)]}
            for name, (ks, vs), live in zip(("left", "right"), sides,
                                            (LIVE_L, LIVE_R))}


def _program(ctx, sides, round_to=None) -> dict:
    """The program's answer through the query file, the values rounded
    to ``round_to`` first if given."""
    (kl, vl), (kr, vr) = sides
    if round_to is not None:
        vl = [v.to(round_to).float() for v in vl]
        vr = [v.to(round_to).float() for v in vr]
    state = {"left": _table(ctx, kl, vl, LIVE_L, "lv"),
             "right": _table(ctx, kr, vr, LIVE_R, "rv")}
    return query.answer(query.keep(query.run(state)))


def _assert_equals_the_reference(got, sides):
    want = reference.compute(_inputs(sides), {"key_domain": DOMAIN})
    assert want["groups"] > 0 and want["join_rows"] >= 60 * 25
    numbers = reference.compare(got, want)
    exact = ("join_rows_gap", "sized_rows_gap", "groups_gap",
             "keys_differing", "validity_wrong")
    assert {k: numbers[k] for k in exact} == dict.fromkeys(exact, 0)
    assert numbers["sum_rel_gap"] < TOL and numbers["mean_rel_gap"] < TOL
    assert HOT in got["keys"].tolist()
    assert DOMAIN - 1 not in got["keys"].tolist()  # one side only


@pytest.mark.parametrize("seed", [3, 17, 2 ** 31 + 5])
def test_program_equals_the_blocked_reference(ctx, seed):
    sides = _sides(seed)
    _assert_equals_the_reference(_program(ctx, sides), sides)


def _syncs() -> dict:
    return {k: n for k, (_, n) in obs_spans.aggregate_report().items()
            if k.startswith("sync.")}


def test_join_groupby_reads_only_count_matrices_and_join_counts(ctx):
    sides = _sides(29)
    (kl, vl), (kr, vr) = sides
    left = _table(ctx, kl, vl, LIVE_L, "lv")
    right = _table(ctx, kr, vr, LIVE_R, "rv")
    obs_spans.reset()
    groups, joined = pipeline.distributed_join_groupby(left, right)
    # both sides' and the partials' count matrices, a join count a shard;
    # neither group-by phase reads its group count
    assert _syncs() == {"sync.shuffle_counts": 3, "sync.join_count": CARDS}
    obs_spans.reset()
    again = joined.groupby("l_k", {"lv": "sum", "rv": "mean"})
    assert _syncs() == {"sync.shuffle_counts": 1}
    for a, b in zip(again.shards, groups.shards):
        for x, y in zip(a, b):
            assert torch.equal(x.data, y.data)
    kept = query.keep((list(groups.shards), [int(c) for c in groups.counts],
                       list(joined.counts), joined.shard_capacity))
    _assert_equals_the_reference(query.answer(kept), sides)


def test_bfloat16_fails_the_tolerance(ctx):
    sides = _sides(3)
    inputs = _inputs(sides)
    want = reference.compute(inputs, {"key_domain": DOMAIN})
    numbers = reference.compare(_program(ctx, sides, torch.bfloat16), want)
    assert numbers["keys_differing"] == 0
    assert max(numbers["sum_rel_gap"], numbers["mean_rel_gap"]) > TOL
    control = reference.compute(inputs, {"key_domain": DOMAIN},
                                dtype=torch.bfloat16)
    numbers = reference.compare(control, want)
    assert max(numbers["sum_rel_gap"], numbers["mean_rel_gap"]) > TOL


# -- the join's narrowed inputs ----------------------------------------------


def _tables(ctx, seed=5):
    (kl, vl), (kr, vr) = _sides(seed)
    return (_table(ctx, kl, vl, LIVE_L, "lv"),
            _table(ctx, kr, vr, LIVE_R, "rv"))


def test_narrowed_shuffle_is_a_view_at_cap_round(ctx):
    left, _ = _tables(ctx)
    whole = par_ops.shuffle(left, (0,))
    narrow = par_ops.shuffle(left, (0,), narrow=True)
    received = [int(c) for c in whole.counts]
    assert sum(received) == 967
    cap = cap_round(max(received))
    assert whole.shard_capacity == 1 << (max(received) - 1).bit_length()
    assert narrow.shard_capacity == cap < whole.shard_capacity
    for ws, ns, n in zip(whole.shards, narrow.shards, received):
        for w, c in zip(ws, ns):
            assert torch.equal(c.data, w.data[:cap])
            assert torch.equal(c.validity, w.validity[:cap])
            assert not bool(c.validity[n:].any())
            # a view of the whole receive buffer, not a copy
            assert c.data.untyped_storage().nbytes() == \
                w.data.untyped_storage().nbytes() == w.data.nbytes


def test_distributed_join_bit_for_bit_the_unnarrowed_join(ctx):
    left, right = _tables(ctx)
    got = left.distributed_join(right, on="k")
    cfg = JoinConfig.of("inner", "sort", (0,), (0,))
    want = _local_join(par_ops.shuffle(left, (0,)),
                       par_ops.shuffle(right, (0,)), cfg)
    assert got.shard_capacity == want.shard_capacity
    for gs, ws, gc, wc in zip(got.shards, want.shards, got.counts,
                              want.counts):
        assert int(gc) == int(wc)
        for g, w in zip(gs, ws):
            assert torch.equal(g.data, w.data)
            assert torch.equal(g.validity, w.validity)


# -- accounting --------------------------------------------------------------


def test_count_matrix_read_and_bytes_across(ctx):
    left, _ = _tables(ctx)
    obs_spans.reset()
    before = obs_metrics.counter_value("shuffle.bytes_cross")
    out = par_ops.shuffle(left, (0,))
    syncs = {k: n for k, (_, n) in obs_spans.aggregate_report().items()
             if k.startswith("sync.")}
    assert syncs == {"sync.shuffle_counts": 1}
    # which rows stayed: a row stays where its shard's target is its own
    stayed = sum(int((partition.hash_targets(cols, n, (0,), CARDS)
                      == s).sum())
                 for s, (cols, n) in enumerate(zip(left.shards,
                                                   left.counts)))
    row_bytes = 4 + 1 + 4 + 1  # int32 key, float32 value, validity bytes
    assert obs_metrics.counter_value("shuffle.bytes_cross") - before == \
        (out.row_count - stayed) * row_bytes


def test_record_exchange_counts_the_off_diagonal_rows():
    cols = (Column(torch.zeros(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), None, dtypes.int32),)
    cm = np.array([[3, 1], [2, 5]])
    before = obs_metrics.counter_value("shuffle.bytes_cross")
    sent = obs_metrics.counter_value("shuffle.bytes_sent")
    par_ops._record_exchange(cols, False, "ragged", cm)
    assert obs_metrics.counter_value("shuffle.bytes_cross") - before == 3 * 5
    assert obs_metrics.counter_value("shuffle.bytes_sent") - sent == 11 * 5


@pytest.mark.parametrize("dtype,per_row", [(torch.int32, 13),
                                           (torch.int64, 17),
                                           (torch.bool, 10)])
def test_murmur3_least_bytes(dtype, per_row):
    col = Column(torch.zeros(1000, dtype=dtype),
                 torch.ones(1000, dtype=torch.bool), None, dtypes.int32)
    assert hash_kernels.least_bytes([col]) == 1000 * per_row
    assert hash_kernels.least_bytes([col, col]) == \
        1000 * (2 * per_row - 8)
    hash_kernels.reset_launches()
    assert hash_kernels.BYTES == {"hash_partition": 0}


# -- spans on several cards (CUDA's runtime stood in for by fakes) -----------


class _Clock:
    """Timing events on one fake clock per card: recording advances the
    card's clock by 1 ms."""

    def __init__(self):
        self.now = {}

    def event(self, enable_timing=False):
        clock = self

        class Event:
            def record(self, stream):
                clock.now[stream.device_index] = \
                    clock.now.get(stream.device_index, 0.0) + 1.0
                self.t = clock.now[stream.device_index]
                self.card = stream.device_index

            def query(self):
                return True

            def synchronize(self):
                pass

            def elapsed_time(self, end):
                assert end.card == self.card
                return end.t - self.t

        return Event()


@pytest.fixture
def cards(monkeypatch):
    from types import SimpleNamespace

    clock = _Clock()
    streams = {i: SimpleNamespace(device_index=i) for i in range(4)}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: streams[2 if device is None or device.index
                                    is None else device.index])
    monkeypatch.setattr(torch.cuda, "Event", clock.event)
    obs_spans.reset()
    obs_spans.reset_device()
    yield clock
    obs_spans.reset()
    obs_spans.reset_device()


def test_a_span_is_timed_on_each_of_its_cards(cards):
    from cylon_tpu_torch import config

    one, three = torch.device("cuda", 1), torch.device("cuda", 3)
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with obs_spans.span("on_one", devices=one):
            cards.now[1] += 5.0  # card 1 works 5 ms
        with obs_spans.span("over_all", devices=[one, three, one, "cpu"]):
            cards.now[1] += 2.0
            cards.now[3] += 7.0
        with obs_spans.span("current"):  # the current card's, 2
            cards.now[1] += 9.0
        with obs_spans.span("cpu_only", devices=["cpu"]):
            cards.now[1] += 9.0
    report = obs_spans.device_report()
    # each pair reads its card's work plus the 1 ms its end event adds
    assert report["on_one"] == (6e-3, 1)
    assert report["over_all"] == (pytest.approx(11e-3), 1)  # 3 + 8
    assert report["current"] == (1e-3, 1)
    assert "cpu_only" not in report
