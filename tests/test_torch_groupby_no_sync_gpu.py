"""On the card (marker ``gpu``): the group-by queues its work without a
host sync.

- On one card, ``hash_groupby`` and ``pipeline_groupby`` run under
  ``torch.cuda.set_sync_debug_mode("error")`` without raising.
- On two cards or more, the distributed group-by of a joined table of
  one shard a card syncs once: the partial shuffle's count matrix,
  ``sync.shuffle_counts``."""
import pytest
import torch

from cylon_tpu_torch import CylonContext, MeshConfig, Table, config, dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.obs import spans
from cylon_tpu_torch.ops import groupby

AggOp = groupby.AggOp
AGGS = ((1, AggOp.SUM), (1, AggOp.MEAN), (1, AggOp.MIN), (1, AggOp.MAX),
        (1, AggOp.COUNT), (1, AggOp.VAR))
ROWS = 1 << 16


def _strict(call):
    """``call()`` under the "error" sync debug mode, traced; returns its
    result and the ``sync.*`` span counts."""
    spans.reset()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = {k: n for k, (_, n) in spans.aggregate_report().items()
             if k.startswith("sync.")}
    return out, syncs


def _columns(device, rows, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randint(0, rows // 8, (rows,), generator=g, device=device,
                      dtype=torch.int32)
    v = torch.rand(rows, generator=g, device=device)
    live = torch.ones(rows, dtype=torch.bool, device=device)
    return (Column(k, live, None, dtypes.int32),
            Column(v, live.clone(), None, dtypes.float_))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["hash_groupby", "pipeline_groupby"])
def test_local_group_by_never_syncs(cuda_device, entry):
    key, val = _columns(cuda_device, ROWS, 7)
    if entry == "pipeline_groupby":  # key-grouped input
        order = torch.argsort(key.data, stable=True)
        key, val = key.take(order), val.take(order)
    cols = (key, val)
    count = torch.tensor(ROWS - 100, dtype=torch.int32, device=cuda_device)
    run = getattr(groupby, entry)
    want = run(cols, count, (0,), AGGS)  # builds outside the checked run
    torch.cuda.synchronize()
    got, syncs = _strict(lambda: run(cols, count, (0,), AGGS))
    torch.cuda.synchronize()
    assert syncs == {}
    assert torch.equal(got[1], want[1]) and 0 < int(got[1]) <= ROWS // 8
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.data, w.data)
        assert torch.equal(g.validity, w.validity)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


def _table(ctx, cards, seed, name):
    shards, counts = [], []
    for i, card in enumerate(cards):
        k, v = _columns(card, ROWS, seed + i)
        shards.append((k, v))
        counts.append(torch.tensor(ROWS, dtype=torch.int32, device=card))
    return Table(tuple(shards), tuple(counts), ("k", name), ctx)


@pytest.mark.gpu
def test_distributed_group_by_syncs_once(cards):
    ctx = CylonContext.InitDistributed(MeshConfig(devices=cards))
    joined = _table(ctx, cards, 11, "lv").distributed_join(
        _table(ctx, cards, 23, "rv"), on="k")

    def call():
        return joined.groupby("l_k", {"lv": "sum", "rv": "mean"})

    want = call()  # builds and first-use allocations
    for card in cards:
        torch.cuda.synchronize(card)
    got, syncs = _strict(call)
    for card in cards:
        torch.cuda.synchronize(card)
    assert syncs == {"sync.shuffle_counts": 1}
    assert [int(c) for c in got.counts] == [int(c) for c in want.counts]
    assert sum(int(c) for c in got.counts) > 0
