"""The local group-by's frame reads nothing on the host: ``num_groups`` is
the group id of the last live row plus one, gathered on the device.

``hash_groupby`` and ``pipeline_groupby`` run with ``obs.spans``'s host
reads made to raise, and give bit for bit what the frame that read the
last row's index on the host (``_host_index_frame``, below) gives: keys,
aggregates, validity and ``num_groups``.  The cases: no live row, every
row live, one group, every key distinct, a CHAR(1) string key, and junk
past the count.  At capacity 0 the two frames agree, and both
group-bys raise ``IndexError`` with either frame."""
import numpy as np
import pytest
import torch

from cylon_tpu_torch import dtypes
from cylon_tpu_torch.column import Column
from cylon_tpu_torch.obs import spans as obs_spans
from cylon_tpu_torch.ops import groupby, segments

AggOp = groupby.AggOp
AGGS = ((1, AggOp.SUM), (1, AggOp.MEAN), (1, AggOp.MIN), (2, AggOp.MAX),
        (2, AggOp.COUNT), (1, AggOp.VAR), (2, AggOp.NUNIQUE))


def _host_index_frame(new_group, count, cap):
    """``groupby._group_frame`` with the last live row's index read on
    the host and used as a Python index into ``gid``."""
    gid = torch.cumsum(new_group, 0, dtype=torch.int32) - 1
    start, end = segments.segment_spans(new_group)
    iota = torch.arange(cap, dtype=torch.int32, device=new_group.device)
    live = iota < count
    last = (count - 1).clamp(0, cap - 1).cpu()
    num_groups = torch.where(count > 0, gid[last] + 1,
                             torch.zeros((), dtype=torch.int32,
                                         device=new_group.device))
    leader = start.clamp(0, cap - 1)
    group_live = iota < num_groups
    return gid, start, end, live, num_groups, leader, group_live


def _no_host_read(*args, **kwargs):
    raise AssertionError("the group-by read the host")


def _key(case, rng, cap, count):
    """The key column of ``case``, its live rows in key order (so that
    ``pipeline_groupby`` may take them) and junk past ``count``."""
    if case == "one_group":
        k = np.full(cap, 5, np.int32)
    elif case == "all_distinct":
        k = np.arange(cap, dtype=np.int32) * 3 - 7
    else:
        k = np.sort(rng.integers(-4, 4, cap).astype(np.int32))
    k[count:] = rng.integers(-4, 4, cap - count)  # junk, live-looking keys
    valid = np.ones(cap, bool)  # junk rows claim validity too
    if case == "char1":
        mat = (k.astype(np.int64) - k.min() + 0x61).astype(np.uint8)
        return Column(torch.from_numpy(mat.reshape(cap, 1)),
                      torch.from_numpy(valid), torch.ones(cap,
                                                          dtype=torch.int32),
                      dtypes.string)
    return Column(torch.from_numpy(k), torch.from_numpy(valid), None,
                  dtypes.int32)


CASES = {  # case: (capacity, live count)
    "count_0": (16, 0),
    "count_is_capacity": (16, 16),
    "one_group": (16, 11),
    "all_distinct": (16, 16),
    "char1": (32, 27),
    "junk_past_count": (32, 19),
}


def _columns(case):
    cap, count = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + cap)
    key = _key(case, rng, cap, count)
    v = torch.from_numpy(rng.random(cap).astype(np.float32))
    vvalid = torch.from_numpy(rng.random(cap) > 0.2)
    w = torch.from_numpy(rng.integers(-50, 50, cap).astype(np.int32))
    return (key, Column(v, vvalid, None, dtypes.float_),
            Column(w, torch.ones(cap, dtype=torch.bool), None,
                   dtypes.int32)), count


def _assert_bit_for_bit(got, want):
    (gcols, gm), (wcols, wm) = got, want
    assert gm.dtype == wm.dtype and torch.equal(gm, wm)
    assert len(gcols) == len(wcols)
    for g, w in zip(gcols, wcols):
        assert g.dtype == w.dtype
        assert torch.equal(g.data.view(torch.uint8),
                           w.data.view(torch.uint8))
        assert torch.equal(g.validity, w.validity)
        assert (g.lengths is None) == (w.lengths is None)
        if g.lengths is not None:
            assert torch.equal(g.lengths, w.lengths)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry", ["hash_groupby", "pipeline_groupby"])
def test_group_by_reads_no_host_and_matches_the_host_index(monkeypatch,
                                                           entry, case):
    cols, count = _columns(case)
    run = getattr(groupby, entry)
    with monkeypatch.context() as m:
        m.setattr(groupby, "_group_frame", _host_index_frame)
        want = run(cols, count, (0,), AGGS)
    monkeypatch.setattr(obs_spans, "host_read", _no_host_read)
    monkeypatch.setattr(obs_spans, "host_select", _no_host_read)
    got = run(cols, torch.tensor(count, dtype=torch.int32), (0,), AGGS)
    _assert_bit_for_bit(got, want)
    groups = {"count_0": 0, "one_group": 1, "all_distinct": 16}
    if case in groups:
        assert int(got[1]) == groups[case]


@pytest.mark.parametrize("count", [0, 3])
def test_capacity_zero_matches_the_host_index(monkeypatch, count):
    # an empty frame's boundary mask has one row (rows_equal_adjacent
    # pads its first row)
    new_group = torch.ones(1, dtype=torch.bool)
    n = torch.tensor(count, dtype=torch.int32)
    want = _host_index_frame(new_group, n, 0)
    monkeypatch.setattr(obs_spans, "host_read", _no_host_read)
    got = groupby._group_frame(new_group, n, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    key = Column(torch.zeros(0, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.bool), None, dtypes.int32)
    for entry in (groupby.hash_groupby, groupby.pipeline_groupby):
        with pytest.raises(IndexError):
            entry((key, key), count, (0,), ((1, AggOp.SUM),))
        with monkeypatch.context() as m:
            m.setattr(groupby, "_group_frame", _host_index_frame)
            with pytest.raises(IndexError):
                entry((key, key), count, (0,), ((1, AggOp.SUM),))
