"""The four-card cell ``jg-sort-1b-4card`` on the CPU at a tiny size, on
``"cpu"`` once a card: a sound run through the whole harness is correct,
traced too; the generator gives every seed the same work; and each fault
the cell can have turns ``correct`` false: an answer altered where it is
produced, half of every input's rows left out, and one segment of the
exchange (source shard 1 to destination shard 2) dropped.  Its readers
read nothing, and raise nothing, where the program lacks what they
read."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, trace
from benchmark.data import join_groupby_sharded
from benchmark.queries import distributed_join_groupby as query
from cylon_tpu_torch.parallel import collectives
from cylon_tpu_torch.parallel import ops as par_ops

from .conftest import SEED

CELL = "jg-sort-1b-4card"
TINY = {"rows_per_side": 1 << 12, "key_domain": 1 << 12}


def run(trace_on=False):
    return harness.run_cell(CELL, SEED, 0.2, trace_on, "cpu",
                            time.perf_counter(), TINY, chips=4)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert out["metrics"]["rows_per_s"]["value"] > 0


def test_sound_traced_run_reads_the_exchange():
    out = run(trace_on=True)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    # 3 count matrices, 4 join counts, 8 group counts (partial and final)
    assert m["host.syncs"] == 15.0
    assert m["shuffle.cross_gib"] > 0
    # four packed lexsorts a shard: two in the local join, one in each
    # group-by (partial and final)
    assert m["lexsort.sorts"] == 16.0
    # the CPU runs no CUDA scan: its roofline reads nothing, and no error
    assert "cuda.scan_path_roofline" not in m


def test_every_seed_the_same_work():
    cfg = {**harness.Cell(CELL).config, **TINY}

    def work(seed):
        d = join_groupby_sharded.generate(cfg, seed, ["cpu"] * 4)
        cl, cr = (torch.bincount(torch.cat(d[s]["k"]).long(),
                                 minlength=TINY["key_domain"])
                  for s in ("left", "right"))
        return int((cl * cr).sum()), int(((cl > 0) & (cr > 0)).sum()), d

    m1, g1, d1 = work(SEED)
    m2, g2, d2 = work(SEED + 1)
    assert (m1, g1) == (m2, g2)
    assert [k.shape[0] for k in d1["left"]["k"]] == [1 << 10] * 4
    assert not torch.equal(d1["left"]["k"][0], d2["left"]["k"][0])
    assert torch.equal(d1["left"]["k"][0],
                       join_groupby_sharded.generate(
                           cfg, SEED, ["cpu"] * 4)["left"]["k"][0])


def test_altered_group_sum(monkeypatch):
    real = par_ops.finalize_groupby_columns

    def altered(*args, **kwargs):
        cols = real(*args, **kwargs)
        cols[1].data[0] *= 1.01
        return cols

    monkeypatch.setattr(par_ops, "finalize_groupby_columns", altered)
    out = run()
    assert not out["correct"]
    assert out["checks"]["sum_rel_gap"]["value"] > \
        out["checks"]["sum_rel_gap"]["limit"]


def test_half_the_rows_left_out(monkeypatch):
    """The program sees the first half of every shard's rows; the
    reference all of them."""
    real = query._table

    def half(ctx, cols, value_name):
        t = real(ctx, cols, value_name)
        t.counts = tuple(c // 2 for c in t.counts)
        return t

    monkeypatch.setattr(query, "_table", half)
    assert not run()["correct"]


def test_one_exchange_segment_dropped(monkeypatch):
    """Every exchange drops the rows shard 1 sends to shard 2: they are
    counted as received, but stay zero and invalid."""
    real = collectives.all_to_all
    dropped = []

    def drop(send, sizes, out, group=None):
        sizes = sizes.copy()
        dropped.append(int(sizes[1, 2]))
        kept = [o.clone() for o in out]
        res = real(send, sizes, out, group)
        at = int(sizes[:1, 2].sum())
        n = int(sizes[1, 2])
        res[2][at:at + n] = kept[2][at:at + n]
        return res

    monkeypatch.setattr(collectives, "all_to_all", drop)
    out = run()
    assert sum(dropped) > 0
    assert not out["correct"]


def test_readers_read_nothing_where_the_program_lacks_it(monkeypatch):
    from cylon_tpu_torch.obs import metrics, spans
    from cylon_tpu_torch.ops import hash_kernels

    run_ = SimpleNamespace(trace=SimpleNamespace(queries=2, families={}))
    monkeypatch.delattr(hash_kernels, "BYTES")
    murmur = harness.reader("cuda.murmur3_roofline")
    assert murmur.read(run_, murmur.begin(run_)) is None
    monkeypatch.setattr(metrics, "snapshot", lambda: {"counters": {}})
    cross = harness.reader("shuffle.cross_gib")
    assert cross.read(run_, cross.begin(run_)) is None
    monkeypatch.delattr(spans, "device_report")
    dev = harness.reader("shuffle.device_ms")
    assert dev.read(run_, dev.begin(run_)) is None
    p2p = harness.reader("shuffle.p2p_roofline")
    token = p2p.begin(run_)
    trace.reduce([], [], 1)  # a trace with no copies between cards
    assert p2p.read(run_, token) is None
    assert trace.reduce is token.reduce


def _copy(device, nbytes, dur_us):
    args = {"device": device, "stream": 7}
    if nbytes is not None:
        args["bytes"] = nbytes
    return {"ph": "X", "name": "Memcpy PtoP (Device -> Device)",
            "cat": "gpu_memcpy", "ts": 0, "dur": dur_us, "args": args}


def test_p2p_roofline_is_each_cards_own_share_averaged(monkeypatch):
    r = harness.reader("shuffle.p2p_roofline")
    run_ = SimpleNamespace(trace=SimpleNamespace(queries=2))
    token = r.begin(run_)
    peak = r.LINK_BYTES_PER_S
    events = [_copy(0, peak * 1e-3, 1000), _copy(0, peak * 1e-3, 3000),
              _copy(1, peak * 1e-3, 1000),
              {"ph": "X", "name": "Memcpy DtoD (Device -> Device)",
               "cat": "gpu_memcpy", "ts": 0, "dur": 10,
               "args": {"device": 1, "bytes": 1}}]
    trace.reduce(events, [], 1)
    # card 0: 2 ms of bytes in 4 ms, 50%; card 1: 1 ms in 1 ms, 100%
    assert r.read(run_, token) == pytest.approx(75.0)


def test_p2p_roofline_falls_back_on_the_counter(monkeypatch):
    from cylon_tpu_torch.obs import metrics

    counted = {"shuffle.bytes_cross": 0}
    monkeypatch.setattr(metrics, "snapshot",
                        lambda: {"counters": dict(counted)})
    r = harness.reader("shuffle.p2p_roofline")
    run_ = SimpleNamespace(trace=SimpleNamespace(queries=2))
    token = r.begin(run_)
    counted["shuffle.bytes_cross"] = r.LINK_BYTES_PER_S * 2e-3  # 2 queries
    trace.reduce([_copy(0, None, 1000), _copy(1, None, 3000)], [], 2)
    # per query: 1 ms of bytes over 2 ms of copies
    assert r.read(run_, token) == pytest.approx(50.0)


def test_murmur3_roofline_and_exchange_ms(monkeypatch):
    from cylon_tpu_torch.obs import spans
    from cylon_tpu_torch.ops import hash_kernels

    monkeypatch.setitem(hash_kernels.BYTES, "hash_partition", 0)
    fam = "CUDA hash kernel (cuda/murmur3.cu)"
    r = harness.reader("cuda.murmur3_roofline")
    run_ = SimpleNamespace(trace=SimpleNamespace(queries=2,
                                                 families={fam: 0.002}))
    token = r.begin(run_)
    hash_kernels.BYTES["hash_partition"] += int(r.HBM_BYTES_PER_S * 1e-3)
    assert r.read(run_, token) == pytest.approx(50.0)

    seconds = {"shuffle.plan": (0.25, 2), "shuffle.exchange": (0.5, 2),
               "join.count": (9.0, 2)}
    monkeypatch.setattr(spans, "device_report", lambda: dict(seconds))
    d = harness.reader("shuffle.device_ms")
    token = d.begin(run_)
    seconds["shuffle.plan"] = (0.45, 4)
    seconds["shuffle.exchange"] = (0.9, 4)
    assert d.read(run_, token) == pytest.approx(300.0)
