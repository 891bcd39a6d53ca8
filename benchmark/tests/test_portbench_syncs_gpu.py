"""On the card (marker ``gpu``): every host sync of the program on the
four cells' query paths is one of its named ``sync.<site>`` spans.

Each path runs at a small size under
``torch.cuda.set_sync_debug_mode("error")``, which the program's helpers
(``obs.spans.host_read``, ``host_select``) lift around their own read
alone, so any other sync raises and names itself: the join count and the
join -> group-by with the sort and with the hash join (the program's
calls of the join cells' query, without the query file's read of the
group count), Q1's calls and Q5's plan.  The same runs, traced, time the
join's count pass on the card within the traced wall."""
import time

import pytest
import torch

from benchmark import harness
from cylon_tpu_torch import config, pipeline
from cylon_tpu_torch.obs import spans
from cylon_tpu_torch.ops import hash_join
from cylon_tpu_torch.table import cap_round

from .conftest import SEED

SMALL = {
    "jg-sort-2p28": {"rows_per_side": 1 << 20, "key_domain": 1 << 20},
    "jg-hash-2p28": {"rows_per_side": 1 << 20, "key_domain": 1 << 20},
    "tpch-q5-sf10": {"scale_factor": 0.1},
    "tpch-q1-sf10": {"scale_factor": 0.1},
}


def _program_call(c, state):
    """The program's part of one query of the cell ``c``."""
    if c.name.startswith("jg-"):
        tables, algo = state["tables"], state["algo"]
        return lambda: pipeline.join_groupby(
            *tables, cap_round(pipeline.join_count(*tables, algo=algo)),
            algo=algo)
    return lambda: c.query.run(state)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_every_sync_is_a_named_span(cell, cuda_device):
    c = harness.Cell(cell, SMALL[cell])
    inputs = c.generator.generate(c.config, SEED, cuda_device)
    state = c.query.prepare(inputs, c.traffic.get("params", {}),
                            cuda_device)
    call = _program_call(c, state)
    call()  # builds and first-use allocations outside the checked run
    torch.cuda.synchronize()
    spans.reset()
    spans.reset_device()
    rounds = sum(hash_join.ROUNDS.values())
    t0 = time.perf_counter()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = sum(hash_join.ROUNDS.values()) - rounds
    syncs = {k: n for k, (_, n) in spans.aggregate_report().items()
             if k.startswith("sync.")}
    device = spans.device_report()
    assert syncs
    if cell == "jg-hash-2p28":
        assert sum(n for k, n in syncs.items()
                   if k.startswith("sync.hash_")) == 2 * rounds + 4
    if cell.startswith("jg-"):
        assert 0 < device["join.count"][0] <= wall
        assert device["join.count"][0] + device["groupby"][0] <= wall
    print(cell, syncs, {k: round(v[0] * 1e3, 3) for k, v in device.items()},
          f"wall {wall * 1e3:.3f} ms")
