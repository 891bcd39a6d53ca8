"""On two CUDA cards or more (marker ``gpu``), the four-card cell
``jg-sort-1b-4card`` at a small size on ``min(4, device_count())`` cards:

- the program's call of the query, ``pipeline.distributed_join_groupby``,
  under ``torch.cuda.set_sync_debug_mode("error")`` makes no host sync
  outside its named ``sync.<site>`` spans, and the count matrix of each
  of its three exchanges (both join sides, the group-by's partials) is
  one ``sync.shuffle_counts``;
- a traced run through the harness is correct, its rooflines, the
  murmur3 kernel's, the copies' between cards and the scans', read at
  most 100%, and it sorts four times a card."""
import time

import pytest
import torch

from benchmark import harness
from cylon_tpu_torch import config, pipeline
from cylon_tpu_torch.obs import spans

from .conftest import SEED

CELL = "jg-sort-1b-4card"


@pytest.fixture
def chips():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return min(4, torch.cuda.device_count())


@pytest.mark.gpu
def test_every_sync_is_a_named_span(chips):
    c = harness.Cell(CELL, {"rows_per_side": 1 << 22,
                            "key_domain": 1 << 22})
    devices = harness.cards(torch.device("cuda", 0), chips)
    inputs = c.generator.generate(c.config, SEED, devices)
    state = c.query.prepare(inputs, c.traffic["params"], devices)

    def call():
        return pipeline.distributed_join_groupby(state["left"],
                                                 state["right"])

    call()  # builds and first-use allocations outside the checked run
    harness.sync(devices)
    spans.reset()
    with config.knob_env(CYLON_TPU_TRACE="1"):
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    harness.sync(devices)
    syncs = {k: n for k, (_, n) in spans.aggregate_report().items()
             if k.startswith("sync.")}
    assert syncs["sync.shuffle_counts"] == 3
    assert syncs["sync.join_count"] == chips


@pytest.mark.gpu
def test_traced_run_reads_its_rooflines_under_100(chips):
    out = harness.run_cell(CELL, SEED, 2.0, True, torch.device("cuda", 0),
                           time.perf_counter(),
                           {"rows_per_side": 1 << 26, "key_domain": 1 << 26},
                           chips=chips)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    print("metrics", m)
    for name in ("cuda.murmur3_roofline", "shuffle.p2p_roofline",
                 "cuda.scan_path_roofline"):
        assert 0 < m[name] <= 100, name
    assert m["lexsort.sorts"] == 4 * chips
    assert m["shuffle.device_ms"] > 0 and m["shuffle.cross_gib"] > 0
