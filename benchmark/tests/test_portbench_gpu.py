"""On the card (marker ``gpu``): every cell, at a size a test run can
hold, runs correct through the whole harness with tracing on, and the
control fails its limits there too."""
import time

import pytest

from benchmark import calibrate, harness

from .conftest import SEED

SMALL = {
    "jg-sort-2p28": {"rows_per_side": 1 << 22, "key_domain": 1 << 22},
    "jg-hash-2p28": {"rows_per_side": 1 << 22, "key_domain": 1 << 22},
    "tpch-q5-sf10": {"scale_factor": 0.5},
    "tpch-q1-sf10": {"scale_factor": 0.5},
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cell, cuda_device):
    out = harness.run_cell(cell, SEED, 1.0, True, cuda_device,
                           time.perf_counter(), SMALL[cell])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    c = harness.Cell(cell, SMALL[cell])
    control = calibrate.control_numbers(c, SEED, cuda_device)
    assert any(control[k] > lim for k, lim in c.limits.items())
