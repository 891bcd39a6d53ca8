"""Shared pieces of the benchmark's own tests: tiny sizes of each cell's
configuration, small enough for the CPU."""
import pytest

TINY = {
    "jg-sort-2p28": {"rows_per_side": 1 << 12, "key_domain": 1 << 12},
    "jg-hash-2p28": {"rows_per_side": 1 << 12, "key_domain": 1 << 12},
    "tpch-q5-sf10": {"scale_factor": 0.005},
    "tpch-q1-sf10": {"scale_factor": 0.005},
}
SEED = (1 << 31) + 12345  # larger than 32 signed bits hold


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
