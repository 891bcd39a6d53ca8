"""The CUDA scan kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode.  This file imports neither jax nor cylon_tpu, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: exact for integers and min/max; float32 sums rtol=1e-5 against
a float64 oracle (tree-order rounding)."""
import pytest
import torch

from cylon_tpu_torch.ops import scan

# across one tile (4096), its edges, and three recursion levels
SIZES = (1, 4095, 4096, 4097, 3 * 4096 * 4096 + 5)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(1)


@pytest.mark.gpu
@pytest.mark.parametrize("op", scan.OPS)
def test_scan_1d_kernel_matches_plain(gen, op):
    for n in SIZES:
        x = torch.randint(-1000, 1000, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        for rev in (False, True):
            assert torch.equal(scan.scan_1d(x, op, rev),
                               scan.scan_1d_plain(x, op, rev))  # exact


@pytest.mark.gpu
@pytest.mark.parametrize("op", scan.OPS)
def test_segmented_scan_kernel_matches_plain(gen, op):
    for n in SIZES:
        x = torch.randint(-1000, 1000, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        for p in (0.0, 0.001, 0.4, 1.0):
            r = torch.rand(n, generator=gen, device="cuda") < p
            assert torch.equal(scan.segmented_scan(x, r, op),
                               scan.segmented_scan_plain(x, r, op))  # exact


@pytest.mark.gpu
def test_float_sums_uint32_and_launch_counts(gen):
    n = 3 * 4096 * 4096 + 5
    x = torch.rand(n, generator=gen, device="cuda")
    r = torch.rand(n, generator=gen, device="cuda") < 0.01
    scan.reset_launches()
    got = scan.segmented_scan(x, r, "sum").double()
    want = scan.segmented_scan_plain(x.double(), r, "sum")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    got = scan.scan_1d(x, "sum", reverse=True).double()
    want = scan.scan_1d_plain(x.double(), "sum", reverse=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert scan.LAUNCHES == {"scan_1d": 1, "segmented_scan": 1}
    xu = torch.randint(0, 1 << 31, (4097,), generator=gen, device="cuda",
                       dtype=torch.int32).view(torch.uint32)
    for op in scan.OPS:  # compared as bit patterns
        assert torch.equal(scan.scan_1d(xu, op).view(torch.int32),
                           scan.scan_1d_plain(xu, op).view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        scan.scan_1d(x[::2], "sum")
