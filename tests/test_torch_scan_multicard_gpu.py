"""On two CUDA cards or more (marker ``gpu``): the CUDA scans launch on
the card their tensor lives on, whatever card is current.  The
distributed group-by runs each shard's segmented scans with card 0
current.  Launched from card 0, the segmented scan of a card-k tensor
faults with an illegal memory access where the cards have no peer
access, and where they have it (after the exchange's copies) its output
sent the group-by's gathers out of bounds.  Each case keeps card k's
stream busy (a sleep), writes the input behind the sleep, scans with
card 0 current, and checks the result against the plain scan.  This file
imports neither jax nor cylon_tpu."""
import pytest
import torch

from cylon_tpu_torch.ops import scan

N = (1 << 22) + 12_345  # many tiles: the carry scan and the fix-up run
SLEEP_CYCLES = 50_000_000  # about 25 ms on an H100


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _behind_a_sleep(card, seed):
    """int32 values and segment starts made on ``card``'s stream after a
    sleep there, so a scan on another stream would read them unwritten."""
    gen = torch.Generator(device=card).manual_seed(seed)
    with torch.cuda.device(card):
        x = torch.full((N,), -7, dtype=torch.int32, device=card)
        reset = torch.zeros(N, dtype=torch.bool, device=card)
        torch.cuda.synchronize(card)
        torch.cuda._sleep(SLEEP_CYCLES)
        x.copy_(torch.randint(-1000, 1000, (N,), generator=gen,
                              device=card, dtype=torch.int32))
        reset.copy_(torch.rand(N, generator=gen, device=card) < 1e-3)
    return x, reset


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["sum", "max"])
def test_segmented_scan_on_another_card_than_the_current(cards, op):
    torch.cuda.set_device(cards[0])
    for k, card in enumerate(cards[1:], start=1):
        x, reset = _behind_a_sleep(card, seed=k)
        got = scan.segmented_scan(x, reset, op)
        assert got.device == card
        want = scan.segmented_scan_plain(x.cpu(), reset.cpu(), op)
        assert torch.equal(got.cpu(), want), (card, op)


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_1d_on_another_card_than_the_current(cards, reverse):
    torch.cuda.set_device(cards[0])
    for k, card in enumerate(cards[1:], start=1):
        x, _ = _behind_a_sleep(card, seed=100 + k)
        got = scan.scan_1d(x, "sum", reverse=reverse)
        assert got.device == card
        want = scan.scan_1d_plain(x.cpu(), "sum", reverse)
        assert torch.equal(got.cpu(), want), (card, reverse)
