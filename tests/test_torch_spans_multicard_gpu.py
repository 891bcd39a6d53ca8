"""On two CUDA cards or more (marker ``gpu``): a span is timed on the
streams of the cards its work runs on.  A span whose work sleeps on card
1 reads that card's stream time, where card 0's stream, idle the while,
reads nearly none; a span over both cards reads the sum of the two
cards' times.  This file imports neither jax nor cylon_tpu."""
import pytest
import torch

from cylon_tpu_torch import config
from cylon_tpu_torch.obs import spans

SLEEP_CYCLES = 20_000_000  # about 10 ms on an H100


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    spans.reset()
    spans.reset_device()
    yield torch.device("cuda", 0), torch.device("cuda", 1)
    spans.reset()
    spans.reset_device()


def _sleep(card):
    with torch.cuda.device(card):
        torch.cuda._sleep(SLEEP_CYCLES)


def _sleep_seconds(card) -> float:
    """The sleep's seconds on ``card`` by CUDA events."""
    with torch.cuda.device(card):
        _sleep(card)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _sleep(card)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3


@pytest.mark.gpu
def test_a_span_reads_the_card_its_work_runs_on(two_cards):
    card0, card1 = two_cards
    torch.cuda.set_device(card0)
    slept = _sleep_seconds(card1)
    _sleep_seconds(card0)
    torch.cuda.synchronize(card0)
    torch.cuda.synchronize(card1)
    with config.knob_env(CYLON_TPU_TRACE="1"):
        with spans.span("on_card1", devices=card1):
            _sleep(card1)
        torch.cuda.synchronize(card1)
        with spans.span("current_stream"):  # card 0's, idle
            _sleep(card1)
        torch.cuda.synchronize(card1)
        with spans.span("both", devices=[card0, card1, card1]):
            _sleep(card0)
            _sleep(card1)
    report = spans.device_report()
    assert report["on_card1"][1] == 1
    assert report["on_card1"][0] == pytest.approx(slept, rel=0.2)
    assert report["current_stream"][0] < 0.1 * slept
    assert report["both"][0] == pytest.approx(2 * slept, rel=0.2)
