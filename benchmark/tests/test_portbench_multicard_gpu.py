"""On two or more cards (marker ``gpu``): a throwaway cell of
``min(4, device_count())`` cards (``multicard.py``, defined in memory)
runs through the whole harness, traced.  Its query queues a sleep on the
last card alone, or on every card at once, and reads nothing back, so
the test sees that a query's latency ends when its last card is done,
that each card's peak is read, and that the busy share is each card's
own, averaged: near 1 / cards with one sleeper, where a union over the
cards reads near 1, and near 1 with every card asleep, where a union
divided by the cards reads near 1 / cards."""
import time

import pytest
import torch

from benchmark import harness

from . import multicard
from .conftest import SEED

SLEEP_S = 0.05
ROWS = 1 << 20  # card i holds (i + 1) x 4 MiB


def _cycles_for(seconds: float, card) -> tuple:
    """The ``torch.cuda._sleep`` cycles that last about ``seconds`` on
    ``card``, and the seconds they took there (CUDA events)."""
    def timed(cycles):
        with torch.cuda.device(card):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)  # warm-up
            start.record()
            torch.cuda._sleep(cycles)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3

    probe = 10 ** 7
    cycles = int(probe * seconds / timed(probe))
    return cycles, timed(cycles)


@pytest.mark.gpu
@pytest.mark.parametrize("sleep_on", ["last", "all"])
def test_a_multi_card_cell_waits_for_reads_and_traces_every_card(
        monkeypatch, sleep_on):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    chips = min(4, torch.cuda.device_count())
    last = torch.device("cuda", chips - 1)
    cycles, slept = _cycles_for(SLEEP_S, last)
    name = multicard.install(monkeypatch, chips, cycles, sleep_on)
    for i in range(chips):  # earlier tests in this process left peaks
        torch.cuda.reset_peak_memory_stats(i)
    out = harness.run_cell(name, SEED, 1.0, True, torch.device("cuda", 0),
                           time.perf_counter(), {"rows_per_card": ROWS},
                           chips)
    assert out["correct"], out["checks"]
    assert multicard.seen["generate"] == [torch.device("cuda", i)
                                          for i in range(chips)]

    # the latency of a query covers the sleep on the last card
    assert out["latency_ms"]["median"] >= 0.9 * 1e3 * slept, (out, slept)

    # each card's peak, the fullest card's as the cell's
    dev = out["device"]
    per_card = dev["memory_peak_bytes_per_card"]
    shard = 4 * ROWS
    assert len(per_card) == chips
    assert all(p >= (i + 1) * shard for i, p in enumerate(per_card))
    assert per_card == sorted(per_card) and per_card[0] < per_card[-1]
    assert dev["memory_peak_bytes"] == max(per_card)

    # the busy share: a sleeping card is busy through most of the window,
    # the others run almost nothing
    share = dev["busy_s"] / dev["window_s"]
    want = 1 / chips if sleep_on == "last" else 1.0
    assert 0.7 * want < share < 1.3 * want, (share, dev)
    assert out["metrics"]["device.idle_pct"]["value"] == pytest.approx(
        100 * (1 - share))
