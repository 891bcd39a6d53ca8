"""The port's ``utils`` package against the JAX package's, the
counterpart of ``tests/test_utils_subsystem.py``: uuid v4, value
printing, the timing shim over ``obs.spans``, the benchmark decorator,
``pow2ceil`` (the one copy the engine and the shuffle import), and the
``join.count`` / ``join.gather`` spans of a join."""
import logging
import re

import numpy as np
import pytest

from cylon_tpu import utils as rutils
from cylon_tpu_torch import CylonContext, Table, utils


def test_uuid_v4():
    u = utils.generate_uuid_v4()
    assert re.fullmatch(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab]"
                        r"[0-9a-f]{3}-[0-9a-f]{12}", u)
    assert utils.generate_uuid_v4() != u


@pytest.mark.parametrize("value,quote", [
    (None, False), (True, False), (False, False), (3, False),
    (2.5, False), ("x", True), ("x", False), (b"ab", False),
    (np.int32(7), False)])
def test_to_string(value, quote):
    assert utils.to_string(value, quote_strings=quote) == \
        rutils.to_string(value, quote_strings=quote)


def test_timing_spans(caplog):
    utils.timing_reset()
    with utils.span("phase.a"):
        pass
    with utils.span("phase.a"):
        pass
    total, count = utils.timing_report()["phase.a"]
    assert count == 2 and total >= 0
    try:
        utils.enable_timing(True)
        with caplog.at_level(logging.INFO, "cylon_tpu_torch.spans"):
            with utils.span("phase.logged"):
                pass
        assert any("phase.logged" in r.message for r in caplog.records)
    finally:
        utils.enable_timing(False)
    from cylon_tpu_torch.utils import timing

    assert not timing.enabled()


def test_benchmark_decorator():
    @utils.benchmark_with_repetitions(repetitions=3, time_type="us")
    def f(x):
        return x + 1

    avg_us, result = f(41)
    assert result == 42 and avg_us >= 0
    assert utils.benchmark_with_repitions is utils.benchmark_with_repetitions
    for unit in ("ms", "us", "s", "ns"):
        assert utils.time_conversion(1e6, unit) == \
            rutils.time_conversion(1e6, unit)
    with pytest.raises(ValueError):
        utils.time_conversion(1, "h")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 1025, 1 << 20])
def test_pow2ceil(n):
    from cylon_tpu_torch import exec as exec_mod
    from cylon_tpu_torch.parallel import shuffle

    assert utils.pow2ceil(n) == rutils.pow2ceil(n)
    assert utils.pow2ceil(n, 1) == rutils.pow2ceil(n, 1)
    # one rule: the engine and the shuffle use this very function
    assert exec_mod.pow2ceil is shuffle.pow2ceil is utils.pow2ceil


def test_join_emits_spans():
    utils.timing_reset()
    t = Table.from_pydict({"k": np.arange(50) % 7, "v": np.arange(50.0)},
                          ctx=CylonContext.Init("cpu"))
    t.join(t, on="k")
    rep = utils.timing_report()
    assert "join.count" in rep and "join.gather" in rep
