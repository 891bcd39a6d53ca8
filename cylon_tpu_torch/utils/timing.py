"""Timing shim over ``obs.spans``, the one timing substrate
(``cylon_tpu/utils/timing.py``).  ``span`` IS ``obs.spans.span``
(aggregate totals always accumulate; ``CYLON_TPU_TRACE=1`` also buffers
events), and ``report()`` / ``reset()`` read and clear the same
aggregates.  Spans time host wall-clock: device work lands in the span
that waits for it."""
from __future__ import annotations

from typing import Dict, Tuple

from ..obs import spans as _spans
from ..obs.spans import span  # noqa: F401  (the shimmed entry point)


def enable(on: bool = True) -> None:
    """Flip the per-span INFO log (``obs.spans.enable_log``)."""
    _spans.enable_log(on)


def enabled() -> bool:
    return _spans.log_enabled()


def report() -> Dict[str, Tuple[float, int]]:
    """{span name: (total seconds, call count)} snapshot."""
    return _spans.aggregate_report()


def reset() -> None:
    """Clear the aggregates only; buffered trace events survive (use
    ``obs.spans.reset`` for everything)."""
    _spans.reset_aggregates()
