"""Utility subsystem: uuid, value printing, timing spans, the benchmark
decorator and the one capacity-rounding rule.

The port of ``cylon_tpu/utils/`` (reference: util/uuid.cpp,
util/to_string.hpp, pycylon util/benchutils.py, the CYLON_DEBUG chrono
spans).  ``span`` / ``timing_report`` / ``timing_reset`` /
``enable_timing`` are a shim over ``obs.spans``.  The reference's
``compile_cache.py`` is jax's persistent compilation cache and has no
counterpart here: the port compiles its CUDA kernels once per process
into ``build/cylon_tpu_torch/`` (``cuda/build.py``), and nothing is
traced.  Nor has its ``shard_map`` shim, a jax version guard.
"""
from __future__ import annotations

import uuid as _uuid

from .benchutils import (benchmark_with_repetitions,  # noqa: F401
                         benchmark_with_repitions, time_conversion)
from .timing import enable as enable_timing  # noqa: F401
from .timing import report as timing_report  # noqa: F401
from .timing import reset as timing_reset  # noqa: F401
from .timing import span  # noqa: F401


def generate_uuid_v4() -> str:
    """reference: util/uuid.cpp generate_uuid_v4."""
    return str(_uuid.uuid4())


def pow2ceil(n: int, min_size: int = 8) -> int:
    """Smallest power of two >= n (>= 1), floored at ``min_size``: the one
    capacity-rounding rule every planner and kernel shares, so shard
    capacities never disagree (``cylon_tpu/utils/__init__.py:39``)."""
    return max(min_size, 1 << (max(1, int(n)) - 1).bit_length())


def to_string(value, quote_strings: bool = False) -> str:
    """CSV-ish scalar rendering (reference: util/to_string.hpp): nulls
    print empty, strings optionally quoted."""
    if value is None:
        return ""
    if isinstance(value, float):
        return repr(value)
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (bytes, bytearray)):
        value = value.decode("utf-8", "replace")
    if isinstance(value, str) and quote_strings:
        return f'"{value}"'
    return str(value)
