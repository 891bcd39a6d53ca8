"""Join types and configs, sort options, and the environment-knob registry.

``JoinType``, ``JoinConfig`` and ``SortOptions`` mirror the JAX package's
``cylon_tpu/config.py:29``, ``:67`` and ``:107`` (reference:
join/join_config.hpp, table.hpp).
``KNOBS`` is the one place this package reads a
``CYLON_TPU_*`` environment variable; ``knob()`` is its only accessor, as in
``cylon_tpu/config.py:649``.  It holds only the knobs the ported modules
read.
"""
from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Tuple


class JoinType(enum.IntEnum):
    """reference: join/join_config.hpp JoinType."""

    INNER = 0
    LEFT = 1
    RIGHT = 2
    FULL_OUTER = 3


_JOIN_TYPE_OF = {
    "inner": JoinType.INNER, "left": JoinType.LEFT, "right": JoinType.RIGHT,
    "fullouter": JoinType.FULL_OUTER, "full_outer": JoinType.FULL_OUTER,
    "outer": JoinType.FULL_OUTER,
}


@dataclass(frozen=True)
class JoinConfig:
    """Join type x algorithm x key columns x output-name prefixes
    (``cylon_tpu/config.py:67``; reference: join/join_config.hpp:29-89).
    The algorithm is ``"sort"`` or ``"hash"``."""

    join_type: JoinType = JoinType.INNER
    algorithm: str = "sort"
    left_on: Tuple = ()
    right_on: Tuple = ()
    left_prefix: str = "l_"
    right_prefix: str = "r_"

    @staticmethod
    def of(join_type, algorithm: str = "sort", left_on=(), right_on=(),
           left_prefix: str = "l_", right_prefix: str = "r_") -> "JoinConfig":
        if isinstance(join_type, str):
            join_type = _JOIN_TYPE_OF[join_type.lower().replace("-", "_")]
        if algorithm not in ("sort", "hash"):
            raise ValueError(f"join algorithm must be sort/hash, got "
                             f"{algorithm!r}")
        return JoinConfig(JoinType(join_type), algorithm, _as_tuple(left_on),
                          _as_tuple(right_on), left_prefix, right_prefix)


def _as_tuple(v) -> Tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


@dataclass(frozen=True)
class SortOptions:
    """Options of the distributed sort's sampled-histogram range
    partitioner (``cylon_tpu/config.py:107``; reference: table.hpp:365-373
    SortOptions)."""

    ascending: bool = True
    num_bins: int = 0        # 0 -> 16 * world_size (reference default)
    num_samples: int = 0     # 0 -> 4096 per shard
    nulls_first: bool = True


@dataclass(frozen=True)
class Knob:
    """An environment knob: one of ``choices``, or an integer when
    ``choices`` is empty."""

    name: str
    default: str
    choices: Tuple[str, ...]
    help: str


KNOBS = {k.name: k for k in [
    Knob("CYLON_TPU_ACCUM", "auto", ("auto", "wide", "narrow"),
         "Accumulation precision: wide (f64/int64 accumulators), narrow "
         "(f32/int32, scans through the CUDA scan kernels), or auto "
         "(narrow for CUDA tensors, wide for CPU tensors)."),
    Knob("CYLON_TPU_MAX_STRING_WIDTH", "4096", (),
         "Widest byte matrix a string column may ingest without an explicit "
         "string_width= (device memory = capacity x width)."),
]}


def knob(name: str):
    """The knob's value: the environment's when it is set to one of the
    knob's choices (or parses as an integer, for an integer knob), else the
    registered default."""
    k = KNOBS[name]
    raw = os.environ.get(name)
    if not k.choices:
        try:
            return int(raw)
        except (TypeError, ValueError):
            return int(k.default)
    return raw if raw in k.choices else k.default
