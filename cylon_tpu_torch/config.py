"""Join types and the environment-knob registry.

``JoinType`` mirrors the JAX package's ``cylon_tpu/config.py:29`` (reference:
join/join_config.hpp).  ``KNOBS`` is the one place this package reads a
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


@dataclass(frozen=True)
class Knob:
    name: str
    default: str
    choices: Tuple[str, ...]
    help: str


KNOBS = {k.name: k for k in [
    Knob("CYLON_TPU_ACCUM", "auto", ("auto", "wide", "narrow"),
         "Accumulation precision: wide (f64/int64 accumulators), narrow "
         "(f32/int32, scans through the CUDA scan kernels), or auto "
         "(narrow for CUDA tensors, wide for CPU tensors)."),
]}


def knob(name: str) -> str:
    """The knob's value: the environment's when it is set to one of the
    knob's choices, else the registered default."""
    k = KNOBS[name]
    raw = os.environ.get(name)
    return raw if raw in k.choices else k.default
