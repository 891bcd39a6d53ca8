"""Accumulation-precision policy: wide (64-bit) vs narrow (32-bit) kernels.

The port of ``cylon_tpu/precision.py``.  ``wide`` accumulates floats in
f64 and counts in int64; ``narrow`` accumulates in f32 with int32 counts
and sends every run and segment scan through the CUDA scan kernels
(``ops/scan.py``).  Integer SUM accumulates int64 in both modes.

Resolution order: ``set_accumulation()`` > ``CYLON_TPU_ACCUM`` > the
device of the data: narrow for CUDA tensors, wide for CPU tensors (the
JAX package picks narrow on a TPU and wide elsewhere,
``cylon_tpu/precision.py:56``).  Every query takes the device the data
lives on, since the default follows it.
"""
from __future__ import annotations

import torch

from . import config

_MODE: "str | None" = None  # None = auto-resolve


def set_accumulation(mode: "str | None") -> None:
    """Force ``"wide"`` or ``"narrow"`` accumulation (None = auto)."""
    global _MODE
    if mode not in (None, "wide", "narrow"):
        raise ValueError(f"accumulation mode must be wide/narrow, got {mode}")
    _MODE = mode


def accumulation_mode(device: torch.device) -> str:
    if _MODE is not None:
        return _MODE
    env = config.knob("CYLON_TPU_ACCUM")
    if env in ("wide", "narrow"):
        return env
    return "narrow" if torch.device(device).type == "cuda" else "wide"


def narrow(device: torch.device) -> bool:
    return accumulation_mode(device) == "narrow"


def float_acc(device: torch.device) -> torch.dtype:
    """Accumulator dtype for float prefix sums / derived statistics."""
    return torch.float32 if narrow(device) else torch.float64


def float_acc_for(data_dtype: torch.dtype,
                  device: torch.device) -> torch.dtype:
    """Float accumulator for a float SUM: input width in wide mode, f32 in
    narrow mode."""
    if narrow(device):
        return torch.float32
    return torch.float64 if data_dtype == torch.float64 else torch.float32


def int_acc() -> torch.dtype:
    """Accumulator for integer sums: always int64."""
    return torch.int64


def count_acc() -> torch.dtype:
    """Count accumulations run in int32 (cardinality < 2^31 per table)."""
    return torch.int32
