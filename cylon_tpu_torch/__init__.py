"""cylon_tpu_torch: the PyTorch / CUDA port of cylon_tpu for NVIDIA Hopper.

Columns are torch tensors with a static capacity and a live-row count, as
in the JAX package.  Entry points that create tensors from host data run
on the CUDA card unless the caller passes ``device="cpu"``; without a card
they raise.  Relational kernels run wherever their input tensors live.
The JAX package's Pallas TPU kernels become hand-written CUDA kernels
(``cuda/``), built with ``nvcc`` at first use; each has a plain PyTorch
version beside it that CPU tensors take.
"""
from __future__ import annotations

from . import column, config, dtypes, interop, pipeline, precision, status
from .column import Column, default_device
from .config import JoinType
from .status import Code, CylonError

__all__ = ["Code", "Column", "CylonError", "JoinType", "column", "config",
           "default_device", "dtypes", "interop", "pipeline", "precision",
           "status"]
