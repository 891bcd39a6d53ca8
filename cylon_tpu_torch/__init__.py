"""cylon_tpu_torch: the PyTorch / CUDA port of cylon_tpu for NVIDIA Hopper.

Columns are torch tensors with a static capacity and a live-row count, as
in the JAX package.  Entry points that create tensors from host data run
on the CUDA card unless the caller passes ``device="cpu"``; without a card
they raise.  Relational kernels run wherever their input tensors live.
The JAX package's Pallas TPU kernels become hand-written CUDA kernels
(``cuda/``), built with ``nvcc`` at first use; each has a plain PyTorch
version beside it that CPU tensors take.  A ``CylonContext`` holds an
mesh of shards, in one process or over a ``torch.distributed`` process
group (``context.py``), over which a ``Table`` runs the distributed
rung (``parallel/``): sort-merge and hash joins, hash and
pipeline group-bys, NUNIQUE, sorts, set ops and broadcasts.  ``exec``
streams key-domain passes of a join (and group-by) over host frames
larger than the card's memory, splitting passes that run out of it
(``resilience``).  ``io`` reads and writes CSV (through the port's own
native C++ reader, ``native/``) and Parquet, and ``DataFrame``,
``Series`` and the ``Index`` classes are the pandas-like facade over
``Table``.  ``Table.plan()`` starts a lazy query plan (``plan/``: shuffle
elision from tracked partitioning, column pruning, the fused join ->
aggregate shard body, ``explain``), and ``utils`` holds the timing shim,
the benchmark decorator and ``pow2ceil``.  ``cylon_tpu_torch.serve``
(``QueryService``: admission, per-tenant budgets, one scheduler thread,
the journal as a result cache) and ``cylon_tpu_torch.stream``
(``StreamTable`` and its incremental ``GroupByQuery`` / ``JoinQuery``)
are subpackages imported on demand, as in the JAX package.  pandas and
pyarrow are imported only inside the functions that need them.
"""
from __future__ import annotations

from . import (column, compute, config, context, dtypes, durable, exec,
               interop, io, native, obs, pipeline, plan, precision,
               resilience, status, table, utils)
from .column import Column, default_device
from .config import JoinAlgorithm, JoinConfig, JoinType, SortOptions
from .context import CommType, CylonContext, LocalConfig, MeshConfig
from .frame import DataFrame
from .index import (CategoricalIndex, ColumnIndex, Index, Int64Index,
                    IntegerIndex, NumericIndex, RangeIndex)
from .ops.groupby import AggOp
from .series import Series
from .status import Code, CylonError, Status
from .table import Table

__version__ = "0.1.0"

__all__ = ["AggOp", "CategoricalIndex", "Code", "Column", "ColumnIndex",
           "CommType", "CylonContext", "CylonError", "DataFrame", "Index",
           "Int64Index", "IntegerIndex", "JoinAlgorithm", "JoinConfig",
           "JoinType", "LocalConfig", "MeshConfig", "NumericIndex",
           "RangeIndex", "Series", "SortOptions", "Status", "Table",
           "__version__", "column", "compute", "config", "context",
           "default_device", "dtypes", "durable", "exec", "interop", "io",
           "native", "obs", "pipeline", "precision", "resilience", "status",
           "table"]
