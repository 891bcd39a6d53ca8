"""Where the port's observability artifacts land.

The part of ``cylon_tpu/obs/export.py`` the planner's profiler reads:
``trace_dir`` and ``_artifact_path`` (``plan_profile.r<rank>.json``
beside the flight-recorder dumps).  The rank is this process's rank in
the ``torch.distributed`` group, or 0.  The Chrome-trace and metrics
exports (``export_trace``, ``export_metrics``, ``export_all``,
``load_trace``) and the run-id namespacing of the fleet identity wait for
the service layers (ROADMAP.md queue A, item 11).
"""
from __future__ import annotations

import os
from typing import Optional

from .. import config


def trace_dir() -> str:
    """Artifact directory (``CYLON_TPU_TRACE_DIR``, default ``traces``)."""
    return str(config.knob("CYLON_TPU_TRACE_DIR")) or "traces"


def default_rank() -> int:
    """This process's rank for artifact naming: its rank in the
    ``torch.distributed`` group when one is formed, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _artifact_path(path: Optional[str], prefix: str,
                   rank: Optional[int]) -> str:
    """``path`` when given, else ``<trace_dir>/<prefix>.r<rank>.json``
    (the directory made on demand)."""
    if path is not None:
        return path
    r = default_rank() if rank is None else int(rank)
    d = trace_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{prefix}.r{r}.json")
