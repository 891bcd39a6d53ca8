"""Chrome-trace/Perfetto export of the span buffer and a flat metrics
JSON, and where the port's observability artifacts land.

A copy of ``cylon_tpu/obs/export.py``.  The trace file is the Chrome
Trace Event JSON object form (``{"traceEvents": [...]}``) with "X"
complete events and "i" instants (``ts``/``dur`` in microseconds), one
``pid`` per rank and the recording thread as ``tid``; it loads in
``ui.perfetto.dev`` and in the repo's stdlib tools
(``tools/trace_report.py``, ``tools/critical_path.py``).  File names
carry the rank (``trace.r{rank}.json``, or ``trace.<run_id>.r{rank}.json``
under a run id) in ``CYLON_TPU_TRACE_DIR``; plan profiles land beside
them (``plan_profile.r<rank>.json``).  The rank is the fleet identity
(``obs.fleet.set_rank``) when one is set, else this process's rank in the
``torch.distributed`` group, else 0.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from .. import config
from . import fleet as fleet_mod
from . import metrics as metrics_mod
from . import spans as spans_mod

#: one Chrome-trace event (kept in ``obs.fleet``, whose dumps carry them)
_event_json = fleet_mod._event_json


def trace_dir() -> str:
    """Artifact directory (``CYLON_TPU_TRACE_DIR``, default ``traces``)."""
    return str(config.knob("CYLON_TPU_TRACE_DIR")) or "traces"


def default_rank() -> int:
    """This process's rank for artifact naming: the fleet identity
    (``obs.fleet.set_rank``) when set, else its rank in the
    ``torch.distributed`` group when one is formed, else 0."""
    r = fleet_mod.current_rank()
    if isinstance(r, int):
        return r
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _artifact_path(path: Optional[str], prefix: str,
                   rank: Optional[int]) -> str:
    """``path`` when given, else ``<trace_dir>/<prefix>[.<run_id>].r<rank>
    .json`` (the directory made on demand)."""
    if path is not None:
        return path
    r = default_rank() if rank is None else int(rank)
    d = trace_dir()
    os.makedirs(d, exist_ok=True)
    rid = fleet_mod.current_run_id()
    if rid:
        # run-id namespacing: back-to-back runs sharing one trace dir
        # never clobber
        return os.path.join(
            d, f"{prefix}.{fleet_mod._safe_component(rid)}.r{r}.json")
    return os.path.join(d, f"{prefix}.r{r}.json")


def export_trace(path: Optional[str] = None, *, rank: Optional[int] = None,
                 prefix: str = "trace") -> str:
    """Write the buffered span events as Chrome-trace JSON; returns the
    file path (``{dir}/{prefix}.r{rank}.json`` unless ``path`` given).  A
    span whose device time has resolved (``obs.spans.device_report``)
    carries it as ``device_ms`` in its ``args``; the export waits for
    none."""
    out_path = _artifact_path(path, prefix, rank)
    spans_mod.poll_device()
    pid = default_rank() if rank is None else int(rank)
    doc = {
        "traceEvents": [_event_json(e, pid) for e in spans_mod.events()],
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "cylon_tpu_torch.obs",
            "rank": pid,
            "dropped_events": spans_mod.dropped(),
            # clock alignment (obs.fleet): lets tools/trace_merge.py lay
            # this rank's monotonic timestamps onto the coordinator clock
            "run_id": fleet_mod.current_run_id(),
            "clock": fleet_mod.clock_dict(),
        },
    }
    with open(out_path, "w", encoding="utf-8") as fh:
        # default=str: attrs may carry dtypes/enums; a label beats a crash
        json.dump(doc, fh, default=str)
    return out_path


def export_metrics(path: Optional[str] = None, *, rank: Optional[int] = None,
                   prefix: str = "metrics") -> str:
    """Write the flat metrics snapshot (+ rank and span-drop counter) as
    JSON; returns the file path."""
    out_path = _artifact_path(path, prefix, rank)
    doc = dict(metrics_mod.snapshot())
    doc["rank"] = default_rank() if rank is None else int(rank)
    doc["dropped_events"] = spans_mod.dropped()
    doc["run_id"] = fleet_mod.current_run_id()
    doc["clock"] = fleet_mod.clock_dict()
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, default=str, sort_keys=True)
    return out_path


def export_all(*, rank: Optional[int] = None,
               prefix: str = "trace") -> Tuple[str, str]:
    """Trace + metrics side by side: ``{prefix}.r{rank}.json`` and
    ``{prefix}.metrics.r{rank}.json``."""
    return (export_trace(rank=rank, prefix=prefix),
            export_metrics(rank=rank, prefix=f"{prefix}.metrics"))


def load_trace(path: str) -> Dict[str, object]:
    """Load and validate an exported trace: the object form with a
    ``traceEvents`` list whose members carry name/ph/ts/pid/tid (and
    ``dur`` on "X" events)."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError(f"{path}: not a Chrome-trace export "
                         f"(missing traceEvents list)")
    for ev in evs:
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"{path}: event missing {k!r}: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"{path}: complete event missing dur: {ev}")
    return doc


def load_metrics(path: str) -> Dict[str, object]:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)
