"""Observability for the port: tracing spans, request trace contexts,
metrics and the failure flight recorder.

The parts of ``cylon_tpu/obs/`` the out-of-core engine reads: ``spans``
(``exec.pass`` spans and the instants of faults, retries and OOM splits),
``tracectx`` (causal trace identity of those spans), ``metrics``
(``oom.refinements``, ``retry.attempts``, ``exec.parts_run``,
``hbm.live_bytes``) and ``fleet.flight_record``.  Host-side; the export,
OpenMetrics and statistics-catalog modules are not ported.
"""
from __future__ import annotations

from . import fleet, metrics, spans, tracectx  # noqa: F401
from .spans import instant, span  # noqa: F401
