"""Observability for the port: tracing spans, request trace contexts,
metrics and the failure flight recorder.

The parts of ``cylon_tpu/obs/`` the out-of-core engine reads: ``spans``
(``exec.pass`` spans and the instants of faults, retries and OOM splits),
``tracectx`` (causal trace identity of those spans), ``metrics``
(``oom.refinements``, ``retry.attempts``, ``exec.parts_run``,
``hbm.live_bytes``) and ``fleet.flight_record``; and what the planner
reads: ``stats_catalog`` (the persistent statistics catalog) and
``export._artifact_path`` (where a plan profile lands).  Host-side; the
trace exports and OpenMetrics wait for ROADMAP.md queue A, item 11.
"""
from __future__ import annotations

from . import (export, fleet, metrics, spans, stats_catalog,  # noqa: F401
               tracectx)
from .spans import instant, span  # noqa: F401
