"""Observability for the port: tracing spans, request trace contexts,
metrics, their exports and the failure flight recorder.

A copy of ``cylon_tpu/obs/``: ``spans`` (nested wall-clock spans and
instants over every hot path, the flight ring and the event buffer),
``tracectx`` (causal request identity, W3C traceparent, tail-based
retention), ``metrics`` (counters, gauges, histograms with cumulative
``le`` buckets), ``export`` (Chrome-trace/Perfetto and flat metrics JSON
with per-rank naming), ``openmetrics`` (the Prometheus text exposition
and its scrape listener), ``fleet`` (process identity, clock alignment,
``flight_record``) and ``stats_catalog`` (the planner's persistent
statistics).  Host-side.
"""
from __future__ import annotations

from . import (export, fleet, metrics, openmetrics, spans,  # noqa: F401
               stats_catalog, tracectx)
from .spans import instant, span  # noqa: F401
