"""Alias of ``query_p95_ms``, for the planner's cells."""
from benchmark import harness

read = harness.reader("query_p95_ms").read
