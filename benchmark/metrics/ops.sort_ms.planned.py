"""Alias of ``ops.sort_ms``, for the planner's cells."""
from benchmark import harness

read = harness.reader("ops.sort_ms").read
