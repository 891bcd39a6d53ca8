"""Alias of ``ops.gather_ms``, for the planner's cells."""
from benchmark import harness

read = harness.reader("ops.gather_ms").read
