"""Alias of ``rows_per_s``, for the planner's cells."""
from benchmark import harness

read = harness.reader("rows_per_s").read
