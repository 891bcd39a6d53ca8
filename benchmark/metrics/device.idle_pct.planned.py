"""Alias of ``device.idle_pct``, for the planner's cells."""
from benchmark import harness

read = harness.reader("device.idle_pct").read
