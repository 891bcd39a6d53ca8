"""Alias of ``host.syncs``, for the planner's cells."""
from benchmark import harness

read = harness.reader("host.syncs").read
