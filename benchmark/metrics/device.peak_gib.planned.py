"""Alias of ``device.peak_gib``, for the planner's cells."""
from benchmark import harness

read = harness.reader("device.peak_gib").read
