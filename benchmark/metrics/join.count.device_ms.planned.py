"""Alias of ``join.count.device_ms``, for the planner's cells."""
from benchmark import harness

_reader = harness.reader("join.count.device_ms")
begin, read = _reader.begin, _reader.read
