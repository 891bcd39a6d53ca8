"""Error codes and the package's exception type.

Same code set as the JAX package's ``cylon_tpu/status.py`` (itself modelled
on the reference's ``cylon::Code``, cpp/src/cylon/code.cpp), so messages
and call sites translate one to one between the two packages.
"""
from __future__ import annotations

import enum


class Code(enum.IntEnum):
    """Error codes (reference: cpp/src/cylon/code.cpp)."""

    OK = 0
    OutOfMemory = 1
    KeyError = 2
    TypeError = 3
    Invalid = 4
    IOError = 5
    CapacityError = 6
    IndexError = 7
    UnknownError = 9
    NotImplemented = 10
    SerializationError = 11
    RError = 13
    CodeGenError = 40
    ExpressionValidationError = 41
    ExecutionError = 42
    AlreadyExists = 45
    Timeout = 46
    Unavailable = 47
    EpochMismatch = 48
    ResourceExhausted = 49
    Cancelled = 50


class CylonError(Exception):
    """Raised when an operation fails; carries a :class:`Code`."""

    def __init__(self, code: Code, msg: str):
        super().__init__(f"[{code.name}] {msg}")
        self.code = code
        self.msg = msg
