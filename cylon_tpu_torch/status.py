"""Error codes, the operation status and the package's exception type.

Same code set as the JAX package's ``cylon_tpu/status.py`` (itself modelled
on the reference's ``cylon::Code``, cpp/src/cylon/code.cpp), so messages
and call sites translate one to one between the two packages.
``Status.from_exception`` classifies a failure into that taxonomy, as
``cylon_tpu/status.py:85`` does, with the CUDA allocator's failures as
``Code.OutOfMemory``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch


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

    def __init__(self, code: Code, msg: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"[{code.name}] {msg}")
        self.code = code
        self.msg = msg
        # a shed's hint to the caller (seconds), carried across the wire
        # by ``router/wire.classified``; None when the failure has none
        self.retry_after_s = retry_after_s


# Failure-text classification tables (lowercase substrings), as
# ``cylon_tpu/status.py:59-69``, plus the CUDA allocator's shapes: a
# caching-allocator failure is a ``torch.OutOfMemoryError`` ("CUDA out of
# memory"), but an allocation failing inside a library or a kernel launch
# surfaces as a plain RuntimeError naming ``cudaErrorMemoryAllocation``.
_OOM_PATTERNS = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "failed to allocate", "allocation failure", "exceeds hbm",
    "hbm capacity", "exceeds the memory", "cudaerrormemoryallocation",
)
_TRANSIENT_PATTERNS = (
    "deadline_exceeded", "deadline exceeded", "timed out", "timeout",
    "unavailable", "connection reset", "connection refused",
    "connection closed", "socket closed", "broken pipe", "aborted",
    "cancelled", "preempt", "network error",
)


@dataclass(frozen=True)
class Status:
    """Operation status (reference: cpp/src/cylon/status.hpp).
    ``Status.OK()`` is success; anything else carries a code and message."""

    code: Code = Code.OK
    msg: str = ""

    @staticmethod
    def OK() -> "Status":
        return Status(Code.OK, "")

    @staticmethod
    def from_exception(exc: BaseException) -> "Status":
        """Classify an exception into the `Code` taxonomy.

        `CylonError` keeps its own code; ``torch.OutOfMemoryError``,
        `MemoryError` and allocator failure text map to
        `Code.OutOfMemory`; deadline/comm failure text maps to retryable
        `Code.ExecutionError`; anything unrecognized is `Code.UnknownError`
        (never retried, never split).  Text is matched only on a
        RuntimeError: on any other type it is a bug's wording."""
        if isinstance(exc, CylonError):
            return Status(exc.code, exc.msg)
        msg = f"{type(exc).__name__}: {exc}"
        if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
            return Status(Code.OutOfMemory, msg)
        if isinstance(exc, (TimeoutError, ConnectionError)):
            return Status(Code.ExecutionError, msg)
        if isinstance(exc, RuntimeError):
            low = str(exc).lower()
            if any(p in low for p in _OOM_PATTERNS):
                return Status(Code.OutOfMemory, msg)
            if any(p in low for p in _TRANSIENT_PATTERNS):
                return Status(Code.ExecutionError, msg)
        return Status(Code.UnknownError, msg)

    def is_ok(self) -> bool:
        return self.code == Code.OK

    def get_code(self) -> Code:
        return self.code

    def get_msg(self) -> str:
        return self.msg

    def __bool__(self) -> bool:
        return self.is_ok()
