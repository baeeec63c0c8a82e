"""Structured framework errors + enforce helpers — the port of
``paddle_tpu/core/errors.py`` (a copy: that module imports no JAX, and
the port imports nothing of the JAX package).

The taxonomy is Paddle's phi error codes (``paddle/phi/core/errors.h``:
LEGACY, INVALID_ARGUMENT, NOT_FOUND, OUT_OF_RANGE, ALREADY_EXISTS,
RESOURCE_EXHAUSTED, PRECONDITION_NOT_MET, PERMISSION_DENIED,
EXECUTION_TIMEOUT, UNIMPLEMENTED, UNAVAILABLE, FATAL, EXTERNAL) and its
PADDLE_ENFORCE macros (``paddle/phi/core/enforce.h``), which attach a
code and context to every raised error.

Python-native: one exception class per code, all deriving from PaddleError
(which also derives from the matching python builtin so existing `except
ValueError` call sites keep working), plus `enforce(cond, ...)` helpers.
"""
from __future__ import annotations

__all__ = [
    "PaddleError", "InvalidArgumentError", "NotFoundError", "OutOfRangeError",
    "AlreadyExistsError", "ResourceExhaustedError", "PreconditionNotMetError",
    "PermissionDeniedError", "ExecutionTimeoutError", "UnimplementedError",
    "UnavailableError", "FatalError", "ExternalError",
    "enforce", "enforce_eq", "enforce_gt", "enforce_not_none",
]


class PaddleError(Exception):
    """Base framework error; `code` mirrors phi::ErrorCode names."""

    code = "LEGACY"

    def __init__(self, message, **context):
        self.context = context
        if context:
            ctx = ", ".join(f"{k}={v!r}" for k, v in context.items())
            message = f"{message} [{ctx}]"
        super().__init__(f"({self.code}) {message}")


class InvalidArgumentError(PaddleError, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(PaddleError, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(PaddleError, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(PaddleError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(PaddleError, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(PaddleError, RuntimeError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(PaddleError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(PaddleError, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(PaddleError, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(PaddleError, RuntimeError):
    code = "UNAVAILABLE"


class FatalError(PaddleError):
    code = "FATAL"


class ExternalError(PaddleError):
    code = "EXTERNAL"


# ------------------------------------------------------------- enforce macros
def enforce(cond, message="enforce failed", error=InvalidArgumentError,
            **context):
    """PADDLE_ENFORCE analog: raise `error(message, **context)` unless cond."""
    if not cond:
        raise error(message, **context)


def enforce_eq(a, b, message=None, error=InvalidArgumentError, **context):
    if a != b:
        raise error(message or f"expected {a!r} == {b!r}", **context)


def enforce_gt(a, b, message=None, error=InvalidArgumentError, **context):
    if not a > b:
        raise error(message or f"expected {a!r} > {b!r}", **context)


def enforce_not_none(x, message="unexpected None", error=NotFoundError,
                     **context):
    if x is None:
        raise error(message, **context)
    return x
