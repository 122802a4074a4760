"""Error handling.

The reference threads an `error_t` (code + message + bounded context trace)
through every call (upstream metalquicha src/utils/mqc_error.f90:24-39). In Python
we use exceptions; `MqcError` preserves the context-trace idea so errors
surfaced from deep in the fragment pipeline carry their provenance.
"""

from __future__ import annotations


class MqcError(Exception):
    """Framework error with an accumulating context trace."""

    MAX_TRACE = 20

    def __init__(self, message: str, code: int = 1):
        super().__init__(message)
        self.message = message
        self.code = code
        self.trace: list[str] = []

    def add_context(self, context: str) -> "MqcError":
        if len(self.trace) < self.MAX_TRACE:
            self.trace.append(context)
        return self

    def full_trace(self) -> str:
        lines = [f"error[{self.code}]: {self.message}"]
        for i, ctx in enumerate(reversed(self.trace)):
            lines.append("  " * (i + 1) + f"from: {ctx}")
        return "\n".join(lines)


class InputError(MqcError):
    """Invalid user input (.mqc / JSON / geometry)."""


class ParseError(InputError):
    """Malformed input text / command line (reference ERROR_PARSE class)."""


class ConvergenceError(MqcError):
    """An SCF or iterative solver failed to converge."""


def with_context(exc: Exception, context: str) -> Exception:
    """Attach context to an MqcError, or wrap a foreign exception."""
    if isinstance(exc, MqcError):
        return exc.add_context(context)
    err = MqcError(str(exc))
    err.add_context(context)
    return err
