"""Typed errors shared across the PyTorch package."""


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this package does not have yet.

    Raised instead of silently degrading (densifying a structured
    constraint, dropping a precision tier, ignoring an option), so a
    caller learns at once which part of the problem needs the JAX
    package."""


class DeviceUnavailableError(RuntimeError):
    """The caller asked for (or defaulted to) a CUDA device that is not
    visible.  Entry points never carry on quietly on the CPU: the CPU is
    used only when the caller passes ``device="cpu"``."""
