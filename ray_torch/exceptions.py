"""Exceptions of the PyTorch port: its own copy of the two classes of
``ray_tpu/exceptions.py`` that the request path needs. The rest of that
module belongs to the runtime core, which is not ported yet."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's end-to-end deadline passed (core/deadline.py).

    Raised when work is refused at admission because its deadline already
    expired, or when a wait bounded by the remaining deadline ran out."""
