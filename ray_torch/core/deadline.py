"""Request deadline propagation.

End-to-end deadline carrier for the serving request path (and any other
caller that opts in): the caller sets an ABSOLUTE wall-clock deadline
(``time.time()`` epoch seconds — it must survive process hops on the same
host, which ``time.monotonic()`` does not) and every layer below bounds
its own waits by the REMAINING budget instead of hardcoded constants.

The value lives in a contextvar, so a deadline set around a call reaches
the LLM engine without any signature changes: ``LLMEngine.submit`` reads
it in the caller's context. The design follows Dean & Barroso, "The Tail
at Scale" (CACM 2013): refuse to *start* expired work, bound every wait by
what's left, and cancel on expiry rather than computing answers nobody
will read.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

from ray_torch.exceptions import DeadlineExceededError

_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "ray_torch_request_deadline", default=None)


def current() -> Optional[float]:
    """The ambient absolute deadline (epoch seconds), or None."""
    return _deadline.get()


def remaining(default: Optional[float] = None) -> Optional[float]:
    """Seconds left on the ambient deadline (can be <= 0), or `default`
    when no deadline is set."""
    d = _deadline.get()
    if d is None:
        return default
    return d - time.time()


def expired() -> bool:
    d = _deadline.get()
    return d is not None and time.time() >= d


def bound(timeout: Optional[float]) -> Optional[float]:
    """Clamp a wait to the remaining deadline budget.

    Returns min(timeout, remaining) — with either side allowed to be
    None (no bound from that side). A non-positive result is floored at a
    tiny epsilon so downstream waits fail fast with their own timeout
    error instead of blocking for a default."""
    rem = remaining()
    if rem is None:
        return timeout
    if timeout is None or rem < timeout:
        timeout = rem
    return max(timeout, 0.001)


def raise_if_expired(what: str = "request") -> None:
    """Admission check: refuse to start work whose deadline has passed."""
    d = _deadline.get()
    if d is not None and time.time() >= d:
        raise DeadlineExceededError(
            f"{what} deadline exceeded {time.time() - d:.3f}s ago")


@contextlib.contextmanager
def scope(deadline: Optional[float]) -> Iterator[Optional[float]]:
    """Establish `deadline` as the ambient deadline for the block.

    ``scope(None)`` is a no-op passthrough (keeps any outer deadline), so
    a caller can wrap unconditionally with an optional deadline."""
    if deadline is None:
        yield _deadline.get()
        return
    token = _deadline.set(deadline)
    try:
        yield deadline
    finally:
        _deadline.reset(token)
