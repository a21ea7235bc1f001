"""Structured serving errors — the overload/fault surface of the
solve service (the JAX package's ``serve/errors.py``, copied).

A serving layer needs failure to be a *typed* outcome, not a hang or a
bare ``Exception``:

* :class:`ServiceStopped` — the scheduler thread is dead (supervisor
  gave up, thread killed, or the service was stopped with work still
  in flight).  ``result()``/``stream()``/``wait_all()`` raise it
  instead of blocking forever on a job nobody will ever finish.
* :class:`ServiceOverloaded` — admission control rejected a submit:
  the bounded pending queue is full (and the arrival did not outrank
  any queued job) or the tenant is over its quota.  Carries a
  ``retry_after`` hint in seconds, estimated from the service's
  observed completion rate, so well-behaved clients can back off
  instead of hammering.
* :class:`DeadlineInfeasible` — the job's deadline cannot possibly be
  met (already expired at submit time); rejecting at the front door is
  cheaper for everyone than admitting work that is guaranteed to be
  preempted.

All of them derive from :class:`ServeError`, so ``except ServeError``
catches the whole admission/liveness surface while programming errors
still propagate.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class ServeError(Exception):
    """Base class of the solve service's structured errors."""


class ServiceStopped(ServeError):
    """The scheduler thread is dead; the job will never complete."""


class ServiceOverloaded(ServeError):
    """Admission control rejected the submit (queue full / quota).

    ``retry_after`` is a back-off hint in seconds derived from the
    service's observed completion rate and current backlog."""

    def __init__(self, reason: str, retry_after: float = 1.0,
                 tenant: Optional[str] = None):
        self.reason = reason
        self.retry_after = float(retry_after)
        self.tenant = tenant
        super().__init__(
            f"service overloaded ({reason}); retry after "
            f"~{self.retry_after:.3g}s"
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "error": "overloaded",
            "reason": self.reason,
            "retry_after": self.retry_after,
            "tenant": self.tenant,
        }


class DeadlineInfeasible(ServeError):
    """The submitted deadline is unmeetable (expired at submit time)."""
