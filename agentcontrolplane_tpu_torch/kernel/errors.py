"""Store errors: the Kubernetes apierrors subset the controllers branch on
(the port's copy of the reference's ``kernel/errors.py``)."""

from __future__ import annotations


class StoreError(Exception):
    pass


class NotFound(StoreError):
    """apierrors.IsNotFound: controllers branch on this to requeue and wait
    (an Agent's missing LLM leaves it Pending)."""


class AlreadyExists(StoreError):
    """apierrors.IsAlreadyExists: used for idempotent child creation."""


class Conflict(StoreError):
    """resource_version mismatch, an optimistic-concurrency conflict:
    callers re-get and retry."""


class Invalid(StoreError):
    """Validation failure at admission."""
