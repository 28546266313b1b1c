"""Exceptions for the define-by-run HPO engine."""

from __future__ import annotations


class ReproError(Exception):
    """Base class for all repro_torch.core errors."""


class TrialPruned(ReproError):
    """Raised (by user code or ``Trial.report``-driven logic) to signal that the
    current trial was pruned.

    The ``Study.optimize`` loop catches this exception and marks the trial as
    ``TrialState.PRUNED`` instead of ``FAILED``.  This mirrors the paper's
    'should_prune API' contract (paper Fig. 5).
    """


class StorageInternalError(ReproError):
    """A storage backend failed in a way that retrying cannot fix."""


class DuplicatedStudyError(ReproError):
    """A study with the requested name already exists in the storage."""


class StudyNotFoundError(KeyError, ReproError):
    """No study with the requested name/id exists in the storage."""


class TrialNotFoundError(KeyError, ReproError):
    """No trial with the requested id exists in the storage."""


class RetryableStorageError(ReproError):
    """Transient storage failure (lock contention, torn read); safe to retry."""


class StorageUnavailableError(RetryableStorageError):
    """The storage node cannot serve this call *right now* — e.g. a replica
    that has not been promoted refusing writes during a failover window.
    Clients back off, rotate to another candidate, and retry."""
