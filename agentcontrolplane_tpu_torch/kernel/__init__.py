"""The control plane's kernel: store, leases, events, work queue and the
controller manager. The reference's cross-process store server
(``kernel/served.py``) comes with the fleet (ROADMAP A.12)."""

from .errors import AlreadyExists, Conflict, Invalid, NotFound, StoreError
from .events import EventRecorder
from .queue import WorkQueue
from .runtime import LeaderElector, Manager, Reconciler, Result, map_owner
from .store import (
    Backend, FencedStore, MemoryBackend, SqliteBackend, Store, Watch, WatchEvent,
    wait_for,
)
from . import lease

__all__ = [
    "AlreadyExists", "Conflict", "Invalid", "NotFound", "StoreError",
    "EventRecorder", "WorkQueue", "LeaderElector", "Manager", "Reconciler",
    "Result", "map_owner", "Backend", "FencedStore", "MemoryBackend",
    "SqliteBackend", "Store", "Watch", "WatchEvent", "wait_for", "lease",
]
