"""Distributed locking with Leases (the port's copy of the reference's
``kernel/lease.py``).

Create-or-adopt-expired semantics with a TTL, so a surviving replica can
adopt a dead replica's lock after expiry; also the substrate of leader
election (``runtime.LeaderElector``). The lease's epoch is the fencing
token the store checks (``Store._check_fence``).
"""

from __future__ import annotations

import time

from ..api.resources import Lease, LeaseSpec
from ..api.meta import ObjectMeta
from .errors import AlreadyExists, Conflict, NotFound
from .store import Store


def try_acquire(
    store: Store,
    name: str,
    holder: str,
    namespace: str = "default",
    ttl: float = 30.0,
    now: float | None = None,
) -> bool:
    """Attempt to acquire/renew the lease. Returns True iff held by ``holder``."""
    return try_acquire_epoch(store, name, holder, namespace, ttl, now) is not None


def try_acquire_epoch(
    store: Store,
    name: str,
    holder: str,
    namespace: str = "default",
    ttl: float = 30.0,
    now: float | None = None,
) -> int | None:
    """Attempt to acquire/renew the lease. Returns the lease EPOCH iff held
    by ``holder`` afterwards, else None. The epoch is the fencing token:
    bumped on every change of holder (create = 1), stable across renewals —
    see Store fencing (``store.create(..., fence=...)``).

    Semantics:
    - absent        -> create, acquired
    - held by us    -> renew, acquired
    - expired       -> adopt (CAS-guarded), acquired
    - held, live    -> not acquired
    """
    now = time.time() if now is None else now
    try:
        existing = store.get("Lease", name, namespace)
    except NotFound:
        lease = Lease(
            metadata=ObjectMeta(name=name, namespace=namespace),
            spec=LeaseSpec(
                holder_identity=holder,
                lease_duration_seconds=ttl,
                acquire_time=now,
                renew_time=now,
                epoch=1,
            ),
        )
        try:
            store.create(lease)
            return 1
        except AlreadyExists:
            return None

    assert isinstance(existing, Lease)
    spec = existing.spec
    expired = now - spec.renew_time > spec.lease_duration_seconds
    if spec.holder_identity == holder or expired:
        takeover = spec.holder_identity != holder
        epoch = spec.epoch + 1 if takeover else spec.epoch
        existing.spec = LeaseSpec(
            holder_identity=holder,
            lease_duration_seconds=ttl,
            acquire_time=now if takeover else spec.acquire_time,
            renew_time=now,
            epoch=epoch,
        )
        try:
            store.update(existing)
            return epoch
        except (Conflict, NotFound):
            return None
    return None


def holder(
    store: Store,
    name: str,
    namespace: str = "default",
    now: float | None = None,
) -> str | None:
    """The lease's LIVE holder identity, or None when the lease is absent,
    released, or expired. Read-only — never mutates the lease, so pool
    status surfaces (``FleetRouter.stats()``, ``/v1/fleet``) can report
    holders without racing the heartbeat's CAS renewals."""
    now = time.time() if now is None else now
    try:
        lease = store.get("Lease", name, namespace)
    except NotFound:
        return None
    assert isinstance(lease, Lease)
    spec = lease.spec
    if not spec.holder_identity:
        return None
    if now - spec.renew_time > spec.lease_duration_seconds:
        return None
    return spec.holder_identity


class LeaseHeartbeat:
    """Background renewer for a set of leases (the fleet pool's replica
    registrations): a daemon thread re-runs :func:`try_acquire_epoch` for
    every tracked ``(name, holder)`` each ``interval`` seconds, keeping the
    leases live while the process serves. ``epochs`` exposes the latest
    fencing token per lease name; a lease another holder adopted (epoch
    returned None) is dropped from tracking and reported via
    ``on_lost(name)`` so the owner can react (mark the replica dead).

    Add/remove are thread-safe; ``stop()`` joins the thread but leaves the
    leases to expire naturally (a crashed process couldn't release either —
    expiry IS the failover signal)."""

    def __init__(
        self,
        store: Store,
        interval: float = 1.0,
        ttl: float = 30.0,
        namespace: str = "default",
        on_lost=None,
    ) -> None:
        import threading

        self.store = store
        self.interval = max(0.05, float(interval))
        self.ttl = float(ttl)
        self.namespace = namespace
        self.on_lost = on_lost
        self.epochs: dict[str, int] = {}
        self._leases: dict[str, str] = {}  # name -> holder
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def add(self, name: str, holder: str) -> int | None:
        """Acquire ``name`` for ``holder`` now and keep renewing it.
        Returns the fencing epoch (None when another live holder has it —
        the lease is NOT tracked in that case)."""
        epoch = try_acquire_epoch(
            self.store, name, holder, self.namespace, self.ttl
        )
        if epoch is None:
            return None
        with self._lock:
            self._leases[name] = holder
            self.epochs[name] = epoch
        return epoch

    def remove(self, name: str, release_lease: bool = True) -> None:
        """Stop renewing ``name``; optionally release it immediately so a
        survivor can adopt without waiting out the TTL."""
        with self._lock:
            hld = self._leases.pop(name, None)
            self.epochs.pop(name, None)
        if release_lease and hld is not None:
            release(self.store, name, hld, self.namespace)

    def start(self) -> None:
        import threading

        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="lease-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def beat(self) -> None:
        """One renewal pass over every tracked lease (also callable
        directly from tests for deterministic timing)."""
        with self._lock:
            snapshot = list(self._leases.items())
        for name, hld in snapshot:
            epoch = try_acquire_epoch(
                self.store, name, hld, self.namespace, self.ttl
            )
            if epoch is None:
                # deposed: another holder adopted (or a CAS race we lost
                # twice) — stop renewing and tell the owner
                with self._lock:
                    self._leases.pop(name, None)
                    self.epochs.pop(name, None)
                if self.on_lost is not None:
                    try:
                        self.on_lost(name)
                    except Exception:
                        pass
            else:
                with self._lock:
                    if name in self._leases:
                        self.epochs[name] = epoch

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()


def release(store: Store, name: str, holder: str, namespace: str = "default") -> None:
    """Relinquish the lease if held by ``holder`` (best-effort).

    The Lease object is KEPT (holder cleared, renew_time zeroed so any
    replica can adopt immediately) rather than deleted: deleting would
    reset the epoch counter to 1 on the next create, and a fencing token
    minted before an earlier deposition could validate again — epochs must
    be monotonic for the lifetime of the lease name. The update is
    CAS-guarded by the object's resource_version: if another replica
    adopted between our get and write, the write Conflicts and the new
    holder's lease survives untouched."""
    try:
        lease = store.get("Lease", name, namespace)
    except NotFound:
        return
    assert isinstance(lease, Lease)
    if lease.spec.holder_identity == holder:
        lease.spec = LeaseSpec(
            holder_identity="",
            lease_duration_seconds=lease.spec.lease_duration_seconds,
            acquire_time=lease.spec.acquire_time,
            renew_time=0.0,
            epoch=lease.spec.epoch,
        )
        try:
            store.update(lease)
        except (NotFound, Conflict):
            pass
