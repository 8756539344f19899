"""Controller manager: controller-runtime, asyncio-native (the port's copy
of the reference's ``kernel/runtime.py``).

Controllers are registered with the kind they reconcile and the kinds they
own (an owned object's watch event maps to its owner's key, like
controller-runtime's ``Owns()``); each gets a rate-limited work queue fed
by store watches, and N workers call ``reconcile(key)``, which returns a
``Result`` with requeue semantics. Leader election gates singleton
runnables and mints the fencing tokens of ``fenced_store()``.

The reference counts reconciles in its metrics registry; the port's
metrics come with ROADMAP A.11, so the worker counts nothing yet.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional, Protocol

from ..api.meta import Resource
from ..observability.metrics import REGISTRY
from . import lease as leaselib
from .events import EventRecorder
from .queue import WorkQueue
from .store import Key, Store, WatchEvent

log = logging.getLogger("acp_tpu.runtime")


@dataclass
class Result:
    """Reconcile outcome (controller-runtime ctrl.Result)."""

    requeue: bool = False
    requeue_after: Optional[float] = None

    @staticmethod
    def done() -> "Result":
        return Result()

    @staticmethod
    def after(seconds: float) -> "Result":
        return Result(requeue_after=seconds)


class Reconciler(Protocol):
    async def reconcile(self, key: Key) -> Result: ...


KeyMapper = Callable[[Resource], Optional[Key]]


def map_owner(owner_kind: str) -> KeyMapper:
    """Map an owned object's event to its controller-owner's key."""

    def mapper(obj: Resource) -> Optional[Key]:
        for ref in obj.metadata.owner_references:
            if ref.kind == owner_kind:
                return (owner_kind, obj.metadata.namespace, ref.name)
        return None

    return mapper


@dataclass
class _Controller:
    name: str
    kind: str
    reconciler: Reconciler
    mappers: dict[str, KeyMapper] = field(default_factory=dict)
    workers: int = 4
    queue: WorkQueue[Key] = field(default_factory=WorkQueue)


class LeaderElector:
    """Lease-based leader election."""

    def __init__(
        self,
        store: Store,
        identity: str,
        lease_name: str = "acp-tpu-leader",
        namespace: str = "default",
        ttl: float = 15.0,
        renew_interval: float = 5.0,
    ):
        self._store = store
        self.identity = identity
        self._lease_name = lease_name
        self._namespace = namespace
        self._ttl = ttl
        self._renew = renew_interval
        self.is_leader = False
        # fencing token: the lease epoch under which we currently lead
        # (None while not leading). Bumped by the lease on every change of
        # holder, so a token minted before a deposition can never validate.
        self.epoch: Optional[int] = None
        self._task: Optional[asyncio.Task] = None

    def fence(self) -> Optional[dict]:
        """The current fencing token for store mutations, or None when not
        leading. Read at CALL time by FencedStore so every leader-gated
        write carries the freshest view this replica has."""
        epoch = self.epoch
        if not self.is_leader or epoch is None:
            return None
        return {
            "name": self._lease_name,
            "namespace": self._namespace,
            "holder": self.identity,
            "epoch": epoch,
        }

    async def _run(self) -> None:
        while True:
            epoch = leaselib.try_acquire_epoch(
                self._store, self._lease_name, self.identity, self._namespace, self._ttl
            )
            self.epoch = epoch
            self.is_leader = epoch is not None
            await asyncio.sleep(self._renew)

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self.is_leader:
            leaselib.release(self._store, self._lease_name, self.identity, self._namespace)
            self.is_leader = False
            self.epoch = None


Runnable = Callable[[], Awaitable[None]]


class Manager:
    """Holds the store, recorder, controllers and runnables; runs them all."""

    def __init__(
        self,
        store: Store,
        identity: str | None = None,
        leader_election: bool = False,
    ):
        self.store = store
        self.identity = identity or f"acp-tpu-{uuid.uuid4().hex[:8]}"
        self.recorder = EventRecorder(store)
        self._controllers: list[_Controller] = []
        self._runnables: list[tuple[Runnable, bool]] = []  # (fn, leader_gated)
        self._tasks: list[asyncio.Task] = []
        self._watches = []
        self.elector = LeaderElector(store, self.identity) if leader_election else None
        self._started = False
        self._stopping = False

    def fenced_store(self):
        """A Store view for leader-gated work: every mutation carries the
        elector's current fencing token and is rejected by the store once
        another replica adopts the election lease (see Store._check_fence).
        Falls back to the raw store when leader election is off — a single
        replica has nobody to be fenced against."""
        if self.elector is None:
            return self.store
        from .store import FencedStore

        return FencedStore(self.store, self.elector.fence)

    def add_controller(
        self,
        name: str,
        kind: str,
        reconciler: Reconciler,
        owns: list[str] | None = None,
        watches: dict[str, KeyMapper] | None = None,
        workers: int = 4,
    ) -> None:
        mappers: dict[str, KeyMapper] = {}
        for owned in owns or []:
            mappers[owned] = map_owner(kind)
        mappers.update(watches or {})
        self._controllers.append(
            _Controller(name=name, kind=kind, reconciler=reconciler, mappers=mappers, workers=workers)
        )

    def add_runnable(self, fn: Runnable, leader_gated: bool = False) -> None:
        self._runnables.append((fn, leader_gated))

    async def _watch_loop(self, ctl: _Controller) -> None:
        """Watch + dispatch, with the apiserver resync contract: if the
        watch ENDS while the manager is still running (a served store's
        owner restarted and the RemoteStore connection died), re-list and
        re-watch with backoff — a follower replica must come back on its
        own rather than go deaf. In-process Store watches only end via
        stop(), which sets _stopping first, so this never spins locally."""
        backoff = 0.2
        while not self._stopping:
            kinds = {ctl.kind, *ctl.mappers.keys()}
            try:
                watch = self.store.watch(kinds, namespace=None)
            except Exception:
                log.warning(
                    "%s: store watch unavailable; retrying in %.1fs",
                    ctl.name, backoff,
                )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            self._watches.append(watch)
            try:
                # (re-)list: the cache-sync on first iteration, the resync
                # covering events lost in the gap on later ones
                for obj in self.store.list(ctl.kind, namespace=None):
                    ctl.queue.add(obj.key)
            except Exception:
                watch.stop()
                self._watches.remove(watch)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            backoff = 0.2
            async for ev in watch:
                self._dispatch(ctl, ev)
            if watch in self._watches:
                self._watches.remove(watch)
            if not self._stopping:
                log.warning("%s: watch ended; resyncing", ctl.name)
                await asyncio.sleep(backoff)

    def _dispatch(self, ctl: _Controller, ev: WatchEvent) -> None:
        obj = ev.object
        if obj.kind == ctl.kind:
            # DELETED also enqueues: reconcile observes NotFound and releases
            # non-owned resources (controller-runtime semantics).
            ctl.queue.add(obj.key)
            return
        mapper = ctl.mappers.get(obj.kind)
        if mapper is None:
            return
        key = mapper(obj)
        if key is not None:
            ctl.queue.add(key)

    async def _worker(self, ctl: _Controller) -> None:
        while True:
            key = await ctl.queue.get()
            if key is None:
                return
            t0 = time.monotonic()
            try:
                result = await ctl.reconciler.reconcile(key)
            except Exception:
                log.exception("%s: reconcile %s failed", ctl.name, key)
                REGISTRY.counter_add("acp_reconcile_total",
                                     labels={"controller": ctl.name, "result": "error"},
                                     help="reconcile outcomes per controller")
                ctl.queue.add_rate_limited(key)
            else:
                REGISTRY.counter_add("acp_reconcile_total",
                                     labels={"controller": ctl.name, "result": "success"},
                                     help="reconcile outcomes per controller")
                REGISTRY.observe("acp_reconcile_duration_seconds", time.monotonic() - t0,
                                 labels={"controller": ctl.name},
                                 help="reconcile latency per controller")
                ctl.queue.forget(key)
                if result.requeue_after is not None:
                    ctl.queue.add_after(key, result.requeue_after)
                elif result.requeue:
                    ctl.queue.add_rate_limited(key)
            finally:
                ctl.queue.done(key)

    async def _leader_gated_runner(self, fn: Runnable) -> None:
        """Run ``fn`` only while leader; cancel it on leadership loss and
        restart it if leadership is re-acquired (no split-brain singletons)."""
        assert self.elector is not None
        while True:
            while not self.elector.is_leader:
                await asyncio.sleep(0.1)
            task = asyncio.ensure_future(fn())
            while self.elector.is_leader and not task.done():
                await asyncio.sleep(0.1)
            if not task.done():
                task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            if task.done() and self.elector.is_leader:
                return  # fn finished on its own while still leader

    async def start(self) -> None:
        """Start everything; returns once all loops are scheduled."""
        if self._started:
            return
        self._started = True
        self._stopping = False
        if self.elector:
            self.elector.start()
        for ctl in self._controllers:
            ctl.queue = WorkQueue()  # fresh queue: stop() shutdown is permanent
        for ctl in self._controllers:
            self._tasks.append(asyncio.ensure_future(self._watch_loop(ctl)))
            for _ in range(ctl.workers):
                self._tasks.append(asyncio.ensure_future(self._worker(ctl)))
        for fn, gated in self._runnables:
            if gated and self.elector:
                self._tasks.append(asyncio.ensure_future(self._leader_gated_runner(fn)))
            else:
                self._tasks.append(asyncio.ensure_future(fn()))
        # yield once so watch loops register before callers mutate the store
        await asyncio.sleep(0)

    async def stop(self) -> None:
        self._stopping = True  # watch loops must not resync a stopping manager
        for ctl in self._controllers:
            ctl.queue.shutdown()
        for w in self._watches:
            w.stop()
        if self.elector:
            await self.elector.stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            # Grace first: a well-behaved worker's cancellation cleanup
            # (closing connections, flushing a watch) may legitimately
            # await — give it 2s to finish before escalating.
            if not t.done():
                await asyncio.wait([t], timeout=2.0)
            # A worker may absorb the first CancelledError inside a cleanup
            # path (e.g. awaiting a handler that swallows it); re-deliver
            # cancellation until the task actually dies, bounded so stop()
            # can never hang the process on a misbehaving worker.
            for _ in range(50):
                if t.done():
                    break
                t.cancel()
                await asyncio.wait([t], timeout=0.2)
            if not t.done():
                log.error("manager task ignored repeated cancellation; detaching: %r", t)
            elif not t.cancelled() and t.exception() is not None:
                log.debug("manager task exited with error during stop: %r", t.exception())
        self._tasks.clear()
        self._watches.clear()
        self._started = False

    async def run_until(self, predicate: Callable[[], bool], timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not predicate():
            if time.monotonic() > deadline:
                raise TimeoutError("run_until timed out")
            await asyncio.sleep(0.02)
