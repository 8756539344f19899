"""Durable object store, the control plane's kernel (the port's copy of
the reference's ``kernel/store.py``).

Kubernetes semantics in-tree, so the control plane runs standalone:

- ``create/get/list/update/update_status/delete`` over deep-copied
  documents, with monotonically increasing ``resource_version``s and
  generation tracking;
- label-selector ``list`` (an exact-match map);
- ``watch`` streams (ADDED/MODIFIED/DELETED) that feed controller queues;
- cascading deletion of owned objects (owner-reference GC);
- fencing tokens on mutations (``FencedStore``), so a deposed leader's
  in-flight writes are refused;
- a durability backend: in memory (tests) or sqlite in WAL mode, so a
  restart resumes. A document is the JSON of the snake_case dump, as the
  reference stores it, so the two packages' sqlite files are
  interchangeable.

Thread safety: every mutation takes an RLock, so the engine thread can read
objects and the REST server's worker threads can read and write; watch
delivery is asyncio-native (``call_soon_threadsafe`` from other threads).
``phase_counts`` feeds ``/metrics``. The reference's raw-document
``subscribe`` serves its cross-process store server and comes with it
(ROADMAP A.12).
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from ..api.meta import Resource
from ..api.resources import from_doc
from .errors import AlreadyExists, Conflict, Invalid, NotFound

Key = tuple[str, str, str]  # (kind, namespace, name)


@dataclass
class WatchEvent:
    type: str  # "ADDED" | "MODIFIED" | "DELETED"
    object: Resource

    @property
    def key(self) -> Key:
        return self.object.key


class Backend:
    """Durability backend interface. ``rv`` on put/remove is the store's
    monotonic resource_version counter at the time of the mutation; backends
    persist it so the counter never runs backwards across restarts (a
    re-issued rv would defeat optimistic concurrency for clients holding
    pre-restart objects)."""

    def load_all(self) -> tuple[int, list[dict[str, Any]]]:
        return 0, []

    def put(self, doc: dict[str, Any], rv: int = 0) -> None:
        pass

    def remove(self, key: Key, rv: int = 0) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryBackend(Backend):
    pass


class SqliteBackend(Backend):
    """Append-to-latest sqlite backend (WAL) — the etcd stand-in."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        # WAL + NORMAL = commits append to the WAL without a per-commit
        # fsync (fsync happens at checkpoint). This is the group-commit
        # etcd gets from batching raft writes: status updates are the
        # control plane's hottest write (every phase transition serializes
        # the context window), and per-write fsync was the bottleneck at 64
        # concurrent tasks. Durability across process crash is preserved;
        # an OS crash can lose the tail of the WAL (acceptable standalone).
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS objects ("
            " kind TEXT, namespace TEXT, name TEXT, rv INTEGER, doc TEXT,"
            " PRIMARY KEY (kind, namespace, name))"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)"
        )
        self._lock = threading.Lock()

    def load_all(self) -> tuple[int, list[dict[str, Any]]]:
        with self._lock:
            rows = self._conn.execute("SELECT rv, doc FROM objects").fetchall()
            meta = self._conn.execute("SELECT v FROM meta WHERE k='rv'").fetchone()
        docs = [json.loads(doc) for _, doc in rows]
        # the persisted counter wins: max-over-live-rows alone would re-issue
        # rvs if the highest-rv objects were deleted before the restart
        max_rv = max((rv for rv, _ in rows), default=0)
        return max(meta[0] if meta else 0, max_rv), docs

    def put(self, doc: dict[str, Any], rv: int = 0) -> None:
        meta = doc["metadata"]
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO objects (kind, namespace, name, rv, doc)"
                " VALUES (?, ?, ?, ?, ?)",
                (doc["kind"], meta["namespace"], meta["name"], meta["resource_version"], json.dumps(doc)),
            )
            self._conn.execute(
                "INSERT OR REPLACE INTO meta (k, v) VALUES ('rv', ?)", (rv,)
            )
            self._conn.commit()

    def remove(self, key: Key, rv: int = 0) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM objects WHERE kind=? AND namespace=? AND name=?", key
            )
            self._conn.execute(
                "INSERT OR REPLACE INTO meta (k, v) VALUES ('rv', ?)", (rv,)
            )
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


@dataclass
class _Watcher:
    kinds: frozenset[str]
    namespace: Optional[str]
    queue: asyncio.Queue = field(default_factory=asyncio.Queue)
    loop: Optional[asyncio.AbstractEventLoop] = None

    def matches(self, ev: WatchEvent) -> bool:
        if ev.object.kind not in self.kinds:
            return False
        if self.namespace is not None and ev.object.metadata.namespace != self.namespace:
            return False
        return True

    def deliver(self, ev: WatchEvent) -> None:
        if self.loop is not None and self.loop is not _current_loop():
            self.loop.call_soon_threadsafe(self.queue.put_nowait, ev)
        else:
            self.queue.put_nowait(ev)


def _current_loop() -> Optional[asyncio.AbstractEventLoop]:
    try:
        return asyncio.get_running_loop()
    except RuntimeError:
        return None


def _match_labels(labels: dict[str, str], selector: dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class Store:
    def __init__(self, backend: Backend | None = None):
        self._backend = backend or MemoryBackend()
        self._lock = threading.RLock()
        self._objects: dict[Key, dict[str, Any]] = {}
        # owner-clock timestamp of each Lease's last write: the fence expiry
        # check compares against THIS clock, not the holder-written
        # spec.renew_time — cross-host clock skew larger than the TTL would
        # otherwise permanently fence out a live leader renewing over RPC
        self._lease_touched: dict[Key, float] = {}
        self._watchers: list[_Watcher] = []
        rv, docs = self._backend.load_all()
        self._rv = rv
        for doc in docs:
            obj = from_doc(doc)
            self._objects[obj.key] = doc

    # -- helpers ---------------------------------------------------------

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _notify(self, type_: str, doc: dict[str, Any]) -> None:
        if not self._watchers:
            return
        ev = WatchEvent(type=type_, object=from_doc(doc))
        for w in list(self._watchers):
            if w.matches(ev):
                w.deliver(ev)

    @staticmethod
    def _doc(obj: Resource) -> dict[str, Any]:
        return json.loads(json.dumps(obj.model_dump()))

    # -- fencing ---------------------------------------------------------

    def _check_fence(self, fence: Optional[dict]) -> None:
        """Reject a mutation whose fencing token is stale. ``fence`` is
        ``{"name", "namespace", "holder", "epoch"}`` naming an election
        Lease; the check runs under the store lock, so it is atomic with
        the write it guards — a deposed-but-alive leader (renew missed, GC
        pause) whose in-flight write arrives after a new holder adopted the
        lease observes Conflict instead of landing on a stale view. Lease
        semantics: ``lease.try_acquire_epoch`` bumps ``spec.epoch`` on every
        change of holder and never on renewal."""
        if fence is None:
            return
        key = ("Lease", fence.get("namespace", "default"), fence["name"])
        doc = self._objects.get(key)
        if doc is None:
            raise Conflict(f"fencing: election lease {key} is gone")
        spec = doc.get("spec") or {}
        if spec.get("holder_identity") != fence.get("holder"):
            raise Conflict(
                f"fencing: lease {key} now held by "
                f"{spec.get('holder_identity')!r}, not {fence.get('holder')!r}"
            )
        if spec.get("epoch") != fence.get("epoch"):
            raise Conflict(
                f"fencing: lease {key} epoch {spec.get('epoch')} != "
                f"token epoch {fence.get('epoch')}"
            )
        # expiry on the OWNER's clock: when did THIS store last see the
        # lease written? The holder-written renew_time is another host's
        # clock and skew > ttl would fence a live leader out permanently.
        # After an owner restart no write has been seen yet; fall back to
        # the spec timestamp until the first renew (< renew_interval away).
        touched = self._lease_touched.get(key, spec.get("renew_time", 0))
        if time.time() - touched > spec.get("lease_duration_seconds", 0):
            raise Conflict(f"fencing: election lease {key} has expired")

    # -- CRUD ------------------------------------------------------------

    def create(self, obj: Resource, fence: Optional[dict] = None) -> Resource:
        if not obj.kind:
            raise Invalid("object has no kind")
        if not obj.metadata.name:
            raise Invalid("object has no name")
        with self._lock:
            self._check_fence(fence)
            key = obj.key
            if key in self._objects:
                raise AlreadyExists(f"{key} already exists")
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.generation = 1
            doc = self._doc(obj)
            self._objects[key] = doc
            if obj.kind == "Lease":
                self._lease_touched[key] = time.time()
            self._backend.put(doc, self._rv)
            self._notify("ADDED", doc)
        return from_doc(doc)

    def get(self, kind: str, name: str, namespace: str = "default") -> Resource:
        with self._lock:
            doc = self._objects.get((kind, namespace, name))
            if doc is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return from_doc(doc)

    def try_get(self, kind: str, name: str, namespace: str = "default") -> Optional[Resource]:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def phase_counts(self) -> dict[tuple[str, str], int]:
        """(kind, phase) -> live object count, in one pass under one lock
        hold (the ``/metrics`` scrape). The phase falls back to
        ``status.status`` (LLM/Agent-style readiness), then "unknown"."""
        out: dict[tuple[str, str], int] = {}
        with self._lock:
            for (kind, _ns, _name), doc in self._objects.items():
                st = doc.get("status") or {}
                phase = str(st.get("phase") or st.get("status") or "unknown")
                out[(kind, phase)] = out.get((kind, phase), 0) + 1
        return out

    def list(
        self,
        kind: str,
        namespace: Optional[str] = "default",
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[Resource]:
        out: list[Resource] = []
        with self._lock:
            for (k, ns, _), doc in self._objects.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and not _match_labels(
                    doc["metadata"].get("labels") or {}, label_selector
                ):
                    continue
                out.append(from_doc(doc))
        out.sort(key=lambda o: o.metadata.creation_timestamp)
        return out

    def _update(
        self, obj: Resource, *, status_only: bool, fence: Optional[dict] = None
    ) -> Resource:
        with self._lock:
            self._check_fence(fence)
            key = obj.key
            cur = self._objects.get(key)
            if cur is None:
                raise NotFound(f"{key} not found")
            if obj.metadata.resource_version != cur["metadata"]["resource_version"]:
                raise Conflict(
                    f"{key}: resource_version {obj.metadata.resource_version} != "
                    f"{cur['metadata']['resource_version']}"
                )
            new = self._doc(obj)
            if status_only:
                # status subresource: spec/labels/owner refs are taken from
                # the stored copy, only status moves.
                merged = dict(cur)
                merged["status"] = new.get("status")
                new = merged
            else:
                # spec update: preserve stored status, bump generation if the
                # spec actually changed.
                new["status"] = cur.get("status")
                if new.get("spec") != cur.get("spec"):
                    new["metadata"]["generation"] = cur["metadata"]["generation"] + 1
                else:
                    new["metadata"]["generation"] = cur["metadata"]["generation"]
            new["metadata"]["resource_version"] = self._next_rv()
            # admission check: a doc that cannot round-trip through its model
            # (e.g. a handler assigned a wrong-typed field: assignment is not
            # validated) must never be committed, or every
            # subsequent read of the object would fail
            try:
                result = from_doc(new)
            except Exception as e:
                self._rv -= 1
                raise Invalid(f"invalid object state for {key}: {e}") from e
            self._objects[key] = new
            if new.get("kind") == "Lease":
                self._lease_touched[key] = time.time()
            self._backend.put(new, self._rv)
            self._notify("MODIFIED", new)
        return result

    def update(self, obj: Resource, fence: Optional[dict] = None) -> Resource:
        return self._update(obj, status_only=False, fence=fence)

    def update_status(self, obj: Resource, fence: Optional[dict] = None) -> Resource:
        return self._update(obj, status_only=True, fence=fence)

    def delete(
        self,
        kind: str,
        name: str,
        namespace: str = "default",
        resource_version: Optional[int] = None,
        fence: Optional[dict] = None,
    ) -> None:
        """Delete; with ``resource_version`` set, a precondition delete (k8s
        ``Preconditions.ResourceVersion``): raises Conflict if the stored
        object has moved on — used by lease release so a holder never deletes
        a lease another replica adopted after expiry."""
        with self._lock:
            self._check_fence(fence)
            key = (kind, namespace, name)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFound(f"{key} not found")
            if (
                resource_version is not None
                and cur["metadata"]["resource_version"] != resource_version
            ):
                raise Conflict(
                    f"{key}: resource_version {resource_version} != "
                    f"{cur['metadata']['resource_version']}"
                )
            doc = self._objects.pop(key)
            self._lease_touched.pop(key, None)
            self._backend.remove(key, self._rv)
            self._notify("DELETED", doc)
            self._gc_owned(doc["metadata"]["uid"])

    def _gc_owned(self, owner_uid: str) -> None:
        """Cascade-delete objects owned by ``owner_uid`` (k8s GC equivalent)."""
        owned = [
            key
            for key, doc in self._objects.items()
            if any(
                ref.get("uid") == owner_uid
                for ref in doc["metadata"].get("owner_references") or []
            )
        ]
        for kind, ns, name in owned:
            try:
                self.delete(kind, name, ns)
            except NotFound:
                pass

    # -- conflict-retried mutation -----------------------------------------

    def mutate_status(
        self,
        kind: str,
        name: str,
        namespace: str,
        fn: Callable[[Resource], None],
        attempts: int = 3,
    ) -> Resource:
        """Get-latest, apply ``fn``, update status; retry on Conflict."""
        last: Exception | None = None
        for _ in range(attempts):
            obj = self.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update_status(obj)
            except Conflict as e:  # re-get and retry
                last = e
        raise last  # type: ignore[misc]

    # -- watch -----------------------------------------------------------

    def watch(
        self, kinds: str | Iterable[str], namespace: Optional[str] = None
    ) -> "Watch":
        if isinstance(kinds, str):
            kinds = [kinds]
        w = _Watcher(kinds=frozenset(kinds), namespace=namespace, loop=_current_loop())
        with self._lock:
            self._watchers.append(w)
        return Watch(self, w)

    def _unwatch(self, w: _Watcher) -> None:
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def close(self) -> None:
        self._backend.close()


class Watch:
    """Async iterator over watch events; ``stop()`` detaches and ends iteration."""

    _SENTINEL = object()

    def __init__(self, store: Store, watcher: _Watcher):
        self._store = store
        self._watcher = watcher

    def __aiter__(self) -> "Watch":
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self._watcher.queue.get()
        if ev is self._SENTINEL:
            raise StopAsyncIteration
        return ev

    async def next(self, timeout: float | None = None) -> Optional[WatchEvent]:
        try:
            ev = await asyncio.wait_for(self._watcher.queue.get(), timeout)
        except asyncio.TimeoutError:
            return None
        if ev is self._SENTINEL:
            return None
        return ev

    def stop(self) -> None:
        self._store._unwatch(self._watcher)
        # unblock any consumer parked in __anext__/next
        if self._watcher.loop is not None and self._watcher.loop is not _current_loop():
            self._watcher.loop.call_soon_threadsafe(
                self._watcher.queue.put_nowait, self._SENTINEL
            )
        else:
            self._watcher.queue.put_nowait(self._SENTINEL)


async def wait_for(
    store: Store,
    kind: str,
    name: str,
    namespace: str,
    predicate: Callable[[Resource], bool],
    timeout: float = 10.0,
    poll: float = 0.02,
) -> Resource:
    """Poll until ``predicate(obj)`` holds; ``TimeoutError`` after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        obj = store.try_get(kind, name, namespace)
        if obj is not None and predicate(obj):
            return obj
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {kind} {namespace}/{name}")
        await asyncio.sleep(poll)


class FencedStore:
    """A Store view whose every MUTATION carries a fencing token read from
    ``fence_provider`` at call time (``None`` = not leader => immediate
    Conflict). Leader-gated work (the REST server in multi-replica
    deployments) writes through this view, so a deposed-but-alive leader's
    in-flight writes are rejected by the store atomically with the check of
    the election lease's holder+epoch — closing the window where a stale
    leader could act for seconds on a poll-gated ``is_leader``. Reads and
    watches pass through unfenced (serving a stale read is the same
    exposure any cache has; only externally-visible mutation needs the
    token)."""

    def __init__(self, store, fence_provider: Callable[[], Optional[dict]]):
        self._store = store
        self._fence = fence_provider

    def _require(self) -> dict:
        fence = self._fence()
        if fence is None:
            raise Conflict("fencing: this replica is not the leader")
        return fence

    # -- fenced mutations -------------------------------------------------

    def create(self, obj: Resource) -> Resource:
        return self._store.create(obj, fence=self._require())

    def update(self, obj: Resource) -> Resource:
        return self._store.update(obj, fence=self._require())

    def update_status(self, obj: Resource) -> Resource:
        return self._store.update_status(obj, fence=self._require())

    def delete(self, kind: str, name: str, namespace: str = "default",
               resource_version: Optional[int] = None) -> None:
        self._store.delete(kind, name, namespace,
                           resource_version=resource_version,
                           fence=self._require())

    def mutate_status(self, kind: str, name: str, namespace: str,
                      fn: Callable[[Resource], None], attempts: int = 3) -> Resource:
        last: Exception | None = None
        for _ in range(attempts):
            obj = self._store.get(kind, name, namespace)
            fn(obj)
            try:
                return self.update_status(obj)
            except Conflict as e:
                if "fencing" in str(e):
                    raise  # deposed: retrying cannot help
                last = e
        raise last  # type: ignore[misc]

    # -- reads/watches pass through --------------------------------------

    def __getattr__(self, name: str):
        return getattr(self._store, name)
