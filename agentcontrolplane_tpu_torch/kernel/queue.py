"""Rate-limited work queue: controller-runtime's workqueue, asyncio-native
(the port's copy of the reference's ``kernel/queue.py``).

Keys are deduplicated while pending (a hundred watch events for one object
collapse into one reconcile), failures back off exponentially (5 ms to
16 s, controller-runtime's defaults), and ``add_after`` implements
RequeueAfter.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import Generic, Hashable, Optional, TypeVar

T = TypeVar("T", bound=Hashable)

BASE_DELAY = 0.005
MAX_DELAY = 16.0


class WorkQueue(Generic[T]):
    def __init__(self):
        self._pending: set[T] = set()  # queued or scheduled, not yet handed out
        self._active: set[T] = set()  # handed out to a worker
        self._dirty: set[T] = set()  # re-added while active
        self._ready: list[T] = []
        self._delayed: list[tuple[float, int, T]] = []  # heap by fire time
        self._seq = 0
        self._failures: dict[T, int] = {}
        self._wakeup = asyncio.Event()
        self._shutdown = False

    def __len__(self) -> int:
        return len(self._ready) + len(self._delayed)

    def add(self, item: T) -> None:
        if self._shutdown:
            return
        if item in self._active:
            self._dirty.add(item)
            return
        if item in self._pending:
            return
        self._pending.add(item)
        self._ready.append(item)
        self._wakeup.set()

    def add_after(self, item: T, delay: float) -> None:
        if self._shutdown:
            return
        if delay <= 0:
            self.add(item)
            return
        self._seq += 1
        heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, item))
        self._wakeup.set()

    def add_rate_limited(self, item: T) -> None:
        n = self._failures.get(item, 0)
        self._failures[item] = n + 1
        self.add_after(item, min(BASE_DELAY * (2**n), MAX_DELAY))

    def forget(self, item: T) -> None:
        self._failures.pop(item, None)

    def done(self, item: T) -> None:
        self._active.discard(item)
        if item in self._dirty:
            self._dirty.discard(item)
            self.add(item)

    def shutdown(self) -> None:
        self._shutdown = True
        self._wakeup.set()

    def _promote_delayed(self) -> Optional[float]:
        """Move due delayed items to ready; return seconds until next fire."""
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item in self._active:
                self._dirty.add(item)
            elif item not in self._pending:
                self._pending.add(item)
                self._ready.append(item)
        if self._delayed:
            return max(self._delayed[0][0] - now, 0.0)
        return None

    async def get(self) -> Optional[T]:
        """Next item, or None on shutdown."""
        while True:
            next_fire = self._promote_delayed()
            if self._ready:
                item = self._ready.pop(0)
                self._pending.discard(item)
                self._active.add(item)
                return item
            if self._shutdown:
                return None
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=next_fire)
            except asyncio.TimeoutError:
                pass
