"""Event recorder: Kubernetes Events as user-facing execution history (the
port's copy of the reference's ``kernel/events.py``).

Events are store objects of kind Event, deduplicated by (involved uid,
reason, message) with a bumped count, as Kubernetes does. Deduplication
uses an in-memory index plus a label on the Event, so emitting one is
O(1), not a namespace scan.
"""

from __future__ import annotations

import time
import uuid

from ..api.meta import ObjectMeta, Resource
from ..api.resources import Event, EventSpec
from .errors import Conflict, NotFound
from .store import Store

LABEL_INVOLVED_UID = "acp.tpu/involved-uid"


class EventRecorder:
    def __init__(self, store: Store, component: str = "acp-tpu"):
        self._store = store
        self.component = component
        # (namespace, involved_uid, reason, message) -> event name
        self._index: dict[tuple[str, str, str, str], str] = {}

    def event(self, obj: Resource, type_: str, reason: str, message: str) -> None:
        now = time.time()
        ns = obj.metadata.namespace
        idx_key = (ns, obj.metadata.uid, reason, message)
        existing_name = self._index.get(idx_key)
        if existing_name is not None:
            existing = self._store.try_get("Event", existing_name, ns)
            if isinstance(existing, Event):
                existing.spec.count += 1
                existing.spec.last_timestamp = now
                try:
                    self._store.update(existing)
                    return
                except (Conflict, NotFound):
                    pass
        name = f"{obj.metadata.name}.{uuid.uuid4().hex[:10]}"
        self._store.create(
            Event(
                metadata=ObjectMeta(
                    name=name, namespace=ns, labels={LABEL_INVOLVED_UID: obj.metadata.uid}
                ),
                spec=EventSpec(
                    involved_kind=obj.kind,
                    involved_name=obj.metadata.name,
                    involved_uid=obj.metadata.uid,
                    type=type_,
                    reason=reason,
                    message=message,
                    count=1,
                    last_timestamp=now,
                ),
            )
        )
        self._index[idx_key] = name

    def events_for(self, obj: Resource) -> list[Event]:
        return [
            ev
            for ev in self._store.list(
                "Event",
                obj.metadata.namespace,
                label_selector={LABEL_INVOLVED_UID: obj.metadata.uid},
            )
            if isinstance(ev, Event)
        ]
