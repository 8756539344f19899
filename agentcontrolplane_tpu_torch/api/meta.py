"""Object metadata: the subset of Kubernetes ObjectMeta the control plane
relies on (the port's copy of the reference's ``api/meta.py``).

Names and namespaces, labels (the fan-out/fan-in joins), owner references
(garbage collection of owned objects) and ``resource_version`` optimistic
concurrency. Python code uses snake_case; manifests may use camelCase
(``schema.APIModel``), and the store keeps snake_case.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from ..schema import APIModel


@dataclass(kw_only=True)
class OwnerReference(APIModel):
    """Reference to an owning object; owned objects are garbage-collected."""

    kind: str
    name: str
    uid: str
    controller: bool = True


@dataclass(kw_only=True)
class ObjectMeta(APIModel):
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: uuid.uuid4().hex)
    resource_version: int = 0
    generation: int = 0
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None


@dataclass(kw_only=True)
class Resource(APIModel):
    """Base class of every API object (a CRD's equivalent). Subclasses set
    ``kind`` as a class-level default and define ``spec`` and ``status``."""

    kind: str = ""
    metadata: ObjectMeta

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.kind, self.metadata.namespace, self.metadata.name)

    def owner_ref(self) -> OwnerReference:
        return OwnerReference(kind=self.kind, name=self.metadata.name, uid=self.metadata.uid)


def new_meta(name: str, namespace: str = "default", labels: dict[str, str] | None = None) -> ObjectMeta:
    return ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {}))
