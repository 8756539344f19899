"""Manifest loading, the ``kubectl apply`` equivalent (the port's copy of
the reference's ``api/manifests.py``).

Field names accept snake_case and camelCase (``schema.APIModel``). Text is
read as YAML, multi-document, through ``yamlsubset`` (the card's machine
has no YAML library; the subset covers ``examples/*.yaml`` and refuses what
it does not read); JSON text goes through ``json`` first. A document is
one object, a list of objects, or ``{"items": [...]}``. ``dump_manifests``
writes YAML that the reference's reader loads too.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

from ..kernel.errors import Invalid
from .meta import Resource
from .resources import KINDS
from .yamlsubset import dump_all, load_all


def resource_from_manifest(doc: dict[str, Any]) -> Resource:
    if not isinstance(doc, dict):
        raise Invalid("manifest must be a mapping")
    kind = doc.get("kind")
    if not kind or kind not in KINDS:
        raise Invalid(f"unknown kind {kind!r} (known: {sorted(KINDS)})")
    meta = doc.get("metadata") or {}
    if not meta.get("name"):
        raise Invalid(f"{kind} manifest requires metadata.name")
    body = {
        "kind": kind,
        "metadata": meta,
        "spec": doc.get("spec") or {},
    }
    if doc.get("status") is not None:
        body["status"] = doc["status"]
    try:
        return KINDS[kind].model_validate(body)
    except Exception as e:
        raise Invalid(f"invalid {kind} manifest: {e}") from e


def load_manifests(text: str) -> list[Resource]:
    """Parse a (multi-document) YAML or JSON string into resources."""
    try:
        docs = [json.loads(text)]
    except ValueError:
        docs = load_all(text)
    out: list[Resource] = []
    for doc in docs:
        if doc is None:
            continue
        if isinstance(doc, dict) and "kind" not in doc and isinstance(doc.get("items"), list):
            doc = doc["items"]
        if isinstance(doc, list):
            out.extend(resource_from_manifest(d) for d in doc)
        else:
            out.append(resource_from_manifest(doc))
    return out


def apply_resources(store, resources: Iterable[Resource]) -> list[tuple[str, Resource]]:
    """Create-or-update (kubectl apply semantics): spec and labels are taken
    from the manifest; status and system metadata are preserved."""
    results: list[tuple[str, Resource]] = []
    for res in resources:
        existing = store.try_get(res.kind, res.metadata.name, res.metadata.namespace)
        if existing is None:
            results.append(("created", store.create(res)))
            continue
        existing.spec = res.spec
        existing.metadata.labels = dict(res.metadata.labels)
        existing.metadata.annotations = dict(res.metadata.annotations)
        results.append(("configured", store.update(existing)))
    return results


def resource_to_manifest(res: Resource, include_status: bool = True) -> dict[str, Any]:
    doc: dict[str, Any] = {
        "kind": res.kind,
        "metadata": res.metadata.model_dump(exclude_none=True),
        "spec": res.spec.model_dump(exclude_none=True) if hasattr(res, "spec") else {},
    }
    if include_status and hasattr(res, "status"):
        doc["status"] = res.status.model_dump(exclude_none=True)
    return doc


def dump_manifests(resources: Iterable[Resource]) -> str:
    """Multi-document YAML, ``load_manifests``' input form."""
    return dump_all(resource_to_manifest(r) for r in resources)
