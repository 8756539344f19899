"""Manifest loading, the ``kubectl apply`` equivalent (the port's copy of
the reference's ``api/manifests.py``).

Field names accept snake_case and camelCase (``schema.APIModel``). The
reference reads YAML; the port reads and writes JSON, since the card's
machine has no YAML library: a document is one object, a list of objects,
or ``{"items": [...]}``. JSON text is also YAML, so a file written here
loads in the reference too.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

from ..kernel.errors import Invalid
from .meta import Resource
from .resources import KINDS


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
    """Parse a JSON manifest document into resources."""
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise Invalid(f"manifest is not valid JSON: {e}") from e
    if doc is None:
        return []
    if isinstance(doc, dict) and "kind" not in doc and isinstance(doc.get("items"), list):
        doc = doc["items"]
    if isinstance(doc, list):
        return [resource_from_manifest(d) for d in doc]
    return [resource_from_manifest(doc)]


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
    """A JSON list of manifests, ``load_manifests``' input form."""
    return json.dumps([resource_to_manifest(r) for r in resources], indent=2)
