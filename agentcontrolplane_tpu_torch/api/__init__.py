"""The object model (``resources.py``), its metadata (``meta.py``) and the
manifest reader (``manifests.py``, YAML through ``yamlsubset.py``)."""

from .meta import ObjectMeta, OwnerReference, Resource, new_meta
from .resources import *  # noqa: F401,F403
from .resources import KINDS, from_doc

__all__ = ["ObjectMeta", "OwnerReference", "Resource", "new_meta", "KINDS", "from_doc"]
