"""Human approval and contact: the seam (``client.py``) and the in-tree
backend (``local.py``)."""

from .client import (
    ApprovalStatus,
    FunctionCallSpec,
    HumanContactStatus,
    HumanLayerClient,
    HumanLayerClientFactory,
)
from .local import (
    LocalHumanBackend,
    LocalHumanLayerClient,
    LocalHumanLayerClientFactory,
    PendingApproval,
    PendingContact,
)

__all__ = [
    "ApprovalStatus", "FunctionCallSpec", "HumanContactStatus", "HumanLayerClient",
    "HumanLayerClientFactory", "LocalHumanBackend", "LocalHumanLayerClient",
    "LocalHumanLayerClientFactory", "PendingApproval", "PendingContact",
]
