"""The human-layer seam: what the ToolCall controller asks of a human
approval / contact service (the port's copy of the reference's
``humanlayer/client.py``, its types and Protocols).

The port's implementation is the in-tree ``LocalHumanBackend``
(``local.py``), the operator's default. The reference's HTTP client of the
HumanLayer service needs an HTTP client library the card's machine lacks
and is not ported yet (ROADMAP A.16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Protocol


@dataclass
class FunctionCallSpec:
    """What the human is asked to approve (fn name + kwargs + channel)."""

    fn: str
    kwargs: dict[str, Any]
    channel: Optional[dict[str, Any]] = None


@dataclass
class ApprovalStatus:
    approved: Optional[bool] = None  # None = still pending
    comment: str = ""


@dataclass
class HumanContactStatus:
    response: Optional[str] = None  # None = still pending


class HumanLayerClient(Protocol):
    """The seam; the ToolCall controller depends only on this."""

    async def request_approval(self, run_id: str, call_id: str, spec: FunctionCallSpec) -> str: ...

    async def get_function_call_status(self, call_id: str) -> ApprovalStatus: ...

    async def request_human_contact(
        self, run_id: str, call_id: str, message: str, channel: Optional[dict[str, Any]] = None
    ) -> str: ...

    async def get_human_contact_status(self, call_id: str) -> HumanContactStatus: ...


class HumanLayerClientFactory(Protocol):
    def create_client(self, api_key: str) -> HumanLayerClient: ...
