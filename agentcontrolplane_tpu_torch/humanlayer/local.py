"""In-tree human interaction backend (the port's copy of the reference's
``humanlayer/local.py``): the operator's default human layer, with no
external service.

Pending approvals and contacts are held here; a human (or a test) answers
them through ``approve`` / ``reject`` / ``respond``, over the operator's
REST routes (``server/operator_rest.py``) or directly. The REST routes run
on the HTTP server's worker threads while the controllers' clients run on
the operator's event loop, so every read and write of the two tables takes
the backend's lock (each hold is a few dict operations; nothing awaits
under it). The ``should_fail`` / ``auto_approve`` / ``auto_respond`` knobs
make it the scriptable mock too.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from .client import ApprovalStatus, FunctionCallSpec, HumanContactStatus


@dataclass
class PendingApproval:
    call_id: str
    run_id: str
    fn: str
    kwargs: dict[str, Any]
    channel: Optional[dict[str, Any]]
    created: float
    approved: Optional[bool] = None
    comment: str = ""


@dataclass
class PendingContact:
    call_id: str
    run_id: str
    message: str
    channel: Optional[dict[str, Any]]
    created: float
    response: Optional[str] = None


@dataclass
class LocalHumanBackend:
    """Shared state: one instance per operator process; every channel's
    client resolves to it."""

    approvals: dict[str, PendingApproval] = field(default_factory=dict)
    contacts: dict[str, PendingContact] = field(default_factory=dict)
    # mock knobs (mock_hlclient.go:13-24)
    should_fail: bool = False
    auto_approve: Optional[bool] = None  # True/False = instant verdict
    auto_respond: Optional[str] = None
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    # -- human-side API (REST server / tests call these) -----------------

    def approve(self, call_id: str, comment: str = "") -> None:
        with self.lock:
            self.approvals[call_id].approved = True
            self.approvals[call_id].comment = comment

    def reject(self, call_id: str, comment: str = "") -> None:
        with self.lock:
            self.approvals[call_id].approved = False
            self.approvals[call_id].comment = comment

    def respond(self, call_id: str, response: str) -> None:
        with self.lock:
            self.contacts[call_id].response = response

    def pending_approvals(self) -> list[PendingApproval]:
        with self.lock:
            return [a for a in self.approvals.values() if a.approved is None]

    def pending_contacts(self) -> list[PendingContact]:
        with self.lock:
            return [c for c in self.contacts.values() if c.response is None]


class LocalHumanLayerClient:
    """Client view over a LocalHumanBackend (implements HumanLayerClient)."""

    def __init__(self, backend: LocalHumanBackend):
        self._b = backend

    async def request_approval(self, run_id: str, call_id: str, spec: FunctionCallSpec) -> str:
        if self._b.should_fail:
            raise RuntimeError("human backend unavailable (scripted failure)")
        call_id = call_id or uuid.uuid4().hex[:12]
        pending = PendingApproval(
            call_id=call_id,
            run_id=run_id,
            fn=spec.fn,
            kwargs=spec.kwargs,
            channel=spec.channel,
            created=time.time(),
            approved=self._b.auto_approve,
            comment="" if self._b.auto_approve is None else "auto",
        )
        with self._b.lock:
            self._b.approvals[call_id] = pending
        return call_id

    async def get_function_call_status(self, call_id: str) -> ApprovalStatus:
        if self._b.should_fail:
            raise RuntimeError("human backend unavailable (scripted failure)")
        with self._b.lock:
            a = self._b.approvals[call_id]
            return ApprovalStatus(approved=a.approved, comment=a.comment)

    async def request_human_contact(
        self, run_id: str, call_id: str, message: str, channel: Optional[dict[str, Any]] = None
    ) -> str:
        if self._b.should_fail:
            raise RuntimeError("human backend unavailable (scripted failure)")
        call_id = call_id or uuid.uuid4().hex[:12]
        pending = PendingContact(
            call_id=call_id,
            run_id=run_id,
            message=message,
            channel=channel,
            created=time.time(),
            response=self._b.auto_respond,
        )
        with self._b.lock:
            self._b.contacts[call_id] = pending
        return call_id

    async def get_human_contact_status(self, call_id: str) -> HumanContactStatus:
        if self._b.should_fail:
            raise RuntimeError("human backend unavailable (scripted failure)")
        with self._b.lock:
            return HumanContactStatus(response=self._b.contacts[call_id].response)

    async def verify_project(self) -> dict[str, Any]:
        if self._b.should_fail:
            raise RuntimeError("human backend unavailable (scripted failure)")
        return {"project": "local", "org": "local"}


class LocalHumanLayerClientFactory:
    def __init__(self, backend: Optional[LocalHumanBackend] = None):
        self.backend = backend or LocalHumanBackend()

    def create_client(self, api_key: str) -> LocalHumanLayerClient:
        return LocalHumanLayerClient(self.backend)
