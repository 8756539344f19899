"""ContactChannel controller: validates a channel's config and credentials
(the port's copy of the reference's ``controllers/contactchannel.py``).

Config shape (email address, Slack channel id), the API key's Secret, then
the credentials through the human layer's ``verify_project``; with the
in-tree ``LocalHumanBackend`` that is a local call.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..api.resources import ContactChannel
from ..humanlayer.client import HumanLayerClientFactory
from ..kernel.errors import Invalid
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store
from ..llmclient.factory import resolve_secret_key

REQUEUE_AFTER_ERROR = 30.0
EMAIL_RE = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")
SLACK_ID_RE = re.compile(r"^[CDUW][A-Z0-9]{6,12}$")


def validate_channel_config(channel: ContactChannel) -> None:
    spec = channel.spec
    if spec.api_key_from is None and spec.channel_api_key_from is None:
        raise Invalid("one of apiKeyFrom or channelApiKeyFrom is required")
    if spec.api_key_from is not None and spec.channel_api_key_from is not None:
        raise Invalid("apiKeyFrom and channelApiKeyFrom are mutually exclusive")
    if spec.channel_api_key_from is not None and not spec.channel_id:
        raise Invalid("channelApiKeyFrom requires channelId")
    if spec.type == "email":
        if spec.email is None or not spec.email.address:
            raise Invalid("email channel requires an email address")
        if not EMAIL_RE.match(spec.email.address):
            raise Invalid(f"invalid email address {spec.email.address!r}")
    elif spec.type == "slack":
        if spec.slack is None or not spec.slack.channel_or_user_id:
            if not spec.channel_id:
                raise Invalid("slack channel requires channelOrUserId")
        elif not SLACK_ID_RE.match(spec.slack.channel_or_user_id):
            raise Invalid(f"invalid Slack channel/user id {spec.slack.channel_or_user_id!r}")


@dataclass
class ContactChannelReconciler:
    store: Store
    recorder: EventRecorder
    hl_factory: Optional[HumanLayerClientFactory] = None
    verify_credentials: bool = True

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        channel = self.store.try_get("ContactChannel", name, ns)
        if channel is None:
            return Result.done()
        assert isinstance(channel, ContactChannel)

        try:
            validate_channel_config(channel)
            api_key = resolve_secret_key(
                self.store, ns, channel.spec.api_key_from or channel.spec.channel_api_key_from
            )
        except Invalid as e:
            self._set_status(channel, ready=False, status="Error", detail=str(e))
            self.recorder.event(channel, "Warning", "ValidationFailed", str(e))
            return Result.after(REQUEUE_AFTER_ERROR)

        if self.verify_credentials and self.hl_factory is not None:
            client = self.hl_factory.create_client(api_key)
            verify = getattr(client, "verify_project", None)
            if verify is not None:
                try:
                    await verify()
                except Exception as e:
                    detail = f"Credential verification failed: {e}"
                    self._set_status(channel, ready=False, status="Error", detail=detail)
                    self.recorder.event(channel, "Warning", "VerificationFailed", detail)
                    return Result.after(REQUEUE_AFTER_ERROR)

        if not channel.status.ready:
            self._set_status(channel, ready=True, status="Ready", detail="Channel validated")
            self.recorder.event(channel, "Normal", "ValidationSucceeded", "Contact channel validated")
        return Result.done()

    def _set_status(self, channel: ContactChannel, ready: bool, status: str, detail: str) -> None:
        if (channel.status.ready, channel.status.status, channel.status.status_detail) == (
                ready, status, detail):
            # unchanged: the write's own watch event would only re-run this
            # reconcile at once (the reference rewrites; ROADMAP C)
            return

        def apply(fresh) -> None:
            fresh.status.ready = ready
            fresh.status.status = status
            fresh.status.status_detail = detail

        self.store.mutate_status("ContactChannel", channel.name, channel.namespace, apply)
