"""Input validation and Kubernetes-style random names (the port's copy of
the reference's ``validation.py``)."""

from __future__ import annotations

import secrets
from typing import Optional

from .api.resources import Message, Task
from .kernel.errors import Invalid, NotFound
from .kernel.store import Store

VALID_ROLES = {"system", "user", "assistant", "tool"}


def validate_task_message_input(
    user_message: Optional[str], context_window: Optional[list[Message]]
) -> None:
    """Exactly one of userMessage / contextWindow; window roles valid and must
    contain ≥1 user message."""
    has_msg = bool(user_message)
    has_window = bool(context_window)
    if has_msg and has_window:
        raise Invalid("only one of userMessage or contextWindow can be provided")
    if not has_msg and not has_window:
        raise Invalid("one of userMessage or contextWindow must be provided")
    if context_window:
        has_user = False
        for msg in context_window:
            if msg.role not in VALID_ROLES:
                raise Invalid(f"invalid role in contextWindow: {msg.role}")
            if msg.role == "user":
                has_user = True
        if not has_user:
            raise Invalid("contextWindow must contain at least one user message")


def get_user_message_preview(
    user_message: Optional[str], context_window: Optional[list[Message]]
) -> str:
    """50-char preview from userMessage or last user message."""
    preview = ""
    if user_message:
        preview = user_message
    elif context_window:
        for msg in reversed(context_window):
            if msg.role == "user":
                preview = msg.content
                break
    if len(preview) > 50:
        preview = preview[:47] + "..."
    return preview


_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_ALNUM = _LETTERS + "0123456789"


def generate_k8s_random_string(n: int = 6) -> str:
    """Secure random k8s-compliant suffix: starts with a letter, lowercase
    alphanumeric, 1-8 chars."""
    if n < 1 or n > 8:
        n = 6
    return secrets.choice(_LETTERS) + "".join(
        secrets.choice(_ALNUM) for _ in range(n - 1)
    )


def validate_contact_channel_ref(store: Store, task: Task) -> None:
    """Referenced ContactChannel must exist and be ready. A
    channel_token_from Task (v1beta3) carries its own per-task credentials,
    so readiness of the shared channel object is still required but API-key
    validation happened at channel level."""
    ref = task.spec.contact_channel_ref
    if ref is None:
        return
    try:
        channel = store.get("ContactChannel", ref.name, task.namespace)
    except NotFound:
        raise Invalid(f'referenced ContactChannel "{ref.name}" not found') from None
    if not channel.status.ready:
        raise Invalid(
            f'referenced ContactChannel "{ref.name}" is not ready '
            f"(status: {channel.status.status})"
        )
