"""Shared-secret comparison for the REST server's bearer auth (the port's
copy of the reference's ``utils/tokens.py``)."""

from __future__ import annotations

import hmac


def token_matches(supplied: str, expected: str) -> bool:
    """Constant-time equality on bytes: ``hmac.compare_digest`` on str
    raises TypeError for non-ASCII input, which would reject the correct
    secret (surrogateescape keeps even undecodable env-var bytes
    comparable)."""
    return hmac.compare_digest(
        supplied.encode("utf-8", "surrogateescape"),
        expected.encode("utf-8", "surrogateescape"),
    )
