"""LLM client factory, the dependency-injection seam (the port's copy of
the reference's ``llmclient/factory.py``).

Controllers never construct providers directly: tests inject mocks, and
the in-process engine is one more provider (``tpu``). The reference's
HTTP providers (openai, mistral, google, vertex, anthropic) need an HTTP
client library the card's machine lacks and are not ported yet (ROADMAP
A.16); ``create_client`` refuses them with ``Invalid``.
"""

from __future__ import annotations

from typing import Optional, Protocol

from ..api.resources import LLM, Secret, SecretKeyRef, TPUProviderConfig
from ..kernel.errors import Invalid, NotFound
from ..kernel.store import Store
from .base import LLMClient
from .mock import MockLLMClient

HTTP_PROVIDERS = ("openai", "mistral", "google", "vertex", "anthropic")


class LLMClientFactory(Protocol):
    async def create_client(self, llm: LLM, api_key: str) -> LLMClient: ...

    @property
    def engine(self):
        """The in-process serving engine, or None when this factory only
        routes to external providers. Public so reconcilers can validate
        declarative parallelism specs against the live engine."""
        ...


def resolve_secret_key(store: Store, namespace: str, ref: Optional[SecretKeyRef]) -> str:
    if ref is None:
        return ""
    try:
        secret = store.get("Secret", ref.name, namespace)
    except NotFound:
        raise Invalid(f'secret "{ref.name}" not found') from None
    assert isinstance(secret, Secret)
    if ref.key not in secret.spec.data:
        raise Invalid(f'key "{ref.key}" not found in secret "{ref.name}"')
    return secret.spec.data[ref.key]


class DefaultLLMClientFactory:
    """Routes on ``spec.provider``: ``tpu`` to the in-process engine's
    client, ``mock`` to a ``MockLLMClient``."""

    def __init__(self, engine=None):
        self._engine = engine

    @property
    def engine(self):
        return self._engine

    async def create_client(self, llm: LLM, api_key: str) -> LLMClient:
        provider = llm.spec.provider
        if provider in HTTP_PROVIDERS:
            raise Invalid(f"provider {provider} is not ported yet (only tpu and mock are)")
        if provider == "tpu":
            if self._engine is None:
                raise Invalid("provider tpu requires a serving engine")
            from ..engine.client import TPUEngineClient

            tpu = llm.spec.tpu or TPUProviderConfig()
            return TPUEngineClient(
                self._engine,
                llm.spec.parameters,
                force_json_tools=bool(llm.spec.provider_config.get("force_json_tools", False)),
                tool_choice=str(llm.spec.provider_config.get("tool_choice", "auto")),
                request_timeout_s=tpu.request_timeout_seconds,
                queue_timeout_s=tpu.queue_timeout_seconds,
                overlap_tool_calls=tpu.overlap_tool_calls,
            )
        if provider == "mock":
            return MockLLMClient(delay_s=float(llm.spec.provider_config.get("delay_s", 0.0)))
        raise Invalid(f"unknown provider {provider!r}")


class MockLLMClientFactory:
    """Always returns the injected client (test seam)."""

    def __init__(self, client: LLMClient):
        self.client = client
        self.calls: list[LLM] = []

    @property
    def engine(self):
        return None

    async def create_client(self, llm: LLM, api_key: str) -> LLMClient:
        self.calls.append(llm)
        return self.client
