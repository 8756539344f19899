"""LLM controller: validates an LLM's provider config, then probes it with
a live one-token request (the port's copy of the reference's
``controllers/llm.py``).

A bad key or model fails at the LLM object, not mid-Task. For ``provider:
tpu`` the spec's parallelism and quantization are held against the live
engine (``engine.mesh.shape``, ``engine.quantize``, ``engine.quantize_kv``)
and the probe is a one-token request through the factory's
``TPUEngineClient``: a prefill on the engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..api.resources import LLM, BaseConfig, Message
from ..kernel.errors import Invalid, NotFound
from ..kernel.events import EventRecorder
from ..kernel.runtime import Result
from ..kernel.store import Key, Store
from ..llmclient.base import LLMRequestError
from ..llmclient.factory import LLMClientFactory, resolve_secret_key

REQUEUE_AFTER_ERROR = 30.0
PROVIDERS_REQUIRING_KEY = {"openai", "anthropic", "mistral", "google", "vertex"}


@dataclass
class LLMReconciler:
    store: Store
    recorder: EventRecorder
    llm_factory: LLMClientFactory
    probe: bool = True  # live 1-token validation request

    async def reconcile(self, key: Key) -> Result:
        _, ns, name = key
        llm = self.store.try_get("LLM", name, ns)
        if llm is None:
            return Result.done()
        assert isinstance(llm, LLM)

        try:
            api_key = self._validate_spec(llm, ns)
        except (Invalid, NotFound) as e:
            self._set_status(llm, ready=False, status="Error", detail=str(e))
            self.recorder.event(llm, "Warning", "ValidationFailed", str(e))
            return Result.after(REQUEUE_AFTER_ERROR)

        if self.probe:
            try:
                await self._probe(llm, api_key)
            except Exception as e:
                detail = f"Provider validation failed: {e}"
                self._set_status(llm, ready=False, status="Error", detail=detail)
                self.recorder.event(llm, "Warning", "ProbeFailed", detail)
                return Result.after(REQUEUE_AFTER_ERROR)

        if not llm.status.ready:
            self._set_status(llm, ready=True, status="Ready", detail="Provider validated")
            self.recorder.event(llm, "Normal", "ValidationSucceeded", "LLM provider validated")
        return Result.done()

    def _validate_spec(self, llm: LLM, ns: str) -> str:
        provider = llm.spec.provider
        if provider == "vertex" and not llm.spec.parameters.base_url:
            # Vertex has no hardcodable default endpoint (it is
            # project/region-scoped): never fall back to another vendor's.
            # The typed block derives it from cloudProject + cloudLocation;
            # baseURL overrides.
            if llm.spec.vertex is None:
                raise Invalid(
                    "provider vertex requires spec.vertex "
                    "(cloudProject + cloudLocation) or parameters.baseURL"
                )
        if provider in PROVIDERS_REQUIRING_KEY:
            if llm.spec.api_key_from is None:
                raise Invalid(f"provider {provider} requires apiKeyFrom")
            return resolve_secret_key(self.store, ns, llm.spec.api_key_from)
        if provider == "tpu":
            if llm.spec.tpu is None:
                raise Invalid("provider tpu requires a tpu config block")
            # the engine is process-wide (built before the control plane
            # starts); the CR's parallelism fields
            # are declarative intent, so a mismatch is a config error the
            # user must see at LLM validation time, not silently ignored
            engine = self.llm_factory.engine
            if engine is not None:
                shape = dict(engine.mesh.shape)
                want_tp = llm.spec.tpu.tensor_parallelism
                if want_tp and shape.get("tp", 1) != want_tp:
                    raise Invalid(
                        f"engine mesh tp={shape.get('tp', 1)} != spec "
                        f"tensorParallelism={want_tp} (set acp-tpu run --tpu-tp)"
                    )
                want_sp = llm.spec.tpu.context_parallelism
                if want_sp > 1 and shape.get("sp", 1) != want_sp:
                    raise Invalid(
                        f"engine mesh sp={shape.get('sp', 1)} != spec "
                        f"contextParallelism={want_sp} (set acp-tpu run --tpu-sp)"
                    )
                want_ep = llm.spec.tpu.expert_parallelism
                if want_ep > 1 and shape.get("ep", 1) != want_ep:
                    raise Invalid(
                        f"engine mesh ep={shape.get('ep', 1)} != spec "
                        f"expertParallelism={want_ep} (set acp-tpu run --tpu-ep)"
                    )
                # quantization is the same declarative-intent contract: a
                # spec requesting quantized serving from a bf16 engine must
                # fail validation, not silently serve unquantized
                want_qw = bool(
                    llm.spec.tpu.quantize_weights or llm.spec.tpu.quantization
                )
                if want_qw and engine.quantize != "int8":
                    raise Invalid(
                        "engine serves bf16 weights but spec requests "
                        "quantizeWeights (set acp-tpu run "
                        "--tpu-quantize-weights)"
                    )
                if llm.spec.tpu.quantize_kv and not engine.quantize_kv:
                    raise Invalid(
                        "engine serves bf16 KV but spec requests quantizeKv "
                        "(set acp-tpu run --tpu-quantize-kv)"
                    )
        return ""

    async def _probe(self, llm: LLM, api_key: str) -> None:
        """1-token live request."""
        probe_llm = llm.model_copy(deep=True)
        probe_llm.spec.parameters = BaseConfig(
            model=llm.spec.parameters.model,
            base_url=llm.spec.parameters.base_url,
            max_tokens=1,
        )
        client = await self.llm_factory.create_client(probe_llm, api_key)
        try:
            await client.send_request([Message(role="user", content="hi")], [])
        finally:
            await client.close()

    def _set_status(self, llm: LLM, ready: bool, status: str, detail: str) -> None:
        if (llm.status.ready, llm.status.status, llm.status.status_detail) == (
                ready, status, detail):
            # unchanged: the write's own watch event would only re-run this
            # reconcile at once, and so on (the reference rewrites, and an
            # Error LLM spins on its own status; ROADMAP C)
            return

        def apply(fresh) -> None:
            fresh.status.ready = ready
            fresh.status.status = status
            fresh.status.status_detail = detail

        self.store.mutate_status("LLM", llm.name, llm.namespace, apply)
