"""The port's LLM and Agent controllers, client factory and ``Engine.mesh``
against the JAX package's, on the CPU.

- The reference's LLM and Agent controller cases (its
  ``tests/controllers/test_agent_llm_controllers.py``: probe success and
  failure, missing secret, the tpu mesh and quantization mismatches) and
  their neighbours are replayed on both packages: each gives the same
  status, requeue and Events (type, reason, message).
- With real engines (the tiny f32 preset, one module-scoped pair): a
  ``provider: tpu`` LLM validates and probes to the same phase and message
  against the port's engine and the JAX paged engine, and the port
  engine's ``stats()`` counts the probe's prefill.
- ``Engine.mesh.shape`` equals the reference's ``serving_mesh(...).shape``
  for tp=1, tp=2 and sp=2 x tp=2; the factory's ``tpu`` branch passes every
  timeout, ``overlapToolCalls`` and ``providerConfig`` field through as the
  reference's does, its ``mock`` branch returns ``MockLLMClient``, and the
  HTTP providers raise ``Invalid``.
"""

import asyncio
import dataclasses
import json
import types

import numpy as np
import pytest

import jax

import agentcontrolplane_tpu.api.resources as ref_resources
import agentcontrolplane_tpu.controllers.agent as ref_agent
import agentcontrolplane_tpu.controllers.llm as ref_llm
import agentcontrolplane_tpu.kernel as ref_kernel
import agentcontrolplane_tpu.llmclient as ref_llmclient
import agentcontrolplane_tpu.llmclient.factory as ref_factory
import agentcontrolplane_tpu_torch.api.resources as port_resources
import agentcontrolplane_tpu_torch.controllers.agent as port_agent
import agentcontrolplane_tpu_torch.controllers.llm as port_llm
import agentcontrolplane_tpu_torch.kernel as port_kernel
import agentcontrolplane_tpu_torch.llmclient.base as port_base
import agentcontrolplane_tpu_torch.llmclient.factory as port_factory
import agentcontrolplane_tpu_torch.llmclient.mock as port_mock
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.parallel.mesh import make_mesh, serving_mesh
from agentcontrolplane_tpu_torch.engine.engine import Engine
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.parallel.mesh import ServingGroup, ServingMesh

REF = types.SimpleNamespace(
    R=ref_resources, K=ref_kernel, LLMReconciler=ref_llm.LLMReconciler,
    AgentReconciler=ref_agent.AgentReconciler, factory=ref_factory,
    MockLLMClient=ref_llmclient.MockLLMClient, LLMRequestError=ref_llmclient.LLMRequestError,
    assistant=ref_llmclient.assistant)
PORT = types.SimpleNamespace(
    R=port_resources, K=port_kernel, LLMReconciler=port_llm.LLMReconciler,
    AgentReconciler=port_agent.AgentReconciler, factory=port_factory,
    MockLLMClient=port_mock.MockLLMClient, LLMRequestError=port_base.LLMRequestError,
    assistant=port_mock.assistant)


def _make(ns, store, kind, name, spec, status=None):
    obj = store.create(ns.R.KINDS[kind].model_validate(
        {"metadata": {"name": name}, "spec": spec}))
    if status is not None:
        obj.status = type(obj.status).model_validate(status)
        obj = store.update_status(obj)
    return obj


READY = {"ready": True, "status": "Ready"}
OPENAI = {"provider": "openai", "apiKeyFrom": {"name": "s", "key": "api-key"},
          "parameters": {"model": "gpt-4o"}}


def _tpu(**tpu):
    return {"provider": "tpu", "parameters": {"model": "m"}, "tpu": {"preset": "tiny", **tpu}}


def _engine(shape, quantize=None, quantize_kv=False):
    return types.SimpleNamespace(mesh=types.SimpleNamespace(shape=shape), quantize=quantize,
                                 quantize_kv=quantize_kv)


class EngineFactory:
    """A factory that only names an engine (the validator reads it)."""

    def __init__(self, engine):
        self.engine = engine


def _mock_factory(ns, *script):
    return ns.factory.MockLLMClientFactory(ns.MockLLMClient(script=list(script)))


BF16 = {"tp": 1}
# (LLM spec, factory maker, probe, secret data or None)
LLM_CASES = {
    "probe-success": (OPENAI, lambda ns: _mock_factory(ns, ns.assistant("ok")), True, {}),
    "probe-failure": (OPENAI, lambda ns: _mock_factory(ns, ns.LLMRequestError(401, "invalid key")),
                      True, {}),
    "missing-secret": ({**OPENAI, "apiKeyFrom": {"name": "absent", "key": "api-key"}},
                       lambda ns: _mock_factory(ns), False, None),
    "missing-key": ({**OPENAI, "apiKeyFrom": {"name": "s", "key": "nope"}},
                    lambda ns: _mock_factory(ns), False, {}),
    "no-api-key-from": ({"provider": "anthropic"}, lambda ns: _mock_factory(ns), False, None),
    "vertex-no-block": ({"provider": "vertex", "apiKeyFrom": {"name": "s", "key": "api-key"}},
                        lambda ns: _mock_factory(ns), False, {}),
    "tpu-no-block": ({"provider": "tpu"}, lambda ns: EngineFactory(_engine(BF16)), False, None),
    "tpu-tp-mismatch": (_tpu(tensorParallelism=2), lambda ns: EngineFactory(_engine(BF16)),
                        False, None),
    "tpu-sp-mismatch": (_tpu(contextParallelism=4),
                        lambda ns: EngineFactory(_engine({"sp": 1, "tp": 2})), False, None),
    "tpu-ep-mismatch": (_tpu(expertParallelism=2), lambda ns: EngineFactory(_engine(BF16)),
                        False, None),
    "tpu-tp-ok": (_tpu(tensorParallelism=2), lambda ns: EngineFactory(_engine({"sp": 1, "tp": 2})),
                  False, None),
    "quantize-weights-on-bf16": (_tpu(quantizeWeights=True),
                                 lambda ns: EngineFactory(_engine(BF16)), False, None),
    "quantization-legacy-on-bf16": (_tpu(quantization="int8"),
                                    lambda ns: EngineFactory(_engine(BF16)), False, None),
    "quantize-kv-on-bf16": (_tpu(quantizeKv=True), lambda ns: EngineFactory(_engine(BF16)),
                            False, None),
    "quantized-ok": (_tpu(quantizeWeights=True, quantizeKv=True),
                     lambda ns: EngineFactory(_engine(BF16, "int8", True)), False, None),
    "mock-probe": ({"provider": "mock"}, lambda ns: ns.factory.DefaultLLMClientFactory(), True,
                   None),
    "tpu-probe-without-engine": (_tpu(), lambda ns: ns.factory.DefaultLLMClientFactory(), True,
                                 None),
}


def _events(ns, store, obj) -> list:
    return sorted((e.spec.type, e.spec.reason, e.spec.message, e.spec.count)
                  for e in ns.K.EventRecorder(store).events_for(obj))


async def _llm_case(ns, case) -> dict:
    spec, factory_of, probe, secret = LLM_CASES[case]
    store = ns.K.Store()
    if secret is not None:
        _make(ns, store, "Secret", "s", {"data": {"api-key": "sk-1", **secret}})
    factory = factory_of(ns)
    rec = ns.LLMReconciler(store, ns.K.EventRecorder(store), factory, probe=probe)
    _make(ns, store, "LLM", "l", spec)
    first = await rec.reconcile(("LLM", "default", "l"))
    status = store.get("LLM", "l").status.model_dump()
    # a settled object stays put; a failed probe is retried (the mock's
    # script is spent, so the retry succeeds)
    second = await rec.reconcile(("LLM", "default", "l"))
    llm = store.get("LLM", "l")
    calls = [c.spec.parameters.max_tokens for c in getattr(factory, "calls", [])]
    return {"status": status, "final_status": llm.status.model_dump(),
            "results": [dataclasses.astuple(first), dataclasses.astuple(second)],
            "events": _events(ns, store, llm), "probe_max_tokens": calls}


@pytest.mark.parametrize("case", LLM_CASES)
async def test_llm_controller_matches_the_reference(case):
    ref, ours = await _llm_case(REF, case), await _llm_case(PORT, case)
    assert ours == ref
    if case.startswith(("probe-success", "quantized-ok", "tpu-tp-ok", "mock-probe")):
        assert ours["status"]["status"] == "Ready"
    else:
        assert ours["status"]["status"] == "Error" and ours["results"][0][1] == 30.0
    if case == "probe-success":
        assert ours["probe_max_tokens"] == [1, 1]  # the 1-token probe


AGENT_CASES = {
    # (dependencies to create: (kind, name, spec, status)), agent spec
    "all-ready": ([("LLM", "l", {"provider": "mock"}, READY),
                   ("MCPServer", "fetch", {"transport": "stdio", "command": "uvx"},
                    {"connected": True, "status": "Ready",
                     "tools": [{"name": "fetch"}, {"name": "post"}]}),
                   ("ContactChannel", "oncall", {"type": "email"}, READY),
                   ("Agent", "sub", {"llmRef": {"name": "l"}, "system": "s",
                                     "description": "helps"}, READY)],
                  {"mcpServers": [{"name": "fetch"}], "humanContactChannels": [{"name": "oncall"}],
                   "subAgents": [{"name": "sub"}]}),
    "missing-llm": ([], {}),
    "pending-llm": ([("LLM", "l", {"provider": "mock"}, None)], {}),
    "pending-deps": ([("LLM", "l", {"provider": "mock"}, READY),
                      ("MCPServer", "fetch", {"transport": "stdio", "command": "uvx"}, None),
                      ("ContactChannel", "oncall", {"type": "slack"}, None),
                      ("Agent", "sub", {"llmRef": {"name": "l"}, "system": "s"}, None)],
                     {"mcpServers": [{"name": "fetch"}], "humanContactChannels": [{"name": "oncall"}],
                      "subAgents": [{"name": "sub"}]}),
    "missing-deps": ([("LLM", "l", {"provider": "mock"}, None)],
                     {"mcpServers": [{"name": "gone"}], "humanContactChannels": [{"name": "gone"}],
                      "subAgents": [{"name": "gone"}]}),
}


async def _agent_case(ns, case) -> dict:
    deps, extra = AGENT_CASES[case]
    store = ns.K.Store()
    for kind, name, spec, status in deps:
        _make(ns, store, kind, name, spec, status)
    rec = ns.AgentReconciler(store, ns.K.EventRecorder(store))
    _make(ns, store, "Agent", "a", {"llmRef": {"name": "l"}, "system": "be brief", **extra})
    results = [dataclasses.astuple(await rec.reconcile(("Agent", "default", "a")))
               for _ in range(2)]
    agent = store.get("Agent", "a")
    return {"status": agent.status.model_dump(), "results": results,
            "events": _events(ns, store, agent)}


@pytest.mark.parametrize("case", AGENT_CASES)
async def test_agent_controller_matches_the_reference(case):
    ref, ours = await _agent_case(REF, case), await _agent_case(PORT, case)
    assert ours == ref
    want = {"all-ready": "Ready", "missing-llm": "Error", "pending-llm": "Pending",
            "pending-deps": "Pending", "missing-deps": "Error"}[case]
    assert ours["status"]["status"] == want


# -- real engines -------------------------------------------------------------

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=2, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4, page_size=8)


@pytest.fixture(scope="module")
def engines():
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    jax_engine = JaxEngine(
        config=JCFG, params=jax.tree_util.tree_map(jax.numpy.asarray, p),
        tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
        kv_layout="paged", prefix_cache_entries=0, **KW,
    )
    port = Engine(TCFG, params_from_jax(p, TCFG, device="cpu"), device="cpu", **KW)
    jax_engine.start()
    port.start()
    yield jax_engine, port
    jax_engine.stop()
    port.stop()


async def _probe_on(ns, engine, spec) -> tuple:
    store = ns.K.Store()
    rec = ns.LLMReconciler(store, ns.K.EventRecorder(store),
                           ns.factory.DefaultLLMClientFactory(engine), probe=True)
    _make(ns, store, "LLM", "l", spec)
    result = await rec.reconcile(("LLM", "default", "l"))
    llm = store.get("LLM", "l")
    return (llm.status.ready, llm.status.status, llm.status.status_detail,
            dataclasses.astuple(result), _events(ns, store, llm))


@pytest.mark.parametrize("spec,prefills", [
    (_tpu(tensorParallelism=1), 1),
    (_tpu(tensorParallelism=2), 0),
    (_tpu(quantizeWeights=True), 0),
], ids=["validated", "tp-mismatch", "quantize-mismatch"])
async def test_tpu_llm_probes_alike_on_real_engines(engines, spec, prefills):
    jax_engine, port = engines
    before = port.stats()["requests_prefilled"]
    ref = await _probe_on(REF, jax_engine, spec)
    ours = await _probe_on(PORT, port, spec)
    assert ours == ref
    assert port.stats()["requests_prefilled"] - before == prefills
    if prefills:
        assert ours[:3] == (True, "Ready", "Provider validated")
    else:
        assert ours[1] == "Error"


def test_engine_mesh_shape_is_the_reference_serving_mesh(engines):
    _, port = engines
    assert list(port.mesh.shape.items()) == list(serving_mesh(1).shape.items())
    assert port.stats()["mesh"] == dict(port.mesh.shape)
    for tp, sp in ((2, 1), (2, 2)):
        group = ServingGroup(tp=tp, sp=sp, rank=0, tp_rank=0, sp_rank=0)
        assert list(ServingMesh.of(group).shape.items()) == \
            list(serving_mesh(tp, sp).shape.items())


# -- the factory --------------------------------------------------------------

FACTORY_SPECS = {
    "defaults": _tpu(),
    "no-tpu-block": {"provider": "tpu"},
    "every-field": {
        "provider": "tpu",
        "parameters": {"model": "m", "temperature": 0.3, "maxTokens": 7, "topP": 0.9, "topK": 5,
                       "baseUrl": "u", "frequencyPenalty": 0.1, "presencePenalty": 0.2},
        "tpu": {"preset": "tiny", "requestTimeoutSeconds": 5, "queueTimeoutSeconds": 9.5,
                "overlapToolCalls": False},
        "providerConfig": {"force_json_tools": True, "tool_choice": "required"},
    },
    "named-tool": {**_tpu(), "providerConfig": {"tool_choice": "search", "force_json_tools": 0}},
}


def _client_view(client) -> dict:
    return {"params": json.loads(json.dumps(client.params.model_dump())),
            **{k: getattr(client, k) for k in (
                "force_json_tools", "tool_choice", "request_timeout_s", "queue_timeout_s",
                "overlap_tool_calls", "supports_early_tool_calls")}}


@pytest.mark.parametrize("case", FACTORY_SPECS)
async def test_factory_tpu_branch_passes_every_field_through(case):
    spec = FACTORY_SPECS[case]
    stub = object()
    ref = await REF.factory.DefaultLLMClientFactory(stub).create_client(
        REF.R.LLM.model_validate({"metadata": {"name": "l"}, "spec": spec}), "")
    ours = await PORT.factory.DefaultLLMClientFactory(stub).create_client(
        PORT.R.LLM.model_validate({"metadata": {"name": "l"}, "spec": spec}), "")
    assert type(ours).__name__ == type(ref).__name__ == "TPUEngineClient"
    assert ours.engine is stub
    assert _client_view(ours) == _client_view(ref)


async def test_factory_mock_branch_and_secrets():
    spec = {"provider": "mock", "providerConfig": {"delay_s": "0.25"}}
    client = await PORT.factory.DefaultLLMClientFactory().create_client(
        PORT.R.LLM.model_validate({"metadata": {"name": "l"}, "spec": spec}), "")
    ref = await REF.factory.DefaultLLMClientFactory().create_client(
        REF.R.LLM.model_validate({"metadata": {"name": "l"}, "spec": spec}), "")
    assert isinstance(client, port_mock.MockLLMClient) and client.delay_s == ref.delay_s == 0.25
    for ns in (REF, PORT):
        store = ns.K.Store()
        _make(ns, store, "Secret", "s", {"data": {"k": "v"}})
        ref_key = ns.R.SecretKeyRef
        assert ns.factory.resolve_secret_key(store, "default", None) == ""
        assert ns.factory.resolve_secret_key(store, "default", ref_key(name="s", key="k")) == "v"
        for name, key, msg in (("s", "x", 'key "x" not found in secret "s"'),
                               ("gone", "k", 'secret "gone" not found')):
            with pytest.raises(ns.K.Invalid, match=msg):
                ns.factory.resolve_secret_key(store, "default", ref_key(name=name, key=key))


@pytest.mark.parametrize("provider", ["openai", "mistral", "google", "vertex", "anthropic"])
async def test_factory_refuses_the_http_providers(provider):
    llm = PORT.R.LLM.model_validate({"metadata": {"name": "l"}, "spec": {
        "provider": provider, "vertex": {"cloudProject": "p", "cloudLocation": "l"}}})
    with pytest.raises(port_kernel.Invalid, match=f"provider {provider} is not ported yet"):
        await PORT.factory.DefaultLLMClientFactory().create_client(llm, "key")


async def test_settled_objects_are_not_rewritten_under_a_manager():
    """The port's controllers skip a status write that changes nothing: the
    write's own watch event would re-run the reconcile at once, so an Error
    LLM or a Pending/Ready Agent would rewrite its status in a loop (the
    reference does, ROADMAP C). Settled objects keep their resource
    versions while the Agent controller requeues every 50 ms."""
    K, store = PORT.K, PORT.K.Store()
    mgr = K.Manager(store)
    mgr.add_controller("llm", "LLM", PORT.LLMReconciler(
        store, mgr.recorder, PORT.factory.DefaultLLMClientFactory(), probe=False))
    mgr.add_controller("agent", "Agent", PORT.AgentReconciler(
        store, mgr.recorder, requeue_delay=0.05))
    await mgr.start()
    try:
        _make(PORT, store, "LLM", "ok", {"provider": "mock"})
        _make(PORT, store, "LLM", "bad", {"provider": "tpu"})
        _make(PORT, store, "Agent", "a", {"llmRef": {"name": "ok"}, "system": "s"})
        _make(PORT, store, "Agent", "b", {"llmRef": {"name": "bad"}, "system": "s"})
        want = {("LLM", "ok"): "Ready", ("LLM", "bad"): "Error",
                ("Agent", "a"): "Ready", ("Agent", "b"): "Pending"}
        await mgr.run_until(lambda: all(store.get(*k).status.status == v
                                        for k, v in want.items()), timeout=10)
        rvs = {k: store.get(*k).metadata.resource_version for k in want}
        await asyncio.sleep(0.3)
        assert {k: store.get(*k).metadata.resource_version for k in want} == rvs
        waiting = [e for e in mgr.recorder.events_for(store.get("Agent", "b"))
                   if e.spec.reason == "Waiting"]
        assert waiting and waiting[0].spec.count >= 3  # it did requeue meanwhile
    finally:
        await mgr.stop()
