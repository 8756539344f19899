"""The port's object model and manifest reader against the JAX package's, on
the CPU.

- Every document of the six ``examples/*.yaml`` (loaded with ``yaml`` here,
  in the test) goes through both ``resource_from_manifest``s: the storage
  form (``model_dump()``, snake_case) and the manifest form
  (``model_dump(by_alias=True)``, camelCase) are equal, with the uid and
  the timestamp pinned, and so are ``resource_to_manifest``'s.
- The same JSON text through the reference's ``load_manifests`` (YAML) and
  the port's (JSON first, then its YAML subset) gives equal objects; the
  port's ``dump_manifests`` output (YAML) loads back in both.
- Bad kinds, names, Literals, bounds and types raise ``Invalid`` on both;
  messages are compared by their ``invalid {kind} manifest:`` prefix where
  the tail is pydantic's text.
- Lax-mode coercions (numeric strings, bool strings) give the same values.
"""

import json
from pathlib import Path

import pytest
import yaml

from agentcontrolplane_tpu.api import manifests as ref_manifests
from agentcontrolplane_tpu.api import resources as ref_resources
from agentcontrolplane_tpu.kernel.errors import Invalid as RefInvalid
from agentcontrolplane_tpu_torch.api import manifests, resources
from agentcontrolplane_tpu_torch.engine import types
from agentcontrolplane_tpu_torch.kernel.errors import Invalid
from agentcontrolplane_tpu_torch.schema import ValidationError, to_camel

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))
UID, TS = "0123456789abcdef0123456789abcdef", 1700000000.25


def _example_docs() -> list:
    out = []
    for path in EXAMPLES:
        for i, doc in enumerate(yaml.safe_load_all(path.read_text())):
            for j, d in enumerate(doc if isinstance(doc, list) else [doc] if doc else []):
                out.append(pytest.param(d, id=f"{path.stem}-{i}.{j}-{d.get('kind')}"))
    return out


DOCS = _example_docs()


def _pin(res):
    res.metadata.uid = UID
    res.metadata.creation_timestamp = TS
    return res


def test_the_examples_hold_every_kind_the_slice_runs():
    assert len(EXAMPLES) == 6
    kinds = {p.values[0]["kind"] for p in DOCS}
    assert {"LLM", "Agent", "Task", "MCPServer", "ContactChannel", "Secret"} <= kinds


@pytest.mark.parametrize("doc", DOCS)
def test_example_manifest_forms_match_the_reference(doc):
    ref = _pin(ref_manifests.resource_from_manifest(doc))
    ours = _pin(manifests.resource_from_manifest(doc))
    assert type(ours).__name__ == type(ref).__name__
    assert ours.model_dump() == ref.model_dump()
    assert ours.model_dump(by_alias=True) == ref.model_dump(by_alias=True)
    assert ours.model_dump(exclude_none=True) == ref.model_dump(exclude_none=True)
    assert manifests.resource_to_manifest(ours) == ref_manifests.resource_to_manifest(ref)
    # the storage document reads back to the same object in both packages
    doc_ours = json.loads(json.dumps(ours.model_dump()))
    assert json.loads(ref.model_dump_json()) == doc_ours
    assert resources.from_doc(doc_ours) == ours
    assert ref_resources.from_doc(doc_ours).model_dump() == ref.model_dump()


def test_json_text_loads_alike_in_both_packages():
    text = json.dumps([p.values[0] for p in DOCS], indent=1)
    ref = [_pin(r) for r in ref_manifests.load_manifests(text)]
    ours = [_pin(r) for r in manifests.load_manifests(text)]
    assert [r.model_dump() for r in ours] == [r.model_dump() for r in ref]
    # one object, and kubectl's {"items": [...]} list form
    one = json.dumps(DOCS[0].values[0])
    assert _pin(manifests.load_manifests(one)[0]).model_dump() == ref[0].model_dump()
    items = json.dumps({"items": [p.values[0] for p in DOCS[:3]]})
    assert [_pin(r).model_dump() for r in manifests.load_manifests(items)] == \
        [r.model_dump() for r in ref[:3]]
    assert manifests.load_manifests("null") == []
    # the port's dump is YAML, which the reference's reader also takes
    dumped = manifests.dump_manifests(ours)
    back = manifests.load_manifests(dumped)
    assert [r.model_dump() for r in back] == [r.model_dump() for r in ours]
    assert [r.model_dump() for r in ref_manifests.load_manifests(dumped)] == \
        [r.model_dump() for r in ours]
    # text that is not JSON is read as YAML: this one lacks its name
    with pytest.raises(Invalid, match="requires metadata.name"):
        manifests.load_manifests("kind: LLM\n")


def _llm(**spec):
    return {"kind": "LLM", "metadata": {"name": "m"}, "spec": {"provider": "tpu", **spec}}


BAD = {
    "not-a-mapping": ["kind", "LLM"],
    "no-kind": {"metadata": {"name": "x"}},
    "unknown-kind": {"kind": "Pod", "metadata": {"name": "x"}},
    "no-name": {"kind": "LLM", "metadata": {}, "spec": {"provider": "tpu"}},
    "empty-name": {"kind": "Agent", "metadata": {"name": ""}},
    "bad-provider": _llm(provider="bedrock"),
    "bad-quantization": _llm(tpu={"quantization": "int4"}),
    "bad-status-literal": {**_llm(), "status": {"status": "Maybe"}},
    "timeout-not-positive": _llm(tpu={"requestTimeoutSeconds": 0}),
    "negative-chunk": _llm(tpu={"prefillChunk": -1}),
    "azure-without-version": _llm(provider="openai", openai={"apiType": "AZURE"}),
    "vertex-without-location": _llm(provider="vertex", vertex={"cloudProject": "p"}),
    "agent-without-llm": {"kind": "Agent", "metadata": {"name": "a"}, "spec": {"system": "s"}},
    "bad-role": {"kind": "Task", "metadata": {"name": "t"}, "spec": {
        "agentRef": {"name": "a"}, "contextWindow": [{"role": "robot", "content": "x"}]}},
    "bad-transport": {"kind": "MCPServer", "metadata": {"name": "s"},
                      "spec": {"transport": "carrier-pigeon"}},
    "bad-channel-type": {"kind": "ContactChannel", "metadata": {"name": "c"},
                         "spec": {"type": "fax"}},
    "str-for-int": _llm(tpu={"maxSequences": "many"}),
    "fraction-for-int": _llm(tpu={"pageSize": 1.5}),
    "int-for-str": {"kind": "Agent", "metadata": {"name": "a"},
                    "spec": {"llmRef": {"name": "l"}, "system": 7}},
    "list-for-dict": {"kind": "Secret", "metadata": {"name": "s"}, "spec": {"data": ["k"]}},
    "bool-out-of-range": _llm(tpu={"quantizeKv": 2}),
    "bad-tool-type": {"kind": "ToolCall", "metadata": {"name": "tc"}, "spec": {
        "toolCallId": "c", "taskRef": {"name": "t"}, "toolRef": {"name": "x"},
        "toolType": "Shell"}},
}


@pytest.mark.parametrize("doc", BAD.values(), ids=BAD.keys())
def test_bad_manifests_raise_invalid_on_both(doc):
    with pytest.raises(RefInvalid) as ref:
        ref_manifests.resource_from_manifest(doc)
    with pytest.raises(Invalid) as ours:
        manifests.resource_from_manifest(doc)
    ref_msg, our_msg = str(ref.value), str(ours.value)
    if ref_msg.startswith("invalid "):  # the tail is the validator's own text
        prefix = ref_msg.split(":")[0] + ":"
        assert our_msg.startswith(prefix), (our_msg, ref_msg)
    else:
        assert our_msg == ref_msg


LAX = {
    "numeric-strings": _llm(tpu={"maxSequences": "8", "maxContext": 4096.0,
                                 "requestTimeoutSeconds": "2.5", "tensorParallelism": True}),
    "bool-strings": _llm(tpu={"quantizeWeights": "yes", "quantizeKv": 0,
                              "overlapToolCalls": "off", "hostPrefetch": 1.0}),
    "snake-and-camel": _llm(api_key_from={"name": "s", "key": "k"},
                            parameters={"max_tokens": "16", "topP": 0.5, "baseUrl": "u"}),
    "nested-status": {**_llm(), "status": {"ready": "true", "status": "Ready",
                                           "statusDetail": "ok"}},
    "extra-keys-ignored": {**_llm(tpu={"preset": "tiny", "notAField": 1}),
                           "apiVersion": "acp.tpu/v1alpha1"},
    "tuple-list": {"kind": "MCPServer", "metadata": {"name": "s", "labels": {"a": "b"}},
                   "spec": {"transport": "stdio", "command": "c", "args": ("x", "y")}},
}


@pytest.mark.parametrize("doc", LAX.values(), ids=LAX.keys())
def test_lax_coercion_matches_the_reference(doc):
    ref = _pin(ref_manifests.resource_from_manifest(doc))
    ours = _pin(manifests.resource_from_manifest(doc))
    assert ours.model_dump() == ref.model_dump()


def test_message_types_are_shared_and_validate():
    # one type per concept: the object model re-exports the engine's types
    assert resources.Message is types.Message
    assert resources.BaseConfig is types.BaseConfig
    assert [f for f in resources.BaseConfig.__dataclass_fields__] == \
        list(ref_resources.BaseConfig.model_fields)
    msg = {"role": "assistant", "content": "", "toolCallId": None, "toolCalls": [
        {"id": "c0", "function": {"name": "f", "arguments": "{}"}}]}
    assert types.Message.model_validate(msg).model_dump(by_alias=True) == \
        ref_resources.Message.model_validate(msg).model_dump(by_alias=True)
    with pytest.raises(ValidationError):
        types.Message(role="robot")
    with pytest.raises(ValueError):
        types.Message(role="user", content=3)
    deep = resources.LLM.model_validate(_llm(tpu={"preset": "tiny"}))
    copy = deep.model_copy(deep=True)
    copy.spec.tpu.preset = "other"
    assert deep.spec.tpu.preset == "tiny"


@pytest.mark.parametrize("name", ["api_key_from", "top_p", "base_url", "quantize_kv",
                                  "v1beta3_flag", "x", "already_camelCase", "a_1b", "_private"])
def test_to_camel_is_pydantics(name):
    from pydantic.alias_generators import to_camel as ref_to_camel

    assert to_camel(name) == ref_to_camel(name)
