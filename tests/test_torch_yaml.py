"""The port's YAML subset (``api/yamlsubset.py``) against PyYAML, on the
CPU (the card's machine has no YAML library; the CPU tests have PyYAML).

- ``load_all`` equals ``yaml.safe_load_all`` on every ``examples/*.yaml``
  and on crafted streams that reach each construct of the subset: document
  markers, comments, block and flow collections, the three scalar styles,
  ``|`` block scalars and their chomping, YAML 1.1's resolution of plain
  scalars. Equality is exact: types, key order, NaN where NaN.
- Every construct outside the subset raises ``Invalid`` naming its line
  (anchors, tags, directives, ``?`` keys, folded and multi-line scalars,
  tabs, the int/float/timestamp forms it does not build, ...), where
  PyYAML would read a value or fail.
- ``yaml.safe_load_all(dump_all(docs)) == docs`` and ``load_all`` reads the
  same text back equal, for every example and for crafted documents.
- Every example manifest loads and applies to the port's store, created
  then configured, with status preserved (the reference's
  ``test_apply_create_then_configure`` and
  ``test_every_example_manifest_applies``), equal to the reference's
  objects.
"""

import math
from pathlib import Path

import pytest
import yaml

from agentcontrolplane_tpu.api import manifests as ref_manifests
from agentcontrolplane_tpu_torch.api import manifests
from agentcontrolplane_tpu_torch.api.yamlsubset import dump_all, load_all
from agentcontrolplane_tpu_torch.kernel import Invalid, Store

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*.yaml"))


def same(a, b) -> bool:
    """Exact equality, types and key order included (NaN equals NaN)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


SUPPORTED = [
    "", "---\n", "a: 1\n---\n", "# only a comment\n", "# c\n---\na: 1\n",
    "a: 1\n...\n---\nb: 2\n", "--- # a comment on the marker\na: 1\n", "\ufeffa: 1\n",
    "a: 1\r\nb: two\r\n",
    "a:\n- 1\n- 2\nb: x\n", "- a\n- b: 1\n  c: 2\n- - x\n  - y\n",
    "outer:\n  inner:\n    - name: a\n      v: 1\n    - name: b\n  k: v\n",
    "a:\n  - b\n  -\n  - c\n", "key with spaces: value with spaces\n",
    "k: 'it''s'\nd: \"a\\tb\\u00e9\\n\\x41\\U0001F600\\\\ \\\" \\/\"\n",
    "x: yes\ny: No\nz: ~\nw: null\nv:\nu: ON\nt: off\n",
    "n: -12\np: +3\nz: 0\nf: 1.5\ng: .5\nh: -.inf\ni: .nan\nj: 1.\nk: 1e5\nl: 1.0e+3\n",
    "args: [\"a\", b, 'c', 1, [x, y], {p: q}]\nm: {a: 1, b: [2], \"c\": x}\n",
    "e: []\nf: {}\ng: [ ]\nh: {x: }\ni: [a b, c d]\n",
    "s: |\n  line1\n   indented\n\n  line3\nt: end\n",
    "s: |-\n  a\n  b\n\n\nt: 1\n", "s: |+\n  a\n\n\nt: 1\n", "s: |\n\nt: 1\n",
    "s: |  # a comment on the header\n  x\n", "- |\n  text\n- x\n",
    "a: b # comment\nc: 'd' # c\ne: \"f\"  # c\ng: h#i\n",
    "url: http://x.y/z?a=b\nlabel: acp.tpu/agent=x\nz: '0755'\n",
    "\"quoted key\": 1\n'single': 2\n3: int key\ntrue: bool key\n",
    "a: -x\nb: :x\nc: ?x\nd: a]b\n", "a: 1\n\n\n# trailing\n", "empty:\n# c\nnext: 1\n",
    "l:\n- a # c\n- 'b'\n", "top\n", "- 1\n- 2.5\n", "a:   spaced   \n",
    "a: \"x: y\"\nb: 'p # q'\nc: x:y\n", "a: 1\nb:\n  c: 2\n  d:\n    - e\nf: 3\n",
]

UNSUPPORTED = [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "%YAML 1.1\n---\na: 1\n", "? a\n: b\n",
    "a: >\n  folded\n", "a: plain\n  continued\n", "a: \"multi\n  line\"\n",
    "a: 0x1F\n", "a: 0755\n", "a: 1_000\n", "a: 2024-01-01\n", "a: 1:30\n",
    "<<: {a: 1}\n", "a: [1, 2\n", "\ta: 1\n", "a: b: c\n", "a: 'x' y\n", "a: =\n",
    "a:\n\t- 1\n", "- a\nb: 1\n", "a: |2\n  x\n", "--- a\n", "a: [b: c]\n",
    "a: \"\\q\"\n", "a: 1\n...\nb: 2\n", "a: @x\n", "a: `x`\n", "[a]: 1\n",
]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_load_as_pyyaml_loads_them(path):
    text = path.read_text()
    assert same(load_all(text), list(yaml.safe_load_all(text)))


@pytest.mark.parametrize("text", SUPPORTED)
def test_supported_yaml_loads_as_pyyaml_loads_it(text):
    assert same(load_all(text), list(yaml.safe_load_all(text)))


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_unsupported_yaml_raises_naming_its_line(text):
    with pytest.raises(Invalid, match=r"^line \d+: "):
        load_all(text)


DOCS = [
    {"a": 1, "b": [1, 2.5, None, True, False, "x y", "", "yes", "null", "1.0", "0755",
                   "multi\nline\ttab", "é \u2028 \U0001F600 \x00 \x85 \ufeff", {"k": []}, [],
                   {}, "- dash", "a: b", "#hash", "trailing ", " leading", "it's", 'q"uote'],
     "c": {"d": {"e": "f"}}, "f": 1e-05, "g": 1e20, "h": -0.0, "i": float("inf"),
     "j": float("-inf"), "k": float("nan"), 3: "int key", None: "null key",
     "l": [[1, [2]], {"x": [3]}], "acp.tpu/agent": "a-b_c.d/e", "m": 10**20},
    None, "scalar", 42, [], {}, [{"name": "a", "sub": [{"x": 1}]}, [[]]],
]


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_dump_loads_back_equal(i):
    text = dump_all([DOCS[i]])
    assert same(list(yaml.safe_load_all(text)), [DOCS[i]])
    assert same(load_all(text), [DOCS[i]])


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_dump_of_every_example_loads_back_equal(path):
    docs = list(yaml.safe_load_all(path.read_text()))
    text = dump_all(docs)
    assert same(list(yaml.safe_load_all(text)), docs)
    assert same(load_all(text), docs)
    # and the port's manifest writer round-trips the objects
    resources = manifests.load_manifests(path.read_text())
    again = manifests.load_manifests(manifests.dump_manifests(resources))
    assert [r.model_dump() for r in again] == [r.model_dump() for r in resources]


def _pinned(resources):
    for r in resources:
        r.metadata.uid, r.metadata.creation_timestamp = "u", 0.0
    return [r.model_dump() for r in resources]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_every_example_manifest_applies(path):
    text = path.read_text()
    resources = manifests.load_manifests(text)
    assert resources and _pinned(resources) == _pinned(ref_manifests.load_manifests(text))
    store = Store()
    results = manifests.apply_resources(store, resources)
    assert [a for a, _ in results] == ["created"] * len(resources)
    results = manifests.apply_resources(store, manifests.load_manifests(text))
    assert [a for a, _ in results] == ["configured"] * len(resources)


def test_apply_create_then_configure_keeps_status():
    text = (ROOT / "examples" / "getting-started.yaml").read_text()
    store = Store()
    assert [a for a, _ in manifests.apply_resources(
        store, manifests.load_manifests(text))] == ["created"] * 4
    llm = store.get("LLM", "gpt-4o")
    llm.status.ready, llm.status.status = True, "Ready"
    store.update_status(llm)
    text = text.replace("model: gpt-4o", "model: gpt-4o-mini")
    assert [a for a, _ in manifests.apply_resources(
        store, manifests.load_manifests(text))] == ["configured"] * 4
    llm = store.get("LLM", "gpt-4o")
    assert llm.spec.parameters.model == "gpt-4o-mini" and llm.status.ready


def test_manifest_errors_name_the_line_or_the_kind():
    with pytest.raises(Invalid, match="line 2"):
        manifests.load_manifests("kind: LLM\nmetadata: &m {name: x}\n")
    with pytest.raises(Invalid, match="unknown kind 'Nope'"):
        manifests.load_manifests("kind: Nope\nmetadata: {name: x}")
    with pytest.raises(Invalid, match="requires metadata.name"):
        manifests.load_manifests("---\nkind: Task\nmetadata: {}\n")
    assert manifests.load_manifests("---\n# nothing\n---\n") == []
