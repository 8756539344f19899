"""The port's JSON-constrained decoding against the JAX package, on the CPU.

- The token table, its start state and ``min_close`` are bit-equal to the
  reference's on the byte tokenizer.
- ``ops/sampling.py``'s ``constrain_logits`` / ``advance_constraint`` equal
  the reference's functions of those names (taken from the source of
  ``Engine._build_jitted`` and jitted) exactly, on seeded numpy logits,
  states (some outside the table), budgets (some infeasible) and tokens
  (some past the table's width), with the reference's table padded to the
  vocabulary as its engine pads it.
- Greedy ``json_only``, forced-prefix and budget-limited streams through
  the port's paged engine are byte-identical to the JAX paged engine on the
  tiny f32 preset (vocab 512, so the width masking is exercised), and every
  constrained completion ``json.loads``.
- A batch with no constrained lane never calls ``constrain_logits``.
"""

import ast
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agentcontrolplane_tpu.engine import constrain as ref_constrain
from agentcontrolplane_tpu.engine.engine import Engine as JaxEngine
from agentcontrolplane_tpu.engine.engine import SamplingParams as JaxSampling
from agentcontrolplane_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from agentcontrolplane_tpu.models import llama as jl
from agentcontrolplane_tpu.parallel.mesh import make_mesh
from agentcontrolplane_tpu_torch.engine import constrain
from agentcontrolplane_tpu_torch.engine import engine as port_engine_mod
from agentcontrolplane_tpu_torch.engine.client import forced_call_prefix
from agentcontrolplane_tpu_torch.engine.engine import Engine, SamplingParams
from agentcontrolplane_tpu_torch.engine.tokenizer import ByteTokenizer
from agentcontrolplane_tpu_torch.engine.types import Tool, ToolFunction
from agentcontrolplane_tpu_torch.engine.weights import params_from_jax
from agentcontrolplane_tpu_torch.models import llama as tl
from agentcontrolplane_tpu_torch.ops import sampling

JCFG = dataclasses.replace(jl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
TCFG = dataclasses.replace(tl.PRESETS["tiny"], vocab_size=512, max_seq_len=256)
KW = dict(max_slots=4, max_ctx=64, prefill_buckets=(32, 64), decode_block_size=4, page_size=8)
EOT = 260  # ByteTokenizer's <|eot_id|>, a stop token
V = JCFG.vocab_size


@pytest.fixture(scope="module")
def tables():
    return ref_constrain.build_token_table(JaxByteTokenizer()), \
        constrain.build_token_table(ByteTokenizer())


def test_token_table_bit_equal_to_the_reference(tables):
    ref, port = tables
    assert port.token_trans.dtype == ref.token_trans.dtype == np.int16
    np.testing.assert_array_equal(port.token_trans, ref.token_trans)
    assert port.start_state == ref.start_state
    assert port.min_close.dtype == ref.min_close.dtype == np.int16
    np.testing.assert_array_equal(port.min_close, ref.min_close)
    assert port.token_trans.shape == (ref.token_trans.shape[0], ByteTokenizer().vocab_size)
    assert inspect.signature(constrain.build_token_table).parameters["max_depth"].default == 8


def _reference_mask_fns():
    """The reference's constrain_logits / advance_constraint, from the source
    of ``Engine._build_jitted`` (where they are closures), with its NEG."""
    tree = ast.parse(inspect.getsource(JaxEngine._build_jitted).strip())
    code = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in ("constrain_logits",
                                                                "advance_constraint"):
            code[node.name] = ast.unparse(node)
        if isinstance(node, ast.Assign) and [ast.unparse(t) for t in node.targets] == ["NEG"]:
            code["NEG"] = ast.unparse(node)
    assert set(code) == {"constrain_logits", "advance_constraint", "NEG"}
    ns = {"jnp": jnp}
    for src in code.values():
        exec(src, ns)  # noqa: S102 — the reference's own source
    return jax.jit(ns["constrain_logits"]), jax.jit(ns["advance_constraint"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_equal_the_reference(tables, seed):
    ref_table, table = tables
    ref_constrain_logits, ref_advance = _reference_mask_fns()
    n_states, T = table.token_trans.shape
    # the reference engine's padding of its table to the vocabulary
    padded = np.full((n_states, V), -1, np.int32)
    padded[:, :T] = ref_table.token_trans
    rng = np.random.default_rng(seed)
    S = 48
    logits = rng.standard_normal((S, V)).astype(np.float32) * 4
    states = rng.integers(0, n_states, S).astype(np.int32)
    states[:4] = [-1, n_states + 3, table.start_state, -7]  # clipped into the table
    done = [s for s in range(n_states) if table.min_close[s] == 0]
    states[4:6] = done[:2]
    constrained = rng.random(S) < 0.75
    budgets = rng.integers(0, 40, S).astype(np.int32)
    budgets[6:20] = rng.integers(0, 3, 14)  # tight: often infeasible
    # the cases the budget cannot close from: plain legality is kept there
    nxt = padded[np.clip(states, 0, n_states - 1)]
    closable = ref_table.min_close[np.clip(nxt, 0, n_states - 1)] <= budgets[:, None] - 1
    infeasible = ~((nxt >= 0) & closable).any(-1) & (nxt >= 0).any(-1) & constrained
    assert infeasible.sum() >= 2
    want = np.asarray(ref_constrain_logits(
        jnp.asarray(logits), jnp.asarray(padded), jnp.asarray(states), jnp.asarray(constrained),
        jnp.asarray(ref_table.min_close.astype(np.int32)), jnp.asarray(budgets)))
    dev_table = torch.from_numpy(table.token_trans)
    got = sampling.constrain_logits(
        torch.from_numpy(logits), dev_table, torch.from_numpy(states),
        torch.from_numpy(constrained), torch.from_numpy(table.min_close),
        torch.from_numpy(budgets)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[constrained][:, T:] == np.float32(-1e30)).all()
    np.testing.assert_array_equal(got[~constrained], logits[~constrained])
    # tokens: argmax of the masked logits, plus some outside the grammar and
    # past the table's width (where the reference's padding gives -1)
    toks = got.argmax(-1).astype(np.int32)
    toks[::5] = rng.integers(0, V, len(toks[::5]))
    toks[1] = V - 1
    want_states = np.asarray(ref_advance(jnp.asarray(padded), jnp.asarray(states),
                                         jnp.asarray(constrained), jnp.asarray(toks)))
    got_states = sampling.advance_constraint(dev_table, torch.from_numpy(states),
                                             torch.from_numpy(constrained),
                                             torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got_states, want_states)


def _weights() -> dict:
    """As tests/test_torch_engine.py: seeded weights whose stop token's
    lm_head column is a scaled copy of a frequently chosen token's."""
    p = jax.tree_util.tree_map(np.array, jl.init_params(JCFG, jax.random.key(0)))
    p["lm_head"][:, EOT] = p["lm_head"][:, 289] * 1.05
    return p


@pytest.fixture(scope="module")
def engines(tables):
    ref_table, port_table = tables
    weights = _weights()
    # each engine would build its table again: hand it the one built above
    # (the build is deterministic)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_constrain, "build_token_table", lambda tokenizer, max_depth=8: ref_table)
        mp.setattr(port_engine_mod, "build_token_table", lambda tokenizer, max_depth=8: port_table)
        jax_engine = JaxEngine(
            config=JCFG, params=jax.tree_util.tree_map(jax.numpy.asarray, weights),
            tokenizer=JaxByteTokenizer(), mesh=make_mesh({"tp": 1}, devices=jax.devices()[:1]),
            kv_layout="paged", prefix_cache_entries=0, **KW,
        )
        port = Engine(TCFG, params_from_jax(weights, TCFG, device="cpu"), device="cpu", **KW)
        jax_engine.start()
        port.start()
        yield jax_engine, port
        jax_engine.stop()
        port.stop()


def _envelope(name: str) -> tuple:
    tool = Tool(function=ToolFunction(name=name))
    return forced_call_prefix(ByteTokenizer(), [tool], name)


# (prompt, sampling): json_only from the start, a forced tool envelope with
# json_only, budgets too small for the model's choice (closed early), a
# forced prefix without the constraint, and unconstrained lanes beside them
BATCH = [
    ("json", dict(max_tokens=30, json_only=True)),
    ("cat", dict(max_tokens=10)),
    ("tool time", dict(max_tokens=24, json_only=True, forced_prefix=_envelope("get_weather"))),
    ("hello", dict(max_tokens=5, json_only=True)),
    ("w" * 50, dict(max_tokens=6, json_only=True, forced_prefix=_envelope("search"))),
    ("qq", dict(max_tokens=8, forced_prefix=tuple(b'{"a": '))),
    ("plan", dict(max_tokens=40, json_only=True)),
]


def test_constrained_streams_byte_identical_to_jax_engine(engines):
    jax_engine, port = engines
    jf = [jax_engine.submit(p, JaxSampling(**kw)) for p, kw in BATCH]
    tf = [port.submit(p, SamplingParams(**kw)) for p, kw in BATCH]
    ref = [f.result(timeout=300) for f in jf]
    ours = [f.result(timeout=300) for f in tf]
    for (prompt, kw), r, o in zip(BATCH, ref, ours):
        assert o.tokens == r.tokens, prompt
        assert o.text == r.text and o.finish_reason == r.finish_reason, prompt
        assert o.prompt_tokens == r.prompt_tokens, prompt
        prefix = kw.get("forced_prefix", ())
        assert tuple(o.tokens[: len(prefix)]) == tuple(prefix)
        assert len(o.tokens) - len(prefix) <= kw["max_tokens"]
        if kw.get("json_only"):
            doc = json.loads(o.text)
            if prefix:
                assert set(doc) == {"name", "arguments"}
    # the small budgets closed their objects inside max_tokens
    assert ours[3].finish_reason == "length" and ours[4].finish_reason == "length"
    assert port.stats()["constraint_table_bytes"] < 8 * 2**20
    assert port.stats()["active_slots"] == 0


def test_unconstrained_batches_never_call_constrain_logits(engines):
    _, port = engines
    before = sampling.CONSTRAIN_CALLS
    futs = [port.submit(p, SamplingParams(max_tokens=12)) for p in ("a", "bb", "ccc")]
    for f in futs:
        f.result(timeout=120)
    assert sampling.CONSTRAIN_CALLS == before
    port.generate("x", SamplingParams(max_tokens=9, json_only=True))
    assert sampling.CONSTRAIN_CALLS > before
