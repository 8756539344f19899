"""Llama model family in PyTorch — the port of
``agentcontrolplane_tpu/models/llama.py`` for the paged and the slot serving
paths.

Layout fidelity with the reference, so the tests compare like with like:
params are a plain dict with **stacked layer weights** (leading dim =
n_layers) in the ``x @ W`` orientation, the paged pools are
``[L, num_pages, P, H_kv, d]``, the slot cache is ``[L, S, C, H_kv, d]``,
and the public programs keep the reference's names and argument order.
Differences that are PyTorch idiom:

- the layer ``lax.scan`` is a Python loop over views of the stacked weights;
- JAX's functional ``.at[].set`` page commits become in-place
  ``index_put_`` on the page pool (no pool-sized copy per step); the
  programs mutate ``pages`` and return the same dict.

int8 serving rides the reference's seams: layer matrices may be
``ops.quant.QuantizedTensor`` (every matmul of the block goes through
``quant.matmul``), and a quantized cache is the same dict with int8
``"k"``/``"v"`` plus f32 scale twins ``"ks"``/``"vs"`` — every commit goes
through :func:`_kv_commit` (quantize on commit, the same index for values
and scales) and decode attention reads the scales beside the pages.

The decode write discipline is the reference's: pages are read-only inside
the layer loop, the new token attends through a self term, one commit
follows the loop, and inactive lanes write to ``TRASH_PAGE``. Decode
attention goes through ``ops.cuda.paged_attention`` — the hand-written
kernel on CUDA tensors, its plain version on CPU tensors.

The slot layout (the reference CLI's default) keeps one contiguous row of
``C = max_ctx`` positions per slot. Its attention is plain torch on every
device, as the reference leaves it to XLA: decode reads each slot's whole
row masked at ``seq_len`` (``ops.attention.decode_attention_cache_plus_new``),
and a write that must go nowhere lands on row ``C - 1``, which attention
never reads (a lane stops before its ``seq_len`` reaches ``C - 1``).

Parallel serving (the reference's mesh-aware programs): every program takes
an optional ``group`` (``parallel.mesh.ServingGroup``) and then runs on the
rank's slices — H/tp query and H_kv/tp KV heads, the rank's ffn columns and
vocab slice, and a pool holding rows ``[sp_rank * P/sp, (sp_rank + 1) *
P/sp)`` of every page. The tp group sums the partial products after ``wo``
and ``w2``, the masked local embedding lookup, and the vocab slices of the
logits (placed into a zero ``[.., V]`` buffer, so the sum is exact); decode
attention runs the sharded wrappers, which merge the sp ranks' states.
Activations are replicated across sp ranks, so prefill needs no sp
collective (it attends only to the prompt's own keys) and each sp rank
commits its rows of each page. Without a group every program is the
single-card path unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import (
    NEG_INF,
    blocked_causal_attention,
    causal_attention,
    continue_state,
    decode_attention_cache_plus_new,
    online_softmax_finalize,
)
from ..ops.cuda.paged_attention import (
    paged_decode_attention_cache_plus_new,
    paged_decode_attention_cache_plus_new_sharded,
)
from ..ops.norms import rms_norm
from ..ops.paged import TRASH_PAGE, init_kv_pages, merge_sp_states, token_write_targets
from ..ops import quant
from ..ops.quant import QuantizedTensor, kv_dequantize, kv_quantize
from ..ops.quant import matmul as mm
from ..ops.rope import apply_rope
from ..parallel.mesh import ServingGroup, local_heads, param_slice, vocab_range


@dataclass(frozen=True)
class LlamaConfig:
    """The reference's config, field for field, with ``dtype`` a
    ``torch.dtype``. The port serves the Llama block (silu MLP, RMSNorm,
    GQA, llama3 RoPE scaling); the other families' switches are kept so
    presets copy over, and :func:`check_supported` refuses them."""

    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_seq: int = 8192
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    qkv_bias: bool = False
    hidden_act: str = "silu"
    norm_plus_one: bool = False
    embed_scale: bool = False
    head_dim_override: Optional[int] = None
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norms: bool = False
    query_pre_attn_scalar: float = 0.0
    sliding_window: int = 0
    n_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 2.0
    moe_group_size: int = 512
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads


# Copied from the reference. llama3-8b matches meta-llama/Meta-Llama-3-8B.
PRESETS: dict[str, LlamaConfig] = {
    "llama3-8b": LlamaConfig(),
    "llama3.1-8b": LlamaConfig(
        rope_scaling_factor=8.0, rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
        rope_original_max_seq=8192, max_seq_len=131072,
    ),
    "llama3.2-1b": LlamaConfig(
        vocab_size=128256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        ffn_dim=8192, rope_theta=500000.0, tie_embeddings=True,
        rope_scaling_factor=32.0, rope_original_max_seq=8192, max_seq_len=131072,
    ),
    "llama3.2-3b": LlamaConfig(
        vocab_size=128256, dim=3072, n_layers=28, n_heads=24, n_kv_heads=8,
        ffn_dim=8192, tie_embeddings=True, rope_scaling_factor=32.0,
        rope_original_max_seq=8192, max_seq_len=131072,
    ),
    "bench-1b": LlamaConfig(
        vocab_size=32768, dim=2048, n_layers=16, n_heads=16, n_kv_heads=8, ffn_dim=8192,
    ),
    "mistral-7b": LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, rope_theta=10000.0, max_seq_len=8192,
    ),
    "qwen2.5-7b": LlamaConfig(
        vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
        ffn_dim=18944, rope_theta=1000000.0, qkv_bias=True,
    ),
    "qwen2.5-0.5b": LlamaConfig(
        vocab_size=151936, dim=896, n_layers=24, n_heads=14, n_kv_heads=2,
        ffn_dim=4864, rope_theta=1000000.0, qkv_bias=True, tie_embeddings=True,
    ),
    "gemma-2b": LlamaConfig(
        vocab_size=256000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        ffn_dim=16384, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        head_dim_override=256,
    ),
    "gemma-7b": LlamaConfig(
        vocab_size=256000, dim=3072, n_layers=28, n_heads=16, n_kv_heads=16,
        ffn_dim=24576, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        head_dim_override=256,
    ),
    "gemma2-2b": LlamaConfig(
        vocab_size=256000, dim=2304, n_layers=26, n_heads=8, n_kv_heads=4,
        ffn_dim=9216, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        head_dim_override=256, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norms=True, query_pre_attn_scalar=256.0, sliding_window=4096,
    ),
    "gemma2-9b": LlamaConfig(
        vocab_size=256000, dim=3584, n_layers=42, n_heads=16, n_kv_heads=8,
        ffn_dim=14336, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        head_dim_override=256, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norms=True, query_pre_attn_scalar=256.0, sliding_window=4096,
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, rope_theta=1000000.0, max_seq_len=32768,
        n_experts=8, experts_per_token=2,
    ),
    "moe-tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        max_seq_len=128, rope_theta=10000.0, n_experts=4, experts_per_token=2,
        expert_capacity_factor=8.0, dtype=torch.float32,
    ),
    "tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        max_seq_len=128, rope_theta=10000.0, dtype=torch.float32,
    ),
}


def check_supported(config: LlamaConfig) -> None:
    """Refuse configurations whose features the port does not have yet
    (Qwen2 biases, the Gemma families, MoE) instead of silently computing
    a different function."""
    unported = [
        name for name, on in (
            ("qkv_bias", config.qkv_bias),
            ("hidden_act", config.hidden_act != "silu"),
            ("norm_plus_one", config.norm_plus_one),
            ("embed_scale", config.embed_scale),
            ("attn_logit_softcap", config.attn_logit_softcap),
            ("final_logit_softcap", config.final_logit_softcap),
            ("post_norms", config.post_norms),
            ("query_pre_attn_scalar", config.query_pre_attn_scalar),
            ("sliding_window", config.sliding_window),
            ("n_experts", config.n_experts),
        ) if on
    ]
    if unported:
        raise NotImplementedError(
            f"the torch port serves the Llama block only; not yet ported: {unported}"
        )


def init_params(
    config: LlamaConfig, generator: torch.Generator, device=None, quantize: Optional[str] = None,
    group: Optional[ServingGroup] = None,
) -> dict:
    """Random init made on ``device`` from ``generator`` (serving with
    random weights); layout and scales mirror the reference's init. Every
    leaf is drawn in one seeded order, each stacked matrix one layer at a
    time, directly in the model dtype, and only this rank's slice of each
    draw is kept (``group``; the whole draw without one). So every rank of
    a tp group holds its part of the SAME model a single card draws from
    the same seed, and no rank ever holds the whole model: the peak is the
    kept slices plus one drawn layer matrix (or the vocabulary matrix, 1.05
    GB for llama3-8b). With ``quantize="int8"`` each drawn layer matrix is
    quantized whole (per output channel) before it is sliced — the values
    of quantizing the full bf16 model."""
    check_supported(config)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantize!r}")
    c = config
    d, hd = c.dim, c.head_dim
    device = device if device is not None else generator.device

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device, dtype=c.dtype)
        return t.mul_(scale)

    def top(name, shape, scale):
        return param_slice(name, normal(shape, scale), group, layer=False).clone(
            memory_format=torch.contiguous_format)

    def matrix(name, shape, scale):
        out = None
        for i in range(L):
            w = normal(shape, scale)
            if quantize is not None:
                w = quant.quantize(w)
            w = param_slice(name, w, group, layer=True)
            if out is None:
                if isinstance(w, QuantizedTensor):
                    out = QuantizedTensor(
                        q=torch.empty((L, *w.q.shape), dtype=torch.int8, device=device),
                        scale=torch.empty((L, *w.scale.shape), dtype=torch.float32,
                                          device=device),
                    )
                else:
                    out = torch.empty((L, *w.shape), dtype=c.dtype, device=device)
            if isinstance(w, QuantizedTensor):
                out.q[i], out.scale[i] = w.q, w.scale
            else:
                out[i] = w
        return out

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    L = c.n_layers
    scale = d**-0.5
    params = {
        "embed": top("embed", (c.vocab_size, d), scale),
        "layers": {
            "ln1": ones((L, d)),
            "ln2": ones((L, d)),
            "wq": matrix("wq", (d, c.n_heads * hd), scale),
            "wk": matrix("wk", (d, c.n_kv_heads * hd), scale),
            "wv": matrix("wv", (d, c.n_kv_heads * hd), scale),
            "wo": matrix("wo", (c.n_heads * hd, d), scale),
            "w1": matrix("w1", (d, c.ffn_dim), scale),  # gate_proj
            "w3": matrix("w3", (d, c.ffn_dim), scale),  # up_proj
            "w2": matrix("w2", (c.ffn_dim, d), c.ffn_dim**-0.5),  # down_proj
        },
        "norm": ones((d,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = top("lm_head", (d, c.vocab_size), scale)
    return params


def _layer(params: dict, i: int) -> dict:
    """One layer's weights as views of the stacked tensors (a
    ``QuantizedTensor`` indexes its values and scales together)."""
    return {name: w[i] for name, w in params["layers"].items()}


def _rope_scaling(c: LlamaConfig):
    if c.rope_scaling_factor == 1.0:
        return None
    return (
        c.rope_scaling_factor, c.rope_low_freq_factor,
        c.rope_high_freq_factor, c.rope_original_max_seq,
    )


def _tp_sum(group: Optional[ServingGroup], t: torch.Tensor) -> torch.Tensor:
    return t if group is None else group.tp_sum(t)


def _embed(params: dict, tokens: torch.Tensor, c: LlamaConfig,
           group: Optional[ServingGroup] = None) -> torch.Tensor:
    """Embedding rows; over tp each rank looks up the tokens in its vocab
    slice (zeros elsewhere) and the tp sum assembles them exactly."""
    if group is None or group.tp == 1:
        return params["embed"][tokens.long()].to(c.dtype)
    lo, hi = vocab_range(c, group)
    local = tokens.long() - lo
    inside = (local >= 0) & (local < hi - lo)
    x = params["embed"][local.clamp(0, hi - lo - 1)].to(c.dtype)
    return group.tp_sum(torch.where(inside[..., None], x, x.new_zeros(())))


def _final_norm_w(params: dict, c: LlamaConfig) -> torch.Tensor:
    return params["norm"]


def _head_logits(x: torch.Tensor, params: dict, c: LlamaConfig,
                 group: Optional[ServingGroup] = None) -> torch.Tensor:
    """lm_head projection -> float32 logits; over tp each rank computes its
    vocab columns into a zero [.., V] buffer and the tp sum gives every rank
    the full logits, exactly."""
    head = params["embed"].T if c.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(c.dtype)).float()
    if group is None or group.tp == 1:
        return logits
    lo, hi = vocab_range(c, group)
    full = logits.new_zeros((*logits.shape[:-1], c.vocab_size))
    full[..., lo:hi] = logits
    return group.tp_sum(full)


def _attn_mlp(
    x: torch.Tensor,  # [B, T, D]
    layer: dict,  # one layer's weights (this rank's slices)
    config: LlamaConfig,
    positions: torch.Tensor,  # [B, T]
    attn_fn,
    group: Optional[ServingGroup] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared block body: returns (output, k, v) where k/v are this layer's
    new key/value tensors (for the commit) over this rank's heads. The
    seven matmuls go through ``quant.matmul``: ``x @ W`` for dense weights,
    ``(x @ q) * scale`` for int8 ones. Over tp the row-sliced ``wo`` and
    ``w2`` products are partial sums, summed over the tp group."""
    c = config
    B, T, D = x.shape
    H, H_kv = local_heads(c, group)
    h = rms_norm(x, layer["ln1"], c.norm_eps)
    q = mm(h, layer["wq"]).reshape(B, T, H, c.head_dim)
    k = mm(h, layer["wk"]).reshape(B, T, H_kv, c.head_dim)
    v = mm(h, layer["wv"]).reshape(B, T, H_kv, c.head_dim)
    scaling = _rope_scaling(c)
    q = apply_rope(q, positions, c.rope_theta, scaling=scaling)
    k = apply_rope(k, positions, c.rope_theta, scaling=scaling)
    attn = attn_fn(q, k, v)
    x = x + _tp_sum(group, mm(attn.reshape(B, T, H * c.head_dim), layer["wo"]))
    h = rms_norm(x, layer["ln2"], c.norm_eps)
    y = mm(F.silu(mm(h, layer["w1"])) * mm(h, layer["w3"]), layer["w2"])
    return x + _tp_sum(group, y), k, v


def forward(
    params: dict,
    tokens: torch.Tensor,  # [B, T] int
    config: LlamaConfig,
    positions: Optional[torch.Tensor] = None,  # [B, T]; default arange
    group: Optional[ServingGroup] = None,
) -> torch.Tensor:
    """Full-sequence causal forward -> logits [B, T, V] (float32)."""
    c = config
    check_supported(c)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = _embed(params, tokens, c, group)
    for i in range(c.n_layers):
        x, _, _ = _attn_mlp(
            x, _layer(params, i), c, positions,
            lambda q, k, v: causal_attention(q, k, v, positions), group,
        )
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    return _head_logits(x, params, c, group)


# ---------------------------------------------------------------------------
# Serving: KV quantization seam
# ---------------------------------------------------------------------------


def _kv_commit(pages: dict, new_k: torch.Tensor, new_v: torch.Tensor, setter) -> dict:
    """Commit fresh K/V through ``setter(array, values)`` — the SAME
    in-place index applied to the value pools ([..., H_kv, d]) and, for a
    quantized cache, to the scale twins ([..., H_kv]); quantization happens
    here, once per program, on the already-stacked commit."""
    if "ks" in pages:
        qk, sk = kv_quantize(new_k)
        qv, sv = kv_quantize(new_v)
        for name, val in (("k", qk), ("v", qv), ("ks", sk), ("vs", sv)):
            setter(pages[name], val)
    else:
        for name, val in (("k", new_k), ("v", new_v)):
            setter(pages[name], val.to(pages[name].dtype))
    return pages


def _kv_rows(pool: torch.Tensor, scales: Optional[torch.Tensor], idx,
             dtype: torch.dtype) -> torch.Tensor:
    """Gather one layer's rows by ``idx`` (a block table of pages, a slot
    index or a slice of slots) and dequantize int8 rows with their scale
    twins AFTER the gather, so only the gathered rows ever exist in
    float."""
    if scales is not None:
        return kv_dequantize(pool[idx], scales[idx], dtype)
    return pool[idx].to(dtype)


# ---------------------------------------------------------------------------
# Serving: slot KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(
    config: LlamaConfig, max_slots: int, max_ctx: int, device="cuda", quantize_kv: bool = False,
) -> dict:
    """``[L, S, C, H_kv, d]`` per k/v in the model dtype — or int8 plus
    ``[L, S, C, H_kv]`` f32 scale rows with ``quantize_kv``."""
    return init_kv_pages(
        config.n_layers, max_slots, max_ctx, config.n_kv_heads, config.head_dim,
        config.dtype, device=device, quantize=quantize_kv,
    )


def prefill_batch(
    params: dict,
    cache: dict,  # {"k": [L, S, C, H_kv, d], "v": ...} — updated in place
    tokens: torch.Tensor,  # [B, T] int (each row padded)
    lengths: torch.Tensor,  # [B] int — true prompt lengths
    slots: torch.Tensor,  # [B] int — distinct target slots
    config: LlamaConfig,
) -> tuple[dict, torch.Tensor]:
    """B prompts through the model in one pass; one commit writes every
    layer's K/V at rows ``[0, T)`` of each row's slot (the padded tail is
    garbage that decode never reads: it masks by seq_len). Returns (cache,
    last-token logits [B, V])."""
    c = config
    check_supported(c)
    B, T = tokens.shape
    ar = torch.arange(T, device=tokens.device)
    lengths = lengths.long()
    positions = torch.where(ar[None, :] < lengths[:, None], ar[None, :], -1)
    x = _embed(params, tokens, c)
    new_k, new_v = [], []
    for i in range(c.n_layers):
        x, k, v = _attn_mlp(
            x, _layer(params, i), c, positions,
            lambda q, k, v: blocked_causal_attention(q, k, v, positions),
        )
        new_k.append(k)
        new_v.append(v)
    idx = slots.long()

    def setter(arr, val):
        arr[:, idx, :T] = val

    _kv_commit(cache, torch.stack(new_k), torch.stack(new_v), setter)
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    last = x[torch.arange(B, device=x.device), lengths - 1]
    return cache, _head_logits(last, params, c)


def prefill(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # [T] int (padded)
    length: torch.Tensor,  # scalar int — true prompt length
    slot: torch.Tensor,  # scalar int
    config: LlamaConfig,
) -> tuple[dict, torch.Tensor]:
    """Single-prompt prefill (the B=1 view of :func:`prefill_batch`)."""
    cache, logits = prefill_batch(params, cache, tokens[None], length.reshape(1),
                                  slot.reshape(1), config)
    return cache, logits[0]


def _continue_forward(
    params: dict,
    cache: dict,  # read only here; the callers commit
    tokens: torch.Tensor,  # [B, T] int — SUFFIX tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true suffix lengths (0 = a padding lane)
    starts: torch.Tensor,  # [B] int — absolute position of each suffix start
    slots: torch.Tensor,  # [B] int
    config: LlamaConfig,
    prefix_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot continuation's body: rows ``[0, start)`` of each slot are
    written; only the suffix runs through the model, attending over those
    rows and then causally over itself, one online softmax over both.
    Returns ``(new_k [L, B, T, H_kv, d], new_v, x_normed [B, T, D],
    write_pos [B, T])``, uncommitted. ``write_pos`` is clamped to row
    ``C - 1``, so bucket padding and a padding lane (start ``max_ctx``)
    never write past the row: their garbage lands where attention never
    reads.

    The keys walked are the slot rows below the live lanes' largest start
    (the rest are masked for every query, so leaving them out changes no
    value), read in the model dtype as the reference reads them. A caller
    holding the lanes on the host passes that start as ``prefix_rows``;
    without it the start is read back from the device."""
    c = config
    B, T = tokens.shape
    dev = tokens.device
    ar = torch.arange(T, device=dev)
    lengths, starts = lengths.long(), starts.long()
    positions = torch.where(ar[None, :] < lengths[:, None], starts[:, None] + ar[None, :], -1)
    x = _embed(params, tokens, c)
    C = cache["k"].shape[2]
    write_pos = torch.clamp_max(starts[:, None] + ar[None, :], C - 1)
    if prefix_rows is None:
        prefix_rows = int(torch.where(lengths > 0, starts, 0).max())
    rows = min(C, prefix_rows)
    row_pos = torch.arange(rows, device=dev)
    cache_pos = torch.where(row_pos[None, :] < starts[:, None], row_pos[None, :], -1)
    idx = slots.long()
    quantized = "ks" in cache
    new_k, new_v = [], []
    for i in range(c.n_layers):
        k_rows, v_rows = cache["k"][i, :, :rows], cache["v"][i, :, :rows]
        k_sc, v_sc = ((cache["ks"][i, :, :rows], cache["vs"][i, :, :rows]) if quantized
                      else (None, None))

        def attn(q, k, v):
            state = continue_state(q, _kv_rows(k_rows, k_sc, idx, k.dtype),
                                   _kv_rows(v_rows, v_sc, idx, v.dtype), positions, cache_pos)
            _m, l, acc = continue_state(q, k, v, positions, positions, state=state)
            return online_softmax_finalize(l, acc, q.dtype)

        x, k, v = _attn_mlp(x, _layer(params, i), c, positions, attn)
        new_k.append(k)
        new_v.append(v)
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    return torch.stack(new_k), torch.stack(new_v), x, write_pos


def _commit_slot_rows(cache: dict, new_k: torch.Tensor, new_v: torch.Tensor,
                      slots: torch.Tensor, write_pos: torch.Tensor) -> dict:
    """One commit of a continuation's K/V ``[L, B, T, ...]`` at rows
    ``write_pos [B, T]`` of each row's slot, every layer at once."""
    idx = slots.long()[:, None]

    def setter(arr, val):
        arr[:, idx, write_pos] = val

    return _kv_commit(cache, new_k, new_v, setter)


def prefill_continue(
    params: dict,
    cache: dict,  # updated in place (each slot's suffix rows)
    tokens: torch.Tensor,  # [B, T] int — SUFFIX tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true suffix lengths
    starts: torch.Tensor,  # [B] int — absolute position of each suffix start
    slots: torch.Tensor,  # [B] int
    config: LlamaConfig,
    prefix_rows: Optional[int] = None,  # the live lanes' largest start, if known on the host
) -> tuple[dict, torch.Tensor]:
    """The slot continuation (a prefix-cache hit copied into the slot, an
    adopted parked slot, a resumed preemption, a chunk): the first
    ``starts[b]`` rows of each slot are already written; only the suffix
    runs, at O(suffix) cost. Returns (cache, last-token logits [B, V])."""
    check_supported(config)
    B = tokens.shape[0]
    new_k, new_v, x, write_pos = _continue_forward(params, cache, tokens, lengths, starts,
                                                   slots, config, prefix_rows)
    _commit_slot_rows(cache, new_k, new_v, slots, write_pos)
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return cache, _head_logits(last, params, config)


def prefill_continue_kv(
    params: dict,
    cache: dict,  # updated in place (each slot's chunk rows)
    tokens: torch.Tensor,  # [B, T] int — chunk tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true chunk lengths (0 = a padding lane)
    starts: torch.Tensor,  # [B] int — absolute chunk start (max_ctx for a padding lane)
    slots: torch.Tensor,  # [B] int
    config: LlamaConfig,
    prefix_rows: Optional[int] = None,  # the live lanes' largest start, if known on the host
) -> dict:
    """A mid chunk's KV-only continuation: :func:`prefill_continue`'s
    writes without the lm_head, so nothing is sampled."""
    check_supported(config)
    new_k, new_v, _x, write_pos = _continue_forward(params, cache, tokens, lengths, starts,
                                                    slots, config, prefix_rows)
    return _commit_slot_rows(cache, new_k, new_v, slots, write_pos)


def verify_continue(
    params: dict,
    cache: dict,  # updated in place (rows [start, start + length) of each lane)
    tokens: torch.Tensor,  # [B, T] int — last sampled token + draft (rows padded)
    lengths: torch.Tensor,  # [B] int — 1 + draft length (0 = an idle lane)
    starts: torch.Tensor,  # [B] int — each lane's seq_len (max_ctx for an idle lane)
    config: LlamaConfig,
    prefix_rows: Optional[int] = None,  # the live lanes' largest start, if known on the host
) -> tuple[dict, torch.Tensor]:
    """The speculative verify pass on the slot layout: every draft position
    scored in one dispatch. Row ``b`` is lane and slot ``b`` (the pass runs
    at the compacted width), so there is no slot indirection. The whole
    row's KV is written optimistically; a rejected tail needs no rollback,
    since the engine advances seq_len over the accepted prefix only.
    Returns (cache, logits [B, T, V])."""
    check_supported(config)
    slots = torch.arange(tokens.shape[0], device=tokens.device)
    new_k, new_v, x, write_pos = _continue_forward(params, cache, tokens, lengths, starts,
                                                   slots, config, prefix_rows)
    _commit_slot_rows(cache, new_k, new_v, slots, write_pos)
    return cache, _head_logits(x, params, config)


def decode_step(
    params: dict,
    cache: dict,  # updated in place
    tokens: torch.Tensor,  # [W] int — last sampled token per slot, W <= max_slots
    seq_lens: torch.Tensor,  # [W] int — length per slot before this token
    config: LlamaConfig,
    active: Optional[torch.Tensor] = None,  # [W] bool; inactive lanes write row C-1
) -> tuple[dict, torch.Tensor]:
    """One decode step for slots ``0..W-1`` of the slot cache (the width
    may be narrower than the cache's slot count; rows past W are
    untouched). Each layer reads the slots' rows read-only and attends the
    new token through a self term; one commit after the loop writes every
    layer's new K/V at row ``seq_len`` of each lane. ``active`` sends an
    inactive lane's write to row ``C - 1``: without it a mid-prefill slot
    below the width would have its prompt rows overwritten at its stale
    seq_len. Returns (cache, logits [W, V])."""
    c = config
    check_supported(c)
    W = tokens.shape[0]
    positions = seq_lens.long()[:, None]
    x = _embed(params, tokens[:, None], c)
    quantized = "ks" in cache
    new_k, new_v = [], []
    for i in range(c.n_layers):
        k_rows, v_rows = cache["k"][i, :W], cache["v"][i, :W]
        k_sc, v_sc = (cache["ks"][i, :W], cache["vs"][i, :W]) if quantized else (None, None)

        def attn(q, k, v):
            out = decode_attention_cache_plus_new(
                q[:, 0], _kv_rows(k_rows, k_sc, slice(None), k.dtype),
                _kv_rows(v_rows, v_sc, slice(None), v.dtype), k[:, 0], v[:, 0], seq_lens,
            )
            return out[:, None]

        x, k, v = _attn_mlp(x, _layer(params, i), c, positions, attn)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
    C = cache["k"].shape[2]
    lens = seq_lens.long()
    rows = torch.where(active, lens, C - 1) if active is not None else lens
    lanes = torch.arange(W, device=lens.device)

    def setter(arr, val):
        arr[:, lanes, rows] = val

    _kv_commit(cache, torch.stack(new_k), torch.stack(new_v), setter)
    x = rms_norm(x[:, 0], _final_norm_w(params, c), c.norm_eps)
    return cache, _head_logits(x, params, c)


# ---------------------------------------------------------------------------
# Serving: paged KV cache
# ---------------------------------------------------------------------------


def init_paged_cache(
    config: LlamaConfig, num_pages: int, page_size: int, device="cuda",
    quantize_kv: bool = False, group: Optional[ServingGroup] = None,
) -> dict:
    """Page pools in the model dtype — or int8 plus f32 scale twins with
    ``quantize_kv``. With a ``group`` the rank's pool: its H_kv/tp heads and
    page_size/sp rows of every page ([L, NP, P/sp, H_kv/tp, d])."""
    _, H_kv = local_heads(config, group)
    sp = group.sp if group is not None else 1
    return init_kv_pages(
        config.n_layers, num_pages, page_size // sp, H_kv, config.head_dim,
        config.dtype, device=device, quantize=quantize_kv,
    )


def prefill_paged_batch(
    params: dict,
    pages: dict,  # {"k": [L, num_pages, P, H_kv, d], "v": ...} — updated in place
    tokens: torch.Tensor,  # [B, T] int (rows padded to a multiple of page_size)
    lengths: torch.Tensor,  # [B] int
    page_ids: torch.Tensor,  # [B, T // P] int (TRASH_PAGE beyond each prompt)
    config: LlamaConfig,
    group: Optional[ServingGroup] = None,
) -> tuple[dict, torch.Tensor]:
    """B prompts forward in one pass, each writing K/V into its own pages.
    Rows' trash-page writes may collide — unordered garbage into the
    never-read page 0. Returns (pages, last-token logits [B, V]). With a
    ``group`` this rank computes its heads and commits its rows of each
    page; no sp collective is needed (activations are replicated)."""
    c = config
    check_supported(c)
    B, T = tokens.shape
    ar = torch.arange(T, device=tokens.device)
    lengths = lengths.long()
    positions = torch.where(ar[None, :] < lengths[:, None], ar[None, :], -1)
    x = _embed(params, tokens, c, group)
    new_k, new_v = [], []
    for i in range(c.n_layers):
        x, k, v = _attn_mlp(
            x, _layer(params, i), c, positions,
            lambda q, k, v: blocked_causal_attention(q, k, v, positions), group,
        )
        new_k.append(k)
        new_v.append(v)
    # prompt attention never reads the pages, so one commit after the loop
    # writes every layer's blocks
    _commit_whole_pages(pages, torch.stack(new_k), torch.stack(new_v), page_ids, group)
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    last = x[torch.arange(B, device=x.device), lengths - 1]  # [B, D]
    return pages, _head_logits(last, params, c, group)


def _commit_whole_pages(
    pages: dict,
    new_k: torch.Tensor,  # [L, B, T, H_kv, d]
    new_v: torch.Tensor,
    page_ids: torch.Tensor,  # [B, T // P] int
    group: Optional[ServingGroup] = None,
) -> dict:
    """Whole-page commit: row block j of prompt b lands in page
    ``page_ids[b, j]`` of every layer, in place. The blocks reshape covers
    the scale twins too (values [L, B, T, H, d] and scales [L, B, T, H]
    both split T into pages). An sp rank writes only its rows
    ``[sp_rank * P/sp, (sp_rank + 1) * P/sp)`` of each block."""
    L, B, T = new_k.shape[:3]
    P_local = pages["k"].shape[2]
    sp = group.sp if group is not None else 1
    P = P_local * sp
    lo = group.sp_rank * P_local if sp > 1 else 0
    flat_ids = page_ids.reshape(-1).long()

    def setter(arr, val):
        blocks = val.reshape(L, B * (T // P), P, *val.shape[3:])
        arr[:, flat_ids] = blocks[:, :, lo : lo + P_local]

    return _kv_commit(pages, new_k, new_v, setter)


def _merge_sp_prefix(group: ServingGroup, state: tuple) -> tuple:
    """Merge the sp ranks' prefix states ``(m, l, acc)`` with
    ``merge_sp_states``. A rank's state of a query none of its rows are
    valid for has ``m`` at ``NEG_INF`` (clamped there, never -inf, so the
    merge stays finite) and weighs 0 beside any rank's real row."""
    m, l, acc = state
    acc, m, l = merge_sp_states(acc, torch.clamp_min(m, NEG_INF), l, group.sp_max, group.sp_sum)
    return m, l, acc


def _paged_continue_forward(
    params: dict,
    pages: dict,  # read only
    tokens: torch.Tensor,  # [B, T] int — the new tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true token counts
    starts: torch.Tensor,  # [B] int — absolute position of each row's first token
    block_tables: torch.Tensor,  # [B, max_pages] int
    config: LlamaConfig,
    group: Optional[ServingGroup] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's new tokens through the model, attending over its prefix
    rows (positions < start, gathered from its pages) and then its own
    tokens causally, one online softmax over both. Returns ``(new_k [L, B,
    T, H_kv, d], new_v, x_normed [B, T, D])``, uncommitted.

    Only the table columns that hold prefix rows are gathered, in page
    order; the reference's offset-major row order is a layout device of
    its sharding and every order masked by key position computes the same
    function. Over tp a rank computes its heads. Over sp a rank holds rows
    ``[sp_rank * P/sp, ...)`` of every page: it walks its rows, the ranks'
    unnormalized states merge over the sp group, and the suffix's own
    causal block (replicated) is folded in after the merge."""
    c = config
    B, T = tokens.shape
    dev = tokens.device
    ar = torch.arange(T, device=dev)
    lengths, starts = lengths.long(), starts.long()
    positions = torch.where(ar[None, :] < lengths[:, None], starts[:, None] + ar[None, :], -1)
    x = _embed(params, tokens, c, group)
    P_local = pages["k"].shape[2]
    sp = group.sp if group is not None else 1
    P = P_local * sp
    lo = group.sp_rank * P_local if sp > 1 else 0
    # the table columns below the live lanes' starts: an idle lane (length
    # 0, start max_ctx, as the verify pass lays them out) must not make
    # every lane gather its whole table
    cols = min(block_tables.shape[1],
               -(-int(torch.where(lengths > 0, starts, 0).max()) // P))
    tables = block_tables[:, :cols].long()
    row_pos = (torch.arange(cols, device=dev)[:, None] * P + lo
               + torch.arange(P_local, device=dev)[None, :]).reshape(-1)
    cache_pos = torch.where(row_pos[None, :] < starts[:, None], row_pos[None, :], -1)
    quantized = "ks" in pages
    new_k, new_v = [], []
    for i in range(c.n_layers):
        k_pool, v_pool = pages["k"][i], pages["v"][i]
        k_sc, v_sc = (pages["ks"][i], pages["vs"][i]) if quantized else (None, None)

        def attn(q, k, v):
            def rows(pool, sc):
                # int8 rows dequantize straight to f32, as the int8 walk
                # reads them; the walk below computes in f32 either way
                dtype = torch.float32 if sc is not None else q.dtype
                return _kv_rows(pool, sc, tables, dtype).reshape(B, cols * P_local,
                                                                 *pool.shape[2:])

            state = continue_state(q, rows(k_pool, k_sc), rows(v_pool, v_sc), positions,
                                   cache_pos)
            if sp > 1:
                state = _merge_sp_prefix(group, state)
            _m, l, acc = continue_state(q, k, v, positions, positions, state=state)
            return online_softmax_finalize(l, acc, q.dtype)

        x, k, v = _attn_mlp(x, _layer(params, i), c, positions, attn, group)
        new_k.append(k)
        new_v.append(v)
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    return torch.stack(new_k), torch.stack(new_v), x


def prefill_paged_continue(
    params: dict,
    pages: dict,  # updated in place (the suffix pages only)
    tokens: torch.Tensor,  # [B, T] int — SUFFIX tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true suffix lengths
    starts: torch.Tensor,  # [B] int — absolute suffix start (page-aligned)
    page_ids: torch.Tensor,  # [B, T // P] int — the SUFFIX pages
    block_tables: torch.Tensor,  # [B, max_pages] int — prefix + suffix pages
    config: LlamaConfig,
    group: Optional[ServingGroup] = None,
) -> tuple[dict, torch.Tensor]:
    """Paged continuation (a prefix-cache hit, an adopted parked slot, a
    resumed preemption): the prefix pages in each row's block table are
    already written — shared with a cache entry or kept by the slot, never
    written here. Starts are page-aligned, so the suffix commit
    (:func:`_commit_whole_pages`) lands in fresh pages only. Returns
    (pages, last-token logits [B, V])."""
    c = config
    check_supported(c)
    B = tokens.shape[0]
    new_k, new_v, x = _paged_continue_forward(params, pages, tokens, lengths, starts,
                                              block_tables, c, group)
    _commit_whole_pages(pages, new_k, new_v, page_ids, group)
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return pages, _head_logits(last, params, c, group)


def prefill_paged_continue_kv(
    params: dict,
    pages: dict,  # updated in place (the chunk pages only)
    tokens: torch.Tensor,  # [B, T] int — chunk tokens (rows padded)
    lengths: torch.Tensor,  # [B] int — true chunk lengths
    starts: torch.Tensor,  # [B] int — absolute chunk start (page-aligned)
    page_ids: torch.Tensor,  # [B, T // P] int — the chunk's pages (TRASH_PAGE pads)
    block_tables: torch.Tensor,  # [B, max_pages] int
    config: LlamaConfig,
    group: Optional[ServingGroup] = None,
) -> dict:
    """A chunked prefill's mid chunk: :func:`prefill_paged_continue`'s
    whole-page commit without the lm_head, so nothing is sampled. Writes
    the same KV as the continuation that samples."""
    check_supported(config)
    new_k, new_v, _x = _paged_continue_forward(params, pages, tokens, lengths, starts,
                                               block_tables, config, group)
    return _commit_whole_pages(pages, new_k, new_v, page_ids, group)


def verify_paged_continue(
    params: dict,
    pages: dict,  # updated in place (the rows [start, start + length) of each lane)
    tokens: torch.Tensor,  # [B, T] int — last sampled token + draft (rows padded)
    lengths: torch.Tensor,  # [B] int — 1 + draft length (0 = an idle lane)
    starts: torch.Tensor,  # [B] int — each lane's seq_len (NOT page-aligned)
    block_tables: torch.Tensor,  # [B, max_pages] int
    config: LlamaConfig,
) -> tuple[dict, torch.Tensor]:
    """The speculative verify pass on one card: every draft position scored
    in one dispatch over the lanes' pages (:func:`_paged_continue_forward`).
    The rows start MID-PAGE, in a page that holds live prefix KV, so the
    commit scatters per token through ``token_write_targets`` (one
    ``_kv_commit``, so int8 pools quantize as a decode step's commit does);
    idle lanes (length 0) and padded positions write the trash page.
    Returns (pages, logits [B, T, V]). The rejected tail's KV needs no
    rollback: attention masks by seq_len, which the engine advances over
    the accepted prefix only."""
    c = config
    check_supported(c)
    T = tokens.shape[1]
    new_k, new_v, x = _paged_continue_forward(params, pages, tokens, lengths, starts,
                                              block_tables, c)
    target, offset = token_write_targets(block_tables, starts, lengths, pages["k"].shape[2], T)

    def setter(arr, val):
        arr[:, target, offset] = val

    _kv_commit(pages, new_k, new_v, setter)
    return pages, _head_logits(x, params, c)


def decode_step_paged(
    params: dict,
    pages: dict,  # updated in place
    tokens: torch.Tensor,  # [S] int
    seq_lens: torch.Tensor,  # [S] int32 (length before this token)
    block_tables: torch.Tensor,  # [S, max_pages] int32
    active: torch.Tensor,  # [S] bool
    config: LlamaConfig,
    group: Optional[ServingGroup] = None,
) -> tuple[dict, torch.Tensor]:
    """One decode step for all slots against the paged cache. Each layer
    calls the paged decode-attention kernel (cache-plus-new form) over the
    read-only pages — the int8 walk, with the layer's scale twins, when the
    cache is quantized; the new token's self term uses its full-precision
    k/v. One commit after the loop writes every layer's new K/V at
    (page(slot), offset(slot)), inactive lanes to the trash page,
    quantizing it for an int8 cache. Returns (pages, logits [S, V]).

    With a ``group`` attention runs the sharded wrappers over this rank's
    heads and rows (sp > 1: the state walk and the sp merge), and the new
    row is written only by the sp rank that holds ``offset // (P/sp)``, at
    ``offset % (P/sp)``; every other rank sends it to the trash page."""
    c = config
    check_supported(c)
    S = tokens.shape[0]
    positions = seq_lens.long()[:, None]
    x = _embed(params, tokens[:, None], c, group)
    quantized = "ks" in pages
    new_k, new_v = [], []
    for i in range(c.n_layers):
        k_pages_l, v_pages_l = pages["k"][i], pages["v"][i]
        scales_l = (
            {"k_scales": pages["ks"][i], "v_scales": pages["vs"][i]} if quantized else {}
        )

        def attn(q, k, v):
            args = (q[:, 0].contiguous(), k_pages_l, v_pages_l, block_tables, seq_lens,
                    k[:, 0].contiguous(), v[:, 0].contiguous())
            if group is None:
                out = paged_decode_attention_cache_plus_new(*args, **scales_l)
            else:
                out = paged_decode_attention_cache_plus_new_sharded(group, *args, **scales_l)
            return out[:, None]

        x, k, v = _attn_mlp(x, _layer(params, i), c, positions, attn, group)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
    P_local = pages["k"].shape[2]
    sp = group.sp if group is not None else 1
    P = P_local * sp
    max_pages = block_tables.shape[1]
    lens = seq_lens.long()
    # inactive lanes may carry a stale seq_len at the context edge: clamp
    # the page index (the reference's gather clamps out-of-range indices)
    page_idx = torch.clamp_max(lens // P, max_pages - 1)
    target = block_tables.long()[torch.arange(S, device=lens.device), page_idx]
    offset = lens % P
    if sp > 1:  # only the rank holding the row writes it
        active = active & (offset // P_local == group.sp_rank)
        offset = offset % P_local
    target = torch.where(active, target, TRASH_PAGE)

    def setter(arr, val):
        arr[:, target, offset] = val

    _kv_commit(pages, torch.stack(new_k), torch.stack(new_v), setter)
    x = rms_norm(x[:, 0], _final_norm_w(params, c), c.norm_eps)
    return pages, _head_logits(x, params, c, group)
