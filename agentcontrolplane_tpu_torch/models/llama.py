"""Llama model family in PyTorch — the port of
``agentcontrolplane_tpu/models/llama.py`` for the paged serving path.

Layout fidelity with the reference, so the tests compare like with like:
params are a plain dict with **stacked layer weights** (leading dim =
n_layers) in the ``x @ W`` orientation, the paged pools are
``[L, num_pages, P, H_kv, d]``, and the public programs keep the reference's
names and argument order. Differences that are PyTorch idiom:

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.attention import blocked_causal_attention, causal_attention
from ..ops.cuda.paged_attention import paged_decode_attention_cache_plus_new
from ..ops.norms import rms_norm
from ..ops.paged import TRASH_PAGE, init_kv_pages
from ..ops.quant import kv_quantize, quantize_stacked
from ..ops.quant import matmul as mm
from ..ops.rope import apply_rope


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
    config: LlamaConfig, generator: torch.Generator, device=None, quantize: Optional[str] = None
) -> dict:
    """Random init made on ``device`` from ``generator`` (serving with
    random weights); layout and scales mirror the reference's init. Each
    tensor is drawn directly in the model dtype, so peak memory is the
    weights themselves (about 16 GB for llama3-8b in bf16). With
    ``quantize="int8"`` each stacked layer matrix is quantized as soon as it
    is drawn and its bf16 original dropped before the next draw: the same
    values as quantizing the bf16 init afterwards, at a peak of the int8
    model plus one stacked matrix."""
    check_supported(config)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantize!r}")
    c = config
    d, hd = c.dim, c.head_dim
    device = device if device is not None else generator.device

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=device, dtype=c.dtype)
        return t.mul_(scale)

    def matrix(shape, scale):
        w = normal(shape, scale)
        return w if quantize is None else quantize_stacked(w)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=c.dtype)

    L = c.n_layers
    scale = d**-0.5
    params = {
        "embed": normal((c.vocab_size, d), scale),
        "layers": {
            "ln1": ones((L, d)),
            "ln2": ones((L, d)),
            "wq": matrix((L, d, c.n_heads * hd), scale),
            "wk": matrix((L, d, c.n_kv_heads * hd), scale),
            "wv": matrix((L, d, c.n_kv_heads * hd), scale),
            "wo": matrix((L, c.n_heads * hd, d), scale),
            "w1": matrix((L, d, c.ffn_dim), scale),  # gate_proj
            "w3": matrix((L, d, c.ffn_dim), scale),  # up_proj
            "w2": matrix((L, c.ffn_dim, d), c.ffn_dim**-0.5),  # down_proj
        },
        "norm": ones((d,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = normal((d, c.vocab_size), scale)
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


def _embed(params: dict, tokens: torch.Tensor, c: LlamaConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(c.dtype)


def _final_norm_w(params: dict, c: LlamaConfig) -> torch.Tensor:
    return params["norm"]


def _head_logits(x: torch.Tensor, params: dict, c: LlamaConfig) -> torch.Tensor:
    """lm_head projection -> float32 logits."""
    head = params["embed"].T if c.tie_embeddings else params["lm_head"]
    return (x @ head.to(c.dtype)).float()


def _attn_mlp(
    x: torch.Tensor,  # [B, T, D]
    layer: dict,  # one layer's weights
    config: LlamaConfig,
    positions: torch.Tensor,  # [B, T]
    attn_fn,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared block body: returns (output, k, v) where k/v are this layer's
    new key/value tensors (for the commit). The seven matmuls go through
    ``quant.matmul``: ``x @ W`` for dense weights, ``(x @ q) * scale`` for
    int8 ones."""
    c = config
    B, T, D = x.shape
    h = rms_norm(x, layer["ln1"], c.norm_eps)
    q = mm(h, layer["wq"]).reshape(B, T, c.n_heads, c.head_dim)
    k = mm(h, layer["wk"]).reshape(B, T, c.n_kv_heads, c.head_dim)
    v = mm(h, layer["wv"]).reshape(B, T, c.n_kv_heads, c.head_dim)
    scaling = _rope_scaling(c)
    q = apply_rope(q, positions, c.rope_theta, scaling=scaling)
    k = apply_rope(k, positions, c.rope_theta, scaling=scaling)
    attn = attn_fn(q, k, v)
    x = x + mm(attn.reshape(B, T, c.n_heads * c.head_dim), layer["wo"])
    h = rms_norm(x, layer["ln2"], c.norm_eps)
    y = mm(F.silu(mm(h, layer["w1"])) * mm(h, layer["w3"]), layer["w2"])
    return x + y, k, v


def forward(
    params: dict,
    tokens: torch.Tensor,  # [B, T] int
    config: LlamaConfig,
    positions: Optional[torch.Tensor] = None,  # [B, T]; default arange
) -> torch.Tensor:
    """Full-sequence causal forward -> logits [B, T, V] (float32)."""
    c = config
    check_supported(c)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = _embed(params, tokens, c)
    for i in range(c.n_layers):
        x, _, _ = _attn_mlp(
            x, _layer(params, i), c, positions,
            lambda q, k, v: causal_attention(q, k, v, positions),
        )
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    return _head_logits(x, params, c)


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


# ---------------------------------------------------------------------------
# Serving: paged KV cache
# ---------------------------------------------------------------------------


def init_paged_cache(
    config: LlamaConfig, num_pages: int, page_size: int, device="cuda",
    quantize_kv: bool = False,
) -> dict:
    """Page pools in the model dtype — or int8 plus f32 scale twins with
    ``quantize_kv``."""
    return init_kv_pages(
        config.n_layers, num_pages, page_size, config.n_kv_heads, config.head_dim,
        config.dtype, device=device, quantize=quantize_kv,
    )


def prefill_paged_batch(
    params: dict,
    pages: dict,  # {"k": [L, num_pages, P, H_kv, d], "v": ...} — updated in place
    tokens: torch.Tensor,  # [B, T] int (rows padded to a multiple of page_size)
    lengths: torch.Tensor,  # [B] int
    page_ids: torch.Tensor,  # [B, T // P] int (TRASH_PAGE beyond each prompt)
    config: LlamaConfig,
) -> tuple[dict, torch.Tensor]:
    """B prompts forward in one pass, each writing K/V into its own pages.
    Rows' trash-page writes may collide — unordered garbage into the
    never-read page 0. Returns (pages, last-token logits [B, V])."""
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
    # prompt attention never reads the pages, so one commit after the loop
    # writes every layer's blocks
    _commit_whole_pages(pages, torch.stack(new_k), torch.stack(new_v), page_ids)
    x = rms_norm(x, _final_norm_w(params, c), c.norm_eps)
    last = x[torch.arange(B, device=x.device), lengths - 1]  # [B, D]
    return pages, _head_logits(last, params, c)


def _commit_whole_pages(
    pages: dict,
    new_k: torch.Tensor,  # [L, B, T, H_kv, d]
    new_v: torch.Tensor,
    page_ids: torch.Tensor,  # [B, T // P] int
) -> dict:
    """Whole-page commit: row block j of prompt b lands in page
    ``page_ids[b, j]`` of every layer, in place. The blocks reshape covers
    the scale twins too (values [L, B, T, H, d] and scales [L, B, T, H]
    both split T into pages)."""
    L, B, T = new_k.shape[:3]
    P = pages["k"].shape[2]
    flat_ids = page_ids.reshape(-1).long()

    def setter(arr, val):
        arr[:, flat_ids] = val.reshape(L, B * (T // P), P, *val.shape[3:])

    return _kv_commit(pages, new_k, new_v, setter)


def decode_step_paged(
    params: dict,
    pages: dict,  # updated in place
    tokens: torch.Tensor,  # [S] int
    seq_lens: torch.Tensor,  # [S] int32 (length before this token)
    block_tables: torch.Tensor,  # [S, max_pages] int32
    active: torch.Tensor,  # [S] bool
    config: LlamaConfig,
) -> tuple[dict, torch.Tensor]:
    """One decode step for all slots against the paged cache. Each layer
    calls the paged decode-attention kernel (cache-plus-new form) over the
    read-only pages — the int8 walk, with the layer's scale twins, when the
    cache is quantized; the new token's self term uses its full-precision
    k/v. One commit after the loop writes every layer's new K/V at
    (page(slot), offset(slot)), inactive lanes to the trash page,
    quantizing it for an int8 cache. Returns (pages, logits [S, V])."""
    c = config
    check_supported(c)
    S = tokens.shape[0]
    positions = seq_lens.long()[:, None]
    x = _embed(params, tokens[:, None], c)
    quantized = "ks" in pages
    new_k, new_v = [], []
    for i in range(c.n_layers):
        k_pages_l, v_pages_l = pages["k"][i], pages["v"][i]
        scales_l = (
            {"k_scales": pages["ks"][i], "v_scales": pages["vs"][i]} if quantized else {}
        )

        def attn(q, k, v):
            out = paged_decode_attention_cache_plus_new(
                q[:, 0].contiguous(), k_pages_l, v_pages_l, block_tables, seq_lens,
                k[:, 0].contiguous(), v[:, 0].contiguous(), **scales_l,
            )
            return out[:, None]

        x, k, v = _attn_mlp(x, _layer(params, i), c, positions, attn)
        new_k.append(k[:, 0])
        new_v.append(v[:, 0])
    P = pages["k"].shape[2]
    max_pages = block_tables.shape[1]
    lens = seq_lens.long()
    # inactive lanes may carry a stale seq_len at the context edge: clamp
    # the page index (the reference's gather clamps out-of-range indices)
    page_idx = torch.clamp_max(lens // P, max_pages - 1)
    target = block_tables.long()[torch.arange(S, device=lens.device), page_idx]
    target = torch.where(active, target, TRASH_PAGE)
    offset = lens % P

    def setter(arr, val):
        arr[:, target, offset] = val

    _kv_commit(pages, torch.stack(new_k), torch.stack(new_v), setter)
    x = rms_norm(x[:, 0], _final_norm_w(params, c), c.norm_eps)
    return pages, _head_logits(x, params, c)
