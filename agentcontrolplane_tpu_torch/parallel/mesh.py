"""The serving group: tensor (tp) and context (sp) parallelism over
``torch.distributed`` ranks, and the rules that cut the model to a rank.

The counterpart of ``agentcontrolplane_tpu/parallel/mesh.py``. The JAX
package builds a device mesh and gives every parameter a ``PartitionSpec``;
XLA then inserts the collectives. Here each rank is a process holding only
its slices, and the model code calls the group's collectives itself:

- ranks are ordered as ``make_mesh({"sp": sp, "tp": tp})`` orders devices,
  tp innermost: ``rank = sp_rank * tp + tp_rank``. The tp group of a rank is
  its sp row, the sp group its tp column;
- :func:`param_slice` is ``param_specs`` (reference :93-130) as slicing
  rules: column slices of ``wq wk wv w1 w3``, row slices of ``wo w2``, the
  vocab rows of ``embed`` and columns of ``lm_head``, norms whole. An int8
  ``QuantizedTensor`` slices its values by the same rule; its per-output
  scale ``[..., 1, out]`` is sliced on ``out`` for a column slice and kept
  whole for a row slice (the scale commutes with the partial sum);
- the paged KV pool of a rank is ``[L, NP, P/sp, H_kv/tp, d]`` (scales
  ``[L, NP, P/sp, H_kv/tp]``): its KV heads, and rows
  ``[sp_rank * P/sp, (sp_rank + 1) * P/sp)`` of every page.

Collectives are sums and maxima only, each computed in f32 on a copy: gloo,
which ranks sharing one card must use, handles CUDA tensors in
``all_reduce`` and ``broadcast`` only, so every collective of the model is
an ``all_reduce``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

# params leaf -> the axis it is sliced on over tp, counted from the end
# (layer leaves carry a leading stacked-layer axis); absent = whole
COLUMN, ROW = -1, -2
LAYER_SLICES = {"wq": COLUMN, "wk": COLUMN, "wv": COLUMN, "w1": COLUMN, "w3": COLUMN,
                "wo": ROW, "w2": ROW}
TOP_SLICES = {"embed": -2, "lm_head": -1}  # vocab rows / vocab columns


@dataclass
class ServingGroup:
    """This rank's place in a tp x sp serving group, with its collectives.

    ``tp_group``/``sp_group`` are ``torch.distributed`` process groups (None
    when that axis has one rank: its collectives are then the identity), and
    ``frame_group`` a CPU (gloo) group over every rank for the engine's
    frame stream. ``collective_calls`` counts the model's collectives."""

    tp: int
    sp: int
    rank: int
    tp_rank: int
    sp_rank: int
    tp_group: Any = None
    sp_group: Any = None
    frame_group: Any = None
    collective_calls: int = 0

    @property
    def world_size(self) -> int:
        return self.tp * self.sp

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def axes(self) -> dict:
        """Axis sizes as the reference's ``mesh`` stats block has them."""
        return {"sp": self.sp, "tp": self.tp} if self.sp > 1 else {"tp": self.tp}

    def _reduce(self, t: torch.Tensor, op, group) -> torch.Tensor:
        """``all_reduce`` of an f32 copy of ``t``, returned in ``t``'s dtype."""
        buf = t.to(torch.float32, copy=True)
        dist.all_reduce(buf, op=op, group=group)
        self.collective_calls += 1
        return buf.to(t.dtype)

    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.tp == 1 else self._reduce(t, dist.ReduceOp.SUM, self.tp_group)

    def sp_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.sp == 1 else self._reduce(t, dist.ReduceOp.SUM, self.sp_group)

    def sp_max(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.sp == 1 else self._reduce(t, dist.ReduceOp.MAX, self.sp_group)

    def broadcast_frame(self, frame: Optional[dict]) -> dict:
        """Rank 0's ``frame`` delivered to every rank (followers pass None)."""
        box = [frame]
        dist.broadcast_object_list(box, src=0, group=self.frame_group)
        return box[0]


@dataclass(frozen=True)
class ServingMesh:
    """``Engine.mesh``: the part of the reference's serving mesh
    (``serving_mesh(...)``, a ``jax.sharding.Mesh``) that the control plane
    reads. ``shape`` maps axis names to sizes, with the reference's keys for
    the same tp and sp (``{"tp": 1}`` on one card)."""

    shape: dict

    @classmethod
    def of(cls, group: Optional[ServingGroup]) -> "ServingMesh":
        return cls(group.axes() if group is not None else {"tp": 1})


def serving_group(tensor_parallelism: int = 0, context_parallelism: int = 1) -> ServingGroup:
    """The serving group of this process (``serving_mesh``, reference
    :46-86): ``context_parallelism`` x ``tensor_parallelism`` ranks over the
    initialised process group, tp innermost. ``tensor_parallelism=0`` takes
    every rank left after sp. Every rank must call this, in the same order
    (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("serving_group needs an initialised process group "
                           "(parallel.distributed.init_distributed)")
    world = dist.get_world_size()
    sp = max(1, context_parallelism)
    if world % sp:
        raise ValueError(f"context_parallelism={sp} must divide the world size ({world})")
    tp = tensor_parallelism or world // sp
    if tp * sp != world:
        raise ValueError(f"tp={tp} x sp={sp} must equal the world size ({world})")
    rank = dist.get_rank()
    sp_rank, tp_rank = divmod(rank, tp)
    tp_group = sp_group = None
    # new_group is collective: every rank creates every group, in one order
    for s in range(sp):
        g = dist.new_group([s * tp + t for t in range(tp)]) if tp > 1 else None
        if s == sp_rank:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([s * tp + t for s in range(sp)]) if sp > 1 else None
        if t == tp_rank:
            sp_group = g
    frame_group = dist.new_group(backend="gloo")
    return ServingGroup(tp=tp, sp=sp, rank=rank, tp_rank=tp_rank, sp_rank=sp_rank,
                        tp_group=tp_group, sp_group=sp_group, frame_group=frame_group)


def check_serving_config(config, group: Optional[ServingGroup], page_size: int,
                         max_ctx: int) -> None:
    """The reference engine's refusals (``engine/engine.py:519-545``) plus
    the divisibility the port's slicing needs; raises ValueError."""
    if group is None:
        return
    tp, sp = group.tp, group.sp
    if tp > 1 and config.n_kv_heads % tp:
        raise ValueError(
            f"n_kv_heads={config.n_kv_heads} cannot shard over tp={tp} "
            "(MQA/GQA KV heads must divide tp — serve gemma-2b-style MQA models with tp=1)"
        )
    if tp > 1 and (config.n_heads % tp or config.vocab_size % tp):
        raise ValueError(
            f"n_heads={config.n_heads} and vocab_size={config.vocab_size} must divide by tp={tp}"
        )
    if sp > 1:
        if page_size % sp:
            raise ValueError(
                f"page_size={page_size} must be divisible by the mesh's sp={sp} for "
                "context-parallel paged serving"
            )
        if max_ctx % sp:
            raise ValueError(
                f"max_ctx={max_ctx} must be divisible by the mesh's sp={sp} for "
                "context-parallel serving"
            )


def _take(a, axis: int, part: int, parts: int):
    """Part ``part`` of ``parts`` equal slices of ``a`` (numpy or torch) on
    ``axis`` (counted from the end), as a view."""
    n = a.shape[axis]
    if n % parts:
        raise ValueError(f"axis of {n} does not split into {parts}")
    w = n // parts
    idx = [slice(None)] * a.ndim
    idx[a.ndim + axis] = slice(part * w, (part + 1) * w)
    return a[tuple(idx)]


def param_slice(name: str, leaf, group: Optional[ServingGroup], layer: bool):
    """The rank's slice of one params leaf (numpy array, tensor, or a
    ``QuantizedTensor``-like object with ``q``/``scale``): a view, or the
    leaf itself when it is replicated or there is no tp."""
    if group is None or group.tp == 1:
        return leaf
    axis = (LAYER_SLICES if layer else TOP_SLICES).get(name)
    if axis is None:
        return leaf
    if hasattr(leaf, "q") and hasattr(leaf, "scale"):
        q = _take(leaf.q, axis, group.tp_rank, group.tp)
        scale = _take(leaf.scale, axis, group.tp_rank, group.tp) if axis == COLUMN else leaf.scale
        return type(leaf)(q, scale)
    return _take(leaf, axis, group.tp_rank, group.tp)


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, group: Optional[ServingGroup]) -> dict:
    """A full params dict of tensors cut to this rank: copies of the
    slices, so the full tensors can be freed."""
    if group is None or group.tp == 1:
        return params

    def own(x):
        if hasattr(x, "q") and hasattr(x, "scale"):
            return type(x)(_copy(x.q), _copy(x.scale))
        return _copy(x)

    out = {k: own(param_slice(k, v, group, layer=False)) for k, v in params.items()
           if k != "layers"}
    out["layers"] = {k: own(param_slice(k, v, group, layer=True))
                     for k, v in params["layers"].items()}
    return out


def local_heads(config, group: Optional[ServingGroup]) -> tuple[int, int]:
    """(query heads, KV heads) on this rank."""
    tp = group.tp if group is not None else 1
    return config.n_heads // tp, config.n_kv_heads // tp


def vocab_range(config, group: Optional[ServingGroup]) -> tuple[int, int]:
    """[lo, hi) of the vocabulary rows this rank holds."""
    if group is None or group.tp == 1:
        return 0, config.vocab_size
    w = config.vocab_size // group.tp
    return group.tp_rank * w, (group.tp_rank + 1) * w
