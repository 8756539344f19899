"""The serving engine of the port: continuous batching over the paged KV
cache, trimmed from ``agentcontrolplane_tpu/engine/engine.py``.

- One **engine thread** owns the device state (params, page pools, the
  decode carry). Requests arrive on a thread-safe queue and resolve
  ``concurrent.futures.Future``s.
- **Admission** is strict FIFO. A request reserves a slot and KV pages for
  its whole generation (prompt + ``max_tokens``, capped at the context) at
  admission; when the pool cannot cover the head of the queue it waits
  there (backpressure) until finishing requests free pages. Admitted
  requests prefill in batches of up to ``prefill_batch_max`` prompts, rows
  padded to a page-multiple bucket, pad pages routed to ``TRASH_PAGE``,
  and sample their first token.
- **Decode** runs K-step blocks at the smallest width bucket covering the
  live slots: every step runs ``decode_step_paged`` (the CUDA paged
  attention kernel in every layer on the card), samples, and detects
  finishes on the device (stop tokens, budgets, the context edge). The
  host reads the block's tokens once per block and commits them.
- Pages are freed at finish and on cancel; queued requests past their
  deadline fail fast; ``max_queue`` sheds load.
- **Constrained decoding** (``SamplingParams.json_only`` /
  ``forced_prefix``): the forced prefix is prefilled with the prompt and
  returned as part of the output; with ``json_only`` the JSON automaton's
  token table (``engine/constrain.py``, built lazily, kept on the device at
  the tokenizer's width) masks the logits before the sampler and advances
  each lane's state after it, at the first token and at every decode step
  (``ops/sampling.py``). A block with no constrained lane runs none of it.
- **Streaming**: ``submit(on_tokens=)`` receives every commit of tokens
  (the first token with the forced prefix, then each decode block), and
  ``submit(on_tool_call=)`` each tool call the moment its braces close,
  from an incremental ``toolparse.ToolStreamParser`` over the same commits.
- **int8 serving** (the reference's knobs): ``quantize="int8"`` /
  ``quantize_weights`` serves int8 layer matrices (``ops/quant.py``), and
  ``quantize_kv`` an int8 page pool with f32 scale twins, walked by the
  int8 page-walk kernel. Both legitimately relax greedy byte identity with
  the unquantized engine (``engine/accuracy.py`` gates them instead); both
  off keeps the unquantized path exactly, with no scale storage.

- **Parallel serving** (the reference's ``mesh=``): with ``group`` (a
  ``parallel.mesh.ServingGroup``) each rank's engine holds its slices of
  the model and of every page, and the ranks run in lockstep on the frame
  stream of ``engine/coordination.py``: rank 0 (the leader) takes
  submissions and every decision that reads a clock, and publishes them as
  one frame per loop iteration; followers refuse ``submit`` and replay the
  frames. Sampling generators are seeded identically on every rank.

Left out for now (each is in ROADMAP): preemption, the prefix cache,
chunked prefill and the megastep, speculative decoding, parked slots
(``submit(park=)``), fleet affinity and trace export (``affinity_key=``,
``trace=``), dedup, the host KV tier, the flight recorder, the metrics
registry and fault sites, and multi-host.
"""

from __future__ import annotations

import contextlib
import heapq
import logging
import queue
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.llama import (
    PRESETS,
    LlamaConfig,
    check_supported,
    decode_step_paged,
    init_paged_cache,
    prefill_paged_batch,
)
from ..ops.cuda import paged_attention as walk
from ..ops.paged import TRASH_PAGE, PageAllocator
from ..ops.quant import QUANTIZABLE, QuantizedTensor, quantize_stacked
from ..ops.sampling import advance_constraint, constrain_logits, sample
from ..parallel.mesh import ServingGroup, ServingMesh, check_serving_config
from .constrain import build_token_table
from .coordination import FrameChannel, deserialize_request
from .tokenizer import ByteTokenizer, Tokenizer
from .toolparse import ToolStreamParser
from .weights import random_params

log = logging.getLogger("acp_torch.engine")


class EngineOverloadedError(RuntimeError):
    """The admission queue is at its cap: the request was shed, not queued.
    Retry after ``retry_after_s`` (the HTTP layer answers 503)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(RuntimeError):
    """The request's ``timeout_s`` expired while it was still queued."""


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 512  # budget for SAMPLED tokens (forced prefix is free)
    # grammar-constrained decoding: force a structurally valid JSON object
    # (engine/constrain.py); generation ends when the object closes
    json_only: bool = False
    # teacher-forced generation prefix (token ids): prefilled with the
    # prompt, returned as part of the output, and — with json_only — the
    # constraint automaton is seeded past it. This is how a forced
    # tool_choice teacher-forces the '{"name": "X", "arguments": {' envelope
    forced_prefix: tuple = ()


@dataclass
class GenerationResult:
    text: str
    tokens: list[int]
    finish_reason: str  # "stop" | "length" | "cancelled"
    prompt_tokens: int
    ttft_ms: float
    latency_ms: float
    preempt_count: int = 0  # always 0: the port does not preempt yet
    kv_handoff: Optional[object] = None  # always None: no disaggregation yet


@dataclass
class _Request:
    rid: str
    prompt: list[int]
    sampling: SamplingParams
    future: Future
    truncated: bool = False
    enqueued: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None  # absolute monotonic
    first_token_at: float = 0.0
    # called from the ENGINE thread with each commit's new token ids (must
    # not block; bridge to asyncio with call_soon_threadsafe)
    on_tokens: Optional[callable] = None
    # called from the ENGINE thread as (index, MessageToolCall) the moment a
    # streamed tool call's braces close; set with tool_parser by submit
    on_tool_call: Optional[callable] = None
    tool_parser: Optional[ToolStreamParser] = None
    # token ids whose text is still an incomplete UTF-8 sequence at a commit
    detok_pending: list[int] = field(default_factory=list)
    # (monotonic emit time, MessageToolCall) per streamed call; the same
    # list is ``future.early_tool_calls``
    early_calls: list = field(default_factory=list)
    # completed when the request takes a slot (prefill starts); mirrored on
    # future.admitted — a client's generation clock starts here, so queue
    # wait does not eat its budget
    admitted: Future = field(default_factory=Future)

    def emit(self, tokens: list[int]) -> None:
        if self.on_tokens is not None and tokens:
            try:
                self.on_tokens(tokens)
            except Exception:  # a broken consumer must not kill the engine
                log.exception("on_tokens failed; disabling for rid %s", self.rid)
                self.on_tokens = None


@dataclass
class _Slot:
    request: _Request
    generated: list[int] = field(default_factory=list)
    prompt_len: int = 0
    prefix_len: int = 0  # leading forced tokens in ``generated``
    first_token_at: float = 0.0


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2_chunks(items: list, max_chunk: int) -> list[list]:
    """Split into power-of-two-sized chunks (7 -> [4, 2, 1])."""
    out: list[list] = []
    i = 0
    while i < len(items):
        b = 1
        while b * 2 <= min(len(items) - i, max_chunk):
            b *= 2
        out.append(items[i : i + b])
        i += b
    return out


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    missing, so nothing silently runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the torch engine runs on the card by "
            "default; pass device='cpu' to run it on the CPU (tests)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    return dev


class Engine:
    def __init__(
        self,
        config: LlamaConfig | str = "llama3-8b",
        params: Optional[dict] = None,
        tokenizer: Optional[Tokenizer] = None,
        *,
        device="cuda",
        max_slots: int = 64,
        max_ctx: int = 2048,
        prefill_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        prefill_batch_max: int = 8,
        width_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        decode_block_size: int = 8,
        page_size: int = 16,
        kv_pages: int = 0,  # total pages (0 = every slot can hold max_ctx)
        max_queue: int = 0,  # 0 = unbounded
        quantize: Optional[str] = None,  # "int8" = weight-only int8 serving
        # alias for quantize="int8", matching the reference's knob names
        # (--quantize-weights on the port's CLI)
        quantize_weights: bool = False,
        # int8 KV pages with per-row-per-head f32 scales: commits quantize,
        # the int8 page walk dequantizes, so the pool holds ~1.94x the tokens
        # per byte at head_dim 128; relaxes greedy byte identity (gated by
        # engine/accuracy.py). Off keeps the unquantized pools exactly.
        quantize_kv: bool = False,
        seed: int = 0,
        # tp x sp serving over torch.distributed ranks: this rank's group;
        # params, if given, are already this rank's slices
        # (params_from_jax(..., group=) or parallel.mesh.shard_params)
        group: Optional[ServingGroup] = None,
    ):
        self.device = resolve_device(device)
        if isinstance(config, str):
            config = PRESETS[config]
        check_supported(config)
        self.config = config
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_slots = max_slots
        self.max_ctx = min(max_ctx, config.max_seq_len)
        self.page_size = page_size
        check_serving_config(config, group, page_size, self.max_ctx)
        if self.max_ctx % page_size:
            raise ValueError(f"page_size {page_size} must divide max_ctx {self.max_ctx}")
        # every prompt fits one bucket (chunked prefill is not ported): the
        # context itself is the last bucket
        buckets = sorted({b for b in prefill_buckets if b <= self.max_ctx} | {self.max_ctx})
        bad = [b for b in buckets if b % page_size]
        if bad:
            raise ValueError(f"prefill buckets {bad} are not multiples of page_size {page_size}")
        self.prefill_buckets = buckets
        self.prefill_batch_max = max(1, prefill_batch_max)
        self.width_buckets = sorted({w for w in width_buckets if 0 < w < max_slots} | {max_slots})
        self.decode_block_size = max(1, decode_block_size)
        self.max_queue = max(0, max_queue)
        self.max_pages_per_seq = self.max_ctx // page_size
        self.num_pages = kv_pages or (max_slots * self.max_pages_per_seq + 1)
        self.group = group
        # axis sizes, read by the LLM controller (``engine.mesh.shape``)
        self.mesh = ServingMesh.of(group)
        # lockstep frame stream across the group's ranks (None on one rank)
        self._channel = (
            FrameChannel(group) if group is not None and group.world_size > 1 else None
        )
        self._follower = self._channel is not None and not self._channel.leader

        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantization {quantize!r}")
        if quantize_weights:
            quantize = "int8"
        self.quantize = quantize
        self.quantize_kv = bool(quantize_kv)

        t0 = time.monotonic()
        if params is None:
            # quantized random init never holds the whole bf16 model; with a
            # group each rank keeps only its slices
            params = random_params(config, seed, self.device, quantize=quantize, group=group)
        elif quantize == "int8" and group is not None and group.tp > 1:
            # a row slice's per-channel scale is the FULL matrix's: int8
            # must be applied before the model is cut to the ranks
            unquantized = [k for k in QUANTIZABLE
                           if not isinstance(params["layers"][k], QuantizedTensor)]
            if unquantized:
                raise ValueError(
                    f"tp={group.tp} int8 serving needs params quantized before slicing; "
                    f"{unquantized} are not (quantize_params, then shard_params)"
                )
        elif quantize == "int8":
            # quantize matrix by matrix, dropping each original as its int8
            # replacement lands (in place in the layer dict), so the peak is
            # the given params plus one matrix; quantized leaves are kept
            layers = params["layers"]
            for key in QUANTIZABLE:
                if not isinstance(layers[key], QuantizedTensor):
                    layers[key] = quantize_stacked(layers[key])
        self.params = params
        # bytes held by weights: int8 values plus f32 scales for quantized
        # matrices, so this is the served footprint
        self.weight_bytes = sum(
            t.nbytes if isinstance(t, QuantizedTensor) else t.numel() * t.element_size()
            for t in [*self.params["layers"].values(),
                      *(v for k, v in self.params.items() if k != "layers")]
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._stop_tokens = torch.tensor(
            sorted(self.tokenizer.stop_tokens), dtype=torch.int64, device=self.device
        )
        # the JSON constraint's token table, built at the first constrained
        # request (_get_token_table); _token_table is published last
        self._table_lock = threading.Lock()
        self._token_table: Optional[torch.Tensor] = None
        self._min_close: Optional[torch.Tensor] = None
        self._token_table_np: Optional[np.ndarray] = None
        self._table_start = 0
        self.constraint_table_bytes = 0
        self.constraint_table_build_s = 0.0
        self._init_kv_state()
        log.info("engine init: params + pages in %.1fs", time.monotonic() - t0)

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._waiting: deque[_Request] = deque()
        # cancel() adds rids here (any thread); _applied holds the cancels
        # every rank applies — the same set on one rank, the leader's
        # published ones under coordination
        self._cancelled: set[str] = set()
        self._applied: set[str] = self._cancelled if self._channel is None else set()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._crashed = False
        self._restart_lock = threading.Lock()
        self._admission_held = 0
        self._admission_lock = threading.Lock()
        self._outstanding: set = set()  # undone futures; failed on crash
        # (rid, tokens, finish_reason) of the latest finished requests, in
        # finish order — what lockstep ranks must agree on
        self.finished: deque[tuple[str, tuple, str]] = deque(maxlen=4096)
        self.decode_steps = 0
        self.requests_prefilled = 0
        self.tokens_generated = 0
        self.table_uploads = 0
        self.sheds = 0
        self.tool_calls_early = 0

    def _init_kv_state(self) -> None:
        """(Re)build the page pools and the host bookkeeping — shared by
        __init__ and crash recovery."""
        self.cache = init_paged_cache(
            self.config, self.num_pages, self.page_size, device=self.device,
            quantize_kv=self.quantize_kv, group=self.group,
        )
        self.pool_bytes = sum(t.numel() * t.element_size() for t in self.cache.values())
        self._allocator = PageAllocator(self.num_pages)
        self._slot_pages: dict[int, list[int]] = {}
        self._block_tables = np.full(
            (self.max_slots, self.max_pages_per_seq), TRASH_PAGE, dtype=np.int32
        )
        self._slots: dict[int, _Slot] = {}
        self._free = list(range(self.max_slots))
        # host mirrors of per-slot decode state
        self._seq_lens = np.zeros(self.max_slots, dtype=np.int32)
        self._last_tokens = np.zeros(self.max_slots, dtype=np.int64)
        self._temps = np.zeros(self.max_slots, dtype=np.float32)
        self._top_ks = np.zeros(self.max_slots, dtype=np.int64)
        self._top_ps = np.ones(self.max_slots, dtype=np.float32)
        self._budgets = np.zeros(self.max_slots, dtype=np.int32)
        self._con_states = np.zeros(self.max_slots, dtype=np.int32)
        self._constrained = np.zeros(self.max_slots, dtype=bool)
        # device-resident decode carry; re-uploaded from the mirrors only
        # when slot assignment changed (admission, finish, cancel)
        self._dev: Optional[dict] = None
        self._state_dirty = True

    # -- public API ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._run, name="torch-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop. On a follower this waits for the leader's stop
        frame: the follower's loop must leave in lockstep with the leader."""
        if self._follower:
            self.join(timeout=60)
            return
        with self._restart_lock:
            self._crashed = False
            if self._thread is None:
                return
            if self._channel is None:
                self._stopping = True
            # a leader must leave through _admit, which publishes the stop
            # frame that ends its followers' loops
            self._queue.put(None)
            self._thread.join(timeout=60)
            self._thread = None

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the engine loop to end (a follower's ends with the
        leader's stop frame). True when it has ended."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                return False
        self._thread = None
        return True

    def ensure_running(self) -> bool:
        """Crash recovery: if the engine loop died on an exception (not a
        stop()), rebuild the pools and bookkeeping and restart it. True when
        the engine is running. A crashed rank of a group stays down: its
        peers cannot be brought back into lockstep from here."""
        with self._restart_lock:
            if self._crashed and self._channel is not None:
                return False
            if self._crashed:
                if self._thread is not None:
                    self._thread.join(timeout=60)
                    if self._thread.is_alive():
                        return False
                log.warning("engine crashed; rebuilding serving state and restarting")
                self._init_kv_state()
                self._waiting.clear()
                self._cancelled.clear()
                self._crashed = False
                self._stopping = False
                self._thread = threading.Thread(target=self._run, name="torch-engine", daemon=True)
                self._thread.start()
                return True
            return self._thread is not None and self._thread.is_alive()

    def submit(
        self,
        prompt: str | list[int],
        sampling: Optional[SamplingParams] = None,
        on_tokens=None,
        timeout_s: Optional[float] = None,
        on_tool_call=None,
    ) -> Future:
        """Thread-safe; returns a Future[GenerationResult]. ``timeout_s``
        fails the request fast (DeadlineExceededError) if it is still queued
        when the deadline passes.

        ``on_tokens`` receives each commit's new token ids from the engine
        thread (the first token with any forced prefix, then every decode
        block); ``on_tool_call`` is called there as ``(index,
        MessageToolCall)`` the moment a streamed tool call's braces close,
        and the calls are also on ``future.early_tool_calls``. Both must not
        block, and neither changes what is generated.
        ``future.admitted`` completes when the request takes a slot."""
        s = sampling or SamplingParams()
        tokens = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        prefix_len = len(s.forced_prefix)
        # keep the prompt's TAIL and leave room for the forced prefix and
        # for generating (a context-filling prompt would otherwise truncate
        # every forced tool call at once)
        reserve = min(s.max_tokens, max(1, self.max_ctx // 2))
        budget = max(1, self.max_ctx - prefix_len - reserve)
        truncated = len(tokens) > budget
        if truncated:
            tokens = tokens[-budget:]
        req = _Request(
            rid=uuid.uuid4().hex[:8],
            prompt=tokens,
            sampling=s,
            future=Future(),
            truncated=truncated,
            deadline=(time.monotonic() + timeout_s) if timeout_s else None,
            on_tokens=on_tokens,
            on_tool_call=on_tool_call,
        )
        if on_tool_call is not None:
            req.tool_parser = ToolStreamParser()
        req.future.early_tool_calls = req.early_calls  # type: ignore[attr-defined]
        req.future.admitted = req.admitted  # type: ignore[attr-defined]
        req.future.rid = req.rid  # type: ignore[attr-defined]  # cancel() keys on it
        if self._follower:
            # a locally submitted request would break lockstep: followers
            # only replay the leader's frame stream
            req.future.set_exception(RuntimeError(
                "coordinated follower engines do not accept submissions "
                "(submit through rank 0's engine)"
            ))
            return req.future
        if self._thread is None or self._stopping:
            req.future.set_exception(RuntimeError("engine is not running"))
            return req.future
        depth = self._queue.qsize() + len(self._waiting)
        if self.max_queue and depth >= self.max_queue:
            self.sheds += 1
            req.future.set_exception(EngineOverloadedError(
                f"admission queue full ({depth} waiting, cap {self.max_queue}); retry later",
                retry_after_s=max(1.0, min(30.0, depth * 0.25)),
            ))
            return req.future
        self._outstanding.add(req.future)
        req.future.add_done_callback(self._outstanding.discard)
        self._queue.put(req)
        return req.future

    def cancel(self, future: Future) -> None:
        """Abort the request behind a Future from :meth:`submit`. A queued
        request is cancelled at the next admission; an active slot is freed
        (pages released) before the next decode block, with finish_reason
        "cancelled"."""
        rid = getattr(future, "rid", None)
        if rid is not None and (not future.done() or future.cancelled()):
            self._cancelled.add(rid)

    def generate(
        self, prompt: str | list[int], sampling: Optional[SamplingParams] = None
    ) -> GenerationResult:
        """Synchronous helper. Requires a started engine."""
        return self.submit(prompt, sampling).result(timeout=600)

    @contextlib.contextmanager
    def hold_admission(self):
        """While held, submitted requests accumulate in the queue; on
        release ONE admission group forms with the whole batch (deterministic
        batch shapes for tests and the smoke's repeat check)."""
        with self._admission_lock:
            self._admission_held += 1
        try:
            yield
        finally:
            with self._admission_lock:
                self._admission_held -= 1

    def stats(self) -> dict:
        """Point-in-time status (served at /v1/engine). Cross-thread reads
        of ints and lengths only."""
        return {
            "model": {
                "dim": self.config.dim,
                "layers": self.config.n_layers,
                "vocab": self.config.vocab_size,
                "dtype": str(self.config.dtype).replace("torch.", ""),
                "quantize": self.quantize,
                "quantize_kv": self.quantize_kv,
                "weight_bytes": self.weight_bytes,
            },
            "device": str(self.device),
            "mesh": dict(self.mesh.shape),
            # this rank's share: its weight slices and its slice of the pool
            "rank": {
                "index": self.group.rank if self.group is not None else 0,
                "weight_bytes": self.weight_bytes,
                "pool_bytes": self.pool_bytes,
            },
            "kv_layout": "paged",
            "max_slots": self.max_slots,
            "max_ctx": self.max_ctx,
            "active_slots": len(self._slots),
            "waiting": len(self._waiting) + self._queue.qsize(),
            "max_queue": self.max_queue,
            "sheds": self.sheds,
            "decode_block_size": self.decode_block_size,
            "decode_steps": self.decode_steps,
            "requests_prefilled": self.requests_prefilled,
            "tokens_generated": self.tokens_generated,
            "tokens_per_decode_step": (
                round(self.tokens_generated / self.decode_steps, 4) if self.decode_steps else 0.0
            ),
            "kv_pages": {
                "total": self.num_pages - 1,
                "free": self._allocator.free_count,
                "page_size": self.page_size,
                "table_uploads": self.table_uploads,
            },
            # the JSON constraint's token table on the device (0 until the
            # first constrained request builds it) and its host build time
            "constraint_table_bytes": self.constraint_table_bytes,
            "constraint_table_build_s": round(self.constraint_table_build_s, 4),
            "tool_calls_early": self.tool_calls_early,
            # this process's CUDA walk launches (all walks and forms, the
            # int8 walk, the state form); 0 while tensors are on the CPU
            "walk_launches": {
                "total": walk.LAUNCHES,
                "int8": walk.INT8_LAUNCHES,
                "state": walk.STATE_LAUNCHES,
            },
            "memory": {
                # int8 KV cache: at a fixed byte budget the pool holds ~1.94x
                # the tokens (head_dim 128)
                "quantized_kv": {
                    "enabled": self.quantize_kv,
                    "pages": self._allocator.allocated_count if self.quantize_kv else 0,
                },
            },
        }

    # -- engine loop -----------------------------------------------------

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                while not self._stopping:
                    self._admit(block=not self._slots)
                    if self._stopping:
                        break
                    if self._slots:
                        self._decode_once()
        except Exception as e:  # an engine crash must not hang callers
            log.exception("engine loop crashed")
            self._slots.clear()
            self._stopping = True
            self._crashed = True
            for fut in list(self._outstanding):
                if not fut.done():
                    fut.set_exception(RuntimeError(f"engine crashed: {e}"))
        # drain: fail queued requests, resolve live slots as stopped
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._waiting.append(req)
        while self._waiting:
            fut = self._waiting.popleft().future
            if not fut.done():
                fut.set_exception(RuntimeError("engine stopped"))
        for slot in list(self._slots):
            self._finish(slot, "stop")

    def _admit(self, block: bool) -> bool:
        """Move queued requests into free slots (prefill), strictly FIFO.

        In a group the request stream is the only input to admission that
        differs between ranks, so the leader publishes what it drained and
        the cancels it decided as one frame, and followers replay it: every
        rank then runs the same admission on the same state."""
        if self._follower:
            frame = self._channel.recv()
            if frame["stop"]:
                self._stopping = True
                return False
            self._waiting.extend(deserialize_request(d) for d in frame["reqs"])
            self._applied.update(frame["cancels"])
            held = frame["hold"]
        else:
            drained: list[_Request] = []
            saw_stop = False
            may_block = block and not self._waiting
            while True:
                try:
                    req = self._queue.get(timeout=0.05) if may_block else self._queue.get_nowait()
                except queue.Empty:
                    break
                may_block = False
                if req is None:
                    saw_stop = True
                    break
                drained.append(req)
            # read once: it drives both the frame and this rank's decision
            held = bool(self._admission_held)
            if self._channel is not None:
                self._publish(drained, saw_stop, held)
            self._waiting.extend(drained)
            if saw_stop:
                self._stopping = True
                return False
        if self._applied:
            kept: deque[_Request] = deque()
            for r in self._waiting:
                if r.rid in self._applied:
                    self._applied.discard(r.rid)
                    r.future.cancel()
                else:
                    kept.append(r)
            self._waiting = kept
            # drop rids that raced their request's finish (snapshot first:
            # on one rank cancel() adds from other threads); in a group
            # in-transit rids never reach _applied, so the rule is the same
            # on every rank
            snapshot = set(self._applied)
            live = {r.rid for r in self._waiting}
            live.update(sl.request.rid for sl in self._slots.values())
            if self._channel is None:
                with self._queue.mutex:
                    live.update(r.rid for r in self._queue.queue if r is not None)
            self._applied -= snapshot - live
        if self._channel is None:
            self._expire_deadlines()
        if held:
            if not self._slots:
                time.sleep(0.002)
            return False
        return self._fill_slots()

    def _publish(self, drained: list, saw_stop: bool, held: bool) -> None:
        """Leader: decide this iteration's cancels and publish the frame.
        Deadlines expire here, before the cancel snapshot, so an expired
        request leaves every rank's queue in this frame. Only cancels of
        requests already in the replicated stream (or in this frame) are
        published; one racing its own still-queued request waits for the
        frame that carries the request."""
        self._expire_deadlines()
        snapshot = set(self._cancelled)
        live = {r.rid for r in self._waiting}
        live.update(sl.request.rid for sl in self._slots.values())
        live.update(r.rid for r in drained)
        pending = snapshot & live
        with self._queue.mutex:
            transit = {r.rid for r in self._queue.queue if r is not None}
        self._cancelled -= pending
        self._cancelled -= snapshot - (transit | live)
        self._channel.publish(drained, sorted(pending), stop=saw_stop, hold=held)
        self._applied.update(pending)

    def _expire_deadlines(self) -> None:
        """Fail queued requests whose deadline passed. On one rank they
        leave the queue here; in a group only the leader reads the clock,
        and the expired rids ride the next frame's cancels."""
        now = time.monotonic()
        expired = [r for r in self._waiting
                   if r.deadline is not None and now > r.deadline and not r.future.done()]
        if not expired:
            return
        for r in expired:
            r.future.set_exception(
                DeadlineExceededError("deadline expired while queued (never admitted)")
            )
        if self._channel is not None:
            self._cancelled.update(r.rid for r in expired)
            return
        gone = {id(r) for r in expired}
        self._waiting = deque(r for r in self._waiting if id(r) not in gone)

    @staticmethod
    def _full_row(req: _Request) -> list[int]:
        """The tokens a request prefills: prompt + teacher-forced prefix."""
        return list(req.prompt) + list(req.sampling.forced_prefix)

    def _pages_needed(self, req: _Request) -> int:
        """Pages for the whole generation: the prompt, the forced prefix and
        max_tokens, capped at the context (decode never allocates)."""
        rows = min(len(req.prompt) + len(req.sampling.forced_prefix) + req.sampling.max_tokens,
                   self.max_ctx)
        return -(-rows // self.page_size)

    def _fill_slots(self) -> bool:
        admitted = False
        while self._waiting and self._free:
            group = self._collect_group()
            if not group:
                break  # the head can't get pages yet; FIFO, it waits
            admitted = True
            for req, slot, pages in group:
                # starts the client's generation clock; a caller that gave
                # up may have cancelled the future already
                with contextlib.suppress(InvalidStateError):
                    req.admitted.set_result(True)
                self._slot_pages[slot] = pages
                self._block_tables[slot, :] = TRASH_PAGE
                self._block_tables[slot, : len(pages)] = pages
            for chunk in _pow2_chunks(group, self.prefill_batch_max):
                self._prefill_group(chunk)
        return admitted

    def _collect_group(self) -> list[tuple[_Request, int, list[int]]]:
        """Pop up to prefill_batch_max head requests, reserving a slot and
        pages for each. Stops at the first request the pool can't cover."""
        group: list[tuple[_Request, int, list[int]]] = []
        while self._waiting and len(group) < self.prefill_batch_max and self._free:
            req = self._waiting[0]
            s = req.sampling
            if s.json_only and s.forced_prefix and self._seed_con_state(s.forced_prefix) < 0:
                # an illegal prefix can never complete: fail it up front (on
                # every rank of a group alike: the decision reads only the
                # request)
                self._waiting.popleft()
                req.future.set_exception(RuntimeError("forced_prefix is not a legal JSON prefix"))
                continue
            need = self._pages_needed(req)
            if need > self._allocator.num_pages - 1:
                # bigger than the whole pool: waiting would spin forever
                self._waiting.popleft()
                req.future.set_exception(RuntimeError(
                    f"request needs {need} KV pages but the pool has "
                    f"{self._allocator.num_pages - 1}"
                ))
                continue
            try:
                pages = self._allocator.alloc(need)
            except MemoryError:
                break
            self._waiting.popleft()
            # lowest slot first keeps occupancy compact (narrow decode widths)
            group.append((req, heapq.heappop(self._free), pages))
        return group

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _seed_con_state(self, prefix: Sequence[int]) -> int:
        """Walk the token table over a forced prefix; -1 = illegal."""
        self._get_token_table()
        state = self._table_start
        for tok in prefix:
            if state < 0 or tok >= self._token_table_np.shape[1]:
                return -1
            state = int(self._token_table_np[state, tok])
        return state

    def _get_token_table(self) -> torch.Tensor:
        """The JSON constraint's token table on the device, built at first
        use under a lock; ``_token_table`` is assigned LAST, so a reader
        keying on it never sees a half-built state. It stays at the
        tokenizer's width (``ops/sampling.py`` forbids the logits past it),
        int16, with no padding to the model's vocabulary."""
        if self._token_table is None:
            with self._table_lock:
                if self._token_table is not None:
                    return self._token_table
                t0 = time.monotonic()
                table = build_token_table(self.tokenizer)
                build_s = time.monotonic() - t0
                self._token_table_np = table.token_trans  # host walks (prefix seeding)
                self._table_start = table.start_state
                self._min_close = torch.from_numpy(table.min_close).to(self.device)
                trans = torch.from_numpy(table.token_trans).to(self.device)
                self.constraint_table_bytes = sum(
                    t.numel() * t.element_size() for t in (trans, self._min_close))
                self.constraint_table_build_s = build_s
                self._token_table = trans  # LAST: publishes the rest
                log.info("JSON constraint table: %d states x %d tokens, %d bytes on %s "
                         "(built in %.1fs)", *table.token_trans.shape,
                         self.constraint_table_bytes, self.device, build_s)
        return self._token_table

    def _prefill_group(self, chunk: list[tuple[_Request, int, list[int]]]) -> None:
        """One batched prefill of prompt + forced prefix for B reserved
        requests, then first-token sampling (masked and advanced for
        json_only lanes) and one host read of the results."""
        B = len(chunk)
        P = self.page_size
        rows = [self._full_row(r) for r, _, _ in chunk]
        bucket = max(_next_bucket(len(row), self.prefill_buckets) for row in rows)
        tokens = np.zeros((B, bucket), dtype=np.int64)
        lengths = np.zeros(B, dtype=np.int64)
        page_ids = np.full((B, bucket // P), TRASH_PAGE, dtype=np.int64)
        temps = np.zeros(B, dtype=np.float32)
        top_ks = np.zeros(B, dtype=np.int64)
        top_ps = np.ones(B, dtype=np.float32)
        for i, (req, _slot, pages) in enumerate(chunk):
            plen = len(rows[i])
            tokens[i, :plen] = rows[i]
            lengths[i] = plen
            n = -(-plen // P)  # row pages; the rest of the bucket is trash
            page_ids[i, :n] = pages[:n]
            s = req.sampling
            temps[i], top_ks[i], top_ps[i] = s.temperature, s.top_k, s.top_p
        self.cache, logits = prefill_paged_batch(
            self.params, self.cache, self._upload(tokens), self._upload(lengths),
            self._upload(page_ids), self.config, group=self.group,
        )
        con_states = np.zeros(B, dtype=np.int32)
        json_lanes = any(r.sampling.json_only for r, _, _ in chunk)
        if json_lanes:
            table = self._get_token_table()
            constrained = np.zeros(B, dtype=bool)
            budgets = np.zeros(B, dtype=np.int32)
            for i, (req, _slot, _pages) in enumerate(chunk):
                s = req.sampling
                # 1 token now + decode capacity to the ctx edge
                budgets[i] = min(s.max_tokens, 1 + max(0, self.max_ctx - 1 - len(rows[i])))
                if s.json_only:
                    constrained[i] = True
                    con_states[i] = (self._seed_con_state(s.forced_prefix)
                                     if s.forced_prefix else self._table_start)
            dev_states, dev_constrained = self._upload(con_states), self._upload(constrained)
            logits = constrain_logits(logits, table, dev_states, dev_constrained,
                                      self._min_close, self._upload(budgets))
        firsts = sample(
            logits, self._gen, self._upload(temps), self._upload(top_ks), self._upload(top_ps)
        )
        if json_lanes:  # one host read for the tokens and the states
            states = advance_constraint(table, dev_states, dev_constrained, firsts)
            both = torch.stack([firsts, states.to(firsts.dtype)]).cpu().numpy()
            firsts, con_states = both[0], both[1].astype(np.int32)
        else:
            firsts = firsts.cpu().numpy()
        now = time.monotonic()
        self._state_dirty = True
        self.requests_prefilled += B
        for i, (req, slot, _pages) in enumerate(chunk):
            s = req.sampling
            first = int(firsts[i])
            if req.first_token_at == 0.0:
                req.first_token_at = now
            sl = _Slot(request=req, prompt_len=len(req.prompt),
                       prefix_len=len(s.forced_prefix), first_token_at=req.first_token_at)
            sl.generated.extend(s.forced_prefix)
            sl.generated.append(first)
            self._slots[slot] = sl
            self._seq_lens[slot] = len(rows[i])
            self._last_tokens[slot] = first
            self._temps[slot] = s.temperature
            self._top_ks[slot] = s.top_k
            self._top_ps[slot] = s.top_p
            self._con_states[slot] = con_states[i]
            self._constrained[slot] = s.json_only
            stop = first in self.tokenizer.stop_tokens
            self._stream(req, list(s.forced_prefix) + ([] if stop else [first]))
            if stop or len(sl.generated) - sl.prefix_len >= s.max_tokens:
                self._finish(slot, "stop" if stop else "length")

    def _slot_budget(self, slot: int, sl: _Slot) -> int:
        """Sampled tokens this slot may still emit: the smaller of its
        remaining max_tokens and the context edge."""
        token_left = sl.request.sampling.max_tokens - (len(sl.generated) - sl.prefix_len)
        ctx_left = self.max_ctx - 1 - int(self._seq_lens[slot])
        return max(0, min(token_left, ctx_left))

    def _ensure_dev_state(self) -> dict:
        """The device-resident decode carry (tokens, seq_lens, budgets,
        active, and the constraint states when a lane is constrained) and
        its per-slot constants. Re-uploaded from the host mirrors only when
        slot assignment changed; otherwise the previous block's carry feeds
        the next block directly."""
        if self._state_dirty or self._dev is None:
            max_active = max(self._slots) + 1
            W = next(w for w in self.width_buckets if w >= max_active)
            active = np.zeros(W, dtype=bool)
            for slot, sl in self._slots.items():
                active[slot] = True
                self._budgets[slot] = self._slot_budget(slot, sl)
            # host-side: a block with no constrained lane issues no mask op
            constrained = bool(self._constrained[:W].any())
            self._dev = {
                "W": W,
                "tokens": self._upload(self._last_tokens[:W]),
                "seq_lens": self._upload(self._seq_lens[:W]),
                "active": self._upload(active),
                "budgets": self._upload(self._budgets[:W]),
                "temps": self._upload(self._temps[:W]),
                "top_ks": self._upload(self._top_ks[:W]),
                "top_ps": self._upload(self._top_ps[:W]),
                "block_tables": self._upload(self._block_tables[:W]),
                "constrained_any": constrained,
            }
            if constrained:
                self._dev.update(
                    table=self._get_token_table(),
                    con_states=self._upload(self._con_states[:W]),
                    constrained=self._upload(self._constrained[:W]),
                )
            self.table_uploads += 1
            self._state_dirty = False
        return self._dev

    def _decode_once(self) -> None:
        """One K-step decode block over the live slots."""
        self._apply_cancels()
        if not self._slots:
            return
        d = self._ensure_dev_state()
        tokens, seq_lens, budgets, active = d["tokens"], d["seq_lens"], d["budgets"], d["active"]
        constrained = d["constrained_any"]
        con_states = d.get("con_states")
        steps = []
        for _ in range(self.decode_block_size):
            self.cache, logits = decode_step_paged(
                self.params, self.cache, tokens, seq_lens, d["block_tables"], active, self.config,
                group=self.group,
            )
            if constrained:
                logits = constrain_logits(logits, d["table"], con_states, d["constrained"],
                                          self._min_close, budgets)
            nxt = sample(logits, self._gen, d["temps"], d["top_ks"], d["top_ps"])
            nxt = torch.where(active, nxt, tokens)
            if constrained:
                con_states = advance_constraint(d["table"], con_states, d["constrained"], nxt)
            step = active.to(torch.int32)
            seq_lens = seq_lens + step
            budgets = budgets - step
            # finish detection on the device: a lane that sampled a stop
            # token, spent its budget or reached the context edge stops
            # advancing and writing for the rest of the block
            active = (
                active & ~torch.isin(nxt, self._stop_tokens) & (budgets > 0)
                & (seq_lens + 1 < self.max_ctx)
            )
            tokens = nxt
            steps.append(nxt)
        if constrained:
            # the block's one host read carries the automaton states too:
            # the mirror must hold them for the next dirty upload
            both = torch.stack([*steps, con_states.to(tokens.dtype)]).cpu().numpy()
            tok_block = both[:-1]
            self._con_states[: d["W"]] = both[-1]
            d["con_states"] = con_states
        else:
            tok_block = torch.stack(steps).cpu().numpy()  # the block's one host read
        d.update(tokens=tokens, seq_lens=seq_lens, budgets=budgets, active=active)
        self.decode_steps += self.decode_block_size
        for slot, sl in list(self._slots.items()):
            if slot < d["W"]:
                self._consume_tokens(slot, sl, tok_block[:, slot])

    def _consume_tokens(self, slot: int, sl: _Slot, toks) -> None:
        """Commit one block's tokens for one slot and finish it at the first
        stop token / exhausted budget / context edge — where the device
        deactivated the lane, so host and device bookkeeping agree."""
        s = sl.request.sampling
        done = None
        block_new: list[int] = []
        for tok in toks:
            tok = int(tok)
            self._seq_lens[slot] += 1
            self._last_tokens[slot] = tok
            sl.generated.append(tok)
            self.tokens_generated += 1
            if tok in self.tokenizer.stop_tokens:
                done = "stop"
                break
            block_new.append(tok)
            if (len(sl.generated) - sl.prefix_len >= s.max_tokens
                    or self._seq_lens[slot] + 1 >= self.max_ctx):
                done = "length"
                break
        self._stream(sl.request, block_new)
        if done is not None:
            self._finish(slot, done)

    def _stream(self, req: _Request, tokens: list[int]) -> None:
        """Commit newly sampled tokens to the caller (engine thread): the
        raw ids to ``on_tokens``, and, with a tool parser, the decoded delta
        to it, firing ``on_tool_call`` for every call whose braces closed.
        Every path that emits tokens comes through here."""
        req.emit(tokens)
        if req.tool_parser is None or not tokens:
            return
        req.detok_pending.extend(tokens)
        text = self.tokenizer.decode(req.detok_pending)
        if text.endswith("\ufffd"):
            return  # a multi-byte character cut at the commit: hold it
        req.detok_pending.clear()
        self._feed_tool_parser(req, text)

    def _stream_flush(self, req: _Request) -> None:
        """At generation end: feed any held-back text, so the parser has
        consumed exactly the generated text."""
        if req.tool_parser is None or not req.detok_pending:
            return
        text = self.tokenizer.decode(req.detok_pending)
        req.detok_pending.clear()
        self._feed_tool_parser(req, text)

    def _feed_tool_parser(self, req: _Request, text: str) -> None:
        try:
            calls = req.tool_parser.feed(text)
        except Exception:  # a broken parser must not kill the engine
            log.exception("tool stream parser failed; disabling for rid %s", req.rid)
            req.tool_parser = None
            return
        now = time.monotonic()
        for tc in calls:
            idx = len(req.early_calls)
            req.early_calls.append((now, tc))
            self.tool_calls_early += 1
            if req.on_tool_call is not None:
                try:
                    req.on_tool_call(idx, tc)
                except Exception:  # a broken consumer must not kill the engine
                    log.exception("on_tool_call failed; disabling for rid %s", req.rid)
                    req.on_tool_call = None

    def _apply_cancels(self) -> None:
        if not self._applied:
            return
        for slot, sl in list(self._slots.items()):
            if sl.request.rid in self._applied:
                self._finish(slot, "cancelled")

    def _finish(self, slot: int, reason: str) -> None:
        sl = self._slots.pop(slot, None)
        if sl is None:
            return
        req = sl.request
        if reason in ("stop", "length"):
            # a cancelled or drained request fires no late tool calls
            self._stream_flush(req)
        self._state_dirty = True  # the lane must be re-uploaded inactive
        self._applied.discard(req.rid)
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
        self._con_states[slot] = 0
        self._constrained[slot] = False
        heapq.heappush(self._free, slot)
        self._allocator.free(self._slot_pages.pop(slot, []))
        self._block_tables[slot, :] = TRASH_PAGE
        gen = sl.generated
        if gen and gen[-1] in self.tokenizer.stop_tokens:
            gen = gen[:-1]
        self.finished.append((req.rid, tuple(gen), reason))
        now = time.monotonic()
        result = GenerationResult(
            text=self.tokenizer.decode(gen),
            tokens=gen,
            finish_reason=reason,
            prompt_tokens=sl.prompt_len,
            ttft_ms=(sl.first_token_at - req.enqueued) * 1e3,
            latency_ms=(now - req.enqueued) * 1e3,
        )
        if not req.future.done():
            req.future.set_result(result)
