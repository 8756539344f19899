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
chunked prefill and the megastep, speculative decoding, parked slots,
dedup, the host KV tier, the flight recorder and fault sites,
multi-host, and constrained decoding (``json_only`` / ``forced_prefix``
raise ``ValueError`` at submit).
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
from concurrent.futures import Future
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
from ..ops.paged import TRASH_PAGE, PageAllocator
from ..ops.quant import QUANTIZABLE, QuantizedTensor, quantize_stacked
from ..ops.sampling import sample
from ..parallel.mesh import ServingGroup, check_serving_config
from .coordination import FrameChannel, deserialize_request
from .tokenizer import ByteTokenizer, Tokenizer
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
    max_tokens: int = 512  # budget for SAMPLED tokens
    json_only: bool = False  # constrained decoding: not ported yet
    forced_prefix: tuple = ()  # teacher-forced prefix: not ported yet


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


@dataclass
class _Slot:
    request: _Request
    generated: list[int] = field(default_factory=list)
    prompt_len: int = 0
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
        self.tokens_generated = 0
        self.table_uploads = 0
        self.sheds = 0

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
        timeout_s: Optional[float] = None,
    ) -> Future:
        """Thread-safe; returns a Future[GenerationResult]. ``timeout_s``
        fails the request fast (DeadlineExceededError) if it is still queued
        when the deadline passes."""
        s = sampling or SamplingParams()
        if s.json_only or s.forced_prefix:
            raise ValueError(
                "json_only / forced_prefix (constrained decoding) is not yet "
                "supported by the torch engine"
            )
        tokens = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        # keep the prompt's TAIL and leave room to generate
        reserve = min(s.max_tokens, max(1, self.max_ctx // 2))
        budget = max(1, self.max_ctx - reserve)
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
        )
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
            "mesh": self.group.axes() if self.group is not None else {"tp": 1},
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

    def _pages_needed(self, req: _Request) -> int:
        """Pages for the whole generation: the prompt plus max_tokens,
        capped at the context (decode never allocates)."""
        rows = min(len(req.prompt) + req.sampling.max_tokens, self.max_ctx)
        return -(-rows // self.page_size)

    def _fill_slots(self) -> bool:
        admitted = False
        while self._waiting and self._free:
            group = self._collect_group()
            if not group:
                break  # the head can't get pages yet; FIFO, it waits
            admitted = True
            for _req, slot, pages in group:
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

    def _prefill_group(self, chunk: list[tuple[_Request, int, list[int]]]) -> None:
        """One batched prefill for B reserved requests, then first-token
        sampling and one host read of the sampled tokens."""
        B = len(chunk)
        P = self.page_size
        bucket = max(_next_bucket(len(r.prompt), self.prefill_buckets) for r, _, _ in chunk)
        tokens = np.zeros((B, bucket), dtype=np.int64)
        lengths = np.zeros(B, dtype=np.int64)
        page_ids = np.full((B, bucket // P), TRASH_PAGE, dtype=np.int64)
        temps = np.zeros(B, dtype=np.float32)
        top_ks = np.zeros(B, dtype=np.int64)
        top_ps = np.ones(B, dtype=np.float32)
        for i, (req, _slot, pages) in enumerate(chunk):
            plen = len(req.prompt)
            tokens[i, :plen] = req.prompt
            lengths[i] = plen
            n = -(-plen // P)  # prompt pages; the rest of the row is trash
            page_ids[i, :n] = pages[:n]
            s = req.sampling
            temps[i], top_ks[i], top_ps[i] = s.temperature, s.top_k, s.top_p
        self.cache, logits = prefill_paged_batch(
            self.params, self.cache, self._upload(tokens), self._upload(lengths),
            self._upload(page_ids), self.config, group=self.group,
        )
        firsts = sample(
            logits, self._gen, self._upload(temps), self._upload(top_ks), self._upload(top_ps)
        ).cpu().numpy()
        now = time.monotonic()
        self._state_dirty = True
        for i, (req, slot, _pages) in enumerate(chunk):
            s = req.sampling
            first = int(firsts[i])
            if req.first_token_at == 0.0:
                req.first_token_at = now
            sl = _Slot(request=req, prompt_len=len(req.prompt), first_token_at=req.first_token_at)
            sl.generated.append(first)
            self._slots[slot] = sl
            self._seq_lens[slot] = len(req.prompt)
            self._last_tokens[slot] = first
            self._temps[slot] = s.temperature
            self._top_ks[slot] = s.top_k
            self._top_ps[slot] = s.top_p
            if first in self.tokenizer.stop_tokens or len(sl.generated) >= s.max_tokens:
                self._finish(slot, "stop" if first in self.tokenizer.stop_tokens else "length")

    def _slot_budget(self, slot: int, sl: _Slot) -> int:
        """Sampled tokens this slot may still emit: the smaller of its
        remaining max_tokens and the context edge."""
        token_left = sl.request.sampling.max_tokens - len(sl.generated)
        ctx_left = self.max_ctx - 1 - int(self._seq_lens[slot])
        return max(0, min(token_left, ctx_left))

    def _ensure_dev_state(self) -> dict:
        """The device-resident decode carry (tokens, seq_lens, budgets,
        active) and its per-slot constants. Re-uploaded from the host
        mirrors only when slot assignment changed; otherwise the previous
        block's carry feeds the next block directly."""
        if self._state_dirty or self._dev is None:
            max_active = max(self._slots) + 1
            W = next(w for w in self.width_buckets if w >= max_active)
            active = np.zeros(W, dtype=bool)
            for slot, sl in self._slots.items():
                active[slot] = True
                self._budgets[slot] = self._slot_budget(slot, sl)
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
            }
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
        steps = []
        for _ in range(self.decode_block_size):
            self.cache, logits = decode_step_paged(
                self.params, self.cache, tokens, seq_lens, d["block_tables"], active, self.config,
                group=self.group,
            )
            nxt = sample(logits, self._gen, d["temps"], d["top_ks"], d["top_ps"])
            nxt = torch.where(active, nxt, tokens)
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
        for tok in toks:
            tok = int(tok)
            self._seq_lens[slot] += 1
            self._last_tokens[slot] = tok
            sl.generated.append(tok)
            self.tokens_generated += 1
            if tok in self.tokenizer.stop_tokens:
                done = "stop"
                break
            if len(sl.generated) >= s.max_tokens or self._seq_lens[slot] + 1 >= self.max_ctx:
                done = "length"
                break
        if done is not None:
            self._finish(slot, done)

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
        self._state_dirty = True  # the lane must be re-uploaded inactive
        self._applied.discard(req.rid)
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
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
