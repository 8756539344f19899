"""The serving engine of the port: continuous batching over the paged or
the slot KV cache, trimmed from ``agentcontrolplane_tpu/engine/engine.py``.

- **Two KV layouts** (``kv_layout``). ``paged`` (the port's default): a
  page pool with per-slot block tables, decoded by the hand-written CUDA
  walk; everything below is written for it. ``slot`` (the reference CLI's
  default, and ``run``'s): one contiguous row of ``max_ctx`` positions per
  slot, ``[L, S, C, H_kv, d]``, read whole and masked at seq_len by plain
  torch attention (the reference leaves it to XLA). It reserves no pages,
  so it never preempts under pressure (only the ``engine.force_preempt``
  fault does); chunks need no page alignment (the autopilot's and the host
  tier's minimum is 8 rows); a prefix-cache entry is a device copy of its
  rows (``prefix_extract[cut]``, copied into the next hit's slot as
  ``prefix_copy[cut]``); a parked slot lends its whole prompt; host-tier
  copies are pow2 row slices (``swap_extract[n]``, ``swap_restore[m]``,
  blocking, without prefetch); dedup is off; a padding lane starts at
  ``max_ctx`` so its writes clamp to the never-read row C-1; and the fused
  cycle dispatches plain finals ahead of it (a padded plain lane would
  write rows of slot 0). Under a serving group the slot layout raises
  (ROADMAP A.14).

- One **engine thread** owns the device state (params, page pools, the
  decode carry). Requests arrive on a thread-safe queue and resolve
  ``concurrent.futures.Future``s.
- **Admission** is strict FIFO. A request reserves a slot and the KV
  pages of its prefill row only (prompt + forced prefix); when the pool
  cannot cover the head of the queue, parked slots and then prefix-cache
  entries yield, and otherwise it waits there (backpressure). Admitted
  requests prefill in batches of up to ``prefill_batch_max`` rows, padded
  to a page-multiple bucket, pad pages routed to ``TRASH_PAGE``, and
  sample their first token.
- **KV reuse across an agent's turns** (the reference's defaults):
  - the **prefix cache** (``prefix_cache_entries`` / ``_max_tokens``):
    after a prefill, an LRU entry takes a reference on the row's leading
    whole prompt pages (zero copy, ``PageAllocator.share``); a later row
    extending that prefix borrows the pages and prefills only its suffix
    (``prefill_paged_continue``). Every cut is page-aligned and below the
    row's last token;
  - **parked slots** (``submit(park=True)``, ``park_max_s``): a finished
    turn resolves its future but keeps its slot and prompt pages, so the
    conversation's next turn adopts the slot in place and prefills only
    its suffix. Parked slots yield first under pressure and expire
    unclaimed; under a serving ``group`` parking is off (expiry reads the
    wall clock, which would fork the ranks);
  - **shared-prefix dedup** (``prefix_dedup``, on by default): a row whose
    page-aligned prefix matches a live slot's row (or an earlier member of
    its admission group) shares that slot's pages instead of writing a
    private copy, so N Tasks of one Agent hold one copy of its system
    prompt. The follower is admitted as a prefilling slot and waits until
    its leader has written the shared rows; a leader that leaves while
    still prefilling rewinds its followers to the rows it wrote, and they
    compute the rest themselves. Admission takes the reuse that covers the
    most rows, ties going to adoption, then the cache, then dedup;
  - **lazy page growth with preempt-and-resume**: before every decode
    block each slot's table must cover ``seq_len + K``; a slot that
    crosses a page grows by ``page_lookahead_blocks`` blocks of pages. A
    pool that runs short reclaims others' lookahead, releases parked
    slots, evicts cache entries and then preempts a victim (parked
    first, then fewest sampled tokens, so mid-prefill slots before any
    decoding one, ties to the most recently admitted): its sampled tokens
    are saved, its pages freed, and it is requeued at the front to resume
    with a prompt + partial prefill that streams nothing twice.
    ``GenerationResult.preempt_count`` counts it.
- **Shared pages** (the cache, dedup, adoption): a decode block never
  writes a page referenced more than once. A prefill writes one only while
  every other holder of it is itself still mid-prefill and has not
  written those rows: a dedup leader writing rows its waiting followers
  will read, or followers rewound after their leader left recomputing the
  same rows. No cache entry, parked slot or decoding slot ever holds a
  page that is written.
- **Chunked prefill under the token-budget scheduler** (``prefill_chunk``,
  ``token_budget``; both 0, off, by default as in the reference): with a
  chunk, admission only reserves the slot and its row's pages, and every
  loop cycle spends a token budget (auto: the decode block's tokens plus
  one chunk per prefilling slot) on prefill chunks, earliest deadline
  first, then the decode block, so one long prompt never stalls the
  decoding lanes for its whole prefill. At least one chunk advances per
  cycle. Mid chunks write KV only (``prefill_paged_continue_kv``); a final
  chunk samples the first token and the slot starts decoding. Chunk
  boundaries are page-aligned, the chunk is clamped to the largest prefill
  bucket, and a live toggle to 0 drains mid-prefill slots at that bucket.
  A prefilling slot's decode lane is inactive (its writes go to the trash
  page), it grows no pages, and a deadline or cancel mid-prefill releases
  its partial KV. With chunking off, a row longer than the largest bucket
  spills its head through KV-only continuations of that bucket before its
  last part prefills (``_spill_long_chunks``).
- **The chunk-rate planner** (``rate_planner``, on by default as in the
  reference; ``engine/planner.py``): a request with a deadline gets a
  quota of chunks per cycle, ceil(chunks left / cycles to its deadline)
  off an EWMA of busy cycles' wall time (``_cycle_clock``), so its chunk
  is quota x the base chunk (capped at the largest bucket). The plan is
  made at admission and remade at preempt -> resume and park -> adopt.
  Without a deadline, under a group and on followers the quota is 1.
- **The fused megastep** (``megastep``, on by default as in the
  reference): a cycle with prefill chunks only plans them; the decode
  site then runs the cycle's mid chunks, plain finals, continuation finals
  and decode block back to back on the cache (``_megastep_dispatch``),
  each phase ONE lane batch padded to a power of two (pad lanes write the
  trash page), with ONE host read for the finals' first tokens and
  automaton states and the block's tokens, where the split path
  dispatches and reads per pow2 batch. A final that fuses samples its
  first token inside the cycle and joins the next cycle's decode lanes.
  Lanes whose slot was preempted, cancelled or expired between planning
  and dispatch are dropped (``_validate_pending``). ``prefill_pos``
  advances at the commit, so a dedup follower never reads rows a fused
  cycle has not written. Each distinct phase set and shape is keyed as
  the reference keys its programs (``megastep[paged,m256x2+f512x1+d8x8]``);
  a new key past ``megastep_max_programs`` runs that cycle's split
  dispatches instead (``megastep_fallbacks``). In eager torch the fused
  cycle is one function of the same model calls; a CUDA graph per key is
  left to ROADMAP A.3.
- **Decode** runs K-step blocks at the smallest width bucket covering the
  live slots: every step runs ``decode_step_paged`` (the CUDA paged
  attention kernel in every layer on the card), samples, and detects
  finishes on the device (stop tokens, budgets, the context edge). The
  host reads the block's tokens once per block and commits them. Both
  dispatch sites are a device half and a commit half
  (``_prefill_device`` / ``_finish_prefill_dispatch``, ``_decode_block`` /
  ``_commit_decode_block``), shared by the split and the fused paths.
- **Speculative decoding** (``spec_len``, 0 = off by default as in the
  reference; ``spec_ngram``): before the block's page growth each live
  slot drafts up to ``min(its controller's cap, budget - 1)`` tokens by
  n-gram prompt lookup over its prompt + generated (``engine/spec.py``).
  When one drafts, its table grows to cover 1 + draft rows and ONE verify
  pass (``verify_paged_continue``, plain torch, then
  ``speculative_accept`` with the block's masking, stop and budget rules)
  replaces the K-step block: each slot commits the prefix the model agrees
  with plus one token, so greedy outputs are the engine's without
  speculation. A pass counts one decode step. In a fused cycle the pass
  takes the block's place (``v<W>x<T>`` in the shape key). When no slot
  drafts the plain block runs, the CUDA walk in every layer.
- **KV memory tiers**: the device page pool is the first tier; the
  **host-RAM tier** (``host_kv_bytes``, 0 = off by default as in the
  reference; ``ops/paged.py::HostKVPool``) is the second. A preemption,
  a parked slot released by pressure or expiry, and a mid-prefill
  deadline drop copy the slot's written rows (a page-aligned strict
  prefix of its row, gathered in pow2 page groups, one device -> host
  copy joined on one event) into a pinned host entry instead of
  discarding them. Admission matches an entry by the request's rid
  (preempt -> resume) or by the longest token prefix (a conversation or
  persona that comes back), at the lowest priority after adoption, the
  cache and dedup, and consumes it once the slot's fresh pages are
  reserved; the slot then enters the prefilling path (chunking on or
  off) and its rows restore chunk by chunk under the token budget, EDF
  with the prefill chunks, before model chunks prefill the rest. With
  ``host_prefetch`` (on by default) the NEXT restore chunk's rows go
  host -> device on a side stream while the cycle computes, and its
  scatter lands in the next cycle, first in a fused megastep (the
  ``s<m>-<m>...`` part of its key). Restored rows are a bit-exact copy
  (int8 pools with their f32 scale twins), so greedy outputs are the
  tier-off engine's. ``submit(export_kv=True)`` attaches the prompt's
  rows to the result as ``kv_handoff`` (the prefill -> decode handoff
  unit), and ``inject_host_kv`` lands such an entry in this engine's
  tier before the next admission.
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

- **Observability and robustness**: the flight recorder (``self.flight``,
  ``observability/flight.py``) records every scheduling decision per
  request (submit, admit, prefill chunks and rounds, prefill_done, decode
  blocks, verify passes, preempt, park, adopt, swaps, expire, cancel,
  finish, crash, restart), so each request's wall splits into
  ``queue_wait`` / ``prefill`` / ``decode`` / ``preempt_stall`` /
  ``host_stall`` / ``tool_overlap_hidden``, exported as histograms and as
  child spans of ``submit(trace=)``'s context. The dispatch profiler
  (``self.profiler``, ``observability/profiler.py``) times every dispatch
  by the reference's program keys and keeps the goodput/waste ledger. The
  fault sites of ``faults.py`` sit where the reference's do; the armed
  invariant checker (``check_invariants`` or ``$ACP_INVARIANTS``,
  ``engine/invariants.py``) audits the host bookkeeping after every busy
  cycle; the stall watchdog counts cycles over ``stall_mult`` x the
  fastest busy cycle and ``stall_min_s``; the brownout ladder
  (``brownout``, ``engine/brownout.py``) and the autopilot (``autopilot``,
  ``engine/planner.py``) step knobs from pressure and from the recorder's
  phase summaries. Under a serving group brownout and the autopilot are
  forced off (they read wall clocks), and the recorder and profiler only
  record: no decision reads them.

Left out for now (each is in ROADMAP): speculative decoding and the host
KV tier under a serving group (``spec_len > 0`` or ``host_kv_bytes > 0``
with ``group`` raises), fleet affinity (``affinity_key=``), prewarm, the
fleet fault sites, and multi-host.
"""

from __future__ import annotations

import contextlib
import hashlib
import heapq
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.llama import (
    PRESETS,
    LlamaConfig,
    check_supported,
    decode_step,
    decode_step_paged,
    init_kv_cache,
    init_paged_cache,
    prefill_batch,
    prefill_continue,
    prefill_continue_kv,
    prefill_paged_batch,
    prefill_paged_continue,
    prefill_paged_continue_kv,
    verify_continue,
    verify_paged_continue,
)
from ..faults import FAULTS
from ..observability.flight import FlightRecorder, phase_summaries
from ..observability.metrics import REGISTRY
from ..observability.profiler import DispatchProfiler
from ..ops.cuda import paged_attention as walk
from ..ops.paged import TRASH_PAGE, HostKVEntry, HostKVPool, PageAllocator
from ..ops.quant import QUANTIZABLE, QuantizedTensor, quantize_stacked
from ..ops.sampling import advance_constraint, constrain_logits, sample, speculative_accept
from ..parallel.mesh import ServingGroup, ServingMesh, check_serving_config
from .constrain import build_token_table
from .coordination import FrameChannel, deserialize_request
from .brownout import LADDER, BrownoutController, BrownoutPolicy
from .invariants import check_engine_invariants
from .planner import Autopilot, AutopilotLimits, CycleClock, project_quota
from .spec import SpecState, ngram_propose
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
    # times this request was preempted under KV pool pressure and resumed;
    # preemption is invisible in the output, this is its only trace
    preempt_count: int = 0
    # with submit(export_kv=True): the prompt's written KV, rows [0, cut)
    # page-aligned, as a HostKVEntry a decode engine restores through
    # inject_host_kv; None when the export was skipped (too few rows, a
    # truncated prompt, a dedup follower)
    kv_handoff: Optional[HostKVEntry] = None


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
    # park at a normal finish: keep the slot and its prompt KV so the
    # conversation's next turn prefills only its suffix (Engine._park)
    park: bool = False
    # preempt-and-resume: the tokens already SAMPLED (past any forced
    # prefix) before a preemption freed the slot; the resumed prefill row is
    # prompt + forced prefix + these, so decode continues where it stopped
    resume_tokens: list[int] = field(default_factory=list)
    preempt_count: int = 0
    # prefill -> decode handoff: at a stop or length finish the prompt's KV
    # rides out on the result (GenerationResult.kv_handoff); never parks
    export_kv: bool = False
    # the caller's span context (trace_id, span_id): the flight recorder
    # exports the request's phase windows as child spans under it
    trace: Optional[object] = None

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
    admit_seq: int = 0  # admission order (the victim policy's tie-break)
    # parked: the future resolved, the slot lingers with its prompt KV for
    # the conversation's next turn; it never decodes, yields first under
    # pressure, and expires after park_max_s
    parked: bool = False
    parked_at: float = 0.0
    park_cut: int = 0  # KV rows valid for adoption (page-aligned)
    # chunked prefill: the slot and its row's pages are reserved but only
    # ``prefill_pos`` rows of KV are written; the scheduler advances it a
    # chunk a cycle and it never decodes until its final chunk. Preempting
    # it loses no sampled token. ``prefill_row`` is its ``_full_row``
    # (kept after the final chunk while dedup is on: the leader scan reads
    # it)
    prefilling: bool = False
    prefill_pos: int = 0
    prefill_row: Optional[list] = None
    # a dedup follower: (leader slot, leader rid, cut) — rows [0, cut) are
    # the leader's pages; it dispatches no chunk until the leader has
    # written them. None once the wait is over
    share_of: Optional[tuple] = None
    # the rate planner's chunks per cycle (engine/planner.py): its chunk is
    # quota x the base chunk; 1 without a deadline or under a group
    chunk_quota: int = 1
    # speculative decoding: the adaptive draft-length controller (None with
    # spec_len 0), host-only, rebuilt fresh at every (re-)admission; and the
    # drafter's view of prompt + generated, synced by appending (_slot_ctx)
    spec: Optional[SpecState] = None
    ctx_buf: Optional[np.ndarray] = None
    ctx_len: int = 0
    # host-tier restore: the HostKVEntry whose rows are restored into this
    # slot's fresh pages a chunk a cycle under the token budget; cleared at
    # the restore's cut, after which model chunks prefill the rest.
    # swap_stall_s sums the engine-thread seconds blocked in restore copies
    swap_entry: Optional[HostKVEntry] = None
    swap_stall_s: float = 0.0
    # host_prefetch: the NEXT restore chunk's rows already on their way to
    # the device, {"start", "n", "groups": [(page ids, {name: blocks})],
    # "event"} in the pow2 page groups the blocking copy scatters; the
    # commit scatters them next cycle. Holding them here keeps them alive
    # until then; a slot that leaves drops them unscattered
    swap_staged: Optional[dict] = None


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


def _live_start(lengths: np.ndarray, starts: np.ndarray) -> int:
    """The largest start among lanes with tokens (a padding lane starts at
    max_ctx): the slot rows a continuation reads, taken from the host lane
    arrays so the dispatch reads nothing back from the device."""
    return int(np.where(lengths > 0, starts, 0).max(initial=0))


def _pow2_sizes(n: int) -> list[int]:
    """Greedy power-of-two decomposition (7 -> [4, 2, 1]): the host tier's
    page groups, so no group pads past real rows."""
    out: list[int] = []
    b = 1
    while b * 2 <= n:
        b *= 2
    while n:
        while b > n:
            b //= 2
        out.append(b)
        n -= b
    return out


def _pow2(n: int) -> int:
    """The smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


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
        # prefix cache: LRU entries of refcounted prompt pages; 0 disables.
        # The token bound counts distinct pages (entries of one growing
        # conversation share theirs)
        prefix_cache_entries: int = 4,
        prefix_cache_max_tokens: int = 4096,
        # decode blocks of pages a slot grows by when it crosses a page, so
        # its block table is not re-uploaded every block
        page_lookahead_blocks: int = 8,
        # parked slots (submit(park=True)) expire after this long unclaimed;
        # 0 disables parking. Forced to 0 under a serving group
        park_max_s: float = 30.0,
        # chunked prefill: > 0 splits every prefill into chunks of at most
        # this many tokens (rounded up to a page, clamped to the largest
        # bucket), co-scheduled with decode blocks; 0 = the whole prefill
        # at admission
        prefill_chunk: int = 0,
        # tokens a loop cycle spends on prefill chunks and the decode
        # block; 0 = auto (the decode block's tokens + one chunk per
        # prefilling slot). Decode always runs and one chunk always
        # advances, so it throttles prefill without starving either side
        token_budget: int = 0,
        # shared-prefix dedup: a row whose page-aligned prefix matches a
        # live slot's row shares its pages instead of writing a copy
        prefix_dedup: bool = True,
        # speculative decoding (engine/spec.py): > 0 drafts up to this many
        # tokens a slot by n-gram prompt lookup over prompt + generated and
        # scores them all in ONE verify pass, which commits the prefix the
        # model agrees with plus one token; greedy outputs are the engine's
        # without it. 0 = off. A plain attribute (set it while idle)
        spec_len: int = 0,
        spec_ngram: int = 3,  # longest n-gram the drafter matches on
        # the fused megastep: a cycle with prefill chunks runs its mid
        # chunks, final chunks and decode block as one lane batch per phase
        # with one host read, instead of one dispatch per pow2 batch and a
        # host read for each; greedy outputs are the split path's. False =
        # the split dispatches
        megastep: bool = True,
        # bound on distinct fused shapes (chunk bucket x batch x decode
        # width x phase set); a new shape past it runs the split
        # dispatches for that cycle. 0 = never fuse
        megastep_max_programs: int = 32,
        # the chunk-rate planner: a request with a deadline gets a
        # per-cycle quota of chunks (tokens left / cycles to its deadline),
        # reprojected at preempt -> resume and park -> adopt; inert without
        # deadlines and under a group (the leader's wall clock)
        rate_planner: bool = True,
        planner_max_quota: int = 8,  # chunks per slot per cycle, at most
        # the scheduler autopilot (engine/planner.py): every
        # autopilot_interval busy cycles, step prefill_chunk / token_budget
        # / spec_len once from the flight recorder's phase summaries, the
        # budget utilization and the spec acceptance. Forced off under a
        # group (wall-clock inputs would fork the ranks)
        autopilot: bool = False,
        autopilot_interval: int = 128,
        # the stall watchdog: a busy cycle over stall_mult x the fastest
        # busy cycle seen AND over stall_min_s records a `stall` event and
        # counts in acp_engine_stalls_total. Observation only
        stall_mult: float = 8.0,
        stall_min_s: float = 0.25,
        # the brownout ladder (engine/brownout.py): under shed or stall
        # pressure, step spec_len -> park acceptance -> chunk quota down one
        # rung per interval, and back up when it lifts. Forced off under a
        # group
        brownout: bool = False,
        brownout_interval: int = 64,
        # the armed invariant checker (engine/invariants.py) after every
        # busy cycle; None reads $ACP_INVARIANTS
        check_invariants: Optional[bool] = None,
        # the host-RAM KV tier (ops/paged.py HostKVPool): > 0 bounds a host
        # pool that preemption, park expiry and mid-prefill deadline drops
        # copy their written rows into instead of discarding them; a later
        # admission restores them (a bit-exact copy) instead of re-running
        # the prefill. 0 = off. Greedy outputs are equal on or off
        host_kv_bytes: int = 0,
        # stage the next restore chunk's host -> device copy a cycle early
        # on a side stream; False = the blocking copy. Equal outputs either
        # way; only swap_stall_s moves
        host_prefetch: bool = True,
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
        # "paged" (the page pool the CUDA walk reads) or "slot" (one
        # contiguous row of max_ctx per slot, plain torch attention, the
        # reference CLI's default). The port's default is paged: its
        # decode runs the hand-written walk
        kv_layout: str = "paged",
    ):
        if kv_layout not in ("slot", "paged"):
            raise ValueError(f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        if kv_layout == "slot" and group is not None:
            raise ValueError("kv_layout='slot' under a serving group is not ported yet: the "
                             "slot cache shards over tp heads and the sp ctx dim (ROADMAP A.14)")
        if spec_len > 0 and group is not None:
            raise ValueError("spec_len > 0 under a serving group is not ported yet: the verify "
                             "pass's per-token commit on sp ranks (ROADMAP A.14)")
        if host_kv_bytes > 0 and group is not None:
            raise ValueError("host_kv_bytes > 0 under a serving group is not ported yet: each "
                             "rank holds a slice of every page, so entries, budgets and the "
                             "handoff need their own design (ROADMAP A.14)")
        self.device = resolve_device(device)
        if isinstance(config, str):
            config = PRESETS[config]
        check_supported(config)
        self.config = config
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_slots = max_slots
        self.max_ctx = min(max_ctx, config.max_seq_len)
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self.page_size = page_size
        check_serving_config(config, group, page_size, self.max_ctx)
        # the reference's rule: a row longer than the largest bucket spills
        # through continuations of that bucket (_spill_long_chunks)
        buckets = sorted({b for b in prefill_buckets if b <= self.max_ctx}) or [self.max_ctx]
        if self._paged:
            if self.max_ctx % page_size:
                raise ValueError(f"page_size {page_size} must divide max_ctx {self.max_ctx}")
            bad = [b for b in buckets if b % page_size]
            if bad:
                raise ValueError(
                    f"prefill buckets {bad} are not multiples of page_size {page_size}")
        self.prefill_buckets = buckets
        self.prefill_batch_max = max(1, prefill_batch_max)
        self.width_buckets = sorted({w for w in width_buckets if 0 < w < max_slots} | {max_slots})
        self.decode_block_size = max(1, decode_block_size)
        self.max_queue = max(0, max_queue)
        if self._paged:
            self.max_pages_per_seq = self.max_ctx // page_size
            self.num_pages = kv_pages or (max_slots * self.max_pages_per_seq + 1)
        self.page_lookahead_blocks = max(1, page_lookahead_blocks)
        self.group = group
        # the prefix cache and preemption read no clock, so every rank of a
        # group takes the same decisions from the same frames; parking's
        # expiry reads the wall clock, so it is off in a group
        self._prefix_enabled = prefix_cache_entries > 0
        self._prefix_cache_entries = prefix_cache_entries
        self._prefix_cache_max_tokens = prefix_cache_max_tokens
        self._prefix_lock = threading.Lock()  # the engine thread writes, stats() reads
        self.park_max_s = 0.0 if group is not None else max(0.0, park_max_s)
        # chunked prefill and dedup: plain attributes read every cycle and
        # admission, so a live engine can A/B them
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.token_budget = max(0, int(token_budget))
        self.prefix_dedup = bool(prefix_dedup)
        # the megastep and the planner: plain attributes too (A/B on a live
        # engine); ``_megastep_shapes`` holds the fused shapes' keys
        self.megastep = bool(megastep)
        self.megastep_max_programs = max(0, int(megastep_max_programs))
        self._megastep_shapes: set[str] = set()
        self.megastep_dispatches = 0
        self.megastep_fallbacks = 0  # fused cycles split-dispatched (the shape bound)
        self.rate_planner = bool(rate_planner)
        self.planner_max_quota = max(1, int(planner_max_quota))
        self._cycle_clock = CycleClock()  # busy cycles' wall time (EWMA)
        self.quota_projections = 0  # rate plans made (admission and reprojection)
        self.quota_reprojections = 0  # of them at resume or adoption
        self.spec_len = max(0, int(spec_len))
        self.spec_ngram = max(1, int(spec_ngram))
        self.spec_proposed = 0  # draft tokens sent to verification
        self.spec_accepted = 0  # draft tokens the model agreed with
        self.spec_dispatches = 0  # verify dispatches
        # the host KV tier: the pool is engine-thread owned; stats() reads
        # the mirror ints. Entries are pinned when serving on CUDA
        self.host_kv_bytes = max(0, int(host_kv_bytes))
        self._host_pool = HostKVPool(self.host_kv_bytes) if self.host_kv_bytes else None
        self.host_prefetch = bool(host_prefetch)  # read per restore chunk
        self._pin = self.device.type == "cuda"
        self._swap_stream = None  # the prefetch's side stream, made at first use
        # handoff entries from any thread, landed in the pool by the engine
        # thread at the top of _fill_slots, before admission matching
        self._kv_inject: "queue.Queue[HostKVEntry]" = queue.Queue()
        self.kv_injects = 0  # handoff entries landed in the host pool
        self.kv_swap_outs = 0  # entries offloaded to the host tier
        self.kv_swap_ins = 0  # restores completed
        self.kv_prefetch_commits = 0  # restore chunks landed from a staged copy
        self._host_kv_used = 0  # mirrors of the pool
        self._host_kv_entries = 0
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
        # the autopilot, the watchdog and the brownout ladder
        self.autopilot_enabled = bool(autopilot) and group is None
        self._autopilot = Autopilot(
            AutopilotLimits(
                chunk_min=page_size if self._paged else 8,
                chunk_max=self.prefill_buckets[-1],
                budget_max=4 * max_slots * self.decode_block_size + 4 * self.prefill_buckets[-1],
                spec_len_max=16,
            ),
            interval=autopilot_interval,
        ) if self.autopilot_enabled else None
        self.stall_mult = float(stall_mult)
        self.stall_min_s = float(stall_min_s)
        self.stalls = 0  # busy cycles the watchdog judged stalled
        self._cycle_s = 0.0  # the cycle clock's EWMA, mirrored for stats()
        # the fastest busy cycle seen: the stall baseline (one-sided, so a
        # slow cycle never raises it)
        self._cycle_floor = 0.0
        self.brownout_enabled = bool(brownout) and group is None
        self._brownout = BrownoutController(
            BrownoutPolicy(interval=max(1, int(brownout_interval)))
        ) if self.brownout_enabled else None
        self._brownout_level = 0  # the applied rung
        self._brownout_saved: dict = {}  # knob -> its value before the rung
        # fault sites (faults.py), each guarded by the plain bool
        # FAULTS.enabled; the flight recorder and the profiler (public: the
        # REST routes and the CLI read them through their own methods);
        # the armed audit
        self._faults = FAULTS
        self.flight = FlightRecorder()
        self.profiler = DispatchProfiler(flight=self.flight)
        self.check_invariants = (
            bool(check_invariants) if check_invariants is not None
            else os.environ.get("ACP_INVARIANTS", "") not in ("", "0")
        )

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
        REGISTRY.gauge_set("acp_engine_weight_bytes", float(self.weight_bytes),
                           help="per-device bytes held by model weights as served, max "
                           "across local devices (int8 values + scales under "
                           "quantize_weights, bf16 otherwise)")
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
        self.prefill_tokens = 0  # rows run through the model at prefill (suffixes on reuse)
        self.tokens_generated = 0
        self.table_uploads = 0
        self.sheds = 0
        self.tool_calls_early = 0
        self.tool_overlap_saved_s = 0.0
        self.preemptions = 0  # pool-pressure preempt-and-resume events
        self.parks = 0  # slots parked at generation end
        self.park_adoptions = 0  # parked slots adopted by a follow-up turn
        self.park_releases = 0  # parked slots released (pressure, expiry, stop)
        self._prefix_hits = 0
        self._prefix_misses = 0
        self.prefix_shares = 0  # admissions that shared a dedup leader's pages
        self.prefill_chunks = 0  # chunks dispatched (one per slot per cycle)
        self.hol_wait_s = 0.0  # seconds decoding slots waited behind prefill
        # (budget, tokens spent) of the last cycle, replaced as a whole so a
        # stats() read is never torn; and both summed over every cycle
        self._budget_last = (0, 0)
        self._budget_spent_total = 0
        self._budget_total = 0

    def _init_kv_state(self) -> None:
        """(Re)build the KV cache (the page pools, or the slot rows) and the
        host bookkeeping — shared by __init__ and crash recovery. The slot
        layout has no allocator, page lists or block tables."""
        if self._paged:
            self.cache = init_paged_cache(
                self.config, self.num_pages, self.page_size, device=self.device,
                quantize_kv=self.quantize_kv, group=self.group,
            )
            self._allocator = PageAllocator(self.num_pages, track_scales=self.quantize_kv)
            self._slot_pages: dict[int, list[int]] = {}
            self._block_tables = np.full(
                (self.max_slots, self.max_pages_per_seq), TRASH_PAGE, dtype=np.int32
            )
        else:
            self.cache = init_kv_cache(self.config, self.max_slots, self.max_ctx,
                                       device=self.device, quantize_kv=self.quantize_kv)
        self.pool_bytes = sum(t.numel() * t.element_size() for t in self.cache.values())
        # prompt-prefix tokens -> an entry, LRU order: {"cut", "pages"}
        # holding one reference on its pages (paged), or {"cut", "k", "v",
        # ...} holding a device copy of the rows (slot)
        with self._prefix_lock:
            self._prefix_cache: OrderedDict[tuple, dict] = OrderedDict()
        self._slots: dict[int, _Slot] = {}
        self._parked_count = 0  # slots in _slots with parked=True
        self._prefilling_count = 0  # slots in _slots with prefilling=True
        self._admit_seq = 0
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
        self._tables_dirty = True  # block tables changed (pages appended or freed)
        # a fused cycle's chunk lanes, planned by _prefill_chunks and
        # dispatched by the decode site of the same cycle (_decode_once)
        self._fuse_pending: Optional[dict] = None

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
                self._publish_park_gauge()
                self._waiting.clear()
                self._cancelled.clear()
                self._crashed = False
                self._stopping = False
                self._thread = threading.Thread(target=self._run, name="torch-engine", daemon=True)
                self._thread.start()
                REGISTRY.counter_add("acp_engine_restarts_total", 1.0,
                                     help="engine loops rebuilt and restarted after a crash")
                self.flight.record("restart")
                return True
            return self._thread is not None and self._thread.is_alive()

    def submit(
        self,
        prompt: str | list[int],
        sampling: Optional[SamplingParams] = None,
        on_tokens=None,
        timeout_s: Optional[float] = None,
        on_tool_call=None,
        park: bool = False,
        export_kv: bool = False,
        trace=None,
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
        ``future.admitted`` completes when the request takes a slot.

        ``park=True`` keeps the slot parked after a normal finish, holding
        the prompt's KV, so the conversation's next turn (a prompt that
        extends this one) adopts it and prefills only its suffix. It
        changes when KV is computed, never what is generated; a truncated
        prompt (its tail kept) never parks.

        ``export_kv=True`` (prefill -> decode disaggregation) copies the
        prompt's written KV out at a stop or length finish and attaches it
        to the result as ``GenerationResult.kv_handoff``, a
        ``HostKVEntry`` another engine restores through
        :meth:`inject_host_kv`. It supersedes parking.

        ``trace`` (a span context: ``trace_id`` / ``span_id`` attributes or
        keys) parents the request's phase spans when the flight recorder
        has a tracer."""
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
            park=bool(park) and self.park_max_s > 0 and not truncated and not export_kv,
            export_kv=bool(export_kv),
            trace=trace,
        )
        if on_tool_call is not None:
            req.tool_parser = ToolStreamParser()
        req.future.early_tool_calls = req.early_calls  # type: ignore[attr-defined]
        req.future.admitted = req.admitted  # type: ignore[attr-defined]
        req.future.rid = req.rid  # type: ignore[attr-defined]  # cancel() keys on it
        if export_kv and self.group is not None:
            req.future.set_exception(ValueError(
                "export_kv under a serving group is not ported yet: each rank holds a slice "
                "of every page (ROADMAP A.14)"))
            return req.future
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
        # the persona fingerprint trace export groups requests by: a hash of
        # the first 64 prompt tokens, no prompt content
        persona = hashlib.sha1(
            repr(tokens[:64]).encode()).hexdigest()[:16] if self.flight.enabled else ""
        self.flight.record("submit", rid=req.rid, prompt_tokens=len(tokens),
                           timeout_s=timeout_s, park=req.park, key=persona)
        forced_full = self._faults.enabled and self._faults.pop("engine.queue_full") is not None
        depth = self._queue.qsize() + len(self._waiting)
        if forced_full or (self.max_queue and depth >= self.max_queue):
            self.sheds += 1
            REGISTRY.counter_add("acp_engine_shed_requests_total", 1.0,
                                 help="requests shed at admission (bounded queue or fault)")
            self.flight.record("shed", rid=req.rid, depth=depth)
            req.future.set_exception(EngineOverloadedError(
                f"admission queue full ({depth} waiting, cap {self.max_queue}); retry later",
                retry_after_s=max(1.0, min(30.0, depth * 0.25)),
            ))
            self.flight.discard(req.rid)  # the timeline ends at the shed
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
        out = {
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
            "kv_layout": self.kv_layout,
            "max_slots": self.max_slots,
            "max_ctx": self.max_ctx,
            "active_slots": self._n_active(),
            "parked_slots": self._parked_count,
            "prefilling_slots": self._prefilling_count,
            "waiting": len(self._waiting) + self._queue.qsize(),
            "max_queue": self.max_queue,
            # the gray-failure signals: the cycle clock's EWMA, the
            # watchdog's stalls, admission sheds, and the ladder's rung
            "cycle_s": round(self._cycle_s, 6),
            "stalls": self.stalls,
            "sheds": self.sheds,
            "brownout": {
                "enabled": self.brownout_enabled,
                "level": self._brownout_level,
                "steps_down": self._brownout.steps_down if self._brownout is not None else 0,
                "steps_up": self._brownout.steps_up if self._brownout is not None else 0,
            },
            "preemptions": self.preemptions,
            "preempted_waiting": self._preempted_waiting(),
            "decode_block_size": self.decode_block_size,
            "decode_steps": self.decode_steps,
            "requests_prefilled": self.requests_prefilled,
            "prefill_tokens": self.prefill_tokens,
            "tokens_generated": self.tokens_generated,
            # a verify dispatch counts one step, however many tokens land
            "tokens_per_decode_step": (
                round(self.tokens_generated / self.decode_steps, 4) if self.decode_steps else 0.0
            ),
            "spec": {
                "enabled": self.spec_len > 0,
                "spec_len": self.spec_len,
                "ngram": self.spec_ngram,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": (
                    round(self.spec_accepted / self.spec_proposed, 4)
                    if self.spec_proposed else 0.0
                ),
                "verify_dispatches": self.spec_dispatches,
            },
            # the JSON constraint's token table on the device (0 until the
            # first constrained request builds it) and its host build time
            "constraint_table_bytes": self.constraint_table_bytes,
            "constraint_table_build_s": round(self.constraint_table_build_s, 4),
            "tool_calls_early": self.tool_calls_early,
            # the token-budget scheduler: utilization is tokens dispatched
            # over the cycle's budget (low: the budget is oversized; about
            # 1 with chunks waiting: prefill is throttled by it)
            "scheduler": {
                "chunked_prefill": self.prefill_chunk > 0,
                "prefill_chunk": self.prefill_chunk,
                "token_budget": self.token_budget,  # 0 = auto
                "prefill_chunks_total": self.prefill_chunks,
                "hol_wait_seconds": round(self.hol_wait_s, 4),
                "budget_utilization_last": (
                    round(min(1.0, self._budget_last[1] / self._budget_last[0]), 4)
                    if self._budget_last[0] else 0.0
                ),
                "budget_utilization_avg": (
                    round(min(1.0, self._budget_spent_total / self._budget_total), 4)
                    if self._budget_total else 0.0
                ),
                "megastep": {
                    "enabled": self.megastep,
                    "dispatches": self.megastep_dispatches,
                    "shapes": len(self._megastep_shapes),
                    "max_programs": self.megastep_max_programs,
                    "fallbacks": self.megastep_fallbacks,
                },
                "planner": {
                    "enabled": self.rate_planner,
                    "quota_projections": self.quota_projections,
                    "quota_reprojections": self.quota_reprojections,
                    "autopilot": self.autopilot_enabled,
                    "autopilot_adjustments": (
                        self._autopilot.adjustments if self._autopilot is not None else 0
                    ),
                },
            },
            "tool_overlap": {
                "early_calls": self.tool_calls_early,
                # per early call, seconds between its dispatch becoming
                # possible and its turn's generation finishing
                "overlap_saved_s": round(self.tool_overlap_saved_s, 4),
                "parks": self.parks,
                "park_adoptions": self.park_adoptions,
                "park_releases": self.park_releases,
                "park_max_s": self.park_max_s,
            },
            # this process's CUDA walk launches (all walks and forms, the
            # int8 walk, the state form); 0 while tensors are on the CPU
            "walk_launches": {
                "total": walk.LAUNCHES,
                "int8": walk.INT8_LAUNCHES,
                "state": walk.STATE_LAUNCHES,
            },
            # the memory tiers: the host-RAM tier's occupancy (mirror ints,
            # refreshed by _publish_memory_state) and dedup's payoff
            "memory": {
                "host_kv": {
                    "enabled": self.host_kv_bytes > 0,
                    "max_bytes": self.host_kv_bytes,
                    "used_bytes": self._host_kv_used,
                    "entries": self._host_kv_entries,
                    "swap_outs": self.kv_swap_outs,
                    "swap_ins": self.kv_swap_ins,
                    "injects": self.kv_injects,
                },
                "prefix_dedup": {
                    # dedup shares pages: it is paged-only
                    "enabled": self.prefix_dedup and self._paged,
                    "shares": self.prefix_shares,
                    # pages with more than one owner (dedup and the cache)
                    "shared_pages": self._allocator.shared_count if self._paged else 0,
                },
                # int8 KV cache: at a fixed byte budget the pool holds ~1.94x
                # the tokens (head_dim 128)
                "quantized_kv": {
                    "enabled": self.quantize_kv,
                    "pages": (self._allocator.allocated_count
                              if self.quantize_kv and self._paged else 0),
                },
            },
            # the recorder's occupancy and the profiler's per-program stats
            # and ledger (each through its own cross-thread read)
            "flight": self.flight.stats(),
            "perf": self.profiler.stats(),
        }
        if self._paged:
            out["kv_pages"] = {
                "total": self.num_pages - 1,
                "free": self._allocator.free_count,
                "page_size": self.page_size,
                "table_uploads": self.table_uploads,
            }
        if self._prefix_enabled:
            with self._prefix_lock:
                out["prefix_cache"] = {
                    "entries": len(self._prefix_cache),
                    "capacity": self._prefix_cache_entries,
                    "hits": self._prefix_hits,
                    "misses": self._prefix_misses,
                    # distinct pages the entries hold, in tokens
                    "cached_tokens": self._cached_tokens_locked(),
                }
        return out

    def _preempted_waiting(self) -> int:
        """Requeued-after-preemption requests waiting. They are requeued at
        the front and fresh arrivals append at the back, so they form a
        prefix of the queue. A racy cross-thread read: a deque mutated
        while it is read raises, and the count is then partial."""
        n = 0
        try:
            for r in self._waiting:
                if not r.preempt_count:
                    break
                n += 1
        except RuntimeError:
            pass
        return n

    def _n_active(self) -> int:
        """Slots decoding: parked slots linger without work, and
        mid-prefill slots have sampled nothing yet."""
        return len(self._slots) - self._parked_count - self._prefilling_count

    def _has_work(self) -> bool:
        """Slots the loop must advance: decoding or mid-prefill."""
        return len(self._slots) - self._parked_count > 0

    # -- engine loop -----------------------------------------------------

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                while not self._stopping:
                    admitted = self._admit(block=not self._has_work())
                    if self._stopping:
                        break
                    # the watchdog's window: everything from here to the
                    # check after the dispatch is one cycle's wall time,
                    # fault throttles included
                    t_cycle = time.monotonic()
                    # after _admit: a crash armed while the loop idles fires
                    # with the next request admitted but unresolved
                    if self._faults.enabled and self._faults.pop("engine.crash") is not None:
                        raise RuntimeError("fault injection: engine crash")
                    if self._faults.enabled and (admitted or self._has_work()):
                        # busy cycles only: the idle wakeups of _admit must
                        # not drain the times= budget before work arrives
                        slow = self._faults.pop("engine.slow_cycle")
                        if slow is not None:
                            time.sleep(float(slow.get("delay_s", 0.01)))
                    self._sweep_parked()
                    if not self._has_work() and not admitted:
                        self._publish_memory_state()
                        continue
                    if self._has_work():
                        self._dispatch_once()
                    self._stall_check(time.monotonic() - t_cycle)
                    # the mirrors before the audit, so it sees the cycle's end
                    self._publish_memory_state()
                    self.profiler.publish()
                    if self._autopilot is not None:
                        self._autopilot_tick()
                    if self._brownout is not None:
                        self._brownout_tick()
                    if self.check_invariants:
                        if (self._faults.enabled
                                and self._faults.pop("engine.invariant_break") is not None):
                            self._parked_count += 1  # a deliberate mirror corruption
                        check_engine_invariants(self)
        except Exception as e:  # an engine crash must not hang callers
            log.exception("engine loop crashed")
            # recorded and dumped BEFORE any state is torn down: the dump
            # shows the engine as the crash found it
            self.flight.record("crash", error=repr(e))
            self.flight.dump_crash(self, e)
            self._slots.clear()
            self._parked_count = 0
            self._prefilling_count = 0
            self._publish_park_gauge()
            self._stopping = True
            self._crashed = True
            REGISTRY.counter_add("acp_engine_crashes_total", 1.0,
                                 help="engine loops that died on an exception")
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
        # timelines the drain did not retire; the window keeps their events
        self.flight.discard_live()

    def _stall_check(self, dt: float) -> None:
        """The stall watchdog: ``dt`` is a busy cycle's wall time (fault
        throttles included). A cycle over ``stall_mult`` x the fastest busy
        cycle seen and over ``stall_min_s`` is a stall. The baseline is the
        minimum, so a slow cycle never masks later stalls. Also mirrors the
        cycle clock's EWMA for stats()."""
        self._cycle_s = self._cycle_clock.cycle_s
        if dt > 0 and (self._cycle_floor == 0.0 or dt < self._cycle_floor):
            self._cycle_floor = dt
        base = self._cycle_floor
        if base <= 0.0 or dt < self.stall_min_s or dt < self.stall_mult * base:
            return
        self.stalls += 1
        self.flight.record("stall", cycle_s=round(dt, 4), floor_s=round(base, 5))
        REGISTRY.counter_add("acp_engine_stalls_total", 1.0,
                             help="busy cycles the engine's watchdog judged stalled (wall time "
                             "over stall_mult x the fastest busy cycle and over stall_min_s)")

    def _brownout_tick(self) -> None:
        """The brownout ladder (``engine/brownout.py``): on interval
        boundaries judge the shed and stall pressure and move at most one
        rung. Down saves and sheds the next knob in ``LADDER`` order; up
        restores the last one. The controller decides; the engine applies
        the knob, records it and sets the gauge."""
        bo = self._brownout
        if bo is None or not bo.due():
            return
        target = bo.step(self.sheds, self.stalls)
        if target == self._brownout_level:
            return
        if target > self._brownout_level:
            knob, downed = LADDER[self._brownout_level]
            self._brownout_saved[knob] = getattr(self, knob)
            setattr(self, knob, downed)
            self._brownout_level += 1
            self.flight.record("brownout", level=self._brownout_level, **{f"set_{knob}": downed})
        else:
            knob, _ = LADDER[self._brownout_level - 1]
            restored = self._brownout_saved.pop(knob, getattr(self, knob))
            setattr(self, knob, restored)
            self._brownout_level -= 1
            self.flight.record("brownout", level=self._brownout_level,
                               **{f"set_{knob}": restored})
        REGISTRY.gauge_set("acp_engine_brownout_level", float(self._brownout_level),
                           help="the degradation ladder's rung (0 = full service; 1 = "
                           "speculation off; 2 = + park acceptance off; 3 = + chunk quota 1)")
        log.info("brownout level -> %d", self._brownout_level)

    def _autopilot_tick(self) -> None:
        """The scheduler autopilot (``engine/planner.py``): on interval
        boundaries the recorder's phase summaries (p99 per phase), the
        budget utilization and the spec acceptance steer the scheduling
        knobs one bounded step; each change is a flight event."""
        ap = self._autopilot
        if ap is None or not ap.due():
            return
        phases = {k: v.get("p99", 0.0) for k, v in phase_summaries().items()}
        util = self._budget_spent_total / self._budget_total if self._budget_total else 0.0
        acc = self.spec_accepted / self.spec_proposed if self.spec_proposed else None
        knobs = {"prefill_chunk": self.prefill_chunk, "token_budget": self.token_budget,
                 "spec_len": self.spec_len}
        changes = ap.step(phases, util, acc, knobs)
        if not changes:
            return
        for knob, value in changes.items():
            setattr(self, knob, value)
        self.flight.record("autopilot", **{f"set_{k}": v for k, v in changes.items()})
        REGISTRY.counter_add("acp_engine_autopilot_adjustments_total", 1.0,
                             help="scheduler-knob adjustments applied by the autopilot")
        log.info("autopilot adjusted knobs: %s", changes)

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
                    self.flight.record("cancel", rid=r.rid, where="queued")
                    self.flight.discard(r.rid)
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
            if not self._has_work():
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
            REGISTRY.counter_add("acp_engine_deadline_expired_total", 1.0,
                                 help="requests failed fast because their deadline passed")
            self._record_expire(r, "queued")
        if self._channel is not None:
            self._cancelled.update(r.rid for r in expired)
            return
        gone = {id(r) for r in expired}
        self._waiting = deque(r for r in self._waiting if id(r) not in gone)

    def _record_expire(self, req: _Request, where: str) -> None:
        """A deadline expiry ends the request's timeline."""
        self.flight.record("expire", rid=req.rid, where=where)
        self.flight.discard(req.rid)

    @staticmethod
    def _full_row(req: _Request) -> list[int]:
        """The tokens a request prefills: prompt + teacher-forced prefix,
        plus, after a preemption, everything it had sampled, so the resumed
        decode continues where it stopped."""
        return list(req.prompt) + list(req.sampling.forced_prefix) + list(req.resume_tokens)

    # -- prefix cache ----------------------------------------------------

    def _match_prefix(self, req: _Request) -> Optional[tuple]:
        """The longest entry whose key is a strict prefix of the row (at
        least one token must remain to give logits); touches it in the LRU."""
        full = self._full_row(req)
        with self._prefix_lock:
            best_key, best = None, None
            for key, entry in self._prefix_cache.items():
                cut = entry["cut"]
                if cut < len(full) and (best is None or cut > best["cut"]):
                    if tuple(full[:cut]) == key:
                        best_key, best = key, entry
            if best_key is None:
                return None
            self._prefix_cache.move_to_end(best_key)
            return best_key, best

    def _save_prefix(self, full: list[int], prompt_len: int, slot: int) -> None:
        """After a prefill, snapshot the slot's leading rows as an entry.
        Paged: a reference on the slot's leading whole pages (zero copy).
        Slot: a device copy of rows ``[0, cut)``, the cut at the largest
        bucket or largest-bucket multiple (so a long conversation stays
        reusable past one bucket). The cut never reaches past the PROMPT
        into the forced prefix (the next turn re-renders the assistant
        message, not the raw forced tokens, so such a key could never match
        again) nor to the row's last token, so no entry's page is written
        again."""
        if not self._prefix_enabled:
            return
        cap = min(prompt_len, len(full) - 1)
        if self._paged:
            cut = (cap // self.page_size) * self.page_size
        else:
            cut = max([0] + [b for b in self.prefill_buckets if b <= cap])
            CH = self.prefill_buckets[-1]
            cut = max(cut, (cap // CH) * CH)
        if cut < min(self.prefill_buckets[0], 4 * self.page_size):
            return  # too short to be worth caching
        key = tuple(full[:cut])
        with self._prefix_lock:
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                return
        if self._paged:
            pages = self._slot_pages[slot][: cut // self.page_size]
            self._allocator.share(pages)
            entry = {"cut": cut, "pages": list(pages)}
        else:
            prof_t0 = self.profiler.start()
            rows = {name: a[:, slot, :cut].clone() for name, a in self.cache.items()}
            self.profiler.record(f"prefix_extract[{cut}]", prof_t0, out=rows["k"],
                                 real_tokens=cut, real_slots=1)
            entry = {"cut": cut, **rows}
        evicted: list[int] = []
        with self._prefix_lock:
            self._prefix_cache[key] = entry
            while len(self._prefix_cache) > self._prefix_cache_entries or (
                len(self._prefix_cache) > 1
                and self._cached_tokens_locked() > self._prefix_cache_max_tokens
            ):
                _, old = self._prefix_cache.popitem(last=False)  # the LRU entry
                evicted.extend(old.get("pages", ()))
        if evicted:
            self._allocator.free(evicted)

    def _copy_prefix_into_slot(self, slot: int, entry: dict) -> None:
        """A slot-layout cache hit: the entry's rows ``[0, cut)`` copied into
        the slot on the device, so its continuation starts at the cut."""
        cut = entry["cut"]
        prof_t0 = self.profiler.start()
        for name, a in self.cache.items():
            a[:, slot, :cut] = entry[name]
        self.profiler.record(f"prefix_copy[{cut}]", prof_t0, out=self.cache["k"],
                             real_tokens=cut, real_slots=1)

    def _cached_tokens_locked(self) -> int:
        """Tokens pinned by the cache (hold _prefix_lock): a slot entry's
        cut, and paged entries by distinct pages (entries of one growing
        conversation share pages, and counting each entry's cut would
        evict too early)."""
        toks = 0
        pages: set[int] = set()
        for e in self._prefix_cache.values():
            if "pages" in e:
                pages.update(e["pages"])
            else:
                toks += e["cut"]
        return toks + len(pages) * self.page_size

    def _evict_one_prefix_entry(self) -> bool:
        """Evict the LRU entry (allocation pressure). True if one went."""
        with self._prefix_lock:
            if not self._prefix_cache:
                return False
            _, old = self._prefix_cache.popitem(last=False)
        if "pages" in old:
            self._allocator.free(old["pages"])
        return True

    # -- shared-prefix dedup ---------------------------------------------

    def _match_dedup_leader(self, full: list[int], group: list) -> Optional[tuple]:
        """The longest page-aligned common prefix (at least a page) between
        ``full`` and a live slot's row or an earlier member of the
        admission group being formed (the burst case: N Tasks of one Agent
        at once, before any prefill could fill the cache): ``(leader slot,
        leader rid, cut)`` or None. A parked leader shares up to its park
        cut, any other up to its whole row (a follower of a leader still
        prefilling waits for the rows). Waiting followers are never leaders
        (their rows below the cut are not theirs to vouch for); ties keep
        the first candidate, so a burst chains every follower to one
        writer."""
        if not self._paged or not self.prefix_dedup:
            return None  # dedup shares pages
        best: Optional[tuple] = None
        for s, sl in self._slots.items():
            if sl.share_of is not None:
                continue
            if sl.parked:
                other, limit = sl.request.prompt, sl.park_cut
            else:
                other = sl.prefill_row if sl.prefill_row is not None else self._full_row(
                    sl.request)
                limit = len(other)
            cut = self._common_cut(full, other, limit)
            if cut >= self.page_size and (best is None or cut > best[2]):
                best = (s, sl.request.rid, cut)
        for g_req, g_slot, _pages, g_match in group:
            if g_match is not None and (g_match[1].get("share_of") is not None
                                        or g_match[1].get("swap") is not None):
                continue  # a follower or a restore: not a root writer
            cut = self._common_cut(full, self._full_row(g_req))
            if cut >= self.page_size and (best is None or cut > best[2]):
                best = (g_slot, g_req.rid, cut)
        return best

    def _common_cut(self, full: list[int], other: list[int], limit: Optional[int] = None) -> int:
        """Page-aligned length of the common token prefix, below ``full``'s
        last token (a suffix must remain) and at most ``limit``; compared a
        page at a time (the result is page-aligned anyway)."""
        P = self.page_size
        n = min(len(full) - 1, len(other))
        if limit is not None:
            n = min(n, limit)
        i = 0
        while i < n // P and full[i * P: (i + 1) * P] == other[i * P: (i + 1) * P]:
            i += 1
        return i * P

    def _unshare_followers(self, leader_slot: int, leader_sl: _Slot) -> None:
        """A dedup leader leaves while still prefilling (preempted, expired,
        cancelled): every follower waiting on it rewinds to the page-aligned
        rows it wrote. The followers hold references, so the shared pages
        survive; each recomputes the gap itself, into those pages (followers
        rewound together may write the same rows, with the same values)."""
        if not leader_sl.prefilling:
            return  # its prefill finished: every shared row is written
        pos = (leader_sl.prefill_pos // self.page_size) * self.page_size
        rid = leader_sl.request.rid
        for s, sl in self._slots.items():
            if (sl.prefilling and sl.share_of is not None and sl.share_of[0] == leader_slot
                    and sl.share_of[1] == rid):
                if sl.prefill_pos > pos:
                    # the follower recomputes rows its leader had covered
                    self.profiler.reclassify("dedup_rewind", sl.prefill_pos - pos)
                    sl.prefill_pos = pos
                    self._seq_lens[s] = pos
                sl.share_of = None

    # -- admission -------------------------------------------------------

    def _fill_slots(self) -> bool:
        """Admit from the waiting deque. With chunking on, admission only
        reserves (slot, pages, reuse start) and every prefill runs chunk by
        chunk in ``_prefill_chunks``. With it off, dedup followers still
        start as prefilling slots (they may wait on their leader), and the
        rest prefill here: long rows spill first, then plain rows and
        suffix continuations run as separate power-of-two batches. Host-tier
        restores start as prefilling slots too (their rows land under the
        budget). Injected handoff entries land in the host pool first, so
        an inject before a submit is seen by its admission."""
        self._drain_kv_inject()
        admitted = False
        while self._waiting and (self._free or self._parked_count):
            group = self._collect_group()
            if not group:
                break  # the head can't get pages yet; FIFO, it waits
            admitted = True
            direct: list[list] = []  # [(req, slot, pages), start]
            for req, slot, pages, match in group:
                # starts the client's generation clock; a caller that gave
                # up may have cancelled the future already
                with contextlib.suppress(InvalidStateError):
                    req.admitted.set_result(True)
                start, share, swap = 0, None, None
                if match is not None and match[1].get("swap") is not None:
                    # a host restore: its rows land chunk by chunk into
                    # fresh pages, prefill_pos advancing from 0 as they do
                    swap = match[1]["swap"]
                elif match is not None:
                    # a hit borrows the entry's pages (paged) or copies its
                    # rows into the slot (slot), a follower borrows its
                    # leader's pages; an adopted slot kept its own rows
                    start = match[1]["cut"]
                    if match[1].get("share_of") is not None:
                        share = (*match[1]["share_of"], start)
                    elif not match[1].get("in_slot"):
                        if not self._paged:
                            self._copy_prefix_into_slot(slot, match[1])
                        self._prefix_hits += 1
                        REGISTRY.counter_add("acp_engine_prefix_cache_hit_requests", 1.0,
                                             help="admissions that hit the prefix cache")
                elif self._prefix_enabled and not req.truncated:
                    self._prefix_misses += 1
                    REGISTRY.counter_add("acp_engine_prefix_cache_miss_requests", 1.0,
                                         help="admissions that missed the prefix cache")
                # the reservation decision: slot and pages taken, the reuse
                # start resolved (no model compute has run yet)
                self.flight.record(
                    "admit", rid=req.rid, slot=slot, start=start,
                    pages=len(pages) if pages else 0, resumed=req.preempt_count > 0,
                    adopted=bool(match is not None and match[1].get("in_slot")),
                    chunked=bool(self.prefill_chunk), swapped=swap is not None,
                    shared=share is not None,
                )
                if self._paged:
                    self._slot_pages[slot] = pages
                    self._block_tables[slot, :] = TRASH_PAGE
                    self._block_tables[slot, : len(pages)] = pages
                    self._tables_dirty = True
                if self.prefill_chunk or share is not None or swap is not None:
                    # the re-admission edges reproject the rate plan (a
                    # follower or a restore admitted with chunking off plans
                    # as "admit", as in the reference)
                    reason = "admit"
                    if self.prefill_chunk and req.preempt_count:
                        reason = "resume"
                    elif self.prefill_chunk and match is not None and match[1].get("in_slot"):
                        reason = "adopt"
                    self._begin_chunked_prefill(req, slot, start, share, reason, swap=swap)
                else:
                    direct.append([(req, slot, pages), start])
            if not direct:
                continue
            with self._hol_clock():
                self._spill_long_chunks(direct)
                plain = [e[0] for e in direct if e[1] == 0]  # the cheaper causal program
                conts = [e for e in direct if e[1] > 0]  # suffix continuations
                for chunk in _pow2_chunks(plain, self.prefill_batch_max):
                    self._prefill_group(chunk)
                for chunk in _pow2_chunks(conts, self.prefill_batch_max):
                    self._prefill_group([e[0] for e in chunk],
                                        starts=np.asarray([e[1] for e in chunk], dtype=np.int64))
        return admitted

    def _collect_group(self) -> list[tuple[_Request, int, Optional[list[int]], Optional[tuple]]]:
        """Pop up to prefill_batch_max head requests, reserving a slot and
        (paged) the pages of each one's row, and resolving its KV reuse: adopting
        the parked slot of its conversation's previous turn, borrowing a
        prefix-cache entry's pages, or sharing a dedup leader's (a live
        slot or an earlier member of this group), or restoring a host-tier
        entry (its rid's, else the longest token prefix). The reuse covering
        the most rows wins; ties go to adoption (moves nothing), then the
        cache (written rows), then dedup (may wait on its leader), then the
        host tier (a copy). A host entry is consumed only once the row's
        fresh pages are reserved. Under pressure parked slots (the dedup
        leader last) and then cache entries yield. Stops at the first
        request the pool can't cover (FIFO)."""
        group: list[tuple[_Request, int, list[int], Optional[tuple]]] = []
        while (self._waiting and len(group) < self.prefill_batch_max
               and (self._free or self._parked_count)):
            req = self._waiting[0]
            s = req.sampling
            if s.json_only and s.forced_prefix and self._seed_con_state(s.forced_prefix) < 0:
                # an illegal prefix can never complete: fail it up front (on
                # every rank of a group alike: the decision reads only the
                # request)
                self._waiting.popleft()
                self.flight.record("cancel", rid=req.rid, where="illegal_prefix")
                self.flight.discard(req.rid)
                req.future.set_exception(RuntimeError("forced_prefix is not a legal JSON prefix"))
                continue
            match = None
            if self._prefix_enabled and not req.truncated:
                match = self._match_prefix(req)
            full = self._full_row(req)
            host_e, host_cut = self._match_host(req, full)
            dedup = self._match_dedup_leader(full, group) if not req.truncated else None
            adopt = self._match_parked(req)
            best_cut, _prio, kind = max(
                (self._slots[adopt].park_cut if adopt is not None else 0, 3, "adopt"),
                (match[1]["cut"] if match is not None else 0, 2, "cache"),
                (dedup[2] if dedup is not None else 0, 1, "dedup"),
                (host_cut, 0, "host"),
            )
            if best_cut <= 0:
                kind = None
            if kind == "adopt":
                item = self._adopt_parked(req, adopt)
                if item is None:
                    break  # pages short even after yielding; the head waits
                group.extend(item)  # [] when the head was refused
                continue
            # no adoption: parked capacity yields a slot id, the dedup
            # leader last (its pages are the share; released anyway, the
            # request is admitted undeduped below)
            if not self._free and not self._release_lru_parked(
                    exclude=dedup[0] if dedup is not None else None):
                if not self._release_lru_parked():
                    break
            pages: Optional[list[int]] = None  # the slot layout reserves no pages
            shared: list[int] = []
            if self._paged:
                total_pages = -(-len(full) // self.page_size)
                if self._reject_oversize_head(req, total_pages):
                    continue
                if kind == "cache":
                    shared = list(match[1]["pages"])
                elif kind == "dedup":
                    leader_pages = self._slot_pages.get(dedup[0])
                    if leader_pages is None:  # a leader reserved in this group
                        leader_pages = next((it[2] for it in group if it[1] == dedup[0]), None)
                    if leader_pages is None:
                        kind = None  # the leader was released for its slot id
                    else:
                        shared = list(leader_pages[: best_cut // self.page_size])
                # share FIRST: if pressure evicts the matched entry (or
                # releases the parked leader) below, this reference keeps
                # its pages alive
                self._allocator.share(shared)
                fresh = self._alloc_yielding(total_pages - len(shared))
                if fresh is None:
                    self._allocator.free(shared)  # undo; the head waits
                    break
                pages = shared + fresh
            if kind == "dedup":
                match = (None, {"cut": best_cut, "share_of": dedup[:2]})
                self.prefix_shares += 1
                self.flight.record("prefix_share", rid=req.rid, cut=best_cut, leader=dedup[1],
                                   pages=len(shared))
            elif kind == "host":
                # the reservation holds: consume the entry (its bytes return
                # to the budget; the rows restore chunk by chunk)
                self._host_pool.pop(host_e.rid)
                match = (None, {"cut": best_cut, "swap": host_e})
            elif kind is None:
                match = None
            self._waiting.popleft()
            # lowest slot first keeps occupancy compact (narrow decode widths)
            group.append((req, heapq.heappop(self._free), pages, match))
        return group

    def _alloc_yielding(self, n: int, exclude: Optional[int] = None) -> Optional[list[int]]:
        """Admission's allocation: on exhaustion parked slots (but
        ``exclude``) yield first, then prefix-cache entries; None when
        nothing more can yield."""
        while True:
            try:
                return self._allocator.alloc(n)
            except MemoryError:
                if self._release_lru_parked(exclude=exclude):
                    continue
                if not self._evict_one_prefix_entry():
                    return None

    def _reject_oversize_head(self, req: _Request, total_pages: int) -> bool:
        """A row bigger than the whole pool can never fit: fail the head up
        front (waiting would spin forever). True if it was refused."""
        if total_pages <= self._allocator.num_pages - 1:
            return False
        self._waiting.popleft()
        self.flight.record("cancel", rid=req.rid, where="oversize", pages_needed=total_pages)
        self.flight.discard(req.rid)
        req.future.set_exception(RuntimeError(
            f"prompt needs {total_pages} KV pages but the pool has {self._allocator.num_pages - 1}"
        ))
        return True

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

    def _prefill_group(self, chunk: list[tuple[_Request, int, list[int]]],
                       starts: Optional[np.ndarray] = None) -> None:
        """One split batched prefill for B reserved requests: the device
        half (``_prefill_device``: the model and the first-token sample),
        one host read of the results, then the commit
        (``_finish_prefill_dispatch``). With ``starts`` (prefix-cache hits,
        adopted parked slots, dedup followers, spilled rows, final chunks)
        only each row's SUFFIX runs through the model
        (``prefill_paged_continue``): the rows below its start are already
        in the slot's block table and are never written."""
        ln = self._prefill_lanes(chunk, starts)
        prof_t0 = self.profiler.start()
        out = self._prefill_device(ln)
        if self.profiler.enabled:
            # keyed as the reference keys its programs: kind x bucket x
            # batch, +tbl once the JSON table exists
            B, bucket = len(chunk), ln["tokens"].shape[1]
            real = int(ln["lengths"][:B].sum())
            kind = "prefill_cont" if ln["cont"] else "prefill"
            self.profiler.record(f"{kind}[{self.kv_layout},{bucket}x{B}{self._tbl()}]", prof_t0,
                                 out=out[0], real_tokens=real, padded_tokens=B * bucket - real,
                                 real_slots=B)
            self.profiler.account(goodput=real, pad_bucket=B * bucket - real)
        firsts, states = self._host_read(*out)
        self._finish_prefill_dispatch(chunk, ln, firsts, states)

    def _tbl(self) -> str:
        """The ``+tbl`` suffix of a program key once the JSON table exists
        (the reference's programs trace another shape from then on)."""
        return "+tbl" if self._token_table is not None else ""

    def _prefill_lanes(self, chunk: list, starts: Optional[np.ndarray] = None,
                       width: int = 0) -> dict:
        """Host lane arrays of a sampled prefill for B reserved requests,
        shared by the split dispatch and the megastep's plain and final
        phases: tokens (the suffix past each start), pages (paged) or slots
        (slot), sampling knobs and, with a json_only lane, each lane's
        automaton state and budget. ``width`` > B pads the batch: a pad
        lane has no tokens, samples greedily and is never committed; its
        writes go to the trash page (paged) or, at start ``max_ctx``, to the
        never-read row C-1 of slot 0 (slot)."""
        B, P = len(chunk), self.page_size
        W = max(B, width)
        cont = starts is not None
        if starts is None:
            starts = np.zeros(B, dtype=np.int64)
        rows = [self._full_row(r) for r, _, _ in chunk]
        # bucket over what runs through the model: the suffix on a hit
        bucket = max(_next_bucket(len(row) - int(st), self.prefill_buckets)
                     for row, st in zip(rows, starts))
        ln = {"cont": cont, "rows": rows,
              "tokens": np.zeros((W, bucket), dtype=np.int64),
              "lengths": np.zeros(W, dtype=np.int64),
              "starts": np.full(W, 0 if self._paged else self.max_ctx, dtype=np.int64),
              "temps": np.zeros(W, dtype=np.float32),
              "top_ks": np.zeros(W, dtype=np.int64),
              "top_ps": np.ones(W, dtype=np.float32),
              "json": any(r.sampling.json_only for r, _, _ in chunk)}
        if self._paged:
            ln["page_ids"] = np.full((W, bucket // P), TRASH_PAGE, dtype=np.int64)
        else:
            ln["slots"] = np.zeros(W, dtype=np.int64)
        for i, (req, slot, pages) in enumerate(chunk):
            st = int(starts[i])
            suffix = rows[i][st:]
            ln["tokens"][i, : len(suffix)] = suffix
            ln["lengths"][i], ln["starts"][i] = len(suffix), st
            if self._paged:
                # the row's pages from its start on (a page-aligned cut, so
                # only fresh pages); the rest of the bucket is trash
                fresh = pages[st // P:]
                ln["page_ids"][i, : len(fresh)] = fresh
            else:
                ln["slots"][i] = slot
            s = req.sampling
            ln["temps"][i], ln["top_ks"][i], ln["top_ps"][i] = s.temperature, s.top_k, s.top_p
        if cont and self._paged:  # the continuation reads each row's prefix through its table
            ln["tables"] = np.full((W, self.max_pages_per_seq), TRASH_PAGE, dtype=np.int32)
            ln["tables"][:B] = self._block_tables[[slot for _, slot, _ in chunk]]
        if ln["json"]:
            ln["con_states"] = np.zeros(W, dtype=np.int32)
            ln["constrained"] = np.zeros(W, dtype=bool)
            ln["budgets"] = np.ones(W, dtype=np.int32)
            for i, (req, _slot, _pages) in enumerate(chunk):
                s = req.sampling
                # 1 token now + decode capacity to the ctx edge; a resumed
                # request's budget excludes what it already sampled
                ln["budgets"][i] = min(s.max_tokens - len(req.resume_tokens),
                                       1 + max(0, self.max_ctx - 1 - len(rows[i])))
                if s.json_only:
                    ln["constrained"][i] = True
                    seed = tuple(s.forced_prefix) + tuple(req.resume_tokens)
                    ln["con_states"][i] = self._seed_con_state(seed) if seed else self._table_start
        return ln

    def _prefill_device(self, ln: dict) -> tuple:
        """The device half of a sampled prefill: the model over the lanes
        (the continuation when the lanes have starts), then the first token
        of each, masked and advanced for json_only lanes. Returns (first
        tokens, automaton states or None) on the device."""
        up = self._upload
        if not self._paged:
            if ln["cont"]:
                self.cache, logits = prefill_continue(
                    self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]),
                    up(ln["starts"]), up(ln["slots"]), self.config,
                    prefix_rows=_live_start(ln["lengths"], ln["starts"]),
                )
            else:
                self.cache, logits = prefill_batch(
                    self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]),
                    up(ln["slots"]), self.config,
                )
        elif ln["cont"]:
            self.cache, logits = prefill_paged_continue(
                self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]), up(ln["starts"]),
                up(ln["page_ids"]), up(ln["tables"]), self.config, group=self.group,
            )
        else:
            self.cache, logits = prefill_paged_batch(
                self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]),
                up(ln["page_ids"]), self.config, group=self.group,
            )
        if not ln["json"]:
            return sample(logits, self._gen, up(ln["temps"]), up(ln["top_ks"]),
                          up(ln["top_ps"])), None
        table = self._get_token_table()
        states, constrained = up(ln["con_states"]), up(ln["constrained"])
        logits = constrain_logits(logits, table, states, constrained, self._min_close,
                                  up(ln["budgets"]))
        firsts = sample(logits, self._gen, up(ln["temps"]), up(ln["top_ks"]), up(ln["top_ps"]))
        return firsts, advance_constraint(table, states, constrained, firsts)

    @staticmethod
    def _host_read(*tensors) -> list:
        """ONE device -> host copy of several integer tensors (None passes
        through as None), each back as numpy in its own shape."""
        live = [t for t in tensors if t is not None]
        if not live:
            return [None] * len(tensors)
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in live]).cpu().numpy()
        out, i = [], 0
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            out.append(flat[i: i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        return out

    def _finish_prefill_dispatch(self, chunk: list, ln: dict, firsts: np.ndarray,
                                 con_states: Optional[np.ndarray]) -> None:
        """The commit of a sampled prefill (split or fused; ``firsts`` and
        ``con_states`` host arrays, pad lanes past B ignored): prefix-cache
        entries, each slot's first token streamed, a prefilling slot's
        final chunk flipped to decoding, terminal first tokens finished."""
        rows, B = ln["rows"], len(chunk)
        if con_states is None:
            con_states = np.zeros(B, dtype=np.int32)
        # entries for later turns; a hit or an adopted slot saves too: its
        # table now holds the whole prompt, so the next turn reuses all of it
        if self._prefix_enabled:
            for i, (req, slot, _pages) in enumerate(chunk):
                if not req.truncated:
                    self._save_prefix(rows[i], len(req.prompt), slot)
        now = time.monotonic()
        self._state_dirty = True
        self.requests_prefilled += B
        self.prefill_tokens += int(ln["lengths"][:B].sum())
        for i, (req, slot, _pages) in enumerate(chunk):
            s = req.sampling
            first = int(firsts[i])
            is_first = req.first_token_at == 0.0
            if is_first:  # once per request, not per resume
                req.first_token_at = now
                REGISTRY.observe("acp_engine_ttft_seconds", now - req.enqueued,
                                 help="time to first token")
            # the prompt's KV is resident and the first token sampled; for a
            # resumed request this ends its preempt_stall window
            self.flight.record("prefill_done", rid=req.rid, slot=slot, seq=len(rows[i]),
                               first=is_first)
            prior = self._slots.get(slot)
            if prior is not None and prior.prefilling:
                # a final chunk: the slot keeps its admission stamp, so the
                # victim policy's recency is admission order
                self._prefilling_count -= 1
                admit_seq = prior.admit_seq
            else:
                self._admit_seq += 1
                admit_seq = self._admit_seq
            sl = _Slot(request=req, prompt_len=len(req.prompt),
                       prefix_len=len(s.forced_prefix), first_token_at=req.first_token_at,
                       admit_seq=admit_seq)
            if self.prefix_dedup and self._paged:
                sl.prefill_row = rows[i]  # the dedup leader scan compares it
            if self.spec_len:
                sl.spec = SpecState(limit=self.spec_len)
            sl.generated.extend(s.forced_prefix)
            sl.generated.extend(req.resume_tokens)
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
            # a resumed request streamed its prefix and earlier tokens before
            # it was preempted: only the fresh token goes out
            shown = [] if req.resume_tokens else list(s.forced_prefix)
            self._stream(req, shown + ([] if stop else [first]))
            if stop or len(sl.generated) - sl.prefix_len >= s.max_tokens:
                self._finish(slot, "stop" if stop else "length")

    # -- chunked prefill and the token-budget scheduler -------------------

    def _spill_long_chunks(self, items: list[list]) -> None:
        """Rows longer than the largest bucket, batched across the
        admission group: one largest-bucket chunk per long row per dispatch,
        KV only, until every remainder fits one bucket. Moves each item's
        start (``[(req, slot, pages), start]``) in place."""
        CH, P = self.prefill_buckets[-1], self.page_size
        while True:
            need = [e for e in items if len(self._full_row(e[0][0])) - e[1] > CH]
            if not need:
                return
            for batch in _pow2_chunks(need, self.prefill_batch_max):
                B = len(batch)
                toks = np.zeros((B, CH), dtype=np.int64)
                starts = np.zeros(B, dtype=np.int64)
                for i, ((req, _slot, _pages), st) in enumerate(batch):
                    toks[i] = self._full_row(req)[st: st + CH]
                    starts[i] = st
                lens = self._upload(np.full(B, CH, dtype=np.int64))
                prof_t0 = self.profiler.start()
                if self._paged:
                    page_ids = np.zeros((B, CH // P), dtype=np.int64)
                    for i, ((_req, _slot, pages), st) in enumerate(batch):
                        page_ids[i] = pages[st // P: (st + CH) // P]
                    self.cache = prefill_paged_continue_kv(
                        self.params, self.cache, self._upload(toks), lens, self._upload(starts),
                        self._upload(page_ids),
                        self._upload(self._block_tables[[e[0][1] for e in batch]]),
                        self.config, group=self.group,
                    )
                else:
                    slots = np.asarray([e[0][1] for e in batch], dtype=np.int64)
                    self.cache = prefill_continue_kv(
                        self.params, self.cache, self._upload(toks), lens, self._upload(starts),
                        self._upload(slots), self.config, prefix_rows=int(starts.max()),
                    )
                if self.profiler.enabled:
                    # spill rounds run whole CH-token rows: no bucket padding
                    self.profiler.record(f"spill[{self.kv_layout},{CH}x{B}]", prof_t0,
                                         out=self.cache["k"], real_tokens=B * CH, real_slots=B)
                    self.profiler.account(goodput=B * CH)
                self.prefill_tokens += B * CH
                for e in batch:
                    e[1] += CH

    @contextlib.contextmanager
    def _hol_clock(self):
        """Count prefill wall time as head-of-line wait while any slot
        decodes: those slots' tokens arrive that much later. Wraps the
        whole prefill at admission and the chunk dispatches alike, so one
        metric compares chunking on and off."""
        stalled = self._n_active() > 0
        t0 = time.monotonic()
        try:
            yield
        finally:
            if stalled:
                dt = time.monotonic() - t0
                self.hol_wait_s += dt
                REGISTRY.counter_add("acp_engine_hol_wait_seconds", dt,
                                     help="seconds decoding slots were stalled behind "
                                     "prefill dispatches (head-of-line blocking)")

    def _chunk_tokens(self) -> int:
        """The chunk: clamped to the largest prefill bucket and, paged,
        rounded up to a page, since a mid chunk commits whole pages and
        every boundary must be page-aligned. ``prefill_chunk == 0`` here
        means the knob was turned off while slots were mid-prefill: they
        drain at the largest bucket (smaller chunks would break the
        alignment)."""
        ch = min(self.prefill_chunk or self.prefill_buckets[-1], self.prefill_buckets[-1])
        if self._paged:
            ch = -(-ch // self.page_size) * self.page_size
        return max(1, ch)

    def _begin_chunked_prefill(self, req: _Request, slot: int, start: int,
                               share_of: Optional[tuple] = None,
                               reason: str = "admit",
                               swap: Optional[HostKVEntry] = None) -> None:
        """Admit a request as a PREFILLING slot: slot and pages reserved,
        ``start`` rows already valid (cache pages, an adopted slot's prompt,
        a dedup leader's pages), no model compute yet, and its rate plan
        made (``reason``: admit, resume or adopt). ``swap`` is a host-tier
        entry whose rows restore before any model chunk. Its lane uploads
        as inactive until the final chunk."""
        self._admit_seq += 1
        sl = _Slot(
            request=req, prompt_len=len(req.prompt),
            prefix_len=len(req.sampling.forced_prefix), admit_seq=self._admit_seq,
            prefilling=True, prefill_pos=start, prefill_row=self._full_row(req),
            share_of=share_of, swap_entry=swap,
        )
        self._project_quota(slot, sl, reason)
        self._slots[slot] = sl
        self._prefilling_count += 1
        self._seq_lens[slot] = start
        self._last_tokens[slot] = 0
        self._state_dirty = True

    def _project_quota(self, slot: int, sl: _Slot, reason: str) -> None:
        """The chunk-rate plan (``engine/planner.py``): the request's
        deadline turned into chunks per cycle, so its prefill lands by
        arithmetic rather than by the luck of the cycle's other chunks.
        Made at admission and remade at each re-admission (preempt ->
        resume, park -> adopt), where the tokens and the time left changed.
        Leader-local: deadlines are its wall clock, so under a group and on
        followers every quota stays 1."""
        if self._follower:
            return
        sl.chunk_quota = 1
        if not self.rate_planner or self.group is not None or sl.request.deadline is None:
            return
        tokens_left = max(0, len(sl.prefill_row or []) - sl.prefill_pos)
        seconds_left = sl.request.deadline - time.monotonic()
        sl.chunk_quota = project_quota(
            tokens_left, self._chunk_tokens(), seconds_left,
            self._cycle_clock.cycle_s or 0.05, max_quota=self.planner_max_quota)
        self.quota_projections += 1
        if reason != "admit":
            self.quota_reprojections += 1
            REGISTRY.counter_add("acp_engine_quota_reprojections_total", 1.0,
                                 help="chunk-rate plans recomputed at a re-admission edge "
                                 "(preempt-resume / park-adopt)")
        self.flight.record("quota", rid=sl.request.rid, slot=slot, quota=sl.chunk_quota,
                           tokens_left=tokens_left,
                           seconds_left=round(max(0.0, seconds_left), 4), reason=reason)

    def _slot_chunk_tokens(self, sl: _Slot, chunk: int) -> int:
        """One slot's chunk this cycle: its quota x the base chunk, as ONE
        lane (consecutive chunks of a slot cannot share a dispatch: the
        later would read rows the earlier writes), capped at the largest
        bucket; both are page multiples, so boundaries stay page-aligned."""
        q = sl.chunk_quota if self.rate_planner else 1
        return min(max(1, q) * chunk, self.prefill_buckets[-1])

    def _dispatch_once(self) -> None:
        """One scheduler cycle. With nothing mid-prefill it is the decode
        block alone (keyed on the prefilling count, not the knob, so slots
        still mid-prefill after a toggle to 0 drain here). Otherwise the
        cycle's token budget goes to prefill chunks, then the decode block
        runs: decode is never starved by pending chunks, and at least one
        chunk advances each cycle. With the megastep the chunks are only
        planned here and dispatch with the decode block, so a fused cycle
        enters the decode site even with nothing decoding. Both branches
        feed the planner's cycle clock."""
        t0 = time.monotonic()
        if not self._prefilling_count:
            self._decode_once()
            self._cycle_clock.observe(time.monotonic() - t0)
            return
        self._apply_cancels()
        self._expire_prefilling()
        n_active = self._n_active()
        decode_reserve = n_active * self.decode_block_size
        budget = self.token_budget or (
            decode_reserve + self._chunk_tokens() * max(1, self._prefilling_count))
        spent = self._prefill_chunks(max(0, budget - decode_reserve))
        if self._n_active() or self._fuse_pending is not None:
            steps0 = self.decode_steps
            self._decode_once()
            spent += n_active * min(self.decode_steps - steps0, self.decode_block_size)
        self._cycle_clock.observe(time.monotonic() - t0)
        self._budget_last = (budget, spent)
        self._budget_spent_total += spent
        self._budget_total += budget
        REGISTRY.gauge_set("acp_engine_token_budget_utilization",
                           min(1.0, spent / budget) if budget else 0.0,
                           help="tokens dispatched last scheduler cycle / per-cycle token "
                           "budget (chunked prefill mode)")

    def _expire_prefilling(self) -> None:
        """Fail mid-prefill slots whose deadline passed and release their
        partial KV. Only the leader reads the clock; in a group the rid
        rides the next frame's cancels, so every rank drops the slot in the
        same frame."""
        if self._follower:
            return
        now = time.monotonic()
        expired = [(s, sl) for s, sl in self._slots.items()
                   if sl.prefilling and sl.request.deadline is not None
                   and now > sl.request.deadline and not sl.request.future.done()]
        for slot, sl in expired:
            sl.request.future.set_exception(DeadlineExceededError(
                "deadline expired mid-prefill (partial prompt KV released)"))
            REGISTRY.counter_add("acp_engine_deadline_expired_total", 1.0,
                                 help="requests failed fast because their deadline passed")
            self._record_expire(sl.request, "mid_prefill")
            if self._channel is not None:
                self._cancelled.add(sl.request.rid)
            else:
                # the partial prompt KV goes to the host tier first: a retry
                # of the same task prefix-matches it; dropped outright, the
                # chunks already spent are waste
                if not self._swap_out(slot, sl, reason="expire"):
                    self.profiler.reclassify("preempt_discard", sl.prefill_pos)
                self._drop_prefilling_slot(slot)

    def _drop_prefilling_slot(self, slot: int) -> _Slot:
        """Release a mid-prefill slot: its partial KV pages, mirrors and id,
        its followers rewound. The caller resolves or requeues the request."""
        sl = self._slots.pop(slot)
        self._prefilling_count -= 1
        self._unshare_followers(slot, sl)
        self._release_slot(slot)
        return sl

    def _prefill_chunks(self, chunk_budget: int) -> int:
        """One round of chunked prefill: each mid-prefill slot gets its
        chunk (quota x the base chunk, ``_slot_chunk_tokens``), earliest
        deadline first, then admission order (in a group, admission order
        alone: deadlines are the leader's clock), until the budget is
        spent; the first chunk always goes, over budget or not. A dedup
        follower waits, spending nothing, until its leader has written the
        shared rows. Mid chunks write KV only; a final chunk samples the
        first token (a row whose only chunk it is takes the plain causal
        program). A host restore's chunk (rows up to its cut) costs budget
        like a prefill chunk and is ordered with them; it lands here, or,
        when its rows were staged last cycle and the cycle fuses, as the
        megastep's swaps phase. With the megastep the chunks are planned
        here and left in ``_fuse_pending`` for this cycle's decode site;
        nothing is recorded or advanced until they dispatch. Returns the
        tokens spent."""
        pre = [(s, sl) for s, sl in self._slots.items() if sl.prefilling]
        if self._faults.enabled and pre:
            # a deterministic mid-prefill preemption: the prefilling slot
            # with the most rows written (steps = chunks dispatched, so
            # after_steps=N lets N chunks land first)
            spec = self._faults.pop("engine.preempt_mid_prefill", steps=self.prefill_chunks)
            if spec is not None:
                self._preempt(max(pre, key=lambda t: (t[1].prefill_pos, t[0]))[0], reason="fault")
                pre = [(s, sl) for s, sl in self._slots.items() if sl.prefilling]
                if not pre:
                    return 0
        if self._channel is None:
            pre.sort(key=lambda t: (t[1].request.deadline if t[1].request.deadline is not None
                                    else float("inf"), t[1].admit_seq))
        else:
            pre.sort(key=lambda t: t[1].admit_seq)
        ready = []
        for slot, sl in pre:
            if sl.share_of is not None:
                lead = self._slots.get(sl.share_of[0])
                if (lead is not None and lead.prefilling and lead.request.rid == sl.share_of[1]
                        and lead.prefill_pos < sl.share_of[2]):
                    continue
                sl.share_of = None  # the shared rows are written
            ready.append((slot, sl))
        CHK = self._chunk_tokens()
        sched: list[tuple[int, _Slot, int, int]] = []  # (slot, sl, start, n)
        spent = 0
        for slot, sl in ready:
            end = self._swap_in_cut(sl) if sl.swap_entry is not None else len(sl.prefill_row)
            n = min(self._slot_chunk_tokens(sl, CHK), end - sl.prefill_pos)
            if sched and spent + n > chunk_budget:
                break  # later slots wait a cycle
            sched.append((slot, sl, sl.prefill_pos, n))
            spent += n
        if not sched:
            return 0
        restores = [c for c in sched if c[1].swap_entry is not None]
        restore_slots = {c[0] for c in restores}
        model = [c for c in sched if c[1].swap_entry is None]
        mids = [c for c in model if c[2] + c[3] < len(c[1].prefill_row)]
        finals = [c for c in model if c[2] + c[3] >= len(c[1].prefill_row)]
        plain = [c for c in finals if c[2] == 0]
        conts = [c for c in finals if c[2] > 0]
        staged_ready = any(self._staged_for(sl, st, n) is not None for _, sl, st, n in restores)
        paged = self._paged
        fused = self.megastep and bool(mids or conts or (paged and plain) or staged_ready)
        aborted, refund, deferred = self._run_restores(restores, defer=fused and paged)
        spent -= refund  # an aborted restore dispatched nothing
        deferred_slots = {c[0] for c in deferred}
        rnd = {"spent": spent, "budget": chunk_budget, "restores": restore_slots}
        if fused:
            # a fused plain or continuation final samples its first token
            # inside the fused cycle, so it joins the NEXT cycle's decode
            # lanes (the split path's joins this one's): a shift in the
            # schedule, not in any greedy token. Staged restores ride it as
            # its swaps phase. On the slot layout plain finals dispatch now
            # and join this cycle's lanes, as in the reference: a padded
            # plain lane would write rows [0, T) of slot 0
            if not paged:
                with self._hol_clock():
                    for batch in _pow2_chunks(plain, self.prefill_batch_max):
                        self._prefill_group(self._chunk_items(batch))
            landed = [c for c in sched if c[0] not in aborted and (
                (c in plain and not paged)
                or (c[0] in restore_slots and c[0] not in deferred_slots))]
            self._fuse_pending = {"mids": mids, "finals": conts,
                                  "plains": plain if paged else [], "swaps": deferred,
                                  "landed": landed, "round": rnd}
        else:
            landed = [c for c in restores if c[0] not in aborted]
            self._dispatch_split(mids, plain, conts, rnd, landed=landed)
        return spent

    def _dispatch_split(self, mids: list, plains: list, conts: list, rnd: dict,
                        landed: list = (), swaps: list = ()) -> None:
        """A round's chunks through the split dispatches: staged restore
        scatters first (their rows are the cycle's oldest), then one
        dispatch per pow2 batch of each kind (mid chunks, plain finals,
        continuation finals), then the round recorded with the restore
        chunks that already ``landed`` (``rnd``: the round's tokens spent,
        its budget and its restoring slots)."""
        with self._hol_clock():
            for slot, sl, st, n, staged in swaps:
                sl.swap_stall_s += self._commit_staged_swap(staged)
                self._advance_restore(slot, sl, st, n)
            for batch in _pow2_chunks(mids, self.prefill_batch_max):
                self._chunk_dispatch(batch)
            for batch in _pow2_chunks(plains, self.prefill_batch_max):
                self._prefill_group(self._chunk_items(batch))
            for batch in _pow2_chunks(conts, self.prefill_batch_max):
                self._prefill_group(self._chunk_items(batch),
                                    starts=np.asarray([c[2] for c in batch], dtype=np.int64))
        self._advance_mids(mids)
        self._record_chunk_round([*landed, *(c[:4] for c in swaps), *mids, *plains, *conts], rnd)

    def _advance_mids(self, mids: list) -> None:
        """Mid chunks that dispatched: their rows are written."""
        for slot, sl, st, n in mids:
            sl.prefill_pos = st + n
            self._seq_lens[slot] = sl.prefill_pos

    def _record_chunk_round(self, landed: list, rnd: dict) -> None:
        """Record and count the chunks that dispatched (split or fused): a
        ``prefill_chunk`` event per chunk and the round's ``prefill_round``
        (chunks, tokens spent, budget)."""
        self.prefill_chunks += len(landed)
        if self.flight.enabled:
            for slot, sl, st, n in landed:
                self.flight.record("prefill_chunk", rid=sl.request.rid, slot=slot, start=st, n=n,
                                   final=st + n >= len(sl.prefill_row or ()),
                                   swap=slot in rnd["restores"])
            self.flight.record("prefill_round", scheduled=len(landed), spent=rnd["spent"],
                               budget=rnd["budget"])
        REGISTRY.counter_add("acp_engine_prefill_chunks_total", float(len(landed)),
                             help="prefill chunk dispatches (per-slot chunks) under the "
                             "unified token-budget scheduler")

    def _chunk_items(self, batch: list) -> list:
        """(slot, sl, start, n) chunks -> ``_prefill_group`` items."""
        return [(sl.request, slot, self._slot_pages[slot] if self._paged else None)
                for slot, sl, _st, _n in batch]

    def _mid_lanes(self, batch: list[tuple[int, _Slot, int, int]], width: int = 0) -> dict:
        """Host lane arrays of a mid-chunk dispatch: tokens [start, start +
        n) of each slot's row. Paged chunk boundaries are page-aligned, so
        the commit writes exactly the chunk's pages. ``width`` > B pads the
        batch: a pad lane has no tokens; every page of it is the trash page
        (paged), or it starts at ``max_ctx`` in slot 0, so its writes clamp
        to the never-read row C-1 (slot)."""
        B, P = len(batch), self.page_size
        W = max(B, width)
        bucket = _next_bucket(max(n for _, _, _, n in batch), self.prefill_buckets)
        ln = {"tokens": np.zeros((W, bucket), dtype=np.int64),
              "lengths": np.zeros(W, dtype=np.int64),
              "starts": np.full(W, 0 if self._paged else self.max_ctx, dtype=np.int64)}
        if self._paged:
            ln["page_ids"] = np.full((W, bucket // P), TRASH_PAGE, dtype=np.int64)
            ln["tables"] = np.full((W, self.max_pages_per_seq), TRASH_PAGE, dtype=np.int32)
        else:
            ln["slots"] = np.zeros(W, dtype=np.int64)
        for i, (slot, sl, st, n) in enumerate(batch):
            ln["tokens"][i, :n] = sl.prefill_row[st: st + n]
            ln["lengths"][i], ln["starts"][i] = n, st
            if self._paged:
                sub = self._slot_pages[slot][st // P: -(-(st + n) // P)]
                ln["page_ids"][i, : len(sub)] = sub
                ln["tables"][i] = self._block_tables[slot]
            else:
                ln["slots"][i] = slot
        return ln

    def _mid_device(self, ln: dict) -> None:
        """The KV-only continuation of a mid-chunk lane batch."""
        up = self._upload
        if not self._paged:
            self.cache = prefill_continue_kv(
                self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]), up(ln["starts"]),
                up(ln["slots"]), self.config,
                prefix_rows=_live_start(ln["lengths"], ln["starts"]),
            )
            return
        self.cache = prefill_paged_continue_kv(
            self.params, self.cache, up(ln["tokens"]), up(ln["lengths"]), up(ln["starts"]),
            up(ln["page_ids"]), up(ln["tables"]), self.config, group=self.group,
        )

    def _chunk_dispatch(self, batch: list[tuple[int, _Slot, int, int]]) -> None:
        """One split mid-chunk dispatch."""
        ln = self._mid_lanes(batch)
        prof_t0 = self.profiler.start()
        self._mid_device(ln)
        real = int(ln["lengths"].sum())
        if self.profiler.enabled:
            B, bucket = len(batch), ln["tokens"].shape[1]
            self.profiler.record(f"chunk[{self.kv_layout},{bucket}x{B}]", prof_t0,
                                 out=self.cache["k"],
                                 real_tokens=real, padded_tokens=B * bucket - real, real_slots=B)
            self.profiler.account(goodput=real, pad_bucket=B * bucket - real)
        self.prefill_tokens += real

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
        the next block directly. The block tables ride their own flag: a
        slot growing by a lookahead window re-uploads them alone."""
        if self._state_dirty or self._dev is None:
            # parked and mid-prefill lanes upload inactive: their decode
            # writes go to the trash page and their tokens are never read
            live = [slot for slot, sl in self._slots.items()
                    if not sl.parked and not sl.prefilling]
            W = next(w for w in self.width_buckets if w >= max(live) + 1)
            active = np.zeros(W, dtype=bool)
            for slot in live:
                active[slot] = True
                self._budgets[slot] = self._slot_budget(slot, self._slots[slot])
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
                "constrained_any": constrained,
            }
            if constrained:
                self._dev.update(
                    table=self._get_token_table(),
                    con_states=self._upload(self._con_states[:W]),
                    constrained=self._upload(self._constrained[:W]),
                )
            self._state_dirty = False
            self._tables_dirty = True
        d = self._dev
        if self._paged and self._tables_dirty:
            d["block_tables"] = self._upload(self._block_tables[: d["W"]])
            self._tables_dirty = False
            self.table_uploads += 1
        return d

    def _decode_once(self) -> None:
        """The decode site of a cycle: one K-step block over the live slots,
        after every slot's table was grown to cover the block (which may
        preempt); with speculation, one verify pass in its place when a
        slot drafted (``_decode_spec``). A fused cycle's planned chunk lanes
        dispatch here with the block or the verify pass
        (``_megastep_dispatch``), or alone when nothing decodes
        (``_megastep_flush``); a shape past the bound falls back to the
        split dispatches, then the plain block or the verify pass."""
        pending, self._fuse_pending = self._fuse_pending, None
        self._apply_cancels()
        if self._faults.enabled and self._n_active():
            spec = self._faults.pop("engine.force_preempt", steps=self.decode_steps)
            if spec is not None:
                victim = self._pick_victim()
                if victim is not None:
                    self._preempt(victim, reason="fault")
        if self._n_active() and self.spec_len and self._decode_spec(pending):
            return
        if self._n_active() and self._paged:
            self._ensure_pages_for_block()
        if not self._n_active():
            self._megastep_flush(pending)
            return
        d = self._ensure_dev_state()
        if pending is not None:
            if self._megastep_dispatch(pending, d):
                return
            self._dispatch_pending_split(pending)
            # finals that just joined decode this block too: grow them, as
            # the split path does after its chunks
            if self._paged:
                self._ensure_pages_for_block()
            if not self._n_active():
                self._publish_decode_gauges()
                return
            d = self._ensure_dev_state()
        self._decode_dispatch(d)

    def _decode_dispatch(self, d: dict) -> None:
        """The split decode block: its body, its one host read, its
        commit."""
        W, K, n_act = d["W"], self.decode_block_size, self._n_active()
        key = f"decode[{self.kv_layout},{W}x{K}{self._tbl()}]"
        prof_t0 = self.profiler.start()
        out = self._decode_block(d)
        if self.profiler.enabled:
            # the dispatch-time view (lanes live at upload); the commit
            # accounts the lanes that finished inside the block
            self.profiler.record(key, prof_t0, out=out[0], real_tokens=n_act * K,
                                 padded_tokens=(W - n_act) * K, real_slots=n_act,
                                 padded_slots=W - n_act)
        block, states = self._host_read(*out)
        self._commit_decode_block(d, block, states, key)

    def _decode_block(self, d: dict) -> tuple:
        """The device half of a decode block: K steps of ``decode_step_paged``
        (the CUDA walk in every layer on the card), each sampled and, for
        constrained lanes, masked and advanced; finishes are detected on
        the device. Re-seats the carry in ``d`` and returns (tokens [K, W],
        automaton states [W] or None) on the device."""
        tokens, seq_lens, budgets, active = d["tokens"], d["seq_lens"], d["budgets"], d["active"]
        constrained = d["constrained_any"]
        con_states = d.get("con_states")
        steps = []
        for _ in range(self.decode_block_size):
            if self._paged:
                self.cache, logits = decode_step_paged(
                    self.params, self.cache, tokens, seq_lens, d["block_tables"], active,
                    self.config, group=self.group,
                )
            else:
                self.cache, logits = decode_step(
                    self.params, self.cache, tokens, seq_lens, self.config, active=active,
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
        d.update(tokens=tokens, seq_lens=seq_lens, budgets=budgets, active=active)
        if constrained:
            d["con_states"] = con_states
        return torch.stack(steps), (con_states if constrained else None)

    def _commit_decode_block(self, d: dict, block: np.ndarray,
                             con_states: Optional[np.ndarray], key: str) -> None:
        """The commit of a decode block (split or fused; ``key`` its
        program): the automaton states mirrored (the next dirty upload must
        hold them), each live lane's tokens committed, one ``decode_block``
        event, and the block's W x K positions accounted: committed tokens
        are goodput, the rest width padding. Lanes that were not in the
        block (parked, prefilling, or a slot past its width) are skipped."""
        W, K = d["W"], self.decode_block_size
        if con_states is not None:
            self._con_states[:W] = con_states
        self.decode_steps += K
        self.flight.record("decode_block", width=W, steps=K, active=self._n_active(),
                           program=key)
        emitted = 0
        for slot, sl in list(self._slots.items()):
            if slot < W and not sl.parked and not sl.prefilling:
                n0 = len(sl.generated)
                self._consume_tokens(slot, sl, block[:, slot])
                emitted += len(sl.generated) - n0
        self.profiler.account(goodput=emitted, pad_width=W * K - emitted)
        self._publish_decode_gauges()

    def _publish_decode_gauges(self) -> None:
        """The decode site's gauges, set where the reference sets them:
        after a decode block's or a verify pass's commit."""
        REGISTRY.gauge_set("acp_engine_active_slots", self._n_active(),
                           help="occupied decode slots (parked slots excluded — see "
                           "acp_engine_parked_slots)")
        REGISTRY.gauge_set("acp_engine_waiting_requests", len(self._waiting),
                           help="admission queue depth")
        REGISTRY.gauge_set("acp_engine_preempted_waiting", self._preempted_waiting(),
                           help="preempted requests requeued and awaiting resume")
        REGISTRY.gauge_set("acp_engine_prefilling_slots", float(self._prefilling_count),
                           help="slots admitted but still mid-prefill under the chunked "
                           "token-budget scheduler")

    # -- speculative decoding --------------------------------------------

    def _slot_ctx(self, sl: _Slot) -> np.ndarray:
        """Prompt + generated as one int32 view for the drafter, synced by
        appending only the tokens emitted since the last dispatch."""
        n_prompt = len(sl.request.prompt)
        total = n_prompt + len(sl.generated)
        if sl.ctx_buf is None:
            sl.ctx_buf = np.empty(max(total, self.max_ctx), dtype=np.int32)
            sl.ctx_buf[:n_prompt] = sl.request.prompt
            sl.ctx_len = n_prompt
        elif total > sl.ctx_buf.shape[0]:
            sl.ctx_buf = np.concatenate([sl.ctx_buf, np.empty(total, dtype=np.int32)])
        if sl.ctx_len < total:
            sl.ctx_buf[sl.ctx_len: total] = sl.generated[sl.ctx_len - n_prompt:]
            sl.ctx_len = total
        return sl.ctx_buf[:total]

    def _decode_spec(self, pending: Optional[dict] = None) -> bool:
        """One speculative decode iteration: draft on the host (n-gram
        prompt lookup over each live slot's prompt + generated, capped by
        its controller and its budget), grow every drafting slot's table to
        cover its 1 + draft rows (a slot preempted there leaves the
        dispatch), then ONE verify pass over the live lanes, fused with a
        cycle's pending chunk lanes when there are some. Returns False
        (nothing dispatched) when no slot drafted: the caller then runs the
        plain block, which is the engine without speculation.

        The verify pass writes every draft row; a rejected tail needs no
        rollback, since ``seq_len`` advances only over emitted tokens and
        attention never reads past it. It reads the host mirrors, so it
        marks the device carry dirty for the next plain block."""
        if self.group is not None:
            raise RuntimeError("speculative decoding under a serving group is not ported yet "
                               "(ROADMAP A.14)")
        drafts: dict[int, list[int]] = {}
        budgets: dict[int, int] = {}
        for slot, sl in self._slots.items():
            if sl.parked or sl.prefilling:
                continue
            budgets[slot] = self._slot_budget(slot, sl)
            # the dispatch emits up to draft + 1 tokens and writes as many
            # rows: the cap keeps both within the budget (so within the
            # context edge)
            cap = min(sl.spec.cap(), budgets[slot] - 1) if sl.spec else 0
            drafts[slot] = ngram_propose(self._slot_ctx(sl), self.spec_ngram, cap) if cap > 0 else []
        if not any(drafts.values()):
            return False
        if self._paged:
            self._ensure_pages_for_block({slot: 1 + len(d) for slot, d in drafts.items()})
            if not self._n_active():
                self._megastep_flush(pending)
                return True
            drafts = {s: d for s, d in drafts.items() if s in self._slots}
            if not any(drafts.values()):
                return False  # the drafting slots were preempted: the plain block
        force_reject = bool(self._faults.enabled
                            and self._faults.pop("engine.spec_mismatch") is not None)
        ver = self._verify_lanes(drafts, budgets, force_reject)
        if pending is not None:
            if self._megastep_dispatch(pending, ver=ver):
                return True
            # over the shape bound: the chunks split, then the verify pass
            # alone on the lanes fixed above (a final that joins here emits
            # nothing in it)
            self._dispatch_pending_split(pending)
        W, T = ver["W"], ver["T"]
        key = f"spec_verify[{self.kv_layout},{W}x{T}{self._tbl()}]"
        prof_t0 = self.profiler.start()
        out = self._verify_device(ver)
        if self.profiler.enabled:
            real_in, n_part = int(ver["n_input"].sum()), int(ver["active"].sum())
            self.profiler.record(key, prof_t0, out=out[0], real_tokens=real_in,
                                 padded_tokens=W * T - real_in, real_slots=n_part,
                                 padded_slots=W - n_part)
        self._commit_spec_verify(ver, *self._host_read(*out), key)
        return True

    def _verify_lanes(self, drafts: dict, budgets: dict, force_reject: bool) -> dict:
        """Host lane arrays of a verify pass, [W, spec_len + 1] at the width
        bucket covering the live slots: column 0 the slot's last token, then
        its draft. Lanes not in the dispatch (free, parked, mid-prefill)
        keep ``n_input = 0`` and ``starts = max_ctx``, so every write they
        make lands on the trash page."""
        T = self.spec_len + 1
        live = [s for s, sl in self._slots.items() if not sl.parked and not sl.prefilling]
        W = next(w for w in self.width_buckets if w >= max(live) + 1)
        ver = {"W": W, "T": T, "drafts": drafts, "force_reject": force_reject,
               "inputs": np.zeros((W, T), dtype=np.int64),
               "n_input": np.zeros(W, dtype=np.int64),
               "starts": np.full(W, self.max_ctx, dtype=np.int64),
               "active": np.zeros(W, dtype=bool),
               "budgets": np.zeros(W, dtype=np.int32),
               "proposed": np.zeros(W, dtype=np.int64)}
        for slot in live:
            d = drafts.get(slot, [])
            ver["inputs"][slot, 0] = self._last_tokens[slot]
            ver["inputs"][slot, 1: 1 + len(d)] = d
            ver["n_input"][slot] = 1 + len(d)
            ver["starts"][slot] = self._seq_lens[slot]
            ver["active"][slot] = True
            ver["budgets"][slot] = budgets[slot]
            ver["proposed"][slot] = len(d)
        return ver

    def _verify_device(self, ver: dict) -> tuple:
        """The device half of a verify pass: ``verify_paged_continue`` over
        the lanes, then ``speculative_accept`` with the decode block's
        masking, stop and budget rules. Returns (tokens [W, T] padded with
        -1, emitted counts [W], automaton states [W] or None) on the
        device."""
        up, W = self._upload, ver["W"]
        inputs, n_input = up(ver["inputs"]), up(ver["n_input"])
        if self._paged:
            self.cache, logits = verify_paged_continue(
                self.params, self.cache, inputs, n_input, up(ver["starts"]),
                up(self._block_tables[:W]), self.config,
            )
        else:  # lane b is slot b
            self.cache, logits = verify_continue(
                self.params, self.cache, inputs, n_input, up(ver["starts"]), self.config,
                prefix_rows=_live_start(ver["n_input"], ver["starts"]),
            )
        kw: dict = {}
        constrained = bool(self._constrained[:W].any())
        if constrained:
            table, lanes = self._get_token_table(), up(self._constrained[:W])
            kw = dict(
                constrain_fn=lambda lg, st, b: constrain_logits(lg, table, st, lanes,
                                                                self._min_close, b),
                advance_fn=lambda st, tok, take: torch.where(
                    take, advance_constraint(table, st, lanes, tok), st),
                con_states=up(self._con_states[:W]),
            )
        out, n_emit, states = speculative_accept(
            logits, inputs, n_input, up(ver["active"]), self._gen, up(self._temps[:W]),
            up(self._top_ks[:W]), up(self._top_ps[:W]), self._stop_tokens, up(ver["budgets"]),
            ver["force_reject"], **kw,
        )
        return out, n_emit, (states if constrained else None)

    def _commit_spec_verify(self, ver: dict, out: np.ndarray, n_emit: np.ndarray,
                            con_states: Optional[np.ndarray], key: str) -> None:
        """The commit of a verify pass (split or fused; ``key`` its
        program): the lanes' automaton states mirrored, each live slot's
        accepted prefix and corrected token committed, and its controller
        fed; then the W x T positions accounted (committed tokens, the
        rejected draft tail, padding) and one ``spec_verify`` event. A slot
        that was not a lane of the pass (a final that joined after its lanes
        were fixed) emits nothing."""
        act = ver["active"]
        if con_states is not None:
            self._con_states[: ver["W"]][act] = con_states[act]
        self.decode_steps += 1  # one model forward, however many tokens land
        self.spec_dispatches += 1
        self._state_dirty = True
        emitted = rejected = 0
        for slot, sl in list(self._slots.items()):
            if sl.parked or sl.prefilling or slot >= ver["W"]:
                continue
            n, prop = int(n_emit[slot]), int(ver["proposed"][slot])
            n_gen0 = len(sl.generated)
            if prop:
                # emitted = the accepted prefix + one corrected token, except
                # where emission ended ON a matching draft token (a stop
                # token or the budget), which was accepted too; under a
                # forced rejection nothing was, equal or not
                d = ver["drafts"].get(slot, [])
                acc = max(0, n - 1)
                if (not ver["force_reject"] and 0 < n <= len(d)
                        and int(out[slot, n - 1]) == d[n - 1]):
                    acc = n
                acc = min(acc, prop)
                self.spec_proposed += prop
                self.spec_accepted += acc
                if sl.spec is not None:
                    sl.spec.observe(prop, acc)
                REGISTRY.counter_add("acp_engine_spec_proposed_total", float(prop),
                                     help="draft tokens proposed to speculative verification")
                REGISTRY.counter_add("acp_engine_spec_accepted_total", float(acc),
                                     help="draft tokens accepted by speculative verification")
            if n > 0:
                self._consume_tokens(slot, sl, out[slot, :n])
            emitted += len(sl.generated) - n_gen0
            if prop:
                # the positions past the emitted prefix: the rejected tail
                rejected += max(0, 1 + prop - n)
        W, T, drafts = ver["W"], ver["T"], ver["drafts"]
        self.profiler.account(goodput=emitted, spec_rejected=rejected,
                              pad_width=W * T - emitted - rejected)
        if self.flight.enabled:
            self.flight.record(
                "spec_verify", slots=sum(1 for d in drafts.values() if d),
                proposed=sum(len(d) for d in drafts.values()),
                emitted=sum(int(n_emit[s]) for s in drafts),
                forced_reject=ver["force_reject"], program=key,
            )
        self._publish_decode_gauges()

    # -- the fused megastep ----------------------------------------------

    def _validate_pending(self, pending: dict) -> None:
        """Planning ran before this cycle's cancels and page growth, which
        may have preempted, cancelled or expired a planned slot: drop its
        lanes, which would write KV into freed (maybe reallocated) pages.
        A dropped lane stays counted in the cycle's budget (its split
        dispatch would have landed before the preemption discarded it) but
        is never recorded as a dispatched chunk."""

        def live(c, restoring=False):
            slot, sl, st = c[:3]
            return (self._slots.get(slot) is sl and sl.prefilling and sl.prefill_pos == st
                    and (sl.swap_entry is not None) == restoring)

        for phase in ("mids", "plains", "finals"):
            pending[phase] = [c for c in pending[phase] if live(c)]
        # a staged restore scatters only into a slot still mid-restore at
        # the staged start: a preempt or cancel since freed those pages
        pending["swaps"] = [c for c in pending["swaps"] if live(c, restoring=True)]

    def _dispatch_pending_split(self, pending: dict) -> None:
        """A fused cycle that does not fuse (its shape is past the bound,
        or only staged scatters are left): its live lanes through the split
        dispatches."""
        self._validate_pending(pending)
        self._dispatch_split(pending["mids"], pending["plains"], pending["finals"],
                             pending["round"], landed=pending["landed"], swaps=pending["swaps"])

    def _megastep_flush(self, pending: Optional[dict]) -> None:
        """A fused cycle with nothing left to decode (no live slot, or
        growth preempted them all): a chunks-only megastep."""
        if pending is not None and self._megastep_dispatch(pending) is None:
            self._dispatch_pending_split(pending)

    def _megastep_key(self, mids: list, plains: list, finals: list,
                      d: Optional[dict], ver: Optional[dict] = None, swaps: list = ()) -> str:
        """The fused shape, as the reference keys it:
        ``megastep[<layout>,s<m>-<m>+m<bucket>x<B>+p<bucket>x<B>+f<bucket>x<B>+d<W>x<K>]``
        (present phases only: ``s`` lists the staged scatters' pow2 page
        groups in order, ``v<W>x<T>`` stands for a verify pass in place of
        the decode block; ``+tbl`` once the JSON table exists), each lane
        phase's batch padded to a power of two. Host arithmetic only."""
        parts = []
        if swaps:
            parts.append("s" + "-".join(str(len(ids)) for *_c, staged in swaps
                                        for ids, _blocks in staged["groups"]))
        if mids:
            bucket = _next_bucket(max(n for _, _, _, n in mids), self.prefill_buckets)
            parts.append(f"m{bucket}x{_pow2(len(mids))}")
        if plains:
            bucket = max(_next_bucket(len(sl.prefill_row), self.prefill_buckets)
                         for _, sl, _, _ in plains)
            parts.append(f"p{bucket}x{_pow2(len(plains))}")
        if finals:
            bucket = max(_next_bucket(len(sl.prefill_row) - st, self.prefill_buckets)
                         for _, sl, st, _ in finals)
            parts.append(f"f{bucket}x{_pow2(len(finals))}")
        if d is not None:
            parts.append(f"d{d['W']}x{self.decode_block_size}")
        elif ver is not None:
            parts.append(f"v{ver['W']}x{ver['T']}")
        tbl = "+tbl" if self._token_table is not None else ""
        return f"megastep[{self.kv_layout},{'+'.join(parts)}{tbl}]"

    def _megastep_dispatch(self, pending: dict, d: Optional[dict] = None,
                           ver: Optional[dict] = None) -> Optional[bool]:
        """THE fused cycle: this cycle's staged restore scatters, mid chunks
        (KV only), plain finals, continuation finals (each with its
        first-token sample) and the decode block or the verify pass
        (``ver``), in that order on
        ``self.cache``, each phase ONE lane batch padded to a power of two
        (pad lanes write the trash page), then ONE host read for the
        finals' first tokens and automaton states and the block's (or the
        pass's) tokens. The commits follow: mid chunks advance, the block or
        the pass commits (its lanes predate this cycle's finals), then the
        finals and plains flip to decoding. A fused restore adds no stall
        seconds: its copy overlapped the last cycle. True when it
        dispatched; None when the caller must run the split dispatches (a
        new shape past ``megastep_max_programs``, staged scatters alone, or
        no chunk lane or scatter left beside a decode block or a verify
        pass)."""
        self._validate_pending(pending)
        mids, plains, finals = pending["mids"], pending["plains"], pending["finals"]
        swaps = pending["swaps"]
        if not (mids or plains or finals):
            if not swaps and d is None and ver is None:  # every planned lane was dropped
                self._record_chunk_round(pending["landed"], pending["round"])
                return True
            if (d is None and ver is None) or not swaps:
                return None
        key = self._megastep_key(mids, plains, finals, d, ver, swaps)
        if (key not in self._megastep_shapes
                and len(self._megastep_shapes) >= self.megastep_max_programs):
            self.megastep_fallbacks += 1
            REGISTRY.counter_add("acp_engine_megastep_fallbacks_total", 1.0,
                                 help="fused cycles split-dispatched because a new megastep "
                                 "shape would exceed megastep_max_programs")
            return None
        new_shape = key not in self._megastep_shapes
        self._megastep_shapes.add(key)
        pl_items, fin_items = self._chunk_items(plains), self._chunk_items(finals)
        p_out = f_out = d_out = (None, None)
        v_out = (None, None, None)
        n_act = self._n_active()
        prof_t0 = self.profiler.start()
        for *_c, staged in swaps:
            self._scatter_staged(staged)
        if mids:
            mid_ln = self._mid_lanes(mids, _pow2(len(mids)))
            self._mid_device(mid_ln)
        if plains:
            pl_ln = self._prefill_lanes(pl_items, width=_pow2(len(plains)))
            p_out = self._prefill_device(pl_ln)
        if finals:
            fin_ln = self._prefill_lanes(fin_items,
                                         np.asarray([c[2] for c in finals], dtype=np.int64),
                                         width=_pow2(len(finals)))
            f_out = self._prefill_device(fin_ln)
        if d is not None:
            d_out = self._decode_block(d)
        elif ver is not None:
            v_out = self._verify_device(ver)
        if new_shape:
            self.flight.record("megastep_shape", program=key)
        if self.profiler.enabled:
            probe = next((o[0] for o in (d_out, v_out, f_out, p_out) if o[0] is not None),
                         self.cache["k"])
            self._profile_megastep(key, prof_t0, probe, swaps, mids, plains, finals,
                                   mid_ln if mids else None, pl_ln if plains else None,
                                   fin_ln if finals else None, d, ver, n_act)
        p_firsts, p_states, f_firsts, f_states, block, d_states, *v_np = self._host_read(
            *p_out, *f_out, *d_out, *v_out)
        self.megastep_dispatches += 1
        self.prefill_tokens += sum(n for _, _, _, n in mids)
        for slot, sl, st, n, _staged in swaps:
            self._count_prefetch_commit()
            self._advance_restore(slot, sl, st, n)
        self._advance_mids(mids)
        if d is not None:
            self._commit_decode_block(d, block, d_states, key)
        elif ver is not None:
            self._commit_spec_verify(ver, *v_np, key)
        if finals:
            self._finish_prefill_dispatch(fin_items, fin_ln, f_firsts, f_states)
        if plains:
            self._finish_prefill_dispatch(pl_items, pl_ln, p_firsts, p_states)
        self._record_chunk_round([*pending["landed"], *(c[:4] for c in swaps), *mids, *plains,
                                  *finals], pending["round"])
        return True

    def _profile_megastep(self, key: str, t0: float, probe, swaps: list, mids: list,
                          plains: list, finals: list, mid_ln, pl_ln, fin_ln,
                          d: Optional[dict], ver: Optional[dict], n_act: int) -> None:
        """One fused dispatch for the profiler: real and padded positions
        over its phases (restored rows count as real tokens only: they are
        moved KV, not computed), and each chunk phase accounted as its split
        program would be, plus ``pad_fuse`` for the pow2 pad lanes fusion
        adds (the split path's pow2 decomposition has none). The decode or
        verify phase is accounted at its commit."""
        real = padded = real_slots = padded_slots = 0
        real += sum(int(ids.shape[0]) * self.page_size
                    for *_c, staged in swaps for ids, _b in staged["groups"])
        for lanes, ln in ((mids, mid_ln), (plains, pl_ln), (finals, fin_ln)):
            if not lanes:
                continue
            B, Bp, bucket = len(lanes), _pow2(len(lanes)), ln["tokens"].shape[1]
            n = int(ln["lengths"][:B].sum())
            real += n
            padded += Bp * bucket - n
            real_slots += B
            padded_slots += Bp - B
            self.profiler.account(goodput=n, pad_bucket=B * bucket - n,
                                  pad_fuse=(Bp - B) * bucket)
        if d is not None:
            W, K = d["W"], self.decode_block_size
            real += n_act * K
            padded += (W - n_act) * K
            real_slots += n_act
            padded_slots += W - n_act
        elif ver is not None:
            W, T = ver["W"], ver["T"]
            real_in, n_part = int(ver["n_input"].sum()), int(ver["active"].sum())
            real += real_in
            padded += W * T - real_in
            real_slots += n_part
            padded_slots += W - n_part
        self.profiler.record(key, t0, out=probe, real_tokens=real, padded_tokens=padded,
                             real_slots=real_slots, padded_slots=padded_slots)

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
            # the emit edge of this call's tool_overlap_hidden window
            self.flight.record("tool_call", rid=req.rid, index=idx, name=tc.function.name)
            REGISTRY.counter_add("acp_engine_tool_calls_early_total", 1.0,
                                 help="tool calls emitted from the decode stream before "
                                 "generation finished")
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
        sl = self._slots.get(slot)
        if sl is None:
            return
        if sl.parked:
            # its future resolved when it parked; a finish now is a cancel,
            # a stop or the drain
            self._release_parked(slot, reason=reason)
            return
        req = sl.request
        if sl.prefilling:
            # only a cancel, a replicated deadline or the drain reaches a
            # mid-prefill slot: nothing was sampled, so it fails like a
            # request never admitted
            self._drop_prefilling_slot(slot)
            self._applied.discard(req.rid)
            self.flight.record("cancel", rid=req.rid, slot=slot, where="mid_prefill",
                               reason=reason)
            self.flight.discard(req.rid)
            if not req.future.done():
                if reason == "cancelled":
                    req.future.cancel()
                else:
                    req.future.set_exception(RuntimeError("engine stopped"))
            return
        if reason in ("stop", "length"):
            # a cancelled or drained request fires no late tool calls
            self._stream_flush(req)
        if req.early_calls:
            # the overlap this turn made available: from each call becoming
            # dispatchable to the generation's end
            now = time.monotonic()
            saved = sum(now - t for t, _ in req.early_calls)
            self.tool_overlap_saved_s += saved
            REGISTRY.counter_add("acp_engine_tool_overlap_saved_seconds", saved,
                                 help="per early tool call, seconds between its dispatch "
                                 "becoming possible and its turn's generation finishing")
        if (req.park and reason in ("stop", "length") and not self._stopping
                and self._park_cut_for(sl) > 0):
            self._park(slot, sl)
            self._resolve_result(sl, reason, slot)
            return
        kv_entry = None
        if req.export_kv and reason in ("stop", "length") and not self._stopping:
            # the handoff: the prompt's rows out before the pages go
            kv_entry = self._export_kv_handoff(slot, sl)
        self._slots.pop(slot)
        self._release_slot(slot)
        self._applied.discard(req.rid)
        self._resolve_result(sl, reason, slot, kv_entry)

    def _release_slot(self, slot: int) -> None:
        """A vacated slot: its mirrors zeroed, its id and (paged) pages
        returned."""
        self._state_dirty = True  # the lane must be re-uploaded inactive
        self._seq_lens[slot] = 0
        self._last_tokens[slot] = 0
        self._con_states[slot] = 0
        self._constrained[slot] = False
        heapq.heappush(self._free, slot)
        if self._paged:
            self._allocator.free(self._slot_pages.pop(slot, []))
            self._block_tables[slot, :] = TRASH_PAGE
            self._tables_dirty = True

    def _resolve_result(self, sl: _Slot, reason: str, slot: int = -1,
                        kv_entry: Optional[HostKVEntry] = None) -> None:
        """Resolve a slot's future with its result: at a finish, and at a
        park (the caller gets its result at once; only the KV lingers). The
        timeline's ``finish`` and its phase export come BEFORE the future
        resolves, so a caller that reads the timeline at once sees it
        whole."""
        req = sl.request
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
            preempt_count=req.preempt_count,
            kv_handoff=kv_entry,
        )
        self.flight.finish(req.rid, reason, slot=slot, trace=req.trace, tokens=len(gen),
                           preempts=req.preempt_count)
        if not req.future.done():
            req.future.set_result(result)
        self._count_result(gen)

    @staticmethod
    def _count_result(gen: list[int]) -> None:
        """A resolved generation in the request and token counters."""
        REGISTRY.counter_add("acp_engine_requests_total", 1.0)
        REGISTRY.counter_add("acp_engine_tokens_total", float(len(gen)))

    # -- lazy page growth and preempt-and-resume -------------------------

    def _ensure_pages_for_block(self, need_tokens: Optional[dict] = None) -> None:
        """Every decoding slot's table must cover the block's K tokens
        before dispatch (or ``need_tokens[slot]`` rows: a verify pass writes
        1 + draft rows); the CUDA walk reads only its table, so a short
        table would silently drop rows. Pass 1 gives each slot exactly the
        pages this dispatch needs (preempting when the pool can't). Pass 2
        tops the slots whose table changed this round up to
        ``page_lookahead_blocks`` dispatches ahead, so a slot re-uploads its
        table once per window, not at every page crossing; a failed top-up
        is harmless."""
        if self._faults.enabled:
            self._faults.apply_page_pressure(self._allocator)
        K = self.decode_block_size
        crossed: list[int] = []
        for slot in list(self._slots):
            sl = self._slots.get(slot)
            if sl is None or sl.parked or sl.prefilling:
                # preempted for an earlier slot, or not decoding (a
                # prefilling slot reserved its row's pages at admission)
                continue
            # the context edge deactivates the lane on the device at
            # max_ctx - 1, so a full table always suffices
            need = K if need_tokens is None else need_tokens.get(slot, K)
            needed = min(-(-(int(self._seq_lens[slot]) + need) // self.page_size),
                         self.max_pages_per_seq)
            have = len(self._slot_pages.get(slot, []))
            if needed <= have:
                continue
            new_pages = self._alloc_with_preemption(needed - have, slot, need_tokens)
            if new_pages is None:
                continue  # the slot itself was preempted
            self._append_pages(slot, new_pages)
            crossed.append(slot)
        # a verify pass writes up to spec_len + 1 rows: the window covers
        # whichever dispatch is wider
        ahead = max(K, self.spec_len + 1) * self.page_lookahead_blocks
        for slot in crossed:
            if slot not in self._slot_pages:
                continue
            want = min(-(-(int(self._seq_lens[slot]) + ahead) // self.page_size),
                       self.max_pages_per_seq)
            have = len(self._slot_pages[slot])
            if want <= have:
                continue
            try:
                self._append_pages(slot, self._allocator.alloc(want - have))
            except MemoryError:
                pass  # the pool is tight: strict coverage already holds

    def _alloc_reclaiming_lookahead(self, n: int, requester: int,
                                    need_tokens: Optional[dict] = None) -> Optional[list[int]]:
        """Allocate ``n`` pages; on exhaustion take back other slots'
        unused lookahead (pages past their strict need for this dispatch)
        and retry, so earlier top-ups never preempt a slot that strictly
        fits. The floor honours ``need_tokens``: a later slot's allocation
        in the same pass must not strip the pages an earlier slot was just
        given for its draft rows, or the pass would write them to the
        trash page while the host advances ``seq_len`` over them."""
        try:
            return self._allocator.alloc(n)
        except MemoryError:
            pass
        K = self.decode_block_size
        reclaimed = False
        for slot, sl in self._slots.items():
            table = self._slot_pages.get(slot)
            if slot == requester or not table or sl.parked or sl.prefilling:
                # a parked slot is trimmed to its cut; a prefilling slot's
                # pages are the reservation its chunks write into
                continue
            need = K if need_tokens is None else max(K, need_tokens.get(slot, K))
            strict = min(-(-(int(self._seq_lens[slot]) + need) // self.page_size),
                         self.max_pages_per_seq)
            if len(table) > strict:
                excess = table[strict:]
                del table[strict:]
                self._block_tables[slot, strict: strict + len(excess)] = TRASH_PAGE
                self._allocator.free(excess)
                self._tables_dirty = True
                reclaimed = True
        if not reclaimed:
            return None
        try:
            return self._allocator.alloc(n)
        except MemoryError:
            return None

    def _alloc_with_preemption(self, n: int, requester: int,
                               need_tokens: Optional[dict] = None) -> Optional[list[int]]:
        """Allocate ``n`` pages for a decoding slot, escalating: others'
        lookahead, parked slots, prefix-cache entries (cache never starves
        live work), then policy victims until it fits or the requester is
        the victim. None iff the requester was preempted."""
        while True:
            pages = self._alloc_reclaiming_lookahead(n, requester, need_tokens)
            if pages is not None:
                return pages
            if self._release_lru_parked():
                continue
            if self._evict_one_prefix_entry():
                continue
            victim = self._pick_victim()
            if victim is None:
                victim = requester
            self._preempt(victim)
            if victim == requester:
                return None

    def _pick_victim(self) -> Optional[int]:
        """Parked slots first (oldest park: their callers have their
        results), then the fewest sampled tokens (least work lost, the
        cheapest resume; a mid-prefill slot has sampled none, so those go
        first), ties to the most recently admitted (the oldest keep their
        progress, as front-of-queue resumes do)."""
        if not self._slots:
            return None
        parked = [(sl.parked_at, s) for s, sl in self._slots.items() if sl.parked]
        if parked:
            return min(parked)[1]
        return min(self._slots, key=lambda s: (
            len(self._slots[s].generated) - self._slots[s].prefix_len,
            -self._slots[s].admit_seq,
        ))

    def _preempt(self, slot: int, reason: str = "pool_pressure") -> None:
        """Evacuate a decoding or mid-prefill slot without finishing it:
        save its sampled tokens on the request, free its pages and requeue
        it at the FRONT. Re-admitted, it prefills prompt + partial and
        decodes on; its greedy result is byte-identical to an uncontended
        run and only ``preempt_count`` shows it. With the host tier its
        written rows are copied out before the pages go, and the resume
        restores them instead of prefilling them again."""
        if self._slots[slot].parked:
            self._release_parked(slot, reason=reason)  # nothing to save
            return
        sl = self._slots.pop(slot)
        req = sl.request
        if sl.prefilling:
            # nothing sampled in this admission: the partial prompt KV goes
            # with the pages and the row restarts from its reuse start. Its
            # resume_tokens stay: a resumed request preempted again
            # mid-prefill keeps what it sampled before
            self._prefilling_count -= 1
            self._unshare_followers(slot, sl)
        else:
            req.resume_tokens = list(sl.generated[sl.prefix_len:])
        rows_written = sl.prefill_pos if sl.prefilling else int(self._seq_lens[slot])
        if not self._swap_out(slot, sl, reason="preempt"):
            # no host copy landed: the resume recomputes the written KV, so
            # its goodput becomes waste
            self.profiler.reclassify("preempt_discard", rows_written)
        req.preempt_count += 1
        self.preemptions += 1
        self._release_slot(slot)
        REGISTRY.counter_add("acp_engine_preemptions_total", 1.0,
                             help="slots preempted (and requeued) under KV pool pressure")
        self.flight.record("preempt", rid=req.rid, slot=slot, reason=reason,
                           sampled=len(req.resume_tokens), count=req.preempt_count,
                           mid_prefill=sl.prefilling)
        # a request that can't fit the WHOLE pool can never resume: finish
        # it at its current length (real exhaustion, not contention). A slot
        # always holds max_ctx rows
        if self._paged:
            ever = min(-(-(len(self._full_row(req)) + self.decode_block_size) // self.page_size),
                       self.max_pages_per_seq)
            if ever > self._allocator.num_pages - 1:
                log.warning("rid %s needs %d pages to resume but the pool has %d; finishing "
                            "at its current length", req.rid, ever,
                            self._allocator.num_pages - 1)
                self._resolve_preempted_as_length(req)
                return
        self._waiting.appendleft(req)
        log.info("preempted rid %s (slot %d, %d tokens sampled, preempt #%d); requeued at "
                 "the front", req.rid, slot, len(req.resume_tokens), req.preempt_count)

    def _resolve_preempted_as_length(self, req: _Request) -> None:
        """The end of a preempted request that can never fit the pool
        again: resolve with what it generated, finish reason "length"."""
        gen = list(req.sampling.forced_prefix) + list(req.resume_tokens)
        if gen and gen[-1] in self.tokenizer.stop_tokens:
            gen = gen[:-1]
        self.finished.append((req.rid, tuple(gen), "length"))
        now = time.monotonic()
        result = GenerationResult(
            text=self.tokenizer.decode(gen),
            tokens=gen,
            finish_reason="length",
            prompt_tokens=len(req.prompt),
            ttft_ms=(req.first_token_at - req.enqueued) * 1e3,
            latency_ms=(now - req.enqueued) * 1e3,
            preempt_count=req.preempt_count,
        )
        self.flight.finish(req.rid, "length", trace=req.trace, tokens=len(gen),
                           preempts=req.preempt_count)
        if not req.future.done():
            req.future.set_result(result)
        self._count_result(gen)

    def _append_pages(self, slot: int, new_pages: list[int]) -> None:
        table = self._slot_pages[slot]
        have = len(table)
        self._block_tables[slot, have: have + len(new_pages)] = new_pages
        table.extend(new_pages)
        self._tables_dirty = True

    # -- parked slots ----------------------------------------------------

    def _park_cut_for(self, sl: _Slot) -> int:
        """The rows a parked slot lends the next turn: its PROMPT rows only
        (the next turn re-renders the assistant message, so generated KV
        never matches), page-aligned on the paged layout (a continuation
        starts on a page)."""
        if self._paged:
            return (sl.prompt_len // self.page_size) * self.page_size
        return sl.prompt_len

    def _park(self, slot: int, sl: _Slot) -> None:
        """Park a finished slot: it keeps its id and its prompt's pages
        (the rest are freed) until the conversation's next turn adopts it,
        pressure releases it or it expires. The lane is inactive from the
        next block on."""
        self._state_dirty = True
        self._applied.discard(sl.request.rid)
        cut = self._park_cut_for(sl)
        sl.parked = True
        sl.parked_at = time.monotonic()
        sl.park_cut = cut
        self._parked_count += 1
        self._seq_lens[slot] = cut  # the rows that stay meaningful
        self._last_tokens[slot] = 0
        self._con_states[slot] = 0
        self._constrained[slot] = False
        self._budgets[slot] = 0
        if self._paged:
            keep = cut // self.page_size
            table = self._slot_pages.get(slot, [])
            if len(table) > keep:
                excess = table[keep:]
                del table[keep:]
                self._block_tables[slot, keep: keep + len(excess)] = TRASH_PAGE
                self._allocator.free(excess)
                self._tables_dirty = True
        self.parks += 1
        REGISTRY.counter_add("acp_engine_parks_total", 1.0,
                             help="slots parked at generation end awaiting the "
                             "conversation's next turn")
        self.flight.record("park", rid=sl.request.rid, slot=slot, cut=cut)
        self._publish_park_gauge()

    def _release_parked(self, slot: int, reason: str = "pressure") -> None:
        """Free a parked slot entirely (pressure, expiry, stop, or a
        preemption landing on it): its future resolved at park time. Its
        prompt KV may still serve the same persona or conversation later,
        so pressure and expiry copy it to the host tier first."""
        sl = self._slots.get(slot)
        if sl is None or not sl.parked:
            return
        if reason in ("pressure", "expired", "pool_pressure", "fault"):
            self._swap_out(slot, sl, reason=f"park_{reason}")
        self.flight.record("park_release", rid=sl.request.rid, slot=slot, reason=reason)
        # the timeline was retired when the park resolved the future: the
        # release extends the finished timeline, leaving no live orphan
        self.flight.discard(sl.request.rid)
        self._slots.pop(slot)
        self._parked_count -= 1
        self._release_slot(slot)
        self.park_releases += 1
        self._publish_park_gauge()
        log.debug("released parked slot %d (%s)", slot, reason)

    def _publish_park_gauge(self) -> None:
        REGISTRY.gauge_set("acp_engine_parked_slots", float(self._parked_count),
                           help="slots parked at generation end, prompt KV resident, "
                           "awaiting the conversation's next turn")

    def _release_lru_parked(self, exclude: Optional[int] = None) -> bool:
        """Release the longest-parked slot but ``exclude``. True if one
        yielded."""
        parked = [(sl.parked_at, s) for s, sl in self._slots.items()
                  if sl.parked and s != exclude]
        if not parked:
            return False
        self._release_parked(min(parked)[1])
        return True

    def _sweep_parked(self) -> None:
        """Expire parked slots whose next turn never came. Reads the wall
        clock: never under a group, where park_max_s is 0."""
        if not self.park_max_s or not self._parked_count:
            return
        now = time.monotonic()
        for slot in [s for s, sl in self._slots.items()
                     if sl.parked and now - sl.parked_at > self.park_max_s]:
            self._release_parked(slot, reason="expired")

    def _match_parked(self, req: _Request) -> Optional[int]:
        """The parked slot whose prompt covers the longest strict prefix of
        this request's row: the conversation's previous turn."""
        if req.truncated or not self._parked_count:
            return None
        full = self._full_row(req)
        best, best_cut = None, 0
        for slot, sl in self._slots.items():
            cut = sl.park_cut
            if (sl.parked and 0 < cut < len(full) and cut > best_cut
                    and list(sl.request.prompt[:cut]) == full[:cut]):
                best, best_cut = slot, cut
        return best

    def _adopt_parked(self, req: _Request, slot: int) -> Optional[list]:
        """Hand a parked slot to the head request, its conversation's next
        turn: ``[group item]``, ``[]`` when the head was refused (bigger
        than the pool), or None when pages ran short even after other
        parked slots and cache entries yielded (the slot stays parked). A
        slot-layout slot already holds max_ctx rows: nothing to reserve."""
        cut = self._slots[slot].park_cut
        pages: Optional[list[int]] = None
        if self._paged:
            total_pages = -(-len(self._full_row(req)) // self.page_size)
            if self._reject_oversize_head(req, total_pages):
                return []
            kept = list(self._slot_pages.get(slot, []))
            fresh = self._alloc_yielding(total_pages - len(kept), exclude=slot)
            if fresh is None:
                return None
            # the whole list now: a dedup follower later in this group may
            # pick the adopter as its leader and must share past the park cut
            pages = kept + fresh
            self._slot_pages[slot] = pages
        self._slots.pop(slot)  # the new turn takes the slot over in place
        self._parked_count -= 1
        self.park_adoptions += 1
        self.flight.record("adopt", rid=req.rid, slot=slot, cut=cut)
        REGISTRY.counter_add("acp_engine_park_adoptions_total", 1.0,
                             help="parked slots adopted by their conversation's next turn "
                             "(suffix-only prefill)")
        self._publish_park_gauge()
        self._waiting.popleft()
        return [(req, slot, pages, (None, {"cut": cut, "in_slot": True}))]

    # -- the host KV tier ------------------------------------------------

    def set_host_kv_bytes(self, n: int) -> None:
        """Resize the host KV tier (0 disables it) on an idle engine, for
        A/B runs on one warm engine; shrinking evicts the LRU entries past
        the new budget."""
        self.host_kv_bytes = max(0, int(n))
        if not self.host_kv_bytes:
            self._host_pool = None
        elif self._host_pool is None:
            self._host_pool = HostKVPool(self.host_kv_bytes)
        else:
            pool = self._host_pool
            pool.max_bytes = self.host_kv_bytes
            while pool.used_bytes > pool.max_bytes and len(pool):
                pool.pop(next(iter(pool._entries)))
        self._publish_memory_state()

    def inject_host_kv(self, entry: HostKVEntry) -> bool:
        """Land a ``HostKVEntry`` (another engine's ``kv_handoff``) in this
        engine's host tier; thread-safe. The engine thread commits it at
        the top of the next admission, before matching, so a request
        submitted after the inject sees it. False when the tier is off or
        the engine is not running (the request then prefills in full)."""
        if self._host_pool is None or self._thread is None or self._stopping:
            return False
        self._kv_inject.put(entry)
        return True

    def _drain_kv_inject(self) -> None:
        """Injected entries into the host pool (engine thread). One that no
        longer fits (the pool shrank) is dropped: its request recomputes."""
        landed = False
        while True:
            try:
                entry = self._kv_inject.get_nowait()
            except queue.Empty:
                break
            if self._host_pool is not None and self._host_pool.put(entry):
                landed = True
                self.kv_injects += 1
                self.flight.record("kv_inject", rid=entry.rid, tokens=entry.cut,
                                   bytes=entry.nbytes)
        if landed:
            self._publish_memory_state()

    def _publish_memory_state(self) -> None:
        """The mirrors stats() reads, and the memory gauges: the host tier's
        bytes, the int8 pages (0 with int8 KV off and on the slot layout:
        the series is always present) and, paged, the shared pages."""
        pool = self._host_pool
        self._host_kv_used = pool.used_bytes if pool is not None else 0
        self._host_kv_entries = len(pool) if pool is not None else 0
        if pool is not None:
            REGISTRY.gauge_set("acp_engine_host_kv_bytes", float(self._host_kv_used),
                               help="bytes of swapped-out KV resident in the host-RAM "
                               "offload tier (bounded by --tpu-host-kv-bytes)")
        REGISTRY.gauge_set(
            "acp_engine_quantized_kv_pages",
            float(self._allocator.allocated_count if self._paged and self.quantize_kv else 0),
            help="allocated KV pages currently holding int8-quantized KV (with per-row scale "
            "storage); 0 unless quantize_kv is on")
        if self._paged:
            REGISTRY.gauge_set(
                "acp_engine_prefix_shared_pages", float(self._allocator.shared_count),
                help="HBM KV pages currently refcount-shared by more than one owner "
                "(cross-request shared-prefix dedup + prefix cache)")

    def _swap_min_rows(self) -> int:
        """Rows below this are not worth a host round trip: one page
        (paged), 8 rows (slot)."""
        return self.page_size if self._paged else 8

    def _row_cut(self, rows: int) -> int:
        """A host-tier cut: page-aligned on the paged layout (restores land
        whole pages), any row on the slot layout."""
        return (rows // self.page_size) * self.page_size if self._paged else rows

    def _match_host(self, req: _Request, full: list[int]) -> tuple:
        """Admission's host-tier candidate: the entry swapped out under this
        rid (preempt -> resume) if its tokens are a strict prefix of the
        row, else the longest token-prefix entry; ``(entry, cut)`` with the
        cut page-aligned below the row's last token, or ``(None, 0)``. A
        peek: the entry is consumed only once the reservation holds."""
        pool = self._host_pool
        if pool is None or req.truncated:
            return None, 0
        e = pool.get(req.rid)
        if e is not None and not (0 < e.cut < len(full) and tuple(full[: e.cut]) == e.tokens):
            e = None
        if e is None:
            e = pool.match_prefix(full)
        if e is None:
            return None, 0
        cut = self._row_cut(min(e.cut, len(full) - 1))
        if cut < self._swap_min_rows():
            return None, 0
        return e, cut

    def _swap_out(self, slot: int, sl: _Slot, reason: str) -> bool:
        """Copy a slot's written rows to the host pool right before its
        pages are released (``reason``: preempt, expire, park_<why>): rows
        ``[0, cut)``, the cut page-aligned and below the row's last token,
        a bit-exact copy, so a later restore gives what a recompute would.
        A slot preempted mid-restore re-puts its whole consumed entry, with
        no copy, under its own rid. No swap for a dedup follower still
        waiting (its shared rows may be unwritten), a truncated request, or
        fewer than a page of rows. True when an entry landed."""
        pool = self._host_pool
        if pool is None or self._stopping:
            return False
        req = sl.request
        if req.truncated or sl.share_of is not None:
            return False
        if sl.prefilling:
            rows = sl.prefill_pos
        elif sl.parked:
            rows = sl.park_cut
        else:
            rows = int(self._seq_lens[slot])
        row = self._full_row(req)
        cut = self._row_cut(min(rows, len(row) - 1))
        restoring = sl.prefilling and sl.swap_entry is not None
        if cut < self._swap_min_rows() and not restoring:
            return False
        t0 = time.monotonic()
        if self._faults.enabled:
            if self._faults.pop("engine.host_swap_error") is not None:
                # the copy failed: no entry lands, the resume recomputes
                self.flight.record("swap_out", rid=req.rid, slot=slot, reason=reason, error=True)
                return False
            spec = self._faults.pop("engine.host_swap_slow")
            if spec is not None:
                # inside the timed window: the injected delay is host_stall
                time.sleep(float(spec.get("seconds", 0.05)))
        if restoring:
            entry = sl.swap_entry
            if entry.rid != req.rid:
                entry = HostKVEntry(rid=req.rid, tokens=entry.tokens, k=entry.k, v=entry.v,
                                    k_scale=entry.k_scale, v_scale=entry.v_scale)
        else:
            out = self._extract(slot, cut)
            entry = HostKVEntry(rid=req.rid, tokens=tuple(row[:cut]), k=out["k"], v=out["v"],
                                k_scale=out.get("ks"), v_scale=out.get("vs"))
        if not pool.put(entry):
            return False  # bigger than the whole budget: the resume recomputes
        stall = time.monotonic() - t0
        self.kv_swap_outs += 1
        REGISTRY.counter_add("acp_engine_kv_swap_out_total", 1.0,
                             help="KV offloads to the host-RAM tier (preemption, park expiry, "
                             "and mid-prefill deadline drops that would otherwise discard "
                             "written KV)")
        self.flight.record("swap_out", rid=req.rid, slot=slot, reason=reason, tokens=entry.cut,
                           bytes=entry.nbytes, stall_s=round(stall, 6))
        self._publish_memory_state()
        return True

    def _export_kv_handoff(self, slot: int, sl: _Slot) -> Optional[HostKVEntry]:
        """The prefill -> decode handoff unit of a finishing ``export_kv``
        request: ``_swap_out``'s page-aligned rows ``[0, cut)``, attached to
        the result as ``handoff-<rid>`` instead of landing in this engine's
        pool. None for a truncated prompt, a dedup follower or too few
        rows."""
        req = sl.request
        if req.truncated or sl.share_of is not None:
            return None
        row = self._full_row(req)
        cut = self._row_cut(min(int(self._seq_lens[slot]), len(row) - 1))
        if cut < self._swap_min_rows():
            return None
        t0 = time.monotonic()
        out = self._extract(slot, cut)
        entry = HostKVEntry(rid=f"handoff-{req.rid}", tokens=tuple(row[:cut]), k=out["k"],
                            v=out["v"], k_scale=out.get("ks"), v_scale=out.get("vs"))
        self.flight.record("handoff_export", rid=req.rid, slot=slot, tokens=cut,
                           bytes=entry.nbytes, stall_s=round(time.monotonic() - t0, 6))
        return entry

    def _extract(self, slot: int, cut: int) -> dict[str, torch.Tensor]:
        """Rows ``[0, cut)`` of a slot to host tensors, token-major."""
        if self._paged:
            return self._extract_pages(self._slot_pages[slot][: cut // self.page_size])
        return self._extract_rows(slot, cut)

    def _extract_rows(self, slot: int, cut: int) -> dict[str, torch.Tensor]:
        """The slot layout's ``_extract_pages``: rows ``[0, cut)`` of
        ``slot`` to host tensors ``{"k"/"v": [L, cut, H_kv, d]}`` (plus the
        int8 cache's ``{"ks"/"vs": [L, cut, H_kv]}``), sliced in pow2 row
        groups; on the card each cache tensor goes device -> host in ONE
        copy into pinned memory, and one event joins them all."""
        groups, start = [], 0
        for n in _pow2_sizes(cut):
            prof_t0 = self.profiler.start()
            groups.append({name: a[:, slot, start: start + n] for name, a in self.cache.items()})
            self.profiler.record(f"swap_extract[{n}]", prof_t0, out=groups[-1]["k"],
                                 real_tokens=n)
            start += n
        return self._to_host({name: torch.cat([g[name] for g in groups], dim=1)
                              for name in self.cache})

    def _to_host(self, rows: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Device rows to host tensors: on the card one copy per tensor into
        pinned memory, joined on one event before the entry may be read."""
        if not self._pin:
            return rows  # fresh tensors already (a gather or a cat)
        out = {}
        for name, a in rows.items():
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            out[name] = host
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return out

    def _extract_pages(self, pages: list[int]) -> dict[str, torch.Tensor]:
        """Gather whole pages to host tensors, token-major: ``{"k"/"v": [L,
        n*P, H_kv, d]}`` plus ``{"ks"/"vs": [L, n*P, H_kv]}`` for an int8
        pool (its bytes and scales verbatim). The gathers run in pow2 page
        groups; on the card each pool tensor goes device -> host in ONE
        copy into pinned memory, and one event joins them all before the
        entry may be read."""
        L, P = self.config.n_layers, self.page_size
        groups, i = [], 0
        for m in _pow2_sizes(len(pages)):
            prof_t0 = self.profiler.start()
            ids = self._upload(np.asarray(pages[i: i + m], dtype=np.int64))
            groups.append({name: a.index_select(1, ids) for name, a in self.cache.items()})
            self.profiler.record(f"swap_gather[{m}]", prof_t0, out=groups[-1]["k"],
                                 real_tokens=m * P)
            i += m
        rows = {}
        for name, a in self.cache.items():
            parts = [g[name] for g in groups]
            rows[name] = (torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]).reshape(
                L, len(pages) * P, *a.shape[3:])
        return self._to_host(rows)

    def _swap_in_cut(self, sl: _Slot) -> int:
        """Rows a mid-restore slot takes from its entry: the entry's cut,
        page-aligned on the paged layout and never past the strict-prefix
        edge of the row."""
        return self._row_cut(min(sl.swap_entry.cut, len(sl.prefill_row) - 1))

    def _entry_rows(self, entry: HostKVEntry) -> dict[str, torch.Tensor]:
        """An entry's host tensors by cache name; an int8 cache needs the
        entry's scale rows."""
        rows = {"k": entry.k, "v": entry.v}
        if "ks" in self.cache:
            if entry.k_scale is None:
                raise RuntimeError("an entry without scale rows cannot restore into an int8 pool")
            rows.update(ks=entry.k_scale, vs=entry.v_scale)
        return rows

    def _swap_groups(self, slot: int, entry: HostKVEntry, start: int, n: int) -> list:
        """Rows ``[start, start + n)`` of ``entry`` on the device, as the
        pow2 page groups the scatter writes: ``[(page ids, {name: [L, m, P,
        ...]})]``. On the card the copies are issued on the current stream,
        one per layer and pool tensor (a layer's rows are contiguous in
        host memory), asynchronous from pinned memory."""
        P = self.page_size
        pages = self._slot_pages[slot][start // P: (start + n) // P]
        if TRASH_PAGE in pages:
            raise RuntimeError(f"slot {slot}: a restore would write the trash page")
        rows = self._entry_rows(entry)
        groups, i = [], 0
        for m in _pow2_sizes(len(pages)):
            lo, hi = start + i * P, start + (i + m) * P
            ids = torch.tensor(pages[i: i + m], dtype=torch.int64)
            if self._pin:
                ids = ids.pin_memory().to(self.device, non_blocking=True)
            blocks = {}
            for name, a in rows.items():
                if self._pin:
                    dev = torch.empty((a.shape[0], hi - lo, *a.shape[2:]), dtype=a.dtype,
                                      device=self.device)
                    for layer in range(a.shape[0]):
                        dev[layer].copy_(a[layer, lo:hi], non_blocking=True)
                else:
                    dev = a[:, lo:hi]
                blocks[name] = dev.reshape(a.shape[0], m, P, *a.shape[2:])
            groups.append((ids, blocks))
            i += m
        return groups

    def _scatter(self, groups: list) -> None:
        """Write restored page groups into the pools, by page id along dim 1
        of each pool tensor (in place). On the card the blocks are marked
        as used by the current stream, so a staged copy's memory is not
        reused before its scatter has run."""
        cur = torch.cuda.current_stream(self.device) if self._pin else None
        for ids, blocks in groups:
            prof_t0 = self.profiler.start()
            if cur is not None:
                ids.record_stream(cur)
            for name, b in blocks.items():
                if cur is not None:
                    b.record_stream(cur)
                self.cache[name].index_copy_(1, ids, b)
            # a sampled wait on the current stream covers the staged copies
            # too: the stream waited on the side stream's event first
            self.profiler.record(f"swap_scatter[{int(ids.shape[0])}]", prof_t0,
                                 out=self.cache["k"], real_tokens=int(ids.shape[0]) * self.page_size)

    def _swap_in_rows(self, slot: int, entry: HostKVEntry, start: int, n: int) -> float:
        """The blocking restore of rows ``[start, start + n)`` into the
        slot: paged, into its pages (page-aligned; the host -> device
        copies, a wait until they land, the scatter); slot, into its rows
        in pow2 row groups. Returns the engine-thread seconds it blocked."""
        t0 = time.monotonic()
        if not self._paged:
            rows, pos = self._entry_rows(entry), start
            while pos < start + n:
                m = _pow2_sizes(start + n - pos)[0]
                prof_t0 = self.profiler.start()
                for name, a in rows.items():
                    self.cache[name][:, slot, pos: pos + m].copy_(a[:, pos: pos + m])
                self.profiler.record(f"swap_restore[{m}]", prof_t0, out=self.cache["k"],
                                     real_tokens=m)
                pos += m
            return time.monotonic() - t0
        groups = self._swap_groups(slot, entry, start, n)
        if self._pin:
            torch.cuda.current_stream(self.device).synchronize()
        self._scatter(groups)
        return time.monotonic() - t0

    def _stage_swap_in(self, slot: int, sl: _Slot) -> None:
        """The prefetch's stage half: the NEXT restore chunk's rows start
        host -> device on a side stream, in the blocking path's page groups,
        and an event marks their arrival. No page is written until the
        commit half scatters them next cycle, so a slot that leaves first
        just drops them."""
        start = sl.prefill_pos
        n = min(self._slot_chunk_tokens(sl, self._chunk_tokens()), self._swap_in_cut(sl) - start)
        if n <= 0:
            sl.swap_staged = None
            return
        event = None
        if self._pin:
            if self._swap_stream is None:
                self._swap_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._swap_stream):
                groups = self._swap_groups(slot, sl.swap_entry, start, n)
            event = torch.cuda.Event()
            event.record(self._swap_stream)
        else:
            groups = self._swap_groups(slot, sl.swap_entry, start, n)
        sl.swap_staged = {"start": start, "n": n, "groups": groups, "event": event}

    @staticmethod
    def _staged_for(sl: _Slot, start: int, n: int) -> Optional[dict]:
        """The slot's staged rows if they are exactly this chunk's."""
        st = sl.swap_staged
        return st if st is not None and st["start"] == start and st["n"] == n else None

    def _scatter_staged(self, staged: dict) -> None:
        """The commit half: the compute stream waits for the staged copies,
        then scatters them."""
        if staged["event"] is not None:
            torch.cuda.current_stream(self.device).wait_event(staged["event"])
        self._scatter(staged["groups"])

    def _count_prefetch_commit(self) -> None:
        self.kv_prefetch_commits += 1
        REGISTRY.counter_add("acp_engine_kv_prefetch_commits_total", 1.0,
                             help="host-KV restore chunks whose rows were prefetched (staged "
                             "host->device a cycle early) and landed by scatter commit")

    def _commit_staged_swap(self, staged: dict) -> float:
        """A staged chunk's split commit; returns the seconds it blocked."""
        t0 = time.monotonic()
        self._scatter_staged(staged)
        self._count_prefetch_commit()
        return time.monotonic() - t0

    def _run_restores(self, restores: list, defer: bool = False) -> tuple:
        """Land this round's restore chunks ``(slot, sl, start, n)``: a chunk
        staged last cycle commits its staged rows, any other runs the
        blocking copy. With ``defer`` (the cycle fuses) a staged chunk is
        returned instead, as ``(slot, sl, start, n, staged)``, for the
        megastep's swaps phase. Returns ``(aborted slots, refunded tokens,
        deferred)``: a restore ``engine.host_swap_error`` cancelled
        dispatched nothing, so its budget refunds and its rows are
        recomputed by model chunks; a stage ``engine.prefetch_error``
        aborts takes the blocking copy, which lands the same rows."""
        aborted: set[int] = set()
        refund = 0
        deferred: list = []
        if not restores:
            return aborted, refund, deferred
        with self._hol_clock():
            for slot, sl, st, n in restores:
                if self._faults.enabled and st == 0:
                    spec = self._faults.pop("engine.host_swap_slow")
                    if spec is not None:
                        slow = float(spec.get("seconds", 0.05))
                        time.sleep(slow)
                        sl.swap_stall_s += slow  # attributed as host_stall
                    if self._faults.pop("engine.host_swap_error") is not None:
                        self.flight.record("swap_in", rid=sl.request.rid, slot=slot, error=True)
                        # the preserved rows are recomputed after all
                        self.profiler.reclassify("swap_recompute", self._swap_in_cut(sl))
                        sl.swap_entry = None
                        sl.swap_staged = None
                        aborted.add(slot)
                        refund += n
                        continue
                staged = self._staged_for(sl, st, n)
                sl.swap_staged = None
                if staged is not None and self._faults.enabled:
                    if self._faults.pop("engine.prefetch_error") is not None:
                        self.flight.record("prefetch_abort", rid=sl.request.rid, slot=slot,
                                           start=st)
                        staged = None
                if staged is not None and defer:
                    deferred.append((slot, sl, st, n, staged))
                    continue
                if staged is not None:
                    sl.swap_stall_s += self._commit_staged_swap(staged)
                else:
                    sl.swap_stall_s += self._swap_in_rows(slot, sl.swap_entry, st, n)
                self._advance_restore(slot, sl, st, n)
        return aborted, refund, deferred

    def _advance_restore(self, slot: int, sl: _Slot, st: int, n: int) -> None:
        """A restore chunk landed: the slot's rows advance; at the cut the
        restore is done, else the next chunk is staged."""
        sl.prefill_pos = st + n
        self._seq_lens[slot] = sl.prefill_pos
        if sl.prefill_pos >= self._swap_in_cut(sl):
            self._finish_swap_in(slot, sl)
        elif self.host_prefetch and self._paged:  # the slot layout's copy is blocking
            self._stage_swap_in(slot, sl)

    def _finish_swap_in(self, slot: int, sl: _Slot) -> None:
        """The restore reached its cut: the slot is a plain mid-prefill slot
        from here, and model chunks prefill the rest of its row."""
        self.kv_swap_ins += 1
        REGISTRY.counter_add("acp_engine_kv_swap_in_total", 1.0,
                             help="host-tier KV restores completed (re-admissions that "
                             "swapped rows back in instead of re-running prefill)")
        self.flight.record("swap_in", rid=sl.request.rid, slot=slot, tokens=sl.prefill_pos,
                           stall_s=round(sl.swap_stall_s, 6))
        sl.swap_entry = None
        self._publish_memory_state()
