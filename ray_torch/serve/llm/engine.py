"""Continuous-batching LLM engine: the PyTorch counterpart of
``ray_tpu/serve/llm/engine.py``, with the same public API and the same
``engine_stats()`` key names for what it supports.

Requests enter a waiting queue; the engine loop admits them into fixed
decode slots (prefill — full, or chunked when the prompt is long or a
cached prefix was matched), then repeatedly dispatches decode blocks of
1..K steps across all active slots and streams sampled tokens out per
request.

How the reference's JAX machinery maps onto PyTorch:
- the jitted, donated programs are plain functions that update the KV pool
  and the device-resident slot state IN PLACE (where JAX donated the
  buffers and received new ones);
- a multi-step decode block is a loop of K steps whose input tokens are
  the previous step's on-device samples, so the host never waits between
  them;
- the reference's jitted decode program (one per (packed width, block
  length)) and verify-k program (one per packed width) are each a
  captured CUDA graph on the card (``LLMConfig.cuda_graphs``; a
  ``_Program`` per signature): captured where the reference compiles
  (warmup, else first use, inside the same ``compile_scope``) after one
  eager warm run on a side stream, and replayed on static inputs (the
  index vector, the drafts) that every dispatch fills in place. With
  graphs off, and on the CPU, the same functions run eagerly on the same
  static inputs;
- the reference's prefill program (one per prompt bucket) and chunk
  program (one per chunk length) are likewise a captured graph each on
  the card (``_prompt_programs``): captured at first use inside the same
  ``compile_scope``, as the reference's jit compiles them, and replayed
  on static inputs (tokens, page table, ``true_len``, ``start``,
  temperature) that each prompt pass fills in place; the first token is
  sampled inside the graph and cloned behind the replay. With graphs off
  the prompt passes run eagerly as plain calls. All graphs share one
  memory pool. Slot patches stay eager;
- the host harvests sampled tokens ``pipeline_depth`` blocks behind: each
  block's tokens start a ``non_blocking`` copy into pinned host memory at
  dispatch time and record a CUDA event; ``event.query()`` is the
  readiness probe (``is_ready`` in the reference) and ``synchronize()``
  the blocking harvest;
- the slot state keeps a PERMANENT TRASH ROW (row ``max_batch_size``):
  packed decode widths pad their index vector with it, so padding lanes
  write only into the trash page; slot patches are applied at one fixed
  shape (B+1 rows, trash-row padded);
- speculative decoding (``spec_decode_enabled``) verifies a greedy slot's
  n-gram draft in one verify round (``_verify_round``: k+1 positions per
  slot through ``kv_cache.paged_verify_step``); the host bookkeeping
  around it is the reference's;
- the KV tier (``kv_tier_enabled``, kv_tier.py): prefix pages the
  allocator evicts are gathered on the device inside its spill hook
  (``_spill_capture``, stream-ordered before any write that reuses them)
  and copied into pinned host memory behind an event; the loop hands the
  copies that have landed to the store (``_kv_tier_flush``), never
  waiting on the device. A returning prompt's spilled chain streams back
  (``_restore_steps``) and is scattered IN PLACE into its pool pages
  (``index_copy_``), where the reference rebinds a donated pool: the
  captured graphs read the pool by address. The suffix is then
  chunk-prefilled from the restored frontier;
- request deadlines (``ray_torch.core.deadline``, "The Tail at Scale"):
  ``submit`` captures the caller's ambient deadline, ``result`` bounds its
  wait by it, ``_admit`` sheds waiting requests whose deadline has passed
  (no slot, no pages, no prefill) and a request whose deadline passes
  mid chunked prefill or mid restore is dropped at the next pass, its
  slot and pages given back (``stats["shed_expired"]`` counts both). A
  slotted, decoding request is not preempted;
- per-request attribution (``ray_torch.observability.attribution``):
  ``result`` and ``drain``'s final chunk carry ``request_id``,
  ``queue_wait_s`` and ``stages``, the request's ``queue`` / ``restore``
  / ``prefill`` / ``decode`` waterfall built from its stamps and the
  restore's split (``_attribution_payload``), once a request, on the
  caller's thread; the loop only stamps;
- the flight recorder (``ray_torch.observability.events``): a
  ``failover_resume`` event at a continuation's submit, ``restore_partial``
  when a tier restore stream ends short of its plan, and (from the
  profiler) ``mid_traffic_compile`` at a signature's first use after
  traffic started, a prompt graph's capture included;
- tracing (``ray_torch.observability.tracing``): ``submit`` captures the
  caller's span carrier (``inject``) and a finished request records one
  ``llm.generate`` span under it, from its submit wall clock to its end,
  with its request id and token counts;
- mid-stream failover continuations: ``submit(resume_tokens=...)`` admits
  the prompt plus the tokens a dead replica already streamed through the
  same cache-aware path (local prefix match, tier restore, chunked suffix
  prefill), and decode resumes at the exact next token;
  ``request_progress`` is the per-request journal a resume needs;
  ``spill_inflight`` pushes every live chain's computed full pages into
  the tier now (drain / SIGTERM), through the loop
  (``stats["failover_resumed"]`` / ``["failover_restored_tokens"]``).

This slice leaves out, for later slices: the tier's warm start, prefetch
hints and cluster index, the ingress prefix digests, disaggregation and
tensor parallelism. Only the fields of ``_NOT_PORTED`` (tensor parallelism
and disaggregation) raise when set; the others have no switch in the port.

Threading model: one loop thread drives the device. ``submit()`` /
``drain()`` / ``result()`` / ``cancel()`` are thread-safe.
"""

from __future__ import annotations

import functools
import gc
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ray_torch._device import resolve_device
from ray_torch.core import deadline as request_deadline
from ray_torch.models import llama
from ray_torch.observability import attribution
from ray_torch.observability import events as _fr
from ray_torch.observability import profiling as profiling_mod
from ray_torch.observability import tracing
from ray_torch.ops import _build
from ray_torch.ops import paged_attention as paged_ops
from ray_torch.serve.llm import kv_cache as kvc
from ray_torch.serve.llm import kv_tier as kvt
from ray_torch.serve.llm import spec_decode
from ray_torch.serve.llm.config import LLMConfig
from ray_torch.serve.llm.tokenizer import get_tokenizer

logger = logging.getLogger(__name__)

# LLMConfig switches of features this slice does not carry: (field, the
# only accepted value)
_NOT_PORTED = (("tp_degree", 1), ("disagg_prompt_threshold", 0),
               ("disagg_prefill_deployment", None))


@dataclass
class _Request:
    request_id: str
    prompt_tokens: list[int]
    max_tokens: int
    temperature: float
    top_k: int
    stop_token: Optional[int]
    # state
    slot: int = -1
    pages: list[int] = field(default_factory=list)
    generated: list[int] = field(default_factory=list)
    dispatched: int = 0  # tokens whose computation has been dispatched
    prefill_pos: int = 0  # prompt tokens already prefilled (chunked prefill)
    # prompt tokens served from the prefix cache (shared pages; prefill_pos
    # starts here so only the suffix is computed)
    cached_tokens: int = 0
    # cancelled while mid chunked prefill or mid restore: the loop frees
    # slot+pages promptly via _abort_prefilling instead of finishing the
    # prompt pass
    prefill_cancelled: bool = False
    # KV-tier restore accounting: decoded payload size, and the restore
    # wall time (stream open -> finalize; the stream overlaps other
    # requests' work, so wall != loop time — see restore_blocked_ms)
    restore_bytes: int = 0
    restore_ms: float = 0.0
    # the live ChainStream while this request sits in _restoring, plus the
    # codec decode time and the loop time spent on this stream
    # (take/decode/inject)
    restore_stream: Any = None
    restore_started: float = 0.0        # perf_counter at stream open
    restore_page0: int = 0              # first chain slot the stream fills
    restore_pages: int = 0              # pages injected so far
    restore_decode_ms: float = 0.0
    restore_blocked_ms: float = 0.0
    # speculative decoding: per-request n-gram proposer (spec_decode.py),
    # created lazily on the first draft attempt; spec_inflight marks a slot
    # with an unharvested verify round so the decode path never dispatches
    # it concurrently (its device seq_len is k+1 ahead until rollback)
    spec: Any = None
    spec_inflight: bool = False
    # cancelled by the client: completion also reaps the tracking entry
    abandoned: bool = False
    drained_upto: int = 0
    done: bool = False
    error: Optional[str] = None
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    # host record-time of the last token plus the per-token gaps
    last_token_at: Optional[float] = None
    itl_gaps: list[float] = field(default_factory=list)
    finished_at: Optional[float] = None
    done_event: threading.Event = field(default_factory=threading.Event)
    # end-to-end request deadline (core/deadline.py, epoch seconds),
    # captured at submit: the admission loop sheds waiting requests whose
    # deadline passed instead of prefilling answers nobody will read
    deadline: Optional[float] = None
    # attribution (observability/attribution.py): the wall clock at
    # submit, which maps the monotonic stamps onto the wall; the KV-tier
    # restore's split — tokens whose KV came back from the tier, encoded
    # bytes off the store, how much of restore_ms hid under other work
    # (restore_ms - restore_blocked_ms), and whether the stream ended
    # short of its plan (the landed pages kept, the tail re-prefilled)
    submitted_wall: float = field(default_factory=time.time)
    restored_tokens: int = 0
    restore_wire_bytes: int = 0
    restore_overlap_ms: float = 0.0
    restore_partial: bool = False
    # tracing: the caller's span carrier captured at submit (the engine
    # loop thread has no ambient span context); None when not traced
    trace_ctx: Optional[dict] = None
    # mid-stream failover: number of already-generated tokens from a dead
    # replica appended to prompt_tokens as a continuation. 0 = ordinary
    # request. Admission is unchanged — the continuation rides the same
    # prefix-match / tier-restore / chunked suffix prefill path, and
    # decode resumes at the exact next token
    resume_len: int = 0


class _Fetch:
    """Device -> host copy of sampled tokens, started at dispatch time so
    the later harvest finds the bytes already in host memory: a
    ``non_blocking`` copy into a pinned tensor plus a CUDA event recorded
    behind it on the same stream. On the CPU the tensor is already host
    memory."""

    def __init__(self, dev: torch.Tensor):
        if dev.device.type == "cuda":
            self.host = torch.empty(dev.shape, dtype=dev.dtype,
                                    pin_memory=True)
            self.host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev.device))
        else:
            self.host = dev
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class _Program:
    """One engine program's signature: decode (``("decode", width,
    block)``), verify (``("verify", width, draft_len)``), prefill
    (``("prefill", bucket)``) or chunk (``("chunk", length)``). Holds the
    static inputs that every dispatch of it fills in place (decode: the
    index vector [W]; verify: also the drafts [W, k]; prefill: tokens
    [1, L], page table [max_pages], ``true_len`` [1] and temperature [1];
    chunk: the same with ``start`` [1] before the temperature) and, with
    graphs on, its captured graph, the graph's output and the kernel
    launches one replay makes."""
    inputs: tuple
    graph: Any = None
    out: Optional[torch.Tensor] = None
    launches: dict = field(default_factory=dict)


def _cuda_graphs_on(flag: Optional[bool], device: torch.device) -> bool:
    """``LLMConfig.cuda_graphs`` for ``device``: None is on for a CUDA
    device and off on the CPU; True on the CPU raises (nothing falls back
    silently, as with ``attention_kernel="cuda"``)."""
    if flag is None:
        return device.type == "cuda"
    if flag and device.type != "cuda":
        raise ValueError(f"LLMConfig.cuda_graphs=True needs a CUDA device, "
                         f"got {device}")
    return bool(flag)


def _take_launches(before: dict) -> dict:
    """The launches counted in ``paged_attention.launches`` since
    ``before`` (a copy of it), by kernel, taken back out: a capture counts
    each launch it records, and launches nothing."""
    counts = paged_ops.launches
    delta = {k: n - before.get(k, 0) for k, n in counts.items()
             if n != before.get(k, 0)}
    counts.update(before)
    return delta


def _add_launches(delta: dict) -> None:
    """Count one replay's launches: the ones its capture recorded."""
    for k, n in delta.items():
        paged_ops.launches[k] += n


def _copy_in(dst: torch.Tensor, values: np.ndarray) -> None:
    """Copy a host array into a static input in place: on the card through
    a fresh pinned tensor, so it is asynchronous (see
    ``LLMEngine._to_device``)."""
    src = torch.from_numpy(values)
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class _CudaGraphs:
    """The engine's captured programs on the card, and their counters
    (``captures``, ``replays``, ``pool_bytes``), which ``engine_stats()``
    leaves out.

    Every graph allocates from ONE private memory pool. A graph's output is
    read once, by a device copy enqueued right behind its replay on the
    same stream (a decode block's or verify round's ``_Fetch`` copy, a
    prompt program's clone of its token), so no later replay, of the same
    graph or another, can overwrite memory that is still to be read; what
    graphs read and write across replays (weights, the KV pool, slot
    state, static inputs) lives outside the pool.

    Captures use the thread-local capture mode: a prompt program is
    captured mid-traffic, while other threads (request handlers, readers
    of ``engine_stats()``) may call CUDA, which the global mode would
    count against the capture."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self._generator = generator
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0   # device memory the captures reserved

    def capture(self, prog: _Program, body, warm: tuple) -> None:
        """Capture ``body(*prog.inputs)`` into ``prog``, after one eager run
        of ``body(*warm)`` that pays the first-use costs (the kernel
        library's attributes, cuBLAS's workspace for the stream) outside
        the capture. Both run on a side stream, ordered after the work
        already queued and before the work that follows. The sampling
        generator is registered, so every replay draws new numbers."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            graph.register_generator_state(self._generator)
            body(*warm)
            before = dict(paged_ops.launches)
            reserved = torch.cuda.memory_reserved(self.device)
            # no garbage collection while the stream captures: collecting
            # another engine's graphs resets them, which a capture in
            # progress does not permit (it invalidates the capture)
            gc_on = gc.isenabled()
            gc.disable()
            try:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = body(*prog.inputs)
                finally:
                    graph.capture_end()
            finally:
                if gc_on:
                    gc.enable()
            self.pool_bytes += torch.cuda.memory_reserved(self.device) \
                - reserved
            prog.launches = _take_launches(before)
        cur.wait_stream(self._stream)
        prog.graph, prog.out = graph, out
        self.captures += 1

    def replay(self, prog: _Program) -> torch.Tensor:
        prog.graph.replay()
        _add_launches(prog.launches)
        self.replays += 1
        return prog.out


class LLMEngine:
    def __init__(self, cfg: LLMConfig, params=None, rng_seed: int = 0):
        for name, only in _NOT_PORTED:
            if getattr(cfg, name) != only:
                raise NotImplementedError(
                    f"LLMConfig.{name}={getattr(cfg, name)!r}: not ported "
                    f"to ray_torch yet (only {only!r} is accepted)")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model_cfg = cfg.llama()
        self.tokenizer = get_tokenizer(cfg.tokenizer)
        # Paged-attention backend, resolved ONCE; an explicit kernel on
        # the CPU or a shape the kernel does not take raises here
        self._attn_backend = kvc.resolve_attention_backend(
            cfg.attention_kernel, self.model_cfg, self.device)
        if self._attn_backend == "cuda":
            # build (or load) the kernel library now: a failed build fails
            # the engine's construction, not a request mid-traffic
            _build.load("paged_attention")
        graphs_on = _cuda_graphs_on(cfg.cuda_graphs, self.device)

        if params is None:
            if cfg.checkpoint_path:
                params = llama.load_params(cfg.checkpoint_path,
                                           self.model_cfg, self.device)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(rng_seed)
                params = llama.init_params(self.model_cfg, gen, self.device)
        self.params = params  # nested dict of tensors on self.device

        b = cfg.max_batch_size
        self.max_pages_per_seq = -(-cfg.max_seq_len // cfg.page_size)
        self.kv = kvc.init_paged_cache(
            self.model_cfg, cfg.num_pages, cfg.page_size, self.device)
        self._prof = profiling_mod.EngineProfiler(
            enabled=bool(cfg.profiling_enabled))
        self._prof.set_memory_layout(
            profiling_mod.tree_bytes(self.params),
            profiling_mod.tree_bytes(self.kv))
        # Prefix caching (kv_cache.PageAllocator): host-side bookkeeping
        # between steps — shared pages change WHICH pool pages a slot
        # reads, never the step functions or their shapes.
        self._prefix_cache_on = bool(cfg.prefix_cache_enabled)
        self.allocator = kvc.PageAllocator(
            cfg.num_pages, cache_pages=cfg.prefix_cache_max_pages)
        self.page_tables = np.zeros((b, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros((b,), np.int32)
        self.slot_req: list[Optional[_Request]] = [None] * b
        self.free_slots = list(range(b))

        self._lock = threading.Lock()
        self._waiting: list[_Request] = []
        # chunked prefill: admitted (slot+pages held) but prompt not fully
        # prefilled; the loop dispatches one chunk per request per
        # iteration, interleaved with decode blocks
        self._prefilling: list[_Request] = []
        # streaming tier restore: admitted (slot+pages held), restore
        # stream open — the loop injects landed chunks (_restore_steps) and
        # routes each request on to its suffix prefill when its stream ends
        self._restoring: list[_Request] = []
        self._requests: dict[str, _Request] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed + 1)
        self._loop_thread: Optional[threading.Thread] = None
        self.stats = {"steps": 0, "prefills": 0, "tokens_out": 0,
                      "requests": 0, "shed_expired": 0, "compile_s": 0.0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0,
                      "spilled_pages": 0, "restored_pages": 0,
                      "tier_hit_tokens": 0, "restore_partial": 0,
                      "spec_rounds": 0, "spec_drafted_tokens": 0,
                      "spec_accepted_tokens": 0,
                      "failover_resumed": 0, "failover_restored_tokens": 0,
                      # decode blocks / verify rounds / prefill chunks
                      # dispatched, each running the resolved attention
                      # backend per layer
                      "attn_decode_dispatches": 0,
                      "attn_verify_dispatches": 0,
                      "attn_chunk_dispatches": 0}
        # Tiered KV cache (kv_tier.py): evicted cached page chains spill
        # host-side instead of dying, and _admit extends its longest-match
        # search past the local index into the tier. The allocator hook
        # only captures evictions and dispatches one device gather per
        # batch (stream-ordered before any reuse of the pages) with its
        # device->host copy; the store put happens later on the loop, once
        # the copy has landed (_kv_tier_flush).
        self._kv_tier_on = bool(cfg.kv_tier_enabled) and self._prefix_cache_on
        self._kv_tier = None
        self._tier_pending: list = []  # [(_Fetch k, _Fetch v, [(page, dig, pos)])]
        if self._kv_tier_on:
            kv_dtype = self.kv["k"].dtype
            self._kv_tier = kvt.KVTierStore(
                max_bytes=cfg.kv_tier_max_bytes,
                disk_dir=cfg.kv_tier_disk_dir,
                disk_max_bytes=cfg.kv_tier_disk_max_bytes,
                ttl_s=cfg.kv_tier_ttl_s,
                page_size=cfg.page_size,
                codec=cfg.kv_tier_codec,
                dtype="bfloat16" if kv_dtype == torch.bfloat16 else None)
            self.allocator.spill_hook = self._spill_capture
        # drain-time eager spill handshake: spill_inflight() parks one
        # (done_event, result_box) here and the loop performs the gather
        # and the hand-off to the store — one thread drives the device
        self._spill_req: Optional[tuple] = None
        # Speculative decoding (spec_decode.py + _verify_round): host-side
        # n-gram drafts verified k at a time in one dispatch. Greedy-only
        # guarantee: non-greedy slots are never drafted and ride the normal
        # decode path.
        self._spec_on = bool(cfg.spec_decode_enabled)
        self._last_block = 0
        # Pipelined decode: the host harvests sampled tokens PIPELINE_DEPTH
        # blocks behind the device
        self.PIPELINE_DEPTH = cfg.pipeline_depth
        self._pending: list = []   # [(_Fetch, [(col, slot, req)], k)]
        self._overrides: dict[int, object] = {}  # slot -> first token
        # Device-resident decode state. Row b (one past the last slot) is
        # a PERMANENT TRASH ROW: packed dispatch pads its slot index vector
        # with it, so padding lanes write into the trash page (page-table
        # row of zeros) instead of any live slot's KV.
        dev = self.device
        self._pt_dev = torch.zeros((b + 1, self.max_pages_per_seq),
                                   dtype=torch.int32, device=dev)
        self._sl_dev = torch.zeros((b + 1,), dtype=torch.int32, device=dev)
        self._temps_dev = torch.zeros((b + 1,), dtype=torch.float32,
                                      device=dev)
        self._dev_tokens = torch.zeros((b + 1,), dtype=torch.long,
                                       device=dev)
        self._dirty_slots: dict[int, tuple] = {}  # slot -> (seq_len, temp)
        # decode and verify signatures (_Program), made at first use; with
        # graphs on, each captured into _graphs' pool
        self._programs: dict[tuple, _Program] = {}
        # prefill and chunk signatures (_Program), each made and captured
        # at its first use with graphs on; unused with graphs off
        self._prompt_programs: dict[tuple, _Program] = {}
        self._graphs = _CudaGraphs(dev, self._gen) if graphs_on else None

    # ---- device programs -------------------------------------------------
    def _decode_block(self, idx: torch.Tensor, num_steps: int):
        """``num_steps`` decode steps at the PACKED width ``len(idx)``,
        dispatched back to back. ``idx`` selects the active slots (padded
        with the trash row); the gather / scatter of the [W]-sized state
        stays on the device. Updates the KV pool and slot state in place and
        returns all sampled tokens [K, W]."""
        pt = self._pt_dev[idx]
        lens = self._sl_dev[idx]
        toks = self._dev_tokens[idx]
        temps = self._temps_dev[idx]
        outs = []
        for _ in range(num_steps):
            logits, lens = kvc.paged_decode_step(
                self.params, self.kv, pt, lens, toks, self.model_cfg,
                self.cfg.page_size, self._attn_backend)
            toks = kvc.sample_tokens(logits, self._gen, temps,
                                     self.cfg.top_k)
            outs.append(toks)
        # padding lanes must not accumulate garbage into the trash row
        # (its seq_len would creep toward int32 overflow on a long-lived
        # engine): pin it back to zero on scatter
        trash = self.cfg.max_batch_size
        self._sl_dev[idx] = torch.where(idx == trash, 0, lens)
        self._dev_tokens[idx] = toks
        return torch.stack(outs)

    def _verify_round(self, idx: torch.Tensor, drafts: torch.Tensor):
        """Verify round (speculative decoding) at the PACKED width
        ``len(idx)``: k+1 token positions per slot, the current token
        followed by its k drafted tokens, scored in ONE multi-position pass
        (``paged_verify_step``). logits[t] match what sequential decode
        computes after consuming the first t draft tokens, so with greedy
        sampling output s[t] equals baseline decode's: the host accepts the
        longest prefix with drafts[t] == s[t] and emits s[:a+1].

        Rejected tail positions write junk KV past the accepted length, in
        the slot's own suffix pages (decode positions are never below the
        prompt length, so never in shared prefix pages); the harvest rolls
        the slot's seq_len back and later steps overwrite the junk before
        attending to it. drafts: [W, k] longs, -1 for padding lanes and
        short drafts (-1 never equals a sampled token). Updates the KV pool
        and slot state in place and returns all samples [k+1, W]."""
        pt = self._pt_dev[idx]
        lens = self._sl_dev[idx]
        temps = self._temps_dev[idx]
        tokens = torch.cat([self._dev_tokens[idx][:, None], drafts], dim=1)
        logits, new_lens = kvc.paged_verify_step(
            self.params, self.kv, pt, lens, tokens, self.model_cfg,
            self.cfg.page_size, self._attn_backend)
        t = tokens.shape[1]
        out = kvc.sample_tokens(
            logits.reshape(-1, logits.shape[-1]), self._gen,
            temps[:, None].expand(-1, t).reshape(-1),
            self.cfg.top_k).reshape(-1, t)
        all_toks = out.T.contiguous()                               # [k+1, W]
        # the scattered lens are k+1 past the truth for every rejected
        # draft; the harvest patches every participating slot with its
        # rolled-back length before a later dispatch reads it. Trash row
        # pinned to zero as in _decode_block.
        trash = self.cfg.max_batch_size
        self._sl_dev[idx] = torch.where(idx == trash, 0, new_lens)
        self._dev_tokens[idx] = all_toks[-1]
        return all_toks

    def _first_token(self, logits, temperature):
        """Sample a prompt pass's first token on the device (no host
        sync; the harvest pipeline records it). top_k is the ENGINE's.
        ``temperature`` is a float, or a prompt program's [1] fp32 static
        input."""
        if not isinstance(temperature, torch.Tensor):
            temperature = torch.full((1,), temperature, dtype=torch.float32,
                                     device=self.device)
        return kvc.sample_tokens(logits[None, :], self._gen, temperature,
                                 self.cfg.top_k)[0]

    def _prefill_program(self, toks, table, true_len, temp):
        """A prefill signature's body: the prompt pass and its first
        token."""
        return self._first_token(kvc.paged_prefill(
            self.params, self.kv, table, toks, true_len, self.model_cfg,
            self.cfg.page_size), temp)

    def _chunk_program(self, toks, table, true_len, start, temp):
        """A chunk signature's body: one prefill chunk and the token
        sampled after it (used only after the final chunk)."""
        return self._first_token(kvc.paged_prefill_chunk(
            self.params, self.kv, table, toks, start, true_len,
            self.model_cfg, self.cfg.page_size, self._attn_backend), temp)

    def _prompt_inputs(self, sig: tuple) -> tuple:
        """Static inputs of a prefill or chunk signature whose page table
        is all zeros: a run on them writes only into the trash page."""
        kind, n = sig
        dev = self.device
        ints = [torch.full((1,), n, dtype=torch.int32, device=dev)]
        if kind == "chunk":
            ints.append(torch.zeros((1,), dtype=torch.int32, device=dev))
        return (torch.zeros((1, n), dtype=torch.long, device=dev),
                torch.zeros((self.max_pages_per_seq,), dtype=torch.int32,
                            device=dev),
                *ints, torch.zeros((1,), dtype=torch.float32, device=dev))

    def _replay_prompt(self, sig: tuple, body, *values: np.ndarray):
        """Dispatch a prefill or chunk signature with graphs on: capture
        it at its first use, fill its static inputs in place and replay
        it. Returns a clone of the sampled token, taken right behind the
        replay: a later replay of the same graph (the next same-length
        prompt admitted before a decode dispatch reads this one's token)
        overwrites the graph's output."""
        prog = self._prompt_programs.get(sig)
        if prog is None:
            prog = _Program(self._prompt_inputs(sig))
            self._graphs.capture(prog, body, self._prompt_inputs(sig))
            self._prompt_programs[sig] = prog
        for dst, v in zip(prog.inputs, values):
            _copy_in(dst, v)
        return self._graphs.replay(prog).clone()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        through a fresh pinned tensor, so it is asynchronous, as the
        reference's ``jnp.asarray`` is: after a copy from pageable memory
        PyTorch synchronises the stream, and the host would wait for every
        block queued ahead. The caching host allocator hands that pinned
        block out again only once the copy has run."""
        src = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return src.pin_memory().to(self.device, non_blocking=True)
        return src

    def _stage(self, dst: torch.Tensor, values: np.ndarray) -> None:
        """Copy a host array into a decode or verify static input in
        place."""
        _copy_in(dst, values)

    def _trash_inputs(self, sig: tuple) -> tuple:
        """Inputs of a decode or verify signature that select only the
        trash row (and -1 drafts): a run on them writes only into the
        trash page."""
        kind, w, k = sig
        idx = torch.full((w,), self.cfg.max_batch_size, dtype=torch.long,
                         device=self.device)
        if kind == "decode":
            return (idx,)
        return idx, torch.full((w, k), -1, dtype=torch.long,
                               device=self.device)

    def _program(self, sig: tuple, body) -> _Program:
        """A signature's static inputs, made at its first use (at warmup,
        or mid-traffic with warmup off) and, with graphs on, its graph,
        captured then; ``body`` runs the signature on its inputs."""
        prog = self._programs.get(sig)
        if prog is None:
            prog = _Program(self._trash_inputs(sig))
            if self._graphs is not None:
                self._graphs.capture(prog, body, self._trash_inputs(sig))
            self._programs[sig] = prog
        return prog

    def _run_program(self, sig: tuple, body, *values: np.ndarray):
        """Dispatch a decode or verify signature on host ``values``: fill
        its static inputs in place, then replay its graph, or with graphs
        off run ``body`` on them."""
        prog = self._program(sig, body)
        for dst, v in zip(prog.inputs, values):
            self._stage(dst, v)
        if self._graphs is None:
            return body(*prog.inputs)
        return self._graphs.replay(prog)

    def _warm(self, sig: tuple, body) -> None:
        """First use of a signature before traffic: with graphs on, its
        capture (which makes one eager warm run); with graphs off, one
        eager run on trash-row inputs."""
        self._program(sig, body)
        if self._graphs is None:
            body(*self._trash_inputs(sig))

    # ---- public API ------------------------------------------------------
    def start(self):
        if self._loop_thread is None:
            if self.cfg.warmup_compile:
                self._warmup_decode_programs()
            self._loop_thread = threading.Thread(
                target=self._loop, name="llm-engine", daemon=True)
            self._loop_thread.start()

    @torch.no_grad()
    def _warmup_decode_programs(self):
        """Run every (bucket width, block length) decode signature once
        before serving, so first-use costs (kernel library load, cuBLAS
        heuristics, allocator growth, and with graphs on the captures) are
        paid before traffic. All-trash index vectors make the warmup write
        only into the trash page."""
        widths = sorted({self._bucket_width(n)
                         for n in range(1, self.cfg.max_batch_size + 1)})
        tiers = {1, max(1, min(self.cfg.pressure_decode_block,
                               self.cfg.decode_block)),
                 self.cfg.decode_block}
        if self._spec_on:
            # the spec-capped idle tier (_select_block) dispatches too
            tiers.add(min(self.cfg.decode_block,
                          max(1, self.cfg.spec_draft_len)))
        for w in widths:
            for k in sorted(tiers):
                with self._prof.compile_scope("decode", ("decode", w, k)):
                    self._warm(("decode", w, k), functools.partial(
                        self._decode_block, num_steps=k))
            if self._spec_on:
                # the verify round per width too, on -1 drafts
                k = self.cfg.spec_draft_len
                with self._prof.compile_scope("verify", ("verify", w, k)):
                    self._warm(("verify", w, k), self._verify_round)
        if self._kv_tier_on:
            # the tier-restore scatter, as the reference warms its one
            # fixed-shape inject program (a zero page into the trash page)
            mp = self.max_pages_per_seq
            shape = self.kv["k"].shape
            zero = np.zeros(shape[:2] + (1,) + shape[3:], self._host_dtype())
            with self._prof.compile_scope("kv_tier_inject",
                                          ("kv_tier_inject", mp)):
                self._scatter_pages([0], zero, zero)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        loop_alive = False
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
            loop_alive = self._loop_thread.is_alive()
            self._loop_thread = None
        # surface already-computed completions: the loop may exit with
        # dispatched blocks still unharvested, and their waiters would
        # otherwise time out on results that exist. Skip if the loop
        # thread is wedged past the join timeout — draining concurrently
        # with it would race on _pending.
        if loop_alive:
            return
        while self._pending:
            self._harvest_one()
        # restore streams have their own worker threads; cut them before
        # the tier closes underneath them
        with self._lock:
            restoring = list(self._restoring)
        for req in restoring:
            if req.restore_stream is not None:
                req.restore_stream.abort()
                req.restore_stream = None
        if self._kv_tier is not None:
            # hand the captured spills to the store, then drop its blobs
            # and end its threads
            try:
                self._kv_tier_flush(wait=True)
            except Exception:  # noqa: BLE001 - spill is best-effort
                logger.warning("kv-tier: spills lost at shutdown",
                               exc_info=True)
                self._tier_pending.clear()
            self._kv_tier.close()

    def submit(self, prompt: str | list[int], *,
               max_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               request_id: Optional[str] = None,
               resume_tokens: Optional[list] = None) -> str:
        """Enqueue a request; returns its id. Tokens stream via drain().

        ``resume_tokens`` is a mid-stream failover continuation: the token
        ids a dead replica already generated for this request. They extend
        the admission sequence past the prompt — the cache-aware admission
        path (local prefix match, tier restore, suffix-only chunked
        prefill) then recovers or recomputes the dead replica's KV and
        decode resumes at the exact next token; drain() emits ONLY
        post-resume tokens. ``max_tokens`` for a continuation is the
        REMAINING budget (original minus the tokens already emitted)."""
        if isinstance(prompt, str):
            toks = self.tokenizer.encode(prompt)
        else:
            toks = list(prompt)
        # the prompt cap applies BEFORE the continuation is appended: the
        # original leg was capped the same way, so the digest chain over
        # the prompt pages is identical across legs
        toks = toks[: self.cfg.max_prompt_len]
        resume_len = 0
        if resume_tokens:
            if not self.cfg.failover_enabled:
                raise ValueError(
                    "continuation submit with failover_enabled=False")
            # leave >=1 position of generation room: a continuation that
            # would fill max_seq_len exactly still has to sample the next
            # token to make progress
            resume = list(resume_tokens)[: max(
                0, self.cfg.max_seq_len - 1 - len(toks))]
            resume_len = len(resume)
            toks = toks + [int(t) for t in resume]
        req = _Request(
            request_id=request_id or uuid.uuid4().hex[:16],
            prompt_tokens=toks,
            max_tokens=max(1, min(max_tokens or self.cfg.max_tokens,
                                  self.cfg.max_seq_len - len(toks))),
            temperature=(self.cfg.temperature if temperature is None
                         else temperature),
            top_k=self.cfg.top_k if top_k is None else top_k,
            stop_token=getattr(self.tokenizer, "eos_token_id", None),
            deadline=request_deadline.current(),
            trace_ctx=tracing.inject(),
            resume_len=resume_len)
        if req.top_k != self.cfg.top_k:
            # all sampling uses the ENGINE's top_k, as in the reference
            logger.warning(
                "request top_k=%s differs from engine top_k=%s; sampling "
                "uses the engine setting", req.top_k, self.cfg.top_k)
        with self._lock:
            self._requests[req.request_id] = req
            self._waiting.append(req)
            self.stats["requests"] += 1
            if resume_len:
                self.stats["failover_resumed"] += 1
        if resume_len:
            # a failed replica's stream is being spliced onto this one:
            # journal it under the same request id
            _fr.emit("failover_resume", "WARNING",
                     request_id=req.request_id,
                     attrs={"resume_len": int(resume_len),
                            "model": str(self.cfg.model_id)})
        self._wake.set()
        return req.request_id

    def cancel(self, request_id: str) -> None:
        """Abandon a request (client disconnected mid-stream): a waiting
        request is dropped immediately; a slotted one finishes at its next
        recorded token (the loop then frees its slot/pages on the normal
        completion path)."""
        with self._lock:
            req = self._requests.pop(request_id, None)
            if req is None:
                return
            if req in self._waiting:
                self._waiting.remove(req)
                req.done = True
                req.finished_at = time.monotonic()
                req.done_event.set()
                return
            if req in self._prefilling or req in self._restoring:
                # mid chunked prefill (or mid tier-restore stream): flag it
                # and let the LOOP free the slot/pages (_abort_prefilling)
                # — the loop may be building a chunk dispatch from
                # req.pages, or injecting restored pages, right now
                req.prefill_cancelled = True
                req.abandoned = True
                self._requests[request_id] = req  # loop reaps on abort
                self._wake.set()
                return
            if not req.done:
                req.max_tokens = max(1, len(req.generated))
                req.abandoned = True
                self._requests[request_id] = req
                req.drained_upto = len(req.generated)
        self._wake.set()

    def drain(self, request_id: str) -> dict:
        """New tokens since the last drain + done flag (streaming poll)."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                return {"tokens": [], "text": "", "done": True,
                        "error": "unknown request"}
            new = req.generated[req.drained_upto:]
            req.drained_upto = len(req.generated)
            done = req.done
            err = req.error
            if done and req.drained_upto >= len(req.generated):
                self._requests.pop(request_id, None)
        out = {"tokens": new, "text": self.tokenizer.decode(new),
               "done": done, "error": err}
        if done:
            # the final chunk carries the per-request attribution (queue
            # wait + engine stage timeline), as result() does; built
            # outside the lock
            out.update(self._attribution_payload(req))
        return out

    def result(self, request_id: str, timeout: Optional[float] = None) -> dict:
        """Block until the request completes; returns the full completion.

        The wait is bounded by min(timeout, remaining request deadline);
        with neither, the 120 s guard still applies (a hung engine must not
        pin the caller forever). On expiry the request is CANCELLED — its
        slot/pages free at the next recorded token instead of decoding to
        max_tokens for nobody."""
        if timeout is None:
            timeout = 120.0
        timeout = request_deadline.bound(timeout)
        with self._lock:
            req = self._requests.get(request_id)
        if req is None:
            return {"text": "", "tokens": [], "error": "unknown request"}
        if not req.done_event.wait(timeout):
            self.cancel(request_id)
            expired = (req.deadline is not None
                       and time.time() >= req.deadline)
            return {"text": "", "tokens": [],
                    "error": "deadline exceeded" if expired else "timeout"}
        with self._lock:
            self._requests.pop(request_id, None)
        ttft = (req.first_token_at - req.submitted_at
                if req.first_token_at else None)
        gaps = sorted(req.itl_gaps)
        out = {
            "text": self.tokenizer.decode(req.generated),
            "tokens": list(req.generated),
            "num_prompt_tokens": len(req.prompt_tokens),
            "num_generated_tokens": len(req.generated),
            "error": req.error,
            "ttft_s": ttft,
            # median inter-token gap at host record time (bursty under
            # pipelined harvests)
            "itl_s": gaps[len(gaps) // 2] if gaps else None,
            "latency_s": (req.finished_at or time.monotonic())
            - req.submitted_at,
        }
        out.update(self._attribution_payload(req))
        return out

    @staticmethod
    def _attribution_payload(req: _Request) -> dict:
        """Per-request critical-path extras: queue wait plus the
        engine-side stage timeline (``attribution.engine_stages``), in the
        completion's metadata."""
        gaps = sorted(req.itl_gaps)
        queue_wait = ((req.admitted_at - req.submitted_at)
                      if req.admitted_at is not None else None)
        return {
            "request_id": req.request_id,
            "queue_wait_s": queue_wait,
            "stages": attribution.engine_stages(
                submitted_wall=req.submitted_wall,
                submitted_at=req.submitted_at,
                admitted_at=req.admitted_at,
                first_token_at=req.first_token_at,
                finished_at=req.finished_at,
                cached_tokens=req.cached_tokens,
                restored_tokens=req.restored_tokens,
                restore_bytes=req.restore_bytes,
                restore_ms=req.restore_ms,
                restore_wire_bytes=req.restore_wire_bytes,
                restore_decode_ms=req.restore_decode_ms,
                restore_overlap_ms=req.restore_overlap_ms,
                restore_partial=req.restore_partial,
                prompt_tokens=len(req.prompt_tokens),
                generated_tokens=len(req.generated),
                itl_s=gaps[len(gaps) // 2] if gaps else None),
        }

    def generate(self, prompt: str, **kw) -> dict:
        """Convenience: submit + wait."""
        rid = self.submit(prompt, **kw)
        return self.result(rid)

    def request_progress(self, request_id: str) -> Optional[dict]:
        """Per-request failover journal: the progress a resume needs —
        accepted token ids, how much of a continuation's prior work was
        recovered from cache or tier, and the restore cost. None for an
        unknown (or already collected) request."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                return None
            return {"prompt_tokens": len(req.prompt_tokens),
                    "generated": list(req.generated),
                    "resume_len": req.resume_len,
                    "cached_tokens": req.cached_tokens,
                    "restored_tokens": req.restored_tokens,
                    "restore_bytes": req.restore_bytes,
                    "restore_ms": req.restore_ms,
                    "admitted": req.admitted_at is not None}

    def engine_stats(self) -> dict:
        with self._lock:
            active = sum(1 for r in self.slot_req if r is not None)
            waiting = len(self._waiting)
            prefilling = len(self._prefilling)
            restoring = len(self._restoring)
        free = self.allocator.available()
        out = {**self.stats, "active_slots": active,
               "waiting": waiting + prefilling + restoring,
               "prefilling": prefilling, "restoring": restoring,
               "free_pages": free,
               "decode_block_effective": self._last_block,
               "pending_pipeline_depth": len(self._pending)}
        out.update(self._prof.phase_stats())
        out["compile_events"] = self._prof.compile_events
        out["mid_traffic_compiles"] = self._prof.mid_traffic_compiles
        out["compile_s"] = round(self._prof.compile_s, 3)
        # paged-attention backend surface: which kernel this replica runs
        # (string + a numeric twin exporters can gauge) and how many
        # attention-bearing signatures have been dispatched so far
        out["attention_backend"] = self._attn_backend
        out["attn_backend_cuda"] = int(self._attn_backend == "cuda")
        out["attn_kernel_compiles"] = self._prof.compile_count(
            ("decode", "verify", "chunk"))
        out["tp_degree"] = 1
        out.update(self._prof.memory_stats(
            self.device, used_pages=self.cfg.num_pages - free,
            total_pages=self.cfg.num_pages))
        if self._spec_on:
            d = self.stats["spec_drafted_tokens"]
            out["spec_accept_rate"] = (
                round(self.stats["spec_accepted_tokens"] / d, 4) if d
                else 0.0)
        if self._prefix_cache_on:
            cs = self.allocator.cache_stats()
            out.update({"prefix_cached_pages": cs["cached_pages"],
                        "prefix_evictable_pages": cs["evictable_pages"],
                        "prefix_shared_pages": cs["shared_pages"],
                        "prefix_evictions": cs["evicted"],
                        "prefix_hit_pages": cs["hit_pages"],
                        "prefix_inserted_pages": cs["inserted"]})
        # tier gauges, always emitted (0 when the tier is off) for a stable
        # key set; the spill/restore counters live in self.stats
        ts = self._kv_tier.stats() if self._kv_tier is not None else {}
        out["tier_bytes_shm"] = ts.get("shm_bytes", 0)
        out["tier_bytes_disk"] = ts.get("disk_bytes", 0)
        out["tier_bytes_shm_raw"] = ts.get("shm_bytes_raw", 0)
        out["tier_bytes_disk_raw"] = ts.get("disk_bytes_raw", 0)
        out["tier_codec_ratio"] = ts.get("codec_ratio", 0.0)
        out["tier_encode_ms_p50"] = ts.get("encode_ms_p50", 0.0)
        out["tier_decode_ms_p50"] = ts.get("decode_ms_p50", 0.0)
        # the reference's prefetch-hint gauges: hints come with the serve
        # layer, so they stay 0 here
        out["tier_prefetch_hints"] = 0
        out["tier_prefetch_pages"] = 0
        out["tier_prefetch_hit_pages"] = 0
        return out

    # ---- engine loop -----------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.no_grad():
                self._run_loop()
        except BaseException as exc:
            # the device path failed (a kernel launch, an out-of-memory):
            # fail every outstanding request with the error instead of
            # letting them hang to their timeouts, then stop
            logger.exception("engine loop failed; failing all requests")
            self._fail_all(f"engine loop failed: {exc!r}")
            raise

    def _run_loop(self):
        prof = self._prof
        while not self._stop.is_set():
            if prof.enabled:
                t0 = time.perf_counter()
                if self._admit():
                    prof.record("admit", time.perf_counter() - t0)
            else:
                self._admit()
            # streaming tier restores first: a chunk that landed since the
            # last pass injects before this pass's prefill chunks dispatch,
            # and a stream that just finished routes its request into
            # _prefilling in time for THIS pass
            restored = self._restore_steps() if self._kv_tier_on else 0
            chunks = self._prefill_chunks()
            if self._spill_req is not None:
                # drain-time eager spill: gather and hand to the store on
                # THIS thread, then release the waiter — its return must
                # mean the chains are actually in the tier
                ev, box = self._spill_req
                self._spill_req = None
                try:
                    box.append(self._spill_inflight_now())
                    self._kv_tier_flush(wait=True)
                finally:
                    ev.set()
            # chunk dispatches count as progress: an otherwise-idle engine
            # mid-chunked-prefill must not sleep between chunks. Restore
            # progress counts too; a stream WAITING on fetches does not —
            # the idle wait below parks on _wake, which the stream's
            # on_ready sets the moment new pages land
            dispatched = self._step() or chunks > 0 or restored > 0
            if self._kv_tier_on:
                # spill gathers whose device->host copies have landed
                self._kv_tier_flush()
            # Eager harvest: pop every entry whose tokens already landed
            # in host memory; the blocking PIPELINE_DEPTH trim in
            # _decode_step still bounds the queue when results are slow
            while self._pending and self._pending[0][0].ready():
                self._harvest_one()
            if not dispatched:
                if self._pending:
                    self._harvest_one()  # drain the pipeline tail
                    continue
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _fail_all(self, error: str) -> None:
        with self._lock:
            reqs = [r for r in self._requests.values() if not r.done]
            for req in reqs:
                req.error = error
                req.done = True
                req.finished_at = time.monotonic()
        for req in reqs:
            req.done_event.set()

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.cfg.max_prompt_len)

    def _admissions_blocked(self) -> bool:
        """Requests waiting while slots are free (= page-pool starved), or
        a chunked prefill mid-flight: shrink decode blocks so page
        reclamation isn't a whole block late and prefill chunks interleave
        tightly. Lock held."""
        return (bool(self._waiting) and bool(self.free_slots)) \
            or bool(self._prefilling) or bool(self._restoring)

    def _bucket_width(self, n: int) -> int:
        """Packed decode width: smallest power-of-two >= n (floor 4),
        capped at max_batch_size."""
        w = 4
        while w < n:
            w *= 2
        return min(w, self.cfg.max_batch_size)

    def _shed_expired_waiting(self) -> None:
        """Drop WAITING requests whose deadline passed: no slot, no pages,
        no prefill — the caller stopped listening ("The Tail at Scale").
        Slotted requests are not preempted; cancel() handles those."""
        now = time.time()
        shed: list[_Request] = []
        with self._lock:
            keep = []
            for req in self._waiting:
                if req.deadline is not None and now >= req.deadline:
                    shed.append(req)
                else:
                    keep.append(req)
            if shed:
                self._waiting = keep
                self.stats["shed_expired"] += len(shed)
                for req in shed:
                    req.error = "deadline exceeded"
                    req.done = True
                    req.finished_at = time.monotonic()
        for req in shed:
            req.done_event.set()

    def _admit(self) -> int:
        """Move waiting requests into free slots (prefill each)."""
        self._shed_expired_waiting()
        admitted = 0
        while True:
            with self._lock:
                if not self._waiting or not self.free_slots:
                    return admitted
                req = self._waiting[0]
                # cache-aware admission: longest indexed full-page prefix
                # (increffed — shared pages go into this slot's page table
                # and only the suffix gets prefilled)
                matched: list[int] = []
                if self._prefix_cache_on:
                    matched = self.allocator.match_prefix(
                        req.prompt_tokens, self.cfg.page_size)
                n_pages = -(-max(len(req.prompt_tokens) + req.max_tokens, 1)
                            // self.cfg.page_size)
                n_pages = min(n_pages, self.max_pages_per_seq)
                pages = self.allocator.alloc(n_pages - len(matched))
                if pages is None:
                    # page pool exhausted; drop the match refs (pages park
                    # back in the cached LRU, still matchable) + retry
                    if matched:
                        self.allocator.free(matched)
                    return admitted
                self._waiting.pop(0)
                slot = self.free_slots.pop()
                req.slot = slot
                req.admitted_at = time.monotonic()
                req.pages = matched + pages
                req.cached_tokens = len(matched) * self.cfg.page_size
                req.prefill_pos = req.cached_tokens
                if self._prefix_cache_on \
                        and len(req.prompt_tokens) > self.cfg.page_size:
                    key = "prefix_hits" if matched else "prefix_misses"
                    self.stats[key] += 1
                    self.stats["prefix_hit_tokens"] += req.cached_tokens
            self._prof.record("queue_wait",
                              req.admitted_at - req.submitted_at)
            if self._kv_tier_on and self._kv_tier_begin_restore(
                    req, len(matched)):
                # pipelined streaming restore: the stream's worker plans
                # and fetches chunk by chunk off this thread; the loop's
                # _restore_steps injects chunks as they land and routes the
                # request on to its suffix prefill when the stream ends
                with self._lock:
                    self._restoring.append(req)
                admitted += 1
                continue
            if req.resume_len:
                # tokens of the dead replica's work recovered WITHOUT
                # recompute (local prefix pages; the tier-restore route
                # accounts its share when its stream finalizes)
                self.stats["failover_restored_tokens"] += req.cached_tokens
            self._route_admitted(req)
            admitted += 1

    def _route_admitted(self, req: _Request) -> None:
        """Send an admitted request to its prompt pass."""
        suffix = len(req.prompt_tokens) - req.prefill_pos
        if req.prefill_pos > 0 or (self.cfg.prefill_chunk > 0
                                   and suffix > self.cfg.prefill_chunk):
            # long prompt OR cached prefix: prefill the (remaining)
            # suffix in chunks interleaved with decode blocks. A cached
            # prefix MUST go through the chunk pass — paged_prefill
            # writes from position 0 and would scribble on the shared
            # pages; the chunk pass starts at prefill_pos and reads the
            # cached prefix back through the page table.
            with self._lock:
                self._prefilling.append(req)
        else:
            self._prefill(req)

    # ---- tiered KV cache (kv_tier.py) ---------------------------------
    # pages gathered per spill batch: one blob of the store each, the
    # reference's fixed gather width
    _SPILL_BATCH = 8

    def _host_dtype(self) -> np.dtype:
        """numpy dtype of the pool's pages on the host: a bf16 pool's as
        16-bit words (numpy has no bfloat16; the store tags them)."""
        if self.kv["k"].dtype == torch.bfloat16:
            return np.dtype(np.int16)
        return torch.empty((), dtype=self.kv["k"].dtype).numpy().dtype

    def _spill_capture(self, evicted) -> None:
        """Allocator spill hook: runs on the loop thread immediately after
        an evicting alloc()/free(), BEFORE the caller can dispatch writes
        that reuse the pages — so the gather dispatched here reads the
        pre-eviction KV on the ordered stream (the stream the graphs replay
        on). Only the gather and its device->host copy into pinned memory
        (``_Fetch``: non-blocking, behind an event) are dispatched here;
        _kv_tier_flush hands the landed copies to the store."""
        ents = [(p, d, pos) for (p, d, pos) in evicted if pos is not None]
        words = self.kv["k"].dtype == torch.bfloat16
        for i in range(0, len(ents), self._SPILL_BATCH):
            batch = ents[i:i + self._SPILL_BATCH]
            pidx = self._to_device(np.array([p for p, _, _ in batch],
                                            np.int64))
            fetches = []
            for name in ("k", "v"):
                pages = self.kv[name].index_select(2, pidx)
                fetches.append(_Fetch(pages.view(torch.int16) if words
                                      else pages))
            self._tier_pending.append((*fetches, batch))

    def _kv_tier_flush(self, wait: bool = False) -> None:
        """Hand captured spill gathers whose host copies have landed to the
        tier store, oldest first; with ``wait`` (shutdown) all of them. The
        loop never waits on the device here: a copy still in flight waits
        for a later pass. A failed put degrades to a plain eviction — the
        pages are long since back on the free list."""
        while self._tier_pending:
            fk, fv, ents = self._tier_pending[0]
            if not (wait or (fk.ready() and fv.ready())):
                return
            self._tier_pending.pop(0)
            try:
                n = self._kv_tier.put(
                    fk.wait(), fv.wait(),
                    digests=[d.hex() for _, d, _ in ents],
                    tokens=[(pos + 1) * self.cfg.page_size
                            for _, _, pos in ents])
                self.stats["spilled_pages"] += n
            except Exception:  # noqa: BLE001 - spill is best-effort
                logger.warning("kv-tier spill put failed; chain evicted "
                               "without spilling", exc_info=True)

    def spill_inflight(self, timeout_s: float = 5.0) -> int:
        """Eagerly spill the computed full KV pages of every LIVE chain into
        the tier (the drain / SIGTERM path). Ordinary spill waits for pool
        eviction; a draining or dying replica's in-flight requests would
        take their KV with them — this pushes the chains out NOW so that a
        continuation can restore instead of recomputing. Thread-safe: the
        gather runs on the engine loop through a handshake (one thread
        drives the device), or directly when the loop is not running.
        Returns the pages spilled (0 with the tier off)."""
        if not self._kv_tier_on:
            return 0
        loop = self._loop_thread
        if loop is None or not loop.is_alive():
            n = self._spill_inflight_now()
            self._kv_tier_flush(wait=True)
            return n
        ev = threading.Event()
        box: list = []
        self._spill_req = (ev, box)
        self._wake.set()
        ev.wait(timeout_s)
        return box[0] if box else 0

    def _spill_inflight_now(self) -> int:
        """Capture spill gathers for every live request's full pages
        (slotted, mid chunked prefill or mid restore). Loop thread only
        (or the caller's, when the loop is down) — the same thread frees
        pages, so the entries cannot go stale under us."""
        if self._kv_tier is None:
            return 0
        ps = self.cfg.page_size
        ents: list = []
        with self._lock:
            live = [r for r in self.slot_req if r is not None and not r.done]
            live += [r for r in self._prefilling
                     if not r.prefill_cancelled and not r.done]
            # mid-restore requests hold pages too; their injected frontier
            # is prefill_pos, as for a chunked prefill
            live += [r for r in self._restoring
                     if not r.prefill_cancelled and not r.done]
            for req in live:
                toks = req.prompt_tokens + req.generated
                if req.dispatched > 0:
                    # armed slot: prompt KV fully written; a generated
                    # token's KV is written when it feeds the NEXT step,
                    # so the newest recorded token may not be cached yet
                    covered = len(req.prompt_tokens) + max(
                        0, len(req.generated) - 1)
                else:
                    covered = req.prefill_pos   # mid chunked prefill
                limit = min(covered // ps, len(req.pages))
                ents += [(req.pages[i], bytes.fromhex(d), i) for i, d in
                         enumerate(self._chain_digests(toks, limit))]
        if not ents:
            return 0
        self._spill_capture(ents)
        return len(ents)

    def _chain_digests(self, toks, limit: int) -> list[str]:
        """Hex chain digests of the first ``limit`` full pages of
        ``toks``, recomputed over this engine's own tokens (the reference
        also cross-checks digests computed at serve ingress, which comes
        with the serve layer)."""
        ps = self.cfg.page_size
        digest = b""
        digs = []
        for i in range(limit):
            digest = kvc._chain_digest(digest, toks[i * ps:(i + 1) * ps])
            digs.append(digest.hex())
        return digs

    def _kv_tier_begin_restore(self, req: _Request, m_loc: int) -> bool:
        """Open a pipelined restore stream for the tier-held chain pages
        past the local match. Returns False when there is nothing past the
        local match worth probing (or the stream could not open) — the
        caller then routes straight to prefill. True parks the request in
        _restoring; _restore_steps drives it from there."""
        try:
            ps = self.cfg.page_size
            toks = req.prompt_tokens
            limit = min((len(toks) - 1) // ps, len(req.pages))
            if limit <= m_loc:
                return False
            digs = self._chain_digests(toks, limit)
            # floor the prefetch window at two raw chunks: a window
            # narrower than one chunk serializes the worker to sub-chunk
            # progress — it parks before every landing
            window = max(
                self.cfg.kv_tier_stream_window_bytes,
                2 * self.cfg.kv_tier_chunk_pages
                * kvc.page_raw_nbytes(self.model_cfg, ps))
            req.restore_stream = self._kv_tier.open_stream(
                digs, m_loc,
                chunk_pages=self.cfg.kv_tier_chunk_pages,
                window_bytes=window,
                on_ready=self._wake.set)
        except Exception:  # noqa: BLE001 - restore degrades to a miss
            logger.warning("kv-tier restore stream failed to open; cold "
                           "prefill instead", exc_info=True)
            req.restore_stream = None
            return False
        req.restore_started = time.perf_counter()
        req.restore_page0 = m_loc
        req.restore_pages = 0
        return True

    def _restore_steps(self) -> int:
        """Drive active restore streams (loop thread): take landed chunks,
        decode + scatter them into the request's pages, enforce the
        per-chunk budget, and finalize — full or PARTIAL — routing the
        request on to its suffix prefill."""
        with self._lock:
            active = list(self._restoring)
        if not active:
            return 0
        progressed = 0
        now_w = time.time()
        budget_s = max(self.cfg.kv_tier_chunk_timeout_s, 0.1)
        for req in active:
            stream = req.restore_stream
            if req.prefill_cancelled or (req.deadline is not None
                                         and now_w >= req.deadline):
                self._abort_prefilling(req)
                progressed += 1
                continue
            t0 = time.perf_counter()
            injected = 0
            try:
                pairs, wire, dec_ms = stream.take(
                    max_pages=self.max_pages_per_seq)
                if pairs:
                    injected = self._inject_pages(req, pairs)
                    req.restore_wire_bytes += wire
                    req.restore_decode_ms += dec_ms
            except Exception:  # noqa: BLE001 - degrade to partial/miss
                logger.warning("kv-tier chunk inject failed; keeping "
                               "landed pages, prefilling the rest",
                               exc_info=True)
                stream.abort()
            req.restore_blocked_ms += (time.perf_counter() - t0) * 1e3
            progressed += injected
            if stream.exhausted:
                self._finalize_restore(req)
                progressed += 1
            elif (time.monotonic() - stream.last_progress) > budget_s * 1.5:
                # per-chunk budget watchdog: a wedged load must not park
                # the request forever — cut the stream, keep what landed
                stream.abort()
        return progressed

    def _scatter_pages(self, pages: list[int], k_np: np.ndarray,
                       v_np: np.ndarray) -> None:
        """Write host pages [L, Hkv, n, page, D] (a bf16 pool's as words)
        into pool pages ``pages`` IN PLACE: the captured graphs read the
        pool by address, so it is never rebound. The host -> device copies
        go through pinned memory, asynchronous (``_to_device``)."""
        idx = self._to_device(np.array(pages, np.int64))
        for name, arr in (("k", k_np), ("v", v_np)):
            pool = self.kv[name]
            src = self._to_device(np.ascontiguousarray(
                arr.view(self._host_dtype())))
            pool.index_copy_(2, idx, src.view(pool.dtype))

    def _inject_pages(self, req: _Request, pairs: list) -> int:
        """Scatter decoded chain pages (in chain order, continuing at
        restore_page0 + restore_pages) into this request's pool pages."""
        ps = self.cfg.page_size
        pos0 = req.restore_page0 + req.restore_pages
        t = min(len(pairs), len(req.pages) - pos0)
        if t <= 0:
            return 0
        k_np = np.concatenate([k for k, _ in pairs[:t]], axis=2)
        v_np = np.concatenate([v for _, v in pairs[:t]], axis=2)
        with self._prof.compile_scope(
                "kv_tier_inject", ("kv_tier_inject", self.max_pages_per_seq),
                mid_traffic=self.stats["requests"] > 0):
            self._scatter_pages(req.pages[pos0:pos0 + t], k_np, v_np)
        req.restore_pages += t
        req.cached_tokens = (pos0 + t) * ps
        req.prefill_pos = req.cached_tokens
        req.restored_tokens += t * ps
        req.restore_bytes += int(k_np.nbytes) + int(v_np.nbytes)
        self.stats["restored_pages"] += t
        self.stats["tier_hit_tokens"] += t * ps
        return t

    def _finalize_restore(self, req: _Request) -> None:
        """Stream over (fully, partially, or not at all): stamp the
        attribution split, count a partial restore, and send the request
        to its suffix prefill — which starts exactly at the restored
        frontier, so a mid-chain fault costs recompute of the TAIL only."""
        stream = req.restore_stream
        req.restore_stream = None
        req.restore_ms = (time.perf_counter() - req.restore_started) * 1e3
        req.restore_overlap_ms = max(
            0.0, req.restore_ms - req.restore_blocked_ms)
        planned = stream.planned or 0
        if 0 < req.restore_pages < planned:
            self.stats["restore_partial"] += 1
            req.restore_partial = True
            _fr.emit("restore_partial", "WARNING",
                     request_id=req.request_id,
                     attrs={"restored_pages": int(req.restore_pages),
                            "planned_pages": int(planned)})
        if req.resume_len:
            # the continuation's recovered-without-recompute accounting,
            # deferred from _admit until the restored frontier is final
            self.stats["failover_restored_tokens"] += req.cached_tokens
        with self._lock:
            if req in self._restoring:
                self._restoring.remove(req)
        self._route_admitted(req)

    def _prefill(self, req: _Request):
        """Dispatch the prompt pass WITHOUT waiting for it: the sampled first
        token stays on the device (fed to the next decode block as an
        override) and is recorded on the host by the harvest pipeline."""
        plen = len(req.prompt_tokens)
        bucket = self._bucket(plen)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = req.prompt_tokens
        table = np.zeros((self.max_pages_per_seq,), np.int32)
        table[: len(req.pages)] = req.pages
        with self._prof.phase("prefill"), self._prof.compile_scope(
                "prefill", ("prefill", bucket),
                mid_traffic=self.stats["requests"] > 0):
            if self._graphs is None:
                logits = kvc.paged_prefill(
                    self.params, self.kv, self._to_device(table),
                    self._to_device(toks), plen, self.model_cfg,
                    self.cfg.page_size)
                tok_dev = self._first_token(logits, req.temperature)
            else:
                tok_dev = self._replay_prompt(
                    ("prefill", bucket), self._prefill_program, toks, table,
                    np.array([plen], np.int32),
                    np.array([req.temperature], np.float32))
        self._arm_slot(req, table, tok_dev, plen)

    def _arm_slot(self, req: _Request, table, tok_dev, plen: int) -> None:
        """Publish a freshly prefilled slot to the decode loop: host/device
        state patch, first-token override, and a harvest entry for the
        sampled first token."""
        fetch = _Fetch(tok_dev)
        with self._lock:
            req.dispatched = 1
            self.page_tables[req.slot] = table
            self.seq_lens[req.slot] = plen
            self.slot_req[req.slot] = req
            self._dirty_slots[req.slot] = (plen, req.temperature)
            self._overrides[req.slot] = tok_dev
            self._pending.append((fetch, [(0, req.slot, req)], 1))
        if self._prefix_cache_on:
            # Index the prompt's FULL pages now (not at completion): the
            # writes are merely dispatched, but any matcher's reads are dispatched
            # later on the same ordered stream, so a concurrent
            # same-prefix admission can already share. Partial trailing
            # pages are never indexed, and decode writes land at positions
            # >= plen, so a shared page is never written after insertion.
            self.allocator.insert_prefix(
                req.prompt_tokens, req.pages, self.cfg.page_size)
        self.stats["prefills"] += 1

    def _prefill_chunks(self) -> int:
        """Dispatch ONE prefill chunk per in-progress chunked admission (loop
        thread). The final chunk's on-device sampled token arms the slot
        exactly like _prefill's; intermediate chunks only extend the
        cached KV."""
        with self._lock:
            active = list(self._prefilling)
        now = time.time()
        for req in active:
            if req.prefill_cancelled or (req.deadline is not None
                                         and now >= req.deadline):
                self._abort_prefilling(req)
                continue
            plen = len(req.prompt_tokens)
            start = req.prefill_pos
            remaining = plen - start
            # prefill_chunk 0 disables chunking, but a cached-prefix
            # admission still rides this path (suffix-only prefill): the
            # whole suffix then goes as one chunk
            chunk = (self.cfg.prefill_chunk if self.cfg.prefill_chunk > 0
                     else remaining)
            final = remaining <= chunk
            clen = self._bucket(remaining) if final else chunk
            toks = np.zeros((1, clen), np.int64)
            seg = req.prompt_tokens[start: start + clen]
            toks[0, : len(seg)] = seg
            table = np.zeros((self.max_pages_per_seq,), np.int32)
            table[: len(req.pages)] = req.pages
            with self._prof.phase("chunk_prefill"), self._prof.compile_scope(
                    "chunk", ("chunk", clen),
                    mid_traffic=self.stats["requests"] > 0):
                if self._graphs is None:
                    logits = kvc.paged_prefill_chunk(
                        self.params, self.kv, self._to_device(table),
                        self._to_device(toks), start, plen, self.model_cfg,
                        self.cfg.page_size, self._attn_backend)
                    tok_dev = self._first_token(logits, req.temperature)
                else:
                    tok_dev = self._replay_prompt(
                        ("chunk", clen), self._chunk_program, toks, table,
                        np.array([plen], np.int32),
                        np.array([start], np.int32),
                        np.array([req.temperature], np.float32))
            self.stats["attn_chunk_dispatches"] += 1
            req.prefill_pos = min(start + clen, plen)
            if req.prefill_pos >= plen:
                with self._lock:
                    self._prefilling.remove(req)
                self._arm_slot(req, table, tok_dev, plen)
        return len(active)

    def _abort_prefilling(self, req: _Request) -> None:
        """Release a mid-chunked-prefill (or mid-restore) request NOW,
        cancelled or past its deadline: slot, pages and tracking. Loop
        thread only: dispatched chunks and injects may still write these
        pages, but the stream is ordered, so any later prefill reusing
        them runs after. A request that was not cancelled has expired: it
        is counted and kept, so that result() / drain() report it."""
        expired = not req.abandoned
        if req.restore_stream is not None:
            # cut the stream first: its worker must stop landing chunks
            # for pages we are about to hand back to the pool
            req.restore_stream.abort()
            req.restore_stream = None
        with self._lock:
            if req in self._prefilling:
                self._prefilling.remove(req)
            if req in self._restoring:
                self._restoring.remove(req)
            if req.slot >= 0:
                self.free_slots.append(req.slot)
                req.slot = -1
            req.done = True
            req.finished_at = time.monotonic()
            if expired:
                req.error = "deadline exceeded"
                self.stats["shed_expired"] += 1
            else:
                self._requests.pop(req.request_id, None)
        self.allocator.free(req.pages)
        req.pages = []
        req.done_event.set()

    def _record_token(self, req: _Request, tok: int) -> None:
        """Append a sampled token; mark done on stop/max. Lock held."""
        if req.done:
            return
        now = time.monotonic()
        if req.first_token_at is None:
            req.first_token_at = now
        elif req.last_token_at is not None:
            gap = now - req.last_token_at
            req.itl_gaps.append(gap)
            self._prof.record_itl(gap)
        req.last_token_at = now
        req.generated.append(tok)
        self.stats["tokens_out"] += 1
        hit_stop = (req.stop_token is not None and tok == req.stop_token)
        if hit_stop or len(req.generated) >= req.max_tokens:
            if hit_stop:
                req.generated.pop()  # don't emit the stop token
            req.done = True
            req.finished_at = time.monotonic()

    def _select_block(self) -> int:
        """Decode-block tier for the next dispatch (lock held): 1 while
        admissions wait, pressure_decode_block while requests queue for
        slots, decode_block otherwise.

        With speculative decoding on, the idle tier is capped at
        spec_draft_len: a draft can only continue the CURRENT head token,
        and the engine probes for drafts once per loop iteration, so long
        decode blocks would skip most draft opportunities (the head lands
        mid-block)."""
        if self._admissions_blocked():
            return 1
        if self._waiting:
            return max(1, min(self.cfg.pressure_decode_block,
                              self.cfg.decode_block))
        k = self.cfg.decode_block
        if self._spec_on:
            k = min(k, max(1, self.cfg.spec_draft_len))
        return k

    def _flush_slot_patches(self, dirty: dict, overrides: dict) -> None:
        """Apply queued slot-state patches at the fixed B+1 shape (padded
        onto the trash row, whose state is all zeros by invariant) and
        write token overrides into the device token vector. Shared by the
        decode and verify dispatch paths; loop thread only."""
        trash_row = self.cfg.max_batch_size
        if dirty:
            order = sorted(dirty)
            pad = (trash_row + 1) - len(order)
            didx = self._to_device(np.array(order + [trash_row] * pad,
                                            np.int64))
            ptv = np.zeros((trash_row + 1, self.max_pages_per_seq), np.int32)
            ptv[: len(order)] = self.page_tables[order]
            slv = np.zeros((trash_row + 1,), np.int32)
            slv[: len(order)] = [dirty[i][0] for i in order]
            tv = np.zeros((trash_row + 1,), np.float32)
            tv[: len(order)] = [dirty[i][1] for i in order]
            self._pt_dev[didx] = self._to_device(ptv)
            self._sl_dev[didx] = self._to_device(slv)
            self._temps_dev[didx] = self._to_device(tv)
        if overrides:
            # values are on-device tokens from prefills (stacked on the
            # device, no host sync) or host ints from verify-round
            # acceptance (one host-to-device copy for all of them, padded
            # with the trash row's zeros)
            on_dev = [s for s, v in overrides.items()
                      if isinstance(v, torch.Tensor)]
            on_host = [s for s, v in overrides.items()
                       if not isinstance(v, torch.Tensor)]
            pad = (trash_row + 1) - len(overrides)
            oidx = self._to_device(np.array(
                on_dev + on_host + [trash_row] * pad, np.int64))
            host_vals = self._to_device(np.array(
                [overrides[s] for s in on_host] + [0] * pad, np.int64))
            self._dev_tokens[oidx] = torch.cat(
                [overrides[s].reshape(1).long() for s in on_dev]
                + [host_vals])

    def _step(self) -> bool:
        """Dispatch the iteration's device work: a verify round for slots
        with drafts (spec_decode_enabled), then one decode block for the
        rest."""
        did_spec = self._spec_on and self._spec_step()
        return self._decode_step() or did_spec

    def _decode_step(self) -> bool:
        """Dispatch one decode block (1..decode_block steps) without waiting
        for its result; harvest PIPELINE_DEPTH blocks behind. The stream
        is ordered, so an in-flight block that still references a freed
        slot's pages runs BEFORE any later prefill that reuses them."""
        with self._lock:
            # a slot joins while it has tokens left to dispatch, or while
            # nothing of it is in flight (dispatched == len(generated)): a
            # cancel that lands between a verify harvest and the next
            # dispatch caps max_tokens at len(generated), and only one more
            # token, as a decode-mode cancel records, finishes the request
            snapshot = [(i, i, req) for i, req in enumerate(self.slot_req)
                        if req is not None and not req.spec_inflight
                        and (req.dispatched < req.max_tokens
                             or req.dispatched == len(req.generated))]
            if not snapshot:
                return False
            # Overshoot past a request's max_tokens is by-design safe:
            # extra writes land in the slot's own tail pages or the trash
            # page, and harvest discards them.
            k = self._select_block()
            self._last_block = k
            dirty, self._dirty_slots = self._dirty_slots, {}
            overrides, self._overrides = self._overrides, {}
            for _col, _slot, req in snapshot:
                req.dispatched += k
        # decode_dispatch times the HOST cost of dispatching the block; the
        # device sync is the harvest phase
        t0 = time.perf_counter() if self._prof.enabled else 0.0
        self._flush_slot_patches(dirty, overrides)
        # bucketed width: pack the active slots, pad with the trash row
        active_slots = [slot for _c, slot, _r in snapshot]
        w = self._bucket_width(len(active_slots))
        idx = np.full((w,), self.cfg.max_batch_size, np.int64)
        idx[: len(active_slots)] = active_slots
        snapshot = [(col, slot, req)
                    for col, (_c, slot, req) in enumerate(snapshot)]
        with self._prof.compile_scope(
                "decode", ("decode", w, k),
                mid_traffic=self.stats["requests"] > 0):
            all_toks = self._run_program(
                ("decode", w, k),
                functools.partial(self._decode_block, num_steps=k), idx)
        self._pending.append((_Fetch(all_toks), snapshot, k))
        self.stats["steps"] += k
        self.stats["attn_decode_dispatches"] += 1
        if self._prof.enabled:
            self._prof.record("decode_dispatch", time.perf_counter() - t0)
        if len(self._pending) > self.PIPELINE_DEPTH:
            self._harvest_one()
        return True

    # ---- speculative decoding --------------------------------------------
    def _propose_locked(self, req: _Request) -> list[int]:
        """Draft tokens for one slot (lock held). Greedy slots only — the
        identity guarantee is a greedy property; non-greedy slots ride the
        normal decode path untouched. The draft is capped so a fully
        accepted round cannot emit past max_tokens."""
        if req.temperature != 0.0:
            return []
        remaining = req.max_tokens - len(req.generated)
        if remaining <= 1:
            return []
        if req.spec is None:
            req.spec = spec_decode.NGramProposer(
                self.cfg.spec_ngram_max, self.cfg.spec_draft_len)
        draft = req.spec.propose(req.prompt_tokens + req.generated)
        return draft[: remaining - 1]

    def _dispatch_verify(self, rows) -> None:
        """Dispatch ONE verify round for ``rows`` of (slot, req, draft,
        base_len) whose host state is exact (just drained or just
        harvested). Loop thread only; lock NOT held."""
        k = self.cfg.spec_draft_len
        with self._lock:
            for _slot, req, _draft, _base in rows:
                req.spec_inflight = True
                req.dispatched += k + 1
            dirty, self._dirty_slots = self._dirty_slots, {}
            overrides, self._overrides = self._overrides, {}
        t0 = time.perf_counter() if self._prof.enabled else 0.0
        self._flush_slot_patches(dirty, overrides)
        spec_slots = [slot for slot, _r, _d, _b in rows]
        w = self._bucket_width(len(spec_slots))
        idx = np.full((w,), self.cfg.max_batch_size, np.int64)
        idx[: len(spec_slots)] = spec_slots
        draft_mat = np.full((w, k), -1, np.int64)
        entry = []  # (col, slot, req, draft, base_len)
        for col, (slot, req, draft, base_len) in enumerate(rows):
            draft_mat[col, : len(draft)] = draft
            entry.append((col, slot, req, draft, base_len))
        with self._prof.compile_scope(
                "verify", ("verify", w, k),
                mid_traffic=self.stats["requests"] > 0):
            all_toks = self._run_program(("verify", w, k), self._verify_round,
                                         idx, draft_mat)
        self._pending.append((_Fetch(all_toks), entry, ("spec", k)))
        self.stats["steps"] += k + 1
        self.stats["attn_verify_dispatches"] += 1
        if self._prof.enabled:
            self._prof.record("verify_dispatch", time.perf_counter() - t0)

    def _spec_step(self) -> bool:
        """TRANSITION decode-mode slots with drafts into verify rounds.

        Speculation needs the host's view of a slot to be authoritative
        (drafts continue the slot's true token sequence, and rollback needs
        its true cache length), so entering spec mode drains the entries
        in flight once. After that the slot CHAINS drain-free: each verify
        harvest leaves its host state exact, so _apply_verify re-proposes
        and dispatches the next round directly, and the slot falls back
        into decode blocks only when no draft comes. A cheap pre-check on
        the (possibly pipeline-stale) host context avoids paying the drain
        when nothing would draft."""
        with self._lock:
            # gate on generated (host truth lower bound), NOT dispatched:
            # pipelined decode runs dispatched ahead to max_tokens within a
            # few blocks, which would silence speculation for the rest of
            # the generation. A stale-context false positive just costs the
            # drain (the post-drain re-propose is authoritative).
            if not any(req is not None and not req.done
                       and len(req.generated) < req.max_tokens
                       and not req.spec_inflight
                       and self._propose_locked(req)
                       for req in self.slot_req):
                return False
            n = len(self._pending)
        # drain the entries present NOW: chained verify rounds appended by
        # these harvests belong to already-speculating slots and never
        # reference the transitioning ones
        for _ in range(n):
            self._harvest_one()
        with self._lock:
            rows = []  # (slot, req, draft, base_len)
            for slot, req in enumerate(self.slot_req):
                if req is None or req.spec_inflight \
                        or req.dispatched >= req.max_tokens:
                    continue
                draft = self._propose_locked(req)
                if not draft:
                    continue
                # device cache length for this slot: prompt + every
                # recorded token except the current one (the verify
                # round's position-0 input). Exact because the pipeline
                # was just drained.
                base_len = len(req.prompt_tokens) + len(req.generated) - 1
                rows.append((slot, req, draft, base_len))
        if not rows:
            return False
        self._dispatch_verify(rows)
        return True

    def _apply_verify(self, host: np.ndarray, rows, k: int) -> None:
        """Record a verify round: per slot, accept the longest draft prefix
        matching the per-position outputs, emit accepted+1 tokens through
        _record_token, and roll the slot's seq_len back past the rejected
        tail through the dirty-slot patch. Rollback is pure length
        accounting — no allocator calls, so shared prefix-cache pages are
        never decreffed or evicted by a rejection.

        Slots whose fresh context drafts again chain straight into the next
        verify round (their just-harvested host state is exact); the rest
        drop back to decode blocks. Once the engine is stopping (shutdown
        drains the entries in flight on the caller's thread) nothing
        chains: the drain then ends with the rounds already dispatched."""
        host = host.reshape(k + 1, -1)
        finished: list[_Request] = []
        chain = []  # (slot, req, draft, base_len)
        with self._lock:
            self.stats["spec_rounds"] += 1
            for col, slot, req, draft, base_len in rows:
                req.spec_inflight = False
                outs = [int(host[s, col]) for s in range(k + 1)]
                a = spec_decode.accept_length(draft, outs)
                self.stats["spec_drafted_tokens"] += len(draft)
                self.stats["spec_accepted_tokens"] += a
                emitted = 0
                for tok in outs[: a + 1]:
                    if req.done:
                        break  # stop token inside the accepted run
                    self._record_token(req, tok)
                    emitted += 1
                if req.done:
                    finished.append(req)
                    if self.slot_req[slot] is req:
                        self.slot_req[slot] = None
                        self.free_slots.append(slot)
                        self.page_tables[slot] = 0
                        self.seq_lens[slot] = 0
                        self._dirty_slots[slot] = (0, 0.0)
                    continue
                # roll back: the device seq_len advanced k+1 in the round;
                # the truth is base_len + emitted (the accepted tokens are
                # in cache, the last emitted token is the new current one)
                new_len = base_len + emitted
                self.seq_lens[slot] = new_len
                self._dirty_slots[slot] = (new_len, req.temperature)
                self._overrides[slot] = outs[emitted - 1]
                req.dispatched = len(req.generated)
                nxt = self._propose_locked(req)
                if nxt:
                    chain.append((slot, req, nxt, new_len))
        if chain and not self._stop.is_set():
            self._dispatch_verify(chain)
        self._finish_requests(finished)

    def _harvest_one(self) -> None:
        """Block on the OLDEST in-flight entry's tokens and record them.

        Entries are decode blocks (tokens [k, W] at the PACKED bucket
        width — the column is the request's position in that block's
        packed index vector, NOT its slot id), prefill first-tokens
        (scalar, column 0), or verify rounds (meta ("spec", k), tokens
        [k+1, W], recorded by _apply_verify)."""
        with self._lock:
            if not self._pending:
                return
            fetch, snapshot, k = self._pending.pop(0)
        if self._prof.enabled:
            t0 = time.perf_counter()
            host_toks = fetch.wait()  # THE device sync: oldest entry only
            self._prof.record("harvest", time.perf_counter() - t0)
        else:
            host_toks = fetch.wait()
        if isinstance(k, tuple):  # ("spec", draft_len) verify round
            self._apply_verify(host_toks, snapshot, k[1])
            return
        host_toks = host_toks.reshape(k, -1)
        finished: list[_Request] = []
        with self._lock:
            for step in range(k):
                for col, slot, req in snapshot:
                    if req.done:
                        continue  # stop/max lag: discard overshoot tokens
                    self._record_token(req, int(host_toks[step, col]))
                    if req.done:
                        finished.append(req)
                        if self.slot_req[slot] is req:
                            self.slot_req[slot] = None
                            self.free_slots.append(slot)
                            self.page_tables[slot] = 0
                            self.seq_lens[slot] = 0
                            # invalidate the DEVICE row too: a stale device
                            # page table keeps scattering this slot's junk
                            # KV into pages after they're reallocated
                            self._dirty_slots[slot] = (0, 0.0)
        self._finish_requests(finished)

    def _finish_requests(self, finished: list[_Request]) -> None:
        """Completion tail shared by decode and verify harvests: free pages,
        release waiters, record trace spans, reap abandoned."""
        for req in finished:
            self.allocator.free(req.pages)
            req.pages = []
        for req in finished:
            req.done_event.set()
            if req.trace_ctx:
                # the span ends where the request finished, on the wall
                # clock of its submit stamp (as the attribution stages
                # do): its duration is the completion's latency_s, free
                # of the time this tail takes to reach it
                end = req.submitted_wall + (
                    (req.finished_at or time.monotonic()) - req.submitted_at)
                tracing.record_span(
                    "llm.generate", req.submitted_wall, end,
                    parent=req.trace_ctx, kind="llm",
                    attrs={"request_id": req.request_id,
                           "prompt_tokens": len(req.prompt_tokens),
                           "generated_tokens": len(req.generated)})
            if req.abandoned:
                with self._lock:
                    self._requests.pop(req.request_id, None)
