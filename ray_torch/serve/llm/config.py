"""LLM serving config: the port's own copy of ``ray_tpu/serve/llm/config.py``.

Same field names and defaults, so one dict configures either package, plus
two fields of the port's own (``device``, ``cuda_graphs``), except
``attention_kernel``: where the reference says ``"pallas"`` for its kernel,
the port says ``"cuda"`` (and raises on ``"pallas"``).

Of the fields of features this slice of the port does not carry yet, three
make the engine raise unless they keep their defaults (``_NOT_PORTED`` in
``engine.py``): ``tp_degree``, ``disagg_prompt_threshold`` and
``disagg_prefill_deployment``. The SLO and routing fields
(``slo_ttft_p99_ms``, ``slo_e2e_p99_ms``, ``prefix_summary_max_pages``) are
read by the reference's serve layer (``ray_tpu/serve/proxy.py:263-311``,
``ray_tpu/serve/llm/llm_server.py:477-479``), which waits for the port's
serve layer: the engine accepts them and nothing reads them yet. Nothing
reads ``warm_start_*`` either (the tier's warm start waits for the serve
layer). The ``kv_tier_*`` fields configure the KV tier (``kv_tier.py``);
``failover_enabled`` gates the engine's continuation submits and
``failover_max_resumes`` the server's choice between a continuation and a
retry from scratch (``llm_server._resume_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class LLMConfig:
    """Model + continuous-batching engine sizing.

    ``max_batch_size`` fixes the decode slot count; prompt prefill pads to
    power-of-two buckets bounded by ``max_prompt_len``; the KV cache is
    paged so long and short sequences share one device pool.
    """

    # model
    model_id: str = "llama-tiny"
    model_config: Any = None          # ray_torch.models.llama.LlamaConfig
    checkpoint_path: Optional[str] = None  # save_params npz; None = random init
    tokenizer: str = "byte"           # "byte" | HF tokenizer local path

    # where the engine runs: "cuda" (default) or "cpu". "cuda" without a
    # visible GPU raises — there is no silent CPU fallback.
    device: str = "cuda"
    # the engine's decode blocks and verify rounds as captured CUDA graphs,
    # one per signature (the reference's jitted programs): None (default)
    # is on for a CUDA device and off on the CPU; True on the CPU raises;
    # False dispatches every kernel of a step eagerly
    cuda_graphs: Optional[bool] = None

    # engine sizing
    max_batch_size: int = 8           # decode slots
    page_size: int = 128              # tokens per KV page
    num_pages: int = 256              # total pages in the device pool
    max_prompt_len: int = 512
    max_seq_len: int = 1024           # prompt + generation cap per request
    # prompts longer than this prefill in chunks of this many tokens,
    # interleaved with decode blocks (chunked prefill): a long admission
    # stalls active generations by at most one chunk, not the whole prompt
    prefill_chunk: int = 512
    # Paged-attention backend (serve/llm/kv_cache.py +
    # ops/paged_attention.py): "cuda" runs the hand-written kernel, which
    # reads K/V pages straight from the pool through the slot page table;
    # "gather" materializes each slot's full view + dense softmax. "auto"
    # (default) is the kernel on a CUDA device and gather on the CPU.
    # One dict configures either package except here: where the reference
    # says "pallas" for its kernel, the port says "cuda" ("pallas" raises).
    attention_kernel: str = "auto"    # "auto" | "gather" | "cuda"
    # not ported yet: must stay 1
    tp_degree: int = 1
    # decode steps dispatched back to back per block when the batch is
    # steady (multi-step decode); streaming granularity and stop-token lag
    # grow with it
    decode_block: int = 8
    # decode block while requests queue for slots (slot-starved): smaller
    # blocks detect stop tokens (and free slots for the queue) sooner
    pressure_decode_block: int = 2
    # dispatched-but-unharvested decode blocks (the host reads sampled
    # tokens this many blocks behind the device)
    pipeline_depth: int = 3

    # time the first dispatch of every (width, block) decode signature at
    # start() instead of on first use mid-traffic
    warmup_compile: bool = True

    # phase timers, inter-token-latency ring and device-memory gauges in
    # engine_stats() (observability/profiling.py)
    profiling_enabled: bool = True

    # Automatic prefix caching: full pages of prompt KV are kept in a
    # refcounted hash-chained index, and later admissions with a matching
    # token prefix share those pages and prefill ONLY the suffix.
    prefix_cache_enabled: bool = True
    # cap on refcount-zero cached pages retained for reuse (LRU beyond it);
    # 0 = bounded only by the pool
    prefix_cache_max_pages: int = 0

    # Speculative decoding (spec_decode.py): greedy slots draft up to
    # spec_draft_len tokens by n-gram lookup over their own context (n up
    # to spec_ngram_max), verified in one multi-position pass per round
    spec_decode_enabled: bool = False
    spec_draft_len: int = 4
    spec_ngram_max: int = 3

    # Tiered KV cache (serve/llm/kv_tier.py): prefix pages evicted from the
    # pool spill to host memory (an in-process shm tier backed by a bounded
    # local disk tier) and a returning prompt restores them, so only its
    # suffix is prefilled. Greedy outputs stay identical to a cold prefill
    # under the lossless codec; every tier failure degrades to a plain
    # cache miss. Requires prefix_cache_enabled. Default off.
    # Measured cost (H100, llama3_1b, pages of 128 tokens): a restore
    # through the default lossless codec costs MORE than the prefill it
    # replaces (TTFT 436-555 ms restored against 64-155 ms cold), and each
    # spill's encode runs on the engine loop and blocks every live request
    # (1.3-1.5 s); raw pages (codec "none") only tie a cold prefill.
    # Source: chip_smoke.py phase 10, recorded in PERF.md section 6;
    # moving the codec off the loop is ROADMAP Queue 1 item 1d.
    kv_tier_enabled: bool = False
    kv_tier_max_bytes: int = 256 * 1024 * 1024
    kv_tier_disk_dir: Optional[str] = None
    kv_tier_disk_max_bytes: int = 1024 * 1024 * 1024
    kv_tier_ttl_s: float = 600.0
    kv_tier_codec: str = "lossless"
    kv_tier_chunk_pages: int = 8
    kv_tier_chunk_timeout_s: float = 2.0
    kv_tier_stream_window_bytes: int = 8 * 1024 * 1024

    # Cache-warm scale-up (waits for the serve layer; nothing reads these)
    warm_start_enabled: bool = True
    warm_start_max_bytes: int = 64 * 1024 * 1024
    warm_start_budget_s: float = 5.0
    warm_start_max_chains: int = 64

    # Mid-stream generation failover: a re-dispatched stream resumes as a
    # continuation (prompt + already-streamed tokens through the
    # cache-aware admission path) up to failover_max_resumes times, then
    # degrades to a retry from scratch with the streamed prefix suppressed
    failover_enabled: bool = True
    failover_max_resumes: int = 2

    # Fleet prefill/decode disaggregation — not ported yet: the threshold
    # must stay 0
    disagg_prompt_threshold: int = 0
    disagg_prefill_deployment: Optional[str] = None
    disagg_wire_codec: str = "lossless"
    disagg_int8_max_divergence: float = 0.0

    # Prefix-affinity routing summary cap (serve layer not ported yet)
    prefix_summary_max_pages: int = 512

    # sampling defaults (overridable per request)
    max_tokens: int = 128
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = full softmax

    # serving
    num_replicas: int = 1
    name: str = "llm"
    ray_actor_options: Optional[dict] = None

    # SLO policy (serve layer not ported yet)
    slo_ttft_p99_ms: Optional[float] = None
    slo_e2e_p99_ms: Optional[float] = None
    slo_sample_rate: float = 0.01

    def llama(self):
        from ray_torch.models import llama
        if self.model_config is not None:
            return self.model_config
        return llama.llama_tiny()
