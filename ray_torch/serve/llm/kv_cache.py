"""Paged KV cache + paged attention steps for continuous batching: the
PyTorch counterpart of ``ray_tpu/serve/llm/kv_cache.py``.

KV lives in a fixed pool of fixed-size pages on the device; each decode
slot owns a page table mapping logical sequence positions to pool pages.
Pool layout ``[L, Hkv, P, page, D]``, head-major per layer, which is what
the paged-attention kernel (``ray_torch/ops/paged_attention.py``) reads
directly.

Design choices, as in the reference:
- attention over the paged pool dispatches through ONE backend switch
  (``LLMConfig.attention_kernel``, resolved once by
  :func:`resolve_attention_backend`): ``"cuda"`` runs the hand-written
  kernel, which reads each slot's live pages through its page table;
  ``"gather"`` materializes the full per-slot view + dense softmax (the
  kernel's plain PyTorch version). Both give the same floats up to
  summation order, so greedy tokens match;
- writes are scatters at (page, offset) index pairs; inactive slots and
  prompt padding write to a reserved trash page (page 0);
- full (non-chunked) prefill stays dense within the prompt: it runs at
  B=1 per admission with no cached prefix to read back.

Where the reference's jitted steps took the pool as a donated argument and
returned a new one, these steps update ``kv["k"]`` / ``kv["v"]`` IN PLACE
(index writes into the per-layer views) and do not return the pool — the
same memory behaviour, without a second pool.

The reference's ``lax.scan`` over layers is a Python loop over the stacked
layer axis here.

Page 0 is RESERVED as the trash page; the allocator never hands it out.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from ray_torch.models.llama import (
    LlamaConfig,
    dense_attention,
    embed,
    rope_freqs,
    run_layers,
)
from ray_torch._device import resolve_device
from ray_torch.ops import paged_attention as paged_ops

logger = logging.getLogger(__name__)

def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device: torch.device | str = "cuda") -> dict:
    """KV pool: [n_layers, n_kv_heads, num_pages, page_size, head_dim], on
    the card unless the caller names the CPU (raises without a GPU)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def page_raw_nbytes(cfg: LlamaConfig, page_size: int) -> int:
    """Bytes ONE pool page holds across all layers, k + v."""
    per = cfg.n_layers * cfg.n_kv_heads * page_size * cfg.head_dim
    return 2 * per * cfg.dtype.itemsize


def _chain_digest(parent: bytes, chunk) -> bytes:
    """Hash-chain node key for one FULL page of prompt tokens: digest of
    (parent page's digest, this page's token ids). Chaining makes the key
    encode the entire token prefix, so equal digests mean equal prefixes.
    blake2b-128 so a collision (which would silently serve the wrong KV)
    is cryptographically excluded rather than merely unlikely. Byte-for-
    byte the reference's digest."""
    return hashlib.blake2b(
        parent + np.asarray(chunk, np.int32).tobytes(),
        digest_size=16).digest()


class PageAllocator:
    """Host-side free list + prefix cache over the page pool (page 0
    reserved as trash). The reference's allocator, less the digest-chain
    methods and the routing-summary export (``match_digest_chain``,
    ``insert_digest_chain``, ``prefix_summary``), whose only callers are the
    warm start and the prefetch hints of the serve layer still to come.

    Prefix caching: pages are REFCOUNTED, and full pages of prompt tokens
    can be registered in a hash-chained index (one node per full page,
    keyed on the chain digest of every token up to the page's end). A page
    whose refcount drops to zero while indexed is not returned to the free
    list — it parks in an LRU of cached pages, its KV content intact, and
    is either resurrected by a later ``match_prefix`` (refcount 1 again,
    shared) or evicted back to the free list under pool pressure. Because
    only refcount-zero pages are evictable, eviction can never free a page
    a live slot's page table still references.

    ``cache_pages`` caps how many refcount-zero cached pages are retained
    (0 = bounded only by the pool itself).

    Spilling (serve/llm/kv_tier.py): ``spill_hook``, when set, receives
    every ``(page, digest, chain_pos)`` evicted during one ``alloc()`` /
    ``free()`` call — after the allocator lock is released but BEFORE
    control returns to the caller, i.e. before the caller can dispatch
    device writes that reuse the freed pages (the hook's gather lands
    first on the ordered device stream). A raising hook is swallowed:
    the eviction has already completed, so behavior degrades to a plain
    free — no page leaks, no deadlock, just no spill.
    """

    def __init__(self, num_pages: int, cache_pages: int = 0):
        self._free = list(range(num_pages - 1, 0, -1))  # stack; never page 0
        self._lock = threading.Lock()
        self.num_pages = num_pages
        self._cache_cap = int(cache_pages)
        self._ref: dict[int, int] = {}          # live page -> refcount
        self._index: dict[bytes, int] = {}      # chain digest -> page
        self._page_key: dict[int, bytes] = {}   # indexed page -> digest
        self._page_pos: dict[int, int] = {}     # indexed page -> chain pos
        self._lru: OrderedDict[int, None] = OrderedDict()  # ref-0 cached
        self.spill_hook = None
        self.counters = {"hit_pages": 0, "miss_pages": 0, "evicted": 0,
                         "inserted": 0}

    # ---- allocation ----------------------------------------------------
    def _evict_one_locked(self, spilled: list | None = None) -> bool:
        """Drop the least-recently-used refcount-zero cached page back to
        the free list (its index node dies with it). Lock held. When a
        spill hook is installed, the page's (page, digest, chain_pos) is
        appended to ``spilled`` for the post-lock hook call."""
        if not self._lru:
            return False
        page, _ = self._lru.popitem(last=False)
        key = self._page_key.pop(page)
        pos = self._page_pos.pop(page, None)
        if self._index.get(key) == page:
            del self._index[key]
        if spilled is not None and self.spill_hook is not None:
            spilled.append((page, key, pos))
        self._free.append(page)
        self.counters["evicted"] += 1
        return True

    def _fire_spill_hook(self, spilled: list) -> None:
        hook = self.spill_hook
        if hook is None or not spilled:
            return
        try:
            hook(spilled)
        except Exception:  # noqa: BLE001 - spill is best-effort by contract
            logger.warning(
                "kv-tier spill hook failed; %d pages evicted without "
                "spilling", len(spilled), exc_info=True)

    def alloc(self, n: int) -> list[int] | None:
        """n fresh pages at refcount 1, evicting cached pages LRU-first
        under pressure; None when free + evictable can't cover n."""
        spilled: list = []
        with self._lock:
            if len(self._free) + len(self._lru) < n:
                return None  # can't be satisfied — don't evict for nothing
            while len(self._free) < n:
                self._evict_one_locked(spilled)
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
        self._fire_spill_hook(spilled)
        return out

    def free(self, pages: list[int]) -> None:
        """Decref; a page reaching zero parks in the cached LRU if indexed
        (content stays valid for later matches), else rejoins the free
        list. Safe against double-free of already-dead pages."""
        spilled: list = []
        with self._lock:
            for p in pages:
                if p == 0:
                    continue
                cur = self._ref.get(p)
                if cur is None:
                    # already dead: a double free must not re-append the
                    # page (duplicate free-list entries would hand one
                    # page to two requests)
                    continue
                if cur > 1:
                    self._ref[p] = cur - 1
                    continue
                del self._ref[p]
                if p in self._page_key:
                    self._lru[p] = None
                    self._lru.move_to_end(p)
                    while self._cache_cap > 0 \
                            and len(self._lru) > self._cache_cap:
                        self._evict_one_locked(spilled)
                else:
                    self._free.append(p)
        self._fire_spill_hook(spilled)

    def incref(self, pages: list[int]) -> None:
        with self._lock:
            for p in pages:
                if p != 0:
                    self._ref[p] = self._ref.get(p, 0) + 1

    def available(self) -> int:
        """Pages an alloc() could obtain: strictly-free + evictable
        cached (see cache_stats() for the three-way breakdown)."""
        with self._lock:
            return len(self._free) + len(self._lru)

    def refcount(self, page: int) -> int:
        """Current refcount of one page (0 = free or parked in the cached
        LRU). Inspection only."""
        with self._lock:
            return self._ref.get(page, 0)

    # ---- prefix index --------------------------------------------------
    def match_prefix(self, tokens, page_size: int) -> list[int]:
        """Longest indexed chain of FULL token pages that prefixes
        ``tokens``, capped so at least one token is left to prefill (the
        suffix pass is what produces the first sampled token). Matched
        pages are increffed (cached ref-0 pages resurrect from the LRU) —
        the caller owns one reference and releases it via free()."""
        limit = (len(tokens) - 1) // page_size
        out: list[int] = []
        if limit <= 0:
            return out
        with self._lock:
            digest = b""
            for i in range(limit):
                digest = _chain_digest(
                    digest, tokens[i * page_size:(i + 1) * page_size])
                page = self._index.get(digest)
                if page is None:
                    self.counters["miss_pages"] += 1
                    break
                out.append(page)
            for p in out:
                if p in self._lru:
                    del self._lru[p]
                self._ref[p] = self._ref.get(p, 0) + 1
            self.counters["hit_pages"] += len(out)
        return out

    def insert_prefix(self, tokens, pages: list[int],
                      page_size: int) -> int:
        """Register a request's FULL prompt pages in the index (pages[i]
        holds tokens [i*page_size, (i+1)*page_size)). First writer wins: a
        chunk whose digest is already indexed keeps the existing page (the
        duplicate page simply stays un-indexed and frees normally).
        Returns how many new nodes were added."""
        added = 0
        with self._lock:
            digest = b""
            for i in range(min(len(tokens) // page_size, len(pages))):
                digest = _chain_digest(
                    digest, tokens[i * page_size:(i + 1) * page_size])
                if digest in self._index:
                    continue
                page = pages[i]
                if page == 0 or page in self._page_key:
                    continue
                self._index[digest] = page
                self._page_key[page] = digest
                # chain position: the spill path registers each evicted
                # page's token length, (pos + 1) * page_size
                self._page_pos[page] = i
                added += 1
            self.counters["inserted"] += added
        return added

    def cache_stats(self) -> dict:
        """Snapshot for engine stats. Three distinct occupancy numbers:

        - ``free_pages``: strictly free — on the free list, content dead;
        - ``evictable_pages``: refcount-zero but cached — content is live,
          reusable KV; allocating them evicts first;
        - live/referenced pages: ``num_pages - 1 - free - evictable``
          (page 0 is the reserved trash page) — never evictable.

        ``available()`` = free_pages + evictable_pages.
        """
        with self._lock:
            return {**self.counters,
                    "free_pages": len(self._free),
                    "cached_pages": len(self._page_key),
                    "evictable_pages": len(self._lru),
                    "shared_pages": sum(1 for c in self._ref.values()
                                        if c > 1)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def resolve_attention_backend(choice, cfg: LlamaConfig | None = None,
                              device: torch.device | str = "cpu") -> str:
    """Resolve ``LLMConfig.attention_kernel`` to ``"cuda"`` or ``"gather"``.

    ``"auto"`` (default) is the CUDA kernel on a CUDA device and gather on
    the CPU. An explicit ``"cuda"`` on the CPU raises: a CUDA kernel has
    no interpreter mode. The kernel's shape and dtype limits are checked
    here, so an engine the kernel cannot serve fails at construction."""
    dev = torch.device(device)
    if choice in (None, "", "auto"):
        choice = "cuda" if dev.type == "cuda" else "gather"
    if choice not in ("gather", "cuda"):
        raise ValueError(
            f"attention_kernel must be 'auto', 'gather' or 'cuda', "
            f"got {choice!r}")
    if choice == "cuda":
        if dev.type != "cuda":
            raise ValueError(
                "attention_kernel='cuda' needs a CUDA device (the kernel "
                f"has no interpreter mode), got device {str(dev)!r}")
        if cfg is not None:
            paged_ops.check_shapes(cfg.head_dim, cfg.dtype)
    return choice


def _page_index(page_tables: torch.Tensor, pos: torch.Tensor,
                page_size: int) -> torch.Tensor:
    """Pool page of each position through its row's page table: [B, T].
    Positions past the table span (a decode block overshooting a request's
    last page) map to the trash page."""
    col = torch.div(pos, page_size, rounding_mode="floor").long()
    in_table = col < page_tables.shape[1]
    page = page_tables.gather(1, col.clamp(max=page_tables.shape[1] - 1))
    return torch.where(in_table, page, 0).long()


def _write_token_kv(k_cache, v_cache, k_new, v_new, page_idx, offset):
    """Scatter new tokens' k/v into one layer's page pool, in place.

    k_cache: [Hkv, P, page, D]; k_new: [..., Hkv, D] whose leading dims
    match page_idx/offset ([B] for one token per slot, [B, T] or [T] for
    spans). Real slots write distinct (page, offset) pairs; padding lanes
    may collide on the trash page, which nothing reads."""
    k_cache[:, page_idx, offset] = torch.movedim(k_new, -2, 0).to(
        k_cache.dtype)
    v_cache[:, page_idx, offset] = torch.movedim(v_new, -2, 0).to(
        v_cache.dtype)


def _decode_attention(q, k_cache, v_cache, page_tables, pos, cfg, page_size,
                      attn_backend: str = "gather"):
    """Single-token attention over the paged KV for all slots.

    q: [B, H, D]; k_cache/v_cache: [Hkv, P, page, D]; pos: [B] (the new
    token's position — attend over 0..pos inclusive)."""
    sm = cfg.head_dim ** -0.5
    if attn_backend == "cuda":
        return paged_ops.paged_decode_attention(
            q, k_cache, v_cache, page_tables, pos, sm_scale=sm)
    max_len = page_tables.shape[1] * page_size
    limit = torch.full_like(pos, max_len)
    return paged_ops.paged_attention_reference(
        q[:, None], k_cache, v_cache, page_tables, pos, limit,
        sm_scale=sm)[:, 0]


def _logits(x: torch.Tensor, params: dict) -> torch.Tensor:
    return (x @ params["lm_head"]).float()


def paged_decode_step(params, kv, page_tables, seq_lens, tokens,
                      cfg: LlamaConfig, page_size: int,
                      attn_backend: str = "gather"):
    """One decode step for all slots; updates ``kv`` in place.

    tokens: [B] current token ids; seq_lens: [B] int32 tokens already in
    cache (the new token lands at position seq_lens[b]); page_tables:
    [B, max_pages] int32 pool page ids (trash page 0 for unused entries).
    Returns (logits [B, vocab] fp32, seq_lens + 1). Inactive slots carry
    seq_lens pointing at trash-page positions; their logits are junk and
    the engine ignores them.
    """
    x = embed(params, tokens[:, None], cfg)                      # [B,1,D]
    cos, sin = rope_freqs(cfg, seq_lens[:, None])                # position = len
    pos = seq_lens
    page_idx = _page_index(page_tables, pos[:, None], page_size)[:, 0]
    offset = (pos % page_size).long()

    def attend(l, q, k, v):
        k_cache, v_cache = kv["k"][l], kv["v"][l]
        _write_token_kv(k_cache, v_cache, k[:, 0], v[:, 0], page_idx, offset)
        return _decode_attention(q[:, 0], k_cache, v_cache, page_tables, pos,
                                 cfg, page_size, attn_backend)[:, None]

    x = run_layers(params, x, cos, sin, cfg, attend)
    return _logits(x[:, 0], params), seq_lens + 1


def paged_verify_step(params, kv, page_tables, seq_lens, tokens,
                      cfg: LlamaConfig, page_size: int,
                      attn_backend: str = "gather"):
    """Speculative verify: T tokens per slot in ONE pass; updates ``kv``
    in place.

    tokens: [B, T] — slot b's current token followed by its T-1 drafted
    tokens; tokens[b, t] lands at position seq_lens[b] + t. All T
    positions are computed together (causal within the span, full
    attention over the paged cache): logits[b, t] equal what
    paged_decode_step would produce after consuming tokens[b, :t+1].
    Returns (logits [B, T, vocab] fp32, seq_lens + T).
    """
    t = tokens.shape[1]
    max_len = page_tables.shape[1] * page_size
    x = embed(params, tokens, cfg)                                # [B,T,D]
    pos = seq_lens[:, None] + torch.arange(
        t, dtype=seq_lens.dtype, device=seq_lens.device)[None, :]  # [B,T]
    cos, sin = rope_freqs(cfg, pos)
    page_idx = _page_index(page_tables, pos, page_size)
    offset = (pos % page_size).long()
    limit = torch.full_like(seq_lens, max_len)
    sm = cfg.head_dim ** -0.5

    def attend(l, q, k, v):
        k_cache, v_cache = kv["k"][l], kv["v"][l]
        # write all T tokens' k/v, then attend through the paged view
        _write_token_kv(k_cache, v_cache, k, v, page_idx, offset)
        if attn_backend == "cuda":
            return paged_ops.paged_verify_attention(
                q, k_cache, v_cache, page_tables, seq_lens, sm_scale=sm)
        return paged_ops.paged_attention_reference(
            q, k_cache, v_cache, page_tables, seq_lens, limit, sm_scale=sm)

    x = run_layers(params, x, cos, sin, cfg, attend)
    return _logits(x, params), seq_lens + t                       # [B,T,V]


def _device_scalar(x, device) -> torch.Tensor:
    """A prompt pass's ``start`` or ``true_len`` as a [1] int32 tensor on
    ``device``: a Python int is filled in, a [1] integer tensor already
    there is used as it is (never read on the host), so a captured pass
    reads its value at every replay."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(torch.int32)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def _last_row(x: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Row ``rel`` ([1], clamped into the span) of x [1, T, D]: [1, D]."""
    rel = rel.clamp(0, x.shape[1] - 1).long()
    return x.index_select(1, rel)[:, 0]


def paged_prefill(params, kv, page_table, tokens, true_len,
                  cfg: LlamaConfig, page_size: int):
    """Prefill ONE slot's prompt into its pages; updates ``kv`` in place.

    tokens: [1, T] (bucket-padded); page_table: [max_pages] for this slot;
    true_len: actual prompt length, a Python int or a [1] integer tensor
    on the pool's device. Returns last-token logits [vocab] (fp32).
    Padding positions (>= true_len) write to the trash page, so junk never
    lands in real pages.
    """
    t = tokens.shape[1]
    dev = tokens.device
    true_len = _device_scalar(true_len, dev)
    x = embed(params, tokens, cfg)                                # [1,T,D]
    pos = torch.arange(t, device=dev)
    cos, sin = rope_freqs(cfg, pos[None, :])
    page_idx = torch.where(pos < true_len,
                           _page_index(page_table[None], pos[None],
                                       page_size)[0], 0)
    offset = pos % page_size
    causal = pos[:, None] >= pos[None, :]
    n_rep = cfg.n_heads // cfg.n_kv_heads

    def attend(l, q, k, v):
        # scatter the prompt's k/v into this slot's pages; attention is
        # dense within the prompt (compute-bound and contiguous — no need
        # to read back through pages)
        _write_token_kv(kv["k"][l], kv["v"][l], k[0], v[0], page_idx, offset)
        return dense_attention(q, k, v, n_rep, cfg.head_dim ** -0.5, causal)

    x = run_layers(params, x, cos, sin, cfg, attend)
    return _logits(_last_row(x, true_len - 1), params)[0]


def paged_prefill_chunk(params, kv, page_table, tokens, start, true_len,
                        cfg: LlamaConfig, page_size: int,
                        attn_backend: str = "gather"):
    """One CHUNK of a long prompt's prefill; updates ``kv`` in place.

    tokens: [1, C] the chunk (bucket-padded); start: position of the
    chunk's first token; true_len: total prompt length (each a Python int
    or a [1] integer tensor on the pool's device). The chunk's queries
    attend to every cached position < start (earlier chunks or a shared
    cached prefix, read back through the page pool) plus causally within
    the chunk. Returns last-token logits [vocab] (fp32) — meaningful only
    on the final chunk.
    """
    c = tokens.shape[1]
    dev = tokens.device
    base_t = _device_scalar(start, dev)
    limit_t = _device_scalar(true_len, dev)
    x = embed(params, tokens, cfg)                                # [1,C,D]
    pos = base_t + torch.arange(c, device=dev)                    # [C]
    cos, sin = rope_freqs(cfg, pos[None, :])
    page_idx = torch.where(pos < limit_t,
                           _page_index(page_table[None], pos[None],
                                       page_size)[0], 0)
    offset = pos % page_size
    sm = cfg.head_dim ** -0.5

    def attend(l, q, k, v):
        k_cache, v_cache = kv["k"][l], kv["v"][l]
        # write the chunk's k/v first, then attend through the paged view,
        # so the chunk sees earlier chunks AND itself causally
        _write_token_kv(k_cache, v_cache, k[0], v[0], page_idx, offset)
        if attn_backend == "cuda":
            return paged_ops.paged_chunk_attention(
                q, k_cache, v_cache, page_table, base_t, limit_t,
                sm_scale=sm)
        return paged_ops.paged_attention_reference(
            q, k_cache, v_cache, page_table[None], base_t, limit_t,
            sm_scale=sm)

    x = run_layers(params, x, cos, sin, cfg, attend)
    # last REAL token's position relative to this chunk's start
    return _logits(_last_row(x, limit_t - 1 - base_t), params)[0]


def sample_tokens(logits, generator: torch.Generator, temperature,
                  top_k: int = 0):
    """Greedy/temperature/top-k sampling on the logits' device; no host
    sync. logits: [B, V]; temperature: [B] (0 -> greedy). Greedy is the
    first index of the row max, as ``jnp.argmax``; sampled draws come
    from ``generator`` and cannot match ``jax.random``'s."""
    greedy = logits.argmax(dim=-1)
    t = temperature.float().clamp_min(1e-6)[:, None]
    if top_k and top_k > 0:
        vals, idx = logits.topk(top_k, dim=-1)
        choice = torch.multinomial(torch.softmax(vals / t, dim=-1), 1,
                                   generator=generator)
        sampled = idx.gather(1, choice)[:, 0]
    else:
        sampled = torch.multinomial(torch.softmax(logits / t, dim=-1), 1,
                                    generator=generator)[:, 0]
    return torch.where(temperature > 0, sampled, greedy)
