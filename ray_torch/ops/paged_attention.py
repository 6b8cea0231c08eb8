"""Paged attention for the serving path: the wrapper of the hand-written
CUDA kernel (``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of ``ray_tpu/ops/paged_attention.py``: same function, same
layouts. One core computation covers decode (T=1), multi-query
speculative verify (T=k+1, causal within the span) and chunked prefill
(B=1, ``limit=true_len``), dispatched through thin wrappers.

Identity contract: greedy tokens through the kernel equal the gather path
exactly, so the kernel computes the gather path's dense-softmax numerics
(see the note at the head of the source). Outputs agree with
:func:`paged_attention_reference` to the last ULPs of the dtype; sums are
taken in another order.

Dispatch is by the tensor's device, never by a fallback: a CPU tensor
takes :func:`paged_attention_reference`; a CUDA tensor launches a kernel
(each launch adds one to its kernel's count in ``launches``) or
raises — on a failed build, a shape the kernel does not take, or a refused
launch. Three kernels share the semantics (:func:`route` picks one): bf16
decode and verify launches (at most 16 query rows a slot and kv head) take
``paged_decode_hopper``; bf16 launches of more rows (the chunked prefill)
at D 64 or 128 with pages that tile a 64-key tile take
``paged_chunk_hopper``; everything else (fp32, other head dims and page
sizes, a decode span whose scores do not fit) takes
``paged_attention_kernel``.
"""

from __future__ import annotations

import ctypes

import torch

from ray_torch.models.llama import dense_attention
from ray_torch.ops import _build

# kernel launches of this process, per kernel (reset by whoever reads
# them)
launches = {"paged_decode_hopper": 0, "paged_chunk_hopper": 0,
            "paged_attention_kernel": 0}

# launch geometry; csrc/paged_attention.cu holds the same constants
_KEY_TILE = 64
_MAX_ROWS = 16
_MAX_HEAD_DIM = 256
_SMEM_LIMIT = 231424
_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 decode route (paged_decode_hopper)
_DECODE_KEYS = 64
_DECODE_STAGES = 4
_DECODE_WARPS = 8
_DECODE_MAX_ROWS = 16
_DECODE_HEAD_DIMS = (64, 128)
# the bf16 chunk route (paged_chunk_hopper)
_CHUNK_CONSUMERS = 2
_CHUNK_THREADS = 128 * (1 + _CHUNK_CONSUMERS)
_CHUNK_ROWS = 64
_CHUNK_KEYS = 64
_CHUNK_STAGES = 4
_CHUNK_HEAD_DIMS = (64, 128)


def _smem_bytes(rows: int, head_dim: int, score_ld: int) -> int:
    """Dynamic shared memory of one block: query rows, one K/V tile, the
    scores, and per-row max / sum / live length (the kernel's carve-up)."""
    ld = head_dim + 1
    return 4 * (rows * ld + _KEY_TILE * ld + rows * score_ld + 2 * rows) \
        + 4 * rows


def launch_plan(n_rows: int, head_dim: int, max_len: int) -> tuple[int, bool]:
    """(query rows per block, keep the scores in shared memory). The most
    rows (up to 16) whose fp32 scores over the whole table span fit; when
    not even one row's do, 16 rows that recompute their scores per pass."""
    rows = min(n_rows, _MAX_ROWS)
    for r in range(rows, 0, -1):
        if _smem_bytes(r, head_dim, max_len) <= _SMEM_LIMIT:
            return r, True
    return rows, False


def _decode_smem_bytes(rows: int, head_dim: int, max_len: int,
                       max_pages: int) -> int:
    """Dynamic shared memory of one decode-route block: alignment slack,
    the ring of bf16 K/V tiles and its barriers, the rows' fp32 scores over
    the table span, the warps' partial row max and sum, and the slot's
    page-table row (the kernel's carve-up)."""
    return (128 + 2 * _DECODE_STAGES * _DECODE_KEYS * head_dim
            + 16 * _DECODE_STAGES
            + 4 * (rows * max_len + 2 * _DECODE_WARPS * rows + max_pages))


def decode_rows(n_rows: int, head_dim: int, page_size: int, max_pages: int,
                dtype: torch.dtype) -> int | None:
    """Query rows of a ``paged_decode_hopper`` block (a slot and kv head's
    ``n_rows`` = n_rep * T rounded up to 2, 4, 8 or 16), or None when the
    launch takes ``paged_attention_kernel``: fp32, more than 16 rows (a
    prefill chunk), a head_dim other than 64 or 128, or scores over the
    table span that do not fit in shared memory."""
    if dtype != torch.bfloat16 or head_dim not in _DECODE_HEAD_DIMS \
            or not 1 <= n_rows <= _DECODE_MAX_ROWS:
        return None
    rows = max(2, 1 << (n_rows - 1).bit_length())
    if _decode_smem_bytes(rows, head_dim, page_size * max_pages,
                          max_pages) > _SMEM_LIMIT:
        return None
    return rows


def _chunk_smem_bytes(head_dim: int, max_pages: int) -> int:
    """Dynamic shared memory of one chunk-route block: alignment slack, the
    unit's bf16 Q tile, each consumer's ring of bf16 K/V tiles, the
    consumers' partial row max and sum, the rings' barriers and the slot's
    page-table row (the kernel's carve-up)."""
    return (1024 + 2 * (_CHUNK_ROWS
                        + _CHUNK_CONSUMERS * _CHUNK_STAGES * _CHUNK_KEYS)
            * head_dim + 4 * 2 * _CHUNK_CONSUMERS * _CHUNK_ROWS
            + 8 * (1 + 2 * _CHUNK_CONSUMERS * _CHUNK_STAGES)
            + 4 * max_pages)


def chunk_plan(n_rows: int, head_dim: int, page_size: int, max_pages: int,
               dtype: torch.dtype) -> dict | None:
    """The block of a ``paged_chunk_hopper`` launch — threads, query rows
    (one rep at 64 consecutive positions, whose key tiles two consumer
    warpgroups split) and dynamic shared memory — or None when the launch
    takes another kernel: fp32, at most 16 rows a slot and kv head (the
    decode route's), a head_dim other than 64 or 128, or a page that is
    not a multiple of 8 keys dividing the 64-key tile or a multiple of
    it."""
    if dtype != torch.bfloat16 or head_dim not in _CHUNK_HEAD_DIMS \
            or n_rows <= _DECODE_MAX_ROWS or page_size % 8 \
            or (_CHUNK_KEYS % page_size and page_size % _CHUNK_KEYS):
        return None
    smem = _chunk_smem_bytes(head_dim, max_pages)
    if smem > _SMEM_LIMIT:
        return None
    return {"threads": _CHUNK_THREADS, "rows": _CHUNK_ROWS, "smem": smem}


def route(n_rows: int, head_dim: int, page_size: int, max_pages: int,
          dtype: torch.dtype) -> str:
    """The kernel a launch takes (see :func:`decode_rows` and
    :func:`chunk_plan`)."""
    if decode_rows(n_rows, head_dim, page_size, max_pages, dtype) is not None:
        return "paged_decode_hopper"
    if chunk_plan(n_rows, head_dim, page_size, max_pages, dtype) is not None:
        return "paged_chunk_hopper"
    return "paged_attention_kernel"


def check_shapes(head_dim: int, dtype: torch.dtype) -> None:
    """Raise unless the kernel takes this head_dim and dtype."""
    if dtype not in _DTYPES:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, "
                         f"got {dtype}")
    if head_dim % 8 or not 8 <= head_dim <= _MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernel takes head_dim a multiple "
                         f"of 8 up to {_MAX_HEAD_DIM}, got {head_dim}")


def paged_attention_reference(q, k_pages, v_pages, page_tables, base, limit,
                              *, sm_scale: float):
    """Plain PyTorch version: gather each slot's paged view, then the dense
    masked softmax of the serving path's gather backend."""
    b, t, h, d = q.shape
    hkv, _, page, _ = k_pages.shape
    max_len = page_tables.shape[1] * page
    pt = page_tables.long()
    # [Hkv, B, MP, page, D] -> [B, MP, page, Hkv, D] -> [B, L, Hkv, D]
    k_seq = k_pages[:, pt].permute(1, 2, 3, 0, 4).reshape(b, max_len, hkv, d)
    v_seq = v_pages[:, pt].permute(1, 2, 3, 0, 4).reshape(b, max_len, hkv, d)
    col = torch.arange(max_len, device=q.device)
    pos = base.long()[:, None] + torch.arange(t, device=q.device)[None, :]
    valid = (col[None, None, :] <= pos[:, :, None]) \
        & (col[None, None, :] < limit.long()[:, None, None])     # [B,T,L]
    return dense_attention(q, k_seq, v_seq, h // hkv, sm_scale,
                           valid[:, None])


def _launch(q, k_pages, v_pages, page_tables, base, limit, sm_scale: float):
    b, t, h, d = q.shape
    hkv, num_pages, page_size, d_pool = k_pages.shape
    max_pages = page_tables.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the paged attention kernel runs on a CUDA "
                         f"device, got {dev}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("base", base),
                    ("limit", limit)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    check_shapes(d, q.dtype)
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("q and the K/V pools must share one dtype")
    if v_pages.shape != k_pages.shape or d_pool != d or h % hkv:
        raise ValueError(
            f"shapes q {tuple(q.shape)} / pools {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)} do not match")
    if page_tables.shape[0] != b or base.shape != (b,) \
            or limit.shape != (b,):
        raise ValueError("page_tables must be [B, max_pages], base and "
                         "limit [B]")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the K/V pools must be contiguous")
    q = q.contiguous()
    page_tables = page_tables.to(torch.int32).contiguous()
    base = base.to(torch.int32).contiguous()
    limit = limit.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    n_rows = (h // hkv) * t
    kernel = route(n_rows, d, page_size, max_pages, q.dtype)
    args = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), base.data_ptr(), limit.data_ptr(),
            out.data_ptr(), b, t, h, hkv, d, num_pages, page_size, max_pages]
    if kernel == "paged_decode_hopper":
        args += [decode_rows(n_rows, d, page_size, max_pages, q.dtype),
                 float(sm_scale)]
    elif kernel == "paged_chunk_hopper":
        args += [float(sm_scale)]
    else:
        rows, store = launch_plan(n_rows, d, max_pages * page_size)
        args += [rows, int(store), float(sm_scale),
                 int(q.dtype == torch.bfloat16)]
    fn = _kernel_fn(kernel)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel {kernel} launch failed: "
                           f"CUDA error {err}")
    launches[kernel] += 1
    return out


# each kernel's C entry point, and how many int arguments follow the 7
# pointers and B, T, H, Hkv, D, P, page, max_pages before sm_scale (rows,
# store; rows; or none) and after it (is_bf16; or none); the stream comes
# last
_ENTRY = {"paged_attention_kernel": ("paged_attention_launch", 2, 1),
          "paged_decode_hopper": ("paged_decode_launch", 1, 0),
          "paged_chunk_hopper": ("paged_chunk_launch", 0, 0)}


def _kernel_fn(kernel: str):
    name, before, after = _ENTRY[kernel]
    fn = getattr(_build.load("paged_attention"), name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 7 + [i32] * (8 + before) + [ctypes.c_float]
                       + [i32] * after + [ptr])
        fn.restype = i32
    return fn


def paged_attention(q, k_pages, v_pages, page_tables, base, limit=None, *,
                    sm_scale: float | None = None):
    """Paged attention over the whole query span.

    q: [B, T, H, D] — query position of q[:, t] is ``base + t`` (causal
    within the span, full attention over the paged cache below it).
    k_pages/v_pages: [Hkv, P, page, D] pool. page_tables: [B, max_pages].
    base: [B] int first-query positions. limit: [B] int exclusive key
    bound (None = the whole table span) — chunked prefill passes
    ``true_len`` so padded tail pages stay masked.
    Returns [B, T, H, D] in q.dtype.
    """
    b, t, h, d = q.shape
    max_len = page_tables.shape[1] * k_pages.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if limit is None:
        limit = torch.full((b,), max_len, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_tables,
                                         base, limit, sm_scale=sm_scale)
    return _launch(q, k_pages, v_pages, page_tables, base, limit, sm_scale)


def paged_decode_attention(q, k_pages, v_pages, page_tables, pos, *,
                           sm_scale: float | None = None):
    """Single-token decode attention: q [B, H, D], new token at position
    ``pos[b]`` (attends 0..pos inclusive — its own k/v is already written
    to the pool). Returns [B, H, D]."""
    return paged_attention(q[:, None], k_pages, v_pages, page_tables, pos,
                           sm_scale=sm_scale)[:, 0]


def paged_verify_attention(q, k_pages, v_pages, page_tables, seq_lens, *,
                           sm_scale: float | None = None):
    """Multi-query speculative verify: q [B, T, H, D], T = k+1 draft span
    per slot, q[b, t] at position ``seq_lens[b] + t``. Returns
    [B, T, H, D]."""
    return paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                           sm_scale=sm_scale)


def _scalar(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(x), dtype=torch.int32, device=device)


def paged_chunk_attention(q, k_pages, v_pages, page_table, start, true_len,
                          *, sm_scale: float | None = None):
    """Chunked-prefill attention for ONE slot: q [1, C, H, D] chunk whose
    first token sits at position ``start``; keys are the slot's whole
    paged view (earlier chunks + this one, pre-written) bounded by
    ``true_len``. Returns [1, C, H, D]."""
    return paged_attention(q, k_pages, v_pages, page_table[None],
                           _scalar(start, q.device),
                           _scalar(true_len, q.device), sm_scale=sm_scale)
