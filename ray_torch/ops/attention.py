"""Flash attention for the training path: the wrappers of the three
hand-written CUDA kernels (``csrc/flash_attention.cu``) and their plain
PyTorch versions.

Counterpart of ``ray_tpu/ops/attention.py``: the same function on the same
``[B, T, H, D]`` layout (heads already GQA-expanded), the same saved
residuals ``(q, k, v, out, lse)`` and the same backward (FA2: p recomputed
from the forward's log-sum-exp, ``delta = rowsum(dO * O)`` in fp32 outside
the kernels, then a dk/dv kernel and a dq kernel).

Numerics are the Pallas kernels', not the dense path's: q.k is taken in
fp32 from the input dtype (no rounding of the scores), p is rounded to the
value dtype before p.V, ds to the input dtype before ds.K and ds^T.Q, and
every product accumulates in fp32 with one cast of each output at the end.
The plain versions compute exactly that, densely over T x T.

Each kernel is a ``torch.library.custom_op`` so that the dispatcher sees
it: selective activation checkpointing (``models/llama.py::_remat``) then
decides per op, as the reference's remat policies do — "dots" and "full"
re-run the forward kernel in the backward, "hybrid" keeps its outputs
(the reference's names "attn" and "attn_lse").

Dispatch is by the tensor's device, never by a fallback: a CPU tensor takes
the plain version; a CUDA tensor launches the kernel (each launch adds one
to its counter in ``launches``) or raises — on a failed build, a shape or
dtype the kernel does not take, or a refused launch.
"""

from __future__ import annotations

import ctypes

import torch

from ray_torch.ops import _build

# kernel launches of this process, per kernel (reset by whoever reads them)
launches = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)   # csrc/flash_attention.cu instantiates these
_DTYPES = (torch.float32, torch.bfloat16)


def _check_blocks(t_q: int, t_k: int, block_q: int, block_k: int) -> None:
    """The reference's tiling contract (``_flash_bh``): T divides into its
    blocks, a block larger than T being cut to T. The CUDA kernels tile by
    their own 64 rows and mask the ragged tail; the contract is kept so
    that a sequence the reference refuses is refused here too."""
    block_q = min(block_q, t_q)
    block_k = min(block_k, t_k)
    if t_q % block_q or t_k % block_k:
        raise ValueError(f"seq lens ({t_q},{t_k}) must divide blocks "
                         f"({block_q},{block_k})")


# ---------------------------------------------------------------------------
# plain versions (what the kernels compute, densely)
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, sm_scale: float):
    """fp32 scores [B, H, Tq, Tk] from exact products of the input dtype,
    masked to -1e30 above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_forward_reference(q, k, v, causal: bool, sm_scale: float):
    """Plain version of the forward kernel: (out [B, T, H, D] in q.dtype,
    lse [B, H, T] fp32). p = exp(s - rowmax) is rounded to v's dtype before
    p.V, and the fp32 sum is divided by l = sum(p) (l > 0 guarded)."""
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse.contiguous()


def flash_backward_reference(q, k, v, dout, lse, delta, causal: bool,
                             sm_scale: float):
    """Plain version of the two backward kernels: (dq, dk, dv) in the input
    dtypes from q, k, v, dO [B, T, H, D], lse and delta [B, H, T] fp32.
    p = exp(s - lse); dv = p^T.dO with p rounded to dO's dtype;
    ds = p * (dO.V^T - delta) * scale rounded to q's dtype; dk = ds^T.q,
    dq = ds.k."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None):
    """The dense path's attention (the reference's fused-einsum fallback):
    q.k rounded to q's dtype before the fp32 scale, p to q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

_ARGTYPES = {
    # q, k, v, out, lse
    "flash_fwd_launch": 5,
    # q, k, v, dout, lse, delta, dk, dv
    "flash_bwd_dkdv_launch": 8,
    # q, k, v, dout, lse, delta, dq
    "flash_bwd_dq_launch": 7,
}


def _kernel_fn(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # pointers; B, T, H, D, causal; sm_scale; is_bf16; stream
        fn.argtypes = ([ptr] * _ARGTYPES[name] + [i32] * 5
                       + [ctypes.c_float, i32, ptr])
        fn.restype = i32
    return fn


def _check_inputs(tensors: dict, stats: dict | None = None) -> None:
    """Raise unless the kernels take these [B, T, H, D] tensors (and
    [B, H, T] fp32 stats): one CUDA device, one dtype, one shape."""
    q = tensors["q"]
    dev, shape = q.device, q.shape
    if dev.type != "cuda":
        raise ValueError(f"the flash attention kernels run on a CUDA device, "
                         f"got {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, "
                         f"got {q.dtype}")
    if q.dim() != 4 or shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take [B, T, H, D] with D "
                         f"in {_HEAD_DIMS}, got {tuple(shape)}")
    if shape[0] * shape[2] > 65535:
        raise ValueError(f"B * H = {shape[0] * shape[2]} exceeds 65535")
    for name, x in tensors.items():
        if x.device != dev or x.dtype != q.dtype or x.shape != shape:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}; q is {q.dtype} {tuple(shape)} on "
                             f"{dev}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    want = (shape[0], shape[2], shape[1])
    for name, x in (stats or {}).items():
        if x.device != dev or x.dtype != torch.float32 or x.shape != want \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {want} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)}")


def _launch(name: str, ptrs, q, causal: bool, sm_scale: float) -> None:
    b, t, h, d = q.shape
    fn = _kernel_fn(name + "_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[x.data_ptr() for x in ptrs], b, t, h, d, int(causal),
                 float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


@torch.library.custom_op("ray_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (out [B, T, H, D], lse [B, H, T] fp32)."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, sm_scale)
    _check_inputs({"q": q, "k": k, "v": v})
    b, t, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, out, lse), q, causal, sm_scale)
    return out, lse


@flash_fwd.register_fake
def _(q, k, v, causal, sm_scale):
    b, t, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, t), dtype=torch.float32)


@torch.library.custom_op("ray_torch::flash_bwd_dkdv", mutates_args=())
def flash_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool, sm_scale: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel: one block per key tile over the query tiles from
    the diagonal on."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, dout, lse, delta, causal,
                                        sm_scale)[1:]
    _check_inputs({"q": q, "k": k, "v": v, "dout": dout},
                  {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkdv", (q, k, v, dout, lse, delta, dk, dv), q, causal,
            sm_scale)
    return dk, dv


@flash_bwd_dkdv.register_fake
def _(q, k, v, dout, lse, delta, causal, sm_scale):
    return torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("ray_torch::flash_bwd_dq", mutates_args=())
def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool, sm_scale: float) -> torch.Tensor:
    """The dq kernel: one block per query tile over the key tiles up to
    the diagonal."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, dout, lse, delta, causal,
                                        sm_scale)[0]
    _check_inputs({"q": q, "k": k, "v": v, "dout": dout},
                  {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, dout, lse, delta, dq), q, causal,
            sm_scale)
    return dq


@flash_bwd_dq.register_fake
def _(q, k, v, dout, lse, delta, causal, sm_scale):
    return torch.empty_like(q)


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def flash_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, T, H, D] -> [B, H, T]."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward kernel; backward = delta, then the dk/dv and dq kernels.
    Saves (q, k, v, out, lse), as the reference's ``_flash_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        out, lse = torch.ops.ray_torch.flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(dout, out)
        dk, dv = torch.ops.ray_torch.flash_bwd_dkdv(
            q, k, v, dout, lse, delta, ctx.causal, ctx.sm_scale)
        dq = torch.ops.ray_torch.flash_bwd_dq(
            q, k, v, dout, lse, delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, block_q: int = 256,
                    block_k: int = 256):
    """q, k, v: [B, T, H, D] (the same H: expand GQA before calling).
    Differentiable: the forward kernel, and a backward through the two
    backward kernels (nothing [T, T]-shaped is ever made on the card)."""
    if not q.shape == k.shape == v.shape:
        raise ValueError(f"q, k, v must share one [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, float(sm_scale))
