"""Llama-3-family transformer in PyTorch: the inference half of
``ray_tpu/models/llama.py``.

Parameters are a nested dict of tensors with the reference's paths and
layouts, so one flat-npz checkpoint (``save_params`` / ``load_params``)
feeds both packages:

- ``layers/attn/wq|wk|wv`` are ``[L, dim, H, hd]`` and ``wo`` is
  ``[L, H, hd, dim]`` (contraction dim first);
- ``layers/mlp/w_gate|w_up`` are ``[L, dim, ffn]``, ``w_down`` ``[L, ffn, dim]``;
- ``embed`` is ``[V, dim]`` and ``lm_head`` ``[dim, V]``;
- norms are fp32; every layer tensor carries the stacked leading ``L`` axis
  (the reference scans over it, the port loops over it).

Numerics follow the reference: RMSNorm accumulates in fp32 and casts back,
RoPE rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` (not HF's
``rotate_half``), GQA expands kv-major, and attention masks with -1e30 and
takes an fp32 softmax cast back to the activation dtype.

The training half follows ``ray_tpu/models/llama.py`` too: ``loss_fn``
(chunked next-token cross-entropy), attention through the dense path or the
CUDA flash kernels (``attn_impl``), the four remat policies on
``torch.utils.checkpoint`` per layer (where the reference checkpoints its
scan body), and ``int8_matmul`` for ``mlp_impl="int8"``. Autograd takes the
place of ``jax.value_and_grad``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # attention implementation: "dense" | "flash" ("ring" waits for the
    # parallelism slice)
    attn_impl: str = "dense"
    remat: bool = True
    # checkpoint policy: "full" recomputes everything; "dots" saves matmul
    # outputs; "hybrid" saves the named projections, attention and block
    # outputs; "outs" saves only the block outputs (see _remat)
    remat_policy: str = "full"
    # cross-entropy chunk: sequence positions whose fp32 logits are live at
    # once (T or more = one chunk)
    ce_chunk: int = 256
    # recompute each CE chunk's logits in the backward (False keeps them:
    # one more B*T*V fp32 tensor live, one lm_head matmul fewer)
    ce_remat: bool = True
    # MLP matmuls of the training path: "bf16" (plain) or "int8"
    # (int8_matmul: dynamic per-tensor int8, straight-through backward)
    mlp_impl: str = "bf16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama3_8b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def llama3_1b(**kw) -> LlamaConfig:
    """dim 2048, 16 layers, 16 heads / 8 kv heads, ffn 8192: ~1.5B params."""
    d = dict(dim=2048, n_layers=16, n_heads=16, n_kv_heads=8, ffn_dim=8192,
             vocab_size=128256)
    d.update(kw)
    return LlamaConfig(**d)


def llama_tiny(**kw) -> LlamaConfig:
    """Test config: fp32, two layers, runs on the CPU in milliseconds."""
    d = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=128, max_seq_len=256, dtype=torch.float32, remat=False)
    d.update(kw)
    return LlamaConfig(**d)


def num_params(cfg: LlamaConfig) -> int:
    per_layer = (cfg.dim * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                 + cfg.n_heads * cfg.head_dim * cfg.dim
                 + 3 * cfg.dim * cfg.ffn_dim + 2 * cfg.dim)
    return (cfg.vocab_size * cfg.dim * 2 + cfg.dim
            + cfg.n_layers * per_layer)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """Flat ``path -> shape`` of every parameter (the checkpoint's keys)."""
    hd, L = cfg.head_dim, cfg.n_layers
    return {
        "embed": (cfg.vocab_size, cfg.dim),
        "layers/attn/wq": (L, cfg.dim, cfg.n_heads, hd),
        "layers/attn/wk": (L, cfg.dim, cfg.n_kv_heads, hd),
        "layers/attn/wv": (L, cfg.dim, cfg.n_kv_heads, hd),
        "layers/attn/wo": (L, cfg.n_heads, hd, cfg.dim),
        "layers/mlp/w_gate": (L, cfg.dim, cfg.ffn_dim),
        "layers/mlp/w_up": (L, cfg.dim, cfg.ffn_dim),
        "layers/mlp/w_down": (L, cfg.ffn_dim, cfg.dim),
        "layers/attn_norm": (L, cfg.dim),
        "layers/mlp_norm": (L, cfg.dim),
        "final_norm": (cfg.dim,),
        "lm_head": (cfg.dim, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str = "cpu") -> dict:
    """Random weights: N(0, 1/fan_in) drawn in fp32 from ``generator``,
    cast to ``cfg.dtype``; norms are fp32 ones. The generator must live on
    ``device``. Draws cannot match ``jax.random``: tests share weights
    through ``params_from_numpy`` instead."""
    flat = {}
    for path, shape in param_shapes(cfg).items():
        if path.endswith("norm"):
            flat[path] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        # the reference scales every weight by 1/sqrt(dim), w_down by ffn
        fan_in = cfg.ffn_dim if path.endswith("w_down") else cfg.dim
        w.mul_(1.0 / math.sqrt(fan_in))
        flat[path] = w.to(cfg.dtype)
    return unflatten_params(flat)


def unflatten_params(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` -> nested dict (inverse of flatten_params)."""
    params: dict = {}
    for key, val in flat.items():
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return params


def flatten_params(params, prefix: str = "") -> dict:
    """Nested dict -> ``{"a/b/c": leaf}`` (the npz checkpoint's keys)."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
        return out
    out[prefix.rstrip("/")] = params
    return out


def _tensor_from_numpy(arr) -> torch.Tensor:
    """One checkpoint leaf -> a CPU tensor, bf16 reinterpreted bit-exactly.

    ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes`` bfloat16 array,
    and an npz written from one reloads as raw 2-byte void (``|V2``):
    neither is a dtype torch understands, so both are reinterpreted as
    16-bit integers and viewed as ``torch.bfloat16`` — the same bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree, device: torch.device | str = "cpu") -> dict:
    """Weight bridge: a flat (``"layers/attn/wq"``) or nested dict of numpy
    arrays — e.g. ``np.asarray`` of the JAX param pytree, or an npz — to
    the port's nested dict of tensors on ``device``. A pure dtype/device
    transfer: shapes, layouts and bits are unchanged."""
    flat = flatten_params(tree) if any(
        isinstance(v, dict) for v in tree.values()) else dict(tree)
    return unflatten_params({k: _tensor_from_numpy(v).to(device)
                             for k, v in flat.items()})


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale * w).to(x.dtype)


def rope_freqs(cfg: LlamaConfig, positions: torch.Tensor):
    """positions: [B, T] -> (cos, sin) [B, T, head_dim/2], fp32."""
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32,
                     device=positions.device) / cfg.head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, T, H, D]; rotate interleaved pairs (x[..., ::2], x[..., 1::2])."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _gqa_expand(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, T, Hkv, D] -> [B, T, Hkv*n_rep, D], kv-major (head h reads kv
    head h // n_rep)."""
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def dense_attention(q, k, v, n_rep: int, sm_scale: float, mask):
    """Masked softmax attention over dense k/v. q: [B, Tq, H, D];
    k/v: [B, Tk, Hkv, D]; mask broadcastable to [B, H, Tq, Tk] (True =
    attend). The q.k contraction rounds to q's dtype before the fp32
    scale, as the reference's einsum(...).astype(f32) does."""
    k_full = _gqa_expand(k, n_rep)
    v_full = _gqa_expand(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_full).float() * sm_scale
    p = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_full)


def embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig):
    """Token embeddings in ``cfg.dtype``. Ids past the table read its last
    row, as the reference's clamped JAX gather does — e.g. the byte
    tokenizer's BOS (256) on llama_tiny's 256-row table."""
    table = params["embed"]
    return table[tokens.clamp(0, table.shape[0] - 1)].to(cfg.dtype)


def _proj_heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk") as one matmul over the flattened heads."""
    d_in, heads, hd = w.shape
    return (h @ w.reshape(d_in, heads * hd)).unflatten(-1, (heads, hd))


def _layer_params(params: dict) -> list[dict]:
    """The stacked layer tensors as one dict of [L]-less views per layer.
    ``unbind`` keeps one autograd node per stacked tensor: its backward
    stacks the L per-layer grads once, where indexing each layer would add
    L full-size zero-padded grads."""
    flat = flatten_params(params["layers"])
    cols = {k: v.unbind(0) for k, v in flat.items()}
    return [unflatten_params({k: c[l] for k, c in cols.items()})
            for l in range(len(next(iter(cols.values()))))]


def _untagged(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


@torch.library.custom_op("ray_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """The reference's ``checkpoint_name``: an op the dispatcher sees, so
    that a remat policy can keep its output by ``name``. A custom op may
    not return its input, hence the copy; ``hidden_states`` tags only when
    the policy reads names ("hybrid", "outs")."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


def _quantize_int8(t: torch.Tensor):
    """Dynamic per-tensor symmetric quantization: t -> (int8, fp32 scale).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    s = t.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(t.float() / s), -127, 127)
    return q.to(torch.int8), s


class _Int8Matmul(torch.autograd.Function):
    """x @ w with both operands quantized to int8 per tensor, an int32
    product (``torch._int_mm``), scaled back in fp32. The backward is
    straight-through from the saved int8 residuals, dequantized to the
    gradient's dtype (the reference's ``_int8_matmul_bwd``)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, xs = _quantize_int8(x)
        wq, ws = _quantize_int8(w)
        acc = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq)
        out = (acc.float() * (xs * ws)).to(x.dtype)
        ctx.save_for_backward(xq, xs, wq, ws)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xq, xs, wq, ws = ctx.saved_tensors
        x = (xq.float() * xs).to(g.dtype)
        w = (wq.float() * ws).to(g.dtype)
        dx = g @ w.T
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx.to(g.dtype), dw.to(g.dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] through int8 (see ``_Int8Matmul``)."""
    return _Int8Matmul.apply(x, w)


def _mlp_matmul(h: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig):
    if cfg.mlp_impl == "int8":
        return int8_matmul(h, w)
    return h @ w


def _attention(q, k, v, cfg: LlamaConfig, tag=_untagged):
    """Causal self-attention of the training path: the CUDA flash kernels
    or the dense path. q: [B, T, H, D]; k/v: [B, T, Hkv, D]."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if cfg.attn_impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' comes with the port's parallelism library")
    if cfg.attn_impl == "flash":
        # the flash op's outputs are the reference's "attn" and "attn_lse"
        return flash_attention(q, _gqa_expand(k, n_rep),
                               _gqa_expand(v, n_rep), causal=True)
    t = q.shape[1]
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
    return tag(dense_attention(q, k, v, n_rep, cfg.head_dim ** -0.5, causal),
               "attn")


def _layer_fwd(x, layer: dict, cos, sin, cfg: LlamaConfig, attend,
               tag=_untagged, mlp_matmul=torch.matmul):
    """One transformer block. ``attend(q, k, v)`` takes the rotated q/k
    [B, T, H(kv), D] and v and returns [B, T, H, D]; ``tag`` names the
    tensors a remat policy may keep (the reference's checkpoint_name)."""
    attn_w = layer["attn"]
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = tag(_proj_heads(h, attn_w["wq"]), "q_proj")
    k = tag(_proj_heads(h, attn_w["wk"]), "k_proj")
    v = tag(_proj_heads(h, attn_w["wv"]), "v_proj")
    attn = attend(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    wo = attn_w["wo"]
    x = x + tag(attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1]), "attn_out")
    h = tag(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), "mlp_in")
    mlp = layer["mlp"]
    gate = torch.nn.functional.silu(mlp_matmul(h, mlp["w_gate"]))
    up = mlp_matmul(h, mlp["w_up"])
    return x + tag(mlp_matmul(gate * up, mlp["w_down"]), "mlp_out")


def run_layers(params: dict, x: torch.Tensor, cos, sin, cfg: LlamaConfig,
               attend) -> torch.Tensor:
    """The stacked layers of the serving path (a loop where the reference
    scans) and the final norm. ``attend(l, q, k, v)`` is layer ``l``'s
    attention over the rotated q/k [B, T, H(kv), D] and v; it returns
    [B, T, H, D] — the paged KV steps in serve/llm/kv_cache.py."""
    for l, layer in enumerate(_layer_params(params)):
        x = _layer_fwd(x, layer, cos, sin, cfg,
                       functools.partial(attend, l))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# what each remat policy keeps ("full" keeps nothing); the rest of the
# layer is recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten._int_mm.default)
_NAMED_POLICIES = {
    "hybrid": ("q_proj", "k_proj", "v_proj", "attn", "attn_lse", "attn_out",
               "mlp_in", "mlp_out"),
    "outs": ("attn_out", "mlp_out"),
}


def _op_names(func, args) -> tuple[str, ...]:
    if func is torch.ops.ray_torch.checkpoint_name.default:
        return (args[1],)
    if func is torch.ops.ray_torch.flash_fwd.default:
        return ("attn", "attn_lse")
    return ()


def _remat(body, cfg: LlamaConfig):
    """Wrap a layer in ``torch.utils.checkpoint`` per cfg.remat_policy.
    The policy decides op by op in the dispatcher (selective activation
    checkpointing), as JAX's checkpoint policies decide per primitive.

    "full": recompute everything.
    "dots": keep every matmul output without batch dims (aten.mm, the
        reference's dots_with_no_batch_dims_saveable): the projections and
        the d_ff-wide MLP products; attention (batched einsums, or the
        flash kernel) is recomputed.
    "hybrid": keep the named q/k/v projections, attention and its softmax
        stats (the flash op's outputs), attn_out, mlp_in and mlp_out; the
        backward recomputes the two wide MLP products.
    "outs": keep only the block outputs attn_out and mlp_out."""
    if cfg.remat_policy == "dots":
        def keep(func, args):
            return func in _DOTS
    elif cfg.remat_policy in _NAMED_POLICIES:
        names = _NAMED_POLICIES[cfg.remat_policy]

        def keep(func, args):
            return any(n in names for n in _op_names(func, args))
    else:
        return functools.partial(checkpoint, body, use_reentrant=False)

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if keep(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(
        checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy))


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig):
    """tokens [B, T] -> logits [B, T, vocab] (fp32)."""
    x = hidden_states(params, tokens, cfg)
    return (x @ params["lm_head"]).float()


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LlamaConfig):
    """tokens [B, T] -> final-norm hidden states [B, T, D] (no lm_head).
    With ``cfg.remat`` and autograd on, each layer is checkpointed."""
    b, t = tokens.shape
    x = embed(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, torch.arange(t, device=tokens.device)
                          .expand(b, t))
    remat = cfg.remat and torch.is_grad_enabled()
    tag = (checkpoint_name if remat and cfg.remat_policy in _NAMED_POLICIES
           else _untagged)
    body = functools.partial(
        _layer_fwd, cos=cos, sin=sin, cfg=cfg,
        attend=functools.partial(_attention, cfg=cfg, tag=tag), tag=tag,
        mlp_matmul=functools.partial(_mlp_matmul, cfg=cfg))
    if remat:
        body = _remat(body, cfg)
    for layer in _layer_params(params):
        x = body(x, layer)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _ce_chunk(lm_head, h, y):
    """Sum of next-token log-likelihoods of one chunk; targets of -1
    (the padded tail) contribute 0."""
    logits = (h @ lm_head).float()                        # [B, chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, y.clamp(min=0).long()[..., None])[..., 0] - lse
    return torch.where(y >= 0, ll, torch.zeros_like(ll)).sum()


def chunked_cross_entropy(lm_head, hidden, targets, chunk: int = 256,
                          remat: bool = True):
    """Next-token CE without materializing fp32 [B, T, vocab] at once:
    sequence chunks of ``chunk`` positions, the tail padded with targets
    of -1 (T - 1 is never divisible by a power-of-two chunk), the sum
    divided by B * T. ``remat`` checkpoints each chunk, recomputing its
    lm_head matmul in the backward instead of keeping its fp32 logits."""
    b, t, _ = hidden.shape
    chunk = min(chunk, t)
    n = -(-t // chunk)
    pad = n * chunk - t
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        h = hidden[:, i * chunk:(i + 1) * chunk]
        y = targets[:, i * chunk:(i + 1) * chunk]
        if remat:
            total = total + checkpoint(_ce_chunk, lm_head, h, y,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(lm_head, h, y)
    return -total / (b * t)


def loss_fn(params: dict, batch, cfg: LlamaConfig):
    """Next-token cross-entropy; batch: {"tokens": [B, T+1]} or tokens."""
    tokens = batch["tokens"] if isinstance(batch, dict) else batch
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    hidden = hidden_states(params, inputs, cfg)
    return chunked_cross_entropy(params["lm_head"], hidden, targets,
                                 chunk=cfg.ce_chunk, remat=cfg.ce_remat)


# ---------------------------------------------------------------------------
# checkpoint io (the reference's flat-npz format)
# ---------------------------------------------------------------------------

def _numpy_leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # numpy has no bf16: store the raw bits as 2-byte void, the form
        # an npz of a JAX bf16 array takes (and _tensor_from_numpy reads)
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_params(params: dict, path: str) -> str:
    """Write params as ONE .npz of flattened paths (atomic rename).
    ``path`` may be a file ('x.npz') or a directory (-> dir/params.npz)."""
    if not path.endswith(".npz"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "params.npz")
    tmp = path + ".tmp.npz"  # keep the suffix: np.savez appends it otherwise
    try:
        np.savez(tmp, **{k: _numpy_leaf(v)
                         for k, v in flatten_params(params).items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_params(path: str, cfg: LlamaConfig | None = None,
                device: torch.device | str = "cpu") -> dict:
    """Load a ``save_params`` checkpoint (either package's) onto
    ``device``. With a cfg, keys and shapes are validated against it."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.npz")
    with np.load(path) as flat:
        arrays = {k: flat[k] for k in flat.files}
    if cfg is not None:
        want = param_shapes(cfg)
        got = {k: tuple(a.shape) for k, a in arrays.items()}
        if want != got:
            missing = set(want) - set(got)
            extra = set(got) - set(want)
            mismatched = {k for k in set(want) & set(got)
                          if want[k] != got[k]}
            raise ValueError(
                f"checkpoint does not match config: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]} shape-mismatch={sorted(mismatched)[:5]}")
    return params_from_numpy(arrays, device)
