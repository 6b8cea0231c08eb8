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

The training half (remat policies, ``int8_matmul``, chunked cross-entropy,
``loss_fn``) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch


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
             ffn_dim=128, max_seq_len=256, dtype=torch.float32)
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
    return _unflatten(flat)


def _unflatten(flat: dict) -> dict:
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
    return _unflatten({k: _tensor_from_numpy(v).to(device)
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


def run_layers(params: dict, x: torch.Tensor, cos, sin, cfg: LlamaConfig,
               attend) -> torch.Tensor:
    """The stacked layers (a loop where the reference scans) and the final
    norm. ``attend(l, q, k, v)`` is layer ``l``'s attention over the
    rotated q/k [B, T, H(kv), D] and v; it returns [B, T, H, D] — dense
    causal attention here, the paged KV steps in serve/llm/kv_cache.py."""
    layers = params["layers"]
    w = layers["attn"]
    mlp = layers["mlp"]
    for l in range(cfg.n_layers):
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q = apply_rope(_proj_heads(h, w["wq"][l]), cos, sin)
        k = apply_rope(_proj_heads(h, w["wk"][l]), cos, sin)
        v = _proj_heads(h, w["wv"][l])
        attn = attend(l, q, k, v)
        wo = w["wo"][l]
        x = x + attn.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
        h = rms_norm(x, layers["mlp_norm"][l], cfg.norm_eps)
        gate = torch.nn.functional.silu(h @ mlp["w_gate"][l])
        x = x + (gate * (h @ mlp["w_up"][l])) @ mlp["w_down"][l]
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig):
    """tokens [B, T] -> logits [B, T, vocab] (fp32)."""
    x = hidden_states(params, tokens, cfg)
    return (x @ params["lm_head"]).float()


def hidden_states(params: dict, tokens: torch.Tensor, cfg: LlamaConfig):
    """tokens [B, T] -> final-norm hidden states [B, T, D] (no lm_head)."""
    b, t = tokens.shape
    dev = tokens.device
    x = embed(params, tokens, cfg)
    cos, sin = rope_freqs(cfg, torch.arange(t, device=dev).expand(b, t))
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
    n_rep = cfg.n_heads // cfg.n_kv_heads
    return run_layers(
        params, x, cos, sin, cfg,
        lambda l, q, k, v: dense_attention(q, k, v, n_rep,
                                           cfg.head_dim ** -0.5, causal))


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
