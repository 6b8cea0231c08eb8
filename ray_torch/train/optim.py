"""The port's own copy of the optax math that ``train/spmd.py``'s
``default_optimizer`` uses (the machine with the card has no optax).

Each transformation is an ``(init, update)`` pair, as in optax, so that a
chain reads like the reference's. ``init(params)`` returns a state;
``update(updates, state, params)`` returns ``(updates, state)``. Params,
updates and per-parameter state are flat dicts ``{"layers/attn/wq":
tensor}`` (``models.llama.flatten_params``); step counts are host ints.

Semantics follow optax 0.2.6 (``optax/_src/{alias,factorized,transform,
clipping,schedule}.py``), where ``torch.optim`` differs:

- ``adamw`` adds the weight decay AFTER the Adam scaling,
  ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, to every leaf (norms
  included: no mask);
- ``clip_by_global_norm`` has no epsilon: ``g`` if ``|g| < c``, else
  ``g * c / |g|``;
- ``adafactor`` is ``scale_by_factored_rms`` (decay 0.8, eps 1e-30,
  factoring over the two largest dims when the second is >= 128), then
  ``clip_by_block_rms(1.0)``, the learning rate, ``scale_by_param_block_rms``
  and a sign flip;
- state dtypes are the params' (bf16 params give bf16 moments), and the
  warmup schedule starts at 0, so the first update is zero.

Unlike optax, state tensors and the incoming updates are modified in place
(``mul_``, ``add_``, ``copy_``): the train step owns them, as JAX's donated
buffers, and a step then allocates no second copy of the optimizer state.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _empty_init(params):
    return ()


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """A host scalar rounded to ``dtype`` (optax casts its fp32 step sizes
    and bias corrections to the tensor's dtype before using them)."""
    return float(torch.tensor(float(x), dtype=torch.float32).to(dtype))


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False):
    """``jnp.mean``: summed in fp32, returned in the input dtype."""
    m = x.float().mean() if dim is None else x.float().mean(dim, keepdim)
    return m.to(x.dtype)


# ---------------------------------------------------------------------------
# schedules (computed in float32 on the host, as optax's under jit)
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps``. Returns ``count -> float``."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps=} {warmup_steps=}")

    def linear(count: int):
        if warmup_steps <= 0:
            return f32(init_value)
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
            warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int):
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay ** f32(exponent)
                                  + f32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


# ---------------------------------------------------------------------------
# transformations
# ---------------------------------------------------------------------------

def global_norm(updates: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf: a 0-d tensor, summed in
    the leaves' dtypes in JAX's leaf order (sorted paths)."""
    return torch.sqrt(sum(updates[k].square().sum() for k in sorted(updates)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        for name, t in updates.items():
            updates[name] = torch.where(
                keep, t, (t / g_norm.to(t.dtype)) * max_norm)
        return updates, state

    return GradientTransformation(_empty_init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        for name, g in updates.items():
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            # bias corrections in fp32, then divided in the moment's dtype
            bc1 = _in_dtype(1 - np.float32(b1) ** count, mu.dtype)
            bc2 = _in_dtype(1 - np.float32(b2) ** count, nu.dtype)
            g.copy_((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
        return updates, dict(state, count=count)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        for name, g in updates.items():
            g.add_(params[name], alpha=weight_decay)
        return updates, state

    return GradientTransformation(_empty_init, update)


def scale_by_learning_rate(learning_rate: Callable, *,
                           flip_sign: bool = True) -> GradientTransformation:
    """Multiply by the schedule's ``learning_rate(count)``, negated when
    ``flip_sign``; the rate is rounded to each update's dtype first."""
    sign = -1.0 if flip_sign else 1.0

    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        lr = learning_rate(state["count"])
        for g in updates.values():
            g.mul_(_in_dtype(sign * np.float32(lr), g.dtype))
        return updates, {"count": state["count"] + 1}

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        for g in updates.values():
            g.mul_(step_size)
        return updates, state

    return GradientTransformation(_empty_init, update)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest axes (second largest, largest) when
    the second is at least ``min_dim_size_to_factor``, else None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms(min_dim_size_to_factor: int,
                          decay_rate: float = 0.8,
                          epsilon: float = 1e-30) -> GradientTransformation:
    """Adafactor's scaling by a factored estimate of the gradient rms."""
    def init(params):
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for name, p in params.items():
            dims = _factored_dims(p.shape, min_dim_size_to_factor)
            if dims is None:
                state["v"][name] = torch.zeros_like(p)
                continue
            d1, d0 = dims
            shape = list(p.shape)
            state["v_row"][name] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            state["v_col"][name] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return state

    def update(updates, state, params):
        t = np.float32(state["count"] + 1)
        decay = float(np.float32(1) - t ** np.float32(-decay_rate))
        for name, g in updates.items():
            dims = _factored_dims(g.shape, min_dim_size_to_factor)
            grad_sqr = g * g + epsilon
            if dims is None:
                v = state["v"][name]
                v.copy_(decay * v.float() + (1 - decay) * grad_sqr.float())
                g.mul_(v ** -0.5)
                continue
            d1, d0 = dims
            v_row, v_col = state["v_row"][name], state["v_col"][name]
            v_row.copy_(decay * v_row.float()
                        + (1 - decay) * _mean(grad_sqr, d0).float())
            v_col.copy_(decay * v_col.float()
                        + (1 - decay) * _mean(grad_sqr, d1).float())
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean(v_row, reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            g.mul_(row_factor.unsqueeze(d0)).mul_(col_factor.unsqueeze(d1))
        return updates, dict(state, count=state["count"] + 1)

    return GradientTransformation(init, update)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    def update(updates, state, params=None):
        for g in updates.values():
            g.div_(torch.clamp(torch.sqrt(_mean(g * g)) / threshold,
                               min=1.0))
        return updates, state

    return GradientTransformation(_empty_init, update)


def _safe_rms(p: torch.Tensor, min_rms: float) -> torch.Tensor:
    rms = torch.sqrt(_mean(p * p))
    return torch.where(rms <= min_rms, torch.full_like(rms, min_rms), rms)


def scale_by_param_block_rms(min_scale: float = 1e-3
                             ) -> GradientTransformation:
    def update(updates, state, params):
        for name, g in updates.items():
            g.mul_(_safe_rms(params[name], min_scale))
        return updates, state

    return GradientTransformation(_empty_init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# aliases
# ---------------------------------------------------------------------------

def adamw(learning_rate: Callable, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def adafactor(learning_rate: Callable,
              min_dim_size_to_factor: int = 128) -> GradientTransformation:
    """optax.adafactor with its defaults: no momentum, no weight decay."""
    return chain(
        scale_by_factored_rms(min_dim_size_to_factor),
        clip_by_block_rms(1.0),
        scale_by_learning_rate(learning_rate, flip_sign=False),
        scale_by_param_block_rms(),
        scale(-1))


def apply_updates(params: dict, updates: dict, *, in_place: bool) -> dict:
    """p + u in p's dtype; in place when the caller owns ``params``."""
    if in_place:
        for name, p in params.items():
            p.add_(updates[name].to(p.dtype))
        return params
    return {name: (p + updates[name]).to(p.dtype)
            for name, p in params.items()}
