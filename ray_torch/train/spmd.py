"""The training step on one device: the counterpart of
``ray_tpu/train/spmd.py``.

``loss_fn(params, batch) -> scalar`` is differentiated by autograd (where
the reference takes ``jax.value_and_grad``), the grads go through the
optimizer chain of ``default_optimizer`` (the port's copy of the optax
math, ``train/optim.py``), and the step returns the reference's metrics:
the loss, the global norm of the UNCLIPPED grads, and the new step count.

The step runs eagerly on the params' device. With ``donate=True`` the
params and the optimizer state are updated in place, where the reference
donates them to its jitted step; the caller's tensors are then the new
state's.

One device only: ``sharded_create_state``, ``state_shardings`` and
``make_mesh`` (sharded init over a mesh, FSDP/TP rules) come with the
port's parallelism library.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ray_torch._device import resolve_device
from ray_torch.models.llama import flatten_params, unflatten_params
from ray_torch.train import optim


@dataclasses.dataclass
class TrainState:
    """Params (nested dict of tensors) + optimizer state + step count."""

    params: dict
    opt_state: Any
    step: int


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      decay_steps: int = 10_000,
                      grad_clip: float = 1.0,
                      name: str = "adamw") -> optim.GradientTransformation:
    """Optimizer + cosine schedule + global-norm clip, as the reference's.

    name="adamw" is the Llama-pretrain recipe; name="adafactor" the
    factored-second-moment memory saver, without weight decay (optax's
    adafactor decay is not learning-rate scaled)."""
    sched = optim.warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(decay_steps, warmup_steps + 1))
    if name == "adafactor":
        return optim.chain(
            optim.clip_by_global_norm(grad_clip),
            optim.adafactor(sched, min_dim_size_to_factor=128),
        )
    if name != "adamw":
        raise ValueError(f"unknown optimizer {name!r} (adamw | adafactor)")
    return optim.chain(
        optim.clip_by_global_norm(grad_clip),
        optim.adamw(sched, b1=0.9, b2=0.95, weight_decay=weight_decay),
    )


def create_state(params: dict,
                 optimizer: optim.GradientTransformation) -> TrainState:
    """A TrainState on the params' device, optimizer state zeroed (the
    reference's ``TrainState.create``)."""
    return TrainState(params=params,
                      opt_state=optimizer.init(flatten_params(params)),
                      step=0)


def _clone(tree):
    """A copy of an optimizer state (the optimizer updates it in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def make_train_step(loss_fn: Callable, optimizer: optim.GradientTransformation,
                    *, donate: bool = True):
    """Build the train step: ``step(state, batch) -> (state, metrics)``
    with metrics ``{"loss", "grad_norm", "step"}`` (loss and grad_norm as
    0-d device tensors: reading them is the caller's sync)."""

    def step(state: TrainState, batch):
        flat = flatten_params(state.params)
        leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
        loss = loss_fn(unflatten_params(leaves), batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        gnorm = optim.global_norm(grads)
        with torch.no_grad():
            opt_state = state.opt_state if donate else _clone(state.opt_state)
            updates, opt_state = optimizer.update(grads, opt_state, flat)
            new_flat = optim.apply_updates(flat, updates, in_place=donate)
        new = TrainState(params=unflatten_params(new_flat),
                         opt_state=opt_state, step=state.step + 1)
        return new, {"loss": loss.detach(), "grad_norm": gnorm,
                     "step": new.step}

    return step


def shard_batch(batch, device: str | torch.device = "cuda"):
    """Put a host batch (arrays, tensors, or a dict of them) on ``device``,
    the state's device — one device, so nothing is split."""
    dev = resolve_device(device)

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dev, non_blocking=True)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)
