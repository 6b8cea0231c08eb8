"""The port's training path against the JAX package on the CPU.

One weight tree (``init_params(PRNGKey(0), llama_tiny)``, handed over as
numpy) and one token array (numpy seed) go through both packages:
``loss_fn`` and every gradient for the dense and flash attention paths
under each remat policy, the chunked cross-entropy and ``int8_matmul``, the
optimizer math against optax, and three train steps against
``spmd.make_train_step`` on a one-device CPU mesh.

Tolerances, fp32 throughout:
- loss 1e-5 and gradients 1e-5 relative to (1 + |ref|): the two frameworks
  sum the same fp32 products in another order (~1e-7 on a loss of ~6);
- params after three train steps: 1e-6 absolute on all but 1e-3 of the
  elements, and 4 * lr on every one. Adam's update is lr * m_hat /
  (sqrt(v_hat) + eps), about lr * sign(g) on its first real step (lr
  3e-4): where a gradient lies within rounding of 0 the ratio is
  ill-conditioned, and one such element of w_down moves by 4.4e-6; a
  flipped sign would move it by at most 2 * lr a step;
- the optimizer alone against optax 1e-6, on well-conditioned gradients.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.train import spmd as jspmd
from ray_torch.models import llama as tllama
from ray_torch.train import optim as toptim
from ray_torch.train import spmd as tspmd

TOKENS = np.random.RandomState(0).randint(0, 256, (2, 33)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jllama.init_params(jax.random.PRNGKey(0), jllama.llama_tiny())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (1 + np.abs(want))).all(), float(err.max())


def _torch_loss_and_grads(cfg, tokens=TOKENS):
    params = tllama.params_from_numpy(_np_tree(_jax_params()))
    flat = tllama.flatten_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), dict(zip(flat, grads))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("policy", ["none", "full", "dots", "hybrid", "outs"])
def test_loss_and_grads_match_jax(attn_impl, policy):
    kw = dict(attn_impl=attn_impl, remat=policy != "none")
    if policy != "none":
        kw["remat_policy"] = policy
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(
        _jax_params(), {"tokens": jnp.asarray(TOKENS)},
        jllama.llama_tiny(**kw))
    loss, grads = _torch_loss_and_grads(tllama.llama_tiny(**kw))
    assert abs(loss - float(jloss)) <= 1e-5 * (1 + abs(float(jloss)))
    want = tllama.flatten_params(_np_tree(jgrads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name], 1e-5)


def _count_flash_forwards(policy: str) -> int:
    """Calls of the flash forward op in one loss + backward on the CPU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.ray_torch.flash_fwd.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tllama.llama_tiny(attn_impl="flash", remat=policy != "none",
                            remat_policy=policy)
    with Count():
        _torch_loss_and_grads(cfg)
    return Count.n


def test_remat_policies_decide_for_the_flash_op():
    """The flash launches are dispatcher ops, so selective checkpointing
    decides for them as the reference's policies do: "dots", "full" and
    "outs" re-run the forward kernel in the backward (2 per layer),
    "hybrid" keeps its outputs ("attn", "attn_lse": 1 per layer)."""
    layers = tllama.llama_tiny().n_layers
    assert _count_flash_forwards("none") == layers
    for policy in ("full", "dots", "outs"):
        assert _count_flash_forwards(policy) == 2 * layers, policy
    assert _count_flash_forwards("hybrid") == layers


@pytest.mark.parametrize("chunk", [16, 63, 200])
@pytest.mark.parametrize("remat", [True, False])
def test_chunked_cross_entropy_matches_jax(chunk, remat):
    """T - 1 = 63 positions: chunk 16 pads a 1-position tail with
    targets of -1, 63 is one exact chunk, 200 is cut to T."""
    rs = np.random.RandomState(5)
    hidden = rs.randn(2, 63, 64).astype(np.float32)
    lm_head = (rs.randn(64, 256) / 8).astype(np.float32)
    targets = rs.randint(0, 256, (2, 63)).astype(np.int32)

    def jce(h, w):
        return jllama.chunked_cross_entropy(w, h, jnp.asarray(targets),
                                            chunk=chunk, remat=remat)

    jloss, (jdh, jdw) = jax.value_and_grad(jce, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(lm_head))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(lm_head).requires_grad_()
    loss = tllama.chunked_cross_entropy(tw, th, torch.from_numpy(targets),
                                        chunk=chunk, remat=remat)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * (
        1 + abs(float(jloss)))
    _close(th.grad, jdh, 1e-5)
    _close(tw.grad, jdw, 1e-5)


def test_int8_matmul_matches_jax():
    """Forward through int8 with an int32 product; straight-through grads
    from the dequantized residuals. Both quantizations round half to
    even, so the int8 operands are identical."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 24, 64).astype(np.float32)
    w = (rs.randn(64, 128) / 8).astype(np.float32)
    g = rs.randn(2, 24, 128).astype(np.float32)
    jq, js = jllama._quantize_int8(jnp.asarray(x))
    tq, ts = tllama._quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)

    out, vjp = jax.vjp(jllama.int8_matmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tllama.int8_matmul(tx, tw)
    got.backward(torch.from_numpy(g))
    _close(got.detach(), out, 1e-6)
    _close(tx.grad, jdx, 1e-5)
    _close(tw.grad, jdw, 1e-5)
    # and through the model's MLP switch, against the reference's loss
    cfg = dict(mlp_impl="int8")
    jloss = jllama.loss_fn(_jax_params(), {"tokens": jnp.asarray(TOKENS)},
                           jllama.llama_tiny(**cfg))
    loss, _ = _torch_loss_and_grads(tllama.llama_tiny(**cfg))
    assert abs(loss - float(jloss)) <= 1e-5 * (1 + abs(float(jloss)))


def test_ring_attention_waits_for_the_parallelism_slice():
    with pytest.raises(NotImplementedError):
        _torch_loss_and_grads(tllama.llama_tiny(attn_impl="ring"))


# ---------------------------------------------------------------------------
# optimizer math against optax
# ---------------------------------------------------------------------------

def _tree(seed):
    """Leaves of the shapes optax factors (two dims >= 128, in either
    order, stacked or not) and of the ones it does not."""
    rs = np.random.RandomState(seed)
    shapes = {"a": (3, 256, 130), "b": (200, 150), "c": (130, 8, 140),
              "d": (64,), "e": (100, 90)}
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_chain_matches_optax(name):
    params = _tree(0)
    jopt = jspmd.default_optimizer(warmup_steps=2, decay_steps=6, name=name,
                                   grad_clip=50.0)
    topt = tspmd.default_optimizer(warmup_steps=2, decay_steps=6, name=name,
                                   grad_clip=50.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    if name == "adafactor":  # the same leaves factored, the same shapes
        factored, jfactored = tstate[1][0], jstate[1][0]
        assert set(factored["v_row"]) == {"a", "b", "c"}
        for key in ("v_row", "v_col"):
            for leaf, v in factored[key].items():
                assert v.shape == getattr(jfactored, key)[leaf].shape
    for step in range(4):
        grads = _tree(step + 1)
        if step == 3:  # clipped: norm far above grad_clip
            grads = {k: 10 * v for k, v in grads.items()}
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update({k: torch.from_numpy(v.copy())
                                  for k, v in grads.items()}, tstate, tp)
        tp = toptim.apply_updates(tp, tu, in_place=True)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_schedule_and_global_norm_match_optax():
    jsched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    tsched = toptim.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 1000)
    for count in (0, 1, 5, 9, 10, 11, 500, 999, 1000, 2000):
        assert tsched(count) == float(jsched(count)), count
    assert tsched(0) == 0.0   # the first update is a no-op
    tree = _tree(7)
    np.testing.assert_allclose(
        float(toptim.global_norm({k: torch.from_numpy(v)
                                  for k, v in tree.items()})),
        float(optax.global_norm(tree)), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tspmd.default_optimizer(name="sgd")


# ---------------------------------------------------------------------------
# the train step against spmd.make_train_step
# ---------------------------------------------------------------------------

def _jax_steps(name, n):
    cfg = jllama.llama_tiny()
    opt = jspmd.default_optimizer(warmup_steps=1, decay_steps=10, name=name)
    mesh = jspmd.make_mesh(1)
    params = _jax_params()   # concrete before the jitted init traces
    state, sh = jspmd.sharded_create_state(lambda: params, opt, mesh)
    step = jspmd.make_train_step(functools.partial(jllama.loss_fn, cfg=cfg),
                                 opt, mesh, sh, donate=False)
    metrics = []
    for _ in range(n):
        state, m = step(state, {"tokens": jnp.asarray(TOKENS)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return state.params, metrics


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_jax(name):
    jparams, jmetrics = _jax_steps(name, 3)
    opt = tspmd.default_optimizer(warmup_steps=1, decay_steps=10, name=name)
    state = tspmd.create_state(
        tllama.params_from_numpy(_np_tree(_jax_params())), opt)
    step = tspmd.make_train_step(
        functools.partial(tllama.loss_fn, cfg=tllama.llama_tiny()), opt)
    batch = tspmd.shard_batch({"tokens": TOKENS}, "cpu")
    metrics = []
    for _ in range(3):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]), m["step"]))
    # the schedule gives lr 0 at count 0: step 1 sees step 0's params
    assert metrics[1][0] == metrics[0][0]
    assert jmetrics[1][0] == jmetrics[0][0]
    assert metrics[2][0] < metrics[1][0]
    for (loss, gnorm, n), (jloss, jgnorm, jn) in zip(metrics, jmetrics):
        assert n == jn
        assert abs(loss - jloss) <= 1e-5 * (1 + abs(jloss))
        assert abs(gnorm - jgnorm) <= 1e-5 * (1 + abs(jgnorm))
    want = tllama.flatten_params(_np_tree(jparams))
    got = tllama.flatten_params(state.params)
    err = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel()
                          for k in want])
    # every element within the two real updates' reach (2 * 2 * lr), and
    # all but 1e-3 of them to 1e-6 (see the module docstring)
    assert err.max() <= 4 * 3e-4
    assert (err > 1e-6).mean() <= 1e-3, (err > 1e-6).sum()


def test_donate_updates_in_place_and_keep_false_leaves_state():
    params = tllama.params_from_numpy(_np_tree(_jax_params()))
    before = {k: v.clone() for k, v in tllama.flatten_params(params).items()}
    opt = tspmd.default_optimizer(warmup_steps=0, decay_steps=10)
    loss = functools.partial(tllama.loss_fn, cfg=tllama.llama_tiny())
    batch = {"tokens": torch.from_numpy(TOKENS)}

    state = tspmd.create_state(params, opt)
    new, _ = tspmd.make_train_step(loss, opt, donate=False)(state, batch)
    for k, p in tllama.flatten_params(state.params).items():
        assert torch.equal(p, before[k])
    assert not torch.equal(new.params["lm_head"], before["lm_head"])
    assert state.opt_state[1][0]["count"] == 0 and state.step == 0

    new, m = tspmd.make_train_step(loss, opt)(state, batch)
    assert new.params["lm_head"] is state.params["lm_head"]
    assert not torch.equal(state.params["lm_head"], before["lm_head"])
    assert m["step"] == 1 and m["loss"].dim() == 0
