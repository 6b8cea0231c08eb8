"""ray_torch.ops.attention against the JAX Pallas flash kernels on the CPU.

The Pallas kernels run in interpret mode (``interpret=True``), the only way
they run off a TPU; the port's wrappers take their plain PyTorch versions
for CPU tensors, which compute what the CUDA kernels compute. The same
numpy inputs go through both. T=256 with 128-row blocks, so that the causal
block skip is exercised.

Tolerances:
- fp32 forward (O, LSE) 1e-5: the same fp32 products summed in another
  order (online softmax over two blocks vs one dense pass) move values by a
  few ULPs (~1e-7);
- fp32 gradients 1e-4 relative to (1 + |ref|): the backward sums T products
  per element and differences of them (dp - delta), so ordering errors grow
  to ~1e-6; a wrong mask, scale or transpose is O(1);
- bf16 2e-2 relative: p and ds are rounded to bf16 (2^-8 relative) at
  points where the running max of the online softmax and the dense max
  differ, so single roundings can land on either side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_torch.ops import attention as tattn

B, T, H, D = 1, 256, 2, 64
BLOCK = 128


def _inputs(seed, t=T):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, t, H, D).astype(np.float32) for _ in range(4)]


def _to_bh(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= tol * (1 + np.abs(want))).all(), float(err.max())


@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_pallas(causal):
    q, k, v, _ = _inputs(0)
    sm = D ** -0.5
    out_bh, lse = jattn._flash_bh(_to_bh(q), _to_bh(k), _to_bh(v),
                                  causal=causal, sm_scale=sm, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
    got_out, got_lse = tattn.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                                       causal, sm)
    want_out = np.asarray(out_bh).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    _close(got_out, want_out, 1e-5)
    _close(got_lse, np.asarray(lse).reshape(B, H, T), 1e-5)
    # the public op agrees with the kernel's own output
    full = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, block_q=BLOCK, block_k=BLOCK)
    _close(full, want_out, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_pallas(causal):
    q, k, v, g = _inputs(1)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_q=BLOCK,
                                block_k=BLOCK)
    out.backward(torch.from_numpy(g))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, 1e-4)


def test_raw_backward_kernels_match_pallas():
    """The dk/dv and dq kernels' plain versions on the same (lse, delta)
    as ``_flash_bwd_bh`` is given, without autograd in between."""
    q, k, v, g = _inputs(2)
    sm = D ** -0.5
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tattn.flash_fwd(tq, tk, tv, True, sm)
    delta = tattn.flash_delta(tg, out)
    want = jattn._flash_bwd_bh(
        _to_bh(q), _to_bh(k), _to_bh(v), _to_bh(g),
        jnp.asarray(lse.numpy().reshape(B * H, T, 1)),
        jnp.asarray(delta.numpy().reshape(B * H, T, 1)),
        causal=True, sm_scale=sm, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    dk, dv = tattn.flash_bwd_dkdv(tq, tk, tv, tg, lse, delta, True, sm)
    dq = tattn.flash_bwd_dq(tq, tk, tv, tg, lse, delta, True, sm)
    for got, ref in zip((dq, dk, dv), want):
        _close(got, np.asarray(ref).reshape(B, H, T, D).transpose(0, 2, 1, 3),
               1e-4)
    assert tattn.launches == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                              "flash_bwd_dq": 0}   # CPU: no kernel launch


def test_bf16_forward_and_gradients_match_pallas():
    q, k, v, g = _inputs(3)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g)), o

    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    (_, want_out), want = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*jb)
    tb = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
          for x in (q, k, v)]
    out = tattn.flash_attention(*tb, causal=True, block_q=BLOCK,
                                block_k=BLOCK)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g)).sum().backward()
    _close(out.detach().float(), np.asarray(want_out.astype(jnp.float32)),
           2e-2)
    for got, ref in zip(tb, want):
        assert got.grad.dtype == torch.bfloat16
        _close(got.grad.float(), np.asarray(ref.astype(jnp.float32)), 2e-2)


def test_plain_versions_agree_with_the_dense_reference():
    """The flash numerics (fp32 scores) and the dense path's (scores
    rounded to q's dtype) coincide in fp32; reference_attention matches
    the JAX reference_attention."""
    q, k, v, _ = _inputs(4, t=40)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = np.asarray(jattn.reference_attention(
        *map(jnp.asarray, (q, k, v)), causal=True))
    _close(tattn.reference_attention(tq, tk, tv, causal=True), want, 1e-5)
    out, _ = tattn.flash_forward_reference(tq, tk, tv, True, D ** -0.5)
    _close(out, want, 1e-5)


def test_sequence_the_blocks_do_not_divide_raises():
    q = torch.zeros(1, 200, 2, 16)
    with pytest.raises(ValueError, match="must divide blocks"):
        tattn.flash_attention(q, q, q, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="must divide blocks"):
        jattn.flash_attention(jnp.zeros((1, 200, 2, 16)),
                              jnp.zeros((1, 200, 2, 16)),
                              jnp.zeros((1, 200, 2, 16)),
                              block_q=128, block_k=128, interpret=True)
    # a block larger than T is cut to T, as in the reference
    assert tattn.flash_attention(q[:, :100], q[:, :100], q[:, :100]).shape \
        == (1, 100, 2, 16)


def test_kernel_input_checks_raise():
    """What the CUDA wrappers refuse, they refuse before any launch."""
    x = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        tattn._check_inputs({"q": x, "k": x, "v": x})
    with pytest.raises(ValueError, match="share one"):
        tattn.flash_attention(x, x[:, :32], x[:, :32])
