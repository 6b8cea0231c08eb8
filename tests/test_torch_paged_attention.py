"""ray_torch.ops.paged_attention against ray_tpu.ops.paged_attention on
the CPU.

On the CPU the port's wrappers take the kernel's plain PyTorch version
(the CUDA kernel itself is held to that version on the card by
``chip_smoke.py``). Each case feeds the same numpy-seeded arrays to the
port and to the JAX package twice: to the Pallas kernel (interpret mode,
as tests/test_paged_kernels.py runs it) and to the gather math of the
serving path. Tolerances are those of test_paged_kernels.py: 1e-5 in
fp32, 2e-2 in bf16 — the only permitted difference is the order partial
sums are taken in.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import paged_attention as jpaged
from ray_tpu.serve.llm import kv_cache as jkv
from ray_torch.ops import paged_attention as tpaged
from ray_torch.serve.llm import kv_cache as tkv

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _jax_gather(q, k_pages, v_pages, page_tables, base, limit, sm):
    """The gather path's op sequence (kv_cache._decode_attention /
    paged_verify_step) with the kernel's unified mask."""
    b, t, h, d = q.shape
    hkv = k_pages.shape[0]
    max_len = page_tables.shape[1] * k_pages.shape[2]
    k_seq = jnp.moveaxis(jnp.take(k_pages, page_tables, axis=1),
                         0, 3).reshape(b, max_len, hkv, d)
    v_seq = jnp.moveaxis(jnp.take(v_pages, page_tables, axis=1),
                         0, 3).reshape(b, max_len, hkv, d)
    k_full = jkv._gqa_expand(k_seq, h // hkv)
    v_full = jkv._gqa_expand(v_seq, h // hkv)
    col = jnp.arange(max_len)
    pos = base[:, None] + jnp.arange(t)[None, :]
    valid = (col[None, None, :] <= pos[:, :, None]) \
        & (col[None, None, :] < limit[:, None, None])
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k_full).astype(
        jnp.float32) * sm
    logits = jnp.where(valid[:, None], logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v_full)


class _Case:
    """One numpy-seeded problem, as JAX arrays and torch tensors with
    identical bits (both round fp32 to bf16 to nearest even)."""

    def __init__(self, seed, b, t, dtype, *, hkv=2, n_rep=2, d=16, page=8,
                 mp=4, limit=None):
        rs = np.random.RandomState(seed)
        self.jdt, self.tdt, self.tol = _DTYPES[dtype]
        h = hkv * n_rep
        pool = mp * b + 1
        self.q = rs.randn(b, t, h, d).astype(np.float32)
        self.k = rs.randn(hkv, pool, page, d).astype(np.float32)
        self.v = rs.randn(hkv, pool, page, d).astype(np.float32)
        # ragged: slot i's span ends at a different depth into its pages
        self.base = np.asarray([page * (i % mp) + (i * 3) % page
                                for i in range(b)], np.int32)
        self.pt = (rs.permutation(mp * b).reshape(b, mp) + 1).astype(
            np.int32)
        self.limit = np.full((b,), mp * page, np.int32) if limit is None \
            else np.asarray(limit, np.int32)
        self.sm = d ** -0.5

    def jax(self, name):
        x = getattr(self, name)
        return jnp.asarray(x, self.jdt if x.dtype == np.float32 else None)

    def torch(self, name):
        x = torch.from_numpy(getattr(self, name))
        return x.to(self.tdt) if x.dtype == torch.float32 else x

    def check(self, got, want):
        assert got.dtype == self.tdt
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            rtol=self.tol, atol=self.tol)


@pytest.mark.parametrize("b,t", [(1, 1), (4, 1), (2, 2), (4, 4), (3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax_kernel_and_gather(b, t, dtype):
    """(width, span) sweep of test_paged_kernels.py: decode is t=1,
    verify t=k+1; ragged bases, permuted page tables."""
    c = _Case(b * 131 + t, b, t, dtype)
    np.testing.assert_array_equal(
        c.torch("q").float().numpy(), np.asarray(c.jax("q"), np.float32))
    got = tpaged.paged_attention(c.torch("q"), c.torch("k"), c.torch("v"),
                                 c.torch("pt"), c.torch("base"),
                                 sm_scale=c.sm)
    c.check(got, jpaged.paged_attention(
        c.jax("q"), c.jax("k"), c.jax("v"), c.jax("pt"), c.jax("base"),
        sm_scale=c.sm))
    c.check(got, _jax_gather(c.jax("q"), c.jax("k"), c.jax("v"),
                             c.jax("pt"), c.jax("base"), c.jax("limit"),
                             c.sm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrappers_match_jax_wrappers(dtype):
    """decode (q [B, H, D]), verify (q [B, T, H, D]) and chunk (one slot,
    limit = true_len hides the padded tail) against their JAX twins."""
    c = _Case(7, 3, 1, dtype)
    c.check(tpaged.paged_decode_attention(
        c.torch("q")[:, 0], c.torch("k"), c.torch("v"), c.torch("pt"),
        c.torch("base"), sm_scale=c.sm),
        jpaged.paged_decode_attention(
            c.jax("q")[:, 0], c.jax("k"), c.jax("v"), c.jax("pt"),
            c.jax("base"), sm_scale=c.sm))

    c = _Case(8, 2, 3, dtype)
    c.check(tpaged.paged_verify_attention(
        c.torch("q"), c.torch("k"), c.torch("v"), c.torch("pt"),
        c.torch("base"), sm_scale=c.sm),
        jpaged.paged_verify_attention(
            c.jax("q"), c.jax("k"), c.jax("v"), c.jax("pt"), c.jax("base"),
            sm_scale=c.sm))

    c = _Case(9, 1, 16, dtype)
    start, true_len = 8, 19  # rows 11..15 are bucket padding
    got = tpaged.paged_chunk_attention(
        c.torch("q"), c.torch("k"), c.torch("v"), c.torch("pt")[0], start,
        true_len, sm_scale=c.sm)
    c.check(got, jpaged.paged_chunk_attention(
        c.jax("q"), c.jax("k"), c.jax("v"), c.jax("pt")[0], jnp.int32(start),
        jnp.int32(true_len), sm_scale=c.sm))
    unbounded = tpaged.paged_chunk_attention(
        c.torch("q"), c.torch("k"), c.torch("v"), c.torch("pt")[0], start,
        32, sm_scale=c.sm)
    assert not torch.equal(got, unbounded)


def test_rows_without_a_live_key_match_the_dense_softmax():
    """limit=0 masks every column: the dense softmax is then uniform over
    the table span, and the port reproduces it rather than dividing by
    zero."""
    c = _Case(11, 2, 2, "float32", limit=[0, 5])
    got = tpaged.paged_attention(c.torch("q"), c.torch("k"), c.torch("v"),
                                 c.torch("pt"), c.torch("base"),
                                 c.torch("limit"), sm_scale=c.sm)
    assert torch.isfinite(got).all()
    c.check(got, _jax_gather(c.jax("q"), c.jax("k"), c.jax("v"),
                             c.jax("pt"), c.jax("base"), c.jax("limit"),
                             c.sm))


def test_kernel_backend_on_cpu_raises():
    """A CUDA kernel has no interpreter mode: asking for it on the CPU is
    an error, never a silent switch to the plain version."""
    with pytest.raises(ValueError, match="CUDA device"):
        tkv.resolve_attention_backend("cuda", device="cpu")
    c = _Case(0, 1, 1, "float32")
    with pytest.raises(ValueError, match="CUDA device"):
        tpaged._launch(c.torch("q"), c.torch("k"), c.torch("v"),
                       c.torch("pt"), c.torch("base"), c.torch("limit"),
                       c.sm)
    assert tkv.resolve_attention_backend("auto", device="cpu") == "gather"
    assert tkv.resolve_attention_backend(None, device="cpu") == "gather"
    assert tkv.resolve_attention_backend("gather", device="cpu") == "gather"
    with pytest.raises(ValueError, match="attention_kernel"):
        tkv.resolve_attention_backend("pallas", device="cpu")


def test_kernel_shape_limits():
    for d in (16, 64, 128, 256):
        tpaged.check_shapes(d, torch.bfloat16)
    for d in (12, 264, 0):
        with pytest.raises(ValueError, match="head_dim"):
            tpaged.check_shapes(d, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tpaged.check_shapes(128, torch.float16)


@pytest.mark.parametrize("n_rows,head_dim,max_len,want", [
    (2, 128, 2048, (2, True)),        # llama3-1b decode, B=32 slots
    (10, 128, 2048, (10, True)),      # verify, k=4
    (1024, 128, 2048, (16, True)),    # 512-token chunk
    (4, 16, 128, (4, True)),          # llama_tiny
    (64, 256, 65536, (16, False)),    # span too long to keep scores
])
def test_launch_plan(n_rows, head_dim, max_len, want):
    rows, store = tpaged.launch_plan(n_rows, head_dim, max_len)
    assert (rows, store) == want
    used = tpaged._smem_bytes(rows, head_dim,
                              max_len if store else tpaged._KEY_TILE)
    assert used <= tpaged._SMEM_LIMIT


def test_launch_constants_match_the_cuda_source():
    """The Python launch plan and the kernel's shared-memory carve-up use
    the same constants."""
    src = (pathlib.Path(tpaged.__file__).parent / "csrc"
           / "paged_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src)[1])

    assert const("kKeyTile") == tpaged._KEY_TILE
    assert const("kMaxRows") == tpaged._MAX_ROWS
    assert const("kMaxHeadDim") == tpaged._MAX_HEAD_DIM
    assert const("kSmemLimit") == tpaged._SMEM_LIMIT
