"""Which hand-written CUDA kernel each launch of the port takes, planned on
the CPU (nothing is compiled here; ``chip_smoke.py`` holds the kernels to
their plain versions on the card and checks that each launch took the
kernel planned for it).

- Paged attention: bf16 decode and verify launches (at most 16 query rows
  a slot and kv head, D of 64 or 128, the rows' fp32 scores over the table
  span in shared memory) take ``paged_decode_hopper``; bf16 launches of
  more rows (the chunk path) take ``paged_chunk_hopper`` (its plan is
  tested in test_torch_chunk_route.py); fp32 and everything else take
  ``paged_attention_kernel``.
- Flash attention: bf16 takes the Hopper kernels, dq included; fp32 the
  FMA kernels.

The plain version the decode route is held to on the card is held here to
the JAX package's Pallas kernel (interpret mode) at the route's shapes,
with the tolerances of test_paged_kernels.py (1e-5 fp32, 2e-2 bf16).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import paged_attention as jpaged
from ray_torch.ops import attention as tattn
from ray_torch.ops import paged_attention as tpaged

CSRC = pathlib.Path(tpaged.__file__).parent / "csrc"
BF16, FP32 = torch.bfloat16, torch.float32


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src)[1])


@pytest.mark.parametrize("n_rows,head_dim,page,max_pages,dtype,want", [
    (2, 128, 128, 16, BF16, 2),        # llama3-1b decode (n_rep 2)
    (1, 128, 128, 16, BF16, 2),        # one query head a kv head
    (4, 64, 8, 24, BF16, 4),           # n_rep 4, pages smaller than a tile
    (10, 128, 128, 16, BF16, 16),      # verify, k=4
    (16, 128, 128, 16, BF16, 16),
    (17, 128, 128, 16, BF16, None),    # more rows than a decode block
    (1024, 128, 128, 16, BF16, None),  # a 512-token prefill chunk
    (2, 128, 128, 16, FP32, None),     # fp32 stays on the general kernel
    (2, 16, 8, 16, BF16, None),        # llama_tiny's head_dim
    (12, 256, 128, 336, BF16, None),   # head_dim 256
    (2, 128, 128, 512, BF16, None),    # 65,536-token span: scores too big
])
def test_decode_route(n_rows, head_dim, page, max_pages, dtype, want):
    rows = tpaged.decode_rows(n_rows, head_dim, page, max_pages, dtype)
    assert rows == want
    kernel = tpaged.route(n_rows, head_dim, page, max_pages, dtype)
    assert kernel == ("paged_decode_hopper" if want is not None
                      else "paged_chunk_hopper" if dtype == BF16
                      and n_rows > 16 and head_dim in (64, 128)
                      else "paged_attention_kernel")
    if want is not None:
        assert rows >= n_rows and rows in (2, 4, 8, 16)
        assert tpaged._decode_smem_bytes(
            rows, head_dim, page * max_pages, max_pages) \
            <= tpaged._SMEM_LIMIT


def test_decode_shared_memory_carve_up():
    """Ring of 4 bf16 tiles of 64 keys, 4 full/empty barrier pairs, the
    rows' fp32 scores over the span, the warps' partial max and sum, the
    page-table row, and 128 bytes of alignment slack."""
    ring = 4 * 64 * 128 * 2
    assert tpaged._decode_smem_bytes(2, 128, 2048, 16) \
        == 128 + ring + 4 * 16 + 4 * (2 * 2048 + 2 * 8 * 2 + 16)
    # two decode blocks share an SM's 228 KB at the serving shape
    assert 2 * tpaged._decode_smem_bytes(2, 128, 2048, 16) <= 228 * 1024
    # 16 rows of a 2,048-token span fit one block under the 227 KB opt-in
    assert tpaged._decode_smem_bytes(16, 128, 2048, 16) <= tpaged._SMEM_LIMIT
    # the pass-3 partial sums of 8 warps reuse the drained ring
    for rows in (2, 4, 8, 16):
        assert 8 * rows * 128 * 4 <= ring
    # where the scores stop fitting, the general kernel takes the launch
    assert tpaged._decode_smem_bytes(2, 128, 128 * 336, 336) \
        > tpaged._SMEM_LIMIT
    assert tpaged.decode_rows(2, 128, 128, 336, BF16) is None


def test_decode_constants_match_the_cuda_source():
    src = (CSRC / "paged_attention.cu").read_text()
    assert _const(src, "kDecodeKeys") == tpaged._DECODE_KEYS
    assert _const(src, "kDecodeStages") == tpaged._DECODE_STAGES
    assert _const(src, "kDecodeWarps") == tpaged._DECODE_WARPS
    assert _const(src, "kDecodeMaxRows") == tpaged._DECODE_MAX_ROWS
    assert _const(src, "kSmemLimit") == tpaged._SMEM_LIMIT
    entry = src[src.index('extern "C" int paged_decode_launch'):]
    assert tuple(int(d) for d in re.findall(r"case (\d+):", entry)) \
        == tpaged._DECODE_HEAD_DIMS
    rows = src[src.index("cudaError_t launch_decode_rows"):]
    rows = rows[:rows.index("default:")]
    assert [int(r) for r in re.findall(r"case (\d+):", rows)] \
        == [2, 4, 8, 16]
    for kernel in tpaged.launches:
        assert re.search(rf"__global__ void[^;{{]*\b{kernel}\(", src), kernel


@pytest.mark.parametrize("t,dtype", [(1, "bfloat16"), (5, "bfloat16"),
                                     (1, "float32")])
def test_plain_version_at_the_decode_route_shapes_matches_jax(t, dtype):
    """D=64, n_rep 2, pages of 8 keys (a 64-key tile spans 8 pages):
    the shapes the decode route takes, through the port's CPU path and the
    JAX Pallas kernel. On the CPU no kernel is launched."""
    b, hkv, n_rep, d, page, mp = 3, 2, 2, 64, 8, 12
    rs = np.random.RandomState(40 + t)
    q = rs.randn(b, t, hkv * n_rep, d).astype(np.float32)
    k = rs.randn(hkv, b * mp + 1, page, d).astype(np.float32)
    v = rs.randn(hkv, b * mp + 1, page, d).astype(np.float32)
    pt = (rs.permutation(b * mp).reshape(b, mp) + 1).astype(np.int32)
    base = np.asarray([0, 37, mp * page - t], np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert tpaged.route(n_rep * t, d, page, mp, tdt) == (
        "paged_decode_hopper" if dtype == "bfloat16"
        else "paged_attention_kernel")
    before = dict(tpaged.launches)
    got = tpaged.paged_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(pt), torch.from_numpy(base), sm_scale=d ** -0.5)
    assert tpaged.launches == before
    want = jpaged.paged_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pt),
        jnp.asarray(base), sm_scale=d ** -0.5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq"])
def test_flash_kernel_by_dtype(op):
    assert tattn.kernel_name(op, BF16) == f"{op}_hopper"
    assert tattn.kernel_name(op, FP32) == f"{op}_kernel"
    src = (CSRC / "flash_attention.cu").read_text()
    for dtype in (BF16, FP32):
        name = tattn.kernel_name(op, dtype)
        assert re.search(rf"__global__ void[^;{{]*\b{name}\(", src), name
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.kernel_name(op, torch.float16)


def test_flash_bf16_launches_all_take_the_hopper_kernels():
    """``launch`` sends every bf16 op, dq included, to ``launch_hopper``,
    which launches the three Hopper kernels; the FMA kernels are reached
    only from the fp32 branches."""
    src = (CSRC / "flash_attention.cu").read_text()
    body = src[src.index("cudaError_t launch(Which which"):]
    body = body[:body.index("\n}\n")]
    cases = re.split(r"case Which::", body)[1:]
    assert [c.split(":")[0] for c in cases] == ["kFwd", "kDkdv", "kDq"]
    for case in cases:
        bf16, fp32 = case.split("} else {")
        assert "if constexpr (kBf16)" in bf16
        assert "return launch_hopper<D>(which" in bf16
        assert "_kernel<T, D>" in fp32 and "_hopper" not in fp32
    hopper = src[src.index("cudaError_t launch_hopper("):]
    hopper = hopper[:hopper.index("\n}\n")]
    for kernel in ("flash_fwd_hopper", "flash_bwd_dkdv_hopper",
                   "flash_bwd_dq_hopper"):
        assert f"auto kernel = {kernel}<D>;" in hopper
    with pytest.raises(ValueError, match="unknown flash op"):
        tattn.kernel_name("flash_bwd", BF16)


def test_dq_hopper_plan_fits_shared_memory():
    """Q and dO resident (128 rows each) and a 2-stage ring of 64-key K
    and V tiles, in bf16, at every head_dim the kernels take."""
    src = (CSRC / "flash_attention.cu").read_text()
    rows, keys, stages = (_const(src, n) for n in
                          ("kDqRows", "kDqKeys", "kDqStages"))
    assert (rows, keys, stages) == (128, 64, 2)
    for d in tattn._HEAD_DIMS:
        smem = 1024 + 2 * (2 * rows + 2 * stages * keys) * d + 8 * 5
        assert smem <= 232448
