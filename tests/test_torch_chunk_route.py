"""The bf16 chunk route of the port's paged attention (``paged_chunk_hopper``)
planned on the CPU, its plain version held to the JAX package at the route's
shapes, and the port's repairs of ``embed`` and ``int8_matmul``.

Nothing is compiled here: ``chip_smoke.py`` holds the kernel to its plain
version on the card and checks that each launch took the kernel planned
for it. What the CPU can check is the plan (which launch takes which
kernel, and that its block fits), that the plan's constants are the CUDA
source's, and that the plain version the kernel is held to matches the
JAX Pallas kernel (interpret mode) at the route's shapes, with the
tolerances of test_paged_kernels.py (1e-5 fp32, 2e-2 bf16).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.ops import paged_attention as jpaged
from ray_torch.models import llama as tllama
from ray_torch.ops import paged_attention as tpaged

SRC = (pathlib.Path(tpaged.__file__).parent / "csrc"
       / "paged_attention.cu").read_text()
BF16, FP32 = torch.bfloat16, torch.float32


def _const(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", SRC)[1])


@pytest.mark.parametrize("n_rows,head_dim,page,max_pages", [
    (1024, 128, 128, 16),   # llama3-1b: a 512-token chunk, n_rep 2
    (1024, 128, 16, 128),   # pages of 16
    (1024, 128, 32, 64),    # pages of 32
    (1024, 64, 16, 128),    # D=64
    (1024, 64, 128, 16),
    (17, 128, 128, 16),     # one row past the decode route
    (64, 128, 8, 256),      # pages of 8: eight boxes a 64-key tile
])
def test_bf16_chunks_take_the_chunk_route(n_rows, head_dim, page,
                                          max_pages):
    assert tpaged.route(n_rows, head_dim, page, max_pages, BF16) \
        == "paged_chunk_hopper"
    assert tpaged.decode_rows(n_rows, head_dim, page, max_pages, BF16) \
        is None
    plan = tpaged.chunk_plan(n_rows, head_dim, page, max_pages, BF16)
    assert plan == {"threads": 384, "rows": 64,
                    "smem": tpaged._chunk_smem_bytes(head_dim, max_pages)}
    assert plan["smem"] <= tpaged._SMEM_LIMIT


@pytest.mark.parametrize("n_rows,head_dim,page,max_pages,dtype,want", [
    (2, 128, 128, 16, BF16, "paged_decode_hopper"),       # decode
    (10, 128, 128, 16, BF16, "paged_decode_hopper"),      # verify, k=4
    (16, 128, 128, 16, BF16, "paged_decode_hopper"),      # 16 rows
    (1024, 128, 128, 16, FP32, "paged_attention_kernel"),  # fp32 chunk
    (1024, 16, 8, 16, BF16, "paged_attention_kernel"),    # llama_tiny
    (1024, 256, 128, 16, BF16, "paged_attention_kernel"),  # D=256
    (1024, 128, 24, 64, BF16, "paged_attention_kernel"),  # pages of 24
    (1024, 128, 96, 16, BF16, "paged_attention_kernel"),  # pages of 96
    (2, 128, 128, 512, BF16, "paged_attention_kernel"),   # long decode span
])
def test_other_launches_keep_their_kernels(n_rows, head_dim, page,
                                           max_pages, dtype, want):
    assert tpaged.chunk_plan(n_rows, head_dim, page, max_pages, dtype) \
        is None
    assert tpaged.route(n_rows, head_dim, page, max_pages, dtype) == want


def test_chunk_shared_memory_carve_up():
    """Alignment slack, the unit's Q tile, two consumers' rings of four
    64-key bf16 tiles, their partial row max and sum, 17 barriers and the
    page-table row; a 2,048-token table at D=128 fits with room to spare,
    and so does a long table of small pages."""
    assert tpaged._chunk_smem_bytes(128, 16) == (
        1024 + 2 * 64 * 128 + 2 * 4 * 2 * 64 * 128 + 4 * 2 * 2 * 64
        + 8 * 17 + 4 * 16)
    assert tpaged._chunk_smem_bytes(128, 16) <= 150 * 1024
    assert tpaged._chunk_smem_bytes(64, 4096) <= tpaged._SMEM_LIMIT
    # a table too long for shared memory leaves the route
    huge = (tpaged._SMEM_LIMIT - tpaged._chunk_smem_bytes(128, 0)) // 4 + 1
    assert tpaged.chunk_plan(1024, 128, 16, huge, BF16) is None


def test_chunk_constants_match_the_cuda_source():
    assert _const("kChunkConsumers") == tpaged._CHUNK_CONSUMERS
    assert _const("kChunkRows") == tpaged._CHUNK_ROWS
    assert _const("kChunkKeys") == tpaged._CHUNK_KEYS
    assert _const("kChunkStages") == tpaged._CHUNK_STAGES
    assert "constexpr int kChunkThreads = 128 * (1 + kChunkConsumers);" \
        in SRC and tpaged._CHUNK_THREADS == 128 * (1 + _const(
            "kChunkConsumers"))
    entry = SRC[SRC.index('extern "C" int paged_chunk_launch'):]
    entry = entry[:entry.index('extern "C"', 1)]
    assert tuple(int(d) for d in re.findall(r"case (\d+):", entry)) \
        == tpaged._CHUNK_HEAD_DIMS
    assert re.search(r"__global__ void[^;{]*\bpaged_chunk_hopper\(", SRC)
    assert tpaged._ENTRY["paged_chunk_hopper"] == ("paged_chunk_launch", 0, 0)
    # the kChunk constants follow the other launch constants, so the
    # first match of each older name is still the one the plans read
    first_chunk = SRC.index("constexpr int kChunk")
    for name in ("kKeyTile", "kMaxRows", "kSmemLimit", "kDecodeKeys",
                 "kDecodeStages", "kDecodeMaxRows"):
        assert re.search(rf"constexpr \w+ {name} = ", SRC).start() \
            < first_chunk


@pytest.mark.parametrize("c,start,true_len,page,dtype", [
    (64, 0, 64, 8, "bfloat16"),       # a first chunk, pages of 8
    (64, 40, 90, 16, "bfloat16"),     # start > 0, true_len below the span
    (200, 0, 150, 16, "bfloat16"),    # a ragged chunk cut by true_len
    (200, 72, 272, 8, "bfloat16"),
    (64, 40, 90, 16, "float32"),
    (200, 72, 250, 8, "float32"),
])
def test_plain_version_at_the_chunk_route_shapes_matches_jax(
        c, start, true_len, page, dtype):
    """One slot, D=64, n_rep 2: the chunk route's shapes in bf16 (fp32
    takes the general kernel), through the port's CPU path and the JAX
    Pallas kernel. On the CPU no kernel is launched."""
    hkv, n_rep, d = 2, 2, 64
    mp = (start + c + page - 1) // page + 1      # a page past the span
    rs = np.random.RandomState(c + start + page)
    q = rs.randn(1, c, hkv * n_rep, d).astype(np.float32)
    k = rs.randn(hkv, mp + 2, page, d).astype(np.float32)
    v = rs.randn(hkv, mp + 2, page, d).astype(np.float32)
    pt = (rs.permutation(mp + 1)[:mp] + 1).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert tpaged.route(n_rep * c, d, page, mp, tdt) == (
        "paged_chunk_hopper" if dtype == "bfloat16"
        else "paged_attention_kernel")
    before = dict(tpaged.launches)
    got = tpaged.paged_chunk_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(pt), start, true_len, sm_scale=d ** -0.5)
    assert tpaged.launches == before
    want = jpaged.paged_chunk_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(pt),
        jnp.int32(start), jnp.int32(true_len), sm_scale=d ** -0.5)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_embed_wraps_negative_ids_as_jax_does():
    """The reference indexes ``params["embed"][tokens]``: an id below 0
    counts from the end, then ids are clamped to the table."""
    v, dim = 7, 4
    table = np.arange(v * dim, dtype=np.float32).reshape(v, dim)
    ids = np.asarray([[-1, -v, -v - 3, 3, v, v + 5]], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    cfg = tllama.llama_tiny()
    got = tllama.embed({"embed": torch.from_numpy(table)},
                       torch.from_numpy(ids).long(), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, :, 0].tolist() == [24, 0, 0, 12, 24, 24]


@pytest.mark.parametrize("m,rows", [(1, 17), (8, 17), (16, 17), (8, 32)])
def test_int8_row_padding_is_exact(m, rows):
    """Zero rows padded onto an int8 product change none of the rows that
    were there: the padded product equals the unpadded one bit for bit."""
    rs = np.random.RandomState(m + rows)
    a = torch.from_numpy(rs.randint(-127, 128, (m, 64)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (64, 48)).astype(np.int8))
    got = tllama._int_mm_padded(a, b, rows)
    assert got.shape == (m, 48) and got.dtype == torch.int32
    assert torch.equal(got, torch._int_mm(a, b))


def test_int8_rows_the_card_takes():
    """On the CPU every shape runs as it is; on a CUDA device rows are
    padded to the 17 that ``torch._int_mm`` takes at least, and K or N
    that are not multiples of 8 raise a ValueError naming the shape."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tllama._int_mm_rows(8, 2048, 8192, cpu) == 8
    assert tllama._int_mm_rows(3, 20, 12, cpu) == 3
    assert tllama._int_mm_rows(8, 2048, 8192, cuda) == 17
    assert tllama._int_mm_rows(16, 2048, 8192, cuda) == 17
    assert tllama._int_mm_rows(17, 2048, 8192, cuda) == 17
    assert tllama._int_mm_rows(8192, 2048, 8192, cuda) == 8192
    with pytest.raises(ValueError, match=r"x \[32, 2044\] @ w \[2044, 8192\]"):
        tllama._int_mm_rows(32, 2044, 8192, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        tllama._int_mm_rows(32, 2048, 8190, cuda)
