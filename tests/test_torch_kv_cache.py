"""ray_torch.serve.llm.kv_cache against ray_tpu.serve.llm.kv_cache on the
CPU, gather backend.

One sequence of steps — a full prefill, a two-chunk prefill, several
batched decode steps, a verify step — runs through both packages from the
same weights (``params_from_numpy``) and the same numpy-seeded inputs.
Logits agree at 1e-4 (fp32; only summation order differs). The pools
agree position by position: the same (layer, head, page, offset) entries
are written — compared exactly — with values within 1e-5, since each is a
projection both frameworks sum in their own order. The scatter itself, fed
identical k/v, writes bit-identical pools.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import kv_cache as jkv
from ray_torch.models import llama as tllama
from ray_torch.serve.llm import kv_cache as tkv

PAGE = 8
NUM_PAGES = 24
MAX_PAGES = 8


class _Pair:
    """The JAX and port states of one paged-engine timeline."""

    def __init__(self):
        self.jcfg = jllama.llama_tiny(vocab_size=512)
        self.tcfg = tllama.llama_tiny(vocab_size=512)
        self.jp = jllama.init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tp = tllama.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.jkv = jkv.init_paged_cache(self.jcfg, NUM_PAGES, PAGE)
        self.tkv = tkv.init_paged_cache(self.tcfg, NUM_PAGES, PAGE, "cpu")

    def check_pools(self):
        for name in ("k", "v"):
            want = np.asarray(self.jkv[name])
            got = self.tkv[name].numpy()
            np.testing.assert_array_equal(got != 0, want != 0)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _i32(x):
    return np.asarray(x, np.int32)


def test_steps_match_jax_over_a_serving_timeline():
    s = _Pair()
    rs = np.random.RandomState(0)
    tables = _i32([[1, 2, 3, 4, 0, 0, 0, 0], [5, 6, 7, 8, 9, 0, 0, 0]])

    # slot 0: full prefill of 13 tokens in a 16-token bucket
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = rs.randint(0, 512, 13)
    want, s.jkv = jkv.paged_prefill(
        s.jp, s.jkv, jnp.asarray(tables[0]), jnp.asarray(toks),
        jnp.int32(13), s.jcfg, PAGE)
    got = tkv.paged_prefill(s.tp, s.tkv, torch.from_numpy(tables[0]),
                            torch.from_numpy(toks).long(), 13, s.tcfg, PAGE)
    _check(got, want)
    s.check_pools()

    # slot 1: 30-token prompt in two chunks (16, then a padded 16 of 14)
    prompt = rs.randint(0, 512, 30)
    for start in (0, 16):
        chunk = np.zeros((1, 16), np.int32)
        seg = prompt[start:start + 16]
        chunk[0, :len(seg)] = seg
        want, s.jkv = jkv.paged_prefill_chunk(
            s.jp, s.jkv, jnp.asarray(tables[1]), jnp.asarray(chunk),
            jnp.int32(start), jnp.int32(30), s.jcfg, PAGE)
        got = tkv.paged_prefill_chunk(
            s.tp, s.tkv, torch.from_numpy(tables[1]),
            torch.from_numpy(chunk).long(), start, 30, s.tcfg, PAGE)
        _check(got, want)
    s.check_pools()

    # batched decode, a third lane on the trash row
    pt = _i32(np.concatenate([tables, np.zeros((1, MAX_PAGES))]))
    jl, tl = jnp.asarray(_i32([13, 30, 0])), torch.from_numpy(
        _i32([13, 30, 0]))
    for step in range(4):
        tokens = rs.randint(0, 512, 3)
        want, s.jkv, jl = jkv.paged_decode_step(
            s.jp, s.jkv, jnp.asarray(pt), jl, jnp.asarray(_i32(tokens)),
            s.jcfg, PAGE, "gather")
        got, tl = tkv.paged_decode_step(
            s.tp, s.tkv, torch.from_numpy(pt), tl,
            torch.from_numpy(tokens).long(), s.tcfg, PAGE, "gather")
        _check(got[:2], want[:2])
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    s.check_pools()

    # speculative verify over the two live slots, T = 3
    tokens = rs.randint(0, 512, (2, 3))
    want, s.jkv, jl2 = jkv.paged_verify_step(
        s.jp, s.jkv, jnp.asarray(tables), jl[:2],
        jnp.asarray(_i32(tokens)), s.jcfg, PAGE, "gather")
    got, tl2 = tkv.paged_verify_step(
        s.tp, s.tkv, torch.from_numpy(tables), tl[:2],
        torch.from_numpy(tokens).long(), s.tcfg, PAGE, "gather")
    _check(got, want)
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl2))
    s.check_pools()


def test_token_kv_scatter_is_bit_identical():
    rs = np.random.RandomState(1)
    pool = rs.randn(2, 6, PAGE, 16).astype(np.float32)
    k_new = rs.randn(3, 2, 16).astype(np.float32)
    v_new = rs.randn(3, 2, 16).astype(np.float32)
    page_idx, offset = _i32([3, 5, 0]), _i32([7, 0, 2])
    jk, jv = jkv._write_token_kv(jnp.asarray(pool), jnp.asarray(pool),
                                 jnp.asarray(k_new), jnp.asarray(v_new),
                                 jnp.asarray(page_idx), jnp.asarray(offset))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    tkv._write_token_kv(tk, tv, torch.from_numpy(k_new),
                        torch.from_numpy(v_new),
                        torch.from_numpy(page_idx).long(),
                        torch.from_numpy(offset).long())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_past_the_table_span_writes_the_trash_page():
    """A decode block may overshoot a request's last page (harvest
    discards those tokens): positions past the table span land on the
    trash page instead of indexing out of the table."""
    s = _Pair()
    pt = torch.from_numpy(_i32([[1, 2, 3, 4, 5, 6, 7, 8]]))
    lens = torch.from_numpy(_i32([MAX_PAGES * PAGE + 1]))
    logits, _ = tkv.paged_decode_step(
        s.tp, s.tkv, pt, lens, torch.tensor([3]), s.tcfg, PAGE, "gather")
    assert torch.isfinite(logits).all()
    written = (s.tkv["k"] != 0).any(dim=(0, 1, 3, 4))
    assert written.nonzero().flatten().tolist() == [0]


def test_page_raw_nbytes_matches_jax():
    for jcfg, tcfg in ((jllama.llama_tiny(), tllama.llama_tiny()),
                       (jllama.llama3_1b(), tllama.llama3_1b())):
        assert tkv.page_raw_nbytes(tcfg, 128) == jkv.page_raw_nbytes(
            jcfg, 128)
    pool = tkv.init_paged_cache(tllama.llama_tiny(), 5, PAGE, "cpu")
    assert pool["k"].shape == (2, 2, 5, PAGE, 16)


def test_greedy_sampling_picks_the_first_max_like_jax():
    logits = np.asarray([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                         [0.0, -1.0, 5.0, 5.0]], np.float32)
    want = jkv.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                             jnp.zeros((3,)))
    got = tkv.sample_tokens(torch.from_numpy(logits),
                            torch.Generator().manual_seed(0),
                            torch.zeros(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # temperature > 0 samples from the generator; top-k keeps it in the
    # top k
    gen = torch.Generator().manual_seed(1)
    draws = tkv.sample_tokens(torch.from_numpy(logits).repeat(50, 1), gen,
                              torch.ones(150), top_k=2)
    top2 = {0: {1, 2}, 1: {0, 1, 2, 3}, 2: {2, 3}}
    for i, tok in enumerate(draws.tolist()):
        assert tok in top2[i % 3]


# ---------------------------------------------------------------------------
# PageAllocator: mirrors of tests/test_prefix_cache.py's unit tests
# ---------------------------------------------------------------------------


def test_chain_digest_is_byte_identical_to_jax():
    toks = list(range(40))
    d_t = d_j = b""
    for i in range(5):
        d_t = tkv._chain_digest(d_t, toks[i * 8:(i + 1) * 8])
        d_j = jkv._chain_digest(d_j, toks[i * 8:(i + 1) * 8])
        assert d_t == d_j


def test_allocator_match_insert_roundtrip():
    ps = 4
    a = tkv.PageAllocator(num_pages=16)
    toks = list(range(13))  # 3 full pages + 1 tail token
    pages = a.alloc(4)
    assert a.insert_prefix(toks, pages, ps) == 3  # tail page never indexed
    assert a.match_prefix(toks, ps) == pages[:3]
    fork = toks[:4] + [99] * 9
    assert a.match_prefix(fork, ps) == pages[:1]
    assert a.counters["hit_pages"] == 4
    assert a.counters["miss_pages"] == 1


def test_allocator_full_prefix_match_leaves_suffix():
    ps = 4
    a = tkv.PageAllocator(num_pages=16)
    toks = list(range(12))  # exactly 3 pages
    pages = a.alloc(3)
    a.insert_prefix(toks, pages, ps)
    assert a.match_prefix(toks, ps) == pages[:2]


def test_allocator_refcount_lru_and_resurrection():
    ps = 4
    a = tkv.PageAllocator(num_pages=16)
    baseline = a.available()
    toks = list(range(9))
    pages = a.alloc(3)
    a.insert_prefix(toks, pages, ps)
    a.free(pages)
    assert a.available() == baseline
    assert a.cache_stats()["evictable_pages"] == 2
    m1 = a.match_prefix(toks, ps)
    m2 = a.match_prefix(toks, ps)
    assert m1 == m2
    assert a.cache_stats()["shared_pages"] == 2
    assert a.refcount(m1[0]) == 2
    a.free(m1)
    a.free(m2)
    assert a.cache_stats()["shared_pages"] == 0
    assert a.available() == baseline


def test_allocator_eviction_never_touches_live_pages():
    ps = 4
    a = tkv.PageAllocator(num_pages=10)  # pages 1..9
    cached = a.alloc(4)
    a.insert_prefix(list(range(16)), cached, ps)
    a.free(cached)                    # 4 evictable, 5 free
    live = a.alloc(5)
    fresh = a.alloc(3)                # must evict 3 of the cached LRU
    assert fresh is not None
    assert not set(fresh) & set(live)
    assert a.counters["evicted"] == 3
    assert a.alloc(2) is None
    assert a.counters["evicted"] == 3  # failed alloc evicted nothing extra


def test_allocator_cache_cap_bounds_lru():
    ps = 4
    a = tkv.PageAllocator(num_pages=32, cache_pages=2)
    pages = a.alloc(6)
    a.insert_prefix(list(range(24)), pages, ps)
    a.free(pages)
    st = a.cache_stats()
    assert st["evictable_pages"] == 2
    assert st["evicted"] == 4


def test_allocator_double_free_is_safe():
    a = tkv.PageAllocator(num_pages=8)
    pages = a.alloc(3)
    a.free(pages)
    before = a.available()
    a.free(pages)
    assert a.available() == before


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_jax_under_a_random_workload(seed):
    """Same alloc/insert/match/free sequence on both allocators: the same
    pages come back and the counters agree at every step."""
    rs = np.random.RandomState(seed)
    ps = 4
    mine, ref = tkv.PageAllocator(24, cache_pages=6), \
        jkv.PageAllocator(24, cache_pages=6)
    held = []
    prefixes = [list(rs.randint(0, 5, 20)) for _ in range(4)]
    for _ in range(60):
        op = rs.randint(3)
        if op == 0 or not held:
            toks = prefixes[rs.randint(4)][: rs.randint(5, 21)]
            m = mine.match_prefix(toks, ps)
            assert m == ref.match_prefix(toks, ps)
            n = -(-len(toks) // ps) - len(m)
            got, want = mine.alloc(n), ref.alloc(n)
            assert got == want
            if got is None:
                mine.free(m)
                ref.free(m)
                continue
            pages = m + got
            assert mine.insert_prefix(toks, pages, ps) == \
                ref.insert_prefix(toks, pages, ps)
            held.append(pages)
        else:
            pages = held.pop(rs.randint(len(held)))
            mine.free(pages)
            ref.free(pages)
        st_m, st_r = mine.cache_stats(), ref.cache_stats()
        assert st_m == {k: st_r[k] for k in st_m}
        assert mine.available() == ref.available()
