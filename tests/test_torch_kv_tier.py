"""The port's KV tier (``ray_torch/serve/llm/kv_tier.py``, the allocator's
spill hook and the engine's spill / restore path) against the reference
on the CPU.

- The allocator's spill hook runs in lockstep with the reference
  allocator's: the same evictions, digests and chain positions.
- The store (no codec) runs the reference's store tests
  (``tests/test_kv_tier.py``) on both packages side by side: roundtrip,
  demotion to disk, disk cap, TTL, oversize refusal.
- The engine, at the reference tests' shape (``_tier_cfg``: llama_tiny,
  pages of 16, at most 2 cached pages, so a drained 5-full-page prompt
  spills its 3-page chain head): spill on evict; a restore writes back the
  spilled pages bit for bit and greedy tokens equal the cold run's and the
  JAX engine's (one JAX engine, built once for the module); every tier
  failure degrades (failed restore = miss, failed put = plain free, chunk
  fault = partial restore); a cancel mid-restore frees its slot and pages;
  int8 restores within the codec's bound; a bf16 pool spills and restores
  its words; the tier left off is inert.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import kv_cache as rkv
from ray_tpu.serve.llm import kv_tier as rtier
from ray_torch.models import llama as tllama
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import kv_cache as tkv
from ray_torch.serve.llm import kv_tier as ttier

PROMPT = "the quick brown fox jumps over the lazy dog"   # 43 byte-tokens
LONG = PROMPT + " " + PROMPT                             # 87 -> 5 full pages
# the reference tests' shape; a long per-chunk budget so that a loaded
# test machine cannot trip the restore watchdog (it guards wedged loads)
COMMON = dict(max_batch_size=4, page_size=16, num_pages=64,
              max_prompt_len=96, max_seq_len=160, max_tokens=8,
              prefix_cache_max_pages=2, kv_tier_enabled=True,
              kv_tier_chunk_timeout_s=30.0)


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# allocator: the spill hook, in lockstep with the reference
# ---------------------------------------------------------------------------


def _allocators(num_pages=16, cache_pages=0):
    out = []
    for mod in (tkv, rkv):
        a = mod.PageAllocator(num_pages=num_pages, cache_pages=cache_pages)
        captured = []
        a.spill_hook = captured.extend
        out.append((a, captured))
    return out


def test_allocator_spill_hook_captures_evicted_chain():
    ps = 4
    toks = list(range(16))                    # 4 full pages
    for a, captured in _allocators():
        pages = a.alloc(4)
        a.insert_prefix(toks, pages, ps)
        a.free(pages)                         # park all 4 (no cap)
        assert captured == []                 # parking is not eviction
        a.alloc(13)  # 11 free + 4 parked: evicts 2, chain head first
        assert [p for p, _, _ in captured] == pages[:2]
        assert [pos for _, _, pos in captured] == [0, 1]
        d0 = tkv._chain_digest(b"", toks[0:4])
        d1 = tkv._chain_digest(d0, toks[4:8])
        assert [d for _, d, _ in captured] == [d0, d1]
        assert a.counters["evicted"] == 2


def test_allocator_spill_hook_fires_on_cache_cap_free():
    for a, captured in _allocators(num_pages=32, cache_pages=2):
        pages = a.alloc(6)
        a.insert_prefix(list(range(24)), pages, 4)
        a.free(pages)                         # cap 2: 4 evicted at free
        assert [p for p, _, _ in captured] == pages[:4]


def test_allocator_raising_spill_hook_degrades_to_plain_free():
    """The eviction has completed when the hook runs: a raising hook loses
    the spill, nothing else — no page leak, no deadlock."""
    a = tkv.PageAllocator(num_pages=16)
    baseline = a.available()

    def boom(spilled):
        raise RuntimeError("injected spill failure")

    a.spill_hook = boom
    pages = a.alloc(4)
    a.insert_prefix(list(range(16)), pages, 4)
    a.free(pages)
    got = a.alloc(13)                         # evicts 2 through the hook
    assert got is not None and len(got) == 13
    assert a.counters["evicted"] == 2
    a.free(got)
    assert a.available() == baseline
    assert a.alloc(13) is not None


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_spills_match_the_reference_under_a_random_workload(seed):
    """Random alloc / insert / match / free traffic, cache cap 3: both
    allocators hand out the same pages and spill the same (page, digest,
    chain position) triples in the same order."""
    rng = random.Random(seed)
    (pa, pcap), (ra, rcap) = _allocators(num_pages=24, cache_pages=3)
    live = []
    for _ in range(300):
        if live and rng.random() < 0.45:
            pages = live.pop(rng.randrange(len(live)))
            pa.free(pages)
            ra.free(pages)
            continue
        prefix = rng.randrange(3)
        toks = [prefix] * 4 * rng.randrange(1, 4) + \
            [rng.randrange(9) for _ in range(rng.randrange(1, 9))]
        m = pa.match_prefix(toks, 4)
        assert m == ra.match_prefix(toks, 4)
        n = rng.randrange(1, 5)
        new = pa.alloc(n)
        assert new == ra.alloc(n)
        if new is None:
            pa.free(m)
            ra.free(m)
            continue
        pages = m + new
        assert pa.insert_prefix(toks, pages, 4) == \
            ra.insert_prefix(toks, pages, 4)
        live.append(pages)
        assert pcap == rcap
    assert pcap == rcap and len(pcap) > 0
    assert pa.cache_stats() == ra.cache_stats()


def test_cache_stats_free_pages_triplet():
    a = tkv.PageAllocator(num_pages=16)
    pages = a.alloc(4)
    a.insert_prefix(list(range(16)), pages, 4)
    a.free(pages)
    st = a.cache_stats()
    assert st["free_pages"] == 11             # 15 usable - 4 parked
    assert st["evictable_pages"] == 4
    assert st["free_pages"] + st["evictable_pages"] == a.available()
    eng = TEngine(_tcfg(None), rng_seed=0)
    assert eng.engine_stats()["free_pages"] == eng.allocator.available()


# ---------------------------------------------------------------------------
# the store (no codec), both packages side by side
# ---------------------------------------------------------------------------


def _blob(n_pages, seed=0):
    """[L, Hkv, n, page, D] k/v pair + hex chain digests + token lengths
    (the reference test's blob)."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, n_pages, 4, 8)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    digest = b"" if seed == 0 else b"seed%d" % seed
    digs = []
    for i in range(n_pages):
        digest = tkv._chain_digest(digest, [seed * 100 + i])
        digs.append(digest.hex())
    return k, v, digs, [(i + 1) * 4 for i in range(n_pages)]


def _stores(tmp_path=None, **kw):
    """(port store, reference store) over the same settings; each gets its
    own disk directory under ``tmp_path``."""
    out = []
    for i, mod in enumerate((ttier, rtier)):
        d = dict(max_bytes=1 << 20, disk_dir=None, disk_max_bytes=0,
                 ttl_s=600.0, page_size=4)
        d.update(kw)
        if tmp_path is not None:
            d["disk_dir"] = str(tmp_path / str(i))
        out.append(mod.KVTierStore(**d))
    return out


def _same_stats(port, ref):
    """The port's stats equal the reference's on every key the port keeps;
    the reference's others (remote fetch, prefetch hints) stay 0 there."""
    skip = {"encode_ms_p50", "decode_ms_p50"}
    a = {k: v for k, v in port.stats().items() if k not in skip}
    b = ref.stats()
    assert a == {k: b[k] for k in a}
    assert all(b[k] == 0 for k in b.keys() - a.keys() - skip)


def test_store_put_fetch_roundtrip_and_partial_start():
    stores = _stores()
    k, v, digs, toks = _blob(3)
    try:
        for s in stores:
            assert s.put(k, v, digs, toks) == 3
            t, gk, gv = s.fetch_chain(digs, start=0)
            assert t == 3
            np.testing.assert_array_equal(gk, k)
            np.testing.assert_array_equal(gv, v)
            t, gk, _gv = s.fetch_chain(digs, start=1)
            assert t == 2
            np.testing.assert_array_equal(gk, k[:, :, 1:])
            assert s.fetch_chain(["ff" * 16] + digs, start=0)[0] == 0
            assert s.counters["local_hits"] == 5
            assert s.stats()["indexed_pages"] == 3
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


def test_store_shm_cap_demotes_to_disk(tmp_path):
    k, v, digs, toks = _blob(3, seed=1)
    k2, v2, digs2, toks2 = _blob(3, seed=2)
    nbytes = k.nbytes + v.nbytes
    stores = _stores(tmp_path, max_bytes=nbytes, disk_max_bytes=10 * nbytes)
    try:
        for i, s in enumerate(stores):
            assert s.put(k, v, digs, toks) == 3
            assert s.put(k2, v2, digs2, toks2) == 3  # blob 1 demotes
            st = s.stats()
            assert st["demoted_blobs"] == 1
            assert st["blobs_disk"] == 1 and st["blobs_shm"] == 1
            assert st["shm_bytes"] == nbytes and st["disk_bytes"] == nbytes
            assert list((tmp_path / str(i)).glob("*.kvt"))
            t, gk, _gv = s.fetch_chain(digs, start=0)
            assert t == 3
            np.testing.assert_array_equal(gk, k)
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


def test_store_disk_cap_drops_lru(tmp_path):
    blobs = [_blob(3, seed=i) for i in (1, 2, 3)]
    nbytes = blobs[0][0].nbytes + blobs[0][1].nbytes
    stores = _stores(tmp_path, max_bytes=nbytes, disk_max_bytes=nbytes)
    try:
        for i, s in enumerate(stores):
            for bk, bv, bd, bt in blobs:
                assert s.put(bk, bv, bd, bt) == 3
            st = s.stats()
            assert st["demoted_blobs"] == 2
            assert st["dropped_blobs"] == 1
            assert st["blobs_disk"] == 1 and st["disk_bytes"] == nbytes
            assert len(list((tmp_path / str(i)).glob("*.kvt"))) == 1
            assert s.fetch_chain(blobs[0][2], start=0)[0] == 0   # gone
            assert s.fetch_chain(blobs[1][2], start=0)[0] == 3   # on disk
            assert s.fetch_chain(blobs[2][2], start=0)[0] == 3   # in shm
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


def test_store_ttl_expiry():
    stores = _stores(ttl_s=0.05)
    k, v, digs, toks = _blob(2)
    try:
        for s in stores:
            assert s.put(k, v, digs, toks) == 2
        time.sleep(0.1)
        for s in stores:
            assert s.fetch_chain(digs, start=0)[0] == 0   # lazy expiry
            st = s.stats()
            assert st["expired_blobs"] == 1
            assert st["shm_bytes"] == 0 and st["indexed_pages"] == 0
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


def test_store_oversized_put_refused():
    stores = _stores(max_bytes=64)
    k, v, digs, toks = _blob(2)
    try:
        for s in stores:
            assert s.put(k, v, digs, toks) == 0
            assert s.stats()["put_blobs"] == 0
            assert s.fetch_chain(digs, start=0)[0] == 0
        _same_stats(*stores)
    finally:
        for s in stores:
            s.close()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jllama.llama_tiny(vocab_size=512))
    return jllama.save_params(params, str(tmp_path_factory.mktemp("ckpt")))


@pytest.fixture(scope="module")
def jax_tier_run(ckpt):
    """The reference engine at the reference tests' shape, tier on: LONG
    cold, then again once its chain head has spilled (a restore)."""
    eng = JEngine(JConfig(model_config=jllama.llama_tiny(vocab_size=512),
                          attention_kernel="gather", checkpoint_path=ckpt,
                          **COMMON), rng_seed=0)
    eng.start()
    try:
        cold = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)
        hot = eng.generate(LONG, temperature=0.0)["tokens"]
        stats = eng.engine_stats()
    finally:
        eng.shutdown()
    return cold, hot, stats


def _tcfg(ckpt, **kw):
    d = dict(COMMON, checkpoint_path=ckpt)
    d.update(kw)
    return TConfig(model_config=d.pop("model_config", None)
                   or tllama.llama_tiny(vocab_size=512), device="cpu", **d)


def _watch_pages(eng):
    """Record the pool content of every page the spill hook captures, at
    capture time, and the pool pages each restore scatter writes."""
    spilled, restored = {}, []
    capture, scatter = eng._spill_capture, eng._scatter_pages

    def spy_capture(evicted):
        for p, _d, pos in evicted:             # the first spill of each
            spilled.setdefault(pos, (eng.kv["k"][:, :, p].clone(),
                                     eng.kv["v"][:, :, p].clone()))
        capture(evicted)

    def spy_scatter(pages, k_np, v_np):
        restored.extend(pages)
        scatter(pages, k_np, v_np)

    eng._spill_capture = spy_capture
    eng.allocator.spill_hook = spy_capture
    eng._scatter_pages = spy_scatter
    return spilled, restored


def test_engine_spill_restore_identical_to_cold_and_jax(ckpt, jax_tier_run):
    jcold, jhot, jstats = jax_tier_run
    eng = TEngine(_tcfg(ckpt), rng_seed=0)
    spilled, restored = _watch_pages(eng)
    eng.start()
    assert restored == [0]                    # the warmup's trash-page write
    restored.clear()
    try:
        cold = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)
        st = eng.engine_stats()
        assert st["tier_bytes_shm"] > 0 and st["restored_pages"] == 0
        assert eng._kv_tier.stats()["put_pages"] == 3
        assert sorted(spilled) == [0, 1, 2]      # the chain head
        hot = eng.generate(LONG, temperature=0.0)["tokens"]
        st = eng.engine_stats()
    finally:
        eng.shutdown()
    assert cold == hot == jcold == jhot
    assert st["restored_pages"] == jstats["restored_pages"] == 3
    assert st["tier_hit_tokens"] == jstats["tier_hit_tokens"] == 48
    # the hot run's own end spills again, flushed on a later loop pass
    assert st["spilled_pages"] >= 3 and jstats["spilled_pages"] >= 3
    assert st["restore_partial"] == 0 and st["restoring"] == 0
    assert eng._kv_tier.counters["local_hits"] == 3
    # the restore wrote the spilled pages back bit for bit (lossless)
    assert len(restored) == 3
    for pos, page in enumerate(restored):
        assert torch.equal(eng.kv["k"][:, :, page], spilled[pos][0])
        assert torch.equal(eng.kv["v"][:, :, page], spilled[pos][1])
    # shutdown ended the store's stream workers and closed it
    st = eng._kv_tier.stats()
    assert st["streams"] == 0 and st["blobs_shm"] == 0
    assert _wait(lambda: not any(t.name == "kv-tier-stream"
                                 for t in threading.enumerate()))


def test_engine_restore_failure_degrades_to_miss(ckpt):
    eng = TEngine(_tcfg(ckpt), rng_seed=0)
    eng.start()
    try:
        want = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)

        def boom(digests, start, **kw):
            raise RuntimeError("injected restore failure")

        eng._kv_tier.open_stream = boom
        assert eng.generate(LONG, temperature=0.0)["tokens"] == want
        assert eng.engine_stats()["restored_pages"] == 0
    finally:
        eng.shutdown()


def test_engine_failed_spill_put_falls_back_to_plain_free(ckpt):
    cfg = _tcfg(ckpt)
    eng = TEngine(cfg, rng_seed=0)

    def boom(*a, **kw):
        raise RuntimeError("injected put failure")

    eng._kv_tier.put = boom
    eng.start()
    try:
        want = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.allocator.counters["evicted"] >= 3)
        assert eng.generate(LONG, temperature=0.0)["tokens"] == want
        assert _wait(lambda: not eng._tier_pending)
        st = eng.engine_stats()
        assert st["spilled_pages"] == 0 and st["tier_bytes_shm"] == 0
        assert st["active_slots"] == 0
        assert st["free_pages"] == cfg.num_pages - 1
    finally:
        eng.shutdown()


def test_engine_chunk_fault_partial_restore_identity(ckpt):
    """A chunk fault mid-restore completes the request through a PARTIAL
    restore: the landed page kept, the tail prefilled, tokens the same."""
    eng = TEngine(_tcfg(ckpt, kv_tier_chunk_pages=1), rng_seed=0)
    eng.start()
    try:
        want = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)

        def fault(ci):
            if ci >= 1:
                raise RuntimeError("injected chunk fault")

        eng._kv_tier._chunk_fault = fault
        assert eng.generate(LONG, temperature=0.0)["tokens"] == want
        st = eng.engine_stats()
        assert st["restore_partial"] == 1
        assert st["restored_pages"] == 1
    finally:
        eng.shutdown()


def _pump(eng, pred, timeout=60.0):
    """One engine loop pass after another, on this thread, until pred()."""
    deadline = time.monotonic() + timeout
    with torch.no_grad():
        while not pred():
            assert time.monotonic() < deadline, "engine made no progress"
            eng._admit()
            eng._restore_steps()
            eng._prefill_chunks()
            eng._step()
            while eng._pending:
                eng._harvest_one()
            eng._kv_tier_flush()
            time.sleep(0.001)


def test_cancel_mid_restore_frees_slot_and_pages(ckpt):
    """Loop driven by hand: a request parked in _restoring is cancelled;
    cancel only flags it, and the next restore pass aborts its stream and
    gives back its slot and pages."""
    eng = TEngine(_tcfg(ckpt, warmup_compile=False), rng_seed=0)
    baseline = eng.allocator.available()
    try:
        rid = eng.submit(LONG, temperature=0.0)
        _pump(eng, lambda: eng._requests[rid].done)
        eng.drain(rid)
        assert eng.engine_stats()["spilled_pages"] == 3
        rid = eng.submit(LONG, temperature=0.0)
        assert eng._admit() == 1
        req = eng._requests[rid]
        assert eng._restoring == [req] and len(eng.free_slots) == 3
        assert req.restore_stream is not None
        stream = req.restore_stream
        eng.cancel(rid)
        assert eng._restoring == [req]        # cancel only flags
        assert eng._restore_steps() == 1
        assert eng._restoring == [] and eng._prefilling == []
        assert len(eng.free_slots) == 4
        assert eng.allocator.available() == baseline
        assert eng.drain(rid)["error"] == "unknown request"
        assert req.restore_stream is None and stream._aborted
        assert _wait(lambda: eng._kv_tier.stats()["streams"] == 0, 10.0)
    finally:
        eng.shutdown()


def test_engine_int8_codec_restores_within_its_bound(ckpt):
    """int8 is not bit-exact: an fp32 pool's restored pages must sit within
    each group's scale / 127 of the spilled ones, and the request must
    complete. Its tokens are not compared."""
    eng = TEngine(_tcfg(ckpt, kv_tier_codec="int8"), rng_seed=0)
    spilled, restored = _watch_pages(eng)
    eng.start()
    assert restored == [0]                    # the warmup's trash-page write
    restored.clear()
    try:
        cold = eng.generate(LONG, temperature=0.0)
        assert cold["error"] is None and len(cold["tokens"]) == 8
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)
        hot = eng.generate(LONG, temperature=0.0)
        assert hot["error"] is None and len(hot["tokens"]) == 8
        assert eng.engine_stats()["restored_pages"] == 3
    finally:
        eng.shutdown()
    for pos, page in enumerate(restored):
        for i, name in enumerate(("k", "v")):
            want = spilled[pos][i]
            # one scale per (layer, kv head): its amax over (page, D)
            bound = want.abs().amax(dim=(2, 3), keepdim=True) / 127.0
            err = (eng.kv[name][:, :, page] - want).abs()
            assert (err <= 0.5 * bound + 1e-6).all()
            assert not torch.equal(eng.kv[name][:, :, page], want)


def test_engine_bf16_pool_spills_and_restores_its_words():
    """A bf16 pool's pages travel as 16-bit words tagged bfloat16: the
    restore writes them back bit for bit and the tokens equal the cold
    run's."""
    mcfg = tllama.llama_tiny(vocab_size=512, dtype=torch.bfloat16)
    eng = TEngine(_tcfg(None, model_config=mcfg), rng_seed=0)
    assert eng._kv_tier.dtype == "bfloat16"
    spilled, restored = _watch_pages(eng)
    eng.start()
    assert restored == [0]                    # the warmup's trash-page write
    restored.clear()
    try:
        cold = eng.generate(LONG, temperature=0.0)["tokens"]
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)
        hot = eng.generate(LONG, temperature=0.0)["tokens"]
        st = eng.engine_stats()
    finally:
        eng.shutdown()
    assert cold == hot and st["restored_pages"] == 3
    assert len(restored) == 3
    for pos, page in enumerate(restored):
        assert torch.equal(eng.kv["k"][:, :, page], spilled[pos][0])
        assert torch.equal(eng.kv["v"][:, :, page], spilled[pos][1])


def test_kv_tier_default_off_is_inert():
    """kv_tier_enabled=False: no hook, no store, counters at zero, and the
    tier gauges still exported as 0 for a stable key set."""
    assert TConfig().kv_tier_enabled is False
    eng = TEngine(_tcfg(None, kv_tier_enabled=False), rng_seed=0)
    assert eng._kv_tier is None and eng.allocator.spill_hook is None
    st = eng.engine_stats()
    for key in ("spilled_pages", "restored_pages", "tier_hit_tokens",
                "restore_partial", "restoring", "tier_bytes_shm",
                "tier_bytes_disk", "tier_codec_ratio"):
        assert st[key] == 0, key
    eng2 = TEngine(_tcfg(None, prefix_cache_enabled=False), rng_seed=0)
    assert eng2._kv_tier is None and not eng2._kv_tier_on
