"""Speculative decoding in ray_torch against ray_tpu on the CPU.

The proposer and ``accept_length`` are held to the JAX package's
``spec_decode`` on seeded random sequences and on the reference's own
cases. End to end, one JAX gather engine with spec on, one port engine with
spec on and one with spec off share a llama_tiny fp32 checkpoint; the
port's greedy tokens must equal both. The rest mirrors the reference's
contract (``tests/test_spec_decode.py``,
``tests/test_prefix_cache.py::test_spec_rollback_never_evicts_or_decrefs_shared_prefix_pages``)
on the port: repetitive text emits more than one token a verify round,
non-greedy slots never draft, ``max_tokens`` is exact, a rejection is pure
length bookkeeping, the verify signature is warmed before traffic, and
shutdown with verify rounds in flight returns.
"""

import threading

import numpy as np
import pytest

import jax

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import spec_decode as jspec
from ray_torch.models import llama as tllama
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import spec_decode as tspec

REPETITIVE = "abc abc abc abc abc"  # byte tokens; suffix n-grams recur
BATCH = ["abc abc abc abc", "the cat sat on the mat the cat sat", "xyzzy",
         "repeat repeat repeat repeat", "one two one two"]
LONG = "the quick brown fox jumps over the lazy dog " * 2  # 11 full pages


# ---------------------------------------------------------------------------
# proposer and accept_length (host-side)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_proposer_and_accept_length_match_reference(seed):
    """The same context grown call by call (as a generating slot grows it)
    through both proposers: every draft and the index watermark agree; so
    does accept_length on drafts against perturbed verify outputs."""
    rng = np.random.default_rng(seed)
    ngram_max, draft_len = int(rng.integers(1, 5)), int(rng.integers(1, 7))
    mine = tspec.NGramProposer(ngram_max, draft_len)
    ref = jspec.NGramProposer(ngram_max, draft_len)
    ctx: list[int] = []
    drafted = 0
    while len(ctx) < 300:
        ctx += [int(t) for t in rng.integers(0, 6, int(rng.integers(1, 5)))]
        draft = mine.propose(list(ctx))
        assert draft == ref.propose(list(ctx))
        assert mine._indexed == ref._indexed
        drafted += bool(draft)
        verified = list(draft) + [int(rng.integers(0, 6))]
        if verified and rng.random() < 0.5:
            verified[int(rng.integers(0, len(verified)))] = 99
        assert tspec.accept_length(draft, verified) == \
            jspec.accept_length(draft, verified)
    assert drafted > 0


# the reference's proposer cases (tests/test_spec_decode.py), as
# (ngram_max, draft_len, [(context, expected draft), ...] in call order)
PROPOSER_CASES = {
    "continuation_of_repeated_ngram": (3, 4, [([1, 2, 1], [2, 1])]),
    "no_recurrence_no_draft": (3, 4, [([1, 2, 3, 4, 5], []), ([], []),
                                      ([7], [])]),
    "prefers_longest_ngram_match": (
        3, 4, [([1, 2, 3, 4, 9, 8, 4, 2, 3, 4], [9, 8, 4, 2])]),
    "draft_len_caps_output": (2, 2, [([5, 6, 7, 8, 5, 6], [7, 8])]),
    "incremental_index_across_calls": (2, 3, [([4, 5, 6], []),
                                              ([4, 5, 6, 4, 5], [6, 4, 5])]),
}


@pytest.mark.parametrize("case", list(PROPOSER_CASES))
def test_proposer_reference_cases(case):
    ngram_max, draft_len, calls = PROPOSER_CASES[case]
    mine = tspec.NGramProposer(ngram_max, draft_len)
    ref = jspec.NGramProposer(ngram_max, draft_len)
    for ctx, want in calls:
        assert mine.propose(list(ctx)) == ref.propose(list(ctx)) == want
    assert mine._indexed == ref._indexed


# ---------------------------------------------------------------------------
# engines: the port with spec on against JAX with spec on and itself off
# ---------------------------------------------------------------------------

def _configs(ckpt, **kw):
    common = dict(max_batch_size=4, page_size=8, num_pages=256,
                  max_prompt_len=128, max_seq_len=192, max_tokens=24,
                  prefill_chunk=16, checkpoint_path=ckpt)
    common.update(kw)
    jcfg = JConfig(model_config=jllama.llama_tiny(vocab_size=512),
                   attention_kernel="gather", warmup_compile=False, **common)
    tcfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                   device="cpu", **common)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jllama.llama_tiny(vocab_size=512))
    return jllama.save_params(params, str(tmp_path_factory.mktemp("ckpt")))


def _started(*engs):
    for eng in engs:
        eng.start()
    return engs


@pytest.fixture(scope="module")
def jax_engine(ckpt):
    """The JAX gather engine with spec on (apart from the port engines: a
    test worker that needs no JAX engine builds none)."""
    jeng, = _started(JEngine(_configs(ckpt, spec_decode_enabled=True)[0],
                             rng_seed=0))
    yield jeng
    jeng.shutdown()


@pytest.fixture(scope="module")
def engines(ckpt):
    """The port's engines over the same checkpoint: spec on, spec off."""
    engs = _started(
        TEngine(_configs(ckpt, spec_decode_enabled=True)[1], rng_seed=0),
        TEngine(_configs(ckpt)[1], rng_seed=0))
    yield engs
    for eng in engs:
        eng.shutdown()


def _serve(eng, prompts, max_tokens=24, temperature=0.0):
    rids = [eng.submit(p, max_tokens=max_tokens, temperature=temperature)
            for p in prompts]
    outs = [eng.result(r, timeout=120.0) for r in rids]
    assert all(o["error"] is None for o in outs)
    return [o["tokens"] for o in outs]


def _delta(eng, before, *keys):
    now = eng.engine_stats()
    return [now[k] - before[k] for k in keys]


def test_spec_greedy_tokens_identical_to_jax_and_to_spec_off(jax_engine,
                                                            engines):
    """A repetitive prompt alone, then a concurrent batch wider than the
    slots (drafting and non-drafting slots in one loop iteration). The port
    on the CPU runs each dispatch to its end, so its verify rounds are
    deterministic; how many rounds the JAX engine runs depends on how far
    its asynchronous dispatch gets ahead of the harvest, so only its
    tokens are compared."""
    jeng, (teng, toff) = jax_engine, engines
    for prompts in ([REPETITIVE], BATCH):
        before = teng.engine_stats()
        want = _serve(jeng, prompts)
        got = _serve(teng, prompts)
        assert got == want
        assert got == _serve(toff, prompts)
        assert _delta(teng, before, "spec_rounds")[0] > 0
    stats = teng.engine_stats()
    assert stats["attn_verify_dispatches"] == stats["spec_rounds"] > 0
    assert stats["active_slots"] == 0 and stats["pending_pipeline_depth"] == 0
    # padding lanes never leave state in the permanent trash row
    assert int(teng._sl_dev[-1]) == 0
    assert not teng._pt_dev[-1].any()


def test_spec_accepts_more_than_one_token_per_round_on_repetitive(engines):
    teng, _ = engines
    before = teng.engine_stats()
    _serve(teng, [REPETITIVE])
    rounds, accepted = _delta(teng, before, "spec_rounds",
                              "spec_accepted_tokens")
    assert rounds > 0 and accepted > 0
    assert accepted / rounds + 1.0 > 1.0


def test_spec_never_drafts_non_greedy_slots(engines):
    teng, _ = engines
    before = teng.engine_stats()
    _serve(teng, [REPETITIVE, "abc abc abc"], max_tokens=16,
           temperature=0.8)
    assert _delta(teng, before, "spec_rounds", "spec_drafted_tokens") \
        == [0, 0]


def test_spec_respects_max_tokens_exactly(engines):
    """The draft is capped at remaining - 1, so a fully accepted round
    lands exactly on the cap."""
    teng, toff = engines
    got = _serve(teng, [REPETITIVE], max_tokens=17)[0]
    assert len(got) == 17
    assert got == _serve(toff, [REPETITIVE], max_tokens=17)[0]


def test_spec_stats_keys_follow_the_reference(jax_engine, engines):
    jeng, (teng, toff) = jax_engine, engines
    mine, ref = teng.engine_stats(), jeng.engine_stats()
    assert set(mine) - set(ref) == {"attn_backend_cuda"}
    for key in ("spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_accept_rate", "attn_verify_dispatches"):
        assert key in mine and key in ref
    d = mine["spec_drafted_tokens"]
    assert mine["spec_accept_rate"] == (
        round(mine["spec_accepted_tokens"] / d, 4) if d else 0.0)
    off = toff.engine_stats()
    assert not toff._spec_on and "spec_accept_rate" not in off
    assert off["spec_rounds"] == off["attn_verify_dispatches"] == 0


def test_spec_rollback_never_evicts_or_decrefs_shared_prefix_pages(engines):
    """Mirror of the reference's test: a prefix hit shares indexed pages
    while verify rounds run (and reject) on the same slot; every shared
    page stays indexed at refcount 0, nothing is evicted, and the pool
    comes back to its baseline."""
    teng, toff = engines
    want = _serve(toff, [LONG], max_tokens=24)
    alloc = teng.allocator
    assert _serve(teng, [LONG], max_tokens=24) == want  # warm: index pages
    shared = list(alloc._page_key)
    assert len(shared) >= 2
    assert all(alloc.refcount(p) == 0 for p in shared)
    baseline, evicted = alloc.available(), alloc.counters["evicted"]
    before = teng.engine_stats()
    assert _serve(teng, [LONG], max_tokens=24) == want  # hot: prefix hit
    hits, rounds, drafted, accepted = _delta(
        teng, before, "prefix_hits", "spec_rounds", "spec_drafted_tokens",
        "spec_accepted_tokens")
    assert hits >= 1 and rounds > 0
    assert drafted > accepted  # rejections happened
    for p in shared:
        assert p in alloc._page_key
        assert alloc.refcount(p) == 0
    assert alloc.counters["evicted"] == evicted
    assert alloc.available() == baseline


def test_verify_signature_warmed_before_traffic(engines):
    """Warmup registers one verify signature per bucket width; traffic
    first-uses no decode or verify signature."""
    teng, _ = engines
    k = teng.cfg.spec_draft_len
    widths = {teng._bucket_width(n)
              for n in range(1, teng.cfg.max_batch_size + 1)}
    assert {s for s in teng._prof._seen if s[0] == "verify"} == \
        {("verify", w, k) for w in widths}
    count = teng._prof.compile_count(("decode", "verify"))
    before = teng.engine_stats()
    _serve(teng, BATCH[:3])
    assert _delta(teng, before, "spec_rounds")[0] > 0
    assert teng._prof.compile_count(("decode", "verify")) == count


def test_shutdown_with_verify_rounds_in_flight_returns():
    """Loop driven by hand: a verify round is in flight when shutdown
    drains; the drain records it, chains nothing and returns."""
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", max_batch_size=2, page_size=8, num_pages=32,
                  max_prompt_len=64, max_seq_len=128, max_tokens=24,
                  spec_decode_enabled=True, warmup_compile=False)
    eng = TEngine(cfg, rng_seed=0)
    rid = eng.submit(REPETITIVE, temperature=0.0)
    assert eng._admit() == 1
    assert eng._step()  # drains the first token, dispatches a verify round
    assert [m for _f, _s, m in eng._pending] == [("spec", 4)]
    req = eng._requests[rid]
    assert req.spec_inflight and eng.slot_req[req.slot] is req
    done = threading.Thread(target=eng.shutdown)
    done.start()
    done.join(timeout=30.0)
    assert not done.is_alive()
    assert eng._pending == []
    stats = eng.engine_stats()
    assert stats["spec_rounds"] == stats["attn_verify_dispatches"] == 1
    assert not req.spec_inflight and 1 < len(req.generated) < 24


def test_cancel_between_verify_rounds_frees_slot_and_pages():
    """A slot whose verify round was harvested without chaining has nothing
    in flight (dispatched == len(generated)); a cancel then caps max_tokens
    at len(generated). The slot must still get the one more token that
    finishes it, as a decode-mode cancel does, or it would hold its slot
    and pages for ever."""
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", max_batch_size=2, page_size=8, num_pages=32,
                  max_prompt_len=64, max_seq_len=128, max_tokens=24,
                  spec_decode_enabled=True, warmup_compile=False)
    eng = TEngine(cfg, rng_seed=0)
    baseline = eng.allocator.available()
    rid = eng.submit(REPETITIVE, temperature=0.0)
    assert eng._admit() == 1
    assert eng._step()  # a verify round in flight
    req = eng._requests[rid]
    eng._propose_locked = lambda r: []  # the harvest chains nothing
    eng._harvest_one()
    assert eng._pending == [] and not req.done
    assert req.dispatched == len(req.generated) < 24
    eng.cancel(rid)
    for _ in range(3):
        eng._step()
        while eng._pending:
            eng._harvest_one()
    assert req.done and eng.slot_req[req.slot] is not req
    assert len(eng.free_slots) == 2
    assert eng.allocator.available() == baseline
    assert rid not in eng._requests
