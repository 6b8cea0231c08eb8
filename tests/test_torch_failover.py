"""Mid-stream failover continuations, the engine's journal events and its
``llm.generate`` span in the PyTorch port (``LLMEngine.submit(
resume_tokens=...)``, ``request_progress``, ``spill_inflight``,
``LLMServer``'s resume plans) against the reference on the CPU.

ONE JAX gather engine (module fixture; prefix cache and KV tier on, the
config of ``tests/test_failover.py``, ``warmup_compile=False``) and a
port engine of the same config and weights (``params_from_numpy``) run
the same script, their loops driven by hand on this thread so that no
count depends on timing:

1. PROMPT x 8 greedy tokens (``want``), submitted inside a client span;
2. continuations of PROMPT at k = 1, 4, 7;
3. LONG x 8, then its continuation at k = 5 (a local prefix hit);
4. LONG x 16 held at three points (mid chunked prefill, after its first
   token, after one decode block), ``spill_inflight`` at each;
5. a continuation whose deadline has passed at submit.

The tests compare the two runs item by item: tokens, failover counters,
``request_progress``, spill counts, ``failover_resume`` events and the
span. The port alone: cold continuations on a cache-off engine, the
``failover_enabled=False`` raise, a continuation restored from an eager
spill (whole and partial, under the tier's chunk fault) and the server's
stream in both resume plans.
"""

import asyncio
import contextlib
import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.core import deadline as jdeadline
from ray_tpu.models import llama as jllama
from ray_tpu.observability import events as jevents
from ray_tpu.observability import tracing as jtracing
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm.llm_server import _resume_plan as j_resume_plan
from ray_torch.core import deadline as tdeadline
from ray_torch.models import llama as tllama
from ray_torch.observability import events as tevents
from ray_torch.observability import tracing as ttracing
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import LLMServer
from ray_torch.serve.llm.llm_server import _resume_plan as t_resume_plan

PROMPT = "the quick brown fox jumps over the lazy dog"   # 43 byte-tokens
LONG = PROMPT + " " + PROMPT                             # 87 -> 5 full pages
PS = 16
SHAPE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_prompt_len=96,
             max_seq_len=160, max_tokens=8)
CARRIER = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
KS = (1, 4, 7)


def _pump(eng, pred, limit=500):
    """Engine loop passes on this thread until ``pred()`` (both packages'
    engines have the same loop steps)."""
    for _ in range(limit):
        if pred():
            return
        eng._admit()
        if eng._kv_tier_on:
            eng._restore_steps()
        eng._prefill_chunks()
        eng._step()
        while eng._pending:
            eng._harvest_one()
        if eng._kv_tier_on:
            eng._kv_tier_flush()
        time.sleep(0.001)
    raise AssertionError("the engine made no progress")


def _serve(eng, prompt, **kw):
    """Submit greedily, pump to done; (tokens, progress before result())."""
    rid = eng.submit(prompt, temperature=0.0, **kw)
    _pump(eng, lambda: eng._requests[rid].done)
    prog = eng.request_progress(rid)
    out = eng.result(rid, timeout=30.0)
    assert out["error"] is None, out
    return out["tokens"], prog


@contextlib.contextmanager
def _journal(events, tracing):
    """Capture ``events`` through a local sink and ``tracing``'s finished
    spans; put back what was installed before."""
    evs, spans = [], []
    sink, flusher = events._local_sink, tracing._flusher
    events.set_local_sink(evs.append)
    tracing.register_flusher(spans.extend)
    try:
        yield evs, spans
    finally:
        tracing.flush()
        tracing.register_flusher(flusher)
        events._local_sink = sink


def _script(eng, events, tracing, deadline):
    """The module's script (see the module docstring) on one engine."""
    out = {}
    with _journal(events, tracing) as (evs, spans):
        with tracing.span_from(CARRIER, "client") as client:
            rid = eng.submit(PROMPT, max_tokens=8, temperature=0.0,
                             request_id="want")
        _pump(eng, lambda: eng._requests[rid].done)
        out["want"] = eng.result(rid, timeout=30.0)["tokens"]
        out["client"] = dict(client)
        want = out["want"]
        for k in KS:
            out[k] = _serve(eng, PROMPT, resume_tokens=want[:k],
                            max_tokens=8 - k, request_id=f"cont-{k}")[0]
        out["long"] = _serve(eng, LONG, max_tokens=8)[0]
        before = dict(eng.stats)
        out["long5"], out["progress"] = _serve(
            eng, LONG, resume_tokens=out["long"][:5], max_tokens=3,
            request_id="cont-long")
        out["delta"] = {k: eng.stats[k] - before[k] for k in (
            "failover_resumed", "failover_restored_tokens", "prefix_hits")}
        # LONG x 16 held at three points, an eager spill at each
        rid = eng.submit(LONG, max_tokens=16, temperature=0.0,
                         request_id="live")
        spills = []
        eng._admit()                           # mid chunked prefill
        spills.append((eng.request_progress(rid), eng.spill_inflight()))
        eng._prefill_chunks()
        while eng._pending:
            eng._harvest_one()                 # its first token
        spills.append((eng.request_progress(rid), eng.spill_inflight()))
        _pump(eng, lambda: len(eng._requests[rid].generated) > 1)
        spills.append((eng.request_progress(rid), eng.spill_inflight()))
        _pump(eng, lambda: eng._requests[rid].done)
        out["live"] = eng.result(rid, timeout=30.0)["tokens"]
        out["spills"] = spills
        with deadline.scope(time.time() - 0.5):
            rid = eng.submit(PROMPT, resume_tokens=[5, 6, 7], max_tokens=4,
                             temperature=0.0, request_id="late")
        eng._admit()
        late = eng.result(rid, timeout=5.0)
        out["late"] = (late["error"], late["tokens"])
        out["stats"] = {k: eng.stats[k] for k in (
            "failover_resumed", "failover_restored_tokens", "shed_expired",
            "spilled_pages")}
    out["events"] = [{k: v for k, v in e.items() if k != "ts"}
                     for e in evs if e["kind"] != "mid_traffic_compile"]
    out["spans"] = spans
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            jllama.llama_tiny(vocab_size=512))
    tp = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def jax_run(weights):
    eng = JEngine(JConfig(model_config=jllama.llama_tiny(vocab_size=512),
                          attention_kernel="gather", warmup_compile=False,
                          kv_tier_enabled=True, **SHAPE),
                  params=weights[0], rng_seed=0)
    try:
        return _script(eng, jevents, jtracing, jdeadline)
    finally:
        eng.shutdown()


def _tengine(tp, **kw):
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", warmup_compile=False, **dict(SHAPE, **kw))
    return TEngine(cfg, params=tp, rng_seed=0)


@pytest.fixture(scope="module")
def port_run(weights):
    eng = _tengine(weights[1], kv_tier_enabled=True)
    try:
        with torch.no_grad():
            return _script(eng, tevents, ttracing, tdeadline)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def cold_engine(weights):
    eng = _tengine(weights[1], prefix_cache_enabled=False)
    yield eng
    eng.shutdown()


# ---------------------------------------------------------------------------
# the server's plan


@pytest.mark.parametrize("enabled", [True, False])
def test_resume_plan_table_equals_the_reference(enabled):
    tcfg = TConfig(failover_enabled=enabled)
    jcfg = JConfig(failover_enabled=enabled)
    cap = tcfg.failover_max_resumes
    assert cap == jcfg.failover_max_resumes == 2
    table = [([], 0), (None, 0), ([1, 2, 3], None), ([1, 2, 3], 0),
             ([1, 2, 3], 1), ([1, 2, 3], cap), ([1, 2, 3], cap + 1),
             ([7], cap + 5), ((4, 5), "1")]
    got = [t_resume_plan(toks, n, tcfg) for toks, n in table]
    assert got == [j_resume_plan(toks, n, jcfg) for toks, n in table]
    if enabled:
        assert got[:7] == [(False, 0), (False, 0), (True, 0), (True, 0),
                           (True, 0), (True, 0), (False, 3)]
    else:
        assert got[2:] == [(False, 3)] * 5 + [(False, 1), (False, 2)]


# ---------------------------------------------------------------------------
# the engine against the reference


@pytest.mark.parametrize("k", KS)
def test_cold_continuation_matches_the_jax_engine(jax_run, cold_engine, k):
    """A cache-off port engine chunk-prefills prompt + resume from scratch
    and resumes at the exact next token: the JAX engine's tokens, which
    are its uninterrupted run's tail."""
    want = jax_run["want"]
    assert jax_run[k] == want[k:]
    before = dict(cold_engine.stats)
    with torch.no_grad():
        got, prog = _serve(cold_engine, PROMPT, resume_tokens=want[:k],
                           max_tokens=8 - k)
    assert got == want[k:]
    assert prog["resume_len"] == k and prog["cached_tokens"] == 0
    assert cold_engine.stats["failover_resumed"] - \
        before["failover_resumed"] == 1
    assert cold_engine.stats["failover_restored_tokens"] == 0


def test_continuation_tokens_and_counters_match_the_reference(jax_run,
                                                              port_run):
    for key in ("want", *KS, "long", "long5", "live", "late"):
        assert port_run[key] == jax_run[key], key
    assert port_run["want"] == jax_run["want"] and len(port_run["want"]) == 8
    assert port_run["live"][:8] == port_run["long"]
    assert port_run["long5"] == port_run["long"][5:]
    # LONG's 5 full pages were resident from its first leg
    assert port_run["delta"] == jax_run["delta"] == {
        "failover_resumed": 1, "failover_restored_tokens": 5 * PS,
        "prefix_hits": 1}
    assert port_run["stats"] == jax_run["stats"]
    assert port_run["stats"]["failover_resumed"] == 5
    assert port_run["late"] == ("deadline exceeded", [])


def test_request_progress_matches_the_reference(jax_run, port_run):
    got, want = dict(port_run["progress"]), dict(jax_run["progress"])
    assert got.pop("restore_ms") == want.pop("restore_ms") == 0.0
    assert got == want == {
        "prompt_tokens": len(LONG) + 1 + 5, "generated": port_run["long5"],
        "resume_len": 5, "cached_tokens": 5 * PS, "restored_tokens": 0,
        "restore_bytes": 0, "admitted": True}


def test_spill_inflight_counts_match_the_reference(jax_run, port_run):
    assert port_run["spills"] == jax_run["spills"]
    (p0, n0), (p1, n1), (p2, n2) = port_run["spills"]
    # mid chunked prefill: the prefix hit's frontier; then the prompt's
    # full pages; then also the pages the first decode block filled
    assert (p0["generated"], p0["cached_tokens"], n0) == ([], 5 * PS, 5)
    assert (len(p1["generated"]), n1) == (1, 5)
    covered = p2["prompt_tokens"] + len(p2["generated"]) - 1
    assert n2 == covered // PS == 6
    assert port_run["stats"]["spilled_pages"] == 16


def test_failover_resume_events_match_the_reference(jax_run, port_run):
    assert port_run["events"] == jax_run["events"]
    assert port_run["events"] == [
        {"kind": "failover_resume", "severity": "WARNING",
         "request_id": rid, "attrs": {"resume_len": n, "model": "llama-tiny"}}
        for rid, n in (("cont-1", 1), ("cont-4", 4), ("cont-7", 7),
                       ("cont-long", 5), ("late", 3))]


def test_llm_generate_span_matches_the_reference(jax_run, port_run):
    def spans(run):
        return [s for s in run["spans"] if s["name"] == "llm.generate"]

    (got,), (want,) = spans(port_run), spans(jax_run)
    for s, run in ((got, port_run), (want, jax_run)):
        assert (s["trace_id"], s["parent_id"]) == \
            (CARRIER["trace_id"], run["client"]["span_id"])
        assert s["end"] >= s["start"] >= run["client"]["start"]
    keys = ("name", "kind", "status", "attrs")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys} == {
        "name": "llm.generate", "kind": "llm", "status": "ok",
        "attrs": {"request_id": "want", "prompt_tokens": len(PROMPT) + 1,
                  "generated_tokens": 8}}
    # one span per traced request: the untraced ones recorded none
    assert [s["name"] for s in port_run["spans"]] == ["client",
                                                      "llm.generate"]


def test_continuation_rejected_when_failover_disabled(weights):
    eng = _tengine(weights[1], failover_enabled=False)
    try:
        with pytest.raises(ValueError, match="failover_enabled"):
            eng.submit(PROMPT, resume_tokens=[1, 2, 3])
        assert eng.stats["requests"] == 0 and not eng._waiting
        eng.submit(PROMPT, resume_tokens=[])   # empty: an ordinary request
        assert eng.stats["failover_resumed"] == 0
    finally:
        eng.shutdown()


def test_continuation_is_capped_to_leave_generation_room(weights):
    eng = _tengine(weights[1])
    try:
        toks = list(range(1, 121))             # past max_prompt_len (96)
        rid = eng.submit(toks, resume_tokens=list(range(200, 300)))
        req = eng._requests[rid]
        # the prompt is capped first, then the continuation leaves one
        # position of room under max_seq_len (160)
        assert req.prompt_tokens == toks[:96] + list(range(200, 263))
        assert (req.resume_len, req.max_tokens) == (63, 1)
        assert eng.request_progress(rid)["resume_len"] == 63
        assert eng.request_progress("no-such-request") is None
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the port alone: a continuation restored from an eager spill


@pytest.mark.parametrize("partial", [False, True], ids=["whole", "partial"])
def test_eager_spill_lets_a_continuation_restore_past_the_prompt(
        weights, jax_run, partial):
    """LONG held after one decode block: spill_inflight puts its 6 full
    pages in the tier, the 6th past the prompt. Cancelled, then evicted
    by two other prompts (at most 2 cached pages), its continuation at k
    = 9 restores those 6 pages (under the chunk fault, only the first:
    a partial restore, journaled) and resumes at LONG's 10th token."""
    eng = _tengine(weights[1], kv_tier_enabled=True, prefix_cache_max_pages=2,
                   kv_tier_chunk_timeout_s=30.0,
                   kv_tier_chunk_pages=1 if partial else 8)
    live = jax_run["live"]
    try:
        with torch.no_grad(), _journal(tevents, ttracing) as (evs, _):
            rid = eng.submit(LONG, max_tokens=16, temperature=0.0)
            _pump(eng, lambda: len(eng._requests[rid].generated) > 1)
            gen = list(eng._requests[rid].generated)
            assert gen == live[:len(gen)] and len(gen) == 9
            assert eng.spill_inflight() == 6
            eng.cancel(rid)
            _pump(eng, lambda: rid not in eng._requests)
            for other in ("pack my box with five dozen liquor jugs " * 2,
                          "sphinx of black quartz, judge my vow " * 2):
                _serve(eng, other, max_tokens=2)
            assert not eng.allocator.match_prefix(
                eng.tokenizer.encode(LONG), PS)
            if partial:
                def fault(ci):
                    if ci >= 1:
                        raise RuntimeError("injected chunk fault")

                eng._kv_tier._chunk_fault = fault
            rid = eng.submit(LONG, resume_tokens=gen, max_tokens=16 - 9,
                             temperature=0.0)
            req = eng._requests[rid]
            _pump(eng, lambda: req.done)
            prog = eng.request_progress(rid)
            got = eng.result(rid, timeout=30.0)["tokens"]
    finally:
        eng.shutdown()
    assert got == live[9:]
    pages = 1 if partial else 6
    assert req.restore_pages == pages and req.restore_partial is partial
    assert prog["restored_tokens"] == pages * PS
    assert eng.stats["failover_restored_tokens"] == pages * PS
    kinds = [e["kind"] for e in evs if e["kind"] != "mid_traffic_compile"]
    assert kinds == ["failover_resume"] + ["restore_partial"] * partial
    for e in evs:
        if e["kind"] == "restore_partial":
            assert e["attrs"] == {"restored_pages": 1, "planned_pages": 6}
            assert e["request_id"] == rid


# ---------------------------------------------------------------------------
# the server


@pytest.mark.parametrize("plan", ["continuation", "retry"])
def test_server_stream_resumes(weights, jax_run, plan):
    """A stream whose payload carries the ids already streamed resumes as
    a continuation (within ``failover_max_resumes``) or, past it,
    regenerates with those ids suppressed; either way its ``token_ids``
    are the uninterrupted run's tail, and its first chunk carries
    ``resume_meta``."""
    want, k = jax_run["want"], 3
    srv = LLMServer(TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                            device="cpu", **SHAPE), params=weights[1],
                    rng_seed=0)
    resumes = srv.cfg.failover_max_resumes + (plan == "retry")

    async def stream():
        return [c async for c in srv.completions({
            "prompt": PROMPT, "max_tokens": 8 - k, "temperature": 0.0,
            "stream": True, "resume_tokens": want[:k],
            "resume_count": resumes})]

    try:
        chunks = asyncio.run(stream())
        stats = srv.engine_stats()
        assert srv.eager_spill() == {"spilled_pages": 0}   # tier off
    finally:
        srv.shutdown()
    assert [t for c in chunks[:-1] for t in c["token_ids"]] == want[k:]
    meta = chunks[0]["resume_meta"]
    assert meta["resumed"] is (plan == "continuation")
    assert set(meta) == {"resumed", "restored_tokens", "restore_bytes",
                         "restore_ms", "cached_tokens"}
    assert all("resume_meta" not in c for c in chunks[1:])
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert chunks[-1]["usage"]["completion_tokens"] == 8 - k
    assert stats["failover_resumed"] == (plan == "continuation")
