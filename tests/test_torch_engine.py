"""ray_torch's LLMEngine / LLMServer against ray_tpu's on the CPU.

Both engines load one flat-npz checkpoint (written by the JAX package) of
llama_tiny in fp32 and serve the same requests. The JAX engine runs its
gather backend: that is the reference path that passes on this tree (the
Pallas-engine identity test of tests/test_paged_kernels.py does not).
Greedy tokens must be IDENTICAL — the prefix cache is on, one prompt is
longer than ``prefill_chunk``, a later prompt reuses an indexed prefix
(the chunk path over shared pages), and there are more requests than
``max_batch_size`` slots.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_tpu.serve.llm import llm_server as jserver
from ray_torch.models import llama as tllama
from ray_torch.observability import profiling as tprof
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import LLMServer as TServer

SHARED = "the quick brown fox jumps over the lazy dog"   # 5 full 8-token pages
PROMPTS = [SHARED + " once", SHARED + " twice", "abc abc abc",
           SHARED + " thrice", "x"]


def _configs(ckpt, **kw):
    common = dict(max_batch_size=2, page_size=8, num_pages=48,
                  max_prompt_len=64, max_seq_len=128, max_tokens=10,
                  prefill_chunk=16, checkpoint_path=ckpt)
    common.update(kw)
    jcfg = JConfig(model_config=jllama.llama_tiny(vocab_size=512),
                   attention_kernel="gather", warmup_compile=False, **common)
    tcfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                   device="cpu", **common)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """One JAX and one port engine over the same checkpoint; each test
    sends both the same requests in the same order."""
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jllama.llama_tiny(vocab_size=512))
    ckpt = jllama.save_params(params, str(tmp_path_factory.mktemp("ckpt")))
    jcfg, tcfg = _configs(ckpt)
    jeng, teng = JEngine(jcfg, rng_seed=0), TEngine(tcfg, rng_seed=0)
    # started here, so that a test which reaches the engines only through a
    # server (and runs on a test worker of its own) finds their loops up
    jeng.start()
    teng.start()
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def _serve(eng, prompts, max_tokens):
    rids = [eng.submit(p, max_tokens=max_tokens, temperature=0.0)
            for p in prompts]
    eng.start()
    return [eng.result(r, timeout=120.0) for r in rids]


def test_engine_greedy_tokens_identical_to_jax_gather_engine(engines):
    jeng, teng = engines
    want = _serve(jeng, PROMPTS, 10)
    got = _serve(teng, PROMPTS, 10)
    assert all(o["error"] is None for o in want + got)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert [o["num_prompt_tokens"] for o in got] == \
        [o["num_prompt_tokens"] for o in want]
    js, ts = jeng.engine_stats(), teng.engine_stats()
    assert ts["attention_backend"] == "gather"
    assert ts["prefix_hits"] == js["prefix_hits"] >= 1
    assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"]
    assert ts["attn_chunk_dispatches"] == js["attn_chunk_dispatches"] > 0
    assert ts["attn_decode_dispatches"] > 0
    assert ts["prefills"] == js["prefills"] == len(PROMPTS)
    # the pool drains back to baseline (cached pages count as available)
    assert ts["free_pages"] == js["free_pages"] == 47
    assert ts["active_slots"] == 0
    # padding lanes never leave state in the permanent trash row
    assert int(teng._sl_dev[-1]) == 0
    assert not teng._pt_dev[-1].any()


def test_server_completions_match_jax_server(engines):
    """Same text and token counts through the OpenAI-shaped endpoint; the
    port's streamed chunks carry the same tokens as its non-stream
    answer."""
    jeng, teng = engines
    jsrv = jserver.LLMServer.__new__(jserver.LLMServer)  # no signal hooks
    jsrv.cfg, jsrv.engine = jeng.cfg, jeng
    tsrv = TServer.__new__(TServer)
    tsrv.cfg, tsrv.engine = teng.cfg, teng
    payload = {"prompt": SHARED + " again", "max_tokens": 6,
               "temperature": 0.0}
    want = jsrv.completions(payload)
    got = tsrv.completions(payload)
    assert got["object"] == want["object"] == "text_completion"
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    chat_msgs = {"messages": [{"role": "user", "content": "hi"}],
                 "max_tokens": 4}
    assert tsrv.chat(chat_msgs)["choices"][0]["message"] == \
        jsrv.chat(chat_msgs)["choices"][0]["message"]

    async def stream():
        return [c async for c in tsrv.completions(dict(payload,
                                                       stream=True))]

    chunks = asyncio.run(stream())
    toks = [t for c in chunks[:-1] for t in c["token_ids"]]
    assert toks == teng.generate(SHARED + " again", max_tokens=6,
                                 temperature=0.0)["tokens"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert chunks[-1]["usage"] == want["usage"]
    assert tsrv.handle_http("/v1/models", "GET", None)["data"][0]["id"] \
        == "llama-tiny"
    assert "error" in tsrv.handle_http("/v1/nope", "GET", None)


def test_server_builds_serves_and_shuts_down_its_engine():
    cfg = TConfig(model_config=tllama.llama_tiny(), device="cpu",
                  max_batch_size=2, page_size=8, num_pages=16,
                  max_prompt_len=32, max_seq_len=64, max_tokens=4)
    srv = TServer(cfg, rng_seed=3)
    try:
        assert srv.check_health()
        out = srv.completions({"prompt": ["hi"], "max_tokens": 3})
        assert out["usage"]["completion_tokens"] == 3
        assert srv.handle_http("/v1/stats", "GET", None)["requests"] == 1
    finally:
        srv.shutdown()
    assert not srv.check_health()


def test_engine_stats_keys_follow_the_reference(engines):
    jeng, teng = engines
    extra = set(teng.engine_stats()) - set(jeng.engine_stats())
    assert extra == {"attn_backend_cuda"}


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(TConfig(model_config=tllama.llama_tiny()))
    with pytest.raises(ValueError, match="CUDA device"):
        TEngine(TConfig(model_config=tllama.llama_tiny(), device="cpu",
                        attention_kernel="cuda"))


@pytest.mark.parametrize("field,value", [
    ("spec_decode_enabled", True), ("kv_tier_enabled", True),
    ("tp_degree", 2), ("disagg_prompt_threshold", 256),
    ("disagg_prefill_deployment", "prefill")])
def test_unported_features_raise(field, value):
    cfg = TConfig(model_config=tllama.llama_tiny(), device="cpu",
                  **{field: value})
    if field == "spec_decode_enabled":
        # ported since: the engine builds with speculation on
        # (tests/test_torch_spec_decode.py holds it)
        assert TEngine(cfg)._spec_on
        return
    if field == "kv_tier_enabled":
        # ported since: the engine builds with the KV tier on
        # (tests/test_torch_kv_tier.py holds it)
        assert TEngine(cfg)._kv_tier_on
        return
    with pytest.raises(NotImplementedError, match=field):
        TEngine(cfg)


def test_cancel_mid_chunked_prefill_frees_slot_and_pages():
    """Mirror of test_prefix_cache.py's regression, loop driven by hand."""
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", max_batch_size=4, page_size=16,
                  num_pages=32, max_prompt_len=64, max_seq_len=128,
                  max_tokens=8, prefill_chunk=16)
    eng = TEngine(cfg, rng_seed=0)
    baseline = eng.allocator.available()
    rid = eng.submit([7] * 60, max_tokens=4)
    assert eng._admit() == 1
    assert len(eng._prefilling) == 1 and len(eng.free_slots) == 3
    eng._prefill_chunks()
    assert len(eng._prefilling) == 1
    eng.cancel(rid)
    assert len(eng._prefilling) == 1  # cancel only flags; the loop frees
    eng._prefill_chunks()
    assert eng._prefilling == []
    assert len(eng.free_slots) == 4
    assert eng.allocator.available() == baseline
    assert eng.drain(rid)["error"] == "unknown request"


def test_profiler_matches_reference_percentiles():
    # imported here: importing it before ray_tpu.util is a circular import
    # in the reference
    from ray_tpu.observability import profiling as jprof

    samples = list(np.random.RandomState(0).rand(37))
    mine, ref = tprof.EngineProfiler(), jprof.EngineProfiler()
    for dt in samples:
        mine.record("harvest", dt)
        ref.record("harvest", dt)
        mine.record_itl(dt / 10)
        ref.record_itl(dt / 10)
    assert mine.phase_stats() == ref.phase_stats()
    for prof in (mine, ref):
        with prof.compile_scope("decode", ("decode", 4, 1)):
            pass
        with prof.compile_scope("decode", ("decode", 4, 1)):
            pass
        with prof.compile_scope("chunk", ("chunk", 16), mid_traffic=True):
            pass
    for attr in ("compile_events", "mid_traffic_compiles"):
        assert getattr(mine, attr) == getattr(ref, attr)
    assert mine.compile_count(("decode", "chunk")) == 2
    assert tprof.tree_bytes({"a": torch.zeros(3, 4), "b": [torch.zeros(
        2, dtype=torch.bfloat16)]}) == 52
    assert tprof.device_memory_stats(torch.device("cpu")) == (None, None)
