"""Per-request attribution in the PyTorch port
(``ray_torch/observability/attribution.py``, the engine's
``_attribution_payload`` and the server's ``ray_tpu.stages``) against the
reference on the CPU.

- The module's pure functions (``engine_stages``, ``Timeline``,
  ``build_record``, ``aggregate_report``, ``percentile``,
  ``stages_to_spans``) give the reference's outputs on the same inputs;
  its context variables are its own.
- The engine: a port engine and ONE JAX engine (gather backend, built once
  for the module) serve the same two prompts, the second sharing a
  page-aligned prefix; stage names and count attributes agree. The
  restore stage on a CPU tier engine, clean and partial; a shed request's
  lone ``queue`` stage through ``result`` and ``drain``.
- The server: responses, streamed and not, carry the engine's stages; a
  request id bound in the caller's context reaches the engine.
"""

import asyncio
import contextvars
import time

import numpy as np
import pytest
import torch

import jax

from ray_tpu.models import llama as jllama
from ray_tpu.observability import attribution as rattr
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_torch.core import deadline as tdeadline
from ray_torch.models import llama as tllama
from ray_torch.observability import attribution as tattr
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import LLMServer
from ray_torch.serve.llm import kv_cache as tkv
from ray_torch.serve.llm import kv_tier as ttier

PS = 16
PREFIX = "the quick brown fox jumps over the lazy dog, then"   # 48 chars
PROMPTS = [PREFIX[:47] + " one", PREFIX[:47] + " two"]  # + BOS: 3 shared pages
LONG = ("the quick brown fox jumps over the lazy dog "
        "the quick brown fox jumps over the lazy dog")       # 87 -> 5 pages
SHAPE = dict(max_batch_size=4, page_size=PS, num_pages=64,
             max_prompt_len=96, max_seq_len=160, max_tokens=8)
# the tier tests' shape: a drained LONG spills its 3-page chain head; a
# long per-chunk budget so that a loaded machine cannot trip the watchdog
TIER = dict(prefix_cache_max_pages=2, kv_tier_enabled=True,
            kv_tier_chunk_timeout_s=30.0)


def _isolated(fn, *args):
    """Run ``fn`` in a copy of the current context, so that what it binds
    in either module's context variables does not leak into other tests."""
    return contextvars.copy_context().run(fn, *args)


# ---------------------------------------------------------------------------
# the pure functions against the reference

_T0 = dict(submitted_wall=1000.0, submitted_at=50.0)
ENGINE_CASES = {
    "full_path": dict(
        _T0, admitted_at=50.2, first_token_at=50.5, finished_at=50.9,
        cached_tokens=16, restored_tokens=32, restore_bytes=4096,
        restore_ms=100.0, prompt_tokens=64, generated_tokens=8, itl_s=0.05),
    "no_restore": dict(
        _T0, admitted_at=50.1, first_token_at=50.3, finished_at=50.4,
        prompt_tokens=8, generated_tokens=2),
    "restore_split": dict(
        _T0, admitted_at=50.01, first_token_at=50.7, finished_at=51.2,
        cached_tokens=112, restored_tokens=96, restore_bytes=3 * 65536,
        restore_ms=412.3456, restore_wire_bytes=150001,
        restore_decode_ms=376.12345, restore_overlap_ms=12.3456,
        prompt_tokens=140, generated_tokens=32, itl_s=0.0042),
    "partial_restore": dict(
        _T0, admitted_at=50.0, first_token_at=50.3, finished_at=50.6,
        cached_tokens=16, restored_tokens=16, restore_bytes=4096,
        restore_ms=35.5, restore_wire_bytes=2048, restore_decode_ms=1.25,
        restore_overlap_ms=0.0, restore_partial=True, prompt_tokens=87,
        generated_tokens=8, itl_s=0.01),
    "admitted_no_first_token": dict(
        _T0, admitted_at=50.3, first_token_at=None, finished_at=50.6,
        cached_tokens=32, restored_tokens=32, restore_bytes=8192,
        restore_ms=20.0, prompt_tokens=87),
    "finished_none": dict(
        _T0, admitted_at=50.1, first_token_at=50.2, finished_at=None,
        prompt_tokens=20, generated_tokens=1),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES) + ["never_admitted"])
def test_engine_stages_match_the_reference(case):
    if case != "never_admitted":
        kw = ENGINE_CASES[case]
        got = tattr.engine_stages(**kw)
        assert got == rattr.engine_stages(**kw)
        names = [s["stage"] for s in got]
        assert names == sorted(names, key=tattr.STAGES.index)
        assert ("restore" in names) == (kw.get("restored_tokens", 0) > 0)
        assert ("decode" in names) == (kw["first_token_at"] is not None)
        return
    # never admitted: the queue ends at the clock read inside the call
    kw = dict(submitted_wall=time.time() - 1.0,
              submitted_at=time.monotonic() - 1.0, admitted_at=None,
              first_token_at=None, finished_at=None, prompt_tokens=5)
    before = kw["submitted_wall"] + (time.monotonic() - kw["submitted_at"])
    got = tattr.engine_stages(**kw)
    want = rattr.engine_stages(**kw)
    after = kw["submitted_wall"] + (time.monotonic() - kw["submitted_at"])
    assert len(got) == len(want) == 1
    assert {k: v for k, v in got[0].items() if k != "end"} == \
        {k: v for k, v in want[0].items() if k != "end"} == \
        {"stage": "queue", "start": kw["submitted_wall"],
         "attrs": {"admitted": False}}
    assert before <= got[0]["end"] <= after


def test_timeline_note_merges_into_route_and_orders_stages():
    def run(mod):
        tl = mod.Timeline("req1", app="a", deployment="d")
        tl.note(demotion="spillover")
        tl.note(replica="rep-a", matched_pages=3)
        tl.stamp("route", 10.0, 10.01, attempt=1)
        routed = (list(tl.stages), tl.replica, dict(tl.route_attrs))
        tl.stamp("ingress", 9.0, 9.001)
        tl.extend([
            {"stage": "decode", "start": 10.2, "end": 10.3, "attrs": {}},
            {"stage": "queue", "start": 10.02, "end": 10.05, "attrs": {}},
            {"stage": "prefill", "start": 10.05, "end": 10.2, "attrs": {}},
            {"no stage": 1}, "not a dict",
        ])
        tl.stamp("route", 10.011, 10.02, attempt=2)
        return routed, tl.ordered_stages()

    (route, replica, left), ordered = run(tattr)
    assert (route, replica, left) == run(rattr)[0]
    assert ordered == run(rattr)[1]
    assert route[0]["attrs"] == {"demotion": "spillover", "replica": "rep-a",
                                 "matched_pages": 3, "attempt": 1}
    assert replica == "rep-a" and left == {}
    assert [s["stage"] for s in ordered] == \
        ["ingress", "route", "route", "queue", "prefill", "decode"]
    assert ordered[1]["start"] < ordered[2]["start"]
    assert tattr.STAGES == rattr.STAGES


def _rec(mod, rid, *, replica="rep-a", violated=("ttft",), queue_ms=5.0,
         prefill_ms=50.0, decode_ms=20.0, matched_pages=0):
    """One record built through ``mod``'s Timeline and build_record (the
    reference tests' ``_rec`` shape)."""
    t = 1000.0
    q1 = t + 0.002 + queue_ms / 1e3
    p1 = q1 + prefill_ms / 1e3
    d1 = p1 + decode_ms / 1e3
    tl = mod.Timeline(rid, app="app", deployment="llm")
    tl.stamp("ingress", t, t + 0.001)
    tl.note(replica=replica, matched_pages=matched_pages)
    tl.stamp("route", t + 0.001, t + 0.002)
    tl.extend([
        {"stage": "decode", "start": p1, "end": d1,
         "attrs": {"generated_tokens": 8}},
        {"stage": "queue", "start": t + 0.002, "end": q1,
         "attrs": {"admitted": True}},
        {"stage": "prefill", "start": q1, "end": p1,
         "attrs": {"cached_tokens": 0, "restored_tokens": 0,
                   "prefilled_tokens": 32}}])
    return mod.build_record(
        tl, kind="violation" if violated else "baseline",
        violated=list(violated), policy={"slo_ttft_p99_ms": 1.0},
        ttft_ms=queue_ms + prefill_ms, e2e_ms=queue_ms + prefill_ms
        + decode_ms, source="src01")


def _records(mod, which):
    if which == "skew":
        return ([_rec(mod, f"a{i}", queue_ms=100.0, prefill_ms=10.0,
                      matched_pages=4) for i in range(4)]
                + [_rec(mod, f"b{i}", replica="rep-b", queue_ms=2.0,
                        prefill_ms=60.0, violated=()) for i in range(4)])
    if which == "no_violations":
        return [_rec(mod, f"r{i}", violated=(),
                     decode_ms=500.0 if i == 0 else 5.0) for i in range(10)]
    return [{"request_id": "x", "stages": None}, "not a record",
            {"request_id": "y", "ttft_ms": 3.0, "stages": [
                {"stage": "unknown", "start": 0.0, "end": 1.0},
                {"stage": "queue", "start": 2.0, "end": 1.0}]}]


def _no_ts(rec):
    return {k: v for k, v in rec.items() if k != "ts"}


@pytest.mark.parametrize("which", ["skew", "no_violations", "odd"])
def test_records_report_and_spans_match_the_reference(which):
    got, want = _records(tattr, which), _records(rattr, which)
    assert [_no_ts(r) if isinstance(r, dict) else r for r in got] == \
        [_no_ts(r) if isinstance(r, dict) else r for r in want]
    rep = tattr.aggregate_report(got)
    assert rep == rattr.aggregate_report(want)
    for r, w in zip(got, want):
        if isinstance(r, dict):
            assert tattr.stages_to_spans(r) == rattr.stages_to_spans(w)
    if which == "skew":
        assert rep["violations"] == 4 and rep["dominant_stage"] == \
            {"queue": 4}
        assert rep["replica_skew"]["rep-a"]["affinity_hit_share"] == 1.0
        assert rep["replica_skew"]["rep-a"]["prefilled_tokens"] == 4 * 32
        spans = tattr.stages_to_spans(got[0])
        assert spans[0]["parent_id"] is None
        assert [s["name"] for s in spans[1:]] == \
            [f"stage:{s['stage']}" for s in got[0]["stages"]]
    if which == "no_violations":
        assert rep["dominant_stage"] == {"decode": 1}


def test_percentile_matches_the_reference():
    vals = [float(v) for v in range(1, 101)]
    rng = np.random.RandomState(0)
    cases = [(vals, 0.50), (vals, 0.99), ([7.0], 0.95), ([], 0.5)]
    cases += [(sorted(rng.rand(n).tolist()), q)
              for n in (2, 3, 17) for q in (0.0, 0.25, 0.5, 0.95, 1.0)]
    for xs, q in cases:
        assert tattr.percentile(xs, q) == rattr.percentile(xs, q)
    assert tattr.percentile(vals, 0.50) == pytest.approx(50.5)
    assert tattr.percentile(vals, 0.99) == pytest.approx(99.01)


def test_context_functions_and_their_own_context_variables():
    def run():
        assert tattr.current() is None and tattr.get_request_id() == ""
        tattr.stamp("queue", 1.0, 2.0)          # no timeline: a no-op
        tattr.note(replica="r")
        tl = tattr.begin("rid-1", app="a", deployment="d")
        assert tattr.current() is tl and tattr.get_request_id() == "rid-1"
        tattr.note(replica="rep-x", matched_pages=2)
        tattr.stamp("route", 1.0, 1.5, attempt=1)
        assert tl.stages == [{"stage": "route", "start": 1.0, "end": 1.5,
                              "attrs": {"replica": "rep-x",
                                        "matched_pages": 2, "attempt": 1}}]
        assert tl.replica == "rep-x"
        # the reference's variables are not the port's, both ways
        assert rattr.current() is None and rattr.get_request_id() == ""
        rtl = rattr.begin("rid-2")
        assert tattr.current() is tl and tattr.get_request_id() == "rid-1"
        assert rattr.current() is rtl
        tattr.set_request_id("rid-3")
        assert tattr.get_request_id() == "rid-3"
        assert rattr.get_request_id() == "rid-2"
        tattr.set_request_id(None)
        assert tattr.get_request_id() == ""

    _isolated(run)
    assert tattr.current() is None and tattr.get_request_id() == ""


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jllama.llama_tiny(vocab_size=512))
    return jllama.save_params(params, str(tmp_path_factory.mktemp("ckpt")))


def _serve_two(eng):
    """PROMPTS one after the other (the second hits the first's 3 cached
    pages); each result."""
    eng.start()
    try:
        return [eng.generate(p, temperature=0.0) for p in PROMPTS]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_two(ckpt):
    return _serve_two(JEngine(JConfig(
        model_config=jllama.llama_tiny(vocab_size=512),
        attention_kernel="gather", checkpoint_path=ckpt, **SHAPE),
        rng_seed=0))


def _tengine(ckpt=None, **kw):
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", checkpoint_path=ckpt, **dict(SHAPE, **kw))
    return TEngine(cfg, rng_seed=0)


def _counts(stages):
    keys = ("admitted", "cached_tokens", "prefilled_tokens",
            "generated_tokens", "restored_tokens")
    return [(s["stage"], {k: v for k, v in s["attrs"].items() if k in keys})
            for s in stages]


def _contiguous(out, plen):
    names = [s["stage"] for s in out["stages"]]
    by = {s["stage"]: s for s in out["stages"]}
    q, p, d = by["queue"], by["prefill"], by["decode"]
    assert (by.get("restore", q)["end"] == p["start"]
            and q["end"] == by.get("restore", p)["start"]
            and p["end"] == d["start"])
    assert p["end"] - q["start"] == pytest.approx(out["ttft_s"], abs=1e-6)
    assert d["end"] - q["start"] == pytest.approx(out["latency_s"],
                                                  abs=1e-6)
    assert q["end"] - q["start"] == pytest.approx(out["queue_wait_s"],
                                                  abs=1e-6)
    assert p["attrs"]["prefilled_tokens"] == \
        plen - p["attrs"]["cached_tokens"]
    assert d["attrs"]["generated_tokens"] == len(out["tokens"])
    return names


def test_engine_stages_match_a_jax_engine(ckpt, jax_two):
    outs = _serve_two(_tengine(ckpt))
    for i, (got, want) in enumerate(zip(outs, jax_two)):
        assert got["tokens"] == want["tokens"]
        assert _counts(got["stages"]) == _counts(want["stages"])
        plen = len(PROMPTS[i]) + 1
        assert _contiguous(got, plen) == ["queue", "prefill", "decode"]
        assert got["stages"][0]["attrs"] == {"admitted": True}
    cached = [o["stages"][1]["attrs"]["cached_tokens"] for o in outs]
    assert cached == [0, 3 * PS]


def _handed(monkeypatch) -> list:
    """The bytes of every page payload the store hands a restore stream
    from now on, K's and V's together, read from the payloads."""
    sizes = []
    fetch = ttier.ChainStream._fetch_chunk

    def spy(stream, chunk, blobs):
        items = fetch(stream, chunk, blobs)
        for pk, pv, enc, _nb in items:
            sizes.append(sum(len(p["data"]) + len(p.get("scale") or b"")
                             if enc else p.nbytes for p in (pk, pv)))
        return items

    monkeypatch.setattr(ttier.ChainStream, "_fetch_chunk", spy)
    return sizes


def _wait(pred, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end and not pred():
        time.sleep(0.01)
    return pred()


@pytest.mark.parametrize("partial", [False, True], ids=["clean", "partial"])
def test_restore_stage_fields(monkeypatch, partial):
    eng = _tengine(kv_tier_chunk_pages=1 if partial else 8, **TIER)
    eng.start()
    try:
        cold = eng.generate(LONG, temperature=0.0)
        assert _wait(lambda: eng.engine_stats()["spilled_pages"] >= 3)
        handed = _handed(monkeypatch)
        if partial:
            def fault(ci):
                if ci >= 1:
                    raise RuntimeError("injected chunk fault")

            eng._kv_tier._chunk_fault = fault
        rid = eng.submit(LONG, temperature=0.0)
        req = eng._requests[rid]
        out = eng.result(rid, timeout=120.0)
    finally:
        eng.shutdown()
    assert out["tokens"] == cold["tokens"]
    assert [s["stage"] for s in cold["stages"]] == \
        ["queue", "prefill", "decode"]
    names = _contiguous(out, len(LONG) + 1)
    assert names == ["queue", "restore", "prefill", "decode"]
    r = out["stages"][1]["attrs"]
    pages = 1 if partial else 3
    mcfg = eng.model_cfg
    page_bytes = (mcfg.n_layers * mcfg.n_kv_heads * PS * mcfg.head_dim
                  * eng.kv["k"].element_size() * 2)
    assert page_bytes == tkv.page_raw_nbytes(mcfg, PS)
    assert req.restore_pages == pages == len(handed)
    assert r["restored_tokens"] == pages * PS
    assert r["restore_bytes"] == pages * page_bytes
    assert r["bytes_wire"] > 0 and r["bytes_wire"] == sum(handed)
    assert r["restore_ms"] == round(req.restore_ms, 3)
    assert r["decode_ms"] == round(req.restore_decode_ms, 3)
    assert r["overlap_ms"] == round(
        max(0.0, req.restore_ms - req.restore_blocked_ms), 3)
    assert r["partial"] is partial
    assert out["stages"][2]["attrs"]["cached_tokens"] == \
        (PS if partial else 3 * PS)


def test_shed_request_is_queue_only_through_result_and_drain():
    eng = _tengine()
    try:
        with tdeadline.scope(time.time() - 1.0):
            a = eng.submit(PROMPTS[0], temperature=0.0)
            b = eng.submit(PROMPTS[1], temperature=0.0)
        t0 = time.time()
        with torch.no_grad():
            eng._admit()
        assert eng.stats["shed_expired"] == 2
        out = eng.result(a, timeout=5.0)
        fin = eng.drain(b)
        t1 = time.time()
    finally:
        eng.shutdown()
    for o in (out, fin):
        assert o["error"] == "deadline exceeded" and o["queue_wait_s"] is None
        (q,) = o["stages"]
        assert q["stage"] == "queue" and q["attrs"] == {"admitted": False}
        # the queue of a request never admitted ends when it is read
        assert q["start"] <= t0 and t0 - 1e-3 <= q["end"] <= t1 + 1e-3
    assert fin["done"] and fin["request_id"] == b


# ---------------------------------------------------------------------------
# the server


def test_server_responses_carry_the_engine_stages():
    srv = LLMServer(TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                            device="cpu", **SHAPE), rng_seed=0)
    seen = {}
    result, drain = srv.engine.result, srv.engine.drain

    def spy_result(rid, timeout=None):
        seen["result"] = result(rid, timeout)
        return seen["result"]

    def spy_drain(rid):
        d = drain(rid)
        if d["done"]:
            seen["drain"] = d
        return d

    srv.engine.result, srv.engine.drain = spy_result, spy_drain

    async def stream(payload):
        return [c async for c in srv.completions(payload)]

    def bound(rid, payload):
        tattr.set_request_id(rid)
        if payload.get("stream"):
            return asyncio.run(stream(payload))
        return srv.completions(payload)

    try:
        plain = srv.completions({"prompt": PROMPTS[0], "max_tokens": 4,
                                 "temperature": 0.0})
        named = _isolated(bound, "req-from-ingress",
                          {"prompt": PROMPTS[1], "max_tokens": 4,
                           "temperature": 0.0})
        engine_out = seen["result"]
        assert engine_out["request_id"] == "req-from-ingress"
        chunks = _isolated(bound, "req-streamed",
                           {"prompt": PROMPTS[0], "max_tokens": 4,
                            "temperature": 0.0, "stream": True})
        chat = srv.chat({"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 2})
    finally:
        srv.shutdown()
    for resp in (plain, named, chat):
        st = resp["ray_tpu"]["stages"]
        assert [s["stage"] for s in st] == ["queue", "prefill", "decode"]
    assert named["ray_tpu"]["stages"] == engine_out["stages"]
    assert named["ray_tpu"]["request_id"] == "req-from-ingress"
    assert plain["ray_tpu"]["request_id"] != "req-from-ingress"
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] == "stop"
    assert final["ray_tpu"]["request_id"] == "req-streamed"
    assert final["ray_tpu"]["stages"] == seen["drain"]["stages"]
    assert [s["stage"] for s in final["ray_tpu"]["stages"]] == \
        ["queue", "prefill", "decode"]
    assert final["ray_tpu"]["stages"][2]["attrs"]["generated_tokens"] == \
        final["usage"]["completion_tokens"]
    assert tattr.get_request_id() == ""
