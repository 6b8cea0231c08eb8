"""Request deadlines in the PyTorch port (``ray_torch/core/deadline.py``,
``ray_torch/exceptions.py`` and the engine's five deadline sites) against
the reference on the CPU.

Every deadline that must have passed is set in the past at submit, or
assigned to ``req.deadline`` between passes of a loop driven by hand, so
nothing races a clock; the one bounded ``result()`` wait is the only test
that sleeps against a deadline. One JAX engine is built (module fixture,
``warmup_compile=False``) and its loop is never started.
"""

import time

import pytest
import torch

from ray_tpu.core import deadline as jdeadline
from ray_tpu.exceptions import DeadlineExceededError as JDeadlineError
from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import LLMConfig as JConfig
from ray_tpu.serve.llm import LLMEngine as JEngine
from ray_torch.core import deadline as tdeadline
from ray_torch.exceptions import DeadlineExceededError, RayTpuError
from ray_torch.models import llama as tllama
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine

PROMPT = "the quick brown fox jumps over the lazy dog"   # 43 byte-tokens
LONG = PROMPT + " " + PROMPT                             # 87 -> 5 full pages
SHAPE = dict(max_batch_size=4, page_size=16, num_pages=64, max_prompt_len=96,
             max_seq_len=160, max_tokens=8)
# the KV tier at the reference tests' shape: a drained LONG spills its
# 3-page chain head (tests/test_torch_kv_tier.py)
TIER = dict(prefix_cache_max_pages=2, kv_tier_enabled=True,
            kv_tier_chunk_timeout_s=30.0)
WAVE = [PROMPT, "abc abc abc", LONG, "x", PROMPT + " twice", "pack my box"]


def _engine(**kw):
    cfg = TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                  device="cpu", warmup_compile=False, **dict(SHAPE, **kw))
    return TEngine(cfg, rng_seed=0)


def _past():
    return time.time() - 1.0


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _pump(eng, pred, timeout=60.0):
    """One engine loop pass after another, on this thread, until pred()."""
    end = time.monotonic() + timeout
    with torch.no_grad():
        while not pred():
            assert time.monotonic() < end, "engine made no progress"
            eng._admit()
            if eng._kv_tier_on:
                eng._restore_steps()
            eng._prefill_chunks()
            eng._step()
            while eng._pending:
                eng._harvest_one()
            if eng._kv_tier_on:
                eng._kv_tier_flush()


def _serve(eng, prompts, expired=()):
    """Submit ``prompts`` (those at the indices ``expired`` under a deadline
    that has passed), then start the loop; every result, in order."""
    rids = []
    for i, p in enumerate(prompts):
        with tdeadline.scope(_past() if i in expired else None):
            rids.append(eng.submit(p, temperature=0.0))
    eng.start()
    return [eng.result(r, timeout=120.0) for r in rids]


def _sequence(mod, error):
    """The deadline module's semantics (tests/test_serve_robustness.py's
    assertions) as a record of what each call returned."""
    out = [mod.current(), mod.remaining(), mod.remaining(default=7.0),
           mod.bound(5.0), mod.bound(None), mod.expired()]
    mod.raise_if_expired()
    dl = time.time() + 10.0
    with mod.scope(dl) as got:
        rem = mod.remaining()
        assert 9.0 < rem <= 10.0
        assert mod.bound(60.0) <= 10.0 and mod.bound(None) <= 10.0
        out += [got == dl, mod.current() == dl, mod.bound(1.0),
                mod.expired()]
        with mod.scope(None) as outer:
            out += [outer == dl, mod.current() == dl]
        inner = time.time() + 1.0
        with mod.scope(inner):
            out.append(mod.current() == inner)
        out.append(mod.current() == dl)
    out.append(mod.current())
    with mod.scope(time.time() - 0.5):
        assert mod.remaining() < 0
        out += [mod.expired(), mod.bound(30.0), mod.bound(None)]
        with pytest.raises(error, match="unit test deadline exceeded"):
            mod.raise_if_expired("unit test")
    return out


def test_deadline_module_matches_the_reference():
    got = _sequence(tdeadline, DeadlineExceededError)
    assert got == _sequence(jdeadline, JDeadlineError)
    assert got[:6] == [None, None, 7.0, 5.0, None, False]
    assert got[-3:] == [True, pytest.approx(0.001), pytest.approx(0.001)]
    assert issubclass(DeadlineExceededError, TimeoutError)
    assert issubclass(DeadlineExceededError, RayTpuError)
    assert [c.__name__ for c in DeadlineExceededError.__mro__] == \
        [c.__name__ for c in JDeadlineError.__mro__]


def test_submit_captures_the_ambient_deadline():
    eng = _engine()
    rid = eng.submit(PROMPT)
    assert eng._requests[rid].deadline is None
    dl = time.time() + 60.0
    with tdeadline.scope(dl):
        rid = eng.submit(PROMPT)
        with tdeadline.scope(None):
            rid2 = eng.submit(PROMPT)
    assert eng._requests[rid].deadline == dl
    assert eng._requests[rid2].deadline == dl
    # the reference's carrier is not the port's
    with jdeadline.scope(dl):
        assert eng._requests[eng.submit(PROMPT)].deadline is None


@pytest.fixture(scope="module")
def jax_engine():
    """The reference engine, never started: shedding runs in _admit's
    first statement, so it is called by hand."""
    eng = JEngine(JConfig(model_config=jllama.llama_tiny(vocab_size=512),
                          attention_kernel="gather", warmup_compile=False,
                          **SHAPE), rng_seed=0)
    yield eng
    eng.shutdown()


def _shed_four(eng, scope):
    """Two past deadlines, one ahead, one none: shed, then one result()
    each (a short wait for the two left waiting)."""
    rids = []
    for dl in (_past(), None, time.time() + 3600.0, _past()):
        with scope(dl):
            rids.append(eng.submit(PROMPT))
    eng._shed_expired_waiting()
    shed = [i for i, r in enumerate(rids) if eng._requests[r].done]
    waiting = len(eng._waiting)
    errors = [eng.result(r, timeout=5.0 if i in shed else 0.05)["error"]
              for i, r in enumerate(rids)]
    return shed, eng.stats["shed_expired"], errors, waiting, \
        len(eng._waiting)


def test_shedding_matches_the_jax_engine(jax_engine):
    got = _shed_four(_engine(), tdeadline.scope)
    assert got == _shed_four(jax_engine, jdeadline.scope)
    assert got == ([0, 3], 2, ["deadline exceeded", "timeout", "timeout",
                               "deadline exceeded"], 2, 0)


def test_admit_gives_shed_requests_no_slot_and_no_prefill():
    eng = _engine()
    baseline = eng.allocator.available()
    rids = []
    for dl in (_past(), None, _past()):
        with tdeadline.scope(dl):
            rids.append(eng.submit(PROMPT, temperature=0.0))
    reqs = [eng._requests[r] for r in rids]
    with torch.no_grad():
        assert eng._admit() == 1
    assert eng.stats["shed_expired"] == 2 and eng.stats["prefills"] == 1
    assert eng.stats["attn_chunk_dispatches"] == 0
    assert len(eng.free_slots) == 3 and eng._waiting == []
    for req in (reqs[0], reqs[2]):
        assert req.slot == -1 and req.pages == [] and req.done
        assert req.error == "deadline exceeded" and req.generated == []
    assert reqs[1].slot >= 0 and eng.slot_req[reqs[1].slot] is reqs[1]
    assert eng.allocator.available() == baseline - len(reqs[1].pages)


def test_deadline_mid_chunked_prefill_frees_slot_and_pages():
    """Mirror of test_torch_engine.py's cancel mid chunked prefill, with the
    deadline passing between two chunks."""
    eng = _engine(prefill_chunk=16)
    baseline = eng.allocator.available()
    with tdeadline.scope(time.time() + 3600.0):
        rid = eng.submit([7] * 60, max_tokens=4)
    with torch.no_grad():
        assert eng._admit() == 1
        eng._prefill_chunks()
    req = eng._requests[rid]
    assert eng._prefilling == [req] and len(eng.free_slots) == 3
    req.deadline = _past()
    with torch.no_grad():
        eng._prefill_chunks()
    assert eng._prefilling == [] and len(eng.free_slots) == 4
    assert eng.allocator.available() == baseline
    assert eng.stats["shed_expired"] == 1
    assert eng.stats["attn_chunk_dispatches"] == 1
    t0 = time.monotonic()
    out = eng.result(rid, timeout=30.0)
    assert time.monotonic() - t0 < 1.0
    assert out["error"] == "deadline exceeded" and out["tokens"] == []
    assert rid not in eng._requests


def test_cancel_mid_chunked_prefill_still_pops_and_counts_nothing():
    eng = _engine(prefill_chunk=16)
    baseline = eng.allocator.available()
    with tdeadline.scope(time.time() + 3600.0):
        rid = eng.submit([7] * 60, max_tokens=4)
    with torch.no_grad():
        eng._admit()
        eng._prefill_chunks()
    eng.cancel(rid)
    with torch.no_grad():
        eng._prefill_chunks()
    assert eng._prefilling == [] and len(eng.free_slots) == 4
    assert eng.allocator.available() == baseline
    assert eng.stats["shed_expired"] == 0
    assert eng.drain(rid)["error"] == "unknown request"


def test_deadline_mid_restore_aborts_the_stream_and_frees_slot_and_pages():
    """Mirror of test_torch_kv_tier.py's cancel mid restore, with the
    deadline passing while the request sits in _restoring; A served again
    with no deadline still restores and gives the cold run's tokens."""
    eng = _engine(**TIER)
    baseline = eng.allocator.available()
    try:
        rid = eng.submit(LONG, temperature=0.0)
        _pump(eng, lambda: eng._requests[rid].done)
        cold = eng.drain(rid)["tokens"]
        assert eng.engine_stats()["spilled_pages"] == 3
        with tdeadline.scope(time.time() + 3600.0):
            rid = eng.submit(LONG, temperature=0.0)
        with torch.no_grad():
            assert eng._admit() == 1
        req = eng._requests[rid]
        assert eng._restoring == [req] and len(eng.free_slots) == 3
        stream = req.restore_stream
        assert stream is not None
        req.deadline = _past()
        with torch.no_grad():
            assert eng._restore_steps() == 1
        assert eng._restoring == [] and eng._prefilling == []
        assert len(eng.free_slots) == 4
        assert eng.allocator.available() == baseline
        assert req.restore_stream is None and stream._aborted
        assert eng.stats["shed_expired"] == 1
        out = eng.result(rid, timeout=5.0)
        assert out["error"] == "deadline exceeded" and out["tokens"] == []
        assert _wait(lambda: eng._kv_tier.stats()["streams"] == 0)
        restored = eng.stats["restored_pages"]
        rid = eng.submit(LONG, temperature=0.0)
        _pump(eng, lambda: eng._requests[rid].done)
        assert eng.drain(rid)["tokens"] == cold
        assert eng.stats["restored_pages"] - restored == 3
        assert eng.stats["shed_expired"] == 1
    finally:
        eng.shutdown()


def test_result_wait_is_bounded_by_the_deadline():
    eng = _engine()                     # the loop is not started
    with tdeadline.scope(time.time() + 0.2):
        rid = eng.submit(PROMPT)
        t0 = time.monotonic()
        out = eng.result(rid, timeout=30.0)
    assert time.monotonic() - t0 < 5.0
    assert out["error"] == "deadline exceeded" and out["tokens"] == []
    assert eng._waiting == [] and rid not in eng._requests


def test_shed_requests_leave_the_survivors_tokens_and_pages_alone():
    """A wave with expired requests mixed in gives the survivors the greedy
    tokens of the same wave without them, on a fresh engine, and the free
    pages come back to their value before the wave."""
    expired = (1, 4)
    eng = _engine(max_batch_size=2)
    baseline = eng.allocator.available()
    try:
        mixed = _serve(eng, WAVE, expired)
        assert eng.allocator.available() == baseline
        stats = eng.engine_stats()
    finally:
        eng.shutdown()
    survivors = [p for i, p in enumerate(WAVE) if i not in expired]
    eng = _engine(max_batch_size=2)
    try:
        alone = _serve(eng, survivors)
        alone_stats = eng.engine_stats()
    finally:
        eng.shutdown()
    assert [mixed[i]["error"] for i in expired] == ["deadline exceeded"] * 2
    assert all(mixed[i]["tokens"] == [] for i in expired)
    kept = [o for i, o in enumerate(mixed) if i not in expired]
    assert all(o["error"] is None for o in kept + alone)
    assert [o["tokens"] for o in kept] == [o["tokens"] for o in alone]
    assert stats["shed_expired"] == 2 and alone_stats["shed_expired"] == 0
    for key in ("prefills", "attn_chunk_dispatches", "tokens_out"):
        assert stats[key] == alone_stats[key], key


def test_drain_reports_a_shed_request_done_with_its_error():
    eng = _engine()
    with tdeadline.scope(_past()):
        rid = eng.submit(PROMPT)
    with torch.no_grad():
        eng._admit()
    out = eng.drain(rid)
    assert out["done"] and out["error"] == "deadline exceeded"
    assert out["tokens"] == [] and out["request_id"] == rid
    assert out["queue_wait_s"] is None
    assert eng.drain(rid)["error"] == "unknown request"


def test_requests_without_a_deadline_run_as_before():
    """No deadline and a deadline far ahead: the same greedy tokens and the
    same counters (deadlines that do not pass change nothing), and
    ``shed_expired`` stays 0."""
    runs = []
    for dl in (None, time.time() + 3600.0):
        eng = _engine(max_batch_size=2, prefill_chunk=32)
        try:
            with tdeadline.scope(dl):
                outs = _serve(eng, WAVE)
            stats = dict(eng.stats)
        finally:
            eng.shutdown()
        assert all(o["error"] is None for o in outs)
        stats.pop("compile_s")
        runs.append(([o["tokens"] for o in outs], stats))
    assert runs[0] == runs[1]
    assert runs[0][1]["shed_expired"] == 0
    assert runs[0][1]["requests"] == len(WAVE)
