"""The engine's prefill and chunk programs (``ray_torch/serve/llm/engine.py``
``_prompt_programs``) and the prompt passes they capture
(``ray_torch/serve/llm/kv_cache.py`` ``paged_prefill`` /
``paged_prefill_chunk`` with ``start`` and ``true_len`` as [1] device
tensors), on the CPU, llama_tiny fp32, gather backend.

A captured graph reads its scalars from device tensors at every replay, so
the tensor forms must equal the int forms bit for bit and match the JAX
package at op level (the tolerances of ``tests/test_torch_kv_cache.py``).
CUDA graphs exist only on the card: here a stand-in for ``_CudaGraphs``
reruns each program's body at every replay and copies its result into one
fixed output tensor, as a graph writes its static output, so the engine's
graph path (static inputs filled in place, the token cloned behind the
replay) runs and is held to the graphs-off engine. ``chip_smoke.py``
holds the captures on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.serve.llm import kv_cache as jkv
from ray_torch.models import llama as tllama
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import engine as engine_mod
from ray_torch.serve.llm import kv_cache as tkv

PAGE = 8
NUM_PAGES = 24
TABLE = np.asarray([1, 2, 3, 4, 5, 0, 0, 0], np.int32)
SHARED = "the quick brown fox jumps over the lazy dog"   # 5 full pages
SAME_BUCKET = ["abc", "hello there", "zq"]   # one 16-token bucket
LONG = SHARED + " and keeps running far past the fence"  # 3 chunks + 1


def _i32(x):
    return torch.tensor([x], dtype=torch.int32)


def _tiny():
    cfg = tllama.llama_tiny(vocab_size=512)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _pools(cfg, params, seed):
    """Two equal pools holding a 16-token cached prefix on pages 1-2."""
    rs = np.random.RandomState(seed)
    pool = tkv.init_paged_cache(cfg, NUM_PAGES, PAGE, "cpu")
    toks = torch.from_numpy(rs.randint(0, 512, (1, 16))).long()
    tkv.paged_prefill(params, pool, torch.from_numpy(TABLE), toks, 16, cfg,
                      PAGE)
    return pool, {k: v.clone() for k, v in pool.items()}, rs


@pytest.mark.parametrize("true_len", [13, 16])
def test_prefill_tensor_scalar_equals_int_form(true_len):
    cfg, params = _tiny()
    a, b, rs = _pools(cfg, params, 0)
    toks = torch.from_numpy(rs.randint(0, 512, (1, 16))).long()
    table = torch.from_numpy(np.asarray([6, 7, 0, 0, 0, 0, 0, 0], np.int32))
    want = tkv.paged_prefill(params, a, table, toks, true_len, cfg, PAGE)
    got = tkv.paged_prefill(params, b, table, toks, _i32(true_len), cfg,
                            PAGE)
    assert torch.equal(got, want)
    assert all(torch.equal(a[n], b[n]) for n in ("k", "v"))


@pytest.mark.parametrize("start, true_len", [
    (0, 40),     # a first chunk over the cached pages' slots
    (16, 40),    # past the cached prefix, full
    (32, 40),    # padded final chunk: 8 real tokens of 16
])
def test_chunk_tensor_scalars_equal_int_forms(start, true_len):
    cfg, params = _tiny()
    a, b, rs = _pools(cfg, params, 1)
    toks = torch.from_numpy(rs.randint(0, 512, (1, 16))).long()
    table = torch.from_numpy(TABLE)
    want = tkv.paged_prefill_chunk(params, a, table, toks, start, true_len,
                                   cfg, PAGE)
    got = tkv.paged_prefill_chunk(params, b, table, toks, _i32(start),
                                  _i32(true_len), cfg, PAGE)
    assert torch.equal(got, want)
    assert all(torch.equal(a[n], b[n]) for n in ("k", "v"))


def test_tensor_scalar_forms_match_jax():
    """A 13-token prefill, then a 40-token prompt chunked over a 16-token
    prefix: chunk [16, 32) and the padded final chunk [32, 48). Logits at
    1e-4 and pools at 1e-5, as tests/test_torch_kv_cache.py states."""
    cfg, jcfg = tllama.llama_tiny(vocab_size=512), jllama.llama_tiny(
        vocab_size=512)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu")
    tpool = tkv.init_paged_cache(cfg, NUM_PAGES, PAGE, "cpu")
    jpool = jkv.init_paged_cache(jcfg, NUM_PAGES, PAGE)
    rs = np.random.RandomState(2)

    def check(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    short = np.asarray([6, 7, 0, 0, 0, 0, 0, 0], np.int32)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = rs.randint(0, 512, 13)
    want, jpool = jkv.paged_prefill(jp, jpool, jnp.asarray(short),
                                    jnp.asarray(toks), jnp.int32(13), jcfg,
                                    PAGE)
    check(tkv.paged_prefill(params, tpool, torch.from_numpy(short),
                            torch.from_numpy(toks).long(), _i32(13), cfg,
                            PAGE), want)
    prompt = rs.randint(0, 512, 40)
    first = np.asarray(prompt[None, :16], np.int32)
    _, jpool = jkv.paged_prefill(jp, jpool, jnp.asarray(TABLE),
                                 jnp.asarray(first), jnp.int32(16), jcfg,
                                 PAGE)
    tkv.paged_prefill(params, tpool, torch.from_numpy(TABLE),
                      torch.from_numpy(first).long(), 16, cfg, PAGE)
    for start in (16, 32):
        chunk = np.zeros((1, 16), np.int32)
        seg = prompt[start:start + 16]
        chunk[0, :len(seg)] = seg
        want, jpool = jkv.paged_prefill_chunk(
            jp, jpool, jnp.asarray(TABLE), jnp.asarray(chunk),
            jnp.int32(start), jnp.int32(40), jcfg, PAGE)
        check(tkv.paged_prefill_chunk(
            params, tpool, torch.from_numpy(TABLE),
            torch.from_numpy(chunk).long(), _i32(start), _i32(40), cfg,
            PAGE), want)
    for name in ("k", "v"):
        w, g = np.asarray(jpool[name]), tpool[name].numpy()
        np.testing.assert_array_equal(g != 0, w != 0)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine's graph path on the CPU
# ---------------------------------------------------------------------------


class _StandInGraphs:
    """``_CudaGraphs`` on the CPU. A capture runs the body once on the warm
    inputs and keeps that result as the program's fixed output; a replay
    reruns the body on the static inputs and copies its result into that
    output, as a graph's replay writes its static output. Records the
    signature of each replay."""

    def __init__(self, eng):
        self._eng = eng
        self.captures = 0
        self.replays = []

    def capture(self, prog, body, warm):
        prog.graph, prog.out = body, body(*warm)
        self.captures += 1

    def replay(self, prog):
        prog.out.copy_(prog.graph(*prog.inputs))
        sig = next((s for s, p in {**self._eng._programs,
                                   **self._eng._prompt_programs}.items()
                    if p is prog), None)
        self.replays.append(sig)
        return prog.out


class _CopyingFetch(engine_mod._Fetch):
    """``_Fetch`` as on the card, where the sampled tokens are copied out
    right behind the dispatch (on the CPU it keeps the tensor itself,
    which a later replay of the same stand-in program would overwrite)."""

    def __init__(self, dev):
        super().__init__(dev.clone())


def _config():
    return TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                   device="cpu", max_batch_size=4, page_size=PAGE,
                   num_pages=64, max_prompt_len=64, max_seq_len=128,
                   prefill_chunk=16, max_tokens=8)


def _serve(graphs: bool, params):
    """One engine (with the stand-in when ``graphs``) serves the three
    same-bucket prompts and the long chunked one, all admitted in one pass
    (submitted before the loop starts), then a prefix hit whose suffix
    chunk-prefills."""
    eng = TEngine(_config(), params=params, rng_seed=0)
    staged = []
    if graphs:
        eng._graphs = _StandInGraphs(eng)
        stage = eng._stage
        eng._stage = lambda dst, v: (staged.append(id(dst)), stage(dst, v))
    try:
        rids = [eng.submit(p, temperature=0.0) for p in SAME_BUCKET + [LONG]]
        eng.start()
        toks = [eng.result(r, timeout=120.0)["tokens"] for r in rids]
        toks.append(eng.generate(SHARED + " once more",
                                 temperature=0.0)["tokens"])
    finally:
        eng.shutdown()
    return eng, toks, staged


@pytest.fixture(scope="module")
def served():
    params = tllama.init_params(tllama.llama_tiny(vocab_size=512),
                                torch.Generator().manual_seed(7), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "_Fetch", _CopyingFetch)
        return {"off": _serve(False, params), "on": _serve(True, params)}


def test_prompt_graph_path_matches_graphs_off(served):
    """Greedy tokens identical to the graphs-off engine: same-bucket
    prefills, a chunked prompt and a prefix-hit suffix chunk."""
    (eng_on, on, _), (eng_off, off, _) = served["on"], served["off"]
    assert all(len(t) == 8 for t in off)
    assert on == off
    assert eng_on.engine_stats()["prefix_hits"] >= 1
    assert eng_on.engine_stats()["attn_chunk_dispatches"] >= 5
    assert eng_off._prompt_programs == {}


def test_same_bucket_prompts_keep_their_own_first_tokens(served):
    """Three prefills of one bucket replay before any decode dispatch reads
    their tokens; each slot decodes from its own first token (a token left
    aliasing the graph's output would carry the last prompt's)."""
    eng, on, _ = served["on"]
    off = served["off"][1]
    replays = eng._graphs.replays
    first = replays.index(("prefill", 16))
    assert replays[first:first + 3] == [("prefill", 16)] * 3
    firsts = [t[0] for t in off[:3]]
    assert len(set(firsts)) == 3
    assert [t[0] for t in on[:3]] == firsts and on[:3] == off[:3]


def test_one_prompt_program_per_signature_outside_programs(served):
    """One prompt program per prefill bucket and chunk length met, each made
    at first use inside compile_scope, none in ``_programs``; their inputs
    are filled in place and never through ``_stage``."""
    eng, _, staged = served["on"]
    prompt = eng._prompt_programs
    seen = {s for s in eng._prof._seen if s[0] in ("prefill", "chunk")}
    assert set(prompt) == seen == {("prefill", 16), ("chunk", 16)}
    assert all(s[0] in ("decode", "verify") and len(s) == 3
               for s in eng._programs)
    assert eng._graphs.captures == len(eng._programs) + len(prompt)
    assert [tuple(x.shape) for x in prompt[("prefill", 16)].inputs] == [
        (1, 16), (eng.max_pages_per_seq,), (1,), (1,)]
    assert [tuple(x.shape) for x in prompt[("chunk", 16)].inputs] == [
        (1, 16), (eng.max_pages_per_seq,), (1,), (1,), (1,)]
    assert eng._graphs.replays.count(("chunk", 16)) \
        == eng.engine_stats()["attn_chunk_dispatches"]
    prompt_inputs = {id(x) for p in prompt.values() for x in p.inputs}
    assert staged and not prompt_inputs & set(staged)
    assert int(eng._sl_dev[-1]) == 0
