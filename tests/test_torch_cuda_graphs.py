"""The engine's decode and verify programs (``ray_torch/serve/llm/engine.py``
``_Program``, ``_CudaGraphs``) on the CPU.

CUDA graphs exist only on the card, so here ``cuda_graphs`` resolves to off
and the same static-input path runs eagerly: every decode (width, block)
and verify width signature gets its index vector (and drafts) once, and
every dispatch fills them in place. The launch bookkeeping that makes
``paged_attention.launches`` count graph replays is plain Python and is
held here; ``chip_smoke.py`` holds the captures and replays on the card.
"""

import pytest

from ray_torch.models import llama as tllama
from ray_torch.ops import paged_attention as paged_ops
from ray_torch.serve.llm import LLMConfig as TConfig
from ray_torch.serve.llm import LLMEngine as TEngine
from ray_torch.serve.llm import engine as engine_mod

PROMPTS = ["abc abc abc abc abc", "one two one two one two", "xyzzy"]


def _config(**kw):
    return TConfig(model_config=tllama.llama_tiny(vocab_size=512),
                   device="cpu", max_batch_size=2, page_size=8,
                   num_pages=32, max_prompt_len=64, max_seq_len=128,
                   max_tokens=12, spec_decode_enabled=True, **kw)


def _serve(eng, prompts):
    rids = [eng.submit(p, temperature=0.0) for p in prompts]
    eng.start()
    out = [eng.result(r, timeout=120.0) for r in rids]
    assert all(o["error"] is None for o in out)
    return out


def test_cuda_graphs_true_on_cpu_raises():
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        TEngine(_config(cuda_graphs=True))


@pytest.mark.parametrize("flag", [None, False])
def test_cuda_graphs_resolve_off_on_cpu(flag):
    eng = TEngine(_config(cuda_graphs=flag))
    assert eng._graphs is None


def test_static_inputs_made_once_per_signature_and_reused():
    """Warmup makes one program per decode (width, block) and verify width
    signature; traffic makes none and fills only those programs' inputs,
    in place. Padding lanes leave the trash row clean."""
    eng = TEngine(_config())
    staged = []
    stage = eng._stage
    eng._stage = lambda dst, values: (staged.append(dst), stage(dst, values))
    widths = {eng._bucket_width(n) for n in range(1, 3)}
    eng.start()                               # warms every signature
    progs = dict(eng._programs)
    tiers = {1, eng.cfg.pressure_decode_block, eng.cfg.spec_draft_len,
             eng.cfg.decode_block}
    assert set(progs) == ({("decode", w, k) for w in widths for k in tiers}
                          | {("verify", w, 4) for w in widths})
    inputs = {id(x): x for p in progs.values() for x in p.inputs}
    ptrs = {i: x.data_ptr() for i, x in inputs.items()}
    for (kind, w, k), prog in progs.items():
        assert prog.graph is None
        assert [tuple(x.shape) for x in prog.inputs] == (
            [(w,)] if kind == "decode" else [(w,), (w, k)])
    try:
        _serve(eng, PROMPTS)
    finally:
        eng.shutdown()
    stats = eng.engine_stats()
    assert stats["spec_rounds"] > 0 and stats["attn_decode_dispatches"] > 0
    assert eng._programs.keys() == progs.keys()
    assert all(eng._programs[sig] is p for sig, p in progs.items())
    assert staged and {id(x) for x in staged} <= set(inputs)
    assert {id(p.inputs[1]) for p in progs.values() if len(p.inputs) == 2} \
        & {id(x) for x in staged}
    assert {i: x.data_ptr() for i, x in inputs.items()} == ptrs
    assert int(eng._sl_dev[-1]) == 0
    assert not eng._pt_dev[-1].any()


def test_without_warmup_each_program_is_made_at_first_dispatch():
    """With warmup off a program is made at its signature's first dispatch,
    inside compile_scope, so it is counted as a mid-traffic first use."""
    eng = TEngine(_config(warmup_compile=False))
    try:
        _serve(eng, PROMPTS)
    finally:
        eng.shutdown()
    seen = {s for s in eng._prof._seen if s[0] in ("decode", "verify")}
    assert seen and set(eng._programs) == seen
    assert eng._prof.mid_traffic_compiles >= len(seen)
    assert int(eng._sl_dev[-1]) == 0


def test_replays_count_the_captured_launches(monkeypatch):
    """A capture's launches are taken back out of the counters (it launches
    nothing) and each replay adds them once."""
    counts = {"paged_decode_hopper": 5, "paged_chunk_hopper": 2,
              "paged_attention_kernel": 0}
    monkeypatch.setattr(paged_ops, "launches", counts)
    before = dict(counts)
    counts["paged_decode_hopper"] += 16     # what a capture counts
    delta = engine_mod._take_launches(before)
    assert delta == {"paged_decode_hopper": 16}
    assert counts == before
    for _ in range(3):
        engine_mod._add_launches(delta)
    assert counts == {"paged_decode_hopper": 5 + 3 * 16,
                      "paged_chunk_hopper": 2, "paged_attention_kernel": 0}
