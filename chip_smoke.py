#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each of which raises on failure (nothing is caught and carried on):

1. device: the card's name and power limit; the CUDA kernels built from the
   sources in this checkout (one ``nvcc`` per source, started together);
2. every kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, in bf16 and fp32, then timed (CUDA events) beside
   its bound and the plain version's time;
3. greedy identity: ``LLMEngine`` on llama_tiny in fp32 through the kernel
   and through the gather path must produce identical tokens;
4. the main path at full width: ``LLMServer`` serving llama3_1b (bf16,
   random weights from a seeded generator) at the serve bench's engine
   settings answers completions, some concurrent, through the kernel; every
   kernel's launch counter is zeroed just before and read just after. Then
   one decode step's logits through the kernel and through the gather path.

Prints numbers on earlier lines, then a ``{"kernels": [...]}`` line, then
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # tests/test_paged_kernels.py


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: paged attention against its plain version
# ---------------------------------------------------------------------------

def paged_case(b, t, dtype, *, seed, base=None, limit=None, hkv=8, n_rep=2,
               d=128, page=128, max_pages=16):
    """Slice shapes (Hkv=8, n_rep=2, D=128, page=128, max_pages=16) with
    ragged bases, permuted page tables and limits below the table span."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    max_len = max_pages * page
    pool = b * max_pages + 1
    q = torch.randn(b, t, hkv * n_rep, d, generator=g, device=dev).to(dtype)
    k = torch.randn(hkv, pool, page, d, generator=g, device=dev).to(dtype)
    v = torch.randn(hkv, pool, page, d, generator=g, device=dev).to(dtype)
    pt = (torch.randperm(b * max_pages, generator=g, device=dev)
          .reshape(b, max_pages) + 1).to(torch.int32)
    if base is None:
        base = torch.randint(0, max_len - t - 64, (b,), generator=g,
                             device=dev)
    if limit is None:
        limit = base + max(1, t - 2) + torch.randint(
            0, 64, (b,), generator=g, device=dev)
    return dict(q=q, k=k, v=v, pt=pt, base=base.to(torch.int32),
                limit=limit.to(torch.int32), sm=d ** -0.5)


def paged_bound(c) -> tuple[float, str]:
    """Least time for the work these inputs need on an H100: each input
    byte the function must read once (q, the LIVE K/V columns of each
    slot, tables) and the output written once, over 3.35 TB/s; against
    4 * D flop per (query row, live key) over the dtype's peak."""
    q, k = c["q"], c["k"]
    b, t, h, d = q.shape
    hkv, page, max_pages = k.shape[0], k.shape[2], c["pt"].shape[1]
    max_len = max_pages * page
    rows = c["base"].long()[:, None] + torch.arange(t, device=q.device) + 1
    valid = torch.minimum(rows, c["limit"].long()[:, None]).clamp(0, max_len)
    live = valid.max(dim=1).values                       # keys read per slot
    item = q.element_size()
    nbytes = (2 * q.numel() * item                       # q in, out
              + 2 * int(live.sum()) * hkv * d * item     # live K and V
              + c["pt"].numel() * 4 + 2 * b * 4)
    flops = 4 * d * h * int(valid.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int = 25, per_rep: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``per_rep``
    back-to-back calls, between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def phase_kernels(card: str):
    from ray_torch.ops import paged_attention as pa

    def check(name, got, want, dtype):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= TOL[dtype] * (1 + want.float().abs())).all())
        log(f"  {name:<34} {str(dtype):<15} max_abs_err={err:.3e} "
            f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"paged attention kernel disagrees with "
                                 f"its plain version: {name} {dtype}")
        return err

    cases = {}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, seed in ((1, 1), (32, 2)):
            c = paged_case(b, 1, dtype, seed=seed)
            got = pa.paged_decode_attention(
                c["q"][:, 0], c["k"], c["v"], c["pt"], c["base"],
                sm_scale=c["sm"])
            want = pa.paged_attention_reference(
                c["q"], c["k"], c["v"], c["pt"], c["base"],
                torch.full_like(c["base"], 16 * 128), sm_scale=c["sm"])[:, 0]
            errs[("decode", b, dtype)] = check(f"decode B={b}", got, want,
                                               dtype)
            cases[("decode", b, dtype)] = c
        c = paged_case(8, 5, dtype, seed=3)
        got = pa.paged_verify_attention(c["q"], c["k"], c["v"], c["pt"],
                                        c["base"], sm_scale=c["sm"])
        want = pa.paged_attention_reference(
            c["q"], c["k"], c["v"], c["pt"], c["base"],
            torch.full_like(c["base"], 16 * 128), sm_scale=c["sm"])
        errs[("verify", 8, dtype)] = check("verify B=8 T=5", got, want, dtype)
        base = torch.tensor([512], device="cuda")
        limit = torch.tensor([900], device="cuda")
        c = paged_case(1, 512, dtype, seed=4, base=base, limit=limit)
        got = pa.paged_chunk_attention(c["q"], c["k"], c["v"], c["pt"][0],
                                       512, 900, sm_scale=c["sm"])
        want = pa.paged_attention_reference(
            c["q"], c["k"], c["v"], c["pt"], c["base"], c["limit"],
            sm_scale=c["sm"])
        errs[("chunk", 512, dtype)] = check("chunk C=512 start=512 len=900",
                                            got, want, dtype)
        cases[("chunk", 512, dtype)] = c
        # the same kernel on its recompute path (a table span too long to
        # keep even one row's scores in shared memory), at D=256
        c = paged_case(2, 3, dtype, seed=5, d=256, max_pages=336,
                       hkv=2, n_rep=4)
        got = pa.paged_attention(c["q"], c["k"], c["v"], c["pt"], c["base"],
                                 c["limit"], sm_scale=c["sm"])
        want = pa.paged_attention_reference(
            c["q"], c["k"], c["v"], c["pt"], c["base"], c["limit"],
            sm_scale=c["sm"])
        assert not pa.launch_plan(12, 256, 336 * 128)[1]
        check("recompute path D=256 span=43008", got, want, dtype)

    timings = []
    for kind, key in (("decode", ("decode", 32, torch.bfloat16)),
                      ("chunk", ("chunk", 512, torch.bfloat16))):
        c = cases[key]
        limit = c["limit"] if kind == "chunk" else torch.full_like(
            c["base"], 16 * 128)

        def kernel(c=c, limit=limit):
            return pa.paged_attention(c["q"], c["k"], c["v"], c["pt"],
                                      c["base"], limit, sm_scale=c["sm"])

        def plain(c=c, limit=limit):
            return pa.paged_attention_reference(
                c["q"], c["k"], c["v"], c["pt"], c["base"], limit,
                sm_scale=c["sm"])

        bc = dict(c, limit=limit)
        bound, bound_by = paged_bound(bc)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        live = int(torch.minimum(c["base"] + c["q"].shape[1],
                                 limit).sum())
        log(f"  time {kind:<6} B={c['q'].shape[0]} T={c['q'].shape[1]} "
            f"bf16 live_keys={live}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
            "library: none (no single PyTorch call attends through a "
            f"page table) [{card}]")
        timings.append({"name": f"paged_attention/{kind}", "route": "cuda",
                        "source": "ray_torch/ops/csrc/paged_attention.cu",
                        "replaces": "ray_tpu/ops/paged_attention.py:77",
                        "max_abs_err": errs[key], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": None})
    return timings


# ---------------------------------------------------------------------------
# phase 3: greedy identity, kernel vs gather, llama_tiny fp32
# ---------------------------------------------------------------------------

def phase_identity():
    from ray_torch.models import llama
    from ray_torch.serve.llm import LLMConfig, LLMEngine

    mcfg = llama.llama_tiny(vocab_size=512)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = llama.init_params(mcfg, gen, "cuda")
    shared = "the quick brown fox jumps over the lazy dog"  # 5 full pages
    waves = [[shared + " and keeps running far past the fence",  # > chunk
              "abc abc abc", "hello"],
             [shared + " once more"]]                        # prefix hit
    outs = {}
    for kernel in ("cuda", "gather"):
        eng = LLMEngine(LLMConfig(
            model_config=mcfg, device="cuda", attention_kernel=kernel,
            max_batch_size=4, page_size=8, num_pages=64, max_prompt_len=64,
            max_seq_len=128, prefill_chunk=16, max_tokens=16), params=params)
        eng.start()
        try:
            toks = []
            for wave in waves:
                rids = [eng.submit(p, temperature=0.0) for p in wave]
                res = [eng.result(r, timeout=300.0) for r in rids]
                for r in res:
                    if r["error"] is not None:
                        raise RuntimeError(f"{kernel} engine: {r['error']}")
                toks += [r["tokens"] for r in res]
            stats = eng.engine_stats()
        finally:
            eng.shutdown()
        assert stats["attention_backend"] == kernel, stats["attention_backend"]
        assert stats["prefix_hits"] >= 1 and stats["attn_chunk_dispatches"] > 0
        outs[kernel] = toks
    if outs["cuda"] != outs["gather"]:
        raise AssertionError(f"greedy tokens differ: kernel {outs['cuda']} "
                             f"vs gather {outs['gather']}")
    log(f"  llama_tiny fp32: {len(outs['cuda'])} requests, "
        f"{sum(map(len, outs['cuda']))} greedy tokens identical "
        "(kernel vs gather; prefix hit + chunked prefill on the path)")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def device_profile(run):
    """Run ``run()`` under torch.profiler (CUDA activity only, to keep the
    host overhead low) and summarize the kernels: total device time, its
    share of the wall time, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled wave: wall {1e3 * wall:.1f} ms, kernels "
        f"{busy_ms:.1f} ms = device busy {100 * busy_ms / (1e3 * wall):.1f}%"
        f" of the wall ({sum(e.count for e in kernels)} launches)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def phase_serve(card: str):
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMConfig, LLMServer

    max_tokens = 32
    # the serve bench's llama3-1b engine settings (bench_serve.py)
    cfg = LLMConfig(
        model_id="llama3-1b", model_config=llama.llama3_1b(max_seq_len=2048),
        device="cuda", max_batch_size=32, page_size=128, num_pages=288,
        max_prompt_len=1024, max_seq_len=2048, decode_block=8,
        pipeline_depth=3, pressure_decode_block=2, max_tokens=max_tokens)
    word = "the quick brown fox jumps over the lazy dog "
    shared = (word * 12)[:511]              # + BOS = 512 tokens = 4 pages
    wave1 = [f"request {i}: " + word * 3 for i in range(6)]
    wave1 += [(word * 21)[:899],            # ~900 tokens: chunked prefill
              shared + " first suffix that differs"]
    wave2 = [shared + " second suffix, a prefix hit",
             "request 6: " + word]
    wave3 = [f"request {i}: " + word * 3 for i in range(7, 15)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0                         # count the main path only
    t0 = time.perf_counter()
    srv = LLMServer(cfg, rng_seed=0)
    setup_s = time.perf_counter() - t0
    try:
        results = []
        walls = []
        with concurrent.futures.ThreadPoolExecutor(len(wave1)) as pool:
            def serve(wave):
                return list(pool.map(lambda p: srv.completions(
                    {"prompt": p, "max_tokens": max_tokens,
                     "temperature": 0.0}), wave))

            for wave in (wave1, wave2):
                t0 = time.perf_counter()
                results += serve(wave)
                walls.append(time.perf_counter() - t0)
            # where a wave's time goes, outside the timed waves
            device_profile(lambda: results.extend(serve(wave3)))
        stats = srv.engine_stats()
    finally:
        srv.shutdown()
    launches = pa.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    for r in results:
        if r.get("error") or r["usage"]["completion_tokens"] != max_tokens:
            raise AssertionError(f"request {r['ray_tpu']['request_id']} "
                                 f"returned {r['usage']} {r.get('error')}")
    if stats["attention_backend"] != "cuda":
        raise AssertionError(f"backend {stats['attention_backend']}")
    for key in ("attn_decode_dispatches", "attn_chunk_dispatches",
                "prefix_hits"):
        if not stats[key] > 0:
            raise AssertionError(f"engine_stats {key}={stats[key]}")
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    ttfts = [r["ray_tpu"]["ttft_s"] for r in results[:10]]
    decode_rates = [(max_tokens - 1)
                    / max(r["ray_tpu"]["latency_s"] - ttft, 1e-9)
                    for r, ttft in zip(results, ttfts)]
    out_tokens = sum(r["usage"]["completion_tokens"] for r in results[:8])
    log(f"  llama3_1b bf16 ({llama.num_params(cfg.model_config) / 1e9:.3f}B "
        f"params), {len(results)} requests x {max_tokens} tokens [{card}]")
    log(f"  engine build + warmup {setup_s:.2f} s")
    log(f"  TTFT p50 {1e3 * statistics.median(ttfts):.1f} ms, max "
        f"{1e3 * max(ttfts):.1f} ms (900-token prompt: "
        f"{1e3 * ttfts[6]:.1f} ms, prefix hit: {1e3 * ttfts[8]:.1f} ms) "
        f"[{card}]")
    log(f"  decode tokens/s per request p50 "
        f"{statistics.median(decode_rates):.1f}; wave of 8 concurrent: "
        f"{out_tokens} tokens in {walls[0]:.3f} s = "
        f"{out_tokens / walls[0]:.1f} output tokens/s [{card}]")
    log(f"  engine phases p50: decode_dispatch "
        f"{stats['phase_decode_dispatch_p50_ms']} ms, harvest "
        f"{stats['phase_harvest_p50_ms']} ms, prefill "
        f"{stats['phase_prefill_p50_ms']} ms, chunk_prefill "
        f"{stats['phase_chunk_prefill_p50_ms']} ms")
    log(f"  peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
        f"[{card}]")
    log(f"  kernel launches on the main path: {launches}; engine "
        f"decode blocks {stats['attn_decode_dispatches']}, chunks "
        f"{stats['attn_chunk_dispatches']}, prefix hits "
        f"{stats['prefix_hits']}, steps {stats['steps']}")
    return srv.engine.params, launches


def _cast(tree, dtype):
    """Weights in ``dtype``; the fp32 norms stay fp32."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.float32 else tree.to(dtype)


def phase_logits(params):
    """One decode step over 4 slots through the kernel and through the
    gather path, from the same prefilled pool, in bf16 and in fp32.

    The two paths differ only in the order attention's fp32 partial sums
    are taken. Tolerance |kernel - gather| <= tol * (1 + |gather|):
    - bf16, tol 6.25e-2: an attention output can then differ by one bf16
      rounding (2^-8 relative) per layer; 16 layers give 16 * 2^-8;
    - fp32, tol 1e-3: attention outputs agree to ~1e-6 (phase 2), and 16
      layers of random weights amplify that by far less than 1e3."""
    from ray_torch.models import llama
    from ray_torch.serve.llm import kv_cache as kvc

    page, max_pages = 128, 8
    lens = [100, 300, 517, 1000]
    tables = torch.arange(1, 4 * max_pages + 1, dtype=torch.int32,
                          device="cuda").reshape(4, max_pages)
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.bfloat16, 6.25e-2), (torch.float32, 1e-3)):
        mcfg = llama.llama3_1b(max_seq_len=2048, dtype=dtype)
        weights = _cast(params, dtype)
        pool = kvc.init_paged_cache(mcfg, 4 * max_pages + 1, page, "cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        first = []
        for i, n in enumerate(lens):
            bucket = 1 << (n - 1).bit_length()
            toks = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
            toks[0, :n] = torch.randint(0, 32000, (n,), generator=g,
                                        device="cuda")
            logits = kvc.paged_prefill(weights, pool, tables[i], toks, n,
                                       mcfg, page)
            first.append(logits.argmax())
        tokens = torch.stack(first)
        out = {}
        for kernel in ("cuda", "gather"):
            kv = {k: v.clone() for k, v in pool.items()}
            out[kernel], _ = kvc.paged_decode_step(
                weights, kv, tables, seq, tokens, mcfg, page, kernel)
        torch.cuda.synchronize()
        diff = (out["cuda"] - out["gather"]).abs()
        ok = bool((diff <= tol * (1 + out["gather"].abs())).all())
        same = int((out["cuda"].argmax(-1) == out["gather"].argmax(-1))
                   .sum())
        log(f"  decode-step logits {str(dtype):<14} 4 slots at {lens} "
            f"tokens: max |kernel - gather| {float(diff.max()):.4e} (max "
            f"|logit| {float(out['gather'].abs().max()):.3f}, tol {tol} * "
            f"(1 + |ref|)); argmax equal in {same}/4 rows")
        if not ok:
            raise AssertionError(f"kernel and gather decode logits disagree "
                                 f"in {dtype}")
        del weights, pool, kv, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from ray_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1] device {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'already built'})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    log("[2] kernels vs plain versions")
    t0 = time.perf_counter()
    kernels = phase_kernels(card)
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    log("[3] greedy identity, kernel vs gather")
    t0 = time.perf_counter()
    phase_identity()
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")

    log("[4] main path: LLMServer, llama3_1b at full width")
    t0 = time.perf_counter()
    params, launches = phase_serve(card)
    phase_logits(params)
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    for k in kernels:
        k["launches"] = launches
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
