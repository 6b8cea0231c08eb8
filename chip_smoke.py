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
4. the serving path at full width: ``LLMServer`` serving llama3_1b (bf16,
   random weights from a seeded generator) at the serve bench's engine
   settings answers completions, some concurrent, through the kernel; every
   kernel's launch counter is zeroed just before and read just after. Then
   one decode step's logits through the kernel and through the gather path;
5. the three flash-attention kernels against their plain versions on the
   card (bf16 and fp32, causal and not, at the training shapes and a small
   one; two backward runs bit-identical), then timed beside their bounds,
   the plain versions and ``scaled_dot_product_attention``;
6. the training path at full width: ``ray_torch.train.spmd`` trains
   llama3_1b (the repo's bench recipe: bf16, "dots" remat, one 2048-wide
   CE chunk kept, flash attention, adafactor, batch 4 x 2048) for 3 warmup
   and 5 timed steps from seeded random weights; every flash counter is
   zeroed just before and read just after;
7. the flash kernels against the dense path end to end: llama_tiny fp32
   (grads and three train steps) and one llama3_1b bf16 step.

Prints numbers on earlier lines, then a ``{"kernels": [...]}`` line, then
the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
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

def device_profile(run, top: int = 8):
    """Run ``run()`` under torch.profiler (CUDA activity only, to keep the
    host overhead low) and summarize the kernels: total device time, its
    share of the wall time, and the ``top`` kernels by device time."""
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
    log(f"  profiled run: wall {1e3 * wall:.1f} ms, kernels "
        f"{busy_ms:.1f} ms = device busy {100 * busy_ms / (1e3 * wall):.1f}%"
        f" of the wall ({sum(e.count for e in kernels)} launches)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
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


# ---------------------------------------------------------------------------
# phase 5: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_case(b, t, h, d, dtype, *, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
            for _ in range(4)]                      # q, k, v, dO


def flash_bound(shape, dtype, causal, products, tensors, stats):
    """Least time on an H100 for a function over [B, T, H, D] tensors:
    ``products`` matrix products of 2 * D flop per (query, key) pair that
    the function needs (T(T+1)/2 pairs a head when causal), against
    ``tensors`` [B, T, H, D] tensors and ``stats`` [B, H, T] fp32 rows,
    each read or written once."""
    b, t, h, d = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = products * 2 * d * pairs * b * h
    item = torch.finfo(dtype).bits // 8
    nbytes = tensors * b * t * h * d * item + stats * b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash(card: str):
    from ray_torch.ops import attention as fa

    def check(name, got, want, dtype):
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= TOL[dtype] * (1 + want.float().abs())).all())
        log(f"  {name:<44} {str(dtype):<15} max_abs_err={err:.3e} "
            f"(tol {TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version: {name} {dtype}")
        return err

    errs = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, h, d in ((4, 2048, 16, 128), (1, 256, 4, 64)):
            for causal in (True, False):
                q, k, v, do = flash_case(b, t, h, d, dtype, seed=t + causal)
                sm = d ** -0.5
                tag = f"B={b} T={t} H={h} D={d} causal={causal}"
                out, lse = fa.flash_fwd(q, k, v, causal, sm)
                want_out, want_lse = fa.flash_forward_reference(
                    q, k, v, causal, sm)
                torch.cuda.synchronize()
                e = max(check(f"fwd out {tag}", out, want_out, dtype),
                        check(f"fwd lse {tag}", lse, want_lse, dtype))
                errs["flash_fwd"] = max(errs["flash_fwd"], e)
                # both backward kernels on the forward kernel's outputs
                delta = fa.flash_delta(do, out)
                dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                           sm)
                dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sm)
                dk2, dv2 = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                             sm)
                dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, sm)
                want_dq, want_dk, want_dv = fa.flash_backward_reference(
                    q, k, v, do, lse, delta, causal, sm)
                torch.cuda.synchronize()
                errs["flash_bwd_dkdv"] = max(
                    errs["flash_bwd_dkdv"],
                    check(f"bwd dk {tag}", dk, want_dk, dtype),
                    check(f"bwd dv {tag}", dv, want_dv, dtype))
                errs["flash_bwd_dq"] = max(
                    errs["flash_bwd_dq"],
                    check(f"bwd dq {tag}", dq, want_dq, dtype))
                if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)
                        and torch.equal(dq, dq2)):
                    raise AssertionError(f"two backward runs differ: {tag}")
                del want_dq, want_dk, want_dv
    log("  two backward runs bit-identical in every case")

    # timings at the training shapes, bf16, causal
    shape = (4, 2048, 16, 128)
    q, k, v, do = flash_case(*shape, torch.bfloat16, seed=1)
    sm = shape[-1] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, sm)
    delta = fa.flash_delta(do, out)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = torch.ops.aten._scaled_dot_product_flash_attention(
        qh, kh, vh, 0.0, True, False, scale=sm)

    def lib_bwd():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            doh, qh, kh, vh, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5],
            0.0, True, lib[6], lib[7], scale=sm)

    # the library's backward computes what the pair computes
    ldq, ldk, ldv = lib_bwd()
    want_dq, want_dk, want_dv = fa.flash_backward_reference(
        q, k, v, do, lse, delta, True, sm)
    torch.cuda.synchronize()
    for name, got, want in (("dq", ldq, want_dq), ("dk", ldk, want_dk),
                            ("dv", ldv, want_dv)):
        err = float((got.transpose(1, 2).float() - want.float()).abs().max())
        log(f"  library backward {name} vs plain: max_abs_err={err:.3e}")
    del want_dq, want_dk, want_dv, ldq, ldk, ldv

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lleaves = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]

    def ours_fwd_bwd():
        fa.flash_attention(*leaves).backward(do)

    def lib_fwd_bwd():
        sdpa(*lleaves, is_causal=True).backward(doh)

    t = {
        "flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, True, sm)),
        "flash_bwd_dkdv": time_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, do, lse, delta, True, sm)),
        "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, True, sm)),
        "plain_fwd": time_ms(lambda: fa.flash_forward_reference(
            q, k, v, True, sm), reps=5, per_rep=2),
        "plain_bwd": time_ms(lambda: fa.flash_backward_reference(
            q, k, v, do, lse, delta, True, sm), reps=5, per_rep=2),
        "lib_fwd": time_ms(lambda: sdpa(qh, kh, vh, is_causal=True)),
        "lib_bwd": time_ms(lib_bwd),
        "ours_fwd_bwd": time_ms(ours_fwd_bwd),
        "lib_fwd_bwd": time_ms(lib_fwd_bwd),
    }
    bounds = {
        "flash_fwd": flash_bound(shape, torch.bfloat16, True, 2, 4, 1),
        "flash_bwd_dkdv": flash_bound(shape, torch.bfloat16, True, 4, 6, 2),
        "flash_bwd_dq": flash_bound(shape, torch.bfloat16, True, 3, 5, 2),
    }
    pair_bound, pair_by = flash_bound(shape, torch.bfloat16, True, 5, 7, 2)
    plain = {"flash_fwd": t["plain_fwd"], "flash_bwd_dkdv": t["plain_bwd"],
             "flash_bwd_dq": t["plain_bwd"]}
    library = {"flash_fwd": t["lib_fwd"], "flash_bwd_dkdv": t["lib_bwd"],
               "flash_bwd_dq": t["lib_bwd"]}
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:26",
                "flash_bwd_dkdv": "ray_tpu/ops/attention.py:120",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:172"}
    timings = []
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        bound, bound_by = bounds[name]
        log(f"  time {name:<15} B=4 T=2048 H=16 D=128 causal bf16: kernel "
            f"{t[name]:.4f} ms, plain {plain[name]:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), library {library[name]:.4f} ms "
            f"[{card}]")
        timings.append({"name": name, "route": "cuda",
                        "source": "ray_torch/ops/csrc/flash_attention.cu",
                        "replaces": replaces[name],
                        "max_abs_err": errs[name], "ms": t[name],
                        "plain_ms": plain[name], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library[name]})
    log(f"  time backward pair (dk/dv + dq): kernels "
        f"{t['flash_bwd_dkdv'] + t['flash_bwd_dq']:.4f} ms, bound "
        f"{pair_bound:.4f} ms ({pair_by}), plain {t['plain_bwd']:.4f} ms, "
        f"library backward {t['lib_bwd']:.4f} ms [{card}]")
    log(f"  time forward + backward through autograd: ours "
        f"{t['ours_fwd_bwd']:.4f} ms, scaled_dot_product_attention "
        f"{t['lib_fwd_bwd']:.4f} ms [{card}]")
    return timings


# ---------------------------------------------------------------------------
# phase 6: the training path at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def train_recipe(**kw):
    """bench.py's llama3_1b training recipe (``bench.py:146-150``)."""
    from ray_torch.models import llama
    from ray_torch.train import spmd

    cfg = llama.llama3_1b(max_seq_len=2048, remat_policy="dots",
                          ce_chunk=2048, ce_remat=False, attn_impl="flash")
    cfg = dataclasses.replace(cfg, **kw)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = spmd.default_optimizer(warmup_steps=10, decay_steps=1000,
                                 name="adafactor")
    state = spmd.create_state(params, opt)
    step = spmd.make_train_step(functools.partial(llama.loss_fn, cfg=cfg),
                                opt)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)
    return cfg, state, step, spmd.shard_batch({"tokens": tokens}, "cuda")


def phase_train(card: str):
    from ray_torch.models import llama
    from ray_torch.ops import attention as fa

    t0 = time.perf_counter()
    cfg, state, step, batch = train_recipe()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:                # count the main path only
        fa.launches[name] = 0
    warmup, timed = 3, 5
    losses, norms, times = [], [], []
    for _ in range(warmup + timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))     # the host read is the sync
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    # where one step's device time goes, outside the counted steps
    device_profile(lambda: step(state, batch), top=14)

    step_ms = 1e3 * statistics.median(times[warmup:])
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    n_params = llama.num_params(cfg)
    mfu = 6 * n_params * tokens_s / PEAK_FLOPS[torch.bfloat16]
    steps = warmup + timed
    log(f"  llama3_1b bf16 ({n_params / 1e9:.3f}B params), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, dots remat, flash, adafactor; state "
        f"built in {setup_s:.2f} s [{card}]")
    log(f"  step ms: {', '.join(f'{1e3 * x:.1f}' for x in times)} (first "
        f"{warmup} warmup); median of the timed {step_ms:.1f} ms [{card}]")
    log(f"  tokens/s {tokens_s:.1f}; MFU {mfu:.4f} (6 * params * tokens/s / "
        f"989 TFLOP/s, attention flops left out, as bench.py:208) [{card}]")
    log(f"  peak torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
        f"[{card}]")
    log(f"  loss per step: {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"  grad_norm per step: {', '.join(f'{x:.4f}' for x in norms)}")
    log(f"  flash launches over {steps} steps: "
        + ", ".join(f"{k} {v} ({v / steps:g}/step)"
                    for k, v in launches.items()))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if losses[1] != losses[0]:
        raise AssertionError(f"step 1's loss {losses[1]!r} differs from step "
                             f"0's {losses[0]!r}: the lr is 0 at count 0")
    log("  step 1's loss equals step 0's exactly (lr 0 at count 0)")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a flash kernel was not launched: {launches}")
    return launches, steps


# ---------------------------------------------------------------------------
# phase 7: the flash kernels against the dense path, end to end
# ---------------------------------------------------------------------------

def phase_flash_vs_dense():
    """llama_tiny fp32 (head_dim 16), flash kernels vs the dense path:
    every gradient of loss_fn at the initial weights, then three adamw
    steps' losses, to 1e-4 relative to (1 + |ref|) — the two paths differ
    only in the order fp32 sums are taken (and the dense path's rounding
    of q.k to fp32, a no-op). Then one llama3_1b bf16 step: the dense path
    rounds q.k to bf16 before the softmax and flash does not, so attention
    outputs differ by ~2^-8 relative; over 16 layers that moves a loss of
    ~11.8 (ln 128256) by far less than 1e-2, and the grad norm by far less
    than 5%."""
    from ray_torch.models import llama
    from ray_torch.train import spmd

    tiny = {impl: llama.llama_tiny(attn_impl=impl)
            for impl in ("dense", "flash")}
    g = torch.Generator(device="cuda").manual_seed(3)
    params = llama.init_params(tiny["dense"], g, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 65), dtype=np.int32)).cuda()
    grads = {}
    for impl, cfg in tiny.items():
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in llama.flatten_params(params).items()}
        loss = llama.loss_fn(llama.unflatten_params(leaves),
                             {"tokens": tokens}, cfg)
        grads[impl] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    worst = 0.0
    for name, want in grads["dense"].items():
        diff = (grads["flash"][name] - want).abs()
        worst = max(worst, float((diff / (1 + want.abs())).max()))
    log(f"  llama_tiny fp32 grads, flash vs dense: worst |diff|/(1+|ref|) "
        f"{worst:.3e} (tol 1e-4)")
    if worst > 1e-4:
        raise AssertionError("llama_tiny grads: flash and dense disagree")
    losses = {}
    for impl, cfg in tiny.items():
        opt = spmd.default_optimizer(warmup_steps=1, decay_steps=10)
        state = spmd.create_state(llama.unflatten_params(
            {k: v.clone() for k, v in llama.flatten_params(params).items()}),
            opt)
        step = spmd.make_train_step(functools.partial(llama.loss_fn, cfg=cfg),
                                    opt)
        losses[impl] = []
        for _ in range(3):
            state, m = step(state, {"tokens": tokens})
            losses[impl].append(float(m["loss"]))
    log(f"  llama_tiny fp32 three adamw steps: loss flash "
        f"{losses['flash']} vs dense {losses['dense']}")
    for a, b in zip(losses["flash"], losses["dense"]):
        if abs(a - b) > 1e-4 * (1 + abs(b)):
            raise AssertionError("llama_tiny train losses: flash and dense "
                                 "disagree")

    full = {}
    for impl in ("flash", "dense"):
        _, state, step, batch = train_recipe(attn_impl=impl)
        _, m = step(state, batch)
        full[impl] = (float(m["loss"]), float(m["grad_norm"]))
        del state, step, batch, m
        torch.cuda.empty_cache()
    (fl, fg), (dl, dg) = full["flash"], full["dense"]
    log(f"  llama3_1b bf16 one step: loss flash {fl:.6f} vs dense {dl:.6f} "
        f"(|diff| {abs(fl - dl):.2e}, tol 1e-2); grad_norm flash {fg:.5f} vs "
        f"dense {dg:.5f} ({100 * abs(fg - dg) / dg:.3f}%, tol 5%)")
    if abs(fl - dl) > 1e-2 or abs(fg - dg) > 0.05 * dg:
        raise AssertionError("llama3_1b: flash and dense steps disagree")


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
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches"] = launches
    del params
    torch.cuda.empty_cache()

    log("[5] flash-attention kernels vs plain versions")
    t0 = time.perf_counter()
    flash = phase_flash(card)
    log(f"  phase 5: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[6] main path: ray_torch.train.spmd, llama3_1b at full width")
    t0 = time.perf_counter()
    train_launches, _ = phase_train(card)
    for k in flash:
        k["launches"] = train_launches[k["name"]]
    log(f"  phase 6: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[7] flash kernels vs the dense path, end to end")
    t0 = time.perf_counter()
    phase_flash_vs_dense()
    log(f"  phase 7: {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": kernels + flash}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
