#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases, each of which raises on failure (nothing is caught and carried on):

1. device: the card's name and power limit; the CUDA kernels built from the
   sources in this checkout (one ``nvcc`` per source, started together),
   each kernel's registers and spills (a Hopper kernel that spills fails);
2. the three paged-attention kernels against their plain PyTorch version
   on the card, at the shapes the main path gives them, in bf16 and fp32,
   each launch checked to take the kernel ``paged_attention.route`` plans
   (bf16 decode and verify: ``paged_decode_hopper``; bf16 prefill chunks:
   ``paged_chunk_hopper``, at ragged chunk lengths, first chunks, pages of
   8, 16, 32 and 128, n_rep 1, 2 and 4 and a slot with no live key, two
   runs bit-identical; fp32 and D=256: ``paged_attention_kernel``), then
   timed (CUDA events, and device time by the profiler) beside the bound
   and the plain version: decode B=32, the speculative serving path's
   verify at W=32, T=spec_draft_len+1, and chunks;
3. greedy identity: ``LLMEngine`` on llama_tiny in fp32 through the kernel
   with CUDA graphs on and off, through the gather path and through the
   kernel with speculative decoding on, graphs on and off, must produce
   identical tokens, over a chunked prompt, a prefix-hit suffix chunk and
   four prompts of one prefill bucket admitted in one pass (with graphs on
   each replays the bucket's graph before a decode dispatch reads their
   first tokens); with graphs on, one prefill or chunk graph per
   signature met; each kernel run's launches (all on
   ``paged_attention_kernel``, counted through graph replays and chunk
   captures' warm runs) must equal the plan its stats imply, and the spec
   runs must run verify rounds.
   Then sampling at temperature 1.0: one decode graph replayed twice on
   the same inputs must draw different tokens, and two engines from one
   seed the same stream;
4. the serving path at full width: ``LLMServer`` serving llama3_1b (bf16,
   random weights from a seeded generator) at the serve bench's engine
   settings answers completions, some concurrent, through the kernels,
   with CUDA graphs on and then off on the same weights, in four waves
   (the fourth wave 1's prompt lengths in fresh text, so that with graphs
   on every prefill and chunk graph it needs was captured before); in
   each arm every launch counter is zeroed once the engine has started
   and read after the waves: the launches must be the plan of its stats
   (every prefill chunk on ``paged_chunk_hopper``, every decode step on
   ``paged_decode_hopper``, none on ``paged_attention_kernel``). Per arm:
   TTFT (and the fourth wave's), ITL, the wave's tokens/s, the profiled
   wave's device busy share, launches and ``cudaGraphLaunch`` calls,
   warmup seconds, the prompt captures by kind with each first use's ms,
   the prefill and chunk phases' host ms, the graphs' pool bytes and how
   long one replay holds the host; how many requests' tokens the arms
   share. Attribution, per arm: every completion's ``ray_tpu.stages``
   must be ``queue``, ``prefill``, ``decode``, each starting where the
   one before ends, prefill's end the TTFT and decode's the latency
   (within 1 ms), prefilled tokens the prompt's less the cached ones, and
   wave 2's prefix hit must have cached the full pages it shares with
   wave 1; ``aggregate_report``'s per-stage p50 / p99 and the slowest
   decile's dominant stage are printed;
4b. speculative decoding on that path: ``LLMServer`` with
   ``spec_decode_enabled`` on and off, each with CUDA graphs on and off,
   then off again (the control), on phase 4's weights, streams one wave of
   8 concurrent greedy completions of 64 tokens (repetitive code and
   quoted text, one prompt past ``prefill_chunk``); every request must
   return its 64 tokens, verify rounds must run, and the launch counters
   (zeroed once each engine has started) must show every verify round and
   decode step on ``paged_decode_hopper`` (n_layers x (steps -
   spec_draft_len x verify rounds) launches) and none on
   ``paged_attention_kernel``; it prints the accept rate, tokens a slot
   and round, live slots a round, each run's output tokens/s, and how
   many requests' bf16 tokens are identical. The same wave in fp32 (every
   launch on ``paged_attention_kernel``) must give identical tokens with
   spec on (graphs on and off) and off. Then, from one prefilled pool in
   bf16 and in fp32, one decode step's logits through the kernel and
   through the gather path, one verify step's logits against as many
   sequential decode steps fed the same tokens, and both steps replayed
   from a captured CUDA graph against eager (reported bit for bit);
5. the three flash-attention kernels against their plain versions on the
   card (bf16 and fp32, causal and not, at the training shapes, a small
   D=64 one and a ragged T=200 with B=2, H=3 at D=128 and D=32; two
   backward runs bit-identical), then timed beside their bounds, the plain
   versions and ``scaled_dot_product_attention`` under each backend that
   takes the shape (the fastest is the ``library_ms`` yardstick); in bf16
   all three are the Hopper kernels (``attention.kernel_name``);
6. the training path at full width: ``ray_torch.train.spmd`` trains
   llama3_1b (the repo's bench recipe: bf16, "dots" remat, one 2048-wide
   CE chunk kept, flash attention, adafactor, batch 4 x 2048) for 3 warmup
   and 5 timed steps from seeded random weights; every flash counter is
   zeroed just before and read just after; one profiled step gives the
   flash kernels' share of the device time and must have run the Hopper
   kernel of each op and no other;
7. the flash kernels against the dense path end to end: llama_tiny fp32
   (grads and three train steps) and one llama3_1b bf16 step;
8. ``int8_matmul`` (``mlp_impl="int8"``) on the card, forward and
   backward, against the dequantized plain product at the training shape
   and at an 8-row decode shape; the card is asked which row counts
   ``torch._int_mm`` refuses, and the product must pad exactly those;
10. the KV tier at full width (run before phase 9): ``LLMServer`` serving
   llama3_1b bf16 with ``kv_tier_enabled`` and CUDA graphs on answers
   prompt A (~1,000 tokens, 7 full pages) cold, again while its prefix is
   resident, then two distinct prompts whose chains evict and spill A's
   (``prefix_cache_max_pages`` 8), then A once more, which restores its 7
   pages and chunk-prefills the suffix from the restored frontier, by
   replaying the chunk graph the resident run captured. The restored pool
   pages must equal A's cached pages bit for bit (lossless), its greedy
   tokens the resident run's, and its launches (counted from engine
   start) the plan of its stats. The same with no codec (raw
   pages, the same checks); one of A's pages encoded with int8 must be
   stored lossless (int8 quantizes numpy floating types only, as the
   reference's codec does); llama_tiny fp32 tier runs through the
   kernel against the gather path (tokens identical, cold and restored)
   and with int8 (error within half the group's scale / 127). Attribution:
   only the restored run has a ``restore`` stage, whose restored tokens
   and bytes are 7 pages' (bytes from the config), whose ``bytes_wire``
   is the sum of the payloads the store handed out, whose ``overlap_ms``
   is ``restore_ms`` less the loop-blocked ms and which is not partial.
   Prints the spill and restore times per page, the codec's, TTFT cold,
   resident and restored beside the restored run's stage split, the codec
   ratio and the tier's bytes;
11. request deadlines at full width (after phase 10, before phase 9;
   llama3_1b at the serve settings, CUDA graphs on, phase 4's weights):
   (a) in fp32, one wave of 24 prompts of 200-400 fresh tokens x 16
   tokens, 8 of them (every third) submitted under a deadline already
   past: the 8 must end with "deadline exceeded" and no token,
   ``shed_expired`` must be 8, the prefill and chunk counts those of the
   16 alone, whose greedy tokens on a fresh engine must equal the wave's,
   and the free pages (with the cached prefix pages) must come back;
   (b) driven by hand (``pump``, the loop not started): a ~900-token
   fp32 prompt whose deadline passes after its first chunk (a chunk
   graph replay) must give back its slot and pages at the next pass and
   its waiter "deadline exceeded" at once, and the same prompt served
   again on that engine a fresh engine's tokens; at phase 10's tier
   setup (bf16, lossless), A's deadline passes while it restores: its
   stream is aborted, slot and pages come back, and A served again
   still restores 7 pages and gives the resident run's tokens; (c) in
   bf16, 96 requests of 256 fresh tokens x 64 tokens at once onto the 32
   slots, without deadlines (D = their latency p50) and each under
   submit + D and under submit + 3D/4 (which sheds the third admission
   batch): finished, late, shed, dropped, goodput (the output tokens of
   requests finished by their deadline per second of wall), their TTFT
   p50 / p99 and how long a shed waiter waits past its deadline; only
   invariants are asserted there. Attribution: (a)'s shed requests have
   a lone ``queue`` stage (not admitted), its survivors whole waterfalls;
   (b)'s dropped requests the stages ``engine_stages`` gives for their
   fields (``queue``, admitted, and ``restore`` if pages had landed; no
   ``decode``); (c) prints each run's per-stage p50 / p99 and the
   dominant stage of its slowest decile;
12. failover continuations, the journal and spans at full width (after
   phase 11, before phase 9; llama3_1b at the serve settings, CUDA graphs
   on, phase 4's weights), on a 750-token prompt (5 full pages and 110
   tokens of a sixth) x 48 tokens, whose uninterrupted cache-off fp32 run
   is ``want``: (a) on a fresh cache-off engine (an ``LLMServer``'s),
   continuations at k = 1, 24, 47 must return want[k:], with
   ``failover_resumed`` 3 and ``failover_restored_tokens`` 0; the same in
   bf16 on its own uninterrupted run is reported, not held; (b) with the
   prefix cache on, the prompt and then its continuation at 24 (want[24:],
   at least the prompt's 640 full-page tokens restored); (c) with the KV
   tier on (raw pages, at most 8 cached pages, one page a restore chunk),
   a live request past 24 tokens: ``spill_inflight`` must spill the full
   pages its ``request_progress`` implies (within one page), 6, the sixth
   past the prompt; cancelled and evicted by two fresh prompts, its
   continuation at 24 restores all 6 from the tier and gives want[24:];
   evicted again, under the tier's chunk fault it restores 1 (partial)
   and still gives want[24:]; (d) the journal, through a local sink: one
   ``failover_resume`` per continuation with its request id and resume
   length, one ``restore_partial``, each engine's ``mid_traffic_compile``
   events equal to its ``mid_traffic_compiles`` and none from a warmup,
   nothing else; (e) with ``tracing_enabled`` in the port's config and a
   span flusher, the continuations at 1 and 24 submitted inside
   ``tracing.span("chip_smoke.client")`` give one ``llm.generate`` span
   each (the client's trace and parent ids, starting at the request's
   submit wall clock, lasting its ``latency_s`` within 1 ms, its token
   counts), the one at 47 outside a span none; (f) a server stream with a
   resume payload as a continuation (``resume_meta`` on its first chunk)
   and past ``failover_max_resumes`` as a retry that suppresses the first
   24 tokens: both streams' ``token_ids`` are want[24:]. Prints each
   continuation's TTFT beside the uninterrupted run's time to its k-th
   token, the eager spill's ms and the restore's ``restore_ms``;
9. phase 4b's bf16 wave once more with spec on and off, each with CUDA
   graphs on and off, each under the profiler: device busy share,
   launches, host calls (``cudaLaunchKernel`` and ``cudaGraphLaunch``, each
   with its host ms; ``cudaGraphLaunch`` must be called with graphs on,
   prefill and chunk programs included) and the decode route's device
   time (last, so that its large profiles share nothing with the kernel
   timings).

Prints numbers on earlier lines, then a ``{"kernels": [...]}`` line (each
row names the CUDA kernel it timed under ``kernel``; ``tier_launches`` is
its count in phase 10's lossless tier runs, ``deadline_launches`` in phase
11 and ``failover_launches`` in phase 12, its engines' warmups included),
then the card's name
and power limit, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # fp32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # tests/test_paged_kernels.py


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(text: str):
    """(kernel, registers, spill-store bytes, spill-load bytes) for each
    kernel of an ``nvcc -Xptxas -v`` log, the kernel named with its
    template arguments (``flash_fwd_hopper<128>``)."""
    out, kernel, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d((?:flash|paged)_"
                      r"\w+?)I(\w+?)E+v", line)
        if m:
            args = [{"f": "float", "13__nv_bfloat16": "bf16"}.get(
                        a.group(0), a.group(1))
                    for a in re.finditer(r"13__nv_bfloat16|Li(\d+)|f",
                                         m.group(2))]
            kernel = f"{m.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), *spill))
            kernel, spill = None, (0, 0)
    return out


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


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()``: the CUDA kernels (and memsets) it
    launches, summed by torch.profiler over ``reps`` calls, over reps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / reps


def phase_kernels(card: str):
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMConfig

    verify_t = LLMConfig().spec_draft_len + 1    # a verify round's span

    errs = {}                                  # max error, by kernel

    def check(name, got, want, dtype, kernel):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= TOL[dtype] * (1 + want.float().abs())).all())
        log(f"  {name:<44} {str(dtype):<15} max_abs_err={err:.3e} "
            f"(tol {TOL[dtype]:g}) {kernel} {'ok' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got).all()):
            raise AssertionError(f"paged attention kernel disagrees with "
                                 f"its plain version: {name} {dtype}")
        errs[kernel] = max(errs.get(kernel, 0.0), err)

    def routed(c, call):
        """call(), which must make one launch, and the kernel it took; it
        must be the one pa.route plans for these shapes."""
        before = dict(pa.launches)
        got = call()
        took = [k for k, v in pa.launches.items() if v != before[k]]
        b, t, h, d = c["q"].shape
        hkv, _, page, _ = c["k"].shape
        want = pa.route((h // hkv) * t, d, page, c["pt"].shape[1],
                        c["q"].dtype)
        if took != [want] or pa.launches[want] != before[want] + 1:
            raise AssertionError(f"launch took {took}, planned {want}")
        return got, want

    def run(c):
        return pa.paged_attention(c["q"], c["k"], c["v"], c["pt"], c["base"],
                                  c["limit"], sm_scale=c["sm"])

    def held(name, c, call=None):
        """One launch of case c (through ``call``, or paged_attention with
        the case's limit), held to the plain version; the kernel it took."""
        got, kernel = routed(c, call or (lambda: run(c)))
        want = pa.paged_attention_reference(
            c["q"], c["k"], c["v"], c["pt"], c["base"], c["limit"],
            sm_scale=c["sm"])
        check(name, got, want, c["q"].dtype, kernel)
        return got, kernel

    def at(*xs):
        return torch.tensor(xs, device="cuda")

    # (case, dtype) -> the kernel it took: bf16 decode and verify take the
    # decode route, bf16 chunks the chunk route, fp32 and D=256 the general
    # kernel
    routes = {}
    cases = {}
    full = 16 * 128                             # the table span
    for dtype in (torch.bfloat16, torch.float32):
        for b, seed in ((1, 1), (32, 2)):
            c = paged_case(b, 1, dtype, seed=seed)
            c["limit"] = torch.full_like(c["base"], full)
            _, routes[f"decode B={b}", dtype] = held(
                f"decode B={b}", c, lambda c=c: pa.paged_decode_attention(
                    c["q"][:, 0], c["k"], c["v"], c["pt"], c["base"],
                    sm_scale=c["sm"])[:, None])
            cases[("decode", b, dtype)] = c
        # a row with no live key (limit 0: uniform over the table span)
        # and spans that end mid-page and mid-tile
        c = paged_case(4, 1, dtype, seed=6, base=at(10, 200, 1000, 2040),
                       limit=at(0, 130, 1001, 2048))
        _, routes["decode B=4 limit 0, mid-page ends", dtype] = held(
            "decode B=4 limit 0, mid-page ends", c)
        # verify: B=8, and the speculative serving path's W=32 at
        # T = spec_draft_len + 1
        for b, seed in ((8, 3), (32, 7)):
            c = paged_case(b, verify_t, dtype, seed=seed)
            c["limit"] = torch.full_like(c["base"], full)
            _, routes[f"verify B={b} T={verify_t}", dtype] = held(
                f"verify B={b} T={verify_t}", c,
                lambda c=c: pa.paged_verify_attention(
                    c["q"], c["k"], c["v"], c["pt"], c["base"],
                    sm_scale=c["sm"]))
            cases[("verify", b, dtype)] = c
        c = paged_case(1, 512, dtype, seed=4, base=at(512), limit=at(900))
        got, routes["chunk C=512", dtype] = held(
            "chunk C=512 start=512 len=900", c,
            lambda c=c: pa.paged_chunk_attention(
                c["q"], c["k"], c["v"], c["pt"][0], 512, 900,
                sm_scale=c["sm"]))
        cases[("chunk", 512, dtype)] = c
        if dtype == torch.bfloat16:
            again, _ = routed(c, lambda c=c: run(c))
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("two runs of the C=512 chunk differ")
            log("  chunk C=512: two runs bit-identical")
        # the general kernel on its recompute path (a table span too long
        # to keep even one row's scores in shared memory), at D=256
        c = paged_case(2, 3, dtype, seed=5, d=256, max_pages=336,
                       hkv=2, n_rep=4)
        assert not pa.launch_plan(12, 256, 336 * 128)[1]
        _, routes["recompute D=256", dtype] = held(
            "recompute path D=256 span=43008", c)
    # the chunk route's shapes (bf16): ragged chunks, first chunks, other
    # page sizes, head dims and n_rep, and a slot with no live key
    for i, (name, c) in enumerate((
            ("chunk C=512 first chunk",
             dict(t=512, base=at(0), limit=at(512))),
            ("chunk C=200 start=300 len=480",
             dict(t=200, base=at(300), limit=at(480))),
            ("chunk C=256 D=64 pages of 16",
             dict(t=256, base=at(100), limit=at(356), d=64, page=16,
                  max_pages=128)),
            ("chunk C=256 n_rep 1",
             dict(t=256, base=at(64), limit=at(320), hkv=16, n_rep=1)),
            ("chunk C=256 n_rep 4 pages of 32",
             dict(t=256, base=at(64), limit=at(300), hkv=4, n_rep=4,
                  page=32, max_pages=64)),
            ("chunk B=2 T=64 limit 0 pages of 8",
             dict(b=2, t=64, base=at(10, 600), limit=at(0, 700), page=8,
                  max_pages=128)))):
        c = paged_case(c.pop("b", 1), c.pop("t"), torch.bfloat16,
                       seed=20 + i, **c)
        _, routes[name, torch.bfloat16] = held(name, c)
    for (name, dtype), kernel in routes.items():
        want = ("paged_attention_kernel" if dtype == torch.float32
                or name.startswith("recompute") else "paged_chunk_hopper"
                if name.startswith("chunk") else "paged_decode_hopper")
        if kernel != want:
            raise AssertionError(f"{name} {dtype} took {kernel}, not {want}")
    log("  routes: bf16 decode and verify -> paged_decode_hopper; bf16 "
        "chunks -> paged_chunk_hopper; fp32 and the D=256 recompute case "
        "-> paged_attention_kernel")

    timings = []
    for kind, key in (("decode", ("decode", 32, torch.bfloat16)),
                      ("verify", ("verify", 32, torch.bfloat16)),
                      ("chunk", ("chunk", 512, torch.bfloat16)),
                      ("general", ("chunk", 512, torch.float32))):
        c = cases[key]
        name = routed(c, lambda c=c: run(c))[1]
        bound, bound_by = paged_bound(c)
        ms, plain_ms = time_ms(lambda c=c: run(c)), time_ms(
            lambda c=c: pa.paged_attention_reference(
                c["q"], c["k"], c["v"], c["pt"], c["base"], c["limit"],
                sm_scale=c["sm"]))
        dev_ms = device_ms(lambda c=c: run(c))
        live = int(torch.minimum(c["base"] + c["q"].shape[1],
                                 c["limit"]).sum())
        dtype = str(c["q"].dtype).replace("torch.", "")
        log(f"  time {kind:<7} B={c['q'].shape[0]} T={c['q'].shape[1]} "
            f"{dtype} live_keys={live} ({name}): kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}); library: none (no single PyTorch call attends "
            f"through a page table) [{card}]")
        timings.append({"name": f"paged_attention/{kind}", "route": "cuda",
                        "kernel": name, "dtype": dtype,
                        "source": "ray_torch/ops/csrc/paged_attention.cu",
                        "replaces": "ray_tpu/ops/paged_attention.py:77",
                        "max_abs_err": errs[name],
                        "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": None,
                        "library": None})
    return timings


# ---------------------------------------------------------------------------
# phase 3: greedy identity, kernel (CUDA graphs on and off) vs gather vs
# kernel with speculative decoding, llama_tiny fp32; sampling through a
# graph
# ---------------------------------------------------------------------------

def graphs_line(eng) -> str:
    """An engine's CUDA graph counters (``LLMEngine._graphs``)."""
    g = eng._graphs
    if g is None:
        return "CUDA graphs off"
    return (f"{g.captures} graphs captured ({prompt_captures(eng)} of them "
            f"prompt programs), {g.replays} replays, pool {g.pool_bytes} "
            f"bytes")


def prompt_captures(eng) -> dict:
    """The engine's prompt programs (``_prompt_programs``: one captured
    graph per prefill bucket and chunk length met), counted by kind."""
    out = {"prefill": 0, "chunk": 0}
    for kind, _ in eng._prompt_programs:
        out[kind] += 1
    return out


def check_prompt_programs(name, eng, graphs: bool) -> None:
    """With graphs on, one prompt program per prefill and chunk signature
    the engine met, each first used inside ``compile_scope``, none among
    the decode and verify ``_programs``, and every graph captured once;
    with graphs off, none."""
    seen = {s for s in eng._prof._seen if s[0] in ("prefill", "chunk")}
    progs = set(eng._prompt_programs)
    ok = (progs == seen and not progs & set(eng._programs)
          and eng._graphs.captures == len(eng._programs) + len(progs)
          ) if graphs else not progs
    if not ok:
        raise AssertionError(f"{name}: prompt programs {sorted(progs)}, "
                             f"signatures met {sorted(seen)}; "
                             f"{graphs_line(eng)}")


def admit_together(eng, prompts) -> list:
    """Submit greedy ``prompts`` while the engine loop waits at the top of
    its next admission pass, so that one pass admits (and prefills) them
    all before any decode dispatch. Returns their request ids."""
    gate, held = threading.Event(), threading.Event()
    admit = eng._admit

    def gated():
        held.set()
        gate.wait()
        return admit()

    eng._admit = gated
    try:
        if not held.wait(10.0):
            raise AssertionError("the engine loop reached no admission pass")
        return [eng.submit(p, temperature=0.0) for p in prompts]
    finally:
        del eng._admit
        gate.set()


def phase_identity(card: str):
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMConfig, LLMEngine

    mcfg = llama.llama_tiny(vocab_size=512)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = llama.init_params(mcfg, gen, "cuda")
    shared = "the quick brown fox jumps over the lazy dog"  # 5 full pages
    waves = [[shared + " and keeps running far past the fence",  # > chunk
              "abc abc abc abc abc", "abc abc abc", "hello"],
             [shared + " once more"]]                 # prefix-hit suffix chunk
    # four prompts of one prefill bucket, admitted in one pass: each
    # replay of the bucket's graph overwrites its output before a decode
    # dispatch reads the earlier prompts' first tokens
    same_bucket = ["abc", "hello there", "zq", "one two three"]
    outs, launches = {}, {}
    for run, kernel, spec, graphs in (
            ("kernel", "cuda", False, True),
            ("kernel, eager", "cuda", False, False),
            ("gather", "gather", False, True),
            ("kernel, spec", "cuda", True, True),
            ("kernel, spec, eager", "cuda", True, False)):
        cfg = LLMConfig(
            model_config=mcfg, device="cuda", attention_kernel=kernel,
            max_batch_size=4, page_size=8, num_pages=64, max_prompt_len=64,
            max_seq_len=128, prefill_chunk=16, max_tokens=32,
            spec_decode_enabled=spec, cuda_graphs=graphs)
        eng = LLMEngine(cfg, params=params)
        eng.start()
        try:
            for name in pa.launches:        # count this engine's traffic
                pa.launches[name] = 0
            toks = []
            for wave in waves + [same_bucket]:
                rids = (admit_together(eng, wave) if wave is same_bucket
                        else [eng.submit(p, temperature=0.0) for p in wave])
                res = [eng.result(r, timeout=300.0) for r in rids]
                for r in res:
                    if r["error"] is not None:
                        raise RuntimeError(f"{run} engine: {r['error']}")
                toks += [r["tokens"] for r in res]
            stats = eng.engine_stats()
            launches[run] = dict(pa.launches)
        finally:
            eng.shutdown()
        assert stats["attention_backend"] == kernel, stats["attention_backend"]
        assert stats["prefix_hits"] >= 1 and stats["attn_chunk_dispatches"] > 0
        if (eng._graphs is not None) != graphs or graphs and not (
                eng._graphs.replays > 0
                and all(prompt_captures(eng).values())):
            raise AssertionError(f"{run}: {graphs_line(eng)}, programs "
                                 f"{sorted(eng._programs)}, prompt programs "
                                 f"{sorted(eng._prompt_programs)}")
        check_prompt_programs(run, eng, graphs)
        if spec:
            # with graphs on the host dispatches a request's decode blocks
            # before its drafts show, so it may run few verify rounds here;
            # phase 4b runs them at full width
            log(f"  {run}: {stats['spec_rounds']} verify rounds, "
                f"{stats['spec_accepted_tokens']} of "
                f"{stats['spec_drafted_tokens']} drafted tokens accepted")
            if not (graphs or stats["spec_rounds"] > 0):
                raise AssertionError("the spec-on engine ran no verify round")
        if kernel == "cuda":
            want = planned_launches(cfg, stats,
                                    prompt_captures(eng)["chunk"])
            log(f"  {run}: launches {launches[run]} (planned {want}); "
                f"{graphs_line(eng)}")
            if launches[run] != want or not want["paged_attention_kernel"]:
                raise AssertionError(f"{run}: launches {launches[run]} are "
                                     f"not the planned {want}")
        outs[run] = toks
    for run in outs:
        if outs[run] != outs["kernel"]:
            raise AssertionError(f"greedy tokens differ: kernel "
                                 f"{outs['kernel']} vs {run} {outs[run]}")
    firsts = [t[0] for t in outs["kernel"][-len(same_bucket):]]
    log(f"  llama_tiny fp32: {len(outs['kernel'])} requests, "
        f"{sum(map(len, outs['kernel']))} greedy tokens identical across "
        f"{', '.join(outs)} (graphs on unless eager, prefill and chunk "
        f"programs included; prefix hit + chunked prefill on the path; "
        f"{len(same_bucket)} prompts of one bucket admitted in one pass, "
        f"first tokens {firsts}) [{card}]")
    if firsts.count(firsts[-1]) == len(firsts):
        raise AssertionError("the same-bucket prompts share their first "
                             "token: the case cannot show a token left "
                             "aliasing its graph's output")
    phase_sampling(mcfg, params, card)
    return launches["kernel"]


def phase_sampling(mcfg, params, card: str):
    """Temperature 1.0 through CUDA graphs, on two engines from one seed:
    each answers one sampled request, then replays its (width 8, 1 step)
    decode graph twice on the same inputs (8 rows at position 0 on pages
    of their own, the same tokens and lengths). The replays must draw
    different tokens in most rows (a generator the graph did not register
    draws the same numbers at every replay), and the engines must give the
    same stream and the same draws."""
    from ray_torch.serve.llm import LLMConfig, LLMEngine

    cfg = LLMConfig(model_config=mcfg, device="cuda", max_batch_size=8,
                    page_size=8, num_pages=64, max_prompt_len=64,
                    max_seq_len=128, max_tokens=32)
    w = cfg.max_batch_size
    streams, draws = [], []
    for _ in range(2):
        eng = LLMEngine(cfg, params=params, rng_seed=5)
        eng.start()
        try:
            out = eng.generate("sample from here", temperature=1.0)
        finally:
            eng.shutdown()
        if out["error"] is not None:
            raise RuntimeError(f"sampled request: {out['error']}")
        streams.append(out["tokens"])
        prog = eng._programs[("decode", w, 1)]
        eng._stage(prog.inputs[0], np.arange(w, dtype=np.int64))
        eng._pt_dev[:w] = 0
        eng._pt_dev[:w, 0] = torch.arange(1, w + 1, dtype=torch.int32,
                                         device="cuda")
        eng._temps_dev[:w] = 1.0
        replays = []
        for _ in range(2):
            eng._sl_dev[:w] = 0
            eng._dev_tokens[:w] = torch.arange(100, 100 + w, device="cuda")
            replays.append(eng._graphs.replay(prog).clone())
        draws.append(torch.cat(replays))
    torch.cuda.synchronize()
    same = int((draws[0][0] == draws[0][1]).sum())
    log(f"  temperature 1.0, one decode graph (width {w}, 1 step) replayed "
        f"twice on the same inputs: the same token in {same}/{w} rows; two "
        f"engines from one seed: replays identical "
        f"{torch.equal(draws[0], draws[1])}, sampled streams identical "
        f"{streams[0] == streams[1]} ({len(streams[0])} tokens) [{card}]")
    if not (2 * same < w and torch.equal(draws[0], draws[1])
            and streams[0] == streams[1] and streams[0]):
        raise AssertionError("sampling through CUDA graphs: replays repeat "
                             "their draws or one seed gives two streams")


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def device_profile(run, top: int = 8) -> dict:
    """Run ``run()`` under torch.profiler (CUDA activity only, to keep the
    host overhead low) and summarize it: the wall, the kernels' device
    time and its share of the wall, the kernels run, the host's CUDA API
    calls by name (``cudaGraphLaunch`` among them) and the ``top`` kernels
    by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    runtime = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and re.match(r"cu(da)?[A-Z]", e.key)]
    calls = {e.key: e.count for e in runtime}
    call_ms = {e.key: e.cpu_time_total / 1e3 for e in runtime}
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"wall_ms": 1e3 * wall, "busy_ms": busy_ms,
           "busy": busy_ms / (1e3 * wall),
           "kernels": sum(e.count for e in kernels), "calls": calls,
           "call_ms": call_ms,
           "by_kernel": {e.key: e.self_device_time_total / 1e3
                         for e in kernels}}
    log(f"  profiled run: wall {out['wall_ms']:.1f} ms, kernels "
        f"{busy_ms:.1f} ms = device busy {100 * out['busy']:.1f}% of the "
        f"wall ({out['kernels']} kernels run; host calls, count and host "
        f"ms: " + ", ".join(f"{k} {n} {call_ms[k]:.1f}" for k, n in sorted(
            calls.items(), key=lambda kv: -kv[1])) + ")")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    return out


def serve_config(**kw):
    """The serve bench's llama3-1b engine settings (bench_serve.py)."""
    from ray_torch.models import llama
    from ray_torch.serve.llm import LLMConfig

    kw.setdefault("model_config", llama.llama3_1b(max_seq_len=2048))
    return LLMConfig(
        model_id="llama3-1b", device="cuda", max_batch_size=32,
        page_size=128, num_pages=288, max_prompt_len=1024, max_seq_len=2048,
        decode_block=8, pipeline_depth=3, pressure_decode_block=2, **kw)


def first_uses(eng) -> dict:
    """From now on, each signature's first-use ms as ``compile_scope``
    times it (with graphs on a prompt program's capture, warm run and
    first replay; off, its first eager pass), by signature."""
    ms, record = {}, eng._prof._record_compile

    def timed(kind, sig, dt, mid_traffic):
        if sig not in eng._prof._seen:
            ms[sig] = 1e3 * dt
        record(kind, sig, dt, mid_traffic)

    eng._prof._record_compile = timed
    return ms


def replay_hold(eng, sigs, reps: int = 5) -> dict:
    """Per signature, on its trash inputs (page table of zeros), with the
    engine idle: the host ms that one graph replay holds the caller
    (``cudaGraphLaunch`` returning), at the first of ``reps`` replays and
    their median, and the median ms until the card has run it."""
    out = {}
    for sig in sigs:
        prompt = sig in eng._prompt_programs
        prog = (eng._prompt_programs if prompt else eng._programs)[sig]
        trash = (eng._prompt_inputs if prompt else eng._trash_inputs)(sig)
        for dst, src in zip(prog.inputs, trash):
            dst.copy_(src)
        held, done = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prog.graph.replay()
            held.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            done.append(1e3 * (time.perf_counter() - t0))
        out[sig] = (held[0], statistics.median(held),
                    statistics.median(done))
    return out


def stage_names(out) -> list[str]:
    return [s["stage"] for s in out.get("stages") or []]


def check_waterfall(name, out, prompt_tokens: int, restored: bool = False,
                    tol_s: float = 1e-3) -> dict:
    """A finished request's stages (``result()``'s or the server's
    ``ray_tpu`` dict, with ``ttft_s`` and ``latency_s``): ``queue``,
    ``restore`` when ``restored``, ``prefill``, ``decode``, each starting
    where the one before ends; prefill's end minus the queue's start is
    the TTFT and decode's end the latency, within ``tol_s``; prefilled
    tokens are the prompt's less the cached ones. Returns the stages by
    name."""
    names = stage_names(out)
    want = ["queue"] + (["restore"] if restored else []) \
        + ["prefill", "decode"]
    by = {s["stage"]: s for s in out.get("stages") or []}
    if names != want:
        raise AssertionError(f"{name}: stages {names}, not {want}")
    chain = [by[n] for n in want]
    gaps = [b["start"] - a["end"] for a, b in zip(chain, chain[1:])]
    q, p, d = by["queue"], by["prefill"], by["decode"]
    ttft = p["end"] - q["start"] - out["ttft_s"]
    lat = d["end"] - q["start"] - out["latency_s"]
    cached = p["attrs"]["cached_tokens"]
    if any(gaps) or abs(ttft) > tol_s or abs(lat) > tol_s \
            or q["attrs"] != {"admitted": True} \
            or p["attrs"]["prefilled_tokens"] != prompt_tokens - cached:
        raise AssertionError(f"{name}: stages {out['stages']} against TTFT "
                             f"{out['ttft_s']} s, latency "
                             f"{out['latency_s']} s, {prompt_tokens} "
                             f"prompt tokens")
    return by


def stage_report(outs) -> dict:
    """``aggregate_report`` over requests' results (each turned into a
    record through ``Timeline.extend`` and ``build_record``)."""
    from ray_torch.observability import attribution

    records = []
    for i, out in enumerate(outs):
        tl = attribution.Timeline(out.get("request_id") or str(i))
        tl.extend(out.get("stages"))
        ttft, lat = out.get("ttft_s"), out.get("latency_s")
        records.append(attribution.build_record(
            tl, kind="baseline", violated=[], policy={},
            ttft_ms=None if ttft is None else 1e3 * ttft,
            e2e_ms=None if lat is None else 1e3 * lat))
    return attribution.aggregate_report(records)


def stage_line(rep, stages=("queue", "restore", "prefill", "decode")) -> str:
    """Per-stage p50 / p99 ms and the slowest decile's dominant stage."""
    ms = rep["stage_ms"]
    return (", ".join(f"{st} {ms[st]['p50']:.1f} / {ms[st]['p99']:.1f}"
                      for st in stages if st in ms)
            + f" ms (p50 / p99 of {rep['count']}); the slowest decile's "
            f"dominant stage {rep['dominant_stage']}")


def serve_arm(card: str, graphs: bool, params=None, max_tokens: int = 32):
    """One arm of phase 4: an ``LLMServer`` (over ``params``, else weights
    from seed 0) with CUDA graphs on or off answers four waves of
    completions, the third profiled, the fourth wave 1's prompt lengths in
    fresh text (with graphs on, every prompt program it needs is already
    captured); the launch counters are zeroed once the engine has started
    and must be the plan of its stats after the waves. Returns what the
    arm measured."""
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMServer

    cfg = serve_config(max_tokens=max_tokens, cuda_graphs=graphs)
    word = "the quick brown fox jumps over the lazy dog "
    shared = (word * 12)[:511]              # + BOS = 512 tokens = 4 pages
    wave1 = [f"request {i}: " + word * 3 for i in range(6)]
    wave1 += [(word * 21)[:899],            # ~900 tokens: chunked prefill
              shared + " first suffix that differs"]
    wave2 = [shared + " second suffix, a prefix hit",
             "request 6: " + word]
    wave3 = [f"request {i}: " + word * 3 for i in range(7, 15)]
    fresh = "pack my box with five dozen liquor jugs, then "
    wave4 = [(f"answer {i}: " + fresh * 30)[:len(p)]
             for i, p in enumerate(wave1)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = LLMServer(cfg, params=params, rng_seed=0)
    setup_s = time.perf_counter() - t0
    eng = srv.engine
    warmup_s = eng._prof.compile_s          # the warmup's first uses
    captured = eng._graphs.captures if graphs else 0
    warm_pool = eng._graphs.pool_bytes if graphs else 0
    first_ms = first_uses(eng)
    try:
        for name in pa.launches:            # count the main path only
            pa.launches[name] = 0
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
            prof = device_profile(lambda: results.extend(serve(wave3)))
            before_warm = dict(first_ms)
            results += serve(wave4)
        stats = srv.engine_stats()
        launches = dict(pa.launches)
        # the widest decode block has not been replayed in these waves
        hold = replay_hold(eng, sorted(eng._prompt_programs) + [
            ("decode", w, cfg.decode_block)
            for w in (8, cfg.max_batch_size)]) if graphs else {}
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    paged_ms = {name: sum(ms for key, ms in prof["by_kernel"].items()
                          if name in key) for name in launches}
    log(f"  paged kernels in the profiled wave: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in paged_ms.items())
        + f"; together {sum(paged_ms.values()):.2f} ms = "
        f"{100 * sum(paged_ms.values()) / prof['busy_ms']:.1f}% of the "
        f"device time [{card}]")
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
    # every prefill chunk (16 rows or more a rep, so past the decode
    # route's 16 rows) on the chunk route, every decode step on the decode
    # route: in bf16 serving nothing is left for paged_attention_kernel
    want = planned_launches(cfg, stats, prompt_captures(eng)["chunk"])
    log(f"  kernel launches on the main path: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" (planned {want}); engine decode blocks "
        f"{stats['attn_decode_dispatches']}, chunks "
        f"{stats['attn_chunk_dispatches']}, prefix hits "
        f"{stats['prefix_hits']}, steps {stats['steps']}; {graphs_line(eng)}")
    if launches != want or not (want["paged_decode_hopper"]
                                and want["paged_chunk_hopper"]) \
            or want["paged_attention_kernel"]:
        raise AssertionError(f"the serving path's paged launches {launches} "
                             f"are not the plan {want}: every chunk on "
                             f"paged_chunk_hopper, every decode step on "
                             f"paged_decode_hopper")
    if not paged_ms["paged_decode_hopper"] > 0:
        raise AssertionError("the profiled wave ran no paged_decode_hopper")
    if graphs and not (prof["calls"].get("cudaGraphLaunch", 0) > 0
                       and eng._graphs.captures == captured
                       + len(eng._prompt_programs)):
        raise AssertionError(f"graphs on: {graphs_line(eng)} ({captured} "
                             f"at warmup), cudaGraphLaunch "
                             f"{prof['calls'].get('cudaGraphLaunch', 0)}")
    check_prompt_programs("phase 4", eng, graphs)
    n = prompt_captures(eng)
    if n["prefill"] > 7 or n["chunk"] > 7 or first_ms != before_warm:
        raise AssertionError(f"prompt programs {sorted(eng._prompt_programs)}"
                             f"; first uses in the warm wave "
                             f"{set(first_ms) - set(before_warm)}")
    # attribution: every completion's waterfall against its own TTFT and
    # latency; wave 2's prefix hit cached the full pages it shares with
    # an earlier prompt
    tok = eng.tokenizer.encode
    prompts = [tok(p) for p in wave1 + wave2 + wave3 + wave4]
    if len(prompts) != len(results):
        raise AssertionError(f"{len(results)} completions for "
                             f"{len(prompts)} prompts")
    for r, p in zip(results, prompts):
        check_waterfall(f"phase 4 {r['ray_tpu']['request_id']}",
                        r["ray_tpu"], len(p))
    hit = prompts[8]
    shared_pages = max(
        next((i for i, (a, b) in enumerate(zip(hit, p)) if a != b),
             min(len(hit), len(p))) for p in prompts[:8]) // cfg.page_size
    hit_pages = min(shared_pages, (len(hit) - 1) // cfg.page_size)
    cached = results[8]["ray_tpu"]["stages"][1]["attrs"]["cached_tokens"]
    if not (hit_pages and cached == hit_pages * cfg.page_size):
        raise AssertionError(f"wave 2's prefix hit cached {cached} tokens, "
                             f"its shared pages {hit_pages}")
    report = stage_report([r["ray_tpu"] for r in results])
    ttfts = [r["ray_tpu"]["ttft_s"] for r in results[:10]]
    warm = [r["ray_tpu"]["ttft_s"] for r in results[-len(wave4):]]
    waits = [r["ray_tpu"]["queue_wait_s"] for r in results[:10]]
    gaps = [(r["ray_tpu"]["latency_s"] - ttft) / (max_tokens - 1)
            for r, ttft in zip(results, ttfts)]
    out_tokens = sum(r["usage"]["completion_tokens"] for r in results[:8])
    return {"cfg": cfg, "params": eng.params, "launches": launches,
            "texts": [r["choices"][0]["text"] for r in results],
            "setup_s": setup_s, "warmup_s": warmup_s,
            "graphs": graphs_line(eng),
            "pool_bytes": eng._graphs.pool_bytes if graphs else 0,
            "warm_pool": warm_pool, "prompt_captures": n,
            "first_ms": {s: ms for s, ms in first_ms.items()
                         if s[0] in ("prefill", "chunk")},
            "hold": hold,
            "warm_p50": statistics.median(warm), "warm_max": max(warm),
            "ttft_p50": statistics.median(ttfts), "ttft_max": max(ttfts),
            "ttft_long": ttfts[6], "ttft_hit": ttfts[8],
            "wait_p50": statistics.median(waits),
            "itl_p50": statistics.median(gaps),
            "rate_p50": 1 / statistics.median(gaps),
            "wave_tps": out_tokens / walls[0], "wave_s": walls[0],
            "out_tokens": out_tokens, "prof": prof, "stats": stats,
            "peak": peak, "stages": report, "hit": (hit_pages, cached)}


def phase_serve(card: str):
    """Phase 4: ``serve_arm`` with CUDA graphs on, then off on the same
    weights; per arm the figures, then how many completions the arms
    share. Returns the weights and the graphs-on arm's launches."""
    from ray_torch.models import llama

    arms = {"on": serve_arm(card, True)}
    arms["off"] = serve_arm(card, False, params=arms["on"]["params"])
    cfg = arms["on"]["cfg"]
    log(f"  llama3_1b bf16 ({llama.num_params(cfg.model_config) / 1e9:.3f}B "
        f"params), {len(arms['on']['texts'])} requests x {cfg.max_tokens} "
        f"tokens a server [{card}]")
    for arm, a in arms.items():
        st, pr = a["stats"], a["prof"]
        log(f"  graphs {arm:<3}: warmup {a['warmup_s']:.3f} s (engine build "
            f"+ warmup {a['setup_s']:.2f} s), {a['graphs']}; TTFT p50 "
            f"{1e3 * a['ttft_p50']:.1f} ms, max {1e3 * a['ttft_max']:.1f} ms "
            f"(900-token prompt {1e3 * a['ttft_long']:.1f} ms, prefix hit "
            f"{1e3 * a['ttft_hit']:.1f} ms; queue wait p50 "
            f"{1e3 * a['wait_p50']:.1f} ms); ITL p50 "
            f"{1e3 * a['itl_p50']:.2f} ms (a request's mean gap after its "
            f"first token); wave of 8: {a['out_tokens']} tokens "
            f"in {a['wave_s']:.3f} s = {a['wave_tps']:.1f} output tokens/s; "
            f"decode tokens/s per request {a['rate_p50']:.1f} (1 / ITL "
            f"p50) [{card}]")
        log(f"  graphs {arm:<3}: phases p50: decode_dispatch "
            f"{st['phase_decode_dispatch_p50_ms']} ms, harvest "
            f"{st['phase_harvest_p50_ms']} ms, prefill "
            f"{st['phase_prefill_p50_ms']} ms, chunk_prefill "
            f"{st['phase_chunk_prefill_p50_ms']} ms; profiled wave: wall "
            f"{pr['wall_ms']:.1f} ms, kernels {pr['busy_ms']:.1f} ms, device "
            f"busy {100 * pr['busy']:.1f}%, {pr['kernels']} kernels run, "
            f"cudaGraphLaunch {pr['calls'].get('cudaGraphLaunch', 0)}, "
            f"cudaLaunchKernel {pr['calls'].get('cudaLaunchKernel', 0)} "
            f"({pr['call_ms'].get('cudaLaunchKernel', 0.0):.1f} ms on the "
            f"host), cudaStreamSynchronize "
            f"{pr['calls'].get('cudaStreamSynchronize', 0)}; "
            f"peak torch.cuda.max_memory_allocated "
            f"{a['peak'] / 2**30:.3f} GiB [{card}]")
        log(f"  graphs {arm:<3}: prompt programs captured "
            f"{a['prompt_captures']} (pool {a['warm_pool']} bytes after "
            f"warmup, {a['pool_bytes']} after the waves); first use ms: "
            + ", ".join(
                f"{k}/{n} {ms:.1f}" for (k, n), ms in sorted(
                    a["first_ms"].items())) + f"; warm wave (wave 1's "
            f"lengths, fresh text) TTFT p50 {1e3 * a['warm_p50']:.1f} ms, "
            f"max {1e3 * a['warm_max']:.1f} ms [{card}]")
        log(f"  graphs {arm:<3}: attribution over all "
            f"{a['stages']['count']} completions: "
            + stage_line(a["stages"]) + f"; wave 2's prefix hit cached "
            f"{a['hit'][1]} tokens = {a['hit'][0]} pages x "
            f"{a['cfg'].page_size} [{card}]")
        if a["hold"]:
            log(f"  graphs {arm:<3}: one replay on trash inputs, engine "
                f"idle, host held at the first / median, until the card is "
                f"done (ms): " + ", ".join(
                    f"{'/'.join(map(str, s))} {f:.3f} / {h:.3f}, {d:.3f}"
                    for s, (f, h, d) in a["hold"].items()) + f" [{card}]")
    on, off = arms["on"], arms["off"]
    log(f"  warm wave TTFT graphs on / off: p50 "
        f"{on['warm_p50'] / off['warm_p50']:.3f}x, max "
        f"{on['warm_max'] / off['warm_max']:.3f}x; prefill phase p50 "
        f"{on['stats']['phase_prefill_p50_ms']} / "
        f"{off['stats']['phase_prefill_p50_ms']} ms, chunk_prefill "
        f"{on['stats']['phase_chunk_prefill_p50_ms']} / "
        f"{off['stats']['phase_chunk_prefill_p50_ms']} ms [{card}]")
    compare_streams("phase 4 bf16 completion text, graphs on vs off",
                    on["texts"], off["texts"], card)
    log(f"  graphs on / off: wave tokens/s "
        f"{on['wave_tps'] / off['wave_tps']:.3f}x, TTFT p50 "
        f"{on['ttft_p50'] / off['ttft_p50']:.3f}x, device busy "
        f"{100 * on['prof']['busy']:.1f}% / {100 * off['prof']['busy']:.1f}%"
        f", graph pool {on['pool_bytes']} bytes [{card}]")
    return on["params"], on["launches"]


# ---------------------------------------------------------------------------
# phase 4b: speculative decoding on the serving path at full width
# ---------------------------------------------------------------------------

def spec_wave() -> list[str]:
    """8 prompts whose text repeats (code, quoted verse), one of them past
    ``prefill_chunk`` (512 tokens) so it chunk-prefills."""
    code = "def add(a, b):\n    return a + b\n\n"
    loop = "for i in range(10):\n    total += values[i] * weights[i]\n"
    quote = '"to be, or not to be, that is the question" she said; '
    wave = [f"# module {i}\n" + code * 4 for i in range(3)]
    wave += [f"reply {i}: " + quote * 3 for i in range(3)]
    wave += ["total = 0\n" + loop * 4]
    wave += [(code + loop) * 10]             # 891 tokens: chunked prefill
    return wave


def stream_wave(srv, prompts, max_tokens):
    """Stream greedy completions of all ``prompts`` concurrently through
    the server's OpenAI-shaped endpoint: per request, its token ids and
    its final chunk."""
    async def one(prompt):
        toks, final = [], None
        async for chunk in srv.completions(
                {"prompt": prompt, "max_tokens": max_tokens,
                 "temperature": 0.0, "stream": True}):
            toks += chunk.get("token_ids", [])
            final = chunk
        return toks, final

    async def wave():
        return await asyncio.gather(*(one(p) for p in prompts))

    return asyncio.run(wave())


def planned_launches(cfg, stats, chunk_captures: int = 0) -> dict:
    """Launches per kernel that an engine run's stats imply: n_layers for
    each decode step, each verify round (one launch at [W, k + 1]) and each
    prefill chunk, each on the kernel ``paged_attention.route`` plans for
    its rows (in bf16: n_layers x (steps - k x verify rounds) on
    ``paged_decode_hopper``), and n_layers on the chunk's kernel for each
    of ``chunk_captures``, the chunk graphs captured in the run: each
    capture's eager warm run (the capture itself launches nothing, and
    its replays count as chunks)."""
    from ray_torch.ops import paged_attention as pa

    mc, k = cfg.model_config, cfg.spec_draft_len
    n_rep, layers = mc.n_heads // mc.n_kv_heads, mc.n_layers
    verify = stats["attn_verify_dispatches"]

    def route(rows):
        return pa.route(n_rep * rows, mc.head_dim, cfg.page_size,
                        -(-cfg.max_seq_len // cfg.page_size), mc.dtype)

    want = dict.fromkeys(pa.launches, 0)
    for rows, count in ((1, stats["steps"] - (k + 1) * verify),
                        (k + 1, verify),
                        (cfg.prefill_chunk,
                         stats["attn_chunk_dispatches"] + chunk_captures)):
        want[route(rows)] += layers * count
    return want


def serve_wave(cfg, params, wave, max_tokens):
    """One ``LLMServer`` over ``params`` streams ``wave``; the launch
    counters are zeroed once the engine has started and read after the
    wave. Returns the streams, the wave's wall time, the engine's stats,
    the launches and the live slots of each verify round."""
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMServer

    srv = LLMServer(cfg, params=params, rng_seed=0)
    rows = []

    def counted(r, dispatch=srv.engine._dispatch_verify):
        rows.append(len(r))
        dispatch(r)

    srv.engine._dispatch_verify = counted
    graphs = srv.engine._graphs
    captured = graphs.captures if graphs is not None else 0
    try:
        for name in pa.launches:
            pa.launches[name] = 0
        t0 = time.perf_counter()
        outs = stream_wave(srv, wave, max_tokens)
        wall = time.perf_counter() - t0
        stats = srv.engine_stats()
        launches = dict(pa.launches)
    finally:
        srv.shutdown()
        # the wrapper refers to the engine: drop it, so the engine (its
        # pool, and in fp32 its weights) is freed with the server
        del srv.engine._dispatch_verify
    for toks, final in outs:
        if final.get("error") or len(toks) != max_tokens \
                or final["usage"]["completion_tokens"] != max_tokens:
            raise AssertionError(f"a request returned {len(toks)} tokens, "
                                 f"{final}")
    want = planned_launches(cfg, stats, prompt_captures(srv.engine)["chunk"])
    log(f"  kernel launches {launches} (planned {want}); engine steps "
        f"{stats['steps']}, decode blocks {stats['attn_decode_dispatches']}"
        f", verify rounds {stats['attn_verify_dispatches']}, chunks "
        f"{stats['attn_chunk_dispatches']}; {graphs_line(srv.engine)}")
    if launches != want or not stats["attn_chunk_dispatches"] > 0:
        raise AssertionError(f"launches {launches} are not the planned "
                             f"{want}")
    if graphs is not None and not (graphs.replays > 0
                                   and graphs.captures == captured
                                   + len(srv.engine._prompt_programs)):
        raise AssertionError(f"{graphs_line(srv.engine)}, {captured} "
                             f"captured at warmup")
    check_prompt_programs("serve wave", srv.engine, graphs is not None)
    return [toks for toks, _ in outs], wall, stats, launches, rows


def compare_streams(name, a, b, card):
    """How many requests' tokens are identical, and where the others
    first differ."""
    firsts = [next(i for i, (p, q) in enumerate(zip(x, y)) if p != q)
              for x, y in zip(a, b) if x != y]
    log(f"  greedy tokens {name}: {len(a) - len(firsts)}/{len(a)} requests "
        f"identical; first differing position of the others: "
        f"{firsts or 'none'} [{card}]")
    return not firsts


def phase_spec_serve(card: str, params):
    """``LLMServer`` serving llama3_1b with speculative decoding on and off,
    one wave of 8 concurrent greedy streams of 64 tokens each, on phase 4's
    weights. In bf16: spec on and off, each with CUDA graphs on and off,
    then off again on a fresh engine (the control); every verify round (16
    layers, one launch a layer at [W, spec_draft_len + 1]) and every decode
    step must run ``paged_decode_hopper`` and nothing
    ``paged_attention_kernel``, and bf16 token differences are reported.
    In fp32 (every launch on ``paged_attention_kernel``): spec on with
    graphs on and off and spec off must give identical tokens."""
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa

    max_tokens = 64
    wave = spec_wave()
    runs = {}
    for run, spec, graphs in (("on", True, True), ("on, eager", True, False),
                              ("off", False, True),
                              ("off, eager", False, False),
                              ("off again", False, True)):
        log(f"  bf16, spec {run}{'' if graphs else ' (CUDA graphs off)'}:")
        cfg = serve_config(max_tokens=max_tokens, spec_decode_enabled=spec,
                           cuda_graphs=graphs)
        runs[run] = serve_wave(cfg, params, wave, max_tokens)
    mc, k = cfg.model_config, cfg.spec_draft_len
    on, off, again = runs["on"], runs["off"], runs["off again"]
    stats, rows = on[2], on[4]
    route = pa.route(mc.n_heads // mc.n_kv_heads * (k + 1), mc.head_dim,
                     cfg.page_size, -(-cfg.max_seq_len // cfg.page_size),
                     mc.dtype)
    if route != "paged_decode_hopper" or not stats["spec_rounds"] > 0:
        raise AssertionError(f"verify route {route}, spec_rounds "
                             f"{stats['spec_rounds']}")
    verify_launches = mc.n_layers * stats["attn_verify_dispatches"]
    log(f"  verify launches at [W, {k + 1}]: route {route}, "
        f"{verify_launches} of the {on[3]['paged_decode_hopper']} "
        f"paged_decode_hopper launches")
    for run in ("on", "on, eager"):
        st, rw = runs[run][2], runs[run][4]
        log(f"  llama3_1b bf16, spec {run}, {len(wave)} concurrent greedy "
            f"streams x {max_tokens} tokens: spec_accept_rate "
            f"{st['spec_accept_rate']} ({st['spec_accepted_tokens']} of "
            f"{st['spec_drafted_tokens']} drafted), {st['spec_rounds']} "
            f"verify rounds, {st['spec_accepted_tokens'] / sum(rw) + 1:.3f} "
            f"tokens a slot and round; live slots a round: mean "
            f"{sum(rw) / len(rw):.2f}, max {max(rw)} ({sum(rw)} slot-rounds)"
            f" [{card}]")
    for run, r in runs.items():
        st = r[2]
        log(f"  engine phases p50, spec {run}: verify_dispatch "
            f"{st['phase_verify_dispatch_p50_ms']} ms, decode_dispatch "
            f"{st['phase_decode_dispatch_p50_ms']} ms, harvest "
            f"{st['phase_harvest_p50_ms']} ms")
    n_out = len(wave) * max_tokens
    tps = {run: n_out / r[1] for run, r in runs.items()}
    log("  wave wall: " + "; ".join(
        f"spec {run} {r[1]:.3f} s = {tps[run]:.1f} output tokens/s"
        for run, r in runs.items()) + f" [{card}]")
    log(f"  spec on / off tokens/s: CUDA graphs "
        f"{tps['on'] / tps['off']:.3f}x, eager "
        f"{tps['on, eager'] / tps['off, eager']:.3f}x; graphs on / off: "
        f"spec on {tps['on'] / tps['on, eager']:.3f}x, spec off "
        f"{tps['off'] / tps['off, eager']:.3f}x [{card}]")
    compare_streams("bf16, spec on vs off", on[0], off[0], card)
    compare_streams("bf16, spec off vs off again", off[0], again[0], card)
    compare_streams("bf16, spec on, graphs on vs off", on[0],
                    runs["on, eager"][0], card)
    compare_streams("bf16, spec off, graphs on vs off", off[0],
                    runs["off, eager"][0], card)

    fp32 = _cast(params, torch.float32)
    mc32 = llama.llama3_1b(max_seq_len=2048, dtype=torch.float32)
    streams = {}
    for run, spec, graphs in (("on", True, True), ("on, eager", True, False),
                              ("off", False, True)):
        log(f"  fp32, spec {run}{'' if graphs else ' (CUDA graphs off)'}:")
        streams[run] = serve_wave(serve_config(
            model_config=mc32, max_tokens=max_tokens,
            spec_decode_enabled=spec, cuda_graphs=graphs), fp32, wave,
            max_tokens)[0]
    same = [compare_streams(f"fp32, spec {a} vs spec {b}", streams[a],
                            streams[b], card)
            for a, b in (("on", "on, eager"), ("on", "off"))]
    if not all(same):
        raise AssertionError("fp32 greedy tokens differ between CUDA graphs "
                             "on and off or with spec on")
    del fp32
    return on[3], verify_launches, k


def phase_spec_profile(card: str, max_tokens: int = 64):
    """Where phase 4b's bf16 wave spends its time, spec on and off, each
    with CUDA graphs on and off: one profiled wave each on a fresh server
    (device busy share, launches, host calls, the decode route's device
    time), over phase 4's weights (the same seed). Run last: a profile of
    ~160,000 launches must not share a process's profiler with the kernel
    timings."""
    from ray_torch.serve.llm import LLMServer

    for spec in (True, False):
        for graphs in (True, False):
            log(f"  bf16, spec {'on' if spec else 'off'}, CUDA graphs "
                f"{'on' if graphs else 'off'}, profiled wave:")
            srv = LLMServer(serve_config(max_tokens=max_tokens,
                                         spec_decode_enabled=spec,
                                         cuda_graphs=graphs), rng_seed=0)
            try:
                prof = device_profile(
                    lambda: stream_wave(srv, spec_wave(), max_tokens), top=4)
            finally:
                srv.shutdown()
            paged = sum(ms for key, ms in prof["by_kernel"].items()
                        if "paged_decode_hopper" in key)
            calls, call_ms = prof["calls"], prof["call_ms"]
            log(f"  paged_decode_hopper {paged:.2f} ms = "
                f"{100 * paged / prof['busy_ms']:.1f}% of the device time; "
                f"host calls: cudaLaunchKernel "
                f"{calls.get('cudaLaunchKernel', 0)} "
                f"({call_ms.get('cudaLaunchKernel', 0.0):.1f} ms), "
                f"cudaGraphLaunch {calls.get('cudaGraphLaunch', 0)} "
                f"({call_ms.get('cudaGraphLaunch', 0.0):.1f} ms) [{card}]")
            if graphs and not prof["calls"].get("cudaGraphLaunch", 0) > 0:
                raise AssertionError("the graphs-on profile shows no "
                                     "cudaGraphLaunch")


def _cast(tree, dtype):
    """Weights in ``dtype``; the fp32 norms stay fp32."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.float32 else tree.to(dtype)


def phase_logits(params, draft_len: int):
    """One decode step over 4 slots through the kernel and through the
    gather path, from the same prefilled pool, in bf16 and in fp32; then,
    through the kernel, one verify step over ``draft_len + 1`` tokens
    against that many sequential decode steps fed the same tokens.

    Kernel and gather differ only in the order attention's fp32 partial
    sums are taken; verify and sequential decode in that order and in the
    shapes of their products ([4 * (draft_len + 1), D] against [4, D], for
    which cuBLAS may pick other kernels). Tolerance
    |got - want| <= tol * (1 + |want|):
    - bf16, tol 6.25e-2: an attention output can then differ by one bf16
      rounding (2^-8 relative) per layer; 16 layers give 16 * 2^-8;
    - fp32, tol 1e-3: attention outputs agree to ~1e-6 (phase 2), and 16
      layers of random weights amplify that by far less than 1e3."""
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa
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
        before = dict(pa.launches)
        for kernel in ("cuda", "gather"):
            kv = {k: v.clone() for k, v in pool.items()}
            out[kernel], _ = kvc.paged_decode_step(
                weights, kv, tables, seq, tokens, mcfg, page, kernel)
        torch.cuda.synchronize()
        took = {k: v - before[k] for k, v in pa.launches.items()
                if v != before[k]}
        want = ("paged_decode_hopper" if dtype == torch.bfloat16
                else "paged_attention_kernel")
        if took != {want: mcfg.n_layers}:
            raise AssertionError(f"{dtype} decode step launched {took}")
        diff = (out["cuda"] - out["gather"]).abs()
        ok = bool((diff <= tol * (1 + out["gather"].abs())).all())
        same = int((out["cuda"].argmax(-1) == out["gather"].argmax(-1))
                   .sum())
        log(f"  decode-step logits {str(dtype):<14} 4 slots at {lens} "
            f"tokens: max |kernel - gather| {float(diff.max()):.4e} (max "
            f"|logit| {float(out['gather'].abs().max()):.3f}, tol {tol} * "
            f"(1 + |ref|)); argmax equal in {same}/4 rows; {want} x "
            f"{mcfg.n_layers}")
        if not ok:
            raise AssertionError(f"kernel and gather decode logits disagree "
                                 f"in {dtype}")
        verify_vs_decode(weights, pool, tables, seq, tokens, mcfg, page,
                         draft_len, tol, g)
        graph_vs_eager(weights, pool, tables, seq, tokens, mcfg, page,
                       draft_len, g)
        del weights, pool, kv, out


def replayed(fn):
    """``fn()`` captured into a CUDA graph, after one eager warm run on a
    side stream, and replayed once: the graph's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    return out


def graph_vs_eager(weights, pool, tables, seq, first, mcfg, page, draft_len,
                   g):
    """One decode step and one verify step through the kernel, run eagerly
    and replayed from a captured CUDA graph, each on its own copy of the
    prefilled pool (a step writes its tokens' K/V in place, the same values
    at every run): are the logits bit-identical? A capture changes how the
    kernels are launched; whether cuBLAS picks other GEMM kernels under
    capture is what this shows."""
    from ray_torch.serve.llm import kv_cache as kvc

    drafts = torch.randint(0, 32000, (first.shape[0], draft_len),
                           generator=g, device=first.device)
    span = torch.cat([first[:, None], drafts], dim=1)
    for name, step, toks in (("decode", kvc.paged_decode_step, first),
                             ("verify", kvc.paged_verify_step, span)):
        def run(kv, step=step, toks=toks):
            return step(weights, kv, tables, seq, toks, mcfg, page,
                        "cuda")[0]

        want = run({k: v.clone() for k, v in pool.items()})
        kv = {k: v.clone() for k, v in pool.items()}
        got = replayed(lambda: run(kv))
        torch.cuda.synchronize()
        log(f"  {name}-step logits {str(mcfg.dtype):<14} replayed from a "
            f"captured graph vs eager: bit-identical {torch.equal(got, want)}"
            f", max difference {float((got - want).abs().max()):.3e}")


def verify_vs_decode(weights, pool, tables, seq, first, mcfg, page,
                     draft_len, tol, g):
    """One ``paged_verify_step`` over [first, draft_len random tokens]
    against ``draft_len + 1`` sequential ``paged_decode_step``s fed the same
    tokens, each on its own copy of the prefilled pool, through the kernel:
    logits[:, t] of the verify step are what decode computes after
    consuming tokens[:, :t + 1]."""
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import kv_cache as kvc

    b, t = first.shape[0], draft_len + 1
    drafts = torch.randint(0, 32000, (b, draft_len), generator=g,
                           device=first.device)
    tokens = torch.cat([first[:, None], drafts], dim=1)
    before = dict(pa.launches)
    kv = {k: v.clone() for k, v in pool.items()}
    got, lens = kvc.paged_verify_step(weights, kv, tables, seq, tokens, mcfg,
                                      page, "cuda")
    kv = {k: v.clone() for k, v in pool.items()}
    steps, pos = [], seq
    for i in range(t):
        logits, pos = kvc.paged_decode_step(weights, kv, tables, pos,
                                            tokens[:, i], mcfg, page, "cuda")
        steps.append(logits)
    want = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in pa.launches.items()
            if v != before[k]}
    hkv = mcfg.n_kv_heads
    routes = {pa.route(mcfg.n_heads // hkv * n, mcfg.head_dim, page,
                       tables.shape[1], mcfg.dtype) for n in (t, 1)}
    if len(routes) != 1 or took != {routes.pop(): (t + 1) * mcfg.n_layers}:
        raise AssertionError(f"verify + {t} decode steps launched {took}")
    if not torch.equal(lens, pos):
        raise AssertionError(f"verify lens {lens} vs decode {pos}")
    diff = (got - want).abs()
    ok = bool((diff <= tol * (1 + want.abs())).all())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    # how close greedy decoding sits to a tie: the gap between each row's
    # two largest logits, against the largest difference seen
    top2 = want.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).flatten()
    log(f"  verify-step logits {str(mcfg.dtype):<14} {b} slots x T={t} vs "
        f"{t} sequential decode steps: max |verify - decode| "
        f"{float(diff.max()):.4e} (max |logit| {float(want.abs().max()):.3f}"
        f", tol {tol} * (1 + |ref|)); argmax equal in {same}/{b * t}; "
        f"top-2 logit gap median {float(gaps.median()):.4e}, below the max "
        f"difference in {int((gaps < diff.max()).sum())}/{b * t} rows; "
        f"{took}")
    if not ok:
        raise AssertionError(f"verify and sequential decode logits disagree "
                             f"in {mcfg.dtype}")


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


def library_attention(q, k, v, do, plain_grads, sm, card):
    """``scaled_dot_product_attention`` on [B, H, T, D] views of the same
    inputs (causal), under each backend that takes them: its gradients
    held to the plain backward's, then its forward, its backward alone
    (``autograd.grad`` of a kept forward) and the two through autograd,
    timed with CUDA events, and the forward and the backward also by their
    kernels' device time (``device_ms``: what the card spends, whatever
    the host adds; a slow host can make the backward's event time its own
    dispatch time). The port never calls it: it is the yardstick. Returns
    ``{backend: (fwd_device_ms, bwd_device_ms, fwd_bwd_ms)}``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    found = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        name = backend.name
        leaves = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]
        with sdpa_kernel(backend):
            try:
                o = sdpa(*leaves, is_causal=True, scale=sm)
                grads = torch.autograd.grad(o, leaves, doh, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError as e:
                log(f"  library {name}: does not take the shape "
                    f"({str(e).splitlines()[0][:120]})")
                continue
            err = max(float((g.transpose(1, 2).float() - w.float())
                            .abs().max())
                      for g, w in zip(grads, plain_grads))
            def fwd():
                return sdpa(qh, kh, vh, is_causal=True, scale=sm)

            def bwd():
                return torch.autograd.grad(o, leaves, doh, retain_graph=True)

            both = time_ms(lambda: torch.autograd.grad(
                sdpa(*leaves, is_causal=True, scale=sm), leaves, doh))
            times = (time_ms(fwd), device_ms(fwd), time_ms(bwd),
                     device_ms(bwd))
        found[name] = (times[1], times[3], both)
        log(f"  library {name}: forward {times[0]:.4f} ms (device "
            f"{times[1]:.4f}), backward {times[2]:.4f} ms (device "
            f"{times[3]:.4f}), forward + backward {both:.4f} ms; gradients "
            f"vs plain max_abs_err={err:.3e} [{card}]")
        del o, grads, leaves
    if not found:
        raise AssertionError("no scaled_dot_product_attention backend took "
                             "the training shape")
    return found


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
        # the training shape; a small D=64 one; T=200 (a ragged second
        # 128-row tile) with B=2 (a tile load must not read into the next
        # batch) and H=3 (the head stride), at D=128 and at D=32 (64-byte
        # rows, the narrower swizzle)
        for b, t, h, d in ((4, 2048, 16, 128), (1, 256, 4, 64),
                           (2, 200, 3, 128), (2, 200, 3, 32)):
            for causal in (True, False):
                q, k, v, do = flash_case(b, t, h, d, dtype,
                                         seed=t + d + causal)
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
    library = library_attention(q, k, v, do, fa.flash_backward_reference(
        q, k, v, do, lse, delta, True, sm), sm, card)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

    def ours_fwd_bwd():
        fa.flash_attention(*leaves).backward(do)

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
        "ours_fwd_bwd": time_ms(ours_fwd_bwd),
    }
    bounds = {
        "flash_fwd": flash_bound(shape, torch.bfloat16, True, 2, 4, 1),
        "flash_bwd_dkdv": flash_bound(shape, torch.bfloat16, True, 4, 6, 2),
        "flash_bwd_dq": flash_bound(shape, torch.bfloat16, True, 3, 5, 2),
    }
    pair_bound, pair_by = flash_bound(shape, torch.bfloat16, True, 5, 7, 2)
    plain = {"flash_fwd": t["plain_fwd"], "flash_bwd_dkdv": t["plain_bwd"],
             "flash_bwd_dq": t["plain_bwd"]}
    # the fastest backend by device time: its forward for the forward
    # kernel, its backward (which computes what the pair computes) for each
    # backward kernel
    fwd_name = min(library, key=lambda n: library[n][0])
    bwd_name = min(library, key=lambda n: library[n][1])
    best = {"flash_fwd": (fwd_name, library[fwd_name][0]),
            "flash_bwd_dkdv": (bwd_name, library[bwd_name][1]),
            "flash_bwd_dq": (bwd_name, library[bwd_name][1])}
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:26",
                "flash_bwd_dkdv": "ray_tpu/ops/attention.py:120",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:172"}
    dev = {
        "flash_fwd": device_ms(lambda: fa.flash_fwd(q, k, v, True, sm)),
        "flash_bwd_dkdv": device_ms(lambda: fa.flash_bwd_dkdv(
            q, k, v, do, lse, delta, True, sm)),
        "flash_bwd_dq": device_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, True, sm)),
    }
    timings = []
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        bound, bound_by = bounds[name]
        lib_name, lib_ms = best[name]
        kernel = fa.kernel_name(name, torch.bfloat16)
        log(f"  time {name:<15} B=4 T=2048 H=16 D=128 causal bf16 "
            f"({kernel}): kernel {t[name]:.4f} ms (device {dev[name]:.4f}), "
            f"plain {plain[name]:.4f} ms, bound {bound:.4f} ms ({bound_by}),"
            f" library {lib_ms:.4f} ms device ({lib_name}) [{card}]")
        timings.append({"name": name, "route": "cuda", "kernel": kernel,
                        "source": "ray_torch/ops/csrc/flash_attention.cu",
                        "replaces": replaces[name],
                        "max_abs_err": errs[name], "ms": t[name],
                        "device_ms": dev[name],
                        "plain_ms": plain[name], "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        "library": f"scaled_dot_product_attention/{lib_name}"})
    log(f"  time backward pair (dk/dv + dq): kernels "
        f"{t['flash_bwd_dkdv'] + t['flash_bwd_dq']:.4f} ms (device "
        f"{dev['flash_bwd_dkdv'] + dev['flash_bwd_dq']:.4f}), bound "
        f"{pair_bound:.4f} ms ({pair_by}), plain {t['plain_bwd']:.4f} ms, "
        f"library backward {library[bwd_name][1]:.4f} ms device ({bwd_name}) "
        f"[{card}]")
    both = min(library, key=lambda n: library[n][2])
    log(f"  time forward + backward through autograd: ours "
        f"{t['ours_fwd_bwd']:.4f} ms, scaled_dot_product_attention "
        f"{library[both][2]:.4f} ms ({both}) [{card}]")
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
    prof = device_profile(lambda: step(state, batch), top=14)
    busy_ms, by_kernel = prof["busy_ms"], prof["by_kernel"]
    flash_ms = {name: sum(ms for key, ms in by_kernel.items() if name in key)
                for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    # the bf16 step runs the Hopper kernel of each op and no other
    for name in flash_ms:
        ran = sorted({m for key in by_kernel
                      for m in re.findall(rf"{name}_(?:hopper|kernel)", key)})
        if ran != [fa.kernel_name(name, torch.bfloat16)]:
            raise AssertionError(f"the profiled step ran {ran} for {name}")
    log(f"  flash kernels in the profiled step: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in flash_ms.items())
        + f"; together {sum(flash_ms.values()):.2f} ms = "
        f"{100 * sum(flash_ms.values()) / busy_ms:.1f}% of the device time "
        f"[{card}]")

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


# ---------------------------------------------------------------------------
# phase 8: int8_matmul on the card
# ---------------------------------------------------------------------------

def phase_int8(card: str):
    """``mlp_impl="int8"``'s product, forward and backward, at the training
    shape (x [B * T, dim] @ w_gate [dim, ffn] of llama3_1b at batch 4 x
    2048) and at an 8-row decode shape, against the dequantized plain
    product. The forward must be exact (an int32 product of the same int8
    operands, scaled by the same fp32 factor); the backward is held to
    fp32 products of the operands dequantized to bf16 (the reference's
    straight-through backward) within the bf16 tolerance: the two differ
    in the order of fp32 sums and in the output's rounding to bf16, half
    an ulp (2^-9 relative). First the card says
    which row counts ``torch._int_mm`` refuses: the product must pad
    exactly those."""
    from ray_torch.models import llama

    cfg = llama.llama3_1b(mlp_impl="int8")
    k, n = cfg.dim, cfg.ffn_dim
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    for m, kk, nn in ((1, k, n), (8, k, n), (16, k, n), (17, k, n),
                      (24, k, n), (8192, k, n), (32, k - 4, n),
                      (32, k, n - 4)):
        a = torch.randint(-127, 128, (m, kk), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (kk, nn), generator=g, device=dev,
                          dtype=torch.int8)
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            answer = "takes it"
        except RuntimeError as e:
            answer = f"refuses it ({str(e).splitlines()[0][:100]})"
        try:
            rows = llama._int_mm_rows(m, kk, nn, dev)
            ours = f"int8_matmul runs it at {rows} rows"
            refused = rows != m
        except ValueError as e:
            ours, refused = f"int8_matmul raises ({e})", True
        log(f"  torch._int_mm [{m}, {kk}] @ [{kk}, {nn}]: the card {answer}; "
            f"{ours}")
        if answer.startswith("refuses") != refused:
            raise AssertionError(f"int8_matmul at [{m}, {kk}] @ [{kk}, {nn}]: "
                                 f"{ours}, but the card {answer}")
    for m in (TRAIN_BATCH * TRAIN_SEQ, 8):
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (0.02 * torch.randn(k, n, generator=g, device=dev)).to(
            torch.bfloat16)
        dout = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = llama._mlp_matmul(xl, wl, cfg)
        out.backward(dout)
        out = out.detach()
        xq, xs = llama._quantize_int8(x)
        wq, ws = llama._quantize_int8(w)
        # integer sums below 2^53: exact in float64
        want = ((xq.double() @ wq.double()).float() * (xs * ws)).to(
            torch.bfloat16)
        xd, wd = ((t.float() * s).to(torch.bfloat16).float()
                  for t, s in ((xq, xs), (wq, ws)))
        want_dx, want_dw = dout.float() @ wd.T, xd.T @ dout.float()
        torch.cuda.synchronize()
        errs = [float((got.float() - ref.float()).abs().max())
                for got, ref in ((out, want), (xl.grad, want_dx),
                                 (wl.grad, want_dw))]
        tol = TOL[torch.bfloat16]
        ok = (torch.equal(out, want)
              and all(bool(((got.float() - ref).abs()
                            <= tol * (1 + ref.abs())).all())
                      for got, ref in ((xl.grad, want_dx),
                                       (wl.grad, want_dw))))
        log(f"  int8_matmul x [{m}, {k}] @ w [{k}, {n}] bf16: forward "
            f"max_abs_err={errs[0]:.3e} (exact), dx {errs[1]:.3e}, dw "
            f"{errs[2]:.3e} (tol {tol:g} * (1 + |ref|)) "
            f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            raise AssertionError(f"int8_matmul disagrees with the "
                                 f"dequantized product at {m} rows")
        del x, w, dout, xl, wl, out, want, want_dx, want_dw, xd, wd


# ---------------------------------------------------------------------------
# phase 10: the KV tier at full width
# ---------------------------------------------------------------------------

def _wait_for(pred, timeout: float = 120.0) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _chain(eng, tokens) -> list:
    """(chain digest, pool page) of each of ``tokens``' full pages, the page
    None where the prefix index does not hold it (read without taking a
    reference)."""
    from ray_torch.serve.llm import kv_cache as kvc

    ps, digest, out = eng.cfg.page_size, b"", []
    for i in range((len(tokens) - 1) // ps):
        digest = kvc._chain_digest(digest, tokens[i * ps:(i + 1) * ps])
        out.append((digest, eng.allocator._index.get(digest)))
    return out


def _pool_pages(eng, pages) -> tuple:
    """A device copy of K and V of ``pages``."""
    idx = torch.tensor(pages, device=eng.kv["k"].device)
    return tuple(eng.kv[n].index_select(2, idx).clone() for n in ("k", "v"))


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def tier_prompts() -> dict:
    """Prompts A, B and C of phase 10: 1,000 tokens each with BOS (7 full
    pages of 128), sharing no full page."""
    words = ("alpha bravo charlie delta echo foxtrot golf hotel india "
             "juliet kilo lima mike november oscar papa quebec romeo ")
    return {name: (f"{name}: " + words * 10)[:999]
            for name in ("A", "B", "C")}


def tier_arm(card: str, params, codec: str):
    """One engine with the tier on (CUDA graphs on) serves prompt A (~1000
    tokens, 7 full pages) cold and again while its prefix is resident; two
    distinct prompts then evict and spill A's chain; A returns and restores
    it. Returns what the arm measured."""
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMServer

    max_tokens = 32
    cfg = serve_config(max_tokens=max_tokens, kv_tier_enabled=True,
                       kv_tier_codec=codec, prefix_cache_max_pages=8)
    prompts = tier_prompts()
    srv = LLMServer(cfg, params=params, rng_seed=0)
    eng = srv.engine
    toks_a = eng.tokenizer.encode(prompts["A"])
    captured = eng._graphs.captures
    runs = {}
    chunks = []                             # (signature, start) replayed
    replay = eng._replay_prompt

    def recorded(sig, body, *values):
        if sig[0] == "chunk":
            chunks.append((sig, int(values[3][0])))
        return replay(sig, body, *values)

    eng._replay_prompt = recorded

    def serve(name, prompt):
        before = eng.engine_stats()
        rid = eng.submit(prompt, max_tokens=max_tokens, temperature=0.0)
        req = eng._requests[rid]
        out = eng.result(rid, timeout=300.0)
        if out["error"] is not None or len(out["tokens"]) != max_tokens:
            raise AssertionError(f"tier {codec} {name}: {out['error']}, "
                                 f"{len(out['tokens'])} tokens")
        after = eng.engine_stats()
        runs[name] = {"tokens": out["tokens"], "ttft": out["ttft_s"],
                      "req": req, "out": out,
                      "delta": {k: after[k] - before[k] for k in before
                                if isinstance(after[k], int)}}
        return runs[name]

    try:
        for name in pa.launches:            # count this phase's traffic
            pa.launches[name] = 0
        serve("cold", prompts["A"])
        pages = [p for _, p in _chain(eng, toks_a)]
        if len(pages) != 7 or None in pages:
            raise AssertionError(f"A's chain is not cached: {pages}")
        snapshot = _pool_pages(eng, pages)
        serve("resident", prompts["A"])
        if runs["resident"]["delta"]["prefix_hit_tokens"] != 7 * 128:
            raise AssertionError(f"resident run: {runs['resident']['delta']}")
        serve("B", prompts["B"])
        serve("C", prompts["C"])
        chain = _chain(eng, toks_a)
        if not _wait_for(lambda: all(
                p is None and d.hex() in eng._kv_tier._by_digest
                for d, p in chain)):
            raise AssertionError(f"A's chain did not spill: "
                                 f"{eng.engine_stats()['spilled_pages']}")
        before = dict(pa.launches)
        made = len(eng._prompt_programs)
        del chunks[:]
        with handed_payloads() as handed:
            restored = serve("restored", prompts["A"])
        launches = {k: pa.launches[k] - before[k] for k in pa.launches}
        suffix = list(chunks)
        made = len(eng._prompt_programs) - made
        total = dict(pa.launches)
        stats = eng.engine_stats()
        after = [p for _, p in _chain(eng, toks_a)]
        got = _pool_pages(eng, after)
        graphs = (eng._graphs.captures, eng._graphs.replays)
        check_prompt_programs(f"tier {codec}", eng, True)
        n_chunk = prompt_captures(eng)["chunk"]
    finally:
        srv.shutdown()
        del eng._replay_prompt
    req, delta = restored["req"], restored["delta"]
    if not (delta["restored_pages"] >= 7 and req.restore_pages == 7
            and delta["tier_hit_tokens"] == 7 * 128
            and delta["attn_chunk_dispatches"] >= 1
            and delta["prefix_hit_tokens"] == 0):
        raise AssertionError(f"tier {codec}: the restore did not bring A's "
                             f"7 pages back: {delta}")
    if graphs[0] != captured + len(eng._prompt_programs) \
            or not graphs[1] > 0:
        raise AssertionError(f"graphs: {graphs} against {captured} captured")
    # the restored request's suffix: one chunk graph, captured before,
    # replayed from the restored frontier
    frontier = 7 * cfg.page_size
    if made or suffix != [(("chunk", eng._bucket(len(toks_a) - frontier)),
                           frontier)]:
        raise AssertionError(f"tier {codec}: the restored run replayed "
                             f"chunks {suffix} and captured {made} graphs")
    want = planned_launches(cfg, delta)
    want_all = planned_launches(cfg, stats, n_chunk)
    if launches != want or total != want_all \
            or not want["paged_chunk_hopper"] \
            or not want["paged_decode_hopper"] \
            or want["paged_attention_kernel"]:
        raise AssertionError(f"tier {codec}: restored run launched "
                             f"{launches} (planned {want}); the phase "
                             f"{total} (planned {want_all})")
    # attribution: no restore stage but in the restored run, whose split
    # is its request's: the tokens and bytes of 7 pages, the payloads the
    # store handed out, overlap = restore_ms - loop-blocked ms
    for name, run in runs.items():
        prompt = prompts.get(name, prompts["A"])
        check_waterfall(f"tier {codec} {name}", run["out"],
                        len(eng.tokenizer.encode(prompt)),
                        restored=name == "restored")
    mcfg = cfg.model_config
    itemsize = torch.empty((), dtype=mcfg.dtype).element_size()
    page_bytes = (mcfg.n_layers * mcfg.n_kv_heads * cfg.page_size
                  * mcfg.head_dim * itemsize * 2)
    r = {s["stage"]: s for s in restored["out"]["stages"]}["restore"]["attrs"]
    want_r = {"restored_tokens": req.restore_pages * cfg.page_size,
              "restore_bytes": req.restore_pages * page_bytes,
              "bytes_wire": sum(handed),
              "overlap_ms": round(max(0.0, req.restore_ms
                                      - req.restore_blocked_ms), 3),
              "partial": False}
    if {k: r[k] for k in want_r} != want_r or len(handed) != 7 \
            or not r["bytes_wire"] > 0:
        raise AssertionError(f"tier {codec}: restore stage {r}, want "
                             f"{want_r} ({len(handed)} payloads handed out)")
    # restored pages against the spilled ones, bit for bit
    same = all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, snapshot))
    return {"cfg": cfg, "runs": runs, "launches": launches, "total": total,
            "want": want, "stats": stats, "same": same, "eng": eng,
            "pages": after, "snapshot": snapshot, "suffix": suffix}


@contextlib.contextmanager
def handed_payloads():
    """The bytes of every page payload the tier store hands a restore
    stream meanwhile (K's and V's together, from the payloads
    themselves: an encoded page's data and scale, a raw page's array)."""
    from ray_torch.serve.llm import kv_tier

    sizes = []
    fetch = kv_tier.ChainStream._fetch_chunk

    def spy(stream, chunk, blobs):
        items = fetch(stream, chunk, blobs)
        for pk, pv, encoded, _ in items:
            sizes.append(sum(len(p["data"]) + len(p.get("scale") or b"")
                             if encoded else p.nbytes for p in (pk, pv)))
        return items

    kv_tier.ChainStream._fetch_chunk = spy
    try:
        yield sizes
    finally:
        kv_tier.ChainStream._fetch_chunk = fetch


def tier_costs(eng, pages, snapshot, reps: int = 5) -> dict:
    """Per-page times of the tier's device work on the engine's own pool
    and helpers: the spill (gather + device -> host into pinned memory,
    until its event) and the restore (host -> device through pinned
    memory + the in-place scatter, until done), medians of ``reps``."""
    from ray_torch.serve.llm import engine as engine_mod

    n = len(pages)
    spill, restore = [], []
    host = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = eng._to_device(np.array(pages, np.int64))
        fetches = [engine_mod._Fetch(eng.kv[name].index_select(2, idx)
                                     .view(torch.int16))
                   for name in ("k", "v")]
        host = [f.wait() for f in fetches]
        spill.append((time.perf_counter() - t0) * 1e3 / n)
    k_np, v_np = (np.array(h) for h in host)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._scatter_pages(pages, k_np, v_np)   # the same bytes back
        torch.cuda.synchronize()
        restore.append((time.perf_counter() - t0) * 1e3 / n)
    got = _pool_pages(eng, pages)
    if not all(torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, snapshot)):
        raise AssertionError("a host round trip of the pool pages changed "
                             "them")
    return {"spill_ms": statistics.median(spill),
            "restore_ms": statistics.median(restore)}


def _spy_tier(eng):
    """Record each spilled page's pool content at its first spill (the
    allocator hook runs before any write that reuses the page) and the pool
    pages each restore scatter writes. Installed after ``start()``, so the
    warmup's trash-page write is not recorded."""
    spilled, restored = {}, []
    hook, scatter = eng._spill_capture, eng._scatter_pages

    def capture(evicted):
        for page, _digest, pos in evicted:
            if pos is not None and pos not in spilled:
                spilled[pos] = _pool_pages(eng, [page])
        hook(evicted)

    def write(pages, k_np, v_np):
        restored.extend(pages)
        scatter(pages, k_np, v_np)

    eng.allocator.spill_hook = capture
    eng._scatter_pages = write
    return spilled, restored


def tier_tiny(card: str):
    """llama_tiny fp32 with the tier on through the kernel (CUDA graphs on):
    a 5-full-page prompt cold, then restored once its 3-page chain head has
    spilled (at most 2 cached pages). Its tokens must equal the gather
    path's cold run, cold and restored, and its launches on
    ``paged_attention_kernel`` the plan of its stats. Then the int8 codec,
    which quantizes fp32 pages: each restored page's largest error against
    its (layer, kv head) group's scale / 127, of which rounding allows half.
    Returns {run: (cold tokens, restored tokens, stats, launches, worst
    error / (scale / 127), restored pages bit-identical)}."""
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa
    from ray_torch.serve.llm import LLMConfig, LLMEngine

    mcfg = llama.llama_tiny(vocab_size=512)
    params = llama.init_params(
        mcfg, torch.Generator(device="cuda").manual_seed(7), "cuda")
    long = "the quick brown fox jumps over the lazy dog " * 2   # 5 pages
    out = {}
    for run, kernel, tier, codec in (("gather", "gather", False, "lossless"),
                                     ("tier", "cuda", True, "lossless"),
                                     ("tier int8", "cuda", True, "int8")):
        cfg = LLMConfig(model_config=mcfg, device="cuda",
                        attention_kernel=kernel, max_batch_size=4,
                        page_size=16, num_pages=64, max_prompt_len=96,
                        max_seq_len=160, max_tokens=32,
                        prefix_cache_max_pages=2, kv_tier_enabled=tier,
                        kv_tier_codec=codec)
        eng = LLMEngine(cfg, params=params)
        eng.start()
        spilled, restored = _spy_tier(eng) if tier else ({}, [])
        try:
            for name in pa.launches:
                pa.launches[name] = 0
            cold = eng.generate(long, temperature=0.0)
            if tier and not _wait_for(
                    lambda: eng.engine_stats()["spilled_pages"] >= 3):
                raise AssertionError(f"{run}: nothing spilled")
            hot = eng.generate(long, temperature=0.0)
            stats = eng.engine_stats()
            launches = dict(pa.launches)
            got = [_pool_pages(eng, [p]) for p in restored]
        finally:
            eng.shutdown()
        for r in (cold, hot):
            if r["error"] is not None:
                raise AssertionError(f"{run}: {r['error']}")
        worst, same = 0.0, True
        for pos, pair in enumerate(got):
            for g, w in zip(pair, spilled[pos]):
                same = same and torch.equal(_bits(g), _bits(w))
                scale = w.abs().amax(dim=(2, 3, 4), keepdim=True) / 127.0
                worst = max(worst, float(((g - w).abs() / scale).max()))
        if tier:
            check_prompt_programs(run, eng, True)
            want = planned_launches(cfg, stats, prompt_captures(eng)["chunk"])
            if stats["restored_pages"] != 3 or len(got) != 3 \
                    or launches != want \
                    or not want["paged_attention_kernel"]:
                raise AssertionError(f"{run}: restored "
                                     f"{stats['restored_pages']} pages, "
                                     f"launches {launches}, planned {want}")
        out[run] = (cold["tokens"], hot["tokens"], stats, launches, worst,
                    same)
    return out


def restored_stages(out) -> str:
    """A restored request's stage ms and its restore split."""
    by = {s["stage"]: s for s in out["stages"]}
    r = by["restore"]["attrs"]
    return (", ".join(f"{n} {1e3 * (s['end'] - s['start']):.1f}"
                      for n, s in by.items())
            + f" ms; restore_ms {r['restore_ms']}, decode_ms "
            f"{r['decode_ms']}, overlap_ms {r['overlap_ms']}, bytes_wire "
            f"{r['bytes_wire']} of restore_bytes {r['restore_bytes']}, "
            f"restored_tokens {r['restored_tokens']}, partial "
            f"{r['partial']}")


def phase_tier(card: str):
    """Phase 10: the KV tier at full width (llama3_1b bf16, CUDA graphs on,
    phase 4's weights from seed 0) with the lossless codec and then raw
    pages, and llama_tiny fp32 against gather, with lossless and int8.
    Returns the launches of the lossless tier runs, by kernel (the bf16
    arm's and the fp32 one's)."""
    from ray_torch.models import llama
    from ray_torch.serve.llm import kv_cache as kvc
    from ray_torch.serve.llm import kv_codec

    cfg = serve_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg.model_config, gen, "cuda")
    arms = {codec: tier_arm(card, params, codec)
            for codec in ("lossless", "none")}
    a = arms["lossless"]
    runs, st = a["runs"], a["stats"]
    costs = tier_costs(a["eng"], a["pages"], a["snapshot"])
    log(f"  llama3_1b bf16, tier lossless: A cold, resident, then after B "
        f"and C spilled its chain, restored: restored pages "
        f"{runs['restored']['req'].restore_pages}, pool pages bit-identical "
        f"to the spilled ones {a['same']}; spilled_pages "
        f"{st['spilled_pages']}, restored_pages {st['restored_pages']}, "
        f"tier_hit_tokens {st['tier_hit_tokens']} [{card}]")
    log(f"  restored run launches {a['launches']} (planned {a['want']}); "
        f"phase {a['total']}; its suffix chunk replayed a chunk graph "
        f"(signature, start) {a['suffix']} [{card}]")
    same_tokens = runs["restored"]["tokens"] == runs["resident"]["tokens"]
    log(f"  greedy tokens: restored == resident {same_tokens}; cold == "
        f"resident {runs['cold']['tokens'] == runs['resident']['tokens']} "
        f"(cold chunk-prefills from 0, the others from 896) [{card}]")
    req = runs["restored"]["req"]
    log(f"  TTFT: A cold {1e3 * runs['cold']['ttft']:.1f} ms, resident hit "
        f"{1e3 * runs['resident']['ttft']:.1f} ms, restored "
        f"{1e3 * runs['restored']['ttft']:.1f} ms (B {1e3 * runs['B']['ttft']:.1f}"
        f", C {1e3 * runs['C']['ttft']:.1f} ms; C arrives as the 6 pages "
        f"B's end evicted are encoded on the engine loop); restore_ms "
        f"{req.restore_ms:.1f} (loop-blocked {req.restore_blocked_ms:.1f}, "
        f"codec decode {req.restore_decode_ms:.1f}, {req.restore_bytes} "
        f"bytes) [{card}]")
    log(f"  restored A's stages: " + restored_stages(runs["restored"]["out"])
        + f" [{card}]")
    page_mib = kvc.page_raw_nbytes(a["cfg"].model_config,
                                   a["cfg"].page_size) / 2**20
    log(f"  per page ({page_mib:g} MiB of K+V): spill device->host "
        f"{costs['spill_ms']:.3f} ms, restore host->device + scatter "
        f"{costs['restore_ms']:.3f} ms; encode p50 "
        f"{st['tier_encode_ms_p50']} ms, decode p50 "
        f"{st['tier_decode_ms_p50']} ms on the host; tier_codec_ratio "
        f"{st['tier_codec_ratio']} (random weights: less compressible KV "
        f"than trained ones), tier_bytes_shm {st['tier_bytes_shm']} "
        f"[{card}]")
    if not (a["same"] and same_tokens):
        raise AssertionError("lossless restore: pages or tokens differ")
    # int8 quantizes numpy floating types only, as the reference's codec
    # does, so a bf16 pool's pages are stored lossless: one of A's pages
    words = [w[:, :, :1].view(torch.int16).cpu().numpy().view(np.uint16)
             for w in a["snapshot"]]
    ek, ev = kv_codec.encode_pages(*words, "int8", dtype="bfloat16")[0]
    int8_lossless = (ek["mode"] == ev["mode"] == "lossless"
                     and all(np.array_equal(kv_codec.decode_page(e)
                                            .view(np.uint16), w)
                             for e, w in zip((ek, ev), words)))
    log(f"  tier int8 on the bf16 pool: a page is stored "
        f"{ek['mode']}/{ev['mode']}, decoded bit-identical {int8_lossless} "
        f"(the fp32 llama_tiny arm below carries the quantization bound) "
        f"[{card}]")
    if not int8_lossless:
        raise AssertionError("int8 on a bf16 pool: not stored lossless")
    c = arms["none"]
    cr, creq = c["runs"], c["runs"]["restored"]["req"]
    same_none = cr["restored"]["tokens"] == cr["resident"]["tokens"]
    log(f"  tier none (raw pages, no codec): TTFT A cold "
        f"{1e3 * cr['cold']['ttft']:.1f} ms, resident hit "
        f"{1e3 * cr['resident']['ttft']:.1f} ms, restored "
        f"{1e3 * cr['restored']['ttft']:.1f} ms; restore_ms "
        f"{creq.restore_ms:.1f} (loop-blocked {creq.restore_blocked_ms:.1f}"
        f"); pages bit-identical {c['same']}, restored tokens == resident "
        f"{same_none}; restored A's stages: "
        + restored_stages(cr["restored"]["out"]) + f" [{card}]")
    if not (c["same"] and same_none):
        raise AssertionError("raw restore: pages or tokens differ")
    tiny = tier_tiny(card)
    g, t, q = tiny["gather"], tiny["tier"], tiny["tier int8"]
    log(f"  llama_tiny fp32, tier lossless (kernel, graphs on): cold == "
        f"gather {t[0] == g[0]}, restored == gather {t[1] == g[0]} "
        f"({len(g[0])} tokens); restored pages bit-identical {t[5]}; "
        f"launches {t[3]} (planned from its stats) [{card}]")
    log(f"  llama_tiny fp32, tier int8: restored pages' worst |err| = "
        f"{q[4]:.3f} x scale/127 (rounding allows 0.5); restored == gather "
        f"{q[1] == g[0]} (reported) [{card}]")
    if not (t[0] == g[0] == t[1] and t[5]):
        raise AssertionError("fp32 tier: tokens differ from gather, or the "
                             "restored pages from the spilled ones")
    if not 0.0 < q[4] <= 0.5 + 1e-3:
        raise AssertionError(f"fp32 int8 arm: error {q[4]} x scale/127")
    return {k: n + t[3][k] for k, n in a["total"].items()}


# ---------------------------------------------------------------------------
# phase 11: request deadlines at full width
# ---------------------------------------------------------------------------

def fresh_tokens(rng, n: int) -> list[int]:
    """``n`` byte tokens from ``rng``: such prompts share no full page, so
    no prefix-cache hit joins them."""
    return [int(t) for t in rng.randint(0, 256, n)]


def pump(eng, pred, timeout: float = 120.0) -> None:
    """Engine loop passes on this thread, the loop not started, until
    ``pred()``: as the CPU tests drive it, so that no pass races an edit
    of a request's deadline."""
    end = time.monotonic() + timeout
    with torch.no_grad():
        while not pred():
            if time.monotonic() > end:
                raise AssertionError("the engine made no progress")
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


def pumped(eng, prompt, **kw) -> dict:
    """Serve ``prompt`` greedily by ``pump``; its result."""
    rid = eng.submit(prompt, temperature=0.0, **kw)
    pump(eng, lambda: eng._requests[rid].done)
    return eng.result(rid, timeout=30.0)


def shed_wave(cfg, params, prompts, expired=()) -> tuple:
    """A fresh engine over ``params``: every prompt submitted before the
    loop starts (those at the indices ``expired`` under a deadline 1 s
    past), then each result. Returns the results, the engine's stats and
    its free pages (with the cached prefix pages) before and after."""
    from ray_torch.core import deadline
    from ray_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params=params, rng_seed=0)
    try:
        base = eng.allocator.available()
        rids = []
        for i, prompt in enumerate(prompts):
            with deadline.scope(time.time() - 1.0 if i in expired else None):
                rids.append(eng.submit(prompt, temperature=0.0))
        eng.start()
        outs = [eng.result(r, timeout=300.0) for r in rids]
        stats = eng.engine_stats()
        free = eng.allocator.available()
    finally:
        eng.shutdown()
    return outs, stats, base, free


def deadline_shedding(card: str, cfg, params):
    """Phase 11 a: one wave of 24 prompts of 200-400 fresh tokens, 8 of
    them (every third) already past their deadline at submit, then the 16
    others alone on a fresh engine. The 8 end with "deadline exceeded"
    and no token, without a prefill; the 16's greedy tokens are those of
    the wave without them; the free pages come back."""
    rng = np.random.RandomState(11)
    prompts = [fresh_tokens(rng, rng.randint(200, 401)) for _ in range(24)]
    expired = set(range(2, 24, 3))
    t0 = time.perf_counter()
    mixed, stats, base, free = shed_wave(cfg, params, prompts, expired)
    survivors = [p for i, p in enumerate(prompts) if i not in expired]
    alone, alone_stats, base2, free2 = shed_wave(cfg, params, survivors)
    shed = [mixed[i] for i in sorted(expired)]
    kept = [o for i, o in enumerate(mixed) if i not in expired]
    same = [a["tokens"] == b["tokens"] for a, b in zip(kept, alone)]
    log(f"  (a) fp32, 24 requests x 16 tokens, 8 past their deadline: shed "
        f"{sum(o['error'] == 'deadline exceeded' for o in shed)} with "
        f"{sum(len(o['tokens']) for o in shed)} tokens, shed_expired "
        f"{stats['shed_expired']}; prefills {stats['prefills']} / "
        f"{alone_stats['prefills']} (the 16 alone), chunks "
        f"{stats['attn_chunk_dispatches']} / "
        f"{alone_stats['attn_chunk_dispatches']}; survivors' greedy tokens "
        f"identical to the 16 alone: {sum(same)}/16; free pages {base} -> "
        f"{free} ({base2} -> {free2} alone); "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not all(o["error"] == "deadline exceeded" and o["tokens"] == []
               and o["queue_wait_s"] is None for o in shed):
        raise AssertionError(f"expired requests: {shed}")
    if not (stats["shed_expired"] == 8 and alone_stats["shed_expired"] == 0
            and stats["prefills"] == alone_stats["prefills"] == 16
            and stats["attn_chunk_dispatches"]
            == alone_stats["attn_chunk_dispatches"]):
        raise AssertionError(f"shedding: {stats} against {alone_stats}")
    if not (all(o["error"] is None for o in kept + alone) and all(same)
            and free == base and free2 == base2):
        raise AssertionError("survivors' tokens or free pages differ")
    # attribution: a shed request waited and was never admitted; the
    # survivors' waterfalls are whole
    for o in shed:
        if stage_names(o) != ["queue"] \
                or o["stages"][0]["attrs"] != {"admitted": False}:
            raise AssertionError(f"shed request's stages {o['stages']}")
    for i, (o, p) in enumerate(zip(kept, survivors)):
        check_waterfall(f"(a) survivor {i}", o, len(p))
    log(f"  (a) stages: the 8 shed ['queue'] (admitted False), the 16 "
        f"survivors queue/prefill/decode: " + stage_line(stage_report(
            kept), ("queue", "prefill", "decode")) + f" [{card}]")


def dropped_stages(name, out, req) -> None:
    """A request dropped while admitted (mid-chunk or mid-restore): its
    stages are those ``engine_stages`` gives for its fields — ``queue``
    (admitted), ``restore`` if pages had landed, and no ``prefill`` or
    ``decode``."""
    from ray_torch.observability import attribution

    want = attribution.engine_stages(
        submitted_wall=req.submitted_wall, submitted_at=req.submitted_at,
        admitted_at=req.admitted_at, first_token_at=req.first_token_at,
        finished_at=req.finished_at, cached_tokens=req.cached_tokens,
        restored_tokens=req.restored_tokens,
        restore_bytes=req.restore_bytes, restore_ms=req.restore_ms,
        restore_wire_bytes=req.restore_wire_bytes,
        restore_decode_ms=req.restore_decode_ms,
        restore_overlap_ms=req.restore_overlap_ms,
        restore_partial=req.restore_partial,
        prompt_tokens=len(req.prompt_tokens),
        generated_tokens=len(req.generated))
    names = ["queue"] + (["restore"] if req.restored_tokens else [])
    if out["stages"] != want or stage_names(out) != names \
            or out["stages"][0]["attrs"] != {"admitted": True}:
        raise AssertionError(f"{name}: stages {out['stages']}, want {want}")


def drop_mid_chunk(card: str, cfg, params):
    """Phase 11 b, mid-chunk, driven by hand: a ~900-token prompt's
    deadline passes after its first chunk (a chunk graph replay); the
    next pass gives back its slot and pages, and its waiter gets
    "deadline exceeded" at once. The same prompt with no deadline on the
    same engine (whose next owner of those pages it is) must then give a
    fresh engine's fp32 tokens."""
    from ray_torch.core import deadline
    from ray_torch.serve.llm import LLMEngine

    prompt = fresh_tokens(np.random.RandomState(12), 900)
    eng = LLMEngine(cfg, params=params, rng_seed=0)
    try:
        base, slots = eng.allocator.available(), len(eng.free_slots)
        with deadline.scope(time.time() + 3600.0):
            rid = eng.submit(prompt, temperature=0.0)
        req = eng._requests[rid]
        with torch.no_grad():
            eng._admit()
            eng._prefill_chunks()
        first = (eng._prefilling == [req]
                 and req.prefill_pos == cfg.prefill_chunk
                 and ("chunk", cfg.prefill_chunk) in eng._prompt_programs
                 and eng._graphs.replays == 1)
        req.deadline = time.time() - 1.0
        with torch.no_grad():
            eng._prefill_chunks()
        t0 = time.perf_counter()
        out = eng.result(rid, timeout=30.0)
        wait_ms = 1e3 * (time.perf_counter() - t0)
        freed = (eng._prefilling == [] and len(eng.free_slots) == slots
                 and eng.allocator.available() == base and req.pages == [])
        stats = eng.engine_stats()
        again = pumped(eng, prompt)
    finally:
        eng.shutdown()
    fresh = LLMEngine(cfg, params=params, rng_seed=0)
    try:
        want = pumped(fresh, prompt)
    finally:
        fresh.shutdown()
    log(f"  (b) fp32 mid-chunk: after chunk 1 of 2 (a chunk graph replay: "
        f"{first}), deadline passed: slot and pages back {freed}, "
        f"shed_expired {stats['shed_expired']}, chunks "
        f"{stats['attn_chunk_dispatches']}, result() '{out['error']}' in "
        f"{wait_ms:.3f} ms; the prompt again on the same engine == a fresh "
        f"engine's tokens: {again['tokens'] == want['tokens']} "
        f"({len(want['tokens'])} tokens) [{card}]")
    if not (first and freed and stats["shed_expired"] == 1
            and stats["attn_chunk_dispatches"] == 1
            and out["error"] == "deadline exceeded" and out["tokens"] == []
            and wait_ms < 100.0):
        raise AssertionError(f"mid-chunk drop: first chunk {first}, freed "
                             f"{freed}, {out['error']} in {wait_ms} ms, "
                             f"{stats}")
    if not (again["error"] is None and want["error"] is None
            and again["tokens"] == want["tokens"]):
        raise AssertionError("the next owner of a dropped request's pages "
                             "differs from a fresh engine")
    dropped_stages("(b) mid-chunk", out, req)
    log(f"  (b) mid-chunk stages {stage_names(out)}, queue "
        f"{1e3 * (out['stages'][0]['end'] - out['stages'][0]['start']):.3f}"
        f" ms [{card}]")


def drop_mid_restore(card: str, params):
    """Phase 11 b, mid-restore, driven by hand, at phase 10's tier setup
    (bf16, lossless, at most 8 cached pages): A cold, resident, spilled by
    B and C; A again, whose deadline passes while it sits in _restoring:
    the next pass aborts its stream and gives back its slot and pages. A
    with no deadline then still restores its 7 pages and gives the
    resident run's tokens."""
    from ray_torch.core import deadline
    from ray_torch.serve.llm import LLMEngine

    cfg = serve_config(max_tokens=32, kv_tier_enabled=True,
                       kv_tier_codec="lossless", prefix_cache_max_pages=8)
    prompts = tier_prompts()
    eng = LLMEngine(cfg, params=params, rng_seed=0)
    try:
        toks_a = eng.tokenizer.encode(prompts["A"])
        runs = {name: pumped(eng, prompts[p]) for name, p in (
            ("A cold", "A"), ("A resident", "A"), ("B", "B"), ("C", "C"))}
        eng._kv_tier_flush(wait=True)
        spilled = all(p is None and d.hex() in eng._kv_tier._by_digest
                      for d, p in _chain(eng, toks_a))
        base, slots = eng.allocator.available(), len(eng.free_slots)
        shed0 = eng.stats["shed_expired"]
        with deadline.scope(time.time() + 3600.0):
            rid = eng.submit(prompts["A"], temperature=0.0)
        req = eng._requests[rid]
        with torch.no_grad():
            admitted = eng._admit()
        stream = req.restore_stream
        parked = (admitted == 1 and eng._restoring == [req]
                  and stream is not None)
        req.deadline = time.time() - 1.0
        with torch.no_grad():
            eng._restore_steps()
        out = eng.result(rid, timeout=30.0)
        freed = (eng._restoring == [] and eng._prefilling == []
                 and len(eng.free_slots) == slots
                 and eng.allocator.available() == base
                 and req.restore_stream is None and stream._aborted)
        shed = eng.stats["shed_expired"] - shed0
        closed = _wait_for(lambda: eng._kv_tier.stats()["streams"] == 0,
                           30.0)
        restored_before = eng.stats["restored_pages"]
        rid = eng.submit(prompts["A"], temperature=0.0)
        again_req = eng._requests[rid]
        pump(eng, lambda: again_req.done)
        again = eng.result(rid, timeout=30.0)
        restored = eng.stats["restored_pages"] - restored_before
    finally:
        eng.shutdown()
    same = again["tokens"] == runs["A resident"]["tokens"]
    log(f"  (b) bf16 mid-restore: A spilled {spilled}, parked in _restoring "
        f"{parked}; deadline passed: stream aborted, slot and pages back "
        f"{freed}, shed_expired +{shed}, result() '{out['error']}', streams "
        f"closed {closed}; A again restored {again_req.restore_pages} pages "
        f"(restored_pages +{restored}), tokens == resident {same} [{card}]")
    if not (spilled and parked and freed and shed == 1 and closed
            and out["error"] == "deadline exceeded" and out["tokens"] == []):
        raise AssertionError(f"mid-restore drop: spilled {spilled}, parked "
                             f"{parked}, freed {freed}, shed {shed}, "
                             f"{out['error']}")
    if not (again["error"] is None and again_req.restore_pages == 7
            and restored == 7 and same):
        raise AssertionError(f"A after the drop: {again['error']}, restored "
                             f"{again_req.restore_pages}, tokens == "
                             f"resident {same}")
    dropped_stages("(b) mid-restore", out, req)
    check_waterfall("(b) A after the drop", again, len(toks_a),
                    restored=True)
    log(f"  (b) mid-restore stages {stage_names(out)} (restored tokens "
        f"{req.restored_tokens}); A after the drop: "
        + restored_stages(again) + f" [{card}]")


def overload_run(cfg, params, prompts, budget=None) -> dict:
    """A fresh engine (started) takes every prompt at once, each under a
    deadline of its submit + ``budget`` seconds when one is given; one
    waiter thread a request, outside the deadline (a slotted request
    finishes late, as in the reference: it is not preempted)."""
    from ray_torch.core import deadline
    from ray_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params=params, rng_seed=0)
    eng.start()
    try:
        base = eng.allocator.available()
        subs = []
        t0 = time.perf_counter()
        for prompt in prompts:
            sub = time.time()
            with deadline.scope(None if budget is None else sub + budget):
                subs.append((eng.submit(prompt, temperature=0.0), sub))

        def wait(rid):
            return eng.result(rid, timeout=600.0), time.time()

        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            done = list(pool.map(wait, [rid for rid, _ in subs]))
        wall = time.perf_counter() - t0
        stats = eng.engine_stats()
        free = eng.allocator.available()
    finally:
        eng.shutdown()
    return {"outs": [o for o, _ in done], "returned": [t for _, t in done],
            "submitted": [s for _, s in subs], "wall": wall,
            "stats": stats, "base": base, "free": free}


def overload_line(name, run, budget, card) -> None:
    """One run's counts, goodput (the output tokens of requests finished
    on time, by submit + ``budget``, per second of wall) and the on-time
    requests' TTFT."""
    outs = run["outs"]
    late = [o for o in outs if o["error"] is None
            and o["latency_s"] > budget]
    ok = [o for o in outs if o["error"] is None
          and o["latency_s"] <= budget]
    gone = [(o, t - (s + budget)) for o, t, s in zip(
        outs, run["returned"], run["submitted"]) if o["error"]]
    past = [dt for o, dt in gone if o["queue_wait_s"] is None]
    ttft = [1e3 * o["ttft_s"] for o in ok] or [float("nan")]
    tokens = sum(len(o["tokens"]) for o in ok)
    log(f"  (c) {name}: finished {len(ok) + len(late)} ({len(ok)} on time, "
        f"{len(late)} late), shed while waiting {len(past)}, dropped "
        f"mid-prefill {len(gone) - len(past)}; goodput "
        f"{tokens / run['wall']:.1f} output tokens/s ({tokens} tokens in "
        f"{run['wall']:.3f} s; every finished request's "
        f"{sum(len(o['tokens']) for o in outs) / run['wall']:.1f}); TTFT on "
        f"time p50 {np.percentile(ttft, 50):.1f} ms, p99 "
        f"{np.percentile(ttft, 99):.1f} ms"
        + (f"; a shed waiter's return past its deadline p50 "
           f"{1e3 * statistics.median(past):.3f} ms, max "
           f"{1e3 * max(past):.3f} ms" if past else "")
        + f" [{card}]")


def deadline_overload(card: str, params):
    """Phase 11 c: 96 requests of 256 fresh tokens, 64 tokens each, at
    once onto 32 slots (bf16): without deadlines (D = their latency p50),
    then each under submit + D, then under submit + 3D/4. The requests
    are admitted in three batches of 32, each when the one before ends,
    at about 0, D/2 and D: with D a batch's admission falls on its
    deadline, with 3D/4 the third batch still waits at its deadline. Only
    invariants are asserted: every request ends with its tokens or
    "deadline exceeded", which ``shed_expired`` counts, and the free
    pages come back."""
    cfg = serve_config(max_tokens=64)
    rng = np.random.RandomState(13)
    prompts = [fresh_tokens(rng, 256) for _ in range(96)]
    free_run = overload_run(cfg, params, prompts)
    budget = statistics.median(o["latency_s"] for o in free_run["outs"])
    runs = {"no deadlines": free_run,
            "submit + D": overload_run(cfg, params, prompts, budget),
            "submit + 3D/4": overload_run(cfg, params, prompts,
                                          0.75 * budget)}
    log(f"  (c) bf16 overload: 96 requests of 256 tokens x 64 tokens onto "
        f"{cfg.max_batch_size} slots; D = latency p50 without deadlines = "
        f"{1e3 * budget:.1f} ms [{card}]")
    overload_line("no deadlines, counted by D", free_run, budget, card)
    overload_line("no deadlines, counted by 3D/4", free_run, 0.75 * budget,
                  card)
    overload_line("deadline submit + D", runs["submit + D"], budget, card)
    overload_line("deadline submit + 3D/4", runs["submit + 3D/4"],
                  0.75 * budget, card)
    for name, run in runs.items():
        log(f"  (c) {name}, stages: " + stage_line(
            stage_report(run["outs"]), ("queue", "prefill", "decode"))
            + f" [{card}]")
    for name, run in runs.items():
        errors = [o["error"] for o in run["outs"]]
        if not (all(e in (None, "deadline exceeded") for e in errors)
                and all(o["tokens"] == [] for o in run["outs"]
                        if o["error"])
                and run["stats"]["shed_expired"]
                == errors.count("deadline exceeded")
                and run["free"] == run["base"]):
            raise AssertionError(f"overload, {name}: errors "
                                 f"{set(errors)}, shed_expired "
                                 f"{run['stats']['shed_expired']}, free "
                                 f"pages {run['base']} -> {run['free']}")
    if free_run["stats"]["shed_expired"]:
        raise AssertionError("requests without a deadline were shed")


def phase_deadlines(card: str):
    """Phase 11: request deadlines at full width (llama3_1b at the serve
    settings, CUDA graphs on, phase 4's weights from seed 0): (a) shedding
    in fp32, (b) drops mid-chunk (fp32) and mid-restore (bf16, tier on),
    driven by hand, (c) an overload wave in bf16 with and without
    deadlines. Returns the phase's launches by kernel, every engine's
    warmup and first-use captures included."""
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(serve_config().model_config, gen, "cuda")
    fp32 = _cast(params, torch.float32)
    cfg32 = serve_config(max_tokens=16, model_config=llama.llama3_1b(
        max_seq_len=2048, dtype=torch.float32))
    for name in pa.launches:
        pa.launches[name] = 0
    t0 = time.perf_counter()
    deadline_shedding(card, cfg32, fp32)
    t1 = time.perf_counter()
    drop_mid_chunk(card, cfg32, fp32)
    del fp32
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    drop_mid_restore(card, params)
    t3 = time.perf_counter()
    deadline_overload(card, params)
    launches = dict(pa.launches)
    log(f"  phase 11 launches (from its first engine's warmup) {launches}; "
        f"(a) {t1 - t0:.1f} s, (b) mid-chunk {t2 - t1:.1f} s, mid-restore "
        f"{t3 - t2:.1f} s, (c) {time.perf_counter() - t3:.1f} s [{card}]")
    if not all(launches.values()):
        raise AssertionError(f"phase 11 launched a paged kernel no time: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: failover continuations, the journal and spans at full width
# ---------------------------------------------------------------------------

FAILOVER_KS = (1, 24, 47)      # resume points: tokens already streamed
FAILOVER_TOKENS = 48


def failover_prompt() -> str:
    """Phase 12's prompt: 749 fresh letters, 750 tokens with BOS: 5 full
    pages of 128 and 110 tokens of a sixth, which the first 18 generated
    tokens fill, so the sixth full page of a continuation at k = 24 lies
    past the prompt."""
    rng = np.random.RandomState(17)
    return "".join(rng.choice(list("abcdefghij klmnopqrst uvwxyz"), 749))


def first_tokens_ms(req, k: int) -> float:
    """ms from submit to a request's ``k``-th token, at host record time."""
    return 1e3 * (req.first_token_at - req.submitted_at
                  + sum(req.itl_gaps[:k - 1]))


class Journal:
    """The port's journal (a local sink) and spans (a span flusher), with
    the events each engine's lifetime added held to its own counts."""

    def __init__(self):
        from ray_torch.observability import events, tracing

        self.events, self.spans = [], []
        self._ev, self._tr = events, tracing
        events.set_local_sink(self.events.append)
        tracing.register_flusher(self.spans.extend)

    def mark(self) -> int:
        return len(self.events)

    def kinds(self, since: int = 0, kind=None) -> list:
        return [e for e in self.events[since:]
                if kind is None or e["kind"] == kind]

    def check_engine(self, name, eng, since: int, warmed: int) -> int:
        """The ``mid_traffic_compile`` events since ``since`` (an engine's
        start) must be its ``mid_traffic_compiles``; none came from its
        warmup (``warmed``: the mark after ``start()``)."""
        if warmed != since:
            raise AssertionError(f"{name}: warmup journaled "
                                 f"{self.events[since:warmed]}")
        got = len(self.kinds(since, "mid_traffic_compile"))
        want = eng.engine_stats()["mid_traffic_compiles"]
        if got != want:
            raise AssertionError(f"{name}: {got} mid_traffic_compile events "
                                 f"against mid_traffic_compiles {want}")
        return got

    def close(self) -> None:
        from ray_torch.core import config

        self._tr.flush()
        self._tr.register_flusher(None)
        self._ev.clear_local_sink()
        config.reset_config()


def started(journal, make):
    """``make()`` builds and starts an engine (or a server); returns it and
    the journal's marks before and after (warmup must journal nothing)."""
    since = journal.mark()
    obj = make()
    return obj, since, journal.mark()


def started_engine(cfg, params):
    """A started ``LLMEngine`` over ``params`` (its warmup run)."""
    from ray_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params=params, rng_seed=0)
    eng.start()
    return eng


def failover_want(journal, cfg, params):
    """The uninterrupted run: a cache-off engine serves the prompt x 48
    tokens. Returns the tokens, the ms to each resume point's token and
    the engine's mid-traffic first uses."""
    eng, since, warmed = started(journal,
                                 lambda: started_engine(cfg, params))
    try:
        rid = eng.submit(failover_prompt(), temperature=0.0)
        req = eng._requests[rid]
        out = eng.result(rid, timeout=300.0)
        mids = journal.check_engine("uninterrupted", eng, since, warmed)
    finally:
        eng.shutdown()
    if out["error"] is not None or len(out["tokens"]) != FAILOVER_TOKENS:
        raise AssertionError(f"uninterrupted run: {out['error']}, "
                             f"{len(out['tokens'])} tokens")
    return (out["tokens"], {k: first_tokens_ms(req, k) for k in FAILOVER_KS},
            mids)


def continuation(eng, want, k, **kw) -> tuple:
    """A continuation at ``k`` of the phase's prompt through ``submit``
    and ``result``; (result, request)."""
    rid = eng.submit(failover_prompt(), resume_tokens=want[:k],
                     max_tokens=FAILOVER_TOKENS - k, temperature=0.0, **kw)
    req = eng._requests[rid]
    return eng.result(rid, timeout=300.0), req


def failover_cold(card, journal, cfg, params, want, to_k):
    """(a) fp32 cold recompute, (e) spans and (f) the server, on one
    cache-off ``LLMServer``'s engine: continuations at k = 1 and 24
    submitted inside a client span, 47 outside; then a stream with a
    resume payload, as a continuation and past ``failover_max_resumes``
    as a retry. Returns the continuations' results by k."""
    from ray_torch.core import config
    from ray_torch.observability import tracing
    from ray_torch.serve.llm import LLMServer

    config.get_config().tracing_enabled = True
    srv, since, warmed = started(journal, lambda: LLMServer(
        cfg, params=params, rng_seed=0))
    eng, ks = srv.engine, FAILOVER_KS[1]
    outs, clients = {}, {}
    try:
        for k in FAILOVER_KS:
            if k != FAILOVER_KS[-1]:
                with tracing.span("chip_smoke.client") as client:
                    outs[k] = continuation(eng, want, k)
                clients[k] = client
            else:
                outs[k] = continuation(eng, want, k)
        stats = eng.engine_stats()
        plans = {}
        for plan, count in (("continuation", 1),
                            ("retry", cfg.failover_max_resumes + 1)):
            async def stream():
                return [c async for c in srv.completions({
                    "prompt": failover_prompt(), "temperature": 0.0,
                    "max_tokens": FAILOVER_TOKENS - ks, "stream": True,
                    "resume_tokens": want[:ks], "resume_count": count})]

            plans[plan] = asyncio.run(stream())
        mids = journal.check_engine("(a) cold", eng, since, warmed)
    finally:
        srv.shutdown()
    for k, (out, req) in outs.items():
        log(f"  (a) fp32 cold continuation at k={k}: tokens == want[k:] "
            f"{out['tokens'] == want[k:]}, TTFT {1e3 * out['ttft_s']:.1f} ms "
            f"(the uninterrupted run's time to token {k}: {to_k[k]:.1f} ms), "
            f"cached_tokens {req.cached_tokens} [{card}]")
        if out["error"] is not None or out["tokens"] != want[k:]:
            raise AssertionError(f"cold continuation at {k}: {out['error']}, "
                                 f"tokens differ from the uninterrupted run")
    if (stats["failover_resumed"], stats["failover_restored_tokens"]) \
            != (len(FAILOVER_KS), 0):
        raise AssertionError(f"cold continuations: {stats}")
    # (e) one llm.generate span per traced request, none for the other
    tracing.flush()
    generated = [s for s in journal.spans if s["name"] == "llm.generate"]
    for k, (out, req) in outs.items():
        mine = [s for s in generated
                if s["attrs"]["request_id"] == req.request_id]
        if k not in clients:
            if mine:
                raise AssertionError(f"untraced request at k={k}: {mine}")
            continue
        (s,) = mine
        c = clients[k]
        dur = s["end"] - s["start"]
        if not ((s["trace_id"], s["parent_id"]) == (c["trace_id"],
                                                    c["span_id"])
                and s["start"] == req.submitted_wall
                and abs(dur - out["latency_s"]) <= 1e-3
                and s["attrs"]["prompt_tokens"] == out["num_prompt_tokens"]
                and s["attrs"]["generated_tokens"]
                == out["num_generated_tokens"]):
            raise AssertionError(f"span at k={k}: {s} against {c} and "
                                 f"latency {out['latency_s']}")
        log(f"  (e) span at k={k}: llm.generate under chip_smoke.client "
            f"(trace {s['trace_id'][:8]}), {1e3 * dur:.3f} ms against "
            f"latency_s {1e3 * out['latency_s']:.3f} ms, tokens "
            f"{s['attrs']['prompt_tokens']} + "
            f"{s['attrs']['generated_tokens']} [{card}]")
    if len(generated) != len(clients):
        raise AssertionError(f"{len(generated)} llm.generate spans for "
                             f"{len(clients)} traced requests")
    # (f) the server's stream, in both plans
    for plan, chunks in plans.items():
        toks = [t for c in chunks[:-1] for t in c["token_ids"]]
        meta = chunks[0].get("resume_meta")
        log(f"  (f) server stream, {plan} at k={ks}: token_ids == want[k:] "
            f"{toks == want[ks:]}, first chunk's resume_meta {meta} [{card}]")
        if toks != want[ks:] or meta is None \
                or meta["resumed"] is not (plan == "continuation") \
                or chunks[-1].get("error"):
            raise AssertionError(f"server {plan}: {meta}, {chunks[-1]}")
    return {k: out for k, (out, _) in outs.items()}, mids


def failover_local(card, journal, cfg, params, want, to_k):
    """(b) fp32: on one engine with the prefix cache on, the prompt, then
    its continuation at k = 24 over the prompt's resident full pages."""
    k = FAILOVER_KS[1]
    eng, since, warmed = started(journal,
                                 lambda: started_engine(cfg, params))
    try:
        first = eng.generate(failover_prompt(), temperature=0.0)
        out, req = continuation(eng, want, k)
        stats = eng.engine_stats()
        mids = journal.check_engine("(b) local", eng, since, warmed)
    finally:
        eng.shutdown()
    full = (len(failover_prompt()) + 1) // cfg.page_size * cfg.page_size
    log(f"  (b) fp32 local-prefix continuation at k={k}: tokens == want[k:] "
        f"{out['tokens'] == want[k:]}, cached_tokens {req.cached_tokens}, "
        f"failover_restored_tokens {stats['failover_restored_tokens']} (the "
        f"prompt's full pages: {full}), TTFT {1e3 * out['ttft_s']:.1f} ms "
        f"(time to token {k}: {to_k[k]:.1f} ms) [{card}]")
    if first["tokens"] != want or out["tokens"] != want[k:] \
            or stats["failover_restored_tokens"] < full \
            or stats["failover_resumed"] != 1:
        raise AssertionError(f"local-prefix continuation: {stats}")
    return out, mids


def failover_tier(card, journal, cfg, params, want, to_k):
    """(c) fp32, the KV tier on, at most 8 cached pages (phase 10's
    settings, but raw pages: a lossless encode of an fp32 page takes
    about half a second on the loop; a tier of 2 GiB: the 16 MiB pages
    of the evictions would push the eager spill out of 256 MiB; one page a
    restore chunk, so a chunk fault leaves a partial restore), one engine:
    a live request past 24 generated tokens; ``spill_inflight``
    must spill the full pages its progress implies (within one page), its
    sixth page past the prompt; cancelled, then evicted by two other
    prompts, its continuation at k = 24 restores those 6 pages from the
    tier. Evicted again, under the tier's chunk fault it restores one
    page (a partial restore) and re-prefills the rest. Both must give
    want[24:]."""
    k, ps = FAILOVER_KS[1], cfg.page_size
    prompt = failover_prompt()
    eng, since, warmed = started(journal,
                                 lambda: started_engine(cfg, params))
    try:
        rid = eng.submit(prompt, max_tokens=120, temperature=0.0)
        if not _wait_for(lambda: len((eng.request_progress(rid) or {}).get(
                "generated") or ()) >= k):
            raise AssertionError("the live request made no progress")
        prog = eng.request_progress(rid)
        t0 = time.perf_counter()
        spilled = eng.spill_inflight()
        spill_ms = 1e3 * (time.perf_counter() - t0)
        implied = (prog["prompt_tokens"] + len(prog["generated"]) - 1) // ps
        gen = list(eng.request_progress(rid)["generated"])
        eng.cancel(rid)
        _wait_for(lambda: rid not in eng._requests, 60.0)
        toks = eng.tokenizer.encode(prompt) + want[:k]
        chain = [d.hex() for d, _ in _chain(eng, toks)]

        def evict(*seeds):
            for s in seeds:
                eng.generate(fresh_tokens(np.random.RandomState(s), 1000),
                             max_tokens=2, temperature=0.0)
            gone = all(p is None for _, p in _chain(eng, toks))
            held = all(d in eng._kv_tier._by_digest for d in chain)
            return gone and held

        evicted = evict(21, 22)
        out, req = continuation(eng, want, k)
        evicted2 = evict(23, 24)

        def fault(ci):
            if ci >= 1:
                raise RuntimeError("injected chunk fault")

        eng._kv_tier._chunk_fault = fault
        part, preq = continuation(eng, want, k)
        eng._kv_tier._chunk_fault = None
        stats = eng.engine_stats()
        mids = journal.check_engine("(c) tier", eng, since, warmed)
    finally:
        eng.shutdown()
    prompt_pages = len(eng.tokenizer.encode(prompt)) // ps
    log(f"  (c) fp32 eager spill at {len(prog['generated'])} generated "
        f"tokens: spill_inflight() {spilled} pages in {spill_ms:.1f} ms "
        f"(implied by request_progress: {implied}; the prompt's full pages "
        f"{prompt_pages}); the live tokens == want {gen[:k] == want[:k]} "
        f"[{card}]")
    log(f"  (c) tier-restored continuation at k={k}: restored pages "
        f"{req.restore_pages} (chain {len(chain)}, past the prompt "
        f"{req.restore_pages - prompt_pages}), restore_ms "
        f"{req.restore_ms:.1f}, tokens == want[k:] "
        f"{out['tokens'] == want[k:]}, TTFT {1e3 * out['ttft_s']:.1f} ms "
        f"(time to token {k}: {to_k[k]:.1f} ms); under the chunk fault: "
        f"restored {preq.restore_pages} of {len(chain)}, partial "
        f"{preq.restore_partial}, tokens == want[k:] "
        f"{part['tokens'] == want[k:]}, TTFT {1e3 * part['ttft_s']:.1f} ms; "
        f"failover_restored_tokens {stats['failover_restored_tokens']} "
        f"[{card}]")
    if not (abs(spilled - implied) <= 1 and spilled >= len(chain)
            and len(chain) > prompt_pages and gen[:k] == want[:k]
            and evicted and evicted2):
        raise AssertionError(f"eager spill: {spilled} pages, implied "
                             f"{implied}, chain {len(chain)}, evicted "
                             f"{evicted}/{evicted2}")
    if not (out["error"] is None and out["tokens"] == want[k:]
            and req.restore_pages == len(chain) and not req.restore_partial
            and part["error"] is None and part["tokens"] == want[k:]
            and preq.restore_pages == 1 and preq.restore_partial
            and stats["failover_restored_tokens"]
            == (len(chain) + 1) * ps and stats["restore_partial"] == 1):
        raise AssertionError(f"tier continuations: {out['error']}, "
                             f"{part['error']}, restored "
                             f"{req.restore_pages}/{preq.restore_pages}, "
                             f"{stats}")
    return out, req, mids, [req.request_id, preq.request_id]


def failover_bf16(card, journal, cfg, params):
    """(a) in bf16, reported: a cache-off engine's uninterrupted run and
    its continuations at each k; how many flip."""
    eng, since, warmed = started(journal,
                                 lambda: started_engine(cfg, params))
    try:
        want = eng.generate(failover_prompt(), temperature=0.0)["tokens"]
        outs = {k: continuation(eng, want, k)[0] for k in FAILOVER_KS}
        mids = journal.check_engine("(a) bf16", eng, since, warmed)
    finally:
        eng.shutdown()
    flips = {k: next((i for i, (a, b) in enumerate(zip(o["tokens"],
                                                       want[k:]))
                      if a != b), None) for k, o in outs.items()}
    log(f"  (a) bf16 continuations (reported, not held): tokens == "
        f"want[k:] {[outs[k]['tokens'] == want[k:] for k in FAILOVER_KS]} "
        f"at k={list(FAILOVER_KS)}; first differing position {flips}; TTFT "
        + ", ".join(f"{1e3 * o['ttft_s']:.1f}" for o in outs.values())
        + f" ms [{card}]")
    if any(o["error"] for o in outs.values()):
        raise AssertionError("bf16 continuation failed")
    return outs, mids


def phase_failover(card: str):
    """Phase 12: failover continuations, the journal and spans at full
    width (llama3_1b at the serve settings, CUDA graphs on, phase 4's
    weights from seed 0): (a) cold continuations (fp32 held, bf16
    reported), (b) over a local prefix, (c) restored from an eager
    spill (whole and partial), (d) the journal through a local sink, (e)
    one span per traced request, (f) the server's resume plans. Returns
    the phase's launches by kernel, every engine's warmup included."""
    from ray_torch.models import llama
    from ray_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(serve_config().model_config, gen, "cuda")
    fp32 = _cast(params, torch.float32)
    model32 = llama.llama3_1b(max_seq_len=2048, dtype=torch.float32)
    off32 = serve_config(max_tokens=FAILOVER_TOKENS, model_config=model32,
                         prefix_cache_enabled=False)
    for name in pa.launches:
        pa.launches[name] = 0
    journal = Journal()
    try:
        t0 = time.perf_counter()
        want, to_k, m_want = failover_want(journal, off32, fp32)
        cold, m_a = failover_cold(card, journal, off32, fp32, want, to_k)
        t1 = time.perf_counter()
        local, m_b = failover_local(card, journal, serve_config(
            max_tokens=FAILOVER_TOKENS, model_config=model32), fp32, want,
            to_k)
        t2 = time.perf_counter()
        tier, treq, m_c, tier_rids = failover_tier(
            card, journal, serve_config(
                max_tokens=FAILOVER_TOKENS, model_config=model32,
                kv_tier_enabled=True, kv_tier_codec="none",
                kv_tier_max_bytes=2 << 30, prefix_cache_max_pages=8,
                kv_tier_chunk_pages=1),
            fp32, want, to_k)
        del fp32
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        bf16, m_bf = failover_bf16(card, journal, serve_config(
            max_tokens=FAILOVER_TOKENS, prefix_cache_enabled=False), params)
        t4 = time.perf_counter()
    finally:
        journal.close()
    launches = dict(pa.launches)
    # (d) the journal: one failover_resume per continuation (the server's
    # retry is not one), one restore_partial, each engine's mid-traffic
    # first uses, nothing else
    k = FAILOVER_KS[1]
    resumes = journal.kinds(kind="failover_resume")
    partial = journal.kinds(kind="restore_partial")
    mids = journal.kinds(kind="mid_traffic_compile")
    # fp32 and bf16 cold, the server's continuation, local, tier x 2
    want_resumes = 2 * len(FAILOVER_KS) + 1 + 1 + 2
    log(f"  (d) journal: {len(resumes)} failover_resume (want "
        f"{want_resumes}), {len(partial)} restore_partial "
        f"{[e['attrs'] for e in partial]}, {len(mids)} mid_traffic_compile "
        f"(engines' mid_traffic_compiles {[m_want, m_a, m_b, m_c, m_bf]}: "
        f"{sorted({tuple(e['attrs']['sig']) for e in mids})}), "
        f"{len(journal.events)} events in all [{card}]")
    others = [e for e in journal.events if e["kind"] not in (
        "failover_resume", "restore_partial", "mid_traffic_compile")]
    if others or len(resumes) != want_resumes \
            or len(mids) != m_want + m_a + m_b + m_c + m_bf \
            or any(e["attrs"]["resume_len"] not in FAILOVER_KS
                   or e["severity"] != "WARNING" for e in resumes) \
            or [e["request_id"] for e in partial] != tier_rids[1:] \
            or not all(rid in {e["request_id"] for e in resumes}
                       for rid in tier_rids):
        raise AssertionError(f"journal: {others}, {len(resumes)} resumes, "
                             f"{partial}, {len(mids)} compiles")
    log(f"  TTFT of a continuation at k={k} (what failover costs a user, "
        f"against the uninterrupted run's time to its token {k}, "
        f"{to_k[k]:.1f} ms): cold {1e3 * cold[k]['ttft_s']:.1f} ms, local "
        f"prefix {1e3 * local['ttft_s']:.1f} ms, tier-restored "
        f"{1e3 * tier['ttft_s']:.1f} ms (restore_ms {treq.restore_ms:.1f}) "
        f"[{card}]")
    log(f"  phase 12 launches (from its first engine's warmup) {launches}; "
        f"(a, e, f) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (a) bf16 {t4 - t3:.1f} s [{card}]")
    if not all(launches.values()):
        raise AssertionError(f"phase 12 launched a paged kernel no time: "
                             f"{launches}")
    return launches


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
        for kernel, regs, stores, loads in ptxas_summary(text):
            log(f"  ptxas[{name}] {kernel}: {regs} registers, spill "
                f"stores {stores} B, loads {loads} B")
            if "_hopper" in kernel and (stores or loads):
                raise AssertionError(f"{kernel} spills registers")
        for line in text.splitlines():
            if "error" in line or "arning" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    log("[2] kernels vs plain versions")
    t0 = time.perf_counter()
    kernels = phase_kernels(card)
    log(f"  phase 2: {time.perf_counter() - t0:.1f} s")

    log("[3] greedy identity: kernel (CUDA graphs on and off), gather, "
        "kernel with speculative decoding (graphs on and off); sampling "
        "through a graph")
    t0 = time.perf_counter()
    identity_launches = phase_identity(card)
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")

    log("[4] main path: LLMServer, llama3_1b at full width")
    t0 = time.perf_counter()
    params, launches = phase_serve(card)
    log(f"  phase 4: {time.perf_counter() - t0:.1f} s")

    log("[4b] main path with speculative decoding: LLMServer, llama3_1b at "
        "full width")
    t0 = time.perf_counter()
    spec_launches, verify_launches, draft_len = phase_spec_serve(card, params)
    phase_logits(params, draft_len)
    log(f"  phase 4b: {time.perf_counter() - t0:.1f} s")
    for k in kernels:         # each kernel's count on the path it serves
        if k["name"] == "paged_attention/verify":
            k["launches"] = spec_launches[k["kernel"]]
            k["verify_launches"] = verify_launches
            k["launches_on"] = "phase 4b: llama3_1b bf16 speculative serving"
            continue
        general = k["kernel"] == "paged_attention_kernel"
        k["launches"] = (identity_launches if general else
                         launches)[k["kernel"]]
        k["launches_on"] = ("phase 3: llama_tiny fp32 engine" if general
                            else "phase 4: llama3_1b bf16 serving")
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
    log(f"  phase 7: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[8] int8_matmul on the card")
    t0 = time.perf_counter()
    phase_int8(card)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s")

    log("[10] the KV tier at full width: spill, restore, suffix prefill")
    t0 = time.perf_counter()
    tier_launches = phase_tier(card)
    for k in kernels:         # the same kernels' counts on the tier's path
        k["tier_launches"] = tier_launches[k["kernel"]]
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[11] request deadlines at full width: shedding, drops mid-chunk "
        "and mid-restore, an overload wave")
    t0 = time.perf_counter()
    deadline_launches = phase_deadlines(card)
    for k in kernels:         # the same kernels' counts on phase 11's path
        k["deadline_launches"] = deadline_launches[k["kernel"]]
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[12] failover continuations, the journal and spans at full width")
    t0 = time.perf_counter()
    failover_launches = phase_failover(card)
    for k in kernels:         # the same kernels' counts on phase 12's path
        k["failover_launches"] = failover_launches[k["kernel"]]
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log("[9] where a speculative serving wave's time goes")
    t0 = time.perf_counter()
    phase_spec_profile(card)
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": kernels + flash}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
