#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Phases, each fatal on failure (the script exits non-zero):

  1. card: name, power limit, and the build of all seven CUDA kernels
     (the four TPU kernels' ports and the backwards of flash attention,
     of the rwkv6 scan and of the SSD scan) from the sources in this
     checkout (one nvcc per source, all in parallel);
  2. kernels: each kernel against its plain torch version, in bf16 and
     f32, at the shapes of the main paths and around them (flash at hd
     128 and hd 80, MHA at hd 128 (deepseek-moe-16b), non-causal at hd 64
     with S != T and with one query row (seamless-m4t-medium's encoder
     and cross-attention), ragged lengths, partial tiles, rows that see
     no key, carried states, B=2, single steps), with times (median of CUDA events), the plain
     version's time, the card's bound and the share of it reached (the
     rwkv6 scan also at decays near 0 and near 1, T 37 and T 1, each line
     naming the kernel that ran, chunked or step), for
     flash attention ``scaled_dot_product_attention``'s time as a
     yardstick the port never calls (wherever it computes the same
     function: no window, no offset, and square if causal), and each
     instance's registers and
     spills from the build; paged at the main shape, at long and ragged
     contexts (32K), B=1 at 8K, B=32, command-r's G=8 and
     deepseek-moe-16b's H = KV = 16, each with its
     split plan, a second time after a flush that leaves no dirty lines
     in L2, and SDPA on a padded contiguous copy (not the same function)
     as a yardstick;
  3. serving: four archs at full width and depth in bf16 with seeded
     random weights, one after the other (each freed before the next):
     llama32-3b (28 layers), rwkv6-3b (32), zamba2-2.7b (54) and
     deepseek-moe-16b (28: one dense, 27 MoE); 4 requests of 1024
     prompt + 32 output tokens in each of the five setups, through
     ``repro_torch.launch.serve.serve``. Every kernel's launch count is
     set to 0 just before an arch's serving and read just after; each
     must equal layers x prefills (flash: 9 shared-block calls x
     prefills for zamba2; paged: layers x decode steps for llama and
     deepseek). Logs the MoE decode slots dropped at capacity per setup.
     Checks the streams, the first tokens across setups, teacher-forced
     decode logits of request 0 against an f32 kernel-free recompute
     built from ``kernels/ref.py`` (the MoE's routed as serving routes
     them: the prompt as one prefill, each later token as a B = 1
     decode step), and times one prefill and one decode step
     (CUDA-event windows behind a ~20 ms and a ~100 ms spin, wall, and
     the device operations of a profiler trace) and one state's store
     and fetch per medium, apart, with the filesystem that holds the
     disk medium's scratch directory;
  4. parity: f32 at full width and reduced depth (llama32-3b 4 layers,
     rwkv6-3b 4, zamba2-2.7b 12, i.e. 2 groups, deepseek-moe-16b 4: the
     dense layer and 3 MoE), TF32 off, must give identical token streams
     in all five setups, and teacher-forced decode logits that match a
     kernel-free recompute. Where MoE decode slots were dropped at
     capacity (the reference's semantics: a drop depends on the batch),
     the count is printed and every decode step of the five setups is
     held instead against the same step, same batch, kernel-free;
  5. vlm and encdec: internvl2-2b (256 patches + 768 text tokens) and
     seamless-m4t-medium (1024 source frames + BOS) at full width in
     bf16 through ``Model``: a prefill and 32 greedy decode steps with
     the launch counts set to 0 just before and read just after (flash:
     24 for the vlm's prefill; 36 for the encdec's prefill and 12 a
     step, its cross-attention with one query row), and the logits of
     the prefill and every step against an f32 kernel-free recompute at
     phase 3's tolerance;
  6. simulator: ``repro_torch.launch.serve`` in simulation mode at its
     defaults (llama32-3b, bs 16, 16384 + 256) in the five setups,
     intra-gpu and 2P2D-ici, printed as the TPU v5e cost model's figures;
     the paper's Experiment 2, fig5's smoke grid (setup x phi in {0.42,
     0.74, 1.0}, batch 8) through ``repro_torch.exp.run_grid``, whose
     rows must equal ``tests/goldens/fig5_pareto_smoke.json`` and whose
     second pass must simulate nothing; and llama32-3b at full width in
     bf16 through ``repro_torch.exp.run`` with the real executor in
     co-1gpu and dis-ici (4 requests of 1024 + 32 tokens): flash 28 x
     prefills and paged 28 x decode steps (counts set to 0 just before
     each run), streams equal to phase 3's, and a record equal to the
     same experiment's without an executor (stepped exactly, as an
     engine with an executor steps);
  7. training: (7a) the flash backward kernel against autograd of the
     plain version in bf16 and f32 at llama32-3b's training shape (q
     [2,1024,24,128], KV 8, causal), hd 80 and 64, MHA, seamless'
     cross-attention (S 32, T 1024, non-causal), ragged 1000, a window, a
     q_offset and rows that see no key, given the forward's log-sum-exp
     (held to the plain one), with the route each shape took (bf16 on
     wgmma, f32 on the CUDA cores), its time, the plain version's, SDPA's
     backward alone where it computes the same function, both forward +
     backward, and the bound; (7b) llama32-3b (28 layers), rwkv6-3b (32
     layers) and zamba2-2.7b (54 Mamba2 layers, 9 shared-block calls) at
     full width and depth in bf16, 5 steps of batch 2 x 1024 each
     through ``repro_torch.launch.train.train``: finite losses, launches
     per step (each forward kernel, flash, the rwkv6 scan or the SSD
     scan, twice a call with the checkpoint's recompute, its backward
     once, no other kernel), step wall, tokens/s, the share of the bf16
     peak at 6 x params x tokens, peak memory, and one step's profiler
     trace; (7c) for each, a restart at full width and 2 layers (zamba2:
     6, one group): 4 steps with a checkpoint every 2, then ``train``
     again from step 2, whose losses and final params and moments must
     equal the first run's bit for bit (with the checkpoint directory's
     filesystem and the save and load times); (7d) for each, one f32
     train step at full width and 4 layers (zamba2: 12, two groups),
     kernels against kernel-free (plain attention and scans, autograd)
     and against kernel-free in f64, TF32 off: grads within 1e-4 of each
     leaf's largest, or, where f32 itself misses that (rwkv6-3b), the
     kernels' largest distance from f64 at most 3x the kernel-free
     f32's, every backward on its step kernel; (7e) the rwkv6 backward
     kernel against autograd of the plain scan in bf16 and f32 at
     rwkv6-3b's training shape ([2,1024,40,64]), B = 1, hd 32 and 128, a
     carried state with a nonzero d(final state), decays near 0, near 1
     and exactly 0, T 37 and T 1, each line naming its route (bf16 at hd
     64 chunked on the tensor cores, near 0 and exact zeros included,
     the chunked route's counter moving with it; the rest the step
     kernel): each gradient within the tolerance of its largest
     magnitude, its distance from an f64 autograd beside the plain
     f32's, two calls bit for bit, its time, the plain version's and the
     bound, at the training shape in bf16 the step kernel's time on the
     same inputs, and each route's resident blocks an SM; 7b requires
     every one of rwkv6-3b's backward launches on the chunked route; (7f) the SSD backward kernel likewise in bf16 and f32 at
     zamba2-2.7b's training shape ([2,1024,80,64], N 64), B = 1, a
     carried state with a nonzero d(final state), N 16 at P 32 and N
     128, decays near 1 and exactly 0, no D, T 37 and T 1, each line
     naming its route (bf16 at N 64 chunked on the tensor cores, the
     rest the step kernel; the chunked route's counter must move with
     it), and each route's resident blocks an SM; 7b requires every one
     of zamba2-2.7b's SSD backward launches on the chunked route;
  8. perf flags (``repro_torch.dist.opt_flags``) on one llama32-3b build
     at full width and depth in bf16: (8a) ``pad_heads``, a 1 x 1024
     prefill whose logits and cache must equal the flag-off run's bit for
     bit, with flash launched 28 times at the regrouped heads (H 32 over
     16 kv heads; the shapes logged); (8b) ``masked_cache_update``,
     ``Model.decode_step`` on the dense cache at B = 4 after a 1024-token
     prefill, logits and cache bit for bit the flag-off run's; (8c) 7b's
     training run under ``remat_dots``, ``bf16_logits`` and both, each
     logged as 7b is (losses, step walls, tokens/s, share of the peak,
     peak memory, launches: flash 56 and backward 28 a step, one profiled
     step) and held to 7b's losses (``remat_dots``: each within 1e-5
     relative; ``bf16_logits``: step 1 within 1e-2);
  9. distribution: (9a) the five collectives of
     ``repro_torch.dist.collectives`` on NCCL in the world this machine
     has (one rank a card), each against its analytic result; (9c) the
     dry run's counter on a small DTensor step on a fake 2-rank mesh,
     held to its flops, bytes and collectives written out, and the dry
     run of llama32-3b's train step (7b's shape) on the one-device mesh
     against the same step on the card: argument bytes equal to the real
     arguments', flops equal to ``FlopCounterMode`` over the real step,
     MemTracker's peak beside ``max_memory_allocated``, and the
     roofline's step time at the H100's data sheet rates beside the
     measured wall; then (9b) the dry run, ``python -m
     repro_torch.launch.dryrun`` on fake tensors in 8 processes, started
     after every phase that times the card: llama32-3b and the ten
     assigned archs, all four shapes, on 16x16 with the roofline, and
     llama32-3b and qwen2-0.5b on 2x16x16; every record's line is
     logged, and every applicable cell of the dense family (llama32-3b,
     qwen2-0.5b, qwen3-1.7b, yi-34b, command-r-35b) must be ok, other
     families' failures logged.

It prints the kernels' JSON line and the card's name and power limit
before its last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

  python3 chip_smoke.py            # from the repository root

Seven diagnostics, which print their JSON line and the card instead:
``--windows DIR`` times phase 3's prefill and decode step, store and
fetch per medium (and the flash wrapper's host time, the paged kernel
at five shapes, and, in a checkout with the kernels as operators, the
host time the operator dispatch adds a call and to llama32-3b's walls)
of the checkout at DIR, so that two checkouts are compared in one call with one
yardstick; ``--train DIR`` runs phase 7b's training of the checkout at
DIR (each trained arch's losses, step walls, launches and a profiled
step's busy time); ``--flash-ablation``,
``--rwkv6-ablation``, ``--ssd-backward-ablation`` and
``--rwkv6-backward-ablation`` time the bf16 flash kernel, the chunked
rwkv6 kernel, the chunked SSD backward's walk or the chunked rwkv6
backward built with one part switched off at a time; ``--dist`` runs
phase 9 alone.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCHS = ("llama32-3b", "rwkv6-3b", "zamba2-2.7b", "deepseek-moe-16b")
PARITY_LAYERS = {"llama32-3b": 4, "rwkv6-3b": 4, "zamba2-2.7b": 12,
                 "deepseek-moe-16b": 4}     # the dense layer and 3 MoE
# the families that decode from the paged pool (``Model.paged``; named
# here so that ``--windows`` also reads checkouts from before it)
PAGED = ("dense", "moe")
N_REQ, PROMPT, OUTPUT = 4, 1024, 32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-4}
SPIN_CYCLES = 40_000_000        # ~20 ms at 1.98 GHz: outlasts the host's enqueue
SPIN_LONG = 200_000_000         # ~100 ms
TOP_OPS = 6                     # device-op names listed per profiled call


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None,
            spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn`` in ms between two CUDA events.

    A spin kernel queued before the first event keeps the card busy
    while the host enqueues ``fn``, so the window holds device work
    only, not the wrapper's host time. ``flush`` runs before it, outside
    the window (to start from a cold L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median wall time of ``fn`` in ms, synchronised: for calls that
    wait on the host themselves (file I/O, host copies)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wrapper_host_ms(torch, fn, calls: int = 100) -> float:
    """Host time of one call of a kernel's wrapper in ms: ``calls`` calls
    back to back, unsynchronised, so the card never holds the host up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def kernel_time(torch, fn) -> dict:
    """The device operations of one call of ``fn`` from a torch.profiler
    trace: their count, their summed time (the card's busy time, host
    gaps excluded), the span from the first one's start to the last
    one's end, in ms, and the names that take the most of the busy time
    (``top``: [name, ms, count]); None where the trace holds no device
    events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        return dict(ops=0, busy_ms=None, span_ms=None)
    start = min(e.time_range.start for e in ops)
    end = max(e.time_range.end for e in ops)
    by_name = {}
    for e in ops:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return dict(ops=len(ops),
                busy_ms=sum(e.time_range.elapsed_us() for e in ops) / 1e3,
                span_ms=(end - start) / 1e3,
                top=[[name[:72], ms, n] for name, (ms, n) in top])


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def within(torch, got, want, tol: float) -> bool:
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def flash_cases():
    # (label, B, S, T, H, KV, hd, causal, window, q_offset)
    yield "main", 1, 1024, 1024, 24, 8, 128, True, 0, 0
    yield "ragged", 1, 1000, 1000, 24, 8, 128, True, 0, 0
    yield "long", 1, 8192, 8192, 24, 8, 128, True, 0, 0
    yield "q_offset", 1, 512, 1536, 24, 8, 128, True, 0, 1024
    yield "hd64", 1, 1024, 1024, 16, 8, 64, True, 0, 0
    yield "hd32", 2, 1024, 1024, 8, 2, 32, True, 0, 0
    yield "window", 1, 1024, 1024, 24, 8, 128, True, 256, 0
    yield "noncausal", 2, 384, 384, 8, 8, 64, False, 0, 0
    yield "hd80", 1, 1024, 1024, 32, 32, 80, True, 0, 0      # zamba2's
    yield "hd80-win", 1, 1024, 1024, 32, 32, 80, True, 256, 0
    yield "hd80-rag", 1, 1000, 1000, 32, 32, 80, True, 0, 0
    yield "hd80-noncausal", 1, 1024, 1024, 32, 32, 80, False, 0, 0
    yield "tiny", 1, 17, 17, 24, 8, 128, True, 0, 0
    # deepseek-moe-16b's prefill (MHA, G = 1) and seamless-m4t-medium's
    # encoder, cross-attention at prefill and at decode, and BOS prefill
    yield "moe", 1, 1024, 1024, 16, 16, 128, True, 0, 0
    yield "enc", 1, 1024, 1024, 16, 16, 64, False, 0, 0
    yield "cross", 1, 32, 1024, 16, 16, 64, False, 0, 0
    yield "cross1", 1, 1, 1024, 16, 16, 64, False, 0, 0
    yield "bos", 1, 1, 1, 16, 16, 64, True, 0, 0
    yield "keyless", 1, 100, 120, 4, 2, 32, True, 30, 80   # rows 69.. see no key


def paged_cases():
    # (label, B, H, KV, hd, page, seq_lens)
    yield "main", 4, 24, 8, 128, 16, [1025, 1040, 1049, 1056]
    yield "mha", 4, 8, 8, 128, 16, [1, 17, 530, 1056]
    yield "g7-hd64", 3, 14, 2, 64, 16, [16, 300, 777]
    yield "hd32", 2, 4, 2, 32, 8, [5, 64]
    yield "long", 4, 24, 8, 128, 16, [32768, 30001, 16384, 1]
    yield "B1-8k", 1, 24, 8, 128, 16, [8192]
    yield "B32", 32, 24, 8, 128, 16, list(range(1024, 1088, 2))
    yield "g8-hd128", 4, 64, 8, 128, 16, [1025, 1040, 1049, 1056]  # command-r
    yield "moe", 4, 16, 16, 128, 16, [1025, 1040, 1049, 1056]  # deepseek-moe


def paged_inputs(torch, g, dt, B, H, KV, hd, page, lens):
    """Random q and pages, a shuffled block table of just enough pages
    for the longest length, and the lengths, on the card."""
    max_pages = -(-max(lens) // page)
    P = B * max_pages + 7
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
    kp = torch.randn(P, page, KV, hd, generator=g, device="cuda").to(dt)
    vp = torch.randn(P, page, KV, hd, generator=g, device="cuda").to(dt)
    perm = torch.randperm(P, generator=g, device="cuda")
    bt = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


def paged_bound(q, bt, sl, KV, lens, dtype_name):
    """The paged kernel's bound: each live K/V row and q read once, the
    output written once, the table and lengths read; 4 operations per
    (query head, live token, dim)."""
    H, hd = q.shape[1], q.shape[2]
    live = sum(lens)
    nbytes = (2 * live * KV * hd + 2 * q.numel()) * q.element_size() \
        + bt.numel() * 4 + sl.numel() * 4
    return bound(4.0 * H * hd * live, nbytes, dtype_name)


def rwkv6_cases(dtype_name):
    # (label, B, T, NH, hd, carried, w range or None for the model's
    # decay): rwkv6-3b's prefill is B=1, T=1024
    yield "main", 1, 1024, 40, 64, False, None
    yield "ragged", 1, 1000, 40, 64, False, None
    yield "B4", 4, 1024, 40, 64, False, None
    yield "carried", 1, 1024, 40, 64, True, None
    yield "near0", 1, 1024, 40, 64, True, (1e-6, 1e-3)
    if dtype_name == "bfloat16":
        # in f32 the state grows to |S| ~ 100 here, and any two f32 orders
        # of the recurrence (the step kernel, the plain scan) differ in y
        # by ~1e-3 where y is near 0, over the f32 tolerance of 2e-4
        yield "near1", 1, 1024, 40, 64, True, (0.999, 1.0)
    yield "short", 1, 37, 40, 64, True, None
    yield "one", 1, 1, 40, 64, True, None


def mamba2_cases():
    # (label, B, T, NH, P, N, carried): zamba2's prefill is B=1, T=1024
    yield "main", 1, 1024, 80, 64, 64, False
    yield "ragged", 1, 1000, 80, 64, 64, False
    yield "carried", 1, 1024, 80, 64, 64, True
    yield "B2", 2, 1024, 80, 64, 64, True
    yield "short", 1, 37, 80, 64, 64, True
    yield "one", 1, 1, 80, 64, 64, True


def flash_pairs(q_offset, S, T, causal, window) -> int:
    """(query, key) pairs the masks let through."""
    total = 0
    for i in range(S):
        qpos = q_offset + i
        hi = min(T, qpos + 1) if causal else T
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def short(lens) -> str:
    return str(lens) if len(lens) <= 4 else f"[{lens[0]}..{lens[-1]}]"


def sdpa_padded_ms(torch, F, args, flush) -> float:
    """SDPA's time on a contiguous [B, KV, T, hd] copy of the pages of
    each row, T the longest length, no mask: what a library reads for a
    padded batch, not paged attention."""
    q, kp, vp, bt, sl = args
    B, H, hd = q.shape
    KV, T = kp.shape[2], int(sl.max())

    def padded(pages):
        return pages[bt.long()].reshape(B, -1, KV, hd)[:, :T].transpose(
            1, 2).contiguous()
    k, v = padded(kp), padded(vp)
    qs = q[:, :, None]
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, k, v, enable_gqa=True), flush=flush)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def scan_in_halves(torch, scan, T: int, state):
    """``scan(time slice, state)`` over the first half of T, then over
    the second from the carried state: (y of both halves, final state)."""
    y1, s1 = scan(slice(0, T // 2), state)
    y2, s2 = scan(slice(T // 2, T), s1)
    return torch.cat((y1, y2), dim=1), s2


def phase_kernels(torch):
    from repro_torch.kernels import (flash_prefill, mamba2_ssd,
                                     paged_decode, ref, rwkv6_scan)
    import torch.nn.functional as F

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    clean_flush = flush_buf.max       # evicts without leaving dirty lines
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for (label, B, S, T, H, KV, hd, causal, window,
             q_offset) in flash_cases():
            q = randn(B, S, H, hd).to(dt)
            k = randn(B, T, KV, hd).to(dt)
            v = randn(B, T, KV, hd).to(dt)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out = flash_prefill.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = max_err(torch, out, want)
            ok = within(torch, out, want, tol)
            reps = 5 if S >= 8192 else 20
            ms = cuda_ms(torch, lambda: flash_prefill.flash_attention(
                q, k, v, **kw), reps=reps, flush=flush)
            plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, **kw), reps=3, warmup=1)
            lib_ms = None
            # SDPA computes the same function wherever there is no window
            # and no offset; its causal mask is aligned top-left, so a
            # causal case must be square
            if window == 0 and q_offset == 0 and (S == T or not causal):
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                    reps=reps, flush=flush)
            flops = 4.0 * B * H * hd * flash_pairs(q_offset, S, T, causal,
                                                   window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"flash {label:14s} {dtype_name:8s} B={B} S={S} T={T} H={H} "
                f"KV={KV} hd={hd} causal={causal} window={window} "
                f"q_offset={q_offset}: max_abs_err={err:.3e} "
                f"(tol {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it")
            require(ok, f"flash {label} {dtype_name}: max_abs_err {err:.3e} "
                        f"over tolerance {tol}")
            if label == "main":
                host = wrapper_host_ms(torch, lambda: (
                    flash_prefill.flash_attention(q, k, v, **kw)))
                log(f"flash main {dtype_name}: wrapper host time {host:.4f} "
                    f"ms per call (checks, output, tensor maps, launch)")
            if label == "main" and dtype_name == "bfloat16":
                rows["flash_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)
            del q, k, v, out, want

        for label, B, H, KV, hd, page, lens in paged_cases():
            q, kp, vp, bt, sl = args = paged_inputs(torch, g, dt, B, H, KV,
                                                    hd, page, lens)
            out = paged_decode.paged_attention(*args)
            want = ref.paged_attention_ref(*args)
            torch.cuda.synchronize()
            err = max_err(torch, out, want)
            ok = within(torch, out, want, tol)
            ms = cuda_ms(torch, lambda: paged_decode.paged_attention(*args),
                         flush=flush)
            clean_ms = cuda_ms(torch, lambda: paged_decode.paged_attention(
                *args), flush=clean_flush)
            plain_ms = cuda_ms(torch, lambda: ref.paged_attention_ref(*args),
                               reps=5, warmup=1)
            b_ms, b_by = paged_bound(q, bt, sl, KV, lens, dtype_name)
            splits, split_pages = paged_decode.split_plan(
                B, KV, bt.shape[1], page, hd * q.element_size(), sms)
            log(f"paged {label:9s} {dtype_name:8s} B={B} H={H} KV={KV} "
                f"hd={hd} page={page} seq_lens={short(lens)}: "
                f"{splits} splits of {split_pages} pages; "
                f"max_abs_err={err:.3e} (tol {tol}) kernel {ms:.4f} ms "
                f"({clean_ms:.4f} ms after a read-only flush), "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms:.1%} of it ({b_ms / clean_ms:.1%})")
            require(ok, f"paged {label} {dtype_name}: max_abs_err {err:.3e} "
                        f"over tolerance {tol}")
            if dtype_name == "bfloat16":
                log(f"paged {label:9s} yardstick, not the same function: "
                    f"SDPA (enable_gqa) on a contiguous copy of K/V padded "
                    f"to the longest length "
                    f"{sdpa_padded_ms(torch, F, args, flush):.4f} ms")
            if label == "main":
                host = wrapper_host_ms(torch, lambda: (
                    paged_decode.paged_attention(*args)))
                log(f"paged main {dtype_name}: wrapper host time "
                    f"{host:.4f} ms per call (checks, plan, output, "
                    f"workspace, launch)")
            if label == "main" and dtype_name == "bfloat16":
                rows["paged_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
            del q, kp, vp, bt, sl, args, out, want

        for label, B, T, NH, hd, carried, w_range in rwkv6_cases(dtype_name):
            r, k, v = (randn(B, T, NH, hd).to(dt) for _ in range(3))
            if w_range is None:
                # the model's decay exp(-exp(w0 + lora)), w0 = -1
                w = torch.exp(-torch.exp(0.5 * randn(B, T, NH, hd) - 1.0))
            else:
                lo, hi = w_range
                w = lo + (hi - lo) * torch.rand(B, T, NH, hd, generator=g,
                                                device="cuda")
            which = rwkv6_scan.kernel_for(r, k, v, w)
            u = 0.1 * randn(NH, hd)
            s0 = randn(B, NH, hd, hd) if carried else None
            if carried:
                y, s = scan_in_halves(torch, lambda t, st: (
                    rwkv6_scan.rwkv6_scan(r[:, t], k[:, t], v[:, t],
                                          w[:, t], u, st)), T, s0)
            else:
                y, s = rwkv6_scan.rwkv6_scan(r, k, v, w, u, s0)
            y_ref, s_ref = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            err = max(max_err(torch, y, y_ref), max_err(torch, s, s_ref))
            ok = within(torch, y, y_ref, tol) and \
                within(torch, s, s_ref, TOL["float32"])
            ms = cuda_ms(torch, lambda: rwkv6_scan.rwkv6_scan(
                r, k, v, w, u, s0), flush=flush)
            plain_ms = cuda_ms(torch, lambda: ref.rwkv6_scan_ref(
                r, k, v, w, u, s0), reps=3, warmup=1)
            # per (step, key c, value j): S update and y term, 2 ops each
            flops = 4.0 * B * T * NH * hd * hd
            nbytes = nbytes_of(r, k, v, w, u, y, s) + \
                (s.numel() * 4 if carried else 0)
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"rwkv6 {label:9s} {dtype_name:8s} B={B} T={T} NH={NH} "
                f"hd={hd} carried={carried} w={w_range or 'model'} "
                f"[{which} kernel]: max_abs_err={err:.3e} "
                f"(tol {tol}, state {TOL['float32']}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms:.1%} of it")
            require(ok, f"rwkv6 {label} {dtype_name}: max_abs_err "
                        f"{err:.3e} over tolerance")
            if label == "main" and dtype_name == "bfloat16":
                require(which == "chunked", "rwkv6 main bfloat16 did not "
                                            "take the chunked kernel")
                rows["rwkv6_scan"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
            del r, k, v, w, y, s, y_ref, s_ref

        for label, B, T, NH, P, N, carried in mamba2_cases():
            x = randn(B, T, NH, P).to(dt)
            # softplus(dt_raw + dt_bias), dt_bias in [-4, -1]: dt ~ 0.1
            dts = F.softplus(randn(B, T, NH) - 2.5)
            A = -torch.linspace(1.0, 16.0, NH, device="cuda")
            Bm, Cm = randn(B, T, N).to(dt), randn(B, T, N).to(dt)
            D = randn(NH)
            s0 = randn(B, NH, N, P) if carried else None
            if carried:
                y, s = scan_in_halves(torch, lambda t, st: (
                    mamba2_ssd.mamba2_ssd(x[:, t], dts[:, t], A, Bm[:, t],
                                          Cm[:, t], D, st)), T, s0)
            else:
                y, s = mamba2_ssd.mamba2_ssd(x, dts, A, Bm, Cm, D, s0)
            y_ref, s_ref = ref.mamba2_ssd_ref(x, dts, A, Bm, Cm, D, s0)
            torch.cuda.synchronize()
            err = max(max_err(torch, y, y_ref), max_err(torch, s, s_ref))
            ok = within(torch, y, y_ref, tol) and \
                within(torch, s, s_ref, TOL["float32"])
            ms = cuda_ms(torch, lambda: mamba2_ssd.mamba2_ssd(
                x, dts, A, Bm, Cm, D, s0), flush=flush)
            plain_ms = cuda_ms(torch, lambda: ref.mamba2_ssd_ref(
                x, dts, A, Bm, Cm, D, s0), reps=3, warmup=1)
            # per (step, head, n, p): S update and y term, 2 ops each
            flops = 4.0 * B * T * NH * N * P
            nbytes = nbytes_of(x, dts, A, Bm, Cm, D, y, s) + \
                (s.numel() * 4 if carried else 0)
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"mamba2 {label:8s} {dtype_name:8s} B={B} T={T} NH={NH} "
                f"P={P} N={N} carried={carried}: max_abs_err={err:.3e} "
                f"(tol {tol}, state {TOL['float32']}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms:.1%} of it")
            require(ok, f"mamba2 {label} {dtype_name}: max_abs_err "
                        f"{err:.3e} over tolerance")
            if label == "main" and dtype_name == "bfloat16":
                rows["mamba2_ssd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
            del x, dts, Bm, Cm, y, s, y_ref, s_ref
    del flush_buf
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# kernel-free recomputes (the plain functions of kernels/ref.py, called
# directly): logits of every position of ``tokens`` [1, N]. With an f32
# ``cfg`` each layer's weights are widened as it runs, so an f32
# recompute never holds a second copy of the model
# ----------------------------------------------------------------------
def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _as(cfg, tree):
    """``tree`` in ``cfg``'s compute dtype (f32: widened; else as is)."""
    return _to_f32(tree) if cfg.compute_dtype == "float32" else tree


def dense_plain_logits(torch, params, cfg, tokens):
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    N = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(N, device=tokens.device)[None]
    for lp in params["layers"]:
        lp = _as(cfg, lp)
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        x = TF._attn_out_mlp(lp, x, attn, cfg)
    return L.lm_logits(params["embed"], x, cfg)[0]


def moe_plain_logits(torch, params, cfg, tokens):
    """As the serving path routes them: the first PROMPT positions as one
    prefill's dispatch (prefill capacity), every later one as its own
    B = 1 decode step's (decode capacity: nothing dropped)."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    N = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(N, device=tokens.device)[None]
    for lp, dense in MOE._blocks(params):
        lp = _as(cfg, lp)
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        x = x + L.out_project(lp["attn"], attn, cfg)
        h = L.rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
        if dense:
            x = x + L.mlp_forward(lp["ffn"], h, cfg)
            continue
        ffn = [MOE.moe_ffn(lp["ffn"], h[:, :PROMPT], cfg)[0]]
        ffn += [MOE.moe_ffn(lp["ffn"], h[:, i:i + 1], cfg, dropless=True)[0]
                for i in range(PROMPT, N)]
        x = x + torch.cat(ffn, dim=1)
    return L.lm_logits(params["embed"], x, cfg)[0]


def rwkv6_plain_hidden(torch, params, cfg, tokens):
    """The last layer's output [B, N, d], every scan the plain one."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6 as RW
    x = L.embed(params["embed"], tokens, cfg)
    for lp in params["layers"]:
        lp = _as(cfg, lp)
        h = L.rms_norm(x, lp["norm_tm"], cfg.norm_eps)
        r, k, v, w, gate = RW._time_mix_in(lp, h, cfg, None)
        # a zero state in the scan's arithmetic type (f64 under in_float64)
        zero = r.float().new_zeros(r.shape[0], *lp["u"].shape, r.shape[-1])
        y, _ = ref.rwkv6_scan_ref(r, k, v, w, lp["u"], zero)
        x = x + RW._time_mix_out(lp, y, gate, h, cfg)
        h = L.rms_norm(x, lp["norm_cm"], cfg.norm_eps)
        x = x + RW.channel_mix_seq(lp, h, None)[0]
    return x


def rwkv6_plain_logits(torch, params, cfg, tokens):
    from repro_torch.models import layers as L
    x = rwkv6_plain_hidden(torch, params, cfg, tokens)
    return L.lm_logits(params["embed"], x, cfg)[0]


def zamba2_plain_hidden(torch, params, cfg, tokens, remat: bool = False):
    """The last layer's output [B, N, d], every scan and shared-block call
    the plain one; ``remat``: each layer and call activation-checkpointed
    (the same operations, recomputed in the backward)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as MB
    N = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(N, device=tokens.device)[None]
    shared = _as(cfg, params["shared_attn"])

    def attn_block(x):
        q, k, v = MB._shared_attn_in(shared, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        return x + L.out_project(shared["attn"], attn, cfg)

    def mamba_block(x, lp):
        lp = _as(cfg, lp)
        xh, dt, A, Bm, Cm, z, _ = MB._mamba_in(lp, x, cfg, None)
        y, _ = ref.mamba2_ssd_ref(xh, dt, A, Bm, Cm, lp["D"])
        return x + MB._mamba_out(lp, y, z, cfg)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat \
            else fn(*args)
    for group in MB._groups(params, cfg):
        x = run(attn_block, x)
        for lp in group:
            x = run(mamba_block, x, lp)
    return x


def zamba2_plain_logits(torch, params, cfg, tokens):
    from repro_torch.models import layers as L
    x = zamba2_plain_hidden(torch, params, cfg, tokens)
    return L.lm_logits(params["embed"], x, cfg)[0]


PLAIN_LOGITS = {"dense": dense_plain_logits, "moe": moe_plain_logits,
                "ssm": rwkv6_plain_logits, "hybrid": zamba2_plain_logits}


def teacher_forced_logits(torch, model, params, cfg, prompt, outputs):
    """The port's own serving path over request 0 (teacher forcing):
    kernel prefill of the prompt, then one decode step per emitted token
    (dense and moe: paged decode through the kernel; recurrent: the
    state's plain step functions, from the prefill state sized as the
    executor sizes it)."""
    S = len(prompt)
    n = len(outputs) - 1
    toks = torch.tensor(prompt, device="cuda")[None]
    logits = []
    if model.family not in PAGED:
        _, state = model.prefill(params, {"tokens": toks},
                                 s_max=S + len(outputs) + 2)
        for i in range(n):
            lg, state = model.decode_step(
                params, torch.tensor([outputs[i]], device="cuda"), state,
                torch.tensor([S + i], dtype=torch.int32, device="cuda"))
            logits.append(lg[0])
        return torch.stack(logits)
    from repro_torch.core import DevicePagedKV, PagedKVPool
    from repro_torch.models.layers import dtype_of
    pool = PagedKVPool(num_pages=-(-(S + n + 1) // 16), page_size=16)
    kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                       dtype=dtype_of(cfg.compute_dtype), device="cuda")
    _, cache = model.prefill(params, {"tokens": toks})
    pool.allocate(0, S)
    kv.write_prefill(0, cache.k[:, 0], cache.v[:, 0])
    for i in range(n):
        pool.allocate(0, 1)
        bt = torch.tensor([pool.block_table(0)], dtype=torch.int32,
                          device="cuda")
        logits.append(model.decode_step_paged(
            params, torch.tensor([outputs[i]], device="cuda"), kv.k, kv.v,
            bt, torch.tensor([S + i], dtype=torch.int32, device="cuda"))[0])
    return torch.stack(logits)


# ----------------------------------------------------------------------
# phase 3: serving at full width, bf16
# ----------------------------------------------------------------------
def launch_counters():
    from repro_torch.kernels import (flash_prefill, mamba2_ssd,
                                     paged_decode, rwkv6_scan)
    return {"flash_attention": flash_prefill.flash_attention,
            "paged_attention": paged_decode.paged_attention,
            "rwkv6_scan": rwkv6_scan.rwkv6_scan,
            "mamba2_ssd": mamba2_ssd.mamba2_ssd}


def expected_launches(cfg, prefills: int, steps: int):
    """Launches of each kernel that serving ``cfg`` must make."""
    L = cfg.num_layers
    if cfg.family in PAGED:
        return {"flash_attention": L * prefills, "paged_attention": L * steps}
    if cfg.family == "ssm":
        return {"rwkv6_scan": L * prefills}
    G = L // cfg.hybrid.shared_attn_every
    return {"mamba2_ssd": L * prefills, "flash_attention": G * prefills}


def serve_setups(torch, arch):
    """Serve ``arch`` in the five setups with every launch count set to
    0 just before and read just after (and, for moe, the dropped decode
    slots per setup); returns (launch counts, streams, prompts, setup
    wall times, every setup's streams)."""
    from repro_torch.configs import get_config
    from repro_torch.core import SETUPS
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe
    from repro_torch.obs.trace import Tracer

    cfg = get_config(arch)
    counters = launch_counters()
    streams, walls = {}, {}
    for fn in counters.values():
        fn.launches = 0
    for setup in SETUPS:
        before = {k: fn.launches for k, fn in counters.items()}
        tracer = Tracer()
        moe.reset_decode_drops()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve(arch, setup, batch_size=N_REQ, input_len=PROMPT,
                    output_len=OUTPUT, real=True, device="cuda", seed=0,
                    tracer=tracer, verbose=False)
        torch.cuda.synchronize()
        walls[setup] = time.perf_counter() - t0
        gc.collect()                  # the cluster's weights, before the next
        if cfg.family == "moe":
            log(f"serve {arch} {setup:8s}: {moe.decode_drops()} decode "
                f"slots dropped at capacity (B <= {N_REQ}: C = "
                f"{moe.capacity(N_REQ * cfg.moe.top_k, cfg, True)} of "
                f"{N_REQ * cfg.moe.top_k} slots a layer)")
        prefills = len([e for e in tracer.instants("lifecycle")
                        if e.name == "prefill_done"])
        steps = len([e for e in tracer.spans()
                     if e.name in ("decode", "mixed")])
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        want = {k: 0 for k in counters}
        want.update(expected_launches(cfg, prefills, steps))
        log(f"serve {arch} {setup:8s}: wall {walls[setup]:.3f} s, "
            f"{prefills} prefills, {steps} decode steps, launches {got}, "
            f"simulated median TTFT {res.metrics.median_ttft_s:.4f} s "
            f"(TPU cost model)")
        require(prefills >= N_REQ and steps >= OUTPUT - 1 and got == want,
                f"{arch} {setup}: launches {got}, want {want} for "
                f"{prefills} prefills and {steps} decode steps")
        reqs = sorted(res.requests, key=lambda r: r.req_id)
        streams[setup] = [r.output_tokens for r in reqs]
        prompts = [list(r.prompt_tokens) for r in reqs]
        require(all(len(t) == OUTPUT for t in streams[setup]),
                f"{arch} {setup}: streams of lengths "
                f"{[len(t) for t in streams[setup]]}, want {OUTPUT}")
    counted = {k: fn.launches for k, fn in counters.items()}
    firsts = {s: [t[0] for t in streams[s]] for s in SETUPS}
    require(all(firsts[s] == firsts["co-1gpu"] for s in SETUPS),
            f"{arch}: first tokens differ across setups: {firsts}")
    same = sum(streams[s] == streams["co-1gpu"] for s in SETUPS)
    log(f"{arch} bf16 first tokens agree in all setups; "
        f"{same}/{len(SETUPS)} setups give co-1gpu's full streams")
    return counted, streams["co-1gpu"], prompts, walls, streams


def check_teacher_forced(torch, model, params, cfg, prompt, outs):
    """Teacher-forced bf16 decode logits of request 0 against an f32
    kernel-free recompute (same weights, TF32 off): the kernel path may
    stray from exact arithmetic by at most 3x what the plain bf16
    recompute itself strays (bf16's own noise floor)."""
    plain_fn = PLAIN_LOGITS[cfg.family]
    got = teacher_forced_logits(torch, model, params, cfg, prompt, outs)
    seq = torch.tensor(prompt + outs[:-1], device="cuda")[None]
    plain = plain_fn(torch, params, cfg, seq)[PROMPT:]
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    exact = plain_fn(torch, params, cfg32, seq)[PROMPT:]
    hold_to_noise_floor(torch, cfg.name, got, plain, exact)


def hold_to_noise_floor(torch, name, got, plain, exact):
    """bf16 logits of the kernel path (``got``) against the f32 kernel-free
    recompute (``exact``): at most 3x the plain bf16 recompute's own
    distance from it."""
    err, noise = max_err(torch, got, exact), max_err(torch, plain, exact)
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"{name} teacher-forced bf16 decode logits: kernel path vs f32 "
        f"recompute max_abs_err={err:.4e}, plain bf16 recompute vs f32 "
        f"{noise:.4e} (ratio {err / max(noise, 1e-30):.2f}; max |logit| "
        f"{float(exact.abs().max()):.3f}); argmax agreement with the plain "
        f"bf16 recompute {agree:.3f}")
    require(err <= 3 * noise,
            f"{name}: decode logits stray {err:.4e} from the f32 "
            f"recompute, over 3x the bf16 noise floor {noise:.4e}")


def main_path_fns(torch, model, params, cfg, prompt, outs):
    """One prefill of ``prompt`` and one B=4 decode step (ctx ~1024) at
    the main path's shapes, as RealExecutor calls them, and one
    sequence's handoff payload: (prefill, step, payload, what)."""
    from repro_torch.core import random_workload
    from repro_torch.launch.serve import device_kv
    toks = torch.tensor(prompt, device="cuda")[None]
    # as RealExecutor calls it: the recurrent families size their state
    kw = {} if model.family in PAGED else {"s_max": PROMPT + OUTPUT + 2}

    def prefill():
        return model.prefill(params, {"tokens": toks}, **kw)
    tok4 = torch.tensor(outs[:N_REQ], device="cuda")
    pos = torch.tensor([PROMPT + 3 * i for i in range(N_REQ)],
                       dtype=torch.int32, device="cuda")
    if model.family in PAGED:
        reqs = random_workload(N_REQ, input_len=PROMPT, output_len=OUTPUT,
                               vocab_size=cfg.vocab_size, seed=0)
        kv = device_kv(cfg, reqs, "cuda")
        for r in reqs:
            kv.pool.allocate(r.req_id, PROMPT + 16)
        bt = torch.tensor([kv.pool.block_table(r.req_id) for r in reqs],
                          dtype=torch.int32, device="cuda")

        def step():
            return model.decode_step_paged(params, tok4, kv.k, kv.v, bt, pos)
        _, cache = prefill()
        k, v = cache.k[:, 0].contiguous(), cache.v[:, 0].contiguous()
        payload = (0, k, v, torch.zeros(1, cfg.vocab_size, device="cuda"))
        return prefill, step, payload, "KV"
    logits, state = prefill()
    joined = model.state_type(*(torch.cat([x] * N_REQ, dim=1)
                                for x in state))

    def step():
        return model.decode_step(params, tok4, joined, pos)
    return prefill, step, (tuple(state), logits), "state"


def window_times(torch, prefill, step) -> dict:
    """Times in ms of one prefill and one decode step: the CUDA-event
    window behind a ~20 ms spin (``window20``) and behind a ~100 ms one
    (``window100``), the wall time, synchronised (``wall``), and the
    device operations of a profiler trace (``kernel_time``). A window
    holds the host's time too wherever the host still enqueues when the
    spin ends."""
    times = {}
    for name, fn, reps in (("prefill", prefill, 5), ("decode", step, 10)):
        times[name] = dict(
            window20=cuda_ms(torch, fn, reps=reps),
            window100=cuda_ms(torch, fn, reps=reps, spin=SPIN_LONG),
            wall=host_ms(torch, fn, reps=reps), **kernel_time(torch, fn))
    return times


def log_windows(name: str, times: dict) -> None:
    shape = {"prefill": f"1 x {PROMPT} tokens",
             "decode": f"B={N_REQ}, ctx ~{PROMPT}"}
    for what, t in times.items():
        busy = "not measured" if t["busy_ms"] is None else (
            f"{t['busy_ms']:.3f} ms busy in {t['ops']} device ops over a "
            f"{t['span_ms']:.3f} ms span")
        log(f"{name} one {what} ({shape[what]}): CUDA-event window "
            f"{t['window20']:.3f} ms behind a 20 ms spin, "
            f"{t['window100']:.3f} ms behind a 100 ms spin; wall "
            f"{t['wall']:.3f} ms; profiler {busy}")
        for op, ms, n in t.get("top", []):
            log(f"  {name} {what} busy: {ms:8.3f} ms in {n:4d} x {op}")


def store_fetch_ms(torch, path, payload, reps: int = 5):
    """Median host times in ms of ``path.store(payload)`` and of the
    ``fetch`` of its handle, each synchronised, after one warm-up."""
    stores, fetches = [], []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = path.store(payload)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path.fetch(handle)
        torch.cuda.synchronize()
        if i:
            stores.append((t1 - t0) * 1e3)
            fetches.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(stores), statistics.median(fetches)


def component_times(torch, model, params, cfg, prompts, outs):
    """Times of one prefill and one B=4 decode step at the main path's
    shapes (``window_times``), and the store and the fetch of one
    sequence's handoff payload per medium (host clock), checked
    bit-exact."""
    from repro_torch.core import make_path
    from repro_torch.core.transfer import map_tensors
    prefill, step, payload, what = main_path_fns(torch, model, params, cfg,
                                                 prompts[0], outs)
    log_windows(cfg.name, window_times(torch, prefill, step))
    flat = []
    map_tensors(flat.append, payload)
    mb = nbytes_of(*flat) / 1e6
    for medium in ("ici", "host", "disk"):
        path = make_path(medium)
        back = []
        map_tensors(back.append, path.fetch(path.store(payload)))
        require(len(back) == len(flat) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(flat, back)),
            f"{cfg.name} {medium}: {what} round trip is not bit-exact")
        st, fe = store_fetch_ms(torch, path, payload)
        log(f"{cfg.name} {medium:4s}: store {st:.3f} ms, fetch {fe:.3f} ms, "
            f"store+fetch {st + fe:.3f} ms for {mb:.1f} MB (one sequence's "
            f"{what}, bit-exact)")


def phase_serving(torch):
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import mount_of
    from repro_torch.models import get_model
    scratch = tempfile.gettempdir()
    point, fstype = mount_of(scratch)
    log(f"disk medium: scratch directory {scratch} is on a {fstype} "
        f"filesystem mounted at {point} (/proc/mounts); its pages are "
        f"dropped after each store's fsync")
    counted = {k: 0 for k in launch_counters()}
    walls, streams = {}, {}
    for arch in ARCHS:
        got, outs0, prompts, walls[arch], streams[arch] = serve_setups(
            torch, arch)
        for k, n in got.items():
            counted[k] += n
        cfg = get_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")   # serve()'s weights: same seed
        check_teacher_forced(torch, model, params, cfg, prompts[0], outs0[0])
        component_times(torch, model, params, cfg, prompts, outs0[0])
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return counted, walls, streams


# ----------------------------------------------------------------------
# phase 4: f32 parity across setups
# ----------------------------------------------------------------------
def parity_setups(torch, model, params, cfg):
    """Serve ``cfg`` (f32) in the five setups: (streams, dropped decode
    slots per setup, request 0's prompt)."""
    from repro_torch.core import (RealExecutor, SETUPS, make_cluster,
                                  random_workload)
    from repro_torch.launch.serve import device_kv
    from repro_torch.models import moe
    streams, drops = {}, {}
    for setup in SETUPS:
        reqs = random_workload(N_REQ, input_len=PROMPT, output_len=OUTPUT,
                               vocab_size=cfg.vocab_size, seed=1)
        prompt0 = list(reqs[0].prompt_tokens)
        kv = device_kv(cfg, reqs, "cuda") if cfg.family in PAGED else None
        moe.reset_decode_drops()
        res = make_cluster(setup, cfg, executor_factory=lambda path: (
            RealExecutor(model, params, kv, transfer_path=path))).run(reqs)
        drops[setup] = moe.decode_drops()
        streams[setup] = [r.output_tokens for r in
                          sorted(res.requests, key=lambda r: r.req_id)]
        require(all(len(t) == OUTPUT for t in streams[setup]),
                f"{cfg.name} f32 {setup}: short streams")
    return streams, drops, prompt0


def check_steps_against_plain(torch, model, params, cfg):
    """Serve again in the five setups, each paged decode step also run
    kernel-free on the same batch (the dense cache gathered from the
    pages, plain attention: ``decode_step``), and hold the two step by
    step: the same batch meets the same capacity, so a slot dropped on
    one side is dropped on the other."""
    from repro_torch.models.transformer import AttnCache
    kernel_step = model.decode_step_paged
    errs = []

    def step(params, tokens, k_pages, v_pages, block_table, pos,
             sink_page=None):
        page, n = k_pages.shape[2], pos.tolist()
        shape = (k_pages.shape[0], len(n), max(n) + 1, *k_pages.shape[3:])
        k, v = k_pages.new_zeros(shape), v_pages.new_zeros(shape)
        for b, m in enumerate(n):          # positions < m, page by page
            rows = block_table[b, :-(-m // page)].long()
            k[:, b, :m] = k_pages[:, rows].flatten(1, 2)[:, :m]
            v[:, b, :m] = v_pages[:, rows].flatten(1, 2)[:, :m]
        want, _ = model.decode_step(params, tokens, AttnCache(k, v), pos)
        got = kernel_step(params, tokens, k_pages, v_pages, block_table,
                          pos, sink_page)
        errs.append((max_err(torch, got, want),
                     within(torch, got, want, 1e-3)))
        return got

    model.decode_step_paged = step
    parity_setups(torch, model, params, cfg)
    worst = max(e for e, _ in errs)
    log(f"{cfg.name} f32: {len(errs)} decode steps in the five setups, each "
        f"against the same step and batch kernel-free: max_abs_err="
        f"{worst:.4e}")
    require(all(ok for _, ok in errs),
            f"{cfg.name} f32: a decode step differs from the same step "
            f"kernel-free by {worst:.4e}")


def phase_parity(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import SETUPS
    from repro_torch.models import get_model

    for arch in ARCHS:
        cfg = get_config(arch).replace(num_layers=PARITY_LAYERS[arch],
                                       param_dtype="float32",
                                       compute_dtype="float32")
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
        streams, drops, prompt0 = parity_setups(torch, model, params, cfg)
        if not any(drops.values()):
            for setup in SETUPS:
                require(streams[setup] == streams["co-1gpu"],
                        f"{arch} f32 parity: {setup} diverged from co-1gpu")
            log(f"{arch} f32 parity: identical streams in all {len(SETUPS)} "
                f"setups ({N_REQ} x {OUTPUT} tokens, {cfg.num_layers} "
                f"layers)")
        else:
            # the reference's capacity semantics: a decode slot is dropped
            # when more of a batch's tokens pick one expert than C, so a
            # stream depends on the batches it decoded in
            same = sum(streams[s] == streams["co-1gpu"] for s in SETUPS)
            log(f"{arch} f32: decode slots dropped at capacity per setup "
                f"{drops}; {same}/{len(SETUPS)} setups give co-1gpu's "
                f"streams")
            check_steps_against_plain(torch, model, params, cfg)
        outs = streams["co-1gpu"][0]
        got = teacher_forced_logits(torch, model, params, cfg, prompt0, outs)
        seq = torch.tensor(prompt0 + outs[:-1], device="cuda")[None]
        want = PLAIN_LOGITS[cfg.family](torch, params, cfg, seq)[PROMPT:]
        err = max_err(torch, got, want)
        log(f"{arch} teacher-forced f32 decode logits vs kernel-free "
            f"recompute: max_abs_err={err:.4e} (max |logit| "
            f"{float(want.abs().max()):.3f})")
        require(within(torch, got, want, 1e-3),
                f"{arch} f32 decode logits differ from the recompute by "
                f"{err:.4e}")
        del model, params
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 5: the vlm and encdec model paths at full width, bf16
# ----------------------------------------------------------------------
FAMILY_ARCHS = ("internvl2-2b", "seamless-m4t-medium")
BOS = 0


def vlm_plain_logits(torch, params, cfg, inputs, tokens):
    """Kernel-free logits of every text position (patches first)."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.models import vlm as VL
    head = {"projector": _as(cfg, params["projector"]),
            "embed": params["embed"]}
    x, positions = VL._combined_embeddings(head, inputs["patches"], tokens,
                                           cfg)
    for lp in params["layers"]:
        lp = _as(cfg, lp)
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        x = TF._attn_out_mlp(lp, x, attn, cfg)
    Np = inputs["patches"].shape[1]
    return L.lm_logits(params["embed"], x[:, Np:], cfg)[0]


def encdec_plain_logits(torch, params, cfg, inputs, tokens):
    """Kernel-free decoder logits of every position of ``tokens``."""
    from repro_torch.kernels import ref
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    fp = _as(cfg, params["frontend_proj"])
    x = inputs["src_embeds"].to(L.dtype_of(cfg.compute_dtype)) @ fp["w"] \
        + fp["b"]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for lp in params["encoder"]:
        lp = _as(cfg, lp)
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=False)
        x = TF._attn_out_mlp(lp, x, attn, cfg)
    y = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None]
    for lp in params["decoder"]:
        lp = _as(cfg, lp)
        ck, cv = (t[0] for t in ED.project_cross_kv({"decoder": [lp]}, x,
                                                    cfg))
        q, k, v = ED.self_in(lp, y, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        y = y + L.out_project(lp["self_attn"], attn, cfg)
        attn = ref.flash_attention_ref(ED.cross_q(lp, y, cfg), ck, cv,
                                       causal=False)
        y = y + L.out_project(lp["cross_attn"], attn, cfg)
        y = y + L.mlp_forward(lp["mlp"], L.rms_norm(
            y, lp["norm_mlp"], cfg.norm_eps), cfg)
    return L.lm_logits(params["embed"], y, cfg)[0]


def family_inputs(torch, cfg):
    """(inputs beside the tokens, the text before decode): internvl2-2b
    256 patches and 768 text tokens, seamless-m4t-medium 1024 source
    frames and BOS."""
    g = torch.Generator(device="cuda").manual_seed(2)
    if cfg.family == "vlm":
        v = cfg.vision
        patches = torch.randn(1, v.num_patches, v.frontend_dim, generator=g,
                              device="cuda")
        text = torch.randint(0, cfg.vocab_size, (1, PROMPT - v.num_patches),
                             generator=g, device="cuda")
        return {"patches": patches}, text
    src = torch.randn(1, PROMPT, cfg.encdec.frontend_dim, generator=g,
                      device="cuda")
    return {"src_embeds": src}, torch.full((1, 1), BOS, device="cuda")


def family_launches(cfg) -> dict:
    """Flash launches of one prefill and OUTPUT decode steps: vlm, one a
    layer at prefill (decode self-attention is plain); encdec, the
    encoder's and the decoder's self and cross at prefill, then the
    cross-attention of every decoder layer at each step."""
    if cfg.family == "vlm":
        return {"flash_attention": cfg.num_layers}
    e = cfg.encdec
    return {"flash_attention": e.num_encoder_layers + 2 * e.num_decoder_layers
            + e.num_decoder_layers * OUTPUT}


def phase_families(torch) -> dict:
    """internvl2-2b and seamless-m4t-medium at full width, bf16, through
    ``Model``: a prefill and OUTPUT greedy decode steps with every launch
    count set to 0 just before and read just after, then the logits of
    the prefill and of every step against an f32 kernel-free recompute
    at phase 3's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    plain_fn = {"vlm": vlm_plain_logits, "encdec": encdec_plain_logits}
    counters = launch_counters()
    counted = {k: 0 for k in counters}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        inputs, text = family_inputs(torch, cfg)
        # the first decode position: after the patches and the text
        start = PROMPT if cfg.family == "vlm" else text.shape[1]
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {**inputs, "tokens": text},
                                      s_max=start + OUTPUT + 2)
        got, outs = [logits[0]], []
        for i in range(OUTPUT):
            tok = logits.argmax(-1)
            outs.append(int(tok))
            logits, state = model.decode_step(
                params, tok, state,
                torch.tensor([start + i], dtype=torch.int32, device="cuda"))
            got.append(logits[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: 0 for k in counters}
        want.update(family_launches(cfg))
        log(f"{arch} bf16: prefill of {tuple(inputs.values())[0].shape[1]} "
            f"{'patches' if cfg.family == 'vlm' else 'source frames'} and "
            f"{text.shape[1]} text tokens, then {OUTPUT} decode steps, in "
            f"{wall:.3f} s wall; launches {launches}; tokens {outs[:8]}...")
        require(launches == want, f"{arch}: launches {launches}, want {want}")
        for k, n in launches.items():
            counted[k] += n
        seq = torch.cat([text, torch.tensor([outs], device="cuda")], dim=1)
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        rows = slice(text.shape[1] - 1, None)
        plain = plain_fn[cfg.family](torch, params, cfg, inputs, seq)[rows]
        exact = plain_fn[cfg.family](torch, params, cfg32, inputs, seq)[rows]
        hold_to_noise_floor(torch, arch, torch.stack(got), plain, exact)
        del model, params, state
        gc.collect()
        torch.cuda.empty_cache()
    return counted


# ----------------------------------------------------------------------
# phase 6: the simulator layers (exp, workload, core.dvfs)
# ----------------------------------------------------------------------
SIM_SETUPS = ("co-1gpu", "co-2gpus", "dis-ici", "dis-host", "dis-disk",
              "intra-gpu", "2P2D-ici")
FIG5_GRID = (0.42, 0.74, 1.0)                 # the fig5 smoke grid
FIG5_HEADER = ["setup", "phi", "median_ttft_s", "prefill_energy_kj",
               "median_tpot_ms", "decode_energy_kj"]
EXP_ARCH, EXP_SETUPS = "llama32-3b", ("co-1gpu", "dis-ici")


def simulated_serving() -> None:
    """6a: ``serve`` in simulation mode at its defaults (llama32-3b,
    bs 16, 16384 + 256) in each setup."""
    from repro_torch.launch.serve import serve
    for setup in SIM_SETUPS:
        res = serve("llama32-3b", setup, verbose=False)
        m = res.metrics
        require(m.median_ttft_s > 0 and m.median_tpot_s > 0,
                f"simulated {setup}: no latency")
        log(f"sim {setup:9s} (simulated, TPU v5e cost model): median TTFT "
            f"{m.median_ttft_s:.4f} s, median TPOT "
            f"{m.median_tpot_s * 1e3:.3f} ms, "
            f"{res.joules_per_token:.4f} J/token")


def fig5_rows(recs, setups):
    """fig5's Pareto rows of a setup x phi grid's records."""
    rows = []
    for i, setup in enumerate(setups):
        for phi, r in zip(FIG5_GRID, recs[i * len(FIG5_GRID):]):
            rows.append(dict(zip(FIG5_HEADER, [
                setup, phi, round(r.metrics.median_ttft_s, 4),
                round(r.prefill_side_j / 1e3, 3),
                round(r.metrics.median_tpot_s * 1e3, 3),
                round(r.decode_side_j / 1e3, 3)])))
    return json.loads(json.dumps(rows))


def fig5_smoke(cache_dir: str) -> None:
    """6b: the paper's Experiment 2, fig5's smoke grid through
    ``run_grid``, held to ``tests/goldens/fig5_pareto_smoke.json``; a
    second pass must simulate nothing."""
    from repro_torch.core import SETUPS
    from repro_torch.exp import (Experiment, Grid, ResultCache, run_grid,
                                 sim_count)
    golden = json.loads((ROOT / "tests" / "goldens" /
                         "fig5_pareto_smoke.json").read_text())["points"]
    cache = ResultCache(cache_dir)
    grid = Grid(Experiment.closed(SETUPS[0], 8, arch="llama32-3b"),
                {"setup": SETUPS, "phi": FIG5_GRID})
    s0 = sim_count()
    rows = fig5_rows(run_grid(grid, parallel=1, cache=cache), SETUPS)
    cold = sim_count() - s0
    require(rows == golden, f"fig5 smoke rows differ from the golden: "
                            f"{rows} != {golden}")
    s1 = sim_count()
    warm = fig5_rows(run_grid(grid, parallel=1, cache=cache), SETUPS)
    require(warm == golden and sim_count() == s1,
            f"fig5 warm pass simulated {sim_count() - s1} cells")
    log(f"fig5 smoke grid: {len(rows)} rows equal "
        f"tests/goldens/fig5_pareto_smoke.json ({cold} simulations; the "
        f"warm pass simulated {sim_count() - s1}, "
        f"{cache.stats.hits} cache hits)")


def exp_real_route(torch, model, params, cfg, setup):
    """6c: one experiment through ``repro_torch.exp.run`` with the real
    executor: ``N_REQ`` requests of ``PROMPT`` + ``OUTPUT`` tokens whose
    ids are ``random_workload``'s, a device KV pool sized to them, and a
    tracer to count prefills and decode steps. Returns (the record, the
    records of the same experiment run without an executor by the exact
    and by the default (fast) stepper, streams, prefills, decode
    steps)."""
    from repro_torch.core import RealExecutor
    from repro_torch.exp import ClosedLoop, Experiment, run
    from repro_torch.fleet import cluster
    from repro_torch.launch.serve import device_kv
    from repro_torch.obs.trace import Tracer
    exp = Experiment(arch=EXP_ARCH, fleet=setup, workload=ClosedLoop(
        N_REQ, input_len=PROMPT, output_len=OUTPUT, seed=0,
        vocab_size=cfg.vocab_size))
    kv = (device_kv(cfg, exp.workload.build(exp.slo), "cuda")
          if model.paged else None)
    served = {}

    class Recording(RealExecutor):
        """Keeps the requests it prefills, to read their streams."""

        def prefill(self, seq):
            served[seq.req.req_id] = seq.req
            return super().prefill(seq)

    tracer = Tracer()
    rec = run(exp, tracer=tracer, executor_factory=lambda path: Recording(
        model, params, kv, transfer_path=path))
    # an engine with an executor steps one token at a time (it never
    # coalesces decode runs, core/fastpath.py), so the like-for-like run
    # without one takes the exact stepper
    default, cluster.DEFAULT_STEPPER = cluster.DEFAULT_STEPPER, "exact"
    try:
        exact = run(exp, cache=None)
    finally:
        cluster.DEFAULT_STEPPER = default
    fast = run(exp, cache=None)
    prefills = len([e for e in tracer.instants("lifecycle")
                    if e.name == "prefill_done"])
    steps = len([e for e in tracer.spans() if e.name in ("decode", "mixed")])
    streams = [served[i].output_tokens for i in sorted(served)]
    return rec, exact, fast, streams, prefills, steps


def record_diff(rec, other, keys=None) -> list:
    """The fields of two records of one experiment that differ."""
    a, b = rec.to_dict(), other.to_dict()
    return [k for k in (keys or a) if a[k] != b[k]]


def stage_gap(rec, other) -> float:
    """Largest relative difference of the two records' joules by stage."""
    a, b = rec.energy_by_stage, other.energy_by_stage
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)


def real_through_exp(torch, streams3) -> dict:
    """6c on the card: llama32-3b at full width and depth in bf16 through
    ``exp.run`` in co-1gpu and dis-ici, launch counts set to 0 just
    before each run and read just after; streams held to phase 3's."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = get_config(EXP_ARCH)
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")               # serve()'s weights: same seed
    counters = launch_counters()
    counted = {k: 0 for k in counters}
    for setup in EXP_SETUPS:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec, exact, fast, streams, prefills, steps = exp_real_route(
            torch, model, params, cfg, setup)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        want = {k: 0 for k in counters}
        want.update(expected_launches(cfg, prefills, steps))
        log(f"exp {EXP_ARCH} {setup:8s} with the real executor: wall "
            f"{wall:.3f} s (and two runs without it), {prefills} prefills, "
            f"{steps} decode steps, launches {got}")
        require(prefills >= N_REQ and steps >= OUTPUT - 1 and got == want,
                f"exp {setup}: launches {got}, want {want} for {prefills} "
                f"prefills and {steps} decode steps")
        for k, n in got.items():
            counted[k] += n
        require(streams == streams3[setup],
                f"exp {setup}: streams differ from phase 3's serve")
        diff = record_diff(rec, exact)
        require(not diff, f"exp {setup}: the record's {diff} differ from "
                          f"the exact stepper's run without an executor")
        # the fast stepper against the exact one: the reference's own
        # contract (tests/test_fastpath_parity.py), bit-equal but for
        # joules by stage, whose fold order it relaxes to 1e-9 relative
        diff = record_diff(rec, fast, ("metrics", "energy_by_component",
                                       "makespan_s", "goodput"))
        gap = stage_gap(rec, fast)
        require(not diff and gap <= 1e-9,
                f"exp {setup}: the record's {diff} (joules by stage "
                f"{gap:.3e} apart) differ from the default run")
        m = rec.metrics
        log(f"exp {EXP_ARCH} {setup:8s}: streams equal phase 3's; record "
            f"equal to the exact stepper's without an executor; against "
            f"the default fast stepper's: metrics equal, joules by stage "
            f"{gap:.3e} apart (relative); simulated (TPU v5e cost model) "
            f"median TTFT {m.median_ttft_s:.4f} s, median TPOT "
            f"{m.median_tpot_s * 1e3:.3f} ms, energy by stage "
            f"{ {k: round(v, 3) for k, v in rec.energy_by_stage.items()} }")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def phase_simulator(torch, streams3) -> dict:
    """Phase 6: 6a, 6b and 6c; returns 6c's launch counts. The port's
    result cache lives in a temporary directory for the phase."""
    import tempfile
    from repro_torch.exp import ResultCache, set_default_cache
    with tempfile.TemporaryDirectory() as tmp:
        set_default_cache(ResultCache(str(Path(tmp) / "default")))
        try:
            simulated_serving()
            fig5_smoke(str(Path(tmp) / "fig5"))
        finally:
            set_default_cache(None)
    return real_through_exp(torch, streams3)


# ----------------------------------------------------------------------
# phase 7: training
# ----------------------------------------------------------------------
TRAIN_ARCH = "llama32-3b"        # phase 8's model
TRAIN_ARCHS = ("llama32-3b", "rwkv6-3b", "zamba2-2.7b")
BACKWARD = ("flash_attention_backward", "rwkv6_scan_backward",
            "mamba2_ssd_backward")   # the backward kernels' counters
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 5
# 7c's and 7d's depths: zamba2's Mamba2 layers run in groups of 6 behind
# the shared block (none at fewer), so one group for its restart and two
# (phase 4's) for its f32 step
RESTART_LAYERS = {"llama32-3b": 2, "rwkv6-3b": 2, "zamba2-2.7b": 6}
PARITY_TRAIN_LAYERS = {"llama32-3b": 4, "rwkv6-3b": 4, "zamba2-2.7b": 12}
TRAIN_LR = 1e-3                  # 7d's AdamW step
GRAD_TOL = 1e-4                  # 7d: grads against each leaf's largest
NOISE_FLOOR = 3                  # 7d: else x f32's own distance from f64


def flash_bwd_cases():
    # (label, B, S, T, H, KV, hd, causal, window, q_offset): the training
    # shape first (llama32-3b at batch 2 x 1024)
    yield "train", 2, 1024, 1024, 24, 8, 128, True, 0, 0
    yield "hd80", 1, 1024, 1024, 32, 32, 80, True, 0, 0
    yield "hd64", 1, 1024, 1024, 16, 8, 64, True, 0, 0
    yield "mha", 1, 1024, 1024, 16, 16, 128, True, 0, 0
    yield "cross", 1, 32, 1024, 16, 16, 64, False, 0, 0
    yield "ragged", 1, 1000, 1000, 24, 8, 128, True, 0, 0
    yield "window", 1, 1024, 1024, 24, 8, 128, True, 256, 0
    yield "q_offset", 1, 512, 1536, 24, 8, 128, True, 0, 1024
    yield "keyless", 1, 100, 120, 4, 2, 32, True, 30, 80   # rows 69.. see no key


def plain_flash_grads(torch, q, k, v, dout, **kw):
    """(dq, dk, dv): autograd of the plain version."""
    from repro_torch.kernels import ref
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(ref.flash_attention_ref(*qkv, **kw), qkv,
                               dout)


def flash_backward_kernel(torch) -> dict:
    """7a: the backward kernel against autograd of the plain version, in
    bf16 and f32, given the forward's log-sum-exp (itself held to the
    plain one), with the route each shape took, its time, the plain
    version's (forward + backward), SDPA's backward alone where SDPA
    computes the same function (its forward outside the window), the
    port's and SDPA's forward + backward, and the bound (10 hd operations
    per visible pair: the five products; each input, lse included, read
    and each gradient written once). Returns the JSON row (training
    shape, bf16)."""
    from repro_torch.kernels import flash_prefill, ref
    import torch.nn.functional as F
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(7)
    row = None
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        route = flash_prefill.backward_route(dt)
        for (label, B, S, T, H, KV, hd, causal, window,
             q_offset) in flash_bwd_cases():
            q, dout = (torch.randn(B, S, H, hd, generator=g,
                                   device="cuda").to(dt) for _ in range(2))
            k, v = (torch.randn(B, T, KV, hd, generator=g,
                                device="cuda").to(dt) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out, lse = flash_prefill.flash_attention_with_lse(q, k, v, **kw)
            lse_want = ref.flash_attention_lse_ref(q, k, **kw)
            got = flash_prefill.flash_attention_backward(
                q, k, v, out, dout, lse=lse, **kw)
            want = plain_flash_grads(torch, q, k, v, dout, **kw)
            torch.cuda.synchronize()
            err = max(max_err(torch, a, b) for a, b in zip(got, want))
            lse_err = max_err(torch, lse, lse_want)
            ok = all(within(torch, a, b, tol) for a, b in zip(got, want))
            ms = cuda_ms(torch, lambda: flash_prefill.flash_attention_backward(
                q, k, v, out, dout, lse=lse, **kw), flush=flush)

            def port_fwd_bwd():
                o, m = flash_prefill.flash_attention_with_lse(q, k, v, **kw)
                flash_prefill.flash_attention_backward(q, k, v, o, dout,
                                                       lse=m, **kw)
            both_ms = cuda_ms(torch, port_fwd_bwd, flush=flush)
            plain_ms = cuda_ms(torch, lambda: plain_flash_grads(
                torch, q, k, v, dout, **kw), reps=3, warmup=1)
            lib_ms = lib_both_ms = None
            if window == 0 and q_offset == 0 and (S == T or not causal):
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                              for x in (q, k, v))
                dot = dout.transpose(1, 2)
                lib_both_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True),
                    (qt, kt, vt), dot), flush=flush)
                o_lib = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
                lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), dot, retain_graph=True), flush=flush)
                del o_lib
            flops = 10.0 * B * H * hd * flash_pairs(q_offset, S, T, causal,
                                                    window)
            nbytes = nbytes_of(q, k, v, out, dout, *got) + 4 * lse.numel()
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"7a flash backward {label:9s} {dtype_name:8s} B={B} S={S} "
                f"T={T} H={H} KV={KV} hd={hd} causal={causal} "
                f"window={window} q_offset={q_offset}, route {route}: "
                f"max_abs_err={err:.3e} (tol {tol}, dq dk dv; lse "
                f"{lse_err:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, sdpa bwd "
                f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; fwd+bwd "
                f"port {both_ms:.4f} ms, sdpa "
                f"{lib_both_ms if lib_both_ms is None else round(lib_both_ms, 4)}"
                f" ms")
            require(ok, f"flash backward {label} {dtype_name}: max_abs_err "
                        f"{err:.3e} over tolerance {tol}")
            require(within(torch, lse, lse_want, tol),
                    f"flash forward lse {label} {dtype_name}: max_abs_err "
                    f"{lse_err:.3e} over tolerance {tol}")
            if label == "train":   # ten calls: a trace of one can miss some
                prof = kernel_time(torch, lambda: [
                    flash_prefill.flash_attention_backward(
                        q, k, v, out, dout, lse=lse, **kw)
                    for _ in range(10)])
                log(f"7a flash backward train {dtype_name}, 10 calls "
                    f"profiled: {prof.get('ops')} device ops, busy "
                    f"{prof.get('busy_ms')} ms; by name [name, ms, calls] "
                    f"{prof.get('top')}")
            if label == "train" and dtype_name == "bfloat16":
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                           design=f"bf16 on {route} + TMA (f32 on the CUDA "
                                  f"cores), the forward's lse")
            del q, k, v, out, lse, dout, got, want
    del flush_buf
    torch.cuda.empty_cache()
    return row


def step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of ``cfg``: the forward
    kernels twice a call (the forward and the checkpoint's recompute),
    their backwards once (flash: one call a layer, or, for the hybrid, a
    shared-block call every ``shared_attn_every`` layers)."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        calls = {"rwkv6_scan": L}
    elif cfg.family == "hybrid":
        calls = {"mamba2_ssd": L,
                 "flash_attention": L // cfg.hybrid.shared_attn_every}
    else:
        calls = {"flash_attention": L}
    got = {**{k: 2 * n for k, n in calls.items()},
           **{f"{k}_backward": n for k, n in calls.items()}}
    if "mamba2_ssd" in calls:    # every backward on the chunked route
        got["mamba2_ssd_backward_chunked"] = calls["mamba2_ssd"]
    if "rwkv6_scan" in calls:
        got["rwkv6_scan_backward_chunked"] = calls["rwkv6_scan"]
    return got


def train_counts(torch, reset: bool = False) -> dict:
    """The seven launch counts and the SSD and rwkv6 backwards' chunked
    routes' (set to 0 first with ``reset``); a backward's reads 0 in a
    checkout from before it, and a chunked route's is left out there."""
    from repro_torch.kernels import flash_prefill, mamba2_ssd, rwkv6_scan
    counters = launch_counters()
    backward = {"flash_attention_backward": flash_prefill.flash_attention,
                "rwkv6_scan_backward": rwkv6_scan.rwkv6_scan,
                "mamba2_ssd_backward": mamba2_ssd.mamba2_ssd}
    if reset:
        for fn in counters.values():
            fn.launches = 0
        for fn in backward.values():
            fn.backward_launches = 0
    got = {k: fn.launches for k, fn in counters.items()}
    for k, fn in backward.items():
        got[k] = getattr(fn, "backward_launches", 0)
    for key, fn in (("mamba2_ssd_backward_chunked", mamba2_ssd.mamba2_ssd),
                    ("rwkv6_scan_backward_chunked", rwkv6_scan.rwkv6_scan)):
        if hasattr(fn, "backward_chunked_launches"):
            if reset:
                fn.backward_chunked_launches = 0
            got[key] = fn.backward_chunked_launches
    return got


def train_run(torch, label: str, flags: str = "",
              arch: str = TRAIN_ARCH) -> dict:
    """``arch`` at full width and depth, bf16, TRAIN_STEPS steps of
    TRAIN_B x TRAIN_S through ``repro_torch.launch.train.train`` (seed 0:
    every run starts from the same weights and batches) with the perf
    ``flags`` set (none: the registry is not touched, so the parent's
    checkout runs it too) and the launch counts set to 0 just before and
    read just after. Logs and returns its losses, step walls, launches
    and peak memory; fails unless every loss is finite and the launches
    are ``step_launches`` a step, no other kernel (llama32-3b: flash 2 x
    L and its backward L; rwkv6-3b: the rwkv6 scan's; zamba2-2.7b: the
    SSD scan's, and flash's per shared-block call)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import get_model
    cfg = get_config(arch)
    L, n_params = cfg.num_layers, get_model(cfg).param_count()
    tokens = TRAIN_B * TRAIN_S
    if flags:
        from repro_torch.dist import opt_flags
        opt_flags.set_flags(flags)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_counts(torch, reset=True)
    t0 = time.perf_counter()
    try:
        losses, wd = train(arch, smoke=False, steps=TRAIN_STEPS,
                           batch_size=TRAIN_B, seq_len=TRAIN_S,
                           device="cuda", log_every=1, verbose=False)
    finally:
        if flags:
            opt_flags.set_flags("")
    wall = time.perf_counter() - t0
    counted = train_counts(torch)
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in counted}
    want.update({k: n * TRAIN_STEPS for k, n in step_launches(cfg).items()
                 if k in counted})
    log(f"{label} {arch} train, {L} layers, {n_params / 1e9:.3f} B "
        f"params, bf16, batch {TRAIN_B} x {TRAIN_S}, flags "
        f"[{flags}]: losses {losses}; launches {counted} (want {want}: "
        f"forward and the checkpoint's recompute, one backward, per call "
        f"and step)")
    require(len(losses) == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"{label} losses {losses}")
    require(counted == want, f"{label} launches {counted}, want {want}")
    steps = list(wd.durations)
    step_s = statistics.median(steps[1:])
    log(f"{label} step walls (s): {[round(x, 4) for x in steps]} (the "
        f"first warms cuBLAS and builds nothing: the kernels are built); "
        f"median of the rest {step_s:.4f} s, {tokens / step_s:.0f} "
        f"tokens/s, {6 * n_params * tokens / step_s / 1e12:.1f} TFLOP/s at "
        f"6 * params * tokens = {6 * n_params * tokens / step_s / PEAK_FLOPS['bfloat16']:.1%} "
        f"of the bf16 peak; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); whole call "
        f"{wall:.1f} s with init")
    return dict(losses=losses, walls=steps, step_s=step_s, counted=counted,
                peak=peak)


def profile_train_step(torch, label: str, flags: str = "",
                       arch: str = TRAIN_ARCH) -> None:
    """One more step of ``arch`` under the profiler, from fresh weights,
    with the perf ``flags`` set: the card's busy time and its largest
    operations."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.dist import opt_flags
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.serve.steps import build_train_step
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = get_model(cfg)
    opt = adamw(1e-3)
    bundle = build_train_step(cfg, make_host_mesh(), InputShape(
        "train", TRAIN_S, TRAIN_B, "train"), optimizer=opt)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    state = opt.init(params)
    batch = SyntheticLM(cfg, TRAIN_B, TRAIN_S).next_batch()
    opt_flags.set_flags(flags)
    try:
        prof = kernel_time(torch, lambda: bundle.fn(params, state, batch))
    finally:
        opt_flags.set_flags("")
    log(f"{label} {arch} one train step, flags [{flags}], profiled: "
        f"{prof.get('ops')} device ops, busy {prof.get('busy_ms')} ms, span "
        f"{prof.get('span_ms')} ms; largest {prof.get('top')}")
    del params, state, bundle, model
    gc.collect()
    torch.cuda.empty_cache()


def train_full(torch) -> dict:
    """7b: ``train_run`` of each of TRAIN_ARCHS with no flag and one
    profiled step; returns {arch: run (its losses and launch counts)}."""
    runs = {}
    for arch in TRAIN_ARCHS:
        runs[arch] = train_run(torch, "7b", arch=arch)
        profile_train_step(torch, "7b", arch=arch)
    return runs


def restart_bit_exact(torch, arch: str) -> None:
    """7c: ``arch`` at full width, RESTART_LAYERS[arch] layers: 4 steps
    with a checkpoint every 2; then the step-4 checkpoint is set aside
    and ``train`` runs again from step 2. Steps 3-4 must give the same
    losses, and step 4 the same params and moments, bit for bit."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import mount_of
    from repro_torch.dist import fault
    from repro_torch.launch.train import train
    from repro_torch.train.optimizer import tree_leaves
    cfg = get_config(arch).replace(num_layers=RESTART_LAYERS[arch])
    times = {"save": [], "load": []}
    saved = (fault.save_checkpoint, fault.load_checkpoint)

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            times[key].append(time.perf_counter() - t0)
            return out
        return call
    fault.save_checkpoint = timed(saved[0], "save")
    fault.load_checkpoint = timed(saved[1], "load")
    ckdir = tempfile.mkdtemp(prefix="repro-torch-ckpt-")
    point, fstype = mount_of(ckdir)
    try:
        kw = dict(smoke=False, steps=4, batch_size=TRAIN_B,
                  seq_len=TRAIN_S, ckpt_dir=ckdir, ckpt_every=2,
                  device="cuda", verbose=False)
        losses_a, _ = train(cfg, **kw)
        last = fault.latest_checkpoint(ckdir)
        a = fault.load_checkpoint(last)
        size = Path(last).stat().st_size
        Path(last).unlink()
        losses_b, _ = train(cfg, **kw)
        b = fault.load_checkpoint(fault.latest_checkpoint(ckdir))
    finally:
        fault.save_checkpoint, fault.load_checkpoint = saved
        shutil.rmtree(ckdir, ignore_errors=True)
    same = [torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
            for x, y in zip(tree_leaves((a["params"], a["opt_state"])),
                            tree_leaves((b["params"], b["opt_state"])))]
    log(f"7c {arch} restart, {RESTART_LAYERS[arch]} layers at full width: "
        f"losses uninterrupted {losses_a}, restarted from step 2 {losses_b}; "
        f"{sum(same)} of {len(same)} params and moments leaves equal bit "
        f"for bit; checkpoint {size / 1e9:.2f} GB in {ckdir} on a {fstype} "
        f"filesystem mounted at {point}; save s "
        f"{[round(x, 2) for x in times['save']]}, load s "
        f"{[round(x, 2) for x in times['load']]}")
    require(losses_b == losses_a[2:], f"7c {arch} restarted losses differ")
    require(all(same) and a["step"] == b["step"] == 4,
            f"7c {arch} restarted params or moments differ")


def dense_plain_loss(torch, params, cfg, batch):
    """Kernel-free loss: the dense model with the plain attention, under
    autograd."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for lp in params["layers"]:
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        x = TF._attn_out_mlp(lp, x, ref.flash_attention_ref(q, k, v), cfg)
    return TF.cross_entropy(L.lm_logits(params["embed"], x, cfg),
                            batch["targets"])


def rwkv6_plain_loss(torch, params, cfg, batch):
    """Kernel-free loss: rwkv6 with the plain scan, under autograd."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    x = rwkv6_plain_hidden(torch, params, cfg, batch["tokens"])
    return TF.cross_entropy(L.lm_logits(params["embed"], x, cfg),
                            batch["targets"])


def zamba2_plain_loss(torch, params, cfg, batch):
    """Kernel-free loss: zamba2 with the plain scan and attention, under
    autograd, each layer checkpointed (the plain scan keeps a state a
    step: 2.7 GB a layer at batch 2 x 1024 in f32)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    x = zamba2_plain_hidden(torch, params, cfg, batch["tokens"], remat=True)
    return TF.cross_entropy(L.lm_logits(params["embed"], x, cfg),
                            batch["targets"])


PLAIN_LOSS = {"llama32-3b": dense_plain_loss, "rwkv6-3b": rwkv6_plain_loss,
              "zamba2-2.7b": zamba2_plain_loss}


def leaf_paths(tree, prefix: str = "") -> list:
    """Dotted names of ``tree``'s leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_paths(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


@contextlib.contextmanager
def in_float64(torch):
    """The kernel-free functions in f64: ``Tensor.float()`` keeps an f64
    tensor and the compute dtype float32 reads as float64, so f64 params
    stay f64 through the model code's casts (7d's exact reference)."""
    from repro_torch.models import layers as L
    own = "float" in vars(torch.Tensor)
    to_float, dtype_of = torch.Tensor.float, L.dtype_of

    def keep64(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return to_float(self, *args, **kwargs)
    torch.Tensor.float = keep64
    L.dtype_of = lambda name: (torch.float64 if name == "float32"
                               else dtype_of(name))
    try:
        yield
    finally:
        if own:
            torch.Tensor.float = to_float
        else:
            del torch.Tensor.float
        L.dtype_of = dtype_of


def train_parity(torch, arch: str) -> None:
    """7d: one f32 train step of ``arch`` at full width,
    PARITY_TRAIN_LAYERS[arch] layers, TF32 off, with the kernels (remat,
    the Functions) and kernel-free (PLAIN_LOSS: the plain attention and
    scans, autograd), from the same params and batch, and kernel-free in f64
    (``in_float64``) as the exact reference. Loss within 2e-4 relative;
    every gradient leaf within GRAD_TOL of its largest magnitude of the
    kernel-free one, or, where f32 itself cannot be held so close (at
    rwkv6-3b's full width the kernel-free f32 gradient is itself ~8e-4
    of a leaf's largest from the f64 one), the kernels' largest distance
    from f64 over the leaves (each over its leaf's largest) at most
    NOISE_FLOOR x the kernel-free f32's: phase 3's rule for bf16 logits.
    After one AdamW step the params' RMS difference within 1e-3 lr, or
    the kernels' RMS distance from the f64 step within NOISE_FLOOR x the
    kernel-free f32 step's; the largest difference within 2 lr (an Adam
    step is about lr whatever the gradient's size, so where a gradient
    is within its error of 0 its element may step either way)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve.steps import to_device
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, tree_leaves, tree_map
    cfg = get_config(arch).replace(
        num_layers=PARITY_TRAIN_LAYERS[arch], param_dtype="float32",
        compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    batch = to_device(SyntheticLM(cfg, TRAIN_B, TRAIN_S).next_batch(),
                      "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    train_counts(torch, reset=True)
    # a leaf the loss does not use (zamba2's per-layer ``norm``, as in the
    # reference) gets a zero gradient, as the train step gives it
    unused = dict(allow_unused=True, materialize_grads=True)
    loss_k, _ = model.loss(params, batch)
    grads_k = torch.autograd.grad(loss_k, leaves, **unused)
    counted = train_counts(torch)
    loss_p = PLAIN_LOSS[arch](torch, params, cfg, batch)
    grads_p = torch.autograd.grad(loss_p, leaves, **unused)
    for p in leaves:
        p.requires_grad_(False)
    params64 = tree_map(lambda t: t.double().requires_grad_(), params)
    with in_float64(torch):
        loss_64 = PLAIN_LOSS[arch](torch, params64, cfg, batch)
        require(loss_64.dtype == torch.float64, f"7d {arch} f64 loss is "
                                                f"{loss_64.dtype}")
        grads_64 = torch.autograd.grad(loss_64, tree_leaves(params64),
                                       **unused)
    del params64
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    rel = abs(loss_k - loss_p) / abs(loss_p)

    def dist(a, b):      # largest |a - b| over b's largest magnitude
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-300))
    per_leaf = [(dist(a, b), dist(a, c), dist(b, c), name)
                for a, b, c, name in zip(grads_k, grads_p, grads_64,
                                         leaf_paths(params))]
    over = [x for x in per_leaf if x[0] > GRAD_TOL]
    grad_err, k64, p64 = (max(x[i] for x in per_leaf) for i in range(3))
    log(f"7d {arch}: leaves by the kernels' distance from the kernel-free "
        f"f32 gradient, each over the leaf's largest [kernels vs f32, "
        f"kernels vs f64, kernel-free f32 vs f64]: " + "; ".join(
            f"{n}: {e:.2e}, {k64:.2e}, {p64:.2e}"
            for e, k64, p64, n in sorted(per_leaf, reverse=True)[:6])
        + f"; largest over all leaves: kernels vs f64 {k64:.2e}, "
        f"kernel-free f32 vs f64 {p64:.2e}; {len(over)} of "
        f"{len(per_leaf)} leaves past GRAD_TOL")
    updated = []
    for grads in (grads_k, grads_p, grads_64):
        opt = adamw(TRAIN_LR)
        p = tree_map(torch.clone, params)
        opt.update_([g.float() for g in grads], opt.init(p), p)
        updated.append(tree_leaves(p))

    def rms(xs, ys):
        return max(float((a - b).square().mean().sqrt())
                   for a, b in zip(xs, ys))
    diffs = [(a - b).abs() for a, b in zip(updated[0], updated[1])]
    p_err = max(float(d.max() / b.abs().max())
                for d, b in zip(diffs, updated[1]))
    p_rms = max(float(d.square().mean().sqrt()) for d in diffs)
    p_max = max(float(d.max()) for d in diffs)
    flips = sum(int((d > 0.1 * TRAIN_LR).sum()) for d in diffs)
    k_rms64, p_rms64 = (rms(updated[i], updated[2]) for i in (0, 1))
    log(f"7d {arch} f32 train step, {cfg.num_layers} layers at full "
        f"width: loss kernels {loss_k:.6f}, plain {loss_p:.6f} "
        f"(relative {rel:.2e}, tol 2e-4); grads max |diff| / leaf max "
        f"{grad_err:.2e} (tol {GRAD_TOL}, else {NOISE_FLOOR} x the f32 "
        f"noise floor); launches {counted}; after one AdamW step (lr "
        f"{TRAIN_LR}) params max |diff| / leaf max {p_err:.2e}, RMS "
        f"{p_rms:.2e} ({p_rms / TRAIN_LR:.2e} lr), max {p_max:.2e} "
        f"({p_max / TRAIN_LR:.2f} lr), {flips} elements past 0.1 lr; RMS "
        f"from the f64 step: kernels {k_rms64:.2e}, kernel-free f32 "
        f"{p_rms64:.2e}")
    require(rel <= 2e-4, f"7d {arch} loss differs by {rel:.2e}")
    require(grad_err <= GRAD_TOL or k64 <= NOISE_FLOOR * p64,
            f"7d {arch} grads differ by {grad_err:.2e}, and from f64 by "
            f"{k64:.2e} against the kernel-free f32's {p64:.2e}")
    require(all(counted[k] == n for k, n in step_launches(cfg).items()
                if k in BACKWARD), f"7d {arch} backward launches {counted}")
    require(counted.get("mamba2_ssd_backward_chunked", 0) == 0
            and counted.get("rwkv6_scan_backward_chunked", 0) == 0,
            f"7d {arch}: f32 took a chunked backward ({counted})")
    require((p_rms <= 1e-3 * TRAIN_LR or k_rms64 <= NOISE_FLOOR * p_rms64)
            and p_max <= 2.0 * TRAIN_LR,
            f"7d {arch} updated params differ: RMS {p_rms:.2e} (from f64 "
            f"{k_rms64:.2e} against {p_rms64:.2e}), max {p_max:.2e}")
    del params, grads_k, grads_p, grads_64, updated, diffs
    gc.collect()
    torch.cuda.empty_cache()


def rwkv6_bwd_cases():
    # (label, B, T, NH, hd, carried, decays): the training shape first
    # (rwkv6-3b at batch 2 x 1024; no carried state, as in training);
    # decays None: the model's, exp(-exp(w0 + lora)); "zeros": the
    # model's with a tenth exactly 0 (exp(-exp(x)) underflows in f32)
    yield "train", 2, 1024, 40, 64, False, None
    yield "B1", 1, 1024, 40, 64, False, None
    yield "carried", 2, 1024, 40, 64, True, None
    yield "hd32", 2, 1024, 80, 32, True, None
    yield "hd128", 2, 1024, 20, 128, True, None
    yield "near0", 2, 1024, 40, 64, True, (1e-6, 1e-3)
    yield "near1", 2, 1024, 40, 64, True, (0.999, 1.0)
    yield "zeros", 2, 1024, 40, 64, True, "zeros"
    yield "short", 1, 37, 40, 64, True, None
    yield "one", 1, 1, 40, 64, True, None


def plain_rwkv6_grads(torch, ins, dy, ds):
    """(dr, dk, dv, dw, du, dstate): autograd of the plain scan."""
    from repro_torch.kernels import ref
    leaves = [t.detach().requires_grad_() for t in ins]
    return torch.autograd.grad(ref.rwkv6_scan_ref(*leaves), leaves, (dy, ds))


def log_forward_from_f64(torch, ins) -> None:
    """The f32 forward kernel's y and final state, and the plain scan's,
    each at its largest distance from the f64 plain scan over that
    tensor's largest: what the forward adds to 7d's distance from f64."""
    from repro_torch.kernels import ref, rwkv6_scan
    with torch.no_grad():
        got = rwkv6_scan.rwkv6_scan(*ins)
        plain = ref.rwkv6_scan_ref(*ins)
        with in_float64(torch):
            exact = ref.rwkv6_scan_ref(*(t.double() for t in ins))
    dist = [[float((a.double() - c).abs().max() / c.abs().max())
             for a, c in zip(x, exact)] for x in (got, plain)]
    log(f"7e rwkv6 forward train    float32: y, final state from the f64 "
        f"scan over its largest: kernel ({rwkv6_scan.kernel_for(*ins[:4])}) "
        f"{[f'{x:.2e}' for x in dist[0]]}, plain "
        f"{[f'{x:.2e}' for x in dist[1]]}")


def rwkv6_backward_kernel(torch) -> dict:
    """7e: the rwkv6 backward kernel against autograd of the plain scan,
    in bf16 and f32: each of the six gradients within TOL of its largest
    magnitude (its sums run over up to T states of |S| up to ~100 near
    decay 1, in another order than autograd's, so an element near 0
    cannot be held to TOL of itself), two calls bit for bit equal, its
    route (bf16 at hd 64 must take the chunked one, its counter moving
    with it: near 0 and exact zeros included), its time (CUDA events,
    cold L2), at the training shape in bf16 the step kernel's time on the
    same inputs, the plain forward + backward's, and the bound (12
    operations per step, key and value: the state, G's update and the
    four sums; each input and gradient moved once); each route's resident
    blocks an SM. Returns the JSON row (training shape, bf16)."""
    from repro_torch.kernels import rwkv6_scan
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(9)
    row = None
    occ = rwkv6_scan.backward_occupancy()
    log(f"7e rwkv6 backward, resident blocks an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, hd 64, bf16): "
        f"step kernel {occ['step']} (256 threads), chunked route's carries "
        f"{occ['chunked_carries']} (256 threads), its chunk blocks "
        f"{occ['chunked_chunks']} (512 threads)")
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for label, B, T, NH, hd, carried, decay in rwkv6_bwd_cases():
            def randn(*shape):
                return torch.randn(*shape, generator=g, device="cuda")
            r, k, v, dy = (randn(B, T, NH, hd).to(dt) for _ in range(4))
            if decay in (None, "zeros"):
                w = torch.exp(-torch.exp(0.5 * randn(B, T, NH, hd) - 1.0))
                if decay == "zeros":
                    w = torch.where(torch.rand(w.shape, generator=g,
                                               device="cuda") < 0.1,
                                    torch.zeros_like(w), w)
            else:
                lo, hi = decay
                w = lo + (hi - lo) * torch.rand(B, T, NH, hd, generator=g,
                                                device="cuda")
            u = 0.1 * randn(NH, hd)
            zero = torch.zeros(B, NH, hd, hd, device="cuda")
            s0, ds = ((randn(B, NH, hd, hd), randn(B, NH, hd, hd))
                      if carried else (zero, zero))
            ins = (r, k, v, w, u, s0)
            route = rwkv6_scan.backward_kernel_for(r, k, v, w, dy)
            require(route == "chunked" or dtype_name == "float32"
                    or hd != 64, f"rwkv6 backward {label} {dtype_name}: "
                                 f"route {route}, not chunked")

            def kernel():
                return rwkv6_scan.rwkv6_scan_backward(*ins, dy, ds)
            chunked = rwkv6_scan.rwkv6_scan.backward_chunked_launches
            got, again = kernel(), kernel()
            require(rwkv6_scan.rwkv6_scan.backward_chunked_launches
                    == chunked + 2 * (route == "chunked"),
                    f"rwkv6 backward {label} {dtype_name}: route {route} "
                    f"not taken")
            want = plain_rwkv6_grads(torch, ins, dy, ds)
            with in_float64(torch):
                exact = plain_rwkv6_grads(torch, [t.double() for t in ins],
                                          dy.double(), ds.double())
            torch.cuda.synchronize()
            errs = [max_err(torch, a, b) for a, b in zip(got, want)]
            scales = [float(b.float().abs().max()) for b in want]
            # each gradient's distance from the f64 one over its largest:
            # the kernel's, and the plain f32 autograd's
            from64 = [[float((a.double() - c).abs().max() / c.abs().max())
                       for a, c in zip(grads, exact)] for grads in (got, want)]
            ok = all(e <= tol * max(sc, 1e-30) for e, sc in zip(errs, scales))
            same = all(same_bits(torch, a, b) for a, b in zip(got, again))
            ms = cuda_ms(torch, kernel, flush=flush)
            step = ""
            if label == "train" and route == "chunked":
                # the step kernel on the same inputs, in the same call:
                # its gradients within TOL too, then both timed in turns
                def step_kernel():
                    return rwkv6_scan.rwkv6_scan_backward(*ins, dy, ds,
                                                          route="step")
                errs_step = [max_err(torch, a, b) for a, b in zip(
                    step_kernel(), want)]
                step_ms = cuda_ms(torch, step_kernel, flush=flush)
                ms = statistics.median([ms, cuda_ms(torch, kernel,
                                                    flush=flush)])
                step_ms = statistics.median([step_ms, cuda_ms(
                    torch, step_kernel, flush=flush)])
                step = (f"; the step kernel on the same inputs {step_ms:.4f}"
                        f" ms ({step_ms / ms:.2f}x), max_abs_err "
                        f"{[f'{e:.3e}' for e in errs_step]}")
                require(all(e <= tol * max(sc, 1e-30) for e, sc in zip(
                    errs_step, [float(b.float().abs().max())
                                for b in want])),
                        f"rwkv6 backward step route: errors {errs_step}")
            plain_ms = cuda_ms(torch, lambda: plain_rwkv6_grads(
                torch, ins, dy, ds), reps=2, warmup=1)
            flops = 12.0 * B * T * NH * hd * hd
            nbytes = nbytes_of(*ins, dy, ds, *got)
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"7e rwkv6 backward {label:7s} {dtype_name:8s} B={B} T={T} "
                f"NH={NH} hd={hd} carried={carried} "
                f"w={decay or 'model'}, route {route}: max_abs_err dr dk "
                f"dv dw du dstate "
                f"{[f'{e:.3e}' for e in errs]} against largest "
                f"{[f'{x:.3e}' for x in scales]} (tol {tol} of it); from "
                f"f64 over its largest: kernel "
                f"{[f'{x:.2e}' for x in from64[0]]}, plain "
                f"{[f'{x:.2e}' for x in from64[1]]}; two "
                f"calls bit for bit {same}; kernel {ms:.4f} ms, plain "
                f"forward + backward {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms:.1%} of it{step}")
            require(ok, f"rwkv6 backward {label} {dtype_name}: errors "
                        f"{errs} over {tol} of {scales}")
            require(same, f"rwkv6 backward {label} {dtype_name}: two calls "
                          f"differ")
            if label == "train" and dtype_name == "float32":
                log_forward_from_f64(torch, ins)
            if label == "train" and dtype_name == "bfloat16":
                row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           design=f"{route}: bf16 at hd 64 on mma.sync (f32 "
                                  f"and other shapes step by step on the "
                                  f"CUDA cores)")
            del r, k, v, w, dy, u, s0, ds, ins, got, again, want, exact
    del flush_buf
    torch.cuda.empty_cache()
    return row


def ssd_bwd_cases():
    # (label, B, T, NH, P, N, carried, steps, skip): the training shape
    # first (zamba2-2.7b at batch 2 x 1024: no carried state, with D, as
    # in training); steps None: the model's dt, a softplus ~0.1; "near1":
    # x 1e-5 (decay ~1); "zeros": a tenth at 200 (A dt < -104: the decay
    # exactly 0 in f32)
    yield "train", 2, 1024, 80, 64, 64, False, None, True
    yield "B1", 1, 1024, 80, 64, 64, False, None, True
    yield "carried", 2, 1024, 80, 64, 64, True, None, True
    yield "N16", 2, 1024, 80, 32, 16, True, None, True
    yield "N128", 2, 1024, 40, 64, 128, True, None, True
    yield "near1", 2, 1024, 80, 64, 64, True, "near1", True
    yield "zeros", 2, 1024, 80, 64, 64, True, "zeros", True
    yield "noD", 2, 1024, 80, 64, 64, True, None, False
    yield "short", 1, 37, 80, 64, 64, True, None, True
    yield "one", 1, 1, 80, 64, 64, True, None, True


def plain_ssd_grads(torch, ins, dy, ds):
    """Autograd of the plain scan over every input that is not None: (dx,
    ddt, dA, dB, dC, dD, dstate), without dD for a D of None."""
    from repro_torch.kernels import ref
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in ins]
    return torch.autograd.grad(ref.mamba2_ssd_ref(*leaves),
                               [t for t in leaves if t is not None],
                               (dy, ds))


def ssd_backward_kernel(torch) -> dict:
    """7f: the SSD backward kernel against autograd of the plain scan, in
    bf16 and f32: each gradient within TOL of its largest magnitude (its
    sums run over up to T states and over the heads, in another order
    than autograd's), its distance from an f64 autograd beside the plain
    f32's, two calls bit for bit equal, its time (CUDA events, cold L2),
    the plain forward + backward's (at the training shape), and the bound
    (12 operations per (t, h, n, p): G's two updates, S_t and the four
    sums; each input and gradient moved once). Returns the JSON row
    (training shape, bf16)."""
    from repro_torch.kernels import mamba2_ssd
    import torch.nn.functional as F
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(11)
    row = None
    occ = mamba2_ssd.backward_occupancy()
    log(f"7f ssd backward, resident blocks an SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, N 64, bf16): step "
        f"kernel {occ['step']} (64 threads), chunked route's state launch "
        f"{occ['chunked_states']} (128 threads), its walk "
        f"{occ['chunked_walk']} (256 threads)")
    for dtype_name in ("bfloat16", "float32"):
        dt_ = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for (label, B, T, NH, P, N, carried, steps,
             skip) in ssd_bwd_cases():
            def randn(*shape):
                return torch.randn(*shape, generator=g, device="cuda")
            x, dy = (randn(B, T, NH, P).to(dt_) for _ in range(2))
            dt = F.softplus(randn(B, T, NH) - 2.5)
            if steps == "near1":
                dt = 1e-5 * dt
            elif steps == "zeros":
                dt = torch.where(torch.rand(dt.shape, generator=g,
                                            device="cuda") < 0.1,
                                 torch.full_like(dt, 200.0), dt)
            A = -torch.linspace(1.0, 16.0, NH, device="cuda")
            Bm, Cm = (randn(B, T, N).to(dt_) for _ in range(2))
            D = randn(NH) if skip else None
            zero = torch.zeros(B, NH, N, P, device="cuda")
            s0, ds = ((randn(B, NH, N, P), randn(B, NH, N, P))
                      if carried else (zero, zero))
            ins = (x, dt, A, Bm, Cm, D, s0)
            route = mamba2_ssd.backward_kernel_for(x, Bm, Cm, dy)

            def kernel():
                return mamba2_ssd.mamba2_ssd_backward(*ins, dy, ds)
            chunked = mamba2_ssd.mamba2_ssd.backward_chunked_launches
            got, again = kernel(), kernel()
            require(mamba2_ssd.mamba2_ssd.backward_chunked_launches
                    == chunked + 2 * (route == "chunked"),
                    f"ssd backward {label} {dtype_name}: route {route} not "
                    f"taken")
            keep = [i for i, t in enumerate(ins) if t is not None]
            got, again = [got[i] for i in keep], [again[i] for i in keep]
            want = plain_ssd_grads(torch, ins, dy, ds)
            with in_float64(torch):
                exact = plain_ssd_grads(
                    torch, [None if t is None else t.double() for t in ins],
                    dy.double(), ds.double())
            torch.cuda.synchronize()
            errs = [max_err(torch, a, b) for a, b in zip(got, want)]
            scales = [float(b.float().abs().max()) for b in want]
            # each gradient's distance from the f64 one over its largest:
            # the kernel's, and the plain f32 autograd's
            from64 = [[float((a.double() - c).abs().max()
                             / max(float(c.abs().max()), 1e-300))
                       for a, c in zip(grads, exact)] for grads in (got, want)]
            ok = all(e <= tol * max(sc, 1e-30) for e, sc in zip(errs, scales))
            same = all(same_bits(torch, a, b) for a, b in zip(got, again))
            ms = cuda_ms(torch, kernel, flush=flush)
            plain_ms = None
            if label == "train":
                plain_ms = cuda_ms(torch, lambda: plain_ssd_grads(
                    torch, ins, dy, ds), reps=2, warmup=1)
            flops = 12.0 * B * T * NH * N * P
            nbytes = nbytes_of(*(t for t in ins if t is not None), dy, ds,
                               *got)
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            names = [n for i, n in enumerate(
                ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate")) if i in keep]
            log(f"7f ssd backward {label:7s} {dtype_name:8s} B={B} T={T} "
                f"NH={NH} P={P} N={N} carried={carried} "
                f"dt={steps or 'model'} D={skip}, route {route}: max_abs_err "
                f"{' '.join(names)} {[f'{e:.3e}' for e in errs]} against "
                f"largest {[f'{x:.3e}' for x in scales]} (tol {tol} of "
                f"it); from f64 over its largest: kernel "
                f"{[f'{x:.2e}' for x in from64[0]]}, plain "
                f"{[f'{x:.2e}' for x in from64[1]]}; two calls bit for bit "
                f"{same}; kernel {ms:.4f} ms, plain forward + backward "
                f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}"
                f", bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it")
            require(ok, f"ssd backward {label} {dtype_name}: errors "
                        f"{errs} over {tol} of {scales}")
            require(same, f"ssd backward {label} {dtype_name}: two calls "
                          f"differ")
            if label == "train" and dtype_name == "bfloat16":
                row = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           design=f"{route}: bf16 at N 64 on mma.sync (f32 "
                                  f"and other shapes step by step on the "
                                  f"CUDA cores)")
            del x, dy, dt, Bm, Cm, D, s0, ds, ins, got, again, want, exact
    del flush_buf
    torch.cuda.empty_cache()
    return row


def phase_training(torch):
    """Phase 7: 7a to 7f; returns (7a's, 7e's and 7f's JSON rows, 7b's
    runs)."""
    rows = {"flash_attention_backward": flash_backward_kernel(torch)}
    runs = train_full(torch)
    for arch in TRAIN_ARCHS:
        restart_bit_exact(torch, arch)
    for arch in TRAIN_ARCHS:
        train_parity(torch, arch)
    rows["rwkv6_scan_backward"] = rwkv6_backward_kernel(torch)
    rows["mamba2_ssd_backward"] = ssd_backward_kernel(torch)
    return rows, runs


# ----------------------------------------------------------------------
# phase 8: the perf flags
# ----------------------------------------------------------------------
FLAG_RUNS = ("remat_dots", "bf16_logits", "remat_dots,bf16_logits")
FLAGS_B = 4                      # 8b's decode batch


def logged_flash_shapes(fn):
    """Calls ``fn`` and returns the (q, k) shapes that the flash forward
    kernel was launched at (its input check runs once a launch)."""
    from repro_torch.kernels import flash_prefill
    shapes, check = [], flash_prefill._check

    def logged(q, k, v):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return check(q, k, v)
    flash_prefill._check = logged
    try:
        out = fn()
    finally:
        flash_prefill._check = check
    return out, shapes


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def flags_serving(torch) -> dict:
    """8a and 8b on one llama32-3b build at full width and depth (bf16,
    seeded weights): a 1 x PROMPT prefill with ``pad_heads`` off and on
    (logits and cache bit for bit, flash launched L times at the
    regrouped heads), and ``Model.decode_step`` on the dense cache at
    B = FLAGS_B after a prefill, ``masked_cache_update`` off and on
    (logits and cache bit for bit). Returns the launch counts of the
    flagged runs."""
    from repro_torch.configs import get_config
    from repro_torch.dist import opt_flags
    from repro_torch.models import get_model
    cfg = get_config(TRAIN_ARCH)
    L, H, KV = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (FLAGS_B, PROMPT + 1),
                         generator=g, device="cuda")
    counted = {k: 0 for k in launch_counters()}

    def prefill(n):
        return model.prefill(params, {"tokens": toks[:n, :PROMPT]},
                             s_max=PROMPT + 1)

    with torch.no_grad():
        base = prefill(1)
        opt_flags.set_flags("pad_heads")
        try:
            for fn in launch_counters().values():
                fn.launches = 0
            tuned, shapes = logged_flash_shapes(lambda: prefill(1))
            got = {k: fn.launches for k, fn in launch_counters().items()}
        finally:
            opt_flags.set_flags("")
        torch.cuda.synchronize()
        same = [same_bits(torch, a, b) for a, b in
                zip((base[0], *base[1]), (tuned[0], *tuned[1]))]
        log(f"8a pad_heads: {TRAIN_ARCH} prefill 1 x {PROMPT} (H {H}, KV "
            f"{KV}): flash launched at (q, k) shapes {sorted(set(shapes))}, "
            f"{got['flash_attention']} launches (want {L}); logits, cache "
            f"k, cache v bit for bit equal to the flag off: {same}")
        require(all(same), "8a pad_heads prefill differs from the flag off")
        require(got["flash_attention"] == L and len(shapes) == L,
                f"8a flash launches {got}")
        want_q = (1, PROMPT, 32, cfg.head_dim)
        require(all(q == want_q and k[2] == 16 for q, k in shapes),
                f"8a flash ran at {sorted(set(shapes))}, want q {want_q} "
                f"over 16 kv heads")
        for k, n in got.items():
            counted[k] += n
        del base, tuned

        for fn in launch_counters().values():
            fn.launches = 0
        logits0, cache = prefill(FLAGS_B)
        counted["flash_attention"] += launch_counters()[
            "flash_attention"].launches
        nxt = toks[:, PROMPT]
        pos = torch.full((FLAGS_B,), PROMPT, dtype=torch.int32,
                         device="cuda")
        out = {}
        for flags in ("", "masked_cache_update"):
            opt_flags.set_flags(flags)
            try:
                out[flags] = model.decode_step(params, nxt, cache, pos)
            finally:
                opt_flags.set_flags("")
        torch.cuda.synchronize()
        (a, ca), (b, cb) = out[""], out["masked_cache_update"]
        same = [same_bits(torch, x, y) for x, y in
                zip((a, *ca), (b, *cb))]
        log(f"8b masked_cache_update: {TRAIN_ARCH} decode_step on the dense "
            f"cache (B {FLAGS_B}, {PROMPT}-token prefill, cache "
            f"{tuple(ca.k.shape)}): logits, cache k, cache v bit for bit "
            f"equal to the flag off: {same}; logits finite "
            f"{bool(torch.isfinite(a).all())}")
        require(all(same), "8b masked_cache_update decode differs")
        require(bool(torch.isfinite(a).all()), "8b logits not finite")
    del params, model, cache, out, logits0
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def flags_training(torch, base: dict) -> dict:
    """8c: ``train_run`` under each of FLAG_RUNS, with one profiled step
    each, against 7b's run ``base``: under ``remat_dots`` each loss
    within 1e-5 relative of 7b's; under ``bf16_logits`` step 1's loss
    within 1e-2 of 7b's. Returns the summed launch counts."""
    counted = {}
    for flags in FLAG_RUNS:
        run = train_run(torch, "8c", flags)
        profile_train_step(torch, "8c", flags)
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   base["losses"])]
        log(f"8c [{flags}] against 7b: losses relative diff {rel}, bit for "
            f"bit equal {run['losses'] == base['losses']}; step "
            f"{run['step_s'] * 1e3:.1f} ms against {base['step_s'] * 1e3:.1f}"
            f" ms ({run['step_s'] / base['step_s'] - 1:+.1%}); peak "
            f"{run['peak'] / 1e9:.2f} GB against {base['peak'] / 1e9:.2f} GB "
            f"({(run['peak'] - base['peak']) / 1e9:+.2f} GB)")
        if "bf16_logits" in flags:
            require(abs(run["losses"][0] - base["losses"][0]) <= 1e-2,
                    f"8c [{flags}] step 1 loss {run['losses'][0]} against "
                    f"7b's {base['losses'][0]}")
        else:
            require(max(rel) <= 1e-5, f"8c [{flags}] losses {rel} off 7b")
        for k, n in run["counted"].items():
            counted[k] = counted.get(k, 0) + n
    return counted


def phase_flags(torch, base: dict) -> dict:
    """Phase 8: 8a to 8c; returns the launch counts of its main-path
    runs."""
    counted = flags_serving(torch)
    counted.update({k: 0 for k in BACKWARD})
    for k, n in flags_training(torch, base).items():
        counted[k] = counted.get(k, 0) + n
    return counted


# ----------------------------------------------------------------------
# diagnostics (not run by default)
# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# phase 9: the collectives on NCCL, the dry run, and the dry run against
# the card
# ----------------------------------------------------------------------
# llama32-3b and ASSIGNED_ARCHS, the longest runs first (45-90 s each on
# the card's host)
DRYRUN_SINGLE = ("moonshot-v1-16b-a3b", "zamba2-2.7b", "rwkv6-3b",
                 "yi-34b", "deepseek-moe-16b", "command-r-35b",
                 "qwen3-1.7b", "seamless-m4t-medium", "qwen2-0.5b",
                 "llama32-3b", "internvl2-2b")
DRYRUN_MULTI = ("llama32-3b", "qwen2-0.5b")
DRYRUN_REQUIRED = ("llama32-3b", "qwen2-0.5b", "qwen3-1.7b", "yi-34b",
                   "command-r-35b")     # the dense family: every cell ok
DRYRUN_WORKERS = 8                      # the host's cores, idle by then
DRYRUN_TIMEOUT_S = 600
# the H100 SXM's data sheet: bf16 dense peak and HBM rate (PEAK_FLOPS,
# PEAK_BYTES), NVLink 4 at 18 links x 50 GB/s (both directions), 80 GB
H100_CHIP = dict(peak_flops=PEAK_FLOPS["bfloat16"], hbm_bw=PEAK_BYTES,
                 ici_bw_per_link=50e9, ici_links=18, hbm_gb=80.0)


class DryRuns:
    """9b's dry runs, ``python -m repro_torch.launch.dryrun`` of one arch
    each, DRYRUN_WORKERS at a time with no card visible (they run on fake
    tensors), started after every phase that times the card, so that no
    wall is taken on a loaded host. ``results`` waits for them; on any
    exit every process still running is killed."""

    def __init__(self, src: Path):
        import concurrent.futures
        import os
        import tempfile
        self._dir = tempfile.TemporaryDirectory(prefix="dryrun-")
        self._procs = []
        self._env = dict(os.environ, PYTHONPATH=str(src),
                         CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.jobs = [(a, "single", []) for a in DRYRUN_SINGLE] + [
            (a, "multi", ["--no-analyze"]) for a in DRYRUN_MULTI]
        self._pool = concurrent.futures.ThreadPoolExecutor(DRYRUN_WORKERS)
        self._futures = [self._pool.submit(self._run, *job)
                         for job in self.jobs]

    def _run(self, arch: str, mesh: str, extra: list):
        out = Path(self._dir.name) / f"{arch}-{mesh}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--mesh", mesh, "--out", str(out), *extra]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=self._env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        self._procs.append(proc)
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {DRYRUN_TIMEOUT_S} s)"
        records = json.loads(out.read_text()) if out.exists() else None
        return arch, mesh, text, records, time.perf_counter() - t0

    def results(self) -> list:
        try:
            return [f.result() for f in self._futures]
        finally:
            self.close()

    def close(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._dir.cleanup()


def nccl_collectives(torch) -> None:
    """9a: the five collectives of ``repro_torch.dist.collectives`` on
    NCCL in the world the machine has (one rank a card), each against
    its analytic result there."""
    import socket
    import torch.distributed as dist
    from repro_torch.dist import collectives as C
    n = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(4, 6, 8, generator=g, device="cuda")
        tree = {"a": torch.randn(1000, generator=g, device="cuda"),
                "b": torch.randn(37, generator=g, device="cuda").bfloat16()}
        checks = {
            "ring_pass": torch.equal(C.ring_pass(x), x),
            "ring_allgather": torch.equal(C.ring_allgather(x), x),
            "halo_exchange": torch.equal(
                C.halo_exchange(x, halo=2, seq_axis=1),
                torch.cat([torch.zeros_like(x[:, :2]), x], 1)),
            "bucketed_psum": all(torch.equal(v, tree[k]) for k, v in
                                 C.bucketed_psum(tree, bucket_bytes=256)
                                 .items()),
        }
        mean, err = C.compressed_psum(tree)
        # one rank: the mean is the dequantized value, and value = mean +
        # err up to the cast of the mean to the leaf's dtype
        checks["compressed_psum"] = all(
            float((mean[k].float() + err[k] - tree[k].float()).abs().max())
            <= (0 if tree[k].dtype == torch.float32 else 1e-2)
            * float(tree[k].float().abs().max()) + 1e-6 for k in tree)
        torch.cuda.synchronize()
        log(f"9a NCCL, world of {dist.get_world_size()} (this machine has "
            f"{n} card{'s' if n > 1 else ''}): " + ", ".join(
                f"{k} {'ok' if v else 'WRONG'}" for k, v in checks.items())
            + "; a two-rank NCCL world needs a second card (NCCL refuses "
            "two ranks on one GPU)")
        require(all(checks.values()), f"9a collectives on NCCL: {checks}")
    finally:
        dist.destroy_process_group()


def dryrun_results(runs: DryRuns) -> dict:
    """9b: every record's line as the reference prints it; fails unless
    every applicable cell of DRYRUN_REQUIRED is ok on 16x16 and every
    DRYRUN_MULTI cell on 2x16x16. Other families' failures are logged
    with their error."""
    recs, bad = [], []
    for arch, mesh, text, records, secs in runs.results():
        for line in text.splitlines():
            if line.startswith(("[ OK ]", "[SKIP]", "[FAIL]")):
                log(f"9b {line}")
        log(f"9b {arch} {mesh}: {secs:.1f} s")
        if records is None:
            log(f"9b {arch} {mesh}: no records; output tail:\n{text[-3000:]}")
            bad.append(f"{arch} {mesh}: no records")
            continue
        for r in records:
            recs.append(r)
            if r["status"] == "fail":
                log(f"9b FAIL {r['arch']} {r['shape']} {r['mesh']}: "
                    f"{r['error']}")
                if r["arch"] in DRYRUN_REQUIRED or mesh == "multi":
                    bad.append(f"{r['arch']} {r['shape']} {r['mesh']}")
    for arch in DRYRUN_REQUIRED:
        cells = [r for r in recs if r["arch"] == arch
                 and r["mesh"] == "16x16"]
        if len(cells) != 4:
            bad.append(f"{arch} 16x16: {len(cells)} of 4 cells")
    require(not bad, f"9b dry-run cells not ok: {bad}")
    return {f"{r['arch']} {r['shape']} {r['mesh']}": {
        k: r[k] for k in ("status", "argument_bytes", "temp_bytes",
                          "compile_s", "roofline") if k in r}
        for r in recs}


def dryrun_against_card(torch) -> dict:
    """9c: the dry run of llama32-3b's train step at 7b's shape on the
    one-device mesh, against the same step on the card: argument bytes
    equal to the real arguments', the fake flop count equal to
    ``FlopCounterMode`` over the real step, MemTracker's peak beside
    ``max_memory_allocated``, and the roofline's step time (the H100's
    data sheet rates) beside the measured wall."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.costs import ChipSpec
    from repro_torch.dist.hlo_analysis import RooflineTerms
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.steps import build_step
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, tree_leaves
    cfg = get_config(TRAIN_ARCH)
    shape = InputShape("card", TRAIN_S, TRAIN_B, "train")
    mesh = make_host_mesh(device_type="cuda")
    t0 = time.perf_counter()
    fake = trace_step(cfg, shape, mesh, track_memory=True)
    fake_s = time.perf_counter() - t0
    bundle = build_step("train", cfg, mesh, shape)
    params = bundle.model.init(torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
    state = adamw(1e-3).init(params)
    data = SyntheticLM(cfg, TRAIN_B, TRAIN_S)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             data.next_batch().items()}
    real_args = (params, state, batch)
    real_bytes = sum(t.numel() * t.element_size()
                     for a in real_args for t in tree_leaves(a))
    with FlopCounterMode(display=False) as fc:
        bundle.fn(*real_args)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bundle.fn(*real_args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    c = fake["counts"]
    chip = dataclasses.replace(ChipSpec(), **H100_CHIP)
    terms = RooflineTerms(flops=c.flops, hbm_bytes=c.bytes,
                          collective_bytes=0, n_chips=1, chip=chip)
    wall = statistics.median(walls)
    log(f"9c {TRAIN_ARCH} train {TRAIN_B} x {TRAIN_S} bf16, one-device "
        f"mesh: dry run {fake_s:.1f} s on fake tensors; argument bytes "
        f"{fake['argument_bytes']} (dry run) vs {real_bytes} (the real "
        f"arguments on the card); flops {c.flops} (dry run) vs {real_flops} "
        f"(FlopCounterMode over the real step); MemTracker peak "
        f"{fake['peak_bytes'] / 2**30:.2f} GiB vs max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; roofline at the H100 data sheet's rates: "
        f"compute {terms.compute_s * 1e3:.1f} ms, memory "
        f"{terms.memory_s * 1e3:.1f} ms ({c.bytes / 1e9:.1f} GB counted), "
        f"step {terms.step_time_s * 1e3:.1f} ms ({terms.dominant}) vs the "
        f"measured wall {wall * 1e3:.1f} ms (median of "
        f"{[round(w * 1e3, 1) for w in walls]})")
    require(fake["argument_bytes"] == real_bytes,
            f"9c argument bytes {fake['argument_bytes']} != {real_bytes}")
    require(c.flops == real_flops, f"9c flops {c.flops} != {real_flops}")
    del params, state, batch, real_args, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return dict(argument_bytes=fake["argument_bytes"], flops=c.flops,
                memtracker_peak=fake["peak_bytes"], max_memory=peak,
                roofline_step_s=terms.step_time_s, wall_s=wall, walls=walls)


def dtensor_counts() -> dict:
    """9c: the dry run's counter on DTensors in this torch, on a fake
    2-rank mesh: flash's forward operator on q [1, 8, 4, 16] and k, v
    [1, 8, 2, 16] sharded on heads, and x [8, 16] (columns sharded) times
    w [16, 8] (rows sharded) made whole. One rank's count, written out:
    flash over its 2 query heads and 36 causal pairs, 4 * 2 * 16 * 36
    flops, reading q (1024 bytes), k and v (512 each) and writing 1024;
    the local [8, 8] x [8, 8] product, 2 * 8 * 8 * 8 flops and 3 * 256
    bytes; one all-reduce of 256 bytes. DTensor's bookkeeping and its
    metadata queries count nothing (the 9b cells rest on that)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.dist.hlo_analysis import count
    from repro_torch.kernels.flash_prefill import flash_fwd
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))

        def step(q, k, v, x, w):
            return (flash_fwd(q, k, v, True, 0, 0),
                    (x @ w).redistribute(mesh, [Replicate()]))
        with FakeTensorMode():
            def local(pl, *shape):
                return DTensor.from_local(torch.empty(*shape), mesh, [pl],
                                          run_check=False)
            args = (local(Shard(2), 1, 8, 2, 16),
                    local(Shard(2), 1, 8, 1, 16),
                    local(Shard(2), 1, 8, 1, 16),
                    local(Shard(1), 8, 8), local(Shard(0), 8, 8))
        _, c = count(step, *args)
    finally:
        dist.destroy_process_group()
    got = dict(flops=c.flops, bytes=c.bytes,
               collectives=dict(c.collectives.bytes_by_kind),
               counts=dict(c.collectives.count_by_kind))
    want = dict(flops=4 * 2 * 16 * 36 + 2 * 8 * 8 * 8,
                bytes=(1024 + 2 * 512 + 1024) + 3 * 256,
                collectives={"all-reduce": 256}, counts={"all-reduce": 1})
    log(f"9c the counter on DTensors (fake 2-rank mesh, torch "
        f"{torch.__version__}): {got} (written out: {want})")
    require(got == want, f"9c counts on DTensors {got} != {want}")
    return got


def phase_dist(torch) -> dict:
    """9a, 9c, then 9b: the card's checks first, the dry runs last."""
    nccl_collectives(torch)
    counted = dtensor_counts()
    card = dryrun_against_card(torch)
    t0 = time.perf_counter()
    runs = DryRuns(SRC)
    cells = dryrun_results(runs)
    log(f"9b {len(runs.jobs)} dry runs, {DRYRUN_WORKERS} at a time: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(cells=cells, card=card, dtensor_counts=counted)


def dist_only(torch) -> dict:
    """``--dist``: phase 9 alone."""
    return phase_dist(torch)


def windows_only(torch) -> dict:
    """``--windows DIR``: phase 3's prefill and decode-step times of each
    arch, its handoff's store and fetch per medium, the flash wrapper's
    host time at the main shape, the paged kernel's times
    (``paged_windows``) and the operator dispatch's host cost
    (``operator_cost`` a call, and llama32-3b's walls through the
    operators and past them, ``operator_walls``, where the checkout has
    the operators), for the
    checkout whose ``src`` is on the path, with this script's yardsticks.
    Run on two checkouts in one call, it compares them like for like."""
    from repro_torch.configs import get_config
    from repro_torch.core import random_workload
    from repro_torch.kernels import flash_prefill
    from repro_torch.models import get_model
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, PROMPT, 24, 128, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(1, PROMPT, 8, 128, generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    out["flash_wrapper_host_ms"] = wrapper_host_ms(
        torch, lambda: flash_prefill.flash_attention(q, k, v, causal=True))
    log(f"flash main bfloat16: wrapper host time "
        f"{out['flash_wrapper_host_ms']:.4f} ms per call")
    out["paged"] = paged_windows(torch, g)
    from repro_torch.kernels import paged_decode
    if hasattr(paged_decode, "paged_op"):   # a checkout with the operators
        out["operator_cost"] = operator_cost(torch, g, (q, k, v))
    for arch in ARCHS:
        cfg = get_config(arch)
        try:
            model = get_model(cfg)
        except NotImplementedError as e:     # a checkout before its port
            log(f"{arch}: skipped, {e}")
            continue
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        prompt = list(random_workload(1, input_len=PROMPT, output_len=OUTPUT,
                                      vocab_size=cfg.vocab_size,
                                      seed=0)[0].prompt_tokens)
        prefill, step, payload, _ = main_path_fns(torch, model, params, cfg,
                                                  prompt, prompt[:N_REQ])
        out[arch] = window_times(torch, prefill, step)
        log_windows(arch, out[arch])
        if arch == "llama32-3b" and "operator_cost" in out:
            out[arch]["operator_walls"] = operator_walls(torch, arch,
                                                         prefill, step)
        out[arch]["transfer"] = transfer_times(torch, payload)
        log(f"{arch} store / fetch ms per medium: " + ", ".join(
            f"{m} {t[0]:.3f} / {t[1]:.3f}"
            for m, t in out[arch]["transfer"].items()))
        del model, params, prefill, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def operator_cost(torch, g, qkv, rounds: int = 7) -> dict:
    """The host time a call that the operator dispatch adds: flash's
    forward at the main prefill shape and paged at the main decode shape,
    each called through its ``torch.ops.repro_torch`` operator and
    through the CUDA implementation the operator dispatches to, in turns
    (``rounds`` of ``wrapper_host_ms``, medians), in ms."""
    from repro_torch.kernels import flash_prefill, paged_decode
    q, k, v = qkv
    args = paged_inputs(torch, g, torch.bfloat16, N_REQ, 24, 8, 128, 16,
                        [1025, 1040, 1049, 1056])
    pairs = {
        "flash": (lambda: flash_prefill.flash_fwd(q, k, v, True, 0, 0),
                  lambda: flash_prefill._forward(q, k, v, True, 0, 0)),
        "paged": (lambda: paged_decode.paged_op(*args),
                  lambda: paged_decode._launch(*args))}
    out = {}
    for name, (op, direct) in pairs.items():
        times = {"operator": [], "direct": []}
        for _ in range(rounds):
            times["operator"].append(wrapper_host_ms(torch, op, 200))
            times["direct"].append(wrapper_host_ms(torch, direct, 200))
        med = {k: statistics.median(t) for k, t in times.items()}
        out[name] = dict(med, added=med["operator"] - med["direct"])
        log(f"{name} operator dispatch: {med['operator']:.4f} ms a call "
            f"through torch.ops.repro_torch, {med['direct']:.4f} ms calling "
            f"its CUDA implementation directly: +{out[name]['added'] * 1e3:.1f}"
            f" us a call (medians of {rounds} turns of 200 calls)")
    return out


@contextlib.contextmanager
def direct_route():
    """The flash and paged wrappers call their CUDA implementations
    straight, past the operator dispatch: the route before the kernels
    were operators."""
    from repro_torch.kernels import flash_prefill, paged_decode
    saved = flash_prefill.flash_fwd, paged_decode.paged_op
    flash_prefill.flash_fwd = flash_prefill._forward
    paged_decode.paged_op = paged_decode._launch
    try:
        yield
    finally:
        flash_prefill.flash_fwd, paged_decode.paged_op = saved


def operator_walls(torch, arch: str, prefill, step, rounds: int = 10
                   ) -> dict:
    """Phase 3's prefill and decode-step walls through the operators and
    through ``direct_route``, in one process, in ``rounds`` turns whose
    order alternates (``host_ms`` of 5 calls each): the operator
    dispatch's share of the walls, free of the spread between processes.
    Medians and quartiles in ms."""
    out = {}
    for name, fn in (("prefill", prefill), ("decode", step)):
        times = {"operator": [], "direct": []}
        for r in range(rounds):
            for side in (("operator", "direct") if r % 2 == 0
                         else ("direct", "operator")):
                with direct_route() if side == "direct" else \
                        contextlib.nullcontext():
                    times[side].append(host_ms(torch, fn))
        q = {k: statistics.quantiles(t, n=4) for k, t in times.items()}
        med = {k: statistics.median(t) for k, t in times.items()}
        out[name] = dict(times=times, median=med, quartiles=q,
                         added=med["operator"] - med["direct"],
                         wins=sum(a > b for a, b in zip(times["operator"],
                                                        times["direct"])))
        log(f"{arch} {name} wall through the operators / straight to the "
            f"CUDA implementations, {rounds} alternating turns in one "
            f"process: medians {med['operator']:.3f} / {med['direct']:.3f}"
            f" ms ({100 * out[name]['added'] / med['direct']:+.2f}%), "
            f"quartiles {[round(x, 3) for x in q['operator']]} / "
            f"{[round(x, 3) for x in q['direct']]}; the operators slower "
            f"in {out[name]['wins']} of {rounds} turns")
    return out


def train_only(torch) -> dict:
    """``--train DIR``: phase 7b's training run (no flag) of each of
    TRAIN_ARCHS, and one profiled step of each, of the checkout whose
    ``src`` is on the path: losses, step walls, launches, peak memory and
    the card's busy time. Run on two checkouts in one call (parent,
    change, change, parent), it shows whether a change moved the train
    steps' numbers."""
    out = {}
    for arch in TRAIN_ARCHS:
        run = train_run(torch, "7b", arch=arch)
        profile_train_step(torch, "7b", arch=arch)
        out[arch] = dict(run, walls=[round(x, 4) for x in run["walls"]])
    return out


def transfer_times(torch, payload) -> dict:
    """Store and fetch ms of one handoff payload per medium, with the
    ``core/transfer.py`` of the checkout on the path."""
    from repro_torch.core import make_path
    return {m: store_fetch_ms(torch, make_path(m), payload)
            for m in ("ici", "host", "disk")}


def paged_windows(torch, g) -> dict:
    """The paged kernel of the checkout on the path, bf16, at the main
    shape, with the lengths x4 (``x4``), at B=16 with the live bytes of
    ``x4`` (``B16``), and at the ``long`` and ``B1-8k`` shapes of phase 2:
    kernel ms (cold L2, as phase 2) beside the bound, and the wrapper's
    host time at the main shape."""
    from repro_torch.kernels import paged_decode
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    main = [1025, 1040, 1049, 1056]
    cases = {"main": (4, main), "x4": (4, [4 * n for n in main]),
             "B16": (16, main * 4),
             "long": (4, [32768, 30001, 16384, 1]), "B1-8k": (1, [8192])}
    out = {}
    for label, (B, lens) in cases.items():
        args = paged_inputs(torch, g, torch.bfloat16, B, 24, 8, 128, 16,
                            lens)
        ms = cuda_ms(torch, lambda: paged_decode.paged_attention(*args),
                     flush=flush)
        b_ms, _ = paged_bound(args[0], args[3], args[4], 8, lens, "bfloat16")
        out[label] = dict(ms=ms, bound_ms=b_ms)
        if label == "main":
            out[label]["wrapper_host_ms"] = wrapper_host_ms(
                torch, lambda: paged_decode.paged_attention(*args))
        log(f"paged {label:5s} bfloat16 B={B} H=24 KV=8 hd=128 page=16 "
            f"seq_lens={short(lens)}: kernel {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms, {b_ms / ms:.1%} of it"
            + (f"; wrapper host time {out[label]['wrapper_host_ms']:.4f} ms"
               if label == "main" else ""))
        del args
    return out


ABLATIONS = {   # kernel: (source, macro, {value: the part switched off})
    "flash": ("flash_prefill", "FLASH_ABLATE", {
        1: "softmax arithmetic off", 2: "O += P V off", 3: "S = Q K^T off"}),
    "rwkv6": ("rwkv6_scan", "RWKV6_ABLATE", {
        1: "A tiles off", 2: "operand pass off", 3: "products off",
        4: "logarithms off"}),
    "ssd_backward": ("mamba2_ssd_backward", "SSD_BWD_ABLATE", {
        1: "chunk-start state off", 2: "dL scan off", 3: "K, E tiles off",
        4: "G products off", 5: "stores off"}),
    "rwkv6_backward": ("rwkv6_backward", "RWKV6_BWD_ABLATE", {
        1: "carries off", 2: "A, dA tiles off", 3: "dV, dR, dK products off",
        4: "dw pass off", 5: "stores of dr, dk, dv off",
        6: "exact dw rows off"}),
}


def ablated_builds(kernel: str) -> dict:
    """The kernel's source built once per ablation value (one nvcc each,
    all started together): {value: ctypes library}."""
    from repro_torch.kernels import _build
    name, macro, parts = ABLATIONS[kernel]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in parts:
        lib = _build.BUILD_DIR / f"lib{name}-ablate{n}.so"
        procs[n] = lib, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, f"-D{macro}={n}", "-o", str(lib),
             str(_build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for n, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        require(proc.returncode == 0, f"{kernel} ablation {n} build:\n{report}")
        libs[n] = ctypes.CDLL(str(lib))
        libs[n].kernel_error_string.argtypes = [ctypes.c_int]
        libs[n].kernel_error_string.restype = ctypes.c_char_p
    return libs


def ablated_times(torch, kernel: str, symbol: str, libs: dict, fn,
                  flush) -> dict:
    """``fn`` timed with the wrapper bound, in turn, to the entry
    ``symbol`` of each ablated build in ``libs`` (then to the built one's
    again): {the part switched off: ms}."""
    from repro_torch.kernels import _build
    name, _, parts = ABLATIONS[kernel]
    built = _build.load(name)
    out = {}
    for n, what in parts.items():
        _build._libs[name] = libs[n]
        _build._launchers.pop(symbol, None)
        try:
            out[what] = cuda_ms(torch, fn, flush=flush)
        finally:
            _build._libs[name] = built
            _build._launchers.pop(symbol, None)
    return out


def flash_ablation(torch) -> dict:
    """``--flash-ablation``: the bf16 flash kernel as built (also with the
    log-sum-exp that training keeps) and built with FLASH_ABLATE = 1, 2,
    3, each of which switches one part of it off (its output is then
    wrong), timed at the main shape, at S = 8192 and at hd 64 and 80:
    what each part costs the kernel."""
    from repro_torch.kernels import flash_prefill
    fns = {}
    for n, lib in ablated_builds("flash").items():
        fns[n] = lib.flash_prefill_fwd
        fns[n].argtypes = flash_prefill._ARGTYPES
        fns[n].restype = ctypes.c_int

    def launch(fn, q, k, v, o):
        B, S, H, hd = q.shape
        err = fn(1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), B, S, k.shape[1], H, k.shape[2],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 1, 0, 0,
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"ablation launch: CUDA error {err}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, S, H, KV, hd in (("main", 1024, 24, 8, 128),
                                ("long", 8192, 24, 8, 128),
                                ("hd64", 1024, 16, 8, 64),
                                ("hd80", 1024, 32, 32, 80)):
        q = torch.randn(1, S, H, hd, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(1, S, KV, hd, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        o = torch.empty_like(q)
        reps = 5 if S >= 8192 else 20
        t = {"as built": cuda_ms(torch, lambda: flash_prefill.flash_attention(
            q, k, v, causal=True), reps=reps, flush=flush)}
        t["as built, with lse"] = cuda_ms(
            torch, lambda: flash_prefill.flash_attention_with_lse(
                q, k, v, causal=True), reps=reps, flush=flush)
        for n, what in ABLATIONS["flash"][2].items():
            t[what] = cuda_ms(torch, lambda: launch(fns[n], q, k, v, o),
                              reps=reps, flush=flush)
        out[label] = t
        log(f"flash ablation {label} (S={S} H={H} KV={KV} hd={hd}, causal): "
            + ", ".join(f"{w} {ms:.4f} ms" for w, ms in t.items()))
    return out


def rwkv6_ablation(torch) -> dict:
    """``--rwkv6-ablation``: the chunked bf16 rwkv6 kernel as built and
    built with RWKV6_ABLATE = 1..4, each of which switches one part of it
    off (its output is then wrong), timed at rwkv6-3b's prefill shape and
    at B = 4: what each part costs the kernel."""
    from repro_torch.kernels import rwkv6_scan
    fns = {}
    for n, lib in ablated_builds("rwkv6").items():
        fns[n] = lib.rwkv6_scan_fwd
        fns[n].argtypes = rwkv6_scan._ARGTYPES
        fns[n].restype = ctypes.c_int

    def launch(fn, r, k, v, w, u, s0, y, s1):
        B, T, NH, hd = r.shape
        err = fn(1, 1, hd, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                 s1.data_ptr(), B, T, NH, *r.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *w.stride()[:3],
                 torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"ablation launch: CUDA error {err}")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, B in (("main", 1), ("B4", 4)):
        T, NH, hd = PROMPT, 40, 64
        r, k, v = (torch.randn(B, T, NH, hd, generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(0.5 * torch.randn(
            B, T, NH, hd, generator=g, device="cuda") - 1.0))
        u = 0.1 * torch.randn(NH, hd, generator=g, device="cuda")
        s0 = torch.zeros(B, NH, hd, hd, device="cuda")
        y, s1 = torch.empty_like(r), torch.empty_like(s0)
        t = {"as built": cuda_ms(torch, lambda: rwkv6_scan.rwkv6_scan(
            r, k, v, w, u, s0), flush=flush)}
        for n, what in ABLATIONS["rwkv6"][2].items():
            t[what] = cuda_ms(torch, lambda: launch(
                fns[n], r, k, v, w, u, s0, y, s1), flush=flush)
        out[label] = t
        log(f"rwkv6 ablation {label} (B={B} T={T} NH={NH} hd={hd}, chunked): "
            + ", ".join(f"{w} {ms:.4f} ms" for w, ms in t.items()))
    return out


def ssd_backward_ablation(torch) -> dict:
    """``--ssd-backward-ablation``: the chunked SSD backward as built and
    with its walk built with SSD_BWD_ABLATE = 1..5, each of which
    switches one part of the walk off (its output is then wrong), timed
    (all three launches) at zamba2-2.7b's training shape and at B = 1:
    what each part costs the kernel."""
    from repro_torch.kernels import mamba2_ssd
    import torch.nn.functional as F
    libs = ablated_builds("ssd_backward")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for label, B in (("train", 2), ("B1", 1)):
        T, NH, P, N = TRAIN_S, 80, 64, 64
        x, dy = (torch.randn(B, T, NH, P, generator=g, device="cuda")
                 .bfloat16() for _ in range(2))
        dt = F.softplus(torch.randn(B, T, NH, generator=g, device="cuda")
                        - 2.5)
        A = -torch.linspace(1.0, 16.0, NH, device="cuda")
        Bm, Cm = (torch.randn(B, T, N, generator=g, device="cuda")
                  .bfloat16() for _ in range(2))
        D = torch.randn(NH, generator=g, device="cuda")
        s0 = torch.zeros(B, NH, N, P, device="cuda")

        def kernel():
            return mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0,
                                                  dy, s0)
        t = {"as built": cuda_ms(torch, kernel, flush=flush),
             **ablated_times(torch, "ssd_backward", "mamba2_ssd_bwd_chunked",
                             libs, kernel, flush)}
        out[label] = t
        log(f"ssd backward ablation {label} (B={B} T={T} NH={NH} P={P} "
            f"N={N}, chunked): " + ", ".join(f"{w} {ms:.4f} ms"
                                             for w, ms in t.items()))
    return out


def rwkv6_backward_ablation(torch) -> dict:
    """``--rwkv6-backward-ablation``: the chunked rwkv6 backward as built
    (and the step kernel on the same inputs) and built with
    RWKV6_BWD_ABLATE = 1..5, each of which switches one part of it off
    (its output is then wrong), timed (all three launches) at rwkv6-3b's
    training shape and at B = 1: what each part costs the kernel."""
    from repro_torch.kernels import rwkv6_scan
    libs = ablated_builds("rwkv6_backward")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for label, B in (("train", 2), ("B1", 1)):
        T, NH, hd = TRAIN_S, 40, 64
        r, k, v, dy = (torch.randn(B, T, NH, hd, generator=g, device="cuda")
                       .bfloat16() for _ in range(4))
        w = torch.exp(-torch.exp(0.5 * torch.randn(
            B, T, NH, hd, generator=g, device="cuda") - 1.0))
        u = 0.1 * torch.randn(NH, hd, generator=g, device="cuda")
        s0 = torch.zeros(B, NH, hd, hd, device="cuda")

        def kernel(route=None):
            return rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, s0,
                                                  route=route)
        t = {"as built": cuda_ms(torch, kernel, flush=flush),
             "step kernel": cuda_ms(torch, lambda: kernel("step"),
                                    flush=flush),
             **ablated_times(torch, "rwkv6_backward", "rwkv6_scan_bwd", libs,
                             kernel, flush)}
        out[label] = t
        log(f"rwkv6 backward ablation {label} (B={B} T={T} NH={NH} hd={hd}, "
            f"chunked): " + ", ".join(f"{w} {ms:.4f} ms"
                                      for w, ms in t.items()))
    return out


# ----------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", metavar="DIR", type=Path,
                    help="only time phase 3's prefill and decode step, of "
                         "the checkout at DIR")
    ap.add_argument("--train", metavar="DIR", type=Path,
                    help="only run phase 7b's training (losses, step "
                         "walls, launches), of the checkout at DIR")
    ap.add_argument("--flash-ablation", action="store_true",
                    help="only time the flash kernel with parts switched off")
    ap.add_argument("--rwkv6-ablation", action="store_true",
                    help="only time the chunked rwkv6 kernel with parts "
                         "switched off")
    ap.add_argument("--ssd-backward-ablation", action="store_true",
                    help="only time the chunked SSD backward with parts of "
                         "its walk switched off")
    ap.add_argument("--rwkv6-backward-ablation", action="store_true",
                    help="only time the chunked rwkv6 backward with parts "
                         "switched off")
    ap.add_argument("--dist", action="store_true",
                    help="only run phase 9 (collectives on NCCL, the dry "
                         "run, the dry run against the card)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    tree = args.windows or args.train
    src = SRC if tree is None else tree.resolve() / "src"
    if not (src / "repro_torch").is_dir():
        log(f"FAIL: no src/repro_torch in {src.parent}")
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} (nvidia-smi); {kind} (torch); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    diagnostic = (windows_only if args.windows is not None else
                  train_only if args.train is not None else
                  flash_ablation if args.flash_ablation else
                  rwkv6_ablation if args.rwkv6_ablation else
                  ssd_backward_ablation if args.ssd_backward_ablation else
                  rwkv6_backward_ablation if args.rwkv6_backward_ablation
                  else dist_only if args.dist else None)
    if diagnostic is not None:
        fn = diagnostic
        print(json.dumps({"tree": str(src.parent), fn.__name__: fn(torch)}))
        print(smi)
        return 0
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    rows = phase_kernels(torch)
    log(f"phase 2 (kernels): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counted, walls, streams = phase_serving(torch)
    log(f"phase 3 (serving): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity(torch)
    log(f"phase 4 (parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, n in phase_families(torch).items():
        counted[k] += n
    log(f"phase 5 (vlm and encdec): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, n in phase_simulator(torch, streams[EXP_ARCH]).items():
        counted[k] += n
    log(f"phase 6 (simulator): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained_rows, trained = phase_training(torch)
    rows.update(trained_rows)
    counted.update({k: 0 for k in BACKWARD})
    for run in trained.values():
        for k, n in run["counted"].items():
            counted[k] = counted.get(k, 0) + n
    log(f"phase 7 (training): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, n in phase_flags(torch, trained[TRAIN_ARCH]).items():
        counted[k] = counted.get(k, 0) + n
    log(f"phase 8 (perf flags): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_dist(torch)
    log(f"phase 9 (collectives, dry run): {time.perf_counter() - t0:.1f} s")

    info = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_prefill.py:35"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                            "src/repro/kernels/paged_decode.py:34"),
        "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan.py:31"),
        "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd.py:32"),
        "flash_attention_backward": (
            "src/repro_torch/kernels/csrc/flash_backward.cu",
            "src/repro/kernels/ref.py:20 (jax.value_and_grad over "
            "flash_attention_ref; no Pallas backward)"),
        "rwkv6_scan_backward": (
            "src/repro_torch/kernels/csrc/rwkv6_backward.cu",
            "src/repro/kernels/ref.py:81 (jax.value_and_grad over "
            "rwkv6_scan_ref; no Pallas backward)"),
        "mamba2_ssd_backward": (
            "src/repro_torch/kernels/csrc/mamba2_ssd_backward.cu",
            "src/repro/kernels/ref.py:119 (jax.value_and_grad over "
            "mamba2_ssd_ref; no Pallas backward)"),
    }
    kernels = []
    for name, (source, replaces) in info.items():
        require(counted[name] > 0, f"{name} never launched on the main path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counted[name],
                            **rows[name]))
    log("setup wall times (s): " + json.dumps(walls))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
