#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Phases, each fatal on failure (the script exits non-zero):

  1. card: name, power limit, and the build of all four CUDA kernels
     from the sources in this checkout (one nvcc per source, all in
     parallel);
  2. kernels: each kernel against its plain torch version, in bf16 and
     f32, at the shapes of the main paths and around them (flash at hd
     128 and hd 80, MHA at hd 128 (deepseek-moe-16b), non-causal at hd 64
     with S != T and with one query row (seamless-m4t-medium's encoder
     and cross-attention), ragged lengths, partial tiles, carried
     states, B=2, single steps), with times (median of CUDA events), the plain
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
     engine with an executor steps).

It prints the kernels' JSON line and the card's name and power limit
before its last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

  python3 chip_smoke.py            # from the repository root

Three diagnostics, which print their JSON line and the card instead:
``--windows DIR`` times phase 3's prefill and decode step, store and
fetch per medium (and the flash wrapper's host time, and the paged
kernel at five shapes) of the
checkout at DIR, so that two checkouts are compared in one call with one
yardstick; ``--flash-ablation`` and ``--rwkv6-ablation`` time the bf16
flash kernel or the chunked rwkv6 kernel built with one part switched
off at a time.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
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


def rwkv6_plain_logits(torch, params, cfg, tokens):
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6 as RW
    x = L.embed(params["embed"], tokens, cfg)
    for lp in params["layers"]:
        lp = _as(cfg, lp)
        h = L.rms_norm(x, lp["norm_tm"], cfg.norm_eps)
        r, k, v, w, gate = RW._time_mix_in(lp, h, cfg, None)
        y, _ = ref.rwkv6_scan_ref(r, k, v, w, lp["u"])
        x = x + RW._time_mix_out(lp, y, gate, h, cfg)
        h = L.rms_norm(x, lp["norm_cm"], cfg.norm_eps)
        x = x + RW.channel_mix_seq(lp, h, None)[0]
    return L.lm_logits(params["embed"], x, cfg)[0]


def zamba2_plain_logits(torch, params, cfg, tokens):
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as MB
    N = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(N, device=tokens.device)[None]
    shared = _as(cfg, params["shared_attn"])
    for group in MB._groups(params, cfg):
        q, k, v = MB._shared_attn_in(shared, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        x = x + L.out_project(shared["attn"], attn, cfg)
        for lp in group:
            lp = _as(cfg, lp)
            xh, dt, A, Bm, Cm, z, _ = MB._mamba_in(lp, x, cfg, None)
            y, _ = ref.mamba2_ssd_ref(xh, dt, A, Bm, Cm, lp["D"])
            x = x + MB._mamba_out(lp, y, z, cfg)
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

    def step(params, tokens, k_pages, v_pages, block_table, pos):
        page, n = k_pages.shape[2], pos.tolist()
        shape = (k_pages.shape[0], len(n), max(n) + 1, *k_pages.shape[3:])
        k, v = k_pages.new_zeros(shape), v_pages.new_zeros(shape)
        for b, m in enumerate(n):          # positions < m, page by page
            rows = block_table[b, :-(-m // page)].long()
            k[:, b, :m] = k_pages[:, rows].flatten(1, 2)[:, :m]
            v[:, b, :m] = v_pages[:, rows].flatten(1, 2)[:, :m]
        want, _ = model.decode_step(params, tokens, AttnCache(k, v), pos)
        got = kernel_step(params, tokens, k_pages, v_pages, block_table,
                          pos)
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
# diagnostics (not run by default)
# ----------------------------------------------------------------------
def windows_only(torch) -> dict:
    """``--windows DIR``: phase 3's prefill and decode-step times of each
    arch, its handoff's store and fetch per medium, the flash wrapper's
    host time at the main shape and the paged kernel's times
    (``paged_windows``), for the
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
        out[arch]["transfer"] = transfer_times(torch, payload)
        log(f"{arch} store / fetch ms per medium: " + ", ".join(
            f"{m} {t[0]:.3f} / {t[1]:.3f}"
            for m, t in out[arch]["transfer"].items()))
        del model, params, prefill, step
        gc.collect()
        torch.cuda.empty_cache()
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
    return libs


def flash_ablation(torch) -> dict:
    """``--flash-ablation``: the bf16 flash kernel as built and built with
    FLASH_ABLATE = 1, 2, 3, each of which switches one part of it off
    (its output is then wrong), timed at the main shape, at S = 8192 and
    at hd 64 and 80: what each part costs the kernel."""
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


# ----------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", metavar="DIR", type=Path,
                    help="only time phase 3's prefill and decode step, of "
                         "the checkout at DIR")
    ap.add_argument("--flash-ablation", action="store_true",
                    help="only time the flash kernel with parts switched off")
    ap.add_argument("--rwkv6-ablation", action="store_true",
                    help="only time the chunked rwkv6 kernel with parts "
                         "switched off")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    src = SRC if args.windows is None else args.windows.resolve() / "src"
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
                  flash_ablation if args.flash_ablation else
                  rwkv6_ablation if args.rwkv6_ablation else None)
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

    info = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_prefill.py:35"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                            "src/repro/kernels/paged_decode.py:34"),
        "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan.py:31"),
        "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd.py:32"),
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
