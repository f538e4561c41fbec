#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Phases, each fatal on failure (the script exits non-zero):

  1. card: name, power limit, and the build of every CUDA kernel from the
     sources in this checkout (one nvcc per source, all in parallel);
  2. kernels: each kernel against its plain torch version, in bf16 and
     f32, at the shapes of the main path and around them, with times
     (median of CUDA events), the plain version's time, the card's bound
     and, for flash attention, ``scaled_dot_product_attention``'s time as
     a yardstick the port never calls;
  3. serving: llama32-3b at full width in bf16 (28 layers, seeded random
     weights), 4 requests of 1024 prompt + 32 output tokens, in each of
     the five setups, through ``repro_torch.launch.serve.serve``; checks
     the streams, the first tokens across setups, teacher-forced decode
     logits against a dense plain-attention recompute, and that every
     prefill and decode step went through the kernels;
  4. parity: the same workload in f32 at full width and 4 layers, TF32
     off, must give identical token streams in all five setups, and its
     teacher-forced decode logits must match a dense recompute.

It prints the kernels' JSON line and the card's name and power limit
before its last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

  python3 chip_smoke.py            # from the repository root
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ARCH = "llama32-3b"
N_REQ, PROMPT, OUTPUT = 4, 1024, 32
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-4}
SPIN_CYCLES = 40_000_000        # ~20 ms at 1.98 GHz: outlasts the host's enqueue


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
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
        torch.cuda._sleep(SPIN_CYCLES)
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


def paged_cases():
    # (label, B, H, KV, hd, page, seq_lens)
    yield "main", 4, 24, 8, 128, 16, [1025, 1040, 1049, 1056]
    yield "mha", 4, 8, 8, 128, 16, [1, 17, 530, 1056]
    yield "g7-hd64", 3, 14, 2, 64, 16, [16, 300, 777]
    yield "hd32", 2, 4, 2, 32, 8, [5, 64]


def flash_pairs(q_offset, S, T, causal, window) -> int:
    """(query, key) pairs the masks let through."""
    total = 0
    for i in range(S):
        qpos = q_offset + i
        hi = min(T, qpos + 1) if causal else T
        lo = max(0, qpos - window + 1) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def phase_kernels(torch):
    from repro_torch.kernels import flash_prefill, paged_decode, ref
    import torch.nn.functional as F

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for (label, B, S, T, H, KV, hd, causal, window,
             q_offset) in flash_cases():
            q = torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt)
            k = torch.randn(B, T, KV, hd, generator=g, device="cuda").to(dt)
            v = torch.randn(B, T, KV, hd, generator=g, device="cuda").to(dt)
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
            if causal and window == 0 and q_offset == 0 and S == T:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                    reps=reps, flush=flush)
            flops = 4.0 * B * H * hd * flash_pairs(q_offset, S, T, causal,
                                                   window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"flash {label:9s} {dtype_name:8s} B={B} S={S} T={T} H={H} "
                f"KV={KV} hd={hd} causal={causal} window={window} "
                f"q_offset={q_offset}: max_abs_err={err:.3e} "
                f"(tol {tol}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
            require(ok, f"flash {label} {dtype_name}: max_abs_err {err:.3e} "
                        f"over tolerance {tol}")
            if label == "main" and dtype_name == "bfloat16":
                rows["flash_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)
            del q, k, v, out, want

        for label, B, H, KV, hd, page, lens in paged_cases():
            max_pages = -(-max(lens) // page)
            P = B * max_pages + 7
            q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
            kp = torch.randn(P, page, KV, hd, generator=g,
                             device="cuda").to(dt)
            vp = torch.randn(P, page, KV, hd, generator=g,
                             device="cuda").to(dt)
            perm = torch.randperm(P, generator=g, device="cuda")
            bt = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = paged_decode.paged_attention(q, kp, vp, bt, sl)
            want = ref.paged_attention_ref(q, kp, vp, bt, sl)
            torch.cuda.synchronize()
            err = max_err(torch, out, want)
            ok = within(torch, out, want, tol)
            ms = cuda_ms(torch, lambda: paged_decode.paged_attention(
                q, kp, vp, bt, sl), flush=flush)
            plain_ms = cuda_ms(torch, lambda: ref.paged_attention_ref(
                q, kp, vp, bt, sl), reps=5, warmup=1)
            live = sum(lens)
            flops = 4.0 * H * hd * live
            nbytes = (2 * live * KV * hd + 2 * q.numel()) * q.element_size() \
                + bt.numel() * 4 + sl.numel() * 4
            b_ms, b_by = bound(flops, nbytes, dtype_name)
            log(f"paged {label:9s} {dtype_name:8s} B={B} H={H} KV={KV} "
                f"hd={hd} page={page} seq_lens={lens}: "
                f"max_abs_err={err:.3e} (tol {tol}) kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            require(ok, f"paged {label} {dtype_name}: max_abs_err {err:.3e} "
                        f"over tolerance {tol}")
            if label == "main" and dtype_name == "bfloat16":
                rows["paged_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
    del flush_buf
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------------
# phase 3: serving at full width, bf16
# ----------------------------------------------------------------------
def dense_plain_logits(torch, params, cfg, tokens):
    """Logits of every position of ``tokens`` [1, N] through the port's
    layers with plain attention (no kernel): the recompute yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    N = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(N, device=tokens.device)[None]
    for lp in params["layers"]:
        q, k, v = TF._attn_in(lp, x, positions, cfg)
        attn = ref.flash_attention_ref(q, k, v, causal=True)
        x = TF._attn_out_mlp(lp, x, attn, cfg)
    return L.lm_logits(params["embed"], x, cfg)[0]


def teacher_forced_logits(torch, model, params, cfg, prompt, outputs):
    """The port's own path over request 0: flash prefill of the prompt,
    then paged decode of each emitted token (teacher forcing)."""
    from repro_torch.core import DevicePagedKV, PagedKVPool
    from repro_torch.models.layers import dtype_of
    S = len(prompt)
    n = len(outputs) - 1
    pool = PagedKVPool(num_pages=-(-(S + n + 1) // 16), page_size=16)
    kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                       dtype=dtype_of(cfg.compute_dtype), device="cuda")
    toks = torch.tensor(prompt, device="cuda")[None]
    _, cache = model.prefill(params, {"tokens": toks})
    pool.allocate(0, S)
    kv.write_prefill(0, cache.k[:, 0], cache.v[:, 0])
    logits = []
    for i in range(n):
        pool.allocate(0, 1)
        bt = torch.tensor([pool.block_table(0)], dtype=torch.int32,
                          device="cuda")
        logits.append(model.decode_step_paged(
            params, torch.tensor([outputs[i]], device="cuda"), kv.k, kv.v,
            bt, torch.tensor([S + i], dtype=torch.int32, device="cuda"))[0])
    return torch.stack(logits)


def _to_f32(params):
    return {"embed": {k: v.float() for k, v in params["embed"].items()},
            "layers": [{k: ({kk: vv.float() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.float())
                        for k, v in lp.items()} for lp in params["layers"]]}


def phase_serving(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import SETUPS
    from repro_torch.kernels import flash_prefill, paged_decode
    from repro_torch.launch.serve import serve
    from repro_torch.obs.trace import Tracer

    cfg = get_config(ARCH)
    streams, walls = {}, {}
    flash_prefill.flash_attention.launches = 0
    paged_decode.paged_attention.launches = 0
    for setup in SETUPS:
        f0 = flash_prefill.flash_attention.launches
        p0 = paged_decode.paged_attention.launches
        tracer = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve(ARCH, setup, batch_size=N_REQ, input_len=PROMPT,
                    output_len=OUTPUT, real=True, device="cuda", seed=0,
                    tracer=tracer, verbose=False)
        torch.cuda.synchronize()
        walls[setup] = time.perf_counter() - t0
        prefills = len([e for e in tracer.instants("lifecycle")
                        if e.name == "prefill_done"])
        steps = len([e for e in tracer.spans()
                     if e.name in ("decode", "mixed")])
        df = flash_prefill.flash_attention.launches - f0
        dp = paged_decode.paged_attention.launches - p0
        L = cfg.num_layers
        log(f"serve {setup:8s}: wall {walls[setup]:.3f} s, {prefills} "
            f"prefills, {steps} decode steps, flash launches {df}, paged "
            f"launches {dp}, simulated median TTFT "
            f"{res.metrics.median_ttft_s:.4f} s (TPU cost model)")
        require(df == L * prefills and prefills >= N_REQ,
                f"{setup}: {df} flash launches for {prefills} prefills")
        require(dp == L * steps and steps >= OUTPUT - 1,
                f"{setup}: {dp} paged launches for {steps} decode steps")
        streams[setup] = [r.output_tokens for r in
                          sorted(res.requests, key=lambda r: r.req_id)]
        require(all(len(t) == OUTPUT for t in streams[setup]),
                f"{setup}: streams of lengths "
                f"{[len(t) for t in streams[setup]]}, want {OUTPUT}")
        prompts = [list(r.prompt_tokens) for r in
                   sorted(res.requests, key=lambda r: r.req_id)]
    counted = {"flash_attention": flash_prefill.flash_attention.launches,
               "paged_attention": paged_decode.paged_attention.launches}

    firsts = {s: [t[0] for t in streams[s]] for s in SETUPS}
    require(all(firsts[s] == firsts["co-1gpu"] for s in SETUPS),
            f"first tokens differ across setups: {firsts}")
    same = sum(streams[s] == streams["co-1gpu"] for s in SETUPS)
    log(f"bf16 first tokens agree in all setups; {same}/{len(SETUPS)} "
        f"setups give co-1gpu's full streams")

    # teacher-forced decode logits of request 0 (flash prefill + paged
    # decode, bf16) against a dense plain-attention recompute. Both are
    # held to the same recompute in f32 (same weights, TF32 off): the
    # kernel path may stray from exact arithmetic by at most 3x what the
    # plain bf16 recompute itself strays (bf16's own noise floor).
    from repro_torch.models import get_model
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    outs = streams["co-1gpu"][0]
    got = teacher_forced_logits(torch, model, params, cfg, prompts[0], outs)
    seq = torch.tensor(prompts[0] + outs[:-1], device="cuda")[None]
    plain = dense_plain_logits(torch, params, cfg, seq)[PROMPT:]
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    exact = dense_plain_logits(torch, _to_f32(params), cfg32, seq)[PROMPT:]
    err, noise = max_err(torch, got, exact), max_err(torch, plain, exact)
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"teacher-forced bf16 decode logits: kernel path vs f32 recompute "
        f"max_abs_err={err:.4e}, plain bf16 recompute vs f32 "
        f"{noise:.4e} (ratio {err / noise:.2f}; max |logit| "
        f"{float(exact.abs().max()):.3f}); argmax agreement with the plain "
        f"bf16 recompute {agree:.3f}")
    require(err <= 3 * noise,
            f"decode logits stray {err:.4e} from the f32 recompute, over "
            f"3x the bf16 noise floor {noise:.4e}")
    del got, plain, exact

    # component times (CUDA events) at the main path's shapes
    from repro_torch.core import make_path
    from repro_torch.launch.serve import device_kv
    from repro_torch.core import random_workload
    toks = torch.tensor(prompts[0], device="cuda")[None]
    prefill_ms = cuda_ms(torch, lambda: model.prefill(params,
                                                      {"tokens": toks}),
                         reps=5)
    reqs = random_workload(N_REQ, input_len=PROMPT, output_len=OUTPUT,
                           vocab_size=cfg.vocab_size, seed=0)
    kv = device_kv(cfg, reqs, "cuda")
    for r in reqs:
        kv.pool.allocate(r.req_id, PROMPT + 16)
    bt = torch.tensor([kv.pool.block_table(r.req_id) for r in reqs],
                      dtype=torch.int32, device="cuda")
    pos = torch.tensor([PROMPT + 3 * i for i in range(N_REQ)],
                       dtype=torch.int32, device="cuda")
    tok4 = torch.tensor(outs[:N_REQ], device="cuda")
    decode_ms = cuda_ms(torch, lambda: model.decode_step_paged(
        params, tok4, kv.k, kv.v, bt, pos), reps=10)
    decode_host_ms = host_ms(torch, lambda: model.decode_step_paged(
        params, tok4, kv.k, kv.v, bt, pos), reps=10)
    log(f"one prefill (1 x {PROMPT} tokens, {cfg.num_layers} layers): "
        f"{prefill_ms:.3f} ms device; one decode step (B={N_REQ}, ctx "
        f"~{PROMPT}): {decode_ms:.3f} ms device, {decode_host_ms:.3f} ms "
        f"wall")
    k_seq, v_seq = kv.gather_dense(reqs[0].req_id)
    payload = (0, k_seq[:, :PROMPT].contiguous(),
               v_seq[:, :PROMPT].contiguous(),
               torch.zeros(1, cfg.vocab_size, device="cuda"))
    nbytes = 2 * payload[1].numel() * payload[1].element_size()
    for medium in ("ici", "host", "disk"):
        path = make_path(medium)
        back = path.fetch(path.store(payload))
        require(torch.equal(back[1], payload[1]) and
                torch.equal(back[2], payload[2]),
                f"{medium}: KV round trip is not bit-exact")
        ms = host_ms(torch, lambda: path.fetch(path.store(payload)))
        log(f"store+fetch {medium:4s}: {ms:.3f} ms for {nbytes / 1e6:.1f} MB "
            f"(one sequence's KV, bit-exact)")
    return counted, walls


# ----------------------------------------------------------------------
# phase 4: f32 parity across setups
# ----------------------------------------------------------------------
def phase_parity(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import (RealExecutor, SETUPS, make_cluster,
                                  random_workload)
    from repro_torch.launch.serve import device_kv
    from repro_torch.models import get_model

    cfg = get_config(ARCH).replace(num_layers=4, param_dtype="float32",
                                   compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1),
                        "cuda")
    streams = {}
    for setup in SETUPS:
        reqs = random_workload(N_REQ, input_len=PROMPT, output_len=OUTPUT,
                               vocab_size=cfg.vocab_size, seed=1)
        prompt0 = list(reqs[0].prompt_tokens)
        kv = device_kv(cfg, reqs, "cuda")
        res = make_cluster(setup, cfg, executor_factory=lambda path: (
            RealExecutor(model, params, kv, transfer_path=path))).run(reqs)
        streams[setup] = [r.output_tokens for r in
                          sorted(res.requests, key=lambda r: r.req_id)]
        require(all(len(t) == OUTPUT for t in streams[setup]),
                f"f32 {setup}: short streams")
    for setup in SETUPS:
        require(streams[setup] == streams["co-1gpu"],
                f"f32 parity: {setup} diverged from co-1gpu")
    log(f"f32 parity: identical streams in all {len(SETUPS)} setups "
        f"({N_REQ} x {OUTPUT} tokens, {cfg.num_layers} layers)")
    outs = streams["co-1gpu"][0]
    got = teacher_forced_logits(torch, model, params, cfg, prompt0, outs)
    seq = torch.tensor(prompt0 + outs[:-1], device="cuda")[None]
    want = dense_plain_logits(torch, params, cfg, seq)[PROMPT:]
    err = max_err(torch, got, want)
    log(f"teacher-forced f32 decode logits vs dense plain recompute: "
        f"max_abs_err={err:.4e} (max |logit| "
        f"{float(want.abs().max()):.3f})")
    require(within(torch, got, want, 1e-3),
            f"f32 decode logits differ from the recompute by {err:.4e}")


# ----------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    if not (SRC / "repro_torch").is_dir():
        log(f"FAIL: no src/repro_torch beside {Path(__file__).name}")
        return 1
    sys.path.insert(0, str(SRC))
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
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    rows = phase_kernels(torch)
    counted, walls = phase_serving(torch)
    phase_parity(torch)

    info = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                            "src/repro/kernels/flash_prefill.py:35"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                            "src/repro/kernels/paged_decode.py:34"),
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
