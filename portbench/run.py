"""The port's benchmark: one run of one cell.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

Set-up builds the cell's model with weights drawn from ``--seed`` on the
card, the KV pool at the wave's worst case, and warms every shape the
traffic uses with one short wave. The window then serves waves of the
cell's traffic through the port's serving entry (``harness/serving.py``):
a wave is released while fewer than ``--seconds`` have passed, and each
runs to its end, so the measured period holds whole waves and lasts
from ``--seconds`` up to one wave more; with ``--trace 1`` a device
trace covers the second half of the first ``--seconds`` (host-clock
per-layer metrics read the first half). After the last wave, the
card's memory peak is read, the program's KV pool is freed, and a sample
of the served requests is held to the f32 reference
(``harness/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number compared beside
its limit, which also end standard error. Without a card, or with fewer
cards than the cell asks for, it exits 2 and prints no result; with the
JAX package or JAX loaded once the window has closed, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def end_to_end(bench, seconds: float, energy_j) -> tuple:
    """The end-to-end metrics of the measured period (``seconds`` long,
    whole waves), and the counts behind them. A wave's prefills come in
    a burst at its start, so a rate over a fixed cut would jump with
    whether a wave's start falls before the cut; over whole waves it
    takes all the work and all the time."""
    recs = list(bench.recs.values())
    prompt = sum(s.tokens for s in bench.spans if s.kind == "prefill")
    output = sum(len(r.stamps) for r in recs)
    tokens = prompt + output
    ttft = [r.first - r.release for r in recs if r.stamps]
    tpot = [(r.stamps[-1] - r.stamps[0]) / (r.output_len - 1)
            for r in recs if r.output_len > 1 and len(r.stamps) > 1]
    out = {"tokens_per_s": tokens / seconds,
           "ttft_p90_ms": 1e3 * percentile(ttft, 90),
           "tpot_p90_ms": 1e3 * percentile(tpot, 90)}
    if energy_j is not None:
        out["j_per_token"] = energy_j / tokens
    return out, {"tokens": tokens, "prompt_tokens": prompt,
                 "requests": len(recs), "ttft_n": len(ttft),
                 "tpot_n": len(tpot)}


def host_probe_ms() -> float:
    """Milliseconds of a fixed loop of pure Python: the host's speed for
    the serving loop's kind of work, logged beside the window so that a
    slow machine shows."""
    t = time.perf_counter()
    s = 0
    for i in range(1_000_000):
        s += i
    return 1e3 * (time.perf_counter() - t)


def wave_log(bench, wave_t) -> list:
    """Each wave's wall and what its calls took, for the log."""
    out = []
    for a, b in zip(wave_t, wave_t[1:]):
        row = {"wall_s": b - a}
        for kind in ("prefill", "store", "fetch", "decode_batch"):
            ss = [s for s in bench.spans if a <= s.t0 < b and s.kind == kind]
            row[kind] = [len(ss), sum(s.t1 - s.t0 for s in ss)]
        out.append(row)
    return out


def warm_draws(traffic: dict, vocab: int, seed: int):
    """One short wave at the traffic's own sizes: every prompt length of
    a wave, two tokens out each, so that every kernel is built and the
    allocators (the pinned host buffers of the handoff among them) hold
    the wave's prefills, payloads and decode batch before the window."""
    import numpy as np
    from portbench.harness import traffic as T
    rng = np.random.default_rng([seed, 1 << 20])
    return [T.Draw(p, 2, rng.integers(0, vocab, p, dtype=np.int64))
            for p, _ in T.wave_shapes(traffic)]


def main(argv=None, *, root: Path = ROOT, device: str = None) -> int:
    """One run; ``device="cpu"`` (tests only) skips the look for a card,
    the energy counter and the device trace."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    seed = args.seed % (1 << 63)

    import torch
    from portbench.harness import (check, guard, layers, nvml, serving, spec,
                                   weights)
    from portbench.harness import traffic as T

    cell = spec.load_cell(Path(root), args.workload)
    card = None
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"needs {cell.chips} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
        uid = str(torch.cuda.get_device_properties(0).uuid)
        card = nvml.Card(uid if uid.startswith("GPU-") else "GPU-" + uid)
        log(f"card {json.dumps(card.record())}")
    else:
        dev = torch.device(device)

    from repro_torch.models import get_model

    phases = {"imports": time.perf_counter() - T_START}
    cfg = spec.model_config(cell.config_name, cell.config)
    cj = cell.config
    model = get_model(cfg)
    params = weights.make(model, cj["init"], cfg.num_layers, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["weights"] = time.perf_counter() - T_START
    traffic = cell.traffic
    server = serving.make_server(cfg, model, params, traffic,
                                 cell.cell["setup"], dev)

    # warm every shape of the traffic, outside the window
    warm = serving.Bench(dev, probe_every=1, seed=seed)
    serving.run_wave(server, warm, warm_draws(traffic, cfg.vocab_size, seed),
                     0)
    del warm
    phases["warm"] = time.perf_counter() - T_START
    trace = None
    if args.trace and card is not None:
        from portbench.harness.devtrace import DeviceTrace
        trace = DeviceTrace()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    probe_ms = [host_probe_ms()]

    # ---------------- the window ----------------
    bench = serving.Bench(dev, probe_every=int(cell.cell["probe_every"]),
                          seed=seed)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    bench.deadline = t0 + args.seconds
    if args.trace:
        # the profiler slows every launch, so the host-clock metrics read
        # the window's first half, untraced, and the device's the second
        bench.trace_from = t0 + args.seconds / 2
        if trace is not None:
            bench.on_open, bench.on_close = trace.start, trace.stop
    e0 = card.energy_mj() if card is not None else None
    sampler = nvml.Sampler(card, args.seconds) if card is not None else None
    w, wave_t = 0, [t0]
    while time.perf_counter() < bench.deadline:
        serving.run_wave(server, bench, T.wave(traffic, cfg.vocab_size, seed,
                                               w), w)
        w += 1
        wave_t.append(time.perf_counter())
    period_s = wave_t[-1] - t0
    energy_j = (card.energy_mj() - e0) / 1e3 if card is not None else None
    bench.tick()                # closes the trace if no call has
    probe_ms.append(host_probe_ms())
    card_log = sampler.stop() if sampler is not None else {}
    log(f"window card {json.dumps(card_log)} host_probe_ms {probe_ms}")
    log(f"waves {json.dumps(wave_log(bench, wave_t))}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    phases["drained"] = time.perf_counter() - T_START
    e2e, counts = end_to_end(bench, period_s, energy_j)
    attempted = len(bench.recs)
    failed = sum(1 for r in bench.recs.values()
                 if len(r.served) != r.output_len
                 or len(r.stamps) != r.output_len)

    result_metrics = {}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        import importlib
        ref = importlib.import_module(f"portbench.reference.{cj['reference']}")
        ctx = layers.Context(
            spans=[s for s in bench.spans if t0 <= s.t0 < bench.t_open],
            traced_spans=[s for s in bench.spans
                          if bench.t_open <= s.t0 < bench.t_close],
            t0=t0, t1=bench.t_open, cfg=cj, ref=ref)
        if trace is not None and trace.t_start is not None:
            ctx.events = trace.events()
            ctx.trace = (trace.t_start, trace.t_stop)
            device_rec["busy_s"] = ctx.busy_s()
            device_rec["window_s"] = trace.t_stop - trace.t_start
            breakdown = layers.breakdown(ctx)
        for m in cell.per_layer:
            v = layers.load(m["name"]).read(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                result_metrics[m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}

    # ---------------- correctness, after the program's state is freed ----
    server.kv = None
    gc.collect()                # the clusters' cycles hold the pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check.judge(bench, params, cj, seed)
    phases["checked"] = time.perf_counter() - T_START
    log(f"window {json.dumps(dict(counts, waves=w, period_s=period_s, setup_s=setup_s))}")
    log(f"phases {json.dumps(phases)}")
    checks, within = check.verdict(readings, cell.cell["limits"])
    correct = failed == 0 and attempted > 0 and within

    bad = guard.loaded()
    if bad:
        log(f"loaded after the window: {bad}")
        return 3
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    if card is not None:
        card.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
