"""Serving launcher: run the paper's setups on any zoo architecture.

Two modes:
  * simulation (default): one declarative ``repro_torch.exp``
    Experiment, timed and priced by the simulator's cost model, whose
    constants describe a TPU v5e: the figures are simulated, not
    measured on the card, and equal the reference's ``repro.launch.serve``
    for the same arguments. Records are memoized in the port's own
    result cache (``$REPRO_TORCH_EXP_CACHE_DIR``, else
    ``~/.cache/repro-torch-exp``).
  * ``--real``: the named architecture at full width, with seeded random
    weights in the config's ``param_dtype``, on ``--device`` (default
    ``cuda``; it raises when no card is present). Prefill goes through
    the family's kernels (flash attention; the rwkv6 scan for rwkv6-3b;
    the Mamba2 SSD scan and flash attention for zamba2-2.7b), the
    prefill state crosses the setup's transfer medium for real, and
    decode goes through the paged-attention kernel over one device-wide
    page pool (dense and moe families, e.g. deepseek-moe-16b) or steps
    the recurrent state (ssm, hybrid). The vlm and encdec families have
    no serving path, as in the reference, whose real mode passes tokens
    only. ``--smoke`` runs the reduced config instead, with prompts
    clamped to 64 tokens and outputs to 8, as the reference's real mode
    does. Its printed TTFT/TPOT/energy come from the same TPU cost
    model.

``--setup`` takes a legacy setup name, the intra-GPU P/D split
("intra-gpu" / "intra-<k>"), or any fleet shape ("2P2D-ici", "co-3").

  PYTHONPATH=src python -m repro_torch.launch.serve --setup dis-ici
  PYTHONPATH=src python -m repro_torch.launch.serve --setup 2P2D-ici \\
      --governor slo-slack
  PYTHONPATH=src python -m repro_torch.launch.serve --real --setup dis-ici
  PYTHONPATH=src python -m repro_torch.launch.serve --real --smoke \\
      --device cpu --setup dis-host
  PYTHONPATH=src python -m repro_torch.launch.serve --real --smoke \\
      --device cpu --arch rwkv6-3b --setup dis-disk
  PYTHONPATH=src python -m repro_torch.launch.serve --real --smoke \\
      --device cpu --arch deepseek-moe-16b --setup dis-host
"""
from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch.configs import ModelConfig, get_config, reduce_for_smoke
from repro_torch.core import (DevicePagedKV, PagedKVPool, RealExecutor,
                              Request, SETUPS, make_cluster, random_workload)
from repro_torch.exp import Experiment
from repro_torch.exp import run as run_exp
from repro_torch.fleet import FleetSpec
from repro_torch.models import get_model
from repro_torch.models.layers import dtype_of


def device_kv(cfg: ModelConfig, requests: List[Request], device,
              page_size: int = 16) -> DevicePagedKV:
    """The physical KV pool of one device, shared by every executor on it:
    room for every request of the run at prompt + output + 2 tokens."""
    pages = sum(-(-(r.prompt_len + r.output_len + 2) // page_size)
                for r in requests)
    return DevicePagedKV(PagedKVPool(pages, page_size), cfg.num_layers,
                         cfg.num_kv_heads, cfg.head_dim,
                         dtype=dtype_of(cfg.compute_dtype), device=device)


def serve(arch: str, setup: str, *, batch_size: int = 16,
          input_len: int = 16_384, output_len: int = 256,
          phi: float = 1.0, governor: str = None, real: bool = False,
          seed: int = 0, verbose: bool = True, device="cuda",
          smoke: bool = False, tracer=None):
    if real:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("serve(real=True) runs on the card and no "
                               "CUDA device is available (device='cpu' "
                               "runs the plain versions on the CPU)")
        cfg = get_config(arch)
        if smoke:
            cfg = reduce_for_smoke(cfg)
            input_len = min(input_len, 64)
            output_len = min(output_len, 8)
        model = get_model(cfg)
        params = model.init(
            torch.Generator(device=device).manual_seed(seed), device)
        reqs = random_workload(batch_size, input_len=input_len,
                               output_len=output_len,
                               vocab_size=cfg.vocab_size, seed=seed)
        # paged KV for the dense and moe families; the recurrent
        # families carry their own per-sequence state
        kv = device_kv(cfg, reqs, device) if model.paged else None

        def executor_factory(path):
            return RealExecutor(model, params, kv, transfer_path=path)

        kw = {"governor": governor} if governor else {}
        res = make_cluster(setup, cfg, phi=phi,
                           executor_factory=executor_factory,
                           tracer=tracer, **kw).run(reqs)
    else:
        exp = Experiment.closed(setup, batch_size, arch=arch,
                                input_len=input_len,
                                output_len=output_len,
                                seed=seed).with_phi(phi=phi)
        if governor:
            exp = exp.with_governor(governor)
        res = run_exp(exp, tracer=tracer)     # a traced run is uncached
    if verbose:
        m = res.metrics
        gov = f" governor={governor}" if governor else ""
        where = f" device={device}" if real else ""
        print(f"[serve] {setup} arch={arch} bs={batch_size} "
              f"phi={phi}{gov}{where}")
        print("  simulated (TPU v5e cost model, not measured on the "
              "card):")
        print(f"  median TTFT {m.median_ttft_s:.3f}s  "
              f"median TPOT {m.median_tpot_s * 1e3:.2f}ms")
        print(f"  prefill tput {m.prefill_throughput_tok_s:.0f} tok/s  "
              f"decode tput {m.decode_throughput_tok_s:.0f} tok/s")
        print(f"  energy {res.energy.total_j / 1e3:.2f} kJ  "
              f"({res.joules_per_token:.4f} J/token)  "
              f"evictions={m.total_evictions}")
        print(f"  breakdown: " + "  ".join(
            f"{k}={v / 1e3:.2f}kJ" for k, v in
            sorted(res.energy.breakdown().items())))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--setup", default="dis-ici",
                    help=f"one of {SETUPS}, the intra-GPU P/D split "
                         "'intra-gpu', or a fleet shape like '2P2D-ici'")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--input-len", type=int, default=16_384)
    ap.add_argument("--output-len", type=int, default=256)
    ap.add_argument("--phi", type=float, default=1.0)
    ap.add_argument("--governor", default=None,
                    help="online DVFS governor: static / queue-depth / "
                         "slo-slack")
    ap.add_argument("--real", action="store_true",
                    help="execute the model on --device (default: "
                         "simulate with the TPU v5e cost model)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --real: reduced config, prompts <= 64, "
                         "outputs <= 8")
    ap.add_argument("--device", default="cuda",
                    help="with --real: the device the model runs on")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.setup not in SETUPS:
        try:
            FleetSpec.parse(args.setup)
        except ValueError as e:
            ap.error(str(e))          # usage error, not a traceback
    serve(args.arch, args.setup, batch_size=args.batch_size,
          input_len=args.input_len, output_len=args.output_len,
          phi=args.phi, governor=args.governor, real=args.real,
          seed=args.seed, device=args.device, smoke=args.smoke)


if __name__ == "__main__":
    main()
