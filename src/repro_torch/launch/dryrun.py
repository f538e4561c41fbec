"""Multi-pod dry run, the port of ``repro.launch.dryrun``: prove the
distribution config is coherent.

For every (architecture x input shape) cell, run the appropriate step
(train / prefill / decode, ``serve.steps``) on the production meshes --
single-pod (16 data x 16 model = 256 devices) and multi-pod (2 pod x 16
x 16 = 512 devices) -- and report what one device holds (fits?) and the
roofline's terms.

The reference lowers and compiles the step on 512 forced host devices
and reads XLA's memory and cost analysis. The port runs its real step,
on DTensors whose shards are fake tensors (``FakeTensorMode``), under a
fake process group of 256 or 512 ranks and the production
``DeviceMesh`` (``launch.mesh.make_production_mesh(device_type="cpu")``),
as rank 0. So the dry run runs on fake tensors by its nature: nothing is
computed and no device is touched, whatever the machine has.

  argument_bytes / output_bytes  rank 0's shard bytes of the step's
      arguments and outputs, from their placements (``torch.chunk``'s
      split: rank 0 holds the larger piece, as XLA pads)
  temp_bytes   the peak that ``MemTracker`` sees over the run
      (``hlo_analysis.LocalMemTracker``) less the arguments
  collectives_rolled   the collectives DTensor issues in the full-size
      run (the port has no rolled loop: every layer is counted)

Cost-number methodology, the reference's: the roofline terms come from
runs at 1 and 2 layer periods and exact linear extrapolation (layer
stacks are homogeneous, so cost(L) = a + b*L). Each cell makes its fake
group and destroys it afterwards, and ``run_cell`` refuses a process
that already has a process group (run it in a subprocess there).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out dryrun_results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs import (ALL_SHAPES, ASSIGNED_ARCHS, SHAPES,
                                 applicable, get_config, skip_reason)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.costs import ChipSpec
from repro_torch.dist.hlo_analysis import (Counts, DeviceCounter,
                                           LocalMemTracker, RooflineTerms,
                                           dtensor_on_fake_shards,
                                           linear_extrapolate, model_flops,
                                           structural_memory_floor,
                                           vmem_resident_traffic)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serve.steps import StepBundle, build_step
from repro_torch.train.optimizer import tree_leaves


# ----------------------------------------------------------------------
def with_periods(cfg: ModelConfig, n: int) -> ModelConfig:
    """Same arch at n layer-periods (for the roofline's small runs)."""
    if cfg.family == "hybrid":
        return cfg.replace(num_layers=n * cfg.hybrid.shared_attn_every)
    if cfg.family == "encdec":
        return cfg.replace(
            num_layers=n,
            encdec=dataclasses.replace(cfg.encdec, num_encoder_layers=n,
                                       num_decoder_layers=n))
    if cfg.family == "moe":
        return cfg.replace(num_layers=cfg.moe.first_k_dense + n)
    return cfg.replace(num_layers=n)


def full_periods(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.shared_attn_every
    if cfg.family == "encdec":
        return cfg.encdec.num_decoder_layers
    if cfg.family == "moe":
        return cfg.num_layers - cfg.moe.first_k_dense
    return cfg.num_layers


# ----------------------------------------------------------------------
# the step on fake DTensors
# ----------------------------------------------------------------------
def _zip_map(fn, tree, shardings):
    """``fn(leaf, placements)`` over a tree and its placements tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          torch.Tensor):
        out = [_zip_map(fn, t, s) for t, s in zip(tree, shardings)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, shardings)


def local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """Rank 0's shard shape of a tensor of global ``shape`` (the whole
    shape on a mesh of one device)."""
    if mesh.size() == 1:
        return tuple(shape)
    return tuple(compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)[0])


def local_bytes(tree, shardings, mesh) -> int:
    """Rank 0's shard bytes of the meta tensors of ``tree``, placed by
    ``shardings``."""
    sizes = []
    _zip_map(lambda t, pl: sizes.append(
        math.prod(local_shape(t.shape, mesh, pl)) * t.element_size()),
        tree, shardings)
    return sum(sizes)


def fake_args(bundle: StepBundle, mesh, mode: FakeTensorMode) -> Tuple:
    """The bundle's abstract arguments as DTensors of fake shards, rank
    0's, placed by the bundle's shardings; on a mesh of one device, as
    fake tensors on its device."""
    def make(meta, pl):
        shape = local_shape(meta.shape, mesh, pl)   # outside the fake mode
        with mode:
            local = torch.empty(shape, dtype=meta.dtype,
                                device=mesh.device_type)
            if mesh.size() == 1:
                return local
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=meta.shape, stride=meta.stride())
    return tuple(_zip_map(make, a, s)
                 for a, s in zip(bundle.abstract_args, bundle.shardings))


def _output_bytes(out) -> int:
    return sum(t._local_tensor.numel() * t._local_tensor.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in tree_leaves(out) if isinstance(t, torch.Tensor))


def trace_step(cfg: ModelConfig, shape, mesh, *, track_memory: bool = False
               ) -> Dict[str, Any]:
    """Build ``shape.kind``'s step for ``cfg`` on ``mesh`` and run it
    once on fake DTensors: {'bundle', 'outputs', 'counts' (one device's
    ``Counts``), 'argument_bytes', 'peak_bytes' (with
    ``track_memory``)}."""
    bundle = build_step(shape.kind, cfg, mesh, shape)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args = fake_args(bundle, mesh, mode)
    counter = DeviceCounter()
    tracker = LocalMemTracker() if track_memory else None
    with mode, dtensor_on_fake_shards():
        if tracker is not None:
            tracker.track_external(*[t for t in tree_leaves(args)
                                     if isinstance(t, torch.Tensor)])
            with tracker, counter:
                out = bundle.fn(*args)
        else:
            with counter:
                out = bundle.fn(*args)
    return {"bundle": bundle, "outputs": out, "counts": counter.counts,
            "argument_bytes": sum(
                local_bytes(a, s, mesh) for a, s in
                zip(bundle.abstract_args, bundle.shardings)),
            "peak_bytes": tracker.peak_bytes() if tracker else None}


# ----------------------------------------------------------------------
def _fake_world(n: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, analyze: bool = True,
             chip: Optional[ChipSpec] = None) -> Dict:
    """Run one (arch, shape, mesh) cell on fake tensors; returns the
    record. ``chip``: the roofline's peak rates (default the TPU
    ``ChipSpec()``, as the reference's)."""
    if dist.is_initialized():
        raise RuntimeError("run_cell makes a fake process group of its "
                           "own: call it in a process with no process "
                           "group (a subprocess)")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    rec: Dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "kind": shape.kind}
    if not applicable(cfg, shape):
        rec["status"] = "skip"
        rec["reason"] = skip_reason(cfg, shape)
        return rec
    _fake_world(n_chips)
    try:
        # --- 1) the full-size run: THE dry-run proof -------------------
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        run = trace_step(cfg, shape, mesh, track_memory=True)
        coll = run["counts"].collectives
        rec.update({
            "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "argument_bytes": int(run["argument_bytes"]),
            "output_bytes": int(_output_bytes(run["outputs"])),
            "temp_bytes": int(run["peak_bytes"] - run["argument_bytes"]),
            "collectives_rolled": {
                "bytes_by_kind": coll.bytes_by_kind,
                "count_by_kind": coll.count_by_kind,
            },
        })

        # --- 2) roofline terms via runs at 1 and 2 layer periods -------
        if analyze:
            t1 = time.time()
            n_full = full_periods(cfg)
            n1, n2 = 1, 2
            vals: Dict[int, Counts] = {}
            for n in (n1, n2):
                vals[n] = trace_step(with_periods(cfg, n), shape,
                                     mesh)["counts"]

            def extrapolate(get):
                return linear_extrapolate(get(vals[n1]), get(vals[n2]),
                                          n1, n2, n_full)
            terms = RooflineTerms(
                flops=extrapolate(lambda c: c.flops),
                hbm_bytes=extrapolate(lambda c: c.bytes),
                collective_bytes=extrapolate(
                    lambda c: c.collectives.total_bytes),
                n_chips=n_chips,
                model_flops=model_flops(cfg, shape, n_chips),
                # the kernels are opaque operators: their on-chip traffic
                # was never counted, so nothing is taken off (reported)
                vmem_resident_bytes=0.0,
                memory_floor_bytes=structural_memory_floor(cfg, shape,
                                                           n_chips),
                **({"chip": chip} if chip is not None else {}))
            rec["roofline"] = terms.as_dict()
            rec["vmem_resident_estimate"] = vmem_resident_traffic(
                cfg, shape, n_chips)
            rec["analyze_s"] = round(time.time() - t1, 1)
    except Exception as e:   # a failure here is a sharding bug — report it
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    finally:
        dist.destroy_process_group()
    if verbose:
        _print_rec(rec)
    return rec


def _print_rec(rec: Dict) -> None:
    if rec["status"] == "skip":
        print(f"[SKIP] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s}"
              f" -- {rec['reason'][:60]}", flush=True)
        return
    if rec["status"] == "fail":
        print(f"[FAIL] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s}"
              f" -- {rec['error'][:120]}", flush=True)
        return
    msg = (f"[ OK ] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
           f"args={rec['argument_bytes']/2**30:8.1f}GiB "
           f"temp={rec['temp_bytes']/2**30:7.1f}GiB "
           f"compile={rec['compile_s']:5.0f}s")
    if "roofline" in rec:
        r = rec["roofline"]
        msg += (f" | comp={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s "
                f"coll={r['collective_s']:.3f}s dom={r['dominant']}"
                f" useful={r['useful_flops_ratio']:.2f}")
    print(msg, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help="shape name (default: all four)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x all shapes")
    ap.add_argument("--no-analyze", action="store_true",
                    help="the full-size run only (skip the roofline runs)")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                # roofline table is single-pod only (assignment)
                records.append(run_cell(arch, shape, mp,
                                        analyze=not args.no_analyze
                                        and not mp))

    n_fail = sum(r["status"] == "fail" for r in records)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skip, {n_fail} fail "
          f"/ {len(records)} cells")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
