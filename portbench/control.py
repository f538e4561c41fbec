"""The readings that a cell's limits are set from, and the control's
verdict, on the card.

  python3 portbench/control.py --workload <cell> --seeds 1,2,... \\
      --control-seeds 1,2,3 [--waves 1]

In one process: for each seed, the cell's weights drawn from it, one
wave (or ``--waves``) of its traffic served through the same path as a
run's window, and the same sample held to the f32 reference: the
program's numbers. For each control seed, also the control's numbers:
the reference in fp8 (``reference/lowp.py``) in the program's place, on
the same requests. Both are judged by ``check.verdict`` against the
cell's limits, as a run's ``correct`` is. One JSON line a seed, then a
summary: each number's largest program reading (the lower end of its
limit), its smallest control reading (the upper end), and the verdicts.
It exits 0 only where every program seed is within the limits and the
control fails them on every control seed. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--waves", type=int, default=1)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}

    import torch
    from portbench.harness import check, serving, spec, traffic, weights
    from repro_torch.models import get_model

    dev = torch.device(device)
    cell = spec.load_cell(root, args.workload)
    cfg = spec.model_config(cell.config_name, cell.config)
    model = get_model(cfg)
    t = cell.traffic
    limits = cell.cell["limits"]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        params = weights.make(model, cell.config["init"], cfg.num_layers,
                              seed, dev)
        server = serving.make_server(cfg, model, params, t,
                                     cell.cell["setup"], dev)
        bench = serving.Bench(dev, int(cell.cell["probe_every"]), seed)
        for w in range(args.waves):
            serving.run_wave(server, bench, traffic.wave(
                t, cfg.vocab_size, seed, w), w)
        server.kv = None
        gc.collect()            # the clusters' cycles hold the pool
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = check.judge(bench, params, cell.config, seed,
                          control=seed in ctrl_seeds)
        prog, ctrl = got if seed in ctrl_seeds else (got, None)
        row = {"seed": seed, "program": prog,
               "program_correct": check.verdict(prog, limits)[1],
               "control": ctrl,
               # the control has no handoff: it is judged on what it reads
               "control_correct": None if ctrl is None else check.verdict(
                   ctrl, {k: v for k, v in limits.items() if k in ctrl})[1],
               "requests": len(bench.recs),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del params, server, bench
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    ctrl_rows = [r for r in rows if r["control"]]
    summary = {
        "program_max": {k: max(r["program"][k] for r in rows)
                        for k in rows[0]["program"]},
        "control_min": {k: min(r["control"][k] for r in ctrl_rows)
                        for k in (ctrl_rows[0]["control"] if ctrl_rows
                                  else {})},
        "limits": limits,
        "program_correct_every_seed": all(r["program_correct"]
                                          for r in rows),
        "control_failed_every_seed": bool(ctrl_rows) and not any(
            r["control_correct"] for r in ctrl_rows)}
    print(json.dumps(summary), flush=True)
    ok = (summary["program_correct_every_seed"]
          and summary["control_failed_every_seed"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
