"""Training launcher: restartable, checkpointed, straggler-watched; the
port of ``repro.launch.train``.

It runs on the card unless asked for the CPU: ``--full`` trains the full
config (llama32-3b: 3.21 B parameters; the flash kernel's forward and
backward carry attention), ``--smoke`` (the default) the reduced one.

  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch llama32-3b --steps 5 --batch-size 2 --seq-len 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --device cpu --steps 12 --ckpt-dir /tmp/ck --ckpt-every 5

Re-run with more ``--steps`` and the same ``--ckpt-dir`` to restore the
latest checkpoint and go on from it. The step is built on
``make_host_mesh`` of ``--device``: one device, (1, 1), in a process with
no process group. Perf flags come from ``REPRO_OPT`` (e.g.
``REPRO_OPT=remat_dots,bf16_logits``; ``dist/opt_flags.py``). rwkv6-3b
trains on the card through the rwkv6 scan's forward and backward kernels
(``--full --arch rwkv6-3b``), zamba2-2.7b through the SSD scan's and
flash's (``--full --arch zamba2-2.7b``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.dist import fault
from repro_torch.dist.fault import SimulatedFailure, StragglerWatchdog
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.steps import build_train_step
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import adamw, cosine_schedule


def train(arch: Union[str, ModelConfig], *, smoke: bool = True,
          steps: int = 50, batch_size: int = 8, seq_len: int = 128,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          seed: int = 0, fail_at: Optional[int] = None,
          log_every: int = 10, verbose: bool = True, device="cuda"):
    """Returns (losses, watchdog). Restart-safe when ckpt_dir is set.

    ``arch``: a registered name, or a config (e.g. one cut in depth),
    which ``smoke`` then reduces likewise."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on the card and no CUDA device is "
                           "available (device='cpu' runs the plain "
                           "versions on the CPU)")
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if smoke:
        cfg = reduce_for_smoke(cfg)
    shape = InputShape("cli", seq_len, batch_size, "train")
    opt = adamw(cosine_schedule(1e-3, warmup_steps=max(steps // 10, 1),
                                total_steps=steps))
    mesh = make_host_mesh(device_type=device.type)
    bundle = build_train_step(cfg, mesh, shape, optimizer=opt)
    model = bundle.model

    data = SyntheticLM(cfg, batch_size, seq_len, seed=seed)
    start_step = 0
    params = opt_state = None
    if ckpt_dir:
        latest = fault.latest_checkpoint(ckpt_dir)
        if latest:
            payload = fault.load_checkpoint(latest)
            params, opt_state, start_step, cursor = fault.restore_sharded(
                payload, device, device)
            del payload
            data.restore(cursor)
            if verbose:
                print(f"[train] restored step {start_step} from {latest}")
    if params is None:
        params = model.init(
            torch.Generator(device=device).manual_seed(seed), device)
        opt_state = opt.init(params)

    watchdog = StragglerWatchdog(threshold=3.0)
    losses = []
    for step in range(start_step, steps):
        if fail_at is not None and step == fail_at:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.time()
        batch = data.next_batch()
        params, opt_state, loss = bundle.fn(params, opt_state, batch)
        loss = float(loss)
        losses.append(loss)
        watchdog.observe(step, time.time() - t0)
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:.4f}")
        if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1):
            fault.save_checkpoint(ckpt_dir, step + 1, params, opt_state,
                                  data.cursor.as_dict())
    return losses, watchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device the model trains on")
    args = ap.parse_args(argv)
    losses, wd = train(args.arch, smoke=args.smoke, steps=args.steps,
                       batch_size=args.batch_size, seq_len=args.seq_len,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       seed=args.seed, fail_at=args.fail_at,
                       device=args.device)
    print(f"[train] done: {len(losses)} steps, final loss "
          f"{losses[-1]:.4f}, {len(wd.flagged)} straggler steps")


if __name__ == "__main__":
    main()
