"""Fault tolerance of the port's training path, mirroring
``tests/test_fault.py``: atomic checkpoints (bf16 bits kept), keep-N
rotation, restart continuity bit-exact, the straggler watchdog; and the
loop's own property, loss falls on the learnable synthetic stream (the
reference's ``test_training_reduces_loss``). The reference's two loop
tests are red only because its train step builds a mesh that this JAX
rejects; the port's run on the CPU."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import fault  # noqa: E402
from repro_torch.dist.fault import SimulatedFailure, StragglerWatchdog  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.train.optimizer import (AdamWState, tree_leaves,  # noqa: E402
                                         tree_map)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_checkpoint_roundtrip_keeps_bits(tmp_path):
    ckpt = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(2, 3, generator=g).to(torch.bfloat16),
              "layers": [{"b": torch.randn(5, generator=g)}]}
    opt = AdamWState(m=tree_map(torch.randn_like, params),
                     v=tree_map(torch.rand_like, params),
                     count=torch.tensor(7, dtype=torch.int32))
    path = fault.save_checkpoint(ckpt, 7, params, opt, {"seed": 1,
                                                        "step": 7})
    payload = fault.load_checkpoint(path)
    assert payload["step"] == 7 and payload["cursor"] == {"seed": 1,
                                                          "step": 7}
    assert fault.latest_checkpoint(ckpt) == path
    got_p, got_o, step, _ = fault.restore_sharded(payload, "cpu", "cpu")
    assert step == 7 and isinstance(got_o, AdamWState)
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((got_p, got_o))):
        assert _bits_equal(a, b)


def test_keep_n_rotation(tmp_path):
    ckpt = str(tmp_path)
    for s in range(6):
        fault.save_checkpoint(ckpt, s, {"w": torch.zeros(1)}, {}, {}, keep=3)
    assert [s for s, _ in fault.sorted_checkpoints(ckpt)] == [3, 4, 5]


def test_no_partial_checkpoint_on_failure(tmp_path, monkeypatch):
    """Temp files never survive as checkpoints, after a save or a failed
    one."""
    ckpt = str(tmp_path)
    fault.save_checkpoint(ckpt, 1, {"w": torch.zeros(1)}, {}, {})

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(fault.torch, "save", broken)
    with pytest.raises(OSError):
        fault.save_checkpoint(ckpt, 2, {"w": torch.zeros(1)}, {}, {})
    assert sorted(os.listdir(ckpt)) == [os.path.basename(
        fault.checkpoint_path(ckpt, 1))]


def test_restart_continuity_bit_exact(tmp_path):
    """Run A: 20 uninterrupted steps. Run B: fail at step 12, restart from
    the step-10 checkpoint. Losses and the final checkpoints (params,
    moments, count) agree bit for bit."""
    ck_a, ck_b = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(steps=20, batch_size=2, seq_len=16, ckpt_every=5,
              verbose=False, device="cpu")
    losses_a, _ = train("qwen2-0.5b", ckpt_dir=ck_a, **kw)
    with pytest.raises(SimulatedFailure):
        train("qwen2-0.5b", ckpt_dir=ck_b, fail_at=12, **kw)
    assert fault.latest_checkpoint(ck_b).endswith("ckpt_00000010.pt")
    losses_b2, _ = train("qwen2-0.5b", ckpt_dir=ck_b, **kw)
    assert losses_b2 == losses_a[10:]
    a = fault.load_checkpoint(fault.latest_checkpoint(ck_a))
    b = fault.load_checkpoint(fault.latest_checkpoint(ck_b))
    assert a["step"] == b["step"] == 20 and a["cursor"] == b["cursor"]
    for x, y in zip(tree_leaves((a["params"], a["opt_state"])),
                    tree_leaves((b["params"], b["opt_state"]))):
        assert _bits_equal(x, y)


def test_training_reduces_loss():
    losses, wd = train("qwen2-0.5b", smoke=True, steps=40, batch_size=4,
                       seq_len=32, verbose=False, device="cpu")
    assert len(losses) == 40 and np.all(np.isfinite(losses))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.05, f"loss did not improve: {first} -> {last}"


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(threshold=2.0, window=20)
    events = []
    wd.on_straggler = lambda s, d, m: events.append((s, d))
    for step in range(20):
        wd.observe(step, 0.1)
    assert not wd.flagged
    assert wd.observe(20, 0.5)          # 5x median -> straggler
    assert wd.flagged == [(20, 0.5)] and events


def test_straggler_deadline():
    wd = StragglerWatchdog(threshold=100.0, deadline_s=1.0)
    for step in range(6):
        wd.observe(step, 0.5)
    assert wd.observe(6, 1.5)           # hard deadline breach


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen2-0.5b", steps=1, verbose=False)
