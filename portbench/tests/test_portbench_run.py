"""Whole runs of ``run.py`` at the tiny cells on the CPU (the look for a
card, the energy counter and the device trace skipped): each comes out
``correct``; with the timed path broken underneath, ``correct`` comes
out false, once for each fault a serving cell can have; and the fp8
control fails the tiny cells' limits."""
import json

import numpy as np
import pytest
import torch

from conftest import TINY_CELLS
from portbench import run
from repro_torch.core import engine, transfer
from repro_torch.models import api

SEED = 3_000_000_017          # above 2**31, as the driver's are


def result(capsys, root, cell, seconds=4.0, trace=0, seed=SEED) -> dict:
    """One run's result line; the window is long enough that a loaded CPU
    finishes several waves in it."""
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_sound_run_is_correct(capsys, tiny_root, cell, trace):
    res = result(capsys, tiny_root, cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        assert {"loop_host_share", "prefill_ms_per_ktok", "decode_step_ms",
                "mfu.prefill", "mfu.decode"} <= names
        assert ("handoff_ms" in names) == cell.endswith("dishost")
    else:
        bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
        # the CPU has no energy counter
        assert {m["name"] for m in bench["end_to_end"]} - {"j_per_token"} \
            <= names
    for m in res["metrics"].values():
        assert m["value"] > 0


def _state_unchanged(monkeypatch):
    """A decode step that leaves its state as it was: the paged pool is
    not written (the step sees copies), the recurrent state not
    advanced."""
    paged, step = api.Model.decode_step_paged, api.Model.decode_step

    def paged_copy(self, params, tokens, k, v, *a):
        return paged(self, params, tokens, k.clone(), v.clone(), *a)

    def step_same(self, params, tokens, state, pos):
        return step(self, params, tokens, state, pos)[0], state
    monkeypatch.setattr(api.Model, "decode_step_paged", paged_copy)
    monkeypatch.setattr(api.Model, "decode_step", step_same)


def _half_batch(monkeypatch):
    """Half of each decode batch left out: its rows take the tokens the
    other half produced."""
    decode = engine.RealExecutor.decode_batch

    def half(self, batch):
        decode(self, batch)
        keep = max(len(batch) // 2, 1)
        for i, s in enumerate(batch[keep:]):
            s.next_token = batch[i % keep].next_token
    monkeypatch.setattr(engine.RealExecutor, "decode_batch", half)


def _token_altered(monkeypatch):
    """Every third decode step's tokens changed where they are produced
    (a check that samples requests cannot see one altered token in one
    request it did not draw)."""
    decode = engine.RealExecutor.decode_batch
    calls = []

    def altered(self, batch):
        decode(self, batch)
        calls.append(1)
        if len(calls) % 3 == 0:
            for s in batch:
                s.next_token = (s.next_token + 1) % 512
    monkeypatch.setattr(engine.RealExecutor, "decode_batch", altered)


def _handoff_dropped(monkeypatch):
    """The exchange between the prefill and the decode side left out:
    the fetch hands over zeros of the payload's shapes."""
    def zeros(self, handle):
        device, state = handle
        return transfer.map_tensors(
            lambda x: torch.zeros_like(x, device=device), state)
    monkeypatch.setattr(transfer.HostPath, "fetch", zeros)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered,
          "handoff_dropped": _handoff_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_broken_path_is_not_correct(capsys, monkeypatch, tiny_root, cell,
                                    fault):
    if fault == "handoff_dropped" and not cell.endswith("dishost"):
        pytest.skip("a colocated cell has no handoff")
    FAULTS[fault](monkeypatch)
    res = result(capsys, tiny_root, cell, seconds=1.0)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_fp8_control_fails_the_limits(capsys, tiny_root, cell):
    """``control.py``: the program reads within the cell's limits, and the
    reference in fp8, put in the program's place on the same served
    requests, reads above one of them, both judged by the comparison
    that decides a run's ``correct``."""
    from portbench import control
    rc = control.main(["--workload", cell, "--seeds", str(SEED),
                       "--control-seeds", str(SEED), "--waves", "3"],
                      root=tiny_root, device="cpu")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["program_correct_every_seed"], summary
    assert summary["control_failed_every_seed"], summary
    assert rc == 0


def test_traffic_is_the_same_work_for_every_seed(tiny_root):
    from portbench.harness import spec, traffic
    t = spec.load_cell(tiny_root, "tiny-dense-dishost").traffic
    a = traffic.wave(t, 512, 1, 0)
    b = traffic.wave(t, 512, 2**31 + 5, 3)
    assert sorted((d.prompt_len, d.output_len) for d in a) == \
        sorted((d.prompt_len, d.output_len) for d in b)
    assert [d.prompt_len for d in a] != [d.prompt_len for d in b] or \
        not np.array_equal(a[0].tokens, b[0].tokens)


def test_no_card_exits_without_a_result(capsys, monkeypatch, tiny_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tiny-dense-co1gpu", "--seed", "1",
                   "--seconds", "1"], root=tiny_root)
    assert rc != 0
    assert capsys.readouterr().out == ""
