"""Simulation-mode ``repro_torch.launch.serve`` (the default, no
``--real``) against ``repro.launch.serve``: the same arguments give a
``RunRecord`` with identical JSON, in the five setups, intra-gpu, a fleet
shape, at a lowered phi and under each governor; ``main`` runs without
``--real`` and still refuses a bad ``--setup`` as a usage error."""
import json

import pytest

pytest.importorskip("torch")

from torch_sim import port_cache  # noqa: E402,F401

from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch import exp as texp  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402

SETUPS = ("co-1gpu", "co-2gpus", "dis-ici", "dis-host", "dis-disk",
          "intra-gpu", "2P2D-ici")


def _dump(rec):
    return json.dumps(rec.to_dict(), sort_keys=True)


@pytest.mark.parametrize("kw", [
    *({"setup": s} for s in SETUPS),
    {"setup": "dis-host", "phi": 0.58, "batch_size": 8},
    *({"setup": "2P2D-ici", "governor": g}
      for g in ("static", "queue-depth", "slo-slack")),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_serve_matches_reference(kw):
    kw = dict(kw)
    setup = kw.pop("setup")
    s0 = texp.sim_count()
    port = port_serve.serve("llama32-3b", setup, verbose=False, **kw)
    assert texp.sim_count() == s0 + 1
    ref = ref_serve.serve("llama32-3b", setup, verbose=False, **kw)
    assert _dump(port) == _dump(ref)
    if kw.get("governor") in ("queue-depth", "slo-slack"):
        assert port.governor_decisions > 0


def test_main_simulates_by_default(capsys):
    port_serve.main(["--setup", "dis-ici", "--batch-size", "4",
                     "--input-len", "2048", "--output-len", "16",
                     "--governor", "slo-slack"])
    out = capsys.readouterr().out
    assert "[serve] dis-ici arch=llama32-3b bs=4 phi=1.0 " \
           "governor=slo-slack" in out
    assert "TPU v5e cost model" in out
    for key in ("median TTFT", "J/token", "breakdown: acc0="):
        assert key in out
    rec = texp.run(texp.Experiment.closed(
        "dis-ici", 4, input_len=2048, output_len=16).with_governor(
            "slo-slack"))
    assert f"median TTFT {rec.metrics.median_ttft_s:.3f}s" in out


def test_bad_setup_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        port_serve.main(["--setup", "dis-tape"])
    assert e.value.code == 2
    assert "cannot parse fleet shape" in capsys.readouterr().err


@pytest.mark.parametrize("setup", ("co-1gpu", "dis-ici"))
def test_real_executor_through_exp(setup, monkeypatch):
    """``exp.run`` with the port's real executor (the reduced model on
    the CPU): its streams are real-mode ``serve``'s for the same prompts,
    and its record is the same experiment's without an executor, stepped
    exactly (an engine with an executor never coalesces decode steps),
    which is the reference's record too."""
    import torch
    from repro.fleet import cluster as ref_cluster
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core import RealExecutor
    from repro_torch.fleet import cluster
    from repro_torch.models import get_model
    from repro import exp as rexp

    cfg = reduce_for_smoke(get_config("llama32-3b"))
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")

    def exp(E):
        return E.Experiment(arch="llama32-3b", fleet=setup,
                            workload=E.ClosedLoop(4, input_len=64,
                                                  output_len=8, seed=0,
                                                  vocab_size=cfg.vocab_size))
    kv = port_serve.device_kv(cfg, exp(texp).workload.build(), "cpu")
    served = {}

    class Recording(RealExecutor):
        def prefill(self, seq):
            served[seq.req.req_id] = seq.req
            return super().prefill(seq)

    rec = texp.run(exp(texp), executor_factory=lambda path: Recording(
        model, params, kv, transfer_path=path))
    monkeypatch.setattr(cluster, "DEFAULT_STEPPER", "exact")
    monkeypatch.setattr(ref_cluster, "DEFAULT_STEPPER", "exact")
    assert _dump(rec) == _dump(texp.run(exp(texp), cache=None))
    assert _dump(rec) == _dump(rexp.run(exp(rexp), cache=None))
    res = port_serve.serve("llama32-3b", setup, batch_size=4, real=True,
                           smoke=True, device="cpu", verbose=False)
    want = [r.output_tokens for r in sorted(res.requests,
                                            key=lambda r: r.req_id)]
    assert [served[i].output_tokens for i in sorted(served)] == want
    assert [len(t) for t in want] == [8] * 4
