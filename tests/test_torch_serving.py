"""Real-mode serving in the port against the reference: identical token
streams per request in the five setups plus intra-gpu (the recipe of
tests/test_serving_integration.py) for the reference's archs there less
the recurrent ones (tests/test_torch_recurrent_serving.py has those) and
the other dense archs, simulated metrics and energy equal to the
reference's, bit-exact transfer paths, and the launcher's device rules.

Both packages run the same weights: the reference's init with its
projections (the experts' too) scaled by 10. At the plain init the
reduced model repeats its last prompt token, which would make the stream
check vacuous."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch.serve import device_kv, serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCH = "llama32-3b"
# tests/test_serving_integration.py's archs less the recurrent ones, then
# the other dense archs
ARCHS = (ARCH, "qwen3-1.7b", "moonshot-v1-16b-a3b", "qwen2-0.5b", "yi-34b",
         "command-r-35b")
SETUPS = tuple(T.SETUPS) + ("intra-gpu",)
IN_LEN, OUT_LEN = 48, 6
_SCALED = {"attn": ("wq", "wk", "wv", "wo"),
           "mlp": ("w_gate", "w_up", "w_down"),
           "ffn": ("w_gate", "w_up", "w_down"),        # moe: dense or experts
           "shared": ("w_gate", "w_up", "w_down")}     # moe: shared experts


def _scale(tree, names=()):
    """The projections named in ``_SCALED`` times 10, wherever they sit."""
    return {k: _scale(v, _SCALED.get(k, ())) if isinstance(v, dict)
            else v * 10 if k in names else v for k, v in tree.items()}


def np_params(arch=ARCH):
    cfg = reduce_for_smoke(REGISTRY[arch])
    p = jax.tree.map(np.asarray,
                     ref_get_model(cfg).init(jax.random.PRNGKey(0)))
    return cfg, _scale(p)


def cluster_kw(cfg, n_req, pool_tokens=None):
    kv_tok = max(cfg.kv_bytes_per_token(), 1)
    pool = pool_tokens or (IN_LEN + OUT_LEN) * n_req * 2
    return dict(pool_bytes=kv_tok * pool, page_size=8,
                prefill_token_budget=32)


def _streams(res):
    return [r.output_tokens for r in
            sorted(res.requests, key=lambda r: r.req_id)]


def run_reference(setup, n_req, pool_tokens=None, real=True, arch=ARCH):
    """The reference's real-mode streams (or, with ``real=False``, its
    simulation without executors) for one setup."""
    cfg, p = np_params(arch)
    model = ref_get_model(cfg)
    params = jax.tree.map(jnp.asarray, p)
    factory = (lambda path: R.RealExecutor(model, params,
                                           transfer_path=path)) \
        if real else None
    reqs = R.random_workload(n_req, input_len=IN_LEN, output_len=OUT_LEN,
                             vocab_size=cfg.vocab_size, seed=11)
    return R.make_cluster(setup, cfg, executor_factory=factory,
                          **cluster_kw(cfg, n_req, pool_tokens)).run(
        reqs, stepper="exact")


def run_port(setups, n_req, pool_tokens=None, arch=ARCH):
    _, p = np_params(arch)
    cfg = tcfg.reduce_for_smoke(tcfg.REGISTRY[arch])
    model = get_model(cfg)
    params = params_from_reference(p, cfg, device="cpu")
    out = {}
    for setup in setups:
        reqs = T.random_workload(n_req, input_len=IN_LEN,
                                 output_len=OUT_LEN,
                                 vocab_size=cfg.vocab_size, seed=11)
        kv = device_kv(cfg, reqs, "cpu")
        out[setup] = T.make_cluster(
            setup, cfg, executor_factory=lambda path: T.RealExecutor(
                model, params, kv, transfer_path=path),
            **cluster_kw(cfg, n_req, pool_tokens)).run(reqs)
        # every physical page is back in the device pool
        assert kv.pool.used_pages == 0, setup
    return out


_RUNS = {}


def _runs(arch=ARCH):
    if arch not in _RUNS:
        _RUNS[arch] = {
            "ref": _streams(run_reference("dis-host", 3, arch=arch)),
            "port": run_port(SETUPS, 3, arch=arch)}
    return _RUNS[arch]


@pytest.mark.parametrize("arch,setup", [
    pytest.param(a, s, id=s if a == ARCH else f"{a}-{s}")
    for a in ARCHS for s in SETUPS])
def test_tokens_match_reference(arch, setup):
    runs = _runs(arch)
    want = runs["ref"]
    assert len({tuple(s) for s in want}) > 1, "streams should differ"
    assert len(set(want[0])) > 1, "a stream should not repeat one token"
    got = _streams(runs["port"][setup])
    assert all(len(s) == OUT_LEN for s in got)
    assert got == want, f"{setup} diverged from the reference"


def _same(a, b):
    np.testing.assert_equal(dataclasses.asdict(a), dataclasses.asdict(b))


@pytest.mark.parametrize("setup", SETUPS)
def test_simulated_metrics_match_reference(setup):
    port = _runs()["port"][setup]
    ref = run_reference(setup, 3, real=False)
    _same(port.metrics, ref.metrics)
    assert port.energy.total_j == ref.energy.total_j
    assert port.energy.breakdown() == ref.energy.breakdown()
    assert port.makespan_s == ref.makespan_s


@pytest.mark.parametrize("medium", ["ici", "host", "disk"])
def test_transfer_paths_round_trip_bit_exact(medium, tmp_path):
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 5, 2, 32))
                         .astype(np.float32))
    payload = (7, k, k.to(torch.bfloat16), torch.arange(6).view(1, 6))
    kw = {"scratch_dir": str(tmp_path)} if medium == "disk" else {}
    path = T.make_path(medium, **kw)
    orig = k.clone()
    handle = path.store(payload)
    k.add_(1.0)                      # the store must not alias the source
    back = path.fetch(handle)
    assert back[0] == 7
    assert torch.equal(back[1], orig)
    assert back[2].dtype == torch.bfloat16
    assert torch.equal(back[2], orig.to(torch.bfloat16))
    assert torch.equal(back[3], payload[3])
    assert list(tmp_path.iterdir()) == []      # the disk file is consumed


def test_serve_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(ARCH, "dis-ici", real=True, smoke=True, verbose=False)
    with pytest.raises(NotImplementedError):
        serve(ARCH, "dis-ici", verbose=False)


def test_serve_smoke_on_cpu():
    res = serve(ARCH, "dis-disk", batch_size=2, real=True, smoke=True,
                device="cpu", verbose=False)
    assert [len(r.output_tokens) for r in res.requests] == [8, 8]
    assert res.metrics.median_ttft_s > 0
