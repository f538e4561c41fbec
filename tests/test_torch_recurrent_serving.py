"""Real-mode serving of the recurrent families in the port against the
reference (the recipe of tests/test_torch_serving.py): rwkv6-3b and
zamba2-2.7b give the reference's per-request token streams in the five
setups plus intra-gpu, with its simulated metrics; the rwkv6 handoff
does not grow with the prompt; a model's NamedTuple state crosses all
three media bit-exactly; the launcher serves both archs on the CPU.

Both packages run the reference's own init of the reduced models: at it
the streams already vary (unlike the dense model's, which the dense
serving test scales), so no projection is scaled here."""
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
from repro_torch.core.engine import EngineSeq  # noqa: E402
from repro_torch.core.transfer import map_tensors  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.rwkv6 import RWKVState  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-2.7b")
SETUPS = tuple(T.SETUPS) + ("intra-gpu",)
IN_LEN, OUT_LEN, N_REQ = 48, 6, 3


def np_params(arch):
    cfg = reduce_for_smoke(REGISTRY[arch])
    return cfg, jax.tree.map(np.asarray,
                             ref_get_model(cfg).init(jax.random.PRNGKey(0)))


def cluster_kw(cfg):
    kv_tok = max(cfg.kv_bytes_per_token(), 1)
    return dict(pool_bytes=kv_tok * (IN_LEN + OUT_LEN) * N_REQ * 2,
                page_size=8, prefill_token_budget=32)


def _workload(vocab):
    return R.random_workload(N_REQ, input_len=IN_LEN, output_len=OUT_LEN,
                             vocab_size=vocab, seed=11)


def _streams(res):
    return [r.output_tokens for r in
            sorted(res.requests, key=lambda r: r.req_id)]


def run_reference(arch, setup, real=True):
    cfg, p = np_params(arch)
    model = ref_get_model(cfg)
    params = jax.tree.map(jnp.asarray, p)
    factory = (lambda path: R.RealExecutor(model, params,
                                           transfer_path=path)) \
        if real else None
    return R.make_cluster(setup, cfg, executor_factory=factory,
                          **cluster_kw(cfg)).run(_workload(cfg.vocab_size),
                                                 stepper="exact")


def port_model(arch):
    _, p = np_params(arch)
    cfg = tcfg.reduce_for_smoke(tcfg.REGISTRY[arch])
    return cfg, get_model(cfg), params_from_reference(p, cfg, device="cpu")


def run_port(arch):
    cfg, model, params = port_model(arch)
    out = {}
    for setup in SETUPS:
        reqs = T.random_workload(N_REQ, input_len=IN_LEN, output_len=OUT_LEN,
                                 vocab_size=cfg.vocab_size, seed=11)
        out[setup] = T.make_cluster(
            setup, cfg, executor_factory=lambda path: T.RealExecutor(
                model, params, None, transfer_path=path),
            **cluster_kw(cfg)).run(reqs)
    return out


_RUNS = {}


def _runs(arch):
    if arch not in _RUNS:
        _RUNS[arch] = (_streams(run_reference(arch, "dis-host")),
                       run_port(arch))
    return _RUNS[arch]


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_match_reference(arch, setup):
    want, port = _runs(arch)
    assert len({tuple(s) for s in want}) > 1, "streams should differ"
    assert len(set(want[0])) > 1, "a stream should not repeat one token"
    got = _streams(port[setup])
    assert all(len(s) == OUT_LEN for s in got)
    assert got == want, f"{arch} {setup} diverged from the reference"


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_simulated_metrics_match_reference(arch, setup):
    port = _runs(arch)[1][setup]
    ref = run_reference(arch, setup, real=False)
    np.testing.assert_equal(dataclasses.asdict(port.metrics),
                            dataclasses.asdict(ref.metrics))
    assert port.energy.total_j == ref.energy.total_j
    assert port.makespan_s == ref.makespan_s


def _prefilled_payload(executor, prompt_len, vocab):
    req = T.random_workload(1, input_len=prompt_len, output_len=4,
                            vocab_size=vocab, seed=3)[0]
    seq = EngineSeq(req=req, prefill_target=prompt_len)
    seq.state, seq.last_logits, seq.next_token = executor.prefill(seq)
    return seq, executor.store(seq)


def _nbytes(payload):
    sizes = []
    map_tensors(lambda x: sizes.append(x.numel() * x.element_size()),
                payload)
    return sum(sizes)


def test_rwkv_state_handoff_is_tiny():
    """Attention-free arch: the payload the port really ships does not
    depend on the prompt length (the degenerate-transfer case), and the
    port's cost model says the same at full size, as the reference's
    test_serving_integration.py:81 does."""
    cfg, model, params = port_model("rwkv6-3b")
    ex = T.RealExecutor(model, params)
    sizes = {n: _nbytes(_prefilled_payload(ex, n, cfg.vocab_size)[1])
             for n in (16, 48)}
    assert sizes[16] == sizes[48] > 0
    full = T.CostModel(tcfg.REGISTRY["rwkv6-3b"])
    assert full.kv_bytes(16_384) == full.kv_bytes(128)
    dense = T.CostModel(tcfg.REGISTRY["llama32-3b"])
    assert dense.kv_bytes(16_384) > 100 * full.kv_bytes(16_384)


@pytest.mark.parametrize("medium", ["ici", "host", "disk"])
def test_state_handoff_crosses_every_medium(medium, tmp_path):
    """The executor's handoff of a prefilled zamba2 state (plain tuple
    on the medium, NamedTuple again on the decode side) is bit-exact."""
    cfg, model, params = port_model("zamba2-2.7b")
    kw = {"scratch_dir": str(tmp_path)} if medium == "disk" else {}
    path = T.make_path(medium, **kw)
    ex = T.RealExecutor(model, params)
    seq, payload = _prefilled_payload(ex, 20, cfg.vocab_size)
    state, logits = ex.fetch(path.fetch(path.store(payload)))
    assert isinstance(state, model.state_type)
    for got, want in zip(state, seq.state):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(logits, seq.last_logits)
    ex.release(seq)
    assert seq.state is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("medium", ["ici", "host", "disk"])
def test_named_tuple_state_round_trip_bit_exact(medium, tmp_path):
    """A NamedTuple state with f32 and bf16 fields survives all three
    media bit-exactly: ici and host keep the NamedTuple itself; every
    medium carries it as the plain tuple the executor ships."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 1, 3, 8, 8))
                         .astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 1, 16)).astype(np.float32))
    state = RWKVState(wkv=x, tm_x=h.to(torch.bfloat16),
                      cm_x=(h * 3).to(torch.bfloat16))
    kw = {"scratch_dir": str(tmp_path)} if medium == "disk" else {}
    path = T.make_path(medium, **kw)
    back = RWKVState(*path.fetch(path.store((tuple(state), 7)))[0])
    if medium != "disk":
        direct = path.fetch(path.store(state))
        assert type(direct) is RWKVState
        assert all(torch.equal(a, b) for a, b in zip(direct, state))
    for got, want in zip(back, state):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu(arch):
    res = serve(arch, "dis-disk", batch_size=2, real=True, smoke=True,
                device="cpu", verbose=False)
    assert [len(r.output_tokens) for r in res.requests] == [8, 8]
    assert res.metrics.median_ttft_s > 0
