"""The port's recurrent families against the reference, from the same
weights (the reference's init with its norm scales, biases, token-shift
mixes and decays perturbed, carried over by the weight bridge), on the
reduced rwkv6-3b and zamba2-2.7b: forward logits, prefill logits and
every field of the state, then decode steps (logits and state), in f32
at 2e-4. zamba2 also runs a windowed case (a long-context window of 8
and prompts longer than 4x it), which takes the ring re-slotting at
prefill and the ring branch at decode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.models import get_model as ref_get_model  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import _hybrid_window  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
TOL = 2e-4
NOISY = ("mu_base", "mu", "w0", "ln_x_scale", "ln_x_bias", "cm_mu_k",
         "cm_mu_r", "norm_tm", "norm_cm", "final_norm", "gate_norm", "norm",
         "D", "dt_bias")


def _perturb(tree, rng):
    """Seeded noise on the leaves the reference initialises to constants,
    which would hide a bridge error (a swapped or misplaced leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in NOISY:
            out[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _windowed(cfg, window=8):
    return cfg.replace(hybrid=dataclasses.replace(
        cfg.hybrid, long_context_window=window))


_CACHE = {}


def _setup(arch, windowed=False):
    key = (arch, windowed)
    if key not in _CACHE:
        cfg = reduce_for_smoke(REGISTRY[arch])
        tcfg = t_reduce(T_REGISTRY[arch])
        if windowed:
            cfg, tcfg = _windowed(cfg), _windowed(tcfg)
        ref = ref_get_model(cfg)
        np_params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
        np_params = _perturb(np_params, np.random.default_rng(1))
        _CACHE[key] = (ref, jax.tree.map(jnp.asarray, np_params),
                       get_model(tcfg),
                       params_from_reference(np_params, tcfg, device="cpu"))
    return _CACHE[key]


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _close_state(port, want):
    assert type(port).__name__ == type(want).__name__
    assert port._fields == want._fields
    for name in want._fields:
        got, exp = getattr(port, name), getattr(want, name)
        assert tuple(got.shape) == tuple(exp.shape), name
        _close(got, exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref, rp, model, tp = _setup(arch)
    toks = np.random.default_rng(5).integers(0, ref.cfg.vocab_size, (2, 37))
    want = ref.forward(rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    _close(model.forward(tp, {"tokens": torch.from_numpy(toks)}), want)


@pytest.mark.parametrize("arch,windowed", [("rwkv6-3b", False),
                                           ("zamba2-2.7b", False),
                                           ("zamba2-2.7b", True)])
def test_prefill_and_decode_match_reference(arch, windowed):
    """Prefill (logits, every state field), then three decode steps."""
    ref, rp, model, tp = _setup(arch, windowed)
    rng = np.random.default_rng(2)
    S, s_max = 40, 46
    toks = rng.integers(0, ref.cfg.vocab_size, (2, S))
    logits, state = ref.prefill(rp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                s_max=s_max)
    t_logits, t_state = model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                      s_max=s_max)
    _close(t_logits, logits)
    _close_state(t_state, state)
    assert isinstance(t_state, model.state_type)
    if arch == "zamba2-2.7b":
        w = _hybrid_window(model.cfg, s_max)
        assert w == (8 if windowed else 0)
        assert t_state.attn_k.shape[2] == (8 if windowed else s_max)
    for step in range(3):
        nxt = rng.integers(0, ref.cfg.vocab_size, (2,))
        pos = np.full(2, S + step, np.int32)
        logits, state = ref.decode_step(rp, jnp.asarray(nxt, jnp.int32),
                                        state, jnp.asarray(pos))
        t_logits, t_state = model.decode_step(tp, torch.from_numpy(nxt),
                                              t_state, torch.from_numpy(pos))
        _close(t_logits, logits)
        _close_state(t_state, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_reference(arch):
    ref, _, model, _ = _setup(arch)
    want = ref.init_decode_state(3, 20, dtype=jnp.float32)
    got = model.init_decode_state(3, 20, dtype=torch.float32, device="cpu")
    _close_state(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_has_the_reference_tree(arch):
    """The port's own init gives the bridge's tree: same keys, shapes and
    dtypes (the values differ: torch and jax draw different numbers)."""
    _, _, model, tp = _setup(arch)
    own = model.init(torch.Generator().manual_seed(0), "cpu")

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return tuple(tree.shape), tree.dtype
    assert sig(own) == sig(tp)
