"""The port's vlm (internvl2-2b) and encdec (seamless-m4t-medium)
families against the reference, in f32 at 2e-4 on the reduced configs,
from the reference's weights (the weight bridge; biases and norms
perturbed): forward logits, prefill logits with its state, and one and
four decode steps (the recipe of tests/test_models.py). Also the port's
own seeded init of every family through ``Model``."""
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
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCHS = ["internvl2-2b", "seamless-m4t-medium"]
TOL = 2e-4
NOISY = ("b", "bq", "bk", "bv", "bo", "b_up", "b_down", "q_norm", "k_norm",
         "norm_attn", "norm_mlp", "norm_self", "norm_cross", "final_norm")


def _perturb(tree, rng):
    """Seeded noise on biases and norm scales (the reference initialises
    them to 0 and 1, which would hide a bridge error)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in NOISY:
            out[k] = (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        cfg = reduce_for_smoke(REGISTRY[arch])
        ref = ref_get_model(cfg)
        np_params = jax.tree.map(np.asarray,
                                 ref.init(jax.random.PRNGKey(0)))
        np_params = _perturb(np_params, np.random.default_rng(1))
        tcfg = t_reduce(T_REGISTRY[arch])
        port = params_from_reference(np_params, tcfg, device="cpu")
        _CACHE[arch] = (cfg, ref, jax.tree.map(jnp.asarray, np_params),
                        get_model(tcfg), port)
    return _CACHE[arch]


def _batch(cfg, B, S, seed):
    """numpy inputs ({"patches" | "src_embeds",} "tokens") and the length
    of what comes before the text in the decoder (vlm: the patches)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    if cfg.family == "vlm":
        v = cfg.vision
        extra = rng.normal(0, 0.1, (B, v.num_patches, v.frontend_dim))
        return {"patches": extra.astype(np.float32), "tokens": toks}, \
            v.num_patches
    if cfg.family != "encdec":
        return {"tokens": toks}, 0
    src = rng.normal(0, 0.1, (B, 24, cfg.encdec.frontend_dim))
    return {"src_embeds": src.astype(np.float32), "tokens": toks}, 0


def _both(batch):
    ref = {k: jnp.asarray(v) for k, v in batch.items()}
    ref["tokens"] = ref["tokens"].astype(jnp.int32)
    return ref, {k: torch.from_numpy(v) for k, v in batch.items()}


def _state_close(got, want):
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, ref, ref_params, model, port = _setup(arch)
    rb, tb = _both(_batch(cfg, 2, 17, 5)[0])
    want = ref.forward(ref_params, rb)
    got = model.forward(port, tb)
    assert got.shape == (2, 17, cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, ref, ref_params, model, port = _setup(arch)
    batch, lead = _batch(cfg, 2, 12, 2)
    rb, tb = _both(batch)
    s_max = lead + 16
    logits, state = ref.prefill(ref_params, rb, s_max=s_max)
    t_logits, t_state = model.prefill(port, tb, s_max=s_max)
    assert type(t_state) is model.state_type
    _close(t_logits, logits)
    _state_close(t_state, state)


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, steps):
    """Prefill the first S - steps tokens, then decode the rest one at a
    time: every step's logits and the final state match the reference's,
    and the last step's logits match the forward pass at that position."""
    cfg, ref, ref_params, model, port = _setup(arch)
    S = 12
    batch, lead = _batch(cfg, 2, S, 3)
    toks = batch["tokens"]
    rfull, _ = _both(batch)
    full = ref.forward(ref_params, rfull)
    prefix = dict(batch, tokens=toks[:, :S - steps])
    rb, tb = _both(prefix)
    _, state = ref.prefill(ref_params, rb, s_max=lead + S)
    _, t_state = model.prefill(port, tb, s_max=lead + S)
    for i in range(S - steps, S):
        pos = np.full((2,), lead + i, np.int32)
        logits, state = ref.decode_step(
            ref_params, jnp.asarray(toks[:, i], jnp.int32), state,
            jnp.asarray(pos))
        t_logits, t_state = model.decode_step(
            port, torch.from_numpy(toks[:, i]), t_state,
            torch.from_numpy(pos))
        _close(t_logits, logits)
        _close(t_logits, full[:, i])
    _state_close(t_state, state)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_reference(arch):
    cfg, ref, _, model, _ = _setup(arch)
    want = ref.init_decode_state(3, 40, jnp.float32)
    got = model.init_decode_state(3, 40, torch.float32, "cpu")
    assert type(got) is model.state_type
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_port_init_serves_the_model_api(arch):
    """The port's own seeded init (no reference) of the reduced config:
    finite logits of the right shape from forward and prefill, the same
    seed gives the same weights, and the paged families refuse a
    per-sequence state."""
    tcfg = t_reduce(T_REGISTRY[arch])
    model = get_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(params["embed"]["embedding"],
                       again["embed"]["embedding"])
    batch, _ = _batch(tcfg, 1, 9, 4)
    _, tb = _both(batch)
    logits = model.forward(params, tb)
    assert logits.shape == (1, 9, tcfg.vocab_size)
    assert torch.isfinite(logits).all()
    last, _ = model.prefill(params, tb)
    torch.testing.assert_close(last, logits[:, -1], atol=TOL, rtol=TOL)
    if tcfg.family == "moe":
        with pytest.raises(NotImplementedError, match="paged pool"):
            model.init_decode_state(1, 16, torch.float32, "cpu")
