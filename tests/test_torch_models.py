"""The port's dense transformer against the reference, from the same
weights (the reference's init, carried over by the weight bridge):
forward logits, prefill logits and KV, dense decode, and decode through
the paged pool,
in f32 at 2e-4 on the reduced configs of the five dense archs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.core import DevicePagedKV, PagedKVPool  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402

ARCHS = ["llama32-3b", "qwen3-1.7b", "qwen2-0.5b", "yi-34b",
         "command-r-35b"]
TOL = 2e-4
S_MAX = 32
NOISY = ("bq", "bk", "bv", "bo", "b_up", "b_down", "q_norm", "k_norm",
         "norm_attn", "norm_mlp", "final_norm")


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


_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        cfg = reduce_for_smoke(REGISTRY[arch])
        np_params = jax.tree.map(np.asarray,
                                 RTF.init(jax.random.PRNGKey(0), cfg))
        np_params = _perturb(np_params, np.random.default_rng(1))
        ref_params = jax.tree.map(jnp.asarray, np_params)
        tcfg = t_reduce(T_REGISTRY[arch])
        port = params_from_reference(np_params, tcfg, device="cpu")
        _CACHE[arch] = (cfg, tcfg, ref_params, port)
    return _CACHE[arch]


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    logits, cache = RTF.prefill(ref_params, jnp.asarray(toks, jnp.int32),
                                cfg, s_max=S_MAX)
    t_logits, t_cache = get_model(tcfg).prefill(
        port, {"tokens": torch.from_numpy(toks)}, s_max=S_MAX)
    _close(t_logits, logits)
    _close(t_cache.k, cache.k)
    _close(t_cache.v, cache.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17))
    want = RTF.forward(ref_params, jnp.asarray(toks, jnp.int32), cfg)
    got = get_model(tcfg).forward(port, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 20))
    nxt = rng.integers(0, cfg.vocab_size, (2,))
    pos = np.array([20, 20], np.int32)
    _, cache = RTF.prefill(ref_params, jnp.asarray(toks, jnp.int32), cfg,
                           s_max=S_MAX)
    logits, cache = RTF.decode_step(ref_params, jnp.asarray(nxt, jnp.int32),
                                    cache, jnp.asarray(pos), cfg)
    model = get_model(tcfg)
    _, t_cache = model.prefill(port, {"tokens": torch.from_numpy(toks)},
                               s_max=S_MAX)
    t_logits, t_cache = model.decode_step(port, torch.from_numpy(nxt),
                                          t_cache, torch.from_numpy(pos))
    _close(t_logits, logits)
    _close(t_cache.k, cache.k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_reference_dense(arch):
    """Ragged batch (13 and 21 tokens) on scattered pages, two decode
    steps: the paged path equals the reference's dense cached_attention."""
    cfg, tcfg, ref_params, port = _setup(arch)
    rng = np.random.default_rng(4)
    lens = [13, 21]
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    steps = rng.integers(0, cfg.vocab_size, (2, 2))      # [step, batch]
    caches = [RTF.prefill(ref_params, jnp.asarray(p, jnp.int32), cfg,
                          s_max=S_MAX)[1] for p in prompts]
    cache = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *caches)

    model = get_model(tcfg)
    pool = PagedKVPool(num_pages=12, page_size=8)
    kv = DevicePagedKV(pool, tcfg.num_layers, tcfg.num_kv_heads,
                       tcfg.head_dim, dtype=torch.float32, device="cpu")
    pool.allocate(99, 8)                 # scatter the sequences' pages
    for sid, p in enumerate(prompts):
        _, c = model.prefill(port, {"tokens": torch.from_numpy(p)})
        pool.allocate(sid, p.shape[1])
        kv.write_prefill(sid, c.k[:, 0], c.v[:, 0])
    pool.free_seq(99)
    for step in range(2):
        pos = np.asarray(lens, np.int32) + step
        logits, cache = RTF.decode_step(
            ref_params, jnp.asarray(steps[step], jnp.int32), cache,
            jnp.asarray(pos), cfg)
        tables = []
        for sid in range(2):
            pool.allocate(sid, 1)
            tables.append(pool.block_table(sid))
        width = max(map(len, tables))
        bt = torch.tensor([t + [0] * (width - len(t)) for t in tables],
                          dtype=torch.int32)
        t_logits = model.decode_step_paged(
            port, torch.from_numpy(steps[step]), kv.k, kv.v, bt,
            torch.from_numpy(pos))
        _close(t_logits, logits)
    # the in-place writes landed where a dense gather finds them
    for sid, n in enumerate(lens):
        k_dense, _ = kv.gather_dense(sid)
        _close(k_dense, cache.k[:, sid, :n + 2])
