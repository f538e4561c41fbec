"""The port's MoE family against the reference, in f32 at 2e-4.

The sort-based dispatch against the reference's ``_dispatch`` on the
same numpy inputs (no drop; drops forced by a small capacity factor; a
B = 4 decode batch whose four tokens all pick one expert; tied router
probabilities), and the reduced deepseek-moe-16b and moonshot-v1-16b-a3b
from the reference's weights (carried over by the weight bridge, norms
perturbed): forward logits and aux loss, prefill logits and KV, dense
decode, and decode through the paged pool."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.core import DevicePagedKV, PagedKVPool  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCHS = ["deepseek-moe-16b", "moonshot-v1-16b-a3b"]
TOL = 2e-4
S_MAX = 32
NOISY = ("norm_attn", "norm_mlp", "final_norm", "q_norm", "k_norm")


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _configs(arch="deepseek-moe-16b", **moe_kw):
    """The reduced reference and port configs, MoE fields replaced."""
    ref = reduce_for_smoke(REGISTRY[arch])
    port = t_reduce(T_REGISTRY[arch])
    return (ref.replace(moe=dataclasses.replace(ref.moe, **moe_kw)),
            port.replace(moe=dataclasses.replace(port.moe, **moe_kw)))


def _ffn_params(cfg, rng, router=None):
    m, d = cfg.moe, cfg.d_model
    E, f = m.num_experts, m.d_expert
    p = {"router": rng.normal(0, 0.3, (d, E)).astype(np.float32)
         if router is None else router.astype(np.float32),
         "w_gate": rng.normal(0, 0.1, (E, d, f)).astype(np.float32),
         "w_up": rng.normal(0, 0.1, (E, d, f)).astype(np.float32),
         "w_down": rng.normal(0, 0.1, (E, f, d)).astype(np.float32)}
    fs = m.num_shared_experts * f
    p["shared"] = {"w_gate": rng.normal(0, 0.1, (d, fs)).astype(np.float32),
                   "w_up": rng.normal(0, 0.1, (d, fs)).astype(np.float32),
                   "w_down": rng.normal(0, 0.1, (fs, d)).astype(np.float32)}
    return p


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _dispatch_both(rcfg, tcfg, p, xt, dropless):
    """(port, reference) of (y, counts, frac_probs) and the moe_ffn
    outputs (y, aux), plus the port's dropped decode slots."""
    jp = jax.tree.map(jnp.asarray, p)
    want = RMOE._dispatch(jp, jnp.asarray(xt), rcfg, dropless)
    want_ffn = RMOE.moe_ffn(jp, jnp.asarray(xt), rcfg, dropless)
    tp, tx = _torch_tree(p), torch.from_numpy(xt)
    moe.reset_decode_drops()
    got = moe._dispatch(tp, tx, tcfg, dropless)
    drops = moe.decode_drops()
    got_ffn = moe.moe_ffn(tp, tx, tcfg, dropless)
    moe.reset_decode_drops()
    return got, want, got_ffn, want_ffn, drops


def _check(got, want, got_ffn, want_ffn):
    for g, w in zip(got, want):          # y, counts, frac_probs
        _close(g, w)
    _close(got_ffn[0], want_ffn[0])
    _close(got_ffn[1], want_ffn[1])


def _dropped_slots(rcfg, xt, p, dropless):
    """Slots the reference drops: top-k slots minus the capacity."""
    C = moe.capacity(xt.shape[0] * rcfg.moe.top_k, rcfg, dropless)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), -1)
    _, idx = jax.lax.top_k(probs, rcfg.moe.top_k)
    counts = np.bincount(np.asarray(idx).ravel(),
                         minlength=rcfg.moe.num_experts)
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("case", ["no-drop", "drops", "decode-no-drop"])
def test_dispatch_matches_reference(case):
    cf = {"no-drop": 8.0, "drops": 0.5, "decode-no-drop": 8.0}[case]
    rcfg, tcfg = _configs(capacity_factor=cf)
    rng = np.random.default_rng(7)
    p = _ffn_params(rcfg, rng)
    xt = rng.normal(0, 1, (24, rcfg.d_model)).astype(np.float32)
    dropless = case.startswith("decode")
    got, want, got_ffn, want_ffn, drops = _dispatch_both(rcfg, tcfg, p, xt,
                                                         dropless)
    _check(got, want, got_ffn, want_ffn)
    dropped = _dropped_slots(rcfg, xt, p, dropless)
    assert (dropped > 0) == (case == "drops"), dropped
    assert drops == 0                     # only decode slots are counted


def test_decode_batch_all_to_one_expert_drops_as_reference():
    """deepseek-moe-16b's routing (64 experts, top-6) at B = 4: decode
    capacity C = 3 of 24 slots; all four tokens pick expert 5 (and, as
    they are alike, a few more experts in common), so a slot of each such
    expert is dropped, and which one decides the output."""
    rcfg, tcfg = _configs(num_experts=64, top_k=6, d_expert=16,
                          num_shared_experts=2)
    assert moe.capacity(4 * 6, tcfg, dropless=True) == 3
    rng = np.random.default_rng(8)
    d = rcfg.d_model
    u = rng.normal(0, 1, d)
    router = rng.normal(0, 0.02, (d, 64))
    router[:, 5] += 10 * u / d
    p = _ffn_params(rcfg, rng, router)
    xt = (u + 0.3 * rng.normal(0, 1, (4, d))).astype(np.float32)
    got, want, got_ffn, want_ffn, drops = _dispatch_both(rcfg, tcfg, p, xt,
                                                         True)
    assert np.asarray(want[1])[5] == 4          # expert 5: all four tokens
    assert drops == _dropped_slots(rcfg, xt, p, True) >= 1
    _check(got, want, got_ffn, want_ffn)
    # B = 1: C = 1 of 6 slots, one per expert, so nothing is dropped
    assert moe.capacity(6, tcfg, dropless=True) == 1
    _, _, _, _, drops = _dispatch_both(rcfg, tcfg, p, xt[:1], True)
    assert drops == 0


def test_tied_router_probabilities_pick_the_lower_expert():
    """Exact ties (integer inputs, router columns 2 and 3 equal) across
    the top-k boundary: the port keeps the reference's lower index."""
    rcfg, tcfg = _configs()                     # 8 experts, top-2
    rng = np.random.default_rng(9)
    d = rcfg.d_model
    xt = rng.integers(0, 2, (6, d)).astype(np.float32)
    xt[:, 0] = 1                                # no row of zeros
    router = np.full((d, 8), -0.25, np.float32)
    router[:, 0] = 0.5
    router[:, 2] = router[:, 3] = 0.25
    p = _ffn_params(rcfg, rng, router)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt @ router), -1))
    assert (probs[:, 2] == probs[:, 3]).all()
    assert (np.sort(probs, -1)[:, -2] == probs[:, 2]).all()
    got, want, got_ffn, want_ffn, _ = _dispatch_both(rcfg, tcfg, p, xt,
                                                     False)
    _, _, idx = moe.route(_torch_tree(p), torch.from_numpy(xt), tcfg)
    assert (idx[:, 1] == 2).all()
    _check(got, want, got_ffn, want_ffn)


# ----------------------------------------------------------------------
# the model, from the reference's weights
# ----------------------------------------------------------------------
def _perturb(tree, rng):
    """Seeded noise on norm scales (the reference initialises them to 1,
    which would hide a bridge error)."""
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
                                 RMOE.init(jax.random.PRNGKey(0), cfg))
        np_params = _perturb(np_params, np.random.default_rng(1))
        tcfg = t_reduce(T_REGISTRY[arch])
        port = params_from_reference(np_params, tcfg, device="cpu")
        _CACHE[arch] = (cfg, tcfg, jax.tree.map(jnp.asarray, np_params),
                        port)
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_layout(arch):
    cfg, tcfg, _, port = _setup(arch)
    n = cfg.moe.first_k_dense
    assert len(port.get("dense_layers", [])) == n
    assert len(port["moe_layers"]) == cfg.num_layers - n
    ffn = port["moe_layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["w_gate"].shape) == (cfg.moe.num_experts, cfg.d_model,
                                          cfg.moe.d_expert)
    if n:
        assert port["dense_layers"][0]["ffn"]["w_up"].shape[1] == \
            cfg.moe.dense_d_ff


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 17))
    want, want_aux = RMOE.forward(ref_params, jnp.asarray(toks, jnp.int32),
                                  cfg)
    got, aux = moe.forward(port, torch.from_numpy(toks), tcfg)
    _close(got, want)
    _close(aux, want_aux)
    _close(get_model(tcfg).forward(port, {"tokens": torch.from_numpy(toks)}),
           want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    logits, cache = RMOE.prefill(ref_params, jnp.asarray(toks, jnp.int32),
                                 cfg, s_max=S_MAX)
    t_logits, t_cache = get_model(tcfg).prefill(
        port, {"tokens": torch.from_numpy(toks)}, s_max=S_MAX)
    _close(t_logits, logits)
    _close(t_cache.k, cache.k)
    _close(t_cache.v, cache.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    cfg, tcfg, ref_params, port = _setup(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 20))
    nxt = rng.integers(0, cfg.vocab_size, (2,))
    pos = np.array([20, 20], np.int32)
    _, cache = RMOE.prefill(ref_params, jnp.asarray(toks, jnp.int32), cfg,
                            s_max=S_MAX)
    logits, cache = RMOE.decode_step(ref_params, jnp.asarray(nxt, jnp.int32),
                                     cache, jnp.asarray(pos), cfg)
    model = get_model(tcfg)
    _, t_cache = model.prefill(port, {"tokens": torch.from_numpy(toks)},
                               s_max=S_MAX)
    t_logits, t_cache = model.decode_step(port, torch.from_numpy(nxt),
                                          t_cache, torch.from_numpy(pos))
    _close(t_logits, logits)
    _close(t_cache.k, cache.k)
    _close(t_cache.v, cache.v)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_reference(arch):
    """Ragged batch (13 and 21 tokens) on scattered pages, two decode
    steps: the paged path equals the reference's dense decode."""
    cfg, tcfg, ref_params, port = _setup(arch)
    rng = np.random.default_rng(4)
    lens = [13, 21]
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lens]
    steps = rng.integers(0, cfg.vocab_size, (2, 2))      # [step, batch]
    caches = [RMOE.prefill(ref_params, jnp.asarray(p, jnp.int32), cfg,
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
        logits, cache = RMOE.decode_step(
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
    for sid, n in enumerate(lens):
        k_dense, _ = kv.gather_dense(sid)
        _close(k_dense, cache.k[:, sid, :n + 2])
