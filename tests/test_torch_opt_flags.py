"""The port's perf flags (``repro_torch.dist.opt_flags``) against the
reference's contract and against the reference itself.

The reference's ``tests/test_opt_flags.py`` holds inside the port: unknown
names raise, the set round-trips, the flags preserve the forward and the
gradients, ``bf16_logits`` keeps bf16, ``masked_cache_update`` is
bit-exact, and ``pad_heads`` is exact for every (H, KV) class. Each flag
is also held to the reference with the same flag set in both, from the
reference's weights (carried over by the weight bridge) and the same
numpy tokens: f32 forward logits within 2e-4, gradients within 1e-4 of
each leaf's largest magnitude. ``local_moe_dispatch`` is held to the
reference's grouped dispatch where capacity drops slots and where it does
not, and under ``remat_dots`` the backward recomputes no projection
(6 x L fewer ``aten.mm`` calls than without it).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.compat import abstract_mesh as r_abstract_mesh  # noqa: E402
from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.dist import opt_flags as r_flags  # noqa: E402
from repro.dist import sharding as r_sharding  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.dist import opt_flags  # noqa: E402
from repro_torch.dist.sharding import abstract_mesh, state_spec  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
FWD_TOL = 2e-4                # f32 forward against the reference
GRAD_TOL = 1e-4               # each grad leaf against its largest magnitude
B, S = 2, 32
HEAD_CLASSES = [(56, 8), (14, 2), (7, 1), (24, 8), (40, 8), (12, 4)]


@pytest.fixture(autouse=True)
def _reset_flags():
    """Both registries cleared around each test: a flag left set would
    change the results of other files run on the same worker."""
    opt_flags.set_flags("")
    r_flags.set_flags("")
    yield
    opt_flags.set_flags("")
    r_flags.set_flags("")


def _set(csv):
    opt_flags.set_flags(csv)
    r_flags.set_flags(csv)


_CACHE = {}


def _setup(arch, **replace):
    """(reference cfg, port cfg, reference model, port model, numpy
    params, numpy tokens) of the reduced ``arch``."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _CACHE:
        rcfg = reduce_for_smoke(REGISTRY[arch]).replace(**replace)
        tcfg = t_reduce(T_REGISTRY[arch]).replace(**replace)
        rmodel = r_get_model(rcfg)
        np_params = jax.tree.map(np.asarray,
                                 rmodel.init(jax.random.PRNGKey(0)))
        toks = np.random.default_rng(5).integers(
            0, rcfg.vocab_size, (B, S)).astype(np.int32)
        _CACHE[key] = (rcfg, tcfg, rmodel, get_model(tcfg), np_params, toks)
    return _CACHE[key]


def _port_params(np_params, tcfg, dtype=torch.float32):
    return params_from_reference(np_params, tcfg, device="cpu", dtype=dtype)


def _forward_both(arch):
    rcfg, tcfg, rmodel, model, np_params, toks = _setup(arch)
    want = rmodel.forward(jax.tree.map(jnp.asarray, np_params),
                          {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = model.forward(_port_params(np_params, tcfg),
                            {"tokens": torch.from_numpy(toks)})
    return got, np.asarray(want, np.float32)


def _port_loss_grads(model, params, batch, remat=True):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True,
                                allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def _batch(toks):
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _grads_both(arch):
    """(port loss, port grads, reference loss, reference grads in the
    port's leaf order) of the loss under remat."""
    rcfg, tcfg, rmodel, model, np_params, toks = _setup(arch)
    loss, grads = jax.value_and_grad(
        lambda p: rmodel.loss(p, jax.tree.map(jnp.asarray, _batch(toks)),
                              remat=True)[0])(
        jax.tree.map(jnp.asarray, np_params))
    want = tree_leaves(_port_params(jax.tree.map(np.asarray, grads), tcfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(toks).items()}
    t_loss, got = _port_loss_grads(model, _port_params(np_params, tcfg),
                                   batch)
    return t_loss, got, float(loss), want


def _assert_leaves_close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().numpy(), w.float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol}*{scale}"


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
def test_unknown_flag_rejected():
    with pytest.raises(ValueError):
        opt_flags.set_flags("definitely_not_a_flag")
    with pytest.raises(ValueError):
        opt_flags.enabled("definitely_not_a_flag")


def test_flag_roundtrip():
    opt_flags.set_flags("remat_dots,bf16_logits")
    assert opt_flags.enabled("remat_dots")
    assert opt_flags.enabled("bf16_logits")
    assert not opt_flags.enabled("seq_shard_kv")
    assert opt_flags.active() == ("bf16_logits", "remat_dots")
    opt_flags.set_flags("")
    assert not opt_flags.active()


def test_registry_is_the_reference_registry():
    assert opt_flags.FLAGS == r_flags.FLAGS


@pytest.mark.parametrize("env,want", [
    ("pad_heads, bf16_logits", "('bf16_logits', 'pad_heads')"),
    ("", "()"),
    ("not_a_flag", "ValueError"),
])
def test_repro_opt_read_at_import(env, want):
    probe = ("try:\n"
             "    from repro_torch.dist import opt_flags\n"
             "    print(opt_flags.active())\n"
             "except ValueError:\n"
             "    print('ValueError')\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(SRC),
                              "REPRO_OPT": env})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


# ----------------------------------------------------------------------
# the reference's contract, inside the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-1.7b",
                                  "zamba2-2.7b"])
def test_opt_flags_preserve_forward(arch):
    rcfg, tcfg, rmodel, model, np_params, toks = _setup(arch)
    params = _port_params(np_params, tcfg)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        base = model.forward(params, batch)
        opt_flags.set_flags("local_moe_dispatch,remat_dots")
        tuned = model.forward(params, batch)
    torch.testing.assert_close(tuned, base, atol=1e-5, rtol=0)


def test_opt_flags_preserve_grads():
    rcfg, tcfg, rmodel, model, np_params, toks = _setup(
        "moonshot-v1-16b-a3b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(toks).items()}
    _, g_base = _port_loss_grads(model, _port_params(np_params, tcfg), batch)
    opt_flags.set_flags("remat_dots,local_moe_dispatch")
    _, g_opt = _port_loss_grads(model, _port_params(np_params, tcfg), batch)
    assert max(float((a - b).abs().max())
               for a, b in zip(g_base, g_opt)) < 1e-4


def test_seq_shard_kv_changes_cache_spec():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    kv_shape = (28, 128, 32768, 8, 128)
    base = state_spec(kv_shape, mesh)
    assert base[4] == "model" and base[2] is None
    opt_flags.set_flags("seq_shard_kv")
    tuned = state_spec(kv_shape, mesh)
    assert tuned[2] == "model" and tuned[4] is None
    # recurrent states (4-D) are unaffected
    assert state_spec((32, 128, 40, 64), mesh)[1] in ("data", ("data",))


def test_bf16_logits_keeps_dtype():
    rcfg, tcfg, rmodel, model, np_params, toks = _setup(
        "qwen3-1.7b", param_dtype="bfloat16", compute_dtype="bfloat16")
    params = _port_params(np_params, tcfg, torch.bfloat16)
    batch = {"tokens": torch.from_numpy(toks[:1, :8])}
    with torch.no_grad():
        opt_flags.set_flags("bf16_logits")
        out = model.forward(params, batch)
        assert out.dtype == torch.bfloat16
        opt_flags.set_flags("")
        out2 = model.forward(params, batch)
    assert out2.dtype == torch.float32
    torch.testing.assert_close(out.float(), out2, atol=2e-2, rtol=2e-2)


def _decode_after_prefill(model, params, toks):
    _, state = model.prefill(params, {"tokens": toks[:, :15]}, s_max=16)
    pos = torch.full((B,), 15, dtype=torch.int32)
    return model.decode_step(params, toks[:, 15], state, pos)


def test_masked_cache_update_decode_equivalence():
    rcfg, tcfg, rmodel, model, np_params, toks = _setup("qwen2-0.5b")
    params = _port_params(np_params, tcfg)
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        base, base_state = _decode_after_prefill(model, params, toks)
        opt_flags.set_flags("masked_cache_update")
        tuned, tuned_state = _decode_after_prefill(model, params, toks)
    assert torch.equal(base, tuned)
    assert all(torch.equal(a, b) for a, b in zip(base_state, tuned_state))


@pytest.mark.parametrize("H,KV", HEAD_CLASSES)
def test_flash_gqa_regroup_exact_over_head_configs(H, KV):
    """pad_heads is exact for every (H, KV) shape class."""
    rng = np.random.default_rng(H * 100 + KV)
    q = torch.from_numpy(rng.normal(size=(1, 32, H, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 32, KV, 16)).astype(
        np.float32)) for _ in range(2))
    base = L.flash_gqa(q, k, v, causal=True)
    opt_flags.set_flags("pad_heads")
    tuned = L.flash_gqa(q, k, v, causal=True)
    assert torch.equal(tuned, base)
    # ... and the reference's regrouping gives the same numbers
    r_flags.set_flags("pad_heads")
    want = RL.flash_gqa(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=True)
    np.testing.assert_allclose(tuned.numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)


# ----------------------------------------------------------------------
# each flag against the reference, the same flag set in both
# ----------------------------------------------------------------------
FLAG_CASES = [
    ("remat_dots", "llama32-3b"), ("remat_dots", "moonshot-v1-16b-a3b"),
    ("remat_dots", "zamba2-2.7b"),
    ("bf16_logits", "qwen3-1.7b"),
    ("pad_heads", "llama32-3b"), ("pad_heads", "deepseek-moe-16b"),
    ("pad_heads", "zamba2-2.7b"),
    ("head_shard_attn", "qwen3-1.7b"),
    ("local_moe_dispatch", "moonshot-v1-16b-a3b"),
    ("local_moe_dispatch", "deepseek-moe-16b"),
    ("masked_cache_update", "qwen2-0.5b"),
]


@pytest.mark.parametrize("flag,arch", FLAG_CASES)
def test_flag_matches_reference(flag, arch):
    _set(flag)
    got, want = _forward_both(arch)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
    t_loss, got_g, loss, want_g = _grads_both(arch)
    np.testing.assert_allclose(float(t_loss), loss, rtol=FWD_TOL)
    _assert_leaves_close(got_g, want_g, GRAD_TOL, f"{flag} {arch} grad")


def test_masked_cache_update_matches_reference_decode():
    _set("masked_cache_update")
    rcfg, tcfg, rmodel, model, np_params, toks = _setup("qwen2-0.5b")
    rp = jax.tree.map(jnp.asarray, np_params)
    jt = jnp.asarray(toks)
    _, state = rmodel.prefill(rp, {"tokens": jt[:, :15]}, s_max=16)
    want, want_state = rmodel.decode_step(rp, jt[:, 15], state,
                                          jnp.full((B,), 15, jnp.int32))
    with torch.no_grad():
        got, got_state = _decode_after_prefill(
            model, _port_params(np_params, tcfg), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)
    for g, w in zip(got_state, jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_seq_shard_kv_matches_reference():
    _set("seq_shard_kv")
    for sizes, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mesh = abstract_mesh(sizes, names)
        r_mesh = r_abstract_mesh(sizes, names)
        for shape in ((28, 128, 32768, 8, 128), (28, 128, 1000, 8, 128),
                      (32, 128, 40, 64, 64), (32, 128, 40, 64)):
            want = tuple(r_sharding.state_spec(shape, r_mesh))
            want = want + (None,) * (len(shape) - len(want))
            got = tuple(e if not isinstance(e, tuple) or len(e) != 1
                        else e[0] for e in state_spec(shape, mesh))
            assert got == want, (sizes, shape)


def _moe_configs(capacity_factor):
    rcfg = reduce_for_smoke(REGISTRY["deepseek-moe-16b"])
    tcfg = t_reduce(T_REGISTRY["deepseek-moe-16b"])
    return (rcfg.replace(moe=dataclasses.replace(
                rcfg.moe, capacity_factor=capacity_factor)),
            tcfg.replace(moe=dataclasses.replace(
                tcfg.moe, capacity_factor=capacity_factor)))


def _group_drops(rcfg, xt, router, groups):
    """Slots the reference drops, group by group."""
    T, K, E = xt.shape[0], rcfg.moe.top_k, rcfg.moe.num_experts
    C = moe.capacity(T // groups * K, rcfg, False)
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(router), -1)
    idx = np.asarray(jax.lax.top_k(probs, K)[1]).reshape(groups, -1)
    return sum(int(np.maximum(np.bincount(g, minlength=E) - C, 0).sum())
               for g in idx)


@pytest.mark.parametrize("case", ["no-drop", "drops"])
def test_local_moe_dispatch_matches_reference(case):
    """Grouped dispatch (64 tokens, 8 experts: 8 groups of 8) with the
    flag set in both: outputs and the aux loss from the summed counts;
    capacity per group binds in ``drops``."""
    rcfg, tcfg = _moe_configs({"no-drop": 8.0, "drops": 0.5}[case])
    m, d = rcfg.moe, rcfg.d_model
    rng = np.random.default_rng(11)
    E, f, fs = m.num_experts, m.d_expert, m.num_shared_experts * m.d_expert
    p = {"router": rng.normal(0, 0.3, (d, E)).astype(np.float32),
         "w_gate": rng.normal(0, 0.1, (E, d, f)).astype(np.float32),
         "w_up": rng.normal(0, 0.1, (E, d, f)).astype(np.float32),
         "w_down": rng.normal(0, 0.1, (E, f, d)).astype(np.float32),
         "shared": {"w_gate": rng.normal(0, 0.1, (d, fs)).astype(np.float32),
                    "w_up": rng.normal(0, 0.1, (d, fs)).astype(np.float32),
                    "w_down": rng.normal(0, 0.1, (fs, d)).astype(
                        np.float32)}}
    xt = rng.normal(0, 1, (64, d)).astype(np.float32)
    _set("local_moe_dispatch")
    want_y, want_aux = RMOE.moe_ffn(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(xt), rcfg)
    tp = jax.tree.map(torch.from_numpy, p)
    got_y, got_aux = moe.moe_ffn(tp, torch.from_numpy(xt), tcfg)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=FWD_TOL)
    drops = _group_drops(rcfg, xt, p["router"], 8)
    assert (drops > 0) == (case == "drops"), drops
    _set("")
    base_y, _ = moe.moe_ffn(tp, torch.from_numpy(xt), tcfg)
    if case == "no-drop":      # one group or eight: the same tokens out
        torch.testing.assert_close(got_y, base_y, atol=1e-5, rtol=0)


class _CountMM(TorchDispatchMode):
    """Counts the products with no batch dimension that run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_the_projections():
    """The backward of the checkpointed reduced llama32-3b: with the flag
    it runs only the 2 gradient products of each of a layer's 7
    projections (wq, wk, wv, wo, w_gate, w_up, w_down) and of the LM head,
    and recomputes none. Without it the recompute runs 6 of the 7: it
    stops once the last tensor the backward saved (w_down's input) is
    back, before w_down's own product. So the flag takes 6 x L ``aten.mm``
    calls out of the backward (and saves 7 outputs a layer)."""
    rcfg, tcfg, rmodel, model, np_params, toks = _setup("llama32-3b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(toks).items()}
    n_layers = tcfg.num_layers
    counts, losses = {}, {}
    for flags in ("", "remat_dots"):
        opt_flags.set_flags(flags)
        params = _port_params(np_params, tcfg)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.loss(params, batch, remat=True)
        with _CountMM() as mode:
            torch.autograd.grad(loss, leaves)
        counts[flags], losses[flags] = mode.n, float(loss.detach())
    assert counts["remat_dots"] == 2 * (7 * n_layers + 1), counts
    assert counts[""] - counts["remat_dots"] == 6 * n_layers, counts
    assert losses[""] == losses["remat_dots"]
