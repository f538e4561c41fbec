"""The port's training path against the reference, from the same weights
(the reference's init, carried over by the weight bridge) and the same
batch (``SyntheticLM``): ``Model.loss`` and the gradient of every leaf
for all six families against ``jax.value_and_grad`` of the reference's
``Model.loss`` (no mesh: the reference's own train step builds one, and
this JAX raises ``ShardingTypeError`` under it); remat on and off; and
three steps of ``build_train_step(...).fn`` against the reference's step
body under plain ``jax.jit``.

Tolerances (f32 throughout): loss 2e-4 relative; each gradient leaf
within 2e-4 of the leaf's largest magnitude (sums in another order,
through up to 2 layers and a 512-way softmax); params after three steps:
the RMS of each leaf's difference within 1e-3 of the peak learning rate
and its largest within 0.1 of it. An Adam step moves each element by
about lr whatever its gradient's size (m / sqrt(v)): where a gradient
is within its error (~1e-6 of the leaf's largest) of 0, its step may
take either sign, so the error is a share of lr, not of the param.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train.data import SyntheticLM  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.dist.sharding import (param_shardings,  # noqa: E402
                                       replicated)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve.steps import (build_decode_step,  # noqa: E402
                                      build_prefill_step, build_train_step)
from repro_torch.train import optimizer as topt  # noqa: E402

ARCHS = ["llama32-3b", "deepseek-moe-16b", "rwkv6-3b", "zamba2-2.7b",
         "internvl2-2b", "seamless-m4t-medium"]
LOSS_TOL = 2e-4
LEAF_TOL = 2e-4
PEAK_LR = 1e-2
B, S = 2, 32

_CACHE = {}


def _setup(arch):
    if arch not in _CACHE:
        cfg = reduce_for_smoke(REGISTRY[arch])
        rmodel = r_get_model(cfg)
        np_params = jax.tree.map(np.asarray,
                                 rmodel.init(jax.random.PRNGKey(0)))
        tcfg = t_reduce(T_REGISTRY[arch])
        batch = SyntheticLM(cfg, B, S, seed=3).next_batch()
        _CACHE[arch] = (cfg, tcfg, rmodel, np_params, batch)
    return _CACHE[arch]


def _port_params(np_params, tcfg):
    return params_from_reference(np_params, tcfg, device="cpu",
                                 dtype=torch.float32)


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_value_and_grad(rmodel, np_params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: rmodel.loss(p, b), has_aux=True))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, np_params),
                                jax.tree.map(jnp.asarray, batch))
    return loss, metrics, jax.tree.map(np.asarray, grads)


def _port_value_and_grad(model, params, batch, remat=True):
    leaves = topt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True,
                                allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _leaf_pairs(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().float().numpy(), w.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        yield i, g, w


def _assert_leaves_close(got, want, tol, what):
    """Each leaf within ``tol`` of its largest magnitude."""
    for i, g, w in _leaf_pairs(got, want, what):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, tcfg, rmodel, np_params, batch = _setup(arch)
    loss, metrics, grads = _ref_value_and_grad(rmodel, np_params, batch)
    model = get_model(tcfg)
    t_loss, t_metrics, t_grads = _port_value_and_grad(
        model, _port_params(np_params, tcfg), _port_batch(batch))
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=LOSS_TOL)
    assert sorted(t_metrics) == sorted(metrics)
    for key in metrics:          # MoE: aux_loss and ce
        np.testing.assert_allclose(float(t_metrics[key]),
                                   float(metrics[key]), rtol=LOSS_TOL,
                                   atol=1e-7)
    # the reference's grads, in the port's layout and leaf order
    want = topt.tree_leaves(params_from_reference(grads, tcfg, device="cpu",
                                                  dtype=torch.float32))
    _assert_leaves_close(t_grads, want, LEAF_TOL, f"{arch} grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_numbers(arch):
    _, tcfg, _, np_params, batch = _setup(arch)
    model = get_model(tcfg)
    a = _port_value_and_grad(model, _port_params(np_params, tcfg),
                             _port_batch(batch), remat=True)
    b = _port_value_and_grad(model, _port_params(np_params, tcfg),
                             _port_batch(batch), remat=False)
    assert float(a[0]) == float(b[0])
    _assert_leaves_close(a[2], b[2], 1e-6, f"{arch} remat grad")


@pytest.mark.parametrize("arch", ["llama32-3b", "deepseek-moe-16b"])
def test_train_step_matches_reference(arch):
    """Three steps of the port's train step (in place) against the
    reference's step body (serve/steps.py) under plain jax.jit."""
    cfg, tcfg, rmodel, np_params, _ = _setup(arch)
    r_opt = ropt.adamw(ropt.cosine_schedule(PEAK_LR, 1, 3))
    t_opt = topt.adamw(topt.cosine_schedule(PEAK_LR, 1, 3))

    @jax.jit
    def ref_step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: rmodel.loss(p, batch, remat=True), has_aux=True)(
                params)
        updates, new_opt = r_opt.update(grads, opt_state, params)
        return ropt.apply_updates(params, updates), new_opt, loss

    mesh = make_host_mesh(device_type="cpu")         # (1, 1), no group
    bundle = build_train_step(tcfg, mesh, InputShape("t", S, B, "train"),
                              optimizer=t_opt)
    assert tuple(mesh.shape) == (1, 1)
    assert bundle.shardings[0] == param_shardings(
        tcfg, bundle.model.abstract_params(), mesh)
    assert bundle.shardings[1].count == replicated(mesh)
    rp = jax.tree.map(jnp.asarray, np_params)
    rs = r_opt.init(rp)
    tp = _port_params(np_params, tcfg)
    ts = t_opt.init(tp)
    data = SyntheticLM(cfg, B, S, seed=5)
    for _ in range(3):
        batch = data.next_batch()
        rp, rs, loss = ref_step(rp, rs, jax.tree.map(jnp.asarray, batch))
        tp2, ts, t_loss = bundle.fn(tp, ts, batch)
        assert tp2 is tp                      # updated in place
        np.testing.assert_allclose(float(t_loss), float(loss),
                                   rtol=LOSS_TOL)
    assert int(ts.count) == int(rs.count) == 3
    want = topt.tree_leaves(params_from_reference(
        jax.tree.map(np.asarray, rp), tcfg, device="cpu",
        dtype=torch.float32))
    for i, g, w in _leaf_pairs(topt.tree_leaves(tp), want, arch):
        rms = float(np.sqrt(np.mean(np.square(g - w))))
        assert rms <= 1e-3 * PEAK_LR, (arch, i, rms)
        assert float(np.abs(g - w).max()) <= 0.1 * PEAK_LR, (arch, i)


def test_abstract_inputs_are_meta():
    model = get_model(T_REGISTRY["llama32-3b"])
    params = model.abstract_params()
    assert all(x.device.type == "meta" for x in topt.tree_leaves(params))
    assert 3.1e9 < model.param_count() < 3.3e9
    shape = InputShape("t", 1024, 2, "train")
    assert model.train_inputs(shape)["tokens"].dtype == torch.int32
    dec = model.decode_inputs(shape)
    assert dec["state"].k.shape == (28, 2, 1024, 8, 128)
    assert dec["state"].k.device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_match_reference(arch):
    """train/prefill/decode stand-ins: the reference's shapes and dtypes,
    as meta tensors."""
    from repro.configs.shapes import InputShape as RShape
    cfg, tcfg, rmodel, _, _ = _setup(arch)
    model = get_model(tcfg)
    for kind in ("train_inputs", "prefill_inputs", "decode_inputs"):
        want = getattr(rmodel, kind)(RShape("t", 64, 2, "train"))
        got = getattr(model, kind)(InputShape("t", 64, 2, "train"))
        assert sorted(want) == sorted(got), kind
        for key in want:
            w, g = jax.tree.leaves(want[key]), topt.tree_leaves(got[key])
            assert len(w) == len(g), (kind, key)
            for a, b in zip(w, g):
                assert tuple(a.shape) == tuple(b.shape), (kind, key)
                assert str(b.dtype).split(".")[-1] == str(a.dtype), \
                    (kind, key)
                assert b.device.type == "meta"


def test_prefill_and_decode_steps_match_reference():
    """build_prefill_step / build_decode_step run the model without grad
    (params that require grad give outputs that do not) and match the
    reference's prefill and decode_step."""
    cfg, tcfg, rmodel, np_params, _ = _setup("llama32-3b")
    shape = InputShape("t", 24, 2, "prefill")
    mesh = make_host_mesh(device_type="cpu")
    prefill = build_prefill_step(tcfg, mesh, shape)
    decode = build_decode_step(tcfg, mesh, shape)
    assert len(decode.abstract_args) == 4
    params = _port_params(np_params, tcfg)
    for p in topt.tree_leaves(params):
        p.requires_grad_(True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    logits, cache = prefill.fn(params, {"tokens": toks.astype(np.int32)})
    nxt = torch.tensor([3, 5])
    pos = torch.tensor([16, 16], dtype=torch.int32)
    step_logits, _ = decode.fn(params, nxt, cache, pos)
    assert not logits.requires_grad and not step_logits.requires_grad
    rp = jax.tree.map(jnp.asarray, np_params)
    want, rcache = rmodel.prefill(rp, {"tokens": jnp.asarray(toks)},
                                  s_max=24)
    want_step, _ = rmodel.decode_step(rp, jnp.asarray(nxt.numpy()), rcache,
                                      jnp.asarray(pos.numpy()))
    for got, ref in ((logits, want), (cache.k, rcache.k),
                     (step_logits, want_step)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
