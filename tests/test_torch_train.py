"""The port's training substrate against the reference: AdamW (updates,
moments, count, clipping, f32 and bf16 trees), the cosine schedule,
``global_norm``, and ``SyntheticLM``'s batches and cursor.

Tolerances: f32 updates and moments 1e-6 relative, to the element or to
the leaf's largest magnitude (one f32 rounding of ``b ** count`` and of
the norm's sums apart); bf16 params after the update
within one bf16 ulp (the f32 update is the same to 1e-6; its cast to
bf16 and the bf16 add may round to the neighbour).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY, reduce_for_smoke  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro.train.data import SyntheticLM as RefLM  # noqa: E402
from repro_torch.configs import REGISTRY as T_REGISTRY  # noqa: E402
from repro_torch.configs import reduce_for_smoke as t_reduce  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.data import SyntheticLM  # noqa: E402

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}, "e": [(6,), (1, 3)]}


def _np_tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _np_tree(v, rng, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_np_tree(v, rng, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), tree)


def _torch(tree, dtype=torch.float32):
    return topt.tree_map(lambda x: torch.from_numpy(x).to(dtype), tree)


def _leaves_np(tree):
    return [np.asarray(x.float() if torch.is_tensor(x) else
                       jnp.asarray(x, jnp.float32))
            for x in (topt.tree_leaves(tree) if _is_torch(tree)
                      else jax.tree.leaves(tree))]


def _is_torch(tree):
    return torch.is_tensor(topt.tree_leaves(tree)[0])


def _close(port, ref, rtol=1e-6):
    """Within ``rtol`` of each element or of the leaf's largest
    magnitude: an update of ~lr where the weight decay nearly cancels the
    Adam step has no relative precision of its own."""
    for p, r in zip(_leaves_np(port), _leaves_np(ref)):
        np.testing.assert_allclose(p, r, rtol=rtol,
                                   atol=rtol * np.abs(r).max())


def _bits(x):
    """bf16 leaves as int16 bit patterns."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().astype(np.int64)
    return np.asarray(x).view(np.int16).astype(np.int64)


@pytest.mark.parametrize("clip,grad_scale", [(None, 1.0), (1.0, 1.0),
                                             (1.0, 1e3)])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_f32_matches_reference(clip, grad_scale, schedule):
    """Three updates of an f32 tree: updates, m, v and count."""
    rng = np.random.default_rng(0)
    params = _np_tree(SHAPES, rng)
    lr_r = ropt.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    lr_t = topt.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    r_opt = ropt.adamw(lr_r, grad_clip_norm=clip)
    t_opt = topt.adamw(lr_t, grad_clip_norm=clip)
    rp, tp = _jax(params), _torch(params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    for _ in range(3):
        g = _np_tree(SHAPES, rng, grad_scale)
        ru, rs = r_opt.update(_jax(g), rs, rp)
        tu, ts = t_opt.update(_torch(g), ts, tp)
        _close(tu, ru)
        _close(ts.m, rs.m)
        _close(ts.v, rs.v)
        assert int(ts.count) == int(rs.count)
        assert ts.count.dtype == torch.int32
        rp, tp = ropt.apply_updates(rp, ru), topt.apply_updates(tp, tu)
        _close(tp, rp)


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_bf16_within_one_ulp(clip):
    """bf16 params, f32 moments; the in-place step (the train step's)
    and the functional one give the same bits; both within one bf16 ulp
    of the reference's params after three steps."""
    rng = np.random.default_rng(1)
    params = _np_tree(SHAPES, rng)
    r_opt = ropt.adamw(1e-2, grad_clip_norm=clip)
    t_opt = topt.adamw(1e-2, grad_clip_norm=clip)
    rp = _jax(params, jnp.bfloat16)
    tp = _torch(params, torch.bfloat16)
    tp_inplace = topt.tree_map(torch.clone, tp)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    ts_inplace = t_opt.init(tp_inplace)
    assert all(m.dtype == torch.float32 for m in topt.tree_leaves(ts.m))
    for _ in range(3):
        g = _np_tree(SHAPES, rng)
        ru, rs = r_opt.update(_jax(g, jnp.bfloat16), rs, rp)
        rp = ropt.apply_updates(rp, ru)
        tu, ts = t_opt.update(_torch(g, torch.bfloat16), ts, tp)
        tp = topt.apply_updates(tp, tu)
        grads = topt.tree_leaves(_torch(g, torch.bfloat16))
        ts_inplace = t_opt.update_(grads, ts_inplace, tp_inplace)
        assert all(x is None for x in grads)
    for a, b, r in zip(topt.tree_leaves(tp), topt.tree_leaves(tp_inplace),
                       jax.tree.leaves(rp)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert np.abs(_bits(a) - _bits(r)).max() <= 1
    _close(ts.m, rs.m, rtol=1e-5)
    _close(ts_inplace.v, rs.v, rtol=1e-5)


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100])
def test_cosine_schedule_matches_reference(step):
    r = ropt.cosine_schedule(1.0, warmup_steps=10, total_steps=100,
                             final_frac=0.1)
    t = topt.cosine_schedule(1.0, warmup_steps=10, total_steps=100,
                             final_frac=0.1)
    want = float(r(jnp.asarray(step)))
    got = float(t(torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert {0: 0.0, 5: 0.5, 10: 1.0, 100: 0.1}.get(step, got) == \
        pytest.approx(got, abs=1e-6)


def test_global_norm_and_leaf_order():
    t = {"b": torch.tensor([4.0]), "a": torch.tensor([3.0])}
    assert float(topt.global_norm(t)) == pytest.approx(5.0)
    rng = np.random.default_rng(2)
    tree = _np_tree(SHAPES, rng)
    # the reference's leaf order: dict keys sorted, lists in order
    for a, b in zip(topt.tree_leaves(_torch(tree)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(float(topt.global_norm(_torch(tree))),
                               float(ropt.global_norm(_jax(tree))),
                               rtol=1e-6)


def test_moments_are_f32_under_bf16_params():
    opt = topt.adamw(1e-3)
    state = opt.init({"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert state.m["w"].dtype == torch.float32
    assert state.v["w"].dtype == torch.float32
    assert state.count.dtype == torch.int32 and int(state.count) == 0


def test_adamw_minimizes_quadratic():
    """The reference's analytic case: d/dp ||p||^2 = 2p drives p to 0."""
    opt = topt.adamw(0.1, weight_decay=0.0, grad_clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = [2 * p for p in topt.tree_leaves(params)]
        state = opt.update_(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_bounds_update():
    opt = topt.adamw(1.0, grad_clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    updates, _ = opt.update({"w": torch.full((4,), 1e9)}, opt.init(params),
                            params)
    assert torch.isfinite(updates["w"]).all()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama32-3b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_batches_byte_identical(arch):
    cfg = reduce_for_smoke(REGISTRY[arch])
    ref, port = RefLM(cfg, 2, 32, seed=7), \
        SyntheticLM(t_reduce(T_REGISTRY[arch]), 2, 32, seed=7)
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        assert sorted(want) == sorted(got)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes()
    assert port.cursor.as_dict() == ref.cursor.as_dict()


def test_cursor_resume():
    cfg = t_reduce(T_REGISTRY["llama32-3b"])
    a = SyntheticLM(cfg, 4, 32, seed=7)
    stream = [a.next_batch() for _ in range(5)]
    b = SyntheticLM(cfg, 4, 32, seed=7)
    for _ in range(3):
        b.next_batch()
    c = SyntheticLM(cfg, 4, 32, seed=7)
    c.restore(b.cursor.as_dict())
    np.testing.assert_array_equal(c.next_batch()["tokens"],
                                  stream[3]["tokens"])
    np.testing.assert_array_equal(c.next_batch()["targets"],
                                  stream[4]["targets"])
