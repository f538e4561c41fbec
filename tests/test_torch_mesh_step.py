"""The step builders on a mesh of many devices: reduced llama32-3b's
train, prefill and decode steps in a 4-rank gloo group on the CPU, on a
(2, 2) ``DeviceMesh`` (data, model), against the same steps on the
one-device mesh.

The reduced config has 4 query and 2 kv heads, which divide the model
axis of 2, so attention runs head-sharded there and batch-sharded over
data, and the projections are tensor-parallel: the DTensor step sums
partial products across ranks where the one-device step sums them in one
product. So the numbers agree to f32 rounding of a reordered sum, not
bit for bit. The gradient is compared itself: one step with no clipping,
whose first moment is (1 - b1) g, each leaf's g divided by its largest
|g| on the one-device mesh, within ``GRAD_ATOL`` = 1e-5 (measured on the
CPU: 6.0e-7, five f32 ulps of the leaf's scale), so a gradient summed
where it should be averaged, or reduced twice, fails by a factor of 2
or more. Losses, logits and caches are held within ``RTOL`` = ``ATOL``
= 1e-5 (measured: at most 4.8e-7), and the params after two clipped
AdamW steps within ``PARAMS_ATOL`` (below).
Each rank runs in a spawned process under a time limit.
"""
import json
import multiprocessing
import socket

import pytest

torch = pytest.importorskip("torch")

WORLD = 4
TIMEOUT_S = 300
RTOL = ATOL = 1e-5
# AdamW's update is lr * m / (sqrt(v) + eps): where a grad is near eps,
# a reordered sum moves the update by a share of lr = 1e-3 that the
# grad's own rounding does not bound. Measured on the CPU after two
# steps: 8.7e-6, held to about twice that
PARAMS_ATOL = 2e-5
B1 = 0.9
GRAD_ATOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _pairs(tree, shardings):
    """(leaf, placements) over a tree and its placements tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, shardings) for x in _pairs(t, s)]
    return [(tree, shardings)]


def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.configs.shapes import InputShape
    from repro_torch.dist.sharding import abstract_mesh
    from repro_torch.serve.steps import build_step
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw, tree_leaves

    torch.set_num_threads(1)     # tiny shapes: no intra-op threads
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        cfg = reduce_for_smoke(get_config("llama32-3b"))
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        one = abstract_mesh((1, 1), ("data", "model"), "cpu")
        B, S = 4, 32
        res = {"max_err": {}, "close": {}, "placements_ok": True,
               "dtensor": True}

        def compare(name, a, b, atol=ATOL):
            a, b = _full(a), _full(b)
            res["max_err"][name] = max(
                res["max_err"].get(name, 0.0),
                float((a.float() - b.float()).abs().max()))
            res["close"][name] = res["close"].get(name, True) and bool(
                a.shape == b.shape and a.dtype == b.dtype
                and torch.allclose(a, b, rtol=RTOL, atol=atol))

        # --- the gradient: one step with no clipping, whose first moment
        # is (1 - b1) g exactly
        shape = InputShape("t", S, B, "train")
        grads = {}
        for name, m in (("one", one), ("mesh", mesh)):
            opt = adamw(1e-3, b1=B1, grad_clip_norm=None)
            bundle = build_step("train", cfg, m, shape, optimizer=opt)
            params = bundle.model.init(torch.Generator().manual_seed(0),
                                       "cpu")
            _, state, _ = bundle.fn(params, opt.init(params),
                                    SyntheticLM(cfg, B, S).next_batch())
            grads[name] = [_full(x) / (1 - B1) for x in tree_leaves(state.m)]
        for a, b in zip(grads["mesh"], grads["one"]):
            top = b.abs().max()
            compare("grads", a / top, b / top, GRAD_ATOL)

        # --- train: two steps from the same seeded params and batches --
        out = {}
        for name, m in (("one", one), ("mesh", mesh)):
            opt = adamw(1e-3)
            bundle = build_step("train", cfg, m, shape, optimizer=opt)
            params = bundle.model.init(torch.Generator().manual_seed(0),
                                       "cpu")
            state, data, losses = opt.init(params), SyntheticLM(cfg, B, S), []
            for _ in range(2):
                params, state, loss = bundle.fn(params, state,
                                                data.next_batch())
                losses.append(loss)
            out[name] = (losses, params, state, bundle)
        for a, b in zip(out["mesh"][0], out["one"][0]):
            compare("loss", a, b)
        for a, b in zip(tree_leaves(out["mesh"][1]),
                        tree_leaves(out["one"][1])):
            compare("params", a, b, PARAMS_ATOL)
        _, params, state, bundle = out["mesh"]
        res["dtensor"] &= all(isinstance(p, DTensor)
                              for p in tree_leaves(params))
        res["placements_ok"] &= all(
            tuple(p.placements) == pl
            for p, pl in _pairs(params, bundle.shardings[0]))

        # --- prefill's logits and cache, then one decode step ----------
        params = out["one"][1]
        tokens = SyntheticLM(cfg, B, S).next_batch()["tokens"]
        pre = {}
        for name, m in (("one", one), ("mesh", mesh)):
            bundle = build_step("prefill", cfg, m, InputShape("p", S, B,
                                                              "prefill"))
            pre[name] = bundle.fn(params, {"tokens": tokens})
        compare("prefill_logits", pre["mesh"][0], pre["one"][0])
        for a, b in zip(pre["mesh"][1], pre["one"][1]):
            compare("prefill_cache", a, b)
        dec = {}
        nxt = torch.argmax(_full(pre["one"][0]), -1).to(torch.int32)
        pos = torch.full((B,), S - 1, dtype=torch.int32)
        for name, m in (("one", one), ("mesh", mesh)):
            bundle = build_step("decode", cfg, m, InputShape("d", S, B,
                                                             "decode"))
            state = pre["one"][1]
            dec[name] = bundle.fn(params, nxt, state, pos)
            if name == "mesh":
                res["placements_ok"] &= all(
                    tuple(t.placements) == pl for t, pl in zip(
                        dec[name][1], bundle.shardings[2]))
        compare("decode_logits", dec["mesh"][0], dec["one"][0])
        for a, b in zip(dec["mesh"][1], dec["one"][1]):
            compare("decode_cache", a, b)
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    tmp = tmp_path_factory.mktemp("mesh_step")
    paths = [str(tmp / f"rank{r}.json") for r in range(WORLD)]
    procs = [ctx.Process(target=_worker, args=(r, port, paths[r]))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    out = []
    for path in paths:
        with open(path) as f:
            out.append(json.load(f))
    return out


def test_mesh_steps_match_one_device(results):
    """Two train steps, prefill and one decode step on the (2, 2) mesh
    give the one-device mesh's losses, params, logits and caches within
    the f32 tolerance above, on every rank."""
    for r in results:
        assert set(r["close"]) == {"grads", "loss", "params",
                                   "prefill_logits",
                                   "prefill_cache", "decode_logits",
                                   "decode_cache"}
        assert all(r["close"].values()), r["max_err"]


def test_mesh_steps_return_dtensors_in_the_bundles_placements(results):
    """The trained params are DTensors in the bundle's param placements,
    and the decode state comes back in the bundle's state placements."""
    for r in results:
        assert r["dtensor"] and r["placements_ok"]
