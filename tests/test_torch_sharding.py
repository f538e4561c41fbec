"""The port's placement layer (``repro_torch.dist.sharding``,
``repro_torch.launch.mesh``) against the reference's rules.

Every parameter of every assigned arch, on the 16x16 and 2x16x16
production meshes (abstract: no process group), gets the reference's spec
of its stacked leaf without the leading [L] entry; every spec divides and
every leaf of at least 8 M elements is sharded. ``batch_spec``,
``state_spec`` (with and without ``seq_shard_kv``) and the moments' ZeRO
rule equal the reference's over a grid of shapes. Specs are compared
normalised: a 1-tuple of axis names is its name, and a spec is padded
with None to the leaf's rank.

Under the fake process group (256 or 512 ranks, or a world of one, torn
down after each test) ``make_production_mesh`` and ``make_host_mesh``
give ``DeviceMesh``es, and the placements shard the local shapes as the
specs say. A step built on a ``DeviceMesh`` of more than one device runs
on fake DTensors and gives its outputs in the bundle's placements; on an
abstract mesh of many devices it raises; on a ``DeviceMesh`` of one
device it runs, bit for bit as on the abstract one-device mesh.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    compute_local_shape_and_global_offset)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.compat import abstract_mesh as r_abstract_mesh  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as r_get_config  # noqa: E402
from repro.dist import opt_flags as r_flags  # noqa: E402
from repro.dist import sharding as RS  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.dist import opt_flags  # noqa: E402
from repro_torch.dist import sharding as TS  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve.steps import build_step  # noqa: E402
from repro_torch.train.data import SyntheticLM  # noqa: E402
from repro_torch.train.optimizer import adamw, tree_leaves  # noqa: E402

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
PRODUCTION = ["1pod", "2pod"]


@pytest.fixture(autouse=True)
def _reset():
    """Flags cleared in both registries, and no process group left
    behind, around each test."""
    opt_flags.set_flags("")
    r_flags.set_flags("")
    yield
    opt_flags.set_flags("")
    r_flags.set_flags("")
    if dist.is_initialized():
        dist.destroy_process_group()


def _meshes(name):
    sizes, names = MESHES[name]
    return TS.abstract_mesh(sizes, names), r_abstract_mesh(sizes, names)


def _norm(spec, rank):
    """A spec as a tuple of rank entries, 1-tuples as bare names."""
    out = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                for e in tuple(spec))
    assert len(out) <= rank, (spec, rank)
    return out + (None,) * (rank - len(out))


def _path_str(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                    for p in path)


def _port_leaves(tree):
    """(path, leaf) of the port's tree, in order."""
    out = []
    TS._map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _zip_leaves(like, tree):
    """The entries of ``tree`` at the leaves of ``like`` (a placements
    tree is walked by its params tree: its leaves are tuples)."""
    if isinstance(like, dict):
        return [x for k in like for x in _zip_leaves(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for a, b in zip(like, tree) for x in _zip_leaves(a, b)]
    return [tree]


def _stacked(path):
    """The reference's path of a port leaf, and whether the reference
    stacks it on a leading [L] axis."""
    parts = path.split("/")
    kept = [p for p in parts if not p.isdigit()]
    return "/".join(kept), len(kept) != len(parts)


_REF = {}


def _reference_leaves(arch):
    if arch not in _REF:
        flat = jax.tree_util.tree_flatten_with_path(
            r_get_model(r_get_config(arch)).abstract_params())[0]
        _REF[arch] = {_path_str(p): tuple(leaf.shape) for p, leaf in flat}
    return _REF[arch]


def _divides(spec, shape, sizes):
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        if shape[d] % int(np.prod([sizes[n] for n in names])):
            return False
    return True


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_param_specs_match_reference(arch, mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    ref = _reference_leaves(arch)
    seen, n_sharded = set(), 0
    for path, leaf in _port_leaves(get_model(cfg).abstract_params()):
        shape = tuple(leaf.shape)
        r_path, stacked = _stacked(path)
        r_shape = ref[r_path]
        assert r_shape == ((r_shape[0],) + shape if stacked else shape), path
        want = _norm(RS.param_spec(r_path, r_shape, r_mesh, r_cfg),
                     len(r_shape))
        got = _norm(TS.param_spec(path, shape, mesh, cfg), len(shape))
        assert got == (want[1:] if stacked else want), (path, got, want)
        assert _divides(got, shape, sizes), (path, got)
        if any(e is not None for e in got):
            n_sharded += 1
        elif int(np.prod(shape)) >= 8_000_000:
            raise AssertionError(f"{arch}: large param {path} {shape} "
                                 f"replicated")
        seen.add(r_path)
    assert seen == set(ref), sorted(set(ref) - seen)
    assert n_sharded > 0


def test_moe_experts_expert_parallel():
    mesh, _ = _meshes("1pod")
    cfg = get_config("deepseek-moe-16b")
    spec = TS.param_spec("moe_layers/5/ffn/w_gate", (64, 2048, 1408), mesh,
                         cfg)
    assert spec[0] == "model"     # E: dim 0 here, dim 1 in the reference


def test_embedding_vocab_parallel_when_divisible():
    mesh, _ = _meshes("1pod")
    spec = TS.param_spec("embed/embedding", (64000, 7168), mesh,
                         get_config("yi-34b"))
    assert spec[0] == "model"
    spec2 = TS.param_spec("embed/embedding", (92553, 2048), mesh,
                          get_config("internvl2-2b"))
    assert spec2[0] is None and spec2[1] == "model"


def test_norms_replicated():
    mesh, _ = _meshes("1pod")
    assert TS.param_spec("layers/7/norm_attn", (7168,), mesh,
                         get_config("yi-34b")) == (None,)


BATCH_SHAPES = [(256, 4096), (1, 524288), (32, 4096), (512, 7), (48, 10),
                (16, 3), (2,), (), (8, 128, 64)]
STATE_SHAPES = [(28, 128, 32768, 8, 128), (28, 1, 524288, 8, 128),
                (28, 16, 1024, 4, 80), (28, 32, 1000, 8, 128),
                (32, 128, 40, 64, 64), (32, 128, 40, 64), (54, 2, 80, 64, 64),
                (12, 48, 7, 3), (4, 5), (7,)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    for shape in BATCH_SHAPES:
        assert _norm(TS.batch_spec(shape, mesh), len(shape)) == \
            _norm(RS.batch_spec(shape, r_mesh), len(shape)), shape
    # the reference test's cases
    if mesh_name == "1pod":
        assert TS.batch_spec((256, 4096), mesh) == (("data",), None)
        assert TS.batch_spec((1, 524288), mesh) == (None, None)
    if mesh_name == "2pod":
        assert TS.batch_spec((256, 4096), mesh) == (("pod", "data"), None)


@pytest.mark.parametrize("flags", ["", "seq_shard_kv"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_state_spec_matches_reference(mesh_name, flags):
    mesh, r_mesh = _meshes(mesh_name)
    opt_flags.set_flags(flags)
    r_flags.set_flags(flags)
    for shape in STATE_SHAPES:
        assert _norm(TS.state_spec(shape, mesh), len(shape)) == \
            _norm(RS.state_spec(shape, r_mesh), len(shape)), shape
    if mesh_name == "1pod" and not flags:    # the reference test's cases
        s = TS.state_spec((28, 128, 32768, 8, 128), mesh)
        assert s[1] in ("data", ("data",)) and s[4] == "model"
        s2 = TS.state_spec((32, 128, 40, 64, 64), mesh)
        assert s2[1] in ("data", ("data",)) and s2[4] == "model"


MOMENT_SHAPES = [(3072, 3072), (3072, 1024), (8192, 3072), (128256, 3072),
                 (64, 2048, 1408), (27, 64, 2048, 1408), (92553, 2048),
                 (3072,), (1, 4096), (7, 5), (32, 2560)]


def _candidate_specs(shape):
    """Fully replicated, and 'model' on each dim in turn."""
    yield (None,) * len(shape)
    for d in range(len(shape)):
        spec = [None] * len(shape)
        spec[d] = "model"
        yield tuple(spec)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_moment_specs_match_reference(mesh_name):
    mesh, r_mesh = _meshes(mesh_name)
    for shape in MOMENT_SHAPES:
        for spec in _candidate_specs(shape):
            want = RS.opt_state_shardings(
                NamedSharding(r_mesh, P(*spec)),
                jax.ShapeDtypeStruct(shape, jnp.float32), r_mesh).spec
            got = TS.moment_spec(spec, shape, mesh)
            assert _norm(got, len(shape)) == _norm(want, len(shape)), \
                (shape, spec)


def test_placements_of_specs():
    mesh, _ = _meshes("2pod")
    assert TS.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements((None, ("data",)), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert TS.replicated(mesh) == (Replicate(),) * 3


def _fake_world(n):
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
def test_production_mesh_under_fake_group(multi_pod):
    name = "2pod" if multi_pod else "1pod"
    sizes, names = MESHES[name]
    _fake_world(int(np.prod(sizes)))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.shape) == sizes and mesh.mesh_dim_names == names
    cfg = get_config("llama32-3b")
    params = get_model(cfg).abstract_params()
    got = TS.param_shardings(cfg, params, mesh)
    assert got == TS.param_shardings(cfg, params, TS.abstract_mesh(sizes,
                                                                   names))
    # each placement shards the local shape as its spec says (rank 0)
    for (path, leaf), pl in zip(_port_leaves(params),
                                _zip_leaves(params, got)):
        spec = TS.param_spec(path, tuple(leaf.shape), mesh, cfg)
        local, _ = compute_local_shape_and_global_offset(
            tuple(leaf.shape), mesh, pl)
        want = tuple(n // (16 if e == "model" else 1)
                     for n, e in zip(leaf.shape, spec))
        assert tuple(local) == want, path


def test_host_mesh():
    assert tuple(make_host_mesh(device_type="cpu").shape) == (1, 1)
    with pytest.raises(ValueError):
        make_host_mesh(model_axis=2, device_type="cpu")
    _fake_world(1)
    mesh = make_host_mesh(device_type="cpu")
    assert isinstance(mesh, dist.device_mesh.DeviceMesh)
    assert tuple(mesh.shape) == (1, 1)


def _placed(tree, shardings):
    """(leaf, placements) over a tree and its placements tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _placed(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, shardings) for x in _placed(t, s)]
    return [(tree, shardings)]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mesh_name", ["1pod", "4x2"])
def test_step_on_many_devices_traces(kind, mesh_name):
    """Under the fake process group, on fake DTensors (the dry run's
    ``trace_step``), each step on a mesh of many devices runs and gives
    outputs of the global shapes in the placements its bundle names:
    the trained params and moments in theirs, the decode state in the
    decode step's state layout (prefill's too), logits and loss whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import trace_step
    sizes, names = MESHES[mesh_name]
    _fake_world(int(np.prod(sizes)))
    mesh = init_device_mesh("cpu", sizes, mesh_dim_names=names)
    cfg = reduce_for_smoke(get_config("llama32-3b"))
    B, S = 16, 32
    run = trace_step(cfg, InputShape("t", S, B, kind), mesh)
    bundle, out = run["bundle"], run["outputs"]
    assert run["counts"].flops > 0 and run["counts"].bytes > 0
    if kind == "train":
        params, opt_state, loss = out
        pairs = (_placed(params, bundle.shardings[0])
                 + _placed(opt_state.m, bundle.shardings[1].m))
        assert tuple(loss.shape) == () and loss.placements == \
            TS.replicated(mesh)
    else:
        logits, state = out
        assert tuple(logits.shape) == (B, cfg.vocab_size)
        assert not any(p.is_partial() for p in logits.placements)
        assert tuple(state.k.shape) == (cfg.num_layers, B, S,
                                        cfg.num_kv_heads, cfg.head_dim)
        pairs = _placed(state, bundle.shardings[2] if kind == "decode"
                        else TS.state_shardings(state, mesh))
    assert len(pairs) > 0
    for t, pl in pairs:
        assert isinstance(t, DTensor) and tuple(t.placements) == pl


def test_step_on_an_abstract_mesh_of_many_devices_raises():
    """An ``AbstractMesh`` has no devices: its bundle serves placement
    only, and its step raises when called."""
    mesh, _ = _meshes("4x2")
    cfg = reduce_for_smoke(get_config("llama32-3b"))
    bundle = build_step("prefill", cfg, mesh,
                        InputShape("t", 32, 16, "prefill"))
    with pytest.raises(ValueError, match="DeviceMesh"):
        bundle.fn(*bundle.abstract_args)


def test_step_on_a_one_device_device_mesh():
    """The train step on a DeviceMesh of one CPU device (a world of one)
    gives the abstract one-device mesh's numbers bit for bit."""
    cfg = reduce_for_smoke(get_config("llama32-3b"))
    shape = InputShape("t", 32, 2, "train")
    losses = {}
    for world in (False, True):
        if world:
            _fake_world(1)
        mesh = make_host_mesh(device_type="cpu")
        opt = adamw(1e-3)
        bundle = build_step("train", cfg, mesh, shape, optimizer=opt)
        params = bundle.model.init(torch.Generator().manual_seed(0), "cpu")
        state, data, out = opt.init(params), SyntheticLM(cfg, 2, 32), []
        for _ in range(2):
            params, state, loss = bundle.fn(params, state, data.next_batch())
            out.append(float(loss))
        losses[world] = (out, tree_leaves(params))
    assert losses[True][0] == losses[False][0]
    assert all(torch.equal(a, b) for a, b in zip(losses[True][1],
                                                 losses[False][1]))


@pytest.mark.parametrize("arch", ["llama32-3b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_decode_state_shardings_follow_state_spec(arch):
    mesh, _ = _meshes("1pod")
    cfg = get_config(arch)
    bundle = build_step("decode", cfg, mesh, InputShape("t", 1024, 32,
                                                        "decode"))
    state, s_sh = bundle.abstract_args[2], bundle.shardings[2]
    leaves = [leaf for _, leaf in _port_leaves(state)]
    placed = _zip_leaves(state, s_sh)
    assert len(placed) == len(leaves) > 0
    for leaf, pl in zip(leaves, placed):
        assert pl == TS.placements(TS.state_spec(tuple(leaf.shape), mesh),
                                   mesh)
    # 32 tokens and positions shard over 'data'
    assert bundle.shardings[1] == bundle.shardings[3] == (Shard(0),
                                                           Replicate())
