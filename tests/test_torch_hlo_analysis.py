"""The port's roofline layer (``repro_torch.dist.hlo_analysis``) and the
kernels' operators against the reference.

The framework-free parts (``collective_stats`` on the reference test's
HLO strings, ``linear_extrapolate``, ``RooflineTerms``, ``model_flops``,
``vmem_resident_traffic``, ``structural_memory_floor``) equal
``repro.dist.hlo_analysis`` exactly, over every registry config, the four
shapes and 256 and 512 chips. ``cost_numbers`` on a reduced dense prefill
equals a flop count written out below, the flash operator's formula
included; ``traced_collective_stats`` counts the all-reduce that DTensor
issues for a partial product under a fake process group, and ``count``
on DTensors on a fake 2-rank mesh equals one device's flops, bytes and
collectives written out (DTensor's bookkeeping counts nothing). Every
kernel operator passes ``torch.library.opcheck`` on CPU tensors.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from test_hlo_analysis import HLO  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import REGISTRY as R_REGISTRY  # noqa: E402
from repro.configs import SHAPES as R_SHAPES  # noqa: E402
from repro.dist import hlo_analysis as RH  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES, reduce_for_smoke  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core.costs import ChipSpec  # noqa: E402
from repro_torch.dist import hlo_analysis as TH  # noqa: E402
from repro_torch.dist.sharding import abstract_mesh  # noqa: E402
from repro_torch.kernels import (flash_prefill, mamba2_ssd,  # noqa: E402
                                 paged_decode, rwkv6_scan)
from repro_torch.serve.steps import build_step  # noqa: E402

N_CHIPS = [256, 512]


@pytest.mark.parametrize("text", [HLO, "%d = f32[8]{0} dot(%a, %b)", ""])
def test_collective_stats_equal_reference(text):
    got, want = TH.collective_stats(text), RH.collective_stats(text)
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind == want.bytes_by_kind
    assert (got.total_count, got.total_bytes) == (want.total_count,
                                                  want.total_bytes)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_ideals_equal_reference(arch):
    """model_flops, vmem_resident_traffic and structural_memory_floor,
    exactly, for each shape and chip count."""
    cfg, rcfg = REGISTRY[arch], R_REGISTRY[arch]
    for name in SHAPES:
        for n in N_CHIPS:
            for fn in ("model_flops", "vmem_resident_traffic",
                       "structural_memory_floor"):
                assert getattr(TH, fn)(cfg, SHAPES[name], n) == getattr(
                    RH, fn)(rcfg, R_SHAPES[name], n), (fn, name, n)


def test_linear_extrapolate_and_terms_equal_reference():
    assert TH.linear_extrapolate(13, 16, 1, 2, 60) == \
        RH.linear_extrapolate(13, 16, 1, 2, 60)
    for kw in (dict(flops=197e12, hbm_bytes=819e9 * 3, collective_bytes=0,
                    n_chips=256),
               dict(flops=1e12, hbm_bytes=1e12, collective_bytes=3e11,
                    n_chips=512, model_flops=4e11, vmem_resident_bytes=4e11,
                    memory_floor_bytes=2e9),
               dict(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0,
                    n_chips=1)):
        assert TH.RooflineTerms(**kw).as_dict() == \
            RH.RooflineTerms(**kw).as_dict()
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.ICI_BW) == (RH.PEAK_FLOPS,
                                                      RH.HBM_BW, RH.ICI_BW)


def test_roofline_takes_a_chip():
    """The default chip is the reference's TPU; another ChipSpec moves
    each term by its own rate."""
    chip = dataclasses.replace(ChipSpec(), peak_flops=989e12, hbm_bw=3.35e12,
                               ici_bw_per_link=450e9, ici_links=1)
    t = TH.RooflineTerms(flops=989e12, hbm_bytes=3.35e12 * 2,
                         collective_bytes=450e9 * 3, n_chips=1, chip=chip)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 3.0)
    assert t.dominant == "collective" and t.step_time_s == 3.0
    assert TH.RooflineTerms(flops=1, hbm_bytes=1, collective_bytes=1,
                            n_chips=1).chip == ChipSpec()


def test_cost_numbers_on_a_reduced_dense_prefill():
    """One device's flops of reduced llama32-3b's prefill (B 2, S 16) on
    the one-device mesh, written out: per layer the q, k, v and o
    projections and the three SwiGLU products (2 flops a multiply-add),
    and the flash operator's causal pairs (4 hd flops a pair and head);
    then the LM head at the last position. Norms, rope and softmax count
    no flops in ``torch.utils.flop_counter``. Bytes are counted, and
    nothing runs: the arguments are meta tensors."""
    cfg = reduce_for_smoke(REGISTRY["llama32-3b"])
    B, S = 2, 16
    d, H, KV, hd, f, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    pairs = S * (S + 1) // 2
    per_layer = (2 * B * S * d * (H + 2 * KV) * hd     # q, k, v
                 + 4 * B * H * hd * pairs              # flash
                 + 2 * B * S * H * hd * d              # o
                 + 3 * 2 * B * S * d * f)              # gate, up, down
    want = cfg.num_layers * per_layer + 2 * B * d * V
    bundle = build_step("prefill", cfg, abstract_mesh((1, 1), ("data",
                                                               "model"),
                                                      "cpu"),
                        InputShape("p", S, B, "prefill"))
    flops, nbytes = TH.cost_numbers(bundle.fn, *bundle.abstract_args)
    assert flops == want
    # at least every parameter is read once
    assert nbytes >= sum(p.numel() * p.element_size() for p in
                         _leaves(bundle.abstract_args[0]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_traced_collective_stats_counts_dtensor_collectives():
    """x [8, 16] sharded on its columns times w [16, 8] sharded on its
    rows is a partial sum on each of 4 ranks; made whole, it is one
    all-reduce of the [8, 8] f32 result (256 bytes) on each rank. The
    per-device flops are the local product's."""
    dist.init_process_group("fake", rank=0, world_size=4,
                            store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))

        def step(x, w):
            return (x @ w).redistribute(mesh, [Replicate()])
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode() as mode:
            x = DTensor.from_local(torch.empty(8, 4), mesh, [Shard(1)],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(4, 8), mesh, [Shard(0)],
                                   run_check=False)
        del mode
        st = TH.traced_collective_stats(step, x, w)
        assert st.count_by_kind == {"all-reduce": 1}
        assert st.bytes_by_kind == {"all-reduce": 8 * 8 * 4}
        assert TH.count(step, x, w)[1].flops == 2 * 8 * 4 * 8
    finally:
        dist.destroy_process_group()


def test_count_on_dtensors_is_one_devices_work():
    """On a fake 2-rank mesh: flash's forward operator on q [1, 8, 4, 16]
    and k, v [1, 8, 2, 16] sharded on heads, and x [8, 16] (columns
    sharded) times w [16, 8] (rows sharded) made whole. One rank's count,
    written out: flash over its 2 query heads and 36 causal pairs,
    4 * 2 * 16 * 36 flops, reading q (1024 bytes), k and v (512 each)
    and writing 1024; the local [8, 8] x [8, 8] product, 2 * 8 * 8 * 8
    flops and 3 * 256 bytes; one all-reduce of 256 bytes. DTensor's
    bookkeeping (the global-shaped runs that find the outputs'
    metadata) and its metadata queries count nothing."""
    dist.init_process_group("fake", rank=0, world_size=2,
                            store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))

        def step(q, k, v, x, w):
            return (flash_prefill.flash_fwd(q, k, v, True, 0, 0),
                    (x @ w).redistribute(mesh, [Replicate()]))
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            def local(pl, *shape):
                return DTensor.from_local(torch.empty(*shape), mesh, [pl],
                                          run_check=False)
            args = (local(Shard(2), 1, 8, 2, 16),
                    local(Shard(2), 1, 8, 1, 16),
                    local(Shard(2), 1, 8, 1, 16),
                    local(Shard(1), 8, 8), local(Shard(0), 8, 8))
        out, c = TH.count(step, *args)
        assert c.flops == 4 * 2 * 16 * 36 + 2 * 8 * 8 * 8
        assert c.bytes == (1024 + 2 * 512 + 1024) + 3 * 256
        assert c.collectives.count_by_kind == {"all-reduce": 1}
        assert c.collectives.bytes_by_kind == {"all-reduce": 256}
        assert [tuple(o.placements) for o in out] == [(Shard(2),),
                                                      (Replicate(),)]
    finally:
        dist.destroy_process_group()


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    def u(*s):
        return torch.rand(*s, generator=g)
    B, S, H, KV, hd, N = 2, 8, 4, 2, 32, 16
    q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
    out, lse = torch.ops.repro_torch.flash_fwd_lse(q, k, v, True, 0, 0)
    rk = [r(B, S, H, hd), r(B, S, H, hd), r(B, S, H, hd), u(B, S, H, hd),
          r(H, hd), r(B, H, hd, hd)]
    ssd = [r(B, S, H, hd), u(B, S, H), -u(H), r(B, S, N), r(B, S, N), r(H),
           r(B, H, N, hd)]
    return {
        "flash_fwd": (flash_prefill.flash_fwd, (q, k, v, True, 0, 0)),
        "flash_fwd_lse": (flash_prefill.flash_fwd_lse,
                          (q, k, v, True, 3, 2)),
        "flash_bwd": (flash_prefill.flash_bwd,
                      (q, k, v, out, r(B, S, H, hd), lse, True, 0, 0)),
        "paged_attention": (paged_decode.paged_op, (
            r(B, H, hd), r(4, 4, KV, hd), r(4, 4, KV, hd),
            torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
            torch.tensor([5, 8], dtype=torch.int32))),
        "rwkv6_scan": (rwkv6_scan.scan_op, tuple(rk)),
        "rwkv6_scan_bwd": (rwkv6_scan.backward_op, (
            *rk, r(B, S, H, hd), r(B, H, hd, hd), None)),
        "mamba2_ssd": (mamba2_ssd.scan_op, tuple(ssd)),
        "mamba2_ssd_bwd": (mamba2_ssd.backward_op, (
            *ssd, r(B, S, H, hd), r(B, H, N, hd))),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_operator_opcheck(name):
    """Schema (no input mutated or aliased by an output), autograd
    registration, fake implementation against the CPU one, and AOT
    dispatch with dynamic shapes."""
    op, args = _op_cases()[name]
    assert op.default.name() == f"repro_torch::{name}"
    res = torch.library.opcheck(op.default, args)
    assert set(res.values()) == {"SUCCESS"}, res
