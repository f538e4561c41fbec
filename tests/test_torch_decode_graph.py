"""The dense paged decode step's CUDA graphs (``models/decode_graph.py``),
their logic on the CPU: the row buckets and what a first need captures,
the table width from the split plan's arithmetic, the padded inputs and
the sink page they name, and which steps take the eager path, with the
counters that say so. The graphs themselves run on the card
(``tests/test_torch_card.py``)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.core as T
from repro_torch import configs as tcfg
from repro_torch.core import DevicePagedKV, PagedKVPool
from repro_torch.kernels import ops, paged_decode
from repro_torch.launch.serve import device_kv
from repro_torch.models import decode_graph as DG
from repro_torch.models import get_model
from repro_torch.models import transformer as TF
from repro_torch.obs import Tracer


@pytest.mark.parametrize("rows,bucket", [
    (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16), (43, 48),
    (64, 64), (65, 72), (250, 256), (256, 256)])
def test_bucket_for(rows, bucket):
    assert DG.bucket_for(rows) == bucket


def test_buckets():
    assert DG.ROW_BUCKETS[:5] == (1, 2, 4, 8, 16)
    assert DG.MAX_ROWS == 256 and len(DG.ROW_BUCKETS) == 35
    assert all(b % 8 == 0 for b in DG.ROW_BUCKETS[3:])


@pytest.mark.parametrize("rows,captured,want", [
    (64, set(), [64, 56, 48, 40, 32, 24, 16, 8, 4, 2, 1]),
    (3, set(), [4, 2, 1]),
    (17, {8, 4, 2, 1}, [24, 16]),
    (5, {1, 2, 4, 8}, []),
    (1, {64, 8}, [1]),
])
def test_first_need_captures_every_smaller_bucket(rows, captured, want):
    assert DG.to_capture(rows, captured) == want


@pytest.mark.parametrize("dtype,hd,page,width", [
    (torch.bfloat16, 128, 16, 80), (torch.float32, 128, 16, 40),
    (torch.bfloat16, 64, 16, 160), (torch.bfloat16, 128, 8, 160),
    (torch.bfloat16, 32, 16, 256), (torch.float32, 128, 64, 10)])
def test_table_width_is_the_split_plans_single_run(dtype, hd, page, width):
    """The width is the widest table ``split_plan`` walks as one run a
    row, at every batch; one page more and it splits."""
    k = torch.empty((2, 4, page, 2, hd), dtype=dtype, device="meta")
    assert DG.table_width(k) == width
    row = hd * k.element_size()
    for B in (1, 8, 64, 256):
        paged_decode.split_plan.cache_clear()
        assert paged_decode.split_plan(B, 8, width, page, row, 132) == \
            (1, width)
        assert paged_decode.split_plan(B, 8, width + 1, page, row,
                                       132)[0] > 1


def _cfg(**kw):
    cfg = tcfg.reduce_for_smoke(tcfg.REGISTRY["yi-34b"])
    return dataclasses.replace(cfg, **kw)


def _fake_cuda(rows, width, hd=128):
    with FakeTensorMode():
        return (torch.empty(rows, dtype=torch.long, device="cuda"),
                torch.empty((2, 9, 16, 2, hd), dtype=torch.bfloat16,
                            device="cuda"),
                torch.empty((rows, width), dtype=torch.int32,
                            device="cuda"))


@pytest.mark.parametrize("rows,width,sink,kw,why", [
    (4, 80, 8, {}, None),
    (256, 80, 8, {}, None),
    (257, 80, 8, {}, "rows"),
    (4, 81, 8, {}, "width"),
    (4, 80, None, {}, "no_sink"),
    (4, 80, 8, {"sliding_window": 64}, "window"),
])
def test_eager_reason_on_cuda_tensors(rows, width, sink, kw, why):
    toks, k, bt = _fake_cuda(rows, width)
    assert DG.eager_reason(_cfg(**kw), toks, k, bt, sink) == why


def test_eager_reason_on_host_and_dtensors():
    toks = torch.zeros(4, dtype=torch.long)
    k = torch.zeros((2, 9, 16, 2, 128), dtype=torch.bfloat16)
    bt = torch.zeros((4, 3), dtype=torch.int32)
    assert DG.eager_reason(_cfg(), toks, k, bt, 8) == "device"
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (1,))
        dk = DTensor.from_local(k, mesh, [Replicate()])
        assert DG.eager_reason(_cfg(), toks, dk, bt, 8) == "dtensor"
    finally:
        dist.destroy_process_group()


def test_pad_inputs():
    R, W, sink = 16, 10, 99
    static = (torch.full((R,), 7, dtype=torch.long),
              torch.full((R,), 7, dtype=torch.int32),
              torch.full((R, W), 7, dtype=torch.int32))
    toks = torch.tensor([11, 12, 13])
    pos = torch.tensor([40, 3, 17], dtype=torch.int32)
    bt = torch.tensor([[5, 6, 4], [1, 0, 0], [2, 3, 0]], dtype=torch.int32)
    t, p, b = DG.pad_inputs(toks, pos, bt, 8, sink, static)
    assert t.shape == (8,) and p.shape == (8,) and b.shape == (8, W)
    assert t.tolist() == [11, 12, 13] + [0] * 5
    assert p.tolist() == [40, 3, 17] + [0] * 5
    assert torch.equal(b[:3, :3], bt)
    assert (b[:3, 3:] == sink).all() and (b[3:] == sink).all()
    # a padded row reads one key, from the sink page's first slot
    seq_lens = p + 1
    assert seq_lens[3:].tolist() == [1] * 5
    assert (b[3:].gather(1, (p[3:].long() // 16)[:, None]) == sink).all()
    # rows past the bucket are left alone
    assert (static[0][8:] == 7).all() and (static[2][8:] == 7).all()


def test_sink_page_is_never_granted_or_touched():
    L, KV, hd, page = 2, 2, 32, 8
    pool = PagedKVPool(num_pages=12, page_size=page)
    dev = DevicePagedKV(pool, L, KV, hd, dtype=torch.float32, device="cpu")
    assert dev.sink_page == 12 and dev.k.shape == (L, 13, page, KV, hd)
    dev.k[:, dev.sink_page] = 5.0
    dev.v[:, dev.sink_page] = -5.0
    rng = np.random.default_rng(3)
    live = {}
    for step in range(60):
        sid = int(rng.integers(0, 6))
        if sid in live and rng.random() < 0.4:
            dev.free(sid)
            del live[sid]
        elif sid not in live:
            n = int(rng.integers(1, 30))
            if not pool.can_fit(n):
                continue
            pool.allocate(sid, n)
            ks, vs = (torch.from_numpy(rng.standard_normal(
                (L, n, KV, hd)).astype(np.float32)) for _ in range(2))
            dev.write_prefill(sid, ks, vs)
            live[sid] = (ks, vs)
        for s, (ks, vs) in live.items():
            assert dev.pool.block_table(s) and \
                dev.sink_page not in dev.pool.block_table(s)
            k, v = dev.gather_dense(s)
            assert torch.equal(k, ks) and torch.equal(v, vs)
        pool.check_invariants()
        assert (dev.k[:, dev.sink_page] == 5.0).all()
        assert (dev.v[:, dev.sink_page] == -5.0).all()
    # every page granted at once: still none is the sink
    for s in list(live):
        dev.free(s)
    granted = pool.allocate(0, 12 * page)
    assert sorted(granted) == list(range(12)) and pool.free_pages == 0
    pool.check_invariants()


def _prefilled(cfg, model, params, lens, seed=0):
    pool = PagedKVPool(num_pages=sum(-(-(n + 4) // 16) for n in lens) + 2,
                       page_size=16)
    kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                       dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(seed)
    pool.allocate(99, 20)                  # scatter the sequences' pages
    for sid, n in enumerate(lens):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
        _, cache = model.prefill(params, {"tokens": toks})
        pool.allocate(sid, n + 1)
        kv.write_prefill(sid, cache.k[:, 0], cache.v[:, 0])
    pool.free_seq(99)
    return kv


@pytest.mark.parametrize("lens", [[37], [5, 40, 17], [16, 33, 1, 48, 9]])
def test_padded_step_gives_the_real_rows_and_writes_only_the_sink(lens):
    """The replayed step's arithmetic, eagerly on the CPU: the step over
    the padded inputs of the row's bucket at the graphs' table width
    gives the real rows' logits and K/V of the step over the real rows
    alone, and writes no page but theirs and the sink."""
    cfg = _cfg(head_dim=128, num_heads=14, num_kv_heads=2, d_model=256)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    kv = _prefilled(cfg, model, params, lens)
    B = len(lens)
    tables = [kv.pool.block_table(s) for s in range(B)]
    w = max(map(len, tables))
    bt = torch.tensor([t + [0] * (w - len(t)) for t in tables],
                      dtype=torch.int32)
    toks = torch.arange(3, 3 + B)
    pos = torch.tensor(lens, dtype=torch.int32)
    k0, v0 = kv.k.clone(), kv.v.clone()
    want = TF.decode_step_paged(params, toks, k0, v0, bt, pos, cfg)
    width = DG.table_width(kv.k)
    static = (torch.zeros(DG.MAX_ROWS, dtype=torch.long),
              torch.zeros(DG.MAX_ROWS, dtype=torch.int32),
              torch.zeros((DG.MAX_ROWS, width), dtype=torch.int32))
    bucket = DG.bucket_for(B)
    ins = DG.pad_inputs(toks, pos, bt, bucket, kv.sink_page, static)
    k1, v1 = kv.k.clone(), kv.v.clone()
    got = TF.decode_step_paged(params, ins[0], k1, v1, ins[2], ins[1], cfg)
    assert got.shape == (bucket, cfg.vocab_size)
    torch.testing.assert_close(got[:B], want, atol=2e-5, rtol=2e-5)
    sink = kv.sink_page
    torch.testing.assert_close(k1[:, :sink], k0[:, :sink], atol=2e-5,
                               rtol=2e-5)
    torch.testing.assert_close(v1[:, :sink], v0[:, :sink], atol=2e-5,
                               rtol=2e-5)
    # pages no row names are untouched
    named = {p for t in tables for p in t}
    for p in set(range(sink)) - named:
        assert torch.equal(k1[:, p], kv.k[:, p])
    if bucket > B:
        assert not torch.equal(k1[:, sink], kv.k[:, sink])


def test_launch_counts_round_trip():
    before = ops.launch_counts()
    ops.add_launches([1] * len(before))
    assert ops.launch_counts() == tuple(n + 1 for n in before)
    ops.add_launches([-1] * len(before))
    assert ops.launch_counts() == before
    assert paged_decode.paged_attention.launches == \
        before[[fn for fn, _ in ops._COUNTERS].index(
            paged_decode.paged_attention)]


def _serve(arch, tracer=None):
    cfg = tcfg.reduce_for_smoke(tcfg.REGISTRY[arch])
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    reqs = T.random_workload(3, input_len=20, output_len=5,
                             vocab_size=cfg.vocab_size, seed=11)
    kv = device_kv(cfg, reqs, "cpu")
    res = T.make_cluster(
        "dis-host", cfg, executor_factory=lambda path: T.RealExecutor(
            model, params, kv, transfer_path=path), tracer=tracer).run(reqs)
    return model, res


@pytest.mark.parametrize("arch,why", [("llama32-3b", "device"),
                                      ("deepseek-moe-16b", "family")])
def test_host_and_moe_steps_run_eagerly_and_are_counted(arch, why):
    tr = Tracer(enabled=False, wall=True)
    model, res = _serve(arch, tr)
    steps = [s for s in tr.walls if s.name == "decode.forward"]
    st = model.graph_stats
    assert steps and st.captures == 0 and st.replays == 0 and st.last == 0
    assert dict(st.eager) == {why: len(steps)}
    assert all(s.args == {"graph": 0} for s in steps)
    assert all(r.output_tokens for r in res.requests)


def test_eager_step_without_a_sink_is_the_plain_step():
    """Without a sink page (a caller that holds no ``DevicePagedKV``),
    the step is ``transformer.decode_step_paged`` itself, bit for bit."""
    cfg = _cfg()
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu")
    kv = _prefilled(cfg, model, params, [9, 30])
    bt = torch.tensor([kv.pool.block_table(s) + [0] * (
        3 - len(kv.pool.block_table(s))) for s in (0, 1)], dtype=torch.int32)
    toks, pos = torch.tensor([4, 5]), torch.tensor([9, 30], dtype=torch.int32)
    k0, v0 = kv.k.clone(), kv.v.clone()
    got = model.decode_step_paged(params, toks, kv.k, kv.v, bt, pos)
    want = TF.decode_step_paged(params, toks, k0, v0, bt, pos, cfg)
    assert torch.equal(got, want) and torch.equal(kv.k, k0)
    assert dict(model.graph_stats.eager) == {"no_sink": 1}
    assert not hasattr(get_model(tcfg.REGISTRY["rwkv6-3b"]), "decode_graphs")
