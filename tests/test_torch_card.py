"""The CUDA kernels on the card: each against its plain torch version
(flash's, the rwkv6 scan's and the SSD scan's backward through
autograd), the paged kernel raising under grad, a train step and the
reduced models' prefill + decode on the card against the same on the
CPU. They skip without a card (the kernels have no CPU mode). This file
imports neither jax nor the reference, so it also runs on a machine
that has only torch:

  python -m pytest --noconftest -q tests/test_torch_card.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import DevicePagedKV, PagedKVPool  # noqa: E402
from repro_torch.kernels import (flash_prefill, mamba2_ssd, paged_decode,  # noqa: E402
                                 ref, rwkv6_scan)
from repro_torch.models import decode_graph as DG  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,H,KV,hd,window", [
    (200, 200, 8, 2, 64, 0), (77, 333, 4, 4, 32, 0), (300, 300, 6, 2, 128, 40),
    (130, 130, 4, 4, 80, 0), (96, 160, 4, 4, 80, 24),
    (17, 17, 24, 8, 128, 0),          # one partial tile
    (1024, 1024, 32, 32, 80, 0),      # zamba2's shared block, both masks
    (1024, 1024, 16, 16, 128, 0),     # deepseek-moe-16b's MHA
    (32, 1024, 16, 16, 64, 0),        # seamless-m4t-medium's cross-attention
    (1, 1024, 16, 16, 64, 0),         # ... at decode: one query row
    (1, 1, 16, 16, 64, 0),            # ... and its BOS prefill
])
def test_flash_kernel_matches_plain(card, dtype, S, T, H, KV, hd, window):
    q = torch.randn(2, S, H, hd, generator=card, device="cuda").to(dtype)
    k = torch.randn(2, T, KV, hd, generator=card, device="cuda").to(dtype)
    v = torch.randn(2, T, KV, hd, generator=card, device="cuda").to(dtype)
    before = flash_prefill.flash_attention.launches
    for causal in (True, False):
        kw = dict(causal=causal, window=window, q_offset=T - S)
        out = flash_prefill.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(
            out.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
            atol=TOL[dtype], rtol=TOL[dtype])
    assert flash_prefill.flash_attention.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,q_offset", [
    (100, 120, 4, 2, 32, True, 30, 80),       # rows 69.. see no key
    (90, 64, 2, 1, 32, False, 20, 60),        # non-causal, rows 23..
    (300, 260, 8, 2, 128, True, 64, 100),     # hd 128, two blocks of rows
    (200, 150, 4, 4, 80, False, 16, 40),      # hd 80
])
def test_flash_kernel_keyless_rows_match_plain(card, dtype, S, T, H, KV, hd,
                                               causal, window, q_offset):
    """Rows that see no key get the plain version's uniform softmax (the
    mean of V), and the forward's log-sum-exp matches the plain one (0 on
    those rows)."""
    q = torch.randn(2, S, H, hd, generator=card, device="cuda").to(dtype)
    k = torch.randn(2, T, KV, hd, generator=card, device="cuda").to(dtype)
    v = torch.randn(2, T, KV, hd, generator=card, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert q_offset + S - 1 >= T + window - 1      # some row sees no key
    out = flash_prefill.flash_attention(q, k, v, **kw)
    out2, lse = flash_prefill.flash_attention_with_lse(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    for got in (out, out2):
        torch.testing.assert_close(got.float(), want, atol=TOL[dtype],
                                   rtol=TOL[dtype])
    torch.testing.assert_close(
        lse, ref.flash_attention_lse_ref(q, k, **kw), atol=TOL[dtype],
        rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,page", [(8, 2, 64, 16), (7, 1, 128, 8),
                                          (4, 4, 32, 16),
                                          (16, 16, 128, 16)])  # deepseek-moe
def test_paged_kernel_matches_plain(card, dtype, H, KV, hd, page):
    P, B, max_pages = 40, 3, 9
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=card, device="cuda").to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=card, device="cuda").to(dtype)
    bt = torch.randperm(P, generator=card, device="cuda")[:B * max_pages]
    bt = bt.reshape(B, max_pages).to(torch.int32)
    lens = torch.tensor([1, page + 3, max_pages * page], dtype=torch.int32,
                        device="cuda")
    out = paged_decode.paged_attention(q, kp, vp, bt, lens)
    torch.testing.assert_close(
        out.float(), ref.paged_attention_ref(q, kp, vp, bt, lens).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def _paged_case(card, dtype, B, H, KV, hd, page, lens, max_pages=None):
    """Random q and pages, a shuffled block table of ``max_pages`` pages
    (default: enough for the longest length) and the lengths."""
    max_pages = max_pages or -(-max(lens) // page)
    P = B * max_pages + 7
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=card, device="cuda").to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=card, device="cuda").to(dtype)
    bt = torch.randperm(P, generator=card, device="cuda")[:B * max_pages]
    bt = bt.reshape(B, max_pages).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,hd,page,lens,max_pages", [
    (1, 24, 8, 128, 16, [8192], None),              # B=1 at 8K: many splits
    (3, 8, 2, 64, 16, [1, 40, 2000], 256),          # empty trailing splits
    (2, 16, 8, 64, 16, [1, 1], 64),                 # len 1
    (4, 24, 8, 128, 16, [1024] * 4, 64),            # a full block table
    (2, 56, 8, 128, 16, [777, 3001], None),         # G 7 (yi-34b)
    (2, 64, 8, 128, 16, [1500, 129], None),         # G 8 (command-r-35b)
    (3, 12, 4, 64, 8, [5, 700, 1601], None),        # page 8
    (3, 12, 4, 32, 32, [31, 32, 4000], None),       # page 32
    (2, 8, 2, 128, 16, [5000, 100], 64),            # clamped to max_pages
])
def test_paged_split_kernel_matches_plain(card, dtype, B, H, KV, hd, page,
                                          lens, max_pages):
    args = _paged_case(card, dtype, B, H, KV, hd, page, lens, max_pages)
    before = paged_decode.paged_attention.launches
    out = paged_decode.paged_attention(*args)
    assert paged_decode.paged_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), ref.paged_attention_ref(*args).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_paged_split_tickets_reset(card):
    """The last split of a row resets its ticket: the same call twice, and
    again after a call of another shape, gives the same bits."""
    a = _paged_case(card, torch.bfloat16, 4, 24, 8, 128, 16,
                    [1025, 1040, 1049, 1056])
    b = _paged_case(card, torch.bfloat16, 1, 24, 8, 128, 16, [8192])
    first = paged_decode.paged_attention(*a)
    assert torch.equal(paged_decode.paged_attention(*a), first)
    paged_decode.paged_attention(*b)
    assert torch.equal(paged_decode.paged_attention(*a), first)
    torch.testing.assert_close(first.float(),
                               ref.paged_attention_ref(*a).float(),
                               atol=2e-2, rtol=2e-2)


def test_wrappers_reject_bad_inputs(card):
    q = torch.zeros(1, 8, 2, 96, device="cuda")
    with pytest.raises(ValueError, match="head dim 96"):
        flash_prefill.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_prefill.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 128, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="aligned"):
        flash_prefill.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="query heads"):
        paged_decode.paged_attention(
            torch.zeros(1, 16, 64, device="cuda"),
            torch.zeros(4, 16, 1, 64, device="cuda"),
            torch.zeros(4, 16, 1, 64, device="cuda"),
            torch.zeros(1, 2, dtype=torch.int32, device="cuda"),
            torch.ones(1, dtype=torch.int32, device="cuda"))
    r = torch.zeros(1, 8, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        rwkv6_scan.rwkv6_scan(r, r, r, r.bfloat16(), r[0, 0])
    x = torch.zeros(1, 8, 2, 24, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        mamba2_ssd.mamba2_ssd(x, torch.ones(1, 8, 2, device="cuda"),
                              -torch.ones(2, device="cuda"),
                              torch.zeros(1, 8, 16, device="cuda"),
                              torch.zeros(1, 8, 16, device="cuda"))


def _rand(card, shape, lo=None, hi=None):
    x = torch.randn(shape, generator=card, device="cuda")
    if lo is not None:
        x = lo + (hi - lo) * torch.rand(shape, generator=card, device="cuda")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,NH,hd,w_lo,w_hi", [
    (1, 1024, 40, 64, 0.45, 0.95),    # rwkv6-3b's prefill shape
    (4, 77, 3, 32, 1e-6, 1e-3),       # ragged T, decays near 0
    (2, 130, 2, 128, 0.999, 1.0),     # decays near 1
])
def test_rwkv6_kernel_matches_plain(card, dtype, B, T, NH, hd, w_lo, w_hi):
    r, k, v = (_rand(card, (B, T, NH, hd)).to(dtype) for _ in range(3))
    w = _rand(card, (B, T, NH, hd), w_lo, w_hi)
    u = 0.1 * _rand(card, (NH, hd))
    s0 = _rand(card, (B, NH, hd, hd))
    before = rwkv6_scan.rwkv6_scan.launches
    y, s = rwkv6_scan.rwkv6_scan(r, k, v, w, u, s0)
    y_ref, s_ref = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    assert rwkv6_scan.rwkv6_scan.launches == before + 1
    tol = 5 * TOL[dtype]      # y sums hd products of O(sqrt(T)) state
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, s_ref, atol=5e-4, rtol=5e-4)


def _rwkv6_case(card, B, T, NH, hd, w_lo, w_hi, dtype=torch.bfloat16,
                zeros=False):
    r, k, v = (_rand(card, (B, T, NH, hd)).to(dtype) for _ in range(3))
    w = _rand(card, (B, T, NH, hd), w_lo, w_hi)
    if zeros:   # exact zeros, as exp(-exp(x)) gives in f32 for large x
        w = torch.where(torch.rand(w.shape, generator=card, device="cuda")
                        < 0.1, torch.zeros_like(w), w)
    u = 0.1 * _rand(card, (NH, hd))
    return r, k, v, w, u


def _rwkv6_check(y, s, y_ref, s_ref, dtype):
    tol = 5 * TOL[dtype]
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, s_ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("B,T,NH,w_lo,w_hi,carried,zeros", [
    (1, 1024, 40, 0.45, 0.95, False, False),    # rwkv6-3b's prefill shape
    (4, 1024, 40, 0.45, 0.95, False, False),    # B = 4
    (1, 1000, 40, 0.45, 0.95, False, False),    # ragged T
    (1, 37, 40, 0.45, 0.95, True, False),       # T < one chunk
    (1, 1, 40, 0.45, 0.95, True, False),        # a single step
    (2, 300, 8, 0.45, 0.95, True, False),       # a carried state
    (2, 256, 4, 1e-6, 1e-3, True, False),       # decays near 0
    (2, 256, 4, 0.999, 1.0, True, False),       # decays near 1
    (1, 200, 4, 0.0, 1.0, True, True),          # w with exact zeros
])
def test_rwkv6_chunked_kernel_matches_plain(card, B, T, NH, w_lo, w_hi,
                                            carried, zeros):
    """bf16 at hd 64 with aligned inputs takes the chunked kernel: one
    launch, and the plain f32 recurrence within the step kernel's
    tolerances."""
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, 64, w_lo, w_hi, zeros=zeros)
    s0 = _rand(card, (B, NH, 64, 64)) if carried else None
    assert rwkv6_scan.kernel_for(r, k, v, w) == "chunked"
    before = rwkv6_scan.rwkv6_scan.launches
    y, s = rwkv6_scan.rwkv6_scan(r, k, v, w, u, s0)
    assert rwkv6_scan.rwkv6_scan.launches == before + 1
    _rwkv6_check(y, s, *ref.rwkv6_scan_ref(r, k, v, w, u, s0),
                 torch.bfloat16)


@pytest.mark.parametrize("case", ["unaligned-bf16", "f32", "hd128-bf16"])
def test_rwkv6_other_inputs_take_the_step_kernel(card, case):
    """bf16 whose strides are not 16-byte multiples, f32 (the parity
    path) and other head dims stay on rwkv6_fwd; one launch each, and
    the plain version's answer."""
    B, T, NH = 2, 150, 4
    hd = 128 if case == "hd128-bf16" else 64
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, hd, 0.45, 0.95, dtype)
    if case == "unaligned-bf16":
        r = _rand(card, (B, T, NH * hd + 1)).bfloat16()[..., 1:].reshape(
            B, T, NH, hd)
        assert r.stride(1) % 8 and r.data_ptr() % 16
    s0 = _rand(card, (B, NH, hd, hd))
    assert rwkv6_scan.kernel_for(r, k, v, w) == "step"
    before = rwkv6_scan.rwkv6_scan.launches
    y, s = rwkv6_scan.rwkv6_scan(r, k, v, w, u, s0)
    assert rwkv6_scan.rwkv6_scan.launches == before + 1
    _rwkv6_check(y, s, *ref.rwkv6_scan_ref(r, k, v, w, u, s0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,NH,P,N", [
    (1, 1024, 80, 64, 64),            # zamba2's prefill shape
    (2, 45, 3, 32, 16),               # ragged T
    (1, 96, 2, 16, 128),
    (2, 1024, 80, 64, 64),            # B = 2
    (1, 37, 80, 64, 64),              # one partial chunk
    (1, 1, 80, 64, 64),               # a single step
])
def test_mamba2_kernel_matches_plain(card, dtype, B, T, NH, P, N):
    x = _rand(card, (B, T, NH, P)).to(dtype)
    dt = torch.nn.functional.softplus(_rand(card, (B, T, NH)) - 2.0)
    A = -torch.linspace(1.0, 16.0, NH, device="cuda")
    Bm, Cm = (_rand(card, (B, T, N)).to(dtype) for _ in range(2))
    D = _rand(card, (NH,))
    s0 = _rand(card, (B, NH, N, P))
    y, s = mamba2_ssd.mamba2_ssd(x, dt, A, Bm, Cm, D, s0)
    y_ref, s_ref = ref.mamba2_ssd_ref(x, dt, A, Bm, Cm, D, s0)
    tol = 5 * TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, s_ref, atol=5e-4, rtol=5e-4)


def test_mamba2_kernel_takes_unaligned_bf16_inputs(card):
    """bf16 x, B and C whose strides are not 16-byte multiples leave the
    chunked kernel (it copies 16-byte pieces) for the step kernel; one
    launch either way, and both match the plain version."""
    B, T, NH, P, N = 2, 100, 4, 64, 64
    x = _rand(card, (B, T, NH, P + 1)).bfloat16()[..., 1:]
    bc = _rand(card, (B, T, 2 * N + 1)).bfloat16()
    Bm, Cm = bc[..., 1:N + 1], bc[..., N + 1:]
    dt = torch.nn.functional.softplus(_rand(card, (B, T, NH)) - 2.0)
    A = -torch.linspace(1.0, 16.0, NH, device="cuda")
    D, s0 = _rand(card, (NH,)), _rand(card, (B, NH, N, P))
    before = mamba2_ssd.mamba2_ssd.launches
    y, s = mamba2_ssd.mamba2_ssd(x, dt, A, Bm, Cm, D, s0)
    assert mamba2_ssd.mamba2_ssd.launches == before + 1
    y_ref, s_ref = ref.mamba2_ssd_ref(x, dt, A, Bm, Cm, D, s0)
    tol = 5 * TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, s_ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_recurrent_model_prefill_and_decode_match_cpu(card, arch):
    cfg = configs.reduce_for_smoke(configs.REGISTRY[arch])
    model = get_model(cfg)
    params = model.init(card, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                         device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        first, state = model.prefill(p, {"tokens": toks.to(dev)}, s_max=44)
        pos = torch.tensor([40, 40], dtype=torch.int32, device=dev)
        nxt, _ = model.decode_step(p, toks[:, -1].to(dev), state, pos)
        out[dev] = (first.cpu(), nxt.cpu(), *(x.cpu() for x in state))
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_model_prefill_and_paged_decode_match_cpu(card):
    cfg = configs.reduce_for_smoke(configs.REGISTRY["qwen2-0.5b"])
    model = get_model(cfg)
    params = model.init(card, "cuda")
    cpu_params = {"embed": {k: v.cpu() for k, v in params["embed"].items()},
                  "layers": [{k: ({kk: vv.cpu() for kk, vv in v.items()}
                                  if isinstance(v, dict) else v.cpu())
                              for k, v in lp.items()}
                             for lp in params["layers"]]}
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                         device="cuda")
    logits = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t = toks.to(dev)
        pool = PagedKVPool(num_pages=8, page_size=16)
        kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads,
                           cfg.head_dim, device=dev)
        first, cache = model.prefill(p, {"tokens": t})
        for b in range(2):
            pool.allocate(b, 41)
            kv.write_prefill(b, cache.k[:, b], cache.v[:, b])
        bt = torch.tensor([pool.block_table(b) for b in range(2)],
                          dtype=torch.int32, device=dev)
        pos = torch.tensor([40, 40], dtype=torch.int32, device=dev)
        nxt = model.decode_step_paged(p, t[:, -1], kv.k, kv.v, bt, pos)
        logits[dev] = (first.cpu(), nxt.cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("T,dropless", [(4, True), (300, False)])
def test_moe_dispatch_on_card_matches_cpu(card, T, dropless):
    """deepseek-moe-16b's routing (64 experts, top-6) at a small width: a
    B = 4 decode batch whose tokens share experts (slots dropped at
    C = 3) and a prefill of 300 tokens, on the card and on the CPU."""
    import dataclasses
    cfg = configs.reduce_for_smoke(configs.REGISTRY["deepseek-moe-16b"])
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=64, top_k=6, d_expert=32, capacity_factor=1.25))
    d, E, f = cfg.d_model, 64, 32
    p = {"router": torch.randn(d, E, generator=card, device="cuda") * 0.05,
         "w_gate": torch.randn(E, d, f, generator=card, device="cuda") * 0.1,
         "w_up": torch.randn(E, d, f, generator=card, device="cuda") * 0.1,
         "w_down": torch.randn(E, f, d, generator=card, device="cuda") * 0.1}
    p["router"][:, 5] += 0.5
    x = torch.randn(T, d, generator=card, device="cuda").abs()
    out, drops = {}, {}
    for dev in ("cuda", "cpu"):
        moe.reset_decode_drops()
        out[dev] = moe._dispatch(_to(p, dev), x.to(dev), cfg, dropless)
        drops[dev] = moe.decode_drops()
    assert drops["cuda"] == drops["cpu"]
    assert (drops["cuda"] > 0) == dropless
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-2b",
                                  "seamless-m4t-medium"])
def test_new_families_match_cpu(card, arch):
    """The reduced model's prefill and one decode step on the card and on
    the CPU (moe: through the paged pool; vlm, encdec: their own state)."""
    cfg = configs.reduce_for_smoke(configs.REGISTRY[arch])
    model = get_model(cfg)
    params = model.init(card, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=card,
                         device="cuda")
    batch, start = {"tokens": toks}, 40
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.vision.num_patches,
                                       cfg.vision.frontend_dim,
                                       generator=card, device="cuda")
        start += cfg.vision.num_patches
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(2, 48, cfg.encdec.frontend_dim,
                                          generator=card, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        pos = torch.tensor([start, start], dtype=torch.int32, device=dev)
        nxt_tok = toks[:, -1].to(dev)
        if cfg.family == "moe":
            pool = PagedKVPool(num_pages=8, page_size=16)
            kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads,
                               cfg.head_dim, dtype=torch.float32, device=dev)
            first, cache = model.prefill(p, b)
            for i in range(2):
                pool.allocate(i, start + 1)
                kv.write_prefill(i, cache.k[:, i], cache.v[:, i])
            bt = torch.tensor([pool.block_table(i) for i in range(2)],
                              dtype=torch.int32, device=dev)
            nxt = model.decode_step_paged(p, nxt_tok, kv.k, kv.v, bt, pos)
        else:
            first, state = model.prefill(p, b, s_max=start + 4)
            nxt, _ = model.decode_step(p, nxt_tok, state, pos)
        out[dev] = (first.cpu(), nxt.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


# ----------------------------------------------------------------------
# the flash backward kernel, and the kernels that have no backward yet
# (the SSD scan and paged decode)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,q_offset", [
    (200, 200, 8, 2, 64, True, 0, 0), (77, 333, 4, 4, 32, False, 0, 0),
    (300, 300, 6, 2, 128, True, 40, 0), (130, 130, 4, 4, 80, True, 0, 0),
    (64, 256, 4, 2, 128, True, 0, 192),       # q_offset, one query tile
    (100, 120, 4, 2, 32, True, 30, 80),       # rows 69.. see no key
    (1, 100, 16, 16, 64, False, 0, 0),        # one query row
    (512, 512, 8, 2, 128, True, 0, 0),        # hd 128: 4 x 8 key tiles
    (1000, 1000, 6, 3, 128, True, 200, 0),    # hd 128, ragged, a window
    (512, 768, 8, 8, 64, False, 0, 0),        # hd 64, non-causal, S != T
    (640, 640, 4, 2, 64, True, 0, 0),         # hd 64, causal
    (520, 520, 4, 4, 80, True, 0, 0),         # hd 80
    (600, 700, 4, 2, 32, True, 100, 200),     # hd 32, keyless rows
])
def test_flash_backward_kernel_matches_plain(card, dtype, S, T, H, KV, hd,
                                             causal, window, q_offset):
    """dq, dk, dv through the FlashAttention Function (forward and
    backward kernels) against autograd of the plain version."""
    shapes = ((2, S, H, hd), (2, T, KV, hd), (2, T, KV, hd))
    q, k, v = (torch.randn(s, generator=card, device="cuda").to(dtype)
               for s in shapes)
    dout = torch.randn(2, S, H, hd, generator=card, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    grads = {}
    for name, fn in (("kernel", flash_prefill.flash_attention),
                     ("plain", ref.flash_attention_ref)):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        grads[name] = torch.autograd.grad(fn(*qkv, **kw), qkv, dout)
    fwd, bwd = (flash_prefill.flash_attention.launches,
                flash_prefill.flash_attention.backward_launches)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(flash_prefill.flash_attention(*qkv, **kw), qkv, dout)
    assert (flash_prefill.flash_attention.launches,
            flash_prefill.flash_attention.backward_launches) == (fwd + 1,
                                                                 bwd + 1)
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_backward_is_deterministic(card):
    q = torch.randn(2, 256, 8, 128, generator=card, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(2, 256, 2, 128, generator=card, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    out, lse = flash_prefill.flash_attention_with_lse(q, k, v)
    dout = torch.randn_like(out)
    a = flash_prefill.flash_attention_backward(q, k, v, out, dout, lse=lse)
    b = flash_prefill.flash_attention_backward(q, k, v, out, dout, lse=lse)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="lse"):
        flash_prefill.flash_attention_backward(q, k, v, out, dout)


def test_kernels_without_backward_raise_under_grad(card):
    """The paged kernel has no backward and raises under grad; the SSD
    scan, which had none before, now trains: its Function launches the
    backward kernel and gives finite grads, in the kernel and in the
    reduced zamba2 model's loss."""
    x = torch.randn(1, 64, 2, 64, generator=card, device="cuda",
                    requires_grad=True)
    dt = torch.rand(1, 64, 2, generator=card, device="cuda")
    Bm = torch.randn(1, 64, 64, generator=card, device="cuda")
    bwd = mamba2_ssd.mamba2_ssd.backward_launches
    y, _ = mamba2_ssd.mamba2_ssd(x, dt, -torch.ones(2, device="cuda"), Bm,
                                 Bm)
    (gx,) = torch.autograd.grad(y.square().sum(), x)
    assert torch.isfinite(gx).all() and gx.abs().max() > 0
    assert mamba2_ssd.mamba2_ssd.backward_launches == bwd + 1
    q = torch.randn(2, 4, 64, generator=card, device="cuda",
                    requires_grad=True)
    pages = torch.randn(4, 16, 2, 64, generator=card, device="cuda")
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([20, 30], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="paged_attention: .*no backward"):
        paged_decode.paged_attention(q, pages, pages, bt, lens)
    with torch.no_grad():                  # serving runs as before
        paged_decode.paged_attention(q, pages, pages, bt, lens)
    cfg = configs.reduce_for_smoke(configs.REGISTRY["zamba2-2.7b"])
    model = get_model(cfg)
    params = model.init(card, "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=card,
                         device="cuda")
    bwd = mamba2_ssd.mamba2_ssd.backward_launches
    loss, _ = model.loss(params, {"tokens": toks, "targets": toks})
    # each layer's ``norm`` is unused, as in the reference: a zero grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert mamba2_ssd.mamba2_ssd.backward_launches == bwd + cfg.num_layers


# ----------------------------------------------------------------------
# the Mamba2 SSD backward kernel
# ----------------------------------------------------------------------
def _ssd_case(card, B, T, NH, P, N, dtype, dt_kind="model"):
    """x, dt, A, B_mat, C_mat, D like the model's: dt a softplus ~0.1,
    or tiny (decay ~1), or with a tenth at 200 (decay exactly 0)."""
    x = _rand(card, (B, T, NH, P)).to(dtype)
    dt = torch.nn.functional.softplus(_rand(card, (B, T, NH)) - 2.5)
    if dt_kind == "near1":
        dt = 1e-5 * dt
    elif dt_kind == "zero":
        mask = torch.rand(dt.shape, generator=card, device="cuda") < 0.1
        dt = torch.where(mask, torch.full_like(dt, 200.0), dt)
    A = -torch.linspace(1.0, 16.0, NH, device="cuda")
    Bm, Cm = (_rand(card, (B, T, N)).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, _rand(card, (NH,))


def _ssd_grads(fn, ins, dy, ds):
    """Autograd of ``fn`` (the kernel's Function or the plain scan) over
    every input that is not None."""
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in ins]
    return torch.autograd.grad(fn(*leaves), [t for t in leaves
                                             if t is not None], (dy, ds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,NH,P,N,dt_kind,skip", [
    (2, 1024, 80, 64, 64, "model", True),   # zamba2-2.7b's training shape
    (1, 300, 4, 64, 64, "model", True),     # B = 1
    (2, 77, 3, 32, 16, "model", False),     # the smoke config's N, P; no D
    (2, 130, 2, 64, 128, "near1", True),    # N 128, decays near 1
    (1, 100, 4, 64, 32, "zero", True),      # decays exactly 0
    (1, 37, 4, 64, 64, "model", True),      # T < a chunk
    (2, 1, 4, 64, 64, "model", True),       # a single step
])
def test_mamba2_backward_kernel_matches_plain(card, dtype, B, T, NH, P, N,
                                             dt_kind, skip):
    """The gradients through the Mamba2SSD Function (forward and backward
    kernels), from a carried state with a nonzero d(final state),
    against autograd of the plain version: each within the dtype's
    tolerance of its largest magnitude."""
    x, dt, A, Bm, Cm, D = _ssd_case(card, B, T, NH, P, N, dtype, dt_kind)
    s0 = _rand(card, (B, NH, N, P))
    dy = _rand(card, (B, T, NH, P)).to(dtype)
    ds = _rand(card, (B, NH, N, P))
    ins = (x, dt, A, Bm, Cm, D if skip else None, s0)
    fwd, bwd = (mamba2_ssd.mamba2_ssd.launches,
                mamba2_ssd.mamba2_ssd.backward_launches)
    got = _ssd_grads(mamba2_ssd.mamba2_ssd, ins, dy, ds)
    assert (mamba2_ssd.mamba2_ssd.launches,
            mamba2_ssd.mamba2_ssd.backward_launches) == (fwd + 1, bwd + 1)
    want = _ssd_grads(ref.mamba2_ssd_ref, ins, dy, ds)
    assert len(got) == len(want) == 6 + skip
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_backward_is_deterministic(card, dtype):
    """Two calls give the same bits (no atomics); under torch.no_grad the
    scan launches its forward kernel alone."""
    B, T, NH, P, N = 2, 300, 8, 64, 64
    x, dt, A, Bm, Cm, D = _ssd_case(card, B, T, NH, P, N, dtype)
    s0, ds = (_rand(card, (B, NH, N, P)) for _ in range(2))
    dy = _rand(card, (B, T, NH, P)).to(dtype)
    a = mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0, dy, ds)
    b = mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0, dy, ds)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    bwd = mamba2_ssd.mamba2_ssd.backward_launches
    with torch.no_grad():
        y, _ = mamba2_ssd.mamba2_ssd(x.requires_grad_(), dt, A, Bm, Cm, D,
                                     s0)
    assert not y.requires_grad
    assert mamba2_ssd.mamba2_ssd.backward_launches == bwd


@pytest.mark.parametrize("B,T,NH,P,dt_kind,skip,carried", [
    (2, 1024, 80, 64, "model", True, False),   # zamba2-2.7b's training shape
    (1, 1024, 80, 64, "model", True, False),   # B = 1
    (1, 37, 4, 64, "model", True, True),       # T < a chunk
    (2, 300, 8, 64, "model", True, True),      # carried, a ragged tail
    (1, 256, 4, 64, "zero", True, True),       # decays exactly 0
    (2, 130, 4, 64, "model", False, True),     # no D
    (1, 200, 4, 128, "near1", True, True),     # two column blocks, decay ~1
])
def test_mamba2_backward_chunked_matches_plain(card, B, T, NH, P, dt_kind,
                                               skip, carried):
    """bf16 at N 64 takes the chunked route (its counter moves by one):
    every gradient within bf16's tolerance of its largest magnitude
    against autograd of the plain scan, from a carried state with a
    nonzero d(final state) or from zeros."""
    x, dt, A, Bm, Cm, D = _ssd_case(card, B, T, NH, P, 64, torch.bfloat16,
                                    dt_kind)
    zero = torch.zeros(B, NH, 64, P, device="cuda")
    s0, ds = ((_rand(card, (B, NH, 64, P)), _rand(card, (B, NH, 64, P)))
              if carried else (zero, zero))
    dy = _rand(card, (B, T, NH, P)).to(torch.bfloat16)
    ins = (x, dt, A, Bm, Cm, D if skip else None, s0)
    assert mamba2_ssd.backward_kernel_for(x, Bm, Cm, dy) == "chunked"
    before = mamba2_ssd.mamba2_ssd.backward_chunked_launches
    got = _ssd_grads(mamba2_ssd.mamba2_ssd, ins, dy, ds)
    assert mamba2_ssd.mamba2_ssd.backward_chunked_launches == before + 1
    want = _ssd_grads(ref.mamba2_ssd_ref, ins, dy, ds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=TOL[torch.bfloat16] * scale)


@pytest.mark.parametrize("case,route", [
    ("bf16-N64", "chunked"), ("f32-N64", "step"), ("bf16-N16", "step"),
    ("bf16-N128", "step"), ("bf16-unaligned-x", "step"),
])
def test_mamba2_backward_route(card, case, route):
    """The route each input takes, by the wrapper's rule and the counters:
    the chunked one only for bf16 at N 64 with aligned x, B, C and dy; f32,
    N 16 and 128, and an x view whose head stride is not a multiple of 8
    take the step kernel by that rule (not after a failed launch), and
    every route's gradients hold to the plain scan."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    N = {"bf16-N16": 16, "bf16-N128": 128}.get(case, 64)
    B, T, NH, P = 2, 150, 4, 64
    x, dt, A, Bm, Cm, D = _ssd_case(card, B, T, NH, P, N, dtype)
    if case == "bf16-unaligned-x":   # heads P + 1 apart: strides odd
        x = _rand(card, (B, T, NH, P + 1)).to(dtype)[..., :P]
    s0, ds = (_rand(card, (B, NH, N, P)) for _ in range(2))
    dy = _rand(card, (B, T, NH, P)).to(dtype)
    assert mamba2_ssd.backward_kernel_for(x, Bm, Cm, dy) == route
    counts = (mamba2_ssd.mamba2_ssd.backward_launches,
              mamba2_ssd.mamba2_ssd.backward_chunked_launches)
    got = mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0, dy, ds)
    chunked = int(route == "chunked")
    assert (mamba2_ssd.mamba2_ssd.backward_launches,
            mamba2_ssd.mamba2_ssd.backward_chunked_launches) == (
                counts[0] + 1, counts[1] + chunked)
    want = _ssd_grads(ref.mamba2_ssd_ref, (x, dt, A, Bm, Cm, D, s0), dy, ds)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=TOL[dtype] * scale)


def test_mamba2_backward_occupancy(card):
    """Two chunked walk blocks fit an SM, so zamba2's 160 blocks at B = 2
    are one wave on 132 SMs."""
    occ = mamba2_ssd.backward_occupancy()
    assert occ["chunked_walk"] >= 2 and occ["chunked_states"] >= 1 \
        and occ["step"] >= 1, occ


# ----------------------------------------------------------------------
# the rwkv6 backward kernel
# ----------------------------------------------------------------------
def _rwkv6_grads(fn, ins, dy, ds):
    """Autograd of ``fn`` (the kernel's Function or the plain scan) over
    r, k, v, w, u and the state."""
    leaves = [t.clone().requires_grad_() for t in ins]
    return torch.autograd.grad(fn(*leaves), leaves, (dy, ds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,NH,hd,w_lo,w_hi,zeros", [
    (2, 1024, 40, 64, 0.45, 0.95, False),   # rwkv6-3b's training shape
    (1, 300, 4, 64, 0.45, 0.95, False),     # B = 1
    (2, 77, 3, 32, 1e-6, 1e-3, False),      # hd 32, decays near 0
    (2, 130, 2, 128, 0.999, 1.0, False),    # hd 128, decays near 1
    (1, 1024, 4, 64, 0.999, 1.0, False),    # decays near 1 over T = 1024
    (1, 37, 4, 64, 0.0, 1.0, True),         # T < a sub-chunk's 64, exact 0s
    (2, 1, 4, 64, 0.45, 0.95, False),       # a single step
])
def test_rwkv6_backward_kernel_matches_plain(card, dtype, B, T, NH, hd,
                                            w_lo, w_hi, zeros):
    """The six gradients through the RWKV6Scan Function (forward and
    backward kernels), from a carried state with a nonzero d(final
    state), against autograd of the plain version: each within the
    dtype's tolerance of its largest magnitude."""
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, hd, w_lo, w_hi, dtype,
                                zeros)
    s0 = _rand(card, (B, NH, hd, hd))
    dy = _rand(card, (B, T, NH, hd)).to(dtype)
    ds = _rand(card, (B, NH, hd, hd))
    ins = (r, k, v, w, u, s0)
    fwd, bwd = (rwkv6_scan.rwkv6_scan.launches,
                rwkv6_scan.rwkv6_scan.backward_launches)
    got = _rwkv6_grads(rwkv6_scan.rwkv6_scan, ins, dy, ds)
    assert (rwkv6_scan.rwkv6_scan.launches,
            rwkv6_scan.rwkv6_scan.backward_launches) == (fwd + 1, bwd + 1)
    want = _rwkv6_grads(ref.rwkv6_scan_ref, ins, dy, ds)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.isfinite(g.float()).all()
        scale = float(x.float().abs().max())
        torch.testing.assert_close(g.float(), x.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_backward_is_deterministic(card, dtype):
    """Two calls give the same bits (no atomics); under torch.no_grad the
    scan launches its forward kernel alone."""
    B, T, NH, hd = 2, 300, 4, 64
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, hd, 0.45, 0.95, dtype)
    s0, ds = (_rand(card, (B, NH, hd, hd)) for _ in range(2))
    dy = _rand(card, (B, T, NH, hd)).to(dtype)
    a = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    b = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    bwd = rwkv6_scan.rwkv6_scan.backward_launches
    with torch.no_grad():
        y, _ = rwkv6_scan.rwkv6_scan(r.requires_grad_(), k, v, w, u, s0)
    assert not y.requires_grad
    assert rwkv6_scan.rwkv6_scan.backward_launches == bwd


@pytest.mark.parametrize("B,T,NH,w_lo,w_hi,zeros,carried", [
    (2, 1024, 40, 0.45, 0.95, False, False),   # rwkv6-3b's training shape
    (1, 1024, 40, 0.45, 0.95, False, False),   # B = 1
    (1, 1000, 8, 0.45, 0.95, False, True),     # a ragged tail
    (2, 37, 4, 0.45, 0.95, False, True),       # T < a chunk
    (1, 1, 4, 0.45, 0.95, False, True),        # a single step
    (2, 256, 4, 1e-6, 1e-3, False, True),      # decays near 0: exact rows
    (2, 1024, 8, 0.999, 1.0, False, True),     # decays near 1
    (1, 200, 4, 0.0, 1.0, True, True),         # w with exact zeros
    (2, 300, 4, 0.02, 0.2, False, True),       # rows on both sides of W_MIN
])
def test_rwkv6_backward_chunked_matches_plain(card, B, T, NH, w_lo, w_hi,
                                             zeros, carried):
    """bf16 at hd 64 takes the chunked route (its counter moves by one):
    every gradient within bf16's tolerance of its largest magnitude
    against autograd of the plain scan, from a carried state with a
    nonzero d(final state) or from zeros."""
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, 64, w_lo, w_hi, zeros=zeros)
    zero = torch.zeros(B, NH, 64, 64, device="cuda")
    s0, ds = ((_rand(card, (B, NH, 64, 64)), _rand(card, (B, NH, 64, 64)))
              if carried else (zero, zero))
    dy = _rand(card, (B, T, NH, 64)).to(torch.bfloat16)
    ins = (r, k, v, w, u, s0)
    assert rwkv6_scan.backward_kernel_for(r, k, v, w, dy) == "chunked"
    before = rwkv6_scan.rwkv6_scan.backward_chunked_launches
    got = _rwkv6_grads(rwkv6_scan.rwkv6_scan, ins, dy, ds)
    assert rwkv6_scan.rwkv6_scan.backward_chunked_launches == before + 1
    want = _rwkv6_grads(ref.rwkv6_scan_ref, ins, dy, ds)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.isfinite(g.float()).all()
        scale = float(x.float().abs().max())
        torch.testing.assert_close(g.float(), x.float(), rtol=0,
                                   atol=TOL[torch.bfloat16] * scale)


@pytest.mark.parametrize("case,route", [
    ("bf16-hd64", "chunked"), ("f32-hd64", "step"), ("bf16-hd32", "step"),
    ("bf16-hd128", "step"), ("bf16-unaligned-r", "step"),
])
def test_rwkv6_backward_route(card, case, route):
    """The route each input takes, by the wrapper's rule and the counters:
    the chunked one only for bf16 at hd 64 with aligned r, k, v, w and
    dy; f32, hd 32 and 128, and an r view whose head stride is odd take
    the step kernel by that rule (not after a failed launch), and every
    route's gradients hold to the plain scan."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    hd = {"bf16-hd32": 32, "bf16-hd128": 128}.get(case, 64)
    B, T, NH = 2, 150, 4
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, hd, 0.45, 0.95, dtype)
    if case == "bf16-unaligned-r":   # heads hd + 1 apart: odd strides
        r = _rand(card, (B, T, NH, hd + 1)).to(dtype)[..., :hd]
    s0, ds = (_rand(card, (B, NH, hd, hd)) for _ in range(2))
    dy = _rand(card, (B, T, NH, hd)).to(dtype)
    assert rwkv6_scan.backward_kernel_for(r, k, v, w, dy) == route
    counts = (rwkv6_scan.rwkv6_scan.backward_launches,
              rwkv6_scan.rwkv6_scan.backward_chunked_launches)
    got = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    assert (rwkv6_scan.rwkv6_scan.backward_launches,
            rwkv6_scan.rwkv6_scan.backward_chunked_launches) == (
                counts[0] + 1, counts[1] + int(route == "chunked"))
    want = _rwkv6_grads(ref.rwkv6_scan_ref, (r, k, v, w, u, s0), dy, ds)
    for g, x in zip(got, want):
        scale = float(x.float().abs().max())
        torch.testing.assert_close(g.float(), x.float(), rtol=0,
                                   atol=TOL[dtype] * scale)


@pytest.mark.parametrize("w_lo,w_hi,zeros", [(0.45, 0.95, False),
                                             (0.0, 1.0, True)])
def test_rwkv6_backward_chunked_is_deterministic(card, w_lo, w_hi, zeros):
    """Two calls of the chunked route at the training shape give the same
    bits (no atomics), exact rows included."""
    B, T, NH = 2, 1024, 40
    r, k, v, w, u = _rwkv6_case(card, B, T, NH, 64, w_lo, w_hi, zeros=zeros)
    s0, ds = (_rand(card, (B, NH, 64, 64)) for _ in range(2))
    dy = _rand(card, (B, T, NH, 64)).to(torch.bfloat16)
    assert rwkv6_scan.backward_kernel_for(r, k, v, w, dy) == "chunked"
    a = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    b = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rwkv6_backward_occupancy(card):
    """Two carry blocks fit an SM, so the training shape's 160 are one
    wave on 132 SMs; a chunk block (16 warps, ~183 KB) fits one."""
    occ = rwkv6_scan.backward_occupancy()
    assert occ["chunked_carries"] >= 2 and occ["chunked_chunks"] >= 1 \
        and occ["step"] >= 1, occ


@pytest.mark.parametrize("arch", ["llama32-3b", "rwkv6-3b", "zamba2-2.7b"])
def test_train_step_on_card_matches_cpu(card, arch):
    """Two f32 steps of the reduced model's train step (llama: the flash
    forward and backward kernels on the card; rwkv6: the scan's; zamba2:
    the SSD scan's and flash's) from the same params and batches as on
    the CPU: the same losses within 2e-4 (the second one after an
    update)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.steps import build_train_step
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw
    cfg = configs.reduce_for_smoke(configs.REGISTRY[arch])
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    kernels = {"flash": flash_prefill.flash_attention,
               "rwkv6": rwkv6_scan.rwkv6_scan,
               "ssd": mamba2_ssd.mamba2_ssd}
    bwd = {k: fn.backward_launches for k, fn in kernels.items()}
    for dev in ("cuda", "cpu"):
        opt = adamw(1e-3)
        step = build_train_step(cfg, make_host_mesh(device_type=dev),
                                InputShape("t", 128, 2, "train"),
                                optimizer=opt)
        p = _to(params, dev)
        state, data, losses = opt.init(p), SyntheticLM(cfg, 2, 128), []
        for _ in range(2):
            p, state, loss = step.fn(p, state, data.next_batch())
            losses.append(loss.cpu())
        out[dev] = torch.stack(losses)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=0, rtol=2e-4)
    launched = {k: fn.backward_launches - bwd[k]
                for k, fn in kernels.items()}
    L, want = cfg.num_layers, {"flash": 0, "rwkv6": 0, "ssd": 0}
    if arch == "zamba2-2.7b":      # a shared-block call every few layers
        want.update(flash=L // cfg.hybrid.shared_attn_every, ssd=L)
    else:
        want[{"llama32-3b": "flash", "rwkv6-3b": "rwkv6"}[arch]] = L
    assert launched == {k: 2 * n for k, n in want.items()}


# ----------------------------------------------------------------------
# the perf flags on the card
# ----------------------------------------------------------------------
@pytest.fixture
def flags():
    """The port's flag registry, cleared after the test."""
    from repro_torch.dist import opt_flags
    yield opt_flags
    opt_flags.set_flags("")


PAD_CLASSES = [(56, 8), (14, 2), (7, 1), (24, 8), (40, 8), (12, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", PAD_CLASSES)
def test_pad_heads_through_flash_kernel_is_exact(card, flags, dtype, H, KV):
    """pad_heads regroups the heads (16 kv heads, H rounded up) and the
    kernel gives each head the numbers it gives it ungrouped."""
    from repro_torch.models import layers as L
    q = torch.randn(2, 200, H, 128, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(2, 200, KV, 128, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    base = L.flash_gqa(q, k, v, causal=True)
    flags.set_flags("pad_heads")
    before = flash_prefill.flash_attention.launches
    tuned = L.flash_gqa(q, k, v, causal=True)
    assert flash_prefill.flash_attention.launches == before + 1
    assert torch.equal(tuned, base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV", [(24, 8), (56, 8), (7, 1)])
def test_pad_heads_gradients_through_backward_kernel(card, flags,
                                                     monkeypatch, dtype, H,
                                                     KV):
    """Under pad_heads the kernels run at the regrouped heads (q padded,
    each kv head duplicated). The gradients with respect to the kernels'
    own inputs are held to autograd of the plain version on the same
    regrouped inputs; in f32 the gradients folded back to the model's
    heads also to the ungrouped plain version. (In bf16 each duplicate's
    dK and dV are rounded to bf16 before the fold sums them, on both
    paths, as ``jnp.repeat``'s gradient does in the reference: where the
    duplicates' parts cancel, the sum keeps their rounding.)"""
    from repro_torch.models import layers as L
    q = torch.randn(2, 256, H, 128, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(2, 256, KV, 128, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    dout = torch.randn_like(q)
    dispatch = L.ops.flash_attention

    def grads(attention):
        """(grads at the kernel's inputs, grads at q, k, v)."""
        seen = []

        def spy(*args, **kw):
            seen.append(args)
            return attention(*args, **kw)
        monkeypatch.setattr(L.ops, "flash_attention", spy)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = L.flash_gqa(*qkv)
        assert len(seen) == 1 and seen[0][2].shape[2] == 16
        g = torch.autograd.grad(out, [*seen[0], *qkv], dout)
        return g[:3], g[3:]
    flags.set_flags("pad_heads")
    bwd = flash_prefill.flash_attention.backward_launches
    got, folded = grads(dispatch)
    assert flash_prefill.flash_attention.backward_launches == bwd + 1
    want, _ = grads(ref.flash_attention_ref)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    if dtype == torch.float32:
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(ref.flash_attention_ref(*qkv), qkv, dout)
        for g, w in zip(folded, plain):
            torch.testing.assert_close(g, w, atol=TOL[dtype], rtol=TOL[dtype])


def test_masked_cache_update_is_exact_on_card(card, flags):
    cfg = configs.reduce_for_smoke(configs.REGISTRY["qwen2-0.5b"])
    model = get_model(cfg)
    params = model.init(card, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=card,
                         device="cuda")
    pos = torch.full((2,), 15, dtype=torch.int32, device="cuda")
    out = {}
    with torch.no_grad():
        for name in ("", "masked_cache_update"):
            flags.set_flags(name)
            _, state = model.prefill(params, {"tokens": toks[:, :15]},
                                     s_max=16)
            out[name] = model.decode_step(params, toks[:, 15], state, pos)
    (a, sa), (b, sb) = out[""], out["masked_cache_update"]
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_train_step_on_host_mesh_is_the_device_path(card):
    """Two bf16 steps of the reduced llama built on ``make_host_mesh``
    (one card, (1, 1)) against the same steps written out on the device
    (loss, autograd, AdamW in place): bit for bit."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.steps import build_train_step, to_device
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import adamw
    cfg = configs.reduce_for_smoke(configs.REGISTRY["llama32-3b"]).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
    init = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for path in ("mesh", "device"):
        opt = adamw(1e-3)
        bundle = build_train_step(cfg, mesh, InputShape("t", 128, 2,
                                                        "train"),
                                  optimizer=opt)
        p = _to(init, "cuda")
        state, data, losses = opt.init(p), SyntheticLM(cfg, 2, 128), []
        for _ in range(2):
            batch = data.next_batch()
            if path == "mesh":
                p, state, loss = bundle.fn(p, state, batch)
            else:
                leaves = tree_leaves(p)
                for x in leaves:
                    x.requires_grad_(True)
                loss, _ = bundle.model.loss(p, to_device(batch, "cuda"))
                grads = list(torch.autograd.grad(
                    loss, leaves, allow_unused=True, materialize_grads=True))
                for x in leaves:
                    x.requires_grad_(False)
                state = opt.update_(grads, state, p)
            losses.append(loss.detach())
        out[path] = (torch.stack(losses), tree_leaves(p))
    assert torch.equal(out["mesh"][0], out["device"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["mesh"][1],
                                                 out["device"][1]))


# ----------------------------------------------------------------------
# the kernels as operators
# ----------------------------------------------------------------------
def _op_cases_on_card(card, dtype):
    def r(*s):
        return torch.randn(*s, generator=card, device="cuda").to(dtype)

    def f32(*s):
        return torch.randn(*s, generator=card, device="cuda")

    def u(*s):
        return torch.rand(*s, generator=card, device="cuda")
    B, S, H, KV, hd, N = 2, 100, 4, 2, 64, 64
    q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
    out, lse = flash_prefill.flash_fwd_lse(q, k, v, True, 0, 0)
    rk = [r(B, S, H, hd), r(B, S, H, hd), r(B, S, H, hd),
          0.5 + 0.45 * u(B, S, H, hd), f32(H, hd), f32(B, H, hd, hd)]
    ssd = [r(B, S, H, hd), 0.1 * u(B, S, H), -u(H), r(B, S, N), r(B, S, N),
           f32(H), f32(B, H, N, hd)]
    pages = 8
    return {
        "flash_fwd": (flash_prefill.flash_fwd, (q, k, v, True, 0, 0)),
        "flash_fwd_lse": (flash_prefill.flash_fwd_lse,
                          (q, k, v, True, 40, 3)),
        "flash_bwd": (flash_prefill.flash_bwd,
                      (q, k, v, out, r(B, S, H, hd), lse, True, 0, 0)),
        "paged_attention": (paged_decode.paged_op, (
            r(B, H, hd), r(pages, 16, KV, hd), r(pages, 16, KV, hd),
            torch.arange(pages, dtype=torch.int32,
                         device="cuda").reshape(B, pages // B),
            torch.tensor([20, 64], dtype=torch.int32, device="cuda"))),
        "rwkv6_scan": (rwkv6_scan.scan_op, tuple(rk)),
        "rwkv6_scan_bwd": (rwkv6_scan.backward_op, (
            *rk, r(B, S, H, hd), f32(B, H, hd, hd), None)),
        "mamba2_ssd": (mamba2_ssd.scan_op, tuple(ssd)),
        "mamba2_ssd_bwd": (mamba2_ssd.backward_op, (
            *ssd, r(B, S, H, hd), f32(B, H, N, hd))),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_opcheck_on_card(card, dtype):
    """Each kernel operator on CUDA tensors (the hand kernels launch):
    schema, autograd registration, its fake implementation against the
    kernel's outputs (shapes, dtypes, strides: the lse's padded rows
    included), and AOT dispatch."""
    for name, (op, args) in _op_cases_on_card(card, dtype).items():
        res = torch.library.opcheck(op.default, args)
        assert set(res.values()) == {"SUCCESS"}, (name, res)


# ----------------------------------------------------------------------
# the dense paged decode step replayed as CUDA graphs
# ----------------------------------------------------------------------
def _graph_cfg():
    """A tiny dense config at yi-34b's head shape: hd 128, G = 7, bf16."""
    cfg = configs.reduce_for_smoke(configs.REGISTRY["yi-34b"])
    return dataclasses.replace(cfg, d_model=256, num_heads=14,
                               num_kv_heads=2, head_dim=128, d_ff=512,
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def _graph_pool(cfg, model, params, lens, card, steps=20):
    pool = PagedKVPool(num_pages=sum(-(-(n + steps) // 16) for n in lens)
                       + 3, page_size=16)
    kv = DevicePagedKV(pool, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                       dtype=torch.bfloat16, device="cuda")
    pool.allocate(999, 40)                 # scatter the sequences' pages
    for sid, n in enumerate(lens):
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=card,
                             device="cuda")
        _, cache = model.prefill(params, {"tokens": toks})
        pool.allocate(sid, n)
        kv.write_prefill(sid, cache.k[:, 0], cache.v[:, 0])
    pool.free_seq(999)
    return kv


def _step_inputs(kv, ctx):
    """Each row's new page granted, and the executor's block table."""
    for s in range(len(ctx)):
        kv.pool.allocate(s, 1)
    tables = [kv.pool.block_table(s) for s in range(len(ctx))]
    w = max(map(len, tables))
    bt = torch.tensor([t + [0] * (w - len(t)) for t in tables],
                      dtype=torch.int32, device="cuda")
    return bt, torch.tensor(ctx, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("lens", [
    [5], [3, 70], [17, 250, 1, 99], [40] * 8, [1200, 7, 640, 33, 1250],
    [2 + 50 * i for i in range(13)], [30 + 7 * i for i in range(64)]],
    ids=lambda lens: f"B{len(lens)}")
def test_decode_graph_replays_the_eager_step(card, lens):
    """20 steps replayed against the eager step on the same inputs (the
    eager step's greedy tokens fed to both): the same tokens, logits
    within bf16 rounding, the K/V pages bit for bit except the sink,
    each replay's logits a tensor of its own, and one paged launch
    counted a layer a step, as eagerly (the capture's warm-up and the
    captures themselves are not steps)."""
    cfg = _graph_cfg()
    model = get_model(cfg)
    params = model.init(card, "cuda")
    kv = _graph_pool(cfg, model, params, lens, card)
    ke, ve = kv.k.clone(), kv.v.clone()          # the eager run's pages
    sink, B, st = kv.sink_page, len(lens), model.graph_stats
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=card,
                         device="cuda")
    ctx, prev = list(lens), None
    for step in range(20):
        bt, pos = _step_inputs(kv, ctx)
        n0 = paged_decode.paged_attention.launches
        want = model.decode_step_paged(params, toks, ke, ve, bt, pos)
        n1 = paged_decode.paged_attention.launches
        got = model.decode_step_paged(params, toks, kv.k, kv.v, bt, pos,
                                      sink_page=sink)
        n2 = paged_decode.paged_attention.launches
        assert st.last == DG.bucket_for(B)
        assert n1 - n0 == cfg.num_layers
        assert n2 - n1 == cfg.num_layers
        assert got.shape == want.shape and got._base is None
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        if prev is not None:                 # not overwritten by a replay
            assert torch.equal(prev[0], prev[1])
        prev = (got, got.clone())
        toks = want.argmax(-1)
        ctx = [c + 1 for c in ctx]
    torch.cuda.synchronize()
    assert torch.equal(kv.k[:, :sink], ke[:, :sink])
    assert torch.equal(kv.v[:, :sink], ve[:, :sink])
    assert dict(st.eager) == {"no_sink": 20} and st.replays == 20
    assert st.captures == len(DG.to_capture(B, ()))


def test_decode_graph_falls_back_past_the_table_width(card):
    """A table one page past the single-run width runs eagerly."""
    cfg = _graph_cfg()
    model = get_model(cfg)
    params = model.init(card, "cuda")
    width = 80
    kv = _graph_pool(cfg, model, params, [width * 16 - 1, 40], card, 2)
    assert DG.table_width(kv.k) == width
    ke, ve = kv.k.clone(), kv.v.clone()
    ctx, toks, st = [width * 16 - 1, 40], torch.tensor([1, 2]).cuda(), \
        model.graph_stats
    for step, last in enumerate((2, 0)):
        bt, pos = _step_inputs(kv, ctx)
        assert bt.shape[1] == width + step
        want = model.decode_step_paged(params, toks, ke, ve, bt, pos)
        got = model.decode_step_paged(params, toks, kv.k, kv.v, bt, pos,
                                      sink_page=kv.sink_page)
        assert st.last == last
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        ctx = [c + 1 for c in ctx]
    assert st.eager["width"] == 1 and st.replays == 1


def test_decode_graphs_serve_waves_without_new_captures(card):
    """Real-mode dis-host waves over one model and one pool, as the
    benchmark serves them: a first wave captures, a second (new
    executors, same pool) captures nothing and replays every step; both
    serve the eager run's tokens with its paged launches, and each
    ``decode.forward`` span names its bucket (0 eagerly)."""
    from repro_torch import core as T
    from repro_torch.launch.serve import device_kv
    from repro_torch.obs import Tracer
    cfg = _graph_cfg()
    model = get_model(cfg)
    params = model.init(card, "cuda")
    st = model.graph_stats

    def reqs():
        return T.random_workload(12, input_len=30, output_len=24,
                                 vocab_size=cfg.vocab_size, seed=5)
    kv, kv_eager = device_kv(cfg, reqs(), "cuda"), device_kv(cfg, reqs(),
                                                             "cuda")
    kv_eager.sink_page = None
    out = {}
    for name, pool in (("eager", kv_eager), ("first", kv), ("second", kv)):
        tr = Tracer(enabled=False, wall=True)
        n0, c0, r0 = (paged_decode.paged_attention.launches, st.captures,
                      st.replays)
        rs = reqs()
        T.make_cluster("dis-host", cfg, executor_factory=lambda path, p=pool:
                       T.RealExecutor(model, params, p, transfer_path=path),
                       tracer=tr).run(rs)
        steps = [(s.args["graph"], tr.walls[s.parent].args["rows"])
                 for s in tr.walls if s.name == "decode.forward"]
        out[name] = ([r.output_tokens for r in rs],
                     paged_decode.paged_attention.launches - n0,
                     st.captures - c0, st.replays - r0, steps)
    eager, first, second = out["eager"], out["first"], out["second"]
    assert eager[4] and all(g == 0 for g, _ in eager[4])
    for run in (first, second):
        assert run[0] == eager[0]
        assert [g for g, _ in run[4]] == [DG.bucket_for(n)
                                          for _, n in run[4]]
        assert run[3] == len(run[4])
    assert first[2] > 0 and second[2] == 0
    assert first[1] == second[1] == eager[1]
    assert dict(st.eager) == {"no_sink": len(eager[4])}
