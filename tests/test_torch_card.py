"""The CUDA kernels on the card: each against its plain torch version,
and the reduced model's prefill + paged decode on the card against the
same on the CPU. They skip without a card (the kernels have no CPU
mode). This file imports neither jax nor the reference, so it also runs
on a machine that has only torch:

  python -m pytest --noconftest -q tests/test_torch_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core import DevicePagedKV, PagedKVPool  # noqa: E402
from repro_torch.kernels import flash_prefill, paged_decode, ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

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
@pytest.mark.parametrize("H,KV,hd,page", [(8, 2, 64, 16), (7, 1, 128, 8),
                                          (4, 4, 32, 16)])
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


def test_wrappers_reject_bad_inputs(card):
    q = torch.zeros(1, 8, 2, 80, device="cuda")
    with pytest.raises(ValueError, match="head dim 80"):
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
