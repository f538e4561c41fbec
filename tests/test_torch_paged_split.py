"""The split-KV paged decode kernel's plan and arithmetic on the CPU.

``split_plan`` (which pages each block walks) is a pure function of
host-known sizes; ``split_kv_mirror`` below repeats the kernel's
arithmetic in torch: each split's warps take every W-th tile of 16
tokens with a running (max, sum, O) in f32, P rounded to bf16 before
O += P V as the bf16 kernel does, the warps merged in the block, the
splits merged by the row's last block, a partial that saw no token
skipped. Both are held against the plain version and the reference's
Pallas kernel (interpret mode) on numpy inputs from a seed. The kernel
itself runs only on the card (tests/test_torch_card.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402

from repro.kernels import paged_decode as j_paged  # noqa: E402
from repro_torch.kernels import paged_decode as t_paged  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TILE = 16


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------
def _runs(splits, split_pages, max_pages):
    return [range(s * split_pages, min((s + 1) * split_pages, max_pages))
            for s in range(splits)]


class _NoTensors(torch.overrides.TorchFunctionMode):
    """Fails on any torch function call made inside it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the plan called {func}")


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), KV=st.integers(1, 16),
       max_pages=st.integers(0, 4096), page=st.sampled_from([1, 8, 16, 32,
                                                              64, 128]),
       row_bytes=st.sampled_from([64, 128, 256, 512]),
       sms=st.integers(1, 264))
def test_split_plan_covers_every_page_once(B, KV, max_pages, page,
                                           row_bytes, sms):
    t_paged.split_plan.cache_clear()
    with _NoTensors():
        splits, split_pages = t_paged.split_plan(B, KV, max_pages, page,
                                                 row_bytes, sms)
    assert type(splits) is int and type(split_pages) is int
    assert 1 <= split_pages <= t_paged.MAX_SPLIT_PAGES
    assert 1 <= splits <= t_paged.MAX_SPLITS
    if max_pages == 0:
        return
    runs = _runs(splits, split_pages, max_pages)
    assert all(len(r) > 0 for r in runs)                # none is empty
    assert [p for r in runs for p in r] == list(range(max_pages))


def test_split_plan_main_path_shapes():
    """The plans the card was tuned on (PERF.md): no split where the rows
    fill the card, splits where one long row must fill it."""
    plan = t_paged.split_plan
    assert plan(4, 8, 66, 16, 256, 132) == (1, 66)       # llama32-3b decode
    assert plan(32, 8, 68, 16, 256, 132) == (1, 68)
    assert plan(1, 8, 512, 16, 256, 132) == (8, 64)      # B=1 at 8K
    assert plan(4, 8, 2048, 16, 256, 132) == (26, 79)    # 32K, ragged


def test_split_plan_refuses_rows_past_its_reach():
    too_many = t_paged.MAX_SPLITS * t_paged.MAX_SPLIT_PAGES + 1
    with pytest.raises(ValueError, match="pages a row"):
        t_paged.split_plan(1, 1, too_many, 16, 256, 132)


# ----------------------------------------------------------------------
# the kernel's arithmetic
# ----------------------------------------------------------------------
def merge(parts):
    """Merge (m, l, acc) partials of one head (m, l scalars, acc [hd])
    as the kernel does: rescale to the largest max, skip any partial that
    saw no token (m = -inf; its acc is never read), 0 if none saw one."""
    live = [p for p in parts if p[0] != -math.inf]
    if not live:
        return -math.inf, 0.0, torch.zeros_like(parts[0][2])
    mx = max(m for m, _, _ in live)
    den = sum(l * 2.0 ** (m - mx) for m, l, _ in live)
    num = sum(a * 2.0 ** (m - mx) for m, _, a in live)
    return mx, den, num


def split_kv_mirror(q, k_pages, v_pages, block_table, seq_lens, splits,
                    split_pages, warps=8):
    """The kernel's split-KV arithmetic in torch, f32, exp2 domain."""
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    G = H // KV
    bf16 = q.dtype == torch.bfloat16
    max_pages = block_table.shape[1]
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = min(max(int(seq_lens[b]), 0), max_pages * page)
        split_tok = split_pages * page
        live = max(1, -(-n // split_tok))
        for h in range(KV):
            qg = q[b, h * G:(h + 1) * G].float()                 # [G, hd]
            partials = []                                       # per split
            for s in range(live):
                tok0 = s * split_tok
                t_end = min(tok0 + split_tok, n)
                tiles = list(range(tok0, max(t_end, tok0), TILE))
                per_warp = []
                for w in range(warps):
                    m = torch.full((G,), -math.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, hd)
                    for t0 in tiles[w::warps]:
                        ts = range(t0, min(t0 + TILE, t_end))
                        pg = block_table[b, [t // page for t in ts]].long()
                        sl = torch.tensor([t % page for t in ts])
                        kt = k_pages[pg, sl, h].float()         # [n, hd]
                        vt = v_pages[pg, sl, h].float()
                        x = qg @ kt.T * scale_log2               # [G, n]
                        m_new = torch.maximum(m, x.max(-1).values)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        pv = p.bfloat16().float() if bf16 else p
                        acc = acc * alpha[:, None] + pv @ vt
                        m = m_new
                    per_warp.append((m, l, acc))
                partials.append([merge([(pw[0][g].item(), pw[1][g].item(),
                                         pw[2][g]) for pw in per_warp])
                                 for g in range(G)])
            for g in range(G):
                _, den, num = merge([p[g] for p in partials])
                out[b, h * G + g] = num / den if den > 0 else 0.0
    return out.to(q.dtype)


def _inputs(seed, B, H, KV, hd, page, max_pages, lens, dtype):
    """The same values for both packages: q, pages, a block table of
    distinct shuffled pages, the lengths."""
    rng = np.random.default_rng(seed)
    P = B * max_pages + 3
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, hd), (P, page, KV, hd), (P, page, KV, hd))]
    bt = rng.permutation(P)[:B * max_pages].reshape(B, max_pages)
    bt = bt.astype(np.int32)
    lens = np.asarray(lens, np.int32)
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return ((*jx, jnp.asarray(bt), jnp.asarray(lens)),
            (*tx, torch.from_numpy(bt), torch.from_numpy(lens)))


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KV,hd,page,max_pages,lens,splits,split_pages", [
        (2, 4, 2, 32, 8, 6, [1, 1], 3, 2),             # len 1, G 2
        (2, 6, 2, 64, 16, 4, [64, 64], 2, 2),          # len = max_pages*page
        (3, 8, 8, 32, 8, 8, [3, 9, 60], 4, 2),         # shorter than a split
        (2, 7, 1, 128, 16, 5, [70, 17], 3, 2),         # G 7 at hd 128
        (1, 16, 2, 64, 32, 4, [100], 2, 2),            # G 8, page 32
        (2, 8, 4, 128, 32, 3, [33, 96], 3, 1),         # one page a split
        (1, 4, 4, 64, 8, 4, [200], 2, 2),              # clamped to 32
        (2, 6, 2, 32, 16, 7, [5, 112], 1, 7),          # no split
    ])
def test_split_kv_mirror_vs_reference(B, H, KV, hd, page, max_pages, lens,
                                      splits, split_pages, dtype):
    seed = B * 1000 + H * 10 + hd + page + sum(lens)
    jx, tx = _inputs(seed, B, H, KV, hd, page, max_pages, lens, dtype)
    got = split_kv_mirror(*tx, splits, split_pages)
    _close(got, t_ref.paged_attention_ref(*tx), TOL[dtype])
    _close(got, j_paged.paged_attention(*jx, interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_mirror_with_the_wrappers_plan(dtype):
    """A row whose K and V pass MAX_SPLIT_BYTES is split by the plan the
    wrapper launches on the H100's 132 SMs, ragged lengths too; the
    mirror over that plan matches the plain version and the reference."""
    B, H, KV, hd, page, max_pages = 2, 2, 1, 32, 8, 263
    splits, split_pages = t_paged.split_plan(
        B, KV, max_pages, page, hd * TORCH[dtype].itemsize, 132)
    assert splits > 1
    jx, tx = _inputs(3, B, H, KV, hd, page, max_pages, [2100, 61], dtype)
    got = split_kv_mirror(*tx, splits, split_pages)
    _close(got, t_ref.paged_attention_ref(*tx), TOL[dtype])
    _close(got, j_paged.paged_attention(*jx, interpret=True), TOL[dtype])


def test_merge_skips_a_partial_that_saw_no_token():
    """An empty partial (m = -inf, l = 0, acc never written: here NaN)
    changes nothing, and a row of empty partials gives 0."""
    a = (1.5, 2.0, torch.tensor([1.0, -2.0]))
    b = (0.5, 3.0, torch.tensor([0.5, 4.0]))
    empty = (-math.inf, 0.0, torch.full((2,), float("nan")))
    m, den, num = merge([a, empty, b])
    assert (m, den) == merge([a, b])[:2]
    torch.testing.assert_close(num, merge([a, b])[2])
    assert merge([empty, empty])[1] == 0.0
