"""The flash backward kernel's block plan, mirrored in torch and held
against autograd of the plain version in f32.

``csrc/flash_backward.cu`` cannot run here, so this mirror repeats its
plan on the CPU: the same 64 x 64 tiles; the pre-pass (log-sum-exp in
the log2 domain and D = rowsum(dO * O) per query row); dK and dV per key
tile over the query tiles of all G heads of its group, skipping the
tiles no pair of the block can see but visiting the trailing rows that
see no key (the plain version's uniform 1/T); dQ per query tile over its
visible key tiles. The mirror's index arithmetic (``key_range``,
``query_tiles``, ``visible``, ``keyless``) is the kernel's, line for
line. Tolerance 1e-5: f32 sums in another order.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_prefill, ref  # noqa: E402

TILE = 64
TOL = 1e-5


# ----------------------------------------------------------------------
# the kernel's index arithmetic
# ----------------------------------------------------------------------
def visible(i, t, S, T, causal, window, q_offset):
    """i: [rows, 1], t: [1, keys] -> [rows, keys] bool."""
    qpos = i + q_offset
    m = (i < S) & (t < T)
    if causal:
        m = m & (t <= qpos)
    if window > 0:
        m = m & (t > qpos - window)
    return m


def keyless(i, S, T, window, q_offset):
    return (i < S) & (window > 0) & (i + q_offset >= T + window - 1)


def key_range(i_first, i_last, T, causal, window, q_offset):
    lo = max(0, i_first + q_offset - window + 1) if window > 0 else 0
    hi = min(T - 1, i_last + q_offset) if causal else T - 1
    return lo, hi


def key_tiles(lo, hi):
    return range(lo - lo % TILE, hi + 1, TILE) if lo <= hi else range(0)


def query_tiles(t0, keys, S, T, causal, window, q_offset):
    """The query tiles bwd_dkdv visits for the key tile at t0."""
    n = -(-S // TILE)
    t_last = t0 + keys - 1
    qlo = max(0, t0 - q_offset) if causal else 0
    qhi = min(S - 1, t_last + window - 1 - q_offset) if window > 0 \
        else S - 1
    seen_end = qhi // TILE + 1 if qlo <= qhi else 0
    keyless_from = max(0, T + window - 1 - q_offset) if window > 0 else S
    tail = max(keyless_from // TILE, seen_end) if keyless_from < S else n
    qt = qlo // TILE if qlo <= qhi else tail
    out = []
    while qt < n:
        if seen_end <= qt < tail:
            qt = tail
        if qt >= n:
            break
        out.append(qt)
        qt += 1
    return out


# ----------------------------------------------------------------------
# the mirror
# ----------------------------------------------------------------------
def _tile(x, start, n):
    """Rows [start, start + TILE) of x [N, hd], zero past n."""
    out = x.new_zeros((TILE, x.shape[-1]))
    rows = min(TILE, n - start)
    out[:rows] = x[start:start + rows]
    return out


def backward_plan(q, k, v, out, dout, *, causal, window, q_offset):
    """(dq, dk, dv, visited) as the kernel computes them, in f32;
    ``visited`` holds the (query tile, key tile) pairs bwd_dkdv visits
    (the same for every head)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = math.log2(math.e) * scale
    q, k, v, out, dout = (x.float() for x in (q, k, v, out, dout))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    ar = torch.arange(TILE)

    def probs(b, h, kh, i0, t0, lse, delta):
        qt, dot = _tile(q[b, :, h], i0, S), _tile(dout[b, :, h], i0, S)
        kt, vt = _tile(k[b, :, kh], t0, T), _tile(v[b, :, kh], t0, T)
        i, t = (i0 + ar)[:, None], (t0 + ar)[None, :]
        vis = visible(i, t, S, T, **mask)
        lse_t = _tile(lse[b, h][:, None], i0, S)
        d_t = _tile(delta[b, h][:, None], i0, S)
        p = torch.where(vis, torch.exp2((qt @ kt.T) * scale_log2 - lse_t),
                        0.0)
        p = torch.where(keyless(i, S, T, window, q_offset) & (t < T)
                        & ~vis, 1.0 / T, p)
        ds = torch.where(vis, p * ((dot @ vt.T) - d_t), 0.0)
        return qt, dot, kt, p, ds

    # 1. pre-pass
    lse = torch.zeros(B, H, S)
    delta = (out * dout).sum(-1).permute(0, 2, 1)
    for b in range(B):
        for h in range(H):
            kh = h // G
            for i0 in range(0, S, TILE):
                rows = min(TILE, S - i0)
                lo, hi = key_range(i0, i0 + rows - 1, T, **mask)
                s2 = torch.full((TILE, 0), -math.inf)
                for t0 in key_tiles(lo, hi):
                    i, t = (i0 + ar)[:, None], (t0 + ar)[None, :]
                    s = _tile(q[b, :, h], i0, S) @ _tile(k[b, :, kh], t0,
                                                         T).T
                    s2 = torch.cat([s2, torch.where(
                        visible(i, t, S, T, **mask), s * scale_log2,
                        -math.inf)], 1)
                m = s2.max(1).values if s2.shape[1] else \
                    torch.full((TILE,), -math.inf)
                ok = m > -math.inf
                mm = torch.where(ok, m, 0.0)
                lse_rows = torch.where(ok, mm + torch.log2(
                    torch.exp2(s2 - mm[:, None]).sum(1)), 0.0)
                lse[b, h, i0:i0 + rows] = lse_rows[:rows]

    # 2. dK, dV per key tile over the G heads' query tiles
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    visited = set()
    for b in range(B):
        for kh in range(KV):
            for t0 in range(0, T, TILE):
                keys = min(TILE, T - t0)
                acc_k, acc_v = torch.zeros(TILE, hd), torch.zeros(TILE, hd)
                for g in range(G):
                    h = kh * G + g
                    for qt in query_tiles(t0, keys, S, T, **mask):
                        visited.add((qt, t0 // TILE))
                        qtile, dot, _, p, ds = probs(b, h, kh, qt * TILE,
                                                     t0, lse, delta)
                        acc_v += p.T @ dot
                        acc_k += ds.T @ qtile
                dk[b, t0:t0 + keys, kh] = (acc_k * scale)[:keys]
                dv[b, t0:t0 + keys, kh] = acc_v[:keys]

    # 3. dQ per query tile over its key tiles
    dq = torch.zeros_like(q)
    for b in range(B):
        for h in range(H):
            for i0 in range(0, S, TILE):
                rows = min(TILE, S - i0)
                acc = torch.zeros(TILE, hd)
                for t0 in key_tiles(*key_range(i0, i0 + rows - 1, T,
                                               **mask)):
                    _, _, kt, _, ds = probs(b, h, h // G, i0, t0, lse, delta)
                    acc += ds @ kt
                dq[b, i0:i0 + rows, h] = (acc * scale)[:rows]
    return dq, dk, dv, visited


# (S, T, H, KV, hd, causal, window, q_offset)
CASES = [
    (100, 100, 4, 2, 32, True, 0, 0),        # partial tiles, G = 2
    (70, 150, 4, 4, 32, False, 0, 0),        # non-causal, S != T, MHA
    (130, 130, 6, 2, 80, True, 0, 0),        # three tiles, G = 3, hd 80
    (150, 150, 4, 2, 32, True, 40, 0),       # window
    (60, 190, 4, 2, 32, True, 0, 130),       # q_offset (chunked prefill)
    (100, 120, 4, 2, 32, True, 30, 80),      # rows 69.. see no key
    (90, 64, 2, 1, 32, False, 20, 60),       # non-causal, keyless rows
    (1, 100, 4, 4, 32, False, 0, 0),         # one query row
]


def _inputs(S, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, S, H, hd), (2, T, KV, hd), (2, T, KV, hd),
                      (2, S, H, hd))]


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,q_offset", CASES)
def test_block_plan_matches_plain_autograd(S, T, H, KV, hd, causal,
                                           window, q_offset):
    q, k, v, dout = _inputs(S, T, H, KV, hd)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out = ref.flash_attention_ref(q, k, v, **mask)
    want = flash_prefill.flash_attention_backward(q, k, v, out, dout, **mask)
    got = backward_plan(q, k, v, out, dout, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL, msg=name)


@pytest.mark.parametrize("S,T,H,KV,hd,causal,window,q_offset", CASES)
def test_block_plan_skips_only_empty_tiles(S, T, H, KV, hd, causal, window,
                                           q_offset):
    """dK/dV visit exactly the tiles holding a visible pair or a keyless
    row; dQ's key loop covers every visible pair."""
    q, k, v, dout = _inputs(S, T, H, KV, hd)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    _, _, _, visited = backward_plan(q, k, v, q, dout, **mask)
    i, t = torch.arange(S)[:, None], torch.arange(T)[None, :]
    vis = visible(i, t, S, T, **mask)
    empty = keyless(torch.arange(S), S, T, window, q_offset)
    need = set()
    for qt in range(-(-S // TILE)):
        for kt in range(-(-T // TILE)):
            rows, keys = slice(qt * TILE, (qt + 1) * TILE), \
                slice(kt * TILE, (kt + 1) * TILE)
            if vis[rows, keys].any() or empty[rows].any():
                need.add((qt, kt))
    assert visited == need
    for i0 in range(0, S, TILE):
        rows = min(TILE, S - i0)
        tiles = set(key_tiles(*key_range(i0, i0 + rows - 1, T, **mask)))
        seen = {t0 for t0 in range(0, T, TILE)
                if vis[i0:i0 + rows, t0:t0 + TILE].any()}
        assert seen <= tiles


def test_plain_autograd_matches_reference_vjp():
    """The port's plain backward (what the kernel is held to) against
    jax.vjp of the reference's flash_attention_ref, keyless rows
    included."""
    S, T, H, KV, hd = 100, 120, 4, 2, 32
    mask = dict(causal=True, window=30, q_offset=80)
    q, k, v, dout = _inputs(S, T, H, KV, hd, seed=3)
    out = ref.flash_attention_ref(q, k, v, **mask)
    got = flash_prefill.flash_attention_backward(q, k, v, out, dout, **mask)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, **mask), *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
