"""The flash backward kernels' block plans, mirrored in torch and held
against autograd of the plain version; the forward's log-sum-exp; and
rows that see no key.

``csrc/flash_backward.cu`` cannot run here, so these mirrors repeat its
two plans on the CPU. Both take each query row's log-sum-exp (log2
domain) from a mirror of the forward kernel's online softmax over its
64-key tiles, and D = rowsum(dO * O) from a pre-pass; dK and dV are
computed per key tile over the query tiles of all G heads of its group,
skipping the tiles no pair can see but visiting the trailing rows that
see no key (the plain version's uniform 1/T); dQ per query tile over its
visible key tiles. The index arithmetic (``key_range``, ``query_tiles``,
``visible``, ``keyless``, the warpgroups' ``need``) is the kernel's,
line for line.

- ``cuda_cores`` (f32): 64 x 64 tiles, scores [query rows, keys], f32
  throughout. Tolerance 1e-5: f32 sums in another order.
- ``wgmma`` (bf16): dK/dV blocks of 128 keys, two warpgroups of 64 keys
  each, which skip a query tile their keys do not need; scores computed
  transposed (S^T = K Q^T, dP^T = V dO^T); P^T and dS^T rounded to bf16
  before dV += P^T dO and dK += dS^T Q; dQ blocks of 128 rows in two
  warpgroups of 64, dS rounded to bf16 before dQ += dS K; inputs, O and
  the gradients in bf16, sums in f32. Tolerance 2e-2, the card's for
  bf16, against autograd of the plain version in f32 on the same
  bf16 inputs.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_prefill as j_flash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_prefill, ref  # noqa: E402

TILE = 64
TOL = {"cuda_cores": 1e-5, "wgmma": 2e-2}
PLANS = ("cuda_cores", "wgmma")
BLOCK_KEYS = {"cuda_cores": TILE, "wgmma": 2 * TILE}


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
    """The query tiles a dK/dV block of the keys [t0, t0 + keys) visits
    (the kernel's QueryTiles)."""
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
        out.append(qt)
        qt += 1
        if seen_end <= qt < tail:
            qt = tail
    return out


def need(tw, i0, S, T, causal, window, q_offset):
    """Whether a wgmma warpgroup of the keys [tw, tw + 64) computes the
    query tile at i0: its keys see a row of it, or it holds a row that
    sees no key."""
    lo, hi = key_range(i0, min(i0 + TILE, S) - 1, T, causal, window,
                       q_offset)
    keyless_from = max(0, T + window - 1 - q_offset) if window > 0 else S
    return tw < T and ((lo <= hi and lo <= min(tw + TILE, T) - 1
                        and hi >= tw) or keyless_from < min(i0 + TILE, S))


# ----------------------------------------------------------------------
# the mirrors
# ----------------------------------------------------------------------
def _tile(x, start, n):
    """Rows [start, start + TILE) of x [N, hd], zero past n."""
    out = x.new_zeros((TILE, x.shape[-1]))
    rows = min(TILE, n - start)
    out[:rows] = x[start:start + rows]
    return out


def _bf16(x):
    return x.bfloat16().float()


def forward_lse(q, k, *, causal, window, q_offset):
    """Each query row's log-sum-exp in the log2 domain as the forward
    kernels keep it: per 64 rows an online softmax over the 64-key tiles
    their keys fall in (running max, rescaled sum), m + log2(l); 0 for a
    row that sees no key. [B, H, S] f32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    sc = math.log2(math.e) / math.sqrt(hd)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k = q.float(), k.float()
    ar = torch.arange(TILE)
    lse = torch.zeros(B, H, S)
    for b in range(B):
        for h in range(H):
            for i0 in range(0, S, TILE):
                rows = min(TILE, S - i0)
                i = (i0 + ar)[:, None]
                m = torch.full((TILE,), -math.inf)
                l = torch.zeros(TILE)
                for t0 in key_tiles(*key_range(i0, i0 + rows - 1, T,
                                               **mask)):
                    t = (t0 + ar)[None, :]
                    s = _tile(q[b, :, h], i0, S) @ _tile(k[b, :, h // G],
                                                         t0, T).T
                    s = torch.where(visible(i, t, S, T, **mask), s * sc,
                                    -math.inf)
                    m_new = torch.maximum(m, s.max(1).values)
                    base = torch.where(m_new == -math.inf, 0.0, m_new)
                    l = l * torch.exp2(m - base) + torch.exp2(
                        s - base[:, None]).sum(1)
                    m = m_new
                lse[b, h, i0:i0 + rows] = torch.where(
                    l > 0, m + torch.log2(l), 0.0)[:rows]
    return lse


def backward_plan(q, k, v, out, dout, lse, *, plan, causal, window,
                  q_offset):
    """(dq, dk, dv, visited) as the kernels of ``plan`` compute them;
    ``visited`` holds the (query tile, 64-key tile) pairs the dK/dV
    kernel computes (the same for every head)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    sc = math.log2(math.e) * scale
    wgmma = plan == "wgmma"
    rnd = _bf16 if wgmma else (lambda x: x)
    q, k, v, out, dout = (x.float() for x in (q, k, v, out, dout))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    ar = torch.arange(TILE)
    delta = (out * dout).sum(-1).permute(0, 2, 1)        # the pre-pass

    def probs(b, h, i0, t0):
        """P and dS of the query tile at i0 by the key tile at t0, [rows,
        keys], as the products take them (rounded to bf16 for wgmma)."""
        qt, dot = _tile(q[b, :, h], i0, S), _tile(dout[b, :, h], i0, S)
        kt, vt = _tile(k[b, :, h // G], t0, T), _tile(v[b, :, h // G], t0, T)
        i, t = (i0 + ar)[:, None], (t0 + ar)[None, :]
        vis = visible(i, t, S, T, **mask)
        lse_t = _tile(lse[b, h][:, None], i0, S)
        d_t = _tile(delta[b, h][:, None], i0, S)
        if wgmma:     # keys as the rows: S^T = K Q^T, dP^T = V dO^T
            s, dp = (kt @ qt.T).T, (vt @ dot.T).T
        else:
            s, dp = qt @ kt.T, dot @ vt.T
        p = torch.where(vis, torch.exp2(s * sc - lse_t), 0.0)
        p = torch.where(keyless(i, S, T, window, q_offset) & (t < T)
                        & ~vis, 1.0 / T, p)
        ds = torch.where(vis, p * (dp - d_t), 0.0)
        return qt, dot, kt, rnd(p), rnd(ds)

    # dK, dV: blocks of BLOCK_KEYS keys, 64 keys a warpgroup, over the
    # query tiles of the group's G heads
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    visited = set()
    for b in range(B):
        for kh in range(KV):
            for t0 in range(0, T, BLOCK_KEYS[plan]):
                tiles = query_tiles(t0, min(BLOCK_KEYS[plan], T - t0), S, T,
                                    **mask)
                for tw in range(t0, min(t0 + BLOCK_KEYS[plan], T), TILE):
                    acc_k, acc_v = torch.zeros(TILE, hd), torch.zeros(TILE, hd)
                    for h in range(kh * G, kh * G + G):
                        for qt in tiles:
                            if wgmma and not need(tw, qt * TILE, S, T,
                                                  **mask):
                                continue
                            visited.add((qt, tw // TILE))
                            qtile, dot, _, p, ds = probs(b, h, qt * TILE, tw)
                            acc_v += p.T @ dot
                            acc_k += ds.T @ qtile
                    keys = min(TILE, T - tw)
                    dk[b, tw:tw + keys, kh] = (acc_k * scale)[:keys]
                    dv[b, tw:tw + keys, kh] = acc_v[:keys]

    # dQ: 64 query rows (a warpgroup's) over their key tiles
    dq = torch.zeros_like(q)
    for b in range(B):
        for h in range(H):
            for i0 in range(0, S, TILE):
                rows = min(TILE, S - i0)
                acc = torch.zeros(TILE, hd)
                for t0 in key_tiles(*key_range(i0, i0 + rows - 1, T,
                                               **mask)):
                    acc += probs(b, h, i0, t0)[4] @ _tile(k[b, :, h // G],
                                                          t0, T)
                dq[b, i0:i0 + rows, h] = (acc * scale)[:rows]
    return rnd(dq), rnd(dk), rnd(dv), visited


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
    (200, 260, 2, 1, 64, True, 0, 60),       # 128-key blocks, hd 64
]
MASK_ARGS = "S,T,H,KV,hd,causal,window,q_offset"


def _inputs(S, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, S, H, hd), (2, T, KV, hd), (2, T, KV, hd),
                      (2, S, H, hd))]


def _plan_inputs(plan, S, T, H, KV, hd, mask):
    """q, k, v, dO (bf16 values for the wgmma plan), O in the same type,
    and the forward mirror's lse."""
    q, k, v, dout = _inputs(S, T, H, KV, hd)
    if plan == "wgmma":
        q, k, v, dout = (_bf16(x) for x in (q, k, v, dout))
    out = ref.flash_attention_ref(q, k, v, **mask)
    if plan == "wgmma":
        out = _bf16(out)
    return q, k, v, out, dout, forward_lse(q, k, **mask)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize(MASK_ARGS, CASES)
def test_block_plan_matches_plain_autograd(plan, S, T, H, KV, hd, causal,
                                           window, q_offset):
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, out, dout, lse = _plan_inputs(plan, S, T, H, KV, hd, mask)
    want = flash_prefill.flash_attention_backward(q, k, v, out, dout, **mask)
    got = backward_plan(q, k, v, out, dout, lse, plan=plan, **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=TOL[plan], rtol=TOL[plan],
                                   msg=name)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize(MASK_ARGS, CASES)
def test_block_plan_skips_only_empty_tiles(plan, S, T, H, KV, hd, causal,
                                           window, q_offset):
    """dK/dV compute exactly the (query tile, 64-key tile) pairs holding a
    visible pair or a keyless row, whether a block owns 64 keys or 128 in
    two warpgroups; dQ's key loop covers every visible pair."""
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, out, dout, lse = _plan_inputs(plan, S, T, H, KV, hd, mask)
    _, _, _, visited = backward_plan(q, k, v, out, dout, lse, plan=plan,
                                     **mask)
    i, t = torch.arange(S)[:, None], torch.arange(T)[None, :]
    vis = visible(i, t, S, T, **mask)
    empty = keyless(torch.arange(S), S, T, window, q_offset)
    want = set()
    for qt in range(-(-S // TILE)):
        for kt in range(-(-T // TILE)):
            rows, keys = slice(qt * TILE, (qt + 1) * TILE), \
                slice(kt * TILE, (kt + 1) * TILE)
            if vis[rows, keys].any() or empty[rows].any():
                want.add((qt, kt))
    assert visited == want
    for i0 in range(0, S, TILE):
        rows = min(TILE, S - i0)
        tiles = set(key_tiles(*key_range(i0, i0 + rows - 1, T, **mask)))
        seen = {t0 for t0 in range(0, T, TILE)
                if vis[i0:i0 + rows, t0:t0 + TILE].any()}
        assert seen <= tiles


@pytest.mark.parametrize(MASK_ARGS, CASES)
def test_forward_lse_is_log2_logsumexp_of_visible_scores(
        S, T, H, KV, hd, causal, window, q_offset):
    """The forward mirror's online log-sum-exp equals the log2-domain
    log-sum-exp of the plain version's visible scores, 0 on the rows that
    see no key; 2^(s log2(e)/sqrt(hd) - lse) then sums to 1 over each
    other row's visible keys. The CPU wrapper returns the plain one."""
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, _ = _inputs(S, T, H, KV, hd)
    got = forward_lse(q, k, **mask)
    want = ref.flash_attention_lse_ref(q, k, **mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    empty = keyless(torch.arange(S), S, T, window, q_offset)
    assert bool((got[:, :, empty] == 0).all())
    G = H // KV
    s = torch.einsum("bshd,bthd->bhst", q,
                     k.repeat_interleave(G, dim=2)) / math.sqrt(hd)
    vis = visible(torch.arange(S)[:, None], torch.arange(T)[None, :], S, T,
                  **mask)
    mass = torch.where(vis, torch.exp2(s * math.log2(math.e)
                                       - got[..., None]), 0.0).sum(-1)
    torch.testing.assert_close(mass[:, :, ~empty],
                               torch.ones_like(mass[:, :, ~empty]),
                               atol=1e-5, rtol=1e-5)
    out, lse = flash_prefill.flash_attention_with_lse(q, k, v, **mask)
    torch.testing.assert_close(lse, want, atol=0, rtol=0)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v, **mask),
                               atol=0, rtol=0)


def test_keyless_rows_plain_reference_and_pallas_agree():
    """Rows that see no key (window 30, q_offset 80: rows 69..99 of 100)
    get the mean of V over the T keys of their kv head in the port's
    plain forward, the reference's plain version and the Pallas kernel in
    interpret mode at its default blocks: the contract the forward
    kernel's repair follows."""
    S, T, H, KV, hd = 100, 120, 4, 2, 32
    mask = dict(causal=True, window=30, q_offset=80)
    q, k, v, _ = _inputs(S, T, H, KV, hd)
    port = ref.flash_attention_ref(q, k, v, **mask).numpy()
    jx = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    want = np.asarray(jref.flash_attention_ref(*jx, **mask))
    pallas = np.asarray(j_flash.flash_attention(*jx, interpret=True, **mask))
    np.testing.assert_allclose(port, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pallas, want, atol=1e-5, rtol=1e-5)
    rows = keyless(torch.arange(S), S, T, 30, 80).numpy()
    assert rows.sum() == 31
    mean = np.repeat(v.numpy().mean(1), H // KV, axis=1)    # [B, H, hd]
    for x in (port, pallas):
        np.testing.assert_allclose(
            x[:, rows], np.broadcast_to(mean[:, None], x[:, rows].shape),
            atol=1e-5, rtol=1e-5)


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
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=TOL["cuda_cores"],
                                   rtol=TOL["cuda_cores"])
