"""The chunked rwkv6 backward kernel's plan, mirrored in torch and held
against autograd of the port's plain scan and ``jax.vjp`` of the
reference's.

``rwkv6_bwd_deltas``, ``rwkv6_bwd_scan``, ``rwkv6_bwd_chunk`` and
``rwkv6_bwd_du`` in ``csrc/rwkv6_backward.cu`` cannot run here, so
``chunked_plan`` repeats their plan on the CPU: the four launches, the
operands the kernel rounds to bf16 and the sums it takes in a fixed
order. Chunks of Q = 64
steps in sub-chunks of 16, chunk-local t, s; Lc[t] the exclusive
cumulative sum of log2(max(w, 1e-38)) over the chunk, Bv[m] = Lc[16 m],
F_ij = 2^{Bv[j] - Bv[i+1]} for sub-chunks i <= j, and

  Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]}     Kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]}
  Kd[s] = k_s 2^{Lc[Q] - Lc[s+1]}      Rd[t] = r_t 2^{Lc[t]}

  launch 1   per (b, h, chunk): the carries' terms Kd^T V and Rd^T dY
             in f32 (Kd and Rd in three bf16 terms), and 2^{Lc[Q]}
  launch 2   the scans: S <- 2^{Lc[Q]} S + Kd^T V over the chunks in
             order, S kept at every chunk boundary; G <- 2^{Lc[Q]} G +
             Rd^T dY in reverse from G = d(final state), G kept at every
             chunk's end; both as bf16 hi + lo; d state = G at chunk 0's
             start
  launch 3   per (b, h, chunk), with S0 the state at its start, S_Q at
             its end and G = dL/dS_Q:
               A   = Rt (Kh F)^T per sub-chunk pair (the forward's),
                     bonus r_t . (u o k_t) on its diagonal
               dA  = (dY V^T) o strict-tril
               dV  = A^T dY + Kd G
               dR' = 2^{Lc[t]} dY S0^T + 2^{Lc[t] - Bv[j]} sum_i F_ij (dA_ji Kh_i)
               dK' = 2^{Lc[Q] - Lc[s+1]} V G^T
                     + 2^{Bv[i+1] - Lc[s+1]} sum_j F_ij (dA_ji^T Rt_j)
               dR  = dR' + u o k (v . dy),  dK = dK' + u o r (v . dy)
               w dw_tau = <G, S_Q>_row + sum_{t > tau} r_t o dR'_t
                          - sum_{s >= tau} k_s o dK'_s
               du partial = sum_t r_t o k_t (v_t . dy_t)
  launch 4   du summed over (b, chunk) in order

A diagonal block whose span Bv[j] - Bv[j+1] passes SPAN_MAX in some
channel (the forward's kSpanMax rule) is taken with exact pairwise
exponents 2^{Lc[t] - Lc[s+1]} instead of F_jj, in A, dR and dK. dw =
(w dw) / w only for a (chunk, channel) whose decays are all at least
W_MIN; a row with a smaller one takes dw_tau = <G_{tau+1}, S_tau>_row
from the step recurrences of that row (S forward from S0, G back from
G), which neither divide nor exponentiate, so w = 0 is exact.

With ``bf16`` each f32 operand that the kernel hands to the bf16 tensor
cores is split into hi = bf16(v) and lo = bf16(v - hi) (the carries' Kd
and Rd into three terms), a product of two split operands taken as hi
hi + hi lo + lo hi; rounded once when not ``split``. Tolerances: 1e-5 of
each gradient's largest magnitude with unrounded operands (the algebra,
in f64), 2e-2 with the kernel's rounding (the card's TOL, in f32 on the
same bf16 inputs).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rwkv6_scan  # noqa: E402
from test_torch_rwkv6_backward import (GRADS, _inputs,  # noqa: E402
                                       _jax_vjp)

Q, SUB = rwkv6_scan.CHUNK, rwkv6_scan.CHUNK_SUB
NSUB = Q // SUB
ALGEBRA, TOL = 1e-5, 2e-2


def _bf16(v):
    return v.to(torch.bfloat16).to(v.dtype)


def ex2(v):
    """2^v as ex2.approx.ftz gives it: 0 below the least normal f32."""
    y = torch.exp2(v)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def chunked_plan(r, k, v, w, u, state, dy, ds_out, *, bf16=True,
                 split=True, span_max=rwkv6_scan.SPAN_MAX,
                 w_min=rwkv6_scan.W_MIN, dtype=torch.float32):
    """The kernel's plan: (dr, dk, dv, dw, du, dstate), dr, dk and dv in
    r's dtype, computed in ``dtype``. ``w_min=0`` takes every dw by
    division; ``span_max=math.inf`` factors every diagonal block
    (mutations the tests must catch)."""
    B, T, NH, hd = r.shape
    f = dtype
    nc = -(-T // Q)

    def parts(x, n=2):
        """The bf16 terms the tensor cores see of an f32 operand."""
        if not bf16:
            return [x]
        out = []
        for _ in range(n if split else 1):
            out.append(_bf16(x))
            x = x - out[-1]
        return out

    def val(x, n=2):
        return sum(parts(x, n))

    def mm(a, b):
        """a @ b, both split: hi hi + hi lo + lo hi."""
        pa, pb = parts(a), parts(b)
        return sum(x @ y for i, x in enumerate(pa) for j, y in enumerate(pb)
                   if i + j < max(len(pa), len(pb)))

    def chunks(x, fill=0.0):    # [B, T, NH, hd] -> [nc, B, NH, Q, hd]
        x = torch.nn.functional.pad(x.to(f).transpose(1, 2),
                                    (0, 0, 0, nc * Q - T), value=fill)
        return x.reshape(B, NH, nc, Q, hd).permute(2, 0, 1, 3, 4)

    rf, kf, vf, dyf = (chunks(x) for x in (r, k, v, dy))
    wf = chunks(w, 1.0)                       # past T: w = 1, no input
    lw = torch.log2(torch.clamp(wf, min=1e-38))
    Lc = torch.nn.functional.pad(torch.cumsum(lw, -2), (0, 0, 1, 0))
    uf = u.to(f)[None, :, None, :]
    tril = torch.ones(SUB, SUB, dtype=torch.bool).tril(-1)

    # launch 1: each chunk's terms of the two carries, and its decays
    LQ = Lc[..., Q, :]                                      # [nc,B,NH,hd]
    Kd = kf * ex2(LQ[..., None, :] - Lc[..., 1:, :])
    Rd = rf * ex2(Lc[..., :Q, :])
    s_terms = val(Kd, 3).transpose(-1, -2) @ vf
    g_terms = val(Rd, 3).transpose(-1, -2) @ dyf
    dec = ex2(LQ)[..., None]
    # launch 2: the scans, S forward and G in reverse, kept at the chunk
    # boundaries
    S, G = state.to(f), ds_out.to(f)
    s_planes, g_planes = [val(S)], [None] * (nc + 1)
    for c in range(nc):
        S = dec[c] * S + s_terms[c]
        s_planes.append(val(S))
    g_planes[nc] = val(G)
    for c in reversed(range(nc)):
        G = dec[c] * G + g_terms[c]
        if c:
            g_planes[c] = val(G)
    dstate = G

    # launch 3: one block per (b, h, chunk)
    dr, dk, dv, dw = (torch.zeros(nc, B, NH, Q, hd, dtype=f)
                      for _ in range(4))
    du_part = torch.zeros(nc, B, NH, hd, dtype=f)
    for c in range(nc):
        rc, kc, vc, dyc, wc, L = rf[c], kf[c], vf[c], dyf[c], wf[c], Lc[c]
        S0, SQ, Gq = s_planes[c], s_planes[c + 1], g_planes[c + 1]
        Bv = L[..., ::SUB, :]                               # [B,NH,5,hd]
        blk = torch.arange(Q) // SUB
        Rt = rc * ex2(L[..., :Q, :] - Bv[..., blk, :])
        Kh = kc * ex2(Bv[..., blk + 1, :] - L[..., 1:, :])
        Kd = kc * ex2(L[..., Q:, :] - L[..., 1:, :])
        bonus = (rc * uf * kc).sum(-1)
        vdy = (vc * dyc).sum(-1)
        slow = [((Bv[..., j, :] - Bv[..., j + 1, :]) > span_max).any(-1)
                [..., None, None] for j in range(NSUB)]

        def rows(x, j):
            return x[..., j * SUB:(j + 1) * SUB, :]

        def F(i, j):            # [B, NH, 1, hd]
            return ex2(Bv[..., j, :] - Bv[..., i + 1, :])[..., None, :]

        def exact(x, j, t_side):
            """The diagonal block's sum with pairwise exponents: dR's
            (x = k, over s < t) or dK's (x = r, over t > s)."""
            Lj = rows(L[..., :Q, :], j)                     # Lc[t]
            Lj1 = rows(L[..., 1:, :], j)                    # Lc[s+1]
            dA = dAt[j][j]
            e = ex2((Lj[..., :, None, :] - Lj1[..., None, :, :]).masked_fill(
                ~tril[..., None], -math.inf))               # [t, s, c]
            if t_side:   # dR[t, c] = sum_s dA[t, s] k_s[c] e[t, s, c]
                return (dA[..., None] * rows(x, j)[..., None, :, :]
                        * e).sum(-2)
            # dK[s, c] = sum_t dA[t, s] r_t[c] e[t, s, c]
            return (dA[..., None] * rows(x, j)[..., :, None, :] * e).sum(-3)

        # the A tiles (the forward's) and the dA tiles, as bf16 hi + lo
        At = [[None] * NSUB for _ in range(NSUB)]
        dAt = [[None] * NSUB for _ in range(NSUB)]
        for j in range(NSUB):
            for i in range(j + 1):
                kt = val(val(rows(Kh, i)) * F(i, j))
                a = mm(rows(Rt, j), kt.transpose(-1, -2))
                dA = rows(dyc, j) @ rows(vc, i).transpose(-1, -2)
                if i == j:
                    e = ex2(rows(L[..., :Q, :], j)[..., :, None, :]
                            - rows(L[..., 1:, :], j)[..., None, :, :])
                    ex = (rows(rc, j)[..., :, None, :]
                          * rows(kc, j)[..., None, :, :] * e).sum(-1)
                    a = torch.where(slow[j], ex, a).masked_fill(~tril, 0.0) \
                        + torch.diag_embed(rows(bonus[..., None], j)[..., 0])
                    dA = dA.masked_fill(~tril, 0.0)
                At[j][i], dAt[j][i] = val(a), val(dA)

        for m in range(NSUB):
            sl = slice(m * SUB, (m + 1) * SUB)
            # dV rows s in sub-chunk m
            acc = mm(rows(Kd, m), Gq)
            for j in range(m, NSUB):
                acc = acc + At[j][m].transpose(-1, -2) @ rows(dyc, j)
            dv[c][..., sl, :] = acc
            # dR' rows t in sub-chunk m
            acc = 0.0
            for i in range(m + 1):
                term = F(i, m) * mm(dAt[m][i], rows(Kh, i))
                acc = acc + (torch.where(slow[m], 0.0, term) if i == m
                             else term)
            dR = ex2(rows(L[..., :Q, :], m)) * (rows(dyc, m) @ S0.transpose(
                -1, -2)) + ex2(rows(L[..., :Q, :], m) - Bv[..., m:m + 1, :]) \
                * acc + torch.where(slow[m], exact(kc, m, True), 0.0)
            dr[c][..., sl, :] = dR
            # dK' rows s in sub-chunk m
            acc = 0.0
            for j in range(m, NSUB):
                term = F(m, j) * mm(dAt[j][m].transpose(-1, -2), rows(Rt, j))
                acc = acc + (torch.where(slow[m], 0.0, term) if j == m
                             else term)
            dK = ex2(L[..., Q:, :] - rows(L[..., 1:, :], m)) * (
                rows(vc, m) @ Gq.transpose(-1, -2)) + ex2(
                Bv[..., m + 1:m + 2, :] - rows(L[..., 1:, :], m)) * acc \
                + torch.where(slow[m], exact(rc, m, False), 0.0)
            dk[c][..., sl, :] = dK

        # w dw from the identity, divided by w ...
        a, b = rc * dr[c], kc * dk[c]
        E = a - b
        after = torch.flip(torch.cumsum(torch.flip(E, [-2]), -2), [-2]) - E
        X = (Gq * SQ).sum(-1)[..., None, :] + after - b
        by_division = X / wc
        # ... or from the step recurrences of each row with a decay under
        # w_min (among the chunk's steps: past T, w = 1)
        Srow, hist = S0, []
        for t in range(Q):
            hist.append(Srow)
            Srow = wc[..., t, :, None] * Srow + \
                kc[..., t, :, None] * vc[..., t, None, :]
        Grow, rec = Gq, [None] * Q
        for t in reversed(range(Q)):
            rec[t] = (Grow * hist[t]).sum(-1)
            Grow = wc[..., t, :, None] * Grow + \
                rc[..., t, :, None] * dyc[..., t, None, :]
        small = (wc < w_min).any(-2, keepdim=True)
        dw[c] = torch.where(small, torch.stack(rec, -2), by_division)

        dr[c] = dr[c] + uf * kc * vdy[..., None]
        dk[c] = dk[c] + uf * rc * vdy[..., None]
        du_part[c] = (rc * kc * vdy[..., None]).sum(-2)

    # launch 4: du over (b, chunk) in order
    du = torch.zeros(NH, hd, dtype=f)
    for b in range(B):
        for c in range(nc):
            du = du + du_part[c, b]

    def steps(x):               # [nc, B, NH, Q, hd] -> [B, T, NH, hd]
        return x.permute(1, 0, 3, 2, 4).reshape(B, nc * Q, NH, hd)[:, :T]
    return (*(steps(x).to(r.dtype) for x in (dr, dk, dv)), steps(dw).float(),
            du.to(u.dtype), dstate.float())


# ----------------------------------------------------------------------
# inputs and comparisons
# ----------------------------------------------------------------------
def _case(seed, B, T, NH, decay, carried, dtype=torch.float32):
    """tests/test_torch_rwkv6_backward.py's inputs at hd 64; "zeros": the
    model's decays with a tenth exactly 0 (exp(-exp(x)) underflows in
    f32)."""
    ins = _inputs(seed, B, T, NH, 64, "model" if decay == "zeros" else decay,
                  carried, dtype)
    if decay == "zeros":
        g = np.random.default_rng(seed + 7)
        ins[3] = torch.where(torch.from_numpy(g.random(ins[3].shape) < 0.1),
                             torch.zeros_like(ins[3]), ins[3])
    return ins


def _errors(got, want):
    """Each gradient's largest distance over its largest magnitude (inf
    where the plan's is not finite)."""
    out = {}
    for name, a, b in zip(GRADS, got, want):
        d = (a.float() - b.float()).abs().max()
        scale = float(b.float().abs().max()) or 1.0
        out[name] = float(d) / scale if torch.isfinite(d) else math.inf
    return out


def _close(got, want, tol, what):
    for name, a, b in zip(GRADS, got, want):
        assert bool(torch.isfinite(a.float()).all()), f"{what} {name}"
        scale = float(b.float().abs().max()) or 1.0
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * scale, msg=f"{what} {name}")


# ----------------------------------------------------------------------
# the plan against autograd and the reference
# ----------------------------------------------------------------------
CASES = [   # (B, T, NH, decay, carried)
    (1, 1, 2, "model", True),          # a single step
    (2, 37, 2, "model", True),         # T < a chunk
    (2, 150, 2, "model", True),        # ragged, B = 2
    (1, 256, 2, "model", False),       # four chunks from zeros
    (1, 256, 2, "near1", True),        # decays near 1
    (2, 150, 1, "near0", True),        # decays in [1e-6, 1e-3]
    (1, 256, 2, "zeros", True),        # a tenth exactly 0
    (2, 37, 2, "zeros", False),
]


@pytest.mark.parametrize("B,T,NH,decay,carried", CASES)
def test_chunked_plan_algebra(B, T, NH, decay, carried):
    """Unrounded operands, in f64: all six gradients of the plan against
    autograd of the port's plain scan and jax.vjp of the reference's, on
    the same f32 inputs, to 1e-5."""
    ins = _case(B * 1000 + T, B, T, NH, decay, carried)
    got = chunked_plan(*ins, bf16=False, dtype=torch.float64)
    _close(got, rwkv6_scan.rwkv6_scan_backward(*ins), ALGEBRA, "autograd")
    _close(got, _jax_vjp(*ins), ALGEBRA, "jax.vjp")


@pytest.mark.parametrize("B,T,NH,decay,carried", CASES)
def test_chunked_plan_bf16(B, T, NH, decay, carried):
    """The kernel's rounding, in f32, on bf16 inputs: each gradient
    within TOL of its largest magnitude against f32 autograd of the plain
    scan and jax.vjp of the reference on the same bf16 inputs, in the
    kernel's output types."""
    ins = _case(B * 1000 + T, B, T, NH, decay, carried, torch.bfloat16)
    got = chunked_plan(*ins)
    want = rwkv6_scan.rwkv6_scan_backward(*ins)
    assert [x.dtype for x in got] == [x.dtype for x in want]
    _close(got, want, TOL, "autograd")
    _close(got, _jax_vjp(*ins), TOL, "jax.vjp")


# ----------------------------------------------------------------------
# what each part of the plan is for: mutations that must miss
# ----------------------------------------------------------------------
F32_TOL = 2e-4   # dw and d state, the f32 gradients, as the forward's
                 # final state is held


def test_chunked_plan_needs_the_split():
    """Why the kernel splits its f32 operands in two bf16 terms: rounded
    once, dr, dk and dv stay inside TOL, but dw and d state move by 5x
    and more the 2e-4 that the forward's final state is held to; split,
    they stay inside it."""
    ins = _case(9, 2, 150, 2, "model", True, torch.bfloat16)
    want = rwkv6_scan.rwkv6_scan_backward(*ins)
    split = _errors(chunked_plan(*ins), want)
    once = _errors(chunked_plan(*ins, split=False), want)
    assert max(split["dw"], split["dstate"]) < F32_TOL, split
    assert min(once["dw"], once["dstate"]) > 5 * F32_TOL, once
    assert max(once.values()) < TOL, once


@pytest.mark.parametrize("decay", ["near0", "zeros"])
def test_chunked_plan_needs_the_exact_dw(decay):
    """dw by division alone, (w dw) / w, misses TOL by far where decays
    are near 0 and is not finite where one is exactly 0; the exact rows
    hold it to 2e-4."""
    ins = _case(17, 2, 150, 2, decay, True, torch.bfloat16)
    want = rwkv6_scan.rwkv6_scan_backward(*ins)
    assert _errors(chunked_plan(*ins), want)["dw"] < F32_TOL
    assert _errors(chunked_plan(*ins, w_min=0.0), want)["dw"] > 10 * TOL


@pytest.mark.parametrize("decay", ["near0", "zeros"])
def test_chunked_plan_needs_the_exact_diagonal_blocks(decay):
    """Factoring every diagonal block (no kSpanMax rule) overflows where
    a sub-chunk's decays sum past 2^-64: dr, dk and dv are not finite."""
    ins = _case(23, 1, 150, 2, decay, True, torch.bfloat16)
    want = rwkv6_scan.rwkv6_scan_backward(*ins)
    bad = _errors(chunked_plan(*ins, span_max=math.inf), want)
    assert min(bad["dr"], bad["dk"], bad["dv"]) == math.inf, bad


def test_w_min_keeps_division_exact_enough():
    """Why W_MIN = 1/16: every decay in [W_MIN, 4 W_MIN], all dw taken by
    division, stays within 1e-3 (a twentieth of TOL) of the largest;
    decays in [1e-6, 1e-3] miss TOL by 10x."""
    ins = _case(5, 1, 256, 2, "model", True, torch.bfloat16)
    g = np.random.default_rng(5)
    for (lo, hi), cond in (((rwkv6_scan.W_MIN, 4 * rwkv6_scan.W_MIN),
                            lambda e: e < 1e-3),
                           ((1e-6, 1e-3), lambda e: e > 10 * TOL)):
        ins[3] = torch.from_numpy(
            (lo + (hi - lo) * g.random(ins[3].shape)).astype(np.float32))
        want = rwkv6_scan.rwkv6_scan_backward(*ins)
        err = _errors(chunked_plan(*ins, w_min=0.0), want)["dw"]
        assert cond(err), ((lo, hi), err)


def test_chunked_plan_through_the_padding():
    """The last chunk's steps past T decay by 1 with no input: the plan
    over T = 37 padded to 64 by hand, cut back to T, equals the plan
    over T = 37 (both within TOL of autograd)."""
    B, T, NH = 2, 37, 2
    r, k, v, w, u, s0, dy, ds = _case(31, B, T, NH, "model", True,
                                      torch.bfloat16)
    pad = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, Q - T), value=fill)
           for x, fill in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0),
                           (dy, 0.0))]
    padded = chunked_plan(pad[0], pad[1], pad[2], pad[3], u, s0, pad[4], ds)
    got = chunked_plan(r, k, v, w, u, s0, dy, ds)
    for a, b in zip([x[:, :T] for x in padded[:4]] + list(padded[4:]), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("case,want", [
    ("bf16-hd64", "chunked"), ("f32-hd64", "step"), ("bf16-hd32", "step"),
    ("bf16-hd128", "step"), ("bf16-unaligned-r", "step"),
    ("bf16-unaligned-w", "step"), ("bf16-unaligned-dy", "step"),
    ("bf16-unaligned-base", "step"),
])
def test_backward_route(case, want):
    """Which backward kernel the wrapper would launch, decided from the
    tensors alone: the chunked one for bf16 at hd 64 with r, k, v, w and
    dy at 16-byte aligned bases and strides."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    hd = {"bf16-hd32": 32, "bf16-hd128": 128}.get(case, 64)
    B, T, NH = 2, 40, 4
    r, k, v, dy = (torch.zeros(B, T, NH, hd, dtype=dtype) for _ in range(4))
    w = torch.ones(B, T, NH, hd)
    if case == "bf16-unaligned-r":      # heads hd + 1 apart: odd strides
        r = torch.zeros(B, T, NH, hd + 1, dtype=dtype)[..., :hd]
    if case == "bf16-unaligned-w":
        w = torch.ones(B, T, NH, hd + 2)[..., :hd]
    if case == "bf16-unaligned-dy":
        dy = torch.zeros(B, T, NH, hd + 1, dtype=dtype)[..., :hd]
    if case == "bf16-unaligned-base":
        k = torch.zeros(B * T * NH * hd + 1, dtype=dtype)[1:].view(
            B, T, NH, hd)
    assert rwkv6_scan.backward_kernel_for(r, k, v, w, dy) == want
