"""The port's recurrent scans against the reference's: ``ops.rwkv6`` and
``ops.mamba2`` (plain torch on the CPU) against the Pallas kernels in
interpret mode and the jnp oracles, on the grid of
tests/test_kernels.py plus ragged T (the padding contract), carried
states, the single-token steps, and decays near 0 and near 1; the
wrappers' input checks and the dispatch rules. The CUDA kernels
themselves run only on the card (tests/test_torch_card.py).

Tolerances: 2e-4 in f32 against the jnp oracles, which compute the same
sequential recurrence; against the Pallas kernels the reference's own
(5e-4 for rwkv6, 1e-3 for mamba2, tests/test_kernels.py), since their
chunked form sums in another order; 2e-2 in bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as r_ops  # noqa: E402
from repro.kernels import ref as r_ref  # noqa: E402
from repro_torch.kernels import mamba2_ssd as t_ssd  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as t_rwkv  # noqa: E402

TOL = 2e-4
PALLAS_TOL = {"rwkv6": 5e-4, "mamba2": 1e-3}


def _pair(x, dtype="float32"):
    """The same values in both frameworks (bf16 rounds identically)."""
    x = np.asarray(x, np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _rwkv_inputs(seed, B, T, NH, hd, w_range=None, dtype="float32"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, NH, hd)) for _ in range(3))
    if w_range is None:          # tests/test_kernels.py's decays
        w = _sigmoid(rng.standard_normal((B, T, NH, hd))) * 0.5 + 0.45
    else:
        w = rng.uniform(*w_range, size=(B, T, NH, hd))
    u = rng.standard_normal((NH, hd)) * 0.1
    pairs = [_pair(x, dtype) for x in (r, k, v)]
    pairs += [_pair(w), _pair(u)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _mamba_inputs(seed, B, T, NH, P, N, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, NH, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, NH)) + dt_shift))
    A = -np.abs(rng.standard_normal(NH))
    Bm, Cm = (rng.standard_normal((B, T, N)) for _ in range(2))
    D = rng.standard_normal(NH) * 0.1
    pairs = [_pair(a) for a in (x, dt, A, Bm, Cm, D)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# ----------------------------------------------------------------------
# rwkv6
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,T,NH,hd,chunk", [
    (1, 64, 2, 32, 16),
    (2, 96, 4, 64, 32),
    (1, 128, 1, 64, 64),
    (2, 50, 3, 32, 16),          # T not a chunk multiple: padded
    (1, 70, 2, 64, 64),          # padded past one chunk
])
def test_rwkv6_plain_vs_reference(B, T, NH, hd, chunk):
    jx, tx = _rwkv_inputs(B * 100 + T + hd, B, T, NH, hd)
    y, s = t_ops.rwkv6(*tx, None, chunk=chunk)
    assert y.shape == (B, T, NH, hd) and s.dtype == torch.float32
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx)
    _close(y, y_ref)
    _close(s, s_ref)
    y_p, s_p = r_ops.rwkv6(*jx, None, chunk=chunk,
                           backend="pallas_interpret")
    _close(y, y_p, PALLAS_TOL["rwkv6"])
    _close(s, s_p, PALLAS_TOL["rwkv6"])


@pytest.mark.parametrize("w_range", [(1e-6, 1e-3), (0.999, 1.0)],
                         ids=["decay-near-0", "decay-near-1"])
def test_rwkv6_extreme_decays(w_range):
    jx, tx = _rwkv_inputs(11, 2, 48, 2, 32, w_range)
    y, s = t_ops.rwkv6(*tx, None, chunk=16)
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx)
    _close(y, y_ref)
    _close(s, s_ref)
    y_p, s_p = r_ops.rwkv6(*jx, None, chunk=16, backend="pallas_interpret")
    _close(y, y_p, PALLAS_TOL["rwkv6"])
    _close(s, s_p, PALLAS_TOL["rwkv6"])


def test_rwkv6_state_carry():
    """Two calls with the state carried == one call over the whole T."""
    jx, tx = _rwkv_inputs(3, 1, 64, 2, 32)
    y_full, s_full = r_ref.rwkv6_scan_ref(*jx)
    r, k, v, w, u = tx
    h = 40                                           # ragged halves
    y1, s1 = t_ops.rwkv6(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, None,
                         chunk=16)
    y2, s2 = t_ops.rwkv6(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1,
                         chunk=16)
    _close(torch.cat([y1, y2], dim=1), y_full)
    _close(s2, s_full)


def test_rwkv6_step_matches_scan():
    rng = np.random.default_rng(9)
    jx, tx = _rwkv_inputs(4, 2, 1, 2, 32)
    sj, st = _pair(rng.standard_normal((2, 2, 32, 32)))
    y_scan, s_scan = r_ref.rwkv6_scan_ref(*jx, sj)
    r, k, v, w, u = tx
    y_step, s_step = t_ops.rwkv6_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                                      st)
    _close(y_step, y_scan[:, 0], 1e-5)
    _close(s_step, s_scan, 1e-5)
    y_ref, s_ref = r_ops.rwkv6_step(*(x[:, 0] for x in jx[:4]), jx[4], sj)
    _close(y_step, y_ref, 1e-5)
    _close(s_step, s_ref, 1e-5)


def test_rwkv6_bf16_vs_reference():
    jx, tx = _rwkv_inputs(5, 1, 40, 2, 32, dtype="bfloat16")
    y, s = t_ops.rwkv6(*tx, None)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx)
    _close(y, y_ref, 2e-2)
    _close(s, s_ref)


# ----------------------------------------------------------------------
# mamba2
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,T,NH,P,N,chunk", [
    (1, 64, 2, 32, 16, 16),
    (2, 96, 4, 64, 64, 32),
    (1, 128, 1, 64, 32, 64),
    (2, 45, 3, 32, 16, 32),      # T not a chunk multiple: padded
])
def test_mamba2_plain_vs_reference(B, T, NH, P, N, chunk):
    jx, tx = _mamba_inputs(B * 100 + T + P + N, B, T, NH, P, N)
    y, s = t_ops.mamba2(*tx, None, chunk=chunk)
    assert y.shape == (B, T, NH, P) and s.dtype == torch.float32
    y_ref, s_ref = r_ref.mamba2_ssd_ref(*jx)
    _close(y, y_ref)
    _close(s, s_ref)
    y_p, s_p = r_ops.mamba2(*jx, None, chunk=chunk,
                            backend="pallas_interpret")
    _close(y, y_p, PALLAS_TOL["mamba2"])
    _close(s, s_p, PALLAS_TOL["mamba2"])


@pytest.mark.parametrize("dt_shift", [-12.0, 4.0],
                         ids=["decay-near-1", "decay-near-0"])
def test_mamba2_extreme_decays(dt_shift):
    """dt ~ 1e-5 (exp(A dt) ~ 1) and dt ~ 4 with |A| up to ~3 (the
    decay underflows towards 0 within a few steps)."""
    jx, tx = _mamba_inputs(12, 1, 48, 2, 32, 16, dt_shift)
    y, s = t_ops.mamba2(*tx, None, chunk=16)
    y_ref, s_ref = r_ref.mamba2_ssd_ref(*jx)
    _close(y, y_ref)
    _close(s, s_ref)
    y_p, s_p = r_ops.mamba2(*jx, None, chunk=16, backend="pallas_interpret")
    _close(y, y_p, PALLAS_TOL["mamba2"])
    _close(s, s_p, PALLAS_TOL["mamba2"])


def test_mamba2_state_carry():
    jx, tx = _mamba_inputs(6, 1, 64, 2, 32, 16)
    y_full, s_full = r_ref.mamba2_ssd_ref(*jx)
    x, dt, A, Bm, Cm, D = tx
    h = 23
    y1, s1 = t_ops.mamba2(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], D,
                          None, chunk=16)
    y2, s2 = t_ops.mamba2(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], D,
                          s1, chunk=16)
    _close(torch.cat([y1, y2], dim=1), y_full)
    _close(s2, s_full)


def test_mamba2_step_matches_scan():
    rng = np.random.default_rng(9)
    jx, tx = _mamba_inputs(7, 2, 1, 2, 32, 16)
    sj, st = _pair(rng.standard_normal((2, 2, 16, 32)))
    y_scan, s_scan = r_ref.mamba2_ssd_ref(*jx, sj)
    x, dt, A, Bm, Cm, D = tx
    y_step, s_step = t_ops.mamba2_step(x[:, 0], dt[:, 0], A, Bm[:, 0],
                                       Cm[:, 0], D, st)
    _close(y_step, y_scan[:, 0], 1e-5)
    _close(s_step, s_scan, 1e-5)
    xj, dtj, Aj, Bj, Cj, Dj = jx
    y_ref, s_ref = r_ops.mamba2_step(xj[:, 0], dtj[:, 0], Aj, Bj[:, 0],
                                     Cj[:, 0], Dj, sj)
    _close(y_step, y_ref, 1e-5)
    _close(s_step, s_ref, 1e-5)


# ----------------------------------------------------------------------
# the CUDA kernel's chunked plan for bf16 (csrc/mamba2_ssd.cu)
# ----------------------------------------------------------------------
def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).float()


def ssd_chunked(x, dt, A, B_mat, C_mat, D=None, state=None, *, chunk=64,
                bf16=False, split=True):
    """A plain mirror of ``ssd_chunked`` in csrc/mamba2_ssd.cu, used only
    by these tests. Per chunk of ``chunk`` steps, in order, with L the
    cumulative sum of A dt within the chunk:

      y = exp(L_t) C S + ((C B^T) o M) x + D x,  M[t,s] = exp(L_t - L_s) dt_s
      S = exp(L_C) S + (B o exp(L_C - L) dt)^T x

    in f32. With ``bf16`` the three f32 operands that the kernel hands to
    the bf16 tensor cores (C B^T o M, S and the carry weights) are rounded
    as it rounds them: split into hi = bf16(v) and lo = bf16(v - hi), or
    rounded once to bf16 when not ``split``."""
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    S = (torch.zeros((Bsz, NH, N, P)) if state is None
         else state.float().clone())

    def operand(v):
        if not bf16:
            return v
        hi = _bf16(v)
        return hi + _bf16(v - hi) if split else hi

    xf, dtf, Bf, Cf = x.float(), dt.float(), B_mat.float(), C_mat.float()
    ys = []
    for t0 in range(0, T, chunk):
        xc = xf[:, t0:t0 + chunk].transpose(1, 2)              # [B,NH,c,P]
        dc = dtf[:, t0:t0 + chunk].transpose(1, 2)             # [B,NH,c]
        bc, cc = Bf[:, t0:t0 + chunk], Cf[:, t0:t0 + chunk]    # [B,c,N]
        L = torch.cumsum(A.float()[None, :, None] * dc, -1)
        causal = torch.ones(dc.shape[-1], dc.shape[-1], dtype=torch.bool).tril()
        M = torch.exp((L[..., :, None] - L[..., None, :])
                      .masked_fill(~causal, -torch.inf)) * dc[..., None, :]
        G = torch.einsum("btn,bsn->bts", cc, bc)[:, None]
        y = operand(G * M) @ xc
        y = y + torch.exp(L)[..., None] * torch.einsum(
            "btn,bhnp->bhtp", cc, operand(S))
        if D is not None:
            y = y + D.float()[None, :, None, None] * xc
        ys.append(y.transpose(1, 2))
        w = torch.exp(L[..., -1:] - L) * dc                    # [B,NH,c]
        W = operand(bc[:, None] * w[..., None])                # [B,NH,c,N]
        S = (torch.exp(L[..., -1])[..., None, None] * S
             + W.transpose(-1, -2) @ xc)
    y = torch.cat(ys, 1) if ys else xf.new_zeros((Bsz, 0, NH, P))
    return y.to(x.dtype), S


def _ssd_plan_inputs(seed, B, T, NH, P, N, carried, bf16):
    """_mamba_inputs plus a state; with ``bf16``, x, B and C are rounded
    to bf16 first, so the reference computes in f32 on the very values
    the kernel is given."""
    jx, tx = _mamba_inputs(seed, B, T, NH, P, N)
    x, dt, A, Bm, Cm, D = tx
    s0 = (torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, NH, N, P)).astype(np.float32)) if carried else None)
    if bf16:
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
        jx = [_pair(t.float().numpy())[0] for t in (x, dt, A, Bm, Cm, D)]
    js = None if s0 is None else _pair(s0.numpy())[0]
    return jx, js, (x, dt, A, Bm, Cm, D), s0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-operands"])
@pytest.mark.parametrize("B,T,NH,P,N,carried", [
    (1, 256, 2, 32, 16, False),      # chunks of 64 against the Pallas 256
    (1, 37, 2, 32, 16, True),        # T < C
    (2, 150, 3, 64, 64, True),       # T not a multiple of C, B = 2
    (1, 1, 2, 32, 16, True),         # a single step
])
def test_mamba2_chunked_plan_vs_reference(B, T, NH, P, N, carried, bf16):
    """The kernel's plan in chunks of 64 holds the sequential reference to
    y 2e-2 and state 2e-4 with its bf16 rounding emulated, and to 2e-4 in
    f32; against the Pallas kernel at chunk 256 (which sums in another
    order) to the reference's own 1e-3."""
    jx, js, tx, s0 = _ssd_plan_inputs(B * 1000 + T + N, B, T, NH, P, N,
                                      carried, bf16)
    y, s = ssd_chunked(*tx, s0, chunk=64, bf16=bf16)
    assert y.shape == (B, T, NH, P) and y.dtype == tx[0].dtype
    y_ref, s_ref = r_ref.mamba2_ssd_ref(*jx, js)
    _close(y, y_ref, 2e-2 if bf16 else TOL)
    _close(s, s_ref, TOL)
    y_p, s_p = r_ops.mamba2(*jx, js, chunk=256, backend="pallas_interpret")
    _close(y, y_p, 2e-2 if bf16 else PALLAS_TOL["mamba2"])
    _close(s, s_p, PALLAS_TOL["mamba2"])


def test_mamba2_chunked_plan_needs_the_split():
    """Why the kernel splits its f32 operands in two bf16 terms: rounded
    once, the carry misses the state tolerance by an order of magnitude."""
    jx, js, tx, s0 = _ssd_plan_inputs(5, 1, 150, 3, 64, 64, True, True)
    _, s_ref = r_ref.mamba2_ssd_ref(*jx, js)
    want = np.asarray(s_ref, np.float32)
    _, s_split = ssd_chunked(*tx, s0, bf16=True)
    _, s_once = ssd_chunked(*tx, s0, bf16=True, split=False)
    _close(s_split, s_ref)
    err_once = np.abs(s_once.numpy() - want) / (TOL + TOL * np.abs(want))
    assert err_once.max() > 10


# ----------------------------------------------------------------------
# the CUDA kernel's chunked plan for bf16 (csrc/rwkv6_scan.cu)
# ----------------------------------------------------------------------
def rwkv6_chunked(r, k, v, w, u, state=None, *, chunk=64, sub=16,
                  bf16=False, split=True, span_max=64.0):
    """A plain mirror of ``rwkv6_chunked`` in csrc/rwkv6_scan.cu, used only
    by these tests. Per chunk of ``chunk`` steps, in order, with Lc[t] the
    exclusive cumulative sum of log2(max(w, 1e-38)) within the chunk and
    Bv[m] = Lc[sub m] its value at the sub-chunk boundaries:

      Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]},   kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]}
      A[t,s] = Rt[t] . (kh[s] 2^{Bv[j] - Bv[i+1]})          (i <= j)
      y = (Rt 2^{Bv[j]}) S + (A o tril) V + bonus,  S = 2^{Lc[C]} S + (kh 2^{Lc[C] - Bv[i+1]})^T V

    Every factor has an exponent <= 0 except the diagonal blocks' k side,
    2^{Bv[j] - Lc[s+1]} <= 2^{span_j}: a diagonal block whose span passes
    ``span_max`` in some channel is computed with exact pairwise exponents
    instead. With ``bf16`` the operands are rounded as the kernel hands
    them to the bf16 tensor cores: f32 values split into hi = bf16(x) and
    lo = bf16(x - hi), products of two such taken as hi hi + hi lo + lo hi,
    the carry operand in three terms; rounded once when not ``split``."""
    Bsz, T, NH, hd = r.shape
    nsub = chunk // sub
    S = (torch.zeros((Bsz, NH, hd, hd)) if state is None
         else state.float().clone())

    def parts(x, n=2):
        if not bf16:
            return [x]
        out = []
        for _ in range(n if split else 1):
            out.append(_bf16(x))
            x = x - out[-1]
        return out

    def mm(a, b, n=2):       # a @ b, a f32 (parts), b exact or f32 (parts)
        pa = parts(a, n)
        if b is None:
            return pa
        pb = parts(b)
        return sum(x @ y for i, x in enumerate(pa) for j, y in
                   enumerate(pb) if i + j < max(len(pa), len(pb)))

    rf, kf, vf = (x.float().transpose(1, 2) for x in (r, k, v))
    lw = torch.log2(torch.clamp(w.float(), min=1e-38)).transpose(1, 2)
    tril = torch.ones(sub, sub, dtype=torch.bool).tril(-1)
    ys = []
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        pad = lambda x: torch.nn.functional.pad(x[:, :, t0:t0 + n],  # noqa
                                                (0, 0, 0, chunk - n))
        rc, kc, vc, lc = (pad(x) for x in (rf, kf, vf, lw))   # w = 1 past T
        Lc = torch.nn.functional.pad(torch.cumsum(lc, 2), (0, 0, 1, 0))
        Bv = Lc[:, :, ::sub]                                   # [.., nsub+1, hd]
        blk = torch.arange(chunk) // sub
        Rt = rc * torch.exp2(Lc[:, :, :-1] - Bv[:, :, blk])
        kh = kc * torch.exp2(Bv[:, :, blk + 1] - Lc[:, :, 1:])
        bonus = (rc * u.float()[None, :, None] * kc).sum(-1)
        A = torch.zeros(Bsz, NH, chunk, chunk)
        for j in range(nsub):
            tj = slice(j * sub, (j + 1) * sub)
            for i in range(j + 1):
                si = slice(i * sub, (i + 1) * sub)
                F = torch.exp2(Bv[:, :, j] - Bv[:, :, i + 1])[:, :, None]
                kt = sum(parts(sum(parts(kh[:, :, si])) * F))
                a = mm(Rt[:, :, tj], kt.transpose(-1, -2))
                if i == j:
                    exact = (rc[:, :, tj, None] * kc[:, :, None, si] * torch.exp2(
                        Lc[:, :, tj, None] - Lc[:, :, None, i * sub + 1:
                                                (i + 1) * sub + 1])).sum(-1)
                    slow = ((Bv[:, :, j] - Bv[:, :, j + 1]) > span_max).any(-1)
                    a = torch.where(slow[..., None, None], exact, a)
                    a = a.masked_fill(~tril, 0.0) + torch.diag_embed(
                        bonus[:, :, tj])
                A[:, :, tj, si] = a
        Rd = torch.cat([sum(parts(sum(parts(Rt[:, :, j * sub:(j + 1) * sub]))
                                  * torch.exp2(Bv[:, :, j, None])))
                        for j in range(nsub)], 2)
        y = mm(Rd, S) + mm(A, vc)
        ys.append(y[:, :, :n].transpose(1, 2))
        Kd = kh * torch.exp2(Bv[:, :, -1:] - Bv[:, :, blk + 1])
        S = torch.exp2(Bv[:, :, -1])[..., None] * S + \
            sum(parts(Kd, 3)).transpose(-1, -2) @ vc
    y = torch.cat(ys, 1) if ys else rf.new_zeros((Bsz, 0, NH, hd))
    return y.to(r.dtype), S


def _rwkv_plan_inputs(seed, B, T, NH, hd, carried, bf16, w_range=None,
                      zeros=False):
    """_rwkv_inputs plus a state; with ``bf16``, r, k and v are rounded to
    bf16 first, so the reference computes in f32 on the very values the
    kernel is given; with ``zeros``, a tenth of w is exactly 0."""
    jx, tx = _rwkv_inputs(seed, B, T, NH, hd, w_range)
    r, k, v, w, u = tx
    rng = np.random.default_rng(seed + 1)
    if zeros:
        w = torch.where(torch.from_numpy(rng.random(w.shape) < 0.1),
                        torch.zeros_like(w), w)
    s0 = (torch.from_numpy(rng.standard_normal((B, NH, hd, hd))
                           .astype(np.float32)) if carried else None)
    if bf16:
        r, k, v = r.bfloat16(), k.bfloat16(), v.bfloat16()
    jx = [_pair(t.float().numpy())[0] for t in (r, k, v, w, u)]
    js = None if s0 is None else _pair(s0.numpy())[0]
    return jx, js, (r, k, v, w, u), s0


# (B, T, NH, carried, w range, the Pallas chunks it is held to). Near 0
# only chunks of 16: at 64 the Pallas kernel itself strays 5.2e-4 from
# the sequential oracle there (its [C, C, hd] exponents in f32), over its
# own 5e-4, where this plan stays within 3e-6.
RWKV_PLAN_CASES = {
    "T256": (1, 256, 2, False, None, (16, 64)),
    "T37": (1, 37, 2, True, None, (16, 64)),          # T < C
    "ragged-B2": (2, 150, 3, True, None, (16, 64)),   # T % C != 0, B = 2
    "T1": (1, 1, 2, True, None, (16, 64)),            # a single step
    "near0": (1, 128, 2, True, (1e-6, 1e-3), (16,)),  # diagonal blocks exact
    "near1": (1, 256, 2, True, (0.999, 1.0), (16, 64)),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-operands"])
@pytest.mark.parametrize("case", list(RWKV_PLAN_CASES))
def test_rwkv6_chunked_plan_vs_reference(case, bf16):
    """The kernel's plan in chunks of 64 holds the sequential reference to
    y 2e-2 and state 2e-4 with its bf16 rounding emulated, and to 2e-4 in
    f32; against the Pallas kernel at chunks of 16 and 64 (which sum in
    another order) to the reference's own 5e-4 (see RWKV_PLAN_CASES)."""
    B, T, NH, carried, w_range, chunks = RWKV_PLAN_CASES[case]
    jx, js, tx, s0 = _rwkv_plan_inputs(B * 1000 + T, B, T, NH, 64, carried,
                                       bf16, w_range)
    y, s = rwkv6_chunked(*tx, s0, bf16=bf16)
    assert y.shape == (B, T, NH, 64) and y.dtype == tx[0].dtype
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx, js)
    _close(y, y_ref, 2e-2 if bf16 else TOL)
    _close(s, s_ref, TOL)
    for chunk in chunks:
        y_p, s_p = r_ops.rwkv6(*jx, js, chunk=chunk,
                               backend="pallas_interpret")
        _close(y, y_p, 2e-2 if bf16 else PALLAS_TOL["rwkv6"])
        _close(s, s_p, PALLAS_TOL["rwkv6"])


def test_rwkv6_chunked_plan_carries_across_calls():
    """Two calls with the state carried == the sequential reference over
    the whole T (a ragged split)."""
    jx, js, tx, s0 = _rwkv_plan_inputs(21, 1, 200, 2, 64, True, True)
    r, k, v, w, u = tx
    h = 77
    y1, s1 = rwkv6_chunked(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, s0,
                           bf16=True)
    y2, s2 = rwkv6_chunked(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, s1,
                           bf16=True)
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx, js)
    _close(torch.cat([y1, y2], dim=1), y_ref, 2e-2)
    _close(s2, s_ref)


def test_rwkv6_chunked_plan_takes_exact_zeros():
    """w with exact zeros (exp(-exp(x)) underflows in f32): the clamp keeps
    every logarithm finite, so no NaN, and the plan equals the step form."""
    jx, js, tx, s0 = _rwkv_plan_inputs(22, 1, 200, 2, 64, True, True,
                                       w_range=(0.0, 1.0), zeros=True)
    assert int((tx[3] == 0).sum()) > 100
    y, s = rwkv6_chunked(*tx, s0, bf16=True)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    y_step, s_step = t_rwkv.plain(*tx, s0)
    _close(y, y_step.float().numpy(), 2e-2)
    _close(s, s_step.numpy())
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx, js)
    _close(s, s_ref)


def test_rwkv6_chunked_plan_needs_the_exact_diagonal_near_0():
    """The overflow argument: with decays near 0 a diagonal block's span
    passes 2^64, and factoring it as the other blocks are factored (the
    exact path switched off) overflows to inf and NaN; the plan as built
    stays finite and exact."""
    jx, js, tx, s0 = _rwkv_plan_inputs(23, 1, 128, 2, 64, True, False,
                                       w_range=(1e-6, 1e-3))
    y, s = rwkv6_chunked(*tx, s0)
    y_ref, _ = r_ref.rwkv6_scan_ref(*jx, js)
    _close(y, y_ref)
    y_bad, _ = rwkv6_chunked(*tx, s0, span_max=float("inf"))
    assert not torch.isfinite(y_bad).all()


def test_rwkv6_chunked_plan_needs_the_split():
    """Why the kernel splits its f32 operands into bf16 terms: rounded once,
    the state misses its tolerance by an order of magnitude, and y misses
    its own."""
    jx, js, tx, s0 = _rwkv_plan_inputs(5, 1, 256, 2, 64, True, True,
                                       w_range=(0.999, 1.0))
    y_ref, s_ref = r_ref.rwkv6_scan_ref(*jx, js)
    want_y, want_s = (np.asarray(x, np.float32) for x in (y_ref, s_ref))
    y_split, s_split = rwkv6_chunked(*tx, s0, bf16=True)
    y_once, s_once = rwkv6_chunked(*tx, s0, bf16=True, split=False)
    _close(s_split, s_ref)
    _close(y_split, y_ref, 2e-2)
    err_s = np.abs(s_once.numpy() - want_s) / (TOL + TOL * np.abs(want_s))
    err_y = np.abs(y_once.float().numpy() - want_y) / (
        2e-2 + 2e-2 * np.abs(want_y))
    assert err_s.max() > 10 and err_y.max() > 1


# ----------------------------------------------------------------------
# the padding contract, the wrappers' checks, dispatch
# ----------------------------------------------------------------------
def test_padding_is_a_no_op():
    """w=1, k=0 (rwkv6) and dt=0 (mamba2) pads leave y and the state
    bit-identical: the plain scans over padded and unpadded inputs."""
    _, (r, k, v, w, u) = _rwkv_inputs(8, 1, 21, 2, 32)
    y, s = t_rwkv.plain(r, k, v, w, u)
    pad = [t_ops._pad_seq(x, 16) for x in (r, k, v)]
    yp, sp = t_rwkv.plain(*pad, t_ops._pad_seq(w, 16, value=1.0), u)
    assert yp.shape[1] == 32
    assert torch.equal(yp[:, :21], y) and torch.equal(sp, s)
    _, (x, dt, A, Bm, Cm, D) = _mamba_inputs(8, 1, 21, 2, 32, 16)
    y, s = t_ssd.plain(x, dt, A, Bm, Cm, D)
    pad = [t_ops._pad_seq(a, 16) for a in (x, dt, Bm, Cm)]
    yp, sp = t_ssd.plain(pad[0], pad[1], A, pad[2], pad[3], D)
    assert torch.equal(yp[:, :21], y) and torch.equal(sp, s)


def test_wrapper_checks_reject_what_the_kernels_cannot_take():
    z = torch.zeros
    r = z(1, 8, 2, 64)
    s = z(1, 2, 64, 64)
    t_rwkv._check(r, r, r, r, z(2, 64), s)                # accepted
    with pytest.raises(TypeError, match="float32"):
        t_rwkv._check(r, r, r, r.bfloat16(), z(2, 64), s)
    with pytest.raises(ValueError, match="head dim 48"):
        r48 = z(1, 8, 2, 48)
        t_rwkv._check(r48, r48, r48, r48, z(2, 48), z(1, 2, 48, 48))
    with pytest.raises(ValueError, match="state"):
        t_rwkv._check(r, r, r, r, z(2, 64), z(1, 2, 64, 32))
    with pytest.raises(ValueError, match="unit-stride"):
        rt = z(1, 8, 64, 2).transpose(2, 3)
        t_rwkv._check(rt, rt, rt, rt, z(2, 64), s)
    x, dt, A, bc = z(1, 8, 2, 32), z(1, 8, 2), z(2), z(1, 8, 16)
    t_ssd._check(x, dt, A, bc, bc, A, z(1, 2, 16, 32))    # accepted
    with pytest.raises(ValueError, match="multiple of 16"):
        x24 = z(1, 8, 2, 24)
        t_ssd._check(x24, dt, A, bc, bc, A, z(1, 2, 16, 24))
    with pytest.raises(ValueError, match="state dim 24"):
        b24 = z(1, 8, 24)
        t_ssd._check(x, dt, A, b24, b24, A, z(1, 2, 24, 32))
    with pytest.raises(TypeError):
        t_ssd._check(x, dt.bfloat16(), A, bc, bc, A, z(1, 2, 16, 32))


@pytest.mark.parametrize("case,want", [
    ("bf16-hd64", "chunked"), ("f32-hd64", "step"), ("bf16-hd32", "step"),
    ("bf16-hd128", "step"), ("bf16-unaligned-base", "step"),
    ("bf16-unaligned-stride", "step"),
])
def test_rwkv6_kernel_choice(case, want):
    """Which CUDA kernel the wrapper would launch: the chunked one takes
    bf16 at hd 64 with 16-byte aligned bases and strides, the step kernel
    everything else (decided from the tensors alone, so checked here)."""
    hd = {"hd32": 32, "hd128": 128}.get(case.split("-")[1], 64)
    dt = torch.float32 if case.startswith("f32") else torch.bfloat16
    r = torch.zeros(2, 40, 4, hd, dtype=dt)
    w = torch.zeros(2, 40, 4, hd)
    if case == "bf16-unaligned-base":
        r = torch.zeros(2 * 40 * 4 * hd + 1, dtype=dt)[1:].view(2, 40, 4, hd)
    if case == "bf16-unaligned-stride":
        r = torch.zeros(2, 40, 4 * hd + 1, dtype=dt)[..., :4 * hd].view(
            2, 40, 4, hd)
    assert t_rwkv.kernel_for(r, r, r, w) == want


def test_scans_dispatch_on_cpu_to_the_plain_versions():
    _, tx = _rwkv_inputs(1, 1, 16, 2, 32)
    _, mx = _mamba_inputs(1, 1, 16, 2, 32, 16)
    before = (t_rwkv.rwkv6_scan.launches, t_ssd.mamba2_ssd.launches)
    for backend in (None, "auto", "ref"):
        y, _ = t_ops.rwkv6(*tx, None, backend=backend)
        torch.testing.assert_close(y, t_rwkv.plain(*tx)[0])
        y, _ = t_ops.mamba2(*mx, None, backend=backend)
        torch.testing.assert_close(y, t_ssd.plain(*mx)[0])
    assert (t_rwkv.rwkv6_scan.launches,
            t_ssd.mamba2_ssd.launches) == before      # no kernel on CPU
    with pytest.raises(ValueError):
        t_ops.rwkv6(*tx, None, backend="cuda")
    with pytest.raises(ValueError):
        t_ops.mamba2(*mx, None, backend="cuda")
