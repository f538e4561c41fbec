"""The chunked Mamba2 SSD backward kernel's plan, mirrored in torch and
held against autograd of the port's plain scan and ``jax.vjp`` of the
reference's.

``ssd_bwd_states`` and ``ssd_bwd_walk`` in
``csrc/mamba2_ssd_backward.cu`` cannot run here, so ``chunked_plan``
repeats their plan on the CPU: the three launches, the operands the
kernel rounds to bf16 and the sums it takes in a fixed order. Chunks of
Q = 64 steps, chunk-local t, s, L_t the inclusive cumulative sum of
max(A dt log2(e), -128) (log2 domain), M_ts = 2^(L_t - L_s) for s <= t,
K = C B^T, E = dy x^T, w_s = 2^(L_Q - L_s) dt_s (L_Q: the chunk's last
L), and R' = M o K o E:

  launch 1   S at every chunk's start, S <- 2^L_Q S + (B o w)^T x, kept
             as bf16 hi + lo
  launch 2   per block (b, h, 64 columns), the chunks in reverse, G =
             dL/dS at the chunk's end (d(final state) first):
               dx  = w o (B G) + ((M o K) diag(dt))^T dy + D dy
               dC  = diag(2^L) dy S0^T + ((M o E) diag(dt)) B
               dB  = w o (x G^T) + ((M o E) diag(dt))^T C
               dL  = u + rows(R' dt) - (cols(R') + v') dt,
                     + 2^L_Q <G, S0> + sum(v' dt) at t = Q-1
               ddt = cols(R') + v' + A revcumsum(dL); dA += sum dt
                     revcumsum(dL); dD += trace E
               G  <- 2^L_Q G + C^T diag(2^L) dy
             u_t = 2^L_t sum_n C_t (dy S0^T)_t and v'_s = 2^(L_Q - L_s)
             sum_n B_s (x G^T)_s
  launch 3   dB and dC over (head, column block), ddt over the column
             blocks, dA and dD over (batch, column block), in order

With ``bf16`` each f32 operand that the kernel hands to the bf16 tensor
cores (S0, G, the M-weighted K and E, C o 2^L, B o w) is split into hi =
bf16(v) and lo = bf16(v - hi), or rounded once when not ``split``; the
rest is f32. Tolerances: 1e-5 of each gradient's largest magnitude with
unrounded operands (the algebra, in f64), 2e-2 with the kernel's
rounding (TOL, the card's, in f32 on the same bf16 inputs).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mamba2_ssd, ops  # noqa: E402
from test_torch_ssd_backward import GRADS, _inputs, _jax_vjp  # noqa: E402

Q, PB = mamba2_ssd.CHUNK, mamba2_ssd.CHUNK_COLS
LOG2E = 1.4426950408889634
CLAMP = -128.0          # a step's log2 decay, clamped (the kernel's kClamp2)
ALGEBRA, TOL = 1e-5, 2e-2
F32_TOL = 2e-4          # the f32 gradients (ddt, dA, d state), as the
                        # forward's final state is held


def _bf16(v):
    return v.to(torch.bfloat16).to(v.dtype)


def ex2(v):
    """2^v as ex2.approx.ftz gives it: 0 below the least normal f32."""
    y = torch.exp2(v)
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def chunked_plan(x, dt, A, B_mat, C_mat, D, state, dy, ds_out, *, bf16=True,
                 split=True, col_term=True, dtype=torch.float32):
    """The kernel's plan: (dx, ddt, dA, dB, dC, dD, dstate), dx, dB and
    dC in x's dtype, computed in ``dtype``. ``col_term=False`` drops the
    column sums of R' from dL (a mutation the tests must catch)."""
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    f = dtype
    D = torch.zeros(NH) if D is None else D
    state = torch.zeros(Bsz, NH, N, P) if state is None else state
    ds_out = torch.zeros(Bsz, NH, N, P) if ds_out is None else ds_out

    def op(v):           # an f32 operand of the bf16 tensor cores
        if not bf16:
            return v
        hi = _bf16(v)
        return hi + _bf16(v - hi) if split else hi

    nc = -(-T // Q)

    def chunks(t, heads):   # [B, T, (NH,) X] -> [nc, B, (NH,) Q, X]
        t = torch.nn.functional.pad(t.to(f), (0, 0) * (t.dim() - 2)
                                    + (0, nc * Q - T))
        t = t.reshape(Bsz, nc, Q, *t.shape[2:])
        return t.permute(1, 0, 3, 2, 4) if heads else t.transpose(0, 1)

    xf, dyf = chunks(x, True), chunks(dy, True)          # [nc,B,NH,Q,P]
    Bf = chunks(B_mat, False)[:, :, None]                # [nc,B,1,Q,N]
    Cf = chunks(C_mat, False)[:, :, None]
    dtf = chunks(dt[..., None], True)[..., 0]            # [nc,B,NH,Q]
    L = torch.cumsum(torch.clamp(A.to(f)[None, :, None] * LOG2E * dtf,
                                 min=CLAMP), -1)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()

    # launch 1: the state at each chunk's start
    S, starts = state.to(f), []
    for c in range(nc):
        starts.append(op(S))
        LQ = L[c][..., -1:]
        w = ex2(LQ - L[c]) * dtf[c]
        S = ex2(LQ)[..., None] * S + \
            op(Bf[c] * w[..., None]).transpose(-1, -2) @ xf[c]

    # launch 2: the walk, a block per (b, h, column block)
    ncb = P // PB
    G = ds_out.to(f)
    dx = torch.zeros(nc, Bsz, NH, Q, P, dtype=f)
    dB_part, dC_part = (torch.zeros(nc, Bsz, NH, ncb, Q, N, dtype=f)
                        for _ in range(2))
    ddt_part = torch.zeros(nc, Bsz, NH, ncb, Q, dtype=f)
    dA_part, dD_part = (torch.zeros(Bsz, NH, ncb, dtype=f) for _ in range(2))
    Af, Df = A.to(f)[None, :, None], D.to(f)[None, :, None, None]
    for c in reversed(range(nc)):
        Lc, dtc = L[c], dtf[c]
        LQ = Lc[..., -1:]
        M = ex2((Lc[..., :, None] - Lc[..., None, :])
                .masked_fill(~causal, -math.inf))
        eL, eQ = ex2(Lc), ex2(LQ - Lc)
        w = eQ * dtc
        K = Cf[c] @ Bf[c].transpose(-1, -2)
        for cb in range(ncb):
            cols = slice(cb * PB, cb * PB + PB)
            xc, dyc, S0 = xf[c][..., cols], dyf[c][..., cols], \
                starts[c][..., cols]
            Gc = G[..., cols]
            E = dyc @ xc.transpose(-1, -2)
            dC1 = dyc @ S0.transpose(-1, -2)
            u = eL * (Cf[c] * dC1).sum(-1)
            ME = op(M * E * dtc[..., None, :])
            R = M * K * E
            xG = xc @ op(Gc).transpose(-1, -2)
            vp = eQ * (Bf[c] * xG).sum(-1)
            dx[c][..., cols] = w[..., None] * (Bf[c] @ op(Gc)) + \
                op(M * K * dtc[..., None, :]).transpose(-1, -2) @ dyc + \
                Df * dyc
            dC_part[c][:, :, cb] = eL[..., None] * dC1 + ME @ Bf[c]
            dB_part[c][:, :, cb] = w[..., None] * xG + \
                ME.transpose(-1, -2) @ Cf[c]
            colsum = R.sum(-2)
            dL = u + (R * dtc[..., None, :]).sum(-1) - vp * dtc
            if col_term:
                dL = dL - colsum * dtc
            last = ex2(LQ[..., 0]) * (Gc * S0).sum((-1, -2)) + \
                (vp * dtc).sum(-1)
            dL = torch.cat([dL[..., :-1], dL[..., -1:] + last[..., None]], -1)
            rc = torch.flip(torch.cumsum(torch.flip(dL, [-1]), -1), [-1])
            ddt_part[c][:, :, cb] = colsum + vp + Af * rc
            dA_part[..., cb] += (dtc * rc).sum(-1)
            dD_part[..., cb] += torch.diagonal(E, 0, -2, -1).sum(-1)
        G = ex2(LQ)[..., None] * G + \
            op(Cf[c] * eL[..., None]).transpose(-1, -2) @ dyf[c]

    # launch 3: the sums across blocks, each in a fixed order
    def steps(t):         # [nc, B, NH, ncb, Q, ...] -> [B, NH * ncb, T, ...]
        t = t.permute(1, 2, 3, 0, 4, *range(5, t.dim()))
        return t.reshape(Bsz, NH * ncb, nc * Q, *t.shape[5:])[:, :, :T]
    dBs, dCs, dds = steps(dB_part), steps(dC_part), steps(ddt_part)
    dB, dC = dBs[:, 0], dCs[:, 0]
    for k in range(1, NH * ncb):
        dB, dC = dB + dBs[:, k], dC + dCs[:, k]
    dds = dds.reshape(Bsz, NH, ncb, T)
    ddt = dds[:, :, 0]
    for k in range(1, ncb):
        ddt = ddt + dds[:, :, k]
    dA, dDv = torch.zeros(NH, dtype=f), torch.zeros(NH, dtype=f)
    for b in range(Bsz):
        for k in range(ncb):
            dA, dDv = dA + dA_part[b, :, k], dDv + dD_part[b, :, k]
    dx = dx.permute(1, 0, 3, 2, 4).reshape(Bsz, nc * Q, NH, P)[:, :T]
    return (dx.to(x.dtype), ddt.transpose(1, 2).float(), dA.to(A.dtype),
            dB.to(x.dtype), dC.to(x.dtype), dDv.to(D.dtype), G.float())


def _errors(got, want):
    """Each gradient's largest distance over its largest magnitude."""
    return {name: float((a.float() - b.float()).abs().max())
            / (float(b.float().abs().max()) or 1.0)
            for name, a, b in zip(GRADS, got, want)}


def _close(got, want, tol, what):
    for name, a, b in zip(GRADS, got, want):
        scale = float(b.float().abs().max()) or 1.0
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * scale, msg=f"{what} {name}")


# ----------------------------------------------------------------------
# the plan against autograd and the reference
# ----------------------------------------------------------------------
CASES = [   # (B, T, NH, P, steps, carried, skip)
    (1, 1, 2, 64, "model", True, True),        # a single step
    (2, 37, 3, 64, "model", True, True),       # T < a chunk
    (1, 64, 2, 128, "model", True, True),      # one whole chunk, P 128
    (2, 130, 2, 64, "model", False, True),     # from zeros, ragged
    (1, 256, 4, 64, "model", True, False),     # four chunks, no D
    (2, 130, 2, 128, "near1", True, True),     # decays near 1
    (1, 256, 3, 64, "zero", True, True),       # decays exactly 0
    (2, 64, 4, 64, "zero", True, False),
]


@pytest.mark.parametrize("B,T,NH,P,steps,carried,skip", CASES)
def test_chunked_plan_algebra(B, T, NH, P, steps, carried, skip):
    """Unrounded operands, in f64: all seven gradients of the plan
    against autograd of the port's plain scan and jax.vjp of the
    reference's, on the same f32 inputs, to 1e-5."""
    ins = _inputs(B * 1000 + T + P, B, T, NH, P, 64, steps, carried, skip)
    got = chunked_plan(*ins, bf16=False, dtype=torch.float64)
    _close(got, mamba2_ssd.mamba2_ssd_backward(*ins), ALGEBRA, "autograd")
    _close(got, _jax_vjp(*ins), ALGEBRA, "jax.vjp")


@pytest.mark.parametrize("B,T,NH,P,steps,carried,skip", CASES)
def test_chunked_plan_bf16(B, T, NH, P, steps, carried, skip):
    """The kernel's rounding, in f32, on bf16 inputs: each gradient
    within TOL of its largest magnitude against f32 autograd of the plain
    scan and jax.vjp of the reference on the same bf16 inputs, in the
    kernel's output types."""
    ins = _inputs(B * 1000 + T + P, B, T, NH, P, 64, steps, carried, skip,
                  torch.bfloat16)
    got = chunked_plan(*ins)
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    assert [v.dtype for v in got] == [v.dtype for v in want]
    _close(got, want, TOL, "autograd")
    _close(got, _jax_vjp(*ins), TOL, "jax.vjp")


def test_chunked_plan_through_the_padding():
    """``ops.mamba2`` pads T = 37 to its chunk of 128 with dt = 0 and x =
    B = C = 0: the plan over the padded call, cut back to T, is the
    unpadded gradient (a padded step has decay 1 and no input)."""
    B, T, NH, P = 2, 37, 2, 64
    ins = _inputs(5, B, T, NH, P, 64, "model", True, True, torch.bfloat16)
    x, dt, A, Bm, Cm, D, s0, dy, ds = ins
    leaves = [v.clone().float().requires_grad_()
              for v in (x, dt, A, Bm, Cm, D, s0)]
    y, s = ops.mamba2(*leaves, chunk=128)
    padded = torch.autograd.grad((y, s), leaves, (dy.float(), ds))
    _close(padded, mamba2_ssd.mamba2_ssd_backward(*(
        None if v is None else v.float() for v in ins)), ALGEBRA,
        "padded autograd")
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    pad = [ops._pad_seq(v, 128) for v in (x, dt, Bm, Cm, dy)]
    got = chunked_plan(pad[0], pad[1], A, pad[2], pad[3], D, s0, pad[4], ds)
    got = [got[0][:, :T], got[1][:, :T], got[2], got[3][:, :T],
           got[4][:, :T], got[5], got[6]]
    _close(got, want, TOL, "padded plan")


def test_chunked_plan_needs_the_split():
    """Why the kernel splits its f32 operands in two bf16 terms: rounded
    once, dx, dB and dC stay inside TOL, but the f32 gradients (ddt, dA,
    d state) move by 5x and more the 2e-4 that the forward's final state
    is held to; split, they stay inside it."""
    ins = _inputs(9, 2, 256, 4, 64, 64, "model", True, True, torch.bfloat16)
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    split = _errors(chunked_plan(*ins), want)
    once = _errors(chunked_plan(*ins, split=False), want)
    f32 = ("ddt", "dA", "dstate")
    assert max(split[k] for k in f32) < F32_TOL, split
    assert max(once[k] for k in f32) > 5 * F32_TOL, once
    assert max(once.values()) < TOL, once


def test_chunked_plan_needs_the_column_term():
    """Dropping the column sums of R' from dL leaves dx, dB and dC alone
    and misses ddt and dA by far more than TOL."""
    ins = _inputs(13, 2, 130, 3, 64, 64, "model", True, True,
                  torch.bfloat16)
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    bad = _errors(chunked_plan(*ins, col_term=False), want)
    assert bad["ddt"] > 10 * TOL and bad["dA"] > 10 * TOL, bad
    assert max(bad[k] for k in ("dx", "dB", "dC", "dstate")) < TOL, bad


def test_exact_zero_decay_is_exact():
    """A first step at dt = 200 decays the state by exactly 0: the plan's
    d(state) is exactly 0, as autograd's is (nothing divides by a
    decay)."""
    ins = _inputs(3, 1, 100, 2, 64, 64, "model", True, True,
                  torch.bfloat16)
    ins[1][:, 0] = 200.0
    got = chunked_plan(*ins)
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    assert bool((got[6] == 0).all()) and bool((want[6] == 0).all())
    assert all(bool(torch.isfinite(v.float()).all()) for v in got)


@pytest.mark.parametrize("case,want", [
    ("bf16-N64", "chunked"), ("bf16-N64-P128", "chunked"),
    ("f32-N64", "step"), ("bf16-N16", "step"), ("bf16-N128", "step"),
    ("bf16-P32", "step"), ("bf16-unaligned-x", "step"),
    ("bf16-unaligned-B", "step"), ("bf16-unaligned-base", "step"),
])
def test_backward_route(case, want):
    """Which backward kernel the wrapper would launch, decided from the
    tensors alone: the chunked one for bf16 at N 64, P a multiple of 64,
    and x, B, C and dy at 16-byte aligned bases and strides."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    N = {"bf16-N16": 16, "bf16-N128": 128}.get(case, 64)
    P = {"bf16-N64-P128": 128, "bf16-P32": 32}.get(case, 64)
    x = torch.zeros(2, 40, 4, P, dtype=dtype)
    Bm = torch.zeros(2, 40, N, dtype=dtype)
    if case == "bf16-unaligned-x":
        x = torch.zeros(2, 40, 4, P + 1, dtype=dtype)[..., :P]
    if case == "bf16-unaligned-B":
        Bm = torch.zeros(2, 40, N + 4, dtype=dtype)[..., :N]
    if case == "bf16-unaligned-base":
        x = torch.zeros(2 * 40 * 4 * P + 1, dtype=dtype)[1:].view(2, 40, 4, P)
    dy = torch.zeros(2, 40, 4, P, dtype=dtype)
    assert mamba2_ssd.backward_kernel_for(x, Bm, Bm, dy) == want
