"""The Mamba2 SSD backward kernel's plan, mirrored in torch and held
against autograd of the port's plain scan and ``jax.vjp`` of the
reference's.

``csrc/mamba2_ssd_backward.cu`` cannot run here, so ``backward_plan``
repeats its plan on the CPU, with its index arithmetic and its orders of
summation. A block owns (batch, head, a slice of 16 state columns) and
``BWD_ROWS[N]`` threads, thread r holding row r of G = dL/dS over the
slice (rows past N held at 0). A first sweep runs the recurrence forward
and keeps the state at the start of every sub-chunk of ``SUB_CHUNK[N]``
steps. Then, sub-chunk by sub-chunk in reverse, it recomputes that
sub-chunk's states S_{t-1} from the kept one and walks its steps
backwards:

  G        <- G + C_t[r] dy_t                      (G_t)
  S_t       = a_t S_{t-1} + B_t[r] (dt_t x_t)
  db[r]     = sum_p G x_t[p],  dc[r] = sum_p S_t dy_t[p],
  gs[r]     = sum_p G S_{t-1}                      (each lane in order)
  colv      = G B_t[r]                             (dx: down the columns)
  G        <- a_t G

dx's column sums run over a warp's 32 rows by a halving exchange (lane
bits 4 down to 0), then over the warps in order. Each sub-chunk's
epilogue writes dx = dt colsum + D dy, the block's partials of dB (dt db)
and dC (dc), and, a warp a step, ddt's partial (sum_r B db + A a sum_r
gs: lanes in order, then an xor butterfly) and the dA and dD terms, each
warp summing its own steps. A second launch adds the blocks' partials in
a fixed order: dB and dC over (head, slice), ddt over the slices, dA and
dD over (batch, slice). f32 throughout; in bf16 dx, dB and dC are
rounded once at the end.

Tolerances: 1e-5 of each gradient's largest magnitude in f32 (sums in
another order); in bf16 2e-2, the card's, against f32 autograd on the
same bf16 inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import mamba2_ssd, ops  # noqa: E402

COLS = mamba2_ssd.COLS
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dstate")


# ----------------------------------------------------------------------
# the kernel's orders of summation
# ----------------------------------------------------------------------
def butterfly(x, offsets=(16, 8, 4, 2, 1)):
    """Lane sums of ``x`` [..., 32] by xor shuffles at ``offsets``, in
    the kernel's order (every lane ends with the same value)."""
    idx = torch.arange(x.shape[-1])
    for off in offsets:
        x = x + x[..., idx ^ off]
    return x[..., 0]


def warp_dot(a, b):
    """sum_c a[..., c] b[..., c] as one warp takes it: lane l sums c = l,
    l + 32, ... in order (from 0), then a butterfly over the 32 lanes."""
    n = a.shape[-1]
    per = torch.nn.functional.pad(a * b, (0, (-n) % 32))
    per = per.reshape(*per.shape[:-1], -1, 32)
    lane = torch.zeros(per.shape[:-2] + (32,))
    for i in range(per.shape[-2]):
        lane = lane + per[..., i, :]
    return butterfly(lane)


def column_sums(colv, warps):
    """colv [..., rows, 16] summed down the rows: within a warp the
    halving exchange's tree (lane bit 4 first, bit 0 last), then the
    warps in order."""
    v = colv.reshape(*colv.shape[:-2], warps, 2, 2, 2, 2, 2, COLS)
    for k in range(5, 0, -1):
        v = v.select(-k - 1, 0) + v.select(-k - 1, 1)
    acc = v[..., 0, :]
    for w in range(1, warps):
        acc = acc + v[..., w, :]
    return acc


def lane_sum(v):
    """sum over the last axis in order, from 0: a thread's fmaf chain."""
    acc = torch.zeros(v.shape[:-1])
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def backward_plan(x, dt, A, B_mat, C_mat, D, state, dy, ds_out):
    """The kernel's plan: (dx, ddt, dA, dB, dC, dD, dstate), dx, dB and
    dC in x's dtype."""
    Bsz, T, NH, P = x.shape
    N = B_mat.shape[-1]
    R, L = mamba2_ssd.BWD_ROWS[N], mamba2_ssd.SUB_CHUNK[N]
    ns, nw = P // COLS, R // 32
    D = torch.zeros(NH) if D is None else D
    zero = torch.zeros(Bsz, NH, N, P)
    state = zero if state is None else state
    ds_out = zero if ds_out is None else ds_out

    def blocks(t):        # [B, T, NH, P] -> [B, NH, ns, T, 16]
        return t.float().reshape(Bsz, T, NH, ns, COLS).permute(0, 2, 3, 1, 4)

    def rows(t):          # [B, T, N] -> [B, 1, 1, T, R], rows past N at 0
        return torch.nn.functional.pad(t.float(), (0, R - N))[:, None, None]

    def held(t):          # [B, NH, N, P] -> [B, NH, ns, R, 16]
        t = t.float().reshape(Bsz, NH, N, ns, COLS).permute(0, 1, 3, 2, 4)
        return torch.nn.functional.pad(t, (0, 0, 0, R - N))

    xf, dyf = blocks(x), blocks(dy)
    dtf = dt.float().permute(0, 2, 1)[:, :, None]           # [B, NH, 1, T]
    Af = A.float()[None, :, None, None]
    a = torch.exp(Af * dtf)
    xd = dtf[..., None] * xf
    Bp, Cp = rows(B_mat), rows(C_mat)
    S, G = held(state), held(ds_out)
    nsc = -(-T // L)

    def advance(S, t):
        return a[..., t, None, None] * S + \
            Bp[..., t, :, None] * xd[..., t, None, :]

    kept = []                                               # sweep
    for sc in range(nsc):
        kept.append(S)
        if sc < nsc - 1:
            for t in range(sc * L, sc * L + L):
                S = advance(S, t)

    dx = torch.zeros(Bsz, NH, ns, T, COLS)
    dB_part, dC_part = torch.zeros(Bsz, NH, ns, T, R), torch.zeros(
        Bsz, NH, ns, T, R)
    ddt_part = torch.zeros(Bsz, NH, ns, T)
    da, dd = torch.zeros(Bsz, NH, ns, nw), torch.zeros(Bsz, NH, ns, nw)
    Df = D.float()[None, :, None, None, None]
    for sc in reversed(range(nsc)):
        t0, n = sc * L, min(L, T - sc * L)
        hist, S = [], kept[sc]                              # recompute
        for s in range(n):
            hist.append(S)
            S = advance(S, t0 + s)
        col = torch.zeros(Bsz, NH, ns, n, COLS)
        db, dc, gs = (torch.zeros(Bsz, NH, ns, n, R) for _ in range(3))
        for s in reversed(range(n)):                        # walk
            t = t0 + s
            at, bn = a[..., t, None, None], Bp[..., t, :, None]
            xt, dyt = xf[..., t, None, :], dyf[..., t, None, :]
            g = Cp[..., t, :, None] * dyt + G
            sp = hist[s]
            sn = at * sp + bn * xd[..., t, None, :]
            db[..., s, :] = lane_sum(g * xt)
            dc[..., s, :] = lane_sum(sn * dyt)
            gs[..., s, :] = lane_sum(g * sp)
            col[..., s, :] = column_sums(g * bn, nw)
            G = at * g
        steps = slice(t0, t0 + n)                           # epilogue
        dx[..., steps, :] = dtf[..., steps, None] * col + \
            Df * dyf[..., steps, :]
        dB_part[..., steps, :] = dtf[..., steps, None] * db
        dC_part[..., steps, :] = dc
        for s in range(n):
            t, w = t0 + s, s % nw
            u1 = warp_dot(Bp[..., t, :].expand_as(db[..., s, :]),
                          db[..., s, :])
            g = warp_dot(gs[..., s, :], torch.ones(R))
            xy = warp_dot(dyf[..., t, :], xf[..., t, :])
            ddt_part[..., t] = Af[..., 0] * a[..., t] * g + u1
            da[..., w] = da[..., w] + dtf[..., t] * a[..., t] * g
            dd[..., w] = dd[..., w] + xy
    dA_part, dD_part = da[..., 0], dd[..., 0]
    for w in range(1, nw):
        dA_part, dD_part = dA_part + da[..., w], dD_part + dd[..., w]

    # the second launch: the sums across blocks, each in a fixed order
    dBs = dB_part[..., :N].reshape(Bsz, NH * ns, T, N)
    dCs = dC_part[..., :N].reshape(Bsz, NH * ns, T, N)
    dB, dC = dBs[:, 0], dCs[:, 0]
    for k in range(1, NH * ns):
        dB, dC = dB + dBs[:, k], dC + dCs[:, k]
    ddt = ddt_part[:, :, 0]
    for s in range(1, ns):
        ddt = ddt + ddt_part[:, :, s]
    dA, dDv = torch.zeros(NH), torch.zeros(NH)
    for b in range(Bsz):
        for s in range(ns):
            dA, dDv = dA + dA_part[b, :, s], dDv + dD_part[b, :, s]
    dstate = G[..., :N, :].permute(0, 1, 3, 2, 4).reshape(Bsz, NH, N, P)
    dx = dx.permute(0, 3, 1, 2, 4).reshape(Bsz, T, NH, P)
    return (dx.to(x.dtype), ddt.permute(0, 2, 1), dA.to(A.dtype),
            dB.to(x.dtype), dC.to(x.dtype), dDv.to(D.dtype), dstate)


# ----------------------------------------------------------------------
# inputs and references
# ----------------------------------------------------------------------
STEPS = {   # name: dt from a normal draw z
    "model": lambda z: np.log1p(np.exp(z - 2.5)),     # softplus: ~0.1
    "near1": lambda z: 1e-5 * np.abs(z),              # a = exp(A dt) ~ 1
    # a tenth of the steps at dt = 200: A dt < -104, a exactly 0 in f32
    "zero": lambda z: np.where(np.abs(z) < 0.125, 200.0,
                               np.log1p(np.exp(z - 2.5))),
}


def _inputs(seed, B, T, NH, P, N, steps, carried, skip=True,
            dtype=torch.float32):
    """numpy draws: x, B, C and dy (rounded to ``dtype``), dt f32, the
    model's A (-1 .. -16), D (None without ``skip``), state and the final
    state's gradient (zeros unless ``carried``)."""
    g = np.random.default_rng(seed)
    x, dy = (g.standard_normal((B, T, NH, P)).astype(np.float32)
             for _ in range(2))
    Bm, Cm = (g.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    dt = STEPS[steps](g.standard_normal((B, T, NH))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, NH).astype(np.float32)
    D = g.standard_normal(NH).astype(np.float32) if skip else None
    shape = (B, NH, N, P)
    state, ds = ((g.standard_normal(shape).astype(np.float32),
                  g.standard_normal(shape).astype(np.float32)) if carried
                 else (np.zeros(shape, np.float32),) * 2)
    t = [None if v is None else torch.from_numpy(v)
         for v in (x, dt, A, Bm, Cm, D, state, dy, ds)]
    for i in (0, 3, 4, 7):
        t[i] = t[i].to(dtype)
    return t


def _jax_vjp(x, dt, A, B_mat, C_mat, D, state, dy, ds):
    """jax.vjp of the reference's mamba2_ssd_ref (bf16 inputs stay bf16);
    D None as D = 0 (the same y), so dD is the gradient there."""
    def arr(v):
        kind = jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(v.float().numpy(), dtype=kind)
    D = torch.zeros(A.shape) if D is None else D
    _, vjp = jax.vjp(jref.mamba2_ssd_ref, *(arr(v) for v in (
        x, dt, A, B_mat, C_mat, D, state)))
    return [torch.from_numpy(np.array(v, dtype=np.float32))
            for v in vjp((arr(dy), jnp.asarray(ds.numpy())))]


def _close(got, want, tol, what):
    for name, a, b in zip(GRADS, got, want):
        scale = float(b.float().abs().max()) or 1.0
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * scale, msg=f"{what} {name}")


# ----------------------------------------------------------------------
# the plan against autograd and the reference
# ----------------------------------------------------------------------
CASES = [   # (B, T, NH, P, N, steps, carried, skip, dtype)
    (1, 1, 2, 32, 16, "model", True, True, torch.float32),
    (2, 37, 2, 32, 16, "model", True, True, torch.float32),
    (2, 130, 2, 64, 64, "model", True, True, torch.float32),
    (1, 37, 3, 64, 64, "model", False, True, torch.float32),
    (2, 37, 2, 64, 64, "near1", True, False, torch.float32),
    (1, 130, 2, 32, 64, "zero", True, True, torch.float32),
    (2, 37, 1, 64, 128, "model", True, True, torch.float32),
    (1, 130, 2, 32, 128, "zero", True, False, torch.float32),
    (2, 1, 2, 64, 128, "near1", True, True, torch.float32),
    (1, 130, 2, 32, 32, "model", True, True, torch.float32),
    (2, 130, 2, 64, 64, "model", True, True, torch.bfloat16),
    (1, 37, 2, 32, 16, "zero", True, False, torch.bfloat16),
    (2, 37, 1, 64, 128, "near1", True, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,T,NH,P,N,steps,carried,skip,dtype", CASES)
def test_backward_plan_matches_autograd_and_reference(B, T, NH, P, N, steps,
                                                      carried, skip, dtype):
    """All seven gradients of the plan against autograd of the port's
    plain scan and jax.vjp of the reference's, on the same inputs."""
    ins = _inputs(B * 1000 + T + N, B, T, NH, P, N, steps, carried, skip,
                  dtype)
    got = backward_plan(*ins)
    kinds = [dtype, torch.float32, torch.float32, dtype, dtype,
             torch.float32, torch.float32]
    assert [v.dtype for v in got] == kinds
    want = mamba2_ssd.mamba2_ssd_backward(*ins)
    assert [v.dtype for v in want] == kinds
    _close(got, want, TOL[dtype], "autograd")
    _close(got, _jax_vjp(*ins), TOL[dtype], "jax.vjp")


def test_exact_zero_decay_is_exact():
    """Where a = exp(A dt) is exactly 0 the state restarts: the plan's
    d(state) is exactly 0 when the first step's decay is 0, as autograd's
    is (nothing divides by a)."""
    x, dt, A, Bm, Cm, D, s0, dy, ds = _inputs(3, 1, 20, 2, 32, 16, "model",
                                              True)
    dt[:, 0] = 200.0
    assert float(torch.exp(A * dt[0, 0]).abs().max()) == 0.0
    got = backward_plan(x, dt, A, Bm, Cm, D, s0, dy, ds)
    want = mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0, dy, ds)
    assert bool((got[6] == 0).all()) and bool((want[6] == 0).all())
    assert all(bool(torch.isfinite(v).all()) for v in got)


def test_backward_plan_through_the_padding():
    """``ops.mamba2`` pads T = 37 to 64 with dt = 0 and x = B = C = 0: the
    plan over the padded call, cut back to T, is the unpadded gradient
    (a padded step has decay 1 and no input, so it carries G back
    unchanged)."""
    B, T, NH, P, N = 2, 37, 2, 32, 16
    x, dt, A, Bm, Cm, D, s0, dy, ds = _inputs(5, B, T, NH, P, N, "model",
                                              True)
    leaves = [v.clone().requires_grad_() for v in (x, dt, A, Bm, Cm, D, s0)]
    y, s = ops.mamba2(*leaves, chunk=64)
    assert y.shape == dy.shape
    padded = torch.autograd.grad((y, s), leaves, (dy, ds))
    want = mamba2_ssd.mamba2_ssd_backward(x, dt, A, Bm, Cm, D, s0, dy, ds)
    _close(padded, want, TOL[torch.float32], "padded autograd")
    pad = [ops._pad_seq(v, 64) for v in (x, dt, Bm, Cm, dy)]
    got = backward_plan(pad[0], pad[1], A, pad[2], pad[3], D, s0, pad[4], ds)
    got = [got[0][:, :T], got[1][:, :T], got[2], got[3][:, :T],
           got[4][:, :T], got[5], got[6]]
    _close(got, want, TOL[torch.float32], "padded plan")


def test_plan_constants():
    """A sub-chunk's states fill 32 KB a block; the halving exchange
    leaves every column of a warp with exactly one even lane."""
    for n in mamba2_ssd.STATE_DIMS:
        rows = mamba2_ssd.BWD_ROWS[n]
        assert rows % 32 == 0 and rows >= n
        assert mamba2_ssd.SUB_CHUNK[n] * rows * COLS * 4 == 32 * 1024
    lanes = range(0, 32, 2)
    cols = [((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4
            + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1) for lane in lanes]
    assert sorted(cols) == list(range(COLS))


def test_plain_autograd_matches_reference_vjp():
    """The port's plain backward (what the kernel is held to) against
    jax.vjp of the reference's mamba2_ssd_ref, with a carried state, a
    nonzero d(final state) and decays with exact zeros."""
    ins = _inputs(11, 2, 50, 3, 32, 32, "zero", True)
    got = mamba2_ssd.mamba2_ssd_backward(*ins)
    _close(got, _jax_vjp(*ins), TOL[torch.float32], "plain")
