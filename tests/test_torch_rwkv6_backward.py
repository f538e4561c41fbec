"""The rwkv6 backward kernel's plan, mirrored in torch and held against
autograd of the port's plain scan and ``jax.vjp`` of the reference's.

``csrc/rwkv6_backward.cu`` cannot run here, so ``backward_plan`` repeats
its plan on the CPU, with its index arithmetic line for line. One block
per (batch, head) holds G = dL/dS [hd, hd] in registers: thread (c, q)
owns row c and the columns ``cols(hd)[q]`` (4 lanes a row). A first sweep
runs the recurrence forward and keeps the state at the start of every
sub-chunk of ``SUB_CHUNK[hd]`` steps. Then, sub-chunk by sub-chunk in
reverse, it recomputes that sub-chunk's states S_t from the kept one and
walks its steps backwards:

  dk_t[c] = sum_j G[c][j] v_t[j] + u[c] r_t[c] (v_t . dy_t)
  dr_t[c] = sum_j S_t[c][j] dy_t[j] + u[c] k_t[c] (v_t . dy_t)
  dw_t[c] = sum_j G[c][j] S_t[c][j]
  dv_t[j] = sum_c G[c][j] k_t[c] + (sum_c r_t[c] u[c] k_t[c]) dy_t[j]
  du[c]  += r_t[c] k_t[c] (v_t . dy_t)
  G[c][j] <- w_t[c] G[c][j] + r_t[c] dy_t[j]

with G = dL/dS_{t+1} on the right (G_T = d final state; d state_0 = G_0).
Row sums: each lane's columns in order, then the 4 lanes by an xor
butterfly; column sums: a halving exchange over the 8 rows of a warp,
then the warps in order. f32 throughout; in bf16 dr, dk and dv are
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
from repro_torch.kernels import ops, rwkv6_scan  # noqa: E402

LANES = 4                                 # threads a row of G
ROWS = 32 // LANES                        # rows of G a warp
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRADS = ("dr", "dk", "dv", "dw", "du", "dstate")


# ----------------------------------------------------------------------
# the kernel's index arithmetic
# ----------------------------------------------------------------------
def cols(hd):
    """[LANES, NC]: lane q's local column i is 16 (i // 4) + 4 q + i % 4
    (float4 m = i // 4 of the lane, neighbouring lanes on neighbouring
    16-byte words)."""
    nc = hd // LANES
    i = torch.arange(nc)
    return 16 * (i // 4)[None] + 4 * torch.arange(LANES)[:, None] + i % 4


def kept_columns(cb, nc):
    """The local columns that row ``cb`` of a warp holds after the
    halving exchange (xor 16, 8, 4 of the lane: bits 2, 1, 0 of cb)."""
    i0 = ((cb >> 2) & 1) * nc // 2 + ((cb >> 1) & 1) * nc // 4 + \
        (cb & 1) * nc // 8
    return range(i0, i0 + nc // 8)


def butterfly(x, offsets):
    """Lane sums of ``x`` [..., lanes] by xor shuffles at ``offsets``, in
    the kernel's order (every lane ends with the same value)."""
    idx = torch.arange(x.shape[-1])
    for off in offsets:
        x = x + x[..., idx ^ off]
    return x[..., 0]


def warp_dot(a, b):
    """sum_j a[..., j] b[..., j] as one warp takes it: lane l sums j = l,
    l + 32, ... in order, then a butterfly over the 32 lanes."""
    hd = a.shape[-1]
    per = (a * b).reshape(*a.shape[:-1], hd // 32, 32)
    lane = per[..., 0, :]
    for n in range(1, per.shape[-2]):
        lane = lane + per[..., n, :]
    return butterfly(lane, (16, 8, 4, 2, 1))


def backward_plan(r, k, v, w, u, state, dy, ds_out):
    """The kernel's plan: (dr, dk, dv, dw, du, dstate), dr/dk/dv in r's
    dtype."""
    B, T, NH, hd = r.shape
    L, nc = rwkv6_scan.SUB_CHUNK[hd], hd // LANES
    nw = LANES * hd // 32
    J = cols(hd)                                         # [LANES, nc]
    rf, kf, vf, wf, dyf = (x.float().permute(0, 2, 1, 3)
                           for x in (r, k, v, w, dy))    # [B, NH, T, hd]
    uf = u.float()[None]                                 # [1, NH, hd]
    # per thread (c, q): [B, NH, hd (c), LANES (q), nc (i)]
    S = state.float()[..., J]
    G = ds_out.float()[..., J]
    nsc = -(-T // L)

    def advance(S, t):
        kc, wc = kf[:, :, t, :, None, None], wf[:, :, t, :, None, None]
        return S * wc + kc * vf[:, :, t][..., J][:, :, None]

    kept = []                                            # sweep
    for sc in range(nsc):
        kept.append(S)
        if sc < nsc - 1:
            for t in range(sc * L, sc * L + L):
                S = advance(S, t)

    dr, dk, dw = (torch.zeros(B, NH, T, hd) for _ in range(3))
    dv = torch.zeros(B, NH, T, hd)
    du_acc = torch.zeros(B, NH, hd)
    for sc in reversed(range(nsc)):
        t0, n = sc * L, min(L, T - sc * L)
        vdy = warp_dot(vf[:, :, t0:t0 + n], dyf[:, :, t0:t0 + n])
        bon = warp_dot(rf[:, :, t0:t0 + n] * uf[:, :, None],
                       kf[:, :, t0:t0 + n])              # [B, NH, n]
        hist, S = [], kept[sc]                           # recompute
        for s in range(n):
            hist.append(S)
            S = advance(S, t0 + s)
        col = torch.zeros(B, NH, n, nw, hd)
        for s in reversed(range(n)):                     # walk
            t = t0 + s
            rc, kc, wc = (x[:, :, t, :, None] for x in (rf, kf, wf))
            vl, dyl = (x[:, :, t][..., J][:, :, None] for x in (vf, dyf))
            Sl, vd = hist[s], vdy[:, :, s, None]
            dkp = dwp = drp = torch.zeros(B, NH, hd, LANES)
            for i in range(nc):
                dkp = dkp + G[..., i] * vl[..., i]
                dwp = dwp + G[..., i] * Sl[..., i]
                drp = drp + Sl[..., i] * dyl[..., i]
            colv = G * kc[..., None]
            G = G * wc[..., None] + rc[..., None] * dyl
            uc = uf[..., :]
            dk[:, :, t] = butterfly(dkp, (1, 2)) + (uc * rc[..., 0]) * vd
            dr[:, :, t] = butterfly(drp, (1, 2)) + (uc * kc[..., 0]) * vd
            dw[:, :, t] = butterfly(dwp, (1, 2))
            du_acc = du_acc + (rc[..., 0] * kc[..., 0]) * vd
            # column sums over the 8 rows of each warp: the halving
            # exchange's tree, each row keeping its share of the columns
            x = colv.reshape(B, NH, nw, ROWS, LANES, nc)
            tree = ((x[:, :, :, 0] + x[:, :, :, 4])
                    + (x[:, :, :, 2] + x[:, :, :, 6])) \
                + ((x[:, :, :, 1] + x[:, :, :, 5])
                   + (x[:, :, :, 3] + x[:, :, :, 7]))   # [B,NH,nw,4,nc]
            written = torch.zeros(hd, dtype=torch.int64)
            for cb in range(ROWS):
                for i in kept_columns(cb, nc):
                    col[:, :, s, :, J[:, i]] = tree[..., i]
                    written[J[:, i]] += 1
            assert bool((written == 1).all())
        acc = col[:, :, :, 0]                            # epilogue
        for wi in range(1, nw):
            acc = acc + col[:, :, :, wi]
        dv[:, :, t0:t0 + n] = acc + bon[..., None] * dyf[:, :, t0:t0 + n]
    du = du_acc[0]
    for b in range(1, B):
        du = du + du_acc[b]
    dstate = torch.zeros(B, NH, hd, hd)
    dstate[..., J] = G
    back = [x.permute(0, 2, 1, 3) for x in (dr, dk, dv, dw)]
    return (*(x.to(r.dtype) for x in back[:3]), back[3], du.to(u.dtype),
            dstate)


# ----------------------------------------------------------------------
# inputs and references
# ----------------------------------------------------------------------
DECAYS = {   # name: w from a uniform draw x in [0, 1)
    "model": lambda x: np.exp(-np.exp(x - 1.5)),   # exp(-exp(w0 + lora))
    "near0": lambda x: 1e-6 + 1e-3 * x,
    "near1": lambda x: 0.999 + 1e-3 * x,
    "zero": lambda x: np.where(x < 0.3, 0.0, np.exp(-np.exp(x - 1.5))),
    "one": lambda x: np.where(x < 0.3, 1.0, np.exp(-np.exp(x - 1.5))),
}


def _inputs(seed, B, T, NH, hd, decay, carried, dtype=torch.float32):
    """numpy draws: r, k, v (rounded to ``dtype``), w f32, u, state and
    the two output gradients (dy in ``dtype``)."""
    g = np.random.default_rng(seed)
    r, k, v, dy = (g.standard_normal((B, T, NH, hd)).astype(np.float32)
                   for _ in range(4))
    w = DECAYS[decay](g.random((B, T, NH, hd))).astype(np.float32)
    u = (0.1 * g.standard_normal((NH, hd))).astype(np.float32)
    shape = (B, NH, hd, hd)
    state, ds = ((g.standard_normal(shape).astype(np.float32),
                  g.standard_normal(shape).astype(np.float32)) if carried
                 else (np.zeros(shape, np.float32),) * 2)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u, state, dy, ds)]
    for i in (0, 1, 2, 6):
        t[i] = t[i].to(dtype)
    return t


def _jax_vjp(r, k, v, w, u, state, dy, ds):
    """jax.vjp of the reference's rwkv6_scan_ref (bf16 inputs stay bf16)."""
    def arr(x):
        dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
        return jnp.asarray(x.float().numpy(), dtype=dt)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *(arr(x) for x in (
        r, k, v, w, u, state)))
    return [torch.from_numpy(np.asarray(g, dtype=np.float32))
            for g in vjp((arr(dy), jnp.asarray(ds.numpy())))]


def _close(got, want, tol, what):
    for name, a, b in zip(GRADS, got, want):
        scale = float(b.float().abs().max()) or 1.0
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * scale, msg=f"{what} {name}")


# ----------------------------------------------------------------------
# the plan against autograd and the reference
# ----------------------------------------------------------------------
CASES = [   # (B, T, NH, hd, decay, carried, dtype)
    (1, 1, 2, 64, "model", True, torch.float32),
    (2, 37, 2, 64, "model", True, torch.float32),
    (1, 63, 2, 64, "near0", True, torch.float32),
    (2, 64, 1, 64, "near1", True, torch.float32),
    (1, 65, 2, 64, "zero", True, torch.float32),
    (2, 200, 1, 64, "one", False, torch.float32),
    (2, 65, 2, 32, "model", True, torch.float32),
    (1, 200, 1, 32, "near1", True, torch.float32),
    (1, 37, 1, 128, "model", True, torch.float32),
    (2, 5, 1, 128, "zero", True, torch.float32),
    (2, 64, 2, 64, "model", True, torch.bfloat16),
    (1, 37, 2, 32, "near0", True, torch.bfloat16),
    (1, 65, 1, 128, "model", True, torch.bfloat16),
]


@pytest.mark.parametrize("B,T,NH,hd,decay,carried,dtype", CASES)
def test_backward_plan_matches_autograd_and_reference(B, T, NH, hd, decay,
                                                      carried, dtype):
    """All six gradients of the plan against autograd of the port's plain
    scan and jax.vjp of the reference's, on the same inputs."""
    ins = _inputs(B * 1000 + T, B, T, NH, hd, decay, carried, dtype)
    got = backward_plan(*ins)
    assert [x.dtype for x in got] == [dtype] * 3 + [torch.float32] * 3
    want = rwkv6_scan.rwkv6_scan_backward(*ins)
    assert [x.dtype for x in want] == [x.dtype for x in got]
    _close(got, want, TOL[dtype], "autograd")
    _close(got, _jax_vjp(*ins), TOL[dtype], "jax.vjp")


def test_backward_plan_through_the_padding():
    """``ops.rwkv6`` pads T = 37 to 64 with w = 1 and r = k = v = 0: the
    plan over the padded call, cut back to T, is the unpadded gradient
    (the padded steps carry G back unchanged)."""
    B, T, NH, hd = 2, 37, 2, 64
    r, k, v, w, u, state, dy, ds = _inputs(5, B, T, NH, hd, "model", True)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, w, u, state)]
    y, s = ops.rwkv6(*leaves, chunk=64)
    assert y.shape == dy.shape
    padded = torch.autograd.grad((y, s), leaves, (dy, ds))
    want = rwkv6_scan.rwkv6_scan_backward(r, k, v, w, u, state, dy, ds)
    _close(padded, want, TOL[torch.float32], "padded autograd")
    pad = [ops._pad_seq(x, 64) for x in (r, k, v, dy)]
    got = backward_plan(pad[0], pad[1], pad[2], ops._pad_seq(w, 64, 1.0),
                        u, state, pad[3], ds)
    got = [x[:, :T] for x in got[:4]] + list(got[4:])
    _close(got, want, TOL[torch.float32], "padded plan")


def test_plan_constants():
    """Every thread owns distinct columns; the halving exchange leaves
    each column of a warp's rows with exactly one row; a sub-chunk's
    states fill 128 KB."""
    for hd in rwkv6_scan.HEAD_DIMS:
        J, nc = cols(hd), hd // LANES
        assert sorted(J.flatten().tolist()) == list(range(hd))
        held = sorted(i for cb in range(ROWS) for i in kept_columns(cb, nc))
        assert held == list(range(nc))
        assert rwkv6_scan.SUB_CHUNK[hd] * hd * hd * 4 == 128 * 1024


def test_plain_autograd_matches_reference_vjp():
    """The port's plain backward (what the kernel is held to) against
    jax.vjp of the reference's rwkv6_scan_ref, with a carried state, a
    nonzero d(final state) and decays with exact zeros."""
    ins = _inputs(11, 2, 50, 2, 32, "zero", True)
    got = rwkv6_scan.rwkv6_scan_backward(*ins)
    _close(got, _jax_vjp(*ins), TOL[torch.float32], "plain")
