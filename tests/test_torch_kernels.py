"""The port's attention kernels against the reference's: the plain torch
versions against the Pallas kernels (interpret mode) and the jnp oracles
on the grid of tests/test_kernels.py, plus the dispatch rules. The CUDA
kernels themselves run only on the card (tests/test_torch_card.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_prefill, paged_decode, ref  # noqa: E402
from repro_torch.kernels import flash_prefill as t_flash  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import paged_decode as t_paged  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same values in both frameworks (bf16 rounds identically)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _close(port, want, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,S,T,H,KV,hd", [
    (1, 64, 64, 4, 4, 32),        # MHA square
    (2, 128, 128, 8, 2, 64),      # GQA
    (1, 96, 96, 4, 1, 64),        # MQA, ragged seq
    (2, 64, 192, 8, 4, 32),       # cross-size KV (q_offset chunk)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_reference(B, S, T, H, KV, hd, dtype):
    rng = np.random.default_rng(B * 1000 + S + T + H + hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in (
        (B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    off = T - S
    port = t_flash.flash_attention(qt, kt, vt, causal=True, q_offset=off)
    _close(port, ref.flash_attention_ref(qj, kj, vj, causal=True,
                                         q_offset=off), TOL[dtype])
    pallas = flash_prefill.flash_attention(qj, kj, vj, causal=True,
                                           q_offset=off, interpret=True)
    _close(port, pallas, TOL[dtype])


@pytest.mark.parametrize("window,causal", [(16, True), (48, True),
                                           (0, False)])
def test_flash_window_and_noncausal(window, causal):
    rng = np.random.default_rng(window)
    B, S, H, hd = (1, 128, 4, 32) if causal else (2, 64, 4, 32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (B, S, H, hd), "float32")
                                    for _ in range(3))
    port = t_flash.flash_attention(qt, kt, vt, causal=causal, window=window)
    _close(port, ref.flash_attention_ref(qj, kj, vj, causal=causal,
                                         window=window), 2e-4)
    pallas = flash_prefill.flash_attention(qj, kj, vj, causal=causal,
                                           window=window, interpret=True)
    _close(port, pallas, 2e-4)


# ----------------------------------------------------------------------
def _paged_inputs(rng, B, H, KV, hd, pages, page, dtype, lens=None):
    max_pages = pages // 2
    qj, qt = _pair(rng, (B, H, hd), dtype)
    kj, kt = _pair(rng, (pages, page, KV, hd), dtype)
    vj, vt = _pair(rng, (pages, page, KV, hd), dtype)
    bt = np.stack([rng.permutation(pages)[:max_pages]
                   for _ in range(B)]).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, max_pages * page + 1, size=B)
    lens = np.asarray(lens, np.int32)
    return ((qj, kj, vj, jnp.asarray(bt), jnp.asarray(lens)),
            (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(lens)))


@pytest.mark.parametrize("B,H,KV,hd,pages,page", [
    (2, 8, 2, 64, 16, 16),
    (3, 4, 4, 32, 8, 32),
    (1, 16, 16, 64, 32, 16),      # MHA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_vs_reference(B, H, KV, hd, pages, page, dtype):
    rng = np.random.default_rng(B * 100 + H + hd + pages)
    jx, tx = _paged_inputs(rng, B, H, KV, hd, pages, page, dtype)
    port = t_paged.paged_attention(*tx)
    _close(port, ref.paged_attention_ref(*jx), TOL[dtype])
    _close(port, paged_decode.paged_attention(*jx, interpret=True),
           TOL[dtype])


def test_paged_ragged_lengths():
    """Pages past seq_len must not contribute."""
    rng = np.random.default_rng(7)
    jx, tx = _paged_inputs(rng, 2, 4, 4, 32, 8, 16, "float32", lens=[1, 64])
    port = t_paged.paged_attention(*tx)
    _close(port, ref.paged_attention_ref(*jx), 2e-4)
    _close(port, paged_decode.paged_attention(*jx, interpret=True), 2e-4)
    # garbage in the pages past each length changes nothing
    qt, kt, vt, bt, lens = tx
    live = {int(bt[b, j]) for b, n in enumerate(lens.tolist())
            for j in range(-(-n // 16))}
    dead = [p for p in range(kt.shape[0]) if p not in live]
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[dead] = 1e4
    vt2[dead] = -1e4
    torch.testing.assert_close(
        t_paged.paged_attention(qt, kt2, vt2, bt, lens), port)


# ----------------------------------------------------------------------
def test_ops_dispatch_on_cpu_takes_ref():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 32))
                                .astype(np.float32)) for _ in range(3))
    assert t_ops.resolve_backend(None, q) == "ref"
    assert t_ops.resolve_backend("auto", q) == "ref"
    want = t_ref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(t_ops.flash_attention(q, k, v), want)
    torch.testing.assert_close(t_ops.flash_attention(q, k, v, backend="ref"),
                               want)
    before = (t_flash.flash_attention.launches,
              t_paged.paged_attention.launches)
    t_ops.flash_attention(q, k, v)
    assert (t_flash.flash_attention.launches,
            t_paged.paged_attention.launches) == before   # no kernel on CPU


@pytest.mark.parametrize("backend", ["cuda", "pallas", "triton"])
def test_ops_rejects_backend_not_matching_device(backend):
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError):
        t_ops.flash_attention(q, q, q, backend=backend)
    qp, kp = torch.zeros(1, 2, 32), torch.zeros(4, 8, 2, 32)
    bt, sl = torch.zeros(1, 2, dtype=torch.int32), torch.ones(1,
                                                              dtype=torch.int32)
    with pytest.raises(ValueError):
        t_ops.paged_attention(qp, kp, kp, bt, sl, backend=backend)
