"""The f32 references: a dense layer against a case computed by hand, the
chunked RWKV6 recurrence against the step-by-step one, and each family's
logits against the port's own model in f32 at a tiny size (the reference
judges the port's function, so the two must agree where neither rounds
to bf16)."""
import json
import math

import numpy as np
import pytest
import torch

from conftest import DATA
from portbench.reference import dense, f32_mm, logits, rwkv6
from portbench.reference.lowp import fp8_mm


def test_dense_hand_computed():
    """One layer, d 2, one query head over one KV head of size 2, d_ff 1,
    vocab 2, two tokens; every weight chosen so the sums can be done by
    hand (below, step by step)."""
    I2 = torch.eye(2)
    params = {"embed": {"embedding": torch.tensor([[1.0, 0.0], [0.0, 2.0]]),
                        "final_norm": torch.ones(2),
                        "lm_head": torch.tensor([[1.0, 0.0], [0.0, 1.0]])},
              "layers": [{"attn": {"wq": I2, "wk": I2, "wv": I2, "wo": I2},
                          "mlp": {"w_gate": torch.zeros(2, 1),
                                  "w_up": torch.zeros(2, 1),
                                  "w_down": torch.zeros(1, 2)},
                          "norm_attn": torch.ones(2),
                          "norm_mlp": torch.ones(2)}]}
    cfg = {"num_heads": 1, "num_kv_heads": 1, "head_dim": 2,
           "norm_eps": 0.0, "rope_theta": 1.0, "tie_embeddings": False}
    h = dense.hidden(params, cfg, torch.tensor([0, 1]))
    # token 0: x = (1, 0); rms = 1/sqrt(2) -> h = (sqrt2, 0); position 0:
    # no rotation; it attends to itself: a = v = (sqrt2, 0); x = (1+sqrt2, 0)
    # token 1: x = (0, 2); h = (0, sqrt2); position 1 rotates q and k by
    # 1 rad: k1 = (-sqrt2 sin1, sqrt2 cos1); k0 = (sqrt2, 0);
    # q1.k0 / sqrt2 = -sqrt2 sin1 ... computed below in plain numbers
    s2 = math.sqrt(2.0)
    q1 = np.array([-s2 * math.sin(1), s2 * math.cos(1)])
    k0, k1 = np.array([s2, 0.0]), q1
    v0, v1 = np.array([s2, 0.0]), np.array([0.0, s2])
    sc = np.array([q1 @ k0, q1 @ k1]) / s2
    p = np.exp(sc - sc.max()) / np.exp(sc - sc.max()).sum()
    x1 = np.array([0.0, 2.0]) + p[0] * v0 + p[1] * v1
    x0 = np.array([1.0 + s2, 0.0])
    want = np.stack([x / np.sqrt((x ** 2).mean()) for x in (x0, x1)])
    np.testing.assert_allclose(h.numpy(), want, rtol=1e-6, atol=1e-6)
    (lo, lg), = logits(params, cfg, h)
    np.testing.assert_allclose(lg.numpy(), want, rtol=1e-6, atol=1e-6)


def _naive_wkv(r, k, v, w, u):
    T, NH, hd = r.shape
    S = torch.zeros(NH, hd, hd, dtype=torch.float64)
    ys = []
    for t in range(T):
        y = torch.einsum("hc,hcj->hj", r[t], S) \
            + (r[t] * u * k[t]).sum(-1, keepdim=True) * v[t]
        S = w[t][..., None] * S + k[t][..., None] * v[t][:, None, :]
        ys.append(y)
    return torch.stack(ys)


@pytest.mark.parametrize("T", [1, 31, 32, 77, 600])
def test_rwkv6_chunked_recurrence(T):
    g = torch.Generator().manual_seed(T)
    NH, hd = 3, 8
    r, k, v = (torch.randn(T, NH, hd, generator=g, dtype=torch.float64)
               for _ in range(3))
    # decays spread from ~0 to ~1, and one channel at exactly 0
    w = torch.rand(T, NH, hd, generator=g, dtype=torch.float64) ** 0.3
    w[:, 0, 0] = 0.0
    u = torch.randn(NH, hd, generator=g, dtype=torch.float64)
    got = rwkv6.wkv(*(x.float() for x in (r, k, v, w, u)))
    want = _naive_wkv(r, k, v, w, u)
    scale = want.abs().max()
    assert float((got.double() - want).abs().max() / scale) < 2e-6


def _port(name):
    from portbench.harness import spec
    from repro_torch.models import get_model
    cj = json.loads((DATA / "portbench" / "configs" / f"{name}.json")
                    .read_text())
    cj = dict(cj, param_dtype="float32", compute_dtype="float32")
    cfg = spec.model_config(name, cj)
    model = get_model(cfg)
    from portbench.harness import weights
    params = weights.make(model, cj["init"], cfg.num_layers, 5, "cpu")
    return cj, model, params


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense),
                                      ("tiny-rwkv6", rwkv6)])
def test_reference_matches_port_in_f32(name, ref):
    cj, model, params = _port(name)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cj["vocab_size"], 70))
    with torch.no_grad():
        want = model.forward(params, {"tokens": toks[None]})[0]
        h = ref.hidden(params, cj, toks)
        got = torch.cat([lg for _, lg in logits(params, cj, h)])
    err = float((got - want).abs().max() / want.std())
    assert err < 1e-4, err


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense),
                                      ("tiny-rwkv6", rwkv6)])
def test_fp8_control_departs_from_f32(name, ref):
    """The control is far coarser than bf16: its logits differ from the
    f32 reference's by several times what bf16 weights alone do."""
    cj, model, params = _port(name)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cj["vocab_size"], 40))
    with torch.no_grad():
        h = ref.hidden(params, cj, toks)
        l32 = torch.cat([lg for _, lg in logits(params, cj, h)])
        h8 = ref.hidden(params, cj, toks, fp8_mm)
        l8 = torch.cat([lg for _, lg in logits(params, cj, h8, fp8_mm)])
        def bf16_mm(x, w):
            return f32_mm(x.bfloat16().float(), w.bfloat16().float())
        hb = ref.hidden(params, cj, toks, bf16_mm)
        lb = torch.cat([lg for _, lg in logits(params, cj, hb, bf16_mm)])
    d8 = float((l8 - l32).abs().max() / l32.std())
    db = float((lb - l32).abs().max() / l32.std())
    assert d8 > 4 * db, (d8, db)
