"""Config system: frozen dataclasses describing every supported architecture.

Every assigned architecture gets one module in this package exporting
``CONFIG``; the registry in ``__init__.py`` resolves ``--arch <id>``.
Configs are *declarative* — model code in ``repro.models`` interprets them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (DeepSeekMoE-style fine-grained)."""

    num_experts: int                 # routed experts
    top_k: int                      # experts activated per token
    num_shared_experts: int = 0     # always-on shared experts
    d_expert: int = 0               # per-expert hidden dim (fine-grained)
    # Layers [0, first_k_dense) use a dense FFN of width dense_d_ff instead.
    first_k_dense: int = 0
    dense_d_ff: int = 0
    router_aux_loss: float = 0.001  # load-balance auxiliary loss weight
    capacity_factor: float = 1.25   # train-time expert capacity
    # decode-time capacity: C = min(T*K, ceil(T*K/E * this)). Large enough
    # that drops are statistically negligible, 8x cheaper than dropless
    # C = T*K (which computes a worst-case all-tokens-to-one-expert buffer)
    decode_capacity_factor: float = 8.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 selective-state-space configuration."""

    state_dim: int = 64             # N: per-channel SSM state size
    head_dim: int = 64              # P: channels per SSM head
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4             # depthwise causal conv kernel
    chunk_size: int = 256           # SSD chunk length


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix configuration."""

    head_dim: int = 64
    decay_lora: int = 64            # low-rank dim for data-dependent decay w_t
    mix_lora: int = 32              # low-rank dim for token-shift mixers
    gate_lora: int = 64


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder split (seamless-m4t style)."""

    num_encoder_layers: int = 12
    num_decoder_layers: int = 12
    # encoder input is a precomputed frame-embedding stub (modality frontend
    # is out of scope per assignment).
    frontend_dim: int = 1024
    max_source_len: int = 4096


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: input_specs() provides precomputed patch embeddings."""

    frontend_dim: int = 1024        # InternViT feature dim (pre-projector)
    num_patches: int = 1024         # patches per image after pixel-shuffle
    images_per_seq: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + shared attention block."""

    # A single *shared* (weight-tied) attention block is invoked every
    # ``shared_attn_every`` layers, concatenating the residual stream with the
    # original embedding (Zamba2's "concatenated" input; we model the cheap
    # variant: plain residual input).
    shared_attn_every: int = 6
    # At 500k context the shared full-attention block gets a sliding window to
    # stay sub-quadratic (DESIGN.md §8).
    long_context_window: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field semantics follow the assignment table."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- attention options ---
    qk_norm: bool = False           # qwen3: RMSNorm on q,k per head
    attn_qkv_bias: bool = False     # qwen2: bias on qkv projections
    attn_out_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 -> full causal attention
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"               # silu (swiglu) | gelu (plain)
    # --- sub-configs (at most one of moe/ssm/rwkv/hybrid per family) ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionStubConfig] = None
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads={self.num_heads} not divisible by "
            f"num_kv_heads={self.num_kv_heads}")

    # ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ contexts without O(S^2) attention?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        """Does the arch autoregressively decode (i.e. support decode shapes)?"""
        return True  # every assigned arch is generative or enc-dec

    # ------------------------------------------------------------------
    # Parameter counting (exact, from the same formulas the init code uses).
    # Used for MODEL_FLOPS = 6 N D in the roofline analysis.
    # ------------------------------------------------------------------
    def _attn_params(self, d_model: int) -> int:
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        p = d_model * (h * hd) + 2 * d_model * (kv * hd) + (h * hd) * d_model
        if self.attn_qkv_bias:
            p += (h + 2 * kv) * hd
        if self.qk_norm:
            p += 2 * hd
        return p

    def _dense_ffn_params(self, d_model: int, d_ff: int) -> int:
        # SwiGLU: gate + up + down
        n_mats = 3 if self.act == "silu" else 2
        return n_mats * d_model * d_ff

    def _moe_ffn_params(self) -> Tuple[int, int]:
        """(total, active) FFN params for one MoE layer."""
        m = self.moe
        per_exp = self._dense_ffn_params(self.d_model, m.d_expert)
        router = self.d_model * m.num_experts
        total = m.num_experts * per_exp + m.num_shared_experts * per_exp + router
        active = (m.top_k + m.num_shared_experts) * per_exp + router
        return total, active

    def _mamba2_params(self) -> int:
        s = self.ssm
        d_in = s.expand * self.d_model
        n_heads = d_in // s.head_dim
        # in_proj -> [z, x, B, C, dt]; conv on (x,B,C); out_proj; norm; A,D,dt_bias
        conv_dim = d_in + 2 * s.state_dim * 1  # grouped: x plus B,C (1 group)
        p = self.d_model * (2 * d_in + 2 * s.state_dim + n_heads)
        p += conv_dim * s.conv_width
        p += d_in * self.d_model
        p += d_in                     # gated RMSNorm
        p += 2 * n_heads + n_heads    # A_log, D, dt_bias
        return p

    def _rwkv6_params(self) -> int:
        r, d = self.rwkv, self.d_model
        # time-mix: r,k,v,g,o projections + lora decays + token-shift mixers
        p = 5 * d * d
        p += 2 * (d * r.decay_lora + r.decay_lora * d)     # w lora (decay)
        p += 5 * (d * r.mix_lora + r.mix_lora * d)         # x lora mixers
        p += d // r.head_dim * r.head_dim                  # u ("bonus") per head
        p += 2 * d                                         # ln_x scale/bias
        # channel-mix: k,v,r
        p += d * self.d_ff + self.d_ff * d + d * d
        return p

    def param_count(self, active_only: bool = False) -> int:
        """Exact parameter count (matches models.init shapes)."""
        d = self.d_model
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        norms_per_layer = 2 * d
        total = emb + head + d  # final norm

        if self.family in ("dense", "vlm"):
            per_layer = (self._attn_params(d)
                         + self._dense_ffn_params(d, self.d_ff)
                         + norms_per_layer)
            total += self.num_layers * per_layer
            if self.family == "vlm":
                total += self.vision.frontend_dim * d + d  # projector
        elif self.family == "moe":
            m = self.moe
            moe_total, moe_active = self._moe_ffn_params()
            for li in range(self.num_layers):
                ffn = (self._dense_ffn_params(d, m.dense_d_ff)
                       if li < m.first_k_dense
                       else (moe_active if active_only else moe_total))
                total += self._attn_params(d) + ffn + norms_per_layer
        elif self.family == "ssm":
            per_layer = self._rwkv6_params() + norms_per_layer
            total += self.num_layers * per_layer
        elif self.family == "hybrid":
            per_layer = self._mamba2_params() + norms_per_layer
            total += self.num_layers * per_layer
            total += self._attn_params(d) + 2 * d  # one shared attention block
        elif self.family == "encdec":
            e = self.encdec
            enc_layer = (self._attn_params(d)
                         + self._dense_ffn_params(d, self.d_ff)
                         + norms_per_layer)
            dec_layer = (2 * self._attn_params(d)   # self + cross
                         + self._dense_ffn_params(d, self.d_ff)
                         + 3 * d)
            total += e.num_encoder_layers * enc_layer
            total += e.num_decoder_layers * dec_layer
            total += e.frontend_dim * d + d  # frontend projector stub
        else:
            raise ValueError(self.family)
        return int(total)

    # KV-cache bytes per token (the paper's central quantity).
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        if self.family == "ssm":
            return 0  # fixed-size state, not per-token
        layers = self.num_layers
        if self.family == "hybrid":
            # Only shared-attention-block invocations hold per-token KV; the
            # block is weight-tied but each invocation caches its own K/V.
            layers = self.num_layers // self.hybrid.shared_attn_every
        if self.family == "encdec":
            layers = self.encdec.num_decoder_layers
        return 2 * layers * self.num_kv_heads * self.head_dim * dtype_bytes

    def state_bytes(self, dtype_bytes: int = 2) -> int:
        """Fixed-size recurrent state per sequence (SSM/hybrid)."""
        if self.family == "ssm":
            n_heads = self.d_model // self.rwkv.head_dim
            per_layer = n_heads * self.rwkv.head_dim * self.rwkv.head_dim
            return self.num_layers * (per_layer + 2 * self.d_model) * dtype_bytes
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * self.d_model
            n_heads = d_in // s.head_dim
            per_layer = n_heads * s.head_dim * s.state_dim + d_in * s.conv_width
            return self.num_layers * per_layer * dtype_bytes
        return 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family & options, tiny dims.
# ----------------------------------------------------------------------
def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        # capacity_factor sized so smoke tests never drop tokens (keeps the
        # prefill+decode == forward consistency checks exact).
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=64,
            dense_d_ff=256 if cfg.moe.first_k_dense else 0,
            capacity_factor=float(8))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, chunk_size=32)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_dim=32, decay_lora=16, mix_lora=8, gate_lora=16)
    if cfg.hybrid is not None:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, shared_attn_every=2)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, num_encoder_layers=2, num_decoder_layers=2,
            frontend_dim=64, max_source_len=64)
        kw["num_layers"] = 2
    if cfg.vision is not None:
        kw["vision"] = dataclasses.replace(
            cfg.vision, frontend_dim=64, num_patches=16)
    return cfg.replace(**kw)
