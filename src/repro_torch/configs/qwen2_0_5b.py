"""qwen2-0.5b: dense GQA with QKV bias [arXiv:2407.10671]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    attn_qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)
