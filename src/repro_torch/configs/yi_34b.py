"""yi-34b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)
