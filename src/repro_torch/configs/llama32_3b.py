"""llama3.2-3b: the paper's own benchmark model (Llama-3.2-3B [hf])."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama32-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-3B (paper section IV-D)",
)
