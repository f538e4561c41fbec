"""rwkv6-3b (Finch): attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,             # d_model / rwkv.head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
    source="arXiv:2404.05892",
)
