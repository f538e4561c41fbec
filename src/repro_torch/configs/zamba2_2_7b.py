"""zamba2-2.7b: Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,          # the shared attention block is MHA
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    hybrid=HybridConfig(shared_attn_every=6, long_context_window=4096),
    source="arXiv:2411.15242",
)
