"""deepseek-moe-16b: 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                # per-expert width (fine-grained)
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_expert=1408, first_k_dense=1, dense_d_ff=10944),
    source="arXiv:2401.06066",
)
