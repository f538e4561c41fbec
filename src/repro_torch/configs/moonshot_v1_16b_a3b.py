"""moonshot-v1-16b-a3b (Moonlight): 64-expert top-6 MoE
[hf:moonshotai/Moonlight-16B-A3B]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                # per-expert width (fine-grained)
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_expert=1408, first_k_dense=1, dense_d_ff=11264),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
