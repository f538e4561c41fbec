"""internvl2-2b: InternViT(stub) + InternLM2 backbone [arXiv:2404.16821].

The assignment specifies the transformer BACKBONE only; the vision frontend
is a stub — input_specs() provides precomputed patch embeddings which a
learned projector maps into the LM embedding space.
"""
from .base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    vision=VisionStubConfig(frontend_dim=1024, num_patches=256,
                            images_per_seq=1),
    source="arXiv:2404.16821",
)
