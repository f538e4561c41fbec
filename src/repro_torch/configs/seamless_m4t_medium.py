"""seamless-m4t-medium: enc-dec multimodal backbone [arXiv:2308.11596].

Backbone only — the speech frontend is a stub providing precomputed frame
embeddings (assignment: modality frontend is a STUB).
"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # per-stack depth (12 enc + 12 dec)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    act="gelu",               # conformer-lineage FFN (plain, not gated)
    encdec=EncDecConfig(num_encoder_layers=12, num_decoder_layers=12,
                        frontend_dim=1024, max_source_len=4096),
    source="arXiv:2308.11596",
)
