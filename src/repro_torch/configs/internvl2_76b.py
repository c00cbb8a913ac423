"""internvl2-76b — VLM: InternViT frontend (STUB) + Llama3-70B-class backbone.
[arXiv:2404.16821]

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision tower is a modality frontend stub: ``data.make_batch_for`` draws
precomputed patch embeddings (256 visual tokens), prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    frontend="vision_patch_stub",
    n_frontend_tokens=256,
    max_seq_len=131072,
)
