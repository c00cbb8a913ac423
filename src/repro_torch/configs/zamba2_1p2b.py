"""zamba2-1.2b — hybrid Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64.
The shared attention+MLP block is applied every 6 Mamba2 layers, reusing
the same weights each time (Zamba-style parameter sharing).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,            # shared block MLP width
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    shared_attn_every=6,
    attn_window=4096,     # shared-attn window: full at seq <= 4096; bounds
                          # the shared block's decode cache at long contexts
    tie_embeddings=True,
    max_seq_len=1 << 20,
)
