"""gemma2-2b — dense, alternating local/global attention, logit softcaps.
[arXiv:2408.00118]

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, window 4096,
attn softcap 50, final softcap 30, head_dim 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    local_global_pattern=True,
    attn_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    max_seq_len=8192 * 16,
)
