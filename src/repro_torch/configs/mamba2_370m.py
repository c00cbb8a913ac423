"""mamba2-370m — pure SSD (state-space duality) LM. [arXiv:2405.21060]

48L d_model=1024, attention-free, d_ff=0 (the Mamba2 blocks carry the MLP's
role), vocab 50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,           # SSD heads = expand*d_model/head_dim = 2048/64
    n_kv_heads=32,
    d_ff=0,               # attention-free, no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
    max_seq_len=1 << 20,
)
