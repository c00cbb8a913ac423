"""deepseek-v3-671b — MoE with Multi-head Latent Attention + MTP.
[arXiv:2412.19437]

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; 1 shared + 256
routed experts, top-8; first 3 layers dense; multi-token prediction.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,       # MLA: latent cache, head count only shapes Q/K/V up-proj
    d_ff=18432,           # dense-layer FFN width (first 3 layers)
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared_experts=1,
                  d_ff_expert=2048, d_ff_shared=2048,
                  routed_scaling=2.5, first_dense_layers=3),
    mtp_depth=1,
    mtp_loss_weight=0.3,
    max_seq_len=131072,
)
