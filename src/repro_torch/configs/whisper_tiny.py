"""whisper-tiny — encoder-decoder with conv audio frontend (STUB).
[arXiv:2212.04356]

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865. The mel/conv
frontend is a stub: ``input_specs`` supplies precomputed frame embeddings
(1500 encoder positions).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq_len=1500,
    frontend="audio_conv_stub",
    n_frontend_tokens=1500,
    tie_embeddings=True,
    max_seq_len=1 << 19,      # decoder ctx is exercised up to the assigned shapes
)
