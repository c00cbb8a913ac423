"""Configuration dataclasses (copy of ``repro.configs.base``).

``ModelConfig``, ``ShapeConfig``, ``MeshConfig``, ``TrainConfig`` and
``reduced`` are kept field for field, so a config of the port and one of
the reference compare equal as dicts and ``param_count`` gives the same
number; the four input shapes of the dry-run's cells are the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds (per-layer layout of hybrid stacks)
ATTN = "attn"
ATTN_LOCAL = "attn_local"
SSM = "ssm"
SHARED_ATTN = "shared_attn"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    router_noise: float = 0.0
    aux_loss_weight: float = 0.001
    capacity_factor: float = 1.25
    routed_scaling: float = 1.0
    first_dense_layers: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3) configuration."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- positional / attention details -----------------------------------
    rope_theta: float = 10000.0
    max_seq_len: int = 32768
    attn_window: int = 0
    local_global_pattern: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    attn_scale_override: float = 0.0     # 0 -> 1/sqrt(head_dim)
    # --- MLP ----------------------------------------------------------------
    mlp_activation: str = "silu"
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    # --- optional sub-configs ----------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- hybrid stacks -------------------------------------------------------
    block_pattern: Tuple[str, ...] = ()
    shared_attn_every: int = 0
    # --- enc-dec (whisper) ---------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # --- modality frontend stubs ---------------------------------------------
    frontend: str = "none"
    n_frontend_tokens: int = 0
    # --- multi-token prediction (DeepSeek-V3) -------------------------------
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # --- performance knobs ---------------------------------------------------
    attn_block: int = 1024

    def get_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolve the per-layer block layout."""
        if self.block_pattern:
            assert len(self.block_pattern) == self.n_layers, (
                f"{self.name}: pattern len {len(self.block_pattern)} != "
                f"n_layers {self.n_layers}")
            return self.block_pattern
        if self.family == "ssm":
            return (SSM,) * self.n_layers
        if self.local_global_pattern:
            return tuple(
                ATTN_LOCAL if i % 2 == 0 else ATTN for i in range(self.n_layers))
        return (ATTN,) * self.n_layers

    def is_subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts (sub-quadratic)."""
        kinds = self.layer_kinds()
        return all(k in (SSM, SHARED_ATTN) for k in kinds) or (
            self.family in ("ssm", "hybrid"))

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embedding included."""
        d, h = self.d_model, self.get_head_dim()
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            return d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d

        def dense_mlp(ff: int) -> int:
            if self.mlp_activation in ("silu", "geglu"):
                return 3 * d * ff
            return 2 * d * ff

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
            p += conv_dim * s.d_conv
            p += n_h * 2
            p += d_in * d
            return p

        kinds = self.layer_kinds()
        for i, k in enumerate(kinds):
            if k in (ATTN, ATTN_LOCAL):
                total += attn_params()
            elif k == SSM:
                total += ssm_params()
            if k in (ATTN, ATTN_LOCAL, SSM):
                if (self.moe is not None
                        and i >= self.moe.first_dense_layers
                        and k != SSM):
                    e = self.moe
                    routed = e.n_experts * 3 * d * e.d_ff_expert
                    shared = e.n_shared_experts * 3 * d * (e.d_ff_shared or e.d_ff_expert)
                    router = d * e.n_experts
                    if active_only:
                        routed = e.top_k * 3 * d * e.d_ff_expert
                    total += routed + shared + router
                elif k == SSM and self.family == "ssm":
                    pass  # pure-SSM archs have no MLP
                else:
                    total += dense_mlp(self.d_ff)
        if self.shared_attn_every:
            total += attn_params() + dense_mlp(self.d_ff)
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry-run."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode
    microbatches: int = 1          # gradient-accumulation splits (train only)


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class MeshConfig:
    """Physical mesh description for the launcher."""
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    """Training-run hyperparameters (extrinsic parameters in paper terms)."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    optimizer: str = "adamw"        # adamw | sgd | adafactor
    remat_policy: str = "full"      # none | full | dots
    zero_stage: int = 3             # 0: replicated, 1: opt-state, 3: params too
    opt_state_dtype: str = "float32"
    grad_compression: str = "none"  # none | bf16 | int8_ef
    ce_impl: str = "gather"         # gather | onehot (sharded-vocab-safe CE)
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
            vocab: int = 512, d_ff: int = 128, n_experts: int = 4,
            seq_cap: int = 128) -> ModelConfig:
    """Shrink a full architecture config to a CPU-testable size, keeping
    the family structure."""
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    head_dim = max(8, d_model // n_heads)
    updates = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=n_kv, head_dim=head_dim,
        d_ff=d_ff if cfg.d_ff else 0, vocab_size=vocab,
        max_seq_len=seq_cap, block_pattern=(),
        attn_window=min(cfg.attn_window, seq_cap // 2) if cfg.attn_window else 0,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, n_experts=n_experts,
            top_k=min(cfg.moe.top_k, n_experts),
            d_ff_expert=d_ff // 2,
            d_ff_shared=d_ff // 2 if cfg.moe.n_shared_experts else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla is not None:
        updates["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.block_pattern:
        kinds = sorted(set(cfg.block_pattern), key=cfg.block_pattern.index)
        updates["block_pattern"] = tuple((kinds * n_layers)[:n_layers])
    if cfg.is_encoder_decoder:
        updates["n_encoder_layers"] = min(2, cfg.n_encoder_layers)
        updates["encoder_seq_len"] = 16
    if cfg.n_frontend_tokens:
        updates["n_frontend_tokens"] = 16
    if cfg.mtp_depth:
        updates["mtp_depth"] = 1
    return dataclasses.replace(cfg, **updates)
