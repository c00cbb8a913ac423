"""Model construction for the ``attn_mlp`` and ``ssm`` segment kinds: init,
hidden forward, logits, the training loss, prefill and decode
(``repro.models.model``, the serving and single-device training subset).

Parameters are nested dicts of tensors. A segment is a list of per-layer
dicts, and where the reference runs ``lax.scan`` over stacked layers this
runs a Python loop. Decode caches keep the reference's stacked layout, per
segment ``(k [n_layers, B, cap, Hkv, hd], v, pos [n_layers, cap])`` for
attention and ``(conv [n_layers, B, K-1, conv_dim], ssd [n_layers, B, H, P,
N] fp32)`` for Mamba2; each layer writes into its slice in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (embed, init_dense, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       softcap, unembed)

MASK_ID = -1                 # label value that is excluded from the loss
EMPTY_POS = 2 ** 30          # ring-cache "empty slot" position

Caches = List[Tuple[torch.Tensor, ...]]
PORTED_KINDS = ("attn_mlp", "ssm")


@dataclass(frozen=True)
class SegmentSpec:
    kind: str
    n: int                    # layers in the segment
    causal: bool = True
    window: int = 0           # sliding window (0 = global)


def _segment_kind(cfg: ModelConfig) -> str:
    """The reference's segment kind for ``cfg`` (``build_segments``' order)."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "zamba_group"
    if cfg.mla is not None:
        return "mla_mlp"
    if cfg.moe is not None:
        return "attn_moe"
    if cfg.local_global_pattern:
        return "lg_pair"
    if cfg.is_encoder_decoder:
        return "dec_attn"
    return "attn_mlp"


def build_segments(cfg: ModelConfig) -> List[SegmentSpec]:
    kind = _segment_kind(cfg)
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"{cfg.name}: segment kind {kind!r} not ported yet")
    return [SegmentSpec(kind, cfg.n_layers)]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d, dt = cfg.d_model, dtype_of(cfg)
    if kind == "ssm":
        return {"ln": init_rmsnorm(d, gen.device),
                "mamba": S.init_mamba2(gen, cfg, dt)}
    return {"ln1": init_rmsnorm(d, gen.device),
            "attn": A.init_gqa(gen, cfg, dt),
            "ln2": init_rmsnorm(d, gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, dt)}


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> Dict[str, Any]:
    """Random weights at the reference's scales, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    segs = build_segments(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype_of(cfg)),
        "final_norm": init_rmsnorm(cfg.d_model, dev),
        "segments": [[init_block(gen, cfg, s.kind) for _ in range(s.n)]
                     for s in segs],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                       dtype_of(cfg))
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, causal=True, window=0) -> AttnSpec:
    return AttnSpec(causal=causal, window=window,
                    logit_softcap=cfg.attn_logit_softcap,
                    scale=cfg.attn_scale_override)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions,
                cache=None, cache_pos=None, window=0, causal=True):
    """One block of ``kind``. Returns (x, new_cache).

    An ``ssm`` block with a cache writes its new conv and SSD states into the
    cache tensors in place, as the attention block writes its ring cache."""
    eps = cfg.norm_eps
    if kind == "ssm":
        h, new_cache = S.mamba2_forward(params["mamba"],
                                        rmsnorm(params["ln"], x, eps), cfg, cache)
        if cache is not None:
            for old, new in zip(cache, new_cache):
                old.copy_(new)
            new_cache = cache
        return x + h, new_cache
    spec = _attn_spec(cfg, causal=causal, window=window)
    h, new_cache = A.gqa_forward(params["attn"], rmsnorm(params["ln1"], x, eps),
                                 cfg, spec, positions, cache, cache_pos)
    x = x + h
    x = x + mlp(params["mlp"], rmsnorm(params["ln2"], x, eps), cfg.mlp_activation)
    return x, new_cache


def embed_tokens(params, cfg: ModelConfig, tokens):
    h = embed(params["embed"], tokens)
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


def _remat_block(blk, h, cfg: ModelConfig, seg: SegmentSpec, positions,
                 remat: str):
    """One training block under the remat policy (``_remat_wrap``): "none"
    keeps its activations for the backward, "full" keeps only its input and
    recomputes it (``torch.utils.checkpoint``)."""
    def run(x):
        return apply_block(blk, x, cfg, seg.kind, positions=positions,
                           window=seg.window, causal=seg.causal)[0]

    if remat == "none":
        return run(h)
    if remat == "dots":
        raise NotImplementedError("remat 'dots' (save the matmul outputs, "
                                  "recompute the rest) not ported yet")
    return torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)


def hidden_forward(params, cfg: ModelConfig, h, *, positions, caches=None,
                   cache_pos=None, keep_cache=False, remat="none"):
    """Run all segments. h: [B,S,D]. Returns (h, caches).

    With ``caches`` the layers update them in place and the same list comes
    back; without, ``keep_cache`` stacks each segment's per-layer caches
    ((k, v, pos) or (conv tail, final SSD state)) as the reference's scan
    does, and otherwise the caches are None.
    ``remat`` applies to the training forward (no caches)."""
    train = caches is None and not keep_cache
    new_caches = []
    for i, seg in enumerate(build_segments(cfg)):
        layer_caches = []
        for j, blk in enumerate(params["segments"][i]):
            if train:
                h = _remat_block(blk, h, cfg, seg, positions, remat)
                continue
            c = None if caches is None else tuple(t[j] for t in caches[i])
            h, nc = apply_block(blk, h, cfg, seg.kind, positions=positions,
                                cache=c, cache_pos=cache_pos,
                                window=seg.window, causal=seg.causal)
            layer_caches.append(nc)
        if caches is not None:
            new_caches.append(caches[i])
        elif keep_cache:
            new_caches.append(tuple(torch.stack(t) for t in zip(*layer_caches)))
        else:
            new_caches.append(None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches


def logits_fn(params, cfg: ModelConfig, h):
    """bf16 logits [..., vocab], as the reference returns them."""
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = unembed(params["embed"], h)
    else:
        logits = unembed({"table": params["lm_head"]["weight"]}, h)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, impl: str = "gather"):
    """logits [..., V] (bf16 ok), labels int (MASK_ID = ignore).
    Returns (sum_ce_fp32, n_tokens).

    impl="gather" takes the label's log-prob by index; impl="onehot" by an
    iota == label mask and a sum over the vocab, which the reference uses for
    a vocab-sharded layout (the same numbers here)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    lab = torch.clamp(labels, min=0).long()
    if impl == "onehot":
        iota = torch.arange(lf.shape[-1], device=lf.device)
        ll = torch.where(iota == lab[..., None], lf,
                         torch.zeros((), device=lf.device)).sum(dim=-1)
    else:
        ll = torch.gather(lf, -1, lab[..., None])[..., 0]
    mask = labels != MASK_ID
    ce = (lse - ll) * mask
    return ce.sum(), mask.sum()


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: str = "full", ce_impl: str = "gather"):
    """Training loss. batch: tokens [B,S]; optional labels (default:
    next-token). Returns (loss, metrics)."""
    if (cfg.frontend != "none" or cfg.is_encoder_decoder or cfg.mtp_depth):
        raise NotImplementedError(f"{cfg.name}: frontend, encoder and MTP "
                                  "losses not ported yet")
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    h, _ = hidden_forward(params, cfg, h, positions=positions, remat=remat)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = torch.cat([tokens[:, 1:],
                            torch.full((B, 1), MASK_ID, dtype=tokens.dtype,
                                       device=tokens.device)], dim=1)
    logits = logits_fn(params, cfg, h)
    ce_sum, n_tok = cross_entropy(logits, labels, impl=ce_impl)
    loss = ce_sum / torch.clamp(n_tok, min=1)
    aux = torch.zeros((), device=loss.device)     # attn_mlp and ssm have none
    metrics = {"ce": loss, "aux": aux, "tokens": n_tok}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill / decode
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch):
    """Full forward keeping caches. Returns (last-position logits [B,V],
    caches)."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, caches = hidden_forward(params, cfg, h, positions=positions,
                               keep_cache=True)
    return logits_fn(params, cfg, h[:, -1:])[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, token, pos: int):
    """One decode step. token [B,1]; pos the absolute position (int).
    Returns (logits [B,V], caches), the caches updated in place."""
    h = embed_tokens(params, cfg, token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, new_caches = hidden_forward(params, cfg, h, positions=positions,
                                   caches=caches, cache_pos=pos)
    return logits_fn(params, cfg, h)[:, 0], new_caches


# ---------------------------------------------------------------------------
# Decode-cache construction
# ---------------------------------------------------------------------------

def _attn_cache(cfg: ModelConfig, B: int, cap: int, n: int, dtype,
                device) -> Tuple[torch.Tensor, ...]:
    shp = (n, B, cap, cfg.n_kv_heads, cfg.get_head_dim())
    return (torch.zeros(shp, dtype=dtype, device=device),
            torch.zeros(shp, dtype=dtype, device=device),
            torch.full((n, cap), EMPTY_POS, dtype=torch.int32, device=device))


def _ssm_cache(cfg: ModelConfig, B: int, n: int, dtype,
               device) -> Tuple[torch.Tensor, ...]:
    """(conv state in the cache dtype, SSD state in fp32), as the reference's."""
    s, _, nh, conv_dim = S._dims(cfg)
    return (torch.zeros((n, B, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
            torch.zeros((n, B, nh, s.head_dim, s.d_state), dtype=torch.float32,
                        device=device))


def init_decode_caches(cfg: ModelConfig, B: int, seq_cap: int,
                       dtype=torch.bfloat16, device="cuda") -> Caches:
    """Zeroed caches matching hidden_forward's cache list."""
    dev = resolve_device(device)
    caches = []
    for seg in build_segments(cfg):
        if seg.kind == "ssm":
            caches.append(_ssm_cache(cfg, B, seg.n, dtype, dev))
            continue
        cap = min(seq_cap, seg.window) if seg.window else seq_cap
        caches.append(_attn_cache(cfg, B, cap, seg.n, dtype, dev))
    return caches
