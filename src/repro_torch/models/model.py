"""Model construction for the ``attn_mlp``, ``lg_pair``, ``ssm``,
``enc_attn`` and ``dec_attn`` segment kinds: init, the encoder, hidden
forward, logits, the training loss, prefill and decode
(``repro.models.model``, the serving and single-device training subset).

Parameters are nested dicts of tensors. A segment is a list of per-layer
dicts (an ``lg_pair`` layer is ``{"local", "global"}``, two ``attn_mlp``
blocks), and where the reference runs ``lax.scan`` over stacked layers this
runs a Python loop. Decode caches keep the reference's stacked layout, per
segment ``(k [n_layers, B, cap, Hkv, hd], v, pos [n_layers, cap])`` for
attention, a pair of those (local ring, global) for ``lg_pair``, and
``(conv [n_layers, B, K-1, conv_dim], ssd [n_layers, B, H, P, N] fp32)``
for Mamba2; each layer writes into its slice in place. An encoder-decoder
(whisper) runs ``encoder_forward`` once per request and hands the decoder
its per-layer cross K/V (``stacked_cross_kv``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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

Caches = List[Tuple]
CrossKV = Tuple[torch.Tensor, torch.Tensor]   # k, v [n_layers, B, T, Hkv, hd]
PORTED_KINDS = ("attn_mlp", "lg_pair", "ssm", "dec_attn")


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
    if kind == "lg_pair":
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: lg_pair needs an even layer count")
        return [SegmentSpec(kind, cfg.n_layers // 2, window=cfg.attn_window)]
    return [SegmentSpec(kind, cfg.n_layers)]


def encoder_segment(cfg: ModelConfig) -> SegmentSpec:
    return SegmentSpec("enc_attn", cfg.n_encoder_layers, causal=False)


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
    if kind == "lg_pair":
        return {"local": init_block(gen, cfg, "attn_mlp"),
                "global": init_block(gen, cfg, "attn_mlp")}
    blk = {"ln1": init_rmsnorm(d, gen.device),
           "attn": A.init_gqa(gen, cfg, dt),
           "ln2": init_rmsnorm(d, gen.device)}
    if kind == "dec_attn":
        blk["xattn"] = A.init_gqa(gen, cfg, dt)
        blk["ln3"] = init_rmsnorm(d, gen.device)
    blk["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_activation, dt)
    return blk


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
    if cfg.is_encoder_decoder:
        enc = encoder_segment(cfg)
        params["encoder"] = {
            "segments": [[init_block(gen, cfg, enc.kind) for _ in range(enc.n)]],
            "final_norm": init_rmsnorm(cfg.d_model, dev),
        }
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, causal=True, window=0) -> AttnSpec:
    return AttnSpec(causal=causal, window=window,
                    logit_softcap=cfg.attn_logit_softcap,
                    scale=cfg.attn_scale_override)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions,
                cache=None, cache_pos=None, window=0, causal=True,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One block of ``kind``. Returns (x, new_cache).

    An ``ssm`` block with a cache writes its new conv and SSD states into the
    cache tensors in place, as the attention block writes its ring cache.
    An ``lg_pair`` is its local block (``window``) then its global block,
    each an ``attn_mlp`` with its own cache of the pair. A ``dec_attn``
    block's cross-attention reads ``enc_kv`` (k, v [B, T, Hkv, hd]); without
    it, it attends within x, non-causally, as the reference's does."""
    eps = cfg.norm_eps
    if kind == "ssm":
        h, new_cache = S.mamba2_forward(params["mamba"],
                                        rmsnorm(params["ln"], x, eps), cfg, cache)
        if cache is not None:
            for old, new in zip(cache, new_cache):
                old.copy_(new)
            new_cache = cache
        return x + h, new_cache
    if kind == "lg_pair":
        x, c0 = apply_block(params["local"], x, cfg, "attn_mlp",
                            positions=positions,
                            cache=None if cache is None else cache[0],
                            cache_pos=cache_pos, window=window)
        x, c1 = apply_block(params["global"], x, cfg, "attn_mlp",
                            positions=positions,
                            cache=None if cache is None else cache[1],
                            cache_pos=cache_pos, window=0)
        return x, (c0, c1)
    spec = _attn_spec(cfg, causal=causal, window=window)
    h, new_cache = A.gqa_forward(params["attn"], rmsnorm(params["ln1"], x, eps),
                                 cfg, spec, positions, cache, cache_pos)
    x = x + h
    mlp_norm = params["ln2"]
    if kind == "dec_attn":
        h, _ = A.gqa_forward(params["xattn"], rmsnorm(params["ln2"], x, eps),
                             cfg, AttnSpec(causal=False), positions,
                             kv_override=enc_kv)
        x = x + h
        mlp_norm = params["ln3"]
    x = x + mlp(params["mlp"], rmsnorm(mlp_norm, x, eps), cfg.mlp_activation)
    return x, new_cache


def embed_tokens(params, cfg: ModelConfig, tokens):
    h = embed(params["embed"], tokens)
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


# The outputs remat "dots" saves: the dense products, which have no batch
# dims (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``). The
# attention's batched products and the flash kernel are recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(blk, h, cfg: ModelConfig, seg: SegmentSpec, positions,
                 remat: str, enc_kv=None):
    """One training block under the remat policy (``_remat_wrap``): "none"
    keeps its activations for the backward, "full" keeps only its input and
    recomputes it, "dots" keeps its dense products' outputs too and
    recomputes the rest (``torch.utils.checkpoint``, selectively)."""
    def run(x):
        return apply_block(blk, x, cfg, seg.kind, positions=positions,
                           window=seg.window, causal=seg.causal,
                           enc_kv=enc_kv)[0]

    if remat == "none":
        return run(h)
    if remat == "dots":
        return checkpoint(run, h, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_dots))
    if remat == "full":
        return checkpoint(run, h, use_reentrant=False)
    raise ValueError(f"unknown remat policy {remat!r}")


def _layer_of(tree, j: int):
    """Layer ``j`` of a stacked cache (nested tuples of [n_layers, ...])."""
    if isinstance(tree, tuple):
        return tuple(_layer_of(t, j) for t in tree)
    return tree[j]


def _stack_layers(trees):
    """Per-layer caches (nested tuples) stacked on a leading layer axis."""
    if isinstance(trees[0], tuple):
        return tuple(_stack_layers(ts) for ts in zip(*trees))
    return torch.stack(trees)


def encoder_forward(params, cfg: ModelConfig, frames):
    """Whisper's encoder over precomputed (stub) frame embeddings [B, T, D]:
    non-causal ``enc_attn`` blocks at positions ``arange(T)``, then its
    final norm."""
    h = frames.to(dtype_of(cfg))
    positions = torch.arange(frames.shape[1], dtype=torch.int32, device=h.device)
    seg = encoder_segment(cfg)
    for blk in params["encoder"]["segments"][0]:
        h, _ = apply_block(blk, h, cfg, seg.kind, positions=positions,
                           causal=seg.causal)
    return rmsnorm(params["encoder"]["final_norm"], h, cfg.norm_eps)


def stacked_cross_kv(params, cfg: ModelConfig, enc_out) -> CrossKV:
    """Each decoder layer's cross K/V of the encoder output, stacked on a
    leading layer axis: (k, v) [n_layers, B, T, Hkv, hd]. The projections
    take no bias, as the reference's ``_stacked_cross_kv``."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.n_kv_heads, cfg.get_head_dim())
    ks, vs = [], []
    for blk in params["segments"][0]:
        ks.append(F.linear(enc_out, blk["xattn"]["wk"]["weight"]).view(shape))
        vs.append(F.linear(enc_out, blk["xattn"]["wv"]["weight"]).view(shape))
    return torch.stack(ks), torch.stack(vs)


def encode(params, cfg: ModelConfig, frames) -> CrossKV:
    """The encoder and its cross K/V: the once-per-request part of serving
    an encoder-decoder."""
    return stacked_cross_kv(params, cfg, encoder_forward(params, cfg, frames))


def hidden_forward(params, cfg: ModelConfig, h, *, positions, caches=None,
                   cache_pos=None, enc_kv: Optional[CrossKV] = None,
                   keep_cache=False, remat="none"):
    """Run all segments. h: [B,S,D]. Returns (h, caches).

    With ``caches`` the layers update them in place and the same list comes
    back; without, ``keep_cache`` stacks each segment's per-layer caches
    ((k, v, pos), a pair of those, or (conv tail, final SSD state)) as the
    reference's scan does, and otherwise the caches are None. ``enc_kv``
    (``stacked_cross_kv``) feeds the ``dec_attn`` layers' cross-attention.
    ``remat`` applies to the training forward (no caches)."""
    train = caches is None and not keep_cache
    new_caches = []
    for i, seg in enumerate(build_segments(cfg)):
        layer_caches = []
        for j, blk in enumerate(params["segments"][i]):
            ekv = (None if enc_kv is None or seg.kind != "dec_attn"
                   else (enc_kv[0][j], enc_kv[1][j]))
            if train:
                h = _remat_block(blk, h, cfg, seg, positions, remat, ekv)
                continue
            c = None if caches is None else _layer_of(caches[i], j)
            h, nc = apply_block(blk, h, cfg, seg.kind, positions=positions,
                                cache=c, cache_pos=cache_pos,
                                window=seg.window, causal=seg.causal,
                                enc_kv=ekv)
            layer_caches.append(nc)
        if caches is not None:
            new_caches.append(caches[i])
        elif keep_cache:
            new_caches.append(_stack_layers(layer_caches))
        else:
            new_caches.append(None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, new_caches


def logits_fn(params, cfg: ModelConfig, h):
    """bf16 logits [..., vocab], as the reference returns them: the product
    in fp32, then the final softcap, then the cast."""
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
    """Training loss. batch: tokens [B,S]; frames [B,T,D] for an
    encoder-decoder; optional labels (default: next-token). Returns (loss,
    metrics).

    An encoder-decoder's loss is the reference's: its ``loss_fn`` computes
    the encoder and the cross K/V of ``frames`` but hands them to no layer
    (``hidden_forward`` gets no ``enc_kv``), so each decoder layer's
    cross-attention attends within the tokens, non-causally, and the
    encoder's gradient is zero. The port does not run that unused encoder:
    its result reaches neither the loss nor a gradient."""
    if cfg.frontend == "vision_patch_stub" or cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}: vision-frontend and MTP "
                                  "losses not ported yet")
    tokens = batch["tokens"]
    if cfg.is_encoder_decoder and "frames" not in batch:
        raise KeyError(f"{cfg.name}: an encoder-decoder batch needs 'frames'")
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
    aux = torch.zeros((), device=loss.device)     # no ported kind has one
    metrics = {"ce": loss, "aux": aux, "tokens": n_tok}
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill / decode
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, *,
            enc_kv: Optional[CrossKV] = None):
    """Full forward keeping caches. Returns (last-position logits [B,V],
    caches). An encoder-decoder takes its cross K/V as ``enc_kv``
    (``encode``), or encodes ``batch["frames"]`` itself."""
    tokens = batch["tokens"]
    h = embed_tokens(params, cfg, tokens)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    if cfg.is_encoder_decoder and enc_kv is None:
        enc_kv = encode(params, cfg, batch["frames"])
    h, caches = hidden_forward(params, cfg, h, positions=positions,
                               enc_kv=enc_kv, keep_cache=True)
    return logits_fn(params, cfg, h[:, -1:])[:, 0], caches


def decode_step(params, cfg: ModelConfig, caches, token, pos: int, *,
                enc_kv: Optional[CrossKV] = None):
    """One decode step. token [B,1]; pos the absolute position (int);
    ``enc_kv`` an encoder-decoder's cross K/V. Returns (logits [B,V],
    caches), the caches updated in place."""
    h = embed_tokens(params, cfg, token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, new_caches = hidden_forward(params, cfg, h, positions=positions,
                                   caches=caches, cache_pos=pos,
                                   enc_kv=enc_kv)
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
        if seg.kind == "lg_pair":           # (local ring, global cache)
            local = min(seq_cap, seg.window or seq_cap)
            caches.append((_attn_cache(cfg, B, local, seg.n, dtype, dev),
                           _attn_cache(cfg, B, seq_cap, seg.n, dtype, dev)))
            continue
        cap = min(seq_cap, seg.window) if seg.window else seq_cap
        caches.append(_attn_cache(cfg, B, cap, seg.n, dtype, dev))
    return caches
