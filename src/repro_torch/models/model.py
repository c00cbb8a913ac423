"""Model construction for every segment kind of the reference: init, the
encoder, hidden forward, logits, the training loss (with the MoE aux loss,
DeepSeek's MTP head and the vision stub's patches), prefill and decode
(``repro.models.model``, the serving and single-device training subset).

Segment kinds: ``attn_mlp``, ``lg_pair`` (local/global pair), ``mla_mlp``
and ``mla_moe`` (MLA attention with a dense MLP or an MoE), ``attn_moe``
(GQA with an MoE), ``ssm`` (Mamba2), ``zamba_group`` (``inner`` Mamba2
blocks, then one attention/MLP block whose weights every group shares) and
``enc_attn``/``dec_attn`` (whisper).

Parameters are nested dicts of tensors. A segment is a list of per-layer
dicts (an ``lg_pair`` layer is ``{"local", "global"}``, two ``attn_mlp``
blocks), except a ``zamba_group`` segment, ``{"inner": [[ssm block] * inner]
* groups, "shared": attn_mlp block}``; where the reference runs ``lax.scan``
over stacked layers this runs a Python loop. Decode caches keep the
reference's stacked layout, per segment ``(k [n_layers, B, cap, Hkv, hd],
v, pos [n_layers, cap])`` for attention, a pair of those (local ring,
global) for ``lg_pair``, ``(latent [n, B, cap, rank], k_rope [n, B, cap,
rope], pos [n, cap])`` for MLA, ``(conv [n_layers, B, K-1, conv_dim], ssd
[n_layers, B, H, P, N] fp32)`` for Mamba2, and for ``zamba_group`` the
Mamba2 pair stacked ``[groups, inner, ...]`` beside one attention cache per
application of the shared block, ``[groups, B, cap, Hkv, hd]``; each layer
writes into its slice in place. An encoder-decoder (whisper) runs
``encoder_forward`` once per request and hands the decoder its per-layer
cross K/V (``stacked_cross_kv``).

The manual sharded train step (``train.step.make_sharded_train_step``)
reads each tensor's logical axes from ``param_axes``, asks ``tp_live_axes``
which of them the layers can keep local, and in its overlap body hands the
forward a tree of markers (``axes``): ``LocalDim`` dims run Megatron's split
(``layers.dense``/``mlp``, ``attention``, ``moe``), and ``StreamDim`` dims
of a segment's layer are gathered inside that layer's body
(``stream_in_params``, under the step's ``manual_mode``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (StreamDim, dense, embed, init_dense,
                                       init_embedding, init_mlp, init_rmsnorm,
                                       marks, mlp, rmsnorm, softcap, unembed)
from repro_torch.tree import tree_map

MASK_ID = -1                 # label value that is excluded from the loss
EMPTY_POS = 2 ** 30          # ring-cache "empty slot" position

Caches = List[Tuple]
CrossKV = Tuple[torch.Tensor, torch.Tensor]   # k, v [n_layers, B, T, Hkv, hd]


@dataclass(frozen=True)
class SegmentSpec:
    kind: str
    n: int                    # layers (zamba_group: groups) in the segment
    causal: bool = True
    window: int = 0           # sliding window (0 = global)
    inner: int = 0            # zamba_group: ssm layers per group


def build_segments(cfg: ModelConfig) -> List[SegmentSpec]:
    if cfg.family == "ssm":
        return [SegmentSpec("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every or cfg.n_layers
        groups, rem = divmod(cfg.n_layers, k)
        segs = []
        if groups:
            segs.append(SegmentSpec("zamba_group", groups, inner=k,
                                    window=cfg.attn_window))
        if rem:
            segs.append(SegmentSpec("ssm", rem))
        return segs
    if cfg.mla is not None:
        nd = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
        segs = []
        if nd:
            segs.append(SegmentSpec("mla_mlp", nd))
        if cfg.n_layers - nd:
            segs.append(SegmentSpec("mla_moe", cfg.n_layers - nd))
        return segs
    if cfg.moe is not None:
        return [SegmentSpec("attn_moe", cfg.n_layers)]
    if cfg.local_global_pattern:
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: lg_pair needs an even layer count")
        return [SegmentSpec("lg_pair", cfg.n_layers // 2, window=cfg.attn_window)]
    if cfg.is_encoder_decoder:
        return [SegmentSpec("dec_attn", cfg.n_layers)]
    return [SegmentSpec("attn_mlp", cfg.n_layers)]


def encoder_segment(cfg: ModelConfig) -> SegmentSpec:
    return SegmentSpec("enc_attn", cfg.n_encoder_layers, causal=False)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def tp_live_axes(cfg: ModelConfig, m: int) -> FrozenSet[str]:
    """Logical axes the manual tp step may keep *local* on a model axis of
    ``m`` ranks (the reference's gate, rule for rule): heads and kv_heads
    together for GQA (both cut by m), heads alone for MLA; "mlp" unless the
    stack has Mamba2 blocks (their packed projections mix channels);
    "expert" when E % m == 0; never vocab or embed; nothing for an
    encoder-decoder."""
    if m <= 1 or cfg.is_encoder_decoder:
        return frozenset()
    kinds = {s.kind for s in build_segments(cfg)}
    live = set()
    if not (kinds & {"ssm", "zamba_group"}):
        live.add("mlp")
    if cfg.mla is not None:
        if cfg.n_heads % m == 0:
            live.add("heads")
    elif cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        live.update(("heads", "kv_heads"))
    if cfg.moe is not None and cfg.moe.n_experts % m == 0:
        live.add("expert")
    return frozenset(live)


# ---------------------------------------------------------------------------
# Logical axes of the parameters
# ---------------------------------------------------------------------------

class ParamAxes(NamedTuple):
    """A tensor's logical axes as the reference names them, in the
    reference's layout without its layer-stacking dims; ``transposed`` for a
    dense weight, whose port layout ``[d_out, d_in]`` reverses them."""
    names: Tuple[Optional[str], ...]
    transposed: bool = False


# Dense layers by name: (d_in axis, d_out axis); a bias takes d_out's.
_DENSE_AXES = {
    "wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
    "wq_a": ("embed", None), "wq_b": (None, "heads"),
    "wkv_a": ("embed", None), "wk_b": (None, "heads"), "wv_b": (None, "heads"),
    "up": ("embed", "mlp"), "gate": ("embed", "mlp"), "down": ("mlp", "embed"),
    "in_proj": ("embed", "mlp"), "out_proj": ("mlp", "embed"),
    "lm_head": ("embed", "vocab"), "proj": ("embed", "embed"),
}
# Every other tensor, by its own key.
_ARRAY_AXES = {
    "table": ("vocab", "embed"), "scale": (None,),
    "router": ("embed", "expert"), "w_gate": ("expert", "embed", "mlp"),
    "w_up": ("expert", "embed", "mlp"), "w_down": ("expert", "mlp", "embed"),
    "conv_w": (None, "mlp"), "conv_b": ("mlp",), "A_log": ("mlp",),
    "D": ("mlp",), "dt_bias": ("mlp",), "norm_scale": ("mlp",),
}


def _leaf_axes(path) -> ParamAxes:
    if path[-1] == "weight":
        return ParamAxes(_DENSE_AXES[path[-2]], transposed=True)
    if path[-1] == "bias":
        return ParamAxes((_DENSE_AXES[path[-2]][1],))
    return ParamAxes(_ARRAY_AXES[path[-1]])


def param_axes(params):
    """A ``ParamAxes`` per tensor of a parameter tree (``init_model``'s)."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (i,)) for i, v in enumerate(t))
        return _leaf_axes(path)
    return walk(params, ())


# ---------------------------------------------------------------------------
# Streamed parameter gathers (the overlap train step)
# ---------------------------------------------------------------------------
# The overlap step leaves a segment layer's ZeRO-sharded dims sharded and
# marks them StreamDim; each layer's body then gathers its tensors inside
# the layer's compute (``dist.sharding.manual_stream_gather``, whose
# backward is the reduce-scatter), under the step's ``manual_mode``.

def _stream_in(p: torch.Tensor, ax):
    """Gather one tensor's StreamDim dims: (tensor, its axes with the
    StreamDim entries back to their logical names); as given if unmarked."""
    if ax is None or not any(isinstance(e, StreamDim) for e in ax):
        return p, ax
    from repro_torch.dist.sharding import manual_stream_gather
    entries = tuple(e.entry if isinstance(e, StreamDim) else None for e in ax)
    v = manual_stream_gather(entries, p)
    return v, tuple(e.logical if isinstance(e, StreamDim) else e for e in ax)


def stream_in_params(tree, axes):
    """``_stream_in`` over a layer's tensors: (tree, axes)."""
    if axes is None:
        return tree, None
    pairs = tree_map(lambda p, ax: _stream_in(p, ax), tree, axes)
    return (tree_map(lambda p, pair: pair[0], tree, pairs),
            tree_map(lambda p, pair: pair[1], tree, pairs))


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
    mla = kind in ("mla_mlp", "mla_moe")
    blk = {"ln1": init_rmsnorm(d, gen.device),
           "attn": A.init_mla(gen, cfg, dt) if mla else A.init_gqa(gen, cfg, dt),
           "ln2": init_rmsnorm(d, gen.device)}
    if kind == "dec_attn":
        blk["xattn"] = A.init_gqa(gen, cfg, dt)
        blk["ln3"] = init_rmsnorm(d, gen.device)
    if kind in ("mla_moe", "attn_moe"):
        blk["moe"] = M.init_moe(gen, cfg, dt)
    else:
        blk["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_activation, dt)
    return blk


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: SegmentSpec):
    """A segment's layers; a ``zamba_group`` segment's ``inner`` Mamba2
    blocks of each group and its ONE shared attention/MLP block."""
    if seg.kind == "zamba_group":
        return {"inner": [[init_block(gen, cfg, "ssm") for _ in range(seg.inner)]
                          for _ in range(seg.n)],
                "shared": init_block(gen, cfg, "attn_mlp")}
    return [init_block(gen, cfg, seg.kind) for _ in range(seg.n)]


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
        "segments": [init_segment(gen, cfg, s) for s in segs],
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
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": init_dense(gen, 2 * cfg.d_model, cfg.d_model, dtype_of(cfg)),
            "norm_h": init_rmsnorm(cfg.d_model, dev),
            "norm_e": init_rmsnorm(cfg.d_model, dev),
            "block": init_block(gen, cfg, _mtp_kind(cfg)),
        }
    return params


def param_shapes(cfg: ModelConfig):
    """``init_model``'s tree as shape-only fake tensors, no memory: the
    counterpart of ``jax.eval_shape`` over the reference's init."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_model(cfg, device="cpu")


def _mtp_kind(cfg: ModelConfig) -> str:
    return "mla_mlp" if cfg.mla else "attn_mlp"


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, causal=True, window=0) -> AttnSpec:
    return AttnSpec(causal=causal, window=window,
                    logit_softcap=cfg.attn_logit_softcap,
                    scale=cfg.attn_scale_override)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions,
                cache=None, cache_pos=None, window=0, causal=True,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                axes=None):
    """One block of ``kind``. Returns (x, new_cache, aux): aux is the MoE
    load-balance loss (0-d fp32) of an ``mla_moe`` or ``attn_moe`` block,
    None for the other kinds.

    An ``ssm`` block with a cache writes its new conv and SSD states into the
    cache tensors in place, as the attention blocks write their ring caches.
    An ``lg_pair`` is its local block (``window``) then its global block,
    each an ``attn_mlp`` with its own cache of the pair. A ``dec_attn``
    block's cross-attention reads ``enc_kv`` (k, v [B, T, Hkv, hd]); without
    it, it attends within x, non-causally, as the reference's does.
    ``axes`` is the block's marker tree (the overlap train step's)."""
    eps = cfg.norm_eps
    if kind == "ssm":
        h, new_cache = S.mamba2_forward(params["mamba"],
                                        rmsnorm(params["ln"], x, eps), cfg, cache)
        if cache is not None:
            for old, new in zip(cache, new_cache):
                old.copy_(new)
            new_cache = cache
        return x + h, new_cache, None
    if kind == "lg_pair":
        x, c0, _ = apply_block(params["local"], x, cfg, "attn_mlp",
                               positions=positions,
                               cache=None if cache is None else cache[0],
                               cache_pos=cache_pos, window=window,
                               axes=marks(axes, "local"))
        x, c1, _ = apply_block(params["global"], x, cfg, "attn_mlp",
                               positions=positions,
                               cache=None if cache is None else cache[1],
                               cache_pos=cache_pos, window=0,
                               axes=marks(axes, "global"))
        return x, (c0, c1), None
    spec = _attn_spec(cfg, causal=causal, window=window)
    attn = A.mla_forward if kind in ("mla_mlp", "mla_moe") else A.gqa_forward
    h, new_cache = attn(params["attn"], rmsnorm(params["ln1"], x, eps), cfg,
                        spec, positions, cache, cache_pos,
                        axes=marks(axes, "attn"))
    x = x + h
    mlp_norm = params["ln2"]
    if kind == "dec_attn":
        h, _ = A.gqa_forward(params["xattn"], rmsnorm(params["ln2"], x, eps),
                             cfg, AttnSpec(causal=False), positions,
                             kv_override=enc_kv)
        x = x + h
        mlp_norm = params["ln3"]
    if "moe" in params:
        out = M.moe_forward(params["moe"], rmsnorm(mlp_norm, x, eps), cfg,
                            axes=marks(axes, "moe"))
        return x + out.y, new_cache, out.aux_loss
    x = x + mlp(params["mlp"], rmsnorm(mlp_norm, x, eps), cfg.mlp_activation,
                axes=marks(axes, "mlp"))
    return x, new_cache, None


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


def _remat(run, h, remat: str):
    """``run(h)`` under the remat policy (``_remat_wrap``): "none" keeps its
    activations for the backward, "full" keeps only its input and recomputes
    it, "dots" keeps its dense products' outputs too and recomputes the rest
    (``torch.utils.checkpoint``, selectively)."""
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
        h, _, _ = apply_block(blk, h, cfg, seg.kind, positions=positions,
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


def _zamba_segment(sp, h, cfg: ModelConfig, seg: SegmentSpec, *, positions,
                   cache, cache_pos, keep_cache, remat, axes=None):
    """A ``zamba_group`` segment: per group, its ``inner`` Mamba2 blocks and
    then the shared attention/MLP block, which writes its own cache of the
    group. In training the whole group body is one remat unit (its Mamba2
    blocks run with remat "none" inside), as the reference wraps it.
    ``axes`` marks the shared block only (the step never streams a zamba
    group, and no Mamba2 dim is kept local). Returns (h, cache)."""
    shared = sp["shared"]

    def group(x, layers, ic=None, sc=None):
        ics = []
        for j, blk in enumerate(layers):
            x, c, _ = apply_block(blk, x, cfg, "ssm", positions=positions,
                                  cache=None if ic is None else _layer_of(ic, j))
            ics.append(c)
        x, c, _ = apply_block(shared, x, cfg, "attn_mlp", positions=positions,
                              cache=sc, cache_pos=cache_pos, window=seg.window,
                              axes=marks(axes, "shared"))
        return x, ics, c

    if cache is None and not keep_cache:
        for layers in sp["inner"]:
            h = _remat(lambda x, layers=layers: group(x, layers)[0], h, remat)
        return h, None
    inner, shared_caches = [], []
    for g, layers in enumerate(sp["inner"]):
        if cache is None:
            h, ics, sc = group(h, layers)
            inner.append(_stack_layers(ics))
            shared_caches.append(sc)
        else:
            h, _, _ = group(h, layers, _layer_of(cache[0], g), _layer_of(cache[1], g))
    if cache is not None:
        return h, cache
    return h, (_stack_layers(inner), _stack_layers(shared_caches))


def hidden_forward(params, cfg: ModelConfig, h, *, positions, caches=None,
                   cache_pos=None, enc_kv: Optional[CrossKV] = None,
                   keep_cache=False, remat="none", axes=None):
    """Run all segments. h: [B,S,D]. Returns (h, caches, aux): aux is the
    MoE load-balance loss summed over the blocks, None when no block has
    one.

    With ``caches`` the layers update them in place and the same list comes
    back; without, ``keep_cache`` stacks each segment's per-layer caches
    ((k, v, pos), a pair of those, MLA's (latent, k_rope, pos), Mamba2's
    (conv tail, final SSD state), a zamba group's (Mamba2 pair [groups,
    inner, ...], shared attention [groups, ...])) as the reference's scan
    does, and otherwise the caches are None. ``enc_kv``
    (``stacked_cross_kv``) feeds the ``dec_attn`` layers' cross-attention.
    ``remat`` applies to the training forward (no caches). ``axes`` is a
    sharded program's marker tree: in training each layer's StreamDim
    tensors are gathered inside its (remat) body; with caches (the sharded
    server) it carries ``LocalDim`` entries only."""
    train = caches is None and not keep_cache
    new_caches, auxs = [], []
    for i, seg in enumerate(build_segments(cfg)):
        sp = params["segments"][i]
        c_seg = None if caches is None else caches[i]
        if seg.kind == "zamba_group":
            h, nc = _zamba_segment(sp, h, cfg, seg, positions=positions,
                                   cache=c_seg, cache_pos=cache_pos,
                                   keep_cache=keep_cache, remat=remat,
                                   axes=marks(axes, "segments", i))
            new_caches.append(nc)
            continue
        layer_caches = []
        for j, blk in enumerate(sp):
            ekv = (None if enc_kv is None or seg.kind != "dec_attn"
                   else (enc_kv[0][j], enc_kv[1][j]))

            def run(x, blk=blk, ekv=ekv, seg=seg,     # bound: remat reruns it later
                    bax=marks(axes, "segments", i, j)):
                blk, bax = stream_in_params(blk, bax)
                x, _, a = apply_block(blk, x, cfg, seg.kind, positions=positions,
                                      window=seg.window, causal=seg.causal,
                                      enc_kv=ekv, axes=bax)
                return x, a

            if train:
                h, a = _remat(run, h, remat)
                auxs.append(a)
                continue
            c = None if c_seg is None else _layer_of(c_seg, j)
            h, nc, a = apply_block(blk, h, cfg, seg.kind, positions=positions,
                                   cache=c, cache_pos=cache_pos,
                                   window=seg.window, causal=seg.causal,
                                   enc_kv=ekv, axes=marks(axes, "segments", i, j))
            auxs.append(a)
            layer_caches.append(nc)
        if c_seg is not None:
            new_caches.append(c_seg)
        elif keep_cache:
            new_caches.append(_stack_layers(layer_caches))
        else:
            new_caches.append(None)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    auxs = [a for a in auxs if a is not None]
    return h, new_caches, torch.stack(auxs).sum() if auxs else None


def logits_f32(params, cfg: ModelConfig, h):
    """fp32 logits [..., vocab] before ``logits_fn``'s bf16 cast: the product
    in fp32, then the final softcap."""
    if cfg.tie_embeddings or "lm_head" not in params:
        logits = unembed(params["embed"], h)
    else:
        logits = unembed({"table": params["lm_head"]["weight"]}, h)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def logits_fn(params, cfg: ModelConfig, h):
    """bf16 logits [..., vocab], as the reference returns them: the product
    in fp32, then the final softcap, then the cast."""
    return logits_f32(params, cfg, h).to(torch.bfloat16)


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


def _with_patches(cfg: ModelConfig, h, batch):
    """The vision stub's precomputed patch embeddings prepended to the text."""
    if cfg.frontend != "vision_patch_stub":
        return h
    return torch.cat([batch["patches"].to(device=h.device, dtype=h.dtype), h], dim=1)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: str = "full", ce_impl: str = "gather", axes=None):
    """Training loss. batch: tokens [B,S]; patches [B,n,D] for the vision
    stub; frames [B,T,D] for an encoder-decoder; optional labels (default:
    next-token). Returns (loss, metrics).

    loss = ce + the summed MoE aux loss (+ ``mtp_loss_weight`` · mtp_ce with
    an MTP head: the main hidden states and the next tokens' embeddings,
    each normed, projected together, one block at ``positions[:-1]``, the
    main final norm and logits, labels shifted once more). The vision
    stub's patch positions carry MASK_ID labels.

    An encoder-decoder's loss is the reference's: its ``loss_fn`` computes
    the encoder and the cross K/V of ``frames`` but hands them to no layer
    (``hidden_forward`` gets no ``enc_kv``), so each decoder layer's
    cross-attention attends within the tokens, non-causally, and the
    encoder's gradient is zero. The port does not run that unused encoder:
    its result reaches neither the loss nor a gradient.

    ``axes`` is the overlap train step's marker tree (``hidden_forward``);
    the top-level tensors are never streamed."""
    tokens = batch["tokens"]
    if cfg.is_encoder_decoder and "frames" not in batch:
        raise KeyError(f"{cfg.name}: an encoder-decoder batch needs 'frames'")
    B = tokens.shape[0]
    h = _with_patches(cfg, embed_tokens(params, cfg, tokens), batch)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, _, aux = hidden_forward(params, cfg, h, positions=positions, remat=remat,
                               axes=axes)
    if "labels" in batch:
        labels = batch["labels"]
    else:
        labels = torch.cat([tokens[:, 1:],
                            torch.full((B, 1), MASK_ID, dtype=tokens.dtype,
                                       device=tokens.device)], dim=1)
    if cfg.frontend == "vision_patch_stub":
        labels = torch.cat([torch.full((B, batch["patches"].shape[1]), MASK_ID,
                                       dtype=labels.dtype, device=labels.device),
                            labels], dim=1)
    logits = logits_fn(params, cfg, h)
    ce_sum, n_tok = cross_entropy(logits, labels, impl=ce_impl)
    loss = ce_sum / torch.clamp(n_tok, min=1)
    if aux is None:
        aux = torch.zeros((), device=loss.device)
    metrics = {"ce": loss, "aux": aux, "tokens": n_tok}

    if cfg.mtp_depth and not cfg.is_encoder_decoder:
        mtp, eps = params["mtp"], cfg.norm_eps
        h_in = rmsnorm(mtp["norm_h"], h[:, :-1], eps)
        e_in = rmsnorm(mtp["norm_e"], embed_tokens(params, cfg, tokens[:, 1:]), eps)
        hm = dense(mtp["proj"], torch.cat([h_in, e_in], dim=-1))
        hm, _, _ = apply_block(mtp["block"], hm, cfg, _mtp_kind(cfg),
                               positions=positions[:-1],
                               axes=marks(axes, "mtp", "block"))
        hm = rmsnorm(params["final_norm"], hm, eps)
        mtp_sum, mtp_n = cross_entropy(logits_fn(params, cfg, hm), labels[:, 1:],
                                       impl=ce_impl)
        mtp_ce = mtp_sum / torch.clamp(mtp_n, min=1)
        loss = loss + cfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce

    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill / decode
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, *,
            enc_kv: Optional[CrossKV] = None):
    """Full forward keeping caches. Returns (last-position logits [B,V],
    caches). The vision stub prepends ``batch["patches"]``; an
    encoder-decoder takes its cross K/V as ``enc_kv`` (``encode``), or
    encodes ``batch["frames"]`` itself."""
    h = _with_patches(cfg, embed_tokens(params, cfg, batch["tokens"]), batch)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    if cfg.is_encoder_decoder and enc_kv is None:
        enc_kv = encode(params, cfg, batch["frames"])
    h, caches, _ = hidden_forward(params, cfg, h, positions=positions,
                                  enc_kv=enc_kv, keep_cache=True)
    return logits_fn(params, cfg, h[:, -1:])[:, 0], caches


def decode_hidden(params, cfg: ModelConfig, caches, token, pos: int, *,
                  enc_kv: Optional[CrossKV] = None, axes=None) -> torch.Tensor:
    """One decode step's final hidden state [B, D], the caches updated in
    place; ``axes`` the sharded server's ``LocalDim`` markers."""
    h = embed_tokens(params, cfg, token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    h, _, _ = hidden_forward(params, cfg, h, positions=positions, caches=caches,
                             cache_pos=pos, enc_kv=enc_kv, axes=axes)
    return h[:, 0]


def decode_step(params, cfg: ModelConfig, caches, token, pos: int, *,
                enc_kv: Optional[CrossKV] = None):
    """One decode step. token [B,1]; pos the absolute position (int);
    ``enc_kv`` an encoder-decoder's cross K/V. Returns (logits [B,V],
    caches), the caches updated in place."""
    h = decode_hidden(params, cfg, caches, token, pos, enc_kv=enc_kv)
    return logits_fn(params, cfg, h), caches


# ---------------------------------------------------------------------------
# Decode-cache construction
# ---------------------------------------------------------------------------
# Every cache leaf is made by ``mk(shape, dtype, role)``; the roles are the
# reference's: "kv" (k or v [..., B, cap, Hkv, hd]), "pos" ([..., cap]),
# "lat" and "rope" (MLA's latent and rope key [..., B, cap, r]), "conv"
# ([..., B, K-1, conv_dim]) and "ssd" ([..., B, H, P, N], fp32).
# ``launch.specs.cache_specs`` passes a constructor of spec tuples, and the
# sharded server one of its ranks' slices.

def zeros_leaf(shape, dtype, role, device="cpu") -> torch.Tensor:
    """A zeroed cache leaf; a "pos" leaf holds EMPTY_POS (every slot free)."""
    if role == "pos":
        return torch.full(shape, EMPTY_POS, dtype=torch.int32, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _attn_cache(cfg: ModelConfig, B: int, cap: int, n: int, dtype, mk) -> Tuple:
    shp = (n, B, cap, cfg.n_kv_heads, cfg.get_head_dim())
    return (mk(shp, dtype, "kv"), mk(shp, dtype, "kv"),
            mk((n, cap), torch.int32, "pos"))


def _mla_cache(cfg: ModelConfig, B: int, cap: int, n: int, dtype, mk) -> Tuple:
    m = cfg.mla
    return (mk((n, B, cap, m.kv_lora_rank), dtype, "lat"),
            mk((n, B, cap, m.qk_rope_head_dim), dtype, "rope"),
            mk((n, cap), torch.int32, "pos"))


def _ssm_cache(cfg: ModelConfig, B: int, lead: Tuple[int, ...], dtype, mk) -> Tuple:
    """(conv state in the cache dtype, SSD state in fp32), as the reference's,
    stacked on the ``lead`` axes."""
    s, _, nh, conv_dim = S._dims(cfg)
    return (mk(lead + (B, s.d_conv - 1, conv_dim), dtype, "conv"),
            mk(lead + (B, nh, s.head_dim, s.d_state), torch.float32, "ssd"))


def build_decode_caches(cfg: ModelConfig, B: int, seq_cap: int,
                        dtype=torch.bfloat16, mk=None, device="cuda") -> Caches:
    """The cache list ``hidden_forward`` takes, leaf by leaf from ``mk(shape,
    dtype, role)`` (zeroed tensors on ``device`` by default), in the
    reference's order and shapes (``repro.models.model.build_decode_caches``):
    per segment the Mamba2 pair, the ring cache (a window caps it), MLA's
    latent cache, an ``lg_pair``'s (local ring, global cache), a zamba
    group's (Mamba2 pair stacked ``[groups, inner, ...]``, shared block's
    attention cache)."""
    if mk is None:
        dev = resolve_device(device)
        mk = lambda shape, dt, role: zeros_leaf(shape, dt, role, dev)
    caches = []
    for seg in build_segments(cfg):
        cap = min(seq_cap, seg.window) if seg.window else seq_cap
        if seg.kind == "ssm":
            caches.append(_ssm_cache(cfg, B, (seg.n,), dtype, mk))
        elif seg.kind in ("attn_mlp", "dec_attn"):
            caches.append(_attn_cache(cfg, B, cap, seg.n, dtype, mk))
        elif seg.kind == "attn_moe":                  # no window, as the reference
            caches.append(_attn_cache(cfg, B, seq_cap, seg.n, dtype, mk))
        elif seg.kind in ("mla_mlp", "mla_moe"):
            caches.append(_mla_cache(cfg, B, seq_cap, seg.n, dtype, mk))
        elif seg.kind == "lg_pair":                   # (local ring, global cache)
            caches.append((_attn_cache(cfg, B, cap, seg.n, dtype, mk),
                           _attn_cache(cfg, B, seq_cap, seg.n, dtype, mk)))
        elif seg.kind == "zamba_group":    # (inner Mamba2 pair, shared attention)
            caches.append((_ssm_cache(cfg, B, (seg.n, seg.inner), dtype, mk),
                           _attn_cache(cfg, B, cap, seg.n, dtype, mk)))
        else:
            raise ValueError(seg.kind)
    return caches


def init_decode_caches(cfg: ModelConfig, B: int, seq_cap: int,
                       dtype=torch.bfloat16, device="cuda") -> Caches:
    """Zeroed caches matching hidden_forward's cache list."""
    return build_decode_caches(cfg, B, seq_cap, dtype, device=device)
