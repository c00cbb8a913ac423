"""Serving steps: batched prefill + greedy decode with decode caches (ring KV
caches for attention, conv and SSD states for Mamba2). An encoder-decoder's
encoder and cross K/V run once per request, before the decode loop.

Sharded serving (the reference's ``launch.serve --strategy``, jit with
shardings) is a manual program on a ``Mesh`` of ranks, the counterpart the
port gives GSPMD; the same design runs the GSPMD train step
(``train.step.make_gspmd_train_step``):

* placement: the reference's specs: parameters by ``params_only_shardings``,
  decode caches by role (``launch.specs._cache_pspec``), tokens by
  ``batch_pspec``: a rank computes on its rows of the batch (all rows when
  the batch axes do not divide the batch).
* compute: a layer works on a slice only where ``MD.tp_live_axes`` allows:
  model-sharded heads, kv heads, MLP hidden and experts become ``LocalDim``
  markers (``serve_plan``, the train step's ``_overlap_plans`` without
  streaming), and ``tp_f``/``tp_g`` close Megatron's split with a sum over
  the model axis. Every other sharded dim is gathered where it is used.
* reductions: what the single-device program reduces over a whole tensor
  is an explicit collective over the axes that split it (the train step's
  batch mean is one mean over every label: each rank's loss weighted by
  its share of the labels), so the numbers are the single-device
  program's up to reduction order.

Where the port departs from the reference's placement, and why:

* weights are read-only while serving, so every sharded dim that is not
  ``LocalDim`` is gathered once, when the server loads, and not again each
  step as the reference's program does (on ranks that talk through gloo's
  host copies a full-width gather costs 0.3-1 s a decode step). Every rank
  draws the same seeded weights whole, so that gather is the identity and
  is skipped: each rank keeps the ``LocalDim`` slices and the rest whole.
  The unembedding is such a once-gathered head: each rank computes the
  whole vocabulary's logits of its rows, and nothing is gathered a step.
* a cache keeps its ``_cache_pspec`` slice only on a dim its layer computes
  on a slice of: its batch rows, and its kv heads where wk's output is
  ``LocalDim``. Where the reference puts ``model`` on a dim the layer does
  not split, the rank holds that dim whole: a kv head_dim (qwen2.5-3b's 2
  kv heads over a model axis of 4), MLA's latent rank, a Mamba2 layer's
  conv channels and SSD heads, and every cache of an encoder-decoder (no
  axis is live there); a ring's capacity split over data (a batch the data
  axis does not divide) is held whole too. ``ServePlan`` reports the bytes
  a rank holds beside the reference's spec bytes.
* an MoE routes the batch as one: its capacity is a function of the tokens
  routed together, so a model with an MoE computes every row on every rank
  (the rows replicated, as an indivisible batch is), and keeps its experts
  local where the expert axis is live.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MD


def make_prefill(cfg: ModelConfig):
    def prefill(params, batch, enc_kv=None):
        return MD.prefill(params, cfg, batch, enc_kv=enc_kv)
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode(params, caches, token, pos, enc_kv=None):
        return MD.decode_step(params, cfg, caches, token, pos, enc_kv=enc_kv)
    return decode


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    n_steps: int, seq_cap: Optional[int] = None,
                    batch_extras: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Prefill-by-decode over ``prompt`` [B,S], then ``n_steps`` greedy tokens
    [B,n_steps], on ``prompt``'s device (``decode_loop``). Caches are bf16
    (Mamba2's SSD state fp32), as the reference's. An encoder-decoder takes
    its ``frames`` in ``batch_extras``."""
    B, S = prompt.shape
    caches = MD.init_decode_caches(cfg, B, seq_cap or (S + n_steps),
                                   device=prompt.device)
    enc_kv = None
    if cfg.is_encoder_decoder:
        enc_kv = MD.encode(params, cfg, batch_extras["frames"].to(prompt.device))
    return decode_loop(params, cfg, caches, prompt, n_steps, enc_kv=enc_kv).tokens


class Decoded(NamedTuple):
    tokens: torch.Tensor             # [B, gen] greedy tokens
    logits: torch.Tensor             # [B, vocab] bf16 logits of the last step
    step_logits: List[torch.Tensor]  # fp32 logits before the bf16 cast that
    #   chose each token ([0]: the last prompt position's); all but [0]
    #   only with ``keep_logits``
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_loop(params, cfg: ModelConfig, caches, prompt: torch.Tensor,
                n_gen: int, *, enc_kv=None, axes=None,
                keep_logits: bool = False,
                forced: Optional[torch.Tensor] = None, rec=None) -> Decoded:
    """Prefill-by-decode over ``prompt`` [B, S], then ``n_gen`` greedy
    tokens, each the argmax of the bf16 logits (``MD.logits_fn``), the
    caches updated in place. ``axes``: the sharded server's markers (call
    under its ``manual_mode``). ``forced`` [B, n_gen]: the tokens fed back
    in place of the argmax picks (teacher forcing, to hold every step's
    logits to another run's); the returned tokens stay the picks. Times on
    the host clock, the device synchronised at the ends of the prefill and
    of the generation. ``rec`` (an ``obs.Recorder``) records a ``prefill``
    span, a ``decode`` span and one ``decode_step`` span a generated token
    (the host's dispatch of the step: the loop adds no synchronise)."""
    from repro_torch.obs.trace import NULL_SPAN
    device = prompt.device
    S = prompt.shape[1]
    B = prompt.shape[0]
    span = (lambda *a, **k: NULL_SPAN) if rec is None else rec.span

    def step(tok, pos):
        h = MD.decode_hidden(params, cfg, caches, tok, pos, enc_kv=enc_kv, axes=axes)
        lf = MD.logits_f32(params, cfg, h)
        return lf, lf.to(torch.bfloat16)

    _sync(device)
    t0 = time.perf_counter()
    with span("prefill", category="serve", batch=B, tokens=S):
        for pos in range(S):
            lf, logits = step(prompt[:, pos:pos + 1], pos)
        _sync(device)              # the span times the loop's own synchronise
    prefill_s = time.perf_counter() - t0
    kept, out = [lf], []
    tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.perf_counter()
    with span("decode", category="serve", batch=B, tokens=n_gen):
        for i in range(n_gen):
            out.append(tok)
            with span("decode_step", category="serve", step_num=i):
                lf, logits = step(tok if forced is None else forced[:, i:i + 1], S + i)
                if keep_logits and i + 1 < n_gen:
                    kept.append(lf)
                tok = torch.argmax(logits, dim=-1)[:, None]
        _sync(device)
    return Decoded(torch.cat(out, dim=1), logits, kept, prefill_s,
                   time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The serving plan of a sharded server
# ---------------------------------------------------------------------------

class ServePlan(NamedTuple):
    axes: Any               # marker tree: LocalDim or the logical name, per dim
    local: Any              # spec tree: the LocalDim dims' "model" entries
    param_specs: Any        # the reference's params_only_shardings
    rows_split: bool        # the rank computes on its rows of the batch
    kv_local: bool          # attention caches keep their kv-head slice


def serve_plan(cfg: ModelConfig, mesh, strategy: str, B: int) -> ServePlan:
    """Which dims a rank keeps local (``LocalDim``: model-sharded where
    ``MD.tp_live_axes`` allows; everything else gathered once at load) and
    whether it computes on its rows of a batch of ``B``."""
    from repro_torch.launch.specs import params_only_shardings
    from repro_torch.models.layers import LocalDim
    from repro_torch.train.step import _overlap_plans, gspmd_rows_split, local_spec
    from repro_torch.tree import tree_map

    shapes = MD.param_shapes(cfg)
    specs = params_only_shardings(shapes, mesh, strategy)
    plans = _overlap_plans(cfg, None, mesh, specs, shapes, stream=False)
    axes = tree_map(lambda p, pl: pl.axes, shapes, plans)
    local = tree_map(lambda p, pl: local_spec(pl), shapes, plans)
    kv_local = any(isinstance(a, LocalDim) and a.logical == "kv_heads"
                   for pl in _leaves_of(shapes, plans) for a in pl.axes)
    return ServePlan(axes, local, specs, gspmd_rows_split(cfg, mesh, B), kv_local)


def _leaves_of(like, tree) -> list:
    """``tree``'s entries at ``like``'s tensors (a tree of tuples, which
    ``tree_leaves`` would open)."""
    from repro_torch.tree import tree_map
    out = []
    tree_map(lambda p, x: out.append(x), like, tree)
    return out


def local_params(params, plan: ServePlan, mesh):
    """This rank's resident weights from whole ones: each tensor's
    ``LocalDim`` slice (an owned copy), every other tensor as it is."""
    from repro_torch.dist.sharding import shard_of_full
    from repro_torch.tree import tree_map
    return tree_map(lambda p, s: shard_of_full(p, s, mesh).clone() if s else p,
                    params, plan.local)


def cache_local_spec(role: str, shape, plan: ServePlan, mesh) -> tuple:
    """The part of a cache leaf's ``_cache_pspec`` that its layer computes
    on: the batch entry when the rows are split, and ``model`` on a kv
    cache's heads when wk's output dim is ``LocalDim``."""
    from repro_torch.dist.sharding import _trim, spec_entries
    from repro_torch.launch.specs import _cache_pspec
    ref = spec_entries(_cache_pspec(role, shape, mesh), len(shape))
    keep = [None] * len(shape)
    batch_dim = {"kv": -4, "lat": -3, "rope": -3, "conv": -3, "ssd": -4}.get(role)
    if batch_dim is not None and plan.rows_split:
        keep[batch_dim] = ref[batch_dim]
    if role == "kv" and plan.kv_local:
        keep[-2] = ref[-2]
    return _trim(keep)


def _block_shape(shape, spec, mesh):
    from repro_torch.dist.sharding import _axes_of, axis_sizes, spec_entries
    sizes = axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, spec_entries(spec, len(shape))):
        div = 1
        for a in () if entry is None else _axes_of(entry):
            div *= sizes[a]
        out.append(n // div)
    return tuple(out)


def local_caches(cfg: ModelConfig, plan: ServePlan, mesh, B: int, cap: int,
                 dtype, device):
    """This rank's zeroed decode caches (``cache_local_spec``'s blocks)."""
    return MD.build_decode_caches(
        cfg, B, cap, dtype, mk=lambda shape, dt, role: MD.zeros_leaf(
            _block_shape(shape, cache_local_spec(role, shape, plan, mesh), mesh),
            dt, role, device))


def placement_bytes(cfg: ModelConfig, plan: ServePlan, mesh, strategy: str, B: int,
                    cap: int, dtype) -> Dict[str, int]:
    """Per-rank bytes of the weights and the caches: as this server holds
    them (``resident_*``) and as the reference's specs place them
    (``spec_*``; the weights by ``perf.planner.space.tree_shard_bytes``)."""
    from repro_torch.dist.sharding import axis_sizes
    from repro_torch.launch.specs import cache_specs
    from repro_torch.perf.planner.space import shard_divisor, tree_shard_bytes
    sizes = axis_sizes(mesh)
    shapes = MD.param_shapes(cfg)
    _, spec_params = tree_shard_bytes(shapes, mesh, strategy, pspecs=plan.param_specs)
    resident = sum(p.numel() * p.element_size() // shard_divisor(s, sizes)
                   for p, s in zip(_leaves_of(shapes, shapes),
                                   _leaves_of(shapes, plan.local)))
    structs, specs = cache_specs(cfg, B, cap, mesh, dtype)
    spec_caches = res_caches = 0
    roles = MD.build_decode_caches(cfg, B, cap, dtype, mk=lambda s, d, r: r)
    for t, s, role in zip(_leaves_of(structs, structs), _leaves_of(structs, specs),
                          _leaves_of(structs, roles)):
        n = t.numel() * t.element_size()
        spec_caches += n // shard_divisor(s, sizes)
        res_caches += n // shard_divisor(
            cache_local_spec(role, tuple(t.shape), plan, mesh), sizes)
    return {"resident_param_bytes": int(resident), "spec_param_bytes": int(spec_params),
            "resident_cache_bytes": int(res_caches), "spec_cache_bytes": int(spec_caches)}
