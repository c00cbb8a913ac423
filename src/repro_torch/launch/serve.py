"""Serving entry point: prefill-by-decode + greedy decode with decode caches
(ring KV caches, or Mamba2's conv and SSD states), on a CUDA device unless
``--device cpu`` is given; sharded over a world of ranks with ``--strategy``
and ``--devices N``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --prompt-len 32 --gen 32 --strategy tp --devices 4

Weights are the port's own seeded random init, drawn on the device. An
encoder-decoder (whisper-tiny) encodes the batch's stub frames once, before
the decode loop, and decodes against their cross K/V; the vision stub's
patches are not fed to the decode loop, as in the reference's serve entry
point.

Sharded (``--strategy S --devices N``, N > 1): a ``dist.pool.Pool`` of
``plan_remesh(N)``'s (data, model) mesh of ranks (under ``cuda`` every rank
shares the card, over gloo) runs ``serve_rank`` on each rank: the rank draws
the seeded weights on its device and keeps what ``train.serve.serve_plan``
gives it (the ``LocalDim`` slices its layers compute on, every other tensor
whole: gathered once, at load), makes its decode caches
(``train.serve.local_caches``: its rows, and its kv heads where they are
local) and runs the decode loop on its rows under ``manual_mode``, where
the layers' Megatron collectives sum over the model axis (the module
docstring of ``train.serve`` sets out the design and where it departs
from the reference's placement). ``--strategy`` on one device prints the
reference's warning and serves on the single card; ``--devices`` defaults
to 1, where the reference forces a pool of 8 whenever a strategy is set.

The last stdout line is the report JSON, with the keys of
``repro.launch.serve`` (``strategy``, ``devices``, ``mesh`` among them)
plus ``device``, ``param_count`` (the config's, as the reference counts it),
``tree_params`` (the weights' own count: for a hybrid the reference's
``param_count`` adds a dense MLP to every SSM layer) and ``encode_s`` for an
encoder-decoder; a sharded run adds ``pool`` and ``ranks``, one entry per
rank: its rows, peak memory, the weights' and caches' bytes it holds beside
the reference's spec bytes, decode ms a step, and its kernel launches over
the decode loop, flash attention's by design. ``--trace-dir DIR`` records
the decode loop's spans (``prefill``, ``decode``, one ``decode_step`` a
generated token; each rank its own on a sharded run) and writes
``DIR/trace.jsonl`` (rank 0's, in the reference's schema, with the
metrics) and ``DIR/trace_chrome.json`` (every rank, each its own pid); the
report gains ``trace``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.dist.sharding import STRATEGIES


class Served(NamedTuple):
    report: Dict[str, Any]
    tokens: torch.Tensor      # [B, gen] greedy tokens
    logits: torch.Tensor      # [B, vocab] bf16 logits of the last decode step
    # fp32 logits before the bf16 cast that chose each token ([0]: the last
    # prompt position's); all ``gen`` of them only with ``keep_logits``
    step_logits: List[torch.Tensor]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="", choices=[""] + sorted(STRATEGIES),
                    help="serve sharded under this registry strategy "
                         "(empty = single-device)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the world (all on one card under cuda); "
                         "with --strategy and N > 1 the server is sharded")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--trace-dir", default="",
                    help="record prefill/decode spans and write trace.jsonl + "
                         "trace_chrome.json here; empty (default) keeps the "
                         "zero-overhead disabled recorder")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the serving plan as JSON and exit")
    return ap


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _config(args):
    from repro_torch.configs import get_config, reduced
    cfg = get_config(args.arch)
    return reduced(cfg) if args.reduced else cfg


def _request(cfg, args, device, rows=None):
    """(prompt [rows, S], frames or None) of the seeded request batch."""
    from repro_torch.data import make_batch_for
    batch = make_batch_for(cfg, args.batch, args.prompt_len, step=0, seed=args.seed)
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])
    frames = pick(batch["frames"]).to(device) if cfg.is_encoder_decoder else None
    return pick(batch["tokens"]).to(device), frames


def _encode(params, cfg, frames, device):
    """An encoder-decoder's cross K/V, once per request: (enc_kv, seconds)."""
    from repro_torch.models import model as MD
    if frames is None:
        return None, None
    sync(device)
    t0 = time.perf_counter()
    enc_kv = MD.encode(params, cfg, frames)
    sync(device)
    return enc_kv, time.perf_counter() - t0


def serve_rank(ctx, cfg, args, params=None, keep_logits: bool = False,
               cache_dtype=torch.bfloat16, forced=None):
    """Pool job: one rank of a sharded server. ``params`` (a numpy tree of
    the reference's weights, ``models.convert.params_from_jax``'s input) in
    place of the seeded init; ``cache_dtype`` the caches' (bf16, as the
    reference's server keeps them; Mamba2's SSD state is fp32 always);
    ``forced`` the whole batch's [B, gen] tokens to feed back in place of
    the argmax picks (``train.serve.decode_loop``).
    Returns numbers and numpy arrays of the rank's rows only: tokens, the
    step logits (fp32, before the bf16 cast; the first only unless
    ``keep_logits``), times, launches over the decode loop, peak memory and
    the placement's bytes."""
    from repro_torch.dist import probes
    from repro_torch.dist.sharding import batch_pspec, manual_mode, shard_of_full
    from repro_torch.models import model as MD
    from repro_torch.models.convert import params_from_jax
    from repro_torch.obs import Recorder
    from repro_torch.obs.export import recorded
    from repro_torch.train import serve as TS

    device, mesh = ctx.device, ctx.mesh
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    B, S = args.batch, args.prompt_len
    cap = S + args.gen
    dtype = cache_dtype
    plan = TS.serve_plan(cfg, mesh, args.strategy, B)
    rows = torch.arange(B)
    if plan.rows_split:
        rows = shard_of_full(rows, batch_pspec(mesh, 1, B), mesh)
    with torch.no_grad():
        whole = (MD.init_model(cfg, seed=args.seed, device=device) if params is None
                 else params_from_jax(params, cfg, device=device))
        local = TS.local_params(whole, plan, mesh)
        del whole
        if device.type == "cuda":
            torch.cuda.empty_cache()
        prompt, frames = _request(cfg, args, device, rows)
        caches = TS.local_caches(cfg, plan, mesh, B, cap, dtype, device)
        with manual_mode(mesh):
            enc_kv, t_encode = _encode(local, cfg, frames, device)
            probes.reset_launches()
            rec = Recorder(enabled=bool(getattr(args, "trace_dir", "")))
            out = TS.decode_loop(local, cfg, caches, prompt, args.gen, enc_kv=enc_kv,
                                 axes=plan.axes, keep_logits=keep_logits,
                                 forced=None if forced is None
                                 else forced[rows].to(device), rec=rec)
            launches = probes.launch_snapshot()
    steps = S + args.gen
    res = {"rank": ctx.rank, "device": device_name(device), "rows": rows.tolist(),
           "tokens": out.tokens.cpu().numpy(),
           "step_logits": [x.float().cpu().numpy() for x in out.step_logits],
           "last_logits": out.logits.float().cpu().numpy(),
           "prefill_s": out.prefill_s, "decode_s": out.decode_s,
           "encode_s": t_encode,
           "decode_ms_per_step": out.decode_s / max(args.gen, 1) * 1e3,
           "decode_steps": steps, "launches": launches,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
           "trace": recorded(rec),
           **TS.placement_bytes(cfg, plan, mesh, args.strategy, B, cap, dtype)}
    del local, caches, enc_kv, out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def assemble_rows(ranks, key, B):
    """Rows of every rank's ``key`` array put back in batch order (each row
    from the first rank that holds it)."""
    import numpy as np
    first = ranks[0][key]
    out = np.zeros((B,) + first.shape[1:], first.dtype)
    seen = set()
    for r in ranks:
        for j, row in enumerate(r["rows"]):
            if row not in seen:
                out[row] = r[key][j]
                seen.add(row)
    return out


def _sharded(args, cfg, device, mesh, pool, keep_logits, forced):
    """The sharded server over a pool: (report extras, tokens, last logits,
    step logits, rank 0's times)."""
    import contextlib

    from repro_torch.dist.pool import Pool
    from repro_torch.dist.sharding import mesh_size
    with (contextlib.nullcontext(pool) if pool is not None
          else Pool(world=mesh_size(mesh), device=device)) as pool:
        ranks = pool.run(serve_rank, cfg, args, None, keep_logits, torch.bfloat16,
                         forced, mesh=mesh)
        backend = pool.backend
    B = args.batch
    tokens = torch.from_numpy(assemble_rows(ranks, "tokens", B))
    logits = torch.from_numpy(assemble_rows(ranks, "last_logits", B)).to(torch.bfloat16)
    n_kept = len(ranks[0]["step_logits"])
    step_logits = [torch.from_numpy(assemble_rows(
        [{**r, "lf": r["step_logits"][i]} for r in ranks], "lf", B))
        for i in range(n_kept)]
    keys = ("rank", "device", "rows", "peak_mem_bytes", "resident_param_bytes",
            "spec_param_bytes", "resident_cache_bytes", "spec_cache_bytes",
            "decode_ms_per_step", "decode_steps", "launches")
    per_rank = [{k: r[k] for k in keys} for r in ranks]
    extra = {"pool": {"ranks": mesh_size(mesh), "backend": backend,
                      "cards": 1 if device.type == "cuda" else 0},
             "ranks": per_rank}
    traces = {r["rank"]: r["trace"] for r in ranks}
    return extra, tokens, logits, step_logits, ranks[0], traces


def _write_trace(args, cfg, n_dev, B, t_prefill, t_decode, rec0, traces):
    """The reference's serve metrics and the two trace files; the report's
    ``trace``."""
    import os

    from repro_torch.obs import Metrics, write_chrome_trace, write_jsonl
    from repro_torch.obs.export import write_chrome_trace_ranks
    metrics = Metrics()
    metrics.gauge("prefill_ms").set(t_prefill * 1e3)
    metrics.gauge("decode_tok_per_s").set(B * args.gen / max(t_decode, 1e-9))
    for s in rec0.find("decode_step"):
        metrics.histogram("decode_dispatch_ms").observe(s.duration_s * 1e3)
    os.makedirs(args.trace_dir, exist_ok=True)
    write_jsonl(os.path.join(args.trace_dir, "trace.jsonl"), rec0,
                metrics=metrics.to_dict(),
                meta={"arch": cfg.name, "mode": "serve",
                      "strategy": args.strategy or None, "devices": n_dev,
                      "ranks": 1 if traces is None else len(traces),
                      "chrome_pid": 1 if traces is None else "rank"})
    chrome = os.path.join(args.trace_dir, "trace_chrome.json")
    if traces is None:
        write_chrome_trace(chrome, rec0)
    else:
        write_chrome_trace_ranks(chrome, traces)
    return {"dir": args.trace_dir, "spans": len(rec0.spans)}


def main(argv=None, pool=None, keep_logits: bool = False,
         forced: Optional[torch.Tensor] = None):
    """Serve one request batch; returns ``Served`` (None with ``--dry-run``).
    ``pool``, when given, is the open ``Pool`` a sharded run uses (else it
    opens one of the mesh's ranks); ``keep_logits`` keeps every step's
    logits in ``Served.step_logits``; ``forced`` [batch, gen] (on the CPU)
    are tokens fed back in place of the argmax picks
    (``train.serve.decode_loop``)."""
    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.models import model as MD
    from repro_torch.obs import Recorder
    from repro_torch.train import serve as TS
    from repro_torch.tree import tree_size

    cfg = _config(args)
    device = resolve_device(args.device)
    n_dev = max(args.devices, 1)
    sharded = bool(args.strategy) and n_dev > 1
    if args.strategy and n_dev <= 1:
        print(f"WARNING: --strategy {args.strategy} requested but only "
              f"{n_dev} device is visible — the mesh cannot shard anything "
              f"and serving runs effectively single-device. Force a pool "
              f"with --devices N or run on a multi-device host.",
              file=sys.stderr, flush=True)
    mesh = plan_remesh(n_dev).axes() if sharded else {"data": 1, "model": 1}
    print(f"device={device} ({device_name(device)}) arch={cfg.name} "
          f"params={cfg.param_count()}")
    print(f"devices={n_dev} mesh={tuple(mesh.values())} "
          f"strategy={args.strategy or 'none (single-device)'}", flush=True)
    if args.dry_run:
        print(json.dumps({
            "dry_run": True, "arch": cfg.name, "device": str(device),
            "devices": n_dev, "mesh": list(mesh.values()),
            "strategy": args.strategy or None, "batch": args.batch,
            "prompt_len": args.prompt_len, "gen": args.gen}))
        return None

    extra, t_encode = {}, None
    rec = Recorder(enabled=bool(args.trace_dir))
    if sharded:
        extra, tokens, logits, step_logits, r0, traces = _sharded(
            args, cfg, device, mesh, pool, keep_logits, forced)
        rec0 = traces[0]
        t_prefill, t_decode, t_encode = r0["prefill_s"], r0["decode_s"], r0["encode_s"]
        n_tree = tree_size(MD.param_shapes(cfg))
        B, S = args.batch, args.prompt_len
    else:
        with torch.inference_mode():
            params = MD.init_model(cfg, seed=args.seed, device=device)
            n_tree = tree_size(params)
            prompt, frames = _request(cfg, args, device)
            B, S = prompt.shape
            caches = MD.init_decode_caches(cfg, B, S + args.gen, device=device)
            enc_kv, t_encode = _encode(params, cfg, frames, device)
            out = TS.decode_loop(params, cfg, caches, prompt, args.gen, enc_kv=enc_kv,
                                 keep_logits=keep_logits,
                                 forced=None if forced is None else forced.to(device),
                                 rec=rec)
        rec0, traces = rec, None
        tokens, logits, step_logits = out.tokens, out.logits, out.step_logits
        t_prefill, t_decode = out.prefill_s, out.decode_s

    report = {
        "arch": cfg.name, "batch": B, "prompt_len": S, "generated": args.gen,
        "strategy": args.strategy or None, "devices": n_dev,
        "mesh": list(mesh.values()),
        "prefill_s": round(t_prefill, 3), "decode_s": round(t_decode, 3),
        "decode_tok_per_s": round(B * args.gen / max(t_decode, 1e-9), 1),
        "sample_tokens": tokens[0, :8].tolist(),
        "device": device_name(device),
        "param_count": cfg.param_count(), "tree_params": n_tree, **extra,
    }
    if t_encode is not None:
        report["encode_s"] = round(t_encode, 3)
    if rec.enabled:
        report["trace"] = _write_trace(args, cfg, n_dev, B, t_prefill, t_decode, rec0,
                                       traces)
    print(json.dumps(report))
    return Served(report, tokens, logits, step_logits)


if __name__ == "__main__":
    main()
