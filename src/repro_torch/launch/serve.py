"""Single-device serving entry point: prefill-by-decode + greedy decode with
decode caches (ring KV caches, or Mamba2's conv and SSD states), on a CUDA
device unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --batch 4 --prompt-len 32 --gen 32

Weights are the port's own seeded random init, drawn on the device. An
encoder-decoder (whisper-tiny) encodes the batch's stub frames once, before
the decode loop, and decodes against their cross K/V; the vision stub's
patches are not fed to the decode loop, as in the reference's serve entry
point. The last stdout line is the report JSON, with the keys of
``repro.launch.serve`` plus ``device``, ``param_count`` (the config's, as
the reference counts it), ``tree_params`` (the weights' own count: for a
hybrid the reference's ``param_count`` adds a dense MLP to every SSM layer)
and ``encode_s`` for an encoder-decoder.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, NamedTuple

import torch


class Served(NamedTuple):
    report: Dict[str, Any]
    tokens: torch.Tensor      # [B, gen] greedy tokens
    logits: torch.Tensor      # [B, vocab] logits of the last decode step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain "
                         "PyTorch versions of the kernels)")
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


@torch.inference_mode()
def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_size

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    print(f"device={device} ({device_name(device)}) arch={cfg.name} "
          f"params={cfg.param_count()}")
    if args.dry_run:
        print(json.dumps({
            "dry_run": True, "arch": cfg.name, "device": str(device),
            "batch": args.batch, "prompt_len": args.prompt_len,
            "gen": args.gen}))
        return None

    params = MD.init_model(cfg, seed=args.seed, device=device)
    n_tree = tree_size(params)
    batch = make_batch_for(cfg, args.batch, args.prompt_len, step=0,
                           seed=args.seed)
    prompt = batch["tokens"].to(device)
    B, S = prompt.shape
    caches = MD.init_decode_caches(cfg, B, S + args.gen, device=device)

    enc_kv, t_encode = None, None
    if cfg.is_encoder_decoder:                 # once per request
        sync(device)
        t0 = time.perf_counter()
        enc_kv = MD.encode(params, cfg, batch["frames"].to(device))
        sync(device)
        t_encode = time.perf_counter() - t0

    sync(device)
    t0 = time.perf_counter()
    logits = None
    for pos in range(S):                       # batched prefill-by-decode
        logits, caches = MD.decode_step(params, cfg, caches,
                                        prompt[:, pos:pos + 1], pos,
                                        enc_kv=enc_kv)
    sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(args.gen):
        out_tokens.append(tok)
        logits, caches = MD.decode_step(params, cfg, caches, tok, S + i,
                                        enc_kv=enc_kv)
        tok = torch.argmax(logits, dim=-1)[:, None]
    sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1)
    report = {
        "arch": cfg.name, "batch": B, "prompt_len": S, "generated": args.gen,
        "strategy": None, "devices": 1, "mesh": [1, 1],
        "prefill_s": round(t_prefill, 3), "decode_s": round(t_decode, 3),
        "decode_tok_per_s": round(B * args.gen / max(t_decode, 1e-9), 1),
        "sample_tokens": gen[0, :8].tolist(),
        "device": device_name(device),
        "param_count": cfg.param_count(), "tree_params": n_tree,
    }
    if t_encode is not None:
        report["encode_s"] = round(t_encode, 3)
    print(json.dumps(report))
    return Served(report, gen, logits)


if __name__ == "__main__":
    main()
