"""Perf hillclimbing driver (``benchmarks/hillclimb.py``): one (arch × shape
× mesh) cell of the dry-run under a sequence of knob settings, each in a
subprocess of ``python -m repro_torch.launch.dryrun``, printing the
roofline terms and their change against the first variant, so every
hypothesis → change → measure cycle is recorded.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch smollm-360m \\
      --shape train_4k --variants baseline,ce_onehot,remat_dots

Each variant's row is appended to ``--log`` (by default under the
git-ignored ``benchmarks/dryrun_results_torch/``). The cells trace on
``--device`` (the card unless ``cpu``). ``fsdp_pod`` names no strategy of
the registry, so that variant prints FAIL, as it does in the reference.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from repro_torch.launch.common import DRYRUN_DIR, module_env

# named variants: cli flags for repro_torch.launch.dryrun
VARIANTS = {
    "baseline": [],
    "ce_onehot": ["--ce-impl", "onehot"],
    "remat_none": ["--remat", "none"],
    "remat_dots": ["--remat", "dots"],
    "attn_block_2k": ["--attn-block", "2048"],
    "attn_block_4k": ["--attn-block", "4096"],
    "attn_block_512": ["--attn-block", "512"],
    "adafactor": ["--optimizer", "adafactor"],
    "mb4": ["--microbatches", "4"],
    "mb8": ["--microbatches", "8"],
    "fsdp_pod": ["--strategy", "fsdp_pod"],
    "best": ["--ce-impl", "onehot", "--remat", "dots"],
}



def variant_cmd(arch: str, shape: str, mesh: str, extra_flags, out: str,
                device="cuda"):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
            "--shape", shape, "--mesh", mesh, "--device", str(device),
            "--out", out] + list(extra_flags)


def run_variant(arch: str, shape: str, mesh: str, extra_flags, timeout=3600,
                device="cuda"):
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        out = f.name
    env = module_env()
    t0 = time.time()
    try:
        proc = subprocess.run(variant_cmd(arch, shape, mesh, extra_flags, out, device),
                              capture_output=True, text=True, timeout=timeout, env=env)
        if proc.returncode != 0:
            return {"status": "FAIL", "error": proc.stderr[-1500:],
                    "wall_s": time.time() - t0}
        with open(out) as f:
            row = json.load(f)
    finally:
        os.unlink(out)
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def fmt(row):
    if row.get("status") != "OK":
        return f"FAIL: {row.get('error', '?')[:300]}"
    r = row["roofline"]
    return (f"compute {r['compute_s']:8.4f}s  memory {r['memory_s']:8.4f}s  "
            f"collective {r['collective_s']:8.4f}s  "
            f"-> t_step {r['t_step']:8.4f}s [{r['bottleneck']}] "
            f"useful {r['useful_fraction']:.2%}  "
            f"(compile {row['compile_s']}s)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--variants", default="baseline,ce_onehot")
    ap.add_argument("--log", default=os.path.join(DRYRUN_DIR, "hillclimb.jsonl"))
    ap.add_argument("--device", default="cuda",
                    help="the dry-run's device (the card unless cpu)")
    args = ap.parse_args(argv)

    results = {}
    base = None
    for name in args.variants.split(","):
        flags = VARIANTS[name] if name in VARIANTS else name.split()
        row = run_variant(args.arch, args.shape, args.mesh, flags, device=args.device)
        results[name] = row
        tag = f"{args.arch}/{args.shape}/{args.mesh}"
        print(f"[{tag}] {name:14s} {fmt(row)}", flush=True)
        if row.get("status") == "OK":
            t = row["roofline"]["t_step"]
            if base is None:
                base = t
            else:
                print(f"{'':{len(tag)+3}s}{name:14s} Δ vs baseline: "
                      f"{(base - t) / base:+.1%}", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        with open(args.log, "a") as f:
            f.write(json.dumps({"cell": [args.arch, args.shape, args.mesh],
                                "variant": name, "row": row}) + "\n")
    return results


if __name__ == "__main__":
    main()
