"""Time flash attention's two K/V copy loops against each other on the card.

``load_kv`` (``kernels/csrc/flash_attention.cu``) copies a K/V tile with a
strided loop, the same column chunk of every few rows, where the block's
threads divide a row's 16-byte chunks (head dims 64, 128, 256), and walks
the tile's chunks in order where they do not (192). This builds the source
as it stands and a copy whose strided loop is switched off, so that every
head dim walks the chunks; prints each build's registers and spills for the
tile and split-KV kernels; and times both builds in turns (tree, walk,
walk, tree, twice) at shapes the serving and training paths launch: median
of 50 runs each, CUDA events, L2 flushed before each run. Each call is first
held to ``attention_plain`` at 2e-2.

  PYTHONPATH=src python -m repro_torch.tools.flash_copy_ab [--out PATH]

Needs one CUDA card and ``nvcc``. The last stdout line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from unittest import mock

STRIDED = "if constexpr (NT % T::kChunks == 0) {"

# label, (B, Sq, Skv, Hq, Hkv, head_dim), q positions start, causal, window, softcap
SHAPES = (
    ("smollm_train512", (8, 512, 512, 15, 5, 64), 0, True, 0, 0.0),
    ("zamba2_train512", (8, 512, 512, 32, 32, 64), 0, True, 4096, 0.0),
    ("whisper_encoder1500", (4, 1500, 1500, 6, 6, 64), 0, False, 0, 0.0),
    ("whisper_cross_decode1500", (4, 1, 1500, 6, 6, 64), 32, False, 0, 0.0),
    ("zamba2_decode64", (4, 1, 64, 32, 32, 64), 63, True, 4096, 0.0),
    ("llama4_train512", (8, 512, 512, 40, 8, 128), 0, True, 0, 0.0),
    ("nemotron_prefill32", (4, 32, 32, 48, 8, 128), 0, True, 0, 0.0),
    ("qwen_decode4096", (4, 1, 4096, 16, 2, 128), 4095, True, 0, 0.0),
    ("gemma2_train512", (8, 512, 512, 8, 4, 256), 0, True, 4096, 50.0),
    ("gemma2_decode4096", (4, 1, 4096, 8, 4, 256), 4095, True, 4096, 50.0),
)
ORDER = ("tree", "walk", "walk", "tree") * 2


def walk_source(FA, nvcc) -> str:
    """A copy of the kernel source with the strided copy loop switched off,
    beside a copy of the header it includes, under the git-ignored build
    directory; its path."""
    src = open(FA.SOURCE).read()
    if src.count(STRIDED) != 1:
        raise RuntimeError(f"the source holds {src.count(STRIDED)} strided copy loops, not 1")
    vdir = os.path.join(nvcc.BUILD_DIR, "flash_copy_ab")
    os.makedirs(vdir, exist_ok=True)
    shutil.copy(os.path.join(nvcc.CSRC, "mma_sm90.cuh"), vdir)
    path = os.path.join(vdir, "flash_attention_walk.cu")
    with open(path, "w") as f:
        f.write(src.replace(STRIDED, "if constexpr (false) {"))
    return path


def registers(log_path: str) -> dict:
    """{kernel<HD>: (registers, spill store bytes)} of the tile and split-KV
    kernels in an nvcc build log."""
    out, name, spill = {}, None, None
    for line in open(log_path).read().splitlines():
        m = re.search(r"Compiling entry function '.*?(tile|splitkv)_kernelILi(\d+)E", line)
        if "Compiling entry function" in line:
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "registers" in line:
            out[name] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the summary JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_copy_ab: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as FA, nvcc
    from repro_torch.models.attention import AttnSpec

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    paths = {"tree": nvcc.build(FA.SOURCE), "walk": nvcc.build(walk_source(FA, nvcc))}
    libs = {}
    for key, path in paths.items():
        FA._LIB = None
        with mock.patch.object(FA, "build", lambda path=path: path):
            libs[key] = FA._library()
    FA._LIB = None
    regs = {key: registers(path + ".log") for key, path in paths.items()}
    for key, r in regs.items():
        print(f"{key}: registers, spill store bytes {r}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, runs=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    rows, ok = {}, True
    for label, (B, Sq, Skv, Hq, Hkv, hd), q0, causal, window, cap in SHAPES:
        q, k, v = (torch.randn(B, S, H, hd, generator=gen, device=dev).to(torch.bfloat16)
                   for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
        q_pos = torch.arange(q0, q0 + Sq, dtype=torch.int32, device=dev)
        kv_pos = torch.arange(0, Skv, dtype=torch.int32, device=dev)
        spec = AttnSpec(causal=causal, window=window, logit_softcap=cap)
        ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec).float()
        turns = {"tree": [], "walk": []}
        for key in ORDER:
            FA._LIB = libs[key]
            out = FA.flash_attention(q, k, v, q_pos, kv_pos, spec).float()
            if not torch.allclose(out, ref, atol=2e-2, rtol=2e-2):
                print(f"{label} {key}: disagrees with attention_plain, max_abs_err "
                      f"{(out - ref).abs().max().item()}", flush=True)
                ok = False
            turns[key].append(time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)))
        med = {key: statistics.median(t) for key, t in turns.items()}
        rows[label] = {"design": FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype).variant,
                       "tree_ms": med["tree"], "walk_ms": med["walk"],
                       "walk_over_tree": med["walk"] / med["tree"], "turns_ms": turns}
        print(f"{label:26s} {rows[label]['design']:8s} tree {med['tree']:.6f} ms, walk "
              f"{med['walk']:.6f} ms ({med['walk'] / med['tree']:.3f}x); {card}", flush=True)
        del q, k, v, ref
    FA._LIB = None
    summary = {"ok": ok, "card": card, "registers": regs, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
