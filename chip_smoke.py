#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to their
plain PyTorch versions.

  python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: compile the flash attention kernel from ``src/repro_torch``;
3. kernel against its plain version on the card, bf16 and fp32, over the
   reference's kernel test cases and the serving path's own shapes;
4. full-width qwen2.5-3b served through ``repro_torch.launch.serve.main``
   (batch 4, prompt 32, 32 generated tokens), with the kernel's launches
   counted over that run;
5. decode-loop logits against a prefill forward of the same prompt, at
   full width: asserted in fp32, reported for the served bf16 model,
   whose decode steps are then profiled (device busy time, idle share,
   top kernels);
6. timings at the decode shape: kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it), each the median of 50 runs timed with CUDA events, L2 flushed
   before each run, beside the bound from bytes and operations.

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before that the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARCH = "qwen2.5-3b"
BATCH, PROMPT, GEN = 4, 32, 32
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12,      # dense tensor-core bf16
                  "float32": 67e12}        # fp32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# The reference's kernel test cases (tests/test_kernels.py FLASH_CASES):
# B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap
FLASH_CASES = [
    (1, 128, 128, 2, 2, 16, True, 0, 0.0),
    (2, 64, 192, 4, 2, 32, True, 0, 0.0),
    (1, 128, 128, 4, 1, 16, True, 32, 0.0),
    (1, 96, 96, 2, 2, 16, True, 0, 20.0),
    (2, 1, 256, 4, 2, 16, True, 0, 0.0),
    (1, 64, 64, 3, 1, 8, False, 0, 0.0),
    (1, 80, 144, 6, 3, 24, True, 48, 30.0),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def profile_decode(torch, MD, params, cfg, caches, tok, pos, card, steps=4):
    """Where a decode step's time goes: host time per step without the
    profiler, then a ``torch.profiler`` trace of the same steps, read from
    its Chrome-trace export (device busy time, idle share, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    def run(first):
        nonlocal caches
        for i in range(steps):
            _, caches = MD.decode_step(params, cfg, caches, tok, first + i)
        torch.cuda.synchronize()

    run(pos)                                       # warm
    t0 = time.perf_counter()
    run(pos + steps)
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(pos + 2 * steps)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    print(f"  decode step at full width, bf16, batch {BATCH}: host wall "
          f"{wall_ms:.3f} ms/step (no profiler); card {card}")
    if not kernels:
        print("  device time: not measured (the trace holds no kernel events)")
        return
    busy, end = 0.0, float("-inf")
    for e in kernels:                              # union of kernel intervals
        s, t = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    span = end - kernels[0]["ts"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    print(f"  profiled: {len(kernels) / steps:.0f} kernels/step, device busy "
          f"{busy / steps / 1e3:.3f} ms/step of a {span / steps / 1e3:.3f} ms/step "
          f"device span, idle share {1 - busy / span:.3f}")
    for name, (n, dur) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {dur / steps / 1e3:8.4f} ms/step {n // steps:5d}x/step  {name[:90]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)

    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.models import model as MD
    from repro_torch.models.attention import AttnSpec

    dev = torch.device("cuda", 0)

    # ---- 1. environment ---------------------------------------------------
    phase("environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"card (name, power limit): {card}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    lib = FA.build()
    print(f"built {os.path.relpath(lib, REPO)} in {time.perf_counter() - t0:.1f} s")
    with open(lib + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "build_s" in line:
                print("  " + line.strip())

    # ---- 3. kernel against plain -----------------------------------------
    phase("flash_attention kernel vs plain version")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def inputs(B, Sq, Skv, Hq, Hkv, hd, dtype):
        def r(*s):
            return torch.randn(s, generator=gen, device=dev).to(dtype)
        return r(B, Sq, Hq, hd), r(B, Skv, Hkv, hd), r(B, Skv, Hkv, hd)

    def arange(a, b):
        return torch.arange(a, b, dtype=torch.int32, device=dev)

    def tail_pos(Sq, Skv):
        return arange(Skv - Sq, Skv), arange(0, Skv)

    cases = []   # (label, shape, q_pos, kv_pos, spec)
    for c in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = c
        cases.append((f"ref{c[:6]}", c[:6], *tail_pos(Sq, Skv),
                      AttnSpec(causal=causal, window=window, logit_softcap=cap)))
    cases.append(("ring_cache", (1, 1, 64, 2, 2, 16), arange(95, 96),
                  torch.cat([arange(64, 96), arange(32, 64)]),
                  AttnSpec(causal=True, window=40)))
    full = get_config(ARCH)
    hq, hkv, hd = full.n_heads, full.n_kv_heads, full.get_head_dim()
    for cap in (PROMPT + GEN, 4096):
        cases.append((f"decode_cap{cap}", (BATCH, 1, cap, hq, hkv, hd),
                      *tail_pos(1, cap), AttnSpec()))
    part = arange(0, PROMPT + GEN)
    part[10:] = FA.PAD_POS              # ring cache with empty slots
    cases.append(("decode_partial", (BATCH, 1, PROMPT + GEN, hq, hkv, hd),
                  arange(9, 10), part, AttnSpec()))
    cases.append(("all_masked", (BATCH, 1, PROMPT + GEN, hq, hkv, hd),
                  arange(0, 1), arange(1, PROMPT + GEN + 1), AttnSpec()))
    cases.append((f"prefill{PROMPT}", (BATCH, PROMPT, PROMPT, hq, hkv, hd),
                  *tail_pos(PROMPT, PROMPT), AttnSpec()))

    path_err = None
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for label, shape, q_pos, kv_pos, spec in cases:
            q, k, v = inputs(*shape, dtype)
            out = FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
            ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=TOL[dname],
                                rtol=TOL[dname])
            print(f"  {dname:8s} {label:28s} max_abs_err={err:.3e} "
                  f"tol={TOL[dname]:g} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_attention disagrees with its plain version: "
                     f"{dname} {label} max_abs_err={err}")
            if dtype == torch.bfloat16 and label == f"decode_cap{PROMPT + GEN}":
                path_err = err

    # ---- 4. full-width serve ---------------------------------------------
    phase(f"serve {ARCH} at full width (batch {BATCH}, prompt {PROMPT}, gen {GEN})")
    torch.cuda.reset_peak_memory_stats()
    FA.LAUNCHES = 0
    served = serve.main(["--arch", ARCH, "--batch", str(BATCH),
                         "--prompt-len", str(PROMPT), "--gen", str(GEN),
                         "--device", "cuda"])
    launches = FA.LAUNCHES
    expected = (PROMPT + GEN) * full.n_layers
    rep = served.report
    print(f"  flash_attention launches {launches} (expected {expected}); "
          f"prefill_s {rep['prefill_s']} decode_s {rep['decode_s']} "
          f"decode_tok_per_s {rep['decode_tok_per_s']} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; card {card}", flush=True)
    if launches != expected:
        fail(f"serve launched the kernel {launches} times, expected {expected}")
    if not torch.isfinite(served.logits.float()).all():
        fail("serve produced non-finite logits")
    if served.tokens.shape != (BATCH, GEN) or not (
            (served.tokens >= 0) & (served.tokens < full.vocab_size)).all():
        fail(f"serve tokens out of range or shape {tuple(served.tokens.shape)}")
    del served

    # ---- 5. decode against prefill at full width --------------------------
    # fp32 weights, activations and caches hold the decode path (kernel at
    # Sq=1 over the ring cache) to the prefill path (kernel at Sq=32); the
    # logits are bf16 either way (logits_fn), so the bf16 tolerance applies.
    # The served bf16 model is run the same way and its difference printed:
    # 36 layers of bf16 rounding, in GEMV and GEMM orders, move the logits by
    # several bf16 ulps, so it is reported, not asserted.
    phase("decode loop vs prefill forward at full width")
    prompt = make_batch_for(full, BATCH, PROMPT)["tokens"].to(dev)
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(full, dtype=dname, param_dtype=dname)
        with torch.inference_mode():
            params = MD.init_model(cfg, seed=0, device=dev)
            caches = MD.init_decode_caches(cfg, BATCH, PROMPT + GEN,
                                           dtype=MD.dtype_of(cfg), device=dev)
            for pos in range(PROMPT):
                dec, caches = MD.decode_step(params, cfg, caches,
                                             prompt[:, pos:pos + 1], pos)
            before = FA.LAUNCHES
            pre, _ = MD.prefill(params, cfg, {"tokens": prompt})
            torch.cuda.synchronize()
        if FA.LAUNCHES - before != cfg.n_layers:
            fail("prefill did not run the kernel once per layer")
        err = (dec.float() - pre.float()).abs().max().item()
        ok = torch.allclose(dec.float(), pre.float(), atol=TOL["bfloat16"],
                            rtol=TOL["bfloat16"])
        agree = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
        verdict = ("ok" if ok else "FAIL") if dname == "float32" else "reported"
        print(f"  {dname:8s} last-position logits max_abs_err={err:.3e} "
              f"(max |logit| {pre.float().abs().max().item():.3f}) "
              f"tol={TOL['bfloat16']:g} argmax agreement {agree:.2f} {verdict}",
              flush=True)
        if dname == "float32" and not ok:
            fail(f"decode logits disagree with prefill: max_abs_err={err}")
        if dname == "bfloat16":
            with torch.inference_mode():
                profile_decode(torch, MD, params, cfg, caches,
                               dec.argmax(-1)[:, None], PROMPT, card)
        del params, caches

    # ---- 6. timings -------------------------------------------------------
    phase("timings (median of 50 runs, CUDA events, L2 flushed before each)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, runs=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)   # device busy while the host queues
            flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    rows = {}
    for label, (B, Sq, Skv) in (("decode_cap64", (BATCH, 1, PROMPT + GEN)),
                                ("decode_cap4096", (BATCH, 1, 4096)),
                                (f"prefill{PROMPT}", (BATCH, PROMPT, PROMPT))):
        q, k, v = inputs(B, Sq, Skv, hq, hkv, hd, torch.bfloat16)
        q_pos, kv_pos = tail_pos(Sq, Skv)
        spec = AttnSpec()
        mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True)

        ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
        lib_err = (sdpa().transpose(1, 2).float() - ref.float()).abs().max().item()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (q, k, v, ref, q_pos, kv_pos))
        n_ops = 4 * B * hq * Sq * Skv * hd
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
        row = {
            "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
            "library_ms": time_ms(sdpa),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        rows[label] = row
        print(f"  {label:16s} q [{B},{Sq},{hq},{hd}] kv [{B},{Skv},{hkv},{hd}] bf16: "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms (|sdpa-plain| {lib_err:.2e}), "
              f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
              f"({n_bytes} B, {n_ops} flop); card {card}", flush=True)

    path = rows["decode_cap64"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:122",
        "launches": launches, "max_abs_err": path_err,
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
