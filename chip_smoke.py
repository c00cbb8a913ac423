#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and hold its kernels to their
plain PyTorch versions.

  python3 chip_smoke.py

Phases, by number. They run in the order 1-13, 22 (a), 16-19, 26, 25 (a),
then on one pool of 8 ranks 15, 22 (b), 23 (b), 20, 21, 22 (c), 23 (a), 23
(c), 24 (c), 24 (d), 27 (d), then 25 (b) and (c) and 27 (a) and (c); phase
24 (a) and (b) ride on phases 8 and 6. The pool starts in the background
before phase 16, beside the single-device phases 16-19, 26 and 25 (a), and
phase 14 (then 27 b) runs in a process of its own (``--paper-pipeline``) beside
phases 22 (b) to 23; its output is printed after phase 23. Phase 25's
traces run in a process of their own (``--dryrun-cells DIR``), started
after phase 13 (whose SSD backward timing leaves too little of the card for
a cell's CUDA context), beside phases 22 (a) to 24, and its fits (25 c, 27
a and c) after them there; the main process gates what it wrote. Any failure ends the run with a non-zero exit code, and a run
still going after ``WATCHDOG_S`` seconds prints every thread's stack and
exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and cuDNN;
2. build: compile every kernel source of ``src/repro_torch`` (one ``nvcc``
   per source, all started together) and print registers and spills; each
   flash tile and split-KV instantiation (head dims 64, 128, 192, 256) must
   build without a spill;
3. flash attention against its plain version on the card, bf16 and fp32,
   over the reference's kernel test cases, the serving path's shapes, the
   training path's shape and cases aimed at each design (the tile kernel's
   ragged tiles, windows, ring positions and wholly masked first rows; the
   split-KV kernel's half-empty ring, ragged and empty last splits and a
   wholly masked row over 4096 slots), gemma2-2b's shapes (head_dim 256 on
   the tile and split-KV designs: its training shape, decode and the served
   prefill with window 4096 and softcap 50, a prefill where the window
   bites, a 4096-slot ring
   holding positions past the window), cases aimed at those designs at
   head_dims 256 and 192 (ragged tiles under a window and softcap, rings
   with PAD slots, wholly masked first rows, split-KV at 192 with and
   without a combine), whisper-tiny's (its 1500-frame non-causal
   encoder, the cross-attention over it at prefill and decode),
   zamba2-1.2b's shared block (training and prefill: tile; decode:
   split-KV), llama4-scout's training and prefill (tile, G 5) and decode
   (split-KV), deepseek-v3's MLA prefill (qk dim 192, v zero-padded: the
   tile design) and the ``--reduced`` deepseek and internvl2 runs'
   shapes (head dims 24 and 16: CUDA-core; deepseek's MTP block at S - 1),
   each call gated on the design it must take, and in bf16 also on its
   error over the output's largest entry (outputs shrink as keys grow); and
   the custom op
   ``repro_torch::flash_attention`` that every call on the card goes
   through (``hold_op``): its output and gradients against autograd through
   the plain version at the training shape (fp32, bf16) and at phase 21's
   shapes, eagerly, and inside ``train.step.compile_fullgraph`` at the lm
   trial's, one launch a forward;
4. the int8 codec kernels against their plain versions, bit for bit: the
   reference's test cases, half-ulp boundaries, the zero tensor, random
   sizes, bf16, the training path's shapes (one shared scale over a
   stacked leaf) and the int8_ef residual;
5. the SSD scan kernels against the plain version, fp32 and bf16, y and
   the final state: the reference's kernel test cases, the mamba2 training
   shape, the prefill shape (224 of 256 rows padding), zamba2-1.2b's
   training and prefill shapes (64 heads, d_state 64) and cases aimed at the
   tensor-core design (two groups, an odd count of q tiles, n = 256, a
   misaligned slice that must take the CUDA-core kernel), each call gated
   on the design ``SSD.plan`` picks, the tensor-core kernel's distance to
   its emulation ``ssd_mma_plain`` printed beside; and the custom op
   ``repro_torch::ssd_scan`` as flash attention's (``hold_op``);
6. full-width qwen2.5-3b served through ``repro_torch.launch.serve.main``
   (batch 4, prompt 32, 32 generated tokens), with every kernel's launches
   counted over that run, flash attention's by design (split-KV only);
7. decode-loop logits against a prefill forward of the same prompt, at
   full width: asserted in fp32, reported for the served bf16 model,
   whose decode steps are then profiled (device busy time, idle share,
   top kernels); phases 6-7 are ``lm_serve``;
8. full-width smollm-360m trained through ``repro_torch.launch.train.main``
   (batch 8, seq 512, 3 steps of adamw with int8_ef compression), with
   every kernel's launches counted over that run, flash attention's by
   design (the tile kernel only); the losses must be finite and fall; then
   the same step, which updates its state in place, profiled as in phase 7
   (``lm_train``);
9. ``compress_tree`` on the full-width grads of one backward against its
   plain version, bit for bit;
10. full-width mamba2-370m served as in phase 6: decode is the recurrence,
    so no SSD launch;
11. mamba2-370m's decode loop against ``MD.prefill`` (48 SSD launches: the
    CUDA-core kernel in fp32, the tensor-core kernel in bf16) at full width:
    logits, conv tails and final SSD states asserted in fp32, reported in
    bf16; a bf16 decode step profiled;
12. full-width mamba2-370m trained as in phase 8 (4 x 48 SSD launches, all
    on the tensor-core kernel), then a train step profiled with its SSD
    forward on the tensor-core kernel and on the CUDA-core kernel;
13. timings: each kernel, its plain version and the one-call library
    yardstick where there is one (the port never calls it), each the median
    of 50 runs timed with CUDA events, L2 flushed before each run, beside
    the bound from bytes and operations. Flash attention at decode (64 and
    4096 slots), prefill and the training shape, causal (``AttnSpec()``'s
    default) and not, each against SDPA in its own mask form (none, or
    ``is_causal``) and given the mask as a boolean tensor; then the tile
    kernel's fixed cost and cost per KV tile, full and masked, at head_dims
    64 and 256; flash attention at gemma2-2b's training, prefill and decode
    (64 and 4096 slots) shapes (yardsticks: ``flex_attention`` compiled with
    its softcap and window, and SDPA without the softcap, labelled so) and
    at whisper-tiny's encoder and cross-attention decode (SDPA), and at
    zamba2's, llama4's and deepseek's new shapes (SDPA); at every head_dim
    192 or 256 row also the CUDA-core design on the same inputs, the design
    those head dims took before (``cuda_core_ms``); each flash row is first
    held to its plain version. The SSD scan's two
    designs at mamba2's and zamba2's training and prefill shapes on the same
    inputs, and the tensor-core kernel's fixed cost and cost per chunk;
    phase 21's shapes, one a kernel; the host cost a call of the flash
    attention op against the kernel's wrapper alone at the decode shape;
14. the paper's pipeline (``paper_pipeline``): the first LeNet-5 iteration
    of each mode (eager, ``torch.compile``d, compiled in place) at four
    Table-1 corners (the compiled modes at the first two:
    ``PIPELINE_JIT_CORNERS``) against the port's eager iteration on the CPU (1e-4,
    fp32, TF32 off), one compiled graph per compiled mode; the sweep
    through ``repro_torch.launch.fit_perfmodel.main`` (90 eager trials,
    then 2 in each compiled mode) with the generic model fitted by DE on
    the card, the Table-2/3 constants, the scaling report and the RF/SVR
    comparison, launching no port kernel; the generic model fitted to the
    checked-in arch-sweep rows at the recorded budget, its train MAE within
    1.25x the recorded; ``cost_fn`` on the card against the CPU (rtol 1e-5);
15. the sharded half of the pipeline (``sharded_pipeline``) on one pool of
    8 ranks sharing the card over gloo: (a) ``compressed_psum_mean`` (none,
    bf16, int8) and ``compressed_psum_mean_ef`` over worlds of 2, 4 and 8
    against rank 0's plain emulation (int8 means and residuals bit for bit,
    none/bf16 within n*2^-23*max|x|), exactly one absmax and one quantize
    launch per int8 call per rank; (b) the sharded LeNet-5 iteration at 8
    ranks for dp, fsdp, tp (the fc pair split 8 ways) and fsdp_tp (4 x 2),
    each with none and int8 (eager; two of the eight compiled as well:
    ``SHARDED_JIT_CASES``), against the
    single-process full-batch iteration (the reference test's tolerances,
    eager with cuDNN off: its algorithm for a sub-batch differs from the full
    batch's; compiled with cuDNN on),
    jit against eager, and 5 absmax + 5 quantize launches per rank per int8
    iteration (3 + 3 for tp, whose split leaves reduce over no axis); (c) a
    measured
    sweep through ``fit_perfmodel.main(["--sharded", ...])``: every row ok
    with ``t_measured_sharded`` > 0, the link calibration and the three
    fits run, and the codec kernels launched on the ranks;
16. full-width gemma2-2b (``lm_serve``, ``lm_train``): served through
    ``launch.serve.main`` as in phase 6 (1664 split-KV flash launches); its
    decode loop against a prefill forward, asserted in fp32, its bf16 decode
    steps profiled; trained through ``launch.train.main`` (batch 8, seq 512,
    4 steps of adamw with int8_ef under remat "dots": every block's
    attention in the forward and again in the backward's recompute, 52 a
    step), losses finite and falling, the peak memory printed and under
    the card's; a train step profiled;
17. full-width whisper-tiny, the same sequence: its encoder runs once per
    request over the 1500 stub frames of ``make_batch_for``, then each
    decode step attends to its cache and, non-causally, to the encoder's
    cross K/V (split-KV with a combine);
18. full-width zamba2-1.2b (38 Mamba2 layers, one attention/MLP block
    shared by its 6 groups), the same sequence: served (384 split-KV
    launches, no SSD: decode is the recurrence), its prefill (6 flash and
    38 SSD launches) held to the decode loop in fp32, trained under remat
    "full" (every group recomputed whole: 12 flash and 76 SSD launches a
    step, all tile and mma) with adamw and int8_ef; launches by design,
    falling losses, peak memory under the card's;
19. the MoE kinds at their published widths on a depth cut (the
    registry's config replaced for the entry points): llama4-scout on 4 of
    its 48 layers served (split-KV decode, tile prefill) and on 1 trained
    with sgd and no codec; deepseek-v3 on 4 of its 61 (3 dense MLA layers
    and one of 256 experts top-8, plus the MTP head) served, with no
    launch at decode (MLA's absorbed form) and 4 tile launches at a bf16
    prefill (4 CUDA-core in fp32); the decode-vs-prefill gate at capacity
    factor E/k, which drops no token. Then the same functions with ``--reduced``: deepseek trained
    (its MTP loss reported every step, its aux loss positive, all finite,
    the total falling) and internvl2 served (its decode loop held to a
    prefill without patches, as serving feeds none) and trained (patches
    prepended, their labels masked), each with exact launches. Every run
    through an entry point checks that its report's ``param_count`` is the
    config's handed to it;
20. the sharded LM train step (``sharded_lm``): smollm-360m at full width
    on 8 of its 32 layers
    through ``launch.train.main(["--devices", "4", "--strategy",
    "fsdp_tp", "--compression", "int8_ef", ...])`` (adamw, batch 8 x seq
    512, a warm-up and 2 steps) over 4 ranks of phase 15's pool sharing the
    card (gloo, mesh data 2 x model 2, the legacy body): the path, mesh, pool
    and every rank on the card; step 0's loss against the single-device
    loss on the same batch and seed within the bf16 tier; per rank and
    step exactly 8 flash ``tile`` launches (its 4 rows) and one absmax +
    one quantize launch per parameter tensor (74); each rank's peak
    memory and their sum under the card's. Then, on the same 4 ranks, one
    overlap-body step held to the legacy body's at the same mesh in fp32
    (the MLP split on model, attention streamed: 15 heads do not divide
    2) and a profiled legacy step per rank (device busy); then flash
    attention at the per-rank shape q [4, 512, 15, 64] against its plain
    version, timed beside SDPA ``is_causal`` and its bytes bound;
21. the arch sweep (``arch_sweep_phase``), on the shared pool: one
    trial of ``perf.sweep.measure_arch_trial`` in mode "jit" (inductor,
    ``fullgraph=True``) for each family of ``ARCH_SWEEP_POINTS`` (one
    layer: lm fsdp_tp 2 x 2 with int8_ef, moe dp with bf16 at n 2, ssm dp
    at n 4): the compiled single-device step and the compiled overlap body
    on the ranks, each beside as many eager steps from the same init (every
    step's loss within ``ARCH_LOSS_GAP``, the parameters after the last
    within ``ARCH_PARAM_GAP``), with no graph break (two graphs on one
    device; on a rank three, the gathers, the forward and the update, or
    two for dp, whose gather region is empty), exact launches per step
    counted inside the compiled graphs (one CUDA-core flash call per
    attention layer, one CUDA-core SSD call per Mamba2 layer, one absmax
    and one quantize per parameter tensor on every rank under int8_ef) and
    a complete row with its ``t_measured_sharded``. Phase 3 holds the
    flash attention op at the trials' shapes (compiled at the lm
    trial's), phase 5 the SSD op at the ssm trial's, eagerly and compiled
    (and the kernel at the sweep's d_state 16 and 32, which take the
    tensor cores), and phase 13 times one of each;
22. the planner: (a) before phase 15, ``python -m repro_torch.launch.plan
    --dry-run --k 10`` (``launch.plan.main``) on the card with the checked-in
    model and calibration, gated on the reference's plan (``PLAN_SPACE``,
    ``PLAN_FEASIBLE``, ``PLAN_FRONTIER``, ``PLAN_TOP10``, pinned to the
    reference's live output by ``tests/test_torch_plan_cli.py``) and on
    ``tools/planner_smoke.py``'s contract, then its fail-soft plan (the
    model's calibration stripped, ``$REPRO_CALIBRATION`` at a missing file)
    marked uncalibrated; (b) on phase 15's pool of 8, two picks of that plan
    (its int8 top pick and the best pick without a codec) through
    ``launch.plan.measure_slate``, the ``--validate`` protocol (each program
    compiled once, ``PLAN_ROUNDS`` interleaved rounds of ``PLAN_ITERS``
    steps), every rank's codec launches exact by phase 15 (b)'s count per
    int8 iteration, every fixed-work ms finite and positive; (c) after phase
    21, ``launch.train.main(["--strategy", "auto", "--report-comm",
    "--devices", "4", ...])``: smollm-360m at full width on 8 of its 32
    layers, adamw + int8_ef, batch
    8 x 512, ``AUTO_STEPS`` steps over 4 ranks, the strategy run equal to
    ``choose_strategy``'s on the same inputs (recomputed here) and the
    report's ``planner`` its decision, ``comm`` present, losses finite and
    falling, exact flash and codec launches per rank and step; the planner's
    comm_ms printed beside the measured gather_params + grad_reduce a rank.

23. sharded serving and the GSPMD train step over ranks sharing the card
    (``sharded_serve_phase``, ``serve_fp32_phase``, ``gspmd_train_phase``):
    (a) on 4 ranks of the pool, ``launch.serve.main(["--strategy", "tp",
    "--devices", "4", ...])``: full-width qwen2.5-3b at mesh 2 x 2 (q and kv
    heads and the MLP split, each rank on its 2 rows), bf16, batch 4,
    prompt 32, gen 32, fed phase 6's tokens (teacher forcing) and held to
    phase 6 at every step: the fp32 logits within ``TP_SERVE_TOL``, each
    token the argmax of phase 6's logits to within twice that (and a bf16
    ulp), exactly 36 ``split_kv`` flash launches a decode step a rank; (b) on phase 15's pool of 8,
    ``launch.serve.serve_rank`` of qwen2.5-3b on 4 of its 36 layers in fp32
    under fsdp_tp at 2 x 4 (attention whole: 2 kv heads do not divide 4;
    the MLP split), every generated step's fp32 logits within 1e-4 of one
    device on the card, the tokens equal, ``cuda_core`` flash only; (c) on
    4 ranks of the pool, ``launch.train.main(["--devices", "4", "--mode",
    "gspmd", "--strategy", "fsdp_tp", ...])``: full-width smollm-360m,
    adamw + int8_ef, batch 8 x 512, 3 steps, each loss within
    ``GSPMD_LOSS_TOL`` and each grad norm within ``GSPMD_GNORM_RTOL`` of
    phase 8's at the same step, exactly 32 ``tile`` + 290 absmax +
    290 quantize + 290 dequantize launches a rank a step, peak memory and
    the step's transient bytes printed.

24. tracing, checkpoints and the failure drill: (a) phase 8's smollm-360m
    run with ``--trace-dir``: one ``step`` span a step with ``data``,
    ``dispatch`` and ``wait`` children summing to within 10 % of it after
    the first step, ``trace.jsonl`` read back (``obs.read_jsonl``) with the
    report's span count, the Chrome trace with one ``X`` event a span, the
    metrics' step histogram and the card's memory watermark, equal to
    ``torch.cuda.max_memory_allocated``; the disabled recorder's overhead on
    the profiled step printed, not gated; (b) phase 6's qwen2.5-3b run with
    ``--trace-dir``: one ``prefill`` and 32 ``decode_step`` spans, their
    median within 10 % of the report's decode ms a step; (c) on the pool of
    8, the supervised failure drill through ``launch.train.main``:
    smollm-360m at full width on 4 of its 32 layers, fp32, batch 8 x seq 128,
    no codec, 6 steps, fsdp on 8 ranks, a checkpoint every 2 steps, the first
    2 writes failing (``--inject-ckpt-fault``), 4 ranks lost at step 4 and
    the run recovered onto tp on 4 with the survivors' program prebuilt:
    exactly 2 writes retried, the recovery prebuilt and restored shard to
    shard, every checkpoint left verified, the ``recovery/*`` spans traced,
    the 6 losses within ``256 * np.spacing(np.float32(8.0))`` of an
    uninterrupted fsdp run, every rank and step 4 ``cuda_core`` flash
    launches and nothing else; then a fatal (``ValueError``) write fails on
    its first attempt, and ``launch.elastic --quick`` drills the reference's
    tiny config cold and prebuilt; (d) ``launch.trace_report --quick`` on
    fsdp over the pool: every term of the attribution table measured above
    0, every step's children within 10 % of it; the table printed. Phase 13
    also times flash attention at phase 23's per-rank decode shapes.

25. the dry-run, the roofline and the step-time predictor: (a)
    smollm-360m at full width on a mesh of one, phase 8's batch of 8 x 512,
    remat none, adamw, no codec, traced on fake CUDA tensors by
    ``launch.dryrun.trace_cell`` in phase 25's process (no kernel launched
    there), then the same step function run on the card (a warm-up under
    ``perf.op_analysis.flop_counter``, 2 timed): the real flops equal the
    traced, the real peak within 10 % of the traced argument + temp bytes,
    the median step no faster than the roofline's ``t_step``, 32 ``tile``
    launches a step and nothing else; a bf16 GEMM (8192^3, median of 20)
    and a 1 GiB device copy each at most 1.05 x ``perf.roofline``'s
    ``PEAK_FLOPS`` and ``HBM_BW``, and ``HBM_PER_CHIP`` within the card's
    memory; (b) ``launch.dryrun.run_all`` (a process a cell) on device cuda:
    smollm-360m, qwen2.5-3b, gemma2-2b and mamba2-370m at full width, at
    train_4k and decode_32k on the pod mesh (16 x 16, rank 0 of a fake
    world of 256) and at train_4k on the multipod mesh (2 x 16 x 16, 512):
    every row OK, collective bytes on every train row, qwen2.5-3b's
    train_4k flops a rank at least ``model_flops_for`` / 256; each row's
    bottleneck, t_step and bytes per device printed; (c)
    ``launch.predict_scaling.main`` on (b)'s 12 rows: the generic model
    fitted by DE on the card (seeds 0, 1, 2), then the train_4k step of
    qwen2.5-3b, deepseek-v3-671b and mamba2-370m at 256 and 512 ranks and
    their straggler thresholds, every number finite and positive.

26. nemotron-4-15b served at full width (``nemotron_phase``): 15,627,976,704
    parameters (the report's ``param_count``, the reference's), 31.26 GB of
    bf16 weights; exactly 32 ``tile`` flash launches a prefill and 32
    ``split_kv`` a decode step (48 q over 8 kv heads of 128, G 6; phases 3
    and 13 hold and time both shapes); the fp32 decode-vs-prefill gate on 2
    of its 32 layers; the bf16 check and 4 profiled decode steps at full
    depth, a step's device busy at least the weights' bytes over
    ``HBM_BYTES_PER_S`` (9.33 ms); the peak beside the other processes'
    memory under the card's.

27. the benchmark drivers, the examples and the overlap smoke: (a)
    ``launch.roofline_table`` on both meshes and ``launch.roofline_fit``
    on phase 25 (b)'s rows (in phase 25's process): a line per row, its
    numbers the row's own ``roofline`` fields, the fit, ranking and
    threshold finite; (b) ``launch.run --only table2,table5 --quick`` on
    phase 14's eager rows (in phase 14's process): DE, DE+L2, RF and SVR
    test MAPE finite; (c) ``examples.quickstart``'s fit on the card (in
    phase 25's process): test MAPE under ``QUICKSTART_MAPE``, q_gpus
    negative, the example's own claim printed; (d) ``tools.overlap_smoke``'s
    claim 1 on the pool of 8: the overlapped tp body's local
    ``mlp_hidden`` is the sequential body's with d_ff cut 8 ways.

What keeps the run inside its time (PERF.md §4): one pool of 8 for phases
15 and 20-24, started and warmed in the background; phase 14 beside phases
22 (b) to 24; the single-device full-width trainings of smollm-360m (3 steps),
mamba2, zamba2 and gemma2 (4 steps) where every LM trained 8; phase 20 a
warm-up and 2 steps where it took 3, and phase 22 (c), on 8 of smollm's
32 layers (for phase 24's time); one profiled train step where the profiles read 2,
and mamba2's step profiled once on each SSD design; phase 25's traces in
a process of their own beside phases 16-24 (the main process runs only (a)'s
real steps and (b)'s and (c)'s gates); phase 25 (c)'s fit and phase 27's
(a, c) in that process after its traces, 27 (b) in phase 14's. No gate was
dropped.

The line before the last is the card's ``nvidia-smi`` name and power
limit, the one before that the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import unittest.mock

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()     # the phases print their start against it
ARCH = "qwen2.5-3b"
BATCH, PROMPT, GEN = 4, 32, 32
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
# Single-device training steps of the full-width runs: the loss gate's
# minimum where a step is device-bound (mamba2 ~2.0 s, zamba2 1.86 s,
# gemma2 0.83 s a step on the H100), and smollm-360m at phase 23 (c)'s
# three GSPMD steps, whose losses are held to phase 8's (the same config
# and lr schedule); TRAIN_STEPS for the others. A profiled train step
# traces PROFILE_TRAIN_STEPS steps.
TRAIN_STEPS_BY_ARCH = {"smollm-360m": 3, "mamba2-370m": 4, "zamba2-1.2b": 4,
                       "gemma2-2b": 4}
PROFILE_TRAIN_STEPS = 1
# What later phases hold to phases 6 and 8: phase 6's qwen2.5-3b tokens and
# fp32 step logits, phase 8's smollm-360m losses and grad norms.
SERVED, TRAINED = {}, {}
SSM_ARCH = "mamba2-370m"      # served and trained at the shapes above
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12,      # dense tensor-core bf16
                  "float32": 67e12}        # fp32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# SSD kernel vs plain, atol and rtol: the reference's kernel tolerances
# (tests/test_kernels.py). In bf16 the plain version rounds C·Bᵀ and the
# carried state to bf16 where the kernel keeps fp32, so y differs by more
# than its own rounding (one bf16 ulp is 3.1e-2 at |y| = 4..8).
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
# mamba2 decode loop vs prefill in fp32, atol and rtol: the conv tails and
# final SSD states of 48 layers, summed in GEMV and GEMM orders
SSM_CACHE_TOL = 1e-3

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
# The reference's codec test shapes (tests/test_kernels.py QUANT_SHAPES)
QUANT_SHAPES = [(5, 5, 3, 16), (400, 120), (84,), (257, 129), (8192,)]
# The reference's SSD test cases (tests/test_kernels.py SSD_CASES):
# b, l, h, p, g, n, chunk
SSD_CASES = [
    (1, 128, 2, 16, 1, 8, 32),
    (2, 64, 4, 8, 2, 16, 16),
    (1, 256, 8, 16, 1, 32, 64),
    (1, 32, 2, 8, 1, 8, 32),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(1)


CHILDREN = []     # processes started with subprocess (phase 14's)


def stop_children() -> None:
    """Kill every process this one started and has not joined (a pool's
    ranks, phase 14's process), so that the interpreter's exit does not
    wait for them."""
    import multiprocessing
    for child in multiprocessing.active_children():
        child.kill()
    for child in CHILDREN:
        if child.poll() is None:
            if getattr(child, "own_session", False):    # its children with it
                os.killpg(child.pid, 9)
            else:
                child.kill()


def phase(name: str) -> None:
    """The phase's banner, on standard output and standard error alike, so
    that a run cut short shows in either where its time went."""
    line = f"== {name} [{time.perf_counter() - T_START:.1f} s]"
    print(line, flush=True)
    print(f"chip_smoke: {line}", file=sys.stderr, flush=True)


# A run still going after this many seconds prints every thread's stack to
# standard error, stops the processes it started and exits non-zero, inside
# the 1200 s the script is given: what held it up is then on record.
WATCHDOG_S = 1170


def start_watchdog(seconds: float) -> None:
    def fire():
        print(f"chip_smoke: still running after {seconds:.0f} s; every thread's "
              f"stack:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        stop_children()
        os._exit(1)
    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()


def launch_counters(FA, Q, SSD):
    """({kernel: (module, counter)}, reset_counts, read_counts) over the
    port's kernel wrappers' launch counters."""
    counters = {"flash_attention": (FA, "LAUNCHES"),
                "quantize_absmax": (Q, "ABSMAX_LAUNCHES"),
                "quantize_int8": (Q, "QUANTIZE_LAUNCHES"),
                "dequantize_int8": (Q, "DEQUANTIZE_LAUNCHES"),
                "ssd_scan": (SSD, "LAUNCHES")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        FA.LAUNCHES_BY_VARIANT = dict.fromkeys(FA.VARIANTS, 0)
        SSD.LAUNCHES_BY_VARIANT = dict.fromkeys(SSD.VARIANTS, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    return counters, reset_counts, read_counts


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def ptxas_usage(log_path):
    """{entry function: {"registers", "spill_stores", "spill_loads"}} from
    an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            elif name and "spill stores" in line:
                words = line.replace(",", "").split()
                out[name]["spill_stores"] = int(words[words.index("spill") - 2])
                out[name]["spill_loads"] = int(words[-4])
            elif name and "Used" in line and "registers" in line:
                words = line.replace(",", " ").split()
                out[name]["registers"] = int(words[words.index("registers") - 1])
    return out


def flash_registers(ptxas):
    """{"tile<HD>" / "split_kv<HD>": ptxas usage} of the flash tensor-core
    kernels' instantiations, from ``ptxas_usage``'s mangled names."""
    out = {}
    for name, usage in ptxas.items():
        for kernel, label in (("flash_fwd_tile_kernelILi", "tile"),
                              ("flash_fwd_splitkv_kernelILi", "split_kv")):
            if kernel in name:
                out[label, int(name.split(kernel)[1].split("E")[0])] = usage
    return {f"{label}<{hd}>": out[label, hd] for label, hd in sorted(out)}


PORTED_KERNELS = (  # (name, substring of its device kernel's name); first wins
    ("flash_attention", "flash_fwd_"),     # its three designs and the combine
    ("dequantize_int8", "dequantize_kernel"),
    ("quantize_absmax", "absmax_kernel"),
    ("quantize_int8", "quantize_kernel"),
    ("ssd_scan", "ssd_scan_"),             # both designs
)


def profile_steps(torch, run, steps, what, card):
    """Where a step's time goes: host time per step without the profiler,
    then a ``torch.profiler`` trace of as many steps, read from its
    Chrome-trace export (device busy time, idle share, top kernels, and
    the port's own kernels). ``run()`` runs one step; it is called once
    first to warm up. Returns the host and device ms per step (None for the
    device when the trace holds no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    def run_all():
        for _ in range(steps):
            run()
        torch.cuda.synchronize()

    run()                                          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_all()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_all()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    print(f"  {what}: host wall {wall_ms:.3f} ms/step (no profiler); card {card}")
    if not kernels:
        print("  device time: not measured (the trace holds no kernel events)")
        return {"wall_ms": wall_ms, "busy_ms": None}
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, dur) in top:
        print(f"    {dur / steps / 1e3:8.4f} ms/step {n // steps:5d}x/step  {name[:90]}")
    ported = collections.defaultdict(lambda: [0, 0.0])
    for name, (n, dur) in by_name.items():
        label = next((k for k, sub in PORTED_KERNELS if sub in name), None)
        if label:
            ported[label][0] += n
            ported[label][1] += dur
    print("  the port's kernels: " + ", ".join(
        f"{k} {ported[k][1] / steps / 1e3:.4f} ms/step ({ported[k][0] // steps}x)"
        for k, _ in PORTED_KERNELS if k in ported))
    return {"wall_ms": wall_ms, "busy_ms": busy / steps / 1e3, "idle_share": 1 - busy / span,
            "top": [(name[:90], dur / steps / 1e3, n // steps) for name, (n, dur) in top]}


# Phase 14: LeNet-5 corners of Table 1 for the iteration parity, dropout 0:
# each dataset, stride 3 with same, kernel 5 with pool 5 on a map smaller
# than the window, sgd and adam, each activation: four corners, since each
# compiles both compiled modes (~20 s a corner).
PIPELINE_CORNERS = [
    dict(kernel_size=5, pool_size=2, padding="valid", stride=1, dataset="mnist",
         activation="relu", optimizer="sgd", n_filters=16, learning_rate=0.1,
         batch_size=32),
    dict(kernel_size=5, pool_size=5, padding="same", stride=3, dataset="cifar10",
         activation="tanh", optimizer="adam", n_filters=8, learning_rate=0.01,
         batch_size=16),
    dict(kernel_size=4, pool_size=2, padding="same", stride=2,
         dataset="fashion_mnist", activation="sigmoid", optimizer="sgd",
         n_filters=32, learning_rate=0.01, batch_size=64),
    dict(kernel_size=3, pool_size=3, padding="valid", stride=1, dataset="cifar10",
         activation="relu", optimizer="adam", n_filters=64, learning_rate=0.001,
         batch_size=128),
]
# The compiled modes run at the first two corners (both optimizers, two
# datasets and activations); eager at all four. All four compiled until
# phase 21 came; cut for chip_smoke's time.
PIPELINE_JIT_CORNERS = 2
PIPELINE_TOL = 1e-4          # iteration on the card vs eager on the CPU, fp32
COST_RTOL = 1e-5             # cost_fn on the card vs the CPU
ARCH_MAE_BOUND = 1.25        # port's train MAE / the recorded one
# Trials per mode of phase 14's sweep. A compiled mode compiles each config
# (5-30 s a config on the card's host), so the compiled sweeps are short:
# two trials each, which keep every gate and the whole run well inside its
# time limit.
SWEEP_TRIALS = {"eager": 90, "jit": 2, "jit_donate": 2}


class PaperPipelineProcess:
    """Phase 14 in a process of its own (``python3 chip_smoke.py
    --paper-pipeline``), started after phase 15: phase 14 is host-bound
    (inductor's compiles, the DE fits) on a core or two, and phases 22 (b)
    to 23 leave most of the eight cores idle (one to four ranks compile or
    wait on gloo), so it costs the run about nothing. Its output goes to a
    file, printed whole by ``finish``."""

    def __init__(self):
        print("  phase 14 (the paper pipeline) starts in a process of its own beside "
              "phases 22 (b) to 23; its output follows phase 23", flush=True)
        self.log = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--paper-pipeline"],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=REPO)
        CHILDREN.append(self.proc)

    def finish(self):
        """Wait for it, print its output; fail if it failed."""
        rc = self.proc.wait()
        wall = time.perf_counter() - self.t0
        self.log.seek(0)
        sys.stdout.write(self.log.read())
        self.log.close()
        print(f"  phase 14's process ended with code {rc} after {wall:.1f} s", flush=True)
        if rc != 0:
            fail(f"phase 14 (the paper pipeline) failed in its process, exit code {rc}")


def paper_pipeline_main() -> None:
    """``python3 chip_smoke.py --paper-pipeline``: phase 14 alone, with the
    main run's settings (TF32 off) and its own launch counters."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd_scan as SSD
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, reset_counts, read_counts = launch_counters(FA, Q, SSD)
    try:
        paper_pipeline(torch, torch.device("cuda", 0), nvidia_smi(), reset_counts,
                       read_counts)
    finally:
        from torch._inductor.async_compile import shutdown_compile_workers
        shutdown_compile_workers()


def paper_tables(rows_path, card):
    """Phase 27 (b), in phase 14's process: ``launch.run --only table2,table5
    --quick`` on its eager sweep's rows, the fits on the card; the test
    MAPE of DE, DE+L2, RF and SVR finite."""
    import numpy as np

    from repro_torch.launch import run
    print("== paper tables: launch.run --only table2,table5 --quick on the eager sweep's "
          "rows (phase 27 b)", flush=True)
    t0 = time.perf_counter()
    res = run.main(["--only", "table2,table5", "--quick", "--rows", rows_path,
                    "--device", "cuda"])
    t5 = res["table5"]["eager"]
    print(f"  table 5 (eager, test MAPE): {t5}; table 2's constants printed above; "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    if set(t5) != {"DE", "DE+L2", "RF", "SVR"} or not np.isfinite(list(t5.values())).all():
        fail(f"phase 27 (b): table 5's test MAPE is not finite: {t5}")
    return t5


def paper_pipeline(torch, dev, card, reset_counts, read_counts):
    """Phase 14: the paper's pipeline on the card. (a) the first LeNet-5
    iteration of each mode against the port's eager iteration on the CPU,
    one compiled graph per compiled mode; (b) the sweep through
    ``launch.fit_perfmodel.main`` in each mode, no port kernel launched;
    (c) the generic model fitted to the checked-in arch-sweep rows at the
    recorded budget, train MAE within 1.25x the recorded; (d) ``cost_fn``
    on the card against the CPU."""
    import numpy as np
    from torch._dynamo.utils import counters as dynamo_counters

    from repro_torch.configs.lenet5 import LeNet5Config
    from repro_torch.core.fit import fit_sweep_rows
    from repro_torch.core.generic_model import cost_fn, encode_dataset
    from repro_torch.data import lenet_batch
    from repro_torch.launch import fit_perfmodel
    from repro_torch.models.lenet import init_lenet, lenet_loss
    from repro_torch.perf import sweep as SW
    from repro_torch.perf.costmodel import Calibration, resimulate_rows
    from repro_torch.perf.features import LENET_SPEC, get_spec

    t_phase = time.perf_counter()

    # -- a. iteration parity ------------------------------------------------
    # Adam's first step moves a weight by lr*g/(|g| + 1e-8): where |g| is
    # near 1e-8 it turns the card's rounding of g into more than the
    # tolerance, so adam's new params are held where the CPU's |g| >= 1e-6
    # or g = 0 (as tests/test_torch_lenet.py does) and the count left out is
    # printed; sgd's everywhere.
    worst = {m: 0.0 for m in SW.MODES}
    for i, corner in enumerate(PIPELINE_CORNERS):
        cfg = LeNet5Config(**corner, dropout=0.0)
        p_cpu = init_lenet(cfg, seed=i, device="cpu")
        b_cpu = lenet_batch(cfg, seed=i, device="cpu")
        want, want_loss = SW.make_iteration(cfg, "eager")(p_cpu, b_cpu, None)
        g_cpu = torch.func.grad(lenet_loss)(p_cpu, b_cpu, cfg, None)
        sure = {k: (torch.ones_like(g, dtype=torch.bool) if cfg.optimizer == "sgd"
                    else (g.abs() >= 1e-6) | (g == 0)) for k, g in g_cpu.items()}
        left_out = sum(int((~m).sum()) for m in sure.values())
        line = []
        for mode in (("eager", "jit", "jit_donate") if i < PIPELINE_JIT_CORNERS
                     else ("eager",)):
            params = {k: v.to(dev) for k, v in p_cpu.items()}
            batch = {k: v.to(dev) for k, v in b_cpu.items()}
            it = SW.make_iteration(cfg, mode)
            g0 = dynamo_counters["stats"]["unique_graphs"]
            t0 = time.perf_counter()
            new, loss = it(params, batch, None)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            graphs = dynamo_counters["stats"]["unique_graphs"] - g0
            if graphs != (0 if mode == "eager" else 1):
                fail(f"LeNet corner {i} {mode}: {graphs} compiled graphs, expected "
                     f"{0 if mode == 'eager' else 1}")
            if mode == "jit_donate" and any(new[k].data_ptr() != params[k].data_ptr()
                                            for k in params):
                fail(f"LeNet corner {i} jit_donate did not update the params in place")
            err = abs(float(loss) - float(want_loss))
            ok = err <= PIPELINE_TOL * (1 + abs(float(want_loss)))
            for k in want:
                got, ref, m = new[k].cpu()[sure[k]], want[k][sure[k]], sure[k]
                err = max(err, (got - ref).abs().max().item() if m.any() else 0.0)
                ok = ok and torch.allclose(got, ref, atol=PIPELINE_TOL, rtol=PIPELINE_TOL)
            worst[mode] = max(worst[mode], err)
            line.append(f"{mode} {err:.3e} ({graphs} graph, first call {first_s:.2f} s)")
            if not ok:
                fail(f"LeNet corner {i} ({corner}) {mode}: new params or loss off the "
                     f"CPU's by {err:.3e} > {PIPELINE_TOL}")
        print(f"  corner {i} {cfg.dataset} k{cfg.kernel_size} p{cfg.pool_size} "
              f"s{cfg.stride} {cfg.padding} {cfg.activation} {cfg.optimizer} "
              f"b{cfg.batch_size}: " + ", ".join(line)
              + (f"; {left_out} adam weights with 0 < |g| < 1e-6 left out" if left_out
                 else ""), flush=True)
    print(f"  iteration vs the CPU's eager, largest difference per mode: {worst} "
          f"(tolerance {PIPELINE_TOL}); card {card}", flush=True)

    # -- b. the sweep ------------------------------------------------------
    reports, rows_by_mode = {}, {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for mode, n in SWEEP_TRIALS.items():
            path = os.path.join(tmp, f"rows_{mode}.json")
            reports[mode] = fit_perfmodel.main(["--mode", mode, "--trials", str(n),
                                                "--rows-out", path])
            with open(path) as f:
                rows_by_mode[mode] = json.load(f)
        paper_tables(os.path.join(tmp, "rows_eager.json"), card)
    moved = {k: v for k, v in read_counts().items() if v}
    if moved:
        fail(f"the paper pipeline launched port kernels: {moved}")
    for mode, rows in rows_by_mode.items():
        ok = [r for r in rows if "error" not in r]
        errors = [r["error"] for r in rows if "error" in r]
        if len(rows) != SWEEP_TRIALS[mode] or not ok:
            fail(f"{mode} sweep: {len(ok)} rows ok of {len(rows)}, errors {errors[:3]}")
        if any(r["measured_ms"] <= 0 or r["mode"] != mode for r in ok):
            fail(f"{mode} sweep: a row with measured_ms <= 0 or another mode")
        ms = sorted(r["measured_ms"] for r in ok)
        rep = reports[mode]
        print(f"  sweep {mode}: {len(ok)} rows ok, {len(errors)} error"
              f"{' ' + str(errors[:3]) if errors else ''}; measured_ms median "
              f"{statistics.median(ms):.4f}, range {ms[0]:.4f}-{ms[-1]:.4f}; sweep "
              f"{rep['sweep_s']:.1f} s, warm-up (compile) median "
              f"{rep['warmup_s']['median']:.3f} s, max {rep['warmup_s']['max']:.3f} s, "
              f"total {rep['warmup_s']['total']:.1f} s; fit {rep['fit_s']:.2f} s "
              f"(5 seeds); card {card}", flush=True)
    print(f"  launches of the port's kernels over the three sweeps and fits: "
          f"{read_counts()} (all 0)", flush=True)

    # -- c. the fits --------------------------------------------------------
    rep = reports["eager"]
    print(f"  eager fit ({rep['n_fit']} fit / {rep['n_test']} test rows): test MAPE "
          f"generic {rep['test_mape']['generic']:.4f}, random forest "
          f"{rep['test_mape']['random_forest']:.4f}, svr {rep['test_mape']['svr']:.4f}; "
          f"best cost {rep['best_cost']:.4f}; fit {rep['fit_s']:.2f} s; card {card}",
          flush=True)
    art = os.path.join(REPO, "benchmarks", "artifacts")
    with open(os.path.join(art, "arch_sweep_fit.json")) as f:
        recorded = json.load(f)
    plan = recorded["plan"]
    seeds = tuple(range(plan["seeds"]))
    for key, rec in recorded["fits"].items():
        family, source = key.split(":")
        with open(os.path.join(art, f"arch_sweep_{family}.json")) as f:
            rows = json.load(f)
        if source != "measured":
            rows = resimulate_rows(rows, Calibration.from_dict(
                recorded["calibrations"][family]))
        r, n_fit, n_test = fit_sweep_rows(
            get_spec(family).spec, rows, "jit",
            "measured" if source == "measured" else "simulated", seeds=seeds,
            maxiter=plan["maxiter"], device=dev)
        ratio = r.train_metrics["mae"] / rec["train"]["mae"]
        print(f"  {key:28s} ({n_fit}/{n_test} rows, {len(seeds)} seeds x "
              f"{plan['maxiter']}): train MAE {r.train_metrics['mae']:.2f} (recorded "
              f"{rec['train']['mae']:.2f}, x{ratio:.3f}), train MAPE "
              f"{r.train_metrics['mape']:.4f} ({rec['train']['mape']:.4f}); test MAE "
              f"{r.test_metrics['mae']:.2f} ({rec['test']['mae']:.2f}), test MAPE "
              f"{r.test_metrics['mape']:.4f} ({rec['test']['mape']:.4f}); "
              f"{r.fit_seconds / len(seeds):.3f} s a seed; card {card}", flush=True)
        if ratio > ARCH_MAE_BOUND:
            fail(f"{key}: the port's train MAE is {ratio:.3f}x the recorded one "
                 f"(bound {ARCH_MAE_BOUND})")

    # -- d. cost_fn on the card vs the CPU ------------------------------------
    ok_rows = [r for r in rows_by_mode["eager"] if "error" not in r]
    samples = [r["features"] for r in ok_rows]
    times = [SW.fit_target_ms(r) for r in ok_rows]
    lo, hi = LENET_SPEC.bounds()
    xs = (lo + (hi - lo) * np.random.default_rng(14).uniform(
        size=(20, LENET_SPEC.n_params))).astype(np.float32)
    enc = {d_: encode_dataset(LENET_SPEC, samples, times, device=d_)
           for d_ in (dev, "cpu")}
    for reg in ("none", "l1", "l2"):
        got, want = (cost_fn(LENET_SPEC, torch.from_numpy(xs).to(d_), *enc[d_],
                             reg=reg, lam=1e-3).cpu() for d_ in (dev, "cpu"))
        finite = torch.isfinite(want)
        if not torch.equal(finite, torch.isfinite(got)):
            fail(f"cost_fn ({reg}): the card and the CPU disagree on which costs are finite")
        rel = ((got - want).abs() / want.abs())[finite]
        err = rel.max().item() if finite.any() else 0.0
        if not torch.allclose(got[finite], want[finite], rtol=COST_RTOL, atol=0.0):
            fail(f"cost_fn ({reg}) on the card is off the CPU's by {err:.3e} "
                 f"relative > {COST_RTOL}")
        print(f"  cost_fn reg={reg}: 20 x over {len(samples)} eager rows, "
              f"{int(finite.sum())} finite, largest relative difference card vs CPU "
              f"{err:.3e} (rtol {COST_RTOL})", flush=True)
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)


# Phase 15: a world of 8 ranks, one process each, all on the one card (gloo).
SHARDED_WORLD = 8
# (a) per-rank inputs of the collectives: a LeNet fc1 gradient, a conv
# gradient, a ragged matrix and a vector
COLLECTIVE_SHAPES = [(120, 400), (5, 5, 3, 16), (257, 129), (84,)]
EF_STEPS = 3
# (b) eager (cuDNN off) against the full-batch iteration within the
# reference test's tolerances (tests/test_overlap_parity.py, LENET_SNIPPET):
# (2e-5 + 1e-5 * max|g|) * lr for none, (2e-5 + 0.75 * shard_max / 127) * lr
# for int8. jit (cuDNN on, as the sweep times it) against eager (cuDNN off)
# of the same sharded body within the none tolerance widened by
# SHARDED_CUDNN * lr: cuDNN's convolution algorithms for a rank's sub-batch
# move conv1's new params by up to ~1e-4 * lr from the native ones (eager
# with cuDNN on against off is printed). Under int8 at most one value in
# SHARDED_CROSSINGS of a leaf may be off by one more step of the int8 grid
# (lr * shard_max / 127): the compiled grads differ from eager's in the
# last bits and can move a value across a rounding boundary of the codec.
SHARDED_LOSS_TOL = 1e-5
SHARDED_CUDNN = 5e-4
SHARDED_CROSSINGS = 1000
SHARDED_STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp")
# The configurations (b) also compiles: dp's int8 and tp's (its split leaves
# reduce over no axis). All 8 until phase 21 came, which compiles the LM
# step's collectives and codec; cut to 2 for chip_smoke's time (a compile
# ~25 s).
SHARDED_JIT_CASES = (("dp", "int8"), ("tp", "int8"))
# (c) trials of the measured sweep: each compiles its single-device and its
# sharded iteration (on every rank of the trial at once, ~50 s). Seed 12's
# first two trials are fsdp_tp/int8 and tp/none at n = 2: the codec kernels,
# a split fc pair and both wire formats' rows
SHARDED_SWEEP_TRIALS, SHARDED_SWEEP_SEED = 2, 12
# sharded iterations a rank runs in a measured trial: the warm-up and the
# timed ones (perf/sweep.py's n_iters)
SHARDED_TRIAL_ITERS = 1 + 3


def _codec_calls(strategy, n):
    """int8 collectives a rank runs in one sharded LeNet iteration: one per
    leaf, but tp's split fc pair (n > 1) reduces over no axis."""
    return 3 if strategy == "tp" and n > 1 else 5


def _plain_collective(torch, xs, mode):
    """Rank 0's plain emulation of ``compressed_psum_mean`` /
    ``compressed_psum_mean_ef`` over every rank's input, on the CPU in fp32,
    in the reference's order of operations (``dist/compression.py``)."""
    x = torch.from_numpy(xs)                         # [steps, n, ...]
    n = torch.full((), float(x.shape[1]))
    means, residuals = [], []
    err = torch.zeros(x.shape[1:])
    for step in range(x.shape[0]):
        xr = x[step]
        if mode == "none":
            means.append(xr.sum(0) / n)
            continue
        if mode == "bf16":
            means.append(xr.to(torch.bfloat16).float().sum(0) / n)
            continue
        carried = xr + err if mode == "int8_ef" else xr
        scale = carried.abs().amax() / torch.full((), 127.0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(carried / safe), -127, 127)
        means.append(q.sum(0) * scale / n)
        if mode == "int8_ef":
            err = carried - q * scale
            residuals.append(err)
    return (torch.stack(means).numpy(),
            torch.stack(residuals).numpy() if residuals else None)


def warm_inductor(device) -> float:
    """Compile and run a small gradient step on ``device``, so that this
    process's first real compile does not also pay inductor's set-up (~25 s
    a process on the H100 machines' 8-core hosts). The seconds it took."""
    import torch
    t0 = time.perf_counter()

    def loss(w, x):
        return torch.tanh(x @ w).square().mean()

    step = torch.compile(torch.func.grad_and_value(loss), fullgraph=True)
    w = torch.randn(16, 16, device=device)
    g, _ = step(w, torch.randn(8, 16, device=device))
    g.sum().item()
    return time.perf_counter() - t0


def warm_compile(ctx) -> float:
    """Pool job: ``warm_inductor`` on every rank but 0, this process, which
    warmed while the kernels built."""
    return 0.0 if ctx.rank == 0 else warm_inductor(ctx.device)


class OpeningPool(threading.Thread):
    """A ``dist.pool.Pool`` started in the background, each spawned rank
    then warmed by ``warm_compile``: the ranks import torch, take the card
    and set up inductor while this process runs the phases before the
    pool's (one card, no pool). ``get`` waits for it."""

    def __init__(self, world, dev):
        super().__init__(daemon=True, name="pool-start")
        self.world, self.dev = world, dev
        self.pool = self.error = self.up_s = self.warm_s = None
        self.t0 = time.perf_counter()
        self.start()

    def run(self):
        from repro_torch.dist.pool import Pool
        try:
            self.pool = Pool(world=self.world, device=self.dev)
            self.up_s = time.perf_counter() - self.t0
            self.warm_s = self.pool.run(warm_compile, mesh={"data": self.world})
        except BaseException as e:          # handed to the caller by get
            self.error = e

    def get(self):
        """(the open pool, seconds it took to start, each rank's warm-up
        seconds, seconds waited here)."""
        t0 = time.perf_counter()
        self.join()
        if self.error is not None:
            raise self.error
        return self.pool, self.up_s, self.warm_s, time.perf_counter() - t0


def sharded_pipeline(torch, dev, card, opening, then=None):
    """Phase 15: the sharded half of the paper's pipeline on the card, over
    one pool of 8 ranks sharing it (gloo). (a) the compressed collectives
    against rank 0's plain emulation; (b) the sharded LeNet iteration of
    every strategy against the single-process full-batch iteration, jit
    against eager, with exact codec launches; (c) a short measured sweep
    through ``fit_perfmodel.main(["--sharded", ...])``. Returns the kernel
    launches of every rank summed over (c), the path's run, and what
    ``then(pool)`` returned: a later phase run on the same pool.
    ``opening``: the ``OpeningPool`` of 8 ranks started before phase 16."""
    import numpy as np

    from repro_torch.configs.lenet5 import LeNet5Config
    from repro_torch.data import lenet_batch
    from repro_torch.dist import probes
    from repro_torch.launch import fit_perfmodel
    from repro_torch.models.lenet import init_lenet, lenet_loss
    from repro_torch.perf import sweep as SW
    from repro_torch.perf.costmodel import mesh_axes_for

    t_phase = time.perf_counter()
    pool, up_s, warm_s, waited_s = opening.get()
    with pool:
        print(f"  pool of {pool.world} ranks ({pool.backend}) on {dev} up in "
              f"{up_s:.1f} s, started before phase 16, then a first compile on "
              f"ranks 1-{pool.world - 1} in {max(warm_s):.1f} s; waited "
              f"{waited_s:.1f} s for it here", flush=True)

        # -- a. the collectives ------------------------------------------------
        t0 = time.perf_counter()
        worst = {}
        for n in (2, 4, 8):
            for mode in ("none", "bf16", "int8", "int8_ef"):
                steps = EF_STEPS if mode == "int8_ef" else 1
                for j, shape in enumerate(COLLECTIVE_SHAPES):
                    rng = np.random.default_rng(1000 * n + 10 * j + len(mode))
                    xs = (rng.standard_normal((steps, n, *shape))
                          * rng.uniform(1e-3, 10.0, size=(steps, n) + (1,) * len(shape))
                          ).astype(np.float32)
                    res = pool.run(probes.collective, xs, mode, mesh={"data": n})
                    want, want_res = _plain_collective(torch, xs, mode)
                    bit = mode in ("int8", "int8_ef")
                    tol = 0.0 if bit else n * 2.0 ** -23 * float(np.abs(xs).max())
                    err = 0.0
                    for r, out in enumerate(res):
                        err = max(err, float(np.abs(out["means"] - want).max()))
                        if bit and not np.array_equal(out["means"], want):
                            fail(f"compressed_psum_mean {mode} n={n} {shape}: rank {r}'s "
                                 f"mean is not the plain emulation's bit for bit ({err:.3e})")
                        if mode == "int8_ef" and not np.array_equal(out["residuals"],
                                                                    want_res[:, r]):
                            fail(f"compressed_psum_mean_ef n={n} {shape}: rank {r}'s "
                                 "residuals are not the plain emulation's bit for bit")
                        launched = out["launches"]
                        expect = steps if bit else 0
                        if (launched["quantize_absmax"], launched["quantize_int8"],
                                launched["dequantize_int8"]) != (expect, expect, 0):
                            fail(f"compressed_psum_mean {mode} n={n}: rank {r} launched "
                                 f"{launched}, expected {expect} absmax + {expect} quantize")
                    if err > tol:
                        fail(f"compressed_psum_mean {mode} n={n} {shape}: {err:.3e} > {tol:.3e}")
                    worst[mode] = max(worst.get(mode, 0.0), err / tol if tol else err)
        print(f"  collectives over worlds of 2, 4, 8 x {len(COLLECTIVE_SHAPES)} shapes "
              f"(int8_ef over {EF_STEPS} steps): int8 and int8_ef means and residuals "
              f"bit for bit; largest none/bf16 error as a share of n*2^-23*max|x|: "
              f"none {worst['none']:.3f}, bf16 {worst['bf16']:.3f}; one absmax and one "
              f"quantize launch per int8 call per rank, none for none/bf16; "
              f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)

        # -- b. the sharded LeNet iteration at n = 8 ---------------------------
        # The eager iterations against the full batch run with cuDNN off, on
        # every rank and in this process: its algorithm for a rank's
        # sub-batch can differ from the full batch's and is off the fp64
        # iteration by more than the tolerance (conv1 at 8 images a rank under
        # fsdp_tp); PyTorch's own convolutions hold the sharding math to fp32
        # rounding. The compiled iterations then run with cuDNN on, as the
        # sweep does (compiled with cuDNN off, a graph's stride check of a
        # convolution's output failed on the card: planned channels-last,
        # computed contiguous), and are held to the eager ones.
        configs, eager = [], {}
        torch.backends.cudnn.enabled = False
        pool.run(probes.set_cudnn, False, mesh={"data": pool.world})
        for strategy in SHARDED_STRATEGIES:
            for comp in ("none", "int8"):
                t0 = time.perf_counter()
                cfg = LeNet5Config(strategy=strategy, n_devices=SHARDED_WORLD,
                                   batch_size=32, optimizer="sgd", compression=comp,
                                   dropout=0.0)
                axes = mesh_axes_for(strategy, SHARDED_WORLD)
                p_cpu = init_lenet(cfg, seed=0, device="cpu")
                b_cpu = lenet_batch(cfg, seed=0, device="cpu")
                inputs = ({k: v.numpy() for k, v in p_cpu.items()},
                          {k: v.numpy() for k, v in b_cpu.items()})
                res = pool.run(probes.sharded_iteration, cfg, ["eager"], *inputs,
                               mesh=axes)
                params = {k: v.to(dev) for k, v in p_cpu.items()}
                batch = {k: v.to(dev) for k, v in b_cpu.items()}
                want, want_loss = SW.make_iteration(cfg, "eager")(params, batch, None)
                # int8 scales are agreed over per-shard grads, whose maxima exceed
                # the full-batch mean's: bound the ulp by the data shards' maxima
                data = axes.get("data", 1)
                per = cfg.batch_size // data
                shard_max = {k: 0.0 for k in params}
                for i in range(data):
                    sub = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                    g = torch.func.grad(lenet_loss)(params, sub, cfg, None)
                    for k in params:
                        shard_max[k] = max(shard_max[k], g[k].abs().max().item())
                lr = cfg.learning_rate
                frac = 0.0
                expect = 0 if comp == "none" else _codec_calls(strategy, SHARDED_WORLD)
                g_max = {k: float(np.abs(p_cpu[k].numpy() - want[k].cpu().numpy()).max())
                         / lr for k in params}
                for r, out in enumerate(res):
                    launched = out["eager"]["launches"]
                    if (launched["quantize_absmax"], launched["quantize_int8"],
                            launched["dequantize_int8"]) != (expect, expect, 0):
                        fail(f"sharded {strategy}/{comp} eager: rank {r} launched "
                             f"{launched}, expected {expect} absmax + {expect} quantize")
                    if abs(out["eager"]["loss"] - float(want_loss)) > SHARDED_LOSS_TOL:
                        fail(f"sharded {strategy}/{comp}: rank {r}'s loss "
                             f"{out['eager']['loss']} vs {float(want_loss)}")
                    for k in params:
                        got = out["eager"]["params"][k]
                        ref = want[k].cpu().numpy()
                        lim = (2e-5 + (1e-5 * g_max[k] if comp == "none"
                                       else 0.75 * shard_max[k] / 127.0)) * lr
                        err = float(np.abs(got - ref).max())
                        if err > lim:
                            fail(f"sharded {strategy}/{comp} {k}: rank {r}'s new params "
                                 f"off the full-batch iteration by {err:.3e} > {lim:.3e}")
                        frac = max(frac, err / lim)
                eager[strategy, comp] = res
                configs.append((strategy, comp, cfg, axes, inputs, shard_max, g_max,
                                expect))
                print(f"  sharded {strategy:7s} {comp:4s} mesh {axes}: eager new params "
                      f"within {frac:.3f} of the tolerance of the full-batch iteration "
                      f"on every rank; {expect} absmax + {expect} quantize launches per "
                      f"rank per iteration; {time.perf_counter() - t0:.1f} s; card "
                      f"{card}", flush=True)
        torch.backends.cudnn.enabled = True
        pool.run(probes.set_cudnn, True, mesh={"data": pool.world})
        for strategy, comp, cfg, axes, inputs, shard_max, g_max, expect in configs:
            if (strategy, comp) not in SHARDED_JIT_CASES:
                continue
            t0 = time.perf_counter()
            res = pool.run(probes.sharded_iteration, cfg, ["eager", "jit"], *inputs,
                           mesh=axes)
            lr = cfg.learning_rate
            jit_frac, crossed, worst, cudnn = 0.0, 0, 0.0, 0.0
            for r, (out, ref) in enumerate(zip(res, eager[strategy, comp])):
                launched = out["jit"]["launches"]
                if (launched["quantize_absmax"], launched["quantize_int8"],
                        launched["dequantize_int8"]) != (expect, expect, 0):
                    fail(f"sharded {strategy}/{comp} jit: rank {r} launched "
                         f"{launched}, expected {expect} absmax + {expect} quantize")
                loss_gap = abs(out["jit"]["loss"] - ref["eager"]["loss"])
                if loss_gap > SHARDED_LOSS_TOL:
                    fail(f"sharded {strategy}/{comp}: rank {r}'s jit loss off eager "
                         f"by {loss_gap:.3e} > {SHARDED_LOSS_TOL}")
                for k, got in out["jit"]["params"].items():
                    want_k = ref["eager"]["params"][k]
                    diff = np.abs(got - want_k)
                    base = (2e-5 + 1e-5 * g_max[k] + SHARDED_CUDNN) * lr
                    lim = base + (0.0 if comp == "none" else lr * shard_max[k] / 127.0)
                    if diff.max() > lim:
                        fail(f"sharded {strategy}/{comp} {k}: rank {r}'s jit params "
                             f"off eager by {diff.max():.3e} > {lim:.3e}")
                    over = int((diff > base).sum())
                    if over > max(1, diff.size // SHARDED_CROSSINGS):
                        fail(f"sharded {strategy}/{comp} {k}: rank {r}'s jit params "
                             f"off eager by more than {base:.3e} at {over} of "
                             f"{diff.size} values")
                    jit_frac = max(jit_frac, float(diff.max()) / lim)
                    worst = max(worst, float(diff.max()) / lr)
                    crossed += over
                    cudnn = max(cudnn, float(np.abs(out["eager"]["params"][k]
                                                    - want_k).max()) / lr)
            print(f"  sharded {strategy:7s} {comp:4s} jit (cuDNN on) vs eager (off): "
                  f"largest |new param difference| / lr {worst:.3e}, within "
                  f"{jit_frac:.3f} of its tolerance, {crossed} values past the none "
                  f"tolerance on all ranks (eager with cuDNN on vs off: "
                  f"{cudnn:.3e}); {expect} absmax + {expect} quantize launches per "
                  f"rank from the compiled graph; {time.perf_counter() - t0:.1f} s; "
                  f"card {card}", flush=True)

        # -- c. a measured sweep through the entry point ------------------------
        pool.run(probes.reset_launches, mesh={"data": pool.world})
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rows.json")
            report = fit_perfmodel.main(["--sharded", "--mode", "jit", "--trials",
                                         str(SHARDED_SWEEP_TRIALS), "--seed",
                                         str(SHARDED_SWEEP_SEED), "--rows-out", path],
                                        pool=pool)
            with open(path) as f:
                rows = json.load(f)
        per_rank = pool.run(probes.read_launches, mesh={"data": pool.world})
        own_s = time.perf_counter() - t_phase
        later = then(pool) if then is not None else None
    launches = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    ok = [r for r in rows if "error" not in r]
    errors = [r["error"] for r in rows if "error" in r]
    if errors or len(ok) != SHARDED_SWEEP_TRIALS:
        fail(f"sharded sweep: {len(ok)} rows ok of {len(rows)}, errors {errors[:2]}")
    bad = [r for r in ok if not (r["t_measured_sharded"] or 0) > 0
           or r["sharded_skip"] is not None]
    if bad:
        fail(f"sharded sweep: {len(bad)} ok rows without a measured iteration: "
             f"{[(r['t_measured_sharded'], r['sharded_skip']) for r in bad]}")
    if set(report["sharded_fits"]) != {"measured", "simulated (default link)",
                                       "simulated (calibrated)"}:
        fail(f"sharded sweep: fits {sorted(report['sharded_fits'])}")
    codec = sum(f["n_devices"] * SHARDED_TRIAL_ITERS
                * _codec_calls(f["strategy"], f["n_devices"])
                for f in (r["features"] for r in ok) if f["compression"] == "int8")
    if not codec or (launches["quantize_absmax"], launches["quantize_int8"],
                     launches["dequantize_int8"]) != (codec, codec, 0):
        fail(f"sharded sweep: launches over every rank {launches}, expected "
             f"{codec} absmax + {codec} quantize (and more than none)")
    for r in ok:
        f_ = r["features"]
        print(f"  row {f_['strategy']:7s} n={f_['n_devices']} {f_['compression']:4s} "
              f"batch {f_['batch_size']:3d}: measured {r['t_measured_sharded']:.3f} ms, "
              f"simulated {r['t_simulated']:.3f} ms (compute {r['measured_ms']:.3f} + "
              f"comm {r['comm_ms']:.3f}); card {card}", flush=True)
    print(f"  sharded sweep: {len(ok)} rows ok, {len(errors)} error"
          f"{' ' + str(errors[:2]) if errors else ''}, {report['measured_rows']} measured; "
          f"residual MAE {report['residual_mae_ms']['default']:.3f} ms (default link) -> "
          f"{report['residual_mae_ms']['calibrated']:.3f} ms (calibrated); test MAPE "
          + ", ".join(f"{k} {v['test_mape']:.4f}" for k, v in report["sharded_fits"].items())
          + f"; sweep {report['sweep_s']:.1f} s; launches over every rank {launches}; "
          f"card {card}", flush=True)
    print(f"  phase 15 took {own_s:.1f} s; card {card}", flush=True)
    return launches, later


# Phases 16 and 17: the local/global pair and the encoder-decoder kinds at
# full width, each served, held decode-against-prefill and trained under
# remat "dots" (the dense products' outputs kept, the rest recomputed, so
# every block's attention runs twice a step).
LG_ARCH = "gemma2-2b"          # lg_pair, head_dim 256, softcaps 50 and 30
ENCDEC_ARCH = "whisper-tiny"   # enc_attn / dec_attn over 1500 stub frames
LM_REMAT = "dots"
# adamw's peak lr in the short trainings (no warmup under 10 steps). gemma2's
# 2304-wide layers move by about d_model·lr of their output scale on Adam's
# first, sign-like step: at the default 3e-4 its loss rose from 12.81 to
# 16.11 on step 2 before it fell; at 3e-5 it falls on every step.
LG_LR, ENCDEC_LR = 3e-5, 3e-4
# Phase 18: zamba2-1.2b at full width, trained under remat "full" (the
# reference's TrainConfig default: a group's six Mamba2 blocks and the
# shared block recompute together) at gemma2's lr, its width being close.
HYBRID_ARCH, HYBRID_LR, HYBRID_REMAT = "zamba2-1.2b", 3e-5, "full"
# Phase 19: the MoE kinds at their published widths on a depth cut (the
# registry's config replaced in the entry points), and at reduced size
# through ``--reduced``. llama4 trains one layer with sgd and no codec:
# 2 + 2 + 4 bytes a parameter of 4.27B fit; adamw + int8_ef would not.
MOE_ARCH, MLA_ARCH, VLM_ARCH = ("llama4-scout-17b-a16e", "deepseek-v3-671b",
                                "internvl2-76b")
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_TRAIN_LR = 4, 1, 1e-2
REDUCED_SEQ, REDUCED_LR = 128, 3e-4
# Phase 26: nemotron-4-15b (48 q over 8 kv heads of 128, G 6; squared ReLU,
# no gate, an untied head) served at full width on the card: 15,627,976,704
# parameters, 31.26 GB in bf16. Its fp32 decode-vs-prefill gate runs on a
# depth cut (fp32 weights of all 32 layers, 62.5 GB, would not fit beside the
# pool's ranks); its bf16 check and profiled decode step at full depth, where
# a step reads every weight: at least the weights' bytes over HBM_BYTES_PER_S.
NEMOTRON_ARCH, NEMOTRON_CHECK_LAYERS = "nemotron-4-15b", 2


def flash_designs(FA, q_shape, kv_shape, dtype):
    """Kernel launches by design of one flash call (``FA.plan``)."""
    p = FA.plan(q_shape, kv_shape, dtype, dtype, dtype)
    return {p.variant: 1, **({"split_kv_combine": 1} if p.n_splits > 1 else {})}


def _add(acc, launches, times=1):
    for k, n in launches.items():
        acc[k] = acc.get(k, 0) + n * times
    return acc


def pass_work(MD, cfg, B, Sq, Skv, *, decode=False, train=False):
    """One decoder pass of ``cfg``, from ``MD.build_segments``: its flash
    attention calls [(q shape, kv shape)] and its SSD scan calls. Attention
    reads Skv keys (a decode step's cache slots, a windowed cache's at most
    its window; Sq at prefill and in training). whisper's cross-attention
    reads the encoder's T frames, and in training, where the reference's
    loss hands it none, the tokens. MLA attends at qk dim nope + rope with
    Hkv = H at prefill and in training, and launches nothing at decode (the
    absorbed form). Mamba2 blocks run the SSD scan at prefill and in
    training, and the recurrence at decode."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.get_head_dim()
    q = (B, Sq, hq, hd)

    def kv(window=0, n=None):
        n = n or (min(Skv, window) if decode and window else Skv)
        return (B, n, hkv, hd)

    flash, ssd = [], 0
    for seg in MD.build_segments(cfg):
        if seg.kind == "ssm":
            ssd += 0 if decode else seg.n
        elif seg.kind == "zamba_group":
            ssd += 0 if decode else seg.n * seg.inner
            flash += [(q, kv(seg.window))] * seg.n
        elif seg.kind in ("mla_mlp", "mla_moe"):
            qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            flash += [] if decode else [((B, Sq, hq, qk), (B, Sq, hq, qk))] * seg.n
        elif seg.kind == "lg_pair":
            flash += [(q, kv(seg.window)), (q, kv())] * seg.n
        else:                             # attn_mlp, attn_moe, dec_attn
            flash += [(q, kv())] * seg.n
            if seg.kind == "dec_attn":
                flash += [(q, kv(n=Sq if train else cfg.encoder_seq_len))] * seg.n
    return flash, ssd


def designs_of(FA, calls, dtype, times=1):
    acc = {}
    for q, kv in calls:
        _add(acc, flash_designs(FA, q, kv, dtype), times)
    return acc


def _no_drop(cfg):
    """``cfg`` with capacity factor E/k, so C = T: no token is dropped."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _lm_config(arch, n_layers=None, reduced_size=False):
    """The config the entry points run for ``arch``: the registry's, cut to
    ``n_layers`` if given, or ``reduced`` for ``reduced_size``; a context
    that hands a cut config to the entry points (which read the registry
    when called) while it is open; their extra arguments; and a label.
    lm_serve and lm_train fail if a report's ``param_count`` is not this
    config's, so a cut that stops applying is seen."""
    import repro_torch.configs as CF
    full = CF.get_config(arch)
    if reduced_size:
        return CF.reduced(full), contextlib.nullcontext(), ["--reduced"], " --reduced"
    if n_layers is None:
        return full, contextlib.nullcontext(), [], " at full width"
    cut = dataclasses.replace(full, n_layers=n_layers)
    real = CF.get_config
    return (cut, unittest.mock.patch.object(
        CF, "get_config", lambda a: cut if a == arch else real(a)), [],
        f" at full width ({n_layers} of {full.n_layers} layers)")


def _check_param_count(report, cfg, what):
    if report["param_count"] != cfg.param_count():
        fail(f"{what} ran a config of {report['param_count']} parameters, expected "
             f"{cfg.param_count()}: the config handed to the entry point did not apply")


# Phase 24 (a, b): what the traced trainer and server of phases 8 and 6 give
TRACED = {}
OVERHEAD_ROUNDS, OVERHEAD_BLOCK = 2, 1


def train_trace_gate(report, trace_dir, steps, peak, card):
    """Phase 24 (a): the spans of phase 8's traced run (``_spans_gate``),
    ``trace.jsonl`` read back with the report's span count, the Chrome trace
    with one ``X`` event a span, and the metrics' step histogram and memory
    watermark, the run's ``torch.cuda.max_memory_allocated``."""
    import shutil

    from repro_torch.obs import read_jsonl
    phase(f"traced training: phase 8's run with --trace-dir (phase 24 a)")
    try:
        data = read_jsonl(os.path.join(trace_dir, "trace.jsonl"))
        with open(os.path.join(trace_dir, "trace_chrome.json")) as f:
            chrome = json.load(f)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    cover, child_ms = _spans_gate(data, steps, "traced training")
    if len(data.spans) != report["trace"]["spans"]:
        fail(f"trace.jsonl holds {len(data.spans)} spans, the report "
             f"{report['trace']['spans']}")
    n_x = sum(e["ph"] == "X" for e in chrome["traceEvents"])
    if n_x != len(data.spans):
        fail(f"the Chrome trace holds {n_x} X events for {len(data.spans)} spans")
    hist = report["metrics"].get("step_time_ms", {})
    mark = report["metrics"].get("memory/peak_bytes_in_use_max", {}).get("value")
    if hist.get("count") != steps or data.metrics != report["metrics"]:
        fail(f"traced training metrics: step histogram {hist}")
    if mark != peak:
        fail(f"traced training memory watermark {mark} != max_memory_allocated {peak}")
    step_ms = [round(s.duration_s * 1e3, 3) for s in data.find("step")]
    print(f"  {len(data.spans)} spans; step spans ms {step_ms}; children's mean ms "
          f"(steps 1..) {child_ms}; coverage per step {cover}; step_time_ms p50 "
          f"{hist['p50']}; memory watermark {mark} B = max_memory_allocated; card {card}",
          flush=True)
    return {"step_ms": step_ms, "children_ms": child_ms, "coverage": cover,
            "spans": len(data.spans), "peak_bytes": mark}


def recorder_overhead(torch, step, card):
    """The disabled recorder's cost on a step: blocks of steps with a
    disabled recorder's spans and without, interleaved, the minimum of each
    side; printed, not gated (host time spreads between runs, C6)."""
    from repro_torch.obs import Recorder
    off = Recorder(enabled=False)

    def block(spans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(OVERHEAD_BLOCK):
            if spans:
                with off.span("step", category="train", step_num=i, phase="steady"):
                    with off.span("data", category="train"):
                        pass
                    with off.span("dispatch", category="train"):
                        step()
                    with off.span("wait", category="train"):
                        torch.cuda.synchronize()
            else:
                step()
                torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OVERHEAD_BLOCK

    plain, inst = [], []
    for r in range(OVERHEAD_ROUNDS):
        for spans in ((False, True) if r % 2 == 0 else (True, False)):
            (inst if spans else plain).append(block(spans))
    out = {"plain_ms": min(plain) * 1e3, "instrumented_ms": min(inst) * 1e3,
           "overhead": (min(inst) - min(plain)) / min(plain)}
    print(f"  disabled-recorder overhead on the step: {out['overhead']:+.3%} (plain "
          f"{out['plain_ms']:.3f} ms vs instrumented {out['instrumented_ms']:.3f} ms, min "
          f"of {OVERHEAD_ROUNDS} interleaved {OVERHEAD_BLOCK}-step blocks; not gated); "
          f"card {card}", flush=True)
    return out


def serve_trace_gate(report, trace_dir, card):
    """Phase 24 (b): phase 6's traced server: one ``prefill`` and GEN
    ``decode_step`` spans, their median within 10 % of the report's decode
    ms a step."""
    import shutil

    from repro_torch.obs import read_jsonl
    try:
        data = read_jsonl(os.path.join(trace_dir, "trace.jsonl"))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    n_pre, steps = len(data.find("prefill")), data.find("decode_step")
    if (n_pre, len(steps)) != (1, GEN) or report["trace"]["spans"] != len(data.spans):
        fail(f"traced serving: {n_pre} prefill and {len(steps)} decode_step spans")
    med = statistics.median(s.duration_s * 1e3 for s in steps)
    per_step = report["decode_s"] / GEN * 1e3
    print(f"  traced serving (phase 24 b): 1 prefill span ({data.find('prefill')[0].duration_s * 1e3:.3f} ms), "
          f"{GEN} decode_step spans, median {med:.3f} ms vs the report's {per_step:.3f} ms "
          f"a step; card {card}", flush=True)
    if abs(med - per_step) > 0.10 * per_step:
        fail(f"traced serving: median decode_step span {med:.3f} ms is not within 10 % "
             f"of the report's {per_step:.3f} ms a step")
    TRACED["serve"] = {"decode_step_median_ms": med, "decode_ms_per_step": per_step,
                       "prefill_ms": data.find("prefill")[0].duration_s * 1e3,
                       "spans": len(data.spans)}


DECODE_PROFILES = {}     # arch: lm_serve's profiled bf16 decode steps and its report


def lm_serve(torch, dev, card, arch, env, prefix, n_layers=None, reduced_size=False,
             check_layers=None):
    """An LM at full width (``n_layers`` cuts its depth) or ``--reduced``
    (``reduced_size``), served: (a) through ``launch.serve.main`` with every
    kernel's launches counted, flash attention's and the SSD scan's by
    design; (b) the decode loop against a prefill forward (an
    encoder-decoder encodes its frames once for both; an MoE routes at
    capacity factor E/k there, so neither path drops a token; the vision
    stub's prefill gets no patches, as the decode loop gets none), asserted
    in fp32 (on ``check_layers`` of the layers when given) and reported in
    bf16, whose decode steps are then profiled (``DECODE_PROFILES``).
    Returns ({path: kernel counts}, {path: flash launches by design}, {path:
    SSD launches by design}), each path named ``prefix`` + serve or
    prefill_check_<dtype>."""
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.models import model as MD

    full, registry, extra, cut = _lm_config(arch, n_layers, reduced_size)
    encdec = full.is_encoder_decoder
    T, cap = full.encoder_seq_len, PROMPT + GEN
    hq, hkv, hd = full.n_heads, full.n_kv_heads, full.get_head_dim()
    bf16 = torch.bfloat16
    counts, designs, ssd_designs = {}, {}, {}
    enc_calls = [((BATCH, T, hq, hd), (BATCH, T, hkv, hd))] * (
        full.n_encoder_layers if encdec else 0)

    # ---- (a) serve -----------------------------------------------------------
    phase(f"serve {arch}{cut} (batch {BATCH}, prompt {PROMPT}, gen {GEN})")
    torch.cuda.reset_peak_memory_stats()
    env.reset_counts()
    keep = arch == ARCH and n_layers is None and not reduced_size
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_trace_") if keep else None
    with registry:
        served = serve.main(["--arch", arch, *extra, "--batch", str(BATCH), "--prompt-len",
                             str(PROMPT), "--gen", str(GEN), "--device", "cuda",
                             *(["--trace-dir", trace_dir] if keep else [])],
                            keep_logits=keep)
    if keep:                                   # phase 24 (b): the traced server
        serve_trace_gate(served.report, trace_dir, card)
    if keep:                                   # phase 23 (a) holds the sharded server to it
        SERVED[arch] = (served.tokens.cpu(), [x.float().cpu() for x in served.step_logits])
    got, got_designs, got_ssd = env.read_counts(), env.read_variants(), env.read_ssd_variants()
    rep = served.report
    peak_serve = torch.cuda.max_memory_allocated()
    _check_param_count(rep, full, f"{arch} serve")
    # the decode loop runs over the prompt's tokens (the vision stub's prompt
    # is cut to the tokens left beside its patches) and GEN more
    served_cap = rep["prompt_len"] + GEN
    step_calls, _ = pass_work(MD, full, BATCH, 1, served_cap, decode=True)
    want = {k: 0 for k in got}
    want["flash_attention"] = served_cap * len(step_calls) + len(enc_calls)
    print(f"  launches {got} (expected {want}); prefill_s {rep['prefill_s']} decode_s "
          f"{rep['decode_s']} decode_tok_per_s {rep['decode_tok_per_s']} encode_s "
          f"{rep.get('encode_s')} param_count {rep['param_count']} tree_params "
          f"{rep['tree_params']} peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f}; "
          f"card {card}", flush=True)
    if got != want:
        fail(f"{arch} serve launched the kernels {got}, expected {want}")
    env.gate_variants(f"{arch} serve", got_designs,
                      **_add(designs_of(FA, enc_calls, bf16), designs_of(FA, step_calls, bf16),
                             served_cap))
    env.gate_ssd_variants(f"{arch} serve", got_ssd)
    if not torch.isfinite(served.logits.float()).all():
        fail(f"{arch} serve produced non-finite logits")
    if served.tokens.shape != (BATCH, GEN) or not (
            (served.tokens >= 0) & (served.tokens < full.vocab_size)).all():
        fail(f"{arch} serve tokens out of range or shape {tuple(served.tokens.shape)}")
    counts[f"{prefix}serve"], designs[f"{prefix}serve"] = got, got_designs
    ssd_designs[f"{prefix}serve"] = got_ssd
    del served
    torch.cuda.empty_cache()

    # ---- (b) decode loop against prefill -------------------------------------
    # fp32 weights, activations and caches hold the decode path (kernel at
    # Sq=1 over the cache, or MLA's absorbed form) to the prefill path
    # (kernel at Sq=32, the SSD scan over the prompt); the logits are bf16
    # either way (logits_fn), so the bf16 tolerance applies. The served bf16
    # model is run the same way and its difference printed: its layers of
    # bf16 rounding, in GEMV and GEMM orders, move the logits by several bf16
    # ulps, so it is reported, not asserted. An MoE routes B tokens a decode
    # step and B·S at prefill, so at its own capacity factor a decode step
    # drops tokens the prefill keeps: both run at C = T here.
    moe_note = (f" (MoE at capacity factor {full.moe.n_experts}/{full.moe.top_k}: "
                f"no token dropped)" if full.moe else "")
    if check_layers:
        moe_note += f" (fp32 on {check_layers} of its {full.n_layers} layers)"
    phase(f"{arch} decode loop vs prefill forward{cut}{moe_note}")
    batch = make_batch_for(full, BATCH, PROMPT)
    prompt = batch["tokens"].to(dev)
    S = prompt.shape[1]
    pre_batch = {"tokens": prompt}
    if full.frontend == "vision_patch_stub":
        pre_batch["patches"] = torch.zeros(BATCH, 0, full.d_model, device=dev)
    for dname in ("float32", "bfloat16"):
        depth = full.n_layers if dname == "bfloat16" else (check_layers or full.n_layers)
        cfg = _no_drop(dataclasses.replace(full, dtype=dname, param_dtype=dname,
                                           n_layers=depth))
        pre_calls, pre_ssd = pass_work(MD, cfg, BATCH, S, S)
        dtype = MD.dtype_of(cfg)
        with torch.inference_mode():
            params = MD.init_model(cfg, seed=0, device=dev)
            enc_kv = MD.encode(params, cfg, batch["frames"].to(dev)) if encdec else None
            caches = MD.init_decode_caches(cfg, BATCH, cap, dtype=dtype, device=dev)
            for pos in range(S):
                dec, caches = MD.decode_step(params, cfg, caches, prompt[:, pos:pos + 1],
                                             pos, enc_kv=enc_kv)
            torch.cuda.synchronize()
            env.reset_counts()
            pre, _ = MD.prefill(params, cfg, pre_batch, enc_kv=enc_kv)
            torch.cuda.synchronize()
            pre_counts = env.read_counts()
            pre_designs, pre_ssd_designs = env.read_variants(), env.read_ssd_variants()
        want = {k: 0 for k in pre_counts}
        want["flash_attention"], want["ssd_scan"] = len(pre_calls), pre_ssd
        if pre_counts != want:
            fail(f"{arch} {dname} prefill launched the kernels {pre_counts}, expected {want}")
        env.gate_variants(f"{arch} {dname} prefill", pre_designs,
                          **designs_of(FA, pre_calls, dtype))
        # the model paths' SSD shapes (head_dim 64, d_state 64 or 128, aligned
        # rows) take the tensor-core kernel in bf16, the CUDA-core one in fp32
        ssd_design = "mma" if dname == "bfloat16" else "cuda_core"
        env.gate_ssd_variants(f"{arch} {dname} prefill", pre_ssd_designs,
                              **({ssd_design: pre_ssd} if pre_ssd else {}))
        counts[f"{prefix}prefill_check_{dname}"] = pre_counts
        designs[f"{prefix}prefill_check_{dname}"] = pre_designs
        ssd_designs[f"{prefix}prefill_check_{dname}"] = pre_ssd_designs
        err = (dec.float() - pre.float()).abs().max().item()
        ok = torch.allclose(dec.float(), pre.float(), atol=TOL["bfloat16"],
                            rtol=TOL["bfloat16"])
        agree = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
        verdict = ("ok" if ok else "FAIL") if dname == "float32" else "reported"
        print(f"  {dname:8s} last-position logits max_abs_err={err:.3e} (max |logit| "
              f"{pre.float().abs().max().item():.3f}) tol={TOL['bfloat16']:g} argmax "
              f"agreement {agree:.2f} {verdict}; peak_mem_GB "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        if dname == "float32" and not ok:
            fail(f"{arch} decode logits disagree with prefill: max_abs_err={err}")
        if dname == "bfloat16":
            tok, at = dec.argmax(-1)[:, None], [S]

            def decode_one():
                nonlocal caches
                _, caches = MD.decode_step(params, cfg, caches, tok, at[0], enc_kv=enc_kv)
                at[0] += 1

            with torch.inference_mode():
                DECODE_PROFILES[arch] = {
                    **profile_steps(torch, decode_one, 4, f"{arch} decode step{cut}, bf16, "
                                    f"batch {BATCH}", card),
                    "report": {k: rep[k] for k in ("prefill_s", "decode_s",
                                                   "decode_tok_per_s", "param_count",
                                                   "tree_params")},
                    "serve_peak_bytes": peak_serve,
                    "check_peak_bytes": torch.cuda.max_memory_allocated()}
        del params, caches, enc_kv, dec, pre
        torch.cuda.empty_cache()
    return counts, designs, ssd_designs


def _train_work(MD, FA, cfg, B, S, remat, dtype, steps):
    """Flash launches by design, flash calls and SSD calls of ``steps``
    training steps: every block's forward once, and again in the
    backward's recompute under remat "full" or "dots"; an MTP head's block
    once a step (it runs under no remat), at S - 1 positions."""
    passes = 1 if remat == "none" else 2
    calls, ssd = pass_work(MD, cfg, B, S, S, train=True)
    designs = designs_of(FA, calls, dtype, steps * passes)
    n_calls, n_ssd = steps * passes * len(calls), steps * passes * ssd
    if cfg.mtp_depth:
        mtp, _ = pass_work(MD, dataclasses.replace(cfg, n_layers=1, moe=None), B, S - 1,
                           S - 1, train=True)
        _add(designs, designs_of(FA, mtp, dtype, steps))
        n_calls += steps * len(mtp)
    return designs, n_calls, n_ssd


def lm_train(torch, dev, card, arch, env, prefix, lr, remat, *, optimizer="adamw",
             compression="int8_ef", n_layers=None, reduced_size=False):
    """An LM at full width (``n_layers`` cuts its depth) or ``--reduced``
    (``reduced_size``, at sequence REDUCED_SEQ), trained: (c) through
    ``launch.train.main`` (``TRAIN_STEPS_BY_ARCH``'s steps, else
    ``TRAIN_STEPS``, of ``optimizer`` at ``lr`` with
    ``compression`` under ``remat``) with every kernel's launches counted,
    flash attention's and the SSD scan's by design, losses finite and
    falling, an MoE's aux loss finite and positive, an MTP head's loss
    reported every step and finite, the peak memory under the card's; (d)
    one train step of the same kind profiled. Returns ({path: kernel
    counts}, {path: flash launches by design}, {path: SSD launches by
    design}), the path named ``prefix`` + train."""
    import numpy as np
    from repro_torch.configs import TrainConfig, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train
    from repro_torch.models import model as MD
    from repro_torch.train import step as TS
    from repro_torch.tree import reference_leaves

    full, registry, extra, cut = _lm_config(arch, n_layers, reduced_size)
    seq = REDUCED_SEQ if reduced_size else TRAIN_SEQ
    steps = (TRAIN_STEPS if reduced_size or n_layers
             else TRAIN_STEPS_BY_ARCH.get(arch, TRAIN_STEPS))

    # ---- (c) train ------------------------------------------------------------
    phase(f"train {arch}{cut} (batch {TRAIN_BATCH}, seq {seq}, "
          f"{steps} steps, {optimizer} lr {lr:g}, {compression}, remat {remat})")
    torch.cuda.reset_peak_memory_stats()
    env.reset_counts()
    traced = arch == TRAIN_ARCH and not (n_layers or reduced_size)
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_train_trace_") if traced else None
    with registry:
        trained = train.main(["--arch", arch, *extra, "--batch", str(TRAIN_BATCH), "--seq",
                              str(seq), "--steps", str(steps), "--optimizer",
                              optimizer, "--lr", str(lr), "--compression", compression,
                              "--remat", remat, "--device", "cuda", "--log-every", "1",
                              *(["--trace-dir", trace_dir] if traced else [])])
    peak = torch.cuda.max_memory_allocated()
    if traced:                                 # phase 24 (a): the traced trainer
        TRACED["train"] = train_trace_gate(trained, trace_dir, steps, peak, card)
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    got, got_designs, got_ssd = env.read_counts(), env.read_variants(), env.read_ssd_variants()
    # The codec: one launch of each kernel per parameter tensor per step, the
    # tensors grouped into the reference's leaves (the tree from a narrow
    # model of the same depth).
    skeleton = MD.init_model(dataclasses.replace(
        reduced(full), n_layers=full.n_layers, n_encoder_layers=full.n_encoder_layers),
        seed=0, device="cpu")
    groups = reference_leaves(skeleton)
    n_tensors = sum(len(idx) for _, idx in groups)
    # a vision stub's sequence is its patches and the tokens left beside them
    step_designs, n_flash, n_ssd = _train_work(MD, FA, full, TRAIN_BATCH, seq,
                                               remat, torch.bfloat16, steps)
    want = {k: 0 for k in got}
    want["flash_attention"], want["ssd_scan"] = n_flash, n_ssd
    if compression != "none":
        for k in ("quantize_absmax", "quantize_int8", "dequantize_int8"):
            want[k] = steps * n_tensors
    losses, aux, mtp = trained["losses"], trained["aux"], trained.get("mtp_ce", [])
    print(f"  launches {got} (expected {want}: {n_tensors} parameter tensors in "
          f"{len(groups)} reference leaves); step_ms {trained['step_ms']} tokens_per_s "
          f"{trained['tokens_per_s']} peak_mem_GB {peak / 1e9:.2f} of {card_bytes / 1e9:.2f}; "
          f"param_count {trained['param_count']} tree_params {trained['tree_params']}; "
          f"losses {[round(x, 3) for x in losses]}; aux {[round(x, 6) for x in aux]}; "
          f"mtp_ce {[round(x, 3) for x in mtp]}; card {card}", flush=True)
    _check_param_count(trained, full, f"{arch} train")
    if got != want:
        fail(f"{arch} train launched the kernels {got}, expected {want}")
    env.gate_variants(f"{arch} train", got_designs, **step_designs)
    env.gate_ssd_variants(f"{arch} train", got_ssd, **({"mma": n_ssd} if n_ssd else {}))
    if full.mtp_depth and len(mtp) != steps:
        fail(f"{arch} train reported no MTP loss every step: {mtp}")
    if len(losses) != steps or not all(np.isfinite(losses + aux + mtp)):
        fail(f"{arch} train losses not finite: {losses}, aux {aux}, mtp_ce {mtp}")
    if full.moe and not all(a > 0 for a in aux):
        fail(f"{arch} train has no aux loss: {aux}")
    if not losses[-1] < losses[0]:
        fail(f"{arch} train loss did not fall: {losses}")
    if not peak < card_bytes:
        fail(f"{arch} train peak memory {peak} is not under the card's {card_bytes}")
    if arch == TRAIN_ARCH and not (n_layers or reduced_size):
        TRAINED[arch] = (losses, trained["grad_norm"])  # phase 23 (c) holds the GSPMD step to them
    del trained
    torch.cuda.empty_cache()

    # ---- (d) a profiled train step: launch.train's step ---------------------------
    tcfg = TrainConfig(optimizer=optimizer, learning_rate=lr, grad_compression=compression,
                       remat_policy=remat, total_steps=steps,
                       warmup_steps=steps // 10)
    holder = [TS.init_train_state(full, tcfg, seed=0, device=dev)]
    tbatch = {k: v.to(dev) for k, v in make_batch_for(
        full, TRAIN_BATCH, seq, step=0).items()}
    step_fn = TS.make_train_step(full, tcfg)

    def train_one():
        holder[0], _ = step_fn(holder[0], tbatch)

    profile_steps(torch, train_one, PROFILE_TRAIN_STEPS, f"{arch} train step{cut}, bf16, "
                  f"batch {TRAIN_BATCH} x seq {seq}, {optimizer} + {compression}, "
                  f"remat {remat}", card)
    if traced:
        TRACED["train"]["overhead"] = recorder_overhead(torch, train_one, card)
    del holder, tbatch, step_fn
    torch.cuda.empty_cache()
    path = f"{prefix}train"
    return {path: got}, {path: got_designs}, {path: got_ssd}


# Phase 26's counts: nemotron-4-15b's parameters (the reference's
# param_count) and the bytes of a bf16 weight
NEMOTRON_PARAMS, BF16_BYTES = 15_627_976_704, 2


def nemotron_phase(torch, dev, card, env):
    """Phase 26: nemotron-4-15b served at full width through
    ``launch.serve.main`` (``lm_serve``: exact flash launches by design, 32
    ``tile`` per prefill and 32 ``split_kv`` per decode step; the fp32
    decode-vs-prefill gate on ``NEMOTRON_CHECK_LAYERS`` layers at full width;
    the bf16 check and its profiled decode steps at full depth). Gates: the
    report's ``param_count`` is the reference's; this process's peak and
    the card's memory in use under the card's; a profiled decode step's
    device busy at least the weights' bytes over ``HBM_BYTES_PER_S`` (a
    step reads every weight: a lower reading means the trace missed work).
    Prints what the other processes (the pool's ranks, phase 25's traces)
    hold on the card beside it."""
    total = torch.cuda.get_device_properties(dev).total_memory

    def in_use():
        free, _ = torch.cuda.mem_get_info(dev)
        return total - free, total - free - torch.cuda.memory_reserved(dev)

    used0, others0 = in_use()
    result = lm_serve(torch, dev, card, NEMOTRON_ARCH, env, "nemotron_",
                      check_layers=NEMOTRON_CHECK_LAYERS)
    used1, others1 = in_use()
    prof = DECODE_PROFILES[NEMOTRON_ARCH]
    rep = prof["report"]
    weights = rep["tree_params"] * BF16_BYTES
    bound_ms = weights / HBM_BYTES_PER_S * 1e3
    step_ms = rep["decode_s"] / GEN * 1e3
    peak = max(prof["serve_peak_bytes"], prof["check_peak_bytes"])
    numbers = {"param_count": rep["param_count"], "tree_params": rep["tree_params"],
               "weights_bytes": weights, "decode_bound_ms": bound_ms,
               "decode_tok_per_s": rep["decode_tok_per_s"], "decode_step_ms": step_ms,
               "prefill_s": rep["prefill_s"], "busy_ms": prof["busy_ms"],
               "wall_ms": prof["wall_ms"], "idle_share": prof.get("idle_share"),
               "top": prof.get("top"), "serve_peak_bytes": prof["serve_peak_bytes"],
               "check_peak_bytes": prof["check_peak_bytes"], "total_memory": total,
               "others_bytes": [others0, others1], "card_in_use_bytes": [used0, used1]}
    print(f"  nemotron-4-15b: param_count {rep['param_count']} (reference "
          f"{NEMOTRON_PARAMS}), tree_params {rep['tree_params']}; decode "
          f"{rep['decode_tok_per_s']} tok/s, {step_ms:.3f} ms a step (host clock); "
          f"profiled decode step: busy {prof['busy_ms']} ms, wall {prof['wall_ms']:.3f} "
          f"ms, idle share {prof.get('idle_share')}, vs the weights' bytes bound "
          f"{bound_ms:.3f} ms ({weights} B); peak {peak} B (serve "
          f"{prof['serve_peak_bytes']}, checks {prof['check_peak_bytes']}) of the card's "
          f"{total}; other processes held {others0} B before and {others1} B after; "
          f"card {card}", flush=True)
    if rep["param_count"] != NEMOTRON_PARAMS:
        fail(f"phase 26: nemotron-4-15b's param_count {rep['param_count']}, expected "
             f"{NEMOTRON_PARAMS}")
    if prof["busy_ms"] is None or not prof["busy_ms"] >= bound_ms:
        fail(f"phase 26: a profiled decode step's busy {prof['busy_ms']} ms is under "
             f"the weights' bytes bound {bound_ms:.3f} ms: the trace missed work")
    if not peak + max(others0, others1) < total:
        fail(f"phase 26: peak {peak} B beside {max(others0, others1)} B of other "
             f"processes does not fit the card's {total}")
    return result, numbers


# Phase 20: the sharded LM train step. launch.train over a world of 4 ranks
# sharing the card (gloo), mesh plan_remesh(4) = (data 2, model 2), fsdp_tp,
# adamw + int8_ef, a warm-up step then 2 (the report's medians read steps
# 1..2), on 4 ranks of the pool that phases 15 and 20-23 share. Gates: step 0's loss against the single-device loss on the same
# batch and seed within the bf16 tier, |d| <= 1e-5 + |loss| / 256; exact
# launches per rank per step; peak memory. Then one overlap-body step held
# to the legacy body's at the same mesh in fp32 (sgd, b1 0, no decay, no
# clip, lr 1: g = p0 - p1), per tensor within the reference test's
# overlap-vs-legacy tolerance 2e-5 + 1e-5 * max|g_legacy|.
SHARDED_LM_RANKS, SHARDED_LM_STRATEGY, SHARDED_LM_STEPS = 4, "fsdp_tp", 1 + 2
# Its depth cut (8 of 32 layers) pays for phase 24's time.
SHARDED_LM_LAYERS = 8
SHARDED_LM_LOSS_TIER = 1 / 256
SHARDED_BODIES_FLOOR = 2e-5


def sharded_lm(torch, dev, card, pool, then=None):
    """Phase 20 (a, b): the sharded train step of smollm-360m at full width,
    driven through
    ``launch.train.main(["--devices", "4", ...])``, then both bodies and a
    profiled step per rank, on 4 ranks of phase 15's pool, which
    ``then(pool)`` gets next (phases 21, 22 (c) and 23 (a, c)). Returns
    ({kernel: launches summed over ranks and steps}, per-rank shape of the
    flash calls, the numbers printed, what ``then(pool)`` returned)."""
    import numpy as np

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch_for
    from repro_torch.dist import probes
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves

    full, registry, _, cut = _lm_config(TRAIN_ARCH, SHARDED_LM_LAYERS)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, SHARDED_LM_RANKS
    mesh = plan_remesh(n).axes()
    rows = B // mesh["data"]

    # ---- (a) launch.train over the world -------------------------------------
    phase(f"sharded {TRAIN_ARCH}{cut}: launch.train --devices {n} --strategy "
          f"{SHARDED_LM_STRATEGY} (mesh {mesh}), adamw + int8_ef, batch {B} x seq {S}, "
          f"{SHARDED_LM_STEPS} steps, {n} of phase 15's {pool.world} ranks over gloo "
          f"sharing the card")
    t0 = time.perf_counter()
    held = pool.run(probes.release_memory, mesh={"data": pool.world})
    print(f"  device bytes the ranks still reserve after phase 15's jobs: {held}",
          flush=True)
    with registry:
        report = train.main(["--arch", TRAIN_ARCH, "--devices", str(n), "--strategy",
                             SHARDED_LM_STRATEGY, "--compression", "int8_ef",
                             "--optimizer", "adamw", "--batch", str(B), "--seq", str(S),
                             "--steps", str(SHARDED_LM_STEPS), "--device", dev.type,
                             "--log-every", "1"], pool=pool)
    run_s = time.perf_counter() - t0
    _check_param_count(report, full, "sharded train")
    if report["path"] != "sharded" or report["mesh"] != [mesh["data"], mesh["model"]]:
        fail(f"sharded train ran path {report['path']} on mesh {report['mesh']}")
    want_pool = {"ranks": n, "backend": "gloo", "cards": 1}
    if report["pool"] != want_pool:
        fail(f"sharded train pool {report['pool']}, expected {want_pool}")
    if [r["device"] for r in report["ranks"]] != [torch.cuda.get_device_name(0)] * n:
        fail(f"sharded train ranks ran on {[r['device'] for r in report['ranks']]}")
    losses = report["losses"]
    if len(losses) != SHARDED_LM_STEPS or not all(np.isfinite(losses)):
        fail(f"sharded train losses not finite: {losses}")
    params = MD.init_model(full, seed=0, device=dev)
    batch0 = {k: v.to(dev) for k, v in make_batch_for(full, B, S, step=0).items()}
    with torch.no_grad():
        single, _ = MD.loss_fn(params, full, batch0, remat="none")
    single = float(single)
    del params, batch0
    loss_tol = 1e-5 + abs(single) * SHARDED_LM_LOSS_TIER
    print(f"  step 0 loss {losses[0]:.6f} vs the single-device step's {single:.6f}: "
          f"|d| {abs(losses[0] - single):.3e} (tier {loss_tol:.3e}); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if abs(losses[0] - single) > loss_tol:
        fail(f"sharded step 0 loss {losses[0]} vs single-device {single}")
    # every rank, every step: its flash calls (its rows, the tile design) and
    # one absmax + one quantize launch per parameter tensor (the legacy body's
    # int8_ef reduction; the summed integers are scaled, never dequantized)
    step_designs, n_flash, _ = _train_work(MD, FA, full, rows, S, "none",
                                           torch.bfloat16, 1)
    n_tensors = len(tree_leaves(MD.param_shapes(full)))
    want = {"flash_attention": n_flash, "quantize_absmax": n_tensors,
            "quantize_int8": n_tensors, "dequantize_int8": 0, "ssd_scan": 0,
            "flash_by_design": {v: step_designs.get(v, 0) for v in FA.VARIANTS}}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    totals = collections.Counter()
    for r in report["ranks"]:
        for step, got in enumerate(r["launches_per_step"]):
            if got != want:
                fail(f"sharded train rank {r['rank']} step {step} launched {got}, "
                     f"expected {want}")
            totals.update({k: v for k, v in got.items() if k != "flash_by_design"})
        if not r["peak_mem_bytes"] < card_bytes:
            fail(f"sharded train rank {r['rank']} peak memory {r['peak_mem_bytes']}")
    peaks = [r["peak_mem_bytes"] for r in report["ranks"]]
    if not sum(peaks) < card_bytes:
        fail(f"sharded train ranks' peak memory {sum(peaks)} is not under the card's "
             f"{card_bytes}")
    regions = {k: [round(r["regions_ms"][k], 3) for r in report["ranks"]]
               for k in report["ranks"][0]["regions_ms"]}
    print(f"  launches per rank per step {want} ({n_tensors} parameter tensors), every "
          f"rank and step; step_ms {report['step_ms']} tokens_per_s "
          f"{report['tokens_per_s']}; per-rank region ms (median of steps 1..) "
          f"{regions}; per-rank peak_mem_GB "
          f"{[round(p / 1e9, 2) for p in peaks]} (sum {round(sum(peaks) / 1e9, 2)} of "
          f"{round(card_bytes / 1e9, 2)}); run "
          f"{run_s:.1f} s; card {card}", flush=True)
    out = {"step_ms": report["step_ms"], "tokens_per_s": report["tokens_per_s"],
           "regions_ms": regions, "peak_mem_bytes": peaks, "losses": losses,
           "launches_per_rank_step": want}

    # ---- (b) overlap body vs legacy body; a profiled step per rank --------------
    phase(f"sharded {TRAIN_ARCH}{cut}: overlap body vs legacy body in fp32 at mesh {mesh}, "
          f"then a profiled legacy step per rank")
    cfg32 = dataclasses.replace(full, dtype="float32", param_dtype="float32")
    sgd = TrainConfig(learning_rate=1.0, optimizer="sgd", beta1=0.0, weight_decay=0.0,
                      grad_clip=1e9, total_steps=10, warmup_steps=0,
                      remat_policy="none", grad_compression="none")
    main_tcfg = TrainConfig(learning_rate=3e-4, optimizer="adamw",
                            grad_compression="int8_ef", remat_policy="none",
                            total_steps=SHARDED_LM_STEPS,
                            warmup_steps=SHARDED_LM_STEPS // 10)
    batch_np = {k: v.numpy() for k, v in make_batch_for(full, B, S, step=0).items()}
    live = sorted(MD.tp_live_axes(full, mesh["model"]))
    t0 = time.perf_counter()
    res = pool.run(probes.sharded_bodies, cfg32, sgd, SHARDED_LM_STRATEGY, 0,
                   batch_np, mesh=mesh)
    prof = pool.run(probes.sharded_train_profile, full, main_tcfg,
                    SHARDED_LM_STRATEGY, 0, batch_np, mesh=mesh)
    pool.run(probes.release_memory, mesh=mesh)
    later = then(pool) if then is not None else None
    worst = 0.0
    for j in range(len(res[0]["err"])):
        gmax = max(r["gmax"][j] for r in res)
        err = max(r["err"][j] for r in res)
        lim = SHARDED_BODIES_FLOOR + 1e-5 * gmax
        if err > lim:
            fail(f"overlap body tensor {j}: |g_overlap - g_legacy| {err:.3e} > {lim:.3e}")
        worst = max(worst, err / lim)
    l_leg, l_ov = res[0]["loss"][False], res[0]["loss"][True]
    if abs(l_leg - l_ov) > 1e-5 * abs(l_leg):
        fail(f"overlap body loss {l_ov} vs legacy {l_leg}")
    busy = [p["busy_ms"] for p in prof]
    print(f"  overlap vs legacy (tp live axes {live}): worst error {worst:.3f} of "
          f"2e-5 + 1e-5 * max|g| over {len(res[0]['err'])} tensors x {n} ranks; loss "
          f"legacy {l_leg:.6f} overlap {l_ov:.6f}", flush=True)
    print(f"  profiled legacy step per rank (bf16, adamw + int8_ef): wall ms under "
          f"the profiler "
          f"{[round(p['wall_ms'], 3) for p in prof]}, device busy ms {busy}, kernels "
          f"{[p['kernels'] for p in prof]}; {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    out.update(overlap_vs_legacy_worst=worst, busy_ms=busy,
               profiled_wall_ms=[p["wall_ms"] for p in prof])
    q_shape = (rows, S, full.n_heads, full.get_head_dim())
    kv_shape = (rows, S, full.n_kv_heads, full.get_head_dim())
    return dict(totals), (q_shape, kv_shape), out, later


# Phase 21: one compiled trial of the arch sweep a family, at n <= 4 over
# the ranks of the shared pool (``perf.sweep.measure_arch_trial``, mode
# "jit", inductor); the fields are ``perf.sweep.ArchPoint``'s. Inductor's
# compiles, not the steps, set the phase's time: 39-51 s a step on one
# device and 58-86 s on the ranks for fsdp_tp, tp and fsdp points at one
# layer on the H100 (PERF.md). So the moe and ssm points are dp, one layer:
# a rank's rows are the compute probe's sub-batch and its forward graph the
# compute probe's, which the ranks then take from inductor's cache, and
# each rank compiles its update (the reduction over gloo) only. The lm
# point is fsdp_tp at 2 x 2 with int8_ef: the overlap body's gather graph,
# its Megatron splits and streamed gathers under inductor, and the codec on
# every rank. moe with bf16, ssm at d_state 8 (the SSD's CUDA-core design).
# The named --quick run times the other strategies (PERF.md).
ARCH_SWEEP_POINTS = (
    dict(family="lm", arch_id="smollm-360m", seq_len=64, d_model=64, n_layers=1,
         d_ff=128, n_devices=4, batch_size=16, strategy="fsdp_tp",
         compression="int8_ef"),
    dict(family="moe", arch_id="llama4-scout-17b-a16e", seq_len=32, d_model=64,
         n_layers=1, d_ff=64, n_experts=4, top_k=2, n_devices=2, batch_size=8,
         strategy="dp", compression="bf16"),
    dict(family="ssm", arch_id="mamba2-370m", seq_len=64, d_model=64, n_layers=1,
         d_state=8, n_devices=4, batch_size=16, strategy="dp", compression="none"))
# Compiled against eager, every step from the same init: each step's loss
# within ARCH_LOSS_GAP of the eager step's (relative), the parameters after
# the last step within ARCH_PARAM_GAP of the eager ones (each leaf's largest
# |difference| over its largest |value|: 2^-7 is one bf16 rounding there).
# On the H100 80GB HBM3 at 700.00 W these points gave loss gaps up to
# 2.065e-5 and parameter gaps up to 3.953e-3 (one bf16 rounding; PERF.md).
ARCH_LOSS_GAP = 2.0 ** -12
ARCH_PARAM_GAP = 2.0 ** -7
ARCH_SWEEP_ITERS = 2          # timed steps a probe (the reference's n_iters)


def hold_op(torch, TS, what, op, plain, ins, names, go, tol, read, want,
            compiled):
    """A custom op's caller ``op`` of the tensors ``ins`` (leaves needing
    grads; its output the one differentiated), eagerly or inside
    ``TS.compile_fullgraph`` (inductor: the op's fake and its autograd under
    AOT; the compiling call first, then the one checked), against ``plain``
    on the same inputs: the output and every input's grad for the
    cotangent ``go`` within ``tol``, and the launches (``read()``, a
    counter by design) of the checked forward equal to ``want``. Returns
    the largest error."""
    fn = TS.compile_fullgraph(op) if compiled else op
    if compiled:
        fn(*ins)
    before = read()
    out = fn(*ins)
    launched = {d: n - before[d] for d, n in read().items() if n != before[d]}
    got = torch.autograd.grad(out, ins, go)
    ref = plain(*ins)
    wanted = torch.autograd.grad(ref, ins, go)
    torch.cuda.synchronize()
    pairs = [("out", out, ref)] + [(f"d{n}", a, b) for n, a, b in zip(names, got, wanted)]
    errs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in pairs}
    ok = all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol) for _, a, b in pairs)
    how = "compiled" if compiled else "eager"
    print(f"  {what} op {how}: max_abs_err "
          f"{', '.join(f'{n} {e:.3e}' for n, e in errs.items())} tol={tol:g} "
          f"launches {launched} {'ok' if ok else 'FAIL'}", flush=True)
    if launched != want:
        fail(f"{what} op {how} launched {launched}, expected {want}")
    if not ok:
        fail(f"{what} op {how} disagrees with its plain version: {errs}")
    return max(errs.values())


def arch_sweep_shapes(SW, MD, kw):
    """The flash attention and SSD calls a phase-21 point makes: (label,
    (B, Sq, Skv, Hq, Hkv, hd)) for its compute probe (the per-device
    sub-batch) and one rank of its sharded probe (the rows of its data
    shard, the heads of its model shard when heads are local), and (label,
    (b, l, h, p, g, n, chunk)) likewise for an ssm point (l padded to the
    chunk)."""
    point = SW.ArchPoint(**kw)
    cfg = point.model_config()
    mesh = SW.arch_mesh_axes(point.strategy, point.n_devices)
    m = mesh.get("model", 1)
    live = MD.tp_live_axes(cfg, m)
    S = point.seq_len
    subs = (("compute", max(point.batch_size // point.n_devices, 1), 1),
            ("rank", point.batch_size // mesh["data"], m if "heads" in live else 1))
    flash, ssd = [], []
    if subs[1][1:] == subs[0][1:]:               # dp: a rank's calls are the probe's
        subs = subs[:1]
    for where, B, split in subs:
        tag = f"arch_{point.family}_{where}"
        if cfg.ssm is not None:
            s = cfg.ssm
            L = -(-S // s.chunk_size) * s.chunk_size
            ssd.append((tag, (B, L, s.expand * cfg.d_model // s.head_dim, s.head_dim,
                              s.n_groups, s.d_state, s.chunk_size)))
        else:
            flash.append((tag, (B, S, S, cfg.n_heads // split, cfg.n_kv_heads // split,
                                cfg.get_head_dim())))
    return flash, ssd


def arch_sweep_phase(torch, dev, card, pool, env):
    """Phase 21: ``measure_arch_trial`` of each ``ARCH_SWEEP_POINTS`` point on
    ``pool``, with as many eager steps from the same init beside each
    compiled probe. Gates: every step's compiled loss against the eager one
    (``ARCH_LOSS_GAP``) and the parameters after the last step
    (``ARCH_PARAM_GAP``), no graph break (two graphs on one device, three
    on a rank, two for dp), exact launches per step by design counted
    inside the compiled graphs on the card and on every rank, a complete
    row with its sharded column. Returns ({kernel: launches over the
    phase, this process and every rank}, the rows)."""
    from repro_torch.dist import probes
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import model as MD
    from repro_torch.perf import sweep as SW
    from repro_torch.perf.costmodel import DEFAULT_CALIBRATION
    from repro_torch.tree import tree_leaves

    import torch._inductor.config as inductor_config

    phase(f"arch sweep: one compiled trial a family (lm, moe, ssm), sharded probes "
          f"over gloo ranks sharing the card")
    t_phase = time.perf_counter()
    # this process compiles its probe while the ranks wait: all the cores
    # (the pool capped it at cores / world)
    capped, inductor_config.compile_threads = (inductor_config.compile_threads,
                                               os.cpu_count() or 1)
    env.reset_counts()
    pool.run(probes.reset_launches, mesh={"data": pool.world})
    keys = [f.name for f in dataclasses.fields(SW.SweepRow)]
    out_rows = []
    for kw in ARCH_SWEEP_POINTS:
        point = SW.ArchPoint(**kw)
        cfg = point.model_config()
        t0 = time.perf_counter()
        extra = {}
        row = dataclasses.asdict(SW.measure_arch_trial(
            point, "jit", n_iters=ARCH_SWEEP_ITERS, device=dev, pool=pool,
            calibration=DEFAULT_CALIBRATION, extra=extra, eager_check=True))
        wall = time.perf_counter() - t0
        what = f"arch sweep {point.family}"
        if list(row) != keys or row["mode"] != "jit" or row["family"] != point.family:
            fail(f"{what}: row {row}")
        if not (row["measured_ms"] > 0 and row["t_measured_sharded"]
                and row["t_measured_sharded"] > 0 and row["sharded_skip"] is None
                and row["comm_ms"] >= 0 and row["param_bytes"] > 0):
            fail(f"{what}: incomplete row {row}")
        probes_run = [("one device", extra)] + [(f"rank {r}", x)
                                                for r, x in enumerate(extra["sharded"])]
        loss_gap = param_gap = 0.0
        for where, x in probes_run:
            if not len(x["losses"]) == len(x["eager_losses"]) == 1 + ARCH_SWEEP_ITERS:
                fail(f"{what} {where}: {x['losses']} compiled vs {x['eager_losses']} "
                     f"eager losses")
            for i, (got, want) in enumerate(zip(x["losses"], x["eager_losses"])):
                gap = abs(got - want) / abs(want)
                loss_gap = max(loss_gap, gap)
                if gap > ARCH_LOSS_GAP:
                    fail(f"{what} {where} step {i}: compiled loss {got} vs eager {want}")
            param_gap = max(param_gap, x["param_gap"])
            if x["param_gap"] > ARCH_PARAM_GAP:
                fail(f"{what} {where}: compiled parameters {x['param_gap']} from the "
                     f"eager ones after {len(x['losses'])} steps")
        if extra["graph_breaks"] or extra["graphs"] != 2:
            fail(f"{what}: the compiled step took {extra['graphs']} graphs, "
                 f"{extra['graph_breaks']} breaks (expected 2, 0)")
        # gathers, forward, update; dp gathers nothing, so no graph for that
        want_graphs = 2 if point.strategy == "dp" else 3
        for r, x in enumerate(extra["sharded"]):
            if x["graph_breaks"] or x["graphs"] != want_graphs:
                fail(f"{what} rank {r}: the compiled overlap body took {x['graphs']} "
                     f"graphs, {x['graph_breaks']} breaks (expected {want_graphs}, 0)")
        # by design, per step: one flash call (CUDA-core: head_dim below 64)
        # per attention layer, one SSD call (CUDA-core at d_state 8) per
        # Mamba2 layer, forward only (the backward recomputes the plain
        # version); under int8_ef one absmax and one quantize per parameter
        # tensor on every rank (the reduction, one scale per reference leaf)
        attn = 0 if cfg.ssm is not None else cfg.n_layers
        ssm = cfg.n_layers if cfg.ssm is not None else 0
        n_tensors = len(tree_leaves(MD.param_shapes(cfg)))
        codec = n_tensors if point.compression == "int8_ef" else 0
        want_dev = {"flash_attention": attn, "quantize_absmax": 0, "quantize_int8": 0,
                    "dequantize_int8": 0, "ssd_scan": ssm,
                    "flash_by_design": {v: (attn if v == "cuda_core" else 0)
                                        for v in FA.VARIANTS},
                    "ssd_by_design": {v: (ssm if v == "cuda_core" else 0)
                                      for v in SSD.VARIANTS}}
        want_rank = {**want_dev, "quantize_absmax": codec, "quantize_int8": codec}
        if extra["launches"] != want_dev:
            fail(f"{what}: the compiled step launched {extra['launches']} a step, "
                 f"expected {want_dev}")
        for r, x in enumerate(extra["sharded"]):
            if x["launches"] != want_rank:
                fail(f"{what} rank {r}: the compiled overlap body launched "
                     f"{x['launches']} a step, expected {want_rank}")
        sh_compile = max(x["warmup_s"] for x in extra["sharded"])
        print(f"  {point.family:3s} {point.strategy:7s} n={point.n_devices} "
              f"{point.compression:7s} batch {point.batch_size} seq {point.seq_len}: "
              f"measured_ms {row['measured_ms']:.3f}, t_measured_sharded "
              f"{row['t_measured_sharded']:.3f} ms, comm_ms {row['comm_ms']:.4f} "
              f"(default link), t_simulated {row['t_simulated']:.3f} ms; compile "
              f"{extra['compile_s']:.1f} s (one device) + {sh_compile:.1f} s (ranks); "
              f"losses compiled {extra['losses']} vs eager {extra['eager_losses']} "
              f"(one device), rank 0 {extra['sharded'][0]['losses']} vs "
              f"{extra['sharded'][0]['eager_losses']}: largest gap {loss_gap:.3e} "
              f"(limit {ARCH_LOSS_GAP:.3e}), parameters {param_gap:.3e} (limit "
              f"{ARCH_PARAM_GAP:.3e}); "
              f"launches a step {want_rank}; {wall:.1f} s; card {card}", flush=True)
        out_rows.append({"point": kw, "row": row, "compile_s": extra["compile_s"],
                         "sharded_compile_s": sh_compile, "wall_s": wall,
                         "loss_gap": loss_gap, "param_gap": param_gap})
    inductor_config.compile_threads = capped
    mine = env.read_counts()
    ranks = pool.run(probes.read_launches, mesh={"data": pool.world})
    counts = {k: mine[k] + sum(r[k] for r in ranks[1:]) for k in mine}
    print(f"  launches over the phase (this process and every rank) {counts}; phase "
          f"21 took {time.perf_counter() - t_phase:.1f} s; card {card}", flush=True)
    return counts, out_rows


# Phase 22: the planner. (a) ``launch.plan --dry-run --k 10`` with the
# checked-in model and calibration gated on the reference's plan (its live
# output is pinned to these constants by a CPU test): the space, feasible
# and frontier counts and the top-10 keys in order; then the fail-soft plan
# (the model's calibration stripped, ``$REPRO_CALIBRATION`` at a missing
# file), marked uncalibrated. (b) two picks of that plan (its top pick,
# int8, and the best pick without a codec) measured on phase 15's pool by
# ``launch.plan.measure_slate``: a compile (one warm-up iteration) and
# PLAN_ROUNDS x PLAN_ITERS timed iterations a pick, each with phase 15 (b)'s
# codec launches per rank per int8 iteration. (c) ``launch.train --strategy
# auto --report-comm`` of full-width smollm-360m over 4 ranks (adamw +
# int8_ef, batch 8 x 512, AUTO_STEPS steps): the strategy it ran is
# ``choose_strategy``'s on the same inputs, recomputed here; its ``planner``
# and ``comm`` reports; losses finite and falling; exact launches for the
# strategy chosen.
PLAN_SPACE, PLAN_FEASIBLE, PLAN_FRONTIER = 240, 240, 16
PLAN_TOP10 = (("dp", 2, 128, "int8"), ("dp", 4, 128, "int8"),
              ("fsdp", 2, 128, "int8"), ("dp", 8, 128, "int8"),
              ("fsdp", 4, 128, "int8"), ("fsdp", 8, 128, "int8"),
              ("fsdp_tp", 4, 128, "int8"), ("fsdp_tp", 8, 128, "int8"),
              ("fsdp_tp", 2, 128, "int8"), ("tp", 2, 128, "int8"))
PLAN_ITERS, PLAN_ROUNDS = 2, 2
AUTO_STEPS = 3
AUTO_LAYERS = 8     # phase 22 (c)'s depth cut, for phase 24's time


def _check_plan(plan, calibrated, what):
    """tools/planner_smoke.py's contract of a dry-run plan."""
    problems = []
    if not plan["feasible"] > 0 or not plan["frontier_size"] >= 1 or not plan["frontier"]:
        problems.append("no feasible point or an empty frontier")
    if len(plan["top"]) < 8:
        problems.append(f"slate of {len(plan['top'])}")
    for p in plan["top"]:
        if not (p["time_ms"] > 0 and p["compute_ms"] > 0
                and p["band_ms"][0] <= p["time_ms"] <= p["band_ms"][1]
                and p["memory"]["total_per_device"] > 0):
            problems.append(f"pick {p['strategy']} {p['n_devices']}: {p['time_ms']}")
    if plan["calibrated"] != calibrated:
        problems.append(f"calibrated {plan['calibrated']} ({plan['calibration']})")
    if not plan["frontier"][0]["time_ms"] <= plan["top"][0]["time_ms"] + 1e-9:
        problems.append("the frontier's fastest point does not lead the slate")
    if problems:
        fail(f"{what}: {problems}")


def planner_plan_phase(dev, card):
    """Phase 22 (a): the plan CLI's dry run on the card, then its fail-soft
    plan. Returns the plan."""
    import warnings

    from repro_torch.launch import plan as PL
    from repro_torch.perf.planner import default_model_path

    phase("planner: launch.plan --dry-run --k 10 (checked-in model and calibration), "
          "then the fail-soft plan")
    t0 = time.perf_counter()
    blob = PL.main(["--dry-run", "--k", "10", "--device", dev.type])
    plan_s = time.perf_counter() - t0
    _check_plan(blob, True, "plan")
    top = tuple(tuple(p[k] for k in ("strategy", "n_devices", "batch_size",
                                     "compression")) for p in blob["top"])
    got = (blob["space"], blob["feasible"], blob["frontier_size"], top)
    if got != (PLAN_SPACE, PLAN_FEASIBLE, PLAN_FRONTIER, PLAN_TOP10):
        fail(f"plan {got[:3]} top {top}, expected the reference's "
             f"{(PLAN_SPACE, PLAN_FEASIBLE, PLAN_FRONTIER)} top {PLAN_TOP10}")
    with open(default_model_path()) as f:
        stripped = json.load(f)
    stripped["calibration"] = None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "planner_model_nocal.json")
        with open(path, "w") as f:
            json.dump(stripped, f)
        with unittest.mock.patch.dict(os.environ, {
                "REPRO_CALIBRATION": os.path.join(tmp, "missing.json")}), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t1 = time.perf_counter()
            blob2 = PL.main(["--dry-run", "--k", "10", "--device", dev.type,
                             "--model", path])
            soft_s = time.perf_counter() - t1
    _check_plan(blob2, False, "fail-soft plan")
    print(f"  plan: {blob['space']} points, {blob['feasible']} feasible, "
          f"{blob['frontier_size']} on the frontier, top-10 the reference's; "
          f"calibration {blob['calibration']}; top pick {top[0]} predicted "
          f"{blob['top'][0]['time_ms']:.4f} ms (the reference's model of its host "
          f"pool); plan {plan_s:.2f} s (planner_plan's plan_seconds "
          f"{blob['plan_seconds']}); fail-soft plan calibration "
          f"{blob2['calibration']} (calibrated {blob2['calibrated']}), "
          f"{soft_s:.2f} s; card {card}", flush=True)
    return blob


def planner_measure_phase(torch, dev, card, pool):
    """Phase 22 (b): two picks of the plan measured through
    ``launch.plan.measure_slate`` on phase 15's pool, with exact codec
    launches on every rank. Returns (launches over the ranks, numbers)."""
    import numpy as np

    from repro_torch.configs.lenet5 import LeNet5Config
    from repro_torch.dist import probes
    from repro_torch.launch import plan as PL
    from repro_torch.perf.planner import (Constraints, PlannerModel,
                                          enumerate_lenet_space, predict_points,
                                          top_k, validation_slate)

    phase(f"planner: two picks measured by launch.plan.measure_slate on phase 15's "
          f"pool of {pool.world} ({PLAN_ROUNDS} rounds x {PLAN_ITERS} iterations)")
    t0 = time.perf_counter()
    model = PlannerModel.load(device=dev)
    feasible, _ = enumerate_lenet_space(LeNet5Config(), pool=pool.world)
    preds = predict_points(model, feasible)
    first = validation_slate(preds, 1)[0]
    plain = top_k(preds, 1, constraints=Constraints(compressions=("none",)))[0]
    picks = [first, plain]
    if first.point.compression != "int8":
        fail(f"the plan's top pick {first.point.key()} is not int8")
    world = {"data": pool.world}
    pool.run(probes.reset_launches, mesh=world)
    measured = PL.measure_slate(picks, PLAN_ITERS, PLAN_ROUNDS, pool)
    per_rank = pool.run(probes.read_launches, mesh=world)
    iterations = 1 + PLAN_ROUNDS * PLAN_ITERS
    for r, got in enumerate(per_rank):
        calls = sum(iterations * _codec_calls(p.point.strategy, p.point.n_devices)
                    for p in picks
                    if p.point.compression == "int8" and r < p.point.n_devices)
        if (got["quantize_absmax"], got["quantize_int8"], got["dequantize_int8"],
                got["flash_attention"], got["ssd_scan"]) != (calls, calls, 0, 0, 0):
            fail(f"measure_slate: rank {r} launched {got}, expected {calls} absmax + "
                 f"{calls} quantize")
    if not all(np.isfinite(m) and m > 0 for m in measured):
        fail(f"measure_slate: fixed-work ms {measured}")
    launches = {k: sum(c[k] for c in per_rank) for k in per_rank[0]}
    numbers = {"picks": [p.point.key() for p in picks],
               "predicted_ms": [p.time_ms for p in picks], "measured_ms": measured}
    print(f"  picks {numbers['picks']}: fixed-work ms measured {measured} vs predicted "
          f"{numbers['predicted_ms']} (the reference's model); launches over the "
          f"ranks {launches} ({iterations} iterations a pick, {_codec_calls('dp', 2)} "
          f"absmax + quantize a rank per int8 iteration); "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    return launches, numbers


def auto_train_phase(torch, dev, card, pool):
    """Phase 22 (c): ``launch.train --strategy auto --report-comm`` of
    smollm-360m at full width on ``AUTO_LAYERS`` of its 32 layers over 4
    ranks of ``pool``. Returns ({kernel:
    launches summed over ranks and steps}, numbers)."""
    import numpy as np

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.models import model as MD
    from repro_torch.perf.planner import choose_strategy
    from repro_torch.tree import tree_leaves

    full, registry, _, cut = _lm_config(TRAIN_ARCH, AUTO_LAYERS)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, SHARDED_LM_RANKS
    mesh = plan_remesh(n).axes()
    phase(f"planner: launch.train --strategy auto --report-comm --devices {n} "
          f"(mesh {mesh}), {TRAIN_ARCH}{cut}, adamw + int8_ef, batch {B} x "
          f"seq {S}, {AUTO_STEPS} steps")
    t0 = time.perf_counter()
    decision = choose_strategy(full, batch=B, seq=S, n_devices=n, optimizer="adamw",
                               compression="int8_ef", mesh_axes=mesh)
    with registry:
        report = train.main(["--arch", TRAIN_ARCH, "--devices", str(n), "--strategy",
                             "auto", "--report-comm", "--compression", "int8_ef",
                             "--optimizer", "adamw", "--batch", str(B), "--seq", str(S),
                             "--steps", str(AUTO_STEPS), "--device", dev.type,
                             "--log-every", "1"], pool=pool)
    run_s = time.perf_counter() - t0
    _check_param_count(report, full, "--strategy auto train")
    if report["strategy"] != decision.strategy or report["path"] != "sharded":
        fail(f"--strategy auto ran {report['strategy']} on path {report['path']}, "
             f"the planner chose {decision.strategy}")
    if "planner" not in report or "comm" not in report:
        fail(f"--strategy auto --report-comm report lacks planner/comm: {sorted(report)}")
    if report["planner"] != decision.to_dict():
        fail(f"the report's planner {report['planner']} is not choose_strategy's")
    losses = report["losses"]
    if (len(losses) != AUTO_STEPS or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        fail(f"--strategy auto losses not finite and falling: {losses}")
    rows = B // mesh["data"]          # every strategy's batch splits over data
    designs, n_flash, _ = _train_work(MD, FA, full, rows, S, "none", torch.bfloat16, 1)
    n_tensors = len(tree_leaves(MD.param_shapes(full)))
    want = {"flash_attention": n_flash, "quantize_absmax": n_tensors,
            "quantize_int8": n_tensors, "dequantize_int8": 0, "ssd_scan": 0,
            "flash_by_design": {v: designs.get(v, 0) for v in FA.VARIANTS}}
    totals = collections.Counter()
    for r in report["ranks"]:
        for step, got in enumerate(r["launches_per_step"]):
            if got != want:
                fail(f"--strategy auto rank {r['rank']} step {step} launched {got}, "
                     f"expected {want}")
            totals.update({k: v for k, v in got.items() if k != "flash_by_design"})
    regions = {k: [round(r["regions_ms"][k], 3) for r in report["ranks"]]
               for k in report["ranks"][0]["regions_ms"]}
    comm_meas = [round(r["regions_ms"]["gather_params"] + r["regions_ms"]["grad_reduce"],
                       3) for r in report["ranks"]]
    numbers = {"strategy": decision.strategy, "reason": decision.reason,
               "planner_comm_ms": decision.comm_ms,
               "comm_estimate_ms": report["comm"]["per_step_ms"],
               "calibration": decision.calibration_label,
               "measured_gather_plus_reduce_ms": comm_meas, "regions_ms": regions,
               "step_ms": report["step_ms"], "losses": losses,
               "launches_per_rank_step": want}
    print(f"  planner: {decision.strategy} ({decision.reason}); calibration "
          f"{decision.calibration_label}; predicted comm {decision.comm_ms:.3f} ms a "
          f"step (--report-comm {report['comm']['per_step_ms']:.3f} over "
          f"{report['comm']['mesh_axes']}) vs measured gather_params + grad_reduce "
          f"{comm_meas} ms a rank (median of steps 1..); regions {regions}; step_ms "
          f"{report['step_ms']}; losses {[round(x, 4) for x in losses]}; launches per "
          f"rank per step {want}; run {run_s:.1f} s; card {card}", flush=True)
    return dict(totals), numbers


# Phase 23: sharded serving and the GSPMD train step over ranks sharing the
# card. (a) ``launch.serve --strategy tp --devices 4``: full-width
# qwen2.5-3b at mesh (2, 2), bf16, batch 4, prompt 32, gen 32 (16/2 q heads
# and 2/2 kv heads live, the MLP split, each rank on its 2 rows) on the pool
# of 4, fed phase 6's tokens in place of its own picks (teacher forcing), so
# that every generated step, which writes and reads cache slots 32..63, is
# held to phase 6's run on the same inputs: each step's fp32 logits within
# TP_SERVE_TOL (absolute; 8 bf16 ulps at |logit| 4..8, where phase 7
# measured 8.0e-2 between two orders of the same bf16 model), each picked
# token's phase-6 logit within 2 TP_SERVE_TOL and a bf16 ulp of phase 6's
# largest (what logits within TP_SERVE_TOL imply), and exactly 36 split_kv
# flash launches a decode step a rank, nothing else launched. (b)
# ``launch.serve.serve_rank`` on phase 15's pool of 8: qwen2.5-3b on
# SERVE_FP32_LAYERS of its 36 layers in fp32 (weights and caches), fsdp_tp
# at (2, 4): 2 kv heads do not divide 4, so attention is whole on each rank
# and the MLP is split; its fp32 logits (before the bf16 cast) at every
# generated step within SERVE_FP32_TOL (atol and rtol) of a single-device
# fp32 run of the same cut config on the card, the tokens equal, flash on
# the CUDA-core design only. (c) ``launch.train --devices 4 --mode gspmd
# --strategy fsdp_tp``: full-width smollm-360m, batch 8 x seq 512, adamw +
# int8_ef, GSPMD_STEPS steps on 4 ranks of the pool; each loss within
# GSPMD_LOSS_TOL (absolute) of phase 8's loss at the same step (the same
# config and lr schedule): tighter than phase 20's tier (1e-5 + |loss|/256,
# ~0.043) and three times the largest gap of two sound runs (1.6e-3, chip
# runs 1 and 3 of the slice that added this phase). AdamW after the clip
# barely depends on the gradients' scale, so the losses alone would pass a
# mean taken as a sum; each step's grad norm (before the clip) is held too,
# within GSPMD_GNORM_RTOL (relative) of phase 8's: the sound runs' largest
# gap is 2.7e-3, a sum over the 2 data ranks doubles it. Per rank and step
# exactly 32 tile flash launches (its 4 rows) and one absmax, quantize and
# dequantize launch per parameter tensor (290: the codec on the state's
# slices, as phase 8 counts a single-device step).
TP_SERVE_TOL = 0.25
SERVE_FP32_LAYERS, SERVE_FP32_GEN, SERVE_FP32_TOL = 4, 8, 1e-4
GSPMD_STEPS = TRAIN_STEPS_BY_ARCH[TRAIN_ARCH]
GSPMD_LOSS_TOL, GSPMD_GNORM_RTOL = 5e-3, 2e-2


def _rank_sums(ranks, key="launches"):
    """Launch counts summed over the ranks (flash by design apart)."""
    totals, designs = collections.Counter(), collections.Counter()
    for r in ranks:
        got = r[key]
        totals.update({k: v for k, v in got.items() if isinstance(v, int)})
        designs.update(got.get("flash_by_design", {}))
    return dict(totals), dict(designs)


def _serve_launch_gate(ranks, want_flash, design, what):
    """Every rank launched ``want_flash`` flash calls, all of ``design``,
    and nothing else."""
    for r in ranks:
        got = r["launches"]
        counts = {k: v for k, v in got.items() if isinstance(v, int)}
        want = {k: 0 for k in counts}
        want["flash_attention"] = want_flash
        want_designs = {k: 0 for k in got["flash_by_design"]}
        want_designs[design] = want_flash
        if counts != want or got["flash_by_design"] != want_designs:
            fail(f"{what}: rank {r['rank']} launched {got}, expected {want} with flash "
                 f"by design {want_designs}")


def sharded_serve_phase(torch, dev, card, pool):
    """Phase 23 (a), on 4 ranks of the pool. Returns (launches summed over the
    ranks, flash launches by design, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import probes
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import plan_remesh

    full = get_config(ARCH)
    n = SHARDED_LM_RANKS
    mesh = plan_remesh(n).axes()
    phase(f"sharded serving: launch.serve --strategy tp --devices {n} (mesh {mesh}), "
          f"{ARCH} at full width, bf16, batch {BATCH}, prompt {PROMPT}, gen {GEN}, on "
          f"{n} ranks of the pool")
    pool.run(probes.release_memory, mesh=mesh)
    t0 = time.perf_counter()
    one_tokens, one_logits = SERVED[ARCH]
    served = serve.main(["--arch", ARCH, "--strategy", "tp", "--devices", str(n),
                         "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen",
                         str(GEN), "--device", dev.type], pool=pool, keep_logits=True,
                        forced=one_tokens)
    run_s = time.perf_counter() - t0
    rep = served.report
    if (rep["strategy"], rep["mesh"], rep["devices"]) != ("tp", [2, 2], n):
        fail(f"sharded serve ran {rep['strategy']} on mesh {rep['mesh']} over "
             f"{rep['devices']} devices")
    want_pool = {"ranks": n, "backend": "gloo", "cards": 1}
    if rep["pool"] != want_pool:
        fail(f"sharded serve pool {rep['pool']}, expected {want_pool}")
    ranks = rep["ranks"]
    if [r["device"] for r in ranks] != [torch.cuda.get_device_name(0)] * n:
        fail(f"sharded serve ranks ran on {[r['device'] for r in ranks]}")
    steps = PROMPT + GEN
    _serve_launch_gate(ranks, full.n_layers * steps, "split_kv", "sharded serve")
    if len(served.step_logits) != GEN or len(one_logits) != GEN:
        fail(f"sharded serve kept {len(served.step_logits)} steps' logits, phase 6 "
             f"{len(one_logits)}, expected {GEN}")
    errs = []
    for t in range(GEN):
        got, want = served.step_logits[t].float(), one_logits[t]
        errs.append((got - want).abs().max().item())
        if not errs[-1] <= TP_SERVE_TOL:
            fail(f"sharded serve step {t}: fp32 logits differ from phase 6's by "
                 f"{errs[-1]:.3e} > {TP_SERVE_TOL}")
        top = want.max(dim=-1).values
        picked = want.gather(-1, served.tokens[:, t:t + 1].long())[:, 0]
        slack = 2 * TP_SERVE_TOL + (top.abs() + TP_SERVE_TOL) * 2.0 ** -7
        if not bool((picked >= top - slack).all()):
            fail(f"sharded serve step {t}: picked {served.tokens[:, t].tolist()}, whose "
                 f"phase-6 logits {picked.tolist()} are below phase 6's largest "
                 f"{top.tolist()} by more than {slack.tolist()}")
    err = max(errs)
    agree = (served.tokens == one_tokens).float().mean().item()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    peaks = [r["peak_mem_bytes"] or 0 for r in ranks]
    if not sum(peaks) < card_bytes:
        fail(f"sharded serve ranks' peak memory {sum(peaks)} is not under the card's")
    numbers = {"prefill_s": rep["prefill_s"], "decode_s": rep["decode_s"],
               "decode_tok_per_s": rep["decode_tok_per_s"],
               "decode_ms_per_step": [round(r["decode_ms_per_step"], 3) for r in ranks],
               "peak_mem_bytes": peaks,
               "bytes": {k: ranks[0][k] for k in ("resident_param_bytes",
                                                  "spec_param_bytes",
                                                  "resident_cache_bytes",
                                                  "spec_cache_bytes")},
               "step_logits_max_abs_err": [round(e, 6) for e in errs],
               "token_agreement": agree, "run_s": run_s}
    print(f"  fed phase 6's tokens: fp32 logits vs phase 6's, max |d| a step "
          f"{[f'{e:.3e}' for e in errs]} (max {err:.3e}, tol {TP_SERVE_TOL}) over all "
          f"{GEN} steps; picks within 2 tol + a bf16 ulp of phase 6's best, equal to "
          f"phase 6's tokens at {agree:.3f} of the steps; "
          f"{full.n_layers} split_kv launches a step a rank, nothing else; prefill_s "
          f"{rep['prefill_s']} decode_s {rep['decode_s']} decode_tok_per_s "
          f"{rep['decode_tok_per_s']}; decode ms a step per rank "
          f"{numbers['decode_ms_per_step']}; per-rank peak_mem_GB "
          f"{[round(p / 1e9, 2) for p in peaks]}; bytes a rank holds vs the "
          f"reference's specs {numbers['bytes']}; run {run_s:.1f} s; card {card}",
          flush=True)
    counts, designs = _rank_sums(ranks)
    return counts, designs, numbers


def serve_fp32_phase(torch, dev, card, pool):
    """Phase 23 (b), on phase 15's pool of 8. Returns (launches summed over
    the ranks, flash launches by design, numbers)."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch_for
    from repro_torch.dist import probes
    from repro_torch.launch import serve
    from repro_torch.models import model as MD
    from repro_torch.train import serve as TSV

    mesh = {"data": 2, "model": 4}
    full = get_config(ARCH)
    cut = dataclasses.replace(full, n_layers=SERVE_FP32_LAYERS, dtype="float32",
                              param_dtype="float32")
    gen = SERVE_FP32_GEN
    phase(f"sharded serving: serve_rank on phase 15's pool of 8, {ARCH} at full width "
          f"({SERVE_FP32_LAYERS} of {full.n_layers} layers), fp32, fsdp_tp at mesh "
          f"{mesh}, batch {BATCH}, prompt {PROMPT}, gen {gen}, vs one device")
    t0 = time.perf_counter()
    with torch.no_grad():
        params = MD.init_model(cut, seed=0, device=dev)
        prompt = make_batch_for(cut, BATCH, PROMPT)["tokens"].to(dev)
        caches = MD.init_decode_caches(cut, BATCH, PROMPT + gen, dtype=torch.float32,
                                       device=dev)
        one = TSV.decode_loop(params, cut, caches, prompt, gen, keep_logits=True)
        one_tokens = one.tokens.cpu()
        one_logits = [x.cpu() for x in one.step_logits]
        del params, caches, one
    torch.cuda.empty_cache()
    pool.run(probes.release_memory, mesh=mesh)
    args = argparse.Namespace(batch=BATCH, prompt_len=PROMPT, gen=gen, seed=0,
                              strategy="fsdp_tp")
    ranks = pool.run(serve.serve_rank, cut, args, None, True, torch.float32, mesh=mesh)
    tokens = torch.from_numpy(serve.assemble_rows(ranks, "tokens", BATCH))
    if not torch.equal(tokens, one_tokens):
        fail(f"fp32 sharded serve tokens {tokens.tolist()} differ from one device's "
             f"{one_tokens.tolist()}")
    err = 0.0
    for i in range(gen):
        got = torch.from_numpy(serve.assemble_rows(
            [{**r, "lf": r["step_logits"][i]} for r in ranks], "lf", BATCH))
        err = max(err, (got - one_logits[i]).abs().max().item())
        if not torch.allclose(got, one_logits[i], atol=SERVE_FP32_TOL, rtol=SERVE_FP32_TOL):
            fail(f"fp32 sharded serve step {i}: logits differ from one device's by "
                 f"{(got - one_logits[i]).abs().max().item():.3e}")
    _serve_launch_gate(ranks, SERVE_FP32_LAYERS * (PROMPT + gen), "cuda_core",
                       "fp32 sharded serve")
    run_s = time.perf_counter() - t0
    numbers = {"max_abs_err": err, "decode_ms_per_step": [
        round(r["decode_ms_per_step"], 3) for r in ranks],
        "bytes": {k: ranks[0][k] for k in ("resident_param_bytes", "spec_param_bytes",
                                           "resident_cache_bytes", "spec_cache_bytes")},
        "run_s": run_s}
    print(f"  fp32 logits at {gen} generated steps vs one device: max |d| {err:.3e} "
          f"(atol = rtol = {SERVE_FP32_TOL}); tokens equal; {SERVE_FP32_LAYERS} cuda_core "
          f"flash launches a step a rank, nothing else; decode ms a step per rank "
          f"{numbers['decode_ms_per_step']}; bytes a rank holds vs the reference's specs "
          f"{numbers['bytes']}; {run_s:.1f} s; card {card}", flush=True)
    counts, designs = _rank_sums(ranks)
    return counts, designs, numbers


def gspmd_train_phase(torch, dev, card, pool):
    """Phase 23 (c), on 4 ranks of the pool. Returns (launches summed over ranks
    and steps, numbers)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist import probes
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train
    from repro_torch.launch.mesh import plan_remesh
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves

    full = get_config(TRAIN_ARCH)
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, SHARDED_LM_RANKS
    mesh = plan_remesh(n).axes()
    phase(f"GSPMD train step: launch.train --devices {n} --mode gspmd --strategy "
          f"{SHARDED_LM_STRATEGY} (mesh {mesh}), {TRAIN_ARCH} at full width, adamw + "
          f"int8_ef, batch {B} x seq {S}, {GSPMD_STEPS} steps, on {n} ranks of the pool")
    pool.run(probes.release_memory, mesh=mesh)
    t0 = time.perf_counter()
    report = train.main(["--arch", TRAIN_ARCH, "--devices", str(n), "--mode", "gspmd",
                         "--strategy", SHARDED_LM_STRATEGY, "--compression", "int8_ef",
                         "--optimizer", "adamw", "--batch", str(B), "--seq", str(S),
                         "--steps", str(GSPMD_STEPS), "--device", dev.type,
                         "--log-every", "1"], pool=pool)
    run_s = time.perf_counter() - t0
    if ((report["path"], report["path_reason"]) != ("gspmd", "requested")
            or report["mesh"] != [mesh["data"], mesh["model"]]):
        fail(f"gspmd train ran path {report['path']} ({report['path_reason']}) on mesh "
             f"{report['mesh']}")
    if [r["device"] for r in report["ranks"]] != [torch.cuda.get_device_name(0)] * n:
        fail(f"gspmd train ranks ran on {[r['device'] for r in report['ranks']]}")
    losses, gnorms = report["losses"], report["grad_norm"]
    single, single_gnorms = (x[:GSPMD_STEPS] for x in TRAINED[TRAIN_ARCH])
    if (len(losses) != GSPMD_STEPS or len(gnorms) != GSPMD_STEPS
            or not all(np.isfinite(losses + gnorms))):
        fail(f"gspmd train losses or grad norms not finite: {losses}, {gnorms}")
    diffs = [abs(a - b) for a, b in zip(losses, single)]
    if any(d > GSPMD_LOSS_TOL for d in diffs):
        fail(f"gspmd train losses {losses} vs phase 8's {single}: |d| {diffs} past "
             f"{GSPMD_LOSS_TOL}")
    gdiffs = [abs(a - b) / b for a, b in zip(gnorms, single_gnorms)]
    if any(d > GSPMD_GNORM_RTOL for d in gdiffs):
        fail(f"gspmd train grad norms {gnorms} vs phase 8's {single_gnorms}: relative "
             f"|d| {gdiffs} past {GSPMD_GNORM_RTOL}")
    rows = B // mesh["data"]
    designs, n_flash, _ = _train_work(MD, FA, full, rows, S, "none", torch.bfloat16, 1)
    n_tensors = len(tree_leaves(MD.param_shapes(full)))
    want = {"flash_attention": n_flash, "quantize_absmax": n_tensors,
            "quantize_int8": n_tensors, "dequantize_int8": n_tensors, "ssd_scan": 0,
            "flash_by_design": {v: designs.get(v, 0) for v in FA.VARIANTS}}
    totals = collections.Counter()
    for r in report["ranks"]:
        for step, got in enumerate(r["launches_per_step"]):
            if got != want:
                fail(f"gspmd train rank {r['rank']} step {step} launched {got}, "
                     f"expected {want}")
            totals.update({k: v for k, v in got.items() if k != "flash_by_design"})
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    peaks = [r["peak_mem_bytes"] or 0 for r in report["ranks"]]
    if not sum(peaks) < card_bytes:
        fail(f"gspmd train ranks' peak memory {sum(peaks)} is not under the card's")
    regions = {k: [round(r["regions_ms"][k], 3) for r in report["ranks"]]
               for k in report["ranks"][0]["regions_ms"]}
    transient = report["ranks"][0]["transient_bytes"]
    numbers = {"losses": losses, "single_losses": single, "loss_diffs": diffs,
               "grad_norms": gnorms, "single_grad_norms": single_gnorms,
               "grad_norm_rel_diffs": gdiffs,
               "step_ms": report["step_ms"], "tokens_per_s": report["tokens_per_s"],
               "regions_ms": regions, "peak_mem_bytes": peaks,
               "transient_bytes": transient, "launches_per_rank_step": want,
               "run_s": run_s}
    print(f"  losses {[round(x, 5) for x in losses]} vs phase 8's "
          f"{[round(x, 5) for x in single]}: |d| {[f'{d:.3e}' for d in diffs]} (tol "
          f"{GSPMD_LOSS_TOL}); grad norms {[round(x, 5) for x in gnorms]} vs phase 8's "
          f"{[round(x, 5) for x in single_gnorms]}: relative |d| "
          f"{[f'{d:.3e}' for d in gdiffs]} (tol {GSPMD_GNORM_RTOL}); launches per rank "
          f"per step {want}; step_ms "
          f"{report['step_ms']} tokens_per_s {report['tokens_per_s']}; per-rank region "
          f"ms (median of steps 1..) {regions}; per-rank peak_mem_GB "
          f"{[round(p / 1e9, 2) for p in peaks]} (sum {round(sum(peaks) / 1e9, 2)}); "
          f"transient bytes a rank (beyond its state's slices) {transient}; run "
          f"{run_s:.1f} s; card {card}", flush=True)
    return dict(totals), numbers


# Phase 24 (c): the supervised failure drill on the pool of 8. smollm-360m at
# full width on a depth cut (a full-depth fp32 AdamW state is ~4.3 GB a
# checkpoint), fp32, batch 8 x seq 128, no codec, 6 steps: fsdp on 8 ranks,
# a checkpoint every 2 steps, 4 ranks lost at step 4, recovery onto tp on 4,
# the first 2 checkpoint writes failing (transient OSError), the survivors'
# program prebuilt in the background. Its losses against an uninterrupted
# fsdp run within the reference's tier (tests/test_elastic.py).
DRILL_LAYERS, DRILL_BATCH, DRILL_SEQ, DRILL_STEPS = 4, 8, 128, 6
DRILL_FAIL, DRILL_EVERY, DRILL_FAULTS = 4, 2, 2
COVERAGE_TOL = 0.10                        # a step's children within 10 %


def _spans_gate(data, n_steps, what):
    """One ``step`` span a step with ``data``, ``dispatch`` and ``wait``
    children summing to within COVERAGE_TOL of it, after the first;
    returns the per-step coverage and the children's mean ms."""
    steps = data.find("step")
    if len(steps) != n_steps:
        fail(f"{what}: {len(steps)} step spans for {n_steps} steps")
    cover, child_ms = [], collections.defaultdict(list)
    for i, s in enumerate(steps):
        kids = data.children_of(s)
        if sorted(k.name for k in kids) != ["data", "dispatch", "wait"]:
            fail(f"{what}: step {i}'s children are {[k.name for k in kids]}")
        c = sum(k.duration_s for k in kids) / s.duration_s
        cover.append(round(c, 4))
        for k in kids:
            child_ms[k.name].append(k.duration_s * 1e3)
        if i > 0 and abs(1 - c) > COVERAGE_TOL:
            fail(f"{what}: step {i}'s children cover {c:.4f} of it")
    return cover, {k: round(statistics.mean(v[1:] or v), 3) for k, v in child_ms.items()}


def failure_drill_phase(torch, dev, card, pool):
    """Phase 24 (c), on the pool of 8: the supervised failure drill, the
    fatal write, then ``launch.elastic --quick``. Returns (launches summed
    over ranks and steps, flash by design, numbers)."""
    import shutil

    from repro_torch.dist import probes
    from repro_torch.launch import elastic, train
    from repro_torch.obs import read_jsonl
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.supervisor import RetryPolicy, Supervisor

    import numpy as np
    tol = float(256 * np.spacing(np.float32(8.0)))      # tests/test_elastic.py:450
    full, registry, _, cut = _lm_config(TRAIN_ARCH, DRILL_LAYERS)
    phase(f"failure drill: launch.train {TRAIN_ARCH}{cut}, fp32, batch {DRILL_BATCH} x "
          f"seq {DRILL_SEQ}, {DRILL_STEPS} steps, fsdp on {SHARDED_WORLD} ranks, a "
          f"checkpoint every {DRILL_EVERY}, {SHARDED_WORLD // 2} ranks lost at step "
          f"{DRILL_FAIL}, recovery onto tp, {DRILL_FAULTS} write faults, survivors "
          f"prebuilt (phase 24 c)")
    t_phase = time.perf_counter()
    pool.run(probes.release_memory, mesh={"data": SHARDED_WORLD})
    base = ["--arch", TRAIN_ARCH, "--devices", str(SHARDED_WORLD), "--strategy", "fsdp",
            "--dtype", "float32", "--batch", str(DRILL_BATCH), "--seq", str(DRILL_SEQ),
            "--steps", str(DRILL_STEPS), "--device", dev.type, "--log-every", "1"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    ckpt_dir, trace_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "trace")
    try:
        with registry:
            t0 = time.perf_counter()
            ref = train.main(base, pool=pool)
            ref_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            drill = train.main(base + [
                "--ckpt-dir", ckpt_dir, "--ckpt-every", str(DRILL_EVERY),
                "--simulate-failure", str(DRILL_FAIL), "--recover-strategy", "tp",
                "--inject-ckpt-fault", str(DRILL_FAULTS), "--max-retries", "4",
                "--precompile-survivors", "1", "--precompile-block",
                "--trace-dir", trace_dir], pool=pool)
            drill_s = time.perf_counter() - t0
        _check_param_count(drill, full, "failure drill")
        rec, sup = drill.get("recovery"), drill["supervisor"]
        if rec is None:
            fail("failure drill ran without recovering")
        if sup["retries"] != DRILL_FAULTS:
            fail(f"failure drill: the supervisor retried {sup['retries']} writes, "
                 f"expected {DRILL_FAULTS}")
        if not rec["precompiled"] or rec["restore_mode"] != "shard-to-shard":
            fail(f"failure drill recovery: precompiled {rec['precompiled']}, restore "
                 f"mode {rec['restore_mode']}")
        if (rec["after"]["strategy"], rec["after"]["devices"], drill["strategy"]) != \
                ("tp", SHARDED_WORLD // 2, "tp"):
            fail(f"failure drill recovered onto {rec['after']}")
        cm = CheckpointManager(ckpt_dir)
        left = cm.available_steps()
        if not left or not all(cm.verify(s) for s in left):
            fail(f"failure drill: checkpoints {left} do not all verify")
        trace = read_jsonl(os.path.join(trace_dir, "trace.jsonl"))
        names = {s.name for s in trace.spans}
        want_spans = {"recovery/compile", "recovery/plan", "recovery/restore"}
        if not want_spans <= names:
            fail(f"failure drill trace lacks {want_spans - names}")
        errs = [abs(a - b) for a, b in zip(drill["losses"], ref["losses"])]
        if (len(drill["losses"]) != DRILL_STEPS or len(ref["losses"]) != DRILL_STEPS
                or max(errs) > tol):
            fail(f"failure drill losses {drill['losses']} vs uninterrupted "
                 f"{ref['losses']}: |d| {errs} (tol {tol})")
        # every rank, every step: one cuda_core flash call a layer (fp32), no codec
        want = {"flash_attention": DRILL_LAYERS, "quantize_absmax": 0, "quantize_int8": 0,
                "dequantize_int8": 0, "ssd_scan": 0,
                "flash_by_design": {"cuda_core": DRILL_LAYERS, "tile": 0, "split_kv": 0,
                                    "split_kv_combine": 0}}
        totals, designs = collections.Counter(), collections.Counter()
        for r in drill["ranks"]:
            for step, got in enumerate(r["launches_per_step"]):
                if got != want:
                    fail(f"failure drill rank {r['rank']} step {step} launched {got}, "
                         f"expected {want}")
                totals.update({k: v for k, v in got.items() if isinstance(v, int)})
                designs.update(got["flash_by_design"])
        writes = drill.get("checkpoints", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # a fatal write fails on its first attempt: no retry budget spent on it
    fatal_dir = tempfile.mkdtemp(prefix="chip_smoke_fatal_")
    try:
        def bad_hook(op, step):
            raise ValueError("shape mismatch")
        cm = CheckpointManager(fatal_dir, fault_hook=bad_hook)
        sup2 = Supervisor(policy=RetryPolicy(max_attempts=4, backoff_s=0.0),
                          sleep=lambda s: None)
        attempts = []

        def write():
            attempts.append(1)
            cm.save(1, {"w": torch.ones(4, device=dev)})
            cm.wait()
        try:
            sup2.run("checkpoint_save", write)
            fail("a fatal checkpoint write did not raise")
        except ValueError:
            pass
        if len(attempts) != 1 or sup2.retries != 0:
            fail(f"a fatal write took {len(attempts)} attempts ({sup2.retries} retries)")
    finally:
        shutil.rmtree(fatal_dir, ignore_errors=True)

    # launch.elastic --quick: the reference's tiny drill, cold and prebuilt
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = elastic.main(["--quick", "--device", dev.type], pool=pool)
    elastic_s = time.perf_counter() - t0
    er = rows[0]
    numbers = {
        "recovery": rec, "supervisor": sup, "checkpoints": writes,
        "losses": drill["losses"], "ref_losses": ref["losses"], "loss_diffs": errs,
        "step_ms": drill["step_ms"], "ref_step_ms": ref["step_ms"],
        "ranks_peak_mem_bytes": [r["peak_mem_bytes"] for r in drill["ranks"]],
        "trace": drill["trace"], "ref_s": ref_s, "drill_s": drill_s,
        "elastic_quick": {k: er[k] for k in ("cold", "warm")}, "elastic_s": elastic_s,
        "phase_s": time.perf_counter() - t_phase}
    print(f"  recovery {json.dumps(rec)}; supervisor {json.dumps(sup)}; checkpoints "
          f"(bytes, write s) {[(w['step'], w['bytes'], round(w['write_s'], 3)) for w in writes]}"
          f"; losses {drill['losses']} vs uninterrupted {ref['losses']}: max |d| "
          f"{max(errs):.3e} (tol {tol:.3e}); step_ms {drill['step_ms']} (uninterrupted "
          f"{ref['step_ms']}); launches per rank per step {want}; {len(left)} checkpoints "
          f"left, all verified; the fatal write raised on its first attempt; runs "
          f"{ref_s:.1f} s + {drill_s:.1f} s; card {card}", flush=True)
    print(f"  launch.elastic --quick (reduced fp32, fsdp 8 -> 4): cold "
          f"{json.dumps(er['cold'])}; prebuilt {json.dumps(er['warm'])}; {elastic_s:.1f} s",
          flush=True)
    return dict(totals), dict(designs), numbers


def attribution_phase(torch, dev, card, pool):
    """Phase 24 (d): ``launch.trace_report --quick`` on fsdp over the pool of
    8. Returns the numbers."""
    from repro_torch.launch import trace_report
    phase(f"attribution: launch.trace_report --quick --strategies fsdp on the pool of "
          f"{SHARDED_WORLD} (phase 24 d)")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        points = trace_report.main(["--quick", "--strategies", "fsdp", "--device",
                                    dev.type], pool=pool)
    (p,) = points
    missing = [r.term for r in p["rows"] if not (r.measured_ms or 0) > 0]
    if missing:
        fail(f"attribution: terms without a measured time: {missing}")
    if any(abs(1 - c) > COVERAGE_TOL for c in p["step_coverage"]):
        fail(f"attribution: span coverage {p['step_coverage']}")
    from repro_torch.obs import render_markdown
    print(render_markdown(p["rows"], title=f"fsdp at {p['mesh']} (predicted: the "
                                           f"checked-in host-pool calibration; measured: "
                                           f"gloo on one card; {card})"), flush=True)
    numbers = {"step_ms": p["step_ms"], "coverage": p["coverage"],
               "step_coverage": p["step_coverage"], "children_ms": p["children_ms"],
               "regions_ms": p["regions_ms"], "rows": [r.to_dict() for r in p["rows"]],
               "drift": p["drift"].to_dict(), "decomp": p["decomp"],
               "overhead": p["overhead"], "run_s": time.perf_counter() - t0}
    print(f"  step {p['step_ms']:.3f} ms, coverage {p['coverage']:.4f} (per step "
          f"{p['step_coverage']}); regions {json.dumps(p['regions_ms'])}; drift: "
          f"{p['drift'].message}; disabled-recorder overhead "
          f"{p['overhead']['overhead']:+.2%} (not gated); {numbers['run_s']:.1f} s; "
          f"card {card}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# Phase 25: the dry-run, the roofline and the step-time predictor
# ---------------------------------------------------------------------------

DRYRUN_ARCHS = ("smollm-360m", "qwen2.5-3b", "gemma2-2b", "mamba2-370m")
DRYRUN_SHAPES = ("train_4k", "decode_32k")      # on the pod mesh; train_4k on both
DRYRUN_CELL_TIMEOUT = 600
DRYRUN_PEAK_TOL = 0.10       # the real step's peak vs the traced args + temp
RATE_SLACK = 1.05            # a measured rate vs the roofline's constant
DRYRUN_TIMED_STEPS = 2       # after one warm-up step
GEMM_N, GEMM_RUNS, COPY_BYTES = 8192, 20, 2 ** 30


class DryrunCellsProcess:
    """Phase 25's traces in a process of its own (``python3 chip_smoke.py
    --dryrun-cells DIR``), started after phase 13: (a)'s cell first, then
    (b)'s production-mesh cells through ``launch.dryrun.run_all`` (a process
    a cell), all into DIR. Tracing is host work on a core or two, beside
    phases 22 (a) to 24, which leave most of the eight idle. Its cell processes
    share its session, so that ``stop_children`` ends them with it. Its
    output goes to a file, printed whole by ``finish``."""

    def __init__(self):
        print("  phase 25's traces ((a)'s cell, then (b)'s production-mesh cells) start "
              "in a process of their own beside phases 22 (a) to 24; its output follows "
              "phase 24", flush=True)
        self.dir = tempfile.mkdtemp(prefix="dryrun_cells_")
        self.log = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dryrun-cells", self.dir],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=REPO, start_new_session=True)
        self.proc.own_session = True
        CHILDREN.append(self.proc)

    def traced_step(self):
        """(a)'s trace, once the process has written it."""
        path = os.path.join(self.dir, DRYRUN_STEP_FILE)
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                self.finish()
                fail("phase 25's trace process ended without (a)'s trace")
            time.sleep(0.5)
        print(f"  (a)'s trace waited for {time.perf_counter() - t0:.1f} s", flush=True)
        with open(path) as f:
            return json.load(f)

    def finish(self):
        """Wait for it and print its output; fail if it failed. Returns the
        directory of (b)'s rows."""
        t0 = time.perf_counter()
        rc = self.proc.wait()
        self.log.seek(0)
        sys.stdout.write(self.log.read())
        self.log.close()
        print(f"  phase 25's trace process ended with code {rc}; waited "
              f"{time.perf_counter() - t0:.1f} s for it here", flush=True)
        if rc != 0:
            fail(f"phase 25's traces failed in their process, exit code {rc}")
        return self.dir


DRYRUN_STEP_FILE = "phase25a.trace"     # not a row: the fit reads *.json


def dryrun_step_cell():
    """(cfg, shape, train config, mesh) of phase 25 (a)'s cell: smollm-360m
    at full width on a mesh of one (no process group), phase 8's batch of
    8 x 512, remat none, adamw, no codec."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import LazyGroups, Mesh
    return (get_config(TRAIN_ARCH), ShapeConfig("phase8", TRAIN_SEQ, TRAIN_BATCH, "train"),
            TrainConfig(remat_policy="none"), Mesh({"data": 1, "model": 1}, 0, LazyGroups()))


def dryrun_cells_main(outdir: str) -> None:
    """``python3 chip_smoke.py --dryrun-cells DIR``: phase 25's traces on
    device ``cuda``. (a)'s cell traced here by ``launch.dryrun.trace_cell``
    (its fields, op count and the kernel launches during the trace into
    ``DIR/phase25a.trace``); then (b)'s cells, each in a process of its own
    by ``launch.dryrun.run_all``: the four archs at train_4k and decode_32k
    on the pod mesh (16 x 16), then at train_4k on the multipod mesh
    (2 x 16 x 16)."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import dryrun as D
    _, reset_counts, read_counts = launch_counters(FA, Q, SSD)
    cfg, shape, tcfg, mesh = dryrun_step_cell()
    reset_counts()
    t0 = time.perf_counter()
    fields, _, stats = D.trace_cell(cfg, shape, mesh, tcfg, "fsdp_tp", device="cuda")
    trace_s = time.perf_counter() - t0
    traced = {"fields": fields, "n_ops": stats.n_ops, "trace_s": trace_s,
              "launches": read_counts()}
    with open(os.path.join(outdir, DRYRUN_STEP_FILE + ".tmp"), "w") as f:
        json.dump(traced, f)
    os.replace(os.path.join(outdir, DRYRUN_STEP_FILE + ".tmp"),
               os.path.join(outdir, DRYRUN_STEP_FILE))
    print(f"  (a)'s cell traced in {trace_s:.1f} s ({stats.n_ops} ops)", flush=True)
    t0 = time.perf_counter()
    D.run_all(outdir, meshes=("pod",), archs=DRYRUN_ARCHS, shapes=DRYRUN_SHAPES,
              timeout=DRYRUN_CELL_TIMEOUT, device="cuda")
    D.run_all(outdir, meshes=("multipod",), archs=DRYRUN_ARCHS, shapes=("train_4k",),
              timeout=DRYRUN_CELL_TIMEOUT, device="cuda")
    print(f"  {len(DRYRUN_ARCHS) * (len(DRYRUN_SHAPES) + 1)} cells traced in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    after_cells(outdir)


AFTER_CELLS_FILE = "after_cells.out"    # not a row: the fit reads *.json


def after_cells(outdir: str) -> None:
    """In phase 25's process, on (b)'s rows, the fits of phases 25 (c) and 27
    (a, c), whose gates the main process applies (``predictor_phase``,
    ``a17_cells_phase``): ``launch.predict_scaling.main``; the roofline table
    of both meshes and ``launch.roofline_fit``; then ``examples.quickstart``'s
    fit (its claim's outcome recorded), every fit on the card. Into
    ``DIR/after_cells.out``."""
    from repro_torch.examples import quickstart
    from repro_torch.launch import predict_scaling, roofline_fit, roofline_table
    out = {}
    t0 = time.perf_counter()
    out["predictor"] = predict_scaling.main(["--results-dir", outdir, "--device", "cuda"])
    out["predictor_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["tables"] = {m: roofline_table.table(m, outdir) for m in ("pod", "multipod")}
    out["roofline_fit"] = roofline_fit.roofline_fit(outdir, device="cuda")
    out["roofline_s"] = time.perf_counter() - t0
    for text in out["tables"].values():
        print(text, flush=True)
    t0 = time.perf_counter()
    r = quickstart.fit(device="cuda")
    print(r.summary(), flush=True)
    out["quickstart"] = {"recovered": quickstart.recovered(r),
                         "q_gpus": r.model.scaling_powers()["gpus"],
                         "test_mape": r.test_metrics["mape"],
                         "s": time.perf_counter() - t0}
    with open(os.path.join(outdir, AFTER_CELLS_FILE), "w") as f:
        json.dump(out, f, default=float)


def _median_ms(torch, fn, runs):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dryrun_step_phase(torch, dev, card, env, traced):
    """Phase 25 (a): one cell traced and then run on the card. ``traced``
    is ``dryrun_step_cell``'s cell traced on fake CUDA tensors in phase 25's
    trace process (no kernel launched there); here the same step function
    (``launch.specs.input_specs``'s) runs on real tensors, a warm-up step
    under ``flop_counter`` and ``DRYRUN_TIMED_STEPS`` timed. The real flops
    equal the traced, the real peak is within ``DRYRUN_PEAK_TOL`` of the
    traced argument + temp bytes, the median step is no faster than the
    roofline's ``t_step``; then a bf16 GEMM and a device copy against the
    roofline's constants."""
    import numpy as np

    from repro_torch.data import make_batch_for
    from repro_torch.launch.specs import input_specs
    from repro_torch.perf import roofline as RF
    from repro_torch.perf.op_analysis import flop_counter
    from repro_torch.train.step import init_gspmd_train_state

    phase(f"dry-run: {TRAIN_ARCH} train (batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat none, "
          f"adamw) traced on fake CUDA tensors, then run on the card (phase 25 a)")
    cfg, shape, tcfg, mesh = dryrun_step_cell()
    fields = traced["fields"]
    rf, mem = fields["roofline"], fields["memory"]
    print(f"  traced in {traced['trace_s']:.1f} s ({traced['n_ops']} ops) in phase 25's "
          f"process: flops {rf['flops']:.6e}, bytes {rf['hbm_bytes']:.6e}, args "
          f"{mem['argument_size_in_bytes']} + temp {mem['temp_size_in_bytes']} bytes, "
          f"launches {traced['launches']}; roofline {rf['bottleneck']} t_step "
          f"{rf['t_step'] * 1e3:.3f} ms (compute {rf['compute_s'] * 1e3:.3f}, memory "
          f"{rf['memory_s'] * 1e3:.3f} ms)", flush=True)
    if any(traced["launches"].values()):
        fail(f"the dry-run's trace launched kernels: {traced['launches']}")

    step = input_specs(cfg, shape, mesh, tcfg, "fsdp_tp", device=dev).fn
    state = init_gspmd_train_state(cfg, tcfg, mesh, "fsdp_tp", device=dev)
    batch = {k: v.to(dev) for k, v in make_batch_for(cfg, TRAIN_BATCH, TRAIN_SEQ).items()}
    torch.cuda.synchronize()
    env.reset_counts()
    with flop_counter() as fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for _ in range(DRYRUN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated(dev)
    launches, designs = env.read_counts(), env.read_variants()
    del state, batch, metrics
    torch.cuda.empty_cache()
    n_steps = 1 + DRYRUN_TIMED_STEPS
    env.gate_variants("phase 25 (a)'s real steps", designs,
                      tile=cfg.n_layers * n_steps)
    if {k: v for k, v in launches.items() if k != "flash_attention" and v}:
        fail(f"phase 25 (a)'s real steps launched {launches}")
    traced_mem = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    step_s = statistics.median(times)
    print(f"  real: flops {real_flops:.6e} (traced {rf['flops']:.6e}); peak {peak} bytes "
          f"vs traced args + temp {traced_mem} ({peak / traced_mem - 1:+.2%}); median "
          f"step {step_s * 1e3:.3f} ms = {step_s / rf['t_step']:.2f} x the roofline's "
          f"t_step {rf['t_step'] * 1e3:.3f} ms; losses {losses}; card {card}", flush=True)
    if real_flops != rf["flops"]:
        fail(f"phase 25 (a): the real step's flops {real_flops} != traced {rf['flops']}")
    if abs(peak - traced_mem) > DRYRUN_PEAK_TOL * traced_mem:
        fail(f"phase 25 (a): real peak {peak} bytes is not within "
             f"{DRYRUN_PEAK_TOL:.0%} of the traced {traced_mem}")
    if not step_s >= rf["t_step"]:
        fail(f"phase 25 (a): a step took {step_s} s, under the roofline's bound "
             f"{rf['t_step']} s")
    if not all(np.isfinite(losses)):
        fail(f"phase 25 (a): losses {losses}")

    a = torch.randn(GEMM_N, GEMM_N, device=dev, dtype=torch.bfloat16)
    b = torch.randn(GEMM_N, GEMM_N, device=dev, dtype=torch.bfloat16)
    gemm_ms = _median_ms(torch, lambda: a @ b, GEMM_RUNS)
    del a, b
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = _median_ms(torch, lambda: dst.copy_(src), GEMM_RUNS)
    del src, dst
    torch.cuda.empty_cache()
    flops_rate = 2 * GEMM_N ** 3 / (gemm_ms * 1e-3)
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"  bf16 GEMM {GEMM_N}^3: {gemm_ms:.4f} ms = {flops_rate:.4e} FLOP/s vs "
          f"PEAK_FLOPS {RF.PEAK_FLOPS:.4e} ({flops_rate / RF.PEAK_FLOPS:.1%}); copy of "
          f"{COPY_BYTES} bytes: {copy_ms:.4f} ms = {copy_rate:.4e} B/s (read + write) vs "
          f"HBM_BW {RF.HBM_BW:.4e} ({copy_rate / RF.HBM_BW:.1%}); HBM_PER_CHIP "
          f"{RF.HBM_PER_CHIP:.4e} vs total_memory {total}; card {card}", flush=True)
    if flops_rate > RATE_SLACK * RF.PEAK_FLOPS or copy_rate > RATE_SLACK * RF.HBM_BW:
        fail("phase 25 (a): a measured rate beats the roofline's constant by more "
             f"than {RATE_SLACK - 1:.0%}")
    if RF.HBM_PER_CHIP > total:
        fail(f"phase 25 (a): HBM_PER_CHIP {RF.HBM_PER_CHIP} > the card's {total}")
    numbers = {"trace_s": traced["trace_s"], "traced_ops": traced["n_ops"],
               "flops": rf["flops"], "real_flops": real_flops, "hbm_bytes": rf["hbm_bytes"],
               "argument_bytes": mem["argument_size_in_bytes"],
               "temp_bytes": mem["temp_size_in_bytes"], "real_peak_bytes": peak,
               "t_step_s": rf["t_step"], "bottleneck": rf["bottleneck"],
               "step_s": times, "step_over_t_step": step_s / rf["t_step"],
               "gemm_ms": gemm_ms, "gemm_flops_per_s": flops_rate,
               "copy_ms": copy_ms, "copy_bytes_per_s": copy_rate,
               "total_memory": total}
    return launches, designs, numbers


def dryrun_cells_phase(torch, rows_dir, card):
    """Phase 25 (b)'s gates on its rows: every cell OK, collective bytes on
    every train cell, qwen2.5-3b's train_4k flops on 256 ranks at least
    ``model_flops_for`` / 256; each row's bottleneck, t_step and bytes per
    device printed."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.perf.roofline import model_flops_for
    phase("dry-run: the production meshes' cells (phase 25 b, traced in their process)")
    rows = []
    for name in sorted(os.listdir(rows_dir)):
        if name.endswith(".json") and name != "summary.json":
            with open(os.path.join(rows_dir, name)) as f:
                rows.append(json.load(f))
    want = len(DRYRUN_ARCHS) * (len(DRYRUN_SHAPES) + 1)
    if len(rows) != want:
        fail(f"phase 25 (b): {len(rows)} rows, expected {want}")
    for row in rows:
        what = f"{row['arch']} {row['shape']} {row['mesh']}"
        if row.get("status") != "OK":
            fail(f"phase 25 (b): {what} is {row.get('status')}: "
                 f"{str(row.get('error', row.get('reason')))[-1500:]}")
        rf = row["roofline"]
        print(f"  {what:36s} {rf['bottleneck']:10s} t_step {rf['t_step']:.6e} s "
              f"(compute {rf['compute_s']:.3e}, memory {rf['memory_s']:.3e}, collective "
              f"{rf['collective_s']:.3e}); bytes/device {row['bytes_per_device']}; traced "
              f"in {row['lower_s']} s; collectives {row['collective_counts']}", flush=True)
        if row["shape"] == "train_4k" and not rf["collective_bytes"] > 0:
            fail(f"phase 25 (b): {what} records no collective bytes")
        if (row["arch"], row["shape"], row["mesh"]) == ("qwen2.5-3b", "train_4k", "pod"):
            floor = model_flops_for(get_config(row["arch"]), get_shape("train_4k")) / 256
            print(f"  qwen2.5-3b train_4k flops per rank {rf['flops']:.6e} vs "
                  f"model_flops_for / 256 = {floor:.6e}", flush=True)
            if not rf["flops"] >= floor:
                fail(f"phase 25 (b): qwen2.5-3b train_4k flops {rf['flops']} < {floor}")
    print(f"  card {card}", flush=True)
    keep = ("bottleneck", "t_step", "flops", "hbm_bytes", "collective_bytes")
    return {f"{r['arch']}/{r['shape']}/{r['mesh']}": {
        **{k: r["roofline"][k] for k in keep},
        "bytes_per_device": r["bytes_per_device"], "lower_s": r["lower_s"]}
        for r in rows}


def predictor_phase(torch, rows_dir, after, card):
    """Phase 25 (c): ``launch.predict_scaling.main`` on (b)'s 12 rows, run in
    phase 25's process (``after_cells``, ``after``): the generic model
    fitted by DE on the card (seeds 0, 1, 2), then qwen2.5-3b's,
    deepseek-v3-671b's and mamba2-370m's train_4k at 256 and 512 ranks and
    their straggler thresholds, each finite and positive."""
    import numpy as np

    from repro_torch.core.predictor import dryrun_samples
    phase("step-time predictor: launch.predict_scaling on phase 25 (b)'s rows, the fit "
          "on the card in phase 25's process (phase 25 c)")
    n = len(dryrun_samples(rows_dir)[0])
    out, fit_s = after["predictor"], after["predictor_fit_s"]
    values = [out["train_mape"]] + [t for v in out["archs"].values() for t in v.values()]
    print(f"  {n} rows; fit and predictions in {fit_s:.1f} s; card {card}", flush=True)
    if n != len(DRYRUN_ARCHS) * (len(DRYRUN_SHAPES) + 1):
        fail(f"phase 25 (c): the fit read {n} rows")
    if not (all(np.isfinite(values)) and all(v > 0 for v in values)
            and np.isfinite(out["q_chips"])):
        fail(f"phase 25 (c): the fit or a prediction is not finite and positive: {out}")
    return {**out, "rows": n, "fit_s": fit_s}


# ---------------------------------------------------------------------------
# Phase 27: the benchmark drivers, the examples and the overlap smoke on the card
# ---------------------------------------------------------------------------


# Phase 27 (c): the quickstart's fit recovers its synthetic law (2 % noise)
# to this test MAPE, and a negative q_gpus. The example's own assertion
# (q_gpus within 0.15 of -1, the mean over its 5 seeds under L2, which pulls
# q toward 0) is printed, not gated: the reference's example fails it on the
# CPU (-0.842) as the port's did on the card (-0.838).
QUICKSTART_MAPE = 0.10


def _table_cells(text):
    """{(arch, shape): [compute, memory, collective, bottleneck, t_step,
    ratio, useful]} of a roofline table's lines."""
    out = {}
    for line in text.splitlines():
        parts = [p.strip() for p in line.strip().strip("|").split("|")]
        if len(parts) == 10 and parts[0] not in ("arch", "---"):
            out[(parts[0], parts[1])] = parts[2:9]
    return out


def a17_cells_phase(torch, rows_dir, after, card):
    """Phase 27 (a, c), run in phase 25's process (``after_cells``): (a)
    ``launch.roofline_table`` has a line per row of (b) on each mesh, its
    numbers each row's own ``roofline`` fields, and ``launch.roofline_fit``'s
    fit, ranking and threshold are finite; (c) ``examples.quickstart``'s fit
    on the card: test MAPE under ``QUICKSTART_MAPE``, q_gpus negative (its
    own claim printed)."""
    import numpy as np
    phase("benchmark drivers: launch.roofline_table and launch.roofline_fit on phase 25 "
          "(b)'s rows, examples.quickstart, in phase 25's process (phase 27 a, c)")
    rows = []
    for name in sorted(os.listdir(rows_dir)):
        if name.endswith(".json") and name != "summary.json":
            with open(os.path.join(rows_dir, name)) as f:
                rows.append(json.load(f))
    for mesh, text in after["tables"].items():
        got = _table_cells(text)
        mine = [r for r in rows if r["mesh"] == mesh]
        if len(got) != len(mine):
            fail(f"phase 27 (a): the {mesh} table has {len(got)} lines for {len(mine)} rows")
        for r in mine:
            if r.get("status") != "OK":       # a SKIP or FAIL line has no numbers
                if (got.get((r["arch"], r["shape"])) or [None] * 4)[3] != r.get("status"):
                    fail(f"phase 27 (a): no {r.get('status')} line for {r['arch']} "
                         f"{r['shape']} {mesh}")
                continue
            rf = r["roofline"]
            want = [f"{rf['compute_s']:.4f}", f"{rf['memory_s']:.4f}",
                    f"{rf['collective_s']:.4f}", rf["bottleneck"], f"{rf['t_step']:.4f}",
                    f"{(rf['model_flops'] / rf['n_chips']) / max(rf['flops'], 1):.3f}",
                    f"{rf['useful_fraction']:.2%}"]
            if got.get((r["arch"], r["shape"])) != want:
                fail(f"phase 27 (a): {r['arch']} {r['shape']} {mesh}: table "
                     f"{got.get((r['arch'], r['shape']))} != the row's {want}")
        if "hillclimb picks" not in text:
            fail(f"phase 27 (a): the {mesh} table has no hillclimb picks")
    fit = after["roofline_fit"]
    values = [fit["q_chips"], fit["straggler_threshold_s"], fit["metrics"]["mape"],
              fit["metrics"]["r2"]] + [t for _, t in fit["ranked"]]
    print(f"  tables: {sum(len(_table_cells(t)) for t in after['tables'].values())} lines "
          f"for {len(rows)} rows, each equal to its row; fit: train MAPE "
          f"{fit['metrics']['mape']:.3f}, R2 {fit['metrics']['r2']:.3f}, q_chips "
          f"{fit['q_chips']:+.3f}, qwen2.5-3b train_4k order "
          f"{'|'.join(str(n) for n, _ in fit['ranked'])}, straggler threshold at 256 "
          f"{fit['straggler_threshold_s']:.3f} s; {after['roofline_s']:.1f} s; card {card}",
          flush=True)
    if fit["status"] != "OK" or not all(np.isfinite(values)):
        fail(f"phase 27 (a): the roofline fit is not finite: {fit}")
    qs = after["quickstart"]
    print(f"  examples.quickstart's fit on the card: test MAPE {qs['test_mape']:.4f} "
          f"(gate < {QUICKSTART_MAPE}), q_gpus {qs['q_gpus'][0]:+.3f} ± "
          f"{qs['q_gpus'][1]:.3f}; the example's own claim (within 0.15 of -1) "
          f"{'holds' if qs['recovered'] else 'does not hold (reported, not gated)'}; "
          f"{qs['s']:.1f} s; card {card}", flush=True)
    if not (qs["test_mape"] < QUICKSTART_MAPE and qs["q_gpus"][0] < 0):
        fail(f"phase 27 (c): examples.quickstart's fit: {qs}")
    return {"roofline_fit": {k: fit[k] for k in ("q_chips", "ranked", "metrics",
                                                 "straggler_threshold_s")},
            "roofline_s": after["roofline_s"], "quickstart": qs}


def overlap_claim_phase(torch, dev, card, pool):
    """Phase 27 (d): ``tools.overlap_smoke``'s claim 1 on the pool of 8: one
    eager step of each body of reduced smollm-360m, tp at (data 1, model 8),
    under ``tp_probe_sink``; rank 0's overlapped local ``mlp_hidden`` is the
    sequential one's with d_ff cut 8 ways."""
    from repro_torch.tools import overlap_smoke
    phase("overlap smoke, claim 1: tools.overlap_smoke.claim_partition on the pool of 8 "
          "(phase 27 d)")
    t0 = time.perf_counter()
    try:
        out = overlap_smoke.claim_partition(pool)
    except AssertionError as e:
        fail(f"phase 27 (d): the overlapped tp body does not shard mlp_hidden: {e}")
    out["s"] = time.perf_counter() - t0
    print(f"  {json.dumps(out)}; card {card}", flush=True)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    start_watchdog(WATCHDOG_S - (time.perf_counter() - T_START))
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.data import make_batch_for
    from repro_torch.dist import compression as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import quantize as Q
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import serve, train
    from repro_torch.models import model as MD
    from repro_torch.models.attention import AttnSpec
    from repro_torch.perf import sweep as SW
    from repro_torch.train import step as TS
    from repro_torch.tree import reference_leaves, tree_leaves

    dev = torch.device("cuda", 0)
    counters, reset_counts, read_counts = launch_counters(FA, Q, SSD)

    def read_variants():
        return dict(FA.LAUNCHES_BY_VARIANT)

    def read_ssd_variants():
        return dict(SSD.LAUNCHES_BY_VARIANT)

    def gate_ssd_variants(what, got, **want):
        want = {v: want.get(v, 0) for v in SSD.VARIANTS}
        print(f"  ssd_scan launches by design {got} (expected {want})", flush=True)
        if got != want:
            fail(f"{what} launched the SSD designs {got}, expected {want}")

    def gate_variants(what, got, **want):
        want = {v: want.get(v, 0) for v in FA.VARIANTS}
        print(f"  flash_attention launches by design {got} (expected {want})", flush=True)
        if got != want:
            fail(f"{what} launched the flash attention designs {got}, expected {want}")

    env = types.SimpleNamespace(reset_counts=reset_counts, read_counts=read_counts,
                                read_variants=read_variants, gate_variants=gate_variants,
                                read_ssd_variants=read_ssd_variants,
                                gate_ssd_variants=gate_ssd_variants)

    # ---- 1. environment ---------------------------------------------------
    phase("environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"card (name, power limit): {card}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    phase("build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    sources = (FA.SOURCE, Q.SOURCE, *SSD.SOURCES)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        building = ex.map(nvcc.build, sources)
        warm_s = warm_inductor(dev)         # inductor's set-up, beside nvcc
        libs = list(building)
    print(f"built in {time.perf_counter() - t0:.1f} s (inductor warmed beside it in "
          f"{warm_s:.1f} s)")
    for lib in libs:
        print(f"  {os.path.relpath(lib, REPO)}")
        with open(lib + ".log") as f:
            for line in f:
                if any(w in line for w in ("entry function", "registers", "spill",
                                           "build_s")):
                    print("    " + line.strip())
    ptxas = dict(kv for lib in libs for kv in ptxas_usage(lib + ".log").items())
    flash_regs = flash_registers(ptxas)
    print(f"  flash tensor-core kernels, registers and spills: {json.dumps(flash_regs)}",
          flush=True)
    spilled = {k: u for k, u in flash_regs.items() if u["spill_stores"] or u["spill_loads"]}
    if spilled or len(flash_regs) != 2 * len(FA.TC_HEAD_DIMS):
        fail(f"flash tile / split-KV instantiations: {flash_regs} (spilled: {spilled})")

    # ---- 3. flash attention against plain -------------------------------
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

    # (label, shape, q_pos, kv_pos, spec, design in bf16); fp32 always takes
    # the CUDA-core kernel
    cases = []
    for c in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = c
        cases.append((f"ref{c[:6]}", c[:6], *tail_pos(Sq, Skv),
                      AttnSpec(causal=causal, window=window, logit_softcap=cap),
                      "cuda_core"))
    cases.append(("ring_cache", (1, 1, 64, 2, 2, 16), arange(95, 96),
                  torch.cat([arange(64, 96), arange(32, 64)]),
                  AttnSpec(causal=True, window=40), "cuda_core"))
    full = get_config(ARCH)
    hq, hkv, hd = full.n_heads, full.n_kv_heads, full.get_head_dim()
    for cap in (PROMPT + GEN, 4096):
        cases.append((f"decode_cap{cap}", (BATCH, 1, cap, hq, hkv, hd),
                      *tail_pos(1, cap), AttnSpec(), "split_kv"))
    part = arange(0, PROMPT + GEN)
    part[10:] = FA.PAD_POS              # ring cache with empty slots
    cases.append(("decode_partial", (BATCH, 1, PROMPT + GEN, hq, hkv, hd),
                  arange(9, 10), part, AttnSpec(), "split_kv"))
    cases.append(("all_masked", (BATCH, 1, PROMPT + GEN, hq, hkv, hd),
                  arange(0, 1), arange(1, PROMPT + GEN + 1), AttnSpec(), "split_kv"))
    # split-KV: half the ring empty (16 of 32 splits hold only PAD slots);
    # 1000 keys, 8 splits of 128, the last with 104 (and a ragged chunk);
    # a row with no attendable key over 32 splits; 129 keys in 2 splits of
    # 128, the last holding one key (three of its four warps see none, m =
    # -inf, weight 0), with that key attendable and with every key masked
    half = arange(0, 4096)
    half[2048:] = FA.PAD_POS
    cases.append(("decode_cap4096_half_pad", (BATCH, 1, 4096, hq, hkv, hd),
                  arange(2047, 2048), half, AttnSpec(), "split_kv"))
    cases.append(("decode_ragged_1000", (BATCH, 1, 1000, hq, hkv, hd),
                  *tail_pos(1, 1000), AttnSpec(), "split_kv"))
    cases.append(("all_masked_cap4096", (BATCH, 1, 4096, hq, hkv, hd),
                  arange(0, 1), arange(1, 4097), AttnSpec(), "split_kv"))
    cases.append(("decode_last_split_1key", (BATCH, 1, 129, hq, hkv, hd),
                  *tail_pos(1, 129), AttnSpec(), "split_kv"))
    cases.append(("all_masked_129", (BATCH, 1, 129, hq, hkv, hd),
                  arange(0, 1), arange(1, 130), AttnSpec(), "split_kv"))
    cases.append((f"prefill{PROMPT}", (BATCH, PROMPT, PROMPT, hq, hkv, hd),
                  *tail_pos(PROMPT, PROMPT), AttnSpec(), "tile"))
    # tile kernel: ragged q and kv tiles with a window and a softcap (hd 64);
    # non-causal, G = 1 (hd 128); a wrapped ring with PAD slots (unsorted
    # positions: tiles are skipped by position, never by index)
    cases.append(("tile_window_softcap", (2, 200, 328, 8, 2, 64),
                  *tail_pos(200, 328), AttnSpec(causal=True, window=48,
                                                logit_softcap=30.0), "tile"))
    cases.append(("tile_noncausal_g1", (1, 96, 160, 4, 4, 128),
                  *tail_pos(96, 160), AttnSpec(causal=False), "tile"))
    cases.append(("tile_ring", (1, 80, 256, 8, 2, 128), arange(300, 380),
                  torch.cat([arange(320, 380), arange(130, 320),
                             torch.full((6,), FA.PAD_POS, dtype=torch.int32,
                                        device=dev)]),
                  AttnSpec(causal=True, window=100), "tile"))
    tcfg_full = get_config(TRAIN_ARCH)
    t_heads = (tcfg_full.n_heads, tcfg_full.n_kv_heads, tcfg_full.get_head_dim())
    t_shape = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *t_heads)
    cases.append((f"train{TRAIN_SEQ}", t_shape, *tail_pos(TRAIN_SEQ, TRAIN_SEQ),
                  AttnSpec(causal=True), "tile"))
    cases.append((f"train{TRAIN_SEQ}_noncausal", t_shape,
                  *tail_pos(TRAIN_SEQ, TRAIN_SEQ), AttnSpec(causal=False), "tile"))
    # q_pos starts at -8: the first 8 rows have no attendable key (mean(v) over
    # all 512 keys) while each q tile skips every KV tile past its diagonal
    cases.append((f"train{TRAIN_SEQ}_causal_shift", t_shape,
                  arange(-8, TRAIN_SEQ - 8), arange(0, TRAIN_SEQ),
                  AttnSpec(causal=True), "tile"))

    # gemma2-2b (head_dim 256: tile, and split-KV at decode, in bf16) with
    # its window and softcap: the training shape; decode over the served
    # 64-slot ring; the served prefill (32 rows: one block of 128, 6 of its
    # 8 warps idle); a prefill over window + 256 keys, where the window bites;
    # a decode over a 4096-slot ring (slot = position mod 4096) holding
    # positions 900..4995 for a query at 5000, the oldest 5 past the window
    # (16 splits and the combine).
    # whisper-tiny (head_dim 64, bf16 on the tensor-core designs): its
    # encoder (1500 frames, non-causal: ragged 64-row tiles), the decoder's
    # cross-attention over them at prefill (32 rows) and at decode.
    gfull, wfull = get_config(LG_ARCH), get_config(ENCDEC_ARCH)
    g_heads = (gfull.n_heads, gfull.n_kv_heads, gfull.get_head_dim())
    w_heads = (wfull.n_heads, wfull.n_kv_heads, wfull.get_head_dim())
    g_spec = AttnSpec(causal=True, window=gfull.attn_window,
                      logit_softcap=gfull.attn_logit_softcap)
    gw, t_enc = gfull.attn_window, wfull.encoder_seq_len
    cases.append((f"gemma2_train{TRAIN_SEQ}", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *g_heads),
                  *tail_pos(TRAIN_SEQ, TRAIN_SEQ), g_spec, "tile"))
    cases.append((f"gemma2_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN, *g_heads),
                  *tail_pos(1, PROMPT + GEN), g_spec, "split_kv"))
    cases.append((f"gemma2_prefill{PROMPT}", (BATCH, PROMPT, PROMPT, *g_heads),
                  *tail_pos(PROMPT, PROMPT), g_spec, "tile"))
    cases.append((f"gemma2_window_bites_{gw + 256}", (1, 256, gw + 256, *g_heads),
                  *tail_pos(256, gw + 256), g_spec, "tile"))
    cases.append((f"gemma2_ring{gw}_past_window", (BATCH, 1, gw, *g_heads),
                  arange(5000, 5001), torch.cat([arange(gw, 4996), arange(900, gw)]),
                  g_spec, "split_kv"))
    # The tensor-core designs at head_dims 256 and 192 (8 warps over 128 q
    # rows, Q read from shared memory): ragged q and kv tiles (200 rows: the
    # second block's last three warps idle; 328 keys) under a window and a
    # softcap; a wrapped ring with PAD slots (tile, and split-KV over the
    # served ring with its empty slots); first rows with no attendable key
    # (mean(v), 8 or 6 columns a lane); split-KV at 192 over 64 slots (G 1,
    # MLA's heads) and over 1000 (G 4, 8 splits and the combine).
    h256, h192 = (gfull.n_heads, gfull.n_kv_heads, 256), (16, 16, 192)
    cases.append(("tile256_ragged_window_softcap", (2, 200, 328, *h256),
                  *tail_pos(200, 328), AttnSpec(causal=True, window=48, logit_softcap=50.0),
                  "tile"))
    cases.append(("tile256_ring_pad", (1, 80, 256, *h256), arange(300, 380),
                  torch.cat([arange(320, 380), arange(130, 320),
                             torch.full((6,), FA.PAD_POS, dtype=torch.int32, device=dev)]),
                  AttnSpec(causal=True, window=100), "tile"))
    cases.append(("decode256_ring_pad", (BATCH, 1, PROMPT + GEN, *h256), arange(9, 10), part,
                  g_spec, "split_kv"))
    cases.append(("tile256_causal_shift", (2, 130, 130, *h256), arange(-8, 122),
                  arange(0, 130), AttnSpec(causal=True), "tile"))
    cases.append(("tile192_causal_shift", (1, 40, 40, 4, 4, 192), arange(-8, 32),
                  arange(0, 40), AttnSpec(causal=True), "tile"))
    cases.append(("tile192_noncausal_g1", (1, 96, 160, 4, 4, 192), *tail_pos(96, 160),
                  AttnSpec(causal=False), "tile"))
    cases.append((f"decode192_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN, *h192),
                  *tail_pos(1, PROMPT + GEN), AttnSpec(), "split_kv"))
    cases.append(("decode192_ragged_1000_g4", (BATCH, 1, 1000, 8, 2, 192),
                  *tail_pos(1, 1000), AttnSpec(), "split_kv"))
    cases.append((f"whisper_encoder{t_enc}", (BATCH, t_enc, t_enc, *w_heads),
                  arange(0, t_enc), arange(0, t_enc), AttnSpec(causal=False), "tile"))
    cases.append((f"whisper_cross_prefill{PROMPT}", (BATCH, PROMPT, t_enc, *w_heads),
                  arange(0, PROMPT), arange(0, t_enc), AttnSpec(causal=False), "tile"))
    cases.append((f"whisper_cross_decode{t_enc}", (BATCH, 1, t_enc, *w_heads),
                  arange(PROMPT, PROMPT + 1), arange(0, t_enc), AttnSpec(causal=False),
                  "split_kv"))
    # zamba2-1.2b's shared block (32 heads of 64, G 1, window 4096): the
    # training shape (Sq·G = 512: tile) and decode over the served 64-slot
    # cache (split-KV). llama4-scout (40 q over 8 kv heads of 128, G 5): its
    # prefill (Sq·G = 160: tile) and decode (G = 5: split-KV). deepseek-v3's
    # MLA prefill: 128 heads at qk dim 192, v zero-padded to 192, Hkv = H:
    # the tile design (32 rows a block of 128, so 6 of its 8 warps idle).
    zfull, lfull, dfull = get_config(HYBRID_ARCH), get_config(MOE_ARCH), get_config(MLA_ARCH)
    z_heads = (zfull.n_heads, zfull.n_kv_heads, zfull.get_head_dim())
    l_heads = (lfull.n_heads, lfull.n_kv_heads, lfull.get_head_dim())
    d_qk = dfull.mla.qk_nope_head_dim + dfull.mla.qk_rope_head_dim
    d_heads = (dfull.n_heads, dfull.n_heads, d_qk)
    z_spec = AttnSpec(causal=True, window=zfull.attn_window)
    cases.append((f"zamba2_train{TRAIN_SEQ}", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *z_heads),
                  *tail_pos(TRAIN_SEQ, TRAIN_SEQ), z_spec, "tile"))
    cases.append((f"zamba2_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN, *z_heads),
                  *tail_pos(1, PROMPT + GEN), z_spec, "split_kv"))
    cases.append((f"llama4_prefill{PROMPT}", (BATCH, PROMPT, PROMPT, *l_heads),
                  *tail_pos(PROMPT, PROMPT), AttnSpec(), "tile"))
    cases.append((f"llama4_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN, *l_heads),
                  *tail_pos(1, PROMPT + GEN), AttnSpec(), "split_kv"))
    cases.append((f"deepseek_mla_prefill{PROMPT}", (BATCH, PROMPT, PROMPT, *d_heads),
                  *tail_pos(PROMPT, PROMPT), AttnSpec(), "tile"))
    # nemotron-4-15b (48 q over 8 kv heads of 128, G 6): its prefill (Sq·G =
    # 192: tile) and decode over the served 64-slot cache (G = 6: split-KV)
    nfull = get_config(NEMOTRON_ARCH)
    n_heads = (nfull.n_heads, nfull.n_kv_heads, nfull.get_head_dim())
    cases.append((f"nemotron_prefill{PROMPT}", (BATCH, PROMPT, PROMPT, *n_heads),
                  *tail_pos(PROMPT, PROMPT), AttnSpec(), "tile"))
    cases.append((f"nemotron_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN, *n_heads),
                  *tail_pos(1, PROMPT + GEN), AttnSpec(), "split_kv"))
    # Every other shape these paths launch: llama4's one-layer training
    # (Sq·G = 2560: tile), zamba2's shared block at prefill (tile, under its
    # window), and the --reduced runs' shapes, whose head dims (24, 16) take
    # the CUDA-core design: deepseek's MLA training at S and its MTP block at
    # S - 1, internvl2's training over patches and tokens and its decode over
    # the tokens left beside the patches plus GEN.
    rd, rv = reduced(get_config(MLA_ARCH)), reduced(get_config(VLM_ARCH))
    rd_heads = (rd.n_heads, rd.n_heads, rd.mla.qk_nope_head_dim + rd.mla.qk_rope_head_dim)
    rv_heads = (rv.n_heads, rv.n_kv_heads, rv.get_head_dim())
    rv_cap = max(PROMPT - rv.n_frontend_tokens, 1) + GEN
    cases.append((f"llama4_train{TRAIN_SEQ}", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, *l_heads),
                  *tail_pos(TRAIN_SEQ, TRAIN_SEQ), AttnSpec(causal=True), "tile"))
    cases.append((f"zamba2_prefill{PROMPT}", (BATCH, PROMPT, PROMPT, *z_heads),
                  *tail_pos(PROMPT, PROMPT), z_spec, "tile"))
    for S in (REDUCED_SEQ, REDUCED_SEQ - 1):
        cases.append((f"deepseek_reduced_train{S}", (TRAIN_BATCH, S, S, *rd_heads),
                      *tail_pos(S, S), AttnSpec(causal=True), "cuda_core"))
    cases.append((f"internvl2_reduced_train{REDUCED_SEQ}",
                  (TRAIN_BATCH, REDUCED_SEQ, REDUCED_SEQ, *rv_heads),
                  *tail_pos(REDUCED_SEQ, REDUCED_SEQ), AttnSpec(causal=True), "cuda_core"))
    cases.append((f"internvl2_reduced_decode_cap{rv_cap}", (BATCH, 1, rv_cap, *rv_heads),
                  *tail_pos(1, rv_cap), AttnSpec(), "cuda_core"))
    # phase 21's arch-sweep trials: the compute probe's and a rank's calls
    # (head_dim 16: CUDA-core), causal over the whole sequence
    for kw in ARCH_SWEEP_POINTS:
        for label, shape in arch_sweep_shapes(SW, MD, kw)[0]:
            cases.append((label, shape, *tail_pos(shape[1], shape[2]),
                          AttnSpec(causal=True), "cuda_core"))

    path_err = None
    designs_seen = collections.Counter()
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for label, shape, q_pos, kv_pos, spec, design in cases:
            q, k, v = inputs(*shape, dtype)
            before = read_variants()
            out = FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
            ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
            torch.cuda.synchronize()
            design = design if dtype == torch.bfloat16 else "cuda_core"
            launched = {d: n - before[d] for d, n in read_variants().items() if n != before[d]}
            splits = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype).n_splits
            want = {design: 1, **({"split_kv_combine": 1} if splits > 1 else {})}
            designs_seen.update(launched)
            err = (out.float() - ref.float()).abs().max().item()
            # Over many keys the outputs shrink (about sqrt(e / Skv)), so in
            # bf16 the error is also held to TOL times the output's largest
            # entry: a dropped split or a wrong merge shows there.
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            ok = torch.allclose(out.float(), ref.float(), atol=TOL[dname],
                                rtol=TOL[dname])
            ok = ok and (dtype != torch.bfloat16 or rel <= TOL[dname])
            print(f"  {dname:8s} {label:32s} {design:9s} splits {splits:2d} "
                  f"max_abs_err={err:.3e} err/max|ref|={rel:.3e} tol={TOL[dname]:g} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if launched != want:
                fail(f"flash_attention {dname} {label} launched {launched}, "
                     f"expected {want}")
            if not ok:
                fail(f"flash_attention disagrees with its plain version: "
                     f"{dname} {label} max_abs_err={err} err/max|ref|={rel}")
            if dtype == torch.bfloat16 and label == f"decode_cap{PROMPT + GEN}":
                path_err = err
            del q, k, v, out, ref
    print(f"  launches by design over these cases: {dict(designs_seen)}", flush=True)
    if set(designs_seen) != set(FA.VARIANTS):
        fail(f"the cases did not run every design: {dict(designs_seen)}")

    # The custom op every call on the card goes through: forward the kernel,
    # backward the plain recompute. At the training shape eagerly (as the
    # eager LM steps call it), at phase 21's shapes (head_dim 16: CUDA-core)
    # eagerly, and compiled at the lm trial's compute-probe shape (an
    # inductor compile ~10 s; phase 21 gates the compiled steps at every
    # shape), causal over the whole sequence.
    op_cases = [(f"train{TRAIN_SEQ}", t_shape, dtype, False)
                for dtype in (torch.bfloat16, torch.float32)]
    op_cases += [(label, shape, torch.bfloat16, compiled) for kw in ARCH_SWEEP_POINTS
                 for label, shape in arch_sweep_shapes(SW, MD, kw)[0]
                 for compiled in ((False, True) if label == "arch_lm_compute"
                                  else (False,))]
    for label, shape, dtype, compiled in op_cases:
        dname = str(dtype).split(".")[-1]
        qkv = [t.requires_grad_(True) for t in inputs(*shape, dtype)]
        q_pos, kv_pos = tail_pos(*shape[1:3])
        spec = AttnSpec(causal=True)
        go = torch.randn(qkv[0].shape, generator=gen, device=dev).to(dtype)
        design = FA.plan(qkv[0].shape, qkv[1].shape, dtype, dtype, dtype).variant
        hold_op(torch, TS, f"flash_attention {dname} {label}",
                lambda q, k, v: FA.attention(q, k, v, q_pos, kv_pos, spec),
                lambda q, k, v: FA.attention_plain(q, k, v, q_pos, kv_pos, spec),
                qkv, "qkv", go, TOL[dname], read_variants, {design: 1}, compiled)
        if label.startswith("arch_") and design != "cuda_core":
            fail(f"flash_attention {label} takes {design}, not cuda_core")
        del qkv, go

    # ---- 4. codec kernels against plain -----------------------------------
    phase("int8 codec kernels vs plain versions, bit for bit")
    codec_err = {"quantize_absmax": 0.0, "quantize_int8": 0.0,
                 "dequantize_int8": 0.0}

    def bits(t):
        return t.reshape(-1).view(torch.int32)

    def note(name, a, b):
        err = (a.double() - b.double()).abs().max().item()
        codec_err[name] = max(codec_err[name], err)
        return err

    def codec_check(label, xs):
        """``xs`` on one shared scale, through the kernels and the plain
        versions; plus one int8_ef round of the first tensor with a
        residual carried in. Fails unless every output is equal bit for
        bit."""
        acc = Q.new_absmax(dev)
        for x in xs:
            Q.absmax_into(x, acc)
        kq = [Q.quantize_with(x, acc) for x in xs]
        kd = [Q.dequantize_int8(q, s) for q, s in kq]
        pam = torch.stack([Q.absmax_plain(x) for x in xs]).amax()
        pq = [Q.quantize_plain(x, pam) for x in xs]
        pd = [Q.dequantize_plain(q, s) for q, s in pq]
        err_in = torch.randn(xs[0].shape, generator=gen, device=dev) * 0.01
        kef_d, kef_e = C.compress_decompress(xs[0], "int8_ef", err_in)
        carried = xs[0].float() + err_in
        pef_q, pef_s = Q.quantize_plain(carried, Q.absmax_plain(carried))
        pef_d = Q.dequantize_plain(pef_q, pef_s)
        pef_e = carried - pef_d
        torch.cuda.synchronize()
        ok = torch.equal(bits(acc), bits(pam))
        note("quantize_absmax", acc.reshape(()), pam)
        for (q, s), (qp, sp), d, dp in zip(kq, pq, kd, pd):
            ok &= (torch.equal(q, qp) and torch.equal(bits(s), bits(sp))
                   and torch.equal(bits(d), bits(dp)))
            note("quantize_int8", q, qp)
            note("dequantize_int8", d, dp)
        ok &= (torch.equal(bits(kef_d), bits(pef_d))
               and torch.equal(bits(kef_e), bits(pef_e)))
        n = sum(x.numel() for x in xs)
        print(f"  {label:34s} {len(xs):2d} x {tuple(xs[0].shape)} "
              f"{str(xs[0].dtype).split('.')[-1]:8s} n={n:10d} "
              f"scale={kq[0][1].item():.9g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"codec kernels disagree with their plain versions: {label}")

    rng = np.random.default_rng(0)

    def on_card(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(dtype)

    for shape in QUANT_SHAPES:
        codec_check(f"reference {shape}", [on_card(rng.standard_normal(shape) * 3.0)])
    for i in range(20):       # built as tests/test_kernels.py builds them
        mx = np.float32(rng.uniform(0.5, 5.0))
        sc = np.float32(mx / np.float32(127.0))
        x = (rng.integers(-126, 126, 512).astype(np.float32) + np.float32(0.5)) * sc
        x[0] = mx
        codec_check(f"half-ulp boundaries {i}", [on_card(x)])
    codec_check("zero tensor", [torch.zeros(33, device=dev)])
    for n in sorted(rng.integers(1, 601, 12).tolist()) + [1, 600]:
        mag = 10.0 ** rng.uniform(-3, 3)
        codec_check(f"random size {n}", [on_card(rng.standard_normal(n) * mag)])
    codec_check("unaligned start", [torch.randn(1001, generator=gen, device=dev)[1:]])
    codec_check("bf16", [on_card(rng.standard_normal((96, 40)) * 2.0, torch.bfloat16)])
    codec_check("bf16 ragged", [on_card(rng.standard_normal(1003), torch.bfloat16)])
    V, D, Ff, L = tcfg_full.vocab_size, tcfg_full.d_model, tcfg_full.d_ff, tcfg_full.n_layers
    codec_check(f"embed grad [{V}, {D}]",
                [torch.randn(V, D, generator=gen, device=dev) * 1e-3])
    for name, shape in (("w_gate", (Ff, D)), ("w_up", (Ff, D)), ("w_down", (D, Ff))):
        mags = torch.logspace(-4, -1, L, device=dev)[torch.randperm(
            L, generator=gen, device=dev)]
        codec_check(f"stacked {name} {L} x {shape} shared scale",
                    [torch.randn(shape, generator=gen, device=dev) * m for m in mags])
    print(f"  max |kernel - plain|: {codec_err}", flush=True)
    if any(codec_err.values()):
        fail(f"codec kernels not bit-identical: {codec_err}")
    torch.cuda.empty_cache()

    # ---- 5. SSD scan kernel against plain ---------------------------------
    phase("ssd_scan kernel vs plain version")
    mfull = get_config(SSM_ARCH)
    ms = mfull.ssm
    m_heads = ms.expand * mfull.d_model // ms.head_dim
    ssd_train = (TRAIN_BATCH, TRAIN_SEQ, m_heads, ms.head_dim, ms.n_groups,
                 ms.d_state, ms.chunk_size)
    ssd_prefill = (BATCH, ms.chunk_size, m_heads, ms.head_dim, ms.n_groups,
                   ms.d_state, ms.chunk_size)
    # zamba2-1.2b's Mamba2 layers: 64 heads of 64 (expand 2 x 2048), d_state 64
    zs = get_config(HYBRID_ARCH).ssm
    z_ssd_heads = zs.expand * get_config(HYBRID_ARCH).d_model // zs.head_dim
    zssd_train = (TRAIN_BATCH, TRAIN_SEQ, z_ssd_heads, zs.head_dim, zs.n_groups,
                  zs.d_state, zs.chunk_size)
    zssd_prefill = (BATCH, zs.chunk_size, z_ssd_heads, zs.head_dim, zs.n_groups,
                    zs.d_state, zs.chunk_size)

    def ssd_inputs(b, l, h, p, g, n, chunk, dtype, real=None, pad=0):
        """x, dt, A, B, C, D scaled as the reference's kernel tests. x, B and
        C are slices of one [b, l, h*p + 2*g*n + pad] tensor, as the model
        hands them over (the conv output), so the kernels read them through
        strides; pad = 4 leaves bf16 rows that are not 16-byte aligned. Rows
        from ``real`` on are zero, dt too, as ``mamba2_forward`` pads a
        prompt up to a chunk multiple."""
        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        xbc = torch.cat([r(b, l, h * p) * 0.5, r(b, l, 2 * g * n + pad) * 0.3], dim=-1)
        dt = F.softplus(r(b, l, h)) * 0.2
        if real is not None:
            xbc[:, real:] = 0
            dt[:, real:] = 0
        xbc = xbc.to(dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        B = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        C = xbc[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
        return x, dt, -torch.exp(r(h) * 0.3), B, C, torch.ones(h, device=dev)

    def ssd_design(ins, chunk):
        x, _, _, B, C, _ = ins
        return SSD.plan(x.shape, B.shape, x.dtype, chunk,
                        (x.stride(), B.stride(), C.stride()),
                        (x.data_ptr(), B.data_ptr(), C.data_ptr())).variant

    # (label, case, real rows, pad, design in bf16); fp32 always takes the
    # CUDA-core kernel. The reference's third case (p 16, n 32) is the only
    # one the tensor-core kernel takes; the aimed cases cover two groups, an
    # odd count of q tiles (chunk 48), n = 256 and a misaligned slice.
    ssd_cases = ([(f"ref{c}", c, None, 0, "mma" if c == SSD_CASES[2] else "cuda_core")
                  for c in SSD_CASES]
                 + [(f"train{list(ssd_train)}", ssd_train, None, 0, "mma"),
                    (f"prefill{list(ssd_prefill)} {PROMPT} real", ssd_prefill, PROMPT,
                     0, "mma"),
                    (f"zamba2_train{list(zssd_train)}", zssd_train, None, 0, "mma"),
                    (f"zamba2_prefill{list(zssd_prefill)} {PROMPT} real", zssd_prefill,
                     PROMPT, 0, "mma"),
                    ("mma_groups", (2, 128, 4, 32, 2, 64, 64), None, 0, "mma"),
                    ("mma_odd_q_tiles", (1, 96, 2, 128, 1, 16, 48), None, 0, "mma"),
                    ("mma_n256", (2, 256, 4, 64, 1, 256, 128), None, 0, "mma"),
                    ("misaligned_rows", (2, 128, 4, 64, 1, 128, 64), None, 4,
                     "cuda_core")]
                 # phase 21's ssm trial (d_state 8: CUDA-core) and the sweep's
                 # other state sizes, which SSD.plan sends to the tensor cores
                 + [(label, case, None, 0, "cuda_core") for kw in ARCH_SWEEP_POINTS
                    for label, case in arch_sweep_shapes(SW, MD, kw)[1]]
                 + [(f"arch_ssm_n{n}", (4, 64, 8, 16, 1, n, 32), None, 0, "mma")
                    for n in (16, 32)])
    ssd_err = ssd_mma_gap = None
    ssd_designs_seen = collections.Counter()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = SSD_TOL[dname]
        for label, case, real, pad, design in ssd_cases:
            design = design if dtype == torch.bfloat16 else "cuda_core"
            ins = ssd_inputs(*case, dtype, real=real, pad=pad)
            if ssd_design(ins, case[-1]) != design:
                fail(f"SSD.plan sends {dname} {label} to {ssd_design(ins, case[-1])}, "
                     f"expected {design}")
            before = read_ssd_variants()
            y, st = SSD.ssd_scan(*ins, case[-1])
            yp, sp = SSD.ssd_plain(*ins, chunk=case[-1], return_state=True)
            torch.cuda.synchronize()
            launched = {d: c - before[d] for d, c in read_ssd_variants().items()
                        if c != before[d]}
            ssd_designs_seen.update(launched)
            errs = [(a.float() - b.float()).abs().max().item() for a, b in ((y, yp), (st, sp))]
            ok = all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
                     for a, b in ((y, yp), (st, sp)))
            gap = ""
            if design == "mma":
                ym, sm = SSD.ssd_mma_plain(*ins, chunk=case[-1])
                gaps = [(a.float() - b.float()).abs().max().item()
                        for a, b in ((y, ym), (st, sm))]
                gap = f" | vs ssd_mma_plain y {gaps[0]:.3e} state {gaps[1]:.3e}"
                if case == ssd_train:
                    ssd_mma_gap = max(gaps)
                del ym, sm
            print(f"  {dname:8s} {label:44s} {design:9s} y max_abs_err={errs[0]:.3e} "
                  f"state max_abs_err={errs[1]:.3e} (max |y| "
                  f"{yp.float().abs().max().item():.3f}) tol={tol:g} "
                  f"{'ok' if ok else 'FAIL'}{gap}", flush=True)
            if launched != {design: 1}:
                fail(f"ssd_scan {dname} {label} launched {launched}, expected {design}")
            if not ok:
                fail(f"ssd_scan disagrees with its plain version: {dname} {label} {errs}")
            if dtype == torch.bfloat16 and case == ssd_train:
                ssd_err = max(errs)
            del ins, y, st, yp, sp
    print(f"  SSD launches by design over these cases: {dict(ssd_designs_seen)}",
          flush=True)
    if set(ssd_designs_seen) != set(SSD.VARIANTS):
        fail(f"the SSD cases did not run every design: {dict(ssd_designs_seen)}")

    # The custom op every call on the card goes through: forward the kernel
    # (at the training shape the tensor-core one in bf16), backward the
    # plain recompute; the final state goes unused, as in training, so its
    # gradient comes in as None. At the training shape eagerly (as the
    # eager LM steps call it), at phase 21's ssm shape (d_state 8:
    # CUDA-core) eagerly and compiled.
    op_cases = [("train", ssd_train, dtype, False)
                for dtype in (torch.bfloat16, torch.float32)]
    op_cases += [(label, case, torch.bfloat16, compiled) for kw in ARCH_SWEEP_POINTS
                 for label, case in arch_sweep_shapes(SW, MD, kw)[1]
                 for compiled in (False, True)]
    for label, case, dtype, compiled in op_cases:
        dname = str(dtype).split(".")[-1]
        chunk = case[-1]
        ins = [t.detach().requires_grad_(True) for t in ssd_inputs(*case, dtype)]
        design = ssd_design(ins, chunk)
        want = ("mma" if dtype == torch.bfloat16 else "cuda_core") if label == "train" \
            else "cuda_core"
        if design != want:
            fail(f"SSD.plan sends the {dname} {label} op call to {design}, expected {want}")
        go = torch.randn(ins[0].shape, generator=gen, device=dev).to(dtype)
        hold_op(torch, TS, f"ssd_scan {dname} {label}",
                lambda *a: SSD.ssd_scan_op(*a, chunk)[0],
                lambda *a: SSD.ssd_plain(*a, chunk=chunk),
                ins, ("x", "dt", "A", "B", "C", "D"), go, SSD_TOL[dname],
                read_ssd_variants, {design: 1}, compiled)
        del ins, go
    torch.cuda.empty_cache()

    # ---- 6-7. full-width serve; decode against prefill ---------------------
    lm_counts, lm_designs, lm_ssd = lm_serve(torch, dev, card, ARCH, env, "")

    # ---- 8. full-width training; a profiled train step ---------------------
    for acc, got in zip((lm_counts, lm_designs, lm_ssd),
                        lm_train(torch, dev, card, TRAIN_ARCH, env, "",
                                 TrainConfig().learning_rate, "none")):
        acc.update(got)

    # ---- 9. compress_tree on full-width grads ------------------------------
    phase("compress_tree on full-width grads vs plain")
    tcfg = TrainConfig(optimizer="adamw", grad_compression="int8_ef",
                       remat_policy="none", total_steps=TRAIN_STEPS,
                       warmup_steps=TRAIN_STEPS // 10)
    state = TS.init_train_state(tcfg_full, tcfg, seed=0, device=dev)
    batch = {k: v.to(dev) for k, v in make_batch_for(
        tcfg_full, TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    _, _, grads = TS._grad_fn(tcfg_full, tcfg)(state.params, batch)
    n_ref_leaves = len(reference_leaves(grads))

    def plain_compress_tree(g_tree, e_tree):
        """int8_ef per reference leaf in plain PyTorch; a missing residual
        starts at zeros, as in ``compress_tree`` (-0.0 + 0.0 is +0.0)."""
        gl = [g.float() for g in tree_leaves(g_tree)]
        el = ([torch.zeros_like(g) for g in gl] if e_tree is None
              else tree_leaves(e_tree))
        out_g, out_e = list(gl), list(gl)
        for _, idx in reference_leaves(g_tree):
            carried = [gl[i] + el[i] for i in idx]
            am = torch.stack([Q.absmax_plain(c) for c in carried]).amax()
            for i, c in zip(idx, carried):
                d = Q.dequantize_plain(*Q.quantize_plain(c, am))
                out_g[i], out_e[i] = d, c - d
        return out_g, out_e

    ef = None
    for rnd in range(2):                     # a fresh residual, then a carried one
        # the plain version first: compress_tree writes its residuals into ef
        pg, pef = plain_compress_tree(grads, ef)
        kg, ef = C.compress_tree(grads, "int8_ef", ef)
        torch.cuda.synchronize()
        same = all(torch.equal(bits(a), bits(b)) for a, b in
                   zip(tree_leaves(kg) + tree_leaves(ef), pg + pef))
        for a, b in zip(tree_leaves(kg), pg):
            note("dequantize_int8", a, b)
        print(f"  round {rnd}: {len(pg)} tensors in {n_ref_leaves} reference "
              f"leaves, grads and residuals {'bit-identical' if same else 'FAIL'}",
              flush=True)
        if not same:
            fail("compress_tree on the card disagrees with its plain version")
    del grads, kg, pg, pef, ef, state, batch
    torch.cuda.empty_cache()

    # ---- 10. full-width mamba2 serve ----------------------------------------
    phase(f"serve {SSM_ARCH} at full width (batch {BATCH}, prompt {PROMPT}, gen {GEN})")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    served = serve.main(["--arch", SSM_ARCH, "--batch", str(BATCH),
                         "--prompt-len", str(PROMPT), "--gen", str(GEN),
                         "--device", "cuda"])
    mserve_counts = read_counts()
    mserve_variants = read_variants()
    mserve_ssd = read_ssd_variants()
    expected = {k: 0 for k in counters}     # decode runs the O(1) recurrence
    rep = served.report
    print(f"  launches {mserve_counts} (expected {expected}); "
          f"prefill_s {rep['prefill_s']} decode_s {rep['decode_s']} "
          f"decode_tok_per_s {rep['decode_tok_per_s']} peak_mem_GB "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; card {card}", flush=True)
    if mserve_counts != expected:
        fail(f"{SSM_ARCH} serve launched the kernels {mserve_counts}, expected {expected}")
    gate_variants(f"{SSM_ARCH} serve", mserve_variants)
    gate_ssd_variants(f"{SSM_ARCH} serve", mserve_ssd)
    if not torch.isfinite(served.logits.float()).all():
        fail(f"{SSM_ARCH} serve produced non-finite logits")
    if served.tokens.shape != (BATCH, GEN) or not (
            (served.tokens >= 0) & (served.tokens < mfull.vocab_size)).all():
        fail(f"{SSM_ARCH} serve tokens out of range or shape {tuple(served.tokens.shape)}")
    del served

    # ---- 11. mamba2 decode loop against prefill at full width --------------
    # MD.prefill runs the SSD kernel once per layer over the prompt padded to
    # one chunk; its logits and its caches (conv tails, final SSD states) are
    # held to the decode loop's, which runs the recurrence. Asserted in fp32
    # (logits bf16, so the bf16 tolerance; caches SSM_CACHE_TOL), reported
    # for the served bf16 model, whose decode steps are then profiled.
    phase(f"{SSM_ARCH} decode loop vs MD.prefill at full width")
    mprompt = make_batch_for(mfull, BATCH, PROMPT)["tokens"].to(dev)
    prefill_ssd = {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(mfull, dtype=dname, param_dtype=dname)
        with torch.inference_mode():
            params = MD.init_model(cfg, seed=0, device=dev)
            caches = MD.init_decode_caches(cfg, BATCH, PROMPT + GEN,
                                           dtype=MD.dtype_of(cfg), device=dev)
            for pos in range(PROMPT):
                dec, caches = MD.decode_step(params, cfg, caches,
                                             mprompt[:, pos:pos + 1], pos)
            torch.cuda.synchronize()
            reset_counts()
            pre, pcaches = MD.prefill(params, cfg, {"tokens": mprompt})
            torch.cuda.synchronize()
            prefill_counts = read_counts()
            prefill_ssd[dname] = read_ssd_variants()
        want = {**{k: 0 for k in counters}, "ssd_scan": cfg.n_layers}
        if prefill_counts != want:
            fail(f"{SSM_ARCH} prefill launched {prefill_counts}, expected {want}")
        gate_ssd_variants(f"{SSM_ARCH} {dname} prefill", prefill_ssd[dname],
                          **{"mma" if dname == "bfloat16" else "cuda_core": cfg.n_layers})
        err = (dec.float() - pre.float()).abs().max().item()
        ok = torch.allclose(dec.float(), pre.float(), atol=TOL["bfloat16"],
                            rtol=TOL["bfloat16"])
        cache_errs = {}
        for name, got, ref in zip(("conv tails", "final SSD states"), pcaches[0], caches[0]):
            cache_errs[name] = (got.float() - ref.float()).abs().max().item()
            ok &= got.shape == ref.shape and torch.allclose(
                got.float(), ref.float(), atol=SSM_CACHE_TOL, rtol=SSM_CACHE_TOL)
        agree = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
        verdict = ("ok" if ok else "FAIL") if dname == "float32" else "reported"
        print(f"  {dname:8s} prefill launches {prefill_counts['ssd_scan']}; last-position "
              f"logits max_abs_err={err:.3e} (max |logit| {pre.float().abs().max().item():.3f}) "
              f"tol={TOL['bfloat16']:g}, argmax agreement {agree:.2f}; caches max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in cache_errs.items())
              + f" tol={SSM_CACHE_TOL:g} {verdict}", flush=True)
        if dname == "float32" and not ok:
            fail(f"{SSM_ARCH} prefill disagrees with the decode loop: logits {err}, "
                 f"caches {cache_errs}")
        if dname == "bfloat16":
            tok, pos = dec.argmax(-1)[:, None], [PROMPT]

            def decode_one():
                nonlocal caches
                _, caches = MD.decode_step(params, cfg, caches, tok, pos[0])
                pos[0] += 1

            with torch.inference_mode():
                profile_steps(torch, decode_one, 4,
                              f"{SSM_ARCH} decode step at full width, bf16, "
                              f"batch {BATCH}", card)
        del params, caches, pcaches
    torch.cuda.empty_cache()

    # ---- 12. full-width mamba2 training -------------------------------------
    msteps = TRAIN_STEPS_BY_ARCH[SSM_ARCH]
    phase(f"train {SSM_ARCH} at full width (batch {TRAIN_BATCH}, seq "
          f"{TRAIN_SEQ}, {msteps} steps, adamw, int8_ef)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mtrained = train.main(["--arch", SSM_ARCH, "--batch", str(TRAIN_BATCH),
                           "--seq", str(TRAIN_SEQ), "--steps", str(msteps),
                           "--optimizer", "adamw", "--compression", "int8_ef",
                           "--remat", "none", "--device", "cuda", "--log-every", "1"])
    mtrain_counts = read_counts()
    mtrain_variants = read_variants()
    mtrain_ssd = read_ssd_variants()
    # One kernel forward per layer per step (the backward recomputes the
    # plain version); the codec as in phase 8, over the mamba2 tree.
    mgroups = reference_leaves(MD.init_model(
        dataclasses.replace(reduced(mfull), n_layers=mfull.n_layers),
        seed=0, device="cpu"))
    m_tensors = sum(len(idx) for _, idx in mgroups)
    expected = {"flash_attention": 0,
                **{k: msteps * m_tensors for k in
                   ("quantize_absmax", "quantize_int8", "dequantize_int8")},
                "ssd_scan": msteps * mfull.n_layers}
    losses = mtrained["losses"]
    print(f"  launches {mtrain_counts} (expected {expected}: {m_tensors} "
          f"parameter tensors in {len(mgroups)} reference leaves); "
          f"step_ms {mtrained['step_ms']} tokens_per_s {mtrained['tokens_per_s']} "
          f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f}; losses "
          f"{[round(x, 3) for x in losses]}; card {card}", flush=True)
    if mtrain_counts != expected:
        fail(f"{SSM_ARCH} train launched the kernels {mtrain_counts}, expected {expected}")
    gate_variants(f"{SSM_ARCH} train", mtrain_variants)
    gate_ssd_variants(f"{SSM_ARCH} train", mtrain_ssd, mma=msteps * mfull.n_layers)
    if len(losses) != msteps or not all(np.isfinite(losses)):
        fail(f"{SSM_ARCH} train losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{SSM_ARCH} train loss did not fall: {losses}")
    del mtrained
    torch.cuda.empty_cache()

    holder = [TS.init_train_state(mfull, tcfg, seed=0, device=dev)]
    batch = {k: v.to(dev) for k, v in make_batch_for(
        mfull, TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    step_fn = TS.make_train_step(mfull, tcfg)     # launch.train's step

    def train_one():
        holder[0], _ = step_fn(holder[0], batch)

    what = (f"{SSM_ARCH} train step at full width, bf16, batch {TRAIN_BATCH} x seq "
            f"{TRAIN_SEQ}, adamw + int8_ef")
    # The step on the path's design (mma), then with the SSD forward sent to
    # the CUDA-core kernel (``SSD.plan`` replaced for this comparison only):
    # what the design is worth end to end on one card.
    step_stats = collections.defaultdict(list)
    for design in ("mma", "cuda_core"):
        with contextlib.ExitStack() as stack:
            if design == "cuda_core":
                stack.enter_context(unittest.mock.patch.object(
                    SSD, "plan", lambda x_shape, B_shape, dtype, chunk, *_, **__: SSD.Plan(
                        "cuda_core", SSD.smem_bytes(x_shape[3], B_shape[3], chunk))))
            step_stats[design].append(profile_steps(
                torch, train_one, PROFILE_TRAIN_STEPS, f"{what}, SSD forward on {design}",
                card))
    print(f"  {SSM_ARCH} train step by SSD forward design (host wall, device busy "
          f"ms/step): {dict(step_stats)}; card {card}", flush=True)
    del holder, step_fn, batch
    torch.cuda.empty_cache()

    # ---- 13. timings -------------------------------------------------------
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

    def bound(n_bytes, n_ops, dtype):
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    # Flash attention rows: (label, (B, Sq, Skv), heads, spec, SDPA's own
    # form of the mask). Each row's q_pos/kv_pos leave SDPA a mask it can take
    # without a tensor: none at decode (every key attendable) and non-causal,
    # is_causal at prefill and training (Sq = Skv). library_ms is that call;
    # library_mask_ms is SDPA given the mask as a boolean tensor, the
    # yardstick of PR 13's rows. Both are checked against the plain version.
    # AttnSpec() is causal by default, so "train512" is the causal work.
    rows = {}
    t_dims = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ)
    for label, (B, Sq, Skv), (nh, nkv, dh), spec, sdpa_form in (
            ("decode_cap64", (BATCH, 1, PROMPT + GEN), (hq, hkv, hd), AttnSpec(), "none"),
            ("decode_cap4096", (BATCH, 1, 4096), (hq, hkv, hd), AttnSpec(), "none"),
            (f"prefill{PROMPT}", (BATCH, PROMPT, PROMPT), (hq, hkv, hd), AttnSpec(),
             "is_causal"),
            (f"train{TRAIN_SEQ}", t_dims, t_heads, AttnSpec(), "is_causal"),
            (f"train{TRAIN_SEQ}_noncausal", t_dims, t_heads, AttnSpec(causal=False),
             "none")):
        q, k, v = inputs(B, Sq, Skv, nh, nkv, dh, torch.bfloat16)
        q_pos, kv_pos = tail_pos(Sq, Skv)
        mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        own_kw = {"is_causal": True} if sdpa_form == "is_causal" else {}

        def sdpa_own():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **own_kw)

        def sdpa_mask():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  attn_mask=mask[None, None])

        ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
        lib_err = {}
        for name, fn in (("own", sdpa_own), ("mask", sdpa_mask)):
            got = fn().transpose(1, 2).float()
            lib_err[name] = (got - ref.float()).abs().max().item()
            if not torch.allclose(got, ref.float(), atol=TOL["bfloat16"],
                                  rtol=TOL["bfloat16"]):
                fail(f"SDPA ({name}) is not the {label} row's function: {lib_err}")
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (q, k, v, ref, q_pos, kv_pos))
        n_ops = 4 * B * nh * dh * int(mask.sum().item())   # unmasked pairs only
        bound_ms, bound_by = bound(n_bytes, n_ops, "bfloat16")
        design = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
        row = {
            "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
            "library_ms": time_ms(sdpa_own), "library_call": f"sdpa {sdpa_form}",
            "library_mask_ms": time_ms(sdpa_mask),
            "bound_ms": bound_ms, "bound_by": bound_by, "causal": spec.causal,
            "design": design.variant, "n_splits": design.n_splits,
        }
        rows[label] = row
        print(f"  {label:18s} q [{B},{Sq},{nh},{dh}] kv [{B},{Skv},{nkv},{dh}] bf16 "
              f"causal={spec.causal} {design.variant} ({design.n_splits} split): "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa ({sdpa_form}) {row['library_ms']:.4f} ms, sdpa (bool mask) "
              f"{row['library_mask_ms']:.4f} ms (|sdpa-plain| {lib_err['own']:.2e}, "
              f"{lib_err['mask']:.2e}), kernel/sdpa {row['ms'] / row['library_ms']:.3f}, "
              f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
              f"({n_bytes} B, {n_ops} flop); card {card}", flush=True)
        del q, k, v, ref, qt, kt, vt, mask

    # Flash attention at the sharded servers' per-rank decode shapes (phase
    # 23): qwen2.5-3b tp at 2 x 2 (each rank 2 rows, 8 q heads over 1 kv head,
    # 64 slots, bf16: split-KV) and the fp32 4-layer cut at 2 x 4 (2 rows,
    # the attention whole: 16 over 2, PROMPT + SERVE_FP32_GEN slots: CUDA
    # cores), each beside SDPA (no mask: every slot attendable) and its bound.
    qcfg = get_config(ARCH)
    qh, qkv, qd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.get_head_dim()
    for label, (B, Sq, Skv), (nh, nkv, dh), dname in (
            ("decode_rank_tp", (BATCH // 2, 1, PROMPT + GEN), (qh // 2, qkv // 2, qd),
             "bfloat16"),
            ("decode_rank_fp32", (BATCH // 2, 1, PROMPT + SERVE_FP32_GEN), (qh, qkv, qd),
             "float32")):
        dtype = getattr(torch, dname)
        q, k, v = inputs(B, Sq, Skv, nh, nkv, dh, dtype)
        q_pos, kv_pos = tail_pos(Sq, Skv)
        spec = AttnSpec()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
        got = FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.allclose(got.float(), ref.float(), atol=TOL[dname], rtol=TOL[dname]):
            fail(f"flash attention at the {label} shape: {err:.3e}")
        lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True).transpose(1, 2)
        if not torch.allclose(lib.float(), ref.float(), atol=TOL[dname], rtol=TOL[dname]):
            fail(f"SDPA is not the {label} row's function")
        mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ref, q_pos, kv_pos))
        bound_ms, bound_by = bound(n_bytes, 4 * B * nh * dh * int(mask.sum().item()), dname)
        design = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
        rows[label] = {
            "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True)), "library_call": "sdpa none",
            "bound_ms": bound_ms, "bound_by": bound_by, "causal": True,
            "design": design.variant, "n_splits": design.n_splits, "max_abs_err": err,
            "dtype": dname}
        r = rows[label]
        print(f"  {label:18s} q [{B},{Sq},{nh},{dh}] kv [{B},{Skv},{nkv},{dh}] {dname} "
              f"{design.variant} ({design.n_splits} split): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by}, |kernel-plain| {err:.3e}; card {card}",
              flush=True)
        del q, k, v, ref, got, lib, qt, kt, vt, mask

    # Flash attention at gemma2-2b's, whisper-tiny's, zamba2-1.2b's shared
    # block's, llama4-scout's, nemotron-4-15b's and deepseek-v3's MLA prefill
    # shapes (and the decode ones of the first four), each beside
    # its bound and yardstick (SDPA wherever there is no softcap; zamba2's
    # window does not bite at these lengths, and MLA's v is the zero-padded
    # one at qk dim 192). whisper's encoder and cross-attention decode are
    # SDPA's own function (no mask). SDPA cannot apply gemma2's softcap, so its
    # SDPA time is of the function without it ("sdpa_no_softcap_ms", is_causal;
    # the 4096 window does not bite at these lengths), and its library call is
    # flex_attention compiled with a tanh-softcap score_mod and the causal
    # window as a block mask; each is checked against the plain version of
    # what it computes.
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    flex = torch.compile(flex_attention)

    def flex_call(q, k, v, q_pos, kv_pos, spec):
        off = kv_pos.shape[0] - q_pos.shape[0]      # tail positions

        def score_mod(s, b, h, qi, ki):
            return torch.tanh(s / spec.logit_softcap) * spec.logit_softcap

        def mask_mod(b, h, qi, ki):
            return (ki <= qi + off) & (ki > qi + off - spec.window)

        mask = create_block_mask(mask_mod, None, None, q.shape[1], k.shape[1], device=dev)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                            enable_gqa=True)

    for label, (B, Sq, Skv), (nh, nkv, dh), spec, (q_pos, kv_pos) in (
            (f"gemma2_train{TRAIN_SEQ}", t_dims, g_heads, g_spec,
             tail_pos(TRAIN_SEQ, TRAIN_SEQ)),
            (f"gemma2_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN), g_heads, g_spec,
             tail_pos(1, PROMPT + GEN)),
            (f"gemma2_prefill{PROMPT}", (BATCH, PROMPT, PROMPT), g_heads, g_spec,
             tail_pos(PROMPT, PROMPT)),
            ("gemma2_decode_cap4096", (BATCH, 1, 4096), g_heads, g_spec, tail_pos(1, 4096)),
            (f"whisper_encoder{t_enc}", (BATCH, t_enc, t_enc), w_heads,
             AttnSpec(causal=False), (arange(0, t_enc), arange(0, t_enc))),
            (f"whisper_cross_decode{t_enc}", (BATCH, 1, t_enc), w_heads,
             AttnSpec(causal=False), (arange(PROMPT, PROMPT + 1), arange(0, t_enc))),
            (f"zamba2_train{TRAIN_SEQ}", t_dims, z_heads, z_spec,
             tail_pos(TRAIN_SEQ, TRAIN_SEQ)),
            (f"zamba2_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN), z_heads, z_spec,
             tail_pos(1, PROMPT + GEN)),
            (f"llama4_prefill{PROMPT}", (BATCH, PROMPT, PROMPT), l_heads, AttnSpec(),
             tail_pos(PROMPT, PROMPT)),
            (f"llama4_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN), l_heads,
             AttnSpec(), tail_pos(1, PROMPT + GEN)),
            (f"deepseek_mla_prefill{PROMPT}", (BATCH, PROMPT, PROMPT), d_heads, AttnSpec(),
             tail_pos(PROMPT, PROMPT)),
            (f"llama4_train{TRAIN_SEQ}", t_dims, l_heads, AttnSpec(causal=True),
             tail_pos(TRAIN_SEQ, TRAIN_SEQ)),
            (f"zamba2_prefill{PROMPT}", (BATCH, PROMPT, PROMPT), z_heads, z_spec,
             tail_pos(PROMPT, PROMPT)),
            (f"nemotron_prefill{PROMPT}", (BATCH, PROMPT, PROMPT), n_heads, AttnSpec(),
             tail_pos(PROMPT, PROMPT)),
            (f"nemotron_decode_cap{PROMPT + GEN}", (BATCH, 1, PROMPT + GEN), n_heads,
             AttnSpec(), tail_pos(1, PROMPT + GEN))):
        q, k, v = inputs(B, Sq, Skv, nh, nkv, dh, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
        mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
        causal_kw = {"is_causal": True} if spec.causal and Sq > 1 else {}

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **causal_kw)

        def agrees(fn, want, what):
            got = fn().transpose(1, 2).float()
            err = (got - want.float()).abs().max().item()
            if not torch.allclose(got, want.float(), atol=TOL["bfloat16"],
                                  rtol=TOL["bfloat16"]):
                fail(f"{what} is not the {label} row's function: max_abs_err {err}")
            return err

        out = FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
        kernel_err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=TOL["bfloat16"],
                              rtol=TOL["bfloat16"]):
            fail(f"flash_attention is not the {label} row's function: "
                 f"max_abs_err {kernel_err}")
        del out
        row = {"max_abs_err": kernel_err,
               "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
               "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
               "causal": spec.causal, "window": spec.window,
               "softcap": spec.logit_softcap}
        before_txt = ""
        if dh > 128:      # the CUDA-core design these head dims took before
            core = FA._launch(q, k, v, q_pos, kv_pos, spec, cuda_core=True)
            if not torch.allclose(core.float(), ref.float(), atol=TOL["bfloat16"],
                                  rtol=TOL["bfloat16"]):
                fail(f"the CUDA-core kernel is not the {label} row's function")
            row["cuda_core_ms"] = time_ms(
                lambda: FA._launch(q, k, v, q_pos, kv_pos, spec, cuda_core=True))
            before_txt = (f", before (cuda_core) {row['cuda_core_ms']:.4f} ms "
                          f"({row['cuda_core_ms'] / row['ms']:.1f}x)")
            del core
        if spec.logit_softcap:
            no_cap = spec._replace(logit_softcap=0.0)
            sdpa_err = agrees(sdpa, FA.attention_plain(q, k, v, q_pos, kv_pos, no_cap),
                              "SDPA without the softcap")
            row["sdpa_no_softcap_ms"] = time_ms(sdpa)
            lib = flex_call(q, k, v, q_pos, kv_pos, spec)
            lib_err = agrees(lib, ref, "flex_attention")
            row["library_ms"], row["library_call"] = time_ms(lib), "flex_attention"
            lib_txt = (f"flex_attention {row['library_ms']:.4f} ms (|flex-plain| "
                       f"{lib_err:.2e}), sdpa without the softcap "
                       f"{row['sdpa_no_softcap_ms']:.4f} ms (|sdpa-plain without it| "
                       f"{sdpa_err:.2e})")
        else:
            sdpa_err = agrees(sdpa, ref, "SDPA")
            row["library_ms"], row["library_call"] = time_ms(sdpa), "sdpa none"
            lib_txt = f"sdpa {row['library_ms']:.4f} ms (|sdpa-plain| {sdpa_err:.2e})"
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ref, q_pos, kv_pos))
        n_ops = 4 * B * nh * dh * int(mask.sum().item())
        row["bound_ms"], row["bound_by"] = bound(n_bytes, n_ops, "bfloat16")
        design = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
        row["design"], row["n_splits"] = design.variant, design.n_splits
        rows[label] = row
        print(f"  {label:26s} q [{B},{Sq},{nh},{dh}] kv [{B},{Skv},{nkv},{dh}] bf16 "
              f"causal={spec.causal} window={spec.window} softcap={spec.logit_softcap:g} "
              f"{design.variant} ({design.n_splits} split): kernel {row['ms']:.4f} ms "
              f"(|kernel-plain| {kernel_err:.2e})"
              f"{before_txt}, plain {row['plain_ms']:.4f} ms, {lib_txt}, bound "
              f"{row['bound_ms']:.6f} ms by {row['bound_by']} ({n_bytes} B, {n_ops} flop), "
              f"kernel/bound {row['ms'] / row['bound_ms']:.1f}; card {card}", flush=True)
        del q, k, v, qt, kt, vt, ref, mask

    # What the tile kernel's time is made of: non-causal calls at the training
    # shape over 1, 8 and 16 KV tiles of 64 keys (a line through them splits a
    # call into a fixed cost and a cost per tile), and over 8 tiles that each
    # hold one PAD slot, so that every tile takes the masked path; at
    # smollm's heads (64: 4 warps over 64 rows) and at gemma2's (256: 8 warps
    # over 128 rows, Q from shared memory).
    for key, heads in (("tile_cost", t_heads), ("tile_cost_hd256", g_heads)):
        tile_cost = {}
        for label, skv, pad in (("kv64", 64, False), ("kv512", 512, False),
                                ("kv1024", 1024, False), ("kv512_masked", 512, True)):
            q, k, v = inputs(TRAIN_BATCH, TRAIN_SEQ, skv, *heads, torch.bfloat16)
            q_pos, kv_pos = arange(0, TRAIN_SEQ), arange(0, skv)
            if pad:
                kv_pos[::64] = FA.PAD_POS
            tile_cost[label] = time_ms(lambda: FA.flash_attention(
                q, k, v, q_pos, kv_pos, AttnSpec(causal=False)))
            del q, k, v
        slope = (tile_cost["kv1024"] - tile_cost["kv64"]) / 15
        fixed = tile_cost["kv64"] - slope
        masked = (tile_cost["kv512_masked"] - fixed) / 8
        print(f"  tile kernel cost, non-causal q [{TRAIN_BATCH},{TRAIN_SEQ},{heads[0]},"
              f"{heads[2]}] over {heads[1]} kv heads: {tile_cost} ms; fixed {fixed:.4f} ms + "
              f"{slope:.4f} ms per KV tile; masked tiles {masked:.4f} ms per tile; card {card}",
              flush=True)
        rows[key] = {**tile_cost, "fixed_ms": fixed, "per_tile_ms": slope,
                     "masked_per_tile_ms": masked}

    # Codec kernels at the largest tensor the train step hands them, the
    # embedding's grad [vocab, d_model] in fp32 (one launch each).
    x = torch.randn(V, D, generator=gen, device=dev)
    N = x.numel()
    acc = Q.new_absmax(dev)
    Q.absmax_into(x, acc)
    qx, sx = Q.quantize_with(x, acc)
    pam = Q.absmax_plain(x)
    codec_work = {   # (kernel, plain, library or None, bytes, operations)
        "quantize_absmax": (lambda: Q.absmax_into(x, acc),
                            lambda: Q.absmax_plain(x),
                            lambda: torch.linalg.vector_norm(x, float("inf")),
                            4 * N + 4, 2 * N),
        "quantize_int8": (lambda: Q.quantize_with(x, acc),
                          lambda: Q.quantize_plain(x, pam),
                          None, 4 * N + 4 + N + 4, 4 * N),
        "dequantize_int8": (lambda: Q.dequantize_int8(qx, sx),
                            lambda: Q.dequantize_plain(qx, sx),
                            lambda: torch.mul(qx, sx), N + 4 + 4 * N, 2 * N),
    }
    for name, (kern, plain, lib_fn, n_bytes, n_ops) in codec_work.items():
        bound_ms, bound_by = bound(n_bytes, n_ops, "float32")
        rows[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                      "library_ms": None if lib_fn is None else time_ms(lib_fn),
                      "bound_ms": bound_ms, "bound_by": bound_by}
        r = rows[name]
        lib_txt = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  {name:16s} [{V},{D}] fp32: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib_txt}, bound "
              f"{r['bound_ms']:.6f} ms by {bound_by} ({n_bytes} B, {n_ops} op); "
              f"card {card}", flush=True)

    # The SSD kernels at the mamba2 and zamba2 training shapes and the
    # prefill checks' padded shapes, bf16: the design the path takes (``plan``: mma) and the
    # CUDA-core kernel on the same inputs, timed in turns (mma, CUDA-core,
    # CUDA-core, mma; each design's time is the mean of its two medians).
    # Bytes: each input read once, y and the state written once. Operations:
    # per (b, h, chunk), C·Bᵀ and its product with x over the causal (q, k)
    # pairs only, 2·pairs·(N + P), and the inter-chunk and state products,
    # 2·2·Q·P·N; the padded rows are counted, as the call gets them. No single
    # PyTorch call computes the SSD scan: library none.
    ssd_entry = {"mma": f"ssd_scan_mma_kernelILi{ms.head_dim}ELi{ms.d_state}E",
                 "cuda_core": "ssd_scan_kernelI13__nv_bfloat16E"}
    ssd_regs = {d: next(v for k, v in ptxas.items() if sub in k)
                for d, sub in ssd_entry.items()}
    for label, case, real in (("ssd_train", ssd_train, None),
                              ("ssd_prefill", ssd_prefill, PROMPT),
                              ("zamba2_ssd_train", zssd_train, None),
                              ("zamba2_ssd_prefill", zssd_prefill, PROMPT)):
        b, l, h, p, g, n, Q = case
        ins = ssd_inputs(*case, torch.bfloat16, real=real)
        if ssd_design(ins, Q) != "mma":
            fail(f"SSD.plan does not send {label} to the mma kernel")
        core = SSD.Plan("cuda_core", SSD.smem_bytes(p, n, Q))
        outs = SSD.ssd_scan(*ins, Q)
        n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
        pairs = Q * (Q + 1) // 2
        n_ops = b * h * (l // Q) * (2 * pairs * (n + p) + 4 * Q * p * n)
        bound_ms, bound_by = bound(n_bytes, n_ops, "bfloat16")
        turns = collections.defaultdict(list)
        for design in ("mma", "cuda_core", "cuda_core", "mma"):
            fn = ((lambda: SSD.ssd_scan(*ins, Q)) if design == "mma"
                  else (lambda: SSD.launch(core, *ins, Q)))
            turns[design].append(time_ms(fn))
        design_ms = {d: sum(t) / len(t) for d, t in turns.items()}
        rows[label] = {
            "ms": design_ms["mma"], "cuda_core_ms": design_ms["cuda_core"],
            "turns_ms": dict(turns),
            "plain_ms": time_ms(lambda: SSD.ssd_plain(*ins, chunk=Q, return_state=True)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        r = rows[label]
        print(f"  {label:16s} x [{b},{l},{h},{p}] B/C [{b},{l},{g},{n}] chunk {Q} bf16: "
              f"mma {r['ms']:.4f} ms {turns['mma']}, cuda_core {r['cuda_core_ms']:.4f} ms "
              f"{turns['cuda_core']} ({r['cuda_core_ms'] / r['ms']:.1f}x), plain "
              f"{r['plain_ms']:.4f} ms, library none (no PyTorch call computes the SSD "
              f"scan), bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B, {n_ops} flop), "
              f"mma/bound {r['ms'] / bound_ms:.1f}; card {card}", flush=True)
        del ins, outs
    print(f"  ssd_scan registers and spills (-Xptxas -v): {ssd_regs}", flush=True)
    # Phase 21's arch-sweep shapes, one a kernel: flash attention at the lm
    # trial's compute-probe call (bf16, head_dim 16: CUDA-core; SDPA
    # is_causal beside it) and the SSD scan at the ssm trial's (d_state 8:
    # CUDA-core). Bytes and operations counted as in the rows above.
    (label, (B, Sq, Skv, nh, nkv, dh)), = [
        x for kw in ARCH_SWEEP_POINTS[:1]
        for x in arch_sweep_shapes(SW, MD, kw)[0] if x[0].endswith("compute")]
    q, k, v = inputs(B, Sq, Skv, nh, nkv, dh, torch.bfloat16)
    q_pos, kv_pos = tail_pos(Sq, Skv)
    spec = AttnSpec(causal=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
    lib = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, is_causal=True)
    if not torch.allclose(lib.transpose(1, 2).float(), ref.float(),
                          atol=TOL["bfloat16"], rtol=TOL["bfloat16"]):
        fail(f"SDPA is_causal is not the {label} row's function")
    mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ref, q_pos, kv_pos))
    bound_ms, bound_by = bound(n_bytes, 4 * B * nh * dh * int(mask.sum().item()),
                               "bfloat16")
    design = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
    rows[label] = {
        "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
        "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, is_causal=True)),
        "library_call": "sdpa is_causal", "bound_ms": bound_ms, "bound_by": bound_by,
        "causal": True, "design": design.variant, "shape": [B, Sq, Skv, nh, nkv, dh]}
    r = rows[label]
    print(f"  {label:16s} q [{B},{Sq},{nh},{dh}] kv {Skv} x {nkv} bf16 causal "
          f"{design.variant}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"sdpa is_causal {r['library_ms']:.4f} ms, bound {bound_ms:.6f} ms by "
          f"{bound_by}; card {card}", flush=True)
    del q, k, v, qt, kt, vt, ref, lib, mask
    (label, case), = [x for kw in ARCH_SWEEP_POINTS[2:]
                      for x in arch_sweep_shapes(SW, MD, kw)[1]
                      if x[0].endswith("compute")]
    b, l, h, p, g, n, Q = case
    ins = ssd_inputs(*case, torch.bfloat16)
    outs = SSD.ssd_scan(*ins, Q)
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    pairs = Q * (Q + 1) // 2
    bound_ms, bound_by = bound(n_bytes, b * h * (l // Q) * (2 * pairs * (n + p)
                                                             + 4 * Q * p * n),
                               "bfloat16")
    rows[f"{label}_ssd"] = {
        "ms": time_ms(lambda: SSD.ssd_scan(*ins, Q)), "design": ssd_design(ins, Q),
        "plain_ms": time_ms(lambda: SSD.ssd_plain(*ins, chunk=Q, return_state=True)),
        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": list(case)}
    r = rows[f"{label}_ssd"]
    print(f"  {label:16s} x [{b},{l},{h},{p}] B/C [{b},{l},{g},{n}] chunk {Q} bf16 "
          f"{r['design']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library none, bound {bound_ms:.6f} ms by {bound_by}; card {card}", flush=True)
    del ins, outs
    # What the custom op's dispatch adds to a call: host microseconds a call
    # of the kernel's wrapper alone and of the op the model calls
    # (``FA.attention``), without grads, at qwen's decode shape, 200 calls
    # back to back and one synchronise, in the order wrapper, op, op,
    # wrapper. The decode loops are host-bound, so a layer pays this.
    dfull = get_config(ARCH)
    dshape = (BATCH, 1, PROMPT + GEN, dfull.n_heads, dfull.n_kv_heads,
              dfull.get_head_dim())
    q, k, v = inputs(*dshape, torch.bfloat16)
    q_pos, kv_pos = tail_pos(1, PROMPT + GEN)
    spec = AttnSpec()

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    with torch.no_grad():
        calls = {"wrapper": lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec),
                 "op": lambda: FA.attention(q, k, v, q_pos, kv_pos, spec)}
        order = ("wrapper", "op", "op", "wrapper")
        got = [(name, host_us(calls[name])) for name in order]
    rows["op_dispatch"] = {f"{name}_us": [t for n, t in got if n == name]
                           for name in calls}
    rows["op_dispatch"]["shape"] = list(dshape)
    print(f"  op dispatch      host us a call at q {list(dshape)} bf16 (no grad): "
          f"{', '.join(f'{n} {t:.2f}' for n, t in got)}; card {card}", flush=True)
    del q, k, v
    # What the mma kernel's time is made of: 128 blocks (batch 4 x 32 heads,
    # one wave on 132 SMs) over 1, 2 and 4 chunks of 256; a line through them
    # splits a call into a fixed cost and a cost per chunk (a block's copies,
    # products and barriers for one chunk, none of them overlapped by another
    # block on its SM).
    ssd_cost = {}
    for n_chunks in (1, 2, 4):
        case = (BATCH, n_chunks * ms.chunk_size, m_heads, ms.head_dim, ms.n_groups,
                ms.d_state, ms.chunk_size)
        ins = ssd_inputs(*case, torch.bfloat16)
        ssd_cost[f"chunks{n_chunks}"] = time_ms(lambda: SSD.ssd_scan(*ins, ms.chunk_size))
        del ins
    per_chunk = (ssd_cost["chunks4"] - ssd_cost["chunks1"]) / 3
    ssd_fixed = ssd_cost["chunks1"] - per_chunk
    print(f"  ssd_scan mma cost, x [{BATCH},256k,{m_heads},{ms.head_dim}] (one wave): "
          f"{ssd_cost} ms; fixed {ssd_fixed:.4f} ms + {per_chunk:.4f} ms per chunk of "
          f"{ms.chunk_size}; card {card}", flush=True)
    rows["ssd_cost"] = {**ssd_cost, "fixed_ms": ssd_fixed, "per_chunk_ms": per_chunk}
    # The training path's backward has no kernel: the op recomputes the plain
    # version under autograd. Its time per layer, for the step's breakdown.
    ins = [t.detach().requires_grad_(True)
           for t in ssd_inputs(*ssd_train, torch.bfloat16)]
    y, _ = SSD.ssd_scan_op(*ins, ms.chunk_size)
    go = torch.randn(y.shape, generator=gen, device=dev).to(torch.bfloat16)
    bwd_ms = time_ms(lambda: torch.autograd.grad(y, ins, go, retain_graph=True))
    print(f"  ssd_backward     the SSD op's backward at the train shape (plain recompute "
          f"under autograd, no kernel): {bwd_ms:.4f} ms, x {mfull.n_layers} layers = "
          f"{bwd_ms * mfull.n_layers:.1f} ms/step; card {card}", flush=True)
    del ins, y, go

    # Phase 25's traces start here, in a process of their own, and not beside
    # phases 3-13: the SSD backward timed just above (the plain recompute under
    # autograd at mamba2's training shape) takes all but a few hundred MB of
    # the card, and a cell's process that made its CUDA context then ran out
    # of memory. Phase 25 (a) reads the first trace after phase 26.
    cells = DryrunCellsProcess()

    # ---- 22 (a). the plan CLI's dry run ------------------------------------------
    plan_blob = planner_plan_phase(dev, card)

    # phase 15's pool starts now, its ranks' start-up beside phases 16-19
    opening = OpeningPool(SHARDED_WORLD, dev)
    paper = []              # phase 14's process, started after phase 15

    # ---- 16. gemma2-2b, 17. whisper-tiny ----------------------------------------
    def lm_paths(*results):
        for result in results:
            for acc, got in zip((lm_counts, lm_designs, lm_ssd), result):
                acc.update(got)

    for arch, lr in ((LG_ARCH, LG_LR), (ENCDEC_ARCH, ENCDEC_LR)):
        lm_paths(lm_serve(torch, dev, card, arch, env, f"{arch}_"),
                 lm_train(torch, dev, card, arch, env, f"{arch}_", lr, LM_REMAT))

    # ---- 18. zamba2-1.2b at full width ------------------------------------------
    lm_paths(lm_serve(torch, dev, card, HYBRID_ARCH, env, "zamba2_"),
             lm_train(torch, dev, card, HYBRID_ARCH, env, "zamba2_", HYBRID_LR,
                      HYBRID_REMAT))

    # ---- 19. the MoE kinds at published widths on a depth cut; reduced runs -----
    lm_paths(lm_serve(torch, dev, card, MOE_ARCH, env, "llama4_",
                      n_layers=MOE_SERVE_LAYERS),
             lm_train(torch, dev, card, MOE_ARCH, env, "llama4_", MOE_TRAIN_LR, "none",
                      optimizer="sgd", compression="none", n_layers=MOE_TRAIN_LAYERS),
             lm_serve(torch, dev, card, MLA_ARCH, env, "deepseek_",
                      n_layers=MOE_SERVE_LAYERS),
             lm_train(torch, dev, card, MLA_ARCH, env, f"{MLA_ARCH}_reduced_", REDUCED_LR,
                      "full", reduced_size=True),
             lm_serve(torch, dev, card, VLM_ARCH, env, f"{VLM_ARCH}_reduced_",
                      reduced_size=True),
             lm_train(torch, dev, card, VLM_ARCH, env, f"{VLM_ARCH}_reduced_", REDUCED_LR,
                      "full", reduced_size=True))

    # ---- 26. nemotron-4-15b served at full width ---------------------------------
    nemotron_paths, nemotron_numbers = nemotron_phase(torch, dev, card, env)
    lm_paths(nemotron_paths)

    # ---- 25 (a). one cell traced, then run on the card -------------------------
    dry_counts, dry_designs, dry_numbers = dryrun_step_phase(torch, dev, card, env,
                                                             cells.traced_step())

    # ---- 15. sharded pipeline; 22 (b). two picks measured on its pool; --------
    # ---- 23 (b). fp32 sharded serving; 20. the sharded LM train step; 21. the --
    # ---- arch sweep; 22 (c) the planner's pick; 23 (a, c) sharded serving and --
    # ---- the GSPMD step: all on one pool of 8 ----------------------------------
    phase("sharded pipeline on the card: a world of 8 ranks over gloo")
    try:
        sharded_counts, (_, (plan_counts, plan_numbers), (fp32_counts, fp32_designs,
                                                          fp32_numbers), sharded_lm_out) = \
            sharded_pipeline(torch, dev, card, opening, then=lambda pool: (
                paper.append(PaperPipelineProcess()),
                planner_measure_phase(torch, dev, card, pool),
                serve_fp32_phase(torch, dev, card, pool),
                sharded_lm(torch, dev, card, pool, then=lambda pool: (
                    arch_sweep_phase(torch, dev, card, pool, env),
                    auto_train_phase(torch, dev, card, pool),
                    sharded_serve_phase(torch, dev, card, pool),
                    gspmd_train_phase(torch, dev, card, pool),
                    failure_drill_phase(torch, dev, card, pool),
                    attribution_phase(torch, dev, card, pool),
                    overlap_claim_phase(torch, dev, card, pool)))))
    finally:
        from torch._inductor.async_compile import shutdown_compile_workers
        shutdown_compile_workers()
    phase("paper pipeline on the card: LeNet-5 sweep, generic-model fit by DE (phase "
          "14, run in a process of its own beside phases 22 (b) to 23)")
    paper[0].finish()
    sharded_lm_counts, (rq, rkv), sharded_lm_numbers, later = sharded_lm_out

    # ---- 25 (b). the production meshes' cells; 25 (c). the predictor on them ----
    rows_dir = cells.finish()
    with open(os.path.join(rows_dir, AFTER_CELLS_FILE)) as f:
        after = json.load(f)
    cells_numbers = dryrun_cells_phase(torch, rows_dir, card)
    predictor_numbers = predictor_phase(torch, rows_dir, after, card)
    a17_numbers = a17_cells_phase(torch, rows_dir, after, card)
    shutil.rmtree(rows_dir, ignore_errors=True)
    ((arch_counts, arch_rows), (auto_counts, auto_numbers),
     (serve_counts, serve_designs, serve_numbers), (gspmd_counts, gspmd_numbers),
     (drill_counts, drill_designs, drill_numbers), attribution_numbers,
     claim_numbers) = later
    phase(f"flash attention at the sharded step's per-rank shape q {list(rq)}")
    q, k, v = inputs(*rq[:2], rkv[1], rq[2], rkv[2], rq[3], torch.bfloat16)
    q_pos, kv_pos = tail_pos(rq[1], rkv[1])
    spec = AttnSpec()
    got = FA.flash_attention(q, k, v, q_pos, kv_pos, spec)
    ref = FA.attention_plain(q, k, v, q_pos, kv_pos, spec)
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.allclose(got.float(), ref.float(), atol=TOL["bfloat16"],
                          rtol=TOL["bfloat16"]):
        fail(f"flash attention at the per-rank shape {list(rq)}: {err:.3e}")
    mask = FA.mask_bias(q_pos, kv_pos, spec) == 0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ref, q_pos, kv_pos))
    bound_ms, bound_by = bound(n_bytes, 4 * rq[0] * rq[2] * rq[3] * int(mask.sum().item()),
                               "bfloat16")
    design = FA.plan(q.shape, k.shape, q.dtype, k.dtype, v.dtype)
    rows["train512_rank"] = {
        "ms": time_ms(lambda: FA.flash_attention(q, k, v, q_pos, kv_pos, spec)),
        "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, q_pos, kv_pos, spec)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, is_causal=True)),
        "library_call": "sdpa is_causal", "bound_ms": bound_ms, "bound_by": bound_by,
        "causal": True, "design": design.variant, "n_splits": design.n_splits,
        "max_abs_err": err}
    r = rows["train512_rank"]
    print(f"  q {list(rq)} kv {list(rkv)} bf16 causal {design.variant}: kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa is_causal "
          f"{r['library_ms']:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
          f"|kernel-plain| {err:.3e}; card {card}", flush=True)
    print(f"  sharded step numbers: {json.dumps(sharded_lm_numbers)}", flush=True)
    del q, k, v, got, ref, mask, qt, kt, vt

    planner_numbers = {"plan_top": plan_blob["top"][0], "measure": plan_numbers,
                       "auto_train": auto_numbers}
    print(f"  planner numbers: {json.dumps(planner_numbers)}", flush=True)
    phase23 = {"sharded_serve": serve_numbers, "sharded_serve_fp32": fp32_numbers,
               "gspmd_train": gspmd_numbers}
    print(f"  phase 23 numbers: {json.dumps(phase23)}", flush=True)
    phase24 = {"traced_train": TRACED.get("train"), "traced_serve": TRACED.get("serve"),
               "failure_drill": drill_numbers, "attribution": attribution_numbers}
    print(f"  phase 24 numbers: {json.dumps(phase24)}", flush=True)
    phase25 = {"real_step": dry_numbers, "cells": cells_numbers,
               "predictor": predictor_numbers}
    print(f"  phase 25 numbers: {json.dumps(phase25)}", flush=True)
    phase2627 = {"nemotron": nemotron_numbers, "drivers": a17_numbers,
                 "overlap_claim_1": claim_numbers}
    print(f"  phase 26-27 numbers: {json.dumps(phase2627, default=str)}", flush=True)

    paths = {**{k: lm_counts.pop(k) for k in ("serve", "train")},
             "mamba2_serve": mserve_counts, "mamba2_train": mtrain_counts,
             "mamba2_prefill_check": prefill_counts,
             "sharded_pipeline": sharded_counts, **lm_counts,
             "sharded_lm_train": {k: sharded_lm_counts.get(k, 0) for k in counters},
             "arch_sweep": arch_counts,
             "planner_measure": {k: plan_counts.get(k, 0) for k in counters},
             "auto_train": {k: auto_counts.get(k, 0) for k in counters},
             "sharded_serve": {k: serve_counts.get(k, 0) for k in counters},
             "sharded_serve_fp32": {k: fp32_counts.get(k, 0) for k in counters},
             "gspmd_train": {k: gspmd_counts.get(k, 0) for k in counters},
             "failure_drill": {k: drill_counts.get(k, 0) for k in counters},
             "dryrun_real_step": {k: dry_counts.get(k, 0) for k in counters}}

    def by_path(name):
        return {k: c[name] for k, c in paths.items()}

    path = rows["decode_cap64"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:122",
        "launches": paths["serve"]["flash_attention"],
        "launches_by_path": by_path("flash_attention"),
        "launches_by_design": {**{k: lm_designs.pop(k) for k in ("serve", "train")},
                               "mamba2_serve": mserve_variants,
                               "mamba2_train": mtrain_variants, **lm_designs,
                               "sharded_serve": serve_designs,
                               "sharded_serve_fp32": fp32_designs,
                               "failure_drill": drill_designs,
                               "dryrun_real_step": dry_designs},
        "max_abs_err": path_err,
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"], "op_dispatch": rows["op_dispatch"],
        "registers": flash_regs,
        "rows": {k: r for k, r in rows.items()
                 if k.startswith(("decode_", "prefill", "train", "tile_cost",
                                  "gemma2_", "whisper_", "zamba2_", "llama4_",
                                  "deepseek_", "nemotron_", "arch_")) and "ssd" not in k},
    }]
    for name, line in (("quantize_absmax", 92), ("quantize_int8", 101),
                       ("dequantize_int8", 120)):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": f"src/repro/kernels/quantize.py:{line}",
            "launches": paths["train"][name],
            "launches_by_path": by_path(name),
            "max_abs_err": codec_err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    r = rows["ssd_train"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_mma.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:92",
        "launches": mtrain_counts["ssd_scan"],
        "launches_by_path": by_path("ssd_scan"),
        "launches_by_design": {"mamba2_serve": mserve_ssd, "mamba2_train": mtrain_ssd,
                               **{f"mamba2_prefill_check_{k}": v
                                  for k, v in prefill_ssd.items()}, **lm_ssd},
        "max_abs_err": ssd_err, "max_abs_err_vs_mma_plain": ssd_mma_gap,
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "designs": {d: {"source": f"src/repro_torch/kernels/csrc/{src}",
                        "train_ms": rows["ssd_train"][key],
                        "prefill_ms": rows["ssd_prefill"][key], **ssd_regs[d]}
                    for d, src, key in (("mma", "ssd_scan_mma.cu", "ms"),
                                        ("cuda_core", "ssd_scan.cu", "cuda_core_ms"))},
        "prefill_shape": rows["ssd_prefill"], "mma_cost": rows["ssd_cost"],
        "zamba2_shapes": {k: rows[k] for k in ("zamba2_ssd_train", "zamba2_ssd_prefill")},
        "arch_sweep_shape": {k: r for k, r in rows.items()
                             if k.startswith("arch_") and k.endswith("_ssd")},
    })
    print(f"  arch sweep rows (phase 21): {json.dumps(arch_rows)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        if sys.argv[1:] == ["--paper-pipeline"]:
            paper_pipeline_main()
        elif sys.argv[1:2] == ["--dryrun-cells"] and len(sys.argv) == 3:
            dryrun_cells_main(sys.argv[2])
        else:
            main()
    finally:
        stop_children()
