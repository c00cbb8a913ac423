"""The dry-run rows of one mesh as the §Roofline markdown table, and the
hillclimb picks (``benchmarks/roofline_table.py``).

  PYTHONPATH=src python -m repro_torch.launch.roofline_table [--mesh pod] \\
      [--results-dir benchmarks/dryrun_results_torch]

The rows are ``launch.dryrun``'s, and the table computes its columns and
picks as the reference's does. What they count is the port's (the footnote
under the table):

* a cell is rank 0's program of the production mesh, not the SPMD program;
* ``memory_s`` is over every eager op's operand and output bytes, unfused
  (``perf.op_analysis``), so it is the larger figure and most cells read
  memory-bound;
* the flops ratio's denominator is the traced dots, which hold the plain
  backward's recompute; and an MoE or MTP model computes every row on every
  rank, so its ratio is far below 1 and its pod and multipod cells agree.

The notes are the reference's text, advice for its TPU program, kept
verbatim so that the two tables read alike.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.common import DRYRUN_DIR

NOTE = {
    ("compute", "train"): "raise arithmetic intensity: fuse attn (Pallas), "
                          "drop remat recompute",
    ("memory", "train"): "cut activation traffic: bigger attn blocks, "
                         "bf16 score path, remat policy",
    ("collective", "train"): "resharded CE / param-gather schedule; "
                             "overlap collectives with compute",
    ("memory", "prefill"): "KV write coalescing; wider attention blocks",
    ("collective", "prefill"): "keep logits sharded (onehot CE), avoid "
                               "vocab all-gather",
    ("memory", "decode"): "decode is cache-bandwidth-bound by nature; "
                          "shrink cache reads (MLA/window/ring)",
    ("collective", "decode"): "batch decode collectives; latent (MLA) "
                              "cache reduces gather volume",
}

HEADER = ("| arch | shape | compute_s | memory_s (eager bytes) | collective_s "
          "| bottleneck | t_step | MODEL_FLOPs/traced dots | useful | note |")

FOOTNOTE = (
    "Counted by the port's dry-run (`launch.dryrun`): rank 0's program only; "
    "memory_s over every eager op's operand and output bytes, unfused; the "
    "traced dots hold the plain backward's recompute, and an MoE or MTP model "
    "computes every row on every rank, so its ratio is far below 1 and its "
    "pod and multipod cells agree. The notes are the reference's advice for "
    "its TPU program, kept verbatim.")


def load_rows(mesh: str, results_dir: str = DRYRUN_DIR):
    rows = []
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith(".json") or name == "summary.json":
            continue
        with open(os.path.join(results_dir, name)) as f:
            r = json.load(f)
        if r.get("mesh") != mesh:
            continue
        rows.append(r)
    return rows


def table(mesh: str = "pod", results_dir: str = DRYRUN_DIR) -> str:
    from repro_torch.configs import get_shape
    rows = load_rows(mesh, results_dir)
    lines = [HEADER, "|---|---|---|---|---|---|---|---|---|---|"]
    picks = {"worst_useful": (None, 1e9), "most_collective": (None, -1.0)}
    for r in rows:
        cell = f"{r['arch']} | {r['shape']}"
        if r.get("status") == "SKIP":
            lines.append(f"| {cell} | — | — | — | SKIP | — | — | — | "
                         f"{r['reason'][:60]}… |")
            continue
        if r.get("status") != "OK":
            lines.append(f"| {cell} | — | — | — | FAIL | — | — | — | |")
            continue
        rf = r["roofline"]
        mode = get_shape(r["shape"]).mode
        ratio = (rf["model_flops"] / rf["n_chips"]) / max(rf["flops"], 1)
        note = NOTE.get((rf["bottleneck"], mode), "")
        lines.append(
            f"| {cell} | {rf['compute_s']:.4f} | {rf['memory_s']:.4f} | "
            f"{rf['collective_s']:.4f} | {rf['bottleneck']} | "
            f"{rf['t_step']:.4f} | {ratio:.3f} | "
            f"{rf['useful_fraction']:.2%} | {note} |")
        key = (r["arch"], r["shape"])
        if rf["useful_fraction"] < picks["worst_useful"][1] \
                and mode == "train":
            picks["worst_useful"] = (key, rf["useful_fraction"])
        coll_frac = rf["collective_s"] / max(rf["t_step"], 1e-12)
        if coll_frac > picks["most_collective"][1]:
            picks["most_collective"] = (key, coll_frac)
    out = "\n".join(lines)
    out += "\n\n" + FOOTNOTE
    out += ("\n\nhillclimb picks: worst-useful(train) = "
            f"{picks['worst_useful']}, most-collective = "
            f"{picks['most_collective']}")
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--results-dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    out = table(args.mesh, args.results_dir)
    print(out)
    return out


if __name__ == "__main__":
    main()
