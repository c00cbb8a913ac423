"""End-to-end driver example (``examples/train_lm.py``): train a small LM
for a few hundred steps with checkpointing, straggler monitoring and
resume, the production training path at reduced size, through
``launch.train``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
      [--ckpt-dir DIR] [--device cuda]

A checkpoint is written every 50 steps into ``--ckpt-dir`` (by default a
temporary directory, removed at the end); a run given a directory that
holds one resumes from its latest.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main

CKPT_EVERY = 50


def train_argv(arch: str, steps: int, ckpt_dir: str, device: str):
    """``launch.train``'s arguments for this example."""
    return ["--arch", arch, "--reduced", "--steps", str(steps), "--batch", "8",
            "--seq", "128", "--ckpt-dir", ckpt_dir, "--ckpt-every", str(CKPT_EVERY),
            "--log-every", "20", "--device", device]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda", help="the card unless cpu")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        return train_main(train_argv(args.arch, args.steps, args.ckpt_dir, args.device))
    with tempfile.TemporaryDirectory(prefix="repro_torch_example_ckpt_") as d:
        return train_main(train_argv(args.arch, args.steps, d, args.device))


if __name__ == "__main__":
    main()
