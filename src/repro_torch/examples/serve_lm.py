"""Serving example (``examples/serve_lm.py``): batched prefill and greedy
decode with ring KV caches (gemma2's local-attention layers keep
window-sized ring buffers), reduced gemma2 through ``launch.serve``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cuda]
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the card unless cpu")
    ap.add_argument("--gen", type=int, default=32, help="tokens generated")
    args = ap.parse_args(argv)
    return serve_main(["--arch", "gemma2-2b", "--reduced", "--batch", "4",
                       "--prompt-len", "32", "--gen", str(args.gen),
                       "--device", args.device])


if __name__ == "__main__":
    main()
