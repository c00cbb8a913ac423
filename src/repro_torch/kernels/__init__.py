"""Kernels written by hand for Hopper, each with its plain PyTorch version.

Layout per kernel:
  <name>.py  — build, ctypes wrapper, launch counter, plain version
  csrc/      — the CUDA sources, compiled with nvcc at first use into build/
  ops.py     — dispatch by the tensors' device, used by the model code
  ref.py     — fp32 oracles for tests
"""
