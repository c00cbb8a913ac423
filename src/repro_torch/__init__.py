"""PyTorch/CUDA port of the ``repro`` package, module for module.

The subpackages mirror ``repro`` (``configs``, ``data``, ``models``,
``kernels``, ``train``, ``launch``) so each ported module sits where its
counterpart does. The port imports torch and numpy only: never JAX, never
``repro``. Its entry points run on a CUDA device unless the caller passes
``device="cpu"``; on the CPU the kernels' plain PyTorch versions run.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path")
    return dev
