"""LeNet-5 in PyTorch (``repro.models.lenet``), the paper's experimental
subject, parameterised by the Table-1 intrinsics.

Layouts: images NCHW, conv weights OIHW, dense weights ``[d_out, d_in]``
(``F.linear``). The reference is NHWC/HWIO and flattens the last feature
map in (H, W, C) order; the port flattens in (C, H, W) order, so fc1's
input rows are permuted (``models.convert.lenet_params_from_jax``).

XLA's ``SAME`` padding is ``⌈n/s⌉`` outputs with ``max((⌈n/s⌉−1)·s + k − n,
0)`` padded, the smaller half low; at stride 2–3 or an even kernel that is
asymmetric, which torch's ``padding="same"`` does not do, so ``_conv`` pads
with ``F.pad`` and convolves VALID. Pooling is max over non-overlapping
windows (window = stride = ``_pool_window``), VALID.

The sharded iteration (``perf.sweep.make_sharded_iteration``) may split the
fc pair Megatron-style over a model axis of m ranks: it passes that axis's
process group as ``tp``, fc1 holds rows ``[120/m, flat]`` of this rank and
fc2 columns ``[84, 120/m]`` (the reference's fc1 columns and fc2 rows).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.lenet5 import DATASET_SHAPES, LeNet5Config, N_CLASSES
from repro_torch.models.layers import (Params, activation_fn, normal_param,
                                      tp_f, tp_g, tp_probe)

HIDDEN = (120, 84)     # fc1 and fc2 widths


def _eff_padding(n: int, k: int, padding: str) -> str:
    """Degenerate-size guard: fall back to SAME when the map is smaller
    than the kernel (the paper's sampled space contains such corners)."""
    return "same" if (padding == "valid" and n < k) else padding


def _conv_out(n: int, k: int, stride: int, padding: str) -> int:
    if _eff_padding(n, k, padding) == "same":
        return -(-n // stride)
    return (n - k) // stride + 1


def _pool_window(n: int, p: int) -> int:
    return min(p, n)


def _pool_out(n: int, p: int) -> int:
    return n // _pool_window(n, p)


def feature_dims(cfg: LeNet5Config) -> Tuple[int, int, int]:
    """Spatial dims after conv1/pool1/conv2/pool2 and the flat size."""
    h, w, _ = DATASET_SHAPES[cfg.dataset]
    for _ in range(2):
        h = _pool_out(_conv_out(h, cfg.kernel_size, cfg.stride, cfg.padding),
                      cfg.pool_size)
        w = _pool_out(_conv_out(w, cfg.kernel_size, cfg.stride, cfg.padding),
                      cfg.pool_size)
    return h, w, h * w * (2 * cfg.n_filters)


def init_lenet(cfg: LeNet5Config, *, seed: int = 0, device="cuda") -> Params:
    """Weights at the reference's shapes and scales (``init_lenet``) in the
    port's layout, drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, w, c = DATASET_SHAPES[cfg.dataset]
    f, k = cfg.n_filters, cfg.kernel_size
    _, _, flat = feature_dims(cfg)
    d1, d2 = HIDDEN

    def draw(shape, fan_in):
        return normal_param(gen, shape, torch.float32, 1.0 / fan_in ** 0.5)

    return {"conv1": draw((f, c, k, k), k * k * c),
            "conv2": draw((2 * f, f, k, k), k * k * f),
            "fc1": draw((d1, flat), flat),
            "fc2": draw((d2, d1), d1),
            "out": draw((N_CLASSES, d2), d2)}


def _same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          padding: str) -> torch.Tensor:
    k = w.shape[-1]
    h, wd = x.shape[2], x.shape[3]
    if _eff_padding(min(h, wd), k, padding) == "same":
        top, bottom = _same_pads(h, k, stride)
        left, right = _same_pads(wd, k, stride)
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def _pool(x: torch.Tensor, p: int) -> torch.Tensor:
    window = (_pool_window(x.shape[2], p), _pool_window(x.shape[3], p))
    return F.max_pool2d(x, window, window)


def lenet_forward(params: Params, images: torch.Tensor, cfg: LeNet5Config, *,
                  train: bool = False, rng: Optional[torch.Tensor] = None,
                  tp=None) -> torch.Tensor:
    """images [B,C,H,W] -> logits [B,10].

    ``rng`` stands for the reference's dropout key: uniform draws in [0, 1)
    of fc1's output shape ``[B, 120]`` (``dropout_noise``), made outside so
    a compiled iteration takes them as an input. A unit is kept where its
    draw is below ``1 - dropout``.

    ``tp``, when given, is the model axis's process group of a split fc
    pair: the flattened features enter fc1's row slice through ``tp_f``
    (so the backward completes their cotangent) and fc2's partial product
    is closed by ``tp_g`` before the activation. Under dropout each rank's
    draws cover its own hidden slice (``rng`` is ``[B, 120/m]``)."""
    act = activation_fn(cfg.activation)
    x = act(_conv(images, params["conv1"], cfg.stride, cfg.padding))
    x = _pool(x, cfg.pool_size)
    x = act(_conv(x, params["conv2"], cfg.stride, cfg.padding))
    x = _pool(x, cfg.pool_size)
    x = x.flatten(1)
    if tp is not None:
        x = tp_f(tp, x)
    x = tp_probe("lenet_fc1", act(F.linear(x, params["fc1"])))
    if train and cfg.dropout > 0:
        keep = rng < 1.0 - cfg.dropout
        x = torch.where(keep, x / (1.0 - cfg.dropout), 0.0)
    h = F.linear(x, params["fc2"])
    if tp is not None:
        h = tp_g(tp, h)
    x = act(h)
    return F.linear(x, params["out"])


def dropout_noise(gen: torch.Generator, batch: int,
                  width: int = HIDDEN[0]) -> torch.Tensor:
    """Uniform [batch, width] draws on the generator's device: the port's
    dropout key for ``lenet_forward``/``lenet_loss`` (width 120, or 120/m
    on a split fc pair)."""
    return torch.rand((batch, width), generator=gen, device=gen.device)


def lenet_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: LeNet5Config, rng: Optional[torch.Tensor],
               tp=None) -> torch.Tensor:
    """Mean cross-entropy of the training forward (dropout on); ``tp`` as
    in ``lenet_forward``."""
    logits = lenet_forward(params, batch["images"], cfg, train=True, rng=rng,
                           tp=tp)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, batch["labels"][:, None]).mean()
