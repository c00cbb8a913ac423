"""Weights of the reference package in the port's layout.

``params_from_jax`` takes the tree of ``repro.models.layers.pvalues(params)``
with numpy leaves (per-layer leaves stacked ``[n_layers, ...]``), unstacks
the layers of the decoder's segments and of an encoder's (a zamba group's
``inner`` Mamba2 leaves twice, ``[groups, inner, ...]``; its ``shared``
block is not stacked), and turns every ``[d_in, d_out]`` dense kernel into a
``[d_out, d_in]`` ``F.linear`` weight, so both packages compute the same
function; bare arrays keep their layout (the MoE router ``[d, E]`` and its
stacked experts ``[E, d, ff]``), and a layer's subtrees (an ``lg_pair``'s
``local``/``global``, a decoder block's ``xattn``, an MLP with or without
its gate, MLA's six projections, the shared expert, the ``mtp`` head) map
key for key. ``lenet_params_from_jax`` does the
same for LeNet-5's weights (HWIO convs, fc1's rows in the port's flatten
order).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.lenet5 import LeNet5Config
from repro_torch.models.lenet import feature_dims
from repro_torch.models.model import build_segments, encoder_segment


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16: exact via fp32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # own, writable copy


def _dense(tree, device) -> Dict[str, torch.Tensor]:
    out = {"weight": _tensor(np.swapaxes(np.asarray(tree["kernel"]), -1, -2),
                             device).contiguous()}
    if "bias" in tree:
        out["bias"] = _tensor(tree["bias"], device)
    return out


def _convert(tree, device):
    """Recursively map a (single-layer) reference subtree: a ``{"kernel"}``
    dense layer is transposed, any other array (norm scales, Mamba2's
    depthwise ``conv_w [d_conv, conv_dim]``, ``A_log``, ...) keeps its
    layout."""
    if not isinstance(tree, dict):
        return _tensor(tree, device)
    if "kernel" in tree:
        return _dense(tree, device)
    return {k: _convert(v, device) for k, v in tree.items()}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    segs = build_segments(cfg)
    params: Dict[str, Any] = {
        "embed": {"table": _tensor(tree["embed"]["table"], dev)},
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], dev)},
        "segments": [_segment(seg, seg_tree, dev)
                     for seg, seg_tree in zip(segs, tree["segments"])],
    }
    if "lm_head" in tree:
        params["lm_head"] = _dense(tree["lm_head"], dev)
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "segments": [[_convert(_layer(enc["segments"][0], i), dev)
                          for i in range(encoder_segment(cfg).n)]],
            "final_norm": {"scale": _tensor(enc["final_norm"]["scale"], dev)},
        }
    if "mtp" in tree:
        params["mtp"] = _convert(tree["mtp"], dev)
    return params


def _segment(seg, seg_tree, device):
    if seg.kind == "zamba_group":
        inner = seg_tree["inner"]
        return {"inner": [[_convert(_layer(_layer(inner, g), j), device)
                           for j in range(seg.inner)] for g in range(seg.n)],
                "shared": _convert(seg_tree["shared"], device)}
    return [_convert(_layer(seg_tree, i), device) for i in range(seg.n)]


def lenet_params_from_jax(tree: Dict[str, Any], cfg: LeNet5Config,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """``repro.models.lenet.init_lenet``'s tree (``Param`` leaves or their
    numpy values) in the port's layout: convs HWIO -> OIHW, dense kernels
    ``[d_in, d_out]`` -> ``[d_out, d_in]``, and fc1's input rows from the
    reference's (H, W, C) flatten order into the port's (C, H, W)."""
    dev = resolve_device(device)
    a = {k: np.asarray(getattr(v, "value", v)) for k, v in tree.items()}
    h, w, _ = feature_dims(cfg)
    c = 2 * cfg.n_filters
    fc1 = a["fc1"].reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1)
    out = {name: a[name].transpose(3, 2, 0, 1) for name in ("conv1", "conv2")}
    out.update(fc1=fc1.T, fc2=a["fc2"].T, out=a["out"].T)
    return {k: _tensor(np.ascontiguousarray(v), dev) for k, v in out.items()}
