"""The generic performance-model expression (paper eqs. 1–4) in PyTorch
(``repro.core.generic_model``).

* numeric intrinsics enter as power terms ``a_i · I_i^{p_i}``;
* categorical intrinsics enter as per-value constants (one ``a`` per
  category, no power);
* extrinsics enter multiplicatively as ``E_j^{q_j}``;
* plus the additive constant C.

Unknown vector layout (M = 2·n_num + Σ|cats| + n_ext + 1):
  x = [a_num(n) | p_num(n) | a_cat(Σ|c|) | q(n_ext) | C]

Everything on the device is float32, as in the reference (x64 off): the
encoded features and times are cast from float64 once, in
``encode_dataset``. ``x`` may carry leading batch dimensions (a DE
population ``[NP, M]``); ``PerfModel`` keeps its constants as numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class FeatureSpec:
    numeric: Tuple[str, ...]                       # numeric intrinsic names
    categorical: Tuple[Tuple[str, Tuple[str, ...]], ...]  # (name, values)
    extrinsic: Tuple[str, ...]                     # extrinsic names

    @property
    def n_num(self) -> int:
        return len(self.numeric)

    @property
    def n_cat_total(self) -> int:
        return sum(len(v) for _, v in self.categorical)

    @property
    def n_ext(self) -> int:
        return len(self.extrinsic)

    @property
    def n_params(self) -> int:
        return 2 * self.n_num + self.n_cat_total + self.n_ext + 1

    # -- x-vector slicing ----------------------------------------------------
    def split(self, x):
        n, c, e = self.n_num, self.n_cat_total, self.n_ext
        a = x[..., :n]
        p = x[..., n:2 * n]
        acat = x[..., 2 * n:2 * n + c]
        q = x[..., 2 * n + c:2 * n + c + e]
        C = x[..., -1]
        return a, p, acat, q, C

    def param_names(self) -> List[str]:
        names = [f"a:{f}" for f in self.numeric]
        names += [f"p:{f}" for f in self.numeric]
        for cname, vals in self.categorical:
            names += [f"a:{cname}={v}" for v in vals]
        names += [f"q:{f}" for f in self.extrinsic]
        names.append("C")
        return names

    def bounds(self, a_hi: float = 1000.0, p_hi: float = 5.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Paper's bounds: a,C ∈ (0, 1000); p,q ∈ (−5, 5)."""
        lo = np.concatenate([
            np.zeros(self.n_num),                  # a
            -p_hi * np.ones(self.n_num),           # p
            np.zeros(self.n_cat_total),            # a_cat
            -p_hi * np.ones(self.n_ext),           # q
            np.zeros(1),                           # C
        ])
        hi = np.concatenate([
            a_hi * np.ones(self.n_num),
            p_hi * np.ones(self.n_num),
            a_hi * np.ones(self.n_cat_total),
            p_hi * np.ones(self.n_ext),
            a_hi * np.ones(1),
        ])
        return lo, hi


def encode_numpy(spec: FeatureSpec, samples: Sequence[Dict]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Xnum, Xcat one-hot, Xext) as float64 numpy. Numeric and extrinsic
    features must be positive."""
    N = len(samples)
    Xnum = np.zeros((N, spec.n_num))
    Xcat = np.zeros((N, spec.n_cat_total))
    Xext = np.zeros((N, spec.n_ext))
    for k, s in enumerate(samples):
        for i, f in enumerate(spec.numeric):
            Xnum[k, i] = float(s[f])
        off = 0
        for cname, vals in spec.categorical:
            Xcat[k, off + list(vals).index(s[cname])] = 1.0
            off += len(vals)
        for j, f in enumerate(spec.extrinsic):
            Xext[k, j] = float(s[f])
    if not (Xnum > 0).all():
        raise ValueError("numeric intrinsics must be positive")
    if not (Xext > 0).all():
        raise ValueError("extrinsics must be positive")
    return Xnum, Xcat, Xext


def encode_dataset(spec: FeatureSpec, samples: Sequence[Dict],
                   times: Optional[Sequence[float]] = None, *,
                   device="cuda"):
    """(Xnum, Xcat, Xext[, t]) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    arrays = list(encode_numpy(spec, samples))
    if times is not None:
        arrays.append(np.asarray(times, np.float64))
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def predict_times(spec: FeatureSpec, x: torch.Tensor, Xnum: torch.Tensor,
                  Xcat: torch.Tensor, Xext: torch.Tensor) -> torch.Tensor:
    """Vectorized eq. 4. x: [..., M]; returns t̂ [..., N]."""
    a, p, acat, q, C = spec.split(x)
    # powers via exp/log for stability (features are validated positive)
    t_I = (a[..., None, :] * torch.exp(p[..., None, :] * torch.log(Xnum))
           ).sum(-1)
    t_I = t_I + acat @ Xcat.T
    f_E = torch.exp((q[..., None, :] * torch.log(Xext)).sum(-1))
    return t_I * f_E + C[..., None]


def cost_fn(spec: FeatureSpec, x: torch.Tensor, Xnum, Xcat, Xext, t, *,
            reg: str = "none", lam: float = 0.0) -> torch.Tensor:
    """Eq. 8 (MAE), optionally + λ·L1 (eq. 10) or λ·L2 (eq. 11). x: [..., M]
    -> [...].

    The penalty covers all parameters except the intercept C (paper §III.C).
    """
    pred = predict_times(spec, x, Xnum, Xcat, Xext)
    mae = (t - pred).abs().mean(-1)
    if reg == "l1":
        return mae + lam * x[..., :-1].abs().sum(-1)
    if reg == "l2":
        return mae + lam * x[..., :-1].square().sum(-1)
    return mae


@dataclass
class PerfModel:
    """A fitted generic performance model. ``predict`` encodes and
    evaluates on ``device``, the device it was fitted on."""
    spec: FeatureSpec
    x: np.ndarray                      # best-fit constants [M]
    x_seeds: Optional[np.ndarray] = None   # [n_seeds, M] per-seed fits
    reg: str = "none"
    lam: float = 0.0
    device: str = "cuda"

    def predict(self, samples: Sequence[Dict]) -> np.ndarray:
        return self.predict_encoded(
            *encode_dataset(self.spec, samples, device=self.device))

    def predict_encoded(self, Xnum, Xcat, Xext) -> np.ndarray:
        x = torch.tensor(np.asarray(self.x), dtype=torch.float32,
                         device=Xnum.device)
        return predict_times(self.spec, x, Xnum, Xcat, Xext).cpu().numpy()

    def scaling_powers(self) -> Dict[str, Tuple[float, float]]:
        """Extrinsic q (mean, std over seeds) — paper Table 6."""
        _, _, _, q, _ = self.spec.split(self.x)
        if self.x_seeds is not None:
            qs = np.stack([np.asarray(self.spec.split(xs)[3])
                           for xs in self.x_seeds])
            return {f: (float(np.mean(qs[:, j])), float(np.std(qs[:, j])))
                    for j, f in enumerate(self.spec.extrinsic)}
        return {f: (float(q[j]), 0.0)
                for j, f in enumerate(self.spec.extrinsic)}

    def param_table(self) -> List[Tuple[str, float, float]]:
        """(name, mean, std) rows for every constant — paper Tables 2/3."""
        names = self.spec.param_names()
        if self.x_seeds is not None:
            mean = np.mean(self.x_seeds, axis=0)
            std = np.std(self.x_seeds, axis=0)
        else:
            mean, std = np.asarray(self.x), np.zeros_like(self.x)
        return [(n, float(m), float(s))
                for n, m, s in zip(names, mean, std)]


def metrics(t_true: np.ndarray, t_pred: np.ndarray) -> Dict[str, float]:
    t_true = np.asarray(t_true, np.float64)
    t_pred = np.asarray(t_pred, np.float64)
    err = t_true - t_pred
    mape = float(np.mean(np.abs(err) / np.maximum(np.abs(t_true), 1e-12)))
    mse = float(np.mean(err ** 2))
    ss_res = float(np.sum(err ** 2))
    ss_tot = float(np.sum((t_true - t_true.mean()) ** 2))
    return {"mape": mape, "mse": mse, "rmse": float(np.sqrt(mse)),
            "mae": float(np.mean(np.abs(err))),
            "r2": 1.0 - ss_res / max(ss_tot, 1e-12)}
