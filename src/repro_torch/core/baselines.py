"""Black-box baselines the paper compares against: Random Forest and ε-SVR
(``repro.core.baselines``, copied; numpy, on the host).

Implemented from scratch in numpy:

* ``RandomForestRegressor`` — CART trees on bootstrap samples with
  sqrt-feature subsampling, variance-reduction splits, mean aggregation.
* ``SVR`` — ε-insensitive support vector regression in its exact
  representer form: f(x) = Σ_i β_i K(x_i, x) + b with an RBF kernel,
  optimized by projected subgradient descent on
  L = C·Σ max(0, |y − f(x)| − ε) + ½ βᵀKβ. (The paper uses default
  sklearn SVR; this matches its objective.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# CART regression tree
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("feat", "thresh", "left", "right", "value")

    def __init__(self, value=None):
        self.feat = -1
        self.thresh = 0.0
        self.left = self.right = None
        self.value = value


def _build_tree(X, y, *, max_depth, min_leaf, n_feats, rng, depth=0):
    node = _Node(value=float(y.mean()))
    if depth >= max_depth or len(y) < 2 * min_leaf or np.ptp(y) < 1e-12:
        return node
    D = X.shape[1]
    feats = rng.choice(D, size=min(n_feats, D), replace=False)
    best_gain, best = 0.0, None
    parent_sse = float(((y - y.mean()) ** 2).sum())
    for f in feats:
        order = np.argsort(X[:, f], kind="stable")
        xs, ys = X[order, f], y[order]
        csum = np.cumsum(ys)
        csum2 = np.cumsum(ys ** 2)
        n = len(ys)
        total, total2 = csum[-1], csum2[-1]
        for i in range(min_leaf, n - min_leaf):
            if xs[i] == xs[i - 1]:
                continue
            nl = i
            sl, sl2 = csum[i - 1], csum2[i - 1]
            sr, sr2 = total - sl, total2 - sl2
            sse = (sl2 - sl * sl / nl) + (sr2 - sr * sr / (n - nl))
            gain = parent_sse - sse
            if gain > best_gain:
                best_gain = gain
                best = (f, 0.5 * (xs[i] + xs[i - 1]))
    if best is None:
        return node
    f, thr = best
    mask = X[:, f] <= thr
    node.feat, node.thresh = f, thr
    node.left = _build_tree(X[mask], y[mask], max_depth=max_depth,
                            min_leaf=min_leaf, n_feats=n_feats, rng=rng,
                            depth=depth + 1)
    node.right = _build_tree(X[~mask], y[~mask], max_depth=max_depth,
                             min_leaf=min_leaf, n_feats=n_feats, rng=rng,
                             depth=depth + 1)
    return node


def _predict_tree(node: _Node, X) -> np.ndarray:
    out = np.empty(len(X))
    idx = np.arange(len(X))
    stack = [(node, idx)]
    while stack:
        nd, ix = stack.pop()
        if nd.left is None:
            out[ix] = nd.value
            continue
        mask = X[ix, nd.feat] <= nd.thresh
        stack.append((nd.left, ix[mask]))
        stack.append((nd.right, ix[~mask]))
    return out


@dataclass
class RandomForestRegressor:
    n_trees: int = 100
    max_depth: int = 14
    min_leaf: int = 2
    seed: int = 0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X, y = np.asarray(X, float), np.asarray(y, float)
        rng = np.random.default_rng(self.seed)
        n, d = X.shape
        n_feats = max(1, int(np.sqrt(d)))
        self.trees_: List[_Node] = []
        for _ in range(self.n_trees):
            bs = rng.integers(0, n, size=n)
            self.trees_.append(
                _build_tree(X[bs], y[bs], max_depth=self.max_depth,
                            min_leaf=self.min_leaf, n_feats=n_feats,
                            rng=rng))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, float)
        return np.mean([_predict_tree(t, X) for t in self.trees_], axis=0)


# ---------------------------------------------------------------------------
# ε-SVR (RBF kernel, representer form)
# ---------------------------------------------------------------------------

@dataclass
class SVR:
    C: float = 1.0
    eps: float = 0.1
    gamma: Optional[float] = None      # None -> 1/(D·var) ("scale")
    iters: int = 2000
    lr: float = 1e-3
    seed: int = 0

    def _kernel(self, A, B):
        d2 = (np.sum(A ** 2, 1)[:, None] + np.sum(B ** 2, 1)[None, :]
              - 2 * A @ B.T)
        return np.exp(-self.gamma_ * np.maximum(d2, 0.0))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "SVR":
        X, y = np.asarray(X, float), np.asarray(y, float)
        self.X_ = X
        self.x_mean_ = X.mean(0)
        self.x_std_ = X.std(0) + 1e-9
        Xs = (X - self.x_mean_) / self.x_std_
        self.Xs_ = Xs
        self.gamma_ = (self.gamma if self.gamma is not None
                       else 1.0 / (X.shape[1] * max(Xs.var(), 1e-12)))
        K = self._kernel(Xs, Xs)
        n = len(y)
        beta = np.zeros(n)
        b = float(np.median(y))
        lr = self.lr * max(np.abs(y).max(), 1.0)
        for it in range(self.iters):
            f = K @ beta + b
            r = f - y
            g_loss = np.where(np.abs(r) > self.eps, np.sign(r), 0.0)
            grad_beta = self.C * (K @ g_loss) / n + K @ beta * 1e-3
            grad_b = self.C * g_loss.mean()
            beta -= lr * grad_beta / (np.abs(grad_beta).max() + 1e-12)
            b -= lr * grad_b
        self.beta_, self.b_ = beta, b
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xs = (np.asarray(X, float) - self.x_mean_) / self.x_std_
        return self._kernel(Xs, self.Xs_) @ self.beta_ + self.b_


def encode_blackbox(spec, samples: Sequence[dict]) -> np.ndarray:
    """Flat feature matrix (numeric + one-hot + extrinsic) for baselines."""
    from repro_torch.core.generic_model import encode_numpy
    # float32, as the reference's encoded features are
    return np.concatenate(encode_numpy(spec, samples), axis=1
                          ).astype(np.float32)
