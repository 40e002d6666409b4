"""Synthetic dataset generators matching the paper's Table 3 statistics.

numpy code that produces, for the same seed, the same arrays as the
reference package's generators: (N, d, nnz/example) profiles with a
planted linearly-separable-with-noise structure so LR/SVM converge.
The arrays become tensors only at the end, on ``device`` (``cuda`` unless
the caller says): X and y, or the ``ELLMatrix`` and y.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sparse as sparse_mod
from repro_torch.kernels import common

# name -> (N, d, avg_nnz, max_nnz, dense?)   (paper Table 3)
PAPER_DATASETS: dict[str, tuple[int, int, float, int, bool]] = {
    "covtype": (581_012, 54, 54.0, 54, True),
    "w8a": (64_700, 300, 11.65, 114, False),
    "real-sim": (72_309, 20_958, 51.30, 3_484, False),
    "rcv1": (677_399, 47_236, 73.16, 1_224, False),
    "news": (19_996, 1_355_191, 454.99, 16_423, False),
    "skin": (245_057, 3, 3.0, 3, True),
}


@dataclasses.dataclass
class Dataset:
    name: str
    X: torch.Tensor | None          # dense [N, d] or None for sparse-only
    ell: "sparse_mod.ELLMatrix | None"
    y: torch.Tensor                 # [N] in {-1, +1}
    d: int
    dense: bool
    content_hash: str | None = None  # real data only (repro_torch.data.ingest)

    @property
    def n(self) -> int:
        return len(self.y)


def _planted_labels(rng, X_dot_w: np.ndarray, noise: float = 0.05) -> np.ndarray:
    """Labels from a planted hyperplane with `noise` fraction flipped."""
    y = np.where(X_dot_w >= 0, 1.0, -1.0)
    flip = rng.random(len(y)) < noise
    y[flip] *= -1.0
    return y.astype(np.float32)


def make_dense(
    name: str, n: int, d: int, *, seed: int = 0, noise: float = 0.05,
    device=None,
) -> Dataset:
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, size=(n, d)).astype(np.float32)
    w_star = rng.normal(0, 1, size=(d,)).astype(np.float32)
    y = _planted_labels(rng, X @ w_star, noise)
    dev = common.device(device)
    return Dataset(name=name, X=torch.from_numpy(X).to(dev), ell=None,
                   y=torch.from_numpy(y).to(dev), d=d, dense=True)


def make_sparse(
    name: str,
    n: int,
    d: int,
    avg_nnz: float,
    max_nnz: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
    pad_to: int | None = None,
    device=None,
) -> Dataset:
    """Sparse dataset with log-normal nnz/row (a long tail like real text
    data) and Zipfian feature popularity (like bag-of-words)."""
    rng = np.random.default_rng(seed)
    mu = np.log(max(avg_nnz, 1.5))
    nnz = np.clip(rng.lognormal(mu, 0.8, size=n), 1, max_nnz).astype(np.int64)
    ranks = np.arange(1, d + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    w_star = (rng.normal(0, 1, size=d) / np.sqrt(ranks)).astype(np.float32)
    rows_idx, rows_val, margins = [], [], np.zeros(n, dtype=np.float64)
    for i in range(n):
        k = int(nnz[i])
        idx = np.unique(rng.choice(d, size=k, p=probs))
        val = rng.normal(0, 1, size=len(idx)).astype(np.float32)
        rows_idx.append(idx.astype(np.int32))
        rows_val.append(val)
        margins[i] = float(val @ w_star[idx])
    y = _planted_labels(rng, margins, noise)
    K = pad_to if pad_to is not None else int(max(len(r) for r in rows_idx))
    ell = sparse_mod.from_rows(rows_idx, rows_val, d, pad_to=K, device=device)
    return Dataset(name=name, X=None, ell=ell,
                   y=torch.from_numpy(y).to(common.device(device)), d=d,
                   dense=False)


def paper_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                  max_n: int | None = None, device=None) -> Dataset:
    """A synthetic stand-in for one of the paper's datasets.

    ``scale`` multiplies N (sparsity profile preserved); ``max_n`` caps N.
    """
    N, d, avg_nnz, max_nnz, dense = PAPER_DATASETS[name]
    n = int(N * scale)
    if max_n is not None:
        n = min(n, max_n)
    n = max(n, 64)
    if dense:
        return make_dense(name, n, d, seed=seed, device=device)
    # cap the pad width at a high percentile to keep ELL memory sane
    pad = min(max_nnz, max(int(avg_nnz * 6), 8))
    return make_sparse(name, n, d, avg_nnz, min(max_nnz, pad), seed=seed,
                       pad_to=pad, device=device)
