"""Sparse training data in ELL (padded) format.

The paper pads CSR to a dense width for the GPU's col-major access path
(Section 5.2.1: "we map sparse data into a dense padded format that stores
all the examples at the same width").  The same layout feeds the kernels:

    values  : [N, K]  float   (zero padded)
    indices : [N, K]  int32   (index 0 padded; padded values are 0 so the
                               contribution vanishes)

with K = max nnz/row.  The GLM margin is a gather-dot; the gradient is a
scatter-add (``index_add_``).  ``CSRMatrix`` is the host-side numpy triple
parsers produce; ``ELLMatrix`` holds tensors, and every builder of one puts
them on ``device`` (``cuda`` unless the caller says).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import glm
from repro_torch.kernels import common

Tensor = torch.Tensor


class ELLMatrix(NamedTuple):
    """Padded sparse matrix (ELLPACK layout) on tensors."""

    values: Tensor   # [N, K] float
    indices: Tensor  # [N, K] int32
    d: int           # number of features (model dimension)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.values.shape[0], self.d)

    @property
    def max_nnz(self) -> int:
        return self.values.shape[1]

    def to(self, device: str | torch.device) -> "ELLMatrix":
        return ELLMatrix(self.values.to(device), self.indices.to(device), self.d)


def _ell(values: np.ndarray, indices: np.ndarray, d: int, device) -> ELLMatrix:
    """The numpy ELL arrays as tensors on ``device``."""
    dev = common.device(device)
    return ELLMatrix(torch.from_numpy(values).to(dev),
                     torch.from_numpy(indices).to(dev), d)


class CSRMatrix(NamedTuple):
    """Host-side CSR triple — the ingestion-facing sparse layout (numpy)."""

    indptr: np.ndarray   # [N+1] int64 row offsets
    indices: np.ndarray  # [nnz] int32 column ids
    values: np.ndarray   # [nnz] float32
    d: int               # number of features (model dimension)

    @property
    def shape(self) -> tuple[int, int]:
        return (len(self.indptr) - 1, self.d)

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def avg_nnz(self) -> float:
        return float(self.nnz / max(self.n, 1))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.values[lo:hi]

    def select(self, rows: np.ndarray) -> "CSRMatrix":
        """Row subset (host-side, vectorized)."""
        rows = np.asarray(rows, dtype=np.int64)
        counts = self.row_nnz[rows]
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        within = np.arange(int(indptr[-1]), dtype=np.int64) \
            - np.repeat(indptr[:-1], counts)
        take = np.repeat(self.indptr[rows], counts) + within
        return CSRMatrix(indptr, self.indices[take], self.values[take], self.d)

    def to_ell(self, pad_to: int | None = None, device=None) -> ELLMatrix:
        """Zero-padded ELL conversion on ``device``.  ``pad_to`` defaults to
        the widest row; a narrower ``pad_to`` truncates overflow rows."""
        N = self.n
        K = int(self.row_nnz.max()) if (pad_to is None and N) else (pad_to or 1)
        K = max(K, 1)
        values = np.zeros((N, K), dtype=np.float32)
        indices = np.zeros((N, K), dtype=np.int32)
        if self.nnz:
            row_of = np.repeat(np.arange(N, dtype=np.int64), self.row_nnz)
            pos = np.arange(self.nnz, dtype=np.int64) \
                - np.repeat(self.indptr[:-1], self.row_nnz)
            keep = pos < K
            values[row_of[keep], pos[keep]] = self.values[keep]
            indices[row_of[keep], pos[keep]] = self.indices[keep]
        return _ell(values, indices, self.d, device)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.d), dtype=np.float32)
        rows = np.repeat(np.arange(self.n), self.row_nnz)
        np.add.at(out, (rows, self.indices), self.values)
        return out


def from_csr_parts(
    rows_idx: list[np.ndarray], rows_val: list[np.ndarray], d: int
) -> CSRMatrix:
    """Assemble a ``CSRMatrix`` from per-row (indices, values) pairs."""
    indptr = np.zeros(len(rows_idx) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in rows_idx], out=indptr[1:])
    indices = (np.concatenate(rows_idx).astype(np.int32)
               if rows_idx else np.zeros(0, dtype=np.int32))
    values = (np.concatenate(rows_val).astype(np.float32)
              if rows_val else np.zeros(0, dtype=np.float32))
    return CSRMatrix(indptr, indices, values, d)


def from_rows(
    rows_idx: list[np.ndarray], rows_val: list[np.ndarray], d: int,
    pad_to: int | None = None, device=None,
) -> ELLMatrix:
    """Build on ``device`` from per-row (indices, values) pairs — CSR-style
    input."""
    N = len(rows_idx)
    K = pad_to if pad_to is not None else max((len(r) for r in rows_idx), default=1)
    K = max(K, 1)
    values = np.zeros((N, K), dtype=np.float32)
    indices = np.zeros((N, K), dtype=np.int32)
    for i, (idx, val) in enumerate(zip(rows_idx, rows_val)):
        k = min(len(idx), K)
        values[i, :k] = val[:k]
        indices[i, :k] = idx[:k]
    return _ell(values, indices, d, device)


def to_dense(m: ELLMatrix) -> Tensor:
    """Densify (testing only — O(N*d))."""
    N, K = m.values.shape
    out = torch.zeros((N, m.d), dtype=m.values.dtype, device=m.values.device)
    rows = torch.arange(N, device=m.values.device).repeat_interleave(K)
    return out.index_put_((rows, m.indices.reshape(-1).long()),
                          m.values.reshape(-1), accumulate=True)


# ---------------------------------------------------------------------------
# Sparse GLM margin / gradient
# ---------------------------------------------------------------------------


def margins(m: ELLMatrix, w: Tensor) -> Tensor:
    """x_i . w for every row — gather model features then row-sum."""
    return torch.sum(m.values * w[m.indices.long()], dim=1)


def grad(task: str, m: ELLMatrix, y: Tensor, w: Tensor) -> Tensor:
    """Sum GLM gradient: scatter-add of pull_i * values_i into w-space."""
    pull = glm.PULLS[task](y * margins(m, w), y)
    contrib = m.values * pull[:, None]
    out = torch.zeros(m.d, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, m.indices.reshape(-1).long(), contrib.reshape(-1))


def loss(task: str, m: ELLMatrix, y: Tensor, w: Tensor) -> Tensor:
    return glm.MARGIN_LOSSES[task](y * margins(m, w))


def incremental_epoch(task: str, w: Tensor, m: ELLMatrix, y: Tensor, step: float) -> Tensor:
    """Per-example sparse SGD epoch (sequential oracle) as a Python loop.

    Each step touches only the K nonzero features of the example.
    """
    pull_fn = glm.PULLS[task]
    idx_all = m.indices.long()
    for vals, idx, y_i in zip(m.values, idx_all, y):
        pull = pull_fn(y_i * torch.dot(vals, w[idx]), y_i)
        w = w.index_add(0, idx, -step * pull * vals)
    return w


def minibatch_epoch(
    task: str, w: Tensor, m: ELLMatrix, y: Tensor, step: float, batch: int
) -> Tensor:
    """Mini-batch sparse SGD epoch (per-replica rule of the async engine)."""
    n = m.values.shape[0]
    if n % batch:
        raise ValueError(f"minibatch_epoch needs n % batch == 0, got {n}, {batch}")
    for s in range(0, n, batch):
        mk = ELLMatrix(m.values[s:s + batch], m.indices[s:s + batch], m.d)
        w = w - (step / batch) * grad(task, mk, y[s:s + batch], w)
    return w
