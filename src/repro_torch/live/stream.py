"""Streaming minibatch sources for the live (train-while-serving) loop.

A *stream* is an unbounded, deterministic sequence of fixed-shape
minibatches: the continual-learning analogue of the closed epochs the
study engine runs.  Two sources:

* :class:`SyntheticStream` — a seedable generator over a *stationary*
  planted-GLM distribution (one ``w*`` per stream seed, fresh examples
  per chunk).  Chunk ``i`` is a pure function of ``(seed, i)``, so two
  streams with the same config replay byte-identical batches — replays,
  fault-injection re-runs, and benchmark re-runs all see the same data.
* :class:`LibsvmStream` — a replayable chunked reader over the ingest
  layer's libsvm parser (:mod:`repro_torch.data.ingest.libsvm`): fixed-size
  row chunks converted to padded ELL with a pinned feature width, so a
  file larger than memory streams through the learner.  ``loop=True``
  wraps around at EOF (the continual setting re-visits the data).

Both yield :class:`StreamBatch` — ELL ``values/indices`` plus labels,
and a dense view for dense-profile streams — at one fixed shape.  The
batches are numpy, byte-identical to the reference package's streams for
the same seed (or file); they become tensors in the learner.  Per-replica
partition assignment reuses :func:`repro_torch.core.sgd.partition_indices`
(the paper's row-rr / row-ch access paths + rep-k halos apply unchanged
to a chunk).
"""
from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import sparse as sparse_mod
from repro_torch.data.ingest import libsvm
from repro_torch.kernels import common


@dataclasses.dataclass(frozen=True)
class StreamBatch:
    """One fixed-shape minibatch of a live stream.

    ``seq`` is the monotone chunk index (0, 1, 2, ...) — the learner's
    data clock.  ``values``/``indices`` are zero-padded ELL ``[n, K]``;
    ``X`` is the dense ``[n, d]`` view for dense streams (None for
    sparse ones).  Labels ``y`` are in {-1, +1}.
    """

    seq: int
    values: np.ndarray          # [n, K] float32
    indices: np.ndarray         # [n, K] int32
    y: np.ndarray               # [n] float32
    X: np.ndarray | None = None  # [n, d] float32 (dense streams only)

    @property
    def n(self) -> int:
        return len(self.y)


class SyntheticStream:
    """Deterministic infinite stream over one planted GLM distribution.

    ``w*`` (and the Zipfian feature popularity for sparse profiles) is
    drawn once from ``seed``; chunk ``i`` draws its examples from
    ``default_rng([seed, 1 + i])`` — a pure function of the pair, so
    ``batch(i)`` is random-access and ``reset()`` is free.  ``dense=True``
    produces Gaussian dense rows (ELL view = all ``d`` columns per row);
    the default is the sparse profile (lognormal nnz/row, Zipf columns)
    matching :func:`repro_torch.data.synthetic.make_sparse`.
    """

    def __init__(self, *, n_batch: int, d: int, seed: int = 0,
                 dense: bool = False, avg_nnz: float = 4.0,
                 max_nnz: int = 8, noise: float = 0.05):
        if n_batch < 1 or d < 1:
            raise ValueError(f"n_batch/d must be >= 1: {n_batch}, {d}")
        self.n_batch = n_batch
        self.d = d
        self.seed = seed
        self.dense = dense
        self.noise = noise
        self.max_nnz = min(max_nnz, d) if not dense else d
        self.avg_nnz = min(avg_nnz, float(self.max_nnz))
        rng = np.random.default_rng(seed)
        if dense:
            self.w_star = rng.normal(0, 1, d).astype(np.float32)
            self._probs = None
        else:
            ranks = np.arange(1, d + 1, dtype=np.float64)
            probs = 1.0 / ranks
            self._probs = probs / probs.sum()
            self.w_star = (rng.normal(0, 1, d) / np.sqrt(ranks)) \
                .astype(np.float32)

    @property
    def ell_width(self) -> int:
        return self.max_nnz

    def batch(self, seq: int) -> StreamBatch:
        """Chunk ``seq`` — pure function of ``(seed, seq)``."""
        rng = np.random.default_rng([self.seed, 1 + seq])
        n = self.n_batch
        if self.dense:
            X = rng.normal(0, 1, (n, self.d)).astype(np.float32)
            margins = X @ self.w_star
            y = _flip(rng, margins, self.noise)
            return StreamBatch(seq, X.copy(), _dense_indices(n, self.d),
                               y, X=X)
        K = self.max_nnz
        mu = np.log(max(self.avg_nnz, 1.5))
        nnz = np.clip(rng.lognormal(mu, 0.8, n), 1, K).astype(np.int64)
        values = np.zeros((n, K), np.float32)
        indices = np.zeros((n, K), np.int32)
        margins = np.zeros(n, np.float64)
        for i in range(n):
            idx = np.unique(rng.choice(self.d, int(nnz[i]), p=self._probs))
            val = rng.normal(0, 1, len(idx)).astype(np.float32)
            values[i, :len(idx)] = val
            indices[i, :len(idx)] = idx
            margins[i] = float(val @ self.w_star[idx])
        y = _flip(rng, margins, self.noise)
        return StreamBatch(seq, values, indices, y)

    def __iter__(self) -> Iterator[StreamBatch]:
        for i in itertools.count():
            yield self.batch(i)

    def holdout(self, n: int = 512, *, seq: int = -1, device=None):
        """A fixed evaluation set drawn outside the training chunks
        (chunk index ``-1`` never appears in the stream) — returns
        ``(ELLMatrix on device, y numpy)`` for
        :func:`repro_torch.core.sparse.loss`; ``device`` is ``cuda``
        unless the caller says."""
        saved = self.n_batch
        try:
            self.n_batch = n
            b = self.batch(seq)
        finally:
            self.n_batch = saved
        return sparse_mod.ELLMatrix(*_to_device(b.values, b.indices, device),
                                    self.d), b.y


class LibsvmStream:
    """Replayable chunked reader: libsvm text -> fixed-shape ELL batches.

    Rows stream through :func:`repro_torch.data.ingest.libsvm.iter_rows`
    (bz2-transparent, comment/qid-robust) in chunks of ``n_batch``;
    each chunk converts to padded ELL at the pinned ``(d, ell_width)``.
    The tail chunk short of ``n_batch`` rows is dropped — live batches
    must hold one fixed shape.  ``loop=True`` restarts at EOF so
    the stream is unbounded (``seq`` keeps increasing across wraps);
    ``loop=False`` raises ``StopIteration`` at EOF.

    Indices follow the libsvm 1-based convention; ``zero_based=True``
    reads them as 0-based (chunked streaming cannot afford the ingest
    layer's whole-file base auto-detection).
    """

    def __init__(self, path: str | Path, *, n_batch: int, d: int,
                 ell_width: int, loop: bool = True,
                 zero_based: bool = False, labels_01: bool | None = None):
        self.path = Path(path)
        self.n_batch = n_batch
        self.d = d
        self.ell_width = ell_width
        self.loop = loop
        self.zero_based = zero_based
        self.labels_01 = labels_01
        self._rows: Iterator | None = None
        self._seq = 0

    dense = False

    def _open(self):
        import bz2
        opener = bz2.open if self.path.suffix == ".bz2" else open
        self._fh = opener(self.path, "rt")
        return libsvm.iter_rows(self._fh)

    def reset(self) -> None:
        """Rewind to the start of the file (``seq`` keeps counting)."""
        self._rows = None

    def batch(self) -> StreamBatch:
        """The next chunk of ``n_batch`` rows (wrapping at EOF if
        ``loop``); raises ``StopIteration`` when the file is exhausted
        and ``loop=False``."""
        if self._rows is None:
            self._rows = self._open()
        values = np.zeros((self.n_batch, self.ell_width), np.float32)
        indices = np.zeros((self.n_batch, self.ell_width), np.int32)
        y = np.zeros(self.n_batch, np.float32)
        got = 0
        while got < self.n_batch:
            try:
                label, idx, val = next(self._rows)
            except StopIteration:
                if not self.loop:
                    raise
                self._rows = self._open()
                continue
            if not self.zero_based:
                if len(idx) and int(idx[0]) == 0:
                    raise libsvm.LibsvmFormatError(
                        f"{self.path}: feature index 0 in a 1-based "
                        f"stream; pass zero_based=True")
                idx = idx - 1
            if len(idx) and int(idx[-1]) >= self.d:
                raise libsvm.LibsvmFormatError(
                    f"{self.path}: feature index {int(idx[-1])} out of "
                    f"range for d={self.d}")
            k = min(len(idx), self.ell_width)
            values[got, :k] = val[:k]
            indices[got, :k] = idx[:k]
            y[got] = label
            got += 1
        if self.labels_01 or (self.labels_01 is None and (y >= 0).all()):
            y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
        b = StreamBatch(self._seq, values, indices, y)
        self._seq += 1
        return b

    def __iter__(self) -> Iterator[StreamBatch]:
        while True:
            try:
                yield self.batch()
            except StopIteration:
                return


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _flip(rng, margins, noise) -> np.ndarray:
    y = np.where(margins >= 0, 1.0, -1.0)
    y[rng.random(len(y)) < noise] *= -1.0
    return y.astype(np.float32)


def _dense_indices(n: int, d: int) -> np.ndarray:
    return np.broadcast_to(np.arange(d, dtype=np.int32), (n, d)).copy()


def _to_device(values, indices, device):
    dev = common.device(device)
    return torch.from_numpy(values).to(dev), torch.from_numpy(indices).to(dev)
