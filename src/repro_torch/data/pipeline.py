"""Input pipeline: LM token batches + GLM partitions with rep-k halos.

The pipeline owns the paper's *data replication* axis (§5.2.3): every data
shard can be extended with ``rep_k`` halo examples from the neighbouring
shard — sequential access is preserved, hardware efficiency drops by k/|shard|
per pass, statistical efficiency rises.

The reference's mesh-less path: batches are drawn in numpy and land on one
``device`` (``cuda`` unless the caller says).  Placing them against a mesh
waits for the port's mesh (ROADMAP Queue 1 item 7(d)).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.kernels import common


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic LM token stream (shape-faithful stand-in for
    a tokenized corpus reader; swap ``_gen`` for a real loader in prod)."""

    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    rep_k: int = 0
    device: str | torch.device | None = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._device = common.device(self.device)

    def _gen(self, n: int) -> np.ndarray:
        return self._rng.integers(0, self.vocab, size=(n, self.seq + 1),
                                  dtype=np.int32)

    def __iter__(self) -> Iterator[dict]:
        while True:
            buf = self._gen(self.global_batch)
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
                   for k, v in (("tokens", buf[:, :-1]),
                                ("labels", buf[:, 1:]))}


def shard_with_halo(n: int, shards: int, rep_k: int) -> list[np.ndarray]:
    """Contiguous shard index ranges with rep_k cyclic halo (paper §5.2.3)."""
    per = n // shards
    out = []
    for r in range(shards):
        base = np.arange(r * per, (r + 1) * per)
        halo = (np.arange(rep_k) + ((r + 1) % shards) * per) % n
        out.append(np.concatenate([base, halo]).astype(np.int64)
                   if rep_k else base.astype(np.int64))
    return out


def glm_shards(X: np.ndarray, y: np.ndarray, shards: int, rep_k: int = 0):
    """Partition a GLM dataset into per-replica (X, y) shards with halos."""
    idx = shard_with_halo(len(y), shards, rep_k)
    return [(X[i], y[i]) for i in idx]
