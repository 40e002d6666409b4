"""Input pipeline: LM token batches + GLM partitions with rep-k halos.

The pipeline owns the paper's *data replication* axis (§5.2.3): every data
shard can be extended with ``rep_k`` halo examples from the neighbouring
shard — sequential access is preserved, hardware efficiency drops by k/|shard|
per pass, statistical efficiency rises.

Batches are drawn in numpy and land on ``device`` (``cuda`` unless the
caller says).  With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``)
each rank moves only its own rows of the global batch to the device, and
the rows are assembled as a DTensor sharded over the batch axes
(``("pod", "data")`` present in the mesh) and replicated over the rest:
the counterpart of the reference's ``make_array_from_process_local_data``.
Every rank draws the whole batch on the host, so the stream is the
reference's for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import common


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic LM token stream (shape-faithful stand-in for
    a tokenized corpus reader; swap ``_gen`` for a real loader in prod)."""

    vocab: int
    seq: int
    global_batch: int
    mesh: DeviceMesh | None = None
    seed: int = 0
    rep_k: int = 0
    device: str | torch.device | None = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._device = common.device(self.device)
        self._rows = None
        if self.mesh is not None:
            names = self.mesh.mesh_dim_names
            batch = [i for i, n in enumerate(names) if n in ("pod", "data")]
            self._placements = [Shard(0) if i in batch else Replicate()
                                for i in range(len(names))]
            coord = self.mesh.get_coordinate()
            shard, shards = 0, 1
            for i in batch:   # pod major, as the placements split the rows
                shard = shard * self.mesh.size(i) + coord[i]
                shards *= self.mesh.size(i)
            size = -(-self.global_batch // shards)   # torch.chunk's rows
            self._rows = slice(shard * size,
                               min((shard + 1) * size, self.global_batch))

    def _gen(self, n: int) -> np.ndarray:
        return self._rng.integers(0, self.vocab, size=(n, self.seq + 1),
                                  dtype=np.int32)

    def __iter__(self) -> Iterator[dict]:
        while True:
            buf = self._gen(self.global_batch)
            yield {k: self._place(v) for k, v in (("tokens", buf[:, :-1]),
                                                  ("labels", buf[:, 1:]))}

    def _place(self, rows: np.ndarray) -> torch.Tensor:
        if self._rows is None:
            return torch.from_numpy(np.ascontiguousarray(rows)).to(
                self._device)
        local = torch.from_numpy(np.ascontiguousarray(rows[self._rows]))
        return DTensor.from_local(local.to(self._device), self.mesh,
                                  self._placements, run_check=False,
                                  shape=torch.Size(rows.shape),
                                  stride=(rows.shape[1], 1))


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
