"""Per-rank programs inside a DTensor step: the recurrent mixers and the
MoE routing run on each rank's local tensors, as the reference's
``shard_map``-free mixers run under XLA's SPMD, which splits their scans
alone (DTensor has no rule for a scan, a chunk loop or a sort).

A :class:`Local` is one rank's share of such a program, read from the
activation it starts from: the batch rows that activation holds (the mesh
dims sharding its dim 0) and, where the program splits its work over
``"model"`` (Mamba2's heads, mLSTM's key dim), this rank's part of it.
It moves tensors in and out of local land with the gradient placements
that make DTensor's backward right:

* :meth:`Local.rows` an activation or state on the rows, its other dims
  whole; its gradient is this rank's rows, summed over the parts;
* :meth:`Local.whole` a weight gathered whole (an all-gather of its
  shards, freed with the program's tensors); its gradient is a partial
  sum on every mesh dim whose ranks did different work, so the backward
  all-reduces it over the rows' dims and reduce-scatters it back onto its
  shards;
* :meth:`Local.chunk` a weight's or a state's stored chunk along one dim
  over ``"model"``, where that chunk is what this rank's part reads
  (``w_out``'s rows, a cache's heads): nothing moves;
* :meth:`Local.reduce` a partial sum over the parts, summed;
* :meth:`Local.out` a local result as a DTensor on the rows, partial over
  the parts where each part contributed a share of the sum.

Nothing here touches a plain tensor: a mesh-less caller never builds a
:class:`Local`.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

#: the mesh axis a program may split its work over
MODEL = "model"


class Local:
    """One rank's share of a program that starts from the DTensor ``x``
    (``[B, ...]``).  ``parts``: into how many parts the program can split
    its work over ``"model"`` (heads, a key dim); it is split where the
    model axis' size divides ``parts`` and ``x`` is not sharded on it,
    else every model rank runs it whole on its rows.  ``rows_over_model``
    also deals the batch rows over ``"model"`` where they divide (the
    sLSTM), instead of splitting the work."""

    def __init__(self, x: DTensor, parts: int = 1, *,
                 rows_over_model: bool = False):
        mesh = self.mesh = x.device_mesh
        names = mesh.mesh_dim_names
        self.placements = [Shard(0) if p == Shard(0) else Replicate()
                           for p in x.placements]
        self.model = names.index(MODEL) if MODEL in names else None
        size = 1 if self.model is None else mesh.size(self.model)
        free = self.model is not None and self.placements[self.model] == \
            Replicate()
        if free and rows_over_model:
            held = x.shape[0]
            for i, p in enumerate(self.placements):
                if p == Shard(0):
                    held //= mesh.size(i)
            if held % size == 0:
                self.placements[self.model] = Shard(0)
        self.split = (self.model if free and not rows_over_model
                      and parts % size == 0 else None)
        self.parts = size if self.split is not None else 1
        self.part = (mesh.get_local_rank(self.split)
                     if self.split is not None else 0)
        self._rows = {i for i, p in enumerate(self.placements)
                      if p == Shard(0)}

    def _over_parts(self, placements, on_split) -> list:
        return [on_split if i == self.split else p
                for i, p in enumerate(placements)]

    def rows(self, t: torch.Tensor | None, extra=None) -> torch.Tensor | None:
        """``t`` (``[B, ...]``) on this rank's rows, every other dim whole
        but ``extra`` (``{dim: Shard}`` on the parts' mesh dim: a state
        stored on its heads)."""
        if t is None:
            return None
        pl = self._over_parts(self.placements,
                              extra if extra is not None else Replicate())
        grad = pl if extra is not None else self._over_parts(pl, Partial())
        return t.redistribute(self.mesh, pl).to_local(grad_placements=grad)

    def whole(self, w: torch.Tensor) -> torch.Tensor:
        """The weight ``w`` gathered whole on this rank."""
        if not isinstance(w, DTensor):
            return w
        rep = [Replicate()] * self.mesh.ndim
        grad = [Partial() if i in self._rows or i == self.split
                else Replicate() for i in range(self.mesh.ndim)]
        return w.redistribute(self.mesh, rep).to_local(grad_placements=grad)

    def chunk(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """This part's chunk of the weight ``w`` along ``dim`` (whole where
        the work is not split)."""
        if self.split is None:
            return self.whole(w)
        pl = self._over_parts([Replicate()] * self.mesh.ndim, Shard(dim))
        grad = [Partial() if i in self._rows else p for i, p in enumerate(pl)]
        return w.redistribute(self.mesh, pl).to_local(grad_placements=grad)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the parts of each part's local ``t``."""
        if self.split is None:
            return t
        partial = self._over_parts(self.placements, Partial())
        return DTensor.from_local(t, self.mesh, partial, run_check=False) \
            .redistribute(self.mesh, self.placements) \
            .to_local(grad_placements=partial)

    def out(self, t: torch.Tensor, *, summed: bool = False,
            on_split=None) -> DTensor:
        """The local result ``t`` as a DTensor on the rows: partial over
        the parts where ``summed`` (each part holds a share of the sum),
        or ``on_split`` (a ``Shard``: each part holds a chunk)."""
        pl = self.placements
        if self.split is not None and (summed or on_split is not None):
            pl = self._over_parts(pl, Partial() if summed else on_split)
        return DTensor.from_local(t, self.mesh, pl, run_check=False)

    def part_range(self, n: int) -> tuple[int, int]:
        """This part's ``[start, stop)`` of ``n`` items split evenly."""
        size = n // self.parts
        return self.part * size, (self.part + 1) * size
