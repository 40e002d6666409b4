"""Parameters: seeded initialisers, the containers that hold them, and
their sharding specs.

Each ``init_*`` in the port returns modules whose leaves are
``nn.Parameter``s in the reference's layout (``[d_in, d_out]`` weights,
applied as ``x @ w``), made with ``requires_grad=False``, as serving
wants them.  ``LM.requires_grad_()`` turns gradients on for a caller that
differentiates the module itself; the trainer differentiates an
``LM.from_tree`` over its parameter tree (:mod:`repro_torch.train.trainer`).
Drawn from :data:`META`, an init allocates nothing: every leaf is a
``meta`` tensor of the real shape and dtype (the counterpart of
``jax.eval_shape``, :mod:`repro_torch.launch.specs`).

A leaf's sharding is a :class:`P`, one entry a tensor dim, as the
reference's ``jax.sharding.PartitionSpec``; ``transformer.param_specs``
and ``decode.cache_specs`` give the trees.  Sharding rules (the
reference's DESIGN.md §6):
  vocab/embedding rows     -> "model"
  attention heads          -> "model"
  FFN hidden               -> "model"
  MoE experts              -> "model"   (expert parallelism)
  batch                    -> ("pod", "data") for sync; ("data",) within a
                              pod for async-local (pod axis = replica axis)
  optional FSDP            -> remaining large param axis over "data"
The port keeps one block a layer where the reference stacks layers, so a
port leaf's spec is the reference leaf's with the stacked layer axes
(always ``None``) dropped.  Virtual names (``"batch"``, ``"seq"``,
``"kvseq"``) are resolved against a mesh by ``trainer.resolve_spec``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard


#: the ``shard`` callback of a mesh-less caller: every activation as it is
NOSHARD = lambda x, spec: x  # noqa: E731


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``
    (replicated), an axis name, or a tuple of names (major to minor).  A
    tuple of one name is that name, as ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class AxisNames:
    pod: str | None = "pod"
    data: str = "data"
    model: str = "model"

    @property
    def batch_axes(self):
        return (self.pod, self.data) if self.pod else (self.data,)


class _MetaGenerator:
    """Stands in for a ``torch.Generator``: an init drawn from it makes
    ``meta`` tensors, shapes and dtypes without storage."""

    device = torch.device("meta")


#: pass as an init's generator to allocate nothing
META = _MetaGenerator()


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 from ``gen`` on its device, then
    cast to ``dtype`` (the reference's ``pm.normal``)."""
    if gen is META:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (scale * torch.randn(shape, generator=gen, device=gen.device,
                                dtype=torch.float32)).to(dtype)


def dense_spec(in_spec=None, out_spec="model", fsdp_axis=None) -> P:
    """A ``[d_in, d_out]`` weight's spec (the reference's ``make_dense``)."""
    return P(in_spec if in_spec is not None else fsdp_axis, out_spec)


def fsdp_axes(fsdp: bool):
    """The FSDP entry of a large weight: ``("data", "pod")`` (pod joins on
    multi-pod meshes) or None."""
    return ("data", "pod") if fsdp else None


#: a norm's scale (the reference's ``make_norm``)
NORM_SPEC = P(None)


def stacked(spec: P, axes: int = 1) -> P:
    """``spec`` behind ``axes`` unsharded layer axes (``stack_layers``)."""
    return P(*(None,) * axes, *spec)


def make_norm(d: int, dtype: torch.dtype,
              device: torch.device) -> nn.Parameter:
    return frozen(torch.ones(d, dtype=dtype, device=device))


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def frozen_dict(**tensors: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict({k: frozen(t) for k, t in tensors.items()})


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` in place, where ``dst`` may be a DTensor (a view
    of a cache leaf): ``src`` placed as ``dst`` is, then written into
    ``dst``'s local shard, which is a view of the leaf's."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements).to_local()
    dst.to_local().copy_(src)


def assign_slot(dst: torch.Tensor, dim: int, index: int,
                src: torch.Tensor) -> None:
    """``dst.select(dim, index).copy_(src.select(dim, 0))`` in place, where
    ``dst`` may be a DTensor sharded along ``dim`` (a KV cache on
    ``"kvseq"``): the rank whose shard holds ``index`` writes it."""
    if not isinstance(dst, DTensor):
        dst.select(dim, index).copy_(src.select(dim, 0))
        return
    mesh, pl = dst.device_mesh, dst.placements
    if isinstance(src, DTensor):
        src = src.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in pl]).to_local()
    local = dst.to_local()
    at = index - shard_offset(dst.shape[dim], dim, mesh, pl)
    if 0 <= at < local.shape[dim]:
        local.select(dim, at).copy_(src.select(dim, 0))


def shard_offset(size: int, dim: int, mesh, placements) -> int:
    """Where this rank's shard of a ``size``-long dim ``dim`` starts, the
    mesh dims that shard it splitting it left to right as ``torch.chunk``
    deals it (a first chunk of the ceiling's size)."""
    coord, offset = mesh.get_coordinate(), 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            offset += start
            size = min(chunk, size - start)
    return offset
