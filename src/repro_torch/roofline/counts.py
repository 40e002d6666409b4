"""The dry run's op counts: the counterpart of the reference's
``roofline/hlo.py``.

The reference compiles each cell with XLA and parses the partitioned HLO
text for three figures a device: dot flops, collective wire bytes and an
HBM-traffic proxy, each op's count multiplied by the trip counts of the
loops around it.  The port compiles nothing.  Its dry run
(``launch/dryrun.py``) runs one step eagerly on fake tensors as rank 0 of
a fake world, so every op the step issues passes through a
``TorchDispatchMode``, once each time it runs.  Counting the dispatched
ops gives the same three figures with no text to parse and no
multipliers to rebuild: the port's loops are Python, so each trip
dispatches its ops again.  For the same reason the reference's
``n_while`` and ``max_trip`` have no counterpart; the cell's JSON leaves
them out.

* **Dot flops by input dtype** (``hlo.dot_flops``): :class:`LocalFlopCounter`'s
  per-op counts (``FlopCounterMode``'s matmuls and convolutions, and the
  attention operators through their registered formulas, visible pairs
  only), each keyed by the dtype of its first operand.
* **Collective wire bytes a device** (``hlo.collective_bytes``): each
  functional collective DTensor issues, by the reference's ring formulas
  (:func:`wire_bytes`), ``N`` the size of its process group, recorded by
  kind and by the link its group crosses
  (``roofline.analysis.link_class``).
* **An HBM-traffic proxy** (``hlo.memory_bytes`` / ``hlo._op_traffic``):
  every local op's tensor inputs and outputs counted once; nothing for
  views (unless one copied), allocation and collectives (which have
  their own term); an in-place write into part of a buffer counts twice its update,
  not the buffer, as the reference's dynamic-update-slice rule does; the
  attention operator counts its kernel's bytes as
  ``roofline.kernels.kernel_cost`` prices them.  This is eager PyTorch,
  unfused: every op reads its inputs from HBM and writes its outputs
  back, so the proxy is the traffic the port's step really issues, not
  the fused lower bound XLA's top-level ops give the reference.
"""
from __future__ import annotations

import heapq
import math

import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: functional collective -> (the reference's HLO kind, the tensor its ring
#: formula reads: the input or the output)
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "in"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         "in"),
    "_c10d_functional.all_reduce": ("all-reduce", "in"),
    "_c10d_functional.all_reduce_": ("all-reduce", "in"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "in"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "in"),
    "_dtensor.shard_dim_alltoall": ("all-to-all", "in"),
    "_c10d_functional.broadcast": ("collective-permute", "in"),
}

#: ops that move no bytes besides the views ``OpOverload.is_view`` names:
#: allocation, detaching, and the wait on a collective
NO_TRAFFIC = frozenset({
    "aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
    "aten._unsafe_view", "prim.device", "_c10d_functional.wait_tensor"})

#: writes into part of a buffer: the operands after the buffer (the update
#: and its indices) are read and written, the buffer stays put
SLICE_WRITES = frozenset({
    "aten.copy_", "aten.index_put", "aten.index_put_",
    "aten._index_put_impl_", "aten.slice_scatter", "aten.select_scatter",
    "aten.diagonal_scatter", "aten.as_strided_scatter", "aten.scatter",
    "aten.scatter_", "aten.scatter_add", "aten.scatter_add_",
    "aten.index_copy", "aten.index_copy_", "aten.index_add",
    "aten.index_add_"})

#: the attention forward, priced as its kernel (``roofline.kernels``)
ATTENTION = "repro_torch.flash_attn"

#: the traffic proxy's largest ops kept in a cell's record
TOP = 3


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Wire bytes a device of one collective over ``n`` ranks, the
    reference's ring formulas (``hlo.collective_bytes``): all-gather
    (N-1)/N of the output, reduce-scatter (N-1)/N of the input, all-reduce
    2(N-1)/N, all-to-all (N-1)/N, a permute the tensor."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * frac * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    return frac * nbytes


def nbytes(xs) -> int:
    """Bytes of the tensors in ``xs`` and in its nested lists and tuples,
    each counted once per appearance."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            total += nbytes(x)
    return total


def group_ranks(group_name: str) -> list[int]:
    """The global ranks of the process group a functional collective
    names."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(group_name))


def attention_bytes(q: torch.Tensor, k: torch.Tensor) -> float:
    """The attention kernel's HBM bytes for operands ``[B, H, S, hd]``, as
    ``roofline.kernels`` prices a launch."""
    from repro_torch.roofline.kernels import kernel_cost
    return kernel_cost("flash_attn", {
        "batch": q.shape[0], "heads_q": q.shape[1], "heads_kv": k.shape[1],
        "seq_q": q.shape[2], "seq_k": k.shape[2], "head_dim": q.shape[3],
        "dtype": str(q.dtype).removeprefix("torch.")})["hbm_bytes"]


def _aliases(out, t) -> bool:
    """Whether ``out`` is a tensor on ``t``'s storage."""
    return (isinstance(out, torch.Tensor) and isinstance(t, torch.Tensor)
            and StorageWeakRef(out.untyped_storage()).cdata
            == StorageWeakRef(t.untyped_storage()).cdata)


def rule_of(func) -> str:
    """How :func:`op_traffic` prices ``func``: ``"none"``, ``"view"`` (no
    bytes unless it copied), ``"slice"``, ``"attention"``, ``"collective"``
    or ``"all"`` (inputs and outputs)."""
    name = str(func._overloadpacket)
    if name in COLLECTIVES:
        return "collective"
    if name in NO_TRAFFIC:
        return "none"
    if func.is_view:
        return "view"
    if name in SLICE_WRITES:
        return "slice"
    return "attention" if name == ATTENTION else "all"


def op_traffic(rule: str, args, kwargs, out) -> float:
    """The traffic proxy's bytes for one local op under its ``rule``
    (module docstring).  A view op that copies (``contiguous``,
    ``reshape`` of a strided tensor) counts as any other op."""
    if rule == "view" and (not isinstance(out, torch.Tensor)
                           or _aliases(out, args[0])):
        return 0.0
    if rule == "slice":
        return 2.0 * nbytes((args[1:], tuple(kwargs.values())))
    if rule == "attention":
        return attention_bytes(args[0], args[1])
    return float(nbytes((args, tuple(kwargs.values()), out)))


def _split(out) -> int:
    t = out[0] if isinstance(out, (tuple, list)) and out else out
    if not isinstance(t, DTensor):
        return 1
    return math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                     if p.is_shard() or p.is_partial())


def _first_dtype(args) -> str:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return str(t.dtype).removeprefix("torch.")
    return "float32"


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over rank 0's share of DTensor ops.  A mode
    sees a DTensor op at its global shapes, before DTensor splits it, so
    each op's count is divided by the ranks that split its work: the mesh
    dims on which its output is sharded or partial (a replicated dim
    repeats the work on every rank).  ``by_dtype`` sums the same counts
    by the dtype of each op's first operand (``hlo.dot_flops``'s split)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.by_dtype: dict[str, int] = {}

    def _count_flops(self, func_packet, out, args, kwargs):
        split = _split(out)
        parents = set(self.mod_tracker.parents) | {"Global"}
        before = {p: self.flop_counts[p][func_packet] for p in parents}
        out = super()._count_flops(func_packet, out, args, kwargs)
        for p, b in before.items():
            self.flop_counts[p][func_packet] = (
                b + (self.flop_counts[p][func_packet] - b) // split)
        added = self.flop_counts["Global"][func_packet] - before["Global"]
        if added:
            dt = _first_dtype(args)
            self.by_dtype[dt] = self.by_dtype.get(dt, 0) + added
        return out


class OpCounts(TorchDispatchMode):
    """Rank 0's HBM-traffic proxy and collective wire bytes over a traced
    step.  It lets DTensor desugar each op first (a DTensor op returns
    ``NotImplemented`` here, as ``CommDebugMode`` does), so it sees the
    local ops on each rank's shards and the collectives DTensor issues,
    and none of them twice.

    ``hbm_bytes`` is the proxy, ``by_op`` its bytes by op name;
    ``wire`` the wire bytes by ``(kind, link)``, ``link`` the class
    ``roofline.analysis.link_class`` gives the collective's group."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0.0
        self.by_op: dict[str, float] = {}
        self.wire: dict[tuple[str, str], float] = {}
        self._links: dict[str, tuple[str, int]] = {}
        self._rules: dict = {}   # OpOverload -> (rule_of, its name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if DTensor in types:
            return NotImplemented
        out = func(*args, **kwargs)
        rule, name = self._rules.get(func) or self._rules.setdefault(
            func, (rule_of(func), str(func._overloadpacket)))
        if rule == "collective":
            self._collective(name, args, kwargs, out)
        elif rule != "none":
            b = op_traffic(rule, args, kwargs, out)
            if b:
                self.hbm_bytes += b
                self.by_op[name] = self.by_op.get(name, 0.0) + b
        return out

    def _collective(self, name, args, kwargs, out) -> None:
        from repro_torch.roofline.analysis import link_class
        kind, reads = COLLECTIVES[name]
        group = kwargs.get("group_name", args[-1])
        if group not in self._links:
            ranks = group_ranks(group)
            self._links[group] = (link_class(ranks), len(ranks))
        link, n = self._links[group]
        moved = (out,) if reads == "out" else args[:1]
        b = wire_bytes(kind, nbytes(moved), n)
        self.wire[(kind, link)] = self.wire.get((kind, link), 0.0) + b

    def record(self) -> dict:
        """The cell's keys: ``hbm_bytes``, ``hbm_top`` and the wire bytes
        in all, by kind and by link."""
        by_kind, by_link = {}, {}
        for (kind, link), b in self.wire.items():
            by_kind[kind] = by_kind.get(kind, 0.0) + b
            by_link[link] = by_link.get(link, 0.0) + b
        return {"hbm_bytes": self.hbm_bytes,
                "hbm_top": dict(heapq.nlargest(TOP, self.by_op.items(),
                                               key=lambda kv: kv[1])),
                "wire_bytes": sum(self.wire.values()),
                "wire_bytes_by_kind": by_kind,
                "wire_bytes_by_link": by_link}
