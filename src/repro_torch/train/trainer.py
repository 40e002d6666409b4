"""Training steps: synchronous and asynchronous-local (the paper's
model-update axis).

SYNC (paper's synchronous axis)
    Mini-batch SGD on one model: every step sees the same model, so the
    statistical efficiency is the sequential algorithm's (paper Section 4).
    ``micro_batches > 1`` sums the micro-batches' gradients in fp32 and
    divides, as the reference's accumulation scan does.

ASYNC-LOCAL (paper's asynchronous axis; DimmWitted §5.1)
    Every leaf carries a leading replica axis: replica ``r`` runs
    independent mini-batch SGD on its slice of the batch, and every
    ``merge_every`` steps the caller merges the replicas: their fp32 mean
    broadcast back to each, or (``compress_merge``) each replica's int8
    drift from a shared anchor with error feedback (optim/compress.py), the
    mean of the dequantized drifts moving the anchor.

The port's trees are flat parameter dicts (:mod:`repro_torch.utils.tree`).
A step differentiates the leaves of an ``LM.from_tree`` over the tree
(:func:`value_and_grad`), so a tree from an init, a checkpoint or an
update trains alike, and updates run under ``torch.no_grad``.  The
replica axis is a Python loop over the replicas, not ``torch.func.vmap``:
the attention kernel is a ctypes call, which vmap cannot batch.

ON A MESH (``mesh=``, a ``torch.distributed`` ``DeviceMesh``; the
reference's ``jax.sharding.Mesh``) the trees' leaves are DTensors placed
by the spec trees (:func:`resolve_tree`), and the ``shard`` callback
(:func:`make_shard_fn`) redistributes activations where the reference
constrains them.  The sync step is data-parallel over ``("pod",
"data")``: DTensor makes the gradient reductions XLA's SPMD inserts.  The
async-local step runs each replica on its own pod's sub-mesh (the
reference's shard_map with a manual ``"pod"`` axis), so no collective of
``local_step`` spans pods; ``merge_step`` is the only cross-pod traffic.
Virtual axis names in spec trees are resolved here:
    "batch" -> ("pod", "data") present in the mesh
    "seq"   -> "model" when cfg.seq_shard (sequence parallelism) else None
    "kvseq" -> "model"
    any axis not in the mesh -> None
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.nn import decode, transformer
from repro_torch.nn.param import NOSHARD, P
from repro_torch.nn.transformer import ArchConfig
from repro_torch.optim import compress
from repro_torch.optim.sgd import Optimizer, apply_updates
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Spec resolution
# ---------------------------------------------------------------------------


def resolve_spec(spec: P, mesh, cfg: ArchConfig | None = None, *,
                 extra: dict | None = None) -> P:
    """Map virtual axis names and drop axes absent from the mesh (read
    from ``mesh.mesh_dim_names``), entry for entry as the reference."""
    names = set(mesh.mesh_dim_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    mapping = {"batch": batch_axes,
               "seq": ("model" if (cfg is None or cfg.seq_shard) else None),
               "kvseq": "model"}
    if extra:
        mapping.update(extra)

    def map_one(ax):
        return mapping.get(ax, ax) if isinstance(ax, str) else ax

    out = []
    for ax in spec:
        if isinstance(ax, tuple):  # composite axis: map + flatten + filter
            mapped = []
            for a in ax:
                ma = map_one(a)
                mapped.extend(ma if isinstance(ma, tuple) else (ma,))
            ax = tuple(a for a in mapped if a in names) or None
        else:
            ax = map_one(ax)
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if a in names) or None
            elif isinstance(ax, str) and ax not in names:
                ax = None
        out.append(ax)
    return P(*out)


def placements(spec: P, mesh) -> list:
    """A resolved spec as DTensor placements: ``Shard(i)`` on every mesh
    dim that tensor dim ``i`` names, ``Replicate()`` elsewhere; an axis
    named twice raises.  A composite entry lists its axes major to minor,
    and DTensor splits a dim over its mesh dims left to right, in mesh
    order, so an entry whose axes come out of that order (the FSDP entry
    ``("data", "pod")`` on a ``(pod, data, model)`` mesh) is split in mesh
    order: each rank then holds another rank's chunk of the reference's
    order, of the same size (an even split: every such dim of the
    configs), and a gather gives the same tensor."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (
            () if entry is None else (entry,))
        for i in (names.index(a) for a in axes):
            if out[i] != Replicate():
                raise ValueError(f"spec {spec!r} names {names[i]!r} twice")
            out[i] = Shard(dim)
    return out


def resolve_tree(specs, mesh, cfg=None, *, extra=None):
    """A spec tree (dicts of :class:`P`) as a tree of placements."""
    if isinstance(specs, dict):
        return {k: resolve_tree(v, mesh, cfg, extra=extra)
                for k, v in specs.items()}
    return placements(resolve_spec(specs, mesh, cfg, extra=extra), mesh)


def distribute(tree, mesh: DeviceMesh, placement_tree):
    """``tree``'s tensors as DTensors on ``mesh`` by ``placement_tree``
    (from :func:`resolve_tree`): each rank keeps its shard of the full
    tensor it is given."""
    return tree_map(lambda x, pl: distribute_tensor(x, mesh, pl), tree,
                    placement_tree)


def make_shard_fn(mesh: DeviceMesh | None, cfg: ArchConfig):
    """Activation-constraint callback threaded through the model: a
    DTensor redistributed to the resolved spec's placements (the eager
    counterpart of ``with_sharding_constraint``); plain tensors pass.  A
    ``"batch"`` entry whose axes cannot split the tensor's dim (long_500k's
    global batch of 1) is dropped there, as the reference's dry run
    resolves its activations with ``extra={"batch": ()}``.  What has no
    DTensor rule (the recurrent mixers' scans, the MoE routing) leaves
    DTensor for each rank's local tensors in between
    (:mod:`repro_torch.nn.local`): the mixers on their share of the heads
    or key dim over ``"model"``, their outputs' partial sums placed here
    on the residual's spec."""
    if mesh is None:
        return NOSHARD

    def shard(x, spec):
        if not isinstance(x, DTensor):
            return x
        out = resolve_spec(spec, mesh, cfg)
        if any(n % _ranks(e, mesh) for n, e in zip(x.shape, out)):
            whole = resolve_spec(spec, mesh, cfg, extra={"batch": ()})
            out = P(*(w if n % _ranks(e, mesh) else e
                      for n, e, w in zip(x.shape, out, whole)))
        return x.redistribute(mesh, placements(out, mesh))

    return shard


def _ranks(entry, mesh) -> int:
    """The ranks a resolved spec entry splits a dim over."""
    axes = entry if isinstance(entry, tuple) else (
        () if entry is None else (entry,))
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def opt_state_specs(opt_state_shapes, param_specs):
    """Spec tree for optimizer state: moment buffers mirror the params."""
    specs = {}
    for k in opt_state_shapes:
        specs[k] = param_specs if k in ("m", "v") else P()
    return specs


def _on_mesh(mesh):
    """Plain tensors made inside a step (positions, zeros) count as
    replicated on a mesh."""
    return implicit_replication() if mesh is not None else \
        contextlib.nullcontext()


def value_and_grad(cfg: ArchConfig, params: dict, batch: dict, *,
                   shard=NOSHARD) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` of ``transformer.loss_fn`` at ``params``: the loss
    detached, the gradients a tree like ``params`` in its dtypes."""
    lm = transformer.LM.from_tree(params)
    loss = transformer.loss_fn(lm, cfg, batch, shard=shard)
    names, leaves = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def replica(tree, r: int):
    """Replica ``r`` of a tree whose leaves lead with the replica axis."""
    return tree_map(lambda x: x[r], tree)


def stack_replicas(trees: list):
    """Trees of one structure stacked on a new leading replica axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# Synchronous step
# ---------------------------------------------------------------------------


def make_sync_step(cfg: ArchConfig, optimizer: Optimizer, *,
                   micro_batches: int = 1, mesh: DeviceMesh | None = None,
                   param_specs=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; with micro-batches the loss is the last micro-batch's.

    With ``mesh`` the leaves are DTensors: the batch sharded over the batch
    axes, the parameters by their specs; the loss comes back a plain
    replicated scalar, and the parameters on ``param_specs``' placements
    (the reference's out_shardings), or on those they came in with."""
    shard = make_shard_fn(mesh, cfg)
    out_placements = (None if mesh is None or param_specs is None
                      else resolve_tree(param_specs, mesh, cfg))

    def train_step(params, opt_state, batch):
        came = {k: v.placements for k, v in params.items()
                if isinstance(v, DTensor)}
        with _on_mesh(mesh):
            if micro_batches == 1:
                loss, grads = value_and_grad(cfg, params, batch, shard=shard)
            else:
                split = {k: v.reshape(micro_batches,
                                      v.shape[0] // micro_batches,
                                      *v.shape[1:]) for k, v in batch.items()}
                grads = {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
                for i in range(micro_batches):
                    loss, g = value_and_grad(cfg, params, replica(split, i),
                                             shard=shard)
                    for k, gk in g.items():
                        grads[k] += gk
                grads = {k: g / micro_batches for k, g in grads.items()}
            with torch.no_grad():
                updates, opt_state = optimizer.update(grads, opt_state, params)
                del grads
                params = apply_updates(params, updates)
        if came:
            params = {k: v.redistribute(
                mesh, (out_placements or came)[k]) for k, v in params.items()}
            loss = loss.full_tensor()
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# Asynchronous-local step
# ---------------------------------------------------------------------------


def make_async_local_step(cfg: ArchConfig, optimizer: Optimizer, *,
                          compress_merge: bool = False,
                          mesh: DeviceMesh | None = None, param_specs=None):
    """``(local_step, merge_step)`` over replica-stacked trees.

    ``local_step(params_r, opt_state_r, batch_r) -> (params_r,
    opt_state_r, losses [R])`` runs one optimizer step on each replica with
    its slice ``batch_r[r]``; nothing passes between replicas.
    ``merge_step(params_r, anchor=None, error_feedback=None) -> (merged,
    anchor, error_feedback)``: the fp32 mean of the replicas broadcast to
    each (a view, as the reference's ``broadcast_to``), or with
    ``compress_merge`` the anchor moved by the mean of the replicas' int8
    drifts, carrying each replica's quantization error forward; it runs a
    leaf at a time, so the fp32 drifts of one leaf are its peak.

    On a mesh with a ``"pod"`` axis the replica axis is sharded over it
    (one replica a pod, ``R`` the pod axis' size): ``local_step`` takes
    each rank's replica to its pod's ``(data, model)`` sub-mesh, steps it
    there with the batch over ``"data"`` alone, and stacks it back, so its
    collectives stay inside the pod.  ``merge_step`` averages over
    ``"pod"``; the int8 merge gathers each leaf's fp32 drift and runs the
    mesh-less arithmetic on it (the same numbers; sending the int8 codes
    alone is later work)."""
    pod = mesh is not None and "pod" in mesh.mesh_dim_names
    inner = mesh[tuple(a for a in mesh.mesh_dim_names if a != "pod")] \
        if pod else None
    sync = make_sync_step(cfg, optimizer, mesh=inner,
                          param_specs=param_specs)

    def local_step(params_r, opt_state_r, batch_r):
        if pod:
            return _pod_local(sync, inner, params_r, opt_state_r, batch_r)
        out = {k: torch.empty_like(v) for k, v in params_r.items()}
        states, losses = [], []
        for r in range(next(iter(params_r.values())).shape[0]):
            p, o, loss = sync(replica(params_r, r), replica(opt_state_r, r),
                              replica(batch_r, r))
            with torch.no_grad():
                for k, v in p.items():
                    out[k][r] = v
            del p
            states.append(o)
            losses.append(loss)
        return out, stack_replicas(states), torch.stack(losses)

    def mean_leaf(x):
        m = x.float().mean(0, keepdim=True).to(x.dtype).expand(x.shape)
        if isinstance(x, DTensor):   # the mean over "pod", placed like x
            m = m.redistribute(x.device_mesh, x.placements)
        return m

    def compressed_leaf(x, a, e):
        delta = x.float() - a[None].float()
        qt, e = compress.compress_tree(delta, e)
        mean = compress.decompress_tree(qt, delta).mean(0)
        a = (a.float() + mean).to(a.dtype)
        return a[None].expand(x.shape).to(x.dtype), a, e

    @torch.no_grad()
    def merge_step(params_r, anchor=None, error_feedback=None):
        if not compress_merge:
            with _on_mesh(mesh):
                return ({k: mean_leaf(x) for k, x in params_r.items()},
                        anchor, error_feedback)
        merged, new_anchor, ef = {}, {}, {}
        for k, x in params_r.items():
            merged[k], new_anchor[k], ef[k] = _whole(
                compressed_leaf, x, anchor[k],
                None if error_feedback is None else error_feedback[k])
        return merged, new_anchor, ef

    return local_step, merge_step


def _whole(fn, *tensors):
    """``fn`` on the full tensors of its DTensor arguments, each output
    placed back like the argument in its position."""
    full = [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tensors]
    outs = fn(*full)
    return tuple(distribute_tensor(o, t.device_mesh, t.placements)
                 if isinstance(t, DTensor) else o
                 for o, t in zip(outs, tensors))


def _pod_local(sync, inner: DeviceMesh, params_r, opt_state_r, batch_r):
    """One replica a pod: each rank's ``[1, ...]`` shard of the
    pod-sharded trees as a DTensor on its pod's sub-mesh, stepped there,
    and stacked back on the pod axis."""
    def down(t):
        if not isinstance(t, DTensor):
            return t
        pl = t.placements
        return DTensor.from_local(t.to_local()[0], inner, [
            Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl[1:]],
            run_check=False)

    def up(t, like):
        if not isinstance(like, DTensor):
            return t[None]
        local = t.to_local() if isinstance(t, DTensor) else t
        return DTensor.from_local(local[None], like.device_mesh,
                                  like.placements, run_check=False)

    p, o, loss = sync(tree_map(down, params_r), tree_map(down, opt_state_r),
                      tree_map(down, batch_r))
    mesh = next(iter(params_r.values())).device_mesh
    losses = DTensor.from_local(   # [R] over "pod": one loss a replica
        loss[None], mesh, [Shard(0) if n == "pod" else Replicate()
                           for n in mesh.mesh_dim_names], run_check=False)
    return tree_map(up, p, params_r), tree_map(up, o, opt_state_r), losses


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ArchConfig, mesh: DeviceMesh | None = None):
    """``serve_step(params, cache, inputs, idx) -> (logits, cache)``, with
    no gradient; on a mesh the logits come back a plain replicated
    tensor."""
    shard = make_shard_fn(mesh, cfg)

    @torch.no_grad()
    def serve_step(params, cache, inputs, idx):
        with _on_mesh(mesh):
            logits, cache = decode.decode_step(params, cfg, cache, inputs,
                                               idx, shard=shard)
        return _full(logits), cache

    return serve_step


def make_prefill_step(cfg: ArchConfig, mesh: DeviceMesh | None = None):
    """``prefill_step(params, inputs) -> (logits, cache)``, with no
    gradient; on a mesh the logits come back a plain replicated tensor."""
    shard = make_shard_fn(mesh, cfg)

    @torch.no_grad()
    def prefill_step(params, inputs):
        with _on_mesh(mesh):
            h, cache = transformer.forward(params, cfg, inputs, shard=shard,
                                           mode="prefill")
            logits = (h[:, -1] @ params.unembedding().T).float()
        return _full(logits), cache

    return prefill_step


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t
