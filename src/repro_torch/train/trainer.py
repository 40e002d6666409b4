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
the attention kernel is a ctypes call, which vmap cannot batch.  There is
no mesh: the reference's ``resolve_spec``, ``resolve_tree``,
``make_shard_fn`` and ``opt_state_specs`` wait for the port's mesh (ROADMAP
Queue 1 item 7(d)).
"""
from __future__ import annotations

import torch

from repro_torch.nn import decode, transformer
from repro_torch.nn.transformer import ArchConfig
from repro_torch.optim import compress
from repro_torch.optim.sgd import Optimizer, apply_updates
from repro_torch.utils.tree import tree_map


def value_and_grad(cfg: ArchConfig, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)`` of ``transformer.loss_fn`` at ``params``: the loss
    detached, the gradients a tree like ``params`` in its dtypes."""
    lm = transformer.LM.from_tree(params)
    loss = transformer.loss_fn(lm, cfg, batch)
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
                   micro_batches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``; with micro-batches the loss is the last micro-batch's."""

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            loss, grads = value_and_grad(cfg, params, batch)
        else:
            split = {k: v.reshape(micro_batches, v.shape[0] // micro_batches,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            for i in range(micro_batches):
                loss, g = value_and_grad(cfg, params, replica(split, i))
                for k, gk in g.items():
                    grads[k] += gk
            grads = {k: g / micro_batches for k, g in grads.items()}
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            del grads
            params = apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# Asynchronous-local step
# ---------------------------------------------------------------------------


def make_async_local_step(cfg: ArchConfig, optimizer: Optimizer, *,
                          compress_merge: bool = False):
    """``(local_step, merge_step)`` over replica-stacked trees.

    ``local_step(params_r, opt_state_r, batch_r) -> (params_r,
    opt_state_r, losses [R])`` runs one optimizer step on each replica with
    its slice ``batch_r[r]``; nothing passes between replicas.
    ``merge_step(params_r, anchor=None, error_feedback=None) -> (merged,
    anchor, error_feedback)``: the fp32 mean of the replicas broadcast to
    each (a view, as the reference's ``broadcast_to``), or with
    ``compress_merge`` the anchor moved by the mean of the replicas' int8
    drifts, carrying each replica's quantization error forward; it runs a
    leaf at a time, so the fp32 drifts of one leaf are its peak."""
    sync = make_sync_step(cfg, optimizer)

    def local_step(params_r, opt_state_r, batch_r):
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
        return x.float().mean(0, keepdim=True).to(x.dtype).expand(x.shape)

    def compressed_leaf(x, a, e):
        delta = x.float() - a[None].float()
        qt, e = compress.compress_tree(delta, e)
        mean = compress.decompress_tree(qt, delta).mean(0)
        a = (a.float() + mean).to(a.dtype)
        return a[None].expand(x.shape).to(x.dtype), a, e

    @torch.no_grad()
    def merge_step(params_r, anchor=None, error_feedback=None):
        if not compress_merge:
            return ({k: mean_leaf(x) for k, x in params_r.items()}, anchor,
                    error_feedback)
        merged, new_anchor, ef = {}, {}, {}
        for k, x in params_r.items():
            merged[k], new_anchor[k], ef[k] = compressed_leaf(
                x, anchor[k],
                None if error_feedback is None else error_feedback[k])
        return merged, new_anchor, ef

    return local_step, merge_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ArchConfig):
    def serve_step(params, cache, inputs, idx):
        return decode.decode_step(params, cfg, cache, inputs, idx)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, inputs):
        h, cache = transformer.forward(params, cfg, inputs, mode="prefill")
        logits = (h[:, -1] @ params.unembedding().T).float()
        return logits, cache

    return prefill_step
