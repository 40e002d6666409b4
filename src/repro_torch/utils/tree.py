"""Tree helpers for the port's training slice (the reference's
``utils/tree.py``, which maps with ``jax.tree``).

The port's parameter tree is a flat ``dict[str, Tensor]`` keyed by the
``named_parameters()`` names of a :class:`~repro_torch.nn.transformer.LM`
(``"embed"``, ``"final_norm"``, ``"layers.0.attn.wq"``, ...).  Optimizer
and trainer states nest such dicts in dicts, lists and tuples:
:func:`tree_map` and :func:`tree_leaves` walk those three containers and
take anything else as a leaf.  Sharding specs ride beside a tree, not on
it: a dict of the same keys holding ``nn.param.P`` (a tuple, so these
helpers would walk into it; ``trainer.resolve_tree`` maps spec trees).
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf, following ``tree``'s structure; each of
    ``rest`` must hold ``tree``'s containers, and whatever sits where
    ``tree`` has a leaf is passed to ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``tree``'s order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_mean(trees):
    """Mean of a list of trees with identical structure."""
    acc = trees[0]
    for t in trees[1:]:
        acc = tree_add(acc, t)
    return tree_scale(acc, 1.0 / len(trees))


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_count(a) -> int:
    """Total number of scalar parameters in the tree."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_l2norm(a) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(a)))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, a)
