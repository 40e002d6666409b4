"""int8 block quantization for compressed merges: the live learner's and
the async-local trainer's.

The port's copy of the reference's functions: per-block symmetric int8
quantization with a per-block fp32 scale (the Buckwild low-precision idea
applied at the merge boundary), and the tree functions that carry the
quantization error forward (error feedback), so the merged model stays
unbiased over time.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so a value exactly halfway between two int8 steps lands where the
reference puts it.  Trees are the port's (:mod:`repro_torch.utils.tree`);
quantized trees are ``{"q": int8 tree, "s": fp32 scale tree}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_leaves, tree_map

BLOCK = 256


def _pad_amount(n: int) -> int:
    return (-n) % BLOCK


def quantize_leaf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q [Nb, B] int8,
    s [Nb, 1] fp32)."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, _pad_amount(flat.numel()))).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)[:like.numel()]
    return flat.reshape(like.shape).to(like.dtype)


def compress_tree(tree, error_feedback=None):
    """Quantize every leaf with error feedback, one pass per leaf.

    Returns ``({"q": ..., "s": ...}, new_error_feedback)``; error feedback
    is an fp32 tree of the same structure (zeros on the first call)."""
    if error_feedback is None:
        error_feedback = tree_map(
            lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device), tree)

    def one(x, e):
        xe = x.float() + e
        q, s = quantize_leaf(xe)
        return q, s, xe - dequantize_leaf(q, s, xe)

    # one pass per leaf gives a (q, s, residual) triple at each of tree's
    # leaves; picking by tree's structure splits them into three trees
    triples = tree_map(one, tree, error_feedback)
    qs, ss, ef = (tree_map(lambda _, t, i=i: t[i], tree, triples)
                  for i in range(3))
    return {"q": qs, "s": ss}, ef


def decompress_tree(compressed, like_tree):
    return tree_map(lambda like, q, s: dequantize_leaf(q, s, like),
                    like_tree, compressed["q"], compressed["s"])


def compression_ratio(tree) -> float:
    """Bytes(original) / bytes(int8+scales) of a tree (a sequence of
    tensors, or one tensor, is a tree too)."""
    leaves = tree_leaves(tree)
    orig = sum(x.numel() * x.element_size() for x in leaves)
    comp = sum(x.numel() + 4 * (x.numel() // BLOCK + 1) for x in leaves)
    return orig / comp
