"""Carry state, problems and LM parameters across from the reference package.

Everything arrives as numpy arrays (a caller holding the reference's
arrays passes them through ``np.asarray``) and leaves as tensors on
``device`` (``cuda`` unless the caller says).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import glm, sparse
from repro_torch.kernels import common
from repro_torch.nn import transformer


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(common.device(device))


def state_from_reference(w, device=None) -> torch.Tensor:
    """A model ``w [d]`` (SyncSGD) or replica stack ``W [R, d]``
    (AsyncLocalSGD) as an fp32 tensor on ``device``."""
    w = np.asarray(w)
    if w.ndim not in (1, 2):
        raise ValueError(f"state is w [d] or W [R, d], got shape {w.shape}")
    return _tensor(w, np.float32, device)


def problem_from_reference(task: str, X, y, step: float,
                           device=None) -> glm.GLMProblem:
    """A dense ``GLMProblem`` with X [N, d] and y [N] on ``device``."""
    return glm.GLMProblem(task, _tensor(X, np.float32, device),
                          _tensor(y, np.float32, device), float(step))


def ell_from_reference(values, indices, d: int,
                       device=None) -> sparse.ELLMatrix:
    """An ``ELLMatrix`` (values fp32, indices int32) on ``device``."""
    return sparse.ELLMatrix(_tensor(values, np.float32, device),
                            _tensor(indices, np.int32, device), int(d))


def _flatten(tree, prefix="") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def lm_shapes(cfg: transformer.ArchConfig) -> dict[str, tuple]:
    """The reference's dense parameter tree, as path -> shape, with the
    layer axis stacked first (its ``scan`` layout)."""
    transformer.require_ported(cfg)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    qd, kd = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    shapes = {
        "embed": (cfg.vocab, d), "final_norm": (d,),
        "layers/attn/wq": (L, d, qd), "layers/attn/wk": (L, d, kd),
        "layers/attn/wv": (L, d, kd), "layers/attn/wo": (L, qd, d),
        "layers/norm1": (L, d), "layers/norm2": (L, d),
        "layers/ffn/w_up": (L, d, f), "layers/ffn/w_down": (L, f, d)}
    if cfg.ffn_gated:
        shapes["layers/ffn/w_gate"] = (L, d, f)
    return shapes


def lm_params_from_reference(params: dict, cfg: transformer.ArchConfig,
                             device=None, *,
                             trainable: bool = False) -> transformer.LM:
    """The reference's parameter tree (nested dicts of arrays: ``embed``,
    ``final_norm``, and ``layers`` stacked ``[L, ...]``) as the port's
    :class:`~repro_torch.nn.transformer.LM` on ``device``, in
    ``cfg.param_dtype``, requiring grad when ``trainable``.  Every path and
    shape is checked; the layer axis is unstacked into one block per
    layer."""
    flat = _flatten(params)
    want = lm_shapes(cfg)
    if set(flat) != set(want):
        raise ValueError(f"parameter tree for {cfg.name}: missing "
                         f"{sorted(set(want) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(want))}")
    bad = {k: (flat[k].shape, s) for k, s in want.items()
           if flat[k].shape != s}
    if bad:
        raise ValueError(f"parameter shapes for {cfg.name} (got, want): {bad}")
    tree = {}
    for k, a in flat.items():
        t = _tensor(a, np.float32, device).to(cfg.param_dtype)
        if k.startswith("layers/"):
            name = k[len("layers/"):].replace("/", ".")
            tree.update({f"layers.{i}.{name}": t[i]
                         for i in range(cfg.n_layers)})
        else:
            tree[k] = t
    return transformer.LM.from_tree(tree).requires_grad_(trainable)


def lm_params_to_reference(params, cfg: transformer.ArchConfig) -> dict:
    """The inverse: an :class:`~repro_torch.nn.transformer.LM` or its
    parameter tree as the reference's tree of numpy arrays, layers stacked
    ``[L, ...]``.  bf16 comes back as float32 (numpy has no bfloat16; every
    value is exact)."""
    tree = (params if isinstance(params, dict)
            else dict(params.named_parameters()))

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict = {}
    for path in lm_shapes(cfg):
        if path.startswith("layers/"):
            name = path[len("layers/"):].replace("/", ".")
            arr = np.stack([host(tree[f"layers.{i}.{name}"])
                            for i in range(cfg.n_layers)])
        else:
            arr = host(tree[path])
        *groups, leaf = path.split("/")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = arr
    return out
