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
from repro_torch.nn import param as pm
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
                             device=None) -> transformer.LM:
    """The reference's parameter tree (nested dicts of arrays: ``embed``,
    ``final_norm``, and ``layers`` stacked ``[L, ...]``) as the port's
    :class:`~repro_torch.nn.transformer.LM` on ``device``, in
    ``cfg.param_dtype``.  Every path and shape is checked; the layer axis
    is unstacked into one block per layer."""
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
    t = {k: _tensor(a, np.float32, device).to(cfg.param_dtype)
         for k, a in flat.items()}

    def layer(i: int, group: str) -> dict:
        pre = f"layers/{group}/"
        return {k[len(pre):]: v[i] for k, v in t.items() if k.startswith(pre)}

    blocks = [transformer.AttnBlock(
        pm.frozen_dict(**layer(i, "attn")), pm.frozen_dict(**layer(i, "ffn")),
        pm.frozen(t["layers/norm1"][i]), pm.frozen(t["layers/norm2"][i]))
        for i in range(cfg.n_layers)]
    return transformer.LM(pm.frozen(t["embed"]), pm.frozen(t["final_norm"]),
                          blocks)
