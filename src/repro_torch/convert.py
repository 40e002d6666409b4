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


#: leaves the reference keeps in fp32 whatever ``param_dtype`` is: the MoE
#: router, Mamba2's dt_bias, a_log and d_skip, mLSTM's gates, sLSTM's bias
FP32_LEAVES = ("router", "dt_bias", "a_log", "d_skip", "w_gates",
               "gate_bias", "bias")


def _block_shapes(cfg: transformer.ArchConfig, *, with_moe: bool = False
                  ) -> dict[str, tuple]:
    """One attention block's leaves (path below the block -> shape)."""
    d, f = cfg.d_model, cfg.d_ff
    qd, kd = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    shapes = {"attn/wq": (d, qd), "attn/wk": (d, kd), "attn/wv": (d, kd),
              "attn/wo": (qd, d), "norm1": (d,), "norm2": (d,)}
    if with_moe:
        e = cfg.moe_experts
        shapes.update({"moe/router": (d, e), "moe/w_up": (e, d, f),
                       "moe/w_gate": (e, d, f), "moe/w_down": (e, f, d)})
    else:
        shapes.update({"ffn/w_up": (d, f), "ffn/w_down": (f, d)})
        if cfg.ffn_gated:
            shapes["ffn/w_gate"] = (d, f)
    return shapes


def _stacks(cfg: transformer.ArchConfig) -> dict[str, tuple[tuple, dict]]:
    """Each stack of the reference's tree: name -> (its stacked leading
    axes, its layer's leaves)."""
    d, fam = cfg.d_model, cfg.family
    if fam in ("dense", "audio", "moe"):
        return {"layers": ((cfg.n_layers,),
                           _block_shapes(cfg, with_moe=fam == "moe"))}
    if fam == "vlm":
        n_super, ce = transformer.vlm_shape(cfg)
        return {"self_layers": ((n_super, ce - 1), _block_shapes(cfg)),
                "cross_layers": ((n_super,), _block_shapes(cfg))}
    if fam == "hybrid":
        m = transformer._mamba_meta(cfg)
        di, ds, nh = m["d_inner"], m["d_state"], m["n_heads"]
        layer = {"mamba/w_in": (d, 2 * di + 2 * ds + nh),
                 "mamba/conv": (m["conv_width"], di + 2 * ds),
                 "mamba/dt_bias": (nh,), "mamba/a_log": (nh,),
                 "mamba/d_skip": (nh,), "mamba/w_out": (di, d), "norm": (d,)}
        n_sb, per, rest = transformer.hybrid_shape(cfg)
        out = {"mamba_blocks": ((n_sb, per), layer)}
        if rest:
            out["mamba_tail"] = ((rest,), layer)
        out["shared_attn"] = ((), _block_shapes(cfg))
        return out
    if fam == "ssm":
        m = transformer._mlstm_meta(cfg)
        di, nh = m["d_inner"], m["n_heads"]
        hd = transformer._slstm_meta(cfg)["head_dim"]
        n_sb, per = transformer.ssm_shape(cfg)
        return {"mlstm_blocks": ((n_sb, per - 1), {
                    "mix/w_up": (d, 2 * di), "mix/w_qkv": (di, 3 * di),
                    "mix/w_gates": (di, 2 * nh), "mix/gate_bias": (2 * nh,),
                    "mix/w_down": (di, d), "norm": (d,)}),
                "slstm_blocks": ((n_sb,), {
                    "mix/w_x": (d, 4 * d), "mix/r_h": (nh, hd, 4 * hd),
                    "mix/bias": (4 * d,), "mix/w_out": (d, d), "norm": (d,)})}
    raise ValueError(f"unknown family {fam!r}")


def lm_shapes(cfg: transformer.ArchConfig) -> dict[str, tuple]:
    """The reference's parameter tree, as path -> shape, with each stack's
    layer axes first (its ``scan`` layout: ``[L, ...]``, ``[n_super,
    ce-1, ...]``, ``[n_sb, per, ...]``; hybrid's shared block unstacked)."""
    io = ({"head": (cfg.d_model, cfg.vocab)} if cfg.emb_in()
          else {"embed": (cfg.vocab, cfg.d_model)})
    shapes = {**io, "final_norm": (cfg.d_model,)}
    for stack, (lead, leaves) in _stacks(cfg).items():
        shapes.update({f"{stack}/{k}": (*lead, *s) for k, s in leaves.items()})
    return shapes


def _port_names(cfg: transformer.ArchConfig, path: str
                ) -> tuple[tuple, list[str]]:
    """A reference path's stacked axes and the port's parameter name for
    each of its layers, in C order (``mamba_blocks/norm`` ->
    ``mamba_blocks.0.0.norm``, ...)."""
    stack, _, rest = path.partition("/")
    if not rest:
        return (), [path]
    lead = _stacks(cfg)[stack][0]
    leaf = rest.replace("/", ".")
    return lead, [".".join((stack, *map(str, i), leaf))
                  for i in np.ndindex(*lead)]


def lm_params_from_reference(params: dict, cfg: transformer.ArchConfig,
                             device=None, *,
                             trainable: bool = False) -> transformer.LM:
    """The reference's parameter tree (nested dicts of arrays, stacks
    stacked on their layer axes: :func:`lm_shapes`) as the port's
    :class:`~repro_torch.nn.transformer.LM` on ``device``, in
    ``cfg.param_dtype`` (``FP32_LEAVES`` in fp32), requiring grad when
    ``trainable``.  Every path and shape is checked; the layer axes are
    unstacked into one block per layer."""
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
        dtype = (torch.float32 if k.rsplit("/", 1)[-1] in FP32_LEAVES
                 else cfg.param_dtype)
        t = _tensor(a, np.float32, device).to(dtype)
        lead, names = _port_names(cfg, k)
        t = t.reshape(-1, *t.shape[len(lead):]) if lead else t[None]
        tree.update(zip(names, t))
    return transformer.LM.from_tree(tree).requires_grad_(trainable)


def lm_params_to_reference(params, cfg: transformer.ArchConfig) -> dict:
    """The inverse: an :class:`~repro_torch.nn.transformer.LM` or its
    parameter tree as the reference's tree of numpy arrays, stacks stacked
    on their layer axes.  bf16 comes back as float32 (numpy has no
    bfloat16; every value is exact)."""
    tree = (params if isinstance(params, dict)
            else dict(params.named_parameters()))

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: dict = {}
    for path, shape in lm_shapes(cfg).items():
        _, names = _port_names(cfg, path)
        arr = np.stack([host(tree[n]) for n in names]).reshape(shape)
        *groups, leaf = path.split("/")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = arr
    return out
