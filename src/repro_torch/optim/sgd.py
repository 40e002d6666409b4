"""SGD (the paper's optimizer) — plain and momentum variants.

Optimizer protocol (the reference's, optax-like but dependency-free):

    opt = sgd(lr)
    state = opt.init(params)               # a tree (possibly only a step)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Trees are the port's flat parameter dicts (:mod:`repro_torch.utils.tree`);
the state's ``step`` is a 0-d int32 tensor on the parameters' device.
Updates follow JAX's type promotion: a Python float (a rate, the momentum)
is weakly typed, so it is first rounded to the array's dtype and the
result keeps that dtype; a schedule's fp32 tensor rate promotes a bf16
gradient to fp32 (torch would keep a 0-d tensor out of the promotion and
multiply by the unrounded float).  A state's specs on a mesh:
``trainer.opt_state_specs``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]
    name: str = "opt"


def apply_updates(params, updates):
    """``p + u`` cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _to_schedule(lr):
    if callable(lr):
        return lr
    return lambda step: lr


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def weak(c: float, dtype: torch.dtype) -> float:
    """A Python float as JAX applies it to an array of ``dtype``: rounded
    to that dtype first."""
    return torch.tensor(c, dtype=dtype).item()


def descent(lr_t, x: torch.Tensor) -> torch.Tensor:
    """``-lr_t * x`` with JAX's promotion: a tensor rate (a schedule's fp32
    0-d array there) takes part in the result's dtype, a Python float
    is weak."""
    if isinstance(lr_t, torch.Tensor):
        return -lr_t * x.to(torch.promote_types(lr_t.dtype, x.dtype))
    return weak(-lr_t, x.dtype) * x


def sgd(lr) -> Optimizer:
    """Plain SGD: u = -lr * g.  State = step counter only."""
    sched = _to_schedule(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = sched(step)
        updates = tree_map(lambda g: descent(lr_t, g), grads)
        return updates, {"step": step + 1}

    return Optimizer(init, update, "sgd")


def sgd_momentum(lr, momentum: float = 0.9, *, state_dtype=None) -> Optimizer:
    """SGD with (optionally low-precision) momentum buffers."""
    sched = _to_schedule(lr)

    def init(params):
        m = tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype),
                     params)
        return {"step": _step0(params), "m": m}

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = sched(step)
        m = tree_map(lambda mi, g: (weak(momentum, mi.dtype) * mi + g)
                     .to(mi.dtype), state["m"], grads)
        updates = tree_map(lambda mi: descent(lr_t, mi), m)
        return updates, {"step": step + 1, "m": m}

    return Optimizer(init, update, "sgd_momentum")
