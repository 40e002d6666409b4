"""Adam (for the LM example applications; the paper study itself uses SGD).

fp32 moments by default; the bias corrections are fp32 0-d tensors."""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import Optimizer, _step0, _to_schedule, descent
from repro_torch.utils.tree import tree_map


def adam(lr, b1=0.9, b2=0.95, eps=1e-8, *,
         state_dtype=torch.float32) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=state_dtype)
        return {"step": _step0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = sched(step)
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.to(mi.dtype),
                     state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * torch.square(
            g.to(vi.dtype)), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        updates = tree_map(
            lambda mi, vi: descent(lr_t, mi / bc1)
            / (torch.sqrt(vi / bc2) + eps), m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, "adam")
