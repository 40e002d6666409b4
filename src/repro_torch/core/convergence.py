"""Convergence methodology from the paper's experimental setup (Section 6.1).

* optimal loss = lowest loss seen by any configuration within a budget;
* convergence thresholds at 10%, 5%, 2%, 1% above the optimum.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

DEFAULT_TOLERANCES = (0.10, 0.05, 0.02, 0.01)


def thresholds(optimal_loss: float, tolerances: Sequence[float] = DEFAULT_TOLERANCES):
    """Loss values 'within t of the optimum' for each tolerance t."""
    return {t: optimal_loss * (1.0 + t) if optimal_loss >= 0 else optimal_loss * (1.0 - t)
            for t in tolerances}


def rank_key(result, target: float, *, by: str = "time") -> tuple:
    """Paper Section 6.1 selection order as a sort key (lower is better).

    Converged runs rank first — by time-to-target (``by="time"``) or by
    epochs-to-target (``by="epochs"``); non-converged runs rank by final
    loss; diverged (non-finite) runs rank last.
    """
    last = float(result.losses[-1])
    if not np.isfinite(last):
        return (2, math.inf)
    hit = result.time_to(target) if by == "time" else result.epochs_to(target)
    if hit is None:
        return (1, last)
    return (0, float(hit))


def optimal_loss(results: Iterable) -> float:
    """Paper methodology: run all configurations, lowest loss observed wins."""
    best = math.inf
    for r in results:
        finite = r.losses[np.isfinite(r.losses)]
        if len(finite):
            best = min(best, float(finite.min()))
    return best
