"""Convergence methodology from the paper's experimental setup (Section 6.1).

* optimal loss = lowest loss seen by any configuration within a budget;
* convergence thresholds at 10%, 5%, 2%, 1% above the optimum;
* step size chosen by gridding powers of 10 and picking the fastest
  time-to-convergence (paper: "griding its range in powers of 10").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import sgd as sgd_mod

DEFAULT_TOLERANCES = (0.10, 0.05, 0.02, 0.01)


def thresholds(optimal_loss: float, tolerances: Sequence[float] = DEFAULT_TOLERANCES):
    """Loss values 'within t of the optimum' for each tolerance t."""
    return {t: optimal_loss * (1.0 + t) if optimal_loss >= 0 else optimal_loss * (1.0 - t)
            for t in tolerances}


def grid_step_sizes(lo_exp: int = -6, hi_exp: int = 2) -> list[float]:
    """{1e-6, 1e-5, ..., 1e2} — the paper's step-size grid."""
    return [10.0 ** e for e in range(lo_exp, hi_exp + 1)]


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


@dataclasses.dataclass
class GridSearchResult:
    best_step: float
    best_result: "sgd_mod.RunResult"
    all_results: dict  # step -> RunResult


def grid_search_step(
    make_problem,
    strategy,
    epochs: int,
    target: float,
    *,
    steps: Iterable[float] | None = None,
    sparse_data: bool = False,
) -> GridSearchResult:
    """Paper Section 6.1 step-size selection: fastest time to ``target`` wins.

    ``make_problem(step) -> problem`` lets the caller embed the step size
    (and put the problem's tensors on the device the runs use).  Falls
    back to lowest final loss when no step reaches the target.  Sweeps
    expressed as ``study.spec.TrialSpec``s use ``study.tuner.tune_step``:
    the same selection rule, with trial caching and step stacking.
    """
    steps = list(steps) if steps is not None else grid_step_sizes()
    results: dict[float, sgd_mod.RunResult] = {}
    best_step, best_key = None, None
    for s in steps:
        res = sgd_mod.run(make_problem(s), strategy, epochs, sparse_data=sparse_data)
        results[s] = res
        if not np.isfinite(res.losses[-1]):
            continue  # diverged
        key = rank_key(res, target)
        if best_key is None or key < best_key:
            best_key, best_step = key, s
    if best_step is None:  # everything diverged: pick smallest step
        best_step = min(steps)
    return GridSearchResult(best_step, results[best_step], results)


def optimal_loss(results: Iterable) -> float:
    """Paper methodology: run all configurations, lowest loss observed wins."""
    best = math.inf
    for r in results:
        finite = r.losses[np.isfinite(r.losses)]
        if len(finite):
            best = min(best, float(finite.min()))
    return best
