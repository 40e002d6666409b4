"""Step-size autotuner — the paper's §6.1 grid search as a reusable API.

The port's copy of the reference's ``study/tuner.py``, on the port's
``Runner``.

The paper tunes the step size per (dataset, task, configuration) cell by
"griding its range in powers of 10" and keeping the fastest
time-to-convergence.  ``tune_step`` lifts that loop out of the call
sites: it expands a base ``TrialSpec`` over a step grid, executes it
through a ``Runner`` (so the grid runs stacked, epoch by epoch, and
every run lands in the trial cache), and applies the
``convergence.rank_key`` selection rule.

``by="epochs"`` ranks on statistical efficiency only — no wall-clock in
the decision — which is what makes the advisor deterministic under a
fixed seed.  Benchmarks rank ``by="time"`` like the paper.

``tune_many`` tunes several base specs through **one** ``runner.run``
call — semantically identical to mapping ``tune_step``, but the union
of the step grids is dispatched together (the reference spreads that
dispatch over sweep workers; the port runs it in-process).  The advisor
tunes its whole candidate space this way.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import convergence
from repro_torch.obs import trace
from repro_torch.study.runner import Runner, TrialResult
from repro_torch.study.spec import TrialSpec


@dataclasses.dataclass
class TuneResult:
    best: TrialSpec
    best_result: TrialResult
    target: float                       # the loss target used for ranking
    results: dict[float, TrialResult]   # step -> result (the whole grid)

    @property
    def best_step(self) -> float:
        return self.best.step


def tune_step(
    runner: Runner,
    base: TrialSpec,
    *,
    steps: Sequence[float] | None = None,
    target: float | None = None,
    tolerance: float = 0.01,
    by: str = "time",
) -> TuneResult:
    """Grid-search the step size of ``base`` (its own ``step`` is ignored).

    When ``target`` is None it is derived the paper's way: the lowest
    loss any grid member reached, within ``tolerance`` (default 1%).
    """
    return tune_many(runner, [base], steps=steps, target=target,
                     tolerance=tolerance, by=by)[0]


def tune_many(
    runner: Runner,
    bases: Sequence[TrialSpec],
    *,
    steps: Sequence[float] | None = None,
    target: float | None = None,
    tolerance: float = 0.01,
    by: str = "time",
) -> list[TuneResult]:
    """Tune every base spec's step size in one ``runner.run`` dispatch.

    Equivalent to ``[tune_step(runner, b, ...) for b in bases]`` — each
    base derives its target from its own grid when ``target`` is None —
    but all (base × step) trials execute in a single runner call.
    """
    steps = list(steps) if steps is not None else convergence.grid_step_sizes()
    trials = [b.with_step(s) for b in bases for s in steps]
    with trace.span("study.tune", bases=len(bases), steps=len(steps),
                    by=by):
        results = runner.run(trials)
    out: list[TuneResult] = []
    for i, base in enumerate(bases):
        grid = results[i * len(steps):(i + 1) * len(steps)]
        by_step = dict(zip(steps, grid))
        tgt = target
        if tgt is None:
            opt = convergence.optimal_loss(grid)
            tgt = convergence.thresholds(opt, (tolerance,))[tolerance]
        # rank ties break on the canonical step order (smallest step wins),
        # never on grid/cache arrival order — multi-worker and single-host
        # sweeps must pick identical steps from identical results
        best_step = min(
            steps,
            key=lambda s, t=tgt: (*convergence.rank_key(by_step[s], t, by=by),
                                  s))
        out.append(TuneResult(best=base.with_step(best_step),
                              best_result=by_step[best_step],
                              target=tgt, results=by_step))
    return out
