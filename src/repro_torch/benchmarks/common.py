"""Shared benchmark utilities — thin glue over the port's study subsystem.

The port's twins of the reference's paper drivers (``benchmarks/*.py`` at
the repository root), run on the port's engine and kernels.  The
execution paths keep the reference's names:

    seq        sequential incremental SGD (paper: cpu-seq), here the
               ``glm_sgd`` kernel at micro-batch 1 on one replica
    sync       synchronous batch SGD, fused gradient expression
    sync-comp  synchronous batch SGD via the primitive-composition path,
               one launch per primitive (paper: ViennaCL/TF/BIDMach)
    async-rN   async-local SGD with N model replicas (paper: Hogwild)

``PROFILES`` and ``TASKS`` equal the reference's.  ``--real``
(``repro_torch.benchmarks.run``) flips ``SOURCE`` to "real": sweeps then
load the bundled fixtures through ``repro_torch.data.ingest``.

Every (dataset, task, strategy, step) cell is a ``TrialSpec`` run by the
module-level ``RUNNER`` on its device (``cuda`` unless the driver says):
step grids run stacked, results land in the trial cache under
``bench_results/torch/study_cache``.  With ``--workers N``
(``repro_torch.benchmarks.run``) the driver also attaches a
``repro_torch.sweep`` executor to ``RUNNER``: a runner call whose cache
misses span several stack groups then runs them in N worker subprocesses
on the runner's device, whose private caches merge back into
``study_cache`` (scratch under ``bench_results/torch/sweep_workers``).  The trial keys equal the
reference's, so the port never shares the reference's
``bench_results/study_cache``: that would serve CPU timings as the
card's.
"""
from __future__ import annotations

import csv

from repro_torch.study import runner as runner_mod
from repro_torch.study import spec as spec_mod
from repro_torch.study import store as store_mod
from repro_torch.study import tuner as tuner_mod

RESULTS_DIR = store_mod.RESULTS_DIR

# profile -> (dataset max_n, epochs, synthetic + real dataset name tuples)
PROFILES = {
    "ci": dict(max_n=2048, epochs=12,
               datasets=("covtype", "w8a", "real-sim"),
               real_datasets=("covtype", "w8a", "real-sim")),
    "paper": dict(max_n=16384, epochs=30,
                  datasets=("covtype", "w8a", "real-sim", "rcv1", "news"),
                  real_datasets=("covtype", "w8a", "real-sim", "news",
                                 "skin")),
}

TASKS = ("lr", "svm")

#: dataset source for every sweep: "synthetic" | "real" (set by --real)
SOURCE = "synthetic"

#: shared trial runner: one dataset memo + trial cache for the whole sweep;
#: the driver (repro_torch.benchmarks.run) replaces it to pick the device
#: and attaches a StudyStore to record every trial
RUNNER = runner_mod.Runner(cache_dir=RESULTS_DIR / "study_cache")


def set_source(source: str) -> None:
    """Switch every benchmark module between synthetic and real data."""
    global SOURCE
    if source not in ("synthetic", "real"):
        raise ValueError(f"source must be synthetic|real: {source!r}")
    SOURCE = source


def profile_datasets(profile: str) -> tuple[str, ...]:
    """The dataset names a sweep iterates, source-aware."""
    p = PROFILES[profile]
    return p["real_datasets"] if SOURCE == "real" else p["datasets"]


def dataset_spec(name: str, profile: str) -> spec_mod.DatasetSpec:
    return spec_mod.DatasetSpec(name, max_n=PROFILES[profile]["max_n"],
                                source=SOURCE)


def load(name: str, profile: str):
    """The materialized dataset (memoized in the shared runner)."""
    return RUNNER.dataset(dataset_spec(name, profile))


def tune(dspec: spec_mod.DatasetSpec, task: str, strategy, epochs: int,
         steps=(1e-3, 1e-2, 1e-1)):
    """Mini grid search (paper Section 6.1) through the study tuner.

    Returns ``(best_step, best_result, target)``.
    """
    base = spec_mod.TrialSpec(dataset=dspec, task=task, strategy=strategy,
                              step=steps[0], epochs=epochs)
    t = tuner_mod.tune_step(RUNNER, base, steps=steps)
    return t.best_step, t.best_result, t.target


def write_csv(rows: list[dict], name: str):
    if not rows:
        return
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / name
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path} ({len(rows)} rows)")


def fmt(x):
    if x is None:
        return "inf"
    if isinstance(x, float):
        return f"{x:.4g}"
    return str(x)
