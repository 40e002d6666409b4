"""Study harness: the paper's experimental methodology as a subsystem.

The port's copy of the reference's ``study`` package.  The paper's core
contribution is a *methodology* — sweep update strategy × replication ×
access path per dataset, measure hardware efficiency, statistical
efficiency, and time-to-convergence, and pick the optimal configuration
per dataset/hardware (§6, Tables 4-7).  The modules here make that loop a
cacheable API, on the port's engine and kernels:

    spec.TrialSpec grid ──▶ tuner.tune_step ──▶ runner.Runner ──▶ store
                                                     │
    advisor.recommend ◀── ranked Table-6 answer ◀────┘
                                         claims.validate ──▶ verdicts

Modules
-------
spec     frozen, content-hashed trial descriptions (keys equal the
         reference's for the same spec)
runner   cache-first execution with step stacking (S chains of the
         family's kernel an epoch), on the runner's device
tuner    the §6.1 step-size grid search (rank ties break on canonical
         step order)
store    deterministic ``BENCH_study.json`` + append-only run JSONL, under
         ``bench_results/torch/`` by default
advisor  the paper's Table 6 as a queryable API (``recommend``), with
         a calibratable epoch-cost model (``calibrate``)
claims   paper-claim predicates validated against sweep rows

Quickstart
----------
Run one trial on the CPU and ask the advisor the Table-6 question::

    from repro_torch.core import sgd
    from repro_torch.study import advisor, spec
    from repro_torch.study.runner import Runner

    runner = Runner(device="cpu")            # "cuda" (the default) on a card
    trial = spec.TrialSpec(
        dataset=spec.DatasetSpec("w8a", source="real"),  # bundled fixture
        task="lr", strategy=sgd.SyncSGD(), step=1e-2, epochs=8)
    result = runner.run_trial(trial)
    print(result.final_loss, result.time_per_epoch)

    rec = advisor.recommend(spec.DatasetSpec("covtype", max_n=512),
                            task="svm", runner=runner)
    print(rec.best.name, rec.best.score)

``python -m repro_torch.benchmarks.run`` drives the table/figure sweeps
on top of this package.
"""
from repro_torch.study import advisor, claims, runner, spec, store, tuner  # noqa: F401
