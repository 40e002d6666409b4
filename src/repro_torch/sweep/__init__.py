"""Distributed sweep scheduler: multi-worker ``TrialSpec`` dispatch.

The port's twin of the reference package's ``sweep``.  The study runner
executes every trial serially in one process; this package spreads a
sweep across N worker processes while keeping the single-process
reproducibility contract: a distributed sweep fills the *same* canonical
trial cache a serial sweep would, so ``study.store.StudyStore`` — a pure
function of trial results — writes the same ``BENCH_study.json`` either
way.  Each worker runs its trials on the runner's device (``cuda``
unless the runner says ``cpu``); on one card the workers share it.

Dataflow:

    TrialSpec grid ──▶ plan.plan ──▶ N × [worker subprocess] ──▶ merge
      (cache misses)   (stack-aware    (python -m repro_torch.sweep.worker,
       from Runner)     sharding)       private cache root each)     │
                                                                      ▼
                                                       canonical trial cache
    Runner.run ◀── re-read merged payloads ◀──────────────────────────┘

Modules
-------
plan      stack-aware deterministic sharding (``plan``, ``Shard``) —
          trials sharing a ``stack_key`` stay co-located
worker    the worker CLI (``python -m repro_torch.sweep.worker``): one
          shard file in, one private trial cache out, durable per stack
          group
executor  the executor interface + ``LocalProcessExecutor``
          (subprocess dispatch, bounded retries, dead-worker requeue)
merge     ``merge_caches``: idempotent cache union with
          same-key/different-payload conflict detection

Quickstart — distribute any sweep by attaching an executor::

    from repro_torch.study.runner import Runner
    from repro_torch.sweep import LocalProcessExecutor

    runner = Runner(cache_dir="bench_results/torch/study_cache",
                    executor=LocalProcessExecutor(workers=2))
    runner.run(trials)      # cache misses dispatched across 2 workers

``python -m repro_torch.benchmarks.run --workers N`` wires this into the
full table/figure sweeps.
"""
from repro_torch.sweep.executor import (ExecReport,  # noqa: F401
                                        LocalProcessExecutor, ShardFailure,
                                        ShardRun)
from repro_torch.sweep.merge import (Conflict, MergeConflict,  # noqa: F401
                                     MergeReport, merge_caches)
from repro_torch.sweep.plan import Shard, plan  # noqa: F401
