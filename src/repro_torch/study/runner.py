"""Trial execution: deterministic seeds, timing, caching, step stacking.

The port's copy of the reference's ``study/runner.py``.  The runner turns
``TrialSpec``s into ``TrialResult``s:

* **trial cache** — results are keyed by the spec's content hash and
  persisted as one JSON file per trial, so an interrupted sweep resumes
  where it stopped instead of recomputing, and a repeated sweep is a
  pure cache read.  The keys equal the reference's, so the port keeps
  its own cache directory: a shared one would serve one package's
  timings as the other's;
* **step stacking** — trials that differ only in step size (the Section
  6.1 grid) run together, epoch by epoch.  The port's kernels take the
  step at run time, so a stack of S steps is S ``make_epoch_fn`` chains
  advanced in turn: S launches of the family's kernel an epoch (the
  reference instead vmaps one compiled program over a step axis).  The
  timing rule is the reference's: the first epoch's time is replaced by
  the median of the rest, and the stack's wall time is split evenly over
  its S trials (flagged ``stacked``);
* **dataset memoization** — datasets (synthetic generations and real
  ingests alike) are materialized once per ``DatasetSpec`` per runner, on
  the runner's device (``cuda`` unless given);
* **executor dispatch** — with an ``executor`` attached (see
  ``repro_torch.sweep``), cache-miss trials spanning at least
  ``dispatch_min_groups`` stack groups are not executed in-process:
  they are handed to the executor, with the runner's device, which must
  leave their payloads in the canonical cache (N workers, merged), and
  the runner then reads the results back from the cache.  A single stack
  group cannot parallelize, so it runs in-process even with an executor
  attached.  Cache hits, store recording, and result ordering are
  identical either way, which is what keeps ``BENCH_study.json`` a pure
  function of the trial cache.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from repro_torch.core import glm, sgd
from repro_torch.kernels import common
from repro_torch.obs import metrics, trace
from repro_torch.study.spec import DatasetSpec, TrialSpec, canonical_json


@dataclasses.dataclass
class TrialResult:
    """One trial's measured history (mirrors ``sgd.RunResult`` + meta)."""

    losses: np.ndarray          # [epochs+1] incl. the init loss
    epoch_times: np.ndarray     # [epochs] wall seconds
    strategy: str
    task: str
    cached: bool = False        # served from the trial cache
    stacked: bool = False       # timing amortized over a step-stack

    def epochs_to(self, target: float) -> int | None:
        hit = np.nonzero(self.losses <= target)[0]
        return int(hit[0]) if len(hit) else None

    def time_to(self, target: float) -> float | None:
        e = self.epochs_to(target)
        if e is None:
            return None
        return float(np.sum(self.epoch_times[:e]))

    @property
    def time_per_epoch(self) -> float:
        return float(np.mean(self.epoch_times))

    @property
    def final_loss(self) -> float:
        return float(self.losses[-1])

    def to_dict(self) -> dict:
        return {
            "losses": [float(x) for x in self.losses],
            "epoch_times": [float(x) for x in self.epoch_times],
            "strategy": self.strategy,
            "task": self.task,
            "stacked": self.stacked,
        }

    @classmethod
    def from_dict(cls, dct: dict, *, cached: bool = False) -> "TrialResult":
        return cls(
            losses=np.asarray(dct["losses"], dtype=np.float64),
            epoch_times=np.asarray(dct["epoch_times"], dtype=np.float64),
            strategy=dct["strategy"],
            task=dct["task"],
            cached=cached,
            stacked=dct.get("stacked", False),
        )


class TrialCache:
    """Content-addressed on-disk cache: ``<root>/<trial.key>.json``."""

    def __init__(self, root: str | Path | None):
        self.root = Path(root) if root is not None else None
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> dict | None:
        payload = self.peek(key)
        if payload is None:
            self.misses += 1
            metrics.counter("study.trial_cache.miss").inc()
        else:
            self.hits += 1
            metrics.counter("study.trial_cache.hit").inc()
        return payload

    def peek(self, key: str) -> dict | None:
        """``get`` without touching the hit/miss counters."""
        if self.root is None:
            return None
        try:
            with open(self.root / f"{key}.json") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def put(self, key: str, payload: dict) -> None:
        if self.root is None:
            return
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / f".{key}.tmp.{os.getpid()}"
        tmp.write_text(canonical_json(payload))
        tmp.replace(self.root / f"{key}.json")  # atomic on POSIX


def _problem(ds, task: str, step: float):
    """(problem, sparse_data) for one loaded dataset — the engine's input,
    on the dataset's device."""
    if ds.dense:
        return glm.GLMProblem(task, ds.X, ds.y, step), False
    return (task, ds.ell, ds.y, step), True


def _stackable(t: TrialSpec) -> bool:
    """The reference's predicate: a strategy that forces a kernel backend
    runs its trials one at a time."""
    return getattr(t.strategy, "kernel_backend", None) is None


class Runner:
    """Executes trial lists with caching, stacking, and store recording."""

    def __init__(self, cache_dir: str | Path | None = None, *,
                 store=None, stack: bool = True, executor=None,
                 dispatch_min_groups: int = 2, device=None):
        self.cache = TrialCache(cache_dir)
        self.store = store
        self.stack = stack
        self.executor = executor        # validated by the property setter
        #: dispatch to the executor only when at least this many stack
        #: groups miss the cache: a single group cannot parallelize, and
        #: running it in-process skips the worker's cold start and keeps
        #: the dataset memo warm
        self.dispatch_min_groups = dispatch_min_groups
        self.device = common.device(device)
        self._datasets: dict[DatasetSpec, object] = {}

    @property
    def executor(self):
        return self._executor

    @executor.setter
    def executor(self, executor) -> None:
        # a property so post-construction attachment (benchmarks.run
        # --workers sets it on the shared runner) fails fast too
        if executor is not None and self.cache.root is None:
            raise ValueError("an executor needs a canonical cache_dir to "
                             "merge worker results into")
        self._executor = executor

    def dataset(self, dspec: DatasetSpec):
        if dspec not in self._datasets:
            self._datasets[dspec] = dspec.load(device=self.device)
        return self._datasets[dspec]

    # -- execution ----------------------------------------------------------

    def run_trial(self, trial: TrialSpec) -> TrialResult:
        return self.run([trial])[0]

    def run(self, trials: Sequence[TrialSpec]) -> list[TrialResult]:
        """Run every trial (cache-first), preserving input order."""
        results: list[TrialResult | None] = [None] * len(trials)
        pending: dict[str, list[int]] = {}
        for i, t in enumerate(trials):
            payload = self.cache.get(t.key)
            if payload is not None:
                results[i] = TrialResult.from_dict(payload, cached=True)
            else:
                pending.setdefault(t.stack_key, []).append(i)

        if pending and self.executor is not None \
                and len(pending) >= self.dispatch_min_groups:
            self._run_dispatched(trials, pending, results)
        else:
            for indices in pending.values():
                group = [trials[i] for i in indices]
                if self.stack and len(group) > 1 and _stackable(group[0]):
                    outs = self._run_stacked(group)
                else:
                    outs = [self._run_single(t) for t in group]
                for i, t, res in zip(indices, group, outs):
                    results[i] = res
                    self.cache.put(t.key, res.to_dict())

        for t, res in zip(trials, results):
            if self.store is not None:
                self.store.record_trial(t, res)
        return results  # type: ignore[return-value]

    def _run_dispatched(self, trials, pending, results) -> None:
        """Hand cache misses to the executor, then read the merged cache.

        The executor owns sharding, worker lifecycle, retries, and the
        cache merge; its contract is that every requested key is in the
        canonical cache afterwards, computed on the device it is given
        (the runner's).  Results are re-read from the cache (not returned
        in-band) so the dispatched path and the warm-cache path serve
        byte-identical payloads.
        """
        todo = [trials[i] for idxs in pending.values() for i in idxs]
        try:
            report = self.executor.execute(todo, self.cache,
                                           stack=self.stack,
                                           device=self.device)
        except Exception as exc:
            # a failed sweep is when attribution matters most: executors
            # attach their partial report to the failure (ShardFailure)
            self._record_exec_events(getattr(exc, "report", None))
            raise
        self._record_exec_events(report)
        for idxs in pending.values():
            for i in idxs:
                payload = self.cache.peek(trials[i].key)
                if payload is None:
                    raise RuntimeError(
                        f"executor left no payload for {trials[i].label} "
                        f"({trials[i].key})")
                # computed this sweep (by a worker), not served from cache
                results[i] = TrialResult.from_dict(payload, cached=False)

    def _record_exec_events(self, report) -> None:
        if report is None or self.store is None \
                or not hasattr(self.store, "record_event"):
            return
        for run in report.shard_runs:
            self.store.record_event("sweep_shard", **run.to_dict())
        self.store.record_event(
            "sweep_merge", executor=report.executor,
            workers=report.workers, n_trials=report.n_trials,
            retries=report.retries, **report.merge.to_dict())

    def _run_single(self, t: TrialSpec) -> TrialResult:
        with trace.span("runner.trial", key=t.key, label=t.label,
                        strategy=t.strategy.name), trace.xprof(t.label):
            ds = self.dataset(t.dataset)
            problem, sparse_data = _problem(ds, t.task, t.step)
            r = sgd.run(problem, t.strategy, t.epochs,
                        sparse_data=sparse_data)
        return TrialResult(losses=np.asarray(r.losses, dtype=np.float64),
                           epoch_times=np.asarray(r.epoch_times,
                                                  dtype=np.float64),
                           strategy=t.strategy.name, task=t.task)

    def _run_stacked(self, group: Sequence[TrialSpec]) -> list[TrialResult]:
        """A whole step grid (same-shape configs), advanced epoch by epoch.

        One ``make_epoch_fn`` chain per step, each launching its family's
        kernel once an epoch with its own step.  Mirrors ``sgd.run``'s
        timing protocol: the first epoch builds the kernels and its time is
        replaced by the median of the rest; stack wall time is split evenly
        over the S member trials.
        """
        base = group[0]
        S = len(group)
        metrics.histogram("study.stack_size").observe(float(S))
        with trace.span("runner.stack", size=S, label=base.label,
                        strategy=base.strategy.name), trace.xprof(base.label):
            ds = self.dataset(base.dataset)
            chains = []
            for t in group:
                problem, sparse_data = _problem(ds, t.task, t.step)
                chains.append(sgd.make_epoch_fn(problem, t.strategy,
                                                sparse_data=sparse_data))
            states = [init for init, _, _, _ in chains]
            dev = states[0].device

            def epoch(states):
                return [fn(s) for (_, fn, _, _), s in zip(chains, states)]

            def loss_row(states):
                return [float(loss_fn(s))
                        for (_, _, loss_fn, _), s in zip(chains, states)]

            losses = [loss_row(states)]
            times: list[float] = []
            with trace.span("engine.compile", strategy=base.strategy.name,
                            stacked=S):
                states = epoch(states)      # warmup epoch (builds kernels)
                sgd._sync(dev)
            losses.append(loss_row(states))
            times.append(float("nan"))
            for e in range(base.epochs - 1):
                with trace.span("engine.epoch", epoch=e + 1,
                                strategy=base.strategy.name, stacked=S):
                    t0 = time.perf_counter()
                    states = epoch(states)
                    sgd._sync(dev)
                    times.append(time.perf_counter() - t0)
                losses.append(loss_row(states))
            times[0] = (float(np.nanmedian(times[1:]))
                        if len(times) > 1 else 0.0)

        loss_mat = np.asarray(losses, dtype=np.float64).T   # [S, epochs+1]
        per_trial_times = np.asarray(times) / S             # amortized
        return [
            TrialResult(losses=loss_mat[i],
                        epoch_times=per_trial_times.copy(),
                        strategy=t.strategy.name, task=t.task, stacked=True)
            for i, t in enumerate(group)
        ]
