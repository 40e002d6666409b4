"""Sweep executors: dispatch planned shards to workers and merge caches.

The port's twin of the reference package's executors.  The executor
contract (what ``study.Runner`` calls when it has cache-miss trials and
an executor attached) is a single method::

    execute(trials, cache, *, stack=True, device=None) -> ExecReport

which must leave every trial's payload in ``cache.root`` (the canonical
trial-cache directory), computed on ``device`` (the runner's own;
``cuda`` when None), and report what ran where.  The reference's
contract has no ``device``: JAX picks its platform in every process, but
a port entry point runs on ``cuda`` unless told otherwise, so the
runner's device is handed on to every worker as ``--device``.
``LocalProcessExecutor`` is the subprocess-based local implementation
shipped here.

``LocalProcessExecutor`` lifecycle per ``execute`` call:

1. **plan** — ``sweep.plan.plan`` shards the trials stack-aware
   (stack groups are never split across workers);
2. **dispatch** — one ``python -m repro_torch.sweep.worker`` subprocess
   per shard, all concurrently, each with a *private* cache root and
   shard file under a per-call scratch directory; workers inherit this
   process's environment (plus ``PYTHONPATH`` pinned to the directory
   that holds ``repro_torch``) so dataset sources and backend overrides
   carry over;
3. **fault tolerance** — a worker that exits non-zero (or is killed)
   is diagnosed from its private cache: completed keys stay, the
   missing ones are requeued as a new shard attempt, up to
   ``max_retries`` requeues.  Exhausted retries never abandon sibling
   workers mid-flight: every live worker is waited for and every
   private root is merged *before* ``ShardFailure`` surfaces the
   worker log — so even a failed sweep preserves all completed trials
   in the canonical cache and resumes instead of recomputing;
4. **merge** — ``merge_caches`` unions every private root (including
   the partial roots of dead workers) into the canonical cache, with
   same-key/different-payload conflict detection, then the executor
   verifies every requested key is present.  The per-call scratch
   directory (shard files, private caches, logs) is deleted after a
   fully successful merge and kept for post-mortem on any failure.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Sequence

import repro_torch
from repro_torch.kernels import common
from repro_torch.obs import metrics, trace
from repro_torch.study.runner import TrialCache
from repro_torch.study.spec import TrialSpec
from repro_torch.sweep import plan as plan_mod
from repro_torch.sweep.merge import MergeReport, cache_entries, merge_caches


class ShardFailure(RuntimeError):
    """A shard still had unfinished trials after the retry budget.

    Carries the ``ExecReport`` built up to the failure (``report``) so
    the caller can still log worker/shard/merge provenance — a failed
    sweep is exactly when attribution matters most.
    """

    def __init__(self, message: str, report: "ExecReport | None" = None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class ShardRun:
    """Provenance of one worker attempt (recorded in the store's JSONL)."""

    worker: int
    attempt: int
    returncode: int
    wall_s: float
    keys: tuple[str, ...]           # what the attempt was asked to run
    completed: tuple[str, ...]      # what landed in its private cache
    requeued: tuple[str, ...]       # what the scheduler re-dispatched
    trace_file: str | None = None   # the attempt's trace (REPRO_TRACE=1)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ExecReport:
    """Everything one ``execute`` call did, for logs and provenance."""

    executor: str
    workers: int
    n_trials: int
    shard_runs: list[ShardRun]
    merge: MergeReport

    @property
    def retries(self) -> int:
        return sum(1 for r in self.shard_runs if r.attempt > 0)


def _worker_env() -> dict:
    """Child env: inherit everything, pin PYTHONPATH to this package."""
    src = str(Path(repro_torch.__file__).resolve().parent.parent)
    env = dict(os.environ)
    paths = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p and p != src]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def _log_tail(path: Path, n: int = 20) -> str:
    try:
        return "\n".join(path.read_text().splitlines()[-n:])
    except OSError:
        return "<no worker log>"


class LocalProcessExecutor:
    """Run shards as local worker subprocesses with bounded retries.

    ``worker_args`` is passed through to every worker invocation — the
    fault-injection hooks (``--fault-after`` / ``--fault-flag``) and
    ``--no-stack`` ride on it; production sweeps leave it empty.
    """

    kind = "local-process"

    def __init__(self, workers: int, *, work_dir: str | Path | None = None,
                 max_retries: int = 2,
                 worker_args: Sequence[str] = ()):
        if workers < 1:
            raise ValueError(f"workers must be >= 1: {workers}")
        self.workers = workers
        self.work_dir = Path(work_dir) if work_dir is not None else None
        self.max_retries = max_retries
        self.worker_args = tuple(worker_args)

    # -- dispatch ------------------------------------------------------------

    def _launch(self, shard: plan_mod.Shard, attempt: int, run_dir: Path,
                env: dict, *, stack: bool, device: str) -> dict:
        tag = f"w{shard.worker}a{attempt}"
        root = run_dir / f"cache-{tag}"
        shard_path = run_dir / f"shard-{tag}.json"
        log_path = run_dir / f"worker-{tag}.log"
        shard_path.write_text(json.dumps(shard.to_dict()))
        cmd = [sys.executable, "-m", "repro_torch.sweep.worker",
               "--shard", str(shard_path), "--cache-dir", str(root),
               "--device", device,
               *(() if stack else ("--no-stack",)),
               *self.worker_args]
        trace_file = None
        if trace.enabled() or metrics.enabled():
            # each attempt gets its own tag → its own trace/metrics files,
            # so a requeued shard shows up as an extra lane in the merged
            # view (metrics-only mode still needs the tag for its sidecar)
            env = dict(env)
            env[trace.ENV_TRACE_TAG] = f"shard{shard.worker}a{attempt}"
        log = open(log_path, "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env)
        if trace.enabled():
            trace_file = str(trace.trace_path(
                trace.current_dir(), env[trace.ENV_TRACE_TAG], proc.pid))
        return {"shard": shard, "attempt": attempt, "root": root,
                "proc": proc, "log": log, "log_path": log_path,
                "trace_file": trace_file, "t0": time.perf_counter()}

    def execute(self, trials: Sequence[TrialSpec], cache: TrialCache, *,
                stack: bool = True, device=None) -> ExecReport:
        if cache.root is None:
            raise ValueError("distributed sweeps need a canonical cache root")
        if self.work_dir is not None:
            self.work_dir.mkdir(parents=True, exist_ok=True)
        run_dir = Path(tempfile.mkdtemp(
            prefix="sweep-", dir=self.work_dir))
        env = _worker_env()
        device = str(common.device(device))

        shards = plan_mod.plan(trials, self.workers)
        queue: list[tuple[plan_mod.Shard, int]] = [(s, 0) for s in shards]
        shard_runs: list[ShardRun] = []
        roots: list[Path] = []
        failures: list[str] = []
        live: list[dict] = []

        with trace.span("sweep.execute", workers=self.workers,
                        shards=len(shards), trials=len(trials)):
            try:
                while queue:
                    live = []
                    for s, a in queue:  # loop, not a comprehension: a launch
                        live.append(    # failure must not lose live handles
                            self._launch(s, a, run_dir, env, stack=stack,
                                         device=device))
                    queue = []
                    # reap every live worker before deciding anything (an
                    # exhausted shard must not orphan its siblings
                    # mid-compute), polling so each worker's wall time is
                    # its own exit time, not the round's slowest — the
                    # provenance events attribute wall time per worker
                    t_exit: dict[int, float] = {}
                    while len(t_exit) < len(live):
                        progressed = False
                        for i, item in enumerate(live):
                            if i not in t_exit \
                                    and item["proc"].poll() is not None:
                                t_exit[i] = time.perf_counter()
                                progressed = True
                        if not progressed:
                            time.sleep(0.02)
                    for i, item in enumerate(live):
                        rc = item["proc"].returncode
                        item["log"].close()
                        wall = t_exit[i] - item["t0"]
                        shard, attempt, root = (item["shard"],
                                                item["attempt"],
                                                item["root"])
                        roots.append(root)
                        done = {p.stem for p in cache_entries(root)}
                        unfinished = tuple(t for t in shard.trials
                                           if t.key not in done)
                        requeued: tuple[str, ...] = ()
                        if rc != 0 and unfinished:
                            if attempt >= self.max_retries:
                                tf = item["trace_file"]
                                failures.append(
                                    f"worker {shard.worker} failed "
                                    f"{attempt + 1}x (exit {rc}), "
                                    f"{len(unfinished)} trial(s) unfinished;"
                                    + (f" trace: {tf};" if tf else "")
                                    + f" last log lines:\n"
                                    f"{_log_tail(item['log_path'])}")
                            else:
                                requeue = plan_mod.Shard(
                                    worker=shard.worker, trials=unfinished)
                                queue.append((requeue, attempt + 1))
                                requeued = requeue.keys
                                metrics.counter("sweep.requeue").inc()
                        shard_runs.append(ShardRun(
                            worker=shard.worker, attempt=attempt,
                            returncode=rc, wall_s=wall, keys=shard.keys,
                            completed=tuple(t.key for t in shard.trials
                                            if t.key in done),
                            requeued=requeued,
                            trace_file=item["trace_file"]))
            finally:
                # interrupted mid-round (Ctrl-C, launch failure): never
                # leave worker subprocesses running or log handles open
                for item in live:
                    if item["proc"].poll() is None:
                        item["proc"].terminate()
                        try:
                            item["proc"].wait(timeout=5)
                        except subprocess.TimeoutExpired:
                            item["proc"].kill()
                            item["proc"].wait()
                    if not item["log"].closed:
                        item["log"].close()

        # merge BEFORE raising: even a failed sweep keeps every completed
        # trial, so the next attempt resumes instead of recomputing
        with trace.span("sweep.merge", roots=len(roots)):
            merge = merge_caches(roots, cache.root)
        report = ExecReport(executor=self.kind, workers=self.workers,
                            n_trials=len(trials), shard_runs=shard_runs,
                            merge=merge)
        if failures:
            raise ShardFailure(
                "\n".join(failures)
                + f"\n(completed trials were merged into {cache.root}; "
                f"scratch kept at {run_dir})", report)
        missing = [t.key for t in trials
                   if not (Path(cache.root) / f"{t.key}.json").exists()]
        if missing:
            raise ShardFailure(
                f"{len(missing)} trial(s) missing from the merged cache "
                f"despite clean worker exits: {missing[:5]} "
                f"(scratch kept at {run_dir})", report)
        shutil.rmtree(run_dir, ignore_errors=True)
        return report
