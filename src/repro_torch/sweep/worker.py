"""Sweep worker: execute one shard file into a private trial cache.

    python -m repro_torch.sweep.worker --shard SHARD.json --cache-dir DIR
        [--no-stack] [--fault-after N [--fault-flag PATH]]
        [--fault-mode exit|kill] [--device cuda|cpu]

The port's twin of the reference package's worker.  The worker is the
unit of fault isolation in a distributed sweep: it reads a shard
(serialized ``TrialSpec``s, written by the scheduler), executes it
stack-group by stack-group through a plain ``study.Runner`` whose cache
root is **private to this worker**, on ``--device`` (``cuda`` unless
given; the executor passes its runner's device), and exits 0.  Every
completed trial is already durably cached when the next group starts
(the runner's one-file-per-key atomic writes), so a worker killed
mid-shard leaves a valid partial cache behind — the executor requeues
exactly the keys missing from it and merges whatever did land.

Progress is reported one JSON line per completed stack group on stdout
(``{"done": k, "of": n, "keys": [...]}``); the executor treats stdout
as a log, not a protocol — the cache directory is the source of truth.

``--fault-after N`` is the test/debug hook for the fault-tolerance
path: after N completed trials the worker exits with status 17 —
once, if ``--fault-flag PATH`` names a sentinel file (created on the
first trip, so the retried shard runs to completion), or on every
attempt without it (exercises retry exhaustion).  ``--fault-mode kill``
makes the fault a real ``SIGKILL`` (no atexit, no cleanup) instead of
``sys.exit``: the durability story — per-group ``metrics.flush()`` and
the runner's atomic cache writes — is what keeps the partial sidecar
and cache readable, and the tests assert exactly that.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from pathlib import Path

from repro_torch.obs import metrics, trace
from repro_torch.study.runner import Runner
from repro_torch.sweep.plan import Shard

#: exit status of an injected fault (distinct from argparse's 2 / crash's 1)
FAULT_EXIT = 17


def _maybe_fault(done: int, fault_after: int | None,
                 fault_flag: str | None, fault_mode: str = "exit") -> None:
    if fault_after is None or done < fault_after:
        return
    if fault_flag is not None:
        flag = Path(fault_flag)
        if flag.exists():
            return      # already tripped once; run normally this attempt
        flag.parent.mkdir(parents=True, exist_ok=True)
        flag.write_text("tripped\n")
    print(json.dumps({"fault_injected_after": done}), flush=True)
    if fault_mode == "kill":
        # the real thing: no atexit flush, no unwinding — only the
        # per-group flushes already on disk survive
        os.kill(os.getpid(), signal.SIGKILL)
    sys.exit(FAULT_EXIT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep.worker",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shard", required=True,
                    help="shard file written by the sweep planner")
    ap.add_argument("--cache-dir", required=True,
                    help="this worker's PRIVATE trial-cache root")
    ap.add_argument("--no-stack", action="store_true",
                    help="run every trial of a step grid on its own (debug)")
    ap.add_argument("--fault-after", type=int, default=None,
                    help="test hook: exit(17) after N completed trials")
    ap.add_argument("--fault-flag", default=None,
                    help="sentinel file making --fault-after a one-shot")
    ap.add_argument("--fault-mode", choices=("exit", "kill"), default="exit",
                    help="fault flavor: clean exit(17), or SIGKILL self "
                         "(tests sidecar/cache durability)")
    ap.add_argument("--device", default="cuda",
                    help="where the trials run (cpu: the plain versions)")
    args = ap.parse_args(argv)

    with open(args.shard) as f:
        shard = Shard.from_dict(json.load(f))
    runner = Runner(cache_dir=args.cache_dir, stack=not args.no_stack,
                    device=args.device)

    groups: dict[str, list] = {}
    for t in shard.trials:
        groups.setdefault(t.stack_key, []).append(t)

    done = 0
    total = len(shard.trials)
    # the executor sets REPRO_TRACE_TAG=shard<W>a<A> per attempt, so this
    # span lands in a per-attempt trace file the report CLI stitches into
    # the driver's timeline
    with trace.span("sweep.shard", worker=shard.worker, trials=total,
                    groups=len(groups), device=str(runner.device)):
        _maybe_fault(done, args.fault_after, args.fault_flag, args.fault_mode)
        for group in groups.values():
            with trace.span("sweep.group", stack_key=group[0].stack_key,
                            trials=len(group)):
                runner.run(group)
            done += len(group)
            print(json.dumps({"done": done, "of": total,
                              "keys": [t.key for t in group]}), flush=True)
            # durability point: everything this group counted is on disk
            # before a fault (even SIGKILL) can take the process down
            metrics.flush(0)
            _maybe_fault(done, args.fault_after, args.fault_flag,
                         args.fault_mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
