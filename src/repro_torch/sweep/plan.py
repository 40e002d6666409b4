"""Stack-aware sweep planner: shard a ``TrialSpec`` grid across N workers.

The port's copy of the reference package's planner, on the port's own
``study.spec``; the trial keys are equal in both packages, so the same
trial list and worker count give the same shards, key for key.

The planner's one hard invariant is **stack-group co-location**: trials
that share a ``stack_key`` (same spec up to the step size — the §6.1
grid) must land on the same worker, because the runner executes such a
group as one stack.  Splitting a group would change the recorded timing
meta (``stacked`` amortizes wall time 1/S over the group), so a
distributed sweep would stop reproducing the single-host cache.

Within that constraint the planner balances load with a deterministic
longest-processing-time greedy: groups are weighted by an
epochs × examples × nnz-per-example work proxy from the dataset
profile (so one full-size dataset group outweighs many fixture-sized
ones), sorted heaviest-first (ties broken on ``stack_key``), and each
is assigned to the least-loaded worker (ties broken on the lowest
worker index).  Same trial list + same worker count ⇒ same plan,
everywhere — the scheduler's requeue logic and the provenance log rely
on that.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.study.spec import SCHEMA_VERSION, TrialSpec


@dataclasses.dataclass(frozen=True)
class Shard:
    """One worker's slice of the sweep: whole stack groups only."""

    worker: int
    trials: tuple[TrialSpec, ...]

    @property
    def keys(self) -> tuple[str, ...]:
        return tuple(t.key for t in self.trials)

    def to_dict(self) -> dict:
        """The on-disk shard file consumed by ``repro_torch.sweep.worker``."""
        return {
            "schema": SCHEMA_VERSION,
            "worker": self.worker,
            "trials": [t.to_dict() for t in self.trials],
        }

    @classmethod
    def from_dict(cls, dct: dict) -> "Shard":
        if dct.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"shard schema {dct.get('schema')!r} != {SCHEMA_VERSION}")
        return cls(worker=dct["worker"],
                   trials=tuple(TrialSpec.from_dict(d)
                                for d in dct["trials"]))


def _group_weight(group: Sequence[TrialSpec], profiles: dict) -> float:
    """Work proxy for one stack group: epochs × examples × nnz/example.

    The reference's weight, kept so both packages shard alike: there a
    stacked group runs as one fused program, so its wall cost scales
    with the per-epoch data volume and the epoch count, not with the
    member count S (the port launches once a step, so the proxy
    undercounts its large grids); ``+ S`` keeps big grids from ever
    weighing zero.
    The dataset profile is derivable without materializing the data
    and is what separates a full-size dataset group from many
    fixture-sized ones — strategy constants are deliberately ignored
    (a proxy, not the advisor's cost model).
    """
    t = group[0]
    if t.dataset not in profiles:
        profiles[t.dataset] = t.dataset.profile()
    prof = profiles[t.dataset]
    return t.epochs * prof.n * prof.nnz_per_example + len(group)


def plan(trials: Sequence[TrialSpec], workers: int) -> list[Shard]:
    """Shard ``trials`` over ``workers``, co-locating stack groups.

    Duplicate specs (same ``key``) are dispatched once.  Returns only
    non-empty shards (fewer groups than workers ⇒ fewer shards), with
    each shard's trials in their original input order.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1: {workers}")
    groups: dict[str, list[TrialSpec]] = {}
    pos: dict[str, int] = {}
    for i, t in enumerate(trials):
        if t.key in pos:
            continue
        pos[t.key] = i
        groups.setdefault(t.stack_key, []).append(t)

    profiles: dict = {}
    weight = {sk: _group_weight(g, profiles) for sk, g in groups.items()}
    order = sorted(groups, key=lambda sk: (-weight[sk], sk))
    loads = [0.0] * workers
    assigned: list[list[TrialSpec]] = [[] for _ in range(workers)]
    for sk in order:
        w = min(range(workers), key=lambda i: (loads[i], i))
        loads[w] += weight[sk]
        assigned[w].extend(groups[sk])

    # restore input order inside each shard (stacking regroups by key anyway,
    # but stable order keeps shard files and provenance logs reproducible)
    return [
        Shard(worker=w, trials=tuple(sorted(ts, key=lambda t: pos[t.key])))
        for w, ts in enumerate(assigned) if ts
    ]
