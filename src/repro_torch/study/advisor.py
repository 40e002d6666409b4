"""Configuration advisor — the paper's Table 6 as a queryable API.

The port's copy of the reference's ``study/advisor.py``.  ``HostCaps.detect``
reads ``torch.cuda`` where the reference reads ``jax.devices()``, and a
family's ``backends`` are the one flavor the device implies.

Table 6 answers "which configuration is optimal for this dataset on this
hardware": the winning update strategy / replication level / access path
is dataset- and hardware-dependent and must be *searched* (the same
conclusion as Parnell et al. and Keuper & Pfreundt — see PAPERS.md).

``recommend(profile, caps)`` runs that search: it builds a candidate
space filtered by the host's capabilities, tunes each candidate's step
size (§6.1), and ranks candidates by time-to-convergence

    score = epochs_to_target × epoch_cost

where ``epochs_to_target`` is *measured* statistical efficiency (from
seeded runs — deterministic) and ``epoch_cost`` is, by default, a
deterministic roofline-flavored hardware model (``modeled_epoch_cost``),
so the ranking is reproducible under a fixed seed.  ``rank="measured"``
substitutes measured wall time per epoch (the paper's actual Table-6
protocol; benchmarks use it, tests use the default), and
``rank="calibrated"`` keeps the deterministic model but with its
constants **fit to this host**: ``calibrate(store)`` least-squares the
cost model against the measured wall-times already recorded in
``BENCH_study.json`` (falling back to the fixed defaults below a
minimum trial count).  The measured evidence is attached to every
ranked row either way.

Usage — "what should I run on this dataset, on this host?"::

    from repro_torch.study import advisor
    from repro_torch.study.runner import Runner

    rec = advisor.recommend("w8a", task="lr",        # synthetic stand-in
                            runner=Runner(device="cpu"))
    print(rec.best.name, rec.best.best_step)          # e.g. async-r16-b1
    for row in rec.ranked:                            # full Table-6 row set
        print(row.name, row.score, row.stat_penalty, row.hw_advantage)

Pass a ``DatasetSpec(..., source="real")`` to rank against an ingested
real dataset, a ``Runner(cache_dir=...)`` to reuse the study trial
cache across calls (and to pick the device: a runner made here runs on
``cuda``), and ``caps=HostCaps.detect()`` (the default) to filter
candidates by what this host can execute.
``repro_torch/benchmarks/table6_optimal.py`` is a thin wrapper over this
module with ``rank="measured"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

import torch

from repro_torch.core import convergence, sgd
from repro_torch.kernels import common
from repro_torch.study import tuner as tuner_mod
from repro_torch.study.runner import Runner, TrialResult
from repro_torch.study.spec import (DatasetProfile, DatasetSpec, TrialSpec,
                                    strategy_to_dict)

#: cost-model constants (relative feature-op units; see modeled_epoch_cost)
UPDATE_OVERHEAD = 16.0     # fixed cost of applying one model update
MERGE_UNIT = 1.0           # per (replica × feature) cost of a merge

#: below this many measured trials, calibrate() keeps the fixed defaults
CALIBRATION_MIN_TRIALS = 8


#: per-device example-lane estimate: a TPU core's (8, 128) vregs vs a
#: handful of SIMD lanes on CPU/GPU-less hosts.  The reference's table as
#: it stands: a GPU gets the default (an open question, ROADMAP)
_LANES_PER_DEVICE = {"tpu": 128 * 8}
_DEFAULT_LANES = 8


@dataclasses.dataclass(frozen=True)
class HostCaps:
    """What the advisor may assume about the host.

    ``parallel_width`` — how many example-lanes the host can keep busy
    simultaneously (the paper's thread/warp count analogue); replicas and
    batch rows vectorize up to this width.  ``backends`` — the kernel
    flavor per family that the device implies (``cuda`` on a card,
    ``torch-reference`` on the CPU).  ``platform`` / ``device_count``
    record what ``detect`` saw in ``torch.cuda`` — provenance fields;
    the cost model reads only the width.
    """

    parallel_width: int
    max_replicas: int
    backends: Mapping[str, tuple[str, ...]]
    platform: str = "cpu"
    device_count: int = 1

    @classmethod
    def detect(cls) -> "HostCaps":
        gpu = torch.cuda.is_available()
        platform = "gpu" if gpu else "cpu"
        count = torch.cuda.device_count() if gpu else 1
        width = _LANES_PER_DEVICE.get(platform, _DEFAULT_LANES) * max(1, count)
        flavor = common.CUDA if gpu else common.TORCH_REFERENCE
        # replica count is a *statistical* axis, not a lane budget: the
        # kernels take any replica count on any host; the cost model
        # charges the serialization, not the space.
        return cls(
            parallel_width=width,
            max_replicas=64,
            backends={fam: (flavor,)
                      for fam in ("glm_grad", "glm_sgd", "glm_sparse")},
            platform=platform,
            device_count=count,
        )

    def to_dict(self) -> dict:
        dct = dataclasses.asdict(self)
        dct["backends"] = {k: list(v) for k, v in self.backends.items()}
        return dct


# ---------------------------------------------------------------------------
# Hardware-efficiency model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The constants of ``modeled_epoch_cost``, fixed or fitted.

    The default instance reproduces the hand-picked feature-op units
    (``scale=1.0``); ``calibrate`` returns one whose constants are
    least-squares fit to measured wall-times, with ``scale`` carrying
    the feature-ops→seconds conversion for this host.  Only *ratios*
    between candidate configurations matter to the ranking either way.
    """

    update_overhead: float = UPDATE_OVERHEAD
    merge_unit: float = MERGE_UNIT
    scale: float = 1.0
    source: str = "default"         # "default" | "calibrated"
    n_trials: int = 0               # measured trials behind a fit

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_COST_MODEL = CostModel()


def cost_features(profile: DatasetProfile, strategy,
                  caps: HostCaps) -> tuple[float, float, float]:
    """The cost model's linear decomposition for one configuration.

    Returns ``(base, updates, merges)`` such that

        epoch_cost = scale × (base
                              + update_overhead × updates
                              + merge_unit × merges)

    — the form both ``modeled_epoch_cost`` and the least-squares fit in
    ``calibrate`` consume.  ``base`` is the vectorized feature-op work,
    ``updates`` counts sequential model updates (each paying the fixed
    update overhead), ``merges`` counts replica-merge traffic in
    (R × d / width) units.
    """
    n, nnz, d = profile.n, profile.nnz_per_example, profile.d
    W = max(1, caps.parallel_width)
    if isinstance(strategy, sgd.SyncSGD):
        batch = strategy.batch or n
        updates = math.ceil(n / batch)
        return n * nnz / min(batch, W), float(updates), 0.0
    assert isinstance(strategy, sgd.AsyncLocalSGD)
    R = strategy.replicas
    per = n // R + strategy.rep_k
    # replicas occupy up to W lanes; leftover width vectorizes the local batch
    lanes_per_replica = max(1, W // R)
    chain = math.ceil(per / strategy.local_batch)    # sequential updates
    work = per * nnz / min(strategy.local_batch, lanes_per_replica)
    waves = math.ceil(R / W)        # more replicas than lanes ⇒ they serialize
    merges = max(1, int(round(1.0 / strategy.merge_every))) \
        if strategy.merge_every <= 1 else 1
    return (merges * work * waves, float(merges * chain * waves),
            merges * R * d / W)


def modeled_epoch_cost(profile: DatasetProfile, strategy, caps: HostCaps,
                       model: CostModel = DEFAULT_COST_MODEL) -> float:
    """Relative cost of one epoch, in feature-ops on ``caps``.

    A coarse roofline: work vectorizes up to ``parallel_width`` lanes,
    every model update pays a fixed overhead (the batch-vs-incremental
    trade), replica merges pay R×d.  With the default ``model`` the
    absolute scale is meaningless; only ratios between candidate
    configurations matter, and those reproduce the paper's qualitative
    trade-offs:

    * more replicas ⇒ smaller partitions ⇒ cheaper epochs (hardware
      efficiency up — paper Fig. 12);
    * rep-k halos ⇒ each replica processes k extra examples (Fig. 15);
    * full-batch sync ⇒ one update per epoch, fully vectorized — the
      cheapest pass but the least statistically efficient (Fig. 22).

    A ``calibrate``d model keeps the same structure but host-fitted
    constants (and a seconds scale), per Shi et al.'s finding that
    configuration rankings need per-host cost calibration.
    """
    base, updates, merges = cost_features(profile, strategy, caps)
    return model.scale * (base + model.update_overhead * updates
                          + model.merge_unit * merges)


def calibrate(store, caps: HostCaps | None = None, *,
              min_trials: int = CALIBRATION_MIN_TRIALS) -> CostModel:
    """Fit the cost model's constants to measured wall-times in a store.

    ``store`` is a ``StudyStore``, a loaded snapshot dict, or a path to
    ``BENCH_study.json`` — anything holding trial records (spec +
    ``derived.time_per_epoch_s``).  Each usable trial contributes one
    least-squares row ``t ≈ k·base + k·U·updates + k·M·merges`` (linear
    in ``(k, k·U, k·M)``); the solve is ``np.linalg.lstsq`` —
    deterministic for fixed inputs.

    Falls back to ``DEFAULT_COST_MODEL`` (the fixed constants) whenever
    the fit would not be trustworthy: fewer than ``min_trials`` usable
    measured trials, or a degenerate/non-physical solution (non-positive
    scale).  Negative fitted constants clamp to 0 — a host where merges
    are free is plausible; one where they pay you is not.

    A record only contributes if its stored key matches the key this
    host recomputes from the spec — for real datasets that key embeds
    the ingested content hash, so wall-times measured against different
    bytes (a store from a full-download host calibrated against the
    bundled fixtures, say) are skipped rather than fit against the
    wrong (n, d, nnz) features.
    """
    caps = caps or HostCaps.detect()
    profiles: dict = {}
    rows: list[tuple[float, float, float]] = []
    times: list[float] = []
    for key, rec in _store_trials(store):
        try:
            trial = TrialSpec.from_dict(rec["spec"])
            t = float(rec["derived"]["time_per_epoch_s"])
            if trial.key != key:
                continue        # measured against data this host doesn't have
        except (KeyError, TypeError, ValueError, OSError):
            # OSError: a real dataset whose bytes this host cannot resolve
            # at all (no cached download, no fixture) — skip, don't abort
            continue
        if not (math.isfinite(t) and t > 0):
            continue
        if trial.dataset not in profiles:
            profiles[trial.dataset] = trial.dataset.profile()
        rows.append(cost_features(profiles[trial.dataset], trial.strategy,
                                  caps))
        times.append(t)
    if len(rows) < min_trials:
        return DEFAULT_COST_MODEL
    A = np.asarray(rows, dtype=np.float64)
    b = np.asarray(times, dtype=np.float64)
    coef, _, rank, _ = np.linalg.lstsq(A, b, rcond=None)
    k, ku, km = (float(c) for c in coef)
    if rank < A.shape[1] or k <= 0 or not math.isfinite(k):
        return DEFAULT_COST_MODEL
    return CostModel(update_overhead=max(0.0, ku / k),
                     merge_unit=max(0.0, km / k),
                     scale=k, source="calibrated", n_trials=len(rows))


def _store_trials(store) -> list[tuple[str, dict]]:
    """(key, record) pairs from a StudyStore, a snapshot dict, or a path."""
    from repro_torch.study.store import StudyStore

    if isinstance(store, (str, bytes)) or hasattr(store, "__fspath__"):
        store = StudyStore.load(store)
    if isinstance(store, StudyStore):
        return list(store.trials.items())
    return list(store.get("trials", {}).items())


# ---------------------------------------------------------------------------
# Candidate space
# ---------------------------------------------------------------------------


def candidate_space(
    profile: DatasetProfile,
    caps: HostCaps,
    *,
    replicas: Sequence[int] = (4, 16, 64),
    accesses: Sequence[str] = ("chunk", "round_robin"),
    rep_ks: Sequence[int] = (0, 10),
    kernel_backends: Sequence[str | None] = (None,),
) -> list:
    """Table-6 design space, filtered to what host + dataset can run.

    The reference also offers ``SyncSGD(kernel_backend="pallas-interpret")``
    by default, a second execution path on its CPU.  The port's only
    flavor is the one the device implies, which ``SyncSGD()`` already
    runs, so its default space has no forced backend.
    """
    out: list = []
    for kb in kernel_backends:
        if kb is not None:
            # the reference's rule: kernel-backed sync candidates are dense
            # glm_grad calls on a backend the host offers
            if not profile.dense:
                continue
            if kb not in caps.backends.get("glm_grad", ()):
                continue
        out.append(sgd.SyncSGD(kernel_backend=kb))
    for r in replicas:
        if r > caps.max_replicas or profile.n < r * 2:
            continue
        for access in accesses:
            for rep_k in rep_ks:
                if rep_k >= profile.n // r:
                    continue  # halo would exceed the partition itself
                out.append(sgd.AsyncLocalSGD(replicas=r, local_batch=1,
                                             access=access, rep_k=rep_k))
    return out


# ---------------------------------------------------------------------------
# Recommendation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankedConfig:
    """One row of the recommendation table, with measured evidence."""

    strategy: object                    # the strategy dataclass itself
    score: float                        # epochs_to × epoch_cost (lower wins)
    epochs_to_target: int | None        # measured statistical efficiency
    epoch_cost: float                   # modeled (or measured s/epoch)
    best_step: float
    stat_penalty: float                 # epochs_to / best epochs_to seen
    hw_advantage: float                 # cheapest epoch_cost / own epoch_cost
    measured_time_per_epoch_s: float
    measured_time_to_target_s: float | None
    final_loss: float

    @property
    def name(self) -> str:
        return self.strategy.name

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["strategy"] = strategy_to_dict(self.strategy)
        d["name"] = self.name
        return d


@dataclasses.dataclass
class Recommendation:
    """Ranked configuration table for one (dataset, task) cell."""

    dataset: str
    task: str
    target: float                       # loss target (1% above optimum)
    rank_by: str                        # "modeled" | "measured"
    ranked: list[RankedConfig]          # best first

    @property
    def best(self) -> RankedConfig:
        return self.ranked[0]

    def to_dict(self) -> dict:
        return {
            "dataset": self.dataset,
            "task": self.task,
            "target": self.target,
            "rank_by": self.rank_by,
            "ranked": [r.to_dict() for r in self.ranked],
        }


def recommend(
    profile: DatasetProfile | DatasetSpec | str,
    caps: HostCaps | None = None,
    *,
    task: str = "lr",
    runner: Runner | None = None,
    space: Sequence | None = None,
    steps: Sequence[float] = (1e-3, 1e-2, 1e-1),
    epochs: int = 8,
    tolerance: float = 0.01,
    seed: int = 0,
    rank: str = "modeled",
    cost_model: "CostModel | object | None" = None,
) -> Recommendation:
    """Answer the paper's Table-6 question for one dataset/host/task.

    Runs the candidate space (step-tuned per §6.1) on a synthetic
    instance matching ``profile`` and returns configurations ranked by
    projected time-to-convergence.  Deterministic under a fixed seed with
    the default ``rank="modeled"``; ``rank="measured"`` uses wall time
    per epoch instead of the cost model (the benchmark protocol);
    ``rank="calibrated"`` ranks with host-fitted cost constants — pass
    ``cost_model=calibrate(store)`` (or the store/path itself, which is
    calibrated in place; omitted, it falls back to the fixed defaults,
    mirroring ``calibrate``'s own too-few-trials fallback).
    """
    if rank not in ("modeled", "measured", "calibrated"):
        raise ValueError(f"rank must be modeled|measured|calibrated: {rank!r}")
    if cost_model is not None and rank != "calibrated":
        raise ValueError(
            f"cost_model is only consulted with rank='calibrated' "
            f"(got rank={rank!r}); drop it or set the rank")
    if isinstance(profile, str):
        dspec = DatasetSpec(profile, seed=seed)
    elif isinstance(profile, DatasetSpec):
        dspec = profile  # the spec's own seed wins: keep cache keys aligned
    else:
        dspec = DatasetSpec(profile.name, max_n=profile.n, seed=seed)
    prof = dspec.profile()
    caps = caps or HostCaps.detect()
    runner = runner or Runner()
    space = list(space) if space is not None else candidate_space(prof, caps)
    if not space:
        raise ValueError(f"empty candidate space for {prof}")
    if rank == "calibrated":
        if cost_model is None:
            model = DEFAULT_COST_MODEL
        elif isinstance(cost_model, CostModel):
            model = cost_model
        else:       # a store / snapshot / path: calibrate it here
            model = calibrate(cost_model, caps)
    else:
        model = DEFAULT_COST_MODEL
    rank_by_run = "time" if rank == "measured" else "epochs"

    # one batched dispatch for the whole candidate space: with a sweep
    # executor attached, every candidate's step grid fans out at once
    bases = [TrialSpec(dataset=dspec, task=task, strategy=strat,
                       step=steps[0], epochs=epochs, seed=seed)
             for strat in space]
    tuned = list(zip(space, tuner_mod.tune_many(
        runner, bases, steps=steps, by=rank_by_run)))

    # common target: within `tolerance` of the best loss seen anywhere
    all_results: list[TrialResult] = [
        r for _, t in tuned for r in t.results.values()]
    opt = convergence.optimal_loss(all_results)
    target = convergence.thresholds(opt, (tolerance,))[tolerance]

    rows: list[RankedConfig] = []
    for strat, t in tuned:
        res = t.best_result
        e = res.epochs_to(target)
        cost = (res.time_per_epoch if rank == "measured"
                else modeled_epoch_cost(prof, strat, caps, model=model))
        score = (e * cost) if e is not None else math.inf
        rows.append(RankedConfig(
            strategy=strat, score=score, epochs_to_target=e, epoch_cost=cost,
            best_step=t.best_step, stat_penalty=0.0, hw_advantage=0.0,
            measured_time_per_epoch_s=res.time_per_epoch,
            measured_time_to_target_s=res.time_to(target),
            final_loss=res.final_loss,
        ))

    best_epochs = min((r.epochs_to_target for r in rows
                       if r.epochs_to_target is not None), default=None)
    min_cost = min(r.epoch_cost for r in rows)
    for r in rows:
        if best_epochs is not None and r.epochs_to_target is not None:
            r.stat_penalty = r.epochs_to_target / max(best_epochs, 1)
        else:
            r.stat_penalty = math.inf
        r.hw_advantage = min_cost / r.epoch_cost

    # deterministic total order: score, then final loss, then name
    rows.sort(key=lambda r: (r.score, r.final_loss, r.name))
    return Recommendation(dataset=prof.name, task=task, target=target,
                          rank_by=rank, ranked=rows)
