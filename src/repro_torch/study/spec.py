"""Declarative experiment specs — the paper's study as frozen data.

The port's copy of the reference's ``study/spec.py``: the same fields and
the same canonical serialization, so ``TrialSpec.key`` and ``stack_key``
equal the reference's letter for letter for the same spec (the port's
strategies carry the reference's fields).  ``DatasetSpec.load`` puts the
data on ``device`` (``cuda`` unless the caller says).

The paper's methodology (§6) is a sweep: {dataset × task} × {update
strategy × replication × access path} with the step size grid-searched
per cell and every cell scored on the three performance axes.  This
module declares that sweep as hashable frozen dataclasses so the runner
can cache, stack, and resume it:

* ``DatasetSpec``   a reproducible dataset: a synthetic Table-3
                    stand-in (profile + size cap + seed), an explicit
                    (n, d) dense shape for scaling studies, or one of
                    the paper's real datasets via ``source="real"``
                    (ingested by ``repro_torch.data.ingest``; its trial keys
                    embed the ingested content hash);
* ``DatasetProfile``the advisor-facing summary (n, d, nnz/example,
                    density) — derivable without materializing the data;
* ``TrialSpec``     one (dataset, task, strategy, step, epochs) cell with
                    a content-hash ``key`` that names its cache entry;
* ``grid``          the cross-product builder.

Strategies (``SyncSGD`` / ``AsyncLocalSGD``, incl. the kernel-backend
axis) serialize through ``strategy_to_dict`` / ``strategy_from_dict`` so
specs round-trip through the JSON store.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Sequence

from repro_torch.core import sgd
from repro_torch.data import ingest, synthetic

#: bump when trial semantics change in a way that invalidates cached results
SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """What the advisor needs to know about a dataset without loading it."""

    name: str
    n: int
    d: int
    avg_nnz: float
    dense: bool

    @property
    def nnz_per_example(self) -> float:
        """Work per example in feature-ops (dense rows touch all of d)."""
        return float(self.d) if self.dense else float(self.avg_nnz)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """A reproducible dataset instance, synthetic or real.

    Table-3 stand-ins: ``DatasetSpec("covtype", max_n=2048)``.  Scaling
    studies (fig24-style) pin an explicit dense shape instead:
    ``DatasetSpec("dense-d", n=1024, d=512)``.  The paper's measured
    datasets load through :mod:`repro_torch.data.ingest` with
    ``source="real"`` (bundled fixture offline, cached full download
    when present); ``split`` then selects the §6.1 train/test partition
    (default ``"train"``).
    """

    name: str
    max_n: int | None = None
    seed: int = 0
    n: int | None = None     # explicit dense shape (overrides the profile)
    d: int | None = None
    source: str = "synthetic"       # "synthetic" | "real"
    split: str | None = None        # real only: "train" | "test" | "all"

    def __post_init__(self):
        if self.source not in ("synthetic", "real"):
            raise ValueError(f"source must be synthetic|real: {self.source!r}")
        if self.source == "real":
            if self.n is not None or self.d is not None:
                raise ValueError("real datasets get their shape from the "
                                 "data; drop the explicit (n, d)")
            ingest.registry.get(self.name)   # raises on unknown names
            if self.split is not None and self.split not in ingest.SPLITS:
                raise ValueError(
                    f"split must be one of {ingest.SPLITS}: {self.split!r}")
            return
        if self.split is not None:
            raise ValueError("split only applies to source='real'")
        if (self.n is None) != (self.d is None):
            raise ValueError("explicit shapes need both n and d")
        if self.n is None and self.name not in synthetic.PAPER_DATASETS:
            raise ValueError(
                f"unknown dataset {self.name!r}; Table-3 names: "
                f"{tuple(synthetic.PAPER_DATASETS)} (or pass explicit n, d)")

    def _ingest_kwargs(self) -> dict:
        return {"split": self.split or "train", "max_n": self.max_n,
                "seed": self.seed}

    def load(self, device=None) -> synthetic.Dataset:
        """The dataset's tensors on ``device`` (``cuda`` unless given)."""
        if self.source == "real":
            return ingest.load(self.name, **self._ingest_kwargs(),
                               device=device)
        if self.n is not None:
            return synthetic.make_dense(self.name, self.n, self.d,
                                        seed=self.seed, device=device)
        return synthetic.paper_dataset(self.name, max_n=self.max_n,
                                       seed=self.seed, device=device)

    def profile(self) -> DatasetProfile:
        if self.source == "real":
            # derived from the parsed data, not the Table-3 stand-in row
            n, d, avg_nnz, dense = ingest.profile(self.name,
                                                  **self._ingest_kwargs())
            return DatasetProfile(self.name, n, d, avg_nnz, dense)
        if self.n is not None:
            return DatasetProfile(self.name, self.n, self.d, float(self.d),
                                  dense=True)
        N, d, avg_nnz, _max_nnz, dense = synthetic.PAPER_DATASETS[self.name]
        n = min(N, self.max_n) if self.max_n is not None else N
        n = max(n, 64)  # paper_dataset's size floor
        return DatasetProfile(self.name, n, d,
                              float(d) if dense else avg_nnz, dense)

    def to_dict(self) -> dict:
        dct = _prune_none(dataclasses.asdict(self))
        if dct.get("source") == "synthetic":   # default: keep keys stable
            del dct["source"]
        return dct

    def cache_key_dict(self) -> dict:
        """``to_dict`` plus, for real data, the ingested content hash.

        Trial-cache keys build on this instead of ``to_dict`` so a
        changed source file (re-fetched dataset, edited fixture)
        invalidates every cached trial computed from the old bytes.
        """
        dct = self.to_dict()
        if self.source == "real":
            dct["content_hash"] = ingest.content_hash(
                self.name, **self._ingest_kwargs())
        return dct

    @classmethod
    def from_dict(cls, dct: dict) -> "DatasetSpec":
        return cls(**dct)


# ---------------------------------------------------------------------------
# Strategy (de)serialization
# ---------------------------------------------------------------------------

_STRATEGY_KINDS = {"sync": sgd.SyncSGD, "async": sgd.AsyncLocalSGD}


def strategy_to_dict(strategy) -> dict:
    for kind, cls in _STRATEGY_KINDS.items():
        if isinstance(strategy, cls):
            return {"kind": kind, **_prune_none(dataclasses.asdict(strategy))}
    raise TypeError(f"not a strategy: {strategy!r}")


def strategy_from_dict(dct: dict):
    dct = dict(dct)
    kind = dct.pop("kind")
    return _STRATEGY_KINDS[kind](**dct)


# ---------------------------------------------------------------------------
# Trials
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One cell of the study: everything needed to reproduce one run."""

    dataset: DatasetSpec
    task: str                       # "lr" | "svm"
    strategy: object                # SyncSGD | AsyncLocalSGD
    step: float
    epochs: int
    seed: int = 0                   # reserved for stochastic strategies

    def to_dict(self) -> dict:
        return {
            "dataset": self.dataset.to_dict(),
            "task": self.task,
            "strategy": strategy_to_dict(self.strategy),
            "step": self.step,
            "epochs": self.epochs,
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, dct: dict) -> "TrialSpec":
        return cls(
            dataset=DatasetSpec.from_dict(dct["dataset"]),
            task=dct["task"],
            strategy=strategy_from_dict(dct["strategy"]),
            step=dct["step"],
            epochs=dct["epochs"],
            seed=dct.get("seed", 0),
        )

    def _key_dict(self) -> dict:
        dct = self.to_dict()
        dct["dataset"] = self.dataset.cache_key_dict()
        return dct

    @property
    def key(self) -> str:
        """Content-hash cache key: same spec ⇒ same key across processes.

        For real datasets the key embeds the ingested matrix's content
        hash, so trials cached against stale bytes never serve a sweep
        over re-fetched data.
        """
        return _digest({"schema": SCHEMA_VERSION, **self._key_dict()})

    @property
    def stack_key(self) -> str:
        """Trials equal here except for ``step`` can run vmap-stacked."""
        dct = self._key_dict()
        dct.pop("step")
        return _digest({"schema": SCHEMA_VERSION, **dct})

    @property
    def sparse_data(self) -> bool:
        return not self.dataset.profile().dense

    def with_step(self, step: float) -> "TrialSpec":
        return dataclasses.replace(self, step=step)

    @property
    def label(self) -> str:
        return (f"{self.dataset.name}/{self.task}/{self.strategy.name}"
                f"@{self.step:g}x{self.epochs}")


def grid(
    datasets: Iterable[DatasetSpec],
    tasks: Sequence[str],
    strategies: Iterable,
    steps: Sequence[float],
    epochs: int,
    *,
    seed: int = 0,
) -> tuple[TrialSpec, ...]:
    """The paper's sweep: dataset × task × strategy × step, fixed epochs.

    Strategies whose replica count exceeds half the dataset size are
    dropped (a partition needs ≥ 2 examples), mirroring the benchmark
    modules' guard.
    """
    out = []
    for ds in datasets:
        n = ds.profile().n
        for task in tasks:
            for strat in strategies:
                replicas = getattr(strat, "replicas", 1)
                if n < replicas * 2:
                    continue
                for step in steps:
                    out.append(TrialSpec(ds, task, strat, step, epochs,
                                         seed=seed))
    return tuple(out)


# ---------------------------------------------------------------------------
# Canonical hashing
# ---------------------------------------------------------------------------


def _prune_none(dct: dict) -> dict:
    return {k: v for k, v in dct.items() if v is not None}


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace drift, repr floats."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _digest(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]
