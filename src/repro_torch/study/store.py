"""Structured results store — ``BENCH_study.json`` + per-run JSONL log.

The port's copy of the reference's ``study/store.py``.  One divergence on
purpose: every default path lies under ``bench_results/torch/``
(``RESULTS_DIR``, relative to the working directory, which is git-ignored),
never at the repository root, where the reference's committed
``BENCH_*.json`` trajectories live: the port's card timings must not
overwrite the reference's.

``BENCH_study.json`` is the machine-readable perf trajectory of the
repo: every trial a sweep executed (spec + loss curve + epoch timings +
derived metrics) plus the paper-claim verdicts.  The snapshot is
serialized deterministically (sorted keys, canonical floats, no
timestamps), and trial records come from the cache on re-runs — so a
sweep whose claim checks pass re-run from a warm trial cache writes a
byte-identical file, which CI asserts.  (The claims section is the one
input that is *not* cache-derived — a micro-timing-based claim that
flips between runs changes the file, but also fails the sweep loudly
via the driver's non-zero exit, never a silent diff.)

Run-to-run variance (timestamps, cache-hit counts, wall time) lives in
the append-only JSONL sidecar — one summary line per sweep invocation,
preceded by any provenance **events** recorded during the run
(``record_event``): distributed sweeps log one ``sweep_shard`` event
per worker attempt (worker id, trial keys, wall time, requeues) and a
``sweep_merge`` event per cache merge, so the perf trajectory can
attribute wall time to workers.  Events never enter the deterministic
``BENCH_study.json`` snapshot.
"""
from __future__ import annotations

import datetime
import json
from pathlib import Path

from repro_torch.study.spec import SCHEMA_VERSION, TrialSpec, canonical_json

#: where the port's stores write unless told otherwise
RESULTS_DIR = Path("bench_results") / "torch"

#: version stamped on every JSONL sidecar *event* line ("schema" field).
#: Bump when event field semantics change; ``load_events`` refuses lines
#: stamped newer than this reader, and treats unstamped lines as legacy
#: (pre-stamping sidecars stay loadable).
EVENT_SCHEMA = 1


def load_events(path: str | Path, *,
                kinds: tuple[str, ...] | None = None) -> list[dict]:
    """Read + validate the event lines of a JSONL sidecar.

    Returns only *event* records (lines with an ``"event"`` field —
    run-summary lines are skipped), optionally filtered to ``kinds``.
    Raises ``ValueError`` on malformed JSON or an event stamped with a
    schema newer than :data:`EVENT_SCHEMA`; events with no stamp are
    accepted as legacy (schema 0).
    """
    out: list[dict] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from None
            if "event" not in rec:
                continue        # run-summary line
            schema = rec.get("schema", 0)
            if not isinstance(schema, int) or schema > EVENT_SCHEMA:
                raise ValueError(
                    f"{path}:{i}: event schema {schema!r} is newer than "
                    f"this reader ({EVENT_SCHEMA}); upgrade repro_torch.study")
            if kinds is None or rec["event"] in kinds:
                out.append(rec)
    return out


class StudyStore:
    """Accumulates trial results and claim verdicts, then writes them."""

    def __init__(self,
                 json_path: str | Path = RESULTS_DIR / "BENCH_study.json", *,
                 jsonl_path: str | Path | None = None):
        self.json_path = Path(json_path)
        self.jsonl_path = Path(jsonl_path) if jsonl_path is not None else None
        self.trials: dict[str, dict] = {}
        self.claims: dict = {"checked_modules": [], "violations": []}
        self._n_recorded = 0
        self._n_cached = 0
        self._events: list[dict] = []

    # -- accumulation -------------------------------------------------------

    def record_trial(self, trial: TrialSpec, result) -> None:
        self._n_recorded += 1
        self._n_cached += bool(result.cached)
        self.trials[trial.key] = {
            "spec": trial.to_dict(),
            **result.to_dict(),
            "derived": {
                "final_loss": result.final_loss,
                "time_per_epoch_s": result.time_per_epoch,
            },
        }

    def record_event(self, kind: str, **fields) -> None:
        """Queue a provenance event for the JSONL sidecar (never the JSON).

        Worker attribution, shard requeues, cache merges — anything
        that varies run-to-run but explains *how* this sweep executed.
        Events are flushed (and cleared) by ``write``, one JSONL line
        each, before the run-summary line.  Each line is stamped with
        :data:`EVENT_SCHEMA` so :func:`load_events` can validate reads.
        """
        self._events.append({"event": kind, "schema": EVENT_SCHEMA,
                             **fields})

    def record_claims(self, violations: list[str],
                      checked_modules: list[str]) -> None:
        self.claims = {
            "checked_modules": sorted(checked_modules),
            "violations": sorted(violations),
        }

    # -- serialization ------------------------------------------------------

    def snapshot(self) -> dict:
        """Deterministic view: no timestamps, no cache/run metadata."""
        return {
            "schema": SCHEMA_VERSION,
            "trials": dict(sorted(self.trials.items())),
            "claims": self.claims,
        }

    def write(self) -> Path:
        self.json_path.parent.mkdir(parents=True, exist_ok=True)
        self.json_path.write_text(
            json.dumps(self.snapshot(), sort_keys=True, indent=1) + "\n")
        if self.jsonl_path is not None:
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            ts = datetime.datetime.now(datetime.timezone.utc) \
                         .isoformat(timespec="seconds")
            lines = [canonical_json({"ts": ts, **ev}) for ev in self._events]
            lines.append(canonical_json({
                "ts": ts,
                "json_path": str(self.json_path),
                "n_trials": len(self.trials),
                "n_recorded": self._n_recorded,
                "n_cached": self._n_cached,
                "n_events": len(self._events),
                "n_violations": len(self.claims["violations"]),
            }))
            with open(self.jsonl_path, "a") as f:
                f.write("".join(line + "\n" for line in lines))
        self._events = []
        return self.json_path

    @staticmethod
    def load(path: str | Path) -> dict:
        with open(path) as f:
            return json.load(f)


class TrajectoryStore:
    """Shared base of the labeled-entry benchmark stores.

    The study store records *trials* (SGD runs); these siblings record
    labeled measurement entries — one dict per trajectory point — and
    serialize them with the same determinism contract as
    ``BENCH_study.json``: measured values come from an on-disk timing
    cache on re-runs, so a warm re-run writes a byte-identical file (CI
    asserts this per store).  Host-varying comparisons (regression
    gates vs the committed trajectory) stay in the claims layer and
    never enter the snapshot; run-varying events (timing dispersion,
    host notes) go to the JSONL sidecar only.
    """

    DEFAULT_PATH = RESULTS_DIR / "BENCH.json"

    def __init__(self, json_path: str | Path | None = None, *,
                 jsonl_path: str | Path | None = None):
        self.json_path = Path(json_path if json_path is not None
                              else self.DEFAULT_PATH)
        self.jsonl_path = Path(jsonl_path) if jsonl_path is not None else None
        self.entries: dict[str, dict] = {}
        self._n_cached = 0
        self._events: list[dict] = []

    def record_entry(self, label: str, entry: dict, *,
                     cached: bool = False) -> None:
        self._n_cached += bool(cached)
        self.entries[label] = entry

    def record_event(self, kind: str, **fields) -> None:
        """Queue a run-varying event (timing dispersion, host notes) for
        the JSONL sidecar — same contract as ``StudyStore.record_event``:
        flushed by ``write``, never into the deterministic snapshot."""
        self._events.append({"event": kind, "schema": EVENT_SCHEMA,
                             **fields})

    def snapshot(self) -> dict:
        """Deterministic view: no timestamps, no cache/run metadata."""
        return {
            "schema": SCHEMA_VERSION,
            "entries": dict(sorted(self.entries.items())),
        }

    def write(self) -> Path:
        self.json_path.parent.mkdir(parents=True, exist_ok=True)
        self.json_path.write_text(
            json.dumps(self.snapshot(), sort_keys=True, indent=1) + "\n")
        if self.jsonl_path is not None:
            self.jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            ts = datetime.datetime.now(datetime.timezone.utc) \
                         .isoformat(timespec="seconds")
            lines = [canonical_json({"ts": ts, **ev}) for ev in self._events]
            lines.append(canonical_json({
                "ts": ts,
                "json_path": str(self.json_path),
                "n_entries": len(self.entries),
                "n_cached": self._n_cached,
                "n_events": len(self._events),
            }))
            with open(self.jsonl_path, "a") as f:
                f.write("".join(line + "\n" for line in lines))
        self._events = []
        return self.json_path

    @staticmethod
    def load(path: str | Path) -> dict:
        with open(path) as f:
            return json.load(f)


class KernelBenchStore(TrajectoryStore):
    """``BENCH_kernels.json`` — the kernel-level perf trajectory.

    One entry per (family, shape, dtype, block-config variant) with the
    measured wall time, the conformance verdict against the oracle, and
    the analytic roofline annotation.
    """

    DEFAULT_PATH = RESULTS_DIR / "BENCH_kernels.json"


class ServeBenchStore(TrajectoryStore):
    """``BENCH_serve.json`` — the serving-layer perf trajectory.

    One entry per (batch size, sparsity) point of the GLM scoring
    service (``repro_torch.serve.glm``): request-latency quantiles (p50/p99),
    sustained requests/s, the ``glm_score`` conformance verdict at that
    shape, and the roofline annotation of one scoring launch.
    """

    DEFAULT_PATH = RESULTS_DIR / "BENCH_serve.json"


class LiveBenchStore(TrajectoryStore):
    """``BENCH_live.json`` — the live (train-while-serving) trajectory.

    Two cell families per profile (the reference's
    ``benchmarks.bench_live``, whose twin is not ported yet):
    convergence-vs-wall-time points of the online replica-merge learner
    (holdout-loss curve at checkpoints, steps/s, merges) and
    serve-latency-under-training points (request-latency quantiles and
    throughput of the scoring engine while the learner trains and
    publishes concurrently, plus the measured staleness vs the
    publisher's guaranteed bound).
    """

    DEFAULT_PATH = RESULTS_DIR / "BENCH_live.json"
