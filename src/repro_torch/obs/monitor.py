"""Runtime health monitor: sliding-window SLOs over the serve+live stack.

The metrics sidecars are *post-hoc*: written at exit and read after the
run.  Once the stack serves while it trains (``serve.glm`` +
``repro_torch.live``), health has to be visible **while the system runs** —
the operational counterpart of the paper's three measures:

* hardware efficiency  -> windowed request p50/p99 + rps + batch fill;
* statistical efficiency -> an EWMA drift watch on the holdout-loss
  curve (divergence / plateau flags);
* time-to-convergence coupling -> snapshot staleness vs the
  publisher's guaranteed ``bound_steps`` ceiling.

:class:`HealthMonitor` maintains deterministic sliding windows over the
existing :mod:`repro_torch.obs.metrics` primitives: a bounded fixed-edge
:class:`repro_torch.obs.digest.QuantileDigest` per window (plus a cumulative
one), scalar accumulators for throughput/queue-depth/fill/staleness,
and the loss EWMA pair.  On every window roll the declarative
:class:`SLOSpec` predicates evaluate against the closed window's
sample; each breach increments ``slo.breach.<name>`` (plus the
``slo.breaches`` total) in the metrics registry and emits an
``slo.breach`` instant event into the trace, so breaches land on the
same stitched Perfetto timeline as the ``serve.*`` / ``live.*`` spans
that caused them.  Rolls also best-effort-flush the metrics sidecar
(:func:`repro_torch.obs.metrics.flush`), so a chaos-killed process keeps its
partial health state — the metrics mirror of ``trace.py``'s
closed-span durability.

Hook points (all duck-typed — this module imports only obs siblings):

* ``monitor.attach_engine(engine)`` — ``GLMScoreEngine.flush`` reports
  per-batch latencies, rows, queue depth, and fill;
* ``monitor.watch_live(learner, publisher)`` — ``LiveLearner.step``
  reports per-step snapshot staleness against the publisher's bound
  captured at attach time; ``SnapshotPublisher`` reports publishes;
* ``monitor.observe_loss(v)`` — whoever evaluates holdout loss (the
  live benchmark, a serving-side canary) feeds the drift watch.

The CLI tails the sidecars a monitored run leaves behind::

    PYTHONPATH=src python -m repro_torch.obs.monitor [DIRS] [--check] [--json]

renders the per-process health table (windows, breach counters, last
health gauges) and with ``--check`` exits nonzero per breach.
Everything here is sidecar-only: a monitored
benchmark run writes byte-identical ``BENCH_*.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

from repro_torch.obs import metrics, trace
from repro_torch.obs.digest import LATENCY_EDGES, QuantileDigest

#: metric-name prefixes the monitor owns inside the metrics registry
HEALTH_PREFIX = "health."
BREACH_PREFIX = "slo.breach."


# ---------------------------------------------------------------------------
# SLO predicates
# ---------------------------------------------------------------------------

_OPS: dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
}


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative service-level objective.

    ``metric`` names a field of the per-window health sample (see
    :meth:`HealthMonitor.roll`); ``op`` compares the observed value
    against ``threshold`` and the SLO *holds* when the comparison is
    true.  A window whose sample has no value for ``metric`` (e.g.
    staleness with no publisher attached) is skipped, not breached.
    """

    name: str
    metric: str
    op: str                     # "<=" or ">="
    threshold: float
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"SLOSpec op must be one of {sorted(_OPS)}: "
                             f"{self.op!r}")

    def holds(self, value: float) -> bool:
        return _OPS[self.op](float(value), self.threshold)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: serve-path defaults: the reference's generous ceilings, orders of
#: magnitude above a scoring flush, so only real faults trip
DEFAULT_SERVE_SLOS = (
    SLOSpec("latency_p99", "p99_s", "<=", 0.5,
            "windowed request p99 stays under half a second"),
    SLOSpec("throughput", "rps", ">=", 1.0,
            "the engine keeps scoring at least one request per second"),
)

#: serve+live defaults: the serve pair plus the statistical-efficiency
#: and staleness watchdogs of the train-while-serving loop
DEFAULT_LIVE_SLOS = DEFAULT_SERVE_SLOS + (
    SLOSpec("staleness", "staleness_ratio", "<=", 1.0,
            "served snapshot never lags past the publisher's bound"),
    SLOSpec("loss_divergence", "loss_diverging", "<=", 0.0,
            "the holdout-loss EWMA watch does not flag divergence"),
)


# ---------------------------------------------------------------------------
# EWMA drift watch (statistical efficiency)
# ---------------------------------------------------------------------------


class EWMADrift:
    """Fast-vs-slow EWMA watch over the holdout-loss curve.

    Divergence: the fast average exceeds the slow one by ``tol``
    (relative) for ``patience`` consecutive observations — the loss is
    *rising* against its own recent history — or any observation is
    non-finite (the unambiguous blow-up).  Plateau: the two averages
    agree within ``plateau_eps`` (relative) for ``plateau_patience``
    observations — progress has stalled.  Plateau is an informational
    flag (a converged model plateaus legitimately); divergence is what
    the default live SLO set turns into a breach.
    """

    def __init__(self, *, alpha_fast: float = 0.5, alpha_slow: float = 0.1,
                 tol: float = 0.25, patience: int = 2,
                 plateau_eps: float = 1e-3, plateau_patience: int = 3):
        if not 0 < alpha_slow < alpha_fast <= 1:
            raise ValueError(
                f"need 0 < alpha_slow < alpha_fast <= 1: "
                f"{alpha_slow}, {alpha_fast}")
        self.alpha_fast = alpha_fast
        self.alpha_slow = alpha_slow
        self.tol = tol
        self.patience = patience
        self.plateau_eps = plateau_eps
        self.plateau_patience = plateau_patience
        self.fast: float | None = None
        self.slow: float | None = None
        self.last: float | None = None
        self.n = 0
        self._rising = 0
        self._flat = 0
        self._blown = False

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.last = v
        if not math.isfinite(v):
            self._blown = True
            return
        if self.fast is None or self.slow is None:
            self.fast = self.slow = v
            return
        self.fast = self.alpha_fast * v + (1 - self.alpha_fast) * self.fast
        self.slow = self.alpha_slow * v + (1 - self.alpha_slow) * self.slow
        scale = max(abs(self.slow), 1e-12)
        if (self.fast - self.slow) > self.tol * scale:
            self._rising += 1
        else:
            self._rising = 0
        if abs(self.fast - self.slow) < self.plateau_eps * scale:
            self._flat += 1
        else:
            self._flat = 0

    @property
    def diverging(self) -> bool:
        return self._blown or self._rising >= self.patience

    @property
    def plateaued(self) -> bool:
        return not self._blown and self._flat >= self.plateau_patience

    @property
    def status(self) -> str:
        if self.diverging:
            return "diverging"
        if self.plateaued:
            return "plateau"
        return "ok"


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


class HealthMonitor:
    """Sliding-window health over the serve+live stack (module docstring).

    Thread-safe: ``GLMScoreEngine.flush`` may report from any number of
    consumer threads while the learner thread reports staleness.  The
    window state lives behind one lock; breach emission (metrics
    counters, trace instants, sidecar flush) happens outside it.

    ``window_s`` is the roll period checked lazily on every hook call
    (``clock`` is injectable so tests pin window boundaries without
    sleeping); :meth:`roll` forces a roll at natural boundaries (end of
    a benchmark cell).  An empty window — no scoring, no loss, no
    staleness observation — rolls as a no-op rather than evaluating
    SLOs against vacuous zeros, so idle periods never fabricate
    throughput breaches.  ``history`` keeps the last ``max_windows``
    samples (bounded, like everything else here).
    """

    def __init__(self, slos: Sequence[SLOSpec] = DEFAULT_SERVE_SLOS, *,
                 window_s: float = 1.0,
                 edges: tuple[float, ...] = LATENCY_EDGES,
                 drift: EWMADrift | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_windows: int = 256):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0: {window_s}")
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.slos = tuple(slos)
        self.window_s = window_s
        self.edges = tuple(edges)
        self.drift = drift if drift is not None else EWMADrift()
        self.max_windows = max_windows
        self._clock = clock
        self._lock = threading.Lock()
        self.cumulative = QuantileDigest(self.edges)
        self.history: list[dict] = []
        self.windows = 0
        self.breaches: dict[str, int] = {}
        self._staleness_bound: int | None = None
        self._pub = None
        self._pending: tuple[dict, list] | None = None
        self._reset_window(self._clock())

    # -- window state (callers hold self._lock) ------------------------------

    def _reset_window(self, now: float) -> None:
        self._w_start = now
        self._w_digest = QuantileDigest(self.edges)
        self._w_scored = 0
        self._w_rejected = 0
        self._w_flushes = 0
        self._w_fill_sum = 0.0
        self._w_queue_max: int | None = None
        self._w_staleness_max: int | None = None
        self._w_loss_seen = False
        self._w_publishes = 0

    def _window_empty(self) -> bool:
        return not (self._w_flushes or self._w_rejected or self._w_loss_seen
                    or self._w_staleness_max is not None
                    or self._w_publishes)

    # -- hook points ---------------------------------------------------------

    def attach_engine(self, engine) -> "HealthMonitor":
        """Watch a ``GLMScoreEngine``: its ``flush`` reports here."""
        engine.monitor = self
        return self

    def watch_live(self, learner, publisher) -> "HealthMonitor":
        """Watch a learner/publisher pair: per-step staleness against
        the publisher's bound as captured *now* (a later fault that
        stops publishing cannot quietly relax the ceiling)."""
        with self._lock:
            self._staleness_bound = publisher.bound_steps(
                learner.config.merge_every)
            self._pub = publisher
        learner.monitor = self
        publisher.monitor = self
        return self

    def on_flush(self, *, n: int, padded: int, queue_depth: int,
                 latencies: Sequence[float]) -> None:
        """One scored micro-batch (called by the engine, any thread)."""
        with self._lock:
            self._maybe_roll_locked()
            for v in latencies:
                self._w_digest.observe(v)
                self.cumulative.observe(v)
            self._w_scored += n
            self._w_flushes += 1
            self._w_fill_sum += n / max(padded, 1)
            self._w_queue_max = queue_depth if self._w_queue_max is None \
                else max(self._w_queue_max, queue_depth)
        self._emit_pending()

    def on_reject(self) -> None:
        """One shed request (bounded-FIFO backpressure)."""
        with self._lock:
            self._maybe_roll_locked()
            self._w_rejected += 1
        self._emit_pending()

    def on_learner_step(self, learner) -> None:
        """One live-learner step: sample published-snapshot staleness."""
        pub = self._pub
        if pub is None:
            return
        lag = pub.staleness(learner)
        if lag is None:
            return
        with self._lock:
            self._maybe_roll_locked()
            self._w_staleness_max = lag if self._w_staleness_max is None \
                else max(self._w_staleness_max, lag)
        self._emit_pending()

    def on_publish(self, *, version: int, step: int) -> None:
        """One snapshot publish (called by the publisher)."""
        with self._lock:
            self._maybe_roll_locked()
            self._w_publishes += 1
        self._emit_pending()

    def observe_loss(self, v: float) -> None:
        """One holdout-loss evaluation of the served/merged model."""
        with self._lock:
            self._maybe_roll_locked()
            self.drift.observe(v)
            self._w_loss_seen = True
        self._emit_pending()

    # -- rolling -------------------------------------------------------------

    def _maybe_roll_locked(self) -> None:
        if self._clock() - self._w_start >= self.window_s:
            self._roll_locked()

    def _roll_locked(self) -> None:
        now = self._clock()
        if self._window_empty():
            self._w_start = now         # idle: slide, evaluate nothing
            return
        dur = max(now - self._w_start, 1e-9)
        d = self._w_digest
        sample: dict = {
            "window": self.windows,
            "dur_s": dur,
            "n_scored": self._w_scored,
            "rps": self._w_scored / dur if self._w_flushes else None,
            "p50_s": d.quantile(0.5),
            "p99_s": d.quantile(0.99),
            "rejected": self._w_rejected,
            "flushes": self._w_flushes,
            "batch_fill": (self._w_fill_sum / self._w_flushes
                           if self._w_flushes else None),
            "queue_depth": self._w_queue_max,
            "publishes": self._w_publishes,
            "staleness_steps": self._w_staleness_max,
            "staleness_bound": self._staleness_bound,
            "staleness_ratio": (
                self._w_staleness_max / self._staleness_bound
                if self._w_staleness_max is not None
                and self._staleness_bound else None),
            "loss": self.drift.last if self.drift.n else None,
            "loss_fast": self.drift.fast,
            "loss_slow": self.drift.slow,
            "loss_diverging": (float(self.drift.diverging)
                               if self.drift.n else None),
            "loss_plateau": (float(self.drift.plateaued)
                             if self.drift.n else None),
            "loss_status": self.drift.status if self.drift.n else None,
        }
        breached: list[tuple[SLOSpec, float]] = []
        evaluated = 0
        for slo in self.slos:
            value = sample.get(slo.metric)
            if value is None:
                continue
            evaluated += 1
            if not slo.holds(value):
                breached.append((slo, float(value)))
                self.breaches[slo.name] = self.breaches.get(slo.name, 0) + 1
        sample["breaches"] = [s.name for s, _ in breached]
        sample["evaluated"] = evaluated
        self.windows += 1
        self.history.append(sample)
        if len(self.history) > self.max_windows:
            del self.history[:len(self.history) - self.max_windows]
        self._pending = (sample, breached)
        self._reset_window(now)

    def _emit_pending(self) -> None:
        """Publish the last closed window outside the monitor lock (the
        swap is under the lock, so racing hook threads emit it once)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        sample, breached = pending
        metrics.counter("slo.windows").inc()
        metrics.counter("slo.evaluations").inc(sample["evaluated"])
        for key in ("p50_s", "p99_s", "rps", "batch_fill", "queue_depth",
                    "staleness_steps", "staleness_bound", "loss",
                    "loss_fast", "loss_slow", "loss_diverging",
                    "loss_plateau"):
            v = sample.get(key)
            if v is not None:
                metrics.gauge(HEALTH_PREFIX + key).set(float(v))
        for slo, value in breached:
            metrics.counter("slo.breaches").inc()
            metrics.counter(BREACH_PREFIX + slo.name).inc()
            trace.instant("slo.breach", slo=slo.name, metric=slo.metric,
                          value=value, op=slo.op, threshold=slo.threshold,
                          window=sample["window"])
        metrics.flush()                  # best-effort sidecar durability

    def roll(self) -> dict | None:
        """Force-close the current window; returns its sample (None when
        the window was empty)."""
        with self._lock:
            before = self.windows
            self._roll_locked()
            sample = self.history[-1] if self.windows > before else None
        self._emit_pending()
        return sample

    # -- read-out ------------------------------------------------------------

    @property
    def total_breaches(self) -> int:
        return sum(self.breaches.values())

    def summary(self) -> dict:
        with self._lock:
            return {
                "windows": self.windows,
                "breaches": dict(sorted(self.breaches.items())),
                "total_breaches": self.total_breaches,
                "slos": [s.to_dict() for s in self.slos],
                "cumulative": {
                    "count": self.cumulative.count,
                    "p50_s": self.cumulative.quantile(0.5),
                    "p99_s": self.cumulative.quantile(0.99),
                },
                "loss_status": self.drift.status if self.drift.n else None,
                "last": self.history[-1] if self.history else None,
            }

    def table(self) -> str:
        """The health table (one row per rolled window)."""
        rows = [f"{'win':>4s} {'scored':>7s} {'rps':>9s} {'p50':>9s} "
                f"{'p99':>9s} {'fill':>5s} {'qmax':>5s} {'stale':>6s} "
                f"{'loss':>10s} {'status':10s} breaches"]
        for s in self.history:
            rows.append(
                f"{s['window']:4d} {s['n_scored']:7d} "
                f"{_fmt(s['rps'], '9.1f')} {_fmt_lat(s['p50_s'])} "
                f"{_fmt_lat(s['p99_s'])} {_fmt(s['batch_fill'], '5.2f')} "
                f"{_fmt(s['queue_depth'], '5.0f')} "
                f"{_fmt(s['staleness_steps'], '6.0f')} "
                f"{_fmt(s['loss'], '10.3f')} "
                f"{(s['loss_status'] or '-'):10s} "
                f"{','.join(s['breaches']) or '-'}")
        return "\n".join(rows)


def _fmt(v, spec: str) -> str:
    width = int(spec.split(".")[0])
    return f"{v:{spec}}" if v is not None else " " * (width - 1) + "-"


def _fmt_lat(v) -> str:
    if v is None:
        return "        -"
    return f"{v:9.3f}s" if v >= 1.0 else f"{1e3 * v:8.2f}ms"


# ---------------------------------------------------------------------------
# CLI: tail the sidecars of a monitored run
# ---------------------------------------------------------------------------


#: the files the port's processes write (``metrics.sidecar_path``,
#: ``trace.trace_path``)
METRICS_GLOB = "metrics-*-torch-*.json"
TRACE_GLOB = "trace-*-torch-*.jsonl"


def _files(paths: Sequence[str], pattern: str) -> list[Path]:
    return [f for p in map(Path, paths) if p.is_dir()
            for f in sorted(p.glob(pattern))]


def _read_sidecars(paths: Sequence[str]) -> list[dict]:
    """Per-sidecar health views: tag, breach counters, health gauges."""
    out = []
    for p in _files(paths, METRICS_GLOB):
        try:
            snap = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError) as e:
            out.append({"path": str(p), "error": str(e)})
            continue
        counters = snap.get("counters", {})
        out.append({
            "path": str(p),
            "tag": p.stem[len("metrics-"):],
            "windows": counters.get("slo.windows", 0),
            "breaches": {k[len(BREACH_PREFIX):]: v
                         for k, v in sorted(counters.items())
                         if k.startswith(BREACH_PREFIX)},
            "health": {k[len(HEALTH_PREFIX):]: v
                       for k, v in sorted(snap.get("gauges", {}).items())
                       if k.startswith(HEALTH_PREFIX)},
        })
    return out


def _breach_instants(paths: Sequence[str]) -> int:
    """slo.breach instant events across every trace file under paths (a
    line a process was writing when it died is skipped)."""
    n = 0
    for p in _files(paths, TRACE_GLOB):
        with open(p) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                n += (rec.get("kind") == "instant"
                      and rec.get("name") == "slo.breach")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.monitor",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="sidecar dirs (default: $REPRO_TRACE_DIR or trace/)")
    ap.add_argument("--check", action="store_true",
                    help="exit status = total SLO breaches recorded "
                         "(nonzero also when no sidecars are found)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output for scripted checks")
    args = ap.parse_args(argv)
    paths = args.paths or [os.environ.get(trace.ENV_TRACE_DIR)
                           or trace.DEFAULT_TRACE_DIR]

    files = _read_sidecars(paths)
    total = sum(sum(f.get("breaches", {}).values()) for f in files)
    by_name: dict[str, int] = {}
    for f in files:
        for name, n in f.get("breaches", {}).items():
            by_name[name] = by_name.get(name, 0) + n
    doc = {
        "files": files,
        "windows": sum(f.get("windows", 0) for f in files),
        "breaches": dict(sorted(by_name.items())),
        "total_breaches": total,
        "trace_breach_events": _breach_instants(paths),
    }

    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        if not files:
            print(f"no metrics sidecars under {paths} (run with "
                  f"REPRO_METRICS=1 or REPRO_TRACE=1 and a HealthMonitor "
                  f"attached)", file=sys.stderr)
        for f in files:
            if "error" in f:
                print(f"{f['path']}: unreadable ({f['error']})",
                      file=sys.stderr)
                continue
            h = f["health"]
            print(f"{f['tag']:16s} windows={f['windows']:<4d} "
                  f"p50={_fmt_lat(h.get('p50_s')).strip():>9s} "
                  f"p99={_fmt_lat(h.get('p99_s')).strip():>9s} "
                  f"rps={_fmt(h.get('rps'), '9.1f').strip():>9s} "
                  f"stale={_fmt(h.get('staleness_steps'), '4.0f').strip():>4s}"
                  f" breaches={sum(f['breaches'].values())}")
            for name, n in f["breaches"].items():
                print(f"  BREACH {name:24s} x{n}")
        print(f"{len(files)} sidecar(s), {doc['windows']} window(s), "
              f"{total} breach(es), "
              f"{doc['trace_breach_events']} slo.breach trace event(s)")

    if args.check:
        return total if files else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
