"""Process-local metrics registry: counters, gauges, histograms.

The port's own copy of the reference package's registry.  Complement to
:mod:`repro_torch.obs.trace`: spans answer *where did the time
go*, metrics answer *how often did things happen* — cache hit ratios,
backend-fallback counts, queue depths.  The registry is always live
(an increment is a dict lookup + add under a lock — cheap enough for
cache-lookup call sites), but it is only ever *persisted* as a sidecar
file next to the trace files, and **never** into the deterministic
``BENCH_*.json`` snapshots: metric values are run-dependent by nature.

Histograms use **fixed bucket edges chosen at creation** (default: the
decades from 1µs to 100s, a wall-clock scale) so two runs — or two
processes — produce structurally identical, mergeable snapshots;
edges are part of the snapshot and re-registration with different edges
is an error rather than a silent reshape.

Sidecar: when metrics persistence is enabled (``REPRO_METRICS=1`` on
its own — monitor mode without span-tracing overhead — or implied by
``REPRO_TRACE=1``), the snapshot is written to
``<trace dir>/metrics-<tag>-torch-<pid>.json`` (schema-stamped; the
``-torch`` keeps it apart from the reference's sidecar in a process that
runs both): once at process exit, and *best-effort during the run* via
:func:`flush` — a rate-limited atomic rewrite (tmp + rename), so the
file is always a complete, readable snapshot and a killed process keeps
its partial metrics, mirroring ``trace.py``'s closed-span durability.
Call sites that mark durability points call ``flush()``; everyone else
relies on the ``atexit`` write.
The reference's report CLI sums counters across sidecars and ``--check``
validates their schema.
"""
from __future__ import annotations

import atexit
import bisect
import json
import os
import threading
import time
from pathlib import Path

from repro_torch.obs import trace

#: bump when the sidecar layout changes incompatibly
METRICS_SCHEMA = 1

ENV_METRICS = "REPRO_METRICS"

#: floor between two best-effort flushes (seconds); keeps hot call
#: sites from turning the sidecar into an I/O hot loop
FLUSH_MIN_INTERVAL_S = 0.25

#: default histogram edges: decades of seconds from 1µs to 100s
DEFAULT_EDGES = tuple(10.0 ** e for e in range(-6, 3))


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self.value += n


class Gauge:
    """Last-write-wins scalar (queue depth, stack size, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self.value = float(v)


class Histogram:
    """Fixed-edge histogram; bucket ``i`` counts values <= ``edges[i]``
    (the last bucket is the +inf overflow)."""

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, edges: tuple[float, ...] = DEFAULT_EDGES):
        if list(edges) != sorted(edges) or len(edges) < 1:
            raise ValueError(f"histogram edges must be sorted, non-empty: "
                             f"{edges!r}")
        self.name = name
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.counts[bisect.bisect_left(self.edges, v)] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)


_LOCK = threading.Lock()
_REGISTRY: dict[str, Counter | Gauge | Histogram] = {}


def _get(name: str, cls, *args):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = cls(name, *args)
            _REGISTRY[name] = m
    if not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {cls.__name__}")
    return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str, edges: tuple[float, ...] = DEFAULT_EDGES) -> Histogram:
    h = _get(name, Histogram, edges)
    if h.edges != tuple(float(e) for e in edges):
        raise ValueError(f"histogram {name!r} already registered with edges "
                         f"{h.edges}, not {edges}")
    return h


def reset() -> None:
    """Drop every registered metric (tests)."""
    with _LOCK:
        _REGISTRY.clear()


def snapshot() -> dict:
    """Deterministically ordered view of every registered metric."""
    with _LOCK:
        items = sorted(_REGISTRY.items())
    out: dict = {"schema": METRICS_SCHEMA, "counters": {}, "gauges": {},
                 "histograms": {}}
    for name, m in items:
        if isinstance(m, Counter):
            out["counters"][name] = m.value
        elif isinstance(m, Gauge):
            out["gauges"][name] = m.value
        else:
            out["histograms"][name] = {
                "edges": list(m.edges), "counts": list(m.counts),
                "count": m.count, "sum": m.sum, "min": m.min, "max": m.max,
            }
    return out


def enabled() -> bool:
    """Whether the sidecar is persisted: ``REPRO_METRICS=1`` alone, or
    implied by tracing.  The registry itself is always live; with both
    off the only cost anywhere is this env lookup on flush paths (the
    increment fast path never checks)."""
    return os.environ.get(ENV_METRICS) == "1" or trace.enabled()


def sidecar_path() -> Path | None:
    """This process's sidecar file (None when persistence is disabled).

    Tracing pins the directory; metrics-only mode reads the same
    ``REPRO_TRACE_DIR`` convention so both signals land side by side.
    """
    root = trace.current_dir()
    if root is None:
        if not enabled():
            return None
        root = Path(os.environ.get(trace.ENV_TRACE_DIR)
                    or trace.DEFAULT_TRACE_DIR)
    tag = os.environ.get(trace.ENV_TRACE_TAG) or trace.DEFAULT_TAG
    return root / f"metrics-{tag}-torch-{os.getpid()}.json"


def write_sidecar(path: str | Path | None = None) -> Path | None:
    """Write the snapshot sidecar (explicit path, or the default).

    With no path and persistence disabled this is a no-op returning
    None.  The write is atomic (tmp + rename): a reader — or a SIGKILL
    — never sees a half-written file.
    """
    if path is None:
        path = sidecar_path()
        if path is None:
            return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(snapshot(), sort_keys=True, indent=1) + "\n")
    os.replace(tmp, path)
    return path


_last_flush = 0.0


def flush(min_interval_s: float = FLUSH_MIN_INTERVAL_S) -> Path | None:
    """Best-effort mid-run sidecar write, rate-limited and never raising.

    Returns the path written, or None when persistence is disabled, the
    floor hasn't elapsed, or the write failed (telemetry must never
    take the instrumented path down).
    """
    global _last_flush
    if not enabled():
        return None
    now = time.monotonic()
    if min_interval_s > 0 and now - _last_flush < min_interval_s:
        return None
    try:
        p = write_sidecar()
    except Exception:
        return None
    if p is not None:
        _last_flush = now
    return p


@atexit.register
def _flush_at_exit() -> None:  # pragma: no cover - exercised via subprocesses
    try:
        if _REGISTRY:
            write_sidecar()
    except Exception:
        pass  # never let telemetry turn a clean exit into a traceback
