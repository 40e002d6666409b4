"""Structured span tracer — zero overhead unless ``REPRO_TRACE=1``.

The port's own copy of the reference package's tracer: the same
environment variables and the same JSONL schema, so one report reads the
traces of both.  Its files are named ``trace-<tag>-torch-<pid>.jsonl``,
so a process that runs both tracers (the parity tests import both
packages) writes two files and never interleaves two writers in one.

Usage::

    from repro_torch.obs import trace

    with trace.span("runner.trial", key=t.key):
        ...

    @trace.span("study.tune")
    def tune(...): ...

Disabled (the default), ``trace.span`` returns a shared no-op context
manager after a single ``None`` check — no allocation beyond the kwargs
dict at the call site, no I/O, no effect on what runs on the card (spans are
pure host-side bookkeeping).

Enabled (``REPRO_TRACE=1``), every process appends one JSON line per
closed span to its own file
``$REPRO_TRACE_DIR/trace-<tag>-torch-<pid>.jsonl`` (dir default:
``trace/``).  ``tag`` comes from ``$REPRO_TRACE_TAG`` ("main" when
unset).

File format (``TRACE_SCHEMA``):

* line 1 — meta: ``{"kind": "meta", "schema": 1, "pid", "tag",
  "t0_unix_ns", "t0_perf_ns", "argv"}``.  The two anchors let the
  exporter align per-process monotonic clocks onto one wall-clock
  timeline (``unix_ns = t0_unix_ns + (ts - t0_perf_ns)``).
* span lines — ``{"kind": "span", "name", "ts", "dur" (both
  perf_counter_ns), "pid", "tid", "depth", "args"}``.  ``depth`` is the
  thread-local nesting level at entry; spans are written at *exit*, so
  a crashed process keeps every span that finished before the crash.
* instant lines — ``{"kind": "instant", ...}`` with ``dur`` 0.

The reference's ``xprof`` capture (``jax.profiler``) has no counterpart
here yet.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import time
from pathlib import Path

#: bump when the trace line format changes incompatibly
TRACE_SCHEMA = 1

ENV_TRACE = "REPRO_TRACE"
ENV_TRACE_DIR = "REPRO_TRACE_DIR"
ENV_TRACE_TAG = "REPRO_TRACE_TAG"

DEFAULT_TRACE_DIR = "trace"
DEFAULT_TAG = "main"


def trace_path(root: str | Path, tag: str, pid: int) -> Path:
    """The trace file a process with this (root, tag, pid) writes."""
    return Path(root) / f"trace-{tag}-torch-{pid}.jsonl"


class _NoopSpan:
    """Disabled-path singleton: no-op context manager AND decorator."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


NOOP = _NoopSpan()


class _Tracer:
    """One per process: owns the trace file, the clock anchors, nesting."""

    def __init__(self, root: str | Path, tag: str):
        self.root = Path(root)
        self.tag = tag
        self.pid = os.getpid()
        self.t0_unix_ns = time.time_ns()
        self.t0_perf_ns = time.perf_counter_ns()
        self._fh = None
        self._lock = threading.Lock()
        self._tls = threading.local()

    @property
    def path(self) -> Path:
        return trace_path(self.root, self.tag, self.pid)

    # -- nesting (thread-local) ---------------------------------------------

    def push(self) -> int:
        d = getattr(self._tls, "depth", 0)
        self._tls.depth = d + 1
        return d

    def pop(self) -> None:
        self._tls.depth = max(0, getattr(self._tls, "depth", 1) - 1)

    def depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    # -- sink ---------------------------------------------------------------

    def _file(self):
        if self._fh is None:
            self.root.mkdir(parents=True, exist_ok=True)
            fh = open(self.path, "a", buffering=1)
            fh.write(json.dumps({
                "kind": "meta", "schema": TRACE_SCHEMA, "pid": self.pid,
                "tag": self.tag, "t0_unix_ns": self.t0_unix_ns,
                "t0_perf_ns": self.t0_perf_ns,
                "argv": sys.argv[:4],
            }, sort_keys=True) + "\n")
            self._fh = fh
            atexit.register(self.close)
        return self._fh

    def emit(self, kind: str, name: str, ts: int, dur: int, depth: int,
             attrs: dict) -> None:
        if os.getpid() != self.pid:
            return  # forked child: its spans belong to a tracer it never made
        rec = {"kind": kind, "name": name, "ts": ts, "dur": dur,
               "pid": self.pid, "tid": threading.get_ident(),
               "depth": depth}
        if attrs:
            rec["args"] = attrs
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        with self._lock:
            self._file().write(line)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class _Span:
    """Enabled-path span: times the ``with`` body, emits at exit."""

    __slots__ = ("_t", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: _Tracer, name: str, attrs: dict):
        self._t = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._depth = self._t.push()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc):
        dur = time.perf_counter_ns() - self._t0
        self._t.pop()
        attrs = self.attrs
        if exc_type is not None:
            attrs = {**attrs, "error": exc_type.__name__}
        self._t.emit("span", self.name, self._t0, dur, self._depth, attrs)
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with span(name, **attrs):
                return fn(*a, **k)

        return wrapped


_TRACER: _Tracer | None = None


def refresh() -> None:
    """(Re-)read the ``REPRO_TRACE*`` env vars and swap the tracer.

    Processes pick the config up at import; tests (and anything that
    mutates the env mid-process) call this to apply a change.
    """
    global _TRACER
    if os.environ.get(ENV_TRACE) == "1":
        root = os.environ.get(ENV_TRACE_DIR) or DEFAULT_TRACE_DIR
        tag = os.environ.get(ENV_TRACE_TAG) or DEFAULT_TAG
        cur = _TRACER
        if (cur is None or cur.pid != os.getpid()
                or (str(cur.root), cur.tag) != (str(Path(root)), tag)):
            if cur is not None:
                cur.close()
            _TRACER = _Tracer(root, tag)
    else:
        if _TRACER is not None:
            _TRACER.close()
        _TRACER = None


refresh()


def enabled() -> bool:
    return _TRACER is not None


def current_path() -> Path | None:
    """This process's trace file (None when tracing is disabled)."""
    return _TRACER.path if _TRACER is not None else None


def current_dir() -> Path | None:
    return _TRACER.root if _TRACER is not None else None


def span(name: str, **attrs):
    """A span named ``name`` — context manager or decorator.

    Disabled, returns the shared no-op immediately (the fast path the
    overhead test gates).  ``attrs`` must be JSON-friendly scalars;
    anything else is stringified.
    """
    t = _TRACER
    if t is None:
        return NOOP
    return _Span(t, name, attrs)


def instant(name: str, **attrs) -> None:
    """A zero-duration marker event (rendered as an arrow in Perfetto)."""
    t = _TRACER
    if t is None:
        return
    t.emit("instant", name, time.perf_counter_ns(), 0, t.depth(), attrs)
