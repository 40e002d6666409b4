"""Trace-file loading, timeline stitching, Chrome trace-event export.

The port's copy of the reference package's exporter.  A traced port run
leaves one JSONL file per process in the trace dir —
``trace-main-torch-<pid>.jsonl`` for the driver,
``trace-shard<W>a<A>-torch-<pid>.jsonl`` per sweep-worker attempt.  This
module merges them into one timeline:

* each file's spans are aligned onto the wall clock using the meta
  line's ``(t0_unix_ns, t0_perf_ns)`` anchor pair (per-process
  monotonic clocks have arbitrary origins; the anchors calibrate them);
* each file becomes one Chrome "process" row, named by its shard tag,
  so a ``--workers N`` sweep renders as the driver plus N worker lanes
  in a single Perfetto view — dead-worker requeues included, as extra
  ``shard<W>a<A+1>`` lanes;
* span events use the Chrome trace-event ``"ph": "X"`` (complete)
  format with microsecond timestamps, loadable at
  https://ui.perfetto.dev or ``chrome://tracing``.

Directories are globbed for the port's own file names only
(``TRACE_GLOB``, ``METRICS_GLOB``), so a trace dir shared with the
reference package is not read as the port's.

Schema validation happens on *read*: a trace file whose meta line is
missing or stamped with a schema newer than :data:`trace.TRACE_SCHEMA`
raises instead of silently misparsing.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Sequence

from repro_torch.obs import trace as trace_mod

#: the files the port's processes write (``trace.trace_path``,
#: ``metrics.sidecar_path``)
TRACE_GLOB = "trace-*-torch-*.jsonl"
METRICS_GLOB = "metrics-*-torch-*.json"


@dataclasses.dataclass
class FileTrace:
    """One process's parsed trace file."""

    path: Path
    meta: dict
    spans: list[dict]
    instants: list[dict]

    @property
    def tag(self) -> str:
        return self.meta.get("tag", "?")

    @property
    def pid(self) -> int:
        return int(self.meta.get("pid", 0))

    def unix_ns(self, ts_perf: int) -> int:
        """Align one perf_counter_ns stamp onto the wall clock."""
        return (self.meta["t0_unix_ns"]
                + (int(ts_perf) - self.meta["t0_perf_ns"]))


def read_trace(path: str | Path) -> FileTrace:
    """Parse + validate one trace file (raises on schema drift)."""
    path = Path(path)
    meta = None
    spans: list[dict] = []
    instants: list[dict] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON ({e})") from None
            kind = rec.get("kind")
            if kind == "meta":
                schema = rec.get("schema")
                if not isinstance(schema, int) \
                        or schema > trace_mod.TRACE_SCHEMA:
                    raise ValueError(
                        f"{path}:{i}: trace schema {schema!r} is newer than "
                        f"this reader ({trace_mod.TRACE_SCHEMA}); upgrade "
                        f"repro_torch.obs or re-record the trace")
                meta = rec
            elif kind == "span":
                spans.append(rec)
            elif kind == "instant":
                instants.append(rec)
            else:
                raise ValueError(f"{path}:{i}: unknown record kind {kind!r}")
    if meta is None:
        raise ValueError(f"{path}: no meta line (truncated or not a "
                         f"trace file)")
    return FileTrace(path=path, meta=meta, spans=spans, instants=instants)


def collect(paths: Sequence[str | Path]) -> list[FileTrace]:
    """Load every trace file named by ``paths`` (dirs are globbed)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.glob(TRACE_GLOB)))
        elif p.exists():
            files.append(p)
    traces = [read_trace(f) for f in files]
    traces.sort(key=lambda t: (t.tag != trace_mod.DEFAULT_TAG, t.tag, t.pid))
    return traces


def metrics_sidecars(paths: Sequence[str | Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.glob(METRICS_GLOB)))
    return out


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def chrome_events(traces: Sequence[FileTrace]) -> list[dict]:
    """Merge per-process traces into one chrome trace-event list.

    Each file gets a stable small synthetic pid (its rank in the sorted
    file list) so two processes that happened to share an OS pid — or
    the same process traced twice — never interleave; the real pid and
    shard tag go into the process_name metadata row.
    """
    anchors = [t.meta["t0_unix_ns"] for t in traces if t.spans or t.instants]
    base_ns = min((t.unix_ns(min(s["ts"] for s in t.spans + t.instants))
                   for t in traces if t.spans or t.instants),
                  default=min(anchors, default=0))
    events: list[dict] = []
    for rank, t in enumerate(traces, start=1):
        tid_map: dict[int, int] = {}
        events.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": f"{t.tag} (pid {t.pid})"},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": rank, "tid": 0,
            "args": {"sort_index": rank},
        })
        for rec in sorted(t.spans + t.instants, key=lambda r: r["ts"]):
            tid = tid_map.setdefault(rec.get("tid", 0), len(tid_map) + 1)
            ev = {
                "name": rec["name"],
                "cat": rec["name"].split(".", 1)[0],
                "ph": "X" if rec["kind"] == "span" else "i",
                "ts": (t.unix_ns(rec["ts"]) - base_ns) / 1000.0,
                "pid": rank,
                "tid": tid,
                "args": {**rec.get("args", {}), "depth": rec.get("depth", 0)},
            }
            if rec["kind"] == "span":
                ev["dur"] = rec["dur"] / 1000.0
            else:
                ev["s"] = "t"
            events.append(ev)
    return events


def to_chrome(traces: Sequence[FileTrace]) -> dict:
    return {"traceEvents": chrome_events(traces), "displayTimeUnit": "ms"}


def write_chrome(traces: Sequence[FileTrace], out: str | Path) -> Path:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(to_chrome(traces)) + "\n")
    return out


def validate_chrome(doc: dict) -> list[str]:
    """Shape-check an exported document against the trace-event format."""
    bad: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            bad.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            bad.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            bad.append(f"event {i}: missing pid")
        if ph == "M":
            continue
        if not isinstance(ev.get("tid"), int):
            bad.append(f"event {i}: missing tid")
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            bad.append(f"event {i}: bad ts {ev.get('ts')!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            bad.append(f"event {i}: bad dur {ev.get('dur')!r}")
    return bad


# ---------------------------------------------------------------------------
# Per-phase breakdown (self vs children)
# ---------------------------------------------------------------------------


def breakdown(traces: Iterable[FileTrace]) -> dict[str, dict]:
    """Aggregate spans by name: count, total and *self* wall time.

    Self time is a span's duration minus its direct children's — the
    classic profile decomposition, computed per (process, thread) via
    interval containment (spans within one thread nest properly).
    Returns ``{name: {"count", "total_s", "self_s"}}``.  The span dicts
    are read, never written (the reference stores the child time in
    them, so a second call on the same traces counts it twice), so
    every call on the same traces gives the same answer.
    """
    agg: dict[str, dict] = {}
    by_thread: dict[tuple, list[dict]] = {}
    for t in traces:
        for s in t.spans:
            by_thread.setdefault((id(t), s.get("tid", 0)), []).append(s)
    for spans in by_thread.values():
        spans.sort(key=lambda s: (s["ts"], -s["dur"]))
        child_ns = [0] * len(spans)
        stack: list[int] = []
        for i, s in enumerate(spans):
            while stack and s["ts"] >= (spans[stack[-1]]["ts"]
                                        + spans[stack[-1]]["dur"]):
                stack.pop()
            if stack:
                child_ns[stack[-1]] += s["dur"]
            stack.append(i)
        for s, c in zip(spans, child_ns):
            a = agg.setdefault(s["name"],
                               {"count": 0, "total_s": 0.0, "self_s": 0.0})
            a["count"] += 1
            a["total_s"] += s["dur"] / 1e9
            a["self_s"] += (s["dur"] - c) / 1e9
    return agg


def layers(traces: Iterable[FileTrace]) -> tuple[str, ...]:
    """The distinct top-level span categories present (``kernel``,
    ``engine``, ``runner``, ``sweep``, ...)."""
    return tuple(sorted({s["name"].split(".", 1)[0]
                         for t in traces for s in t.spans}))
