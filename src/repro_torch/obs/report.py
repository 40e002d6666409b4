"""Trace report CLI: per-phase breakdown, Perfetto export, validation.

    PYTHONPATH=src python -m repro_torch.obs.report [PATHS...]
        [--perfetto OUT.json] [--check] [--json] [--top N]

The port's copy of the reference package's report.  ``PATHS`` are trace
files or directories holding the port's ``trace-*-torch-*.jsonl``
(default: ``$REPRO_TRACE_DIR`` or ``trace/``).  All files merge into one
timeline — the driver plus every sweep-worker shard attempt.

* default output: a per-phase table (count, total, self, mean) sorted
  by total time, plus the layer list and per-worker file inventory;
* ``--json``: the same content as one machine-readable JSON document
  on stdout (files, layers, breakdown, summed counters, instant-event
  counts) — what smoke runs assert on instead of grepping tables;
* ``--perfetto OUT.json`` additionally writes the merged Chrome
  trace-event JSON (load at https://ui.perfetto.dev);
* ``--check`` validates everything instead of (just) reporting: trace
  schema on read, span fields, the exported trace-event shape, and
  metrics-sidecar schemas.  Exit status is the number of problems (1 on
  an invalid trace or when no trace file is found).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from repro_torch.obs import export, metrics, trace


def _default_paths() -> list[str]:
    return [os.environ.get(trace.ENV_TRACE_DIR) or trace.DEFAULT_TRACE_DIR]


def _fmt_s(s: float) -> str:
    if s >= 1.0:
        return f"{s:8.3f}s "
    return f"{1e3 * s:8.2f}ms"


def _print_breakdown(traces, top: int) -> None:
    agg = export.breakdown(traces)
    if not agg:
        print("no spans recorded")
        return
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total_s"])
    name_w = max(len(n) for n, _ in rows[:top])
    print(f"{'span':{name_w}s} {'count':>7s} {'total':>10s} "
          f"{'self':>10s} {'mean':>10s}")
    for name, a in rows[:top]:
        print(f"{name:{name_w}s} {a['count']:7d} {_fmt_s(a['total_s'])} "
              f"{_fmt_s(a['self_s'])} {_fmt_s(a['total_s'] / a['count'])}")
    if len(rows) > top:
        print(f"... {len(rows) - top} more span name(s); --top to widen")


def _print_inventory(traces) -> None:
    print(f"\n{len(traces)} trace file(s); "
          f"layers: {', '.join(export.layers(traces)) or '(none)'}")
    for t in traces:
        span_s = sum(s["dur"] for s in t.spans) / 1e9
        print(f"  {t.tag:12s} pid {t.pid:<8d} {len(t.spans):5d} spans "
              f"{_fmt_s(span_s)}  {t.path}")


def _check_metrics(paths) -> list[str]:
    bad = []
    for p in export.metrics_sidecars(paths):
        try:
            snap = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError) as e:
            bad.append(f"{p}: unreadable metrics sidecar ({e})")
            continue
        schema = snap.get("schema")
        if not isinstance(schema, int) or schema > metrics.METRICS_SCHEMA:
            bad.append(f"{p}: metrics schema {schema!r} newer than reader "
                       f"({metrics.METRICS_SCHEMA})")
    return bad


def _sum_counters(paths) -> tuple[dict[str, int], list[Path]]:
    sums: dict[str, int] = {}
    files = export.metrics_sidecars(paths)
    for p in files:
        try:
            snap = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        for name, v in snap.get("counters", {}).items():
            sums[name] = sums.get(name, 0) + v
    return sums, files


def _print_metrics(paths) -> None:
    sums, files = _sum_counters(paths)
    if sums:
        print(f"\ncounters (summed over {len(files)} sidecar(s)):")
        for name in sorted(sums):
            print(f"  {name:48s} {sums[name]:10d}")


def _json_doc(traces, paths) -> dict:
    """Machine-readable report: everything the tables print, as data."""
    counters, files = _sum_counters(paths)
    instants: dict[str, int] = {}
    for t in traces:
        for rec in t.instants:
            name = rec.get("name", "?")
            instants[name] = instants.get(name, 0) + 1
    return {
        "files": [{"tag": t.tag, "pid": t.pid, "spans": len(t.spans),
                   "instants": len(t.instants),
                   "span_s": sum(s["dur"] for s in t.spans) / 1e9,
                   "path": str(t.path)} for t in traces],
        "layers": list(export.layers(traces)),
        "spans": {name: a for name, a in sorted(export.breakdown(traces)
                                                .items())},
        "instants": dict(sorted(instants.items())),
        "counters": dict(sorted(counters.items())),
        "metrics_files": [str(p) for p in files],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="trace files or dirs (default: $REPRO_TRACE_DIR "
                         "or trace/)")
    ap.add_argument("--perfetto", metavar="OUT.json", default=None,
                    help="write the merged Chrome trace-event JSON here")
    ap.add_argument("--check", action="store_true",
                    help="validate traces + export + metrics sidecars; "
                         "exit status = number of problems")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON document on stdout "
                         "(files, layers, spans, instants, counters)")
    ap.add_argument("--top", type=int, default=24,
                    help="max span names in the breakdown table")
    args = ap.parse_args(argv)
    paths = args.paths or _default_paths()

    try:
        traces = export.collect(paths)
    except ValueError as e:
        print(f"invalid trace: {e}", file=sys.stderr)
        return 1
    if not traces:
        print(f"no trace files under {paths} (run with REPRO_TRACE=1 to "
              f"record; see the PyTorch/H100 port section of README.md)",
              file=sys.stderr)
        return 1

    doc = export.to_chrome(traces)
    if args.perfetto:
        out = export.write_chrome(traces, args.perfetto)
        print(f"wrote {out} ({len(doc['traceEvents'])} events) — "
              f"load at https://ui.perfetto.dev")

    if args.check:
        problems = export.validate_chrome(doc) + _check_metrics(paths)
        n_spans = sum(len(t.spans) for t in traces)
        if problems:
            for p in problems:
                print(f"PROBLEM: {p}", file=sys.stderr)
            return len(problems)
        print(f"OK: {n_spans} spans across {len(traces)} file(s), "
              f"layers: {', '.join(export.layers(traces))}")
        return 0

    if args.json:
        json.dump(_json_doc(traces, paths), sys.stdout, sort_keys=True,
                  indent=1)
        print()
        return 0

    _print_breakdown(traces, args.top)
    _print_inventory(traces)
    _print_metrics(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
