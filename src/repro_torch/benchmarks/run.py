"""Benchmark driver for the port: one module per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--profile ci|paper]
        [--only mod1,mod2] [--real] [--device cuda|cpu]
        [--out-json bench_results/torch/BENCH_study.json]

The port's twin of the reference's ``benchmarks/run.py``.  ``--only``
accepts unambiguous prefixes (``--only table4`` runs ``table4_sync``).
``--real`` sweeps the bundled real-data fixtures
(``repro_torch.data.ingest``) instead of the synthetic Table-3 stand-ins.
``--device`` picks where the trials run (``cuda`` by default; ``cpu``
runs every kernel family's plain version).  The reference's ``--workers``
is absent until the port has a ``sweep`` package.

Emits CSVs into bench_results/torch/ and prints a summary, then validates
the paper's qualitative claims (``repro_torch.study.claims``) against the
measured rows (exit 1 on violation).  Every trial is recorded into the
structured results file (``--out-json``) plus an append-only JSONL run
log; trials are cached under bench_results/torch/study_cache/.  Nothing
here reads or writes the reference's ``BENCH_study.json`` or
``bench_results/study_cache``.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.benchmarks import (common, fig8_access_path,
                                    fig11_model_replication,
                                    fig14_data_replication,
                                    fig22_sync_vs_async, fig24_scale,
                                    table4_sync, table6_optimal, table7_async)
from repro_torch.obs import trace
from repro_torch.study import claims
from repro_torch.study.runner import Runner
from repro_torch.study.store import StudyStore

MODULES = {
    "table4_sync": table4_sync,
    "table6_optimal": table6_optimal,
    "table7_async": table7_async,
    "fig8_access_path": fig8_access_path,
    "fig11_model_replication": fig11_model_replication,
    "fig14_data_replication": fig14_data_replication,
    "fig22_sync_vs_async": fig22_sync_vs_async,
    "fig24_scale": fig24_scale,
}


def _resolve_module(name: str) -> str | list[str]:
    """Exact module name, or an unambiguous prefix of one.

    Returns the resolved name, or the (possibly empty) list of
    colliding candidates so the caller can report ambiguity vs unknown.
    """
    if name in MODULES:
        return name
    hits = [m for m in MODULES if m.startswith(name)]
    return hits[0] if len(hits) == 1 else hits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="ci", choices=list(common.PROFILES))
    ap.add_argument("--only", default=None,
                    help="comma-separated module names or unambiguous "
                         "prefixes (default: all)")
    ap.add_argument("--real", action="store_true",
                    help="sweep real datasets (repro_torch.data.ingest) "
                         "instead of the synthetic Table-3 stand-ins")
    ap.add_argument("--device", default="cuda",
                    help="where the trials run (cpu: the plain versions)")
    ap.add_argument("--out-json",
                    default=str(common.RESULTS_DIR / "BENCH_study.json"),
                    help="structured results path (repro_torch.study.store)")
    args = ap.parse_args(argv)

    if args.real:
        common.set_source("real")

    selected = list(MODULES)
    if args.only:
        asked = [s.strip() for s in args.only.split(",") if s.strip()]
        resolved = {s: _resolve_module(s) for s in asked}
        for s, m in resolved.items():
            if isinstance(m, list):
                if m:
                    ap.error(f"ambiguous module prefix {s!r}: matches {m}")
                ap.error(f"unknown module {s!r}; known: {list(MODULES)}")
        selected = [resolved[s] for s in asked]

    store = StudyStore(args.out_json,
                       jsonl_path=common.RESULTS_DIR / "study_runs.jsonl")
    common.RUNNER = Runner(cache_dir=common.RESULTS_DIR / "study_cache",
                           store=store, device=args.device)

    if trace.enabled():
        print(f"tracing -> {trace.current_path()}", flush=True)

    results = {}
    t00 = time.time()
    for name in selected:
        t0 = time.time()
        print(f"== {name} ==", flush=True)
        with trace.span("bench.module", module=name, profile=args.profile):
            results[name] = MODULES[name].run(args.profile)
        for row in results[name]:
            print("  " + ", ".join(f"{k}={common.fmt(v)}"
                                   for k, v in row.items()))
        print(f"   ({time.time()-t0:.1f}s)")

    violations = claims.validate(results)
    store.record_claims(violations, checked_modules=list(results))
    out = store.write()
    print(f"\ntotal {time.time()-t00:.1f}s; "
          f"{sum(len(v) for v in results.values())} rows; "
          f"{len(store.trials)} trials -> {out} "
          f"({common.RUNNER.cache.hits} cache hits)")
    if violations:
        print("PAPER-CLAIM VIOLATIONS:")
        for v in violations:
            print("  - " + v)
        sys.exit(1)
    print("all paper-claim checks passed")


if __name__ == "__main__":
    main()
