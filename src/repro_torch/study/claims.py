"""Paper-claim validation predicates: the port's plain copy of the
reference's ``study/claims.py`` (tested to give the same strings).

Each ``check_*`` takes the row dicts one benchmark module produced and
returns human-readable violation strings (empty = claim holds);
``validate`` dispatches a full results dict.  Living here instead of the
benchmark driver lets tests assert the predicates directly on synthetic
rows, and lets the store persist verdicts next to the trial data.

Usage — validate sweep rows without the benchmark driver::

    from repro_torch.study import claims

    rows = [{"dataset": "w8a", "task": "lr", "n": 2048,
             "paths_statistically_identical": True,
             "speedup_sync_vs_seq": 41.0}]
    assert claims.check_table4(rows) == []            # claim holds
    assert claims.validate({"table4_sync": rows}) == []

``repro_torch.benchmarks.run`` calls ``validate`` on every sweep and exits
non-zero on violations; ``store.StudyStore.record_claims`` persists
the verdicts into ``BENCH_study.json``.  Timing-based predicates carry
size/noise floors (e.g. ``TABLE4_TIMING_N_FLOOR``) so miniature
fixture runs only assert the statistical halves of each claim.
"""
from __future__ import annotations


#: below this many examples the batch-vs-sequential timing claim is
#: meaningless (fixed launch overhead dominates sub-ms epochs — the
#: regime real-data fixtures run in); statistical identity always holds
TABLE4_TIMING_N_FLOOR = 1024


def check_table4(rows: list[dict]) -> list[str]:
    """Sync statistical identity across execution paths + batch ≥ seq.

    The speedup claim is the paper's at-scale statement (§6.2, >400x on
    full datasets); rows measured on fewer than
    ``TABLE4_TIMING_N_FLOOR`` examples (miniature fixtures) only assert
    the statistical-identity half.
    """
    bad = []
    for r in rows:
        if not r["paths_statistically_identical"]:
            bad.append(f"table4: fused != composition on {r['dataset']}"
                       f"/{r['task']} (sync statistical identity broken)")
        if (r.get("n", TABLE4_TIMING_N_FLOOR) >= TABLE4_TIMING_N_FLOOR
                and r["speedup_sync_vs_seq"] < 1.0):
            bad.append(f"table4: batch path slower than sequential on "
                       f"{r['dataset']}/{r['task']}")
    return bad


def check_fig11(rows: list[dict]) -> list[str]:
    """Model replication never improves statistical efficiency (§5.2.2)."""
    bad = []
    by_key: dict[tuple, list[dict]] = {}
    for r in rows:
        by_key.setdefault((r["dataset"], r["task"]), []).append(r)
    for key, rs in by_key.items():
        rs = sorted(rs, key=lambda r: r["replicas"])
        losses = [r["final_loss"] for r in rs]
        if losses[-1] < losses[0] * 0.98:   # thread beating kernel outright
            bad.append(f"fig11: replication improved statistical efficiency "
                       f"on {key} (unexpected): {losses}")
    return bad


def check_fig14(rows: list[dict]) -> list[str]:
    """rep-k data replication costs hardware efficiency (§5.2.3)."""
    bad = []
    by_key: dict[tuple, list[dict]] = {}
    for r in rows:
        by_key.setdefault((r["dataset"], r["task"]), []).append(r)
    for key, rs in by_key.items():
        rs = sorted(rs, key=lambda r: r["rep_k"])
        # single-core CI timings are noisy at sub-ms epochs: only flag a
        # clear (>=30%) inversion of the expected rep-k hardware cost
        if rs[-1]["t_epoch_ms"] < rs[0]["t_epoch_ms"] * 0.7:
            bad.append(f"fig14: rep-10 cheaper than rep-0 on {key}")
    return bad


#: a kernel trajectory point may be this much slower than the committed
#: same-host/same-device point before the regression gate trips
KERNEL_REGRESSION_TOL = 0.20


def check_bench_kernels(rows: list[dict]) -> list[str]:
    """Kernel conformance + wall-time regression gate.

    Each row is one ``BENCH_kernels.json`` trajectory point plus the
    ephemeral ``baseline_wall_s`` the producer looked up from the
    committed trajectory (same entry label, same host, same device
    kind — cross-host timings never gate).  Three failure modes:

    * ``pallas_match is False`` — a Pallas flavor disagreed with the
      oracle at this shape;
    * every row ``None`` — no Pallas flavor was checked at all.  (The
      old predicate computed ``all({})`` per row, so a run that checked
      nothing validated as green; unchecked rows now carry ``None``
      and an entirely unchecked run is a violation.)
    * wall time more than ``KERNEL_REGRESSION_TOL`` above the
      comparable committed point.
    """
    bad = []
    for r in rows:
        if r.get("pallas_match") is False:
            bad.append(f"kernels: pallas mismatch vs oracle at "
                       f"{r.get('label', r)}")
        base = r.get("baseline_wall_s")
        wall = r.get("wall_s")
        if base and wall and wall > base * (1.0 + KERNEL_REGRESSION_TOL):
            bad.append(
                f"kernels: {r.get('label')} regressed "
                f"{100.0 * (wall / base - 1.0):.0f}% vs committed "
                f"trajectory ({wall:.3e}s vs {base:.3e}s)")
    if rows and all(r.get("pallas_match") is None for r in rows):
        bad.append("kernels: no Pallas flavor was conformance-checked "
                   "(every trajectory point is unchecked)")
    return bad


#: a serve trajectory point's p50 latency may be this much above the
#: committed same-host/same-device point before the regression gate trips
#: (request latency includes queueing, noisier than a bare kernel launch)
SERVE_REGRESSION_TOL = 0.25


def check_bench_serve(rows: list[dict]) -> list[str]:
    """Scoring-service conformance + latency/throughput gate.

    Each row is one ``BENCH_serve.json`` trajectory point plus the
    ephemeral ``baseline_p50_s`` the producer looked up from the
    committed trajectory (same entry label, same host, same device
    kind — cross-host latencies never gate).  Failure modes:

    * ``pallas_match is False`` — a Pallas flavor of ``glm_score``
      disagreed with the dense oracle at this shape;
    * every row ``None`` — no Pallas flavor was checked at all (same
      vacuous-green guard as ``check_bench_kernels``);
    * non-positive throughput, or p99 below p50 (a broken quantile
      pipeline, not a slow host);
    * p50 more than ``SERVE_REGRESSION_TOL`` above the comparable
      committed point.
    """
    bad = []
    for r in rows:
        label = r.get("label", r)
        if r.get("pallas_match") is False:
            bad.append(f"serve: glm_score pallas mismatch vs oracle at "
                       f"{label}")
        rps = r.get("rps")
        if rps is not None and rps <= 0:
            bad.append(f"serve: non-positive throughput at {label}")
        p50, p99 = r.get("p50_s"), r.get("p99_s")
        if p50 is not None and p99 is not None and p99 < p50:
            bad.append(f"serve: p99 < p50 at {label} "
                       f"({p99:.3e}s < {p50:.3e}s)")
        base = r.get("baseline_p50_s")
        if base and p50 and p50 > base * (1.0 + SERVE_REGRESSION_TOL):
            bad.append(
                f"serve: {label} p50 regressed "
                f"{100.0 * (p50 / base - 1.0):.0f}% vs committed "
                f"trajectory ({p50:.3e}s vs {base:.3e}s)")
    if rows and all(r.get("pallas_match") is None for r in rows):
        bad.append("serve: no Pallas flavor of glm_score was "
                   "conformance-checked (every trajectory point is "
                   "unchecked)")
    return bad


#: a live trajectory point's latency/wall-time may be this much above
#: the committed same-host/same-device point before the gate trips (the
#: live cells run a learner and a scorer concurrently — noisier than
#: either alone)
LIVE_REGRESSION_TOL = 0.35


def check_bench_live(rows: list[dict]) -> list[str]:
    """Live (train-while-serving) convergence + consistency gate.

    Rows are the two ``BENCH_live.json`` cell families plus the
    ephemeral ``baseline_*`` fields the producer looked up from the
    committed trajectory (same label/host/device kind — cross-host
    timings never gate).  Failure modes:

    * a convergence cell whose holdout loss did not drop by at least
      10% over the run — the online learner is not learning;
    * a serve-under-training cell whose measured staleness exceeded the
      publisher's guaranteed bound, whose served versions were not
      non-decreasing, or that never served a published (post-swap)
      model — the consistency story is broken, not just slow;
    * non-positive throughput or p99 < p50 (broken pipeline);
    * p50 (serve cells) or wall time (convergence cells) more than
      ``LIVE_REGRESSION_TOL`` above the comparable committed point;
    * vacuous-green guard: a non-empty row set missing either cell
      family entirely.
    """
    bad = []
    kinds = {r.get("kind") for r in rows}
    for r in rows:
        label = r.get("label", r)
        if r.get("kind") == "convergence":
            losses = r.get("losses") or []
            if len(losses) >= 2 and losses[-1] > 0.9 * losses[0]:
                bad.append(f"live: no convergence at {label} "
                           f"(loss {losses[0]:.4g} -> {losses[-1]:.4g})")
            sps = r.get("steps_per_s")
            if sps is not None and sps <= 0:
                bad.append(f"live: non-positive steps/s at {label}")
            base = r.get("baseline_wall_s")
            wall = r.get("wall_s")
            if base and wall and wall > base * (1.0 + LIVE_REGRESSION_TOL):
                bad.append(
                    f"live: {label} wall time regressed "
                    f"{100.0 * (wall / base - 1.0):.0f}% vs committed "
                    f"trajectory ({wall:.3e}s vs {base:.3e}s)")
        elif r.get("kind") == "serve":
            ms = r.get("max_staleness_steps")
            bound = r.get("staleness_bound_steps")
            if ms is not None and bound is not None and ms > bound:
                bad.append(f"live: staleness {ms} exceeded bound {bound} "
                           f"at {label}")
            if r.get("versions_monotone") is False:
                bad.append(f"live: served versions went backwards at "
                           f"{label}")
            if not r.get("max_version_served"):
                bad.append(f"live: never served a published model at "
                           f"{label}")
            rps = r.get("rps")
            if rps is not None and rps <= 0:
                bad.append(f"live: non-positive throughput at {label}")
            p50, p99 = r.get("p50_s"), r.get("p99_s")
            if p50 is not None and p99 is not None and p99 < p50:
                bad.append(f"live: p99 < p50 at {label} "
                           f"({p99:.3e}s < {p50:.3e}s)")
            base = r.get("baseline_p50_s")
            if base and p50 and p50 > base * (1.0 + LIVE_REGRESSION_TOL):
                bad.append(
                    f"live: {label} p50 regressed "
                    f"{100.0 * (p50 / base - 1.0):.0f}% vs committed "
                    f"trajectory ({p50:.3e}s vs {base:.3e}s)")
    if rows and "convergence" not in kinds:
        bad.append("live: no convergence cells measured "
                   "(trajectory is serve-only)")
    if rows and "serve" not in kinds:
        bad.append("live: no serve-under-training cells measured "
                   "(trajectory is learner-only)")
    return bad


def check_fig24(rows: list[dict]) -> list[str]:
    """Async time/epoch grows (sub-)linearly in N."""
    bad = []
    n_rows = [r for r in rows if r["axis"] == "N"]
    if len(n_rows) >= 2:
        t0, t1 = n_rows[0], n_rows[-1]
        growth = t1["t_epoch_async_ms"] / max(t0["t_epoch_async_ms"], 1e-9)
        size = t1["value"] / t0["value"]
        if growth > size * 3:
            bad.append(f"fig24: async time grew {growth:.1f}x for {size:.0f}x "
                       f"data (super-linear)")
    return bad


CHECKS = {
    "table4_sync": check_table4,
    "fig11_model_replication": check_fig11,
    "fig14_data_replication": check_fig14,
    "bench_kernels": check_bench_kernels,
    "bench_serve": check_bench_serve,
    "bench_live": check_bench_live,
    "fig24_scale": check_fig24,
}


def validate(results: dict[str, list[dict]]) -> list[str]:
    """Run every applicable claim check; returns all violations."""
    bad: list[str] = []
    for module, check in CHECKS.items():
        if module in results:
            bad.extend(check(results[module]))
    return bad
