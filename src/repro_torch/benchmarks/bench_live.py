"""Live-training benchmark trajectory producer -> ``BENCH_live.json``.

The port's twin of the reference's ``benchmarks/bench_live.py``, with its
profiles, labels and schema, on ``cuda`` unless the caller says.  Two
cell families per profile, both over :mod:`repro_torch.live`:

* **convergence** — the online replica-merge learner over a seeded
  synthetic stream: holdout-loss curve at fixed step checkpoints, wall
  time, steps/s, merges.  Swept over (replicas, compressed-merge) so
  the trajectory shows what the int8 error-feedback channel and the
  replica count cost/buy in the continual setting (the online analogue
  of the study engine's Table-7 cells).
* **serve** — latency under training: a scoring thread admits+flushes a
  request stream against the engine while the learner trains and the
  publisher hot-swaps snapshots concurrently.  Records request-latency
  quantiles, throughput, publishes, the measured staleness vs the
  publisher's guaranteed bound, and whether served versions stayed
  non-decreasing — the consistency half of the cell is gated, not just
  the speed.

Determinism contract (same as ``BENCH_serve.json``): the full measured
payload of every cell — losses, wall times, latencies, staleness — is
cached in ``bench_results/torch/live_cache`` keyed by the cell identity
(profile, config, host, device kind).  A warm re-run is a pure cache
read and writes a byte-identical ``BENCH_live.json``.  The regression gate
(``claims.check_bench_live``) compares against the *committed*
trajectory only for the same host + device kind, and its baseline
lookups stay out of the snapshot.

Standalone:  PYTHONPATH=src python -m repro_torch.benchmarks.bench_live
[ci|paper] [--device cuda|cpu] (exits non-zero on a convergence,
consistency, or regression violation).

``--monitor`` attaches a :class:`repro_torch.obs.monitor.HealthMonitor`:
convergence cells replay their (cached, deterministic) holdout-loss
curves through the drift watch, and the serve cell gets a **shadow
drive** — a separate learner+publisher+engine trio watched end to end
(staleness, publishes, windowed latency).  Health is sidecar-only; the
committed ``BENCH_live.json`` stays byte-identical under monitoring.
``--fault publish-stall`` stalls the shadow publisher after its first
snapshot (a ``staleness`` breach); ``--fault diverge`` adds a shadow
learner at 64x the step size whose loss curve blows up (a
``loss_divergence`` breach).  Faults never touch the measured cells.
Nothing here reads or writes the reference's root ``BENCH_live.json``.
"""
from __future__ import annotations

import hashlib
import platform
import statistics
import threading
import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.kernels import common as kcommon
from repro_torch.kernels import tune
from repro_torch.live import (LiveConfig, LiveLearner, SnapshotPublisher,
                              SyntheticStream)
from repro_torch.obs import metrics, trace
from repro_torch.obs.monitor import DEFAULT_LIVE_SLOS, HealthMonitor
from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest
from repro_torch.study.runner import TrialCache
from repro_torch.study.spec import canonical_json
from repro_torch.study.store import LiveBenchStore

#: bump to invalidate every cached measurement (protocol changes)
TIMING_SCHEMA = 1

TASK = "lr"

#: per-profile shape: stream width/depth, learner steps, and the
#: (replicas x compressed-merge) grid the convergence family sweeps
PROFILES = {
    "ci": dict(d=256, n_batch=64, n_steps=32, merge_every=4,
               step_size=0.2, replicas=(2, 4), compress=(False, True),
               serve_replicas=4, max_batch=8, n_checkpoints=4),
    "paper": dict(d=2048, n_batch=256, n_steps=128, merge_every=4,
                  step_size=0.1, replicas=(4, 8), compress=(False, True),
                  serve_replicas=8, max_batch=32, n_checkpoints=8),
}


def _digest(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]


def _learner(cfg, dev, *, replicas, compress):
    stream = SyntheticStream(n_batch=cfg["n_batch"], d=cfg["d"], seed=0)
    lcfg = LiveConfig(task=TASK, replicas=replicas,
                      step_size=cfg["step_size"],
                      merge_every=cfg["merge_every"], compress=compress)
    return LiveLearner(lcfg, stream, device=dev), stream


def _engine(cfg, stream, dev) -> GLMScoreEngine:
    return GLMScoreEngine(TASK, np.zeros(cfg["d"], np.float32),
                          ell_width=stream.ell_width,
                          max_batch=cfg["max_batch"],
                          queue_depth=4 * cfg["max_batch"],
                          flush_deadline_s=0.0, device=dev)


def _convergence_cell(cfg, dev, *, replicas, compress) -> dict:
    """Holdout-loss-vs-wall-time of one learner config (measured)."""
    lrn, stream = _learner(cfg, dev, replicas=replicas, compress=compress)
    ell, y = stream.holdout(512, device=dev)
    lrn.run(2)                          # warmup: build, first launches
    lrn, stream = _learner(cfg, dev, replicas=replicas, compress=compress)
    n_steps = cfg["n_steps"]
    ckpt = max(1, n_steps // cfg["n_checkpoints"])
    losses = [lrn.loss(ell, y)]
    t0 = time.perf_counter()
    for i in range(n_steps):
        lrn.step()
        if (i + 1) % ckpt == 0:
            losses.append(lrn.loss(ell, y))
    wall = time.perf_counter() - t0
    return {
        "losses": [round(float(v), 6) for v in losses],
        "wall_s": wall,
        "steps_per_s": n_steps / max(wall, 1e-9),
        "merges": lrn.merges,
    }


def _serve_cell(cfg, dev) -> dict:
    """Latency + consistency of the scoring engine while a learner
    trains and publishes against it from another thread (measured)."""
    lrn, stream = _learner(cfg, dev, replicas=cfg["serve_replicas"],
                           compress=False)
    engine = _engine(cfg, stream, dev)
    pub = SnapshotPublisher(engine, every_merges=1).attach(lrn)
    bound = pub.bound_steps(lrn.config.merge_every)
    max_staleness = 0
    done = threading.Event()

    def train():
        nonlocal max_staleness
        for _ in range(cfg["n_steps"]):
            lrn.step()
            lag = pub.staleness(lrn)
            if lag is not None:
                max_staleness = max(max_staleness, lag)
        done.set()

    rng = np.random.default_rng(1)
    k = stream.ell_width
    responses = []
    rid = 0
    # warmup the scoring launch before the clock starts
    engine.try_admit(ScoreRequest(-1, np.zeros(k), np.zeros(k, int)))
    engine.flush()
    th = threading.Thread(target=train)
    t0 = time.perf_counter()
    th.start()
    try:
        while not done.is_set():
            for _ in range(4):
                nn = int(rng.integers(1, k + 1))
                idx = rng.choice(cfg["d"], nn, replace=False)
                if engine.try_admit(ScoreRequest(rid, rng.normal(0, 1, nn),
                                                 idx)):
                    rid += 1
            responses.extend(engine.flush())
    finally:
        th.join()
    responses.extend(engine.drain())
    wall = time.perf_counter() - t0
    lat = sorted(r.latency_s for r in responses)
    versions = [r.model_version for r in responses]
    return {
        "p50_s": statistics.median(lat),
        "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rps": len(lat) / max(wall, 1e-9),
        "n_scored": len(lat),
        "publishes": pub.publishes,
        "max_staleness_steps": int(max_staleness),
        "staleness_bound_steps": bound,
        "versions_monotone": versions == sorted(versions),
        "max_version_served": max(versions, default=0),
    }


def _shadow_serve_cell(cfg, dev, mon: HealthMonitor, *,
                       publish_stall: bool = False) -> None:
    """Health-only serve drive: a fresh learner/publisher/engine trio is
    warmed, then watched end to end — per-step staleness, publishes,
    and windowed request latency all flow into ``mon``.  Single-loop
    interleave (step, admit, flush) so the drive is deterministic apart
    from wall time.  ``publish_stall`` freezes the publisher after its
    first snapshot: merges keep landing but nothing ships, so measured
    staleness climbs past the bound captured at attach time."""
    lrn, stream = _learner(cfg, dev, replicas=cfg["serve_replicas"],
                           compress=False)
    engine = _engine(cfg, stream, dev)
    pub = SnapshotPublisher(engine, every_merges=1).attach(lrn)
    k = stream.ell_width
    engine.try_admit(ScoreRequest(-1, np.zeros(k), np.zeros(k, int)))
    engine.flush()                              # warm the scoring launch
    lrn.run(2)                                  # warm the step/merge launches
    mon.watch_live(lrn, pub).attach_engine(engine)
    rng = np.random.default_rng(1)
    rid = 0
    for _ in range(cfg["n_steps"]):
        lrn.step()
        if publish_stall and pub.publishes >= 1:
            pub.every_merges = 10 ** 9          # injected publisher stall
        for _ in range(2):
            nn = int(rng.integers(1, k + 1))
            idx = rng.choice(cfg["d"], nn, replace=False)
            if engine.try_admit(ScoreRequest(rid, rng.normal(0, 1, nn),
                                             idx)):
                rid += 1
        engine.flush()
    engine.drain()
    mon.roll()


def _shadow_diverge_cell(cfg, dev, mon: HealthMonitor) -> None:
    """Health-only divergence driver: the convergence learner at 64x the
    profile step size, its holdout-loss curve fed to the drift watch.
    At that step size the logistic loss blows up within a handful of
    checkpoints — the ``loss_divergence`` fault class."""
    hot = {**cfg, "step_size": 64.0 * cfg["step_size"]}
    lrn, stream = _learner(hot, dev, replicas=2, compress=False)
    ell, y = stream.holdout(256, device=dev)
    ckpt = max(1, cfg["merge_every"])
    for i in range(cfg["n_steps"]):
        lrn.step()
        if (i + 1) % ckpt == 0:
            mon.observe_loss(lrn.loss(ell, y))
            mon.roll()


def _baseline(committed: dict | None, label: str, host: str,
              device_kind: str, field: str) -> float | None:
    """The committed trajectory's comparable point (same host + device)."""
    entry = (committed or {}).get("entries", {}).get(label)
    if (entry and entry.get("host") == host
            and entry.get("device_kind") == device_kind):
        return entry.get(field)
    return None


#: injectable fault classes for the monitored shadow cells
FAULTS = ("publish-stall", "diverge")


def run(profile: str = "ci", *, out_json=None, monitor: bool = False,
        fault: str | None = None, device=None):
    """Every cell of ``profile`` on ``device`` (``cuda`` unless the caller
    says) into ``out_json`` (default
    ``bench_results/torch/BENCH_live.json``)."""
    out_json = out_json or common.RESULTS_DIR / "BENCH_live.json"
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}: {fault!r}")
    if fault is not None and not monitor:
        raise ValueError("faults only affect monitored shadow cells; "
                         "pass monitor=True")
    mon = HealthMonitor(DEFAULT_LIVE_SLOS) if monitor else None
    try:
        committed = LiveBenchStore.load(out_json)
    except (FileNotFoundError, ValueError):
        committed = None
    store = LiveBenchStore(
        out_json, jsonl_path=common.RESULTS_DIR / "live_runs.jsonl")
    timing_cache = TrialCache(common.RESULTS_DIR / "live_cache")
    host = platform.node()
    device_kind = tune.device_kind()
    dev = kcommon.device(device)

    cfg = PROFILES[profile]
    rows = []

    def measure(label: str, kind: str, ident: dict, fn):
        key = _digest({"timing_schema": TIMING_SCHEMA, "label": label,
                       "profile": profile, "host": host,
                       "device_kind": device_kind, **ident})
        payload = timing_cache.peek(key)
        if payload is None:
            t0 = time.perf_counter()
            with trace.span("bench.live_cell", label=label, kind=kind):
                payload = fn()
            timing_cache.put(key, payload)
            store.record_event("live_timing", label=label,
                               cell_s=time.perf_counter() - t0, **payload)
            cached = False
        else:
            cached = True
        entry = {"kind": kind, "task": TASK, "d": cfg["d"],
                 "n_batch": cfg["n_batch"], "n_steps": cfg["n_steps"],
                 "merge_every": cfg["merge_every"], **ident, **payload,
                 "host": host, "device_kind": device_kind}
        store.record_entry(label, entry, cached=cached)
        return entry

    for replicas in cfg["replicas"]:
        for compress in cfg["compress"]:
            tag = "-c8" if compress else ""
            label = (f"live/{TASK}/d{cfg['d']}/r{replicas}"
                     f"-m{cfg['merge_every']}{tag}")
            ident = {"replicas": replicas, "compress": compress}
            entry = measure(
                label, "convergence", ident,
                lambda r=replicas, c=compress: _convergence_cell(
                    cfg, dev, replicas=r, compress=c))
            rows.append({
                "label": label, **entry,
                "baseline_wall_s": _baseline(committed, label, host,
                                             device_kind, "wall_s"),
            })
            if mon is not None:
                # replay the (deterministic) curve through the drift
                # watch; one health window per convergence cell
                for v in entry["losses"]:
                    mon.observe_loss(v)
                mon.roll()

    label = (f"live-serve/{TASK}/d{cfg['d']}/r{cfg['serve_replicas']}"
             f"/batch{cfg['max_batch']}")
    entry = measure(label, "serve",
                    {"replicas": cfg["serve_replicas"],
                     "max_batch": cfg["max_batch"]},
                    lambda: _serve_cell(cfg, dev))
    rows.append({
        "label": label, **entry,
        "baseline_p50_s": _baseline(committed, label, host, device_kind,
                                    "p50_s"),
    })
    if mon is not None:
        _shadow_serve_cell(cfg, dev, mon,
                           publish_stall=(fault == "publish-stall"))
        if fault == "diverge":
            _shadow_diverge_cell(cfg, dev, mon)

    out = store.write()
    print(f"wrote {out} ({len(rows)} trajectory points)")
    if mon is not None:
        print("\nhealth (shadow cells, sidecar-only):")
        print(mon.table())
        s = mon.summary()
        print(f"windows={s['windows']} breaches={s['total_breaches']} "
              f"{s['breaches'] or ''}")
        metrics.flush(0)
    return rows


if __name__ == "__main__":
    import argparse
    import sys

    from repro_torch.study import claims

    ap = argparse.ArgumentParser()
    ap.add_argument("profile", nargs="?", default="ci",
                    choices=list(PROFILES))
    ap.add_argument("--monitor", action="store_true",
                    help="attach a HealthMonitor to shadow cells "
                         "(sidecar-only; BENCH_live.json unchanged)")
    ap.add_argument("--fault", choices=list(FAULTS), default=None,
                    help="inject a fault into the monitored shadow cells")
    ap.add_argument("--out-json", default=None,
                    help="trajectory output path (default "
                         "bench_results/torch/BENCH_live.json; fault runs "
                         "point this at scratch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the learner and the engine run (cpu: the "
                         "plain versions)")
    args = ap.parse_args()
    rows = run(args.profile, out_json=args.out_json, monitor=args.monitor,
               fault=args.fault, device=args.device)
    for r in rows:
        if r["kind"] == "convergence":
            print(f"  {r['label']:34s} loss={r['losses'][0]:8.3f}"
                  f"->{r['losses'][-1]:8.3f} steps/s={r['steps_per_s']:7.1f}"
                  f" merges={r['merges']}")
        else:
            print(f"  {r['label']:34s} p50={1e6 * r['p50_s']:9.1f}us "
                  f"p99={1e6 * r['p99_s']:9.1f}us rps={r['rps']:8.0f} "
                  f"staleness={r['max_staleness_steps']}"
                  f"<={r['staleness_bound_steps']} "
                  f"v<={r['max_version_served']}")
    bad = claims.check_bench_live(rows)
    if bad:
        print("VIOLATIONS:")
        for v in bad:
            print("  - " + v)
        sys.exit(1)
    print("live convergence + consistency + regression gate clean")
