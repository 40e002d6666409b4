"""Scoring-service benchmark trajectory producer -> ``BENCH_serve.json``.

The port's twin of the reference's ``benchmarks/bench_serve.py``, with
its profiles, labels and schema.  One trajectory point per (batch size,
sparsity) cell of the GLM scoring service (``repro_torch.serve.glm``): a
synthetic padded-ELL request stream is admitted through the engine's
bounded FIFO and scored in padded micro-batches by the ``glm_score``
kernel; the point records the request-latency quantiles (p50/p99,
admission -> response), the sustained requests/s of the drain, the
conformance verdict of the CUDA kernel against its plain version at that
shape (None on the CPU, where no kernel flavor exists, as in
``bench_kernels``), and the roofline annotation of one scoring launch on
the H100 (``repro_torch.roofline.kernels``).

Determinism contract (same as ``BENCH_kernels.json``): measured
latencies are cached in ``bench_results/torch/serve_cache`` keyed by the
entry identity (shape, engine config, backend, host, device kind) — a
warm re-run reads the cache and writes a byte-identical
``BENCH_serve.json`` (``tests/test_torch_bench.py`` holds it to that).
The regression gate (``claims.check_bench_serve``) compares each point's
p50 against the *committed* trajectory entry with the same label, host,
and device kind — cross-host latencies never gate — and its baseline
lookups stay out of the snapshot so the file remains a pure function of
the cache.

Standalone:  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve
[ci|paper] [--consumers N] [--device cuda|cpu] (exits non-zero on a
conformance or regression violation).  ``--consumers N`` drives the
stream with N dedicated consumer threads flushing while the main thread
produces; those points carry a ``/cN`` label suffix so they never collide
with (or gate against) the committed single-consumer trajectory.

``--monitor`` attaches a :class:`repro_torch.obs.monitor.HealthMonitor`
to a **shadow drive** of every cell: the health windows, SLO evaluations,
and sidecar output come from a separate re-drive of the request stream,
never from the measured payloads — the cached ``BENCH_serve.json`` stays
byte-identical under monitoring.  ``--fault-stall S`` makes the shadow
engines stall every flush by S seconds
(``GLMScoreEngine(fault_stall_s=...)``) on a truncated stream — the
injected latency spike the monitor turns into a ``latency_p99`` breach.
Nothing here reads or writes the reference's root ``BENCH_serve.json``.
"""
from __future__ import annotations

import hashlib
import platform
import statistics
import threading
import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.data import synthetic
from repro_torch.kernels import common as kcommon
from repro_torch.kernels import tune
from repro_torch.kernels.glm_score import glm_score
from repro_torch.obs import metrics
from repro_torch.obs.monitor import DEFAULT_SERVE_SLOS, HealthMonitor
from repro_torch.roofline import kernels as roofline
from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest
from repro_torch.study.runner import TrialCache
from repro_torch.study.spec import canonical_json
from repro_torch.study.store import ServeBenchStore
from repro_torch.utils.timing import Timer

#: bump to invalidate every cached latency (measurement protocol changes)
TIMING_SCHEMA = 1

TASK = "lr"

#: per-profile service shape: request count, model width, and the
#: (batch size x ELL sparsity) grid the trajectory sweeps
PROFILES = {
    "ci": dict(n_requests=192, d=512, batches=(8, 32), ks=(4, 16)),
    "paper": dict(n_requests=2048, d=4096, batches=(32, 128), ks=(8, 32)),
}


def _digest(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]


def _requests(n: int, d: int, k: int, dev: torch.device):
    """The benchmark request stream + its ELL batch on ``dev`` (for
    conformance)."""
    ds = synthetic.make_sparse(f"bench-serve-{d}-{k}", n, d, k * 0.6, k,
                               seed=0, device="cpu")
    vals = ds.ell.values.numpy()
    idx = ds.ell.indices.numpy()
    reqs = [ScoreRequest(i, vals[i], idx[i]) for i in range(n)]
    return reqs, ds.ell.values.to(dev), ds.ell.indices.to(dev)


def _conformance(w, vals, idx) -> tuple[bool | None, list[str]]:
    """The CUDA ``glm_score`` kernel against its plain version on the same
    CUDA tensors; ``(None, [])`` on the CPU, where no kernel flavor
    exists."""
    if w.device.type != "cuda":
        return None, []
    with kcommon.plain_versions():
        ref = glm_score(TASK, w, vals, idx)
    out = glm_score(TASK, w, vals, idx)
    return bool(torch.allclose(out, ref, rtol=1e-3, atol=2e-3)), \
        [kcommon.CUDA]


def _drive(engine: GLMScoreEngine, reqs) -> dict:
    """Admit + drain the whole stream; returns latency/throughput stats.

    Producers saturate the bounded FIFO (``try_admit`` fills it until it
    rejects, then the same loop drains), so the measured latencies include
    real queueing, not just the launch.
    """
    responses = []
    with Timer() as t:
        pending = list(reqs)
        while pending or len(engine):
            while pending and engine.try_admit(pending[0]):
                pending.pop(0)
            batch = engine.flush()
            if not batch and not pending:
                break
            responses.extend(batch)
    assert len(responses) == len(reqs), (len(responses), len(reqs))
    lat = sorted(r.latency_s for r in responses)
    return {
        "p50_s": statistics.median(lat),
        "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rps": len(lat) / max(t.elapsed, 1e-9),
    }


def _drive_threaded(engine: GLMScoreEngine, reqs, consumers: int) -> dict:
    """``_drive`` with N dedicated consumer threads flushing while the
    main thread produces — the deployment shape where scoring capacity
    is scaled independently of admission.  Same stats contract."""
    responses: list = []
    resp_lock = threading.Lock()
    produced = threading.Event()

    def consume():
        while True:
            batch = engine.flush()
            if batch:
                with resp_lock:
                    responses.extend(batch)
            elif produced.is_set() and not len(engine):
                return
            else:
                time.sleep(1e-5)

    threads = [threading.Thread(target=consume) for _ in range(consumers)]
    with Timer() as t:
        for th in threads:
            th.start()
        try:
            for r in reqs:
                engine.submit(r)
        finally:
            produced.set()
            for th in threads:
                th.join()
    assert len(responses) == len(reqs), (len(responses), len(reqs))
    lat = sorted(r.latency_s for r in responses)
    return {
        "p50_s": statistics.median(lat),
        "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
        "rps": len(lat) / max(t.elapsed, 1e-9),
    }


def _shadow_drive(mon: HealthMonitor, w, reqs, k: int, engine_cfg: dict, *,
                  fault_stall_s: float) -> None:
    """Health-only re-drive of one cell: a fresh engine is warmed (the
    kernel's build and first launch stay out of the windows), then
    monitored and driven; the window closes at the cell boundary.
    Nothing here touches the benchmark's measured payloads or the
    trajectory store.  A nonzero ``fault_stall_s`` truncates the stream to
    two micro-batches so the injected stall costs ~2 flushes, not the
    whole stream."""
    engine = GLMScoreEngine(TASK, w, ell_width=k, device=w.device,
                            **engine_cfg)
    _drive(engine, reqs)                        # warm the scoring launch
    if fault_stall_s:
        reqs = reqs[:2 * engine_cfg["max_batch"]]
    engine = GLMScoreEngine(TASK, w, ell_width=k, device=w.device,
                            fault_stall_s=fault_stall_s, **engine_cfg)
    mon.attach_engine(engine)
    _drive(engine, reqs)
    mon.roll()


def _baseline_p50(committed: dict | None, label: str, host: str,
                  device_kind: str) -> float | None:
    """The committed trajectory's comparable point (same host + device)."""
    entry = (committed or {}).get("entries", {}).get(label)
    if (entry and entry.get("host") == host
            and entry.get("device_kind") == device_kind):
        return entry.get("p50_s")
    return None


def run(profile: str = "ci", *, out_json=None, consumers: int = 1,
        monitor: bool = False, fault_stall_s: float = 0.0, device=None):
    """Every cell of ``profile`` on ``device`` (``cuda`` unless the caller
    says) into ``out_json`` (default
    ``bench_results/torch/BENCH_serve.json``).  ``pallas_match`` keeps the
    reference's key: here the CUDA kernel's verdict."""
    out_json = out_json or common.RESULTS_DIR / "BENCH_serve.json"
    if consumers < 1:
        raise ValueError(f"consumers must be >= 1: {consumers}")
    if fault_stall_s and not monitor:
        raise ValueError("fault_stall_s only affects monitored shadow "
                         "drives; pass monitor=True")
    mon = HealthMonitor(DEFAULT_SERVE_SLOS) if monitor else None
    try:
        committed = ServeBenchStore.load(out_json)
    except (FileNotFoundError, ValueError):
        committed = None
    store = ServeBenchStore(
        out_json, jsonl_path=common.RESULTS_DIR / "serve_runs.jsonl")
    timing_cache = TrialCache(common.RESULTS_DIR / "serve_cache")
    host = platform.node()
    device_kind = tune.device_kind()
    dev = kcommon.device(device)

    cfg = PROFILES[profile]
    n_req, d = cfg["n_requests"], cfg["d"]
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)

    rows = []
    for k in cfg["ks"]:
        reqs, vals, idx = _requests(n_req, d, k, dev)
        for batch in cfg["batches"]:
            info = {"dtype": "float32", "sparse": True, "n": batch,
                    "d": d, "k": k}
            backend = kcommon.resolve_backend("glm_score", dev)
            pallas_match, checked = _conformance(w, vals, idx)

            engine_cfg = dict(max_batch=batch, queue_depth=2 * batch,
                              flush_deadline_s=0.0)
            suffix = f"/c{consumers}" if consumers > 1 else ""
            label = f"serve/{TASK}/d{d}-k{k}/batch{batch}{suffix}"
            key = _digest({"timing_schema": TIMING_SCHEMA, "label": label,
                           "profile": profile, "backend": backend,
                           "engine": engine_cfg, "consumers": consumers,
                           "host": host, "device_kind": device_kind})
            payload = timing_cache.peek(key)
            if payload is None:
                engine = GLMScoreEngine(TASK, w, ell_width=k,
                                        device=dev, **engine_cfg)
                _drive(engine, reqs)        # warmup (build, first launch)
                engine = GLMScoreEngine(TASK, w, ell_width=k,
                                        device=dev, **engine_cfg)
                t0 = time.perf_counter()
                payload = (_drive(engine, reqs) if consumers == 1 else
                           _drive_threaded(engine, reqs, consumers))
                timing_cache.put(key, payload)
                cached = False
                store.record_event("serve_timing", label=label,
                                   wall_s=time.perf_counter() - t0,
                                   **payload)
            else:
                cached = True

            entry = {
                "kernel": "glm_score",
                "task": TASK,
                "n_requests": n_req,
                "d": d,
                "k": k,
                "batch": batch,
                "engine": engine_cfg,
                "consumers": consumers,
                "backend": backend,
                "p50_s": payload["p50_s"],
                "p99_s": payload["p99_s"],
                "rps": payload["rps"],
                "pallas_match": pallas_match,
                "checked_backends": checked,
                "roofline": roofline.annotate("glm_score", info),
                "host": host,
                "device_kind": device_kind,
            }
            store.record_entry(label, entry, cached=cached)
            rows.append({
                "label": label, **entry,
                "baseline_p50_s": _baseline_p50(committed, label, host,
                                                device_kind),
            })
            if mon is not None:
                _shadow_drive(mon, w, reqs, k, engine_cfg,
                              fault_stall_s=fault_stall_s)
    out = store.write()
    print(f"wrote {out} ({len(rows)} trajectory points)")
    if mon is not None:
        print("\nhealth (shadow drives, sidecar-only):")
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
    ap.add_argument("--consumers", type=int, default=1,
                    help="dedicated consumer threads flushing the engine "
                         "while the main thread produces (1 = the classic "
                         "single-loop driver; >1 points get a /cN label)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach a HealthMonitor to shadow drives of every "
                         "cell (sidecar-only; BENCH_serve.json unchanged)")
    ap.add_argument("--fault-stall", type=float, default=0.0,
                    metavar="S", help="monitored shadow engines stall every "
                                      "flush by S seconds (latency-spike "
                                      "fault injection)")
    ap.add_argument("--out-json", default=None,
                    help="trajectory output path (default "
                         "bench_results/torch/BENCH_serve.json; fault runs "
                         "point this at scratch)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine scores (cpu: the plain version, "
                         "no verdict)")
    args = ap.parse_args()
    rows = run(args.profile, out_json=args.out_json,
               consumers=args.consumers, monitor=args.monitor,
               fault_stall_s=args.fault_stall, device=args.device)
    for r in rows:
        print(f"  {r['label']:36s} p50={1e6 * r['p50_s']:9.1f}us "
              f"p99={1e6 * r['p99_s']:9.1f}us rps={r['rps']:9.0f} "
              f"match={r['pallas_match']}")
    bad = claims.check_bench_serve(rows)
    if bad:
        print("VIOLATIONS:")
        for v in bad:
            print("  - " + v)
        sys.exit(1)
    print("serve conformance + regression gate clean")
