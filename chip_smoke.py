#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (SGD study engine, scoring service and live
learner) on one NVIDIA card.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, one JSON line each:

1. ``env``     card name and power limit, torch, CUDA, nvcc, triton;
2. ``build``   compiles the five kernels from src/repro_torch/kernels/csrc
               (one nvcc per source, all at once) and reports ptxas usage;
3. ``kernels`` holds each kernel against its plain PyTorch version on the
               card: both tasks, both glm_grad layouts, covtype and w8a
               widths, a ragged N, a replica axis, real-sim's width, and
               glm_score at w8a, real-sim and news widths with filler rows
               that must score link(0) exactly; and that the sparse
               kernels refuse an index outside [0, d);
4. ``train``   ``repro_torch.core.sgd.run`` at the full size of the paper's
               covtype (581,012 x 54, dense) and w8a (64,700 x 300, K=69,
               padded ELL) stand-ins, six strategies; launch counts are zeroed
               just before and read just after; then the same strategies at
               N=4,100 through the kernels and through the plain versions on
               the card, loss for loss;
5. ``serve``   ``GLMScoreEngine`` on the card: all 64,700 w8a rows as
               requests under the model phase ``train``'s SyncSGD run ended
               with (max_batch 128, with a swap_model halfway, and 32), and
               8,192 real-sim-width requests; launch counts zeroed just
               before and read just after; every response held against the
               plain version under the snapshot version it carries;
6. ``live``    train-while-serving: ``LiveLearner`` on a real-sim-width
               stream publishing into an engine that a second thread
               serves, exact and int8-compressed, with replicas killed and
               revived; each configuration also run in lockstep through the
               kernels and through the plain versions and held merge by
               merge (int8: also with the plain learner resynced after each
               merge, and its codes compared); short glm_sparse and dense
               runs;
7. ``timing``  each kernel and its plain version at the main path's shapes,
               and a check of the async replica epochs at the full partition
               size (covtype R=8 B=1, w8a R=10 full partition).

It then prints the card's name and power limit, a ``{"kernels": [...]}`` line
(launches on the main path, error, times, bound) and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without a card, or without the repository beside it, it fails.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

GRAD_TOL = dict(rtol=1e-4, atol=2e-3)    # the JAX conformance suite's
EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)

REPLACES = {
    "glm_sgd": "src/repro/kernels/glm_sgd/kernel.py:73",
    "glm_grad": "src/repro/kernels/glm_grad/kernel.py:90",
    "glm_sgd_sparse": "src/repro/kernels/glm_sgd_sparse/kernel.py:86",
    "glm_sparse": "src/repro/kernels/glm_sparse/kernel.py:108",
    "glm_score": "src/repro/kernels/glm_score/kernel.py:72",
}


#: the __global__ functions each wrapper launches (csrc/<name>.cu)
KERNEL_SYMBOLS = {
    "glm_sgd": ("glm_sgd_kernel",),
    "glm_grad": ("glm_grad_row_kernel", "glm_grad_col_kernel",
                 "glm_grad_reduce_kernel"),
    "glm_sgd_sparse": ("ell_sgd_kernel",),
    "glm_sparse": ("ell_grad_kernel",),
    "glm_score": ("glm_score_kernel",),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def close(out: torch.Tensor, ref: torch.Tensor, tol: dict) -> tuple[float, bool]:
    """Max |out - ref| and whether every element is within atol + rtol|ref|."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
    return float(diff.max()), ok


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int) -> dict[str, tuple[float, int]]:
    """Device time of the kernels ``fn`` runs, from ``torch.profiler`` over
    ``reps`` calls after one warm-up call: name -> (total ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def kernel_device_ms(prof: dict[str, tuple[float, int]], names: tuple[str, ...]):
    """Device ms of one call: the mean time of each kernel whose name holds
    one of ``names``, summed (each runs once a call).  The mean over the
    launches the profiler recorded, since a trace may miss one.  None when
    the profiler saw none of them."""
    hits = [ms / count for key, (ms, count) in prof.items()
            if any(n in key for n in names)]
    return sum(hits) if hits else None


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespace noise and arguments."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:60]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ell_bytes(values: torch.Tensor) -> int:
    """Bytes a padded-ELL operand has to move: every value (a kernel finds
    the padding by reading it) and the 4-byte index of each nonzero.  The
    padding sits at the end of each row, so a kernel that skips value-0
    entries never needs their indices."""
    return nbytes(values) + 4 * int((values != 0).sum())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_env(smi: str) -> dict:
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "python": sys.version.split()[0],
            "nvcc": nvcc.strip().splitlines()[-1], "triton": triton_version,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count()}


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    usage = {name: [ln.strip() for ln in text.splitlines()
                    if re.search(r"Used \d+ registers", ln)]
             for name, text in reports.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": _build.sources(), "built": sorted(reports),
            "ptxas": usage}


def _dense_inputs(rng, n, d, dev):
    X = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0, 1.0)
                         .astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return X, y, w


def _ell_inputs(rng, n, d, avg, k, dev, seed):
    from repro_torch.data import synthetic

    ds = synthetic.make_sparse("check", n, d, avg, k, seed=seed, pad_to=k,
                               device=dev)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return ds.ell.values, ds.ell.indices, ds.y, w


def _wide_ell_inputs(n, d, k, dev, seed):
    """Padded-ELL rows at a width ``make_sparse`` is too slow for (news):
    row lengths uniform in [1, k], indices uniform in [0, d), drawn on the
    card; the padding is value 0 at index 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nnz = torch.randint(1, k + 1, (n, 1), device=dev, generator=g)
    live = torch.arange(k, device=dev)[None] < nnz
    v = torch.randn(n, k, device=dev, generator=g) * live
    i = torch.randint(0, d, (n, k), device=dev, generator=g,
                      dtype=torch.int32) * live
    w = torch.randn(d, device=dev, generator=g) * 0.1
    return v, i, w


def phase_kernels(dev) -> tuple[dict, dict]:
    """Every kernel against its plain version on the card, small shapes."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_score.ref import glm_score_ref
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    rng = np.random.default_rng(0)
    cases, worst = [], {}

    def record(kernel, label, out, ref, tol):
        err, ok = close(out, ref, tol)
        cases.append({"kernel": kernel, "case": label, "max_abs_err": err,
                      "tol": tol, "ok": ok})
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    for task in ("lr", "svm"):
        for n, d in ((4096, 54), (4099, 54), (3000, 300)):
            X, y, w = _dense_inputs(rng, n, d, dev)
            for layout in ("row", "col"):
                record("glm_grad", f"{task} n={n} d={d} {layout}",
                       K.glm_grad(task, w, X, y, layout=layout),
                       glm_grad_ref(task, w, X, y), GRAD_TOL)
            for mb in (1, 16):
                record("glm_sgd", f"{task} n={n} d={d} mb={mb}",
                       K.glm_sgd_epoch(task, w, X, y, step=0.01, micro_batch=mb),
                       glm_sgd_epoch_ref(task, w[None], X[None], y[None], 0.01,
                                         mb)[0], EPOCH_TOL)
        X, y, w = _dense_inputs(rng, 8 * 512, 54, dev)
        Xr, yr = X.reshape(8, 512, 54), y.reshape(8, 512)
        W = w[None] * torch.arange(1, 9, device=dev, dtype=torch.float32)[:, None]
        record("glm_sgd", f"{task} R=8 per=512 d=54 mb=1",
               K.glm_sgd_epoch(task, W, Xr, yr, step=0.01, micro_batch=1),
               glm_sgd_epoch_ref(task, W, Xr, yr, 0.01, 1), EPOCH_TOL)

        for n, d, avg, k, label in ((4096, 300, 11.65, 69, "w8a"),
                                    (4101, 300, 11.65, 69, "w8a ragged"),
                                    (2000, 20_958, 51.30, 307, "real-sim")):
            v, i, y, w = _ell_inputs(rng, n, d, avg, k, dev, seed=n)
            record("glm_sparse", f"{task} {label} n={n} d={d} K={k}",
                   K.ell_glm_grad(task, w, v, i, y),
                   ell_glm_grad_ref(task, w[None], v[None], i[None], y[None])[0],
                   GRAD_TOL)
            for mb in (1, 10):
                record("glm_sgd_sparse", f"{task} {label} n={n} d={d} K={k} mb={mb}",
                       K.ell_sgd_epoch(task, w, v, i, y, step=0.05, micro_batch=mb),
                       ell_sgd_epoch_ref(task, w[None], v[None], i[None], y[None],
                                         0.05, mb)[0], EPOCH_TOL)
        v, i, y, w = _ell_inputs(rng, 10 * 410, 300, 11.65, 69, dev, seed=7)
        vr, ir, yr = v.reshape(10, 410, 69), i.reshape(10, 410, 69), y.reshape(10, 410)
        W = w[None] * torch.arange(1, 11, device=dev, dtype=torch.float32)[:, None]
        record("glm_sparse", f"{task} w8a R=10 per=410",
               K.ell_glm_grad(task, W, vr, ir, yr),
               ell_glm_grad_ref(task, W, vr, ir, yr), GRAD_TOL)
        record("glm_sgd_sparse", f"{task} w8a R=10 per=410 mb=10",
               K.ell_sgd_epoch(task, W, vr, ir, yr, step=0.05, micro_batch=10),
               ell_sgd_epoch_ref(task, W, vr, ir, yr, 0.05, 10), EPOCH_TOL)
        # glm_score: every fifth row an all-zero filler row, which must
        # score link(0) exactly (0.5 for LR, 0.0 for SVM)
        link0 = 0.5 if task == "lr" else 0.0
        for n, d, avg, k, label in ((4096, 300, 11.65, 69, "w8a"),
                                    (37, 300, 11.65, 69, "w8a ragged"),
                                    (2000, 20_958, 51.30, 307, "real-sim"),
                                    (512, 1_355_191, 454.99, 2_729, "news")):
            if label == "news":
                v, i, w = _wide_ell_inputs(n, d, k, dev, seed=n)
            else:
                v, i, _, w = _ell_inputs(rng, n, d, avg, k, dev, seed=n + 1)
                v, i = v.clone(), i.clone()
            v[::5], i[::5] = 0.0, 0
            out = K.glm_score(task, w, v, i)
            record("glm_score", f"{task} {label} n={n} d={d} K={k}", out,
                   glm_score_ref(task, w, v, i), GRAD_TOL)
            cases.append({"kernel": "glm_score",
                          "case": f"{task} {label} filler rows == {link0}",
                          "ok": bool((out[::5] == link0).all())})
    # an index outside [0, d) is refused before the kernel would read it
    v, i, y, w = _ell_inputs(rng, 64, 300, 11.65, 69, dev, seed=3)
    for name, call in (
            ("glm_sparse", lambda bad: K.ell_glm_grad("lr", w, v, bad, y)),
            ("glm_sgd_sparse", lambda bad: K.ell_sgd_epoch(
                "lr", w, v, bad, y, step=0.05, micro_batch=10)),
            ("glm_score", lambda bad: K.glm_score("lr", w, v, bad))):
        for j in (-1, 300):
            bad = i.clone()
            bad[5, 0] = j
            try:
                call(bad)
                refused = False
            except ValueError:
                refused = True
            cases.append({"kernel": name, "case": f"index {j} with d=300 refused",
                          "ok": refused})
    torch.cuda.synchronize()
    return {"phase": "kernels", "cases": cases,
            "ok": all(c["ok"] for c in cases)}, worst


def main_path(covtype, w8a, n: int | None = None):
    """The six strategies of the training path, as (label, problem, strategy,
    sparse_data).  ``n`` cuts both datasets to their first n rows."""
    from repro_torch.core import glm, sgd, sparse

    X, yd = covtype
    m, ys = w8a
    if n is not None:
        X, yd = X[:n], yd[:n]
        m, ys = sparse.ELLMatrix(m.values[:n], m.indices[:n], m.d), ys[:n]
    nd, ns = X.shape[0], m.shape[0]
    per = ns // 10
    # full-batch steps scale as 1/N: the update uses the sum gradient
    return [
        ("covtype", glm.GLMProblem("lr", X, yd, 1.0 / nd), sgd.SyncSGD(), False),
        ("covtype", glm.GLMProblem("lr", X, yd, 0.01), sgd.SyncSGD(batch=16), False),
        ("covtype", glm.GLMProblem("lr", X, yd, 1e-3),
         sgd.AsyncLocalSGD(replicas=8, local_batch=1), False),
        ("w8a", ("lr", m, ys, 2.0 / ns), sgd.SyncSGD(), True),
        ("w8a", ("lr", m, ys, 0.2), sgd.AsyncLocalSGD(replicas=10, local_batch=10),
         True),
        ("w8a", ("lr", m, ys, 2.0),
         sgd.AsyncLocalSGD(replicas=10, local_batch=per), True),
    ]


def falling(losses: np.ndarray) -> bool:
    """Finite, lower at the end than at the start, and no epoch rising by
    more than 0.1% over the one before."""
    return bool(np.isfinite(losses).all() and losses[-1] < losses[0]
                and (losses[1:] <= losses[:-1] * (1 + 1e-3)).all())


#: the kernels of the training path (the serving path adds glm_score)
TRAIN_KERNELS = ("glm_grad", "glm_sgd", "glm_sgd_sparse", "glm_sparse")


def phase_train(covtype, w8a, epochs: int) -> tuple[dict, dict, list]:
    """The main path at full size; returns the phase line, the launches and
    the runs' results."""
    from repro_torch.core import convergence, sgd
    from repro_torch.kernels import common

    runs, results = [], []
    common.reset_launches()
    for data, problem, strat, sparse_data in main_path(covtype, w8a):
        res = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        results.append(res)
        runs.append({"data": data, "strategy": res.strategy,
                     "n": (problem[1].shape if sparse_data else problem.X.shape)[0],
                     "step": problem[3], "losses": res.losses.tolist(),
                     "ms_per_epoch": res.time_per_epoch * 1e3,
                     "epoch_ms": (res.epoch_times * 1e3).tolist(),
                     "falling": falling(res.losses)})
    launches = dict(common.LAUNCHES)
    ok = all(r["falling"] for r in runs) and all(launches[k] > 0
                                                 for k in TRAIN_KERNELS)
    # the paper's statistical and end-to-end axes: epochs and time to 1% of
    # the lowest loss any strategy reached on the same dataset
    for data in {r["data"] for r in runs}:
        mine = [(r, res) for r, res in zip(runs, results) if r["data"] == data]
        target = convergence.thresholds(
            convergence.optimal_loss(res for _, res in mine))[0.01]
        for r, res in mine:
            r["epochs_to_1pct"] = res.epochs_to(target)
            t = res.time_to(target)
            r["time_to_1pct_ms"] = None if t is None else t * 1e3
    # where an epoch's time goes: device busy time by kernel, one more epoch
    # each (after the launch counts were read)
    for run, (_, problem, strat, sparse_data) in zip(runs, main_path(covtype, w8a)):
        init, epoch_fn, _, _ = sgd.make_epoch_fn(problem, strat,
                                                  sparse_data=sparse_data)
        prof = device_profile(lambda: epoch_fn(init), 1)
        run["device_busy_ms"] = sum(ms for ms, _ in prof.values())
        run["device_idle_share"] = 1.0 - run["device_busy_ms"] / run["ms_per_epoch"]
        run["device_ms_by_kernel"] = {
            short_name(key): ms for key, (ms, _) in
            sorted(prof.items(), key=lambda kv: -kv[1][0])[:4]}
    return {"phase": "train", "epochs": epochs, "runs": runs,
            "launches": launches, "ok": ok}, launches, results


def phase_parity(covtype, w8a, n: int, epochs: int) -> dict:
    """The same strategies at n rows: kernels vs plain versions on the card."""
    from repro_torch.core import sgd
    from repro_torch.kernels import common

    runs = []
    for data, problem, strat, sparse_data in main_path(covtype, w8a, n):
        kern = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        with common.plain_versions():
            plain = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        err, ok = close(torch.from_numpy(kern.losses),
                        torch.from_numpy(plain.losses), LOSS_TOL)
        runs.append({"data": data, "strategy": kern.strategy,
                     "kernel_losses": kern.losses.tolist(),
                     "plain_losses": plain.losses.tolist(),
                     "max_abs_err": err, "ok": ok and falling(kern.losses)})
    return {"phase": "parity", "n": n, "tol": LOSS_TOL, "runs": runs,
            "ok": all(r["ok"] for r in runs)}


# ---------------------------------------------------------------------------
# The serving path and train-while-serving
# ---------------------------------------------------------------------------


def _requests(values: torch.Tensor, indices: torch.Tensor) -> list:
    """One ``ScoreRequest`` per ELL row, carrying only its nonzeros (the
    padding sits at the end of each row); the engine pads them back."""
    from repro_torch.serve.glm import ScoreRequest

    vals, idx = values.cpu().numpy(), indices.cpu().numpy()
    nnz = (vals != 0).sum(axis=1)
    return [ScoreRequest(r, vals[r, :nnz[r]], idx[r, :nnz[r]])
            for r in range(len(vals))]


def _drive(engine, reqs, swap=None) -> tuple[list, int, float]:
    """Admit until the bounded FIFO is full, flush, repeat, as
    benchmarks/bench_serve.py drives an engine; ``swap = (i, w)`` publishes
    ``w`` right after request i is admitted.  Returns the responses, the
    flushes that scored something, and the wall seconds."""
    responses, flushes, nxt = [], 0, 0
    t0 = time.perf_counter()
    while nxt < len(reqs) or len(engine):
        while nxt < len(reqs) and engine.try_admit(reqs[nxt]):
            nxt += 1
            if swap is not None and nxt == swap[0]:
                engine.swap_model(swap[1])
        batch = engine.flush()
        flushes += bool(batch)
        responses.extend(batch)
    return responses, flushes, time.perf_counter() - t0


def _quantiles(latencies) -> dict:
    lat = np.sort(np.asarray(latencies))
    return {"p50_ms": float(np.median(lat)) * 1e3,
            "p99_ms": float(lat[min(len(lat) - 1, int(0.99 * len(lat)))]) * 1e3}


def _busy_stretch(fn) -> dict:
    """Device busy ms and idle share over one profiled call of ``fn``: the
    device time of every kernel and copy the profiler saw, over the host
    wall time of the stretch (the profiler's own host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return {"stretch_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms}


def _check_scores(responses, values, indices, snapshots, task) -> dict:
    """Every response against the plain version over the same row under the
    weights of the snapshot version it carries (``snapshots``: version ->
    weights on the card)."""
    from repro_torch.kernels.glm_score.ref import glm_score_ref

    rid = torch.tensor([r.rid for r in responses], device=values.device)
    ver = np.array([r.model_version for r in responses])
    got = torch.tensor([r.score for r in responses], device=values.device)
    err, ok = 0.0, bool(np.isin(ver, list(snapshots)).all())
    for v in np.unique(ver):
        sel = torch.from_numpy(np.nonzero(ver == v)[0]).to(values.device)
        rows = rid[sel]
        e, o = close(got[sel], glm_score_ref(task, snapshots[int(v)],
                                             values[rows], indices[rows]),
                     GRAD_TOL)
        err, ok = max(err, e), ok and o
    return {"max_abs_err": err, "ok": ok,
            "versions": sorted(int(v) for v in np.unique(ver)),
            "versions_in_order": bool((np.diff(ver) >= 0).all())}


def phase_serve(dev, w8, realsim, w_sync, w_swap) -> tuple[dict, int]:
    """The scoring engine at full width; returns the phase line and the
    glm_score launches of its runs."""
    from repro_torch.kernels import common
    from repro_torch.serve.glm import GLMScoreEngine

    rng = np.random.default_rng(2)
    w_rs = torch.from_numpy(rng.normal(0, 0.1, realsim.d)
                            .astype(np.float32)).to(dev)
    cells = [("w8a", w8, 128, w_sync, w_swap), ("w8a", w8, 32, w_sync, None),
             ("real-sim", realsim, 128, w_rs, None)]
    runs, total = [], 0
    common.reset_launches()
    for data, ds, mb, w, w2 in cells:
        values, indices = ds.ell.values, ds.ell.indices
        reqs = _requests(values, indices)
        engine = GLMScoreEngine("lr", w, ell_width=ds.ell.max_nnz,
                                max_batch=mb, queue_depth=2 * mb,
                                flush_deadline_s=0.0)
        before = common.LAUNCHES["glm_score"]
        swap = None if w2 is None else (len(reqs) // 2, w2)
        responses, flushes, wall = _drive(engine, reqs, swap)
        launches = common.LAUNCHES["glm_score"] - before
        snapshots = {0: w} if w2 is None else {0: w, 1: w2}
        check = _check_scores(responses, values, indices, snapshots, "lr")
        # admission's host work on a row (its checks and copies), and the
        # index check alone, over this run's requests
        t0 = time.perf_counter()
        for r in reqs:
            engine._admit_row(r)
        admit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in reqs:
            common.check_host_indices(f"request {r.rid}",
                                      np.asarray(r.indices), ds.d)
        check_s = time.perf_counter() - t0
        run = {"data": data, "n": len(reqs), "d": ds.d, "K": ds.ell.max_nnz,
               "max_batch": mb, "device": str(engine.device),
               "requests_per_s": len(reqs) / wall, "wall_s": wall,
               **_quantiles([r.latency_s for r in responses]),
               "flushes": flushes, "glm_score_launches": launches,
               "swap_at": None if swap is None else swap[0],
               "admit_row_us_per_request": admit_s / len(reqs) * 1e6,
               "index_check_us_per_request": check_s / len(reqs) * 1e6,
               "index_check_us_per_batch": check_s / flushes * 1e6,
               "check": check}
        # one profiled stretch: the first 64 batches again, on a fresh engine
        stretch = GLMScoreEngine("lr", w, ell_width=ds.ell.max_nnz,
                                 max_batch=mb, queue_depth=2 * mb,
                                 flush_deadline_s=0.0)
        run["profiled"] = {"requests": 64 * mb, **_busy_stretch(
            lambda: _drive(stretch, reqs[:64 * mb]))}
        run["ok"] = bool(
            engine.device.type == "cuda" and launches == flushes
            and len(responses) == len(reqs) and check["ok"]
            and sorted(r.rid for r in responses) == list(range(len(reqs)))
            and check["versions"] == sorted(snapshots)
            and check["versions_in_order"])
        runs.append(run)
        total += launches
    return {"phase": "serve", "tol": GRAD_TOL, "runs": runs,
            "ok": all(r["ok"] for r in runs)}, total


#: the live stream at real-sim's width (Table 3), and its learner
LIVE_STREAM = dict(n_batch=256, d=20_958, avg_nnz=51.3, max_nnz=307)
LIVE_CONFIG = dict(task="lr", replicas=8, merge_every=4, local_batch=1,
                   step_size=0.1)


def _record_merges(learner) -> list[dict]:
    """Wrap ``learner.merge`` to keep, at every merge that ran, what went
    into it (the replicas, the anchor, the error feedback, the alive mask)
    and the anchor it made."""
    records, merge = [], learner.merge

    def recorded():
        ef = learner._ef
        before = {"W": learner.W.clone(), "anchor": learner.anchor.clone(),
                  "ef": None if ef is None else ef.clone(),
                  "alive": learner.alive()}
        out = merge()
        if out is not None:
            records.append({**before, "out": out.clone()})
        return out

    learner.merge = recorded
    return records


def _live_run(cfg: dict, stream_kw: dict, steps: int, faults: dict,
              serve: bool) -> dict:
    """One learner run on the card; with ``serve``, a SnapshotPublisher
    feeds a GLMScoreEngine that a second thread serves throughout."""
    import threading

    from repro_torch.kernels import common
    from repro_torch.live import (LiveConfig, LiveLearner, SnapshotPublisher,
                                  SyntheticStream)
    from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest

    stream = SyntheticStream(seed=7, **stream_kw)
    learner = LiveLearner(LiveConfig(**cfg), stream)
    out = {"device": str(learner.device)}
    if not stream.dense:
        hold, hy = stream.holdout(1024)
        out["holdout_loss_start"] = learner.loss(hold, hy)
    engine = None
    if serve:
        engine = GLMScoreEngine(cfg["task"], learner.merged_model,
                                ell_width=stream.ell_width, max_batch=128,
                                queue_depth=256, flush_deadline_s=0.0)
        pub = SnapshotPublisher(engine).attach(learner)
        bound = pub.bound_steps(learner.config.merge_every)
        snapshots = {0: engine.model.w}
        learner.add_merge_hook(
            lambda _: snapshots.setdefault(engine.model.version,
                                           engine.model.w))
        reqs = _requests(hold.values, hold.indices)
        served, flushes, stop = [], [0], threading.Event()

        def server():
            rid = 0
            while not stop.is_set() or len(engine):
                while not stop.is_set():
                    row = reqs[rid % len(reqs)]
                    if not engine.try_admit(
                            ScoreRequest(rid, row.values, row.indices)):
                        break
                    rid += 1
                batch = engine.flush()
                flushes[0] += bool(batch)
                served.extend(batch)

        thread = threading.Thread(target=server)
    common.reset_launches()
    staleness = []
    t0 = time.perf_counter()
    if serve:
        thread.start()
    try:
        for i in range(steps):
            for r in faults.get(i, {}).get("kill", ()):
                learner.kill(r)
            for r in faults.get(i, {}).get("revive", ()):
                learner.revive(r)
            learner.step()
            if serve:
                staleness.append(pub.staleness(learner))
    finally:
        if serve:
            stop.set()
            thread.join(timeout=120)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = dict(common.LAUNCHES)
    out["steps"], out["merges"] = learner.steps, learner.merges
    if not stream.dense:
        out["holdout_loss_end"] = learner.loss(hold, hy)
    if serve:
        lag = [s for s in staleness if s is not None]
        rows = torch.tensor([r.rid % len(reqs) for r in served],
                            device=hold.values.device)
        remapped = [dataclasses.replace(r, rid=i) for i, r in enumerate(served)]
        out["serve"] = {
            "thread_done": not thread.is_alive(), "responses": len(served),
            "flushes": flushes[0], "publishes": pub.publishes,
            "staleness_max": max(lag) if lag else None, "bound_steps": bound,
            **_quantiles([r.latency_s for r in served]),
            "check": _check_scores(remapped, hold.values[rows],
                                   hold.indices[rows], snapshots, cfg["task"])}
    return out


def _twin(cfg: dict, stream_kw: dict, steps: int, faults: dict,
          resync: bool) -> dict:
    """The learner through the kernels and the same learner through the
    plain versions, step by step on the same stream, every merge recorded
    in both.  With ``resync`` the plain learner takes the kernel learner's
    state after each merge, so that every merge compares the work of one
    interval from the same start."""
    from repro_torch.kernels import common
    from repro_torch.live import LiveConfig, LiveLearner, SyntheticStream

    kern, plain = (LiveLearner(LiveConfig(**cfg),
                               SyntheticStream(seed=7, **stream_kw))
                   for _ in range(2))
    records = [_record_merges(kern), _record_merges(plain)]
    common.reset_launches()
    for i in range(steps):
        for learner in (kern, plain):
            for r in faults.get(i, {}).get("kill", ()):
                learner.kill(r)
            for r in faults.get(i, {}).get("revive", ()):
                learner.revive(r)
        merges = kern.merges
        kern.step()
        with common.plain_versions():
            plain.step()
        if resync and kern.merges > merges:
            plain.W, plain.anchor = kern.W.clone(), kern.anchor.clone()
            if kern._ef is not None:
                plain._ef = kern._ef.clone()
    torch.cuda.synchronize()
    return {"launches": dict(common.LAUNCHES),
            "held": {"resync": resync, **_held(*records, resync)}}


def _codes(a: dict, b: dict) -> dict:
    """The int8 codes both runs' merge made from its inputs, replica by
    alive replica (as ``optim.compress.quantize_leaf`` makes them), and
    where they differ: ``x`` is a delta in units of its block's step, and
    a code differs only where the two runs' ``x`` lie on either side of a
    half step (``dist``: the plain run's distance to it) and no further
    apart than the replicas' EPOCH_TOL and the difference of the anchors
    and error feedbacks let them (``xtol``).  ``slack`` is what the
    differing codes and scales can move the merged anchor by."""
    from repro_torch.optim import compress as C

    d = a["W"].shape[1]
    alive = np.nonzero(b["alive"])[0]
    out = {"compared": 0, "flips": 0, "max_code_diff": 0, "max_dist": 0.0,
           "max_x_diff": 0.0, "explained": True,
           "slack": torch.zeros_like(b["out"])}
    for r in alive:
        qx = []
        for run in (a, b):
            delta = run["W"][r] - run["anchor"] + run["ef"][r]
            q, s = C.quantize_leaf(delta)
            step = s.expand(-1, C.BLOCK).reshape(-1)[:d]
            qx.append((q.reshape(-1)[:d].int(), step, delta / step))
        (qa, sa, xa), (qb, sb, xb) = qx
        diff = (qa - qb).abs()
        flip = diff > 0
        dist = (xb - torch.floor(xb) - 0.5).abs()
        xdiff = (xa - xb).abs()
        dtol = (EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * b["W"][r].abs()
                + (a["anchor"] - b["anchor"]).abs()
                + (a["ef"][r] - b["ef"][r]).abs())
        xtol = dtol / sa + xb.abs() * (sa - sb).abs() / sa
        out["compared"] += d
        out["flips"] += int(flip.sum())
        out["max_code_diff"] = max(out["max_code_diff"], int(diff.max()))
        if flip.any():
            out["max_dist"] = max(out["max_dist"], float(dist[flip].max()))
            out["max_x_diff"] = max(out["max_x_diff"], float(xdiff[flip].max()))
            out["explained"] = out["explained"] and bool(
                ((dist <= xdiff) & (xdiff <= xtol))[flip].all())
        out["slack"] = out["slack"] + (
            diff * sa + 127 * (sa - sb).abs()) / len(alive)
    return out


def _held(kernel: list, plain: list, resync: bool) -> dict:
    """The kernel run against the plain run, merge by merge.  The inputs of
    the merge (the replicas) agree within EPOCH_TOL.  An exact merge's
    anchor agrees within EPOCH_TOL too.  An int8 merge's codes differ by at
    most one, only where the two runs' deltas straddle a half step within
    round-off (``_codes``), and its anchor within EPOCH_TOL plus what those
    codes and scales move it by.  Without ``resync`` two int8 runs part at
    the first merge whose codes differ: that merge is the last one held,
    and the errors after it are reported only."""
    out = {"merges": len(kernel), "checked_merges": 0,
           "inputs_max_abs_err": 0.0, "anchor_max_abs_err": 0.0,
           "first_differing_merge": None}
    ok = len(kernel) == len(plain) > 0
    codes = []
    for m, (a, b) in enumerate(zip(kernel, plain)):
        err, inputs_ok = close(a["W"], b["W"], EPOCH_TOL)
        out["inputs_max_abs_err"] = max(out["inputs_max_abs_err"], err)
        err, anchor_ok = close(a["out"], b["out"], EPOCH_TOL)
        out["anchor_max_abs_err"] = max(out["anchor_max_abs_err"], err)
        if out["first_differing_merge"] is not None and not resync:
            continue
        out["checked_merges"] += 1
        ok = ok and inputs_ok and bool((a["alive"] == b["alive"]).all())
        if b["ef"] is None:
            ok = ok and anchor_ok
            continue
        c = _codes(a, b)
        bound = (EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * b["out"].abs()
                 + c.pop("slack"))
        ok = ok and c["max_code_diff"] <= 1 and c["explained"] and bool(
            ((a["out"] - b["out"]).abs() <= bound).all())
        codes.append(c)
        if c["flips"] and out["first_differing_merge"] is None:
            out["first_differing_merge"] = m
    if codes:
        out["int8_codes"] = {
            "compared": sum(c["compared"] for c in codes),
            "differing": sum(c["flips"] for c in codes),
            "differing_by_merge": [c["flips"] for c in codes],
            "max_code_diff": max(c["max_code_diff"] for c in codes),
            "differing_max_dist_to_half_step": max(c["max_dist"] for c in codes),
            "differing_max_x_diff": max(c["max_x_diff"] for c in codes),
            "all_explained": all(c["explained"] for c in codes)}
    out["ok"] = bool(ok)
    return out


def phase_live(dev) -> dict:
    """Train-while-serving on the card; each configuration also run step
    by step through the kernels and through the plain versions."""
    faults = {16: {"kill": (1, 3)}, 40: {"revive": (1, 3)}}
    runs = []
    for compress in (False, True):
        cfg = dict(LIVE_CONFIG, compress=compress)
        kern = _live_run(cfg, LIVE_STREAM, 64, faults, serve=True)
        # the same learner with no serving thread beside it
        alone = _live_run(cfg, LIVE_STREAM, 64, faults, serve=False)
        # free-running: an int8 code rounded the other way at one merge
        # carries into every later one, so an int8 pair is held up to that
        # merge, and once more with the plain learner resynced after each
        # merge, which holds every merge to one interval's work
        twins = [_twin(cfg, LIVE_STREAM, 64, faults, resync=r)
                 for r in ((False, True) if compress else (False,))]
        srv = kern["serve"]
        run = {"path": "glm_sgd_sparse", "compress": compress, "steps": 64,
               "kill_at": 16, "revive_at": 40, "device": kern["device"],
               "wall_s": kern["wall_s"], "wall_s_without_serving":
               alone["wall_s"], "merges": kern["merges"],
               "holdout_loss": [kern["holdout_loss_start"],
                                kern["holdout_loss_end"]],
               "launches": kern["launches"], "serve": srv,
               "vs_plain": [t["held"] for t in twins]}
        run["ok"] = bool(
            kern["device"].startswith("cuda")
            and kern["holdout_loss_end"] < kern["holdout_loss_start"]
            and all(h["ok"] for h in run["vs_plain"]) and srv["check"]["ok"]
            and srv["check"]["versions_in_order"] and srv["thread_done"]
            and srv["staleness_max"] is not None
            and srv["staleness_max"] <= srv["bound_steps"]
            and kern["launches"]["glm_sgd_sparse"] == 64
            and all(t["launches"]["glm_sgd_sparse"] == 64 for t in twins)
            and kern["launches"]["glm_score"] == srv["flushes"] > 0)
        runs.append(run)
    # the two other replica passes, short: the full-partition sum gradient
    # (local_batch == per) and a dense stream at covtype's width
    for path, cfg, stream_kw in (
            ("glm_sparse", dict(LIVE_CONFIG, local_batch=32), LIVE_STREAM),
            ("glm_sgd", LIVE_CONFIG, dict(n_batch=256, d=54, dense=True))):
        twin = _twin(cfg, stream_kw, 8, {}, resync=False)
        run = {"path": path, "compress": False, "steps": 8,
               "local_batch": cfg["local_batch"], "d": stream_kw["d"],
               "launches": twin["launches"], "vs_plain": [twin["held"]]}
        run["ok"] = bool(twin["held"]["ok"]
                         and twin["launches"][path] == 8)
        runs.append(run)
    return {"phase": "live", "stream": LIVE_STREAM, "config": LIVE_CONFIG,
            "tol": EPOCH_TOL, "runs": runs, "ok": all(r["ok"] for r in runs)}


def phase_timing(covtype, w8a, worst: dict) -> tuple[list[dict], list[dict]]:
    """Each kernel and its plain version at the main path's shapes: one
    timed row per kernel (glm_score: a serving batch and all of w8a), and a
    check of the two shapes those rows leave out (the replica epochs at the
    full partition size)."""
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_score.ref import glm_score_ref
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    X, yd = covtype
    m, ys = w8a
    n, d = X.shape
    ns, k = m.values.shape
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(X.device)
    ws = torch.from_numpy(rng.normal(0, 0.1, m.d).astype(np.float32)).to(X.device)
    nnz = int((m.values != 0).sum())
    rows = []

    def row(name, shape, kernel, plain, reps, plain_reps, in_bytes, flops, tol,
            library=None, line=True):
        out, ref = kernel(), plain()
        err, ok = close(out, ref, tol)
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        b, by = bound_ms(in_bytes, flops)
        lib = {"library_ms": None}
        if library is not None:
            lib = {"library_ms": cuda_ms(library, reps),
                   "library_max_abs_err": close(library(), ref, tol)[0]}
        rows.append({"name": name, "route": "cuda", "line": line,
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "shape": shape,
                     "max_abs_err": err, "ok": ok,
                     "check_max_abs_err": worst[name], "ms": ms,
                     "device_ms": kernel_device_ms(device_profile(kernel, reps),
                                                   KERNEL_SYMBOLS[name]),
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     **lib})

    # SyncSGD() on covtype: the full-batch sum gradient
    row("glm_grad", f"covtype N={n} d={d} row",
        lambda: K.glm_grad("lr", w, X, yd), lambda: glm_grad_ref("lr", w, X, yd),
        20, 20, nbytes(X, yd, w) + 4 * d, 4.0 * n * d + 8.0 * n, GRAD_TOL)
    # SyncSGD(batch=16) on covtype: one fused epoch, 36,314 updates
    row("glm_sgd", f"covtype N={n} d={d} MB=16 R=1",
        lambda: K.glm_sgd_epoch("lr", w, X, yd, step=0.01, micro_batch=16),
        lambda: glm_sgd_epoch_ref("lr", w[None], X[None], yd[None], 0.01, 16)[0],
        3, 1, nbytes(X, yd, w) + 4 * d, 4.0 * n * d + 8.0 * n, EPOCH_TOL)
    # AsyncLocalSGD(replicas=10, local_batch=10) on w8a: replica epochs
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).to(X.device).long()
    vp, ip, yp = m.values[parts], m.indices[parts], ys[parts]
    W = ws[None].repeat(10, 1)
    row("glm_sgd_sparse", f"w8a N={ns} K={k} d={m.d} R=10 MB=10",
        lambda: K.ell_sgd_epoch("lr", W, vp, ip, yp, step=0.2, micro_batch=10),
        lambda: ell_sgd_epoch_ref("lr", W, vp, ip, yp, 0.2, 10),
        10, 1, ell_bytes(vp) + nbytes(yp, W, W), 4.0 * nnz + 8.0 * ns,
        EPOCH_TOL)
    # SyncSGD() on w8a: the full-batch sparse sum gradient
    row("glm_sparse", f"w8a N={ns} K={k} d={m.d} R=1",
        lambda: K.ell_glm_grad("lr", ws, m.values, m.indices, ys),
        lambda: ell_glm_grad_ref("lr", ws[None], m.values[None], m.indices[None],
                                 ys[None])[0],
        20, 20, ell_bytes(m.values) + nbytes(ys, ws, ws), 4.0 * nnz + 8.0 * ns,
        GRAD_TOL)

    # the serving path: glm_score on one 128-row batch, which is what a
    # flush launches (the kernels line's row), and on all of w8a.  The
    # yardstick is one embedding_bag with per-sample weights, which is the
    # SVM score; the LR score adds a sigmoid, timed with it
    idx64 = m.indices.long()
    for rows_n, reps, line in ((128, 200, True), (ns, 20, False)):
        v, i, i64 = m.values[:rows_n], m.indices[:rows_n], idx64[:rows_n]
        touched = int(torch.unique(i[v != 0]).numel())
        row("glm_score", f"w8a N={rows_n} K={k} d={m.d} lr",
            lambda: K.glm_score("lr", ws, v, i),
            lambda: glm_score_ref("lr", ws, v, i), reps, reps,
            ell_bytes(v) + 4 * rows_n + 4 * touched,
            2.0 * int((v != 0).sum()) + 4.0 * rows_n, GRAD_TOL,
            library=lambda: torch.sigmoid(torch.nn.functional.embedding_bag(
                i64, ws.view(-1, 1), per_sample_weights=v, mode="sum"))[:, 0],
            line=line)

    checks = []

    def check(name, shape, out, ref, tol):
        err, ok = close(out, ref, tol)
        checks.append({"kernel": name, "shape": shape, "max_abs_err": err,
                       "tol": tol, "ok": ok})

    # AsyncLocalSGD(replicas=8, local_batch=1) on covtype: 72,626 updates
    # per replica, replicas 125 MB apart
    parts8 = torch.from_numpy(sgd.partition_indices(n, 8)).to(X.device).long()
    Xp, ydp = X[parts8], yd[parts8]
    W8 = w[None] * torch.linspace(-1.0, 1.0, 8, device=X.device)[:, None]
    check("glm_sgd", f"covtype R=8 per={Xp.shape[1]} d={d} MB=1",
          K.glm_sgd_epoch("lr", W8, Xp, ydp, step=1e-3, micro_batch=1),
          glm_sgd_epoch_ref("lr", W8, Xp, ydp, 1e-3, 1), EPOCH_TOL)
    del Xp
    # AsyncLocalSGD(replicas=10, local_batch=per) on w8a: the full-partition
    # sum gradient over the replica axis
    check("glm_sparse", f"w8a R=10 per={vp.shape[1]} K={k} d={m.d}",
          K.ell_glm_grad("lr", W, vp, ip, yp),
          ell_glm_grad_ref("lr", W, vp, ip, yp), GRAD_TOL)
    return rows, checks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.data import synthetic
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())

    line, worst = phase_kernels(dev)
    emit(line)
    if not line["ok"]:
        return 1

    t0 = time.perf_counter()
    cov = synthetic.paper_dataset("covtype", seed=0, device=dev)
    w8 = synthetic.paper_dataset("w8a", seed=0, device=dev)
    covtype, w8a = (cov.X, cov.y), (w8.ell, w8.y)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "covtype": list(cov.X.shape), "w8a": [w8.n, w8.d, w8.ell.max_nnz],
          "w8a_nnz": int((w8.ell.values != 0).sum())})

    line, launches, results = phase_train(covtype, w8a, epochs=4)
    emit(line)
    if not line["ok"]:
        return 1
    line = phase_parity(covtype, w8a, n=4100, epochs=3)
    emit(line)
    if not line["ok"]:
        return 1

    # the serving path: w8a under the model SyncSGD ended with, swapped
    # halfway for the one AsyncLocalSGD(replicas=10, local_batch=10) merged
    realsim = synthetic.paper_dataset("real-sim", seed=0, max_n=8192,
                                      device=dev)
    line, launches["glm_score"] = phase_serve(
        dev, w8, realsim, results[3].model, results[4].model[0])
    emit(line)
    if not line["ok"]:
        return 1
    checks = [{"kernel": "glm_score", "max_abs_err": r["check"]["max_abs_err"]}
              for r in line["runs"]]
    line = phase_live(dev)
    emit(line)
    if not line["ok"]:
        return 1

    rows, full_checks = phase_timing(covtype, w8a, worst)
    checks += full_checks
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            c["max_abs_err"] for c in checks if c["kernel"] == r["name"]])
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "full_shape_checks": full_checks,
          "seconds_total": time.perf_counter() - t_start})
    if not all(r["ok"] for r in rows + full_checks):
        return 1

    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in rows if r["line"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
