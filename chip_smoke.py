#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the SGD study engine on one NVIDIA card.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, one JSON line each:

1. ``env``     card name and power limit, torch, CUDA, nvcc, triton;
2. ``build``   compiles the four kernels from src/repro_torch/kernels/csrc
               (one nvcc per source, all at once) and reports ptxas usage;
3. ``kernels`` holds each kernel against its plain PyTorch version on the
               card: both tasks, both glm_grad layouts, covtype and w8a
               widths, a ragged N, a replica axis, real-sim's width; and
               that the sparse kernels refuse an index outside [0, d);
4. ``train``   ``repro_torch.core.sgd.run`` at the full size of the paper's
               covtype (581,012 x 54, dense) and w8a (64,700 x 300, K=69,
               padded ELL) stand-ins, six strategies; launch counts are zeroed
               just before and read just after; then the same strategies at
               N=4,100 through the kernels and through the plain versions on
               the card, loss for loss;
5. ``timing``  each kernel and its plain version at the main path's shapes,
               and a check of the async replica epochs at the full partition
               size (covtype R=8 B=1, w8a R=10 full partition).

It then prints the card's name and power limit, a ``{"kernels": [...]}`` line
(launches on the main path, error, times, bound) and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without a card, or without the repository beside it, it fails.
"""
from __future__ import annotations

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
}


#: the __global__ functions each wrapper launches (csrc/<name>.cu)
KERNEL_SYMBOLS = {
    "glm_sgd": ("glm_sgd_kernel",),
    "glm_grad": ("glm_grad_row_kernel", "glm_grad_col_kernel",
                 "glm_grad_reduce_kernel"),
    "glm_sgd_sparse": ("ell_sgd_kernel",),
    "glm_sparse": ("ell_grad_kernel",),
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


def phase_kernels(dev) -> tuple[dict, dict]:
    """Every kernel against its plain version on the card, small shapes."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
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
    # an index outside [0, d) is refused before the kernel would read it
    v, i, y, w = _ell_inputs(rng, 64, 300, 11.65, 69, dev, seed=3)
    for name, call in (
            ("glm_sparse", lambda bad: K.ell_glm_grad("lr", w, v, bad, y)),
            ("glm_sgd_sparse", lambda bad: K.ell_sgd_epoch(
                "lr", w, v, bad, y, step=0.05, micro_batch=10))):
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


def phase_train(covtype, w8a, epochs: int) -> tuple[dict, dict]:
    """The main path at full size; returns the phase line and the launches."""
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
    ok = all(r["falling"] for r in runs) and all(v > 0 for v in launches.values())
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
            "launches": launches, "ok": ok}, launches


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


def phase_timing(covtype, w8a, worst: dict) -> tuple[list[dict], list[dict]]:
    """Each kernel and its plain version at the main path's shapes: one
    timed row per kernel, and a check of the two shapes those rows leave
    out (the replica epochs at the full partition size)."""
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
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

    def row(name, shape, kernel, plain, reps, plain_reps, in_bytes, flops, tol):
        out, ref = kernel(), plain()
        err, ok = close(out, ref, tol)
        ms = cuda_ms(kernel, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        b, by = bound_ms(in_bytes, flops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "shape": shape,
                     "max_abs_err": err, "ok": ok,
                     "check_max_abs_err": worst[name], "ms": ms,
                     "device_ms": kernel_device_ms(device_profile(kernel, reps),
                                                   KERNEL_SYMBOLS[name]),
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None})

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
        10, 1, nbytes(vp, ip, yp, W, W), 4.0 * nnz + 8.0 * ns, EPOCH_TOL)
    # SyncSGD() on w8a: the full-batch sparse sum gradient
    row("glm_sparse", f"w8a N={ns} K={k} d={m.d} R=1",
        lambda: K.ell_glm_grad("lr", ws, m.values, m.indices, ys),
        lambda: ell_glm_grad_ref("lr", ws[None], m.values[None], m.indices[None],
                                 ys[None])[0],
        20, 20, nbytes(m.values, m.indices, ys, ws, ws), 4.0 * nnz + 8.0 * ns,
        GRAD_TOL)

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

    line, launches = phase_train(covtype, w8a, epochs=4)
    emit(line)
    if not line["ok"]:
        return 1
    line = phase_parity(covtype, w8a, n=4100, epochs=3)
    emit(line)
    if not line["ok"]:
        return 1

    rows, checks = phase_timing(covtype, w8a, worst)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            c["max_abs_err"] for c in checks if c["kernel"] == r["name"]])
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "full_shape_checks": checks,
          "seconds_total": time.perf_counter() - t_start})
    if not all(r["ok"] for r in rows + checks):
        return 1

    print(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
