"""Paper Table 4/5: synchronous SGD — time to convergence, time/iteration,
#iterations; speedups of fused vs primitive-composition vs sequential.

The port's twin of the reference's ``benchmarks/table4_sync.py``.
Execution paths: ``seq`` (incremental SGD, the paper's cpu-seq: Algorithm
3 as the ``glm_sgd`` kernel at micro-batch 1 on one replica, which is the
same function as ``glm.incremental_epoch``; on CPU tensors the wrapper
runs its plain version), ``sync-comp`` (primitive composition, one launch
per primitive — the ViennaCL/TF/BIDMach analogue) and ``sync`` (the fused
gradient expression).  The reference computes both sync paths in plain
XLA, outside any Pallas kernel; here they are plain PyTorch.  The paper's
headline claims asserted here:
  * sync statistical efficiency is identical across execution paths;
  * fused beats composition in time/iteration (hardware efficiency);
  * parallel (vectorized batch) crushes sequential by orders of magnitude.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks import common
from repro_torch.core import glm, sgd, sparse
from repro_torch.kernels.glm_sgd import glm_sgd_epoch
from repro_torch.utils.timing import median_time

#: densification cap (news-style): past it the sync paths run on the
#: first DENSE_CAP_ROWS rows
DENSE_CAP = 5e7
DENSE_CAP_ROWS = 1024


def dense_operands(ds):
    """(X, y) the three paths time: the dense data, or the padded ELL
    densified (its first DENSE_CAP_ROWS rows past DENSE_CAP elements; the
    rows are cut before densifying, which gives the same matrix)."""
    if ds.dense:
        return ds.X, ds.y
    m, y = ds.ell, ds.y
    if m.shape[0] * m.shape[1] > DENSE_CAP:
        m = sparse.ELLMatrix(m.values[:DENSE_CAP_ROWS],
                             m.indices[:DENSE_CAP_ROWS], m.d)
        y = y[:DENSE_CAP_ROWS]
    return sparse.to_dense(m), y


def seq_epoch(task: str, w, X, y, step: float):
    """Algorithm 3 (per-example SGD, in order) as one fused epoch."""
    return glm_sgd_epoch(task, w, X, y, step=step, micro_batch=1)


def _sync_paths(ds, task, step):
    """time/iteration for the three execution paths on one dataset."""
    X, y = dense_operands(ds)
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)

    def fused(w):
        return w - step * glm.grad_fused(task, w, X, y)

    def comp(w):
        return w - step * glm.grad_primitive_composition(task, w, X, y)

    def seq(w):
        return seq_epoch(task, w, X, y, step)

    out = {}
    out["sync"] = median_time(fused, w, warmup=1, iters=3)
    out["sync-comp"] = median_time(comp, w, warmup=1, iters=3)
    out["seq"] = median_time(seq, w, warmup=1, iters=3)
    # statistical-efficiency identity: same loss trajectory fused vs comp
    wf, wc = w, w
    for _ in range(3):
        wf, wc = fused(wf), comp(wc)
    out["_path_equiv"] = bool(torch.allclose(wf, wc, rtol=1e-3, atol=1e-3))
    return out


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile):
        dspec = common.dataset_spec(name, profile)
        ds = common.load(name, profile)
        for task in common.TASKS:
            t = _sync_paths(ds, task, 1e-3)
            strategy = sgd.SyncSGD()
            step, res, target = common.tune(
                dspec, task, strategy, p["epochs"])
            iters = res.epochs_to(target)
            rows.append(dict(
                dataset=name, task=task, n=ds.n,
                t_iter_sync_ms=1e3 * t["sync"],
                t_iter_comp_ms=1e3 * t["sync-comp"],
                t_iter_seq_ms=1e3 * t["seq"],
                speedup_fused_vs_comp=t["sync-comp"] / t["sync"],
                speedup_sync_vs_seq=t["seq"] / t["sync"],
                iters_to_1pct=iters,
                time_to_1pct_s=res.time_to(target),
                best_step=step,
                paths_statistically_identical=t["_path_equiv"],
            ))
    common.write_csv(rows, "table4_sync.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
