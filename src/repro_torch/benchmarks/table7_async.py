"""Paper Table 7/8: asynchronous SGD — time to convergence, time/iter,
#iterations for seq / parallel(8 replicas) / massively-parallel(64 replicas,
the GPU-analogue) configurations.

The port's twin of the reference's ``benchmarks/table7_async.py``.  The
paper's claim reproduced here: more replicas buy hardware efficiency per
pass but cost statistical efficiency; the massively-replicated
configuration needs rep-k data replication to converge well.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import sgd


CONFIGS = {
    "seq": sgd.AsyncLocalSGD(replicas=1, local_batch=1),
    "cpu-par": sgd.AsyncLocalSGD(replicas=8, local_batch=1),
    "gpu-norep": sgd.AsyncLocalSGD(replicas=64, local_batch=1),
    "gpu-rep10": sgd.AsyncLocalSGD(replicas=64, local_batch=1, rep_k=10),
}


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile):
        dspec = common.dataset_spec(name, profile)
        n = dspec.profile().n
        for task in common.TASKS:
            per_cfg = {}
            for label, strat in CONFIGS.items():
                if n < strat.replicas * 2:
                    continue
                step, res, target = common.tune(
                    dspec, task, strat, p["epochs"])
                per_cfg[label] = (res, target, step)
            # common target: within 1% of the best loss seen anywhere
            best = min(float(np.nanmin(r.losses))
                       for r, _, _ in per_cfg.values())
            target = best * 1.01 if best > 0 else best * 0.99
            for label, (res, _, step) in per_cfg.items():
                rows.append(dict(
                    dataset=name, task=task, config=label,
                    t_iter_ms=1e3 * res.time_per_epoch,
                    iters_to_1pct=res.epochs_to(target),
                    time_to_1pct_s=res.time_to(target),
                    final_loss=float(res.losses[-1]),
                    best_step=step,
                ))
    common.write_csv(rows, "table7_async.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
