"""Paper Fig 11/12: model-replication granularity (kernel/block/thread).
The port's twin of the reference's ``benchmarks/fig11_model_replication.py``.

replicas=1 ≙ kernel (one shared model), 8 ≙ block, 64 ≙ thread.  Asserts the
paper's monotonic finding: statistical efficiency degrades with replication
while per-epoch cost (with merges amortized) improves or holds."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import sgd

LEVELS = {"kernel": 1, "block": 8, "thread": 64}


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile)[:2]:
        dspec = common.dataset_spec(name, profile)
        n = dspec.profile().n
        for task in ("lr",):
            per = {}
            for label, r in LEVELS.items():
                if n < r * 2:
                    continue
                strat = sgd.AsyncLocalSGD(replicas=r, local_batch=1)
                step, res, target = common.tune(
                    dspec, task, strat, p["epochs"], steps=(1e-2, 1e-1))
                per[label] = res
            best = min(float(np.nanmin(r.losses)) for r in per.values())
            target = best * 1.01 if best > 0 else best * 0.99
            for label, res in per.items():
                rows.append(dict(
                    dataset=name, task=task, replication=label,
                    replicas=LEVELS[label],
                    t_epoch_ms=1e3 * res.time_per_epoch,
                    epochs_to_1pct=res.epochs_to(target),
                    final_loss=float(res.losses[-1]),
                ))
    common.write_csv(rows, "fig11_model_replication.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
