"""Paper Fig 14/15: k-wise data replication (rep-0/2/5/10).
The port's twin of the reference's ``benchmarks/fig14_data_replication.py``.

Asserts the paper's trade: hardware efficiency drops ~linearly in k (each
replica processes k extra examples) while statistical efficiency improves."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import sgd

KS = (0, 2, 5, 10)


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile)[:2]:
        dspec = common.dataset_spec(name, profile)
        for task in ("lr",):
            per = {}
            for k in KS:
                strat = sgd.AsyncLocalSGD(replicas=8, local_batch=1, rep_k=k)
                step, res, target = common.tune(
                    dspec, task, strat, p["epochs"], steps=(1e-2, 1e-1))
                per[k] = res
            best = min(float(np.nanmin(r.losses)) for r in per.values())
            target = best * 1.01 if best > 0 else best * 0.99
            for k, res in per.items():
                rows.append(dict(
                    dataset=name, task=task, rep_k=k,
                    t_epoch_ms=1e3 * res.time_per_epoch,
                    epochs_to_1pct=res.epochs_to(target),
                    final_loss=float(res.losses[-1]),
                ))
    common.write_csv(rows, "fig14_data_replication.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
