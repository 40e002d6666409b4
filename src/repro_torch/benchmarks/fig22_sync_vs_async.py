"""Paper Fig 22/23: best synchronous vs best asynchronous, loss-vs-time.

The port's twin of the reference's ``benchmarks/fig22_sync_vs_async.py``.
Same hyper-parameters and initialization; the paper's conclusion — the
winner is task/dataset-dependent (BGD vs SGD in disguise) — is reproduced
as a per-(dataset, task) verdict table."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import sgd


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile):
        dspec = common.dataset_spec(name, profile)
        for task in common.TASKS:
            _, sync_res, _ = common.tune(
                dspec, task, sgd.SyncSGD(), p["epochs"])
            _, async_res, _ = common.tune(
                dspec, task, sgd.AsyncLocalSGD(replicas=8, local_batch=1),
                p["epochs"], steps=(1e-2, 1e-1))
            best = min(float(np.nanmin(sync_res.losses)),
                       float(np.nanmin(async_res.losses)))
            target = best * 1.01 if best > 0 else best * 0.99
            ts = sync_res.time_to(target)
            ta = async_res.time_to(target)
            winner = ("sync" if (ta is None or (ts is not None and ts <= ta))
                      else "async")
            rows.append(dict(
                dataset=name, task=task,
                sync_time_to_1pct_s=ts, async_time_to_1pct_s=ta,
                winner=winner))
    common.write_csv(rows, "fig22_sync_vs_async.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
