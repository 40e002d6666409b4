"""Paper Fig 8/9: data-access-path selection (row/col x rr/ch).
The port's twin of the reference's ``benchmarks/fig8_access_path.py``.

Engine level: chunk vs round-robin example assignment, hardware
efficiency (time/epoch) and statistical efficiency (epochs to target).
(The row/col layouts of the gradient kernel are timed by
``chip_smoke.py``'s phase ``timing``.)
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import sgd


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    rows = []
    for name in common.profile_datasets(profile)[:2]:
        dspec = common.dataset_spec(name, profile)
        for task in ("lr",):
            per = {}
            for access in ("chunk", "round_robin"):
                strat = sgd.AsyncLocalSGD(replicas=8, local_batch=1,
                                          access=access)
                step, res, target = common.tune(
                    dspec, task, strat, p["epochs"])
                per[access] = (res, target)
            best = min(float(np.nanmin(r.losses)) for r, _ in per.values())
            target = best * 1.01 if best > 0 else best * 0.99
            for access, (res, _) in per.items():
                rows.append(dict(
                    dataset=name, task=task, access=access,
                    t_epoch_ms=1e3 * res.time_per_epoch,
                    epochs_to_1pct=res.epochs_to(target),
                    time_to_1pct_s=res.time_to(target),
                ))
    common.write_csv(rows, "fig8_access_path.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
