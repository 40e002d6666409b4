"""Paper Fig 24/25: scalability in #examples (N) and #features (d).
The port's twin of the reference's ``benchmarks/fig24_scale.py``.

Asserts ~linear time/epoch growth in N and records growth in d; the
relative ordering of the algorithms is expected to be preserved.  Async
epochs run as study trials (explicit-shape ``DatasetSpec``s, so the
scaling sweep is cached/resumable); the sync point is a direct fused-
gradient timing."""
from __future__ import annotations

import torch

from repro_torch.benchmarks import common
from repro_torch.core import glm, sgd
from repro_torch.study import spec as spec_mod
from repro_torch.utils.timing import median_time


def _point(axis: str, name: str, n: int, d: int, seed: int):
    dspec = spec_mod.DatasetSpec(name, n=n, d=d, seed=seed)
    ds = common.RUNNER.dataset(dspec)
    X, y = ds.X, ds.y
    w = torch.zeros(d, dtype=torch.float32, device=X.device)

    def sync(w):
        return w - 1e-3 * glm.grad_fused("lr", w, X, y)

    t_sync = median_time(sync, w, warmup=1, iters=3)
    trial = spec_mod.TrialSpec(
        dataset=dspec, task="lr",
        strategy=sgd.AsyncLocalSGD(replicas=8, local_batch=1),
        step=1e-2, epochs=4)
    res = common.RUNNER.run_trial(trial)
    return dict(axis=axis, value=(n if axis == "N" else d), d=d,
                t_epoch_sync_ms=1e3 * t_sync,
                t_epoch_async_ms=1e3 * res.time_per_epoch)


def run(profile: str = "ci"):
    small = profile == "ci"
    rows = []
    # scale N at fixed d (covtype-style dense)
    for n in ((512, 1024, 2048) if small else (2048, 8192, 16384)):
        rows.append(_point("N", "covtype-n", n, 54, seed=0))
    # scale d at fixed N
    for d in ((32, 128, 512) if small else (54, 300, 2048)):
        rows.append(_point("d", "dense-d", 1024, d, seed=1))
    common.write_csv(rows, "fig24_scale.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
