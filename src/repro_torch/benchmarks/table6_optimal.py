"""Paper Table 6: optimal configuration per dataset/task.
The port's twin of the reference's ``benchmarks/table6_optimal.py``.

Delegates to ``repro_torch.study.advisor`` — the subsystem's Table-6 search:
the design space {sync} ∪ {access path} × {replication level} × {rep-k}
is step-tuned per cell (§6.1) and ranked by measured time to 1% error
(``rank="measured"``, the paper's protocol) — reproducing the paper's
finding that the optimum is dataset/task-dependent (no single
configuration wins everywhere)."""
from __future__ import annotations

import math

from repro_torch.benchmarks import common
from repro_torch.study import advisor


def run(profile: str = "ci"):
    p = common.PROFILES[profile]
    caps = advisor.HostCaps.detect()
    rows = []
    for name in common.profile_datasets(profile):
        dspec = common.dataset_spec(name, profile)
        for task in common.TASKS:
            rec = advisor.recommend(
                dspec, caps, task=task, runner=common.RUNNER,
                steps=(1e-2, 1e-1), epochs=max(6, p["epochs"] // 2),
                rank="measured")
            best = rec.best
            rows.append(dict(
                dataset=name, task=task, optimal_config=best.name,
                time_to_1pct_s=best.measured_time_to_target_s,
                n_configs_tried=len(rec.ranked),
                n_configs_converged=sum(
                    1 for r in rec.ranked if math.isfinite(r.score)),
            ))
    common.write_csv(rows, "table6_optimal.csv")
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
