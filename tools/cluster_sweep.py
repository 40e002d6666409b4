#!/usr/bin/env python3
"""Time ``glm_sgd``'s cluster kernel at every cluster size a shape allows,
and beside the kernels that keep the narrow shapes the warp kernel refuses.

    python3 tools/cluster_sweep.py

Runs Table 4's real-sim seq epoch (N = 1,024 rows, d = 20,958, micro-batch
1, one replica) and d = 58,112 at micro-batches 1 and 10 (N = 2,003) on
``glm_sgd_cluster_kernel`` with the plan's cluster (``ops.cluster_plan``)
and then with every other cluster size from 1 to ``CLUSTER_MAX`` whose
slice the chain's registers hold (each with as many stages as fit, fills of
the plan's rows or fewer), and prints one JSON line per (shape, cluster).
Then it runs the shapes of d <= 1,024 whose batches are too long for the
warp kernel's ring (``SMALL_SHAPES``) on the variant ``ops.variant`` picks
(``"smem"``, or ``"global"`` past a block's shared memory) and on
``"cluster"`` at its plan, one JSON line each.  A line holds ms per epoch
and us per update by CUDA events over 3 epochs after a warm-up, and the
largest difference from the plain PyTorch version.  The card's name and
power limit lead the output.  Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ((1_024, 20_958, 1), (2_003, 58_112, 1), (2_003, 58_112, 10))
#: (N, d, micro-batch) past the warp kernel's ring at d <= 1,024: its
#: widest at the shortest batch it refuses and at 64, 300 and 144 at
#: batches of 128 and 256, and a batch past a block's shared memory
SMALL_SHAPES = ((2_048, 1_024, 28), (2_048, 1_024, 64), (4_096, 300, 128),
                (4_096, 144, 256), (120_000, 1_024, 60_000))


def plans(d: int, mb: int):
    """The plan's (cluster, slice, stages, rows), then every other cluster
    size whose slice fits, with the most stages and rows that fit."""
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_sgd import ops

    chosen = ops.cluster_plan(d, mb)
    yield chosen
    for cluster in range(1, ops.CLUSTER_MAX + 1):
        slice_ = -(-d // cluster)
        if cluster == chosen[0] or (cluster - 1) * slice_ >= d or \
                slice_ > ops.CLUSTER_CHAIN_THREADS * ops.CLUSTER_MAX_VALUES:
            continue
        for rows in range(min(mb, ops.CLUSTER_CHUNK_ROWS), 0, -1):
            stages = max((s for s in range(2, ops.CLUSTER_MAX_STAGES + 1)
                          if ops.cluster_smem_bytes(cluster, slice_, s, rows)
                          <= common.MAX_SMEM_BYTES), default=0)
            if stages:
                yield cluster, slice_, stages, rows
                break


def inputs(rng, n: int, d: int, dev):
    """Unit-normal rows, labels of +-1 and a small model, on ``dev``."""
    X = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0, 1.0)
                         .astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return X, y, w


def timed(epoch, ref, n: int, mb: int) -> dict:
    """ms an epoch by CUDA events over 3 epochs after a checked warm-up."""
    err = float((epoch() - ref).abs().max())
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        epoch()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 3
    return {"ms": ms, "us_per_update": ms * 1e3 / -(-n // mb),
            "max_abs_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_sweep: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_sgd import ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    saved_plan, saved_variant = ops.cluster_plan, ops.variant
    for n, d, mb in SHAPES:
        X, y, w = inputs(rng, n, d, dev)
        ref = glm_sgd_epoch_ref("lr", w[None], X[None], y[None], 1.0 / d,
                                mb)[0]
        for plan in plans(d, mb):
            ops.cluster_plan = lambda *_, plan=plan: plan
            try:
                line = timed(lambda: K.glm_sgd_epoch(
                    "lr", w, X, y, step=1.0 / d, micro_batch=mb), ref, n, mb)
            finally:
                ops.cluster_plan = saved_plan
            print(json.dumps({
                "n": n, "d": d, "micro_batch": mb, "cluster": plan[0],
                "slice": plan[1], "stages": plan[2], "rows": plan[3],
                "planned": plan == saved_plan(d, mb), **line}), flush=True)
        del X
    for n, d, mb in SMALL_SHAPES:
        X, y, w = inputs(rng, n, d, dev)
        ref = glm_sgd_epoch_ref("lr", w[None], X[None], y[None], 1.0 / d,
                                mb)[0]
        for kind in (saved_variant(d, mb), "cluster"):
            ops.variant = lambda *_, kind=kind: kind
            try:
                line = timed(lambda: K.glm_sgd_epoch(
                    "lr", w, X, y, step=1.0 / d, micro_batch=mb), ref, n, mb)
            finally:
                ops.variant = saved_variant
            print(json.dumps({
                "n": n, "d": d, "micro_batch": mb, "variant": kind,
                "plan": list(ops.cluster_plan(d, mb)) if kind == "cluster"
                else None, **line}), flush=True)
        del X
    return 0


if __name__ == "__main__":
    sys.exit(main())
