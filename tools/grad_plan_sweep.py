#!/usr/bin/env python3
"""Time the full-batch gradient kernels under other plans than their own.

    python3 tools/grad_plan_sweep.py

The plans are the wrappers' constants and plan functions, so no rebuild is
needed; each is swapped in for the run of one row and put back:

* ``glm_sparse``'s smem kernel on the w8a stand-in (64,700 x 300, K=69,
  seed 0) at R = 1 and at R = 10 x 6,470, with G = 4, 8, 16 and 32 lanes a
  row (``smem_lanes``; the wrapper picks the G that leaves the fewest
  padded slots, 8 at K = 69) and 2, 3 or 4 blocks a SM
  (``SMEM_BLOCKS_PER_SM``, 4 by default: the kernel's register budget);
* ``glm_grad``'s ring kernel on the covtype stand-in (581,012 x 54, seed
  0) with 2, 3 or 4 stages (``RING_STAGES``) and 2 or 3 blocks a SM
  (``RING_BLOCKS_PER_SM``), where they fit shared memory, and with the
  margin pass's bank skew at the wrapper's choice (``ring_skew``: 0 at
  d = 54, two lanes a row) and at 1.

Prints one JSON line per row: device ms a call (``chip_smoke.
kernel_device_time``: the mean time of each kernel of the call over the
launches ``torch.profiler`` recorded in 20 calls, summed, and how many it
recorded), and the largest difference from the plain PyTorch version.
Needs one card.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def swapped(module, **values):
    """Set module attributes for a while, clearing the plan caches."""
    saved = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    caches = [getattr(module, f) for f in ("ring_plan", "smem_plan")
              if hasattr(module, f)]
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)
        for c in caches:
            c.cache_clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["glm_grad", "glm_sparse"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    def row(label, fn, ref, names):
        print(json.dumps({
            "case": label, "nvidia_smi": smi,
            **cs.kernel_device_time(fn, 20, names),
            "max_abs_err": float((fn() - ref).abs().max())}), flush=True)

    sparse_names = cs.KERNEL_SYMBOLS["glm_sparse"]["smem"]
    ring_names = cs.KERNEL_SYMBOLS["glm_grad"]["ring"]

    dev = torch.device("cuda")
    w8 = synthetic.paper_dataset("w8a", seed=0, device=dev)
    m, ys = w8.ell, w8.y
    ws = torch.randn(m.d, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    parts = torch.from_numpy(sgd.partition_indices(m.shape[0], 10)).to(
        dev).long()
    vp, ip, yp = m.values[parts], m.indices[parts], ys[parts]
    W = ws[None].repeat(10, 1)
    ref1 = ell_glm_grad_ref("lr", ws[None], m.values[None], m.indices[None],
                            ys[None])[0]
    ref10 = ell_glm_grad_ref("lr", W, vp, ip, yp)
    for lanes in (4, 8, 16, 32):
        for per_sm in (2, 3, 4):
            with swapped(sparse_ops, SMEM_BLOCKS_PER_SM=per_sm,
                         smem_lanes=lambda k, g=lanes: g):
                row(f"glm_sparse w8a R=1 G={lanes} blocks/SM={per_sm}",
                    lambda: K.ell_glm_grad("lr", ws, m.values, m.indices,
                                           ys), ref1, sparse_names)
                row(f"glm_sparse w8a R=10 G={lanes} blocks/SM={per_sm}",
                    lambda: K.ell_glm_grad("lr", W, vp, ip, yp), ref10,
                    sparse_names)

    cov = synthetic.paper_dataset("covtype", seed=0, device=dev)
    X, yd = cov.X, cov.y
    w = torch.randn(X.shape[1], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    ref = glm_grad_ref("lr", w, X, yd)
    n, d = X.shape
    for stages in (2, 3, 4):
        for per_sm in (2, 3):
            tile = grad_ops.ring_plan(d, n, 132)[0]
            if per_sm * (grad_ops.ring_smem_bytes(d, tile, stages) + 1024) \
                    > 233_472:
                continue
            for skew in sorted({grad_ops.ring_skew(d, 2), 1}):
                with swapped(grad_ops, RING_STAGES=stages,
                             RING_BLOCKS_PER_SM=per_sm,
                             ring_skew=lambda d_, lanes, s=skew: s):
                    row(f"glm_grad covtype stages={stages} "
                        f"blocks/SM={per_sm} skew={skew}",
                        lambda: K.glm_grad("lr", w, X, yd), ref, ring_names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
