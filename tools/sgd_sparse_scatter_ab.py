#!/usr/bin/env python3
"""Time ``glm_sgd_sparse``'s warp kernel with other scatters in its place.

    python3 tools/sgd_sparse_scatter_ab.py

Compiles ``src/repro_torch/kernels/csrc/glm_sgd_sparse.cu`` as it is
(``kernel``: ``scatter_row``, which takes ``add_row`` with one chain warp and
an ``atomicAdd`` per entry with two) and with the warp kernel's scatter of a
row replaced by

* ``add_row``: a row's compare-and-swaps issued together, whatever the warps;
* ``atomic``: one shared-memory ``atomicAdd`` per entry;
* ``plain``: a plain read, add and write per entry (wrong where a row
  repeats a feature, or where two chain warps add to one: for timing only);
* ``none``: no scatter (the model never changes: for timing only);

then runs each on the w8a stand-in (64,700 x 300, K=69, seed 0) in 10
replicas as ``AsyncLocalSGD(replicas=10)`` splits it, at micro-batches 10
and 1, and prints one JSON line per (scatter, micro-batch): us per update
by CUDA events over 3 epochs, and the largest difference from the plain
PyTorch version after one epoch, on the data as it is and with feature 5
repeated three times in every row.  Needs one card and ``nvcc``; the
builds go to ``build/scatter_ab/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: the warp kernel's scatter of row i, as csrc/glm_sgd_sparse.cu has it
CALL = "            if (i < rows) scatter_row<C>(w, vr[i], ir[i], g, chains);"
SCATTERS = {
    "kernel": CALL,
    "add_row": "            if (i < rows) add_row<C>(w, vr[i], ir[i], g);",
    "atomic": """            if (i < rows) {
#pragma unroll
              for (int c = 0; c < C; ++c)
                if (vr[i][c] != 0.0f && g != 0.0f)
                  atomicAdd(&w[ir[i][c]], g * vr[i][c]);
            }""",
    "plain": """            if (i < rows) {
#pragma unroll
              for (int c = 0; c < C; ++c)
                if (vr[i][c] != 0.0f && g != 0.0f) w[ir[i][c]] += g * vr[i][c];
              __syncwarp();
            }""",
    "none": "            (void)g;",
}


def build(out: Path) -> dict[str, ctypes._CFuncPtr]:
    from repro_torch.kernels import _build
    from repro_torch.kernels.glm_sgd_sparse import ops

    src = (_build.CSRC / "glm_sgd_sparse.cu").read_text()
    if CALL not in src:
        raise RuntimeError("glm_sgd_sparse.cu no longer has the scatter call "
                           "this tool replaces")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, body in SCATTERS.items():
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(CALL, body).replace(
            '#include "ring.cuh"', f'#include "{_build.CSRC / "ring.cuh"}"'))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).ell_sgd_epoch
        fn.argtypes, fn.restype = list(ops._ARGS), ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("sgd_sparse_scatter_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import sgd
    from repro_torch.data import synthetic
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_sgd_sparse import ops
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref

    fns = build(ROOT / "build" / "scatter_ab")
    ds = synthetic.paper_dataset("w8a", seed=0, device="cuda")
    m, y = ds.ell, ds.y
    ns, k = m.values.shape
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).cuda().long()
    vp, ip, yp = (t[parts].contiguous() for t in (m.values, m.indices, y))
    vr, ir = vp.clone(), ip.clone()
    vr[:, :, -3:], ir[:, :, -3:] = 1.0, 5   # feature 5 thrice in each row
    W0 = torch.zeros(10, m.d, device="cuda")
    n = vp.shape[1]
    for name, fn in fns.items():
        for mb in (10, 1):
            stages, group = ops.warp_plan(m.d, k, mb)
            tail = n % mb

            def run(W, v, i):
                code = fn(v.data_ptr(), i.data_ptr(), yp.data_ptr(),
                          W.data_ptr(), 10, n, k, m.d, mb, 0, 0.2 / mb,
                          0.2 / tail if tail else 0.0, stages, group,
                          common.stream(v))
                if code:
                    raise RuntimeError(f"{name}: cudaError {code}")

            errs = []
            for v, i in ((vp, ip), (vr, ir)):
                W = W0.clone()
                run(W, v, i)
                ref = ell_sgd_epoch_ref("lr", W0, v, i, yp, 0.2, mb)
                errs.append(float((W - ref).abs().max()))
            W = W0.clone()
            run(W, vp, ip)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run(W, vp, ip)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            print(json.dumps({
                "scatter": name, "micro_batch": mb, "ms_per_epoch": ms,
                "us_per_update": ms * 1e3 / -(-n // mb),
                "max_abs_err": errs[0], "repeated_feature_max_abs_err":
                errs[1], "device": torch.cuda.get_device_name(0)}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
