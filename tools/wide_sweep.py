#!/usr/bin/env python3
"""Check and time the kernels of the paper profile's widest datasets:
``glm_sgd``'s grid kernel (past 65,536 features) and ``glm_sparse``'s hot
kernel (past the shared-memory kernel's 29,024), each beside the kernel it
replaced there, and the hot kernel with other counts of hot features.

    python3 tools/wide_sweep.py [--only check,sgd,sparse]

Needs one card.  Prints one JSON line a section:

* ``check``: ``chip_smoke.wide_kernel_checks``, each new kernel against its
  plain PyTorch version on the card at the edges phase ``kernels`` holds
  it to;
* ``sgd``: Table 4's ``seq`` epoch on news (its first 1,024 rows
  densified, 1,024 x 1,355,191, micro-batch 1) and d = 100,000 (2,003
  rows, micro-batches 1 and 10) on the grid kernel and on the global kernel
  it replaced: ms by CUDA events, device ms from the profiler, us an
  update, the byte bound;
* ``sparse``: ``ell_glm_grad`` at rcv1's and news's full sizes (677,399 x
  438, 19,996 x 2,729) and at the paper profile's 16,384 rows, and on w8a
  (64,700 x 69): the hot kernel with each of HOT_COUNTS features in shared
  memory, beside the atomic kernel (and at w8a the smem kernel): each
  checked against the plain version, ms, device ms, the byte bound.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SECTIONS = ("check", "sgd", "sparse")


@contextlib.contextmanager
def hot_count(ops, hot: int):
    """Run glm_sparse's hot kernel with ``hot`` features in shared memory."""
    saved, ops.HOT = ops.HOT, hot
    try:
        yield
    finally:
        ops.HOT = saved


def timed(fn, reps: int, names) -> dict:
    out = {"ms": cs.cuda_ms(fn, reps)}
    out.update(cs.kernel_device_time(fn, reps, names))
    return out


def check_section(dev) -> dict:
    cases, worst = cs.wide_kernel_checks(dev)
    return {"section": "check", "cases": cases, "worst": worst,
            "ok": all(c["ok"] for c in cases)}


def sgd_section(dev) -> dict:
    import repro_torch.kernels as K
    from repro_torch.core import sparse
    from repro_torch.kernels.glm_sgd import ops as sgd_ops

    news, yn = cs.news_dataset(dev, n=1_024)
    Xn = sparse.to_dense(news)
    del news
    g = torch.Generator(device=dev).manual_seed(1)
    Xw = torch.randn(2_003, 100_000, device=dev, generator=g)
    yw = torch.where(torch.rand(2_003, device=dev, generator=g) < 0.5, -1.0,
                     1.0)
    rows = []
    for label, X, y, mb in (("news seq", Xn, yn, 1),
                            ("d=100000", Xw, yw, 1), ("d=100000", Xw, yw, 10)):
        n, d = X.shape
        w = torch.zeros(d, device=dev)
        nbytes = cs.nbytes(X, y, w, w)
        for kind in ("grid", "global"):
            with cs.forced_variant(sgd_ops, kind):
                fn = lambda: K.glm_sgd_epoch(  # noqa: E731
                    "lr", w, X, y, step=1e-3, micro_batch=mb)
                t = timed(fn, 3 if kind == "grid" else 1,
                          cs.KERNEL_SYMBOLS["glm_sgd"][kind])
            updates = -(-n // mb)
            rows.append({"case": label, "shape": [n, d], "mb": mb,
                         "variant": kind, **t,
                         "us_per_update": t["ms"] * 1e3 / updates,
                         "bound_ms": cs.bound_ms(nbytes, 4.0 * X.numel())[0]})
    return {"section": "sgd", "rows": rows}


#: features the sparse section privatizes in the hot kernel's blocks (1:
#: almost every add in global memory; 57,344: most of a block's 227 KB)
HOT_COUNTS = (1, 4_096, 16_384, 57_344)


def sparse_section(dev) -> dict:
    import repro_torch.kernels as K
    from repro_torch.data import synthetic
    from repro_torch.kernels.glm_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    rcv1, y1 = cs.rcv1_dataset(dev)
    news, yn = cs.news_dataset(dev)
    w8 = synthetic.paper_dataset("w8a", seed=0, device=dev)
    rows = []
    for label, m, y, cut in (("rcv1 full", rcv1, y1, None),
                             ("rcv1 paper", rcv1, y1, cs.PAPER_ROWS),
                             ("news full", news, yn, None),
                             ("news paper", news, yn, cs.PAPER_ROWS),
                             ("w8a", w8.ell, w8.y, None)):
        v, i = m.values[:cut], m.indices[:cut]
        ys = y[:cut]
        n, k = v.shape
        w = torch.randn(m.d, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
        w *= 0.01
        ref = ell_glm_grad_ref("lr", w[None], v[None], i[None], ys[None])[0]
        nbytes = cs.ell_bytes(v) + cs.nbytes(ys, w, w)
        fn = lambda: K.ell_glm_grad("lr", w, v, i, ys)  # noqa: E731
        runs = [("hot", hot) for hot in HOT_COUNTS] + [("atomic", None)]
        if sparse_ops.variant(m.d, k, 1) == "smem":
            runs.append(("smem", None))
        for kind, hot in runs:
            with cs.forced_variant(sparse_ops, kind), \
                    hot_count(sparse_ops, hot or sparse_ops.HOT):
                err = cs.close(fn(), ref, cs.GRAD_TOL)
                t = timed(fn, 10, cs.KERNEL_SYMBOLS["glm_sparse"][kind])
            rows.append({"case": label, "shape": [n, k, m.d],
                         "variant": kind, "hot": hot,
                         "max_abs_err": err[0], "ok": err[1], **t,
                         "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3})
    return {"section": "sparse", "rows": rows,
            "ok": all(r["ok"] for r in rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        ap.error(f"--only takes sections of {SECTIONS}")
    if not torch.cuda.is_available():
        print("wide_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    reports = _build.build_all(["glm_sgd", "glm_sparse"])
    print(json.dumps({"ptxas": {
        name: [ln.strip() for ln in text.splitlines()
               if "registers" in ln or "spill" in ln or "Compiling" in ln]
        for name, text in reports.items()},
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()}), flush=True)
    dev = torch.device("cuda")
    ok = True
    for name, fn in (("check", check_section), ("sgd", sgd_section),
                     ("sparse", sparse_section)):
        if name in only:
            line = fn(dev)
            ok = ok and line.get("ok", True)
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
