"""Kernel microbenchmark trajectory producer -> ``BENCH_kernels.json``.

The port's twin of the reference's ``benchmarks/bench_kernels.py``: one
trajectory point per (kernel family, shape, dtype, launch-plan variant),
with the same shapes, variants, labels, seeds and inputs.  Each point
records the measured wall time of one wrapper call on its device, the
conformance verdict of the hand-written CUDA kernel against its plain
PyTorch version on the same CUDA tensors (``common.plain_versions()``,
TF32 off), and the analytic roofline annotation on the H100
(``repro_torch.roofline.kernels``).  Variants cover the plan's own launch
geometry (``default``) and the geometry the autotuner picks (``tuned``,
``repro_torch.kernels.tune``); fp32 rows add a bf16-input point.

On the CPU no kernel flavor exists: every verdict is None and
``checked_backends`` is empty, so the gate's "no flavor was
conformance-checked" violation fires and the CLI exits non-zero.  That is
the truthful result of a run that checked no kernel.

Determinism contract (the reference's): wall times are cached in
``bench_results/torch/kernel_cache`` keyed by the entry identity (kernel,
shape, dtype, variant, backend, host, device kind), tuning sweeps in
``bench_results/torch/tune_cache``; a warm re-run reads both caches and
writes a byte-identical ``BENCH_kernels.json``.  The >20% regression gate
(``claims.check_bench_kernels``) compares each point with the committed
entry of the same label, host and device kind.  Nothing here reads or
writes the reference's root ``BENCH_kernels.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels [ci|paper]
        [--device cuda|cpu]

(exits non-zero on a conformance or regression violation).
"""
from __future__ import annotations

import hashlib
import platform

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.data import synthetic
from repro_torch.kernels import common as kcommon
from repro_torch.kernels import tune
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.glm_grad import glm_grad
from repro_torch.kernels.glm_sgd import glm_sgd_epoch
from repro_torch.kernels.glm_sgd_sparse import ell_sgd_epoch
from repro_torch.kernels.glm_sparse import ell_glm_grad
from repro_torch.roofline import kernels as roofline
from repro_torch.study.runner import TrialCache
from repro_torch.study.spec import canonical_json
from repro_torch.study.store import KernelBenchStore
from repro_torch.utils.timing import time_stats

#: bump to invalidate every cached wall time (timing protocol changes)
TIMING_SCHEMA = 1

STEP = 0.05  # SGD-epoch step size (a constant, not tuned)

# family -> per-profile benchmark shape
SHAPES = {
    "glm_grad": {"ci": dict(n=512, d=128), "paper": dict(n=4096, d=512)},
    "glm_sgd": {"ci": dict(n=256, d=64), "paper": dict(n=2048, d=256)},
    "glm_sparse": {"ci": dict(n=256, d=512, k=8),
                   "paper": dict(n=2048, d=4096, k=16)},
    "glm_sgd_sparse": {"ci": dict(n=128, d=256, k=8),
                       "paper": dict(n=1024, d=1024, k=16)},
    "flash_attn": {
        "ci": dict(batch=1, heads_q=2, heads_kv=1, seq_q=64, seq_k=64,
                   head_dim=32),
        "paper": dict(batch=2, heads_q=4, heads_kv=2, seq_q=256, seq_k=256,
                      head_dim=64),
    },
}

#: (dtype, variant) trajectory points per family; the tuned variant only
#: makes sense where the caches can pin a winner, and bf16 tracks input-
#: cast cost at the default geometry
VARIANTS = (("float32", "default"), ("float32", "tuned"),
            ("bfloat16", "default"))

#: the micro-batch the conformance check pins for the fused epochs: the
#: kernel and its plain version must walk the same batches
CHECK_MICRO_BATCH = 8


def _digest(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]


def _shape_tag(shape: dict) -> str:
    return "-".join(f"{k}{v}" for k, v in sorted(shape.items()))


class _Family:
    """One family's benchmark closures at a concrete shape, dtype, device."""

    def __init__(self, info, call, tol, device, check=None):
        self.info = info          # tuner/roofline call info
        self.call = call          # call(**cfg) -> tensor
        self.tol = tol            # (rtol, atol) for the conformance check
        self.device = device      # where the operands live
        self.check = check or {}  # the geometry the conformance check pins


def _make_family(kernel: str, shape: dict, dtype: str,
                 device=None) -> _Family:
    """The reference's inputs (numpy, seeds 0 and 7) on ``device`` (``cuda``
    unless the caller says) in ``dtype``."""
    dev = kcommon.device(device)
    tdt = getattr(torch, dtype)
    loose = dtype == "bfloat16"
    tol = (0.05, 0.05) if loose else (1e-3, 2e-3)
    rng = np.random.default_rng(7)

    def put(a):
        return torch.as_tensor(a).to(dev, tdt)

    if kernel in ("glm_grad", "glm_sgd"):
        n, d = shape["n"], shape["d"]
        ds = synthetic.make_dense(f"bench-{kernel}-{d}", n, d, seed=0,
                                  device=dev)
        X, y = ds.X.to(tdt), ds.y.to(tdt)
        w = put(rng.normal(0, 0.1, d))
        info = {"dtype": dtype, "n": n, "d": d}
        if kernel == "glm_grad":
            def call(**cfg):
                return glm_grad("lr", w, X, y, **cfg)
            return _Family(info, call, tol, dev)

        def call(**cfg):
            return glm_sgd_epoch("lr", w, X, y, step=STEP, **cfg)
        info["micro_batch"] = CHECK_MICRO_BATCH
        return _Family(info, call, tol, dev,
                       {"micro_batch": CHECK_MICRO_BATCH})

    if kernel in ("glm_sparse", "glm_sgd_sparse"):
        n, d, k = shape["n"], shape["d"], shape["k"]
        ds = synthetic.make_sparse(f"bench-{kernel}-{d}", n, d, k * 0.6, k,
                                   seed=0, device=dev)
        vals, idx, y = ds.ell.values.to(tdt), ds.ell.indices, ds.y.to(tdt)
        w = put(rng.normal(0, 0.1, d))
        info = {"dtype": dtype, "sparse": True, "n": n, "d": d, "k": k}
        if kernel == "glm_sparse":
            def call(**cfg):
                return ell_glm_grad("lr", w, vals, idx, y, **cfg)
            return _Family(info, call, tol, dev)

        def call(**cfg):
            return ell_sgd_epoch("lr", w, vals, idx, y, step=STEP, **cfg)
        info["micro_batch"] = CHECK_MICRO_BATCH
        return _Family(info, call, tol, dev,
                       {"micro_batch": CHECK_MICRO_BATCH})

    if kernel != "flash_attn":
        raise KeyError(f"no benchmark family {kernel!r}")
    b, hq, hkv = shape["batch"], shape["heads_q"], shape["heads_kv"]
    sq, sk, hd = shape["seq_q"], shape["seq_k"], shape["head_dim"]
    q = put(rng.normal(0, 1, (b, hq, sq, hd)))
    kk = put(rng.normal(0, 1, (b, hkv, sk, hd)))
    v = put(rng.normal(0, 1, (b, hkv, sk, hd)))
    # causal: the roofline counts the pairs a causal call computes
    info = {"dtype": dtype, "head_dim": hd, "seq_q": sq, "seq_k": sk,
            **shape, "causal": True}

    def call(**cfg):
        return flash_attention(q, kk, v, causal=True, **cfg)
    return _Family(info, call, tol, dev)


def _conformance(fam: _Family) -> tuple[bool | None, list[str]]:
    """The CUDA flavor against the plain version on the same CUDA tensors
    (TF32 off).  Returns ``(verdict, checked_backends)``: ``(None, [])``
    on the CPU, where no kernel flavor exists, not ``True``."""
    if fam.device.type != "cuda":
        return None, []
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with kcommon.plain_versions():
            ref = fam.call(**fam.check).float()
        out = fam.call(**fam.check).float()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    rtol, atol = fam.tol
    return bool(torch.allclose(out, ref, rtol=rtol, atol=atol)), \
        [kcommon.CUDA]


def _baseline_wall(committed: dict | None, label: str, host: str,
                   device_kind: str) -> float | None:
    """The committed trajectory's comparable point (same host + device)."""
    entry = (committed or {}).get("entries", {}).get(label)
    if (entry and entry.get("host") == host
            and entry.get("device_kind") == device_kind):
        return entry.get("wall_s")
    return None


def run(profile: str = "ci", *, out_json=None, device=None):
    """Every family at ``profile``'s shape on ``device`` (``cuda`` unless
    the caller says) into ``out_json`` (default
    ``bench_results/torch/BENCH_kernels.json``).

    ``pallas_match`` keeps the reference's key, which the ported gate
    reads: here it is the CUDA flavor's verdict against the plain version
    (None where none was checked)."""
    out_json = out_json or common.RESULTS_DIR / "BENCH_kernels.json"
    try:
        committed = KernelBenchStore.load(out_json)
    except (FileNotFoundError, ValueError):
        committed = None
    store = KernelBenchStore(
        out_json, jsonl_path=common.RESULTS_DIR / "kernel_runs.jsonl")
    timing_cache = TrialCache(common.RESULTS_DIR / "kernel_cache")
    tune_cache = tune.TuneCache(common.RESULTS_DIR / "tune_cache")
    host = platform.node()
    device_kind = tune.device_kind()
    dev = kcommon.device(device)

    rows = []
    for kernel, shapes in SHAPES.items():
        shape = shapes[profile]
        tag = _shape_tag(shape)
        verdicts: dict[str, tuple] = {}
        for dtype, variant in VARIANTS:
            fam = _make_family(kernel, shape, dtype, dev)
            backend = kcommon.resolve_backend(kernel, dev)
            if dtype not in verdicts:
                verdicts[dtype] = _conformance(fam)
            pallas_match, checked = verdicts[dtype]

            config: dict = {}
            if variant == "tuned":
                config = dict(tune.tune(kernel, backend, fam.info, fam.call,
                                        cache=tune_cache)["config"])

            label = f"{kernel}/{tag}/{dtype}/{variant}"
            key = _digest({"timing_schema": TIMING_SCHEMA, "label": label,
                           "profile": profile, "backend": backend,
                           "config": config, "host": host,
                           "device_kind": device_kind})
            payload = timing_cache.peek(key)
            if payload is None:
                stats = time_stats(lambda: fam.call(**config),
                                   warmup=1, iters=5)
                # the snapshot commits only the median (deterministic via
                # the timing cache); dispersion goes to the JSONL sidecar
                payload = {"wall_s": stats["median"]}
                timing_cache.put(key, payload)
                cached = False
                store.record_event("timing_stats", label=label, **stats)
            else:
                cached = True

            entry = {
                "kernel": kernel,
                "shape": dict(sorted(shape.items())),
                "dtype": dtype,
                "variant": variant,
                "backend": backend,
                "config": config,
                "wall_s": payload["wall_s"],
                "pallas_match": pallas_match,
                "checked_backends": checked,
                "roofline": roofline.annotate(kernel, fam.info,
                                              payload["wall_s"]),
                "host": host,
                "device_kind": device_kind,
            }
            store.record_entry(label, entry, cached=cached)
            rows.append({
                "label": label, **entry,
                "baseline_wall_s": _baseline_wall(committed, label, host,
                                                  device_kind),
            })
    out = store.write()
    print(f"wrote {out} ({len(rows)} trajectory points)")
    return rows


if __name__ == "__main__":
    import argparse
    import sys

    from repro_torch.study import claims

    ap = argparse.ArgumentParser()
    ap.add_argument("profile", nargs="?", default="ci",
                    choices=("ci", "paper"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the kernels run (cpu: the plain versions, "
                         "no verdict)")
    args = ap.parse_args()
    rows = run(args.profile, device=args.device)
    for r in rows:
        print(f"  {r['label']:48s} {1e6 * r['wall_s']:10.1f}us "
              f"match={r['pallas_match']} "
              f"bound={r['roofline']['bound']}")
    bad = claims.check_bench_kernels(rows)
    if bad:
        print("VIOLATIONS:")
        for v in bad:
            print("  - " + v)
        sys.exit(1)
    print("kernel conformance + regression gate clean")
