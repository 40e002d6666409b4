#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's decode attention, sparse SGD epoch and
full-batch gradients of one checkout, for comparisons between two
checkouts on one card.

    python3 tools/port_ab.py [--root DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), so the same script times a parent commit unpacked beside this
one and this one, each in a process of its own; run them in turns (A, B,
B, A) inside one chip call.  Needs one card.  Prints one JSON line:

* ``decode``: ``flash_attention`` at h2o-danube-1.8b's decode shape (B=4,
  Hq=32, Hkv=8, hd=80, bf16, Sq=1, ``causal=False``, as
  ``nn.attention.decode_attention`` calls it) over Sk = 128 (the serving
  run's cache) and Sk = 4096 (a full window): the call's ms by CUDA events
  over 200 back-to-back calls; the device ms of a call from
  ``torch.profiler`` (all kernel time over the counted calls); the byte
  bound (q, k, v read once, the output written once, at 3.35 TB/s); the
  same for ``scaled_dot_product_attention`` on the same inputs; and the
  wrapper's host us per call (host clock over 10 rounds of 100 calls,
  each round behind a ``torch.cuda._sleep`` that keeps the card busy, so
  only the enqueue is timed), for the public function and for the cuda
  flavor called directly;
* ``sgd_sparse``: ``ell_sgd_epoch`` on the w8a stand-in (64,700 x 300,
  K=69, seed 0) split into 10 replicas as ``AsyncLocalSGD(replicas=10)``
  splits it, at micro-batches 10 and 1: ms per epoch by CUDA events over 3
  calls, device ms from the profiler, us per update;
* ``grad``: the full-batch gradients of ``SyncSGD()``: ``glm_grad`` on the
  covtype stand-in (581,012 x 54, seed 0) and ``ell_glm_grad`` on w8a at
  R = 1 and at R = 10 x 6,470 (``AsyncLocalSGD(replicas=10,
  local_batch=6470)``): ms a call by CUDA events over 20 calls, device ms
  from the profiler by kernel, and the byte bound;
* ``train``: ``sgd.run`` for 4 epochs (``chip_smoke.py``'s phase ``train``
  rows) of ``AsyncLocalSGD(replicas=10, local_batch=10)`` on w8a, and of
  ``SyncSGD()`` on covtype and w8a and ``AsyncLocalSGD(replicas=10,
  local_batch=6470)`` on w8a, the gradient kernels' epochs: ms per epoch.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12
#: cycles the card spins before a round of host-timed calls (about 10 ms)
SLEEP_CYCLES = 20_000_000
DECODE = dict(b=4, hq=32, hkv=8, hd=80)


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(fn, reps: int) -> dict:
    """Device ms per call: every kernel the counted step's ``reps`` calls
    ran, from ``torch.profiler``, behind a discarded warm-up step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key: (e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0}
    return {"device_ms": sum(ms for ms, _ in kernels.values()) / reps,
            "kernels": {k[:60]: [ms / reps, n] for k, (ms, n) in
                        kernels.items()}}


def host_us(fn, rounds: int = 10, calls: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(rounds):
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (rounds * calls) * 1e6


def decode_rows(K, ops) -> list[dict]:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for sk in (128, 4096):
        b, hq, hkv, hd = (DECODE[k] for k in ("b", "hq", "hkv", "hd"))
        g = torch.Generator(device="cuda").manual_seed(sk)
        q = torch.randn(b, hq, 1, hd, device="cuda", generator=g).bfloat16()
        k = torch.randn(b, hkv, sk, hd, device="cuda", generator=g).bfloat16()
        v = torch.randn(b, hkv, sk, hd, device="cuda", generator=g).bfloat16()
        call = lambda: K.flash_attention(q, k, v, causal=False)  # noqa: E731
        flavor = lambda: ops._flash_attn_cuda(  # noqa: E731
            q, k, v, causal=False, window=None)
        lib = lambda: sdpa(q, k, v, enable_gqa=True)  # noqa: E731
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        err = float((call().float() - lib().float()).abs().max())
        rows.append({
            "shape": [b, hq, hkv, 1, sk, hd], "dtype": "bf16",
            "variant": ops.variant(q.dtype, 1, hq // hkv)
            if hasattr(ops, "variant") else None,
            "ms": events_ms(call, 200), **profiler_ms(call, 200),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(call), "host_us_cuda_flavor": host_us(flavor),
            "sdpa_ms": events_ms(lib, 200),
            "sdpa_device_ms": profiler_ms(lib, 200)["device_ms"],
            "sdpa_host_us": host_us(lib), "vs_sdpa_max_abs_err": err})
    return rows


def sparse_rows(K, synthetic, sgd) -> tuple[list[dict], dict]:
    ds = synthetic.paper_dataset("w8a", seed=0, device="cuda")
    m, y = ds.ell, ds.y
    ns, k = m.values.shape
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).cuda().long()
    vp, ip, yp = m.values[parts], m.indices[parts], y[parts]
    W = torch.zeros(10, m.d, device="cuda")
    rows = []
    for mb in (10, 1):
        fn = lambda: K.ell_sgd_epoch(  # noqa: E731
            "lr", W, vp, ip, yp, step=0.2, micro_batch=mb)
        ms = events_ms(fn, 3)
        updates = -(-vp.shape[1] // mb)
        prof = profiler_ms(fn, 3)
        rows.append({"shape": [10, vp.shape[1], k, m.d], "micro_batch": mb,
                     "ms": ms, "device_ms": prof["device_ms"],
                     "kernels": prof["kernels"], "updates": updates,
                     "us_per_update": ms * 1e3 / updates,
                     "device_us_per_update": prof["device_ms"] * 1e3 / updates})
    res = sgd.run(("lr", m, y, 0.2), sgd.AsyncLocalSGD(replicas=10,
                                                        local_batch=10),
                  4, sparse_data=True)
    train = {"strategy": res.strategy, "ms_per_epoch":
             res.time_per_epoch * 1e3, "losses": res.losses.tolist()}
    return rows, train


def ell_bytes(values) -> int:
    """Values read once, the 4-byte index of each nonzero once."""
    return values.numel() * 4 + 4 * int((values != 0).sum())


def grad_rows(K, synthetic, sgd) -> tuple[list[dict], list[dict]]:
    from repro_torch.core import glm

    cov = synthetic.paper_dataset("covtype", seed=0, device="cuda")
    w8 = synthetic.paper_dataset("w8a", seed=0, device="cuda")
    X, yd = cov.X, cov.y
    m, ys = w8.ell, w8.y
    n, d = X.shape
    ns = m.values.shape[0]
    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(d, device="cuda", generator=g) * 0.1
    ws = torch.randn(m.d, device="cuda", generator=g) * 0.1
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).cuda().long()
    vp, ip, yp = m.values[parts], m.indices[parts], ys[parts]
    W = ws[None].repeat(10, 1)
    cases = (
        ("glm_grad covtype", lambda: K.glm_grad("lr", w, X, yd),
         X.numel() * 4 + n * 4 + 8 * d),
        ("glm_sparse w8a R=1",
         lambda: K.ell_glm_grad("lr", ws, m.values, m.indices, ys),
         ell_bytes(m.values) + ns * 4 + 8 * m.d),
        ("glm_sparse w8a R=10 per=6470",
         lambda: K.ell_glm_grad("lr", W, vp, ip, yp),
         ell_bytes(vp) + ns * 4 + 80 * m.d))
    rows = []
    for label, fn, nbytes in cases:
        rows.append({"case": label, "ms": events_ms(fn, 20),
                     **profiler_ms(fn, 20),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    train = []
    for label, problem, strat, sparse_data in (
            ("covtype", glm.GLMProblem("lr", X, yd, 1.0 / n), sgd.SyncSGD(),
             False),
            ("w8a", ("lr", m, ys, 2.0 / ns), sgd.SyncSGD(), True),
            ("w8a", ("lr", m, ys, 2.0),
             sgd.AsyncLocalSGD(replicas=10, local_batch=ns // 10), True)):
        res = sgd.run(problem, strat, 4, sparse_data=sparse_data)
        train.append({"data": label, "strategy": res.strategy,
                      "ms_per_epoch": res.time_per_epoch * 1e3,
                      "epoch_ms": (res.epoch_times * 1e3).tolist(),
                      "losses": res.losses.tolist()})
    return rows, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import ops

    t0 = time.perf_counter()
    _build.build_all(["flash_attn", "glm_grad", "glm_sgd_sparse",
                      "glm_sparse"])
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    decode = decode_rows(K, ops)
    sparse, train = sparse_rows(K, synthetic, sgd)
    grad, grad_train = grad_rows(K, synthetic, sgd)
    print(json.dumps({"label": args.label, "root": args.root,
                      "nvidia_smi": smi, "build_s": build_s,
                      "decode": decode, "sgd_sparse": sparse, "grad": grad,
                      "train": [train] + grad_train}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
