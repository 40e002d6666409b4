#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's decode attention, prefill attention, the
attention backward, sparse SGD epoch and full-batch gradients of one
checkout, for comparisons between two checkouts on one card.

    python3 tools/port_ab.py [--root DIR] [--label NAME] [--only A,B]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this script
lies in), so the same script times a parent commit unpacked beside this
one and this one, each in a process of its own; run them in turns (A, B,
B, A) inside one chip call.  Needs one card.  ``--only`` runs the named
sections alone (``decode,prefill,backward,sgd_sparse,grad,lm,wide,dense_grad``;
``decode``, ``sgd_sparse`` and ``grad`` by default).
Prints one JSON line:

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
  local_batch=6470)`` on w8a, the gradient kernels' epochs: ms per epoch;
* ``lm``: full-width h2o-danube-1.8b served as ``chip_smoke.py``'s phase
  ``lm`` serves it (``repro_torch.launch.serve.setup``, 8 requests on 4
  slots, 16 new tokens, seed 0; bf16, random weights): the run's ms a
  decode step and tokens/s by the host clock, its ``flash_attn`` launches,
  then 16 ticks on 4 live slots (ms a tick) and the device ms of 4
  profiled ticks;
* ``prefill``: ``flash_attention`` at danube's prefill (B=1, S=8192,
  window 4096, bf16) and at llama-3.2-vision's cross call (B=1, Hq=32,
  Hkv=8, Sq=2,048 over Sk=1,600, hd 128, no mask) on plain tensors and
  through the operator (inputs that require grad): ms by CUDA events,
  device ms, and the kernels that ran (the profiler's names);
* ``wide``: the paper profile's widest shapes: Table 4's ``seq`` epoch on
  news (its first 1,024 rows densified, 1,024 x 1,355,191, micro-batch 1)
  and ``ell_glm_grad`` on rcv1 (677,399 x 47,236, K=438) and news (19,996
  x 1,355,191, K=2,729) at full size, drawn on the card (``wide_ell``):
  ms by CUDA events, device ms by kernel, the byte bound;
* ``dense_grad``: ``glm_grad`` in the row layout past 1,024 features, on
  dense unit-normal rows drawn on the card: 2,003 x 60,000, the dense
  wide set 16,384 x 20,958 and 16,384 x 2,048 (``chip_smoke.py``'s
  ``WIDE_SWEEP_SHAPES``): ms by CUDA events over 20 calls, device ms from
  the profiler, the byte bound;
* ``backward``: the gradient of ``flash_attention`` (``autograd.grad``
  over one forward's graph, so the backward operator alone runs) at
  danube's training layer (B=2, S=8192, window 4096, bf16) and at fp32
  causal 1,024 x 1,024 on danube's heads: ms by CUDA events over 5 calls
  and device ms by kernel, whatever kernels the checkout's backward runs.
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
            "ms": events_ms(call, 200), **profiler_ms(call, 200),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(call), "host_us_cuda_flavor": host_us(flavor),
            "sdpa_ms": events_ms(lib, 200),
            "sdpa_device_ms": profiler_ms(lib, 200)["device_ms"],
            "sdpa_host_us": host_us(lib), "vs_sdpa_max_abs_err": err})
    return rows


#: ``prefill``'s calls: (label, (B, Hq, Hkv, Sq, Sk, hd), causal, window)
PREFILL_SHAPES = (("danube", (1, 32, 8, 8192, 8192, 80), True, 4096),
                  ("vlm_cross", (1, 32, 8, 2048, 1600, 128), False, None))


def prefill_rows(K) -> list[dict]:
    """``flash_attention`` at PREFILL_SHAPES (bf16): plain tensors (the
    no-grad path), and inputs that require grad (the training path's
    forward through the operator, which in a checkout whose backward reads
    the forward's statistics also writes each row's log-sum-exp and the
    output's rounding residual); ms by CUDA events over 20 calls and the
    profiler's device ms by kernel."""
    rows = []
    for name, shape, causal, window in PREFILL_SHAPES:
        b, hq, hkv, sq, sk, hd = shape
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn(b, hq, sq, hd, device="cuda", generator=g).bfloat16()
        k = torch.randn(b, hkv, sk, hd, device="cuda", generator=g).bfloat16()
        v = torch.randn(b, hkv, sk, hd, device="cuda", generator=g).bfloat16()
        for label, grad in (("no_grad", False), ("operator", True)):
            x = [t.detach().requires_grad_(grad) for t in (q, k, v)]
            call = lambda: K.flash_attention(  # noqa: E731
                *x, causal=causal, window=window)
            rows.append({"call": name, "shape": list(shape), "path": label,
                         "ms": events_ms(call, 20), **profiler_ms(call, 20)})
    return rows


def backward_rows(K) -> list[dict]:
    """The attention backward through autograd at danube's training layer
    (bf16, B=2, S=8192, window 4096) and at fp32 causal 1,024 x 1,024:
    ms by CUDA events and device ms by kernel of one backward."""
    rows = []
    for shape, dtype, window in (((2, 32, 8, 8192, 80), torch.bfloat16, 4096),
                                 ((1, 32, 8, 1024, 80), torch.float32, None)):
        b, hq, hkv, s, hd = shape
        g = torch.Generator(device="cuda").manual_seed(11)
        x = [torch.randn(b, h, s, hd, device="cuda", generator=g).to(dtype)
             .requires_grad_() for h in (hq, hkv, hkv)]
        do = torch.randn(b, hq, s, hd, device="cuda", generator=g).to(dtype)
        out = K.flash_attention(*x, causal=True, window=window)
        call = lambda: torch.autograd.grad(  # noqa: E731
            out, x, do, retain_graph=True)
        rows.append({"shape": list(shape), "dtype": str(dtype),
                     "window": window, "ms": events_ms(call, 5),
                     **profiler_ms(call, 5)})
        del x, do, out
        torch.cuda.empty_cache()
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


def wide_ell(n: int, d: int, avg_nnz: float, k: int, seed: int = 0):
    """Padded-ELL ``(values, indices, y)`` of ``n`` rows drawn on the card
    as ``chip_smoke.wide_dataset`` draws them (log-normal row lengths,
    Zipfian features over d, value-0 padding at index 0, planted labels),
    so both checkouts time the same data."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    nnz = torch.exp(np.log(avg_nnz) + 0.8 * torch.randn(
        n, 1, device="cuda", generator=g)).clamp(1, k).long()
    live = torch.arange(k, device="cuda")[None] < nnz
    ranks = torch.arange(1, d + 1, device="cuda", dtype=torch.float64)
    cdf = torch.cumsum(1.0 / ranks, 0)
    cdf /= cdf[-1].clone()
    idx = torch.empty(n, k, device="cuda", dtype=torch.int32)
    for r0 in range(0, n, 65_536):
        u = torch.rand(min(65_536, n - r0), k, device="cuda", generator=g,
                       dtype=torch.float64)
        idx[r0:r0 + len(u)] = torch.searchsorted(cdf, u).clamp_(max=d - 1)
        del u
    idx *= live
    vals = torch.randn(n, k, device="cuda", generator=g) * live
    del live
    w_star = torch.randn(d, device="cuda", generator=g) / ranks.sqrt().float()
    y = torch.cat([torch.where((vals[r0:r0 + 65_536] * w_star[
        idx[r0:r0 + 65_536].long()]).sum(1) >= 0, 1.0, -1.0)
        for r0 in range(0, n, 65_536)])
    y[torch.rand(n, device="cuda", generator=g) < 0.05] *= -1.0
    return vals, idx, y


#: news and rcv1 at their Table 3 sizes, K paper_dataset's pad width:
#: (rows, d, nonzeros a row on average, K)
NEWS = (19_996, 1_355_191, 454.99, 2_729)
RCV1 = (677_399, 47_236, 73.16, 438)


def wide_rows(K, sparse) -> list[dict]:
    """Table 4's ``seq`` epoch on news (its first 1,024 rows densified,
    micro-batch 1, step 1e-3 from w = 0) and ``ell_glm_grad`` on rcv1 and
    news at full size (``SyncSGD()``'s gradient): ms by CUDA events, device
    ms by kernel from the profiler, the byte bound."""
    rows = []
    news = wide_ell(*NEWS)
    d = NEWS[1]
    X = sparse.to_dense(sparse.ELLMatrix(news[0][:1_024], news[1][:1_024], d))
    ys, w0 = news[2][:1_024], torch.zeros(d, device="cuda")
    seq = lambda: K.glm_sgd_epoch(  # noqa: E731
        "lr", w0, X, ys, step=1e-3, micro_batch=1)
    rows.append({"case": "news seq N=1024 MB=1", "ms": events_ms(seq, 3),
                 **profiler_ms(seq, 3),
                 "bound_ms": (X.numel() + 1_024 + 2 * d) * 4
                 / HBM_BYTES_PER_S * 1e3})
    del X
    torch.cuda.empty_cache()
    for label, (v, i, y), nd in (("rcv1", wide_ell(*RCV1), RCV1[1]),
                                 ("news", news, d)):
        w = torch.randn(nd, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3)) * 0.01
        grad = lambda: K.ell_glm_grad("lr", w, v, i, y)  # noqa: E731
        rows.append({"case": f"{label} gradient {list(v.shape)}",
                     "ms": events_ms(grad, 20), **profiler_ms(grad, 20),
                     "bound_ms": (ell_bytes(v) + 4 * len(y) + 8 * nd)
                     / HBM_BYTES_PER_S * 1e3})
    return rows


#: phase ``lm``'s serving run (``chip_smoke.LM_ARGV``)
LM_ARGV = ["--arch", "h2o-danube-1.8b", "--requests", "8", "--slots", "4",
           "--max-new", "16", "--max-len", "128", "--seed", "0"]


#: ``dense_grad``'s (N, d)
DENSE_GRAD_SHAPES = ((2_003, 60_000), (16_384, 20_958), (16_384, 2_048))


def dense_grad_rows(K) -> list[dict]:
    rows = []
    for n, d in DENSE_GRAD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(d)
        X = torch.randn(n, d, device="cuda", generator=g)
        y = torch.where(torch.rand(n, device="cuda", generator=g) < 0.5,
                        -1.0, 1.0)
        w = torch.randn(d, device="cuda", generator=g) * 0.01
        fn = lambda: K.glm_grad("lr", w, X, y)  # noqa: E731
        rows.append({"case": f"glm_grad N={n} d={d}",
                     "ms": events_ms(fn, 20), **profiler_ms(fn, 20),
                     "bound_ms": (X.numel() + n + 2 * d) * 4
                     / HBM_BYTES_PER_S * 1e3})
        del X
    return rows


def lm_run() -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.serve.engine import Request, ServeEngine

    args = serve.parse_args(LM_ARGV)
    cfg, engine, reqs = serve.setup(args)
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    done = engine.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    out = {"decode_steps": engine.steps, "tokens": tokens, "wall_s": wall,
           "ms_per_step": wall / engine.steps * 1e3,
           "tokens_per_s": tokens / wall,
           "flash_attn_launches": common.LAUNCHES["flash_attn"]}
    stretch = ServeEngine(cfg, engine.params, slots=args.slots,
                          max_len=args.max_len, device="cuda")
    for i in range(args.slots):
        stretch.try_admit(Request(100 + i, np.arange(1, 5) + i, max_new=64))
    tick = lambda: [stretch.tick() for _ in range(4)]  # noqa: E731
    tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        stretch.tick()
    torch.cuda.synchronize()
    out["ms_per_tick"] = (time.perf_counter() - t0) / 16 * 1e3
    out["device_ms_per_tick"] = profiler_ms(tick, 1)["device_ms"] / 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tick()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out["host_top_ops"] = {  # self host ms a tick, calls a tick
        e.key[:60]: [e.self_cpu_time_total / 4e3, e.count / 4]
        for e in top[:15]}
    return out


SECTIONS = ("decode", "prefill", "backward", "sgd_sparse", "grad", "lm",
            "wide", "dense_grad")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="decode,sgd_sparse,grad")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        ap.error(f"--only takes sections of {SECTIONS}")
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
    _build.build_all((["flash_attn"] if {"decode", "prefill", "backward",
                                         "lm"} & set(only) else []) + (
        ["flash_attn_bwd"] if "backward" in only else []) + (
        ["glm_grad"] if "dense_grad" in only else []) + (
        ["glm_grad", "glm_sgd_sparse", "glm_sparse"]
        if {"sgd_sparse", "grad"} & set(only) else []) + (
        ["glm_sgd", "glm_sparse"] if "wide" in only else []))
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"label": args.label, "root": args.root, "nvidia_smi": smi,
           "build_s": build_s}
    if "decode" in only:
        res["decode"] = decode_rows(K, ops)
    if "prefill" in only:
        res["prefill"] = prefill_rows(K)
    if "backward" in only:
        res["backward"] = backward_rows(K)
    train = []
    if "sgd_sparse" in only:
        res["sgd_sparse"], sparse_train = sparse_rows(K, synthetic, sgd)
        train.append(sparse_train)
    if "grad" in only:
        res["grad"], grad_train = grad_rows(K, synthetic, sgd)
        train += grad_train
    if train:
        res["train"] = train
    if "lm" in only:
        res["lm"] = lm_run()
    if "wide" in only:
        from repro_torch.core import sparse
        res["wide"] = wide_rows(K, sparse)
    if "dense_grad" in only:
        res["dense_grad"] = dense_grad_rows(K)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
