#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (SGD study engine and the paper's study layer,
scoring service, live learner and LM serving) on one NVIDIA card.

    python3 chip_smoke.py          (from the repository root; needs one card)

Phases, one JSON line each:

1. ``env``     card name and power limit, torch, CUDA, nvcc, triton;
2. ``build``   compiles the six sources from src/repro_torch/kernels/csrc
               (one nvcc per source, all at once) and reports ptxas usage;
3. ``kernels`` holds each kernel against its plain PyTorch version on the
               card: both tasks, both glm_grad layouts, covtype and w8a
               widths, a ragged N, a replica axis, real-sim's width, and
               both glm_score kernels (flat and group) at w8a, real-sim and
               news widths, rows of 3 words in a batch of 5, and values at
               another 16-byte offset than their indices, with filler rows
               that must score link(0) exactly; glm_sgd at d = 3, 54, 300,
               1024 and 1025 (warp, smem and cluster variants),
               micro-batches 1 to 64 with ragged tails, 1, 8 and 10
               replicas; glm_sgd_sparse's warp
               variant at micro-batches 1, 10 and 64, K = 1, real-sim's
               K = 307, rows of all padding, rows that collide on one
               feature and repeat it, the live learner's shape, and the
               shared-memory variant near the cap; flash_attn at danube's
               prefill (S=8192, window 4096), a full causal 2048 at
               minitron's heads, the tensor-core variant's edges (rep 3 with
               a ragged S, padded head dims, a query chunk over a longer
               cache, a window inside one key tile, acausal, exactly 16
               rows, rows that see no key), the decode variant's (Sk = 1,
               127, 128 and 4096, a cache prefix read in place, head dims
               64, 72 and 128, B = 64 with no split, a window that leaves
               chunks with no key, two row groups, the same output twice)
               and small fp32 cases; glm_grad's ring variant at d = 3, 54
               and 300 with a ragged last tile; glm_sparse's smem variant
               at w8a (R = 1 and 10 x 6,470), real-sim's width and every
               glm_sgd_sparse edge case above (rows of all padding, a
               feature three times in every row), and its atomic variant
               near the cap; the wide models (glm_sgd's cluster variant at
               d = 58,112 and 65,536, its global variant at 100,000,
               glm_grad's row layout at 60,000, glm_sgd_sparse's stream
               variant at news' width with K = 2,729, micro-batches 1 and
               10, several replicas, also with the padding spread through
               the rows, and its global variant past the stream's K); five
               calls of glm_grad, glm_sparse, glm_sgd's cluster variant and
               both glm_score kernels at the serving flushes' shapes giving
               the same bits; and that the sparse kernels refuse an index
               outside [0, d);
4. ``train``   ``repro_torch.core.sgd.run`` at the full size of the paper's
               covtype (581,012 x 54, dense) and w8a (64,700 x 300, K=69,
               padded ELL) stand-ins, six strategies; launch counts are zeroed
               just before and read just after, and the variants the path's
               shapes pick are checked (glm_grad's ring, glm_sparse's smem,
               glm_sgd_sparse's warp); then the same strategies at
               N=4,100 through the kernels and through the plain versions on
               the card, loss for loss;
5. ``news``    the paper's news at full size (19,996 x 1,355,191, K =
               2,729: a 437 MB padded ELL drawn on the card,
               ``news_dataset``) through ``sgd.run`` under Table 7's
               ``AsyncLocalSGD(replicas=8 and 64, local_batch=1)`` for 3
               epochs, launch counts zeroed just before and read just
               after (glm_sgd_sparse's stream variant); ms per epoch and
               us per update; then both on the first 1,600 rows through
               the kernels and through the plain versions, loss for loss;
6. ``study``   the paper's study layer (``repro_torch.study`` and the
               drivers in ``repro_torch.benchmarks``): (a) the Table 7,
               Table 4 and Fig. 22 drivers on the ci profile (covtype, w8a,
               real-sim at 2,048 rows, LR and SVM, 12 epochs, grid 1e-3,
               1e-2, 1e-1) on a fresh runner through the kernels and again
               through the plain versions, every trial's losses held
               loss for loss and every row's best step and epochs to 1%
               equal, with the claim checks' verdicts; (b) covtype, w8a and
               real-sim at their full Table 3 sizes through
               ``tuner.tune_many`` under Table 7's four configurations and
               ``SyncSGD()`` (LR, the same grid and epochs), launch counts
               zeroed just before and read just after, each row with ms per
               iteration, epochs and seconds to 1%, best step, final loss
               and launches by family, and Table 4's execution paths and
               ``speedup_sync_vs_seq`` on each dataset;
7. ``serve``   ``GLMScoreEngine`` on the card: all 64,700 w8a rows as
               requests under the model phase ``train``'s SyncSGD run ended
               with (max_batch 128, with a swap_model halfway, and 32), and
               8,192 real-sim-width requests; launch counts zeroed just
               before and read just after (one glm_score launch a flush, on
               the variant each run's line names); every response held
               against the plain version under the snapshot version it
               carries;
8. ``live``    train-while-serving: ``LiveLearner`` on a real-sim-width
               stream publishing into an engine that a second thread
               serves, exact and int8-compressed, with replicas killed and
               revived; each configuration also run in lockstep through the
               kernels and through the plain versions and held merge by
               merge (int8: also with the plain learner resynced after each
               merge, and its codes compared); short glm_sparse and dense
               runs;
9. ``lm``      the LM serving path on full-width h2o-danube-1.8b (random
               weights from a seeded generator on the card): the serving
               run of ``repro_torch.launch.serve`` (8 requests, 4 slots,
               max_new 16, max_len 128) with launch counts zeroed just
               before and read just after; its logits at every step and
               its caches held against the same steps through the plain
               versions, with the same weights in fp32 as the yardstick
               (``_held_bf16``); a profiled stretch of ticks; and one
               prefill forward at S=8192 held the same way;
10. ``timing`` each kernel and its plain version at the main path's shapes
               (glm_sgd also at covtype R=8 B=1, on its shared-memory
               variant at covtype B=16, on its cluster variant beside the
               shared-memory one at phase study's real-sim seq epoch and
               beside the global one at d = 58,112, glm_grad also in the
               col layout, glm_sgd_sparse also at w8a R=10 B=1 and at news
               R=8 and R=64 B=1 on its stream variant and on the global
               variant,
               glm_grad and glm_sparse each beside the kernel their
               redesign replaced, glm_sparse also at R=10, glm_score's flat
               kernel beside the group kernel at w8a N = 128 and 32,
               real-sim N = 128, all of w8a and news N = 512, flash_attn
               decode also over a full 4096-key window, and an fp32 call),
               with the variant each row ran and its device time
               (profiler, or a CUDA event pair around one call where the
               profiler saw no launch), the decode wrapper's host us per
               call, a check of w8a's R=10 full-partition gradient, and
               the device time of a launch that does nothing.

It then prints the card's name and power limit, a ``{"kernels": [...]}`` line
(launches on the main paths and on phase study's full-size run, error,
times, bound, variant: a row for each kernel the main paths run, named by
its variant where a family has more than one) and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without a card, or without the repository beside it, it fails.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: bf16 on the tensor cores, dense (the attention bound counts bf16 work)
BF16_FLOPS_PER_S = 989e12

GRAD_TOL = dict(rtol=1e-4, atol=2e-3)    # the JAX conformance suite's
EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
#: fp32 attention against its plain version
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
#: bf16 attention: kernel and plain version both compute in fp32 and round
#: once to bf16, so an element may land one bf16 step apart (at most 2^-7
#: of its value); atol covers fp32 summation order near zero
ATTN_BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)

REPLACES = {
    "glm_sgd": "src/repro/kernels/glm_sgd/kernel.py:73",
    "glm_grad": "src/repro/kernels/glm_grad/kernel.py:90",
    "glm_sgd_sparse": "src/repro/kernels/glm_sgd_sparse/kernel.py:86",
    "glm_sparse": "src/repro/kernels/glm_sparse/kernel.py:108",
    "glm_score": "src/repro/kernels/glm_score/kernel.py:72",
    "flash_attn": "src/repro/kernels/flash_attn/kernel.py:110",
}


#: the __global__ functions each wrapper launches (csrc/<name>.cu), by the
#: variant its ops.variant() picks (None: the family has one)
KERNEL_SYMBOLS = {
    "glm_sgd": {"warp": ("glm_sgd_warp_kernel",),
                "cluster": ("glm_sgd_cluster_kernel",),
                "smem": ("glm_sgd_kernel",),
                "global": ("glm_sgd_global_kernel",)},
    "glm_grad": {"ring": ("glm_grad_ring_kernel", "glm_grad_reduce_kernel"),
                 "row": ("glm_grad_row_kernel", "glm_grad_reduce_kernel"),
                 "col": ("glm_grad_col_kernel", "glm_grad_reduce_kernel")},
    "glm_sgd_sparse": {"warp": ("ell_sgd_warp_kernel",),
                       "smem": ("ell_sgd_kernel",),
                       "stream": ("ell_sgd_stream_kernel",),
                       "global": ("ell_sgd_global_kernel",)},
    "glm_sparse": {"smem": ("ell_grad_smem_kernel", "ell_grad_reduce_kernel"),
                   "atomic": ("ell_grad_kernel",)},
    "glm_score": {"flat": ("glm_score_flat_kernel",),
                  "group": ("glm_score_kernel",)},
    "flash_attn": {"mma": ("flash_attn_mma_kernel",),
                   "decode": ("flash_attn_decode_kernel",),
                   "simt": ("flash_attn_kernel",)},
}
#: cycles the card spins before an event-timed call (about 1 ms at the
#: H100's 1.98 GHz boost), longer than the host takes to enqueue the call
SLEEP_CYCLES = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def close(out: torch.Tensor, ref: torch.Tensor, tol: dict) -> tuple[float, bool]:
    """Max |out - ref| and whether every element is within atol + rtol|ref|."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
    return float(diff.max()), ok


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after one warm-up call."""
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


def host_us(fn, rounds: int = 10, calls: int = 100) -> float:
    """Host us per call of ``fn``: the host clock over ``rounds`` rounds of
    ``calls`` calls, each round behind a spin kernel that keeps the card
    busy (about 10 ms), so the calls only enqueue and nothing waits."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(rounds):
        torch.cuda._sleep(10 * SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (rounds * calls) * 1e6


def device_profile(fn, reps: int) -> dict[str, tuple[float, int]]:
    """Device time of the kernels ``fn`` runs, from ``torch.profiler`` over
    ``reps`` calls: name -> (total ms, launches).  The trace opens with a
    warm-up step of ``reps`` calls whose records it discards: a trace's
    first launches can go unrecorded (seen on the card: the first 8 to 17
    launches of a window, all of them when a window held 3 to 10 long
    ones), so the step that counts starts after them."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends, the counted one starts
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        # leaving the block ends the counted step: a step() here would
        # start a new cycle and clear its records
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def event_device_ms(fn) -> float:
    """Device ms of one call of ``fn`` from a CUDA event pair around it,
    with the card kept busy by a spin kernel while the host enqueues the
    call, so the pair holds the call's device work and no host time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def kernel_device_time(fn, reps: int, names: tuple[str, ...]) -> dict:
    """Device ms of one call of ``fn``: from ``torch.profiler`` over
    ``reps`` calls (the mean time of each kernel whose name holds one of
    ``names``, summed: each runs once a call; the mean over the launches
    the trace recorded), or, where the trace recorded none of them, from
    ``event_device_ms``.  Also how many launches the trace recorded of the
    ``reps`` calls."""
    prof = device_profile(fn, reps)
    hits = [(ms, count) for key, (ms, count) in prof.items()
            if any(n in key for n in names)]
    out = {"profiled_calls": reps,
           "profiler_launches": sum(count for _, count in hits)}
    if hits:
        return {"device_ms": sum(ms / count for ms, count in hits),
                "device_ms_from": "profiler", **out}
    return {"device_ms": event_device_ms(fn), "device_ms_from": "events",
            **out}


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespace noise and arguments."""
    name = kernel.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:60]


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ell_bytes(values: torch.Tensor) -> int:
    """Bytes a padded-ELL operand has to move: every value (a kernel finds
    the padding by reading it) and the 4-byte index of each nonzero.  The
    padding sits at the end of each row, so a kernel that skips value-0
    entries never needs their indices."""
    return nbytes(values) + 4 * int((values != 0).sum())


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs attention computes: query i sits at i + sk - sq
    and sees key j iff j <= its position (causal) and it is less than
    ``window`` behind."""
    pos = np.arange(sq) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attn_work(q, k, causal, window) -> tuple[int, float]:
    """Bytes (q, k, v read once, the output written once) and flops (QK^T
    and P.V over the visible pairs) of one attention call."""
    b, hq, sq, hd = q.shape
    pairs = visible_pairs(sq, k.shape[2], causal, window)
    return 2 * nbytes(q) + 2 * nbytes(k), 4.0 * hd * pairs * b * hq


def end_aligned_mask(sq, sk, causal, window, dev) -> torch.Tensor | None:
    """The reference's visibility as a boolean [sq, sk] mask for
    ``scaled_dot_product_attention`` (whose ``is_causal`` aligns the
    first query with the first key); None where every key is visible."""
    qi = torch.arange(sq, device=dev)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=dev)[None]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= qi - kj < window
    return None if bool(mask.all()) else mask


def _attn_inputs(shape, dtype, dev, seed):
    """q [B, Hq, Sq, hd], k, v [B, Hkv, Sk, hd] drawn on the card."""
    b, hq, hkv, sq, sk, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, hq, sq, hd, device=dev, generator=g).to(dtype),
            torch.randn(b, hkv, sk, hd, device=dev, generator=g).to(dtype),
            torch.randn(b, hkv, sk, hd, device=dev, generator=g).to(dtype))


#: flash_attn cases of phase ``kernels``: (label, (B, Hq, Hkv, Sq, Sk, hd),
#: dtype, causal, window)
ATTN_CASES = (
    ("danube prefill", (1, 32, 8, 8192, 8192, 80), torch.bfloat16, True, 4096),
    ("full causal, minitron heads", (1, 24, 8, 2048, 2048, 128),
     torch.bfloat16, True, None),
    ("decode Sk=1", (4, 32, 8, 1, 1, 80), torch.bfloat16, True, None),
    ("decode Sk=127", (4, 32, 8, 1, 127, 80), torch.bfloat16, True, None),
    ("decode Sk=4096", (4, 32, 8, 1, 4096, 80), torch.bfloat16, True, None),
    ("fp32 ragged Sq<Sk", (2, 4, 2, 5, 37, 16), torch.float32, True, None),
    ("fp32 acausal GQA 2:1", (2, 6, 3, 7, 40, 24), torch.float32, False, None),
    ("fp32 window, Sq<Sk", (1, 4, 2, 33, 70, 80), torch.float32, True, 9),
    ("fp32 acausal window, hd 128", (1, 4, 1, 20, 50, 128), torch.float32,
     False, 7),
    # the tensor-core variant's edges
    ("rep 3, ragged S", (1, 24, 8, 1000, 1000, 128), torch.bfloat16, True,
     None),
    ("hd 72, depth padded to 80", (2, 8, 2, 300, 300, 72), torch.bfloat16,
     True, None),
    ("hd 120, window", (1, 8, 8, 200, 200, 120), torch.bfloat16, True, 50),
    ("query chunk over a longer cache", (2, 32, 8, 37, 900, 80),
     torch.bfloat16, True, 256),
    ("window 7 inside one key tile", (1, 4, 1, 500, 500, 64), torch.bfloat16,
     True, 7),
    ("acausal bf16", (2, 12, 4, 130, 200, 80), torch.bfloat16, False, None),
    ("16 rows: the smallest mma call", (1, 4, 1, 4, 40, 32), torch.bfloat16,
     True, None),
    # the decode variant's edges (bf16, fewer than 16 rows)
    ("15 rows: decode, two row groups", (1, 5, 1, 3, 40, 32), torch.bfloat16,
     True, None),
    ("decode Sk=128", (4, 32, 8, 1, 128, 80), torch.bfloat16, True, None),
    ("decode hd 64", (4, 32, 8, 1, 1000, 64), torch.bfloat16, False, None),
    ("decode hd 72", (2, 12, 4, 1, 300, 72), torch.bfloat16, True, None),
    ("decode hd 128, rep 3", (4, 24, 8, 1, 2000, 128), torch.bfloat16, True,
     None),
    ("decode B=64: no split", (64, 32, 8, 1, 4096, 80), torch.bfloat16,
     False, None),
    ("decode window: chunks that see no key", (2, 32, 8, 1, 3000, 80),
     torch.bfloat16, True, 100),
    ("decode one kv head, 9 rows", (2, 9, 1, 1, 700, 16), torch.bfloat16,
     True, None),
)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def forced_variant(ops, kind: str):
    """Make a family's wrapper run the variant ``kind`` for a while: how a
    redesigned kernel's predecessor is timed beside it, in the same call."""
    saved = ops.variant
    ops.variant = lambda *shape: kind
    try:
        yield
    finally:
        ops.variant = saved


def same_bits(fn, calls: int = 5) -> bool:
    """Whether ``calls`` calls of ``fn`` give the same bits."""
    outs = [fn() for _ in range(calls)]
    return all(torch.equal(outs[0], o) for o in outs[1:])


def phase_env(smi: str) -> dict:
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    return {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "python": sys.version.split()[0],
            "nvcc": nvcc.strip().splitlines()[-1], "triton": triton_version,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count()}


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    usage = {name: [ln.strip() for ln in text.splitlines()
                    if re.search(r"Used \d+ registers", ln)]
             for name, text in reports.items()}
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": _build.sources(), "built": sorted(reports),
            "ptxas": usage}


def _dense_inputs(rng, n, d, dev):
    X = torch.from_numpy(rng.normal(0, 1, (n, d)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0, 1.0)
                         .astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return X, y, w


def _ell_inputs(rng, n, d, avg, k, dev, seed):
    from repro_torch.data import synthetic

    ds = synthetic.make_sparse("check", n, d, avg, k, seed=seed, pad_to=k,
                               device=dev)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    return ds.ell.values, ds.ell.indices, ds.y, w


def _wide_ell_inputs(n, d, k, dev, seed):
    """Padded-ELL rows at a width ``make_sparse`` is too slow for (news):
    row lengths uniform in [1, k], indices uniform in [0, d), drawn on the
    card; the padding is value 0 at index 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nnz = torch.randint(1, k + 1, (n, 1), device=dev, generator=g)
    live = torch.arange(k, device=dev)[None] < nnz
    v = torch.randn(n, k, device=dev, generator=g) * live
    i = torch.randint(0, d, (n, k), device=dev, generator=g,
                      dtype=torch.int32) * live
    w = torch.randn(d, device=dev, generator=g) * 0.1
    return v, i, w


#: the paper's news (Table 3) at full size; K is paper_dataset's pad width
NEWS = dict(n=19_996, d=1_355_191, avg_nnz=454.99, k=2_729)


def news_dataset(dev, seed: int = 0):
    """news at full size as a padded-ELL ``(ELLMatrix, y)`` drawn on the
    card with ``synthetic.make_sparse``'s profile: log-normal row lengths
    around 455 nonzeros clipped to [1, 2,729], Zipfian feature popularity
    (an inverse-CDF draw over 1/rank), N(0, 1) values, value-0 padding at
    index 0, and labels planted by w* ~ N(0, 1/rank) with 5% flipped.
    ``make_sparse`` draws row by row on the host, which takes hours at
    this width; here a feature may repeat within a row."""
    from repro_torch.core import sparse

    n, d, k = NEWS["n"], NEWS["d"], NEWS["k"]
    g = torch.Generator(device=dev).manual_seed(seed)
    nnz = torch.exp(np.log(NEWS["avg_nnz"]) + 0.8 * torch.randn(
        n, 1, device=dev, generator=g)).clamp(1, k).long()
    live = torch.arange(k, device=dev)[None] < nnz
    ranks = torch.arange(1, d + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(1.0 / ranks, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, k, device=dev, generator=g, dtype=torch.float64)
    idx = torch.searchsorted(cdf, u).clamp_(max=d - 1).to(torch.int32) * live
    del u
    vals = torch.randn(n, k, device=dev, generator=g) * live
    w_star = torch.randn(d, device=dev, generator=g) / ranks.sqrt().float()
    y = torch.where((vals * w_star[idx.long()]).sum(1) >= 0, 1.0, -1.0)
    y[torch.rand(n, device=dev, generator=g) < 0.05] *= -1.0
    return sparse.ELLMatrix(vals, idx, d), y


def phase_kernels(dev) -> tuple[dict, dict]:
    """Every kernel against its plain version on the card, small shapes."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_score.ref import glm_score_ref
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    from repro_torch.kernels.glm_score import ops as score_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops

    rng = np.random.default_rng(0)
    cases, worst = [], {}

    def record(kernel, label, out, ref, tol):
        err, ok = close(out, ref, tol)
        cases.append({"kernel": kernel, "case": label, "max_abs_err": err,
                      "tol": tol, "ok": ok})
        worst[kernel] = max(worst.get(kernel, 0.0), err)

    from repro_torch.kernels.glm_grad import ops as grad_ops
    for task in ("lr", "svm"):
        # the ring variant's edges: a ragged last tile (4,099 rows), d = 3
        # (128-row tiles of 1.5 KB), 54 and 300 (27-row tiles)
        for n, d in ((4096, 54), (4099, 54), (3000, 300), (4099, 3)):
            X, y, w = _dense_inputs(rng, n, d, dev)
            for layout in ("row", "col"):
                record("glm_grad", f"{task} n={n} d={d} "
                       f"{grad_ops.variant(d, layout)}",
                       K.glm_grad(task, w, X, y, layout=layout),
                       glm_grad_ref(task, w, X, y), GRAD_TOL)
            for mb in (1, 16):
                record("glm_sgd", f"{task} n={n} d={d} mb={mb}",
                       K.glm_sgd_epoch(task, w, X, y, step=0.01, micro_batch=mb),
                       glm_sgd_epoch_ref(task, w[None], X[None], y[None], 0.01,
                                         mb)[0], EPOCH_TOL)
        X, y, w = _dense_inputs(rng, 8 * 512, 54, dev)
        Xr, yr = X.reshape(8, 512, 54), y.reshape(8, 512)
        W = w[None] * torch.arange(1, 9, device=dev, dtype=torch.float32)[:, None]
        record("glm_sgd", f"{task} R=8 per=512 d=54 mb=1",
               K.glm_sgd_epoch(task, W, Xr, yr, step=0.01, micro_batch=1),
               glm_sgd_epoch_ref(task, W, Xr, yr, 0.01, 1), EPOCH_TOL)

        for n, d, avg, k, label in ((4096, 300, 11.65, 69, "w8a"),
                                    (4101, 300, 11.65, 69, "w8a ragged"),
                                    (2000, 20_958, 51.30, 307, "real-sim")):
            v, i, y, w = _ell_inputs(rng, n, d, avg, k, dev, seed=n)
            record("glm_sparse", f"{task} {label} n={n} d={d} K={k}",
                   K.ell_glm_grad(task, w, v, i, y),
                   ell_glm_grad_ref(task, w[None], v[None], i[None], y[None])[0],
                   GRAD_TOL)
            for mb in (1, 10):
                record("glm_sgd_sparse", f"{task} {label} n={n} d={d} K={k} mb={mb}",
                       K.ell_sgd_epoch(task, w, v, i, y, step=0.05, micro_batch=mb),
                       ell_sgd_epoch_ref(task, w[None], v[None], i[None], y[None],
                                         0.05, mb)[0], EPOCH_TOL)
        v, i, y, w = _ell_inputs(rng, 10 * 410, 300, 11.65, 69, dev, seed=7)
        vr, ir, yr = v.reshape(10, 410, 69), i.reshape(10, 410, 69), y.reshape(10, 410)
        W = w[None] * torch.arange(1, 11, device=dev, dtype=torch.float32)[:, None]
        record("glm_sparse", f"{task} w8a R=10 per=410",
               K.ell_glm_grad(task, W, vr, ir, yr),
               ell_glm_grad_ref(task, W, vr, ir, yr), GRAD_TOL)
        # glm_sparse at the full w8a stand-in's shape under R=10 replicas
        # (AsyncLocalSGD(replicas=10, local_batch=6470))
        v, i, y, w = _ell_inputs(rng, 64_700, 300, 11.65, 69, dev, seed=8)
        vr, ir, yr = v.reshape(10, 6470, 69), i.reshape(10, 6470, 69), \
            y.reshape(10, 6470)
        W = w[None] * torch.linspace(-1.0, 1.0, 10, device=dev)[:, None]
        record("glm_sparse", f"{task} w8a R=10 per=6470 "
               f"{sparse_grad_ops.variant(300, 69, 10)}",
               K.ell_glm_grad(task, W, vr, ir, yr),
               ell_glm_grad_ref(task, W, vr, ir, yr), GRAD_TOL)
        record("glm_sgd_sparse", f"{task} w8a R=10 per=410 mb=10",
               K.ell_sgd_epoch(task, W, vr, ir, yr, step=0.05, micro_batch=10),
               ell_sgd_epoch_ref(task, W, vr, ir, yr, 0.05, 10), EPOCH_TOL)
        # glm_score, both kernels: every fifth row an all-zero filler row,
        # which must score link(0) exactly (0.5 for LR, 0.0 for SVM); rows
        # of 3 words (fewer than a 16-byte chunk) in a batch of 5; and the
        # values at another offset from a 16-byte boundary than the
        # indices (read word by word)
        link0 = 0.5 if task == "lr" else 0.0
        for n, d, avg, k, label in ((4096, 300, 11.65, 69, "w8a"),
                                    (37, 300, 11.65, 69, "w8a ragged"),
                                    (2000, 20_958, 51.30, 307, "real-sim"),
                                    (512, 1_355_191, 454.99, 2_729, "news"),
                                    (5, 50, 2.0, 3, "K=3"),
                                    (129, 300, 11.65, 69, "w8a offsets")):
            if label == "news":
                v, i, w = _wide_ell_inputs(n, d, k, dev, seed=n)
            else:
                v, i, _, w = _ell_inputs(rng, n, d, avg, k, dev, seed=n + 1)
                v, i = v.clone(), i.clone()
            v[::5], i[::5] = 0.0, 0
            if label == "w8a offsets":
                v, i = v[1:], i[1:].contiguous()
            ref = glm_score_ref(task, w, v, i)
            for kind in ("flat", "group"):
                with forced_variant(score_ops, kind):
                    out = K.glm_score(task, w, v, i)
                record("glm_score", f"{task} {label} n={v.shape[0]} d={d} "
                       f"K={k} {kind}", out, ref, GRAD_TOL)
                filler = slice(4, None, 5) if label == "w8a offsets" \
                    else slice(None, None, 5)
                cases.append({"kernel": "glm_score",
                              "case": f"{task} {label} {kind} filler rows "
                                      f"== {link0}",
                              "ok": bool((out[filler] == link0).all())})
    # glm_sgd at the variants' edges: skin's and covtype's widths, 300,
    # the warp kernel's widest (whose ring does not fit a micro-batch of
    # 64: the shared-memory kernel) and one past it (the cluster kernel, a
    # cluster of one block); micro-batches 1 to 64 (one butterfly, or rows
    # in chunks); n = 1037, 203 and 130 leave a ragged tail at every
    # micro-batch above 1
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    for d in (3, 54, 300, sgd_ops.WARP_MAX_D, sgd_ops.WARP_MAX_D + 1):
        for mb in (1, 10, 16, 64):
            for n, reps in ((1037, 1), (203, 8), (130, 10)):
                X, y, w = _dense_inputs(rng, n * reps, d, dev)
                Xr, yr = X.reshape(reps, n, d), y.reshape(reps, n)
                W = w[None] * torch.linspace(
                    -1.0, 1.0, reps, device=dev)[:, None]
                record("glm_sgd", f"lr d={d} mb={mb} R={reps} per={n} "
                       f"{sgd_ops.variant(d, mb)}",
                       K.glm_sgd_epoch("lr", W, Xr, yr, step=0.05,
                                       micro_batch=mb),
                       glm_sgd_epoch_ref("lr", W, Xr, yr, 0.05, mb), EPOCH_TOL)
    # glm_sgd_sparse at both variants' edges (the data is Zipfian, so the
    # rows of a batch collide on the popular features)
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    for label, n, d, avg, k, mb, reps in (
            ("w8a MB=64, ragged", 1037, 300, 11.65, 69, 64, 1),
            ("K=1", 1003, 300, 1.0, 1, 10, 1),
            ("live shape: real-sim R=8 per=32", 256, 20_958, 51.30, 307, 1, 8),
            ("d near the cap", 2003, 58_000, 11.65, 69, 10, 1),
            ("rows of all padding", 4100, 300, 11.65, 69, 10, 10),
            ("one feature in every row, three times", 4100, 300, 11.65, 69,
             10, 10),
            ("one feature in every row, three times", 4100, 300, 11.65, 69,
             1, 10)):
        v, i, y, w = _ell_inputs(rng, n, d, avg, k, dev, seed=n + k)
        if label == "rows of all padding":
            v, i = v.clone(), i.clone()
            v[::7], i[::7] = 0.0, 0
        elif label.startswith("one feature"):
            v, i = v.clone(), i.clone()
            v[:, -3:], i[:, -3:] = 1.0, 5   # feature 5 thrice in each row
        per = n // reps
        vr, ir = v[:reps * per].reshape(reps, per, k), i[:reps * per].reshape(
            reps, per, k)
        yr = y[:reps * per].reshape(reps, per)
        W = w[None] * torch.linspace(-1.0, 1.0, reps, device=dev)[:, None]
        for task in ("lr", "svm"):
            record("glm_sgd_sparse", f"{task} {label} n={n} d={d} K={k} "
                   f"mb={mb} R={reps} {sparse_ops.variant(d, k, mb)}",
                   K.ell_sgd_epoch(task, W, vr, ir, yr, step=0.05,
                                   micro_batch=mb),
                   ell_sgd_epoch_ref(task, W, vr, ir, yr, 0.05, mb), EPOCH_TOL)
            # the same edge cases through glm_sparse's variants
            record("glm_sparse", f"{task} {label} n={n} d={d} K={k} "
                   f"R={reps} {sparse_grad_ops.variant(d, k, reps)}",
                   K.ell_glm_grad(task, W, vr, ir, yr),
                   ell_glm_grad_ref(task, W, vr, ir, yr), GRAD_TOL)
    # models past a block's shared memory: glm_sgd at 58,112 (the first
    # width past it at micro-batch 1) and 65,536 features (the cluster
    # kernel's widest; batches streamed twice at micro-batches 10 and 16)
    # and at 100,000 (the global kernel); glm_grad's row layout at 60,000.
    # The dense steps scale as 1/d, as the main path's full-batch steps
    # scale as 1/N: at unit-normal features a fixed step grows the margins
    # with d
    for d, mb, n, reps in ((58_112, 1, 200, 2), (58_112, 10, 203, 2),
                           (65_536, 16, 150, 2), (100_000, 16, 150, 3)):
        X, y, w = _dense_inputs(rng, n * reps, d, dev)
        Xr, yr = X.reshape(reps, n, d), y.reshape(reps, n)
        W = w[None] * torch.linspace(-1.0, 1.0, reps, device=dev)[:, None]
        for task in ("lr", "svm"):
            record("glm_sgd", f"{task} d={d} mb={mb} R={reps} per={n} "
                   f"{sgd_ops.variant(d, mb)}",
                   K.glm_sgd_epoch(task, W, Xr, yr, step=1.0 / d,
                                   micro_batch=mb),
                   glm_sgd_epoch_ref(task, W, Xr, yr, 1.0 / d, mb), EPOCH_TOL)
    X, y, w = _dense_inputs(rng, 2003, 60_000, dev)
    for task in ("lr", "svm"):
        record("glm_grad", f"{task} n=2003 d=60000 "
               f"{grad_ops.variant(60_000, 'row')}",
               K.glm_grad(task, w, X, y), glm_grad_ref(task, w, X, y),
               GRAD_TOL)
    # news' width: the stream variant (also with each row's padding spread
    # through it: the kernel must not take it to sit at the end), and the
    # global variant past the stream's longest row
    d = NEWS["d"]
    for k, mb, n, reps, spread in ((NEWS["k"], 1, 120, 4, False),
                                   (NEWS["k"], 10, 203, 3, False),
                                   (NEWS["k"], 1, 120, 2, True),
                                   (sparse_ops.STREAM_MAX_K + 8, 1, 50, 2,
                                    False)):
        v, i, w = _wide_ell_inputs(n * reps, d, k, dev, seed=mb)
        if spread:
            cols = torch.randperm(k, device=dev,
                                  generator=torch.Generator(device=dev)
                                  .manual_seed(k))
            v, i = v[:, cols].contiguous(), i[:, cols].contiguous()
        y = torch.where(torch.arange(n * reps, device=dev) % 3 == 0, -1.0, 1.0)
        vr, ir, yr = (v.reshape(reps, n, k), i.reshape(reps, n, k),
                      y.reshape(reps, n))
        W = w[None] * torch.linspace(-1.0, 1.0, reps, device=dev)[:, None]
        for task in ("lr", "svm"):
            record("glm_sgd_sparse", f"{task} news width n={n} d={d} K={k} "
                   f"mb={mb} R={reps}{' padding spread' if spread else ''} "
                   f"{sparse_ops.variant(d, k, mb)}",
                   K.ell_sgd_epoch(task, W, vr, ir, yr, step=0.05,
                                   micro_batch=mb),
                   ell_sgd_epoch_ref(task, W, vr, ir, yr, 0.05, mb), EPOCH_TOL)
    # the redesigned reductions sum in a fixed order: the same bits on
    # every call (glm_grad at covtype's width, glm_sparse at w8a's, with a
    # replica axis, glm_sgd's cluster variant at real-sim's seq epoch)
    Xs, ysd, wsd = _dense_inputs(rng, 1024, 20_958, dev)
    cases.append({"kernel": "glm_sgd",
                  "case": "real-sim seq N=1024 d=20958 mb=1 "
                          f"{sgd_ops.variant(20_958, 1)}: five calls give "
                          "the same bits",
                  "ok": same_bits(lambda: K.glm_sgd_epoch(
                      "lr", wsd, Xs, ysd, step=1.0 / 20_958, micro_batch=1))})
    del Xs
    X, y, w = _dense_inputs(rng, 100_003, 54, dev)
    v, i, ys, ws = _ell_inputs(rng, 64_700, 300, 11.65, 69, dev, seed=9)
    vr, ir, yr = v.reshape(10, 6470, 69), i.reshape(10, 6470, 69), \
        ys.reshape(10, 6470)
    # glm_score at the serving flushes' shapes (w8a at max_batch 128 and
    # 32, real-sim at 128), both kernels
    for n, d, avg, k, label in ((128, 300, 11.65, 69, "w8a"),
                                (32, 300, 11.65, 69, "w8a"),
                                (128, 20_958, 51.30, 307, "real-sim")):
        vs, i_s, _, wsc = _ell_inputs(rng, n, d, avg, k, dev, seed=n + k)
        for kind in ("flat", "group"):
            with forced_variant(score_ops, kind):
                cases.append({
                    "kernel": "glm_score",
                    "case": f"{label} N={n} K={k} {kind}: five calls give "
                            "the same bits",
                    "ok": same_bits(lambda: K.glm_score("lr", wsc, vs,
                                                        i_s))})
    for name, label, fn in (
            ("glm_grad", "N=100003 d=54 ring",
             lambda: K.glm_grad("lr", w, X, y)),
            ("glm_sparse", "w8a R=1 smem",
             lambda: K.ell_glm_grad("lr", ws, v, i, ys)),
            ("glm_sparse", "w8a R=10 per=6470 smem",
             lambda: K.ell_glm_grad("lr", ws[None].repeat(10, 1), vr, ir,
                                    yr))):
        cases.append({"kernel": name,
                      "case": f"{label}: five calls give the same bits",
                      "ok": same_bits(fn)})
    # flash_attn: distinct kv heads throughout (each drawn on its own), so
    # a kernel that read kv head h % Hkv rather than h // rep would show
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref
    for n, (label, shape, dtype, causal, window) in enumerate(ATTN_CASES):
        q, k, v = _attn_inputs(shape, dtype, dev, seed=100 + n)
        tol = ATTN_TOL if dtype == torch.float32 else ATTN_BF16_TOL
        kind = attn_ops.variant(dtype, shape[3], shape[1] // shape[2])
        record("flash_attn", f"{label} {list(shape)} {dtype} causal={causal} "
               f"window={window} {kind}",
               K.flash_attention(q, k, v, causal=causal, window=window),
               attention_ref(q, k, v, causal=causal, window=window), tol)
    # rows that see no key: with Sq > Sk the first Sq - Sk queries sit
    # before key 0 (the l == 0 guard gives 0).  The public wrapper refuses
    # Sq > Sk, so the cuda flavor is called directly, in both variants
    for dtype, tol in ((torch.bfloat16, ATTN_BF16_TOL),
                       (torch.float32, ATTN_TOL)):
        q, k, v = _attn_inputs((1, 8, 2, 100, 40, 80), dtype, dev, seed=98)
        out = attn_ops._flash_attn_cuda(q, k, v, causal=True, window=None)
        kind = attn_ops.variant(dtype, 100, 4)
        record("flash_attn", f"rows that see no key, Sq=100 > Sk=40 {dtype} "
               f"{kind}", out, attention_ref(q, k, v, causal=True,
                                             window=None), tol)
        cases.append({"kernel": "flash_attn",
                      "case": f"the 60 rows before key 0 are 0 ({kind})",
                      "ok": bool((out[:, :, :60] == 0).all())})
    # decode's call: the first 77 rows of a 128-row cache, read in place;
    # and the decode kernel's merge of chunks, in chunk order, gives the
    # same bits on every call
    q, kc, vc = _attn_inputs((4, 32, 8, 1, 128, 80), torch.bfloat16, dev, 99)
    record("flash_attn", "decode over a cache prefix, 77 of 128 rows",
           K.flash_attention(q, kc[:, :, :77], vc[:, :, :77], causal=False),
           attention_ref(q, kc[:, :, :77], vc[:, :, :77], causal=False),
           ATTN_BF16_TOL)
    q, k, v = _attn_inputs((4, 32, 8, 1, 4096, 80), torch.bfloat16, dev, 97)
    cases.append({"kernel": "flash_attn",
                  "case": "decode Sk=4096: five calls give the same bits",
                  "ok": same_bits(lambda: K.flash_attention(q, k, v,
                                                            causal=False))})
    # an index outside [0, d) is refused before the kernel would read it
    v, i, y, w = _ell_inputs(rng, 64, 300, 11.65, 69, dev, seed=3)
    for name, call in (
            ("glm_sparse", lambda bad: K.ell_glm_grad("lr", w, v, bad, y)),
            ("glm_sgd_sparse", lambda bad: K.ell_sgd_epoch(
                "lr", w, v, bad, y, step=0.05, micro_batch=10)),
            ("glm_score", lambda bad: K.glm_score("lr", w, v, bad))):
        for j in (-1, 300):
            bad = i.clone()
            bad[5, 0] = j
            try:
                call(bad)
                refused = False
            except ValueError:
                refused = True
            cases.append({"kernel": name, "case": f"index {j} with d=300 refused",
                          "ok": refused})
    torch.cuda.synchronize()
    return {"phase": "kernels", "cases": cases,
            "ok": all(c["ok"] for c in cases)}, worst


def main_path(covtype, w8a, n: int | None = None):
    """The six strategies of the training path, as (label, problem, strategy,
    sparse_data).  ``n`` cuts both datasets to their first n rows."""
    from repro_torch.core import glm, sgd, sparse

    X, yd = covtype
    m, ys = w8a
    if n is not None:
        X, yd = X[:n], yd[:n]
        m, ys = sparse.ELLMatrix(m.values[:n], m.indices[:n], m.d), ys[:n]
    nd, ns = X.shape[0], m.shape[0]
    per = ns // 10
    # full-batch steps scale as 1/N: the update uses the sum gradient
    return [
        ("covtype", glm.GLMProblem("lr", X, yd, 1.0 / nd), sgd.SyncSGD(), False),
        ("covtype", glm.GLMProblem("lr", X, yd, 0.01), sgd.SyncSGD(batch=16), False),
        ("covtype", glm.GLMProblem("lr", X, yd, 1e-3),
         sgd.AsyncLocalSGD(replicas=8, local_batch=1), False),
        ("w8a", ("lr", m, ys, 2.0 / ns), sgd.SyncSGD(), True),
        ("w8a", ("lr", m, ys, 0.2), sgd.AsyncLocalSGD(replicas=10, local_batch=10),
         True),
        ("w8a", ("lr", m, ys, 2.0),
         sgd.AsyncLocalSGD(replicas=10, local_batch=per), True),
    ]


def falling(losses: np.ndarray) -> bool:
    """Finite, lower at the end than at the start, and no epoch rising by
    more than 0.1% over the one before."""
    return bool(np.isfinite(losses).all() and losses[-1] < losses[0]
                and (losses[1:] <= losses[:-1] * (1 + 1e-3)).all())


#: the kernels of the training path (the serving path adds glm_score)
TRAIN_KERNELS = ("glm_grad", "glm_sgd", "glm_sgd_sparse", "glm_sparse")


def phase_train(covtype, w8a, epochs: int) -> tuple[dict, dict, list]:
    """The main path at full size; returns the phase line, the launches and
    the runs' results."""
    from repro_torch.core import convergence, sgd
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops

    runs, results = [], []
    common.reset_launches()
    for data, problem, strat, sparse_data in main_path(covtype, w8a):
        res = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        results.append(res)
        runs.append({"data": data, "strategy": res.strategy,
                     "n": (problem[1].shape if sparse_data else problem.X.shape)[0],
                     "step": problem[3], "losses": res.losses.tolist(),
                     "ms_per_epoch": res.time_per_epoch * 1e3,
                     "epoch_ms": (res.epoch_times * 1e3).tolist(),
                     "falling": falling(res.losses)})
    launches = dict(common.LAUNCHES)
    # the one sparse epoch shape of the path (w8a, AsyncLocalSGD r10 b10)
    # runs glm_sgd_sparse's warp variant, its gradients (w8a at R = 1 and
    # 10) glm_sparse's smem variant, and covtype's gradient glm_grad's ring
    # variant, so each family's launches are that kernel's
    ell = w8a[0]
    k = ell.values.shape[1]
    variants = {
        "glm_sgd_sparse": sparse_ops.variant(ell.d, k, 10),
        "glm_sparse": {sparse_grad_ops.variant(ell.d, k, r) for r in (1, 10)},
        "glm_grad": grad_ops.variant(covtype[0].shape[1], "row")}
    ok = all(r["falling"] for r in runs) and all(
        launches[k] > 0 for k in TRAIN_KERNELS) and variants == {
            "glm_sgd_sparse": "warp", "glm_sparse": {"smem"},
            "glm_grad": "ring"}
    # the paper's statistical and end-to-end axes: epochs and time to 1% of
    # the lowest loss any strategy reached on the same dataset
    for data in {r["data"] for r in runs}:
        mine = [(r, res) for r, res in zip(runs, results) if r["data"] == data]
        target = convergence.thresholds(
            convergence.optimal_loss(res for _, res in mine))[0.01]
        for r, res in mine:
            r["epochs_to_1pct"] = res.epochs_to(target)
            t = res.time_to(target)
            r["time_to_1pct_ms"] = None if t is None else t * 1e3
    # where an epoch's time goes: device busy time by kernel, one more epoch
    # each (after the launch counts were read); where the trace recorded no
    # kernel of the path, the device time of the epoch from an event pair
    symbols = [n for k in TRAIN_KERNELS for v in KERNEL_SYMBOLS[k].values()
               for n in v]
    for run, (_, problem, strat, sparse_data) in zip(runs, main_path(covtype, w8a)):
        init, epoch_fn, _, _ = sgd.make_epoch_fn(problem, strat,
                                                  sparse_data=sparse_data)
        prof = device_profile(lambda: epoch_fn(init), 1)
        if any(n in key for key in prof for n in symbols):
            run["device_busy_ms"] = sum(ms for ms, _ in prof.values())
            run["device_busy_from"] = "profiler"
        else:
            run["device_busy_ms"] = event_device_ms(lambda: epoch_fn(init))
            run["device_busy_from"] = "events"
        run["device_idle_share"] = 1.0 - run["device_busy_ms"] / run["ms_per_epoch"]
        run["device_ms_by_kernel"] = {
            short_name(key): ms for key, (ms, _) in
            sorted(prof.items(), key=lambda kv: -kv[1][0])[:4]}
    return {"phase": "train", "epochs": epochs, "runs": runs,
            "launches": launches,
            "variants": {f: sorted(v) if isinstance(v, set) else v
                         for f, v in variants.items()},
            "ok": ok}, launches, results


def phase_parity(covtype, w8a, n: int, epochs: int) -> dict:
    """The same strategies at n rows: kernels vs plain versions on the card."""
    from repro_torch.core import sgd
    from repro_torch.kernels import common

    runs = []
    for data, problem, strat, sparse_data in main_path(covtype, w8a, n):
        kern = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        with common.plain_versions():
            plain = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        err, ok = close(torch.from_numpy(kern.losses),
                        torch.from_numpy(plain.losses), LOSS_TOL)
        runs.append({"data": data, "strategy": kern.strategy,
                     "kernel_losses": kern.losses.tolist(),
                     "plain_losses": plain.losses.tolist(),
                     "max_abs_err": err, "ok": ok and falling(kern.losses)})
    return {"phase": "parity", "n": n, "tol": LOSS_TOL, "runs": runs,
            "ok": all(r["ok"] for r in runs)}


#: Table 7's news runs (benchmarks/table7_async.py): AsyncLocalSGD at
#: local_batch 1 with 8 replicas (cpu-par) and 64 (gpu-norep)
NEWS_REPLICAS = (8, 64)
#: the step of the news runs, and the rows the plain versions rerun them on
NEWS_STEP = 0.01
NEWS_CUT = 1_600


def phase_news(news, epochs: int) -> tuple[dict, int]:
    """news at full size through ``sgd.run`` under Table 7's two async
    configurations (glm_sgd_sparse's stream variant: the model is 5.4 MB a
    replica), launch counts zeroed just before and read just after; then
    both runs on the first NEWS_CUT rows through the kernels and through
    the plain versions on the card, loss for loss.  Returns the phase line
    and glm_sgd_sparse's launches."""
    from repro_torch.core import sgd, sparse
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops

    m, y = news
    n, k = m.values.shape

    def strategy(replicas):
        return sgd.AsyncLocalSGD(replicas=replicas, local_batch=1)

    runs = []
    common.reset_launches()
    for replicas in NEWS_REPLICAS:
        t0 = time.perf_counter()
        res = sgd.run(("lr", m, y, NEWS_STEP), strategy(replicas), epochs,
                      sparse_data=True)
        updates = n // replicas  # each replica's chain of updates an epoch
        runs.append({"strategy": res.strategy, "replicas": replicas,
                     "updates_per_epoch": updates,
                     "ms_per_epoch": res.time_per_epoch * 1e3,
                     "epoch_ms": (res.epoch_times * 1e3).tolist(),
                     "us_per_update": res.time_per_epoch * 1e6 / updates,
                     "losses": res.losses.tolist(),
                     "falling": falling(res.losses),
                     "wall_s": time.perf_counter() - t0})
    launches = dict(common.LAUNCHES)
    variant = sparse_ops.variant(m.d, k, 1)
    cut = (sparse.ELLMatrix(m.values[:NEWS_CUT], m.indices[:NEWS_CUT], m.d),
           y[:NEWS_CUT])
    parity = []
    for replicas in NEWS_REPLICAS:
        problem = ("lr", *cut, NEWS_STEP)
        kern = sgd.run(problem, strategy(replicas), epochs, sparse_data=True)
        with common.plain_versions():
            plain = sgd.run(problem, strategy(replicas), epochs,
                            sparse_data=True)
        err, ok = close(torch.from_numpy(kern.losses),
                        torch.from_numpy(plain.losses), LOSS_TOL)
        parity.append({"strategy": kern.strategy, "rows": NEWS_CUT,
                       "kernel_losses": kern.losses.tolist(),
                       "plain_losses": plain.losses.tolist(),
                       "max_abs_err": err, "ok": ok})
    ok = (all(r["falling"] for r in runs) and all(p["ok"] for p in parity)
          and variant == "stream"
          and launches["glm_sgd_sparse"] == len(NEWS_REPLICAS) * epochs)
    return {"phase": "news", "shape": [n, m.d, k],
            "ell_mb": nbytes(m.values, m.indices) / 1e6, "epochs": epochs,
            "step": NEWS_STEP, "runs": runs, "launches": launches,
            "glm_sgd_sparse_variant": variant, "parity_cut": NEWS_CUT,
            "parity": parity, "ok": ok}, launches["glm_sgd_sparse"]


# ---------------------------------------------------------------------------
# The paper's study layer: step-size search, trials, the Table 4/7 drivers
# ---------------------------------------------------------------------------

#: the drivers (a) runs on the ci profile: table7_async, table4_sync, fig22
STUDY_DRIVERS = ("table7_async", "table4_sync", "fig22_sync_vs_async")
#: (b): the ci profile's datasets at their full Table 3 size, LR, the ci
#: grid and epochs
STUDY_DATASETS = ("covtype", "w8a", "real-sim")
STUDY_STEPS = (1e-3, 1e-2, 1e-1)
STUDY_EPOCHS = 12


def _study_drivers(dev, plain: bool) -> tuple[dict, dict, float]:
    """The ci profile's drivers on a fresh runner (no trial cache) with a
    store that records every trial; returns the rows by driver, the
    store's trials and the wall seconds."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.kernels import common
    from repro_torch.study.runner import Runner
    from repro_torch.study.store import StudyStore

    store = StudyStore()            # never written: held in memory
    bcommon.RUNNER = Runner(cache_dir=None, store=store, device=dev)
    t0 = time.perf_counter()
    with common.plain_versions() if plain else contextlib.nullcontext():
        rows = {name: importlib.import_module(
            f"repro_torch.benchmarks.{name}").run("ci")
            for name in STUDY_DRIVERS}
    torch.cuda.synchronize()
    return rows, store.trials, time.perf_counter() - t0


def _fell(losses) -> bool:
    """Finite, and lower at the end than at the start."""
    losses = np.asarray(losses)
    return bool(np.isfinite(losses).all() and losses[-1] < losses[0])


def _study_variants(ds) -> dict[str, str]:
    """The variant each family runs on ``ds``'s shapes in (b): the trials'
    replica epochs (micro-batch 1) and full gradients, and Table 4's seq
    epoch on the densified operand (d columns)."""
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops

    out = {"glm_sgd_seq": sgd_ops.variant(ds.d, 1)}
    if ds.dense:
        out.update(glm_sgd=sgd_ops.variant(ds.d, 1),
                   glm_grad=grad_ops.variant(ds.d, "row"))
    else:
        k = ds.ell.max_nnz
        out.update(glm_sgd_sparse=sparse_ops.variant(ds.d, k, 1),
                   glm_sparse=sparse_grad_ops.variant(ds.d, k, 1))
    return out


#: kernel-line name of each (family, variant) phase study runs
STUDY_LINE = {("glm_grad", "ring"): "glm_grad_ring",
              ("glm_sgd", "warp"): "glm_sgd",
              ("glm_sgd", "cluster"): "glm_sgd_cluster",
              ("glm_sgd_sparse", "warp"): "glm_sgd_sparse_warp",
              ("glm_sparse", "smem"): "glm_sparse_smem"}


def phase_study(dev) -> tuple[dict, dict]:
    """The paper's study layer on the card.  (a) The port's Table 7, Table 4
    and Fig. 22 drivers on the ci profile through the kernels, then again
    through the plain versions: every trial's losses within LOSS_TOL, and
    the same best step and epochs to 1% on every row; the claim checks on
    both.  (b) covtype, w8a and real-sim at their full Table 3 sizes
    through ``tuner.tune_many``: Table 7's four configurations and
    ``SyncSGD()`` (LR, the ci grid, 12 epochs), each row with its
    launches by family; Table 4's execution paths on each dataset.
    Launch counts are zeroed just before (b) and read just after.  Returns
    the phase line and (b)'s launches by kernel-line name."""
    from repro_torch.benchmarks import table4_sync, table7_async
    from repro_torch.core import convergence, glm, sgd
    from repro_torch.kernels import common
    from repro_torch.study import claims, tuner
    from repro_torch.study.runner import Runner
    from repro_torch.study.spec import DatasetSpec, TrialSpec

    # (a) the reference's configuration, held against the plain versions
    common.reset_launches()
    kern_rows, kern_trials, kern_s = _study_drivers(dev, plain=False)
    ci_launches = {k: common.LAUNCHES[k] for k in TRAIN_KERNELS}
    plain_rows, plain_trials, plain_s = _study_drivers(dev, plain=True)
    worst, held = 0.0, True
    for key, rec in kern_trials.items():
        err, ok = close(torch.tensor(rec["losses"]),
                        torch.tensor(plain_trials[key]["losses"]), LOSS_TOL)
        worst, held = max(worst, err), held and ok
    mismatched = [
        {"driver": name, **{k: r[k] for k in ("dataset", "task")},
         "config": r.get("config"), "kernels": [r[k] for k in (
             "best_step", "iters_to_1pct")], "plain": [p[k] for k in (
             "best_step", "iters_to_1pct")]}
        for name in ("table7_async", "table4_sync")
        for r, p in zip(kern_rows[name], plain_rows[name])
        if (r["best_step"], r["iters_to_1pct"])
        != (p["best_step"], p["iters_to_1pct"])]
    verdicts = {"kernels": claims.validate(kern_rows),
                "plain": claims.validate(plain_rows)}
    ci = {"profile": "ci", "drivers": list(STUDY_DRIVERS),
          "trials": len(kern_trials),
          "same_trials": sorted(kern_trials) == sorted(plain_trials),
          "tol": LOSS_TOL, "max_abs_err": worst, "losses_held": held,
          "rows_mismatched": mismatched, "claims": verdicts,
          "launches": ci_launches, "kernels_s": kern_s, "plain_s": plain_s,
          "rows": kern_rows}
    ci["ok"] = bool(held and ci["same_trials"] and not mismatched
                    and not verdicts["kernels"] and not verdicts["plain"]
                    and all(ci_launches[k] > 0 for k in TRAIN_KERNELS))

    # (b) the paper's sizes
    runner = Runner(cache_dir=None, device=dev)
    data = {}
    for name in STUDY_DATASETS:
        t0 = time.perf_counter()
        ds = runner.dataset(DatasetSpec(name))
        torch.cuda.synchronize()
        data[name] = {"n": ds.n, "d": ds.d,
                      "k": None if ds.dense else ds.ell.max_nnz,
                      "seconds": time.perf_counter() - t0}
    configs = {**table7_async.CONFIGS, "sync": sgd.SyncSGD()}
    rows, table4, study_launches = [], [], {}
    common.reset_launches()
    t_start = time.perf_counter()
    for name in STUDY_DATASETS:
        dspec = DatasetSpec(name)
        ds = runner.dataset(dspec)
        variants = _study_variants(ds)
        tuned = {}
        for label, strat in configs.items():
            before = dict(common.LAUNCHES)
            t0 = time.perf_counter()
            tuned[label] = (tuner.tune_many(
                runner, [TrialSpec(dspec, "lr", strat, STUDY_STEPS[0],
                                   STUDY_EPOCHS)], steps=STUDY_STEPS)[0],
                {k: common.LAUNCHES[k] - before[k] for k in TRAIN_KERNELS},
                time.perf_counter() - t0)
        # Table 7's common target: within 1% of the best loss seen anywhere
        target = convergence.thresholds(convergence.optimal_loss(
            r for t, _, _ in tuned.values() for r in t.results.values()),
            (0.01,))[0.01]
        for label, (t, launches, wall) in tuned.items():
            res = t.best_result
            rows.append({
                "dataset": name, "task": "lr", "config": label,
                "strategy": res.strategy, "t_iter_ms": res.time_per_epoch * 1e3,
                "iters_to_1pct": res.epochs_to(target),
                "time_to_1pct_s": res.time_to(target),
                "best_step": t.best_step, "final_loss": res.final_loss,
                "losses": res.losses.tolist(), "fell": _fell(res.losses),
                "finite": all(bool(np.isfinite(r.losses).all())
                              for r in t.results.values()),
                "launches": launches, "wall_s": wall})
            for fam, count in launches.items():
                if count:
                    line = STUDY_LINE[(fam, variants[fam])]
                    study_launches[line] = study_launches.get(line, 0) + count
        # Table 4's execution paths at this size (seq: the glm_sgd kernel
        # at micro-batch 1 on one replica)
        before = common.LAUNCHES["glm_sgd"]
        t = table4_sync._sync_paths(ds, "lr", 1e-3)
        seq = common.LAUNCHES["glm_sgd"] - before
        # whether the composition path's 3 steps stayed finite: its
        # exp(-margin) / (1 + exp(-margin)) is inf / inf once a margin
        # passes -88, which the driver's step reaches at full size
        X, y = table4_sync.dense_operands(ds)
        wc = torch.zeros(X.shape[1], device=X.device)
        for _ in range(3):
            wc = wc - 1e-3 * glm.grad_primitive_composition("lr", wc, X, y)
        del X, y
        line = STUDY_LINE[("glm_sgd", variants["glm_sgd_seq"])]
        study_launches[line] = study_launches.get(line, 0) + seq
        table4.append({
            "dataset": name, "task": "lr", "n": ds.n,
            "rows_timed": (ds.n if ds.dense
                           or ds.n * ds.d <= table4_sync.DENSE_CAP
                           else table4_sync.DENSE_CAP_ROWS),
            "t_iter_sync_ms": t["sync"] * 1e3,
            "t_iter_comp_ms": t["sync-comp"] * 1e3,
            "t_iter_seq_ms": t["seq"] * 1e3,
            "speedup_fused_vs_comp": t["sync-comp"] / t["sync"],
            "speedup_sync_vs_seq": t["seq"] / t["sync"],
            "paths_statistically_identical": t["_path_equiv"],
            "composition_finite": bool(torch.isfinite(wc).all()),
            "seq_variant": variants["glm_sgd_seq"], "seq_launches": seq})
    launches = dict(common.LAUNCHES)
    full = {"datasets": data, "steps": list(STUDY_STEPS),
            "epochs": STUDY_EPOCHS, "rows": rows, "table4": table4,
            "claims": claims.validate({"table4_sync": table4}),
            "launches": launches, "study_launches": study_launches,
            "seconds": time.perf_counter() - t_start}
    # every family of the path launched; every run finite; Table 7's
    # configurations fell (SyncSGD()'s full-batch step multiplies the sum
    # gradient, so at these sizes the ci grid's steps may all overshoot);
    # Table 4's claim: batch faster than sequential, and the two sync paths
    # identical wherever the composition stayed finite
    full["ok"] = bool(
        all(launches[k] > 0 for k in TRAIN_KERNELS)
        and set(study_launches) == set(STUDY_LINE.values())
        and all(r["finite"] for r in rows)
        and all(r["fell"] for r in rows if r["config"] != "sync")
        and all(r["speedup_sync_vs_seq"] >= 1.0 and (
            r["paths_statistically_identical"] or not r["composition_finite"])
            for r in table4))
    return {"phase": "study", "ci": ci, "full": full,
            "ok": ci["ok"] and full["ok"]}, study_launches


# ---------------------------------------------------------------------------
# The serving path and train-while-serving
# ---------------------------------------------------------------------------


def _requests(values: torch.Tensor, indices: torch.Tensor) -> list:
    """One ``ScoreRequest`` per ELL row, carrying only its nonzeros (the
    padding sits at the end of each row); the engine pads them back."""
    from repro_torch.serve.glm import ScoreRequest

    vals, idx = values.cpu().numpy(), indices.cpu().numpy()
    nnz = (vals != 0).sum(axis=1)
    return [ScoreRequest(r, vals[r, :nnz[r]], idx[r, :nnz[r]])
            for r in range(len(vals))]


def _drive(engine, reqs, swap=None) -> tuple[list, int, float]:
    """Admit until the bounded FIFO is full, flush, repeat, as
    benchmarks/bench_serve.py drives an engine; ``swap = (i, w)`` publishes
    ``w`` right after request i is admitted.  Returns the responses, the
    flushes that scored something, and the wall seconds."""
    responses, flushes, nxt = [], 0, 0
    t0 = time.perf_counter()
    while nxt < len(reqs) or len(engine):
        while nxt < len(reqs) and engine.try_admit(reqs[nxt]):
            nxt += 1
            if swap is not None and nxt == swap[0]:
                engine.swap_model(swap[1])
        batch = engine.flush()
        flushes += bool(batch)
        responses.extend(batch)
    return responses, flushes, time.perf_counter() - t0


def _quantiles(latencies) -> dict:
    lat = np.sort(np.asarray(latencies))
    return {"p50_ms": float(np.median(lat)) * 1e3,
            "p99_ms": float(lat[min(len(lat) - 1, int(0.99 * len(lat)))]) * 1e3}


def _busy_stretch(fn) -> dict:
    """Device busy ms and idle share over one profiled call of ``fn``: the
    device time of every kernel and copy the profiler saw, over the host
    wall time of the stretch (the profiler's own host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return {"stretch_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms}


def _check_scores(responses, values, indices, snapshots, task) -> dict:
    """Every response against the plain version over the same row under the
    weights of the snapshot version it carries (``snapshots``: version ->
    weights on the card)."""
    from repro_torch.kernels.glm_score.ref import glm_score_ref

    rid = torch.tensor([r.rid for r in responses], device=values.device)
    ver = np.array([r.model_version for r in responses])
    got = torch.tensor([r.score for r in responses], device=values.device)
    err, ok = 0.0, bool(np.isin(ver, list(snapshots)).all())
    for v in np.unique(ver):
        sel = torch.from_numpy(np.nonzero(ver == v)[0]).to(values.device)
        rows = rid[sel]
        e, o = close(got[sel], glm_score_ref(task, snapshots[int(v)],
                                             values[rows], indices[rows]),
                     GRAD_TOL)
        err, ok = max(err, e), ok and o
    return {"max_abs_err": err, "ok": ok,
            "versions": sorted(int(v) for v in np.unique(ver)),
            "versions_in_order": bool((np.diff(ver) >= 0).all())}


def phase_serve(dev, w8, realsim, w_sync, w_swap) -> tuple[dict, int]:
    """The scoring engine at full width; returns the phase line and the
    glm_score launches of its runs."""
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_score import ops as score_ops
    from repro_torch.serve.glm import GLMScoreEngine

    rng = np.random.default_rng(2)
    w_rs = torch.from_numpy(rng.normal(0, 0.1, realsim.d)
                            .astype(np.float32)).to(dev)
    cells = [("w8a", w8, 128, w_sync, w_swap), ("w8a", w8, 32, w_sync, None),
             ("real-sim", realsim, 128, w_rs, None)]
    runs, total = [], 0
    common.reset_launches()
    for data, ds, mb, w, w2 in cells:
        values, indices = ds.ell.values, ds.ell.indices
        reqs = _requests(values, indices)
        engine = GLMScoreEngine("lr", w, ell_width=ds.ell.max_nnz,
                                max_batch=mb, queue_depth=2 * mb,
                                flush_deadline_s=0.0)
        before = common.LAUNCHES["glm_score"]
        swap = None if w2 is None else (len(reqs) // 2, w2)
        responses, flushes, wall = _drive(engine, reqs, swap)
        launches = common.LAUNCHES["glm_score"] - before
        snapshots = {0: w} if w2 is None else {0: w, 1: w2}
        check = _check_scores(responses, values, indices, snapshots, "lr")
        # admission's host work on a row (its checks and copies), and the
        # index check alone, over this run's requests
        t0 = time.perf_counter()
        for r in reqs:
            engine._admit_row(r)
        admit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for r in reqs:
            common.check_host_indices(f"request {r.rid}",
                                      np.asarray(r.indices), ds.d)
        check_s = time.perf_counter() - t0
        run = {"data": data, "n": len(reqs), "d": ds.d, "K": ds.ell.max_nnz,
               "max_batch": mb, "device": str(engine.device),
               "variant": score_ops.variant(mb, ds.ell.max_nnz, ds.d),
               "requests_per_s": len(reqs) / wall, "wall_s": wall,
               **_quantiles([r.latency_s for r in responses]),
               "flushes": flushes, "glm_score_launches": launches,
               "swap_at": None if swap is None else swap[0],
               "admit_row_us_per_request": admit_s / len(reqs) * 1e6,
               "index_check_us_per_request": check_s / len(reqs) * 1e6,
               "index_check_us_per_batch": check_s / flushes * 1e6,
               "check": check}
        # one profiled stretch: the first 64 batches again, on a fresh engine
        stretch = GLMScoreEngine("lr", w, ell_width=ds.ell.max_nnz,
                                 max_batch=mb, queue_depth=2 * mb,
                                 flush_deadline_s=0.0)
        run["profiled"] = {"requests": 64 * mb, **_busy_stretch(
            lambda: _drive(stretch, reqs[:64 * mb]))}
        run["ok"] = bool(
            engine.device.type == "cuda" and launches == flushes
            and len(responses) == len(reqs) and check["ok"]
            and sorted(r.rid for r in responses) == list(range(len(reqs)))
            and check["versions"] == sorted(snapshots)
            and check["versions_in_order"])
        runs.append(run)
        total += launches
    return {"phase": "serve", "tol": GRAD_TOL, "runs": runs,
            "ok": all(r["ok"] for r in runs)}, total


#: the live stream at real-sim's width (Table 3), and its learner
LIVE_STREAM = dict(n_batch=256, d=20_958, avg_nnz=51.3, max_nnz=307)
LIVE_CONFIG = dict(task="lr", replicas=8, merge_every=4, local_batch=1,
                   step_size=0.1)


def _record_merges(learner) -> list[dict]:
    """Wrap ``learner.merge`` to keep, at every merge that ran, what went
    into it (the replicas, the anchor, the error feedback, the alive mask)
    and the anchor it made."""
    records, merge = [], learner.merge

    def recorded():
        ef = learner._ef
        before = {"W": learner.W.clone(), "anchor": learner.anchor.clone(),
                  "ef": None if ef is None else ef.clone(),
                  "alive": learner.alive()}
        out = merge()
        if out is not None:
            records.append({**before, "out": out.clone()})
        return out

    learner.merge = recorded
    return records


def _live_run(cfg: dict, stream_kw: dict, steps: int, faults: dict,
              serve: bool) -> dict:
    """One learner run on the card; with ``serve``, a SnapshotPublisher
    feeds a GLMScoreEngine that a second thread serves throughout."""
    import threading

    from repro_torch.kernels import common
    from repro_torch.live import (LiveConfig, LiveLearner, SnapshotPublisher,
                                  SyntheticStream)
    from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest

    stream = SyntheticStream(seed=7, **stream_kw)
    learner = LiveLearner(LiveConfig(**cfg), stream)
    out = {"device": str(learner.device)}
    if not stream.dense:
        hold, hy = stream.holdout(1024)
        out["holdout_loss_start"] = learner.loss(hold, hy)
    engine = None
    if serve:
        engine = GLMScoreEngine(cfg["task"], learner.merged_model,
                                ell_width=stream.ell_width, max_batch=128,
                                queue_depth=256, flush_deadline_s=0.0)
        pub = SnapshotPublisher(engine).attach(learner)
        bound = pub.bound_steps(learner.config.merge_every)
        snapshots = {0: engine.model.w}
        learner.add_merge_hook(
            lambda _: snapshots.setdefault(engine.model.version,
                                           engine.model.w))
        reqs = _requests(hold.values, hold.indices)
        served, flushes, stop = [], [0], threading.Event()

        def server():
            rid = 0
            while not stop.is_set() or len(engine):
                while not stop.is_set():
                    row = reqs[rid % len(reqs)]
                    if not engine.try_admit(
                            ScoreRequest(rid, row.values, row.indices)):
                        break
                    rid += 1
                batch = engine.flush()
                flushes[0] += bool(batch)
                served.extend(batch)

        thread = threading.Thread(target=server)
    common.reset_launches()
    staleness = []
    t0 = time.perf_counter()
    if serve:
        thread.start()
    try:
        for i in range(steps):
            for r in faults.get(i, {}).get("kill", ()):
                learner.kill(r)
            for r in faults.get(i, {}).get("revive", ()):
                learner.revive(r)
            learner.step()
            if serve:
                staleness.append(pub.staleness(learner))
    finally:
        if serve:
            stop.set()
            thread.join(timeout=120)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = dict(common.LAUNCHES)
    out["steps"], out["merges"] = learner.steps, learner.merges
    if not stream.dense:
        out["holdout_loss_end"] = learner.loss(hold, hy)
    if serve:
        lag = [s for s in staleness if s is not None]
        rows = torch.tensor([r.rid % len(reqs) for r in served],
                            device=hold.values.device)
        remapped = [dataclasses.replace(r, rid=i) for i, r in enumerate(served)]
        out["serve"] = {
            "thread_done": not thread.is_alive(), "responses": len(served),
            "flushes": flushes[0], "publishes": pub.publishes,
            "staleness_max": max(lag) if lag else None, "bound_steps": bound,
            **_quantiles([r.latency_s for r in served]),
            "check": _check_scores(remapped, hold.values[rows],
                                   hold.indices[rows], snapshots, cfg["task"])}
    return out


def _twin(cfg: dict, stream_kw: dict, steps: int, faults: dict,
          resync: bool) -> dict:
    """The learner through the kernels and the same learner through the
    plain versions, step by step on the same stream, every merge recorded
    in both.  With ``resync`` the plain learner takes the kernel learner's
    state after each merge, so that every merge compares the work of one
    interval from the same start."""
    from repro_torch.kernels import common
    from repro_torch.live import LiveConfig, LiveLearner, SyntheticStream

    kern, plain = (LiveLearner(LiveConfig(**cfg),
                               SyntheticStream(seed=7, **stream_kw))
                   for _ in range(2))
    records = [_record_merges(kern), _record_merges(plain)]
    common.reset_launches()
    for i in range(steps):
        for learner in (kern, plain):
            for r in faults.get(i, {}).get("kill", ()):
                learner.kill(r)
            for r in faults.get(i, {}).get("revive", ()):
                learner.revive(r)
        merges = kern.merges
        kern.step()
        with common.plain_versions():
            plain.step()
        if resync and kern.merges > merges:
            plain.W, plain.anchor = kern.W.clone(), kern.anchor.clone()
            if kern._ef is not None:
                plain._ef = kern._ef.clone()
    torch.cuda.synchronize()
    return {"launches": dict(common.LAUNCHES),
            "held": {"resync": resync, **_held(*records, resync)}}


def _codes(a: dict, b: dict) -> dict:
    """The int8 codes both runs' merge made from its inputs, replica by
    alive replica (as ``optim.compress.quantize_leaf`` makes them), and
    where they differ: ``x`` is a delta in units of its block's step, and
    a code differs only where the two runs' ``x`` lie on either side of a
    half step (``dist``: the plain run's distance to it) and no further
    apart than the replicas' EPOCH_TOL and the difference of the anchors
    and error feedbacks let them (``xtol``).  ``slack`` is what the
    differing codes and scales can move the merged anchor by."""
    from repro_torch.optim import compress as C

    d = a["W"].shape[1]
    alive = np.nonzero(b["alive"])[0]
    out = {"compared": 0, "flips": 0, "max_code_diff": 0, "max_dist": 0.0,
           "max_x_diff": 0.0, "explained": True,
           "slack": torch.zeros_like(b["out"])}
    for r in alive:
        qx = []
        for run in (a, b):
            delta = run["W"][r] - run["anchor"] + run["ef"][r]
            q, s = C.quantize_leaf(delta)
            step = s.expand(-1, C.BLOCK).reshape(-1)[:d]
            qx.append((q.reshape(-1)[:d].int(), step, delta / step))
        (qa, sa, xa), (qb, sb, xb) = qx
        diff = (qa - qb).abs()
        flip = diff > 0
        dist = (xb - torch.floor(xb) - 0.5).abs()
        xdiff = (xa - xb).abs()
        dtol = (EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * b["W"][r].abs()
                + (a["anchor"] - b["anchor"]).abs()
                + (a["ef"][r] - b["ef"][r]).abs())
        xtol = dtol / sa + xb.abs() * (sa - sb).abs() / sa
        out["compared"] += d
        out["flips"] += int(flip.sum())
        out["max_code_diff"] = max(out["max_code_diff"], int(diff.max()))
        if flip.any():
            out["max_dist"] = max(out["max_dist"], float(dist[flip].max()))
            out["max_x_diff"] = max(out["max_x_diff"], float(xdiff[flip].max()))
            out["explained"] = out["explained"] and bool(
                ((dist <= xdiff) & (xdiff <= xtol))[flip].all())
        out["slack"] = out["slack"] + (
            diff * sa + 127 * (sa - sb).abs()) / len(alive)
    return out


def _held(kernel: list, plain: list, resync: bool) -> dict:
    """The kernel run against the plain run, merge by merge.  The inputs of
    the merge (the replicas) agree within EPOCH_TOL.  An exact merge's
    anchor agrees within EPOCH_TOL too.  An int8 merge's codes differ by at
    most one, only where the two runs' deltas straddle a half step within
    round-off (``_codes``), and its anchor within EPOCH_TOL plus what those
    codes and scales move it by.  Without ``resync`` two int8 runs part at
    the first merge whose codes differ: that merge is the last one held,
    and the errors after it are reported only."""
    out = {"merges": len(kernel), "checked_merges": 0,
           "inputs_max_abs_err": 0.0, "anchor_max_abs_err": 0.0,
           "first_differing_merge": None}
    ok = len(kernel) == len(plain) > 0
    codes = []
    for m, (a, b) in enumerate(zip(kernel, plain)):
        err, inputs_ok = close(a["W"], b["W"], EPOCH_TOL)
        out["inputs_max_abs_err"] = max(out["inputs_max_abs_err"], err)
        err, anchor_ok = close(a["out"], b["out"], EPOCH_TOL)
        out["anchor_max_abs_err"] = max(out["anchor_max_abs_err"], err)
        if out["first_differing_merge"] is not None and not resync:
            continue
        out["checked_merges"] += 1
        ok = ok and inputs_ok and bool((a["alive"] == b["alive"]).all())
        if b["ef"] is None:
            ok = ok and anchor_ok
            continue
        c = _codes(a, b)
        bound = (EPOCH_TOL["atol"] + EPOCH_TOL["rtol"] * b["out"].abs()
                 + c.pop("slack"))
        ok = ok and c["max_code_diff"] <= 1 and c["explained"] and bool(
            ((a["out"] - b["out"]).abs() <= bound).all())
        codes.append(c)
        if c["flips"] and out["first_differing_merge"] is None:
            out["first_differing_merge"] = m
    if codes:
        out["int8_codes"] = {
            "compared": sum(c["compared"] for c in codes),
            "differing": sum(c["flips"] for c in codes),
            "differing_by_merge": [c["flips"] for c in codes],
            "max_code_diff": max(c["max_code_diff"] for c in codes),
            "differing_max_dist_to_half_step": max(c["max_dist"] for c in codes),
            "differing_max_x_diff": max(c["max_x_diff"] for c in codes),
            "all_explained": all(c["explained"] for c in codes)}
    out["ok"] = bool(ok)
    return out


def phase_live(dev) -> dict:
    """Train-while-serving on the card; each configuration also run step
    by step through the kernels and through the plain versions."""
    faults = {16: {"kill": (1, 3)}, 40: {"revive": (1, 3)}}
    runs = []
    for compress in (False, True):
        cfg = dict(LIVE_CONFIG, compress=compress)
        kern = _live_run(cfg, LIVE_STREAM, 64, faults, serve=True)
        # the same learner with no serving thread beside it
        alone = _live_run(cfg, LIVE_STREAM, 64, faults, serve=False)
        # free-running: an int8 code rounded the other way at one merge
        # carries into every later one, so an int8 pair is held up to that
        # merge, and once more with the plain learner resynced after each
        # merge, which holds every merge to one interval's work
        twins = [_twin(cfg, LIVE_STREAM, 64, faults, resync=r)
                 for r in ((False, True) if compress else (False,))]
        srv = kern["serve"]
        run = {"path": "glm_sgd_sparse", "compress": compress, "steps": 64,
               "kill_at": 16, "revive_at": 40, "device": kern["device"],
               "wall_s": kern["wall_s"], "wall_s_without_serving":
               alone["wall_s"], "merges": kern["merges"],
               "holdout_loss": [kern["holdout_loss_start"],
                                kern["holdout_loss_end"]],
               "launches": kern["launches"], "serve": srv,
               "vs_plain": [t["held"] for t in twins]}
        run["ok"] = bool(
            kern["device"].startswith("cuda")
            and kern["holdout_loss_end"] < kern["holdout_loss_start"]
            and all(h["ok"] for h in run["vs_plain"]) and srv["check"]["ok"]
            and srv["check"]["versions_in_order"] and srv["thread_done"]
            and srv["staleness_max"] is not None
            and srv["staleness_max"] <= srv["bound_steps"]
            and kern["launches"]["glm_sgd_sparse"] == 64
            and all(t["launches"]["glm_sgd_sparse"] == 64 for t in twins)
            and kern["launches"]["glm_score"] == srv["flushes"] > 0)
        runs.append(run)
    # the two other replica passes, short: the full-partition sum gradient
    # (local_batch == per) and a dense stream at covtype's width
    for path, cfg, stream_kw in (
            ("glm_sparse", dict(LIVE_CONFIG, local_batch=32), LIVE_STREAM),
            ("glm_sgd", LIVE_CONFIG, dict(n_batch=256, d=54, dense=True))):
        twin = _twin(cfg, stream_kw, 8, {}, resync=False)
        run = {"path": path, "compress": False, "steps": 8,
               "local_batch": cfg["local_batch"], "d": stream_kw["d"],
               "launches": twin["launches"], "vs_plain": [twin["held"]]}
        run["ok"] = bool(twin["held"]["ok"]
                         and twin["launches"][path] == 8)
        runs.append(run)
    return {"phase": "live", "stream": LIVE_STREAM, "config": LIVE_CONFIG,
            "tol": EPOCH_TOL, "runs": runs, "ok": all(r["ok"] for r in runs)}


# ---------------------------------------------------------------------------
# The LM serving path
# ---------------------------------------------------------------------------

#: the serving run of phase ``lm``, as ``repro_torch.launch.serve`` takes it
LM_ARGV = ["--arch", "h2o-danube-1.8b", "--requests", "8", "--slots", "4",
           "--max-new", "16", "--max-len", "128", "--seed", "0"]
#: the prefill forward of phase ``lm``: twice danube's window
LM_PREFILL = 8192


#: how much further from the fp32 model the kernel path may stand than the
#: plain bf16 path does (``_held_bf16``)
BF16_MODEL_SLACK = 1.5


def _held_bf16(out: torch.Tensor, plain: torch.Tensor,
               fp32: torch.Tensor) -> dict:
    """A bf16 model output through the kernels against the same output
    through the plain versions, with the same weights run in fp32 as the
    yardstick.  The kernel and plain paths differ by where their fp32
    sums round to bf16 inside attention, and the layers after carry that
    on, so the two bf16 paths drift apart as far as each drifts from the
    fp32 model (measured on the card: max |kernel - plain| 0.77-1.0x max
    |plain - fp32| for danube's logits, caches and hidden states); no fixed
    tolerance fits every depth and step.  So the limit is the working
    type's own error: the kernel path must stand no further from the fp32
    model than BF16_MODEL_SLACK times the plain bf16 path does (the max of
    two independent roundings varies by tens of percent: measured 0.77-1.04
    in one run).  A wrong mask or head shows as errors of the logits'
    own size (about 5)."""
    err = float((out.float() - plain.float()).abs().max())
    floor = float((plain.float() - fp32.float()).abs().max())
    mine = float((out.float() - fp32.float()).abs().max())
    return {"max_abs_err": err, "bf16_vs_fp32_max_abs_err": floor,
            "kernel_vs_fp32_max_abs_err": mine, "slack": BF16_MODEL_SLACK,
            "ok": bool(mine <= BF16_MODEL_SLACK * floor
                       and torch.isfinite(out).all())}


def _lm_profile(fn, ticks: int) -> dict:
    """Where a decode tick's time goes, from one profiled call of ``fn``
    (``ticks`` ticks): host ops by self CPU time, aten calls (nested ones
    included), kernel launches, and device kernels by device time (kernel
    events only: an op's device time repeats its kernels'), each per
    tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    host = sorted((e for e in ev if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    dev = sorted((e for e in ev if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    return {
        "host_ms_per_tick": sum(e.self_cpu_time_total for e in host)
        / 1e3 / ticks,
        "aten_calls_per_tick": sum(e.count for e in ev
                                 if e.key.startswith("aten::")) / ticks,
        "launches_per_tick": sum(e.count for e in ev
                                 if "LaunchKernel" in e.key) / ticks,
        "host_top": [[e.key, e.self_cpu_time_total / 1e3 / ticks,
                      e.count / ticks] for e in host[:12]],
        "device_ms_per_tick": sum(e.self_device_time_total for e in dev)
        / 1e3 / ticks,
        "device_top": [[short_name(e.key), e.self_device_time_total / 1e3
                        / ticks, e.count / ticks] for e in dev[:8]]}


def _record_steps(engine) -> list:
    """Wrap ``engine._step`` to keep every decode step's tokens, index and
    logits (the logits tensor each step returns anyway; nothing copied)."""
    steps, step = [], engine._step

    def recorded(tokens, idx):
        logits = step(tokens, idx)
        steps.append((tokens.copy(), idx, logits))
        return logits

    engine._step = recorded
    return steps


def phase_lm(dev) -> tuple[dict, int, int]:
    """Full-width h2o-danube-1.8b: the serving run as the launcher runs it,
    its logits against the plain versions step by step, a profiled stretch
    of ticks, and one prefill forward against the plain versions.  Returns
    the phase line, the serving run's flash_attn launches (decode: the
    ``decode`` kernel) and the prefill forward's (the ``mma`` kernel)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.launch import serve
    from repro_torch.nn import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    args = serve.parse_args(LM_ARGV)
    t0 = time.perf_counter()
    cfg, engine, reqs = serve.setup(args)
    rep = cfg.n_heads // cfg.n_kv
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.params
    steps = _record_steps(engine)
    common.reset_launches()
    t0 = time.perf_counter()
    done = engine.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.LAUNCHES["flash_attn"]
    tokens = sum(len(r.out) for r in done)
    prompt = sum(len(r.prompt) for r in reqs)
    run = {"argv": LM_ARGV, "setup_s": setup_s, "device": str(engine.device),
           "n_params": sum(p.numel() for p in params.parameters()),
           "requests": len(reqs), "done": len(done), "tokens": tokens,
           "prompt_tokens": prompt, "decode_steps": engine.steps,
           "ticks": engine.steps - prompt, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ms_per_step": wall / engine.steps * 1e3,
           "flash_attn_launches": launches,
           "flash_attn_variant": attn_ops.variant(cfg.param_dtype, 1, rep),
           "expected_launches": cfg.n_layers * engine.steps,
           "tokens_in_range": all(0 <= t < cfg.vocab
                                  for r in done for t in r.out)}

    # the same steps (tokens, index) from fresh caches through the plain
    # versions, in bf16 and with the same weights in fp32 (the limit of
    # _held_bf16): every step's logits and the final caches compared
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    params32 = copy.deepcopy(params).float()
    plain, plain32 = (ServeEngine(c, p, slots=args.slots,
                                  max_len=args.max_len, device=dev)
                      for c, p in ((cfg, params), (cfg32, params32)))
    with common.plain_versions():
        refs = [(plain._step(t, i), plain32._step(t, i)) for t, i, _ in steps]
    logits = torch.stack([lg for _, _, lg in steps])
    ref, ref32 = (torch.stack(r) for r in zip(*refs))
    held = {"logits": _held_bf16(logits, ref, ref32),
            **{f"cache_{key}": _held_bf16(engine.cache[key], plain.cache[key],
                                          plain32.cache[key])
               for key in ("k", "v")}}
    run["vs_plain"] = {
        "steps": len(steps), **held,
        "logits_max_abs_err_by_step": (logits - ref).abs().amax(
            dim=(1, 2)).tolist(),
        "logits_max_abs": float(logits.abs().max()),
        "argmax_differs": int((logits.argmax(-1) != ref.argmax(-1)).sum()),
        "ok": all(h["ok"] for h in held.values())}
    del plain, plain32, refs

    # ticks alone, then a profiled stretch of ticks, on 4 live slots
    stretch = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                          device=dev)
    for i in range(args.slots):
        stretch.try_admit(Request(100 + i, np.arange(1, 5) + i, max_new=64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        stretch.tick()
    torch.cuda.synchronize()
    run["ms_per_tick"] = (time.perf_counter() - t0) / 16 * 1e3
    run["profiled_ticks"] = {"ticks": 16, **_busy_stretch(
        lambda: [stretch.tick() for _ in range(16)])}
    run["tick_breakdown"] = _lm_profile(
        lambda: [stretch.tick() for _ in range(4)], 4)

    # one prefill forward at twice the window, kernel against plain
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, LM_PREFILL), device=dev,
                         generator=g)
    common.reset_launches()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, cache = transformer.forward(params, cfg, {"tokens": toks},
                                       mode="prefill")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = common.LAUNCHES["flash_attn"]
        with common.plain_versions():
            t0 = time.perf_counter()
            h_ref, cache_ref = transformer.forward(params, cfg,
                                                   {"tokens": toks},
                                                   mode="prefill")
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            h32, cache32 = transformer.forward(params32, cfg32,
                                               {"tokens": toks},
                                               mode="prefill")
    held = {"hidden": _held_bf16(h, h_ref, h32),
            **{f"cache_{key}": _held_bf16(cache[key], cache_ref[key],
                                          cache32[key]) for key in ("k", "v")}}
    kind = attn_ops.variant(cfg.param_dtype, LM_PREFILL, rep)
    prefill = {"B": 1, "S": LM_PREFILL, "window": cfg.window,
               "wall_s": prefill_s, "plain_wall_s": plain_s,
               "flash_attn_launches": prefill_launches,
               "flash_attn_variant": kind,
               "hidden_shape": list(h.shape),
               "cache_shape": list(cache["k"].shape),
               "hidden_max_abs": float(h.abs().max()), **held,
               "ok": bool(all(x["ok"] for x in held.values())
                          and prefill_launches == cfg.n_layers
                          and kind == "mma")}
    ok = bool(run["device"].startswith("cuda") and run["done"] == len(reqs)
              and all(r.done for r in reqs) and run["tokens_in_range"]
              and launches == run["expected_launches"] > 0
              and run["flash_attn_variant"] == "decode"
              and run["vs_plain"]["ok"] and prefill["ok"])
    return {"phase": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
            "window": cfg.window, "dtype": str(cfg.param_dtype),
            "serve": run, "prefill": prefill, "ok": ok}, launches, \
        prefill_launches


def phase_timing(covtype, w8a, news, realsim, worst: dict
                 ) -> tuple[list[dict], list[dict], dict]:
    """Each kernel and its plain version at the main path's shapes: one
    timed row per kernel and variant (glm_grad: covtype on the ring kernel
    and on the two-pass row kernel it replaced, and d = 60,000; glm_score:
    the serving flushes' shapes (w8a at max_batch 128 and 32, real-sim at
    128), all of w8a and news' first 512 rows, on the flat kernel and on the
    group kernel it replaced, their device times taken twice in turns;
    glm_sgd: SyncSGD(batch=16) on the warp
    kernel and on the smem kernel it replaced, the R=8 B=1 replica epochs,
    and the cluster kernel beside the kernels it replaced: at Table 4's
    real-sim seq epoch (smem) and at d = 58,112 (global); glm_sgd_sparse:
    the R=10 replica epochs at B=10 and B=1, and news' R=8 and R=64 B=1
    epochs on the stream kernel and on the global kernel it replaced;
    glm_sparse: w8a at R=1 and R=10 x 6,470 on the
    smem kernel and on the atomic kernel it replaced; flash_attn: decode
    over the serving run's 128 keys and a full 4096-key window, prefill,
    and an fp32 call; the kernels line takes the rows marked ``line``), the
    decode wrapper's host us per call, a check of w8a's R=10
    full-partition gradient, and the device time of a launch that does
    nothing (``torch.cuda._sleep(0)``)."""
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_score import ops as score_ops
    from repro_torch.kernels.glm_score.ref import glm_score_ref
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    X, yd = covtype
    m, ys = w8a
    n, d = X.shape
    ns, k = m.values.shape
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(X.device)
    ws = torch.from_numpy(rng.normal(0, 0.1, m.d).astype(np.float32)).to(X.device)
    nnz = int((m.values != 0).sum())
    rows = []
    plain_runs = {}

    def row(name, shape, kernel, plain, reps, plain_reps, in_bytes, flops, tol,
            library=None, line=None, flops_per_s=FP32_FLOPS_PER_S,
            variant=None, updates=None):
        """``line``: the row's name in the kernels line (None: not there);
        ``updates``: the dependent updates of a fused epoch's chain.  A
        ``plain`` function two rows share is run and timed once."""
        out = kernel()
        if plain not in plain_runs:
            plain_runs[plain] = (plain(), cuda_ms(plain, plain_reps))
        ref, plain_ms = plain_runs[plain]
        err, ok = close(out, ref, tol)
        ms = cuda_ms(kernel, reps)
        b, by = bound_ms(in_bytes, flops, flops_per_s)
        lib = {"library_ms": None}
        if library is not None:
            lib = {"library_ms": cuda_ms(library, reps),
                   "library_max_abs_err": close(library(), ref, tol)[0]}
        symbols = KERNEL_SYMBOLS[name][variant]
        dev_time = kernel_device_time(kernel, reps, symbols)
        if updates is not None:
            dev_time["us_per_update"] = ms * 1e3 / updates
            dev_time["device_us_per_update"] = \
                dev_time["device_ms"] * 1e3 / updates
        rows.append({"name": name, "route": "cuda", "line": line,
                     "variant": "/".join(symbols),
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "shape": shape,
                     "max_abs_err": err, "ok": ok,
                     "check_max_abs_err": worst[name], "ms": ms, **dev_time,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     **lib})

    # SyncSGD() on covtype: the full-batch sum gradient, on the ring kernel
    # and on the two-pass row kernel it replaced
    for kind, line in (("ring", "glm_grad_ring"), ("row", None)):
        with forced_variant(grad_ops, kind):
            row("glm_grad", f"covtype N={n} d={d} {kind}",
                lambda: K.glm_grad("lr", w, X, yd),
                lambda: glm_grad_ref("lr", w, X, yd), 20, 20,
                nbytes(X, yd, w) + 4 * d, 4.0 * n * d + 8.0 * n, GRAD_TOL,
                line=line, variant=kind)
    # the col layout (Fig. 8's other access path) at covtype: the wrapper
    # materialises the [d, N] transpose, a warp per 32 examples
    row("glm_grad", f"covtype N={n} d={d} col",
        lambda: K.glm_grad("lr", w, X, yd, layout="col"),
        lambda: glm_grad_ref("lr", w, X, yd), 20, 20,
        nbytes(X, yd, w) + 4 * d, 4.0 * n * d + 8.0 * n, GRAD_TOL,
        variant=grad_ops.variant(d, "col"))
    # the row layout past the ring kernel and past w in shared memory
    Xw, yw, ww = _dense_inputs(rng, 2003, 60_000, X.device)
    row("glm_grad", "N=2003 d=60000 row", lambda: K.glm_grad("lr", ww, Xw, yw),
        lambda: glm_grad_ref("lr", ww, Xw, yw), 20, 20,
        nbytes(Xw, yw, ww, ww), 4.0 * Xw.numel() + 8.0 * 2003, GRAD_TOL,
        variant=grad_ops.variant(60_000, "row"))
    # d = 58,112 at micro-batch 10, 201 updates: the cluster kernel (16
    # blocks, each batch streamed twice in fills of 7 rows) and the global
    # kernel it replaced
    Xg, wg = Xw[:, :58_112].contiguous(), ww[:58_112].contiguous()
    del Xw

    def plain58():
        return glm_sgd_epoch_ref("lr", wg[None], Xg[None], yw[None],
                                 1.0 / 58_112, 10)[0]

    for kind in (sgd_ops.variant(58_112, 10), "global"):
        with forced_variant(sgd_ops, kind):
            row("glm_sgd", f"N=2003 d=58112 MB=10 R=1 {kind}",
                lambda: K.glm_sgd_epoch("lr", wg, Xg, yw, step=1.0 / 58_112,
                                        micro_batch=10), plain58,
                3, 1, nbytes(Xg, yw, wg, wg), 4.0 * Xg.numel() + 8.0 * 2003,
                EPOCH_TOL, variant=kind, updates=-(-2003 // 10))
    del Xg
    # SyncSGD(batch=16) on covtype: one fused epoch, 36,314 updates, on the
    # warp kernel and on the shared-memory kernel it replaced
    def plain16():
        return glm_sgd_epoch_ref("lr", w[None], X[None], yd[None], 0.01, 16)[0]

    for kind, line in (("warp", "glm_sgd"), ("smem", None)):
        with forced_variant(sgd_ops, kind):
            row("glm_sgd", f"covtype N={n} d={d} MB=16 R=1 {kind}",
                lambda: K.glm_sgd_epoch("lr", w, X, yd, step=0.01,
                                        micro_batch=16), plain16, 3, 1,
                nbytes(X, yd, w) + 4 * d, 4.0 * n * d + 8.0 * n, EPOCH_TOL,
                line=line, variant=kind, updates=-(-n // 16))
    # phase study's Table 4 seq epoch on real-sim: its first 1,024 rows
    # densified at d = 20,958, micro-batch 1, on the cluster kernel and on
    # the shared-memory kernel it replaced
    Xr, yr, wr = _dense_inputs(rng, 1024, 20_958, X.device)

    def plain_seq():
        return glm_sgd_epoch_ref("lr", wr[None], Xr[None], yr[None],
                                 1.0 / 20_958, 1)[0]

    for kind, line in ((sgd_ops.variant(20_958, 1), "glm_sgd_cluster"),
                       ("smem", None)):
        with forced_variant(sgd_ops, kind):
            row("glm_sgd", f"real-sim seq N=1024 d=20958 MB=1 R=1 {kind}",
                lambda: K.glm_sgd_epoch("lr", wr, Xr, yr, step=1.0 / 20_958,
                                        micro_batch=1), plain_seq,
                5, 1, nbytes(Xr, yr, wr, wr), 4.0 * Xr.numel() + 8.0 * 1024,
                EPOCH_TOL, line=line, variant=kind, updates=1024)
    del Xr
    # AsyncLocalSGD(replicas=8, local_batch=1) on covtype: 72,626 updates
    # per replica, replicas 125 MB apart
    parts8 = torch.from_numpy(sgd.partition_indices(n, 8)).to(X.device).long()
    Xp, ydp = X[parts8], yd[parts8]
    W8 = w[None] * torch.linspace(-1.0, 1.0, 8, device=X.device)[:, None]
    per = Xp.shape[1]
    row("glm_sgd", f"covtype R=8 per={per} d={d} MB=1",
        lambda: K.glm_sgd_epoch("lr", W8, Xp, ydp, step=1e-3, micro_batch=1),
        lambda: glm_sgd_epoch_ref("lr", W8, Xp, ydp, 1e-3, 1),
        3, 1, nbytes(Xp, ydp, W8, W8), 4.0 * Xp.numel() + 8.0 * 8 * per,
        EPOCH_TOL, variant=sgd_ops.variant(d, 1), updates=per)
    del Xp
    # AsyncLocalSGD(replicas=10, local_batch=10) on w8a: replica epochs
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).to(X.device).long()
    vp, ip, yp = m.values[parts], m.indices[parts], ys[parts]
    W = ws[None].repeat(10, 1)
    for mb, line in ((10, "glm_sgd_sparse_warp"), (1, None)):
        row("glm_sgd_sparse", f"w8a N={ns} K={k} d={m.d} R=10 MB={mb}",
            lambda: K.ell_sgd_epoch("lr", W, vp, ip, yp, step=0.2,
                                    micro_batch=mb),
            lambda: ell_sgd_epoch_ref("lr", W, vp, ip, yp, 0.2, mb),
            10 if mb > 1 else 3, 1, ell_bytes(vp) + nbytes(yp, W, W),
            4.0 * nnz + 8.0 * ns, EPOCH_TOL, line=line,
            variant=sparse_ops.variant(m.d, k, mb),
            updates=-(-vp.shape[1] // mb))
    # SyncSGD() on w8a: the full-batch sparse sum gradient, and
    # AsyncLocalSGD(replicas=10, local_batch=6470)'s replica gradients, on
    # the smem kernel and on the atomic kernel it replaced
    for kind, line in (("smem", "glm_sparse_smem"), ("atomic", None)):
        with forced_variant(sparse_grad_ops, kind):
            row("glm_sparse", f"w8a N={ns} K={k} d={m.d} R=1 {kind}",
                lambda: K.ell_glm_grad("lr", ws, m.values, m.indices, ys),
                lambda: ell_glm_grad_ref("lr", ws[None], m.values[None],
                                         m.indices[None], ys[None])[0],
                20, 20, ell_bytes(m.values) + nbytes(ys, ws, ws),
                4.0 * nnz + 8.0 * ns, GRAD_TOL, line=line, variant=kind)
            row("glm_sparse", f"w8a R=10 per={vp.shape[1]} K={k} d={m.d} "
                f"{kind}", lambda: K.ell_glm_grad("lr", W, vp, ip, yp),
                lambda: ell_glm_grad_ref("lr", W, vp, ip, yp), 20, 20,
                ell_bytes(vp) + nbytes(yp, W, W), 4.0 * nnz + 8.0 * ns,
                GRAD_TOL, variant=kind)
    # news' AsyncLocalSGD(replicas=8 and 64, local_batch=1) replica
    # epochs: 2,499 and 312 dependent updates a replica with the model in
    # global memory, on the stream kernel and on the global kernel it
    # replaced
    mn, yn = news
    kn = mn.values.shape[1]
    stream = sparse_ops.variant(mn.d, kn, 1)
    for reps in NEWS_REPLICAS:
        parts = torch.from_numpy(sgd.partition_indices(mn.shape[0], reps)).to(
            X.device).long()
        vn, i_n, ynr = mn.values[parts], mn.indices[parts], yn[parts]
        Wn = torch.zeros(reps, mn.d, device=X.device)

        def plain_news():
            return ell_sgd_epoch_ref("lr", Wn, vn, i_n, ynr, NEWS_STEP, 1)

        for kind, line in (
                (stream, "glm_sgd_sparse_stream" if reps == 8 else None),
                ("global", None)):
            with forced_variant(sparse_ops, kind):
                row("glm_sgd_sparse", f"news N={mn.shape[0]} K={kn} d={mn.d} "
                    f"R={reps} MB=1 {kind}",
                    lambda: K.ell_sgd_epoch("lr", Wn, vn, i_n, ynr,
                                            step=NEWS_STEP, micro_batch=1),
                    plain_news, 3, 1, ell_bytes(vn) + nbytes(ynr, Wn, Wn),
                    4.0 * int((vn != 0).sum()) + 8.0 * ynr.numel(), EPOCH_TOL,
                    line=line, variant=kind, updates=vn.shape[1])
        del vn, i_n

    # the serving path: glm_score at the flushes' shapes (w8a at max_batch
    # 128, the kernels line's row, and 32; real-sim at 128), on all of w8a
    # and on news' first 512 rows, on the kernel variant() picks and on the
    # other.  The yardstick is one embedding_bag with per-sample weights,
    # which is the SVM score; the LR score adds a sigmoid, timed with it
    mr = realsim.ell
    wr = torch.from_numpy(rng.normal(0, 0.1, mr.d).astype(np.float32)).to(
        X.device)
    wn = torch.from_numpy(rng.normal(0, 0.1, mn.d).astype(np.float32)).to(
        X.device)
    for data, ell, wsc, rows_n, reps, line in (
            ("w8a", m, ws, 128, 200, "glm_score"),
            ("w8a", m, ws, 32, 200, None),
            ("real-sim", mr, wr, 128, 200, None),
            ("w8a", m, ws, ns, 20, None), ("news", mn, wn, 512, 50, None)):
        v, i = ell.values[:rows_n], ell.indices[:rows_n]
        i64, ks = i.long(), ell.values.shape[1]
        touched = int(torch.unique(i[v != 0]).numel())
        chosen = score_ops.variant(rows_n, ks, ell.d)

        def plain_score():
            return glm_score_ref("lr", wsc, v, i)

        kinds = (chosen, "group" if chosen == "flat" else "flat")
        for kind in kinds:
            with forced_variant(score_ops, kind):
                row("glm_score", f"{data} N={rows_n} K={ks} d={ell.d} lr "
                    f"{kind}", lambda: K.glm_score("lr", wsc, v, i),
                    plain_score, reps, reps,
                    ell_bytes(v) + 4 * rows_n + 4 * touched,
                    2.0 * int((v != 0).sum()) + 4.0 * rows_n, GRAD_TOL,
                    library=lambda: torch.sigmoid(
                        torch.nn.functional.embedding_bag(
                            i64, wsc.view(-1, 1), per_sample_weights=v,
                            mode="sum"))[:, 0],
                    line=line if kind == chosen else None, variant=kind)
        # both device times again in the other order (A, B, B, A): a row's
        # device time is the mean of its two, so neither kernel gains from
        # running second
        for kind, timed in zip(kinds[::-1], rows[-1:-3:-1]):
            with forced_variant(score_ops, kind):
                again = kernel_device_time(
                    lambda: K.glm_score("lr", wsc, v, i), reps,
                    KERNEL_SYMBOLS["glm_score"][kind])["device_ms"]
            timed["device_ms_runs"] = [timed["device_ms"], again]
            timed["device_ms"] = (timed["device_ms"] + again) / 2

    # the LM path: flash_attn at the decode shape of phase lm's serving run
    # (4 slots over a full 128-entry cache, causal=False as decode calls it:
    # the decode kernel) and over a full 4096-key window, and at its
    # prefill (S=8192, window 4096: the mma kernel); the serving shape and
    # the prefill are in the kernels line.  The yardstick is one
    # scaled_dot_product_attention with enable_gqa and the end-aligned mask
    from repro_torch.kernels.flash_attn.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, shape, causal, window, reps, plain_reps, line in (
            ("decode", (4, 32, 8, 1, 128, 80), False, None, 200, 50,
             "flash_attn_decode"),
            ("decode", (4, 32, 8, 1, 4096, 80), False, None, 200, 10, None),
            ("prefill", (1, 32, 8, LM_PREFILL, LM_PREFILL, 80), True, 4096,
             20, 2, "flash_attn_mma")):
        qa, ka, va = _attn_inputs(shape, torch.bfloat16, X.device, seed=7)
        mask = end_aligned_mask(shape[3], shape[4], causal, window, X.device)
        attn_bytes, attn_flops = attn_work(qa, ka, causal, window)
        row("flash_attn", f"{label} B,Hq,Hkv,Sq,Sk,hd={list(shape)} bf16 "
            f"causal={causal} window={window}",
            lambda: K.flash_attention(qa, ka, va, causal=causal, window=window),
            lambda: attention_ref(qa, ka, va, causal=causal, window=window),
            reps, plain_reps, attn_bytes, attn_flops, ATTN_BF16_TOL,
            library=lambda: sdpa(qa, ka, va, attn_mask=mask, enable_gqa=True),
            line=line, flops_per_s=BF16_FLOPS_PER_S,
            variant=attn_ops.variant(torch.bfloat16, shape[3],
                                     shape[1] // shape[2]))
        if line == "flash_attn_decode":
            # the wrapper's host time per call, and the library call's
            rows[-1]["host_us_per_call"] = host_us(
                lambda: K.flash_attention(qa, ka, va, causal=causal))
            rows[-1]["library_host_us_per_call"] = host_us(
                lambda: sdpa(qa, ka, va, enable_gqa=True))
    # the fp32 variant (no main path runs it): a causal 1024 x 1024 call at
    # danube's heads, bound by fp32 operations outside the tensor cores
    shape = (1, 32, 8, 1024, 1024, 80)
    qa, ka, va = _attn_inputs(shape, torch.float32, X.device, seed=8)
    mask = end_aligned_mask(1024, 1024, True, None, X.device)
    attn_bytes, attn_flops = attn_work(qa, ka, True, None)
    row("flash_attn", f"fp32 B,Hq,Hkv,Sq,Sk,hd={list(shape)} causal=True",
        lambda: K.flash_attention(qa, ka, va, causal=True),
        lambda: attention_ref(qa, ka, va, causal=True), 20, 5, attn_bytes,
        attn_flops, ATTN_TOL,
        library=lambda: sdpa(qa, ka, va, attn_mask=mask, enable_gqa=True),
        variant=attn_ops.variant(torch.float32, 1024, 4))

    checks = []

    def check(name, shape, out, ref, tol):
        err, ok = close(out, ref, tol)
        checks.append({"kernel": name, "shape": shape, "max_abs_err": err,
                       "tol": tol, "ok": ok})

    # AsyncLocalSGD(replicas=10, local_batch=per) on w8a: the full-partition
    # sum gradient over the replica axis
    check("glm_sparse", f"w8a R=10 per={vp.shape[1]} K={k} d={m.d}",
          K.ell_glm_grad("lr", W, vp, ip, yp),
          ell_glm_grad_ref("lr", W, vp, ip, yp), GRAD_TOL)
    # the floor under any launch: the device time of one that does nothing
    empty = kernel_device_time(lambda: torch.cuda._sleep(0), 200,
                               ("spin_kernel",))
    return rows, checks, empty


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.data import synthetic
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())

    line, worst = phase_kernels(dev)
    emit(line)
    if not line["ok"]:
        return 1

    t0 = time.perf_counter()
    cov = synthetic.paper_dataset("covtype", seed=0, device=dev)
    w8 = synthetic.paper_dataset("w8a", seed=0, device=dev)
    covtype, w8a = (cov.X, cov.y), (w8.ell, w8.y)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "covtype": list(cov.X.shape), "w8a": [w8.n, w8.d, w8.ell.max_nnz],
          "w8a_nnz": int((w8.ell.values != 0).sum())})

    line, launches, results = phase_train(covtype, w8a, epochs=4)
    emit(line)
    if not line["ok"]:
        return 1
    launches = {"glm_grad_ring": launches["glm_grad"],
                "glm_sgd": launches["glm_sgd"],
                "glm_sgd_sparse_warp": launches["glm_sgd_sparse"],
                "glm_sparse_smem": launches["glm_sparse"]}
    line = phase_parity(covtype, w8a, n=4100, epochs=3)
    emit(line)
    if not line["ok"]:
        return 1

    t0 = time.perf_counter()
    news = news_dataset(dev)
    torch.cuda.synchronize()
    news_seconds = time.perf_counter() - t0
    line, launches["glm_sgd_sparse_stream"] = phase_news(news, epochs=3)
    line["data_seconds"] = news_seconds
    emit(line)
    if not line["ok"]:
        return 1

    t0 = time.perf_counter()
    line, study_launches = phase_study(dev)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not line["ok"]:
        return 1
    # the study path is the only one that runs glm_sgd's cluster variant
    launches["glm_sgd_cluster"] = study_launches["glm_sgd_cluster"]

    # the serving path: w8a under the model SyncSGD ended with, swapped
    # halfway for the one AsyncLocalSGD(replicas=10, local_batch=10) merged
    realsim = synthetic.paper_dataset("real-sim", seed=0, max_n=8192,
                                      device=dev)
    line, launches["glm_score"] = phase_serve(
        dev, w8, realsim, results[3].model, results[4].model[0])
    emit(line)
    if not line["ok"]:
        return 1
    checks = [{"kernel": "glm_score", "max_abs_err": r["check"]["max_abs_err"]}
              for r in line["runs"]]
    line = phase_live(dev)
    emit(line)
    if not line["ok"]:
        return 1
    line, launches["flash_attn_decode"], launches["flash_attn_mma"] = \
        phase_lm(dev)
    emit(line)
    if not line["ok"]:
        return 1

    rows, full_checks, empty = phase_timing(covtype, w8a, news, realsim,
                                            worst)
    checks += full_checks
    # a kernels-line row's error: the worst of its kernel's rows and checks
    for r in rows:
        r["launches"] = launches[r["line"]] if r["line"] else None
        r["study_launches"] = study_launches.get(r["line"])
        r["max_abs_err"] = max(
            [o["max_abs_err"] for o in rows
             if (o["name"], o["variant"]) == (r["name"], r["variant"])]
            + [c["max_abs_err"] for c in checks if c["kernel"] == r["name"]])
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "full_shape_checks": full_checks, "empty_launch": empty,
          "seconds_total": time.perf_counter() - t_start})
    if not all(r["ok"] for r in rows + full_checks):
        return 1

    print(smi)
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "variant",
            "study_launches")
    emit({"kernels": [{"name": r["line"], **{k: r[k] for k in keys}}
                      for r in rows if r["line"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
