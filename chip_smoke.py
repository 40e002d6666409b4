#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (SGD study engine and the paper's study layer,
scoring service, live learner, LM serving and LM training in every
family) on one NVIDIA card.

    python3 chip_smoke.py          (from the repository root; needs one card)
    python3 chip_smoke.py --lm-train-probe
    python3 chip_smoke.py --lm-families
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --attn-fwd
    python3 chip_smoke.py --attn-bwd
    python3 chip_smoke.py --wide
    python3 chip_smoke.py --dense
    python3 chip_smoke.py --long-rows

The second runs only env, build and the probe of phase ``lm_train``'s
rules (``run_lm_train_probe``): the gradient check on four seeded models
and batches beside a library bf16 attention, and fresh-batch runs at
other rates, lengths and parameter dtypes beside each batch's loss at the
initial weights.  The third runs only env, build and phase
``lm_families``, the fourth only env, build and phase ``mesh`` (after
``lm_families`` in the full run: ``phase_mesh``'s docstring; the placed
families' sync steps and zamba2's decode ticks bit for bit on a one-rank
NCCL mesh, and the dry run's cells on the production meshes), the fifth
only env, build, phase ``kernels``' checks of the attention forward in
every variant, the sweeps behind ``WGMMA_MIN_QUERIES`` and
``TILED_MIN_QUERIES``, the fp32 forward's rows, the forward's rows of
phase ``lm_train``'s (d) and phase ``lm_train`` (c)'s rules, the layer
rule among them, on the kernel path and against forwards wrong on purpose
(``run_attn_fwd``), the sixth only env,
build, phase ``kernels``' checks of the attention backward and phase
``lm_train``'s (d), the seventh only env, build and the paper profile's
widest datasets (``run_wide``: phase ``kernels``' checks of glm_sgd's grid
and glm_sparse's hot kernels, phase ``news``, phase ``study``'s (c) and
their timing rows), the eighth only env, build and the dense paths past
the Hopper designs' first shapes (``run_dense``: phase ``kernels``' checks
of glm_sgd's rows and glm_grad's wide kernels, covtype's ``SyncSGD(batch
=1024)`` and ``AsyncLocalSGD(10, 58,101)`` and ``SyncSGD()`` on the dense
wide set as phase ``train`` runs them and as phase ``parity`` holds them,
their timing rows, the sweep behind ``ROWS_MIN_BATCH`` and the wide
kernel's sweep of tiles), the ninth only env, build and the paper's
sparse sets at their Table 3 row widths (``run_long_rows``:
``live_kernel_checks``, phase ``long_rows`` and ``long_rows_timing``'s
rows, each live-prefix kernel and the kernel it replaced in turns).


Phases, one JSON line each (with ``phase_seconds``, the host seconds since
the previous phase line):

1. ``env``     card name and power limit, torch, CUDA, nvcc, triton;
2. ``build``   compiles the seven sources from src/repro_torch/kernels/csrc
               (one nvcc per source, all at once) and reports ptxas usage
               and every kernel that spills;
3. ``kernels`` holds each kernel against its plain PyTorch version on the
               card: both tasks, both glm_grad layouts, covtype and w8a
               widths, a ragged N, a replica axis, real-sim's width, and
               both glm_score kernels (flat and group) at w8a, real-sim and
               news widths, rows of 3 words in a batch of 5, and values at
               another 16-byte offset than their indices, with filler rows
               that must score link(0) exactly; glm_sgd at d = 3, 54, 300,
               1024 and 1025 (warp, rows and cluster variants),
               micro-batches 1 to 64 with ragged tails, 1, 8 and 10
               replicas; glm_sgd_sparse's warp
               variant at micro-batches 1, 10 and 64, K = 1, real-sim's
               K = 307, rows of all padding, rows that collide on one
               feature and repeat it, the live learner's shape, and the
               shared-memory variant near the cap; flash_attn
               (``attention_forward_checks``: each case in every variant
               that takes it, bf16's log-sum-exp and output to 16 bits
               through the operator too) at danube's
               prefill (S=8192, window 4096), a full causal 2048 at
               minitron's heads, the tensor-core variants' edges (rep 3 with
               a ragged S, padded head dims, a query chunk over a longer
               cache and over a cache prefix read in place, a window inside
               one key tile, acausal, exactly 16 rows, rows that see no
               key, head dims 64 to 128, the queries around
               WGMMA_MIN_QUERIES, unmasked cross Sq > Sk, the vlm cross
               call, three calls of the wgmma kernel giving the same bits),
               the decode variant's (Sk = 1,
               127, 128 and 4096, a cache prefix read in place, head dims
               64, 72 and 128, B = 64 with no split, a window that leaves
               chunks with no key, two row groups, the same output twice)
               and fp32 cases in both fp32 variants with their
               log-sum-exp (ragged tiles, Sq < Sk, cross Sq > Sk, a window
               inside one key tile, rep 1 to 8, hd 8 to 128, the queries
               around TILED_MIN_QUERIES, three calls of the tiled kernel
               giving the same bits); the attention backward
               (``ATTN_BWD_CASES``: head dims 8 to 128, rep 1 and 4,
               causal with and without a window, acausal, cross Sq > Sk,
               ragged lengths) on the forward's output, log-sum-exp and
               rounding residual against the plain backward, in the
               variant ``bwd_variant`` picks and, forced, the other that
               takes the case, fp32 at ATTN_TOL, bf16 within BWD_BF16_REL
               of the fp32 yardstick and the picked variant within
               BWD_PLAIN_RATIO of the plain bf16 backward's error, the
               picked variant's five calls giving the same bits;
               glm_grad's ring variant at d = 3, 54
               and 300 with a ragged last tile; glm_sparse's smem variant
               at w8a (R = 1 and 10 x 6,470), real-sim's width and every
               glm_sgd_sparse edge case above (rows of all padding, a
               feature three times in every row), and its atomic variant
               near the cap; the wide models (glm_sgd's cluster variant at
               d = 58,112 and 65,536, its global variant at 100,000,
               glm_grad's row layout at 60,000, glm_sgd_sparse's stream
               variant at news' width with K = 2,729, micro-batches 1 and
               10, several replicas, also with the padding spread through
               the rows, and its live_global variant past the stream's K);
               five
               calls of glm_grad, glm_sparse, glm_sgd's cluster variant and
               both glm_score kernels at the serving flushes' shapes giving
               the same bits; and that the sparse kernels refuse an index
               outside [0, d); ``wide_kernel_checks``: glm_sgd's grid
               variant from d = 65,537 to news' 1,355,191 (ragged tails,
               a batch streamed twice, 3 replicas, five calls' bits) and
               glm_sparse's hot variant at rcv1's and news' widths and past
               the smem cap (padding spread through the rows, rows of all
               padding, a feature thrice a row, 3 replicas, an index
               outside [0, d) refused); ``live_kernel_checks``:
               glm_sgd_sparse's live-prefix variants at both Table 3 widths
               (LIVE_CASES: micro-batches 1, 10, 16 and 512 with ragged
               tails, 3 replicas, rows split over fills; each as drawn,
               with its padding spread through the rows, every 7th row all
               padding and a feature thrice a row), the kernels they
               replaced forced at two of them, and the length pass alone;
               ``dense_kernel_checks``: glm_sgd's
               rows variant at ROWS_CASES (batches just past the warp
               ring, covtype's 1,024 and 4,096, tails shorter than the
               cluster, 8 and 10 replicas, full partitions) and glm_grad's
               wide variant at WIDE_CASES (clusters of 1 to 16 blocks,
               slices at every 16-byte offset, tiles of 1 to 8 rows), each
               variant's five calls' bits, and the row kernel forced at
               d = 60,000;
4. ``train``   ``repro_torch.core.sgd.run`` at the full size of the paper's
               covtype (581,012 x 54, dense) and w8a (64,700 x 300, K=69,
               padded ELL) stand-ins, eight strategies (covtype's
               ``SyncSGD(batch=1024)`` and ``AsyncLocalSGD(replicas=10,
               local_batch=58,101)`` since PR 32), and ``SyncSGD()`` on the
               dense wide set (16,384 x 20,958 drawn on the card,
               ``dense_wide_dataset``); launch counts are zeroed just
               before each run and read just after, by the variant its
               shapes pick, which is checked (glm_grad's ring and wide,
               glm_sgd's warp and rows, glm_sparse's smem,
               glm_sgd_sparse's warp); then the nine runs at N=4,100
               through the kernels and through the plain versions on the
               card, loss for loss (phase ``parity``);
5. ``news``    the paper's news at full size (19,996 x 1,355,191, K =
               2,729: a 437 MB padded ELL drawn on the card,
               ``news_dataset``) through ``sgd.run`` under Table 7's
               ``AsyncLocalSGD(replicas=8 and 64, local_batch=1)`` and
               under ``SyncSGD()``, and rcv1 at full size (677,399 x
               47,236, K = 438, ``rcv1_dataset``) under ``SyncSGD()``, 3
               epochs each, launch counts zeroed just before each run and
               read just after (glm_sgd_sparse's stream variant, glm_sparse's
               hot variant); ms per epoch and us per update; then each on
               the first 1,600 rows through the kernels and through the
               plain versions, loss for loss;
6. ``long_rows`` real-sim (72,309 x 20,958) and news (19,996 x
               1,355,191) padded to their Table 3 row widths, K = 3,484 and
               16,423 (``long_rows_dataset``: ``wide_dataset``'s draw on
               the card, the first row at full width), through ``sgd.run``:
               real-sim under ``SyncSGD()``, ``SyncSGD(batch=16)``,
               ``AsyncLocalSGD(8, 1)`` and ``AsyncLocalSGD(10, 10)`` (4
               epochs), news under ``AsyncLocalSGD(8, 1)`` and ``(64, 1)``
               and ``SyncSGD()`` (3 epochs), launch counts zeroed just
               before each run and read just after (glm_sgd_sparse's
               live_smem and live_global variants, one launch an epoch;
               glm_sparse's smem and hot), ms an epoch and us an update;
               then each path on the first 4,100 and 1,600 rows through the
               kernels and the plain versions, loss for loss; and
               ``long_rows_timing``'s rows;
7. ``study``   the paper's study layer (``repro_torch.study`` and the
               drivers in ``repro_torch.benchmarks``): (a) the Table 7,
               Table 4 and Fig. 22 drivers on the ci profile (covtype, w8a,
               real-sim cut to STUDY_CI_ROWS = 1,024 rows since PR 32,
               LR and SVM, 12 epochs, grid 1e-3,
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
               ``speedup_sync_vs_seq`` on each dataset; (c) the paper
               profile's rcv1 (``benchmarks.common.load``) and news (drawn
               on the card), 16,384 rows each, LR and SVM: Table 4's three
               paths (seq on glm_sgd's cluster and grid variants) and
               ``SyncSGD()`` at the three steps for 30 epochs (glm_sparse's
               hot variant), launches by family read around each run, each
               run held epoch by epoch to the plain versions on its first
               1,600 rows;
8. ``serve``   ``GLMScoreEngine`` on the card: all 64,700 w8a rows as
               requests under the model phase ``train``'s SyncSGD run ended
               with (max_batch 128, with a swap_model halfway, and 32), and
               8,192 real-sim-width requests; launch counts zeroed just
               before and read just after (one glm_score launch a flush, on
               the variant each run's line names); every response held
               against the plain version under the snapshot version it
               carries;
9. ``live``    train-while-serving: ``LiveLearner`` on a real-sim-width
               stream publishing into an engine that a second thread
               serves, exact and int8-compressed, with replicas killed and
               revived; each configuration also run in lockstep through the
               kernels and through the plain versions and held merge by
               merge (int8: also with the plain learner resynced after each
               merge, and its codes compared); short glm_sparse and dense
               runs;
10. ``lm``      the LM serving path on full-width h2o-danube-1.8b (random
               weights from a seeded generator on the card): the serving
               run of ``repro_torch.launch.serve`` (8 requests, 4 slots,
               max_new 16, max_len 128) with launch counts zeroed just
               before and read just after; its logits at every step and
               its caches held against the same steps through the plain
               versions, with the same weights in fp32 as the yardstick
               (``_held_bf16``); a profiled stretch of ticks; and one
               prefill forward at S=8192 held the same way;
11. ``lm_train`` LM training on full-width h2o-danube-1.8b (bf16, random
               seeded weights) through ``repro_torch.launch.train``'s
               objects: (a) sync SGD, 8 steps at B=2, S=8192 (past the 4096
               window), launch counts zeroed just before and read just
               after (``flash_attn_wgmma_kernel``: a forward and a recompute
               a layer and step), the fresh batches' losses, which must
               fall (the reference's check), ms per step, tokens/s, peak
               memory, the step-0
               checkpoint's host copy, and one step split into forward,
               backward and optimizer with a profiled forward + backward,
               then again with the attention backward's plain version in
               the kernel's place, and with the kernel again;
               (b) async-local, 2 replicas merged every 2 steps, the same
               shape, replicas equal after each merge, and one int8 merge
               with error feedback; (c) one step's loss and every gradient
               leaf through the kernel, through the plain versions in bf16
               and through the plain versions on an fp32 copy (the
               yardstick; each leaf by RMS and by max distance,
               ``_held_bf16_grad``; the loss by ``_held_bf16`` with the
               floor LOSS_ATOL), the kernel path's every attention
               forward call held layer by layer (``checked_attention``:
               its bf16 output within 1.5x the plain bf16 version's RMS
               and max distance from the plain version on fp32 copies of
               its own q, k, v; a recompute to its forward's bits), and 2
               layers in fp32 on the ``simt_tiled`` forward and backward
               against the plain versions, their launches read from the
               trace; (d) the attention backward alone at one layer's
               shape against autograd through the plain forward, three
               calls' bits, then the first designs and the redesigns in
               turns (``_turns``: the call and each pass by events) at the
               window and causal with no window, and in fp32 at causal
               1,024², beside bounds, the plain backward and SDPA's
               backward and backend, and the forward's rows 6a and 6b; (e) a
               restart at the reduced config through the launcher's
               ``main``;
12. ``lm_families`` the moe, hybrid, ssm, audio and vlm families at full
               width (bf16, seeded random weights, stub frontends), one
               architecture at a time, each freed before the next: (a)
               olmoe-1b-7b, zamba2-1.2b and xlstm-1.3b served through
               ``repro_torch.launch.serve`` (8 requests, 4 slots, 16 new
               tokens, max_len 128), musicgen-large and
               llama-3.2-vision-11b through ``trainer.make_prefill_step``
               at B=2, S=512 (1,600 patches) and 16 ``decode_step``s; (b)
               ``launch.train --batch 1 --seq 1024 --steps 2`` (vlm 2,048,
               past its 1,600 patches; xlstm 512) with SGD, checkpoint
               writes off; each
               with launch counts zeroed just before and read just after;
               (c) each at a cut depth (moe and audio 2 layers, vlm 5,
               hybrid and ssm 8) through the kernels, the plain versions
               and fp32: prefill hidden states and caches and decode
               logits by ``_held_bf16``, one step's gradient leaves by
               ``_held_bf16_grad``; (d) the flash_attn shapes they bring
               (head dims 64 and 128, one query head a kv head, the
               non-causal cross call at Sq 2,048 > Sk 1,600 forward and
               backward, decode over 1,600 keys) against the plain version
               beside SDPA; (e) ``launch.train --smoke --ckpt-dir`` then
               ``launch.serve --smoke --ckpt`` serving the same tokens as
               an engine on the trainer's final weights;
13. ``bench``  the port's benchmark producers and the tuner, in a temporary
               results and tune directory: (a) ``bench_kernels.run("paper")``
               (every row checked on the card and true, roofline shares at
               most 1.05, the gate clean, a warm re-run byte-identical;
               launch counts zeroed just before and read just after); (b)
               every candidate of every tunable held against the plain
               version at the bench's shape and at the main paths' shapes
               (covtype's gradient, w8a's at R = 1 and 10, w8a and real-sim
               flushes of 128 rows, danube decode over 128 and 4,096 keys,
               covtype's B=16 epoch on its first 4,100 rows and w8a's
               r10 b10 epochs), the tuner's sweep there and its winner's
               device time beside the plan's pick; (c)
               ``bench_serve.run("ci")`` with 1 and 2 consumers and
               ``bench_live.run("ci")``, gates clean, and a monitored drive
               of each, clean (no breach) and with its fault (a
               ``latency_p99`` breach under a flush stall, a ``staleness``
               breach under a publisher stall); (d) the host us of the
               decode wrapper and of ``glm_score`` with the tuned argument
               pinned, with an empty cache and with a cached record, and
               of a ``GLMScoreEngine.flush``; (e) one traced
               ``bench_serve`` and one traced ``bench_live`` drive, then
               ``python -m repro_torch.obs.report --check`` over their
               trace dir (exit 0, the kernel, serve and live layers);
14. ``sweep``  the multi-worker sweep, traced, with the profiler capture
               on (``REPRO_TRACE_XPROF=1``): the ci profile's Table 7 and
               Fig. 22 trials in this process from no cache, then through
               a ``Runner`` with a 2-worker ``LocalProcessExecutor`` on the
               card from an empty cache, then through the two drivers on a
               serial runner over the merged cache (no miss, the two
               ``BENCH_study.json`` byte-identical, one ``sweep_shard``
               event a worker and one ``sweep_merge``), every dispatched
               trial's losses held against the in-process run; a worker
               killed after its first stack group and requeued once; the
               report CLI over the trace dir (``--check`` exit 0, every
               lane and layer, every worker's ``kernel.dispatch`` on
               ``cuda`` for the four study kernels) and one profiler
               capture a worker attempt naming a port kernel; wall seconds
               of the serial run and of the sweep, recorded (the workers
               share the card);
15. ``timing`` each kernel and its plain version at the main path's shapes
               (glm_sgd also at covtype R=8 B=1, on its shared-memory
               variant at covtype B=16, on its cluster variant beside the
               shared-memory one at phase study's real-sim seq epoch and
               beside the global one at d = 58,112, glm_grad also in the
               col layout, glm_sgd_sparse also on its shared-memory variant
               at w8a R=10 B=10, at w8a R=10 B=1 and at news
               R=8 and R=64 B=1 on its stream variant and on the global
               variant, ``long_rows_timing``: glm_sgd_sparse's
               live_smem variant beside the smem one at real-sim's r8 b1,
               r10 b10 and B=16 epochs and its live_global variant beside
               the global one at news's r8 and r64 b1 epochs, at their
               Table 3 widths, in turns; ``dense_timing``: glm_sgd's rows
               variant beside the smem one at covtype B=1,024 and 4,096
               and beside the global one at R=10 x 58,101, glm_grad's wide
               variant beside
               the row one at 2,003 x 60,000, 16,384 x 20,958 and 16,384 x
               2,048, each pair's device times taken twice in turns,
               glm_grad and glm_sparse each beside the kernel their
               redesign replaced, glm_sparse also at R=10, glm_score's flat
               kernel beside the group kernel at w8a N = 128 and 32,
               real-sim N = 128, all of w8a and news N = 512, flash_attn
               decode also over a full 4096-key window, its prefill and the
               vlm cross call on the wgmma kernel beside the mma kernel,
               and the fp32 forward's two kernels in turns at causal
               1,024², at lm_train (c)'s fp32 layer and at the reduced
               configs' layer (FP32_TIMED, SDPA fp32 beside);
               ``wide_timing``: glm_sgd's grid variant beside the global one
               at Table 4's news seq epoch and at d = 100,000, glm_sparse's
               hot variant beside the atomic one at rcv1's and news' full
               sizes, and at w8a forced),
               with the variant each row ran and its device time
               (profiler, or a CUDA event pair around one call where the
               profiler saw no launch), the decode wrapper's host us per
               call, a check of w8a's R=10 full-partition gradient, and
               the device time of a launch that does nothing.

It then prints the card's name and power limit, a ``{"kernels": [...]}`` line
(launches on the main paths and on phase study's full-size run, error,
times, device ms and us an update of a fused epoch's chain, bound, variant:
a row for each kernel the main paths run, named by its variant where a
family has more than one) and, last,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without a card, or without the repository beside it, it fails.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the tensor
#: cores, bf16 on them (the attention bound counts bf16 work); the visible
#: (query, key) pairs of an attention call
from repro_torch.roofline.kernels import (  # noqa: E402
    BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, visible_pairs)
from repro_torch.kernels.flash_attn.ops import (  # noqa: E402
    TILED_MIN_QUERIES, WGMMA_MIN_QUERIES)

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
    # no TPU kernel: the reference differentiates its XLA chunked_attention
    "flash_attn_bwd": "src/repro/nn/attention.py:49",
}


#: the __global__ functions each wrapper launches (csrc/<name>.cu), by the
#: variant its ops.variant() picks (None: the family has one)
KERNEL_SYMBOLS = {
    "glm_sgd": {"warp": ("glm_sgd_warp_kernel",),
                "rows": ("glm_sgd_rows_kernel",),
                "cluster": ("glm_sgd_cluster_kernel",),
                "grid": ("glm_sgd_grid_kernel",),
                "smem": ("glm_sgd_kernel",),
                "global": ("glm_sgd_global_kernel",)},
    "glm_grad": {"ring": ("glm_grad_ring_kernel", "glm_grad_reduce_kernel"),
                 "wide": ("glm_grad_wide_kernel", "glm_grad_sum_kernel"),
                 "row": ("glm_grad_row_kernel", "glm_grad_reduce_kernel"),
                 "col": ("glm_grad_col_kernel", "glm_grad_reduce_kernel")},
    "glm_sgd_sparse": {"warp": ("ell_sgd_warp_kernel",),
                       "smem": ("ell_sgd_kernel",),
                       "live_smem": ("ell_live_length_kernel",
                                     "ell_sgd_live_smem_kernel"),
                       "stream": ("ell_sgd_stream_kernel",),
                       "live_global": ("ell_live_length_kernel",
                                       "ell_sgd_live_global_kernel"),
                       "global": ("ell_sgd_global_kernel",)},
    "glm_sparse": {"smem": ("ell_grad_smem_kernel", "ell_grad_reduce_kernel"),
                   "hot": ("ell_grad_hot_kernel", "ell_grad_hot_sum_kernel"),
                   "atomic": ("ell_grad_kernel",)},
    "glm_score": {"flat": ("glm_score_flat_kernel",),
                  "group": ("glm_score_kernel",)},
    "flash_attn": {"wgmma": ("flash_attn_wgmma_kernel",),
                   "mma": ("flash_attn_mma_kernel",),
                   "decode": ("flash_attn_decode_kernel",),
                   "simt_tiled": ("flash_attn_tiled_kernel",),
                   "simt": ("flash_attn_kernel",)},
    "flash_attn_bwd": {"wgmma": ("flash_attn_bwd_dq_wgmma_kernel",
                                 "flash_attn_bwd_dkv_wgmma_kernel"),
                       "simt_tiled": ("flash_attn_bwd_dq_tiled_kernel",
                                      "flash_attn_bwd_dkv_tiled_kernel",
                                      "flash_attn_bwd_sum_kernel"),
                       "mma": ("flash_attn_bwd_dq_mma_kernel",
                               "flash_attn_bwd_dkv_mma_kernel")},
}
#: cycles the card spins before an event-timed call (about 1 ms at the
#: H100's 1.98 GHz boost), longer than the host takes to enqueue the call
SLEEP_CYCLES = 2_000_000


#: the host clock at the previous phase line (``emit``)
_LAST_PHASE = [time.perf_counter()]


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase line gets ``phase_seconds``,
    the host seconds since the previous phase line (the first: since the
    script was loaded), so every phase's share of the call shows."""
    if isinstance(obj, dict) and "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_seconds": now - _LAST_PHASE[0]}
        _LAST_PHASE[0] = now
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


def forward_launches() -> dict:
    """flash_attn's forward launches since the last ``reset_launches``, by
    variant (every one of ``ops.VARIANTS``), as the wrapper counted them
    where it launched each kernel."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import ops as attn_ops

    return {kind: common.LAUNCHES.get(f"flash_attn_{kind}", 0)
            for kind in attn_ops.VARIANTS}


def counted(fn, names) -> tuple[object, dict]:
    """``fn()`` once under ``torch.profiler``: its result, and the launches
    of each kernel whose name holds one of ``names`` that the card ran in
    it (what ran, not what a wrapper chose).  A warm-up step of small
    launches opens the trace and is discarded, since a trace's first
    launches can go unrecorded (``device_profile``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        x = torch.zeros(1, device="cuda")
        for _ in range(32):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return out, {n: sum(e.count for e in ev if n in e.key) for n in names}


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
                "device_ms_from": "profiler",
                "device_ms_by_kernel": {
                    short_name(key): ms / count
                    for key, (ms, count) in prof.items()
                    if any(n in key for n in names)}, **out}
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
    # the fp32 register-tiled variant's edges (64-query, 64-key tiles):
    # ragged last tiles, Sq < Sk end-aligned, unmasked cross Sq > Sk, a
    # window inside one key tile, rep 1 to 8, hd 8 and hd % 16 == 8, hd 128
    # (its largest shared memory), the queries around TILED_MIN_QUERIES,
    # and row 6c's timed call
    ("fp32 causal 1,024, danube heads", (1, 32, 8, 1024, 1024, 80),
     torch.float32, True, None),
    ("fp32 hd 8, rep 8, window 7 inside one key tile",
     (1, 16, 2, 130, 130, 8), torch.float32, True, 7),
    ("fp32 hd 72, rep 4, window 20, ragged S", (2, 8, 2, 200, 200, 72),
     torch.float32, True, 20),
    ("fp32 hd 128, rep 1, window, Sq 77 < Sk 201", (1, 4, 4, 77, 201, 128),
     torch.float32, True, 50),
    ("fp32 hd 112, rep 2, acausal window", (1, 4, 2, 100, 150, 112),
     torch.float32, False, 20),
    ("fp32 cross Sq 300 > Sk 170, hd 128", (1, 8, 2, 300, 170, 128),
     torch.float32, False, None),
    ("fp32 Sq one below TILED_MIN_QUERIES over 900 keys",
     (2, 32, 8, TILED_MIN_QUERIES - 1, 900, 80), torch.float32, True, None),
    ("fp32 Sq at TILED_MIN_QUERIES over 900 keys, window",
     (2, 32, 8, TILED_MIN_QUERIES, 900, 80), torch.float32, True, 256),
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
    # the warpgroup variant's edges (bf16, hd 64 to 128 by 16, at least
    # WGMMA_MIN_QUERIES queries): each head dim (80 and 128 above), the
    # queries around the edge over a 900-key cache, ragged query tiles, a
    # window inside one key tile (above), unmasked cross Sq > Sk
    ("hd 64, rep 1, causal, Sq 300", (1, 4, 4, 300, 300, 64), torch.bfloat16,
     True, None),
    ("hd 96, rep 4, window, Sq 333", (1, 8, 2, 333, 333, 96), torch.bfloat16,
     True, 100),
    ("hd 112, rep 8, causal, Sq 200 < Sk 456", (1, 16, 2, 200, 456, 112),
     torch.bfloat16, True, None),
    ("Sq one below WGMMA_MIN_QUERIES over 900 keys",
     (2, 32, 8, WGMMA_MIN_QUERIES - 1, 900, 80), torch.bfloat16, True, None),
    ("Sq at WGMMA_MIN_QUERIES over 900 keys",
     (2, 32, 8, WGMMA_MIN_QUERIES, 900, 80), torch.bfloat16, True, None),
    ("Sq one above WGMMA_MIN_QUERIES over 900 keys",
     (2, 32, 8, WGMMA_MIN_QUERIES + 1, 900, 80), torch.bfloat16, True, 256),
    ("cross Sq 300 > Sk 170, hd 128", (1, 8, 2, 300, 170, 128),
     torch.bfloat16, False, None),
    ("the vlm cross call, Sq 2048 > Sk 1600", (1, 32, 8, 2048, 1600, 128),
     torch.bfloat16, False, None),
)
#: the fp32 forward variants: the first port and its register-tiled redesign
FP32_FORWARDS = ("simt", "simt_tiled")
#: the forward variants whose main-path launches the run counts by variant
#: (a main path that launched one needs its row in the kernels line)
FORWARD_LINES = ("mma", "wgmma") + FP32_FORWARDS
#: the fp32 forward's timed calls (phase timing; ``--attn-fwd`` times the
#: first two): (label, (B, Hq, Hkv, Sq, Sk, hd), causal, window, reps,
#: plain reps, the variant whose kernels-line row it is): row 6c's causal
#: 1,024 x 1,024 at danube's heads, phase lm_train (c)'s fp32 layer, and a
#: decode step of the reduced fp32 configs that phase lm_families (e)
#: serves (4 slots over a full 128-entry cache, hd 16, rep 2)
FP32_TIMED = (
    ("causal 1,024", (1, 32, 8, 1024, 1024, 80), True, None, 20, 5, None),
    ("lm_train (c) layer", (2, 32, 8, 8192, 8192, 80), True, 4096, 3, 2,
     "simt_tiled"),
    ("reduced decode", (4, 4, 2, 1, 128, 16), False, None, 200, 20, "simt"))
#: rows that see no key (Sq > Sk under a causal mask: the first Sq - Sk
#: queries sit before key 0), called on the cuda flavor directly (the
#: public wrapper refuses Sq > Sk under a mask): (B, Hq, Hkv, Sq, Sk, hd)
ATTN_NO_KEY_CASES = ((1, 8, 2, 100, 40, 80), (1, 8, 2, 300, 40, 128))

#: flash_attn_bwd cases of phase ``kernels``, each in fp32 and in bf16:
#: (label, (B, Hq, Hkv, Sq, Sk, hd), causal, window).  The families train at
#: hd 64 (musicgen, zamba2), 80 (danube), 112 (kimi-k2) and 128 (minitron,
#: command-r, olmoe, vlm); 96, which none trains at, is the fifth width
#: ``"wgmma"`` takes
ATTN_BWD_CASES = (
    ("hd 64, rep 1, causal, ragged S", (1, 4, 4, 300, 300, 64), True, None),
    ("hd 80, rep 4, window: danube's heads", (1, 32, 8, 1000, 1000, 80), True,
     256),
    ("hd 112, rep 4, causal", (1, 8, 2, 200, 200, 112), True, None),
    ("hd 128, rep 1, window", (2, 4, 4, 257, 257, 128), True, 64),
    ("hd 128, rep 4, cross Sq 300 > Sk 170", (1, 8, 2, 300, 170, 128), False,
     None),
    ("hd 80, rep 4, window, Sq 77 < Sk 201", (2, 8, 2, 77, 201, 80), True, 50),
    ("hd 64, rep 4, acausal window", (1, 8, 2, 100, 150, 64), False, 20),
    ("hd 72, depth padded to 80", (1, 4, 1, 130, 130, 72), True, None),
    ("hd 8, window 7", (1, 2, 1, 40, 40, 8), True, 7),
    ("hd 128, one query row", (1, 4, 4, 1, 33, 128), True, None),
    ("hd 96, rep 4, window, ragged S", (1, 8, 2, 300, 300, 96), True, 128),
)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def forced_variant(ops, kind: str, choice: str = "variant"):
    """Make a family's wrapper run the variant ``kind`` for a while (its
    ``choice`` function: ``variant``, or flash_attn's ``bwd_variant`` for
    the backward): how a redesigned kernel's predecessor is timed beside
    it, in the same call."""
    saved = getattr(ops, choice)
    setattr(ops, choice, lambda *shape: kind)
    try:
        yield
    finally:
        setattr(ops, choice, saved)


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
            "ptxas": usage, "spills": ptxas_spills(reports)}


def ptxas_spills(reports: dict[str, str]) -> dict[str, list]:
    """Each kernel that spills, from ``ptxas -v``'s report of every source:
    ``[function, spill store bytes, spill load bytes]``."""
    out = {}
    for name, text in reports.items():
        fn = None
        for ln in text.splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                out.setdefault(name, []).append(
                    [fn, int(m.group(1)), int(m.group(2))])
    return out


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


#: the paper's news and rcv1 (Table 3) at full size; K is paper_dataset's
#: pad width (``data/synthetic.py:paper_dataset``: min(max_nnz, 6 x avg))
NEWS = dict(n=19_996, d=1_355_191, avg_nnz=454.99, k=2_729)
RCV1 = dict(n=677_399, d=47_236, avg_nnz=73.16, k=438)
#: rows of the paper profile's datasets (``benchmarks/common.py``)
PAPER_ROWS = 16_384


def wide_dataset(dev, n: int, d: int, avg_nnz: float, k: int,
                 seed: int = 0, full_first: bool = False):
    """A padded-ELL ``(ELLMatrix, y)`` of ``n`` rows drawn on the card with
    ``synthetic.make_sparse``'s profile: log-normal row lengths around
    ``avg_nnz`` nonzeros clipped to [1, k], Zipfian feature popularity over
    d (an inverse-CDF draw over 1/rank), N(0, 1) values, value-0 padding
    at index 0, and labels planted by w* ~ N(0, 1/rank) with 5% flipped.
    ``make_sparse`` draws row by row on the host, which takes hours at
    news's width; here a feature may repeat within a row.  Rows are drawn
    in blocks, so the float64 draws stay small.  ``full_first``: the first
    row holds exactly k entries."""
    from repro_torch.core import sparse

    g = torch.Generator(device=dev).manual_seed(seed)
    nnz = torch.exp(np.log(avg_nnz) + 0.8 * torch.randn(
        n, 1, device=dev, generator=g)).clamp(1, k).long()
    if full_first:
        nnz[0] = k
    live = torch.arange(k, device=dev)[None] < nnz
    ranks = torch.arange(1, d + 1, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(1.0 / ranks, 0)
    cdf /= cdf[-1].clone()
    idx = torch.empty(n, k, device=dev, dtype=torch.int32)
    for r0 in range(0, n, 65_536):
        u = torch.rand(min(65_536, n - r0), k, device=dev, generator=g,
                       dtype=torch.float64)
        idx[r0:r0 + len(u)] = torch.searchsorted(cdf, u).clamp_(max=d - 1)
        del u
    idx *= live
    vals = torch.randn(n, k, device=dev, generator=g) * live
    del live
    w_star = torch.randn(d, device=dev, generator=g) / ranks.sqrt().float()
    y = torch.cat([torch.where((vals[r0:r0 + 65_536] * w_star[
        idx[r0:r0 + 65_536].long()]).sum(1) >= 0, 1.0, -1.0)
        for r0 in range(0, n, 65_536)])
    y[torch.rand(n, device=dev, generator=g) < 0.05] *= -1.0
    return sparse.ELLMatrix(vals, idx, d), y


def news_dataset(dev, seed: int = 0, n: int = NEWS["n"]):
    """news (full size unless ``n`` cuts it) drawn on the card
    (``wide_dataset``)."""
    return wide_dataset(dev, n, NEWS["d"], NEWS["avg_nnz"], NEWS["k"], seed)


#: the paper's sparse sets at their Table 3 row widths (K = max_nnz, the
#: real files' longest row, as ``data/ingest`` pads them): real-sim and news
LONG_ROWS = ("real-sim", "news")


def long_rows_dataset(dev, name: str, n: int | None = None, seed: int = 0):
    """real-sim or news (``LONG_ROWS``) at its Table 3 size, or its first
    ``n`` rows, padded to its Table 3 ``max_nnz`` (3,484 and 16,423):
    ``wide_dataset``'s draw on the card with the first row at exactly
    max_nnz entries, so the ELL is as wide as the real file's.  A draw, not
    the real file (which the repository does not hold)."""
    from repro_torch.data import synthetic

    rows, d, avg_nnz, max_nnz, _ = synthetic.PAPER_DATASETS[name]
    return wide_dataset(dev, rows if n is None else n, d, avg_nnz, max_nnz,
                        seed, full_first=True)


def rcv1_dataset(dev, seed: int = 0):
    """rcv1 at full size drawn on the card (``wide_dataset``)."""
    return wide_dataset(dev, RCV1["n"], RCV1["d"], RCV1["avg_nnz"],
                        RCV1["k"], seed)


#: glm_sgd's grid kernel cases of ``wide_kernel_checks``: (d, micro-batch,
#: rows, replicas); ragged tails at 16, 3 and 64, a batch past a fill (64:
#: streamed twice), three replicas, news's width
GRID_CASES = ((65_537, 1, 300, 1), (100_000, 1, 203, 1), (100_000, 16, 150, 3),
              (140_000, 3, 101, 1), (100_000, 64, 130, 1),
              (1_355_191, 1, 64, 1), (1_355_191, 10, 45, 1))
#: glm_sparse's hot kernel cases: (label, d, K, rows, replicas)
SPARSE_HOT_CASES = (("rcv1 width", 47_236, 438, 2_003, 1),
                        ("rcv1 width R=3", 47_236, 438, 700, 3),
                        ("news width", 1_355_191, 2_729, 500, 1),
                        ("d=100,000", 100_000, 200, 1_500, 1),
                        ("d=300,000", 300_000, 600, 1_500, 1),
                        ("one past the smem cap", 29_025, 69, 2_003, 1))


def wide_kernel_checks(dev) -> tuple[list[dict], dict]:
    """glm_sgd's grid kernel and glm_sparse's hot kernel against their
    plain versions on the card, LR and SVM (whose margins past 1 give pulls
    of 0): the grid kernel at GRID_CASES and five calls' bits at news's
    width; the hot kernel at SPARSE_HOT_CASES, as drawn, with the
    padding spread through each row, with every 7th row all padding and
    with one feature three times in every row, and the refusal of an index
    outside [0, d).
    Returns the cases and the worst error by family."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    cases, worst = [], {"glm_sgd": 0.0, "glm_sparse": 0.0}

    def record(kernel, label, out, ref, tol):
        err, ok = close(out, ref, tol)
        cases.append({"kernel": kernel, "case": label, "max_abs_err": err,
                      "tol": tol, "ok": ok})
        worst[kernel] = max(worst[kernel], err)

    g = torch.Generator(device=dev).manual_seed(28)
    for d, mb, n, reps in GRID_CASES:
        X = torch.randn(reps, n, d, device=dev, generator=g)
        y = torch.where(torch.rand(reps, n, device=dev, generator=g) < 0.5,
                        -1.0, 1.0)
        W = torch.randn(reps, d, device=dev, generator=g) * 0.1
        kind = sgd_ops.variant(d, mb, reps)
        for task in ("lr", "svm"):
            record("glm_sgd", f"{task} d={d} mb={mb} R={reps} per={n} {kind}",
                   K.glm_sgd_epoch(task, W, X, y, step=1.0 / d,
                                   micro_batch=mb),
                   glm_sgd_epoch_ref(task, W, X, y, 1.0 / d, mb), EPOCH_TOL)
        if (d, mb) == (1_355_191, 1):
            cases.append({"kernel": "glm_sgd",
                          "case": f"news width N={n} mb=1 {kind}: five calls "
                                  "give the same bits",
                          "ok": same_bits(lambda: K.glm_sgd_epoch(
                              "lr", W, X, y, step=1.0 / d, micro_batch=1))})
        del X
    for label, d, k, n, reps in SPARSE_HOT_CASES:
        v, i, w = _wide_ell_inputs(n * reps, d, k, dev, seed=k)
        y = torch.where(torch.arange(n * reps, device=dev) % 3 == 0, -1.0, 1.0)
        W = w[None] * torch.linspace(-1.0, 1.0, reps, device=dev)[:, None]
        kind = sparse_ops.variant(d, k, reps)
        for edge in ("", "padding spread", "rows of all padding",
                     "a feature thrice a row"):
            ve, ie = v.clone(), i.clone()
            if edge == "padding spread":
                cols = torch.randperm(k, device=dev, generator=g)
                ve, ie = ve[:, cols].contiguous(), ie[:, cols].contiguous()
            elif edge == "rows of all padding":
                ve[::7], ie[::7] = 0.0, 0
            elif edge:
                ve[:, -3:], ie[:, -3:] = 1.0, 5
            vr, ir, yr = (ve.reshape(reps, n, k), ie.reshape(reps, n, k),
                          y.reshape(reps, n))
            for task in ("lr", "svm"):
                record("glm_sparse", f"{task} {label} n={n} d={d} K={k} "
                       f"R={reps} {edge or 'as drawn'} {kind}",
                       K.ell_glm_grad(task, W, vr, ir, yr),
                       ell_glm_grad_ref(task, W, vr, ir, yr), GRAD_TOL)
        if label == "rcv1 width":
            for j in (-1, d):
                bad = ie.clone()
                bad[5, 0] = j
                try:
                    K.ell_glm_grad("lr", w, ve, bad, y)
                    refused = False
                except ValueError:
                    refused = True
                cases.append({"kernel": "glm_sparse",
                              "case": f"index {j} with d={d} refused ({kind})",
                              "ok": refused})
    torch.cuda.synchronize()
    return cases, worst


#: glm_sgd's rows variant cases of ``dense_kernel_checks``: (d, micro-batch,
#: rows a replica, replicas).  Batches just past the warp kernel's ring at
#: d = 54, 300 and 1,024 (C = 2, 16, 32 values a lane), covtype's 1,024 and
#: 4,096 (fills of a block's run streamed twice), a ragged tail shorter
#: than the cluster (some blocks' runs empty), a width that is no power of
#: two (1,000), d = 3 and 1 (32-row tiles a chain warp), 8 and 10
#: replicas, and full partitions (one batch a replica: R = 10 x 410 and x
#: 5,810, a run streamed in 6 fills)
ROWS_CASES = ((54, 600, 4100, 1), (54, 1024, 4100, 1), (54, 4096, 9000, 1),
              (54, 600, 605, 1), (300, 128, 1037, 1), (300, 95, 203, 8),
              (1024, 28, 203, 8), (1024, 64, 130, 10), (1000, 100, 1037, 1),
              (3, 1024, 5000, 1), (1, 4096, 9000, 1), (54, 410, 410, 10),
              (54, 5810, 5810, 10))
#: glm_grad's wide variant cases: (d, N, block_rows).  Clusters of 1, 2, 8
#: and 16 blocks, slices that are no multiple of 4 (rows at every offset
#: from a 16-byte boundary), a ragged last tile, fewer rows than a tile,
#: tiles of 1, 2 and 3 rows (a butterfly of 1, 2 and 4), the widest slice
#: (4,096)
WIDE_CASES = ((1_025, 4_099, None), (2_048, 1_000, None), (2_049, 777, 1),
              (4_097, 517, None), (4_097, 517, 3), (20_958, 2_003, None),
              (20_958, 300, 2),
              (50_001, 333, None), (60_000, 2_003, None), (65_536, 300, None),
              (30_000, 3, None))


def dense_kernel_checks(dev) -> tuple[list[dict], dict]:
    """glm_sgd's rows variant and glm_grad's wide variant against their
    plain versions on the card, LR and SVM: the rows kernel at ROWS_CASES
    within EPOCH_TOL, the wide kernel at WIDE_CASES within GRAD_TOL, each
    variant's five calls giving the same bits (the rows kernel at
    covtype's width, mini-batch 1,024 and at 10 replicas; the wide kernel
    at d = 60,000), and the wide kernel's predecessor (the row kernel) at
    d = 60,000 forced.  Returns the cases and the worst error by family."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref

    cases, worst = [], {"glm_sgd": 0.0, "glm_grad": 0.0}

    def record(kernel, label, out, ref, tol):
        err, ok = close(out, ref, tol)
        cases.append({"kernel": kernel, "case": label, "max_abs_err": err,
                      "tol": tol, "ok": ok})
        worst[kernel] = max(worst[kernel], err)

    g = torch.Generator(device=dev).manual_seed(32)
    for d, mb, n, reps in ROWS_CASES:
        X = torch.randn(reps, n, d, device=dev, generator=g)
        y = torch.where(torch.rand(reps, n, device=dev, generator=g) < 0.5,
                        -1.0, 1.0)
        W = torch.randn(reps, d, device=dev, generator=g) * 0.1
        kind = sgd_ops.variant(d, mb, reps)
        plan = sgd_ops.rows_plan(d, mb, reps)
        for task in ("lr", "svm"):
            record("glm_sgd", f"{task} d={d} mb={mb} R={reps} per={n} {kind} "
                   f"plan={list(plan)}",
                   K.glm_sgd_epoch(task, W, X, y, step=0.05, micro_batch=mb),
                   glm_sgd_epoch_ref(task, W, X, y, 0.05, mb), EPOCH_TOL)
        cases.append({"kernel": "glm_sgd", "case": f"d={d} mb={mb} R={reps} "
                      f"{kind}", "ok": kind == "rows"})
    for reps, n, mb in ((1, 20_000, 1024), (10, 5_810, 5_810)):
        X = torch.randn(reps, n, 54, device=dev, generator=g)
        y = torch.where(torch.rand(reps, n, device=dev, generator=g) < 0.5,
                        -1.0, 1.0)
        W = torch.randn(reps, 54, device=dev, generator=g) * 0.1
        cases.append({"kernel": "glm_sgd",
                      "case": f"d=54 mb={mb} R={reps} per={n} "
                              f"{sgd_ops.variant(54, mb, reps)}: five calls "
                              "give the same bits",
                      "ok": same_bits(lambda: K.glm_sgd_epoch(
                          "lr", W, X, y, step=0.05, micro_batch=mb))})
    for d, n, tile in WIDE_CASES:
        X = torch.randn(n, d, device=dev, generator=g)
        y = torch.where(torch.rand(n, device=dev, generator=g) < 0.5, -1.0,
                        1.0)
        w = torch.randn(d, device=dev, generator=g) * 0.1
        kind = grad_ops.variant(d, "row")
        plan = grad_ops.wide_plan(d, tile)
        for task in ("lr", "svm"):
            record("glm_grad", f"{task} n={n} d={d} block_rows={tile} {kind} "
                   f"plan={list(plan)}",
                   K.glm_grad(task, w, X, y, block_rows=tile),
                   glm_grad_ref(task, w, X, y), GRAD_TOL)
        cases.append({"kernel": "glm_grad", "case": f"d={d} {kind}",
                      "ok": kind == "wide"})
        if d == 60_000:
            cases.append({"kernel": "glm_grad",
                          "case": f"n={n} d={d} {kind}: five calls give the "
                                  "same bits",
                          "ok": same_bits(lambda: K.glm_grad("lr", w, X,
                                                             y))})
            with forced_variant(grad_ops, "row"):
                for task in ("lr", "svm"):
                    record("glm_grad", f"{task} n={n} d={d} row (forced)",
                           K.glm_grad(task, w, X, y),
                           glm_grad_ref(task, w, X, y), GRAD_TOL)
        del X
    torch.cuda.synchronize()
    return cases, worst


#: glm_sgd_sparse's live-prefix cases of ``live_kernel_checks``: (label, d,
#: K, micro-batch, rows a replica, replicas, draw).  Both Table 3 widths
#: (real-sim's K = 3,484 with the model in shared memory, news's K = 16,423
#: in global memory) and the first row past the stream kernel's; micro-
#: batches 1, 10 and 16 with ragged tails (203 at 10, 1,037 at 16, 1,100 at
#: 512), 3 replicas, a batch past a fill (512 rows: its margins and its
#: scatter staged in turns); row lengths uniform in [1, K] ("uniform":
#: ``_wide_ell_inputs``, most news rows split over fills) or drawn as the
#: paths draw them ("drawn": ``long_rows_dataset``'s profile)
LIVE_CASES = (("real-sim width", 20_958, 3_484, 1, 203, 1, "uniform"),
              ("real-sim width", 20_958, 3_484, 10, 203, 3, "uniform"),
              ("real-sim width", 20_958, 3_484, 16, 1_037, 1, "drawn"),
              ("real-sim width, a batch past a fill", 20_958, 3_484, 512,
               1_100, 1, "uniform"),
              ("news width", 1_355_191, 16_423, 1, 120, 3, "uniform"),
              ("news width", 1_355_191, 16_423, 10, 203, 1, "uniform"),
              ("news width", 1_355_191, 16_423, 1, 500, 2, "drawn"),
              ("past the stream's rows", 1_355_191, 8_200, 10, 61, 2,
               "uniform"))
#: the kernels the live-prefix kernels replaced, forced at LIVE_CASES' rows
#: of these indices
LIVE_REPLACED = {1: "smem", 4: "global"}
#: the edges each case runs: as drawn, each row's padding spread through
#: it, every 7th row all padding, one feature thrice in every row
LIVE_EDGES = ("", "padding spread", "rows of all padding",
              "a feature thrice a row")


def live_kernel_checks(dev) -> tuple[list[dict], dict]:
    """glm_sgd_sparse's live-prefix kernels against the plain version on
    the card, LR and SVM, at LIVE_CASES with each of LIVE_EDGES, within
    EPOCH_TOL; the variant each case picks; the kernels they replaced,
    forced, at LIVE_REPLACED's cases; and the length pass alone
    (``ops.live_lengths``) against its plain version on every case's
    operand.  Returns the cases and the worst error by family."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sgd_sparse.ref import (ell_sgd_epoch_ref,
                                                        live_lengths_ref)

    cases, worst = [], {"glm_sgd_sparse": 0.0}
    g = torch.Generator(device=dev).manual_seed(33)
    for at, (label, d, k, mb, n, reps, draw) in enumerate(LIVE_CASES):
        if draw == "drawn":
            m, _ = long_rows_dataset(
                dev, "real-sim" if d == 20_958 else "news", n * reps, seed=k)
            v, i = m.values, m.indices
        else:
            v, i, _ = _wide_ell_inputs(n * reps, d, k, dev, seed=k + mb)
        w = torch.randn(d, device=dev, generator=g) * 0.1
        y = torch.where(torch.arange(n * reps, device=dev) % 3 == 0, -1.0, 1.0)
        W = w[None] * torch.linspace(-1.0, 1.0, reps, device=dev)[:, None]
        kind = sparse_ops.variant(d, k, mb)
        want = "live_smem" if d == 20_958 else "live_global"
        cases.append({"kernel": "glm_sgd_sparse",
                      "case": f"{label} d={d} K={k} mb={mb}: {kind}",
                      "ok": kind == want})
        for edge in LIVE_EDGES:
            ve, ie = v, i
            if edge == "padding spread":
                cols = torch.randperm(k, device=dev, generator=g)
                ve, ie = v[:, cols].contiguous(), i[:, cols].contiguous()
            elif edge == "rows of all padding":
                ve, ie = v.clone(), i.clone()
                ve[::7], ie[::7] = 0.0, 0
            elif edge:
                ve, ie = v.clone(), i.clone()
                ve[:, :3], ie[:, :3] = 1.0, 5
            vr, ir, yr = (ve.reshape(reps, n, k), ie.reshape(reps, n, k),
                          y.reshape(reps, n))
            kinds = [kind] + ([LIVE_REPLACED[at]] if at in LIVE_REPLACED
                              and not edge else [])
            for forced in kinds:
                with forced_variant(sparse_ops, forced):
                    for task in ("lr", "svm"):
                        out = K.ell_sgd_epoch(task, W, vr, ir, yr, step=0.05,
                                              micro_batch=mb)
                        ref = ell_sgd_epoch_ref(task, W, vr, ir, yr, 0.05, mb)
                        err, ok = close(out, ref, EPOCH_TOL)
                        cases.append({
                            "kernel": "glm_sgd_sparse",
                            "case": f"{task} {label} n={n} d={d} K={k} "
                                    f"mb={mb} R={reps} {draw} "
                                    f"{edge or 'as drawn'} {forced}"
                                    f"{'' if forced == kind else ' (forced)'}",
                            "max_abs_err": err, "tol": EPOCH_TOL, "ok": ok})
                        worst["glm_sgd_sparse"] = max(
                            worst["glm_sgd_sparse"], err)
            lengths = sparse_ops.live_lengths(vr)
            cases.append({"kernel": "glm_sgd_sparse",
                          "case": f"{label} K={k} {draw} {edge or 'as drawn'}:"
                                  " live lengths",
                          "mean_live": float(lengths.float().mean()),
                          "ok": torch.equal(lengths, live_lengths_ref(vr))})
        del v, i
    torch.cuda.synchronize()
    return cases, worst


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
    # live_global variant past the stream's longest row (more of its cases:
    # ``live_kernel_checks``)
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
    attn_cases, worst["flash_attn"] = attention_forward_checks(dev)
    cases += attn_cases
    bwd_cases, worst["flash_attn_bwd"] = _attention_backward_checks(dev)
    cases += bwd_cases
    # the redesigns past the shapes above: glm_sgd's grid kernel and
    # glm_sparse's hot kernel
    wide_cases, wide_worst = wide_kernel_checks(dev)
    dense_cases, dense_worst = dense_kernel_checks(dev)
    live_cases, live_worst = live_kernel_checks(dev)
    cases += wide_cases + dense_cases + live_cases
    for name, err in [*wide_worst.items(), *dense_worst.items(),
                      *live_worst.items()]:
        worst[name] = max(worst.get(name, 0.0), err)
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


def attn_variants_taking(dtype, sq, rep, hd) -> list[str]:
    """The forward variants that take a call, the one ``ops.variant``
    picks first: in fp32 ``"simt"`` and ``"simt_tiled"`` take every call;
    in bf16 ``"mma"`` takes every call, ``"wgmma"`` its WGMMA_HEAD_DIMS at
    any Sq, ``"decode"`` fewer than 16 rows (``Sq * rep``)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops

    picked = attn_ops.variant(dtype, sq, rep, hd)
    if dtype == torch.float32:
        return [picked] + [k for k in FP32_FORWARDS if k != picked]
    kinds = ((["wgmma"] if hd in attn_ops.WGMMA_HEAD_DIMS else []) + ["mma"]
             + (["decode"] if sq * rep < attn_ops.MMA_MIN_ROWS else []))
    return [picked] + [k for k in kinds if k != picked]


def close_stats(out: torch.Tensor, ref: torch.Tensor,
                tol: dict) -> tuple[float, bool]:
    """``close`` for a log-sum-exp: +inf (a row that sees no key) must be
    +inf in both, and counts 0 to the error."""
    inf = torch.isinf(ref)
    same = bool((torch.isinf(out) == inf).all() and (out[inf] == ref[inf]).all())
    err, ok = close(torch.where(inf, 0.0, out), torch.where(inf, 0.0, ref),
                    tol)
    return err, ok and same


def attention_forward_checks(dev) -> tuple[list[dict], float]:
    """flash_attn's forward against its plain version, distinct kv heads
    throughout (each drawn on its own, so a kernel that read kv head
    h % Hkv rather than h // rep would show): every ATTN_CASES case in every
    variant that takes it (``attn_variants_taking``; the others forced by
    ``forced_variant``), the output at ATTN_TOL (fp32) or ATTN_BF16_TOL
    (bf16), and the training path's statistics through the operator
    (``repro_torch::flash_attn`` asked for them; ``"decode"`` writes none,
    so such a call runs ``"mma"`` and is not checked again): the
    log-sum-exp (``close_stats``) and, for bf16, the output to 16 bits,
    ``out + out_lo`` (fp32: an empty ``out_lo``), at the output's
    tolerance; rows that see no key (ATTN_NO_KEY_CASES: 0 and +inf);
    a query chunk over a prefix of a longer cache (a head stride past
    Sk * hd), read in place; decode over a cache prefix; and the same bits
    call after call (the decode kernel's chunk merge five times, the wgmma
    and fp32 tiled kernels three).  Returns the cases and the worst output
    error of a picked variant."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    fwd = torch.ops.repro_torch.flash_attn
    cases, worst = [], 0.0

    def check(label, kinds, q, k, v, causal, window, call=None):
        """``label``'s call in each of ``kinds`` against the plain
        version (``call``: the forward under test, the public wrapper by
        default)."""
        nonlocal worst
        tol = ATTN_TOL if q.dtype == torch.float32 else ATTN_BF16_TOL
        ref, ref_lse, ref_lo = attention_ref(q, k, v, causal=causal,
                                             window=window, with_lse=True)
        for kind in kinds:
            with forced_variant(attn_ops, kind):
                out = (call or (lambda: K.flash_attention(
                    q, k, v, causal=causal, window=window)))()
                err, ok = close(out, ref, tol)
                case = {"kernel": "flash_attn", "case": f"{label} {kind}",
                        "variant": kind, "picked": kind == kinds[0],
                        "max_abs_err": err, "tol": tol}
                # the training path's forward: the statistics too
                o, lse, lo = fwd(q, k, v, causal, window, None, None, True)
                lse_err, lse_ok = close_stats(lse, ref_lse, tol)
                case["lse_max_abs_err"] = lse_err
                if q.dtype == torch.bfloat16:
                    hi_err, hi_ok = close(o.float() + lo.float(),
                                          ref.float() + ref_lo.float(), tol)
                    case["out16_max_abs_err"] = hi_err
                else:  # fp32 has no rounding residual
                    hi_ok = lo.shape == (*q.shape[:3], 0)
                ok = ok and lse_ok and hi_ok
            case["ok"] = ok
            if kind == kinds[0]:
                worst = max(worst, err)
            cases.append(case)

    for n, (label, shape, dtype, causal, window) in enumerate(ATTN_CASES):
        q, k, v = _attn_inputs(shape, dtype, dev, seed=100 + n)
        b, hq, hkv, sq, sk, hd = shape
        check(f"{label} {list(shape)} {dtype} causal={causal} "
              f"window={window}", attn_variants_taking(dtype, sq, hq // hkv,
                                                       hd),
              q, k, v, causal, window)
    # rows that see no key: the l == 0 guard gives 0, and the log-sum-exp
    # +inf; the cuda flavor called directly, in every variant
    for n, shape in enumerate(ATTN_NO_KEY_CASES):
        b, hq, hkv, sq, sk, hd = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _attn_inputs(shape, dtype, dev, seed=98 + n)
            kinds = [kd for kd in attn_variants_taking(dtype, sq, hq // hkv,
                                                       hd) if kd != "decode"]
            check(f"rows that see no key, Sq={sq} > Sk={sk} hd {hd} {dtype}",
                  kinds, q, k, v, True, None,
                  call=lambda: attn_ops._flash_attn_cuda(
                      q, k, v, causal=True, window=None))
            for kind in kinds:
                with forced_variant(attn_ops, kind):
                    out, lse, _ = attn_ops._flash_attn_cuda(
                        q, k, v, causal=True, window=None, lse=True)
                cases.append({
                    "kernel": "flash_attn", "variant": kind,
                    "case": f"the {sq - sk} rows before key 0 are 0 and "
                            f"their log-sum-exp +inf, hd {hd} {dtype} ({kind})",
                    "ok": bool((out[:, :, :sq - sk] == 0).all()
                               and torch.isinf(lse[:, :, :sq - sk]).all())})
    # a query chunk over a prefix of a longer cache, read in place: the
    # kernels get a kv head stride of 1,024 rows for 700 keys
    q, kc, vc = _attn_inputs((2, 32, 8, 200, 1024, 80), torch.bfloat16, dev,
                             seed=96)
    kp, vp = kc[:, :, :700], vc[:, :, :700]
    assert attn_ops._kv_operand(kp)[1] == 1024 * 80
    check("query chunk of 200 over the first 700 of 1,024 cached keys",
          attn_variants_taking(torch.bfloat16, 200, 4, 80), q, kp, vp, True,
          None)
    # decode's call: the first 77 rows of a 128-row cache, read in place;
    # and the decode kernel's merge of chunks, in chunk order, gives the
    # same bits on every call
    q, kc, vc = _attn_inputs((4, 32, 8, 1, 128, 80), torch.bfloat16, dev, 99)
    check("decode over a cache prefix, 77 of 128 rows",
          attn_variants_taking(torch.bfloat16, 1, 4, 80), q, kc[:, :, :77],
          vc[:, :, :77], False, None)
    q, k, v = _attn_inputs((4, 32, 8, 1, 4096, 80), torch.bfloat16, dev, 97)
    cases.append({"kernel": "flash_attn",
                  "case": "decode Sk=4096: five calls give the same bits",
                  "ok": same_bits(lambda: K.flash_attention(q, k, v,
                                                            causal=False))})
    # the wgmma kernel has no atomics: the same bits, statistics too
    q, k, v = _attn_inputs((1, 32, 8, 2048, 1600, 128), torch.bfloat16, dev,
                           95)
    with forced_variant(attn_ops, "wgmma"):
        same = same_bits(lambda: torch.cat(
            [t.flatten().float() for t in fwd(q, k, v, False, None, None,
                                              None, True)]), calls=3)
    cases.append({"kernel": "flash_attn", "variant": "wgmma",
                  "case": "the vlm cross call: three calls of the wgmma "
                          "kernel give the same bits (out, lse, out_lo)",
                  "ok": same})
    # nor has the fp32 register-tiled kernel: the same bits, lse too
    q, k, v = _attn_inputs((2, 32, 8, 1000, 1000, 80), torch.float32, dev, 94)
    with forced_variant(attn_ops, "simt_tiled"):
        same = same_bits(lambda: torch.cat(
            [t.flatten() for t in fwd(q, k, v, True, 256, None, None,
                                      True)[:2]]), calls=3)
    cases.append({"kernel": "flash_attn", "variant": "simt_tiled",
                  "case": "fp32 window 256: three calls of the tiled "
                          "kernel give the same bits (out, lse)",
                  "ok": same})
    return cases, worst


def _grads(fn) -> torch.Tensor:
    """``fn``'s gradients ``(dq, dk, dv)`` as one flat tensor."""
    return torch.cat([g.flatten() for g in fn()])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The RMS of a - b over the RMS of b."""
    a, b = a.float(), b.float()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def bwd_variants_taking(dtype, hd) -> list[str]:
    """The backward variants that take ``dtype`` at head dim ``hd``, the one
    ``ops.bwd_variant`` picks first (fp32 has one; in bf16 the first
    design ``"mma"`` takes every hd, ``"wgmma"`` its WGMMA_HEAD_DIMS)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops

    picked = attn_ops.bwd_variant(dtype, hd)
    if dtype == torch.float32:
        kinds = ["simt_tiled"]
    else:
        kinds = (["wgmma"] if hd in attn_ops.WGMMA_HEAD_DIMS else []) + ["mma"]
    return [picked] + [k for k in kinds if k != picked]


def _attention_backward_checks(dev) -> tuple[list[dict], float]:
    """The attention backward (the operator ``repro_torch::flash_attn_bwd``
    on CUDA tensors, fed the forward operator's output, log-sum-exp and
    rounding residual) against the plain backward, in the variant
    ``ops.bwd_variant`` picks for each case and, forced, in the other
    variant that takes its dtype and head dim (``bwd_variants_taking``: the
    first design ``"mma"`` beside ``"wgmma"``): fp32 at ATTN_TOL against
    ``attention_bwd_ref`` in fp32, bf16 within BWD_BF16_REL of each
    gradient's largest value against the fp32 yardstick
    (``attention_bwd_ref`` on fp32 copies of the same bf16 inputs: the
    limit the plain bf16 backward is held to) and, in the picked variant,
    each gradient's error within BWD_PLAIN_RATIO times the plain bf16
    backward's (max-based; the RMS ratio recorded beside); and the picked
    variant's five calls give the same bits on every case.  Returns the
    cases and the worst fp32 error of a picked variant."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_bwd_ref

    bwd = torch.ops.repro_torch.flash_attn_bwd
    fwd = torch.ops.repro_torch.flash_attn
    cases, worst = [], 0.0
    for n, (label, shape, causal, window) in enumerate(ATTN_BWD_CASES):
        q, k, v = _attn_inputs(shape, torch.float32, dev, seed=400 + n)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(500 + n))
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v, do)]
            out, lse, lo = fwd(*x[:3], causal, window, None, None, True)
            ref = attention_bwd_ref(*(t.float() for t in x), causal=causal,
                                    window=window)
            if dtype == torch.bfloat16:
                mine = attention_bwd_ref(*x, causal=causal, window=window)
                plain = [_rel(a, b) for a, b in zip(mine, ref)]
                plain_rms = [_rms(a, b) for a, b in zip(mine, ref)]
            kinds = bwd_variants_taking(dtype, shape[-1])
            for kind in kinds:
                with forced_variant(attn_ops, kind, "bwd_variant"):
                    got = bwd(*x, out, lse, lo, causal, window)
                    same = kind == kinds[0] and same_bits(lambda: _grads(
                        lambda: bwd(*x, out, lse, lo, causal, window)))
                case = {"kernel": "flash_attn_bwd",
                        "case": f"{label} {list(shape)} {dtype} "
                                f"causal={causal} window={window} {kind}",
                        "variant": kind, "picked": kind == kinds[0]}
                if kind == kinds[0]:
                    case["five_calls_same_bits"] = same
                if dtype == torch.float32:
                    errs = [close(a, b, ATTN_TOL) for a, b in zip(got, ref)]
                    if kind == kinds[0]:
                        worst = max([worst] + [e for e, _ in errs])
                    case.update(max_abs_err=[e for e, _ in errs],
                                tol=ATTN_TOL,
                                ok=all(ok for _, ok in errs))
                else:
                    rel = [_rel(a, b) for a, b in zip(got, ref)]
                    ratio = [a / b for a, b in zip(rel, plain)]
                    case.update(
                        rel_err=rel, plain_rel_err=plain,
                        ratio_to_plain=ratio,
                        rms_ratio_to_plain=[_rms(a, b) / c for a, b, c in
                                            zip(got, ref, plain_rms)],
                        rel_limit=BWD_BF16_REL,
                        ok=max(rel) <= BWD_BF16_REL and (
                            kind != kinds[0]
                            or max(ratio) <= BWD_PLAIN_RATIO))
                    if kind == kinds[0]:
                        case["ratio_limit"] = BWD_PLAIN_RATIO
                case["ok"] = bool(case["ok"] and (same or kind != kinds[0]))
                cases.append(case)
    return cases, worst


#: the step of covtype's dense mini-batch paths past the warp kernel's ring
#: (``SyncSGD(batch=1024)``, ``AsyncLocalSGD(replicas=10, local_batch=per)``:
#: glm_sgd's rows variant), from the study's grid (1e-3, 1e-2, 1e-1); both
#: take the batch's mean gradient, and their losses fall under each
COVTYPE_BATCH_STEP = 0.1


def main_path(covtype, w8a, n: int | None = None):
    """The eight strategies of the training path, as (label, problem,
    strategy, sparse_data).  ``n`` cuts both datasets to their first n
    rows."""
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
        *dense_batch_paths(X, yd),
    ]


def dense_batch_paths(X, yd):
    """covtype's two dense paths past the warp kernel's ring, as main_path's
    entries: ``SyncSGD(batch=1024)`` (568 updates an epoch, the last over
    the 404-row tail) and ``AsyncLocalSGD(replicas=10, local_batch=per)``
    (one mean update a replica an epoch, then the merge)."""
    from repro_torch.core import glm, sgd

    problem = glm.GLMProblem("lr", X, yd, COVTYPE_BATCH_STEP)
    return [("covtype", problem, sgd.SyncSGD(batch=1024), False),
            ("covtype", problem, sgd.AsyncLocalSGD(
                replicas=10, local_batch=X.shape[0] // 10), False)]


def path_variants(problem, strat, sparse_data) -> dict[str, str]:
    """The variant each kernel family runs on a training path's shapes (the
    wrappers' own ``ops.variant``)."""
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops

    if sparse_data:
        m = problem[1]
        n, d, k = m.shape[0], m.d, m.values.shape[1]
    else:
        (n, d), k = problem.X.shape, None
    reps = getattr(strat, "replicas", 1)
    per = n // reps
    batch = (strat.batch or n) if isinstance(strat, sgd.SyncSGD) \
        else strat.local_batch
    if batch >= per:
        return ({"glm_sparse": sparse_grad_ops.variant(d, k, reps)}
                if sparse_data else
                {"glm_grad": grad_ops.variant(d, "row")} if reps == 1 else
                {"glm_sgd": sgd_ops.variant(d, batch, reps)})
    return ({"glm_sgd_sparse": sparse_ops.variant(d, k, batch)} if sparse_data
            else {"glm_sgd": sgd_ops.variant(d, batch, reps)})


def path_line(family: str, kind: str) -> str:
    """The kernels line's name of a family's variant."""
    return STUDY_LINE.get((family, kind), f"{family}_{kind}")


#: real-sim's Table 3 width stored dense, at the ``paper`` profile's
#: 16,384-row cap (1.373 GB of fp32): ``SyncSGD()`` past the ring kernel's
#: 1,024 features, on glm_grad's wide variant
DENSE_WIDE = dict(n=PAPER_ROWS, d=20_958)
#: ``SyncSGD()``'s full-batch step on it, over N (it multiplies the sum
#: gradient): X^T X / N of unit-normal rows peaks near (1 + sqrt(d / N))^2
#: = 4.54, so the mean-gradient step 0.5 stays under the LR loss's 1 / L
DENSE_WIDE_STEP = 0.5


def dense_wide_dataset(dev, n: int = DENSE_WIDE["n"],
                       d: int = DENSE_WIDE["d"], seed: int = 0):
    """``(X, y)``: ``n`` unit-normal rows of ``d`` features drawn on the
    card from a seeded generator, labels planted as
    ``synthetic.make_dense`` plants them (the sign of X w* with w* ~ N(0,
    1), 5% flipped); a host draw of 343 M normals would take a minute."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(n, d, device=dev, generator=g)
    w_star = torch.randn(d, device=dev, generator=g)
    y = torch.where(X @ w_star >= 0, 1.0, -1.0)
    y[torch.rand(n, device=dev, generator=g) < 0.05] *= -1.0
    return X, y


def dense_wide_path(X, y):
    """``SyncSGD()`` on the dense wide set (or its first rows), as
    ``main_path``'s entries: the full-batch step DENSE_WIDE_STEP / N."""
    from repro_torch.core import glm, sgd

    return [("dense wide", glm.GLMProblem("lr", X, y,
                                          DENSE_WIDE_STEP / X.shape[0]),
             sgd.SyncSGD(), False)]


#: the rows phase parity cuts the main paths' datasets to
PARITY_ROWS = 4_100


def falling(losses: np.ndarray) -> bool:
    """Finite, lower at the end than at the start, and no epoch rising by
    more than 0.1% over the one before."""
    return bool(np.isfinite(losses).all() and losses[-1] < losses[0]
                and (losses[1:] <= losses[:-1] * (1 + 1e-3)).all())


#: the kernels of the training path (the serving path adds glm_score)
TRAIN_KERNELS = ("glm_grad", "glm_sgd", "glm_sgd_sparse", "glm_sparse")


def train_runs(paths, epochs: int) -> tuple[list, list, dict]:
    """Each of ``paths`` (``main_path``'s entries) through ``sgd.run``,
    launch counts zeroed just before each run and read just after, by the
    variant the run's shapes pick.  Returns the runs' lines, their results
    and the launches by kernels-line name."""
    from repro_torch.core import sgd
    from repro_torch.kernels import common

    runs, results, launches = [], [], {}
    for data, problem, strat, sparse_data in paths:
        common.reset_launches()
        res = sgd.run(problem, strat, epochs, sparse_data=sparse_data)
        variants = path_variants(problem, strat, sparse_data)
        counts = {path_line(family, kind): common.LAUNCHES.get(family, 0)
                  for family, kind in variants.items()}
        for name, count in counts.items():
            _count(launches, name, count)
        results.append(res)
        runs.append({"data": data, "strategy": res.strategy,
                     "n": (problem[1].shape if sparse_data else problem.X.shape)[0],
                     "step": problem[3], "losses": res.losses.tolist(),
                     "ms_per_epoch": res.time_per_epoch * 1e3,
                     "epoch_ms": (res.epoch_times * 1e3).tolist(),
                     "variants": variants, "launches": counts,
                     "falling": falling(res.losses)})
    return runs, results, launches


def phase_train(covtype, w8a, epochs: int, dense_wide
                ) -> tuple[dict, dict, list]:
    """The main path at full size and ``SyncSGD()`` on the dense wide set
    (``train_runs``: launch counts zeroed just before each run and read
    just after, by the variant the run's shapes pick).  Returns the phase
    line, the launches by kernels-line name and the runs' results."""
    from repro_torch.core import convergence, sgd

    paths = main_path(covtype, w8a) + dense_wide_path(*dense_wide)
    runs, results, launches = train_runs(paths, epochs)
    # every kernel of the path ran on the variant its shapes pick: covtype's
    # gradient on glm_grad's ring variant, its B=16 and r8 b1 epochs on
    # glm_sgd's warp variant, its B=1,024 and r10 full-partition epochs on
    # the rows variant, the dense wide gradient on glm_grad's wide variant,
    # w8a's sparse epoch on glm_sgd_sparse's warp variant and its gradients
    # (R = 1 and 10) on glm_sparse's smem variant
    want = {"glm_grad_ring", "glm_grad_wide", "glm_sgd", "glm_sgd_rows",
            "glm_sgd_sparse_warp", "glm_sparse_smem"}
    ok = all(r["falling"] for r in runs) and set(launches) == want and \
        all(launches.values()) and [r["variants"] for r in runs[-3:]] == [
            {"glm_sgd": "rows"}, {"glm_sgd": "rows"}, {"glm_grad": "wide"}]
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
    for run, (_, problem, strat, sparse_data) in zip(runs, paths):
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
            "launches": launches, "ok": ok}, launches, results


def phase_parity(paths, n: int, epochs: int) -> dict:
    """The strategies of ``paths`` (``main_path``'s entries at ``n`` rows):
    kernels vs plain versions on the card."""
    from repro_torch.core import sgd
    from repro_torch.kernels import common

    runs = []
    for data, problem, strat, sparse_data in paths:
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
#: SyncSGD()'s full-batch step on news and rcv1, over N (it multiplies the
#: sum gradient): under 4 / lambda_max(X^T X) / N of the Zipfian draws,
#: whose hottest feature holds about 31 entries of a news row (rcv1: 6.5)
NEWS_SYNC_STEP = 0.05


def phase_news(news, rcv1, epochs: int) -> tuple[dict, dict]:
    """news at full size through ``sgd.run`` under Table 7's two async
    configurations (glm_sgd_sparse's stream variant: the model is 5.4 MB a
    replica) and under ``SyncSGD()`` (glm_sparse's full-batch gradient),
    and rcv1 at full size (677,399 x 47,236, K = 438) under ``SyncSGD()``,
    launch counts zeroed just before each run and read just after; then
    every run on the first NEWS_CUT rows through the kernels and through
    the plain versions on the card, loss for loss.  Returns the phase line
    and the launches by kernels-line name."""
    from repro_torch.core import sgd, sparse
    from repro_torch.kernels import common
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops

    configs = [("news", news, sgd.AsyncLocalSGD(replicas=r, local_batch=1))
               for r in NEWS_REPLICAS]
    configs += [("news", news, sgd.SyncSGD()), ("rcv1", rcv1, sgd.SyncSGD())]
    runs, launches = [], {"glm_sgd_sparse_stream": 0, "glm_sparse_hot": 0}
    for label, (m, y), strat in configs:
        n, k = m.values.shape
        sync = isinstance(strat, sgd.SyncSGD)
        step = NEWS_SYNC_STEP / n if sync else NEWS_STEP
        fam, kind = (("glm_sparse", sparse_grad_ops.variant(m.d, k, 1)) if sync
                     else ("glm_sgd_sparse", sparse_ops.variant(m.d, k, 1)))
        common.reset_launches()
        t0 = time.perf_counter()
        res = sgd.run(("lr", m, y, step), strat, epochs, sparse_data=True)
        count = common.LAUNCHES[fam]
        launches[f"{fam}_{kind}"] = launches.get(f"{fam}_{kind}", 0) + count
        updates = 1 if sync else n // strat.replicas
        runs.append({"data": label, "shape": [n, m.d, k],
                     "strategy": res.strategy, "step": step,
                     "variant": f"{fam} {kind}", "launches": count,
                     "updates_per_epoch": updates,
                     "ms_per_epoch": res.time_per_epoch * 1e3,
                     "epoch_ms": (res.epoch_times * 1e3).tolist(),
                     "us_per_update": None if sync else
                     res.time_per_epoch * 1e6 / updates,
                     "losses": res.losses.tolist(),
                     "falling": falling(res.losses),
                     "wall_s": time.perf_counter() - t0})
    parity = []
    for (label, (m, y), strat), r in zip(configs, runs):
        cut = (sparse.ELLMatrix(m.values[:NEWS_CUT], m.indices[:NEWS_CUT], m.d),
               y[:NEWS_CUT])
        problem = ("lr", *cut, r["step"])
        kern = sgd.run(problem, strat, epochs, sparse_data=True)
        with common.plain_versions():
            plain = sgd.run(problem, strat, epochs, sparse_data=True)
        err, ok = close(torch.from_numpy(kern.losses),
                        torch.from_numpy(plain.losses), LOSS_TOL)
        parity.append({"data": label, "strategy": kern.strategy,
                       "rows": NEWS_CUT,
                       "kernel_losses": kern.losses.tolist(),
                       "plain_losses": plain.losses.tolist(),
                       "max_abs_err": err, "ok": ok})
    ok = (all(r["falling"] for r in runs) and all(p["ok"] for p in parity)
          and [r["variant"] for r in runs] == [
              "glm_sgd_sparse stream"] * len(NEWS_REPLICAS)
          + ["glm_sparse hot"] * 2
          and all(r["launches"] == epochs for r in runs))
    return {"phase": "news", "news_shape": list(news[0].values.shape),
            "rcv1_shape": list(rcv1[0].values.shape),
            "ell_mb": {"news": nbytes(news[0].values, news[0].indices) / 1e6,
                       "rcv1": nbytes(rcv1[0].values, rcv1[0].indices) / 1e6},
            "epochs": epochs, "runs": runs, "launches": launches,
            "parity_cut": NEWS_CUT, "parity": parity, "ok": ok}, launches


#: real-sim's step on its mini-batch and async paths at its Table 3 row
#: width (``SyncSGD(batch=16)``, ``AsyncLocalSGD(8, 1)`` and ``(10, 10)``):
#: news's NEWS_STEP; each takes the batch's mean gradient, and the plain
#: versions' losses fell under it (and under 0.05) on the CPU on the first
#: 2,000 and 8,000 rows of ``long_rows_dataset``'s draw
REALSIM_STEP = 0.01
#: ``SyncSGD()``'s full-batch step on it, over N: under 4 / lambda_max(X^T
#: X) / N of the Zipfian draw, whose hottest feature holds about 6.7
#: entries of a row (1 / H(20,958) of about 71)
REALSIM_SYNC_STEP = 0.2
#: the epochs of each set's paths, and the rows the plain versions rerun
#: them on (a cut holds every variant: the first row keeps K)
LONG_ROWS_EPOCHS = {"real-sim": 4, "news": 3}
LONG_ROWS_CUT = {"real-sim": PARITY_ROWS, "news": NEWS_CUT}


def long_rows_paths(name: str, data) -> list:
    """The paths of one set of ``LONG_ROWS`` (``long_rows_dataset``) as
    ``main_path``'s entries: real-sim under ``SyncSGD()`` (glm_sparse's smem
    variant), ``SyncSGD(batch=16)``, ``AsyncLocalSGD(8, 1)`` and
    ``AsyncLocalSGD(10, 10)`` (glm_sgd_sparse's live_smem variant); news
    under Table 7's ``AsyncLocalSGD(8, 1)`` and ``(64, 1)`` (live_global)
    and ``SyncSGD()`` (glm_sparse's hot variant)."""
    from repro_torch.core import sgd

    m, y = data
    n = m.shape[0]
    if name == "real-sim":
        return [(name, ("lr", m, y, REALSIM_SYNC_STEP / n), sgd.SyncSGD(),
                 True),
                (name, ("lr", m, y, REALSIM_STEP), sgd.SyncSGD(batch=16),
                 True),
                *[(name, ("lr", m, y, REALSIM_STEP),
                   sgd.AsyncLocalSGD(replicas=r, local_batch=b), True)
                  for r, b in ((8, 1), (10, 10))]]
    return [*[(name, ("lr", m, y, NEWS_STEP),
               sgd.AsyncLocalSGD(replicas=r, local_batch=1), True)
              for r in NEWS_REPLICAS],
            (name, ("lr", m, y, NEWS_SYNC_STEP / n), sgd.SyncSGD(), True)]


#: the variant each path of ``long_rows_paths`` runs, in order
LONG_ROWS_VARIANTS = {
    "real-sim": [{"glm_sparse": "smem"}]
    + [{"glm_sgd_sparse": "live_smem"}] * 3,
    "news": [{"glm_sgd_sparse": "live_global"}] * 2 + [{"glm_sparse": "hot"}]}


def phase_long_rows(sets: dict) -> tuple[dict, dict]:
    """real-sim and news at their Table 3 row widths (``sets``: name ->
    ``long_rows_dataset``) through ``sgd.run``, ``long_rows_paths`` with
    LONG_ROWS_EPOCHS, launch counts zeroed just before each run and read
    just after (``train_runs``: one launch an epoch), with us per update;
    then each path on its set's first LONG_ROWS_CUT rows through the
    kernels and through the plain versions on the card, loss for loss
    (``phase_parity``).  Returns the phase line and the launches by
    kernels-line name."""
    from repro_torch.core import sgd, sparse

    runs, parity, launches = [], [], {}
    ok = True
    for name, (m, y) in sets.items():
        epochs = LONG_ROWS_EPOCHS[name]
        got, _, counts = train_runs(long_rows_paths(name, (m, y)), epochs)
        for r, (_, problem, strat, _) in zip(
                got, long_rows_paths(name, (m, y))):
            if isinstance(strat, sgd.SyncSGD) and strat.batch is None:
                continue
            reps = getattr(strat, "replicas", 1)
            batch = strat.batch if isinstance(strat, sgd.SyncSGD) \
                else strat.local_batch
            r["updates_per_epoch"] = -(-(r["n"] // reps) // batch)
            r["us_per_update"] = r["ms_per_epoch"] * 1e3 / \
                r["updates_per_epoch"]
        for line, count in counts.items():
            _count(launches, line, count)
        ok = ok and [r["variants"] for r in got] == LONG_ROWS_VARIANTS[name] \
            and all(r["falling"] for r in got) and all(
                c == epochs for r in got for c in r["launches"].values())
        runs += got
        cut = LONG_ROWS_CUT[name]
        line = phase_parity(long_rows_paths(name, (sparse.ELLMatrix(
            m.values[:cut], m.indices[:cut], m.d), y[:cut])), cut, epochs)
        parity += [{**r, "rows": cut} for r in line["runs"]]
        ok = ok and line["ok"]
    return {"phase": "long_rows",
            "shapes": {name: [m.shape[0], m.d, m.values.shape[1]]
                       for name, (m, _) in sets.items()},
            "live_entries": {name: int((m.values != 0).sum())
                             for name, (m, _) in sets.items()},
            "ell_gb": {name: nbytes(m.values, m.indices) / 1e9
                       for name, (m, _) in sets.items()},
            "runs": runs, "launches": launches, "parity_cut": LONG_ROWS_CUT,
            "parity": parity, "ok": ok}, launches


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
#: rows of each dataset of the ci profile in (a): its 2,048 cut to 1,024
#: to hold the full call within its time (the plain pass took 129 s of
#: 1,083 in PR 32's first full call); the claim checks pass at both
STUDY_CI_ROWS = 1_024


def _study_drivers(dev, plain: bool) -> tuple[dict, dict, dict]:
    """The ci profile's drivers, its datasets cut to STUDY_CI_ROWS rows, on a
    fresh runner with a store that records every trial and a trial cache
    of the pass's own, empty at its start (as
    the drivers run with one: Fig. 22's trials are Table 7's and Table 4's,
    so they run once a pass); returns the rows by driver, the store's
    trials and the wall seconds by driver."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.kernels import common
    from repro_torch.study.runner import Runner
    from repro_torch.study.store import StudyStore

    store = StudyStore()            # never written: held in memory
    rows, seconds = {}, {}
    profile = bcommon.PROFILES["ci"]
    bcommon.PROFILES["ci"] = {**profile, "max_n": STUDY_CI_ROWS}
    try:
        with tempfile.TemporaryDirectory(prefix="study-cache-") as cache, \
                common.plain_versions() if plain else \
                contextlib.nullcontext():
            bcommon.RUNNER = Runner(cache_dir=cache, store=store, device=dev)
            for name in STUDY_DRIVERS:
                t0 = time.perf_counter()
                rows[name] = importlib.import_module(
                    f"repro_torch.benchmarks.{name}").run("ci")
                torch.cuda.synchronize()
                seconds[name] = time.perf_counter() - t0
    finally:
        bcommon.PROFILES["ci"] = profile
    return rows, store.trials, seconds


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
              ("glm_grad", "wide"): "glm_grad_wide",
              ("glm_sgd", "warp"): "glm_sgd",
              ("glm_sgd", "rows"): "glm_sgd_rows",
              ("glm_sgd", "cluster"): "glm_sgd_cluster",
              ("glm_sgd", "grid"): "glm_sgd_grid",
              ("glm_sgd_sparse", "warp"): "glm_sgd_sparse_warp",
              ("glm_sparse", "smem"): "glm_sparse_smem",
              ("glm_sparse", "hot"): "glm_sparse_hot"}
#: the lines (b) launches: covtype, w8a and real-sim
STUDY_FULL_LINES = {"glm_grad_ring", "glm_sgd", "glm_sgd_cluster",
                    "glm_sgd_sparse_warp", "glm_sparse_smem"}
#: (c): the paper profile's datasets that no other phase runs through the
#: study (``benchmarks/common.py`` PROFILES["paper"]), and the variants
#: their paths take: Table 4's seq epoch and SyncSGD()'s gradient
STUDY_PAPER = {"rcv1": {"glm_sgd_seq": "cluster", "glm_sparse": "hot"},
               "news": {"glm_sgd_seq": "grid", "glm_sparse": "hot"}}


def _final(res) -> float:
    """A run's final loss, inf where it is not finite."""
    last = float(res.losses[-1])
    return last if np.isfinite(last) else float("inf")


def _count(into: dict, line: str, n: int) -> None:
    into[line] = into.get(line, 0) + n


def _table4_paths(table4_sync, ds, task: str) -> dict:
    """Table 4's execution paths on ``ds`` (the driver's ``_sync_paths`` at
    its step 1e-3), with whether the composition path's 3 steps stayed
    finite: its exp(-margin) / (1 + exp(-margin)) is inf / inf once a
    margin passes -88, which the driver's step reaches at full size."""
    from repro_torch.core import glm

    t = table4_sync._sync_paths(ds, task, 1e-3)
    X, y = table4_sync.dense_operands(ds)
    wc = torch.zeros(X.shape[1], device=X.device)
    for _ in range(3):
        wc = wc - 1e-3 * glm.grad_primitive_composition(task, wc, X, y)
    rows = X.shape[0]
    del X, y
    return {"rows_timed": rows, "t_iter_sync_ms": t["sync"] * 1e3,
            "t_iter_comp_ms": t["sync-comp"] * 1e3,
            "t_iter_seq_ms": t["seq"] * 1e3,
            "speedup_fused_vs_comp": t["sync-comp"] / t["sync"],
            "speedup_sync_vs_seq": t["seq"] / t["sync"],
            "paths_statistically_identical": t["_path_equiv"],
            "composition_finite": bool(torch.isfinite(wc).all())}


def _held_epochs(problem, epochs: int) -> tuple[float, bool]:
    """A ``SyncSGD()`` run of ``problem`` (sparse) held epoch by epoch: each
    epoch through the kernels and through the plain versions from the same
    model (the kernels' run so far), their losses within LOSS_TOL.  At the
    tuner's larger steps the full-batch runs diverge to losses in the
    millions, where a margin's last bit, summed in another order, compounds
    from epoch to epoch; from the same model each epoch's error shows where
    it arises.  Returns the largest difference and whether all held."""
    from repro_torch.core import sgd
    from repro_torch.kernels import common

    state, epoch_fn, loss_fn, _ = sgd.make_epoch_fn(
        problem, sgd.SyncSGD(), sparse_data=True)
    kern, plain = [], []
    for _ in range(epochs):
        with common.plain_versions():
            plain.append(float(loss_fn(epoch_fn(state))))
        state = epoch_fn(state)
        kern.append(float(loss_fn(state)))
    return close(torch.tensor(kern), torch.tensor(plain), LOSS_TOL)


def _study_paper(dev) -> tuple[dict, dict]:
    """(c): rcv1 (the study's own loader, ``benchmarks.common.load("rcv1",
    "paper")``: 16,384 rows, d = 47,236, pad 438) and news (16,384 rows
    drawn on the card, ``news_dataset``: ``make_sparse`` takes hours at
    its width), LR and SVM: Table 4's three paths (fused, comp, seq), then
    ``sgd.run`` under ``SyncSGD()`` at each of the tuner's steps for the
    profile's 30 epochs, launch counts zeroed just before each run and read
    just after; every SyncSGD() run again on the first NEWS_CUT rows, held
    loss for loss to the plain versions epoch by epoch (``_held_epochs``).
    Returns the part's line and its launches by kernels-line name."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.benchmarks import table4_sync
    from repro_torch.core import convergence, sgd, sparse
    from repro_torch.data.synthetic import Dataset
    from repro_torch.kernels import common
    from repro_torch.study.runner import Runner

    profile = bcommon.PROFILES["paper"]
    bcommon.RUNNER = Runner(cache_dir=None, device=dev)
    t0 = time.perf_counter()
    rcv1 = bcommon.load("rcv1", "paper")
    torch.cuda.synchronize()
    seconds = {"rcv1": time.perf_counter() - t0}
    t0 = time.perf_counter()
    m, y = news_dataset(dev, n=profile["max_n"])
    news = Dataset("news", None, m, y, m.d, dense=False)
    torch.cuda.synchronize()
    seconds["news"] = time.perf_counter() - t0
    rows, launches = [], {}
    for ds in (rcv1, news):
        variants = _study_variants(ds)
        k = ds.ell.max_nnz
        for task in bcommon.TASKS:
            common.reset_launches()
            paths = _table4_paths(table4_sync, ds, task)
            t4 = {f: common.LAUNCHES[f] for f in TRAIN_KERNELS}
            _count(launches, STUDY_LINE[("glm_sgd", variants["glm_sgd_seq"])],
                   t4["glm_sgd"])
            cut = (sparse.ELLMatrix(ds.ell.values[:NEWS_CUT],
                                    ds.ell.indices[:NEWS_CUT], ds.d),
                   ds.y[:NEWS_CUT])
            sync_runs = []
            for step in STUDY_STEPS:
                common.reset_launches()
                res = sgd.run((task, ds.ell, ds.y, step), sgd.SyncSGD(),
                              profile["epochs"], sparse_data=True)
                counts = {f: common.LAUNCHES[f] for f in TRAIN_KERNELS}
                _count(launches,
                       STUDY_LINE[("glm_sparse", variants["glm_sparse"])],
                       counts["glm_sparse"])
                err, held = _held_epochs((task, *cut, step),
                                         profile["epochs"])
                sync_runs.append((step, res, counts, err, held))
            target = convergence.thresholds(convergence.optimal_loss(
                r for _, r, _, _, _ in sync_runs), (0.01,))[0.01]
            # the tuner's pick: the lowest final loss
            best = min(sync_runs, key=lambda r: _final(r[1]))
            rows.append({
                "dataset": ds.name, "task": task, "n": ds.n, "d": ds.d,
                "k": k, "variants": variants, "table4": paths,
                "table4_launches": t4,
                "sync": [{"step": step, "ms_per_epoch":
                          res.time_per_epoch * 1e3,
                          "final_loss": float(res.losses[-1]),
                          "finite": bool(np.isfinite(res.losses).all()),
                          "epochs_to_1pct": res.epochs_to(target),
                          "launches": counts, "cut_max_abs_err": err,
                          "cut_held": held}
                         for step, res, counts, err, held in sync_runs],
                "best_step": best[0],
                "iters_to_1pct": best[1].epochs_to(target),
                "time_to_1pct_s": best[1].time_to(target)})
    ok = all(
        r["variants"]["glm_sgd_seq"] == STUDY_PAPER[r["dataset"]]["glm_sgd_seq"]
        and r["variants"]["glm_sparse"] == STUDY_PAPER[r["dataset"]][
            "glm_sparse"]
        and r["table4_launches"]["glm_sgd"] > 0
        and r["table4"]["speedup_sync_vs_seq"] >= 1.0
        and (r["table4"]["paths_statistically_identical"]
             or not r["table4"]["composition_finite"])
        and all(s["finite"] and s["cut_held"]
                and s["launches"]["glm_sparse"] == profile["epochs"]
                for s in r["sync"])
        for r in rows)
    return {"profile": "paper", "datasets": {
        ds.name: {"n": ds.n, "d": ds.d, "k": ds.ell.max_nnz,
                  "seconds": seconds[ds.name]} for ds in (rcv1, news)},
        "steps": list(STUDY_STEPS), "epochs": profile["epochs"],
        "parity_cut": NEWS_CUT, "tol": LOSS_TOL, "rows": rows,
        "launches": launches, "ok": ok}, launches


def phase_study(dev) -> tuple[dict, dict]:
    """The paper's study layer on the card.  (a) The port's Table 7, Table 4
    and Fig. 22 drivers on the ci profile through the kernels, then again
    through the plain versions: every trial's losses within LOSS_TOL, and
    the same best step and epochs to 1% on every row; the claim checks on
    both.  (b) covtype, w8a and real-sim at their full Table 3 sizes
    through ``tuner.tune_many``: Table 7's four configurations and
    ``SyncSGD()`` (LR, the ci grid, 12 epochs), each row with its
    launches by family; Table 4's execution paths on each dataset.
    Launch counts are zeroed just before (b) and read just after.  (c) the
    paper profile's rcv1 and news (``_study_paper``).  Returns the phase
    line and (b)'s and (c)'s launches by kernel-line name."""
    from repro_torch.benchmarks import table4_sync, table7_async
    from repro_torch.core import convergence, sgd
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
          "launches": ci_launches, "kernels_s": sum(kern_s.values()),
          "plain_s": sum(plain_s.values()), "plain_s_by_driver": plain_s,
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
        paths = _table4_paths(table4_sync, ds, "lr")
        seq = common.LAUNCHES["glm_sgd"] - before
        _count(study_launches,
               STUDY_LINE[("glm_sgd", variants["glm_sgd_seq"])], seq)
        table4.append({"dataset": name, "task": "lr", "n": ds.n, **paths,
                       "seq_variant": variants["glm_sgd_seq"],
                       "seq_launches": seq})
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
        and set(study_launches) == STUDY_FULL_LINES
        and all(r["finite"] for r in rows)
        and all(r["fell"] for r in rows if r["config"] != "sync")
        and all(r["speedup_sync_vs_seq"] >= 1.0 and (
            r["paths_statistically_identical"] or not r["composition_finite"])
            for r in table4))
    del runner, data
    paper, paper_launches = _study_paper(dev)
    for line, n in paper_launches.items():
        _count(study_launches, line, n)
    return {"phase": "study", "ci": ci, "full": full, "paper": paper,
            "ok": ci["ok"] and full["ok"] and paper["ok"]}, study_launches


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
               fp32: torch.Tensor, atol: float = 0.0) -> dict:
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
    own size (about 5).  ``atol``: a floor under the limit, for a scalar
    whose plain path can land on the fp32 value by chance (LOSS_ATOL)."""
    err = float((out.float() - plain.float()).abs().max())
    floor = float((plain.float() - fp32.float()).abs().max())
    mine = float((out.float() - fp32.float()).abs().max())
    return {"max_abs_err": err, "bf16_vs_fp32_max_abs_err": floor,
            "kernel_vs_fp32_max_abs_err": mine, "slack": BF16_MODEL_SLACK,
            "atol": atol,
            "ok": bool(mine <= max(BF16_MODEL_SLACK * floor, atol)
                       and torch.isfinite(out).all())}


def _lm_profile(fn, ticks: int, count: tuple[str, ...] = ()) -> dict:
    """Where a decode tick's time goes, from one profiled call of ``fn``
    (``ticks`` ticks): host ops by self CPU time, aten calls (nested ones
    included), kernel launches, and device kernels by device time (kernel
    events only: an op's device time repeats its kernels'), each per
    tick; and the launches of each kernel named in ``count`` over the
    call."""
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
                        / ticks, e.count / ticks] for e in dev[:8]],
        "launches_by_kernel": {n: sum(e.count for e in dev if n in e.key)
                               for n in count}}


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
    ``decode`` kernel) and the prefill forward's by variant (``wgmma``)."""
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
           "flash_attn_variant": attn_ops.variant(cfg.param_dtype, 1, rep,
                                                  cfg.hd),
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
        by_variant = forward_launches()
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
    prefill = {"B": 1, "S": LM_PREFILL, "window": cfg.window,
               "wall_s": prefill_s, "plain_wall_s": plain_s,
               "flash_attn_launches": prefill_launches,
               "flash_attn_launches_by_variant": by_variant,
               "hidden_shape": list(h.shape),
               "cache_shape": list(cache["k"].shape),
               "hidden_max_abs": float(h.abs().max()), **held,
               "ok": bool(all(x["ok"] for x in held.values())
                          and prefill_launches == cfg.n_layers
                          and by_variant["wgmma"] == cfg.n_layers)}
    ok = bool(run["device"].startswith("cuda") and run["done"] == len(reqs)
              and all(r.done for r in reqs) and run["tokens_in_range"]
              and launches == run["expected_launches"] > 0
              and run["flash_attn_variant"] == "decode"
              and run["vs_plain"]["ok"] and prefill["ok"])
    return {"phase": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
            "window": cfg.window, "dtype": str(cfg.param_dtype),
            "serve": run, "prefill": prefill, "ok": ok}, launches, \
        by_variant


# ---------------------------------------------------------------------------
# The LM training path
# ---------------------------------------------------------------------------

#: the runs of phase ``lm_train``, as ``repro_torch.launch.train`` takes them:
#: full-width danube at twice its window, the reference's default optimizer.
#: Over 4 steps the fresh batches' losses are ruled by how hard each batch
#: is at the initial weights (10.8625 to 10.8808 for the first four), not by
#: training (+0.006 at lr 4 after 4 steps; ``--lm-train-probe``, PERF.md
#: §6), so the runs take TRAIN_STEPS: at lr 4 the loss of step 5 is 0.13
#: below step 0's and of step 7 0.23 below
TRAIN_LR = 4.0
TRAIN_STEPS = 8
TRAIN_ARGV = ["--arch", "h2o-danube-1.8b", "--batch", "2", "--seq", "8192",
              "--steps", str(TRAIN_STEPS), "--optimizer", "sgd",
              "--lr", str(TRAIN_LR)]
TRAIN_ASYNC = ["--update", "async", "--replicas", "2", "--merge-every", "2"]
#: the restart run: the reduced config, one injected failure
TRAIN_RESTART = ["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "8",
                 "--inject-failure-at", "2"]
#: the fp32 gradient check's depth (full width): the ``simt`` kernel
TRAIN_FP32_LAYERS = 2
#: the backward alone in bf16 against autograd through the plain forward:
#: max |error| over max |gradient|.  Its products round S, P, dP and dS to
#: bf16 (2^-9 each); measured 0.0047-0.0062 (2^-7.3 at most) on the card at
#: danube's shape and on the CPU at the tests' shapes
BWD_BF16_REL = 2 ** -6
#: the picked bf16 backward's largest error, each gradient, at most this
#: times the plain bf16 backward's on the same inputs (the worst ratio of
#: the first design, ``"mma"``, over phase kernels' cases on the card)
BWD_PLAIN_RATIO = 1.09


#: the floor under the training loss's limit (``_held_bf16``'s ``atol``):
#: the loss is one scalar, the mean over the batch's tokens, and its plain
#: bf16 path's distance from fp32 lands near 0 at some seeds (9.5e-7, two
#: of the fp32 loss's ulps, at PROBE_SEEDS' (7, 107)), where 1.5 times it
#: would hold any bf16 attention to the plain path's roundings.  So the
#: floor is the largest distance from fp32 that the loss reached over
#: PROBE_SEEDS through the plain versions (1.945e-4), the first
#: tensor-core forward ``"mma"`` (2.184e-4) and SDPA's forward (2.232e-4)
#: on the card (``--lm-train-probe``, PERF.md §6); ``--attn-fwd`` drives
#: forwards wrong on purpose against it (``_loss_controls``)
LOSS_ATOL = 2.25e-4


#: the max-based rule's slack for one gradient leaf: over four seeded
#: models and batches (``--lm-train-probe``) the kernel path's max distance
#: from fp32 reached 1.52-1.75x the plain path's on one to three leaves a
#: seed, a different set each seed, and a library bf16 attention (SDPA's
#: forward, the same backward) 1.40-1.60x
BF16_GRAD_MAX_SLACK = 2.0


def _held_bf16_grad(out: torch.Tensor, plain: torch.Tensor,
                    fp32: torch.Tensor,
                    max_slack: float = BF16_GRAD_MAX_SLACK) -> dict:
    """``_held_bf16``'s rule for one gradient leaf, twice: by root-mean-square
    distance within BF16_MODEL_SLACK times the plain bf16 path's distance
    from the fp32 yardstick, and by max distance within
    BF16_GRAD_MAX_SLACK times it.  A leaf's max is one element of a few
    thousand (a norm weight has 2,560), so its ratio spreads where the RMS
    ratio does not (0.93-1.07 for both bf16 paths over the probe's seeds);
    a wrong kernel or mask shows as errors of the gradient's own size.
    ``max_slack``: the max rule's slack (the layer rule's is
    BF16_MODEL_SLACK, ``checked_attention``)."""
    def dist(a, b):
        d = a.float() - b.float()
        return float(d.abs().max()), float(d.pow(2).mean().sqrt())

    (top, floor), (top_k, mine) = dist(plain, fp32), dist(out, fp32)
    return {"rms_err": dist(out, plain)[1], "bf16_vs_fp32_rms_err": floor,
            "kernel_vs_fp32_rms_err": mine,
            "rms_ratio": mine / max(floor, 1e-30),
            "max_ratio": top_k / max(top, 1e-30),
            "slack": BF16_MODEL_SLACK, "max_slack": max_slack,
            "ok": bool(mine <= BF16_MODEL_SLACK * floor
                       and top_k <= max_slack * top
                       and torch.isfinite(out).all())}


def _fingerprint(*tensors: torch.Tensor) -> tuple:
    """Sums over each tensor's values, squares and two strided subsets:
    equal for equal bits (the reductions are deterministic), and for
    different inputs equal only by a chance that a training step's
    activations do not meet."""
    out = []
    for t in tensors:
        x = t.detach().float().flatten()
        out += [tuple(t.shape)] + torch.stack(
            [x.sum(), x.square().sum(), x[::7].sum(),
             x[3::13].abs().sum()]).tolist()
    return tuple(out)


@contextlib.contextmanager
def checked_attention():
    """Every flash_attn forward call inside the block held to the plain
    version, call by call (phase lm_train (c)): the call runs as it would
    (the kernel, or a control routed into its place by
    ``routed_attention``), then its bf16 output (the tensor the next layer
    reads) meets the layer rule on its own q, k and v, so the layers'
    inputs are never all held at once: its RMS and max distance from the
    plain version on fp32 copies of them (the yardstick) each within
    BF16_MODEL_SLACK times the plain bf16 version's (``_held_bf16_grad``).
    The plain version computes in fp32 and rounds once
    (``ref.attention_ref``), so on the call's bf16 inputs it gives the
    yardstick rounded to bf16, bit for bit: one plain call gives both
    (``tests/test_torch_kernels.py`` holds that).  The rule judges ``out``
    alone, never ``out + out_lo``: a
    routed control's ``out_lo`` makes that sum the plain version's fp32
    output.  A checkpointed recompute (a call whose q, k and v have the
    bits of one already checked, ``_fingerprint``) is held to that call's
    output bits instead of a second plain call.  Yields the list of calls'
    records, filled as they run (``_layer_summary`` reads it)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn.ref import attention_ref

    dispatch = common.dispatch
    calls, seen = [], {}

    def checked(kernel, dev, *args, **kwargs):
        res = dispatch(kernel, dev, *args, **kwargs)
        if kernel != "flash_attn":
            return res
        q, k, v = args
        out = res[0] if isinstance(res, tuple) else res
        key = _fingerprint(q, k, v)
        if key in seen:
            first, bits = seen[key]
            same = _fingerprint(out) == bits
            calls.append({"recompute_of": first, "ok": same})
            return res
        with torch.no_grad():
            fp32 = attention_ref(q.float(), k.float(), v.float(),
                                 causal=kwargs["causal"],
                                 window=kwargs["window"])
        seen[key] = (len(calls), _fingerprint(out))
        calls.append({"call": len(calls), **_held_bf16_grad(
            out, fp32.to(out.dtype), fp32, max_slack=BF16_MODEL_SLACK)})
        del fp32
        return res

    common.dispatch = checked
    try:
        yield calls
    finally:
        common.dispatch = dispatch


def _layer_summary(calls: list, layers: int) -> dict:
    """``checked_attention``'s records of one training step of ``layers``
    layers: each layer's first call held by the rule (its ratios, in call
    order), the failing layers, and each recompute's bits.  ``ok``: every
    call held, at least one checked call a layer, a call a layer for the
    forward and one for its recompute."""
    held = [c for c in calls if "call" in c]
    again = [c for c in calls if "recompute_of" in c]
    failing = [n for n, c in enumerate(held) if not c["ok"]]
    return {"calls": len(calls), "checked": len(held),
            "recomputes_same_bits": sum(c["ok"] for c in again),
            "recomputes": len(again), "failing_layers": failing,
            "rms_ratios": [c["rms_ratio"] for c in held],
            "max_ratios": [c["max_ratio"] for c in held],
            "max_rms_ratio": max((c["rms_ratio"] for c in held), default=None),
            "max_max_ratio": max((c["max_ratio"] for c in held), default=None),
            "ok": bool(not failing and all(c["ok"] for c in again)
                       and len(held) >= layers
                       and len(calls) == 2 * layers)}


def _timed_loop(loop) -> dict:
    """Wrap a ``ResilientLoop``'s step and checkpoint save to record each
    step's wall ms (host clock, ended by a synchronize), whether the
    replicas of a replica-stacked state agree after it, and the host s of
    each save (its copy to the host) and of the final wait for the
    writer."""
    rec = {"step_ms": [], "replicas_equal": [], "save_s": [], "wait_s": 0.0}
    step, save, wait = loop.step_fn, loop.ckpt.maybe_save, loop.ckpt.wait

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if len(out[0]) == 3:        # async: (params_r, opt_state_r, t)
            rec["replicas_equal"].append(all(
                torch.equal(v[0], v[1]) for v in out[0][0].values()))
        return out

    def timed_save(s, tree):
        t0 = time.perf_counter()
        saved = save(s, tree)
        if saved:
            rec["save_s"].append(time.perf_counter() - t0)
        return saved

    def timed_wait():
        t0 = time.perf_counter()
        wait()
        rec["wait_s"] += time.perf_counter() - t0

    loop.step_fn, loop.ckpt.maybe_save, loop.ckpt.wait = \
        timed_step, timed_save, timed_wait
    return rec


def _train_run(argv: list, ckpt_dir: Path) -> tuple[dict, object]:
    """One run of the launcher's objects on the card, launch counts zeroed
    just before ``loop.run`` and read just after; returns the record and
    the final state."""
    from repro_torch.kernels import common
    from repro_torch.launch import train

    args = train.parse_args(argv + ["--ckpt-dir", str(ckpt_dir)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, loop, batches = train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = _timed_loop(loop)
    common.reset_launches()
    t0 = time.perf_counter()
    state, history = loop.run(batches, args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = train.losses_of(history)
    tokens = args.batch * args.seq
    steady = statistics.median(rec["step_ms"][1:] or rec["step_ms"])
    out = {"argv": argv, "lr": args.lr, "seq": args.seq, "setup_s": setup_s,
           "wall_s": wall,
           "losses": losses,
           "fresh_batch_loss_falls": bool(losses[-1] < losses[0]),
           "restarts": sum(kind == "restart" for kind, _, _ in history),
           **rec, "steady_ms_per_step": steady,
           "tokens_per_step": tokens,
           "tokens_per_s": tokens / steady * 1e3,
           "tokens_per_s_wall": tokens * len(losses) / wall,
           "flash_attn_launches": common.LAUNCHES["flash_attn"],
           "flash_attn_launches_by_variant": forward_launches(),
           "flash_attn_bwd_launches": common.LAUNCHES["flash_attn_bwd"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "ckpt_steps": sorted(p.name for p in ckpt_dir.glob("step_*"))}
    shutil.rmtree(ckpt_dir)
    return out, (cfg, state, batches)


def _step_split(cfg, params: dict, batch: dict, lr: float,
                profile: bool = True) -> dict:
    """One sync step's wall ms (host clock, ended by a synchronize) split
    into the loss forward (grad mode: checkpointed blocks, the kernel),
    the backward (forward + backward, less the forward: each block's
    forward again, the attention backward, the rest) and the optimizer
    (update and apply); then (``profile``) one profiled forward +
    backward, device time by kernel."""
    from repro_torch.nn import transformer
    from repro_torch.optim.sgd import apply_updates, sgd
    from repro_torch.train import trainer

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def forward():
        return transformer.loss_fn(transformer.LM.from_tree(params), cfg,
                                   batch).detach()

    opt = sgd(lr)
    state = opt.init(params)
    fwd, _ = wall(forward)
    fwd_bwd, (_, grads) = wall(lambda: trainer.value_and_grad(cfg, params,
                                                              batch))

    def update():
        with torch.no_grad():
            u, _ = opt.update(grads, state, params)
            return apply_updates(params, u)

    optim, _ = wall(update)
    del grads
    out = {"forward_ms": fwd, "backward_ms": fwd_bwd - fwd,
           "optimizer_ms": optim, "forward_backward_ms": fwd_bwd,
           "step_ms": fwd_bwd + optim}
    if profile:
        prof = _lm_profile(lambda: trainer.value_and_grad(cfg, params,
                                                          batch), 1,
                           KERNEL_SYMBOLS["flash_attn_bwd"]["wgmma"])
        out["profiled_step"] = {k: prof[k] for k in (
            "device_ms_per_tick", "launches_per_tick", "device_top",
            "launches_by_kernel")}
    return out


def _grads_held(cfg, params: dict, batch: dict) -> dict:
    """One sync step's loss and every gradient leaf three ways at full
    width: through the kernel, through the plain versions in bf16, and
    through the plain versions on an fp32 copy of the weights (the
    yardstick: ``_held_bf16_grad`` for each leaf), the kernel path's every
    attention forward call held layer by layer (``checked_attention``:
    the loss and leaf rules cannot see a window one key short); then, on
    the first TRAIN_FP32_LAYERS layers in fp32, the kernels
    (``simt_tiled``'s forward, as the card ran it, and backward) against
    the plain versions at ATTN_TOL.  The loss is held by ``_held_bf16`` with
    the floor LOSS_ATOL under its limit: 1.5 times the plain path's
    distance alone passes or fails by seed for any bf16 attention
    (``--lm-train-probe``: over PROBE_SEEDS the first tensor-core forward
    and the warpgroup one each held it at about half the seeds, with the
    same per-call error, ``_attention_accuracy``)."""
    from repro_torch.kernels import common
    from repro_torch.train import trainer

    t0 = time.perf_counter()
    with checked_attention() as calls:
        loss, grads = trainer.value_and_grad(cfg, params, batch)
    torch.cuda.synchronize()
    layers = {**_layer_summary(calls, cfg.n_layers),
              "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with common.plain_versions():
        loss_p, grads_p = trainer.value_and_grad(cfg, params, batch)
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        p32 = {k: v.float() for k, v in params.items()}
        loss_32, grads_32 = trainer.value_and_grad(cfg32, p32, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    held = {k: _held_bf16_grad(grads[k], grads_p[k], grads_32[k])
            for k in grads}
    worst = max(held, key=lambda k: held[k]["max_ratio"])
    max_ratios = sorted(h["max_ratio"] for h in held.values())
    loss_held = _held_bf16(loss, loss_p, loss_32, atol=LOSS_ATOL)
    del grads, grads_p, grads_32

    # fp32 at full width, 2 layers: the simt kernel against the plain path
    keep = ("embed", "final_norm") + tuple(
        f"layers.{i}." for i in range(TRAIN_FP32_LAYERS))
    p2 = {k: v for k, v in p32.items() if k.startswith(keep)}
    cfg2 = dataclasses.replace(cfg32, n_layers=TRAIN_FP32_LAYERS)
    common.reset_launches()
    fwd_names = KERNEL_SYMBOLS["flash_attn"]["simt_tiled"]
    (l2, g2), ran = counted(lambda: trainer.value_and_grad(cfg2, p2, batch),
                            fwd_names
                            + KERNEL_SYMBOLS["flash_attn_bwd"]["simt_tiled"])
    bwd_launches = common.LAUNCHES["flash_attn_bwd"]
    by_variant = forward_launches()
    with common.plain_versions():
        l2p, g2p = trainer.value_and_grad(cfg2, p2, batch)
    # a forward and a checkpointed recompute a layer, a backward a layer
    want = {n: (2 if n in fwd_names else 1) * TRAIN_FP32_LAYERS for n in ran}
    fp32 = {"layers": TRAIN_FP32_LAYERS,
            "flash_attn_launches_by_variant": by_variant,
            "flash_attn_bwd_launches": bwd_launches,
            "kernel_launches": ran, "expected_kernel_launches": want,
            "loss": float(l2), "loss_plain": float(l2p),
            "loss_ok": close(l2, l2p, ATTN_TOL)[1], "tol": ATTN_TOL}
    errs = {k: close(g2[k], g2p[k], ATTN_TOL) for k in g2}
    fp32["grad_max_abs_err"] = max(e for e, _ in errs.values())
    fp32["grads_ok"] = all(ok for _, ok in errs.values())
    fp32["failing"] = sorted(k for k, (_, ok) in errs.items() if not ok)[:8]
    fp32["ok"] = bool(fp32["loss_ok"] and fp32["grads_ok"]
                      and bwd_launches == TRAIN_FP32_LAYERS
                      and by_variant["simt_tiled"] == 2 * TRAIN_FP32_LAYERS
                      and ran == want)
    return {"seconds_plain_ways": seconds, "leaves": len(held),
            "layers": layers,
            "loss": {"kernel": float(loss), "plain": float(loss_p),
                     "fp32": float(loss_32), **loss_held},
            "leaves_ok": sum(h["ok"] for h in held.values()),
            "max_ratio_quantiles": [max_ratios[int(q * (len(max_ratios) - 1))]
                                    for q in (0, 0.5, 0.9, 0.99, 1)],
            "max_rms_ratio": max(h["rms_ratio"] for h in held.values()),
            "max_ratio_over_1_5": {k: h["max_ratio"] for k, h in
                                   sorted(held.items())
                                   if h["max_ratio"] > BF16_MODEL_SLACK},
            "failing": sorted(k for k, h in held.items() if not h["ok"])[:8],
            "worst_leaf": {"name": worst, **held[worst]},
            "embed": held["embed"], "fp32_2_layers": fp32,
            "ok": bool(all(h["ok"] for h in held.values()) and fp32["ok"]
                       and loss_held["ok"] and layers["ok"])}


#: the fp32 backward's timed call (the kernels line's
#: ``flash_attn_bwd_simt_tiled`` row): causal 1,024 x 1,024 at danube's
#: heads, as row 6c times the forward
BWD_FP32_SHAPE = (1, 32, 8, 1024, 1024, 80)
#: the bf16 backward's timed calls at danube's layer (B=2, S=8192): its
#: window, and causal with no window (SDPA's is_causal beside it)
BWD_BF16_SHAPE = (2, 32, 8, LM_PREFILL, LM_PREFILL, 80)
BWD_BF16_MASKS = ((True, 4096), (True, None))
#: the bf16 backward's first design and redesign, timed in turns in one
#: call (fp32 has one variant)
BWD_PAIRS = {torch.bfloat16: ("mma", "wgmma"),
             torch.float32: ("simt_tiled",)}
#: products a visible pair each pass of the redesigns runs: QK^T and dO V^T
#: in both passes, dQ in the first, dV and dK in the second
BWD_PASS_PRODUCTS = {"dq_pass_ms": 3, "dkv_pass_ms": 4}
#: profiles of a timed turn at most: a trace of a few long launches can
#: hold none of them (seen in whole runs of this script on the card)
TURN_PROFILES = 4


def _bwd_work(q, k, causal, window, products: int) -> tuple[int, float]:
    """Bytes (q, k, v, do, the output, for bf16 its rounding residual, and
    its log-sum-exp read once, dq, dk, dv written once) and flops
    (``products`` products of 2 * hd operations a visible pair) of one
    attention backward."""
    b, hq, sq, hd = q.shape
    pairs = visible_pairs(sq, k.shape[2], causal, window)
    rows = 5 if q.dtype == torch.bfloat16 else 4
    return (rows * nbytes(q) + 4 * nbytes(k) + 4 * b * hq * sq,
            2.0 * products * hd * pairs * b * hq)


def sdpa_backend(*args, **kwargs) -> dict:
    """The backend ``scaled_dot_product_attention`` picks for a call, and
    the attention kernels one forward + backward of it launches."""
    from torch.nn.attention import SDPBackend

    choice = SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name
    leaves = [a.detach().requires_grad_() for a in args[:3]]

    def step():
        out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                               **kwargs)
        torch.autograd.grad(out, leaves, torch.ones_like(out))

    names = sorted({short_name(key) for key in device_profile(step, 1)
                    if re.search("attention|fmha|flash|cudnn", key, re.I)})
    return {"backend": choice, "kernels": names}


def _turns(bwd, kinds, x, out, lse, lo, causal, window) -> dict:
    """The backward in each variant of ``kinds`` (first design, redesign;
    or one variant) on the same inputs, timed in turns (first, re, re,
    first; or twice): per turn the call's ms by events and each kernel's
    device ms a call from the profiler, which gives each pass's ms (the dQ
    pass's kernel; the dK/dV pass's and, for ``"simt_tiled"``, its sum of
    the query heads' parts).  A turn profiles up to TURN_PROFILES times
    until the trace holds every launch of its calls; where none does, its
    pass times are None (means over the turns that have them)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops

    def call():
        return bwd(*x, out, lse, lo, causal, window)

    reps = 3
    runs = {kind: [] for kind in kinds}
    for kind in (*kinds, *kinds[::-1]):
        names = KERNEL_SYMBOLS["flash_attn_bwd"][kind]
        with forced_variant(attn_ops, kind, "bwd_variant"):
            run = {"ms": cuda_ms(call, 5)}
            for attempt in range(1, TURN_PROFILES + 1):
                prof = device_profile(call, reps)
                hits = {n: [(t, c) for key, (t, c) in prof.items()
                            if n in key] for n in names}
                whole = all(sum(c for _, c in h) == reps
                            for h in hits.values())
                if whole:
                    break
        run["profiles"] = attempt
        by = ({n: sum(t for t, _ in h) / reps for n, h in hits.items()}
              if whole else None)
        run.update(device_ms_by_kernel=by,
                   dq_pass_ms=by and by[names[0]],
                   dkv_pass_ms=by and sum(by[n] for n in names[1:]))
        runs[kind].append(run)

    def mean(values):
        values = [v for v in values if v is not None]
        return statistics.mean(values) if values else None

    return {kind: {"runs": r, "ms": statistics.mean(t["ms"] for t in r),
                   **{p: mean(t[p] for t in r) for p in BWD_PASS_PRODUCTS}}
            for kind, r in runs.items()}


#: the forward's timed calls, (label, (B, Hq, Hkv, Sq, Sk, hd), causal,
#: window, reps): danube's prefill (a training layer's forward at B=1),
#: the vlm cross call (llama-3.2-vision's training shape), and the other
#: attention families' training layers (phase lm_families (b), B=1)
FWD_SHAPES = (
    ("danube_prefill", (1, 32, 8, LM_PREFILL, LM_PREFILL, 80), True, 4096,
     20),
    ("vlm_cross", (1, 32, 8, 2048, 1600, 128), False, None, 50),
    ("hd64_rep1_musicgen_zamba2", (1, 32, 32, 1024, 1024, 64), True, None,
     100),
    ("hd128_rep1_olmoe", (1, 16, 16, 1024, 1024, 128), True, None, 100),
    ("hd128_rep4_vlm_self", (1, 32, 8, 2048, 2048, 128), True, None, 50))
#: the sweeps behind ``ops.variant``'s query thresholds, by dtype: the
#: first design and its redesign, a query chunk of each length over a
#: cache at danube's heads (hd 80, rep 4), causal, as (batch, keys), the
#: reps, and the threshold: WGMMA_MIN_QUERIES over 900 keys at B=2;
#: TILED_MIN_QUERIES over 1,024 keys at B=1 (the longest chunk is row
#: 6c's timed call)
FWD_SWEEPS = {
    torch.bfloat16: (("mma", "wgmma"), (16, 37, 64, 128, 256, 512), (2, 900),
                     100, "WGMMA_MIN_QUERIES", WGMMA_MIN_QUERIES),
    torch.float32: (FP32_FORWARDS, (1, 16, 64, 128, 256, 1024), (1, 1024), 50,
                    "TILED_MIN_QUERIES", TILED_MIN_QUERIES)}


def sdpa_fp32(q, k, v, causal, window) -> tuple[object, str]:
    """One ``scaled_dot_product_attention`` call on fp32 operands, the
    library's yardstick beside the fp32 kernels, and its form: the
    end-aligned mask with ``enable_gqa``, or, where its math path's
    [B, Hq, Sq, Sk] fp32 scores would pass 4 GB (17 GB at phase lm_train
    (c)'s layer), K and V repeated to the query heads once beforehand (the
    memory-efficient path then takes the mask), named with the backend
    SDPA picks."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, hq, sq, _ = q.shape
    mask = end_aligned_mask(sq, k.shape[2], causal, window, q.device)
    if 4 * b * hq * sq * k.shape[2] <= 4e9:
        args, kw = (q, k, v), {"attn_mask": mask, "enable_gqa": True}
        form = "enable_gqa"
    else:
        rep = hq // k.shape[1]
        args = (q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1))
        kw, form = {"attn_mask": mask}, "K, V repeated"
    from torch.nn.attention import SDPBackend
    backend = SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    return (lambda: sdpa(*args, **kw)), f"{form}, {backend}"


def _variant_turns(call, kinds, reps: int) -> dict:
    """``call`` in each forward variant of ``kinds`` (first design, then
    redesign) in turns (first, re, re, first): per variant the means over
    its two turns of the call's ms by events and of its kernel's device ms
    (``kernel_device_time``), with each turn's."""
    from repro_torch.kernels.flash_attn import ops as attn_ops

    turns = {kind: [] for kind in kinds}
    for kind in (*kinds, *kinds[::-1]):
        with forced_variant(attn_ops, kind):
            turns[kind].append({"ms": cuda_ms(call, reps),
                                **kernel_device_time(
                                    call, reps,
                                    KERNEL_SYMBOLS["flash_attn"][kind])})
    return {kind: {"ms": statistics.mean(t["ms"] for t in r),
                   "device_ms": statistics.mean(t["device_ms"] for t in r),
                   "turns": r} for kind, r in turns.items()}


def _forward_rows(dev) -> dict:
    """The forward at FWD_SHAPES: ``"mma"`` and ``"wgmma"`` in turns
    (``_variant_turns``) on plain tensors and through the operator asked
    for the statistics (the training path's forward), beside the variant
    ``ops.variant`` picks, SDPA's ms (its flash path where the call has no
    mask), the plain version's, the function's 2-product bound and the
    design's 3-product one (P.V twice, hi and lo); and row 6a's decode (4
    slots over 128 and 4,096 keys): ms by events and device ms, to read
    beside the backward in the same call."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    rows = {}
    for label, shape, causal, window, reps in FWD_SHAPES:
        q, k, v = _attn_inputs(shape, torch.bfloat16, dev, seed=7)
        mask = end_aligned_mask(shape[3], shape[4], causal, window, dev)
        in_bytes, flops = attn_work(q, k, causal, window)

        def call():
            return K.flash_attention(q, k, v, causal=causal, window=window)

        def with_lse():
            return torch.ops.repro_torch.flash_attn(q, k, v, causal, window,
                                                    None, None, True)

        b2, by2 = bound_ms(in_bytes, flops, BF16_FLOPS_PER_S)
        b3, by3 = bound_ms(in_bytes, 1.5 * flops, BF16_FLOPS_PER_S)
        rows[label] = {
            "shape": list(shape), "causal": causal, "window": window,
            "picked": attn_ops.variant(torch.bfloat16, shape[3],
                                       shape[1] // shape[2], shape[5]),
            "plain": _variant_turns(call, ("mma", "wgmma"), reps),
            "operator": _variant_turns(with_lse, ("mma", "wgmma"), reps),
            "sdpa_ms": cuda_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, attn_mask=mask, enable_gqa=True),
                               reps),
            "plain_version_ms": cuda_ms(lambda: attention_ref(
                q, k, v, causal=causal, window=window), 2),
            "bound_2_products_ms": b2, "bound_2_by": by2,
            "bound_3_products_ms": b3, "bound_3_by": by3}
        del q, k, v
    for label, shape, causal, window, reps in (
            ("decode_sk128", (4, 32, 8, 1, 128, 80), False, None, 200),
            ("decode_sk4096", (4, 32, 8, 1, 4096, 80), False, None, 200)):
        q, k, v = _attn_inputs(shape, torch.bfloat16, dev, seed=7)
        kind = attn_ops.variant(torch.bfloat16, shape[3],
                                shape[1] // shape[2], shape[5])

        def call():
            return K.flash_attention(q, k, v, causal=causal, window=window)

        rows[label] = {"shape": list(shape), "variant": kind,
                       "ms": cuda_ms(call, reps),
                       **kernel_device_time(call, 20,
                                            KERNEL_SYMBOLS["flash_attn"][kind])}
    return rows


def _forward_sweep(dev, dtype) -> dict:
    """The evidence for ``dtype``'s threshold in ``ops.variant``
    (FWD_SWEEPS): its first design and redesign in turns at each query
    chunk of the sweep, and the smallest chunk from which on the
    redesign's device ms is no more than the first design's at every
    longer chunk (None: not at the longest)."""
    import repro_torch.kernels as K

    (old, new), queries, (b, sk), reps, name, value = FWD_SWEEPS[dtype]
    rows = []
    for sq in queries:
        shape = (b, 32, 8, sq, sk, 80)
        q, k, v = _attn_inputs(shape, dtype, dev, seed=sq)
        turns = _variant_turns(
            lambda: K.flash_attention(q, k, v, causal=True), (old, new), reps)
        rows.append({"shape": list(shape), **{
            f"{kind}_{key}": turns[kind][key] for kind in turns
            for key in ("ms", "device_ms")}})
    edge = None
    for r in rows[::-1]:
        if r[f"{new}_device_ms"] > r[f"{old}_device_ms"]:
            break
        edge = r["shape"][3]
    return {"rows": rows, "no_slower_from": edge, name: value}


def _fp32_rows(dev) -> dict:
    """The fp32 forward at the first two of FP32_TIMED (row 6c's causal
    1,024 x 1,024 and phase lm_train (c)'s layer): ``"simt"`` and
    ``"simt_tiled"`` in turns (``_variant_turns``) on plain tensors and
    through the operator asked for the statistics (the training path's
    forward), beside the variant ``ops.variant`` picks, SDPA's ms
    (``sdpa_fp32``), the plain version's and the fp32 bound."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    rows = {}
    for label, shape, causal, window, reps, plain_reps, _ in FP32_TIMED[:2]:
        q, k, v = _attn_inputs(shape, torch.float32, dev, seed=8)
        in_bytes, flops = attn_work(q, k, causal, window)

        def call():
            return K.flash_attention(q, k, v, causal=causal, window=window)

        def with_lse():
            return torch.ops.repro_torch.flash_attn(q, k, v, causal, window,
                                                    None, None, True)

        library, form = sdpa_fp32(q, k, v, causal, window)
        bound, by = bound_ms(in_bytes, flops)
        rows[label] = {
            "shape": list(shape), "causal": causal, "window": window,
            "picked": attn_ops.variant(torch.float32, shape[3],
                                       shape[1] // shape[2], shape[5]),
            "plain": _variant_turns(call, FP32_FORWARDS, reps),
            "operator": _variant_turns(with_lse, FP32_FORWARDS, reps),
            "sdpa_ms": cuda_ms(library, reps), "sdpa_form": form,
            "plain_version_ms": cuda_ms(lambda: attention_ref(
                q, k, v, causal=causal, window=window), plain_reps),
            "bound_ms": bound, "bound_by": by}
        del q, k, v, library
        torch.cuda.empty_cache()
    return rows


def _backward_alone(dev) -> tuple[dict, list]:
    """(d) The attention backward at one layer's training shape
    (BWD_BF16_SHAPE, window 4096): autograd through ``flash_attention``
    (the forward kernel with its log-sum-exp, then the backward variant
    ``ops.bwd_variant`` picks: ``"wgmma"`` in bf16, ``"simt_tiled"`` in
    fp32) against autograd through ``ref.attention_ref`` on the same
    inputs (fp32: ATTN_TOL; bf16: BWD_BF16_REL of each gradient's largest
    value), and three calls' bits; then for the window and for causal with
    no window the first design and the redesign in turns (``_turns``),
    beside the bounds of the function's 5 products and the redesign's 7
    (each pass's 3 and 4), the plain backward and SDPA's backward (its
    forward + backward less its forward; the window by an explicit mask,
    causal by ``is_causal``; the backend each ran); then the fp32 pair at
    BWD_FP32_SHAPE the same way beside SDPA's fp32 backward; and the
    forward rows (``_forward_rows``) in the same call.  Returns the line
    and the kernels line's two rows (launches left to the caller)."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn import ref as attn_ref

    shape, (causal, window) = BWD_BF16_SHAPE, BWD_BF16_MASKS[0]
    q, k, v = _attn_inputs(shape, torch.bfloat16, dev, seed=11)
    do = torch.randn(q.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(12)
                     ).to(torch.bfloat16)

    def grads_of(fn, dtype):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, do.to(dtype))

    def kernel(*x):
        return K.flash_attention(*x, causal=causal, window=window)

    def plain(*x):
        return attn_ref.attention_ref(*x, causal=causal, window=window)

    ref32 = grads_of(plain, torch.float32)
    mine32 = grads_of(kernel, torch.float32)
    fp32_errs = [close(a, b, ATTN_TOL) for a, b in zip(mine32, ref32)]
    del mine32
    mine16 = grads_of(kernel, torch.bfloat16)
    rel = [_rel(a, b) for a, b in zip(mine16, ref32)]
    abs16 = max(float((a.float() - b).abs().max())
                for a, b in zip(mine16, ref32))
    del mine16, ref32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    bwd = torch.ops.repro_torch.flash_attn_bwd
    fwd = torch.ops.repro_torch.flash_attn
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"shape": list(shape), "bf16_variant": attn_ops.bwd_variant(
               torch.bfloat16, shape[-1]),
           "fp32_variant": attn_ops.bwd_variant(torch.float32, shape[-1]),
           "fp32_max_abs_err": [e for e, _ in fp32_errs],
           "fp32_ok": all(ok for _, ok in fp32_errs),
           "bf16_rel_err": rel, "bf16_rel_limit": BWD_BF16_REL}
    for causal, window in BWD_BF16_MASKS:
        o, lse, lo = fwd(q, k, v, causal, window, None, None, True)
        x = (q, k, v, do)
        case = {"causal": causal, "window": window}
        if window is not None:
            case["same_bits"] = same_bits(lambda: _grads(
                lambda: bwd(*x, o, lse, lo, causal, window)), calls=3)
        case["variants"] = _turns(bwd, BWD_PAIRS[torch.bfloat16], x, o, lse,
                                  lo, causal, window)
        in_bytes, flops = _bwd_work(q, k, causal, window, 5)
        case["bound_ms"], case["bound_by"] = bound_ms(in_bytes, flops,
                                                      BF16_FLOPS_PER_S)
        case["bound_7_products_ms"] = bound_ms(
            in_bytes, _bwd_work(q, k, causal, window, 7)[1],
            BF16_FLOPS_PER_S)[0]
        case["bound_9_products_ms"] = bound_ms(
            in_bytes, _bwd_work(q, k, causal, window, 9)[1],
            BF16_FLOPS_PER_S)[0]
        case["pass_bound_ms"] = {
            name: _bwd_work(q, k, causal, window, n)[1] / BF16_FLOPS_PER_S
            * 1e3 for name, n in BWD_PASS_PRODUCTS.items()}
        case["flops_5_products"] = flops
        case["plain_backward_ms"] = cuda_ms(lambda: attn_ref.attention_bwd_ref(
            q, k, v, do, causal=causal, window=window), 3)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        mask = end_aligned_mask(shape[3], shape[4], causal, window, dev)
        lib = ({"attn_mask": mask} if mask is not None and window is not None
               else {"is_causal": causal})
        case["sdpa"] = sdpa_backend(qs, ks, vs, enable_gqa=True, **lib)
        torch.cuda.reset_peak_memory_stats()
        f = cuda_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True,
                                 **lib).detach(), 3)
        fb = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qs, ks, vs, enable_gqa=True, **lib), (qs, ks, vs), do), 3)
        case["sdpa"].update(forward_ms=f, forward_backward_ms=fb,
                            backward_ms=fb - f,
                            max_memory_allocated_gb=(
                                torch.cuda.max_memory_allocated() / 1e9))
        out["window" if window else "causal"] = case
        del qs, ks, vs, mask, o, lse, lo
        torch.cuda.empty_cache()
    win = out["window"]
    new, old = BWD_PAIRS[torch.bfloat16][1], BWD_PAIRS[torch.bfloat16][0]
    out["speedup_over_first_design"] = {
        key: out[key]["variants"][old]["ms"] / out[key]["variants"][new]["ms"]
        for key in ("window", "causal")}
    rows = [{"name": "flash_attn_bwd", "line": "flash_attn_bwd_" + new,
             "variant": "/".join(KERNEL_SYMBOLS["flash_attn_bwd"][new]),
             "max_abs_err": abs16, "ms": win["variants"][new]["ms"],
             "plain_ms": win["plain_backward_ms"],
             "bound_ms": win["bound_ms"], "bound_by": win["bound_by"],
             "library_ms": win["sdpa"]["backward_ms"]}]
    del q, k, v, do
    torch.cuda.empty_cache()

    # the fp32 kernels, bound by fp32 operations outside the tensor cores
    q, k, v = _attn_inputs(BWD_FP32_SHAPE, torch.float32, dev, seed=13)
    do = torch.randn(q.shape, device=dev)
    o, lse, lo = fwd(q, k, v, True, None, None, None, True)
    ref = attn_ref.attention_bwd_ref(q, k, v, do, causal=True, window=None)
    errs = [close(a, b, ATTN_TOL) for a, b in
            zip(bwd(q, k, v, do, o, lse, lo, True, None), ref)]
    in_bytes, flops = _bwd_work(q, k, True, None, 5)
    bound32, by32 = bound_ms(in_bytes, flops)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    # SDPA's fp32 backward two ways: the explicit mask (as timed since the
    # first fp32 kernel) and is_causal; the faster is the yardstick
    sdpa32 = {}
    for form, lib in (("mask", {"attn_mask": end_aligned_mask(
            1024, 1024, True, None, dev)}), ("is_causal", {"is_causal": True})):
        f32 = cuda_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True,
                                   **lib).detach(), 5)
        fb32 = cuda_ms(lambda: torch.autograd.grad(
            sdpa(qs, ks, vs, enable_gqa=True, **lib), (qs, ks, vs), do), 5)
        sdpa32[form] = {**sdpa_backend(qs, ks, vs, enable_gqa=True, **lib),
                        "backward_ms": fb32 - f32}
    lib32 = min(r["backward_ms"] for r in sdpa32.values())
    pair = BWD_PAIRS[torch.float32]
    fp32 = {"shape": list(BWD_FP32_SHAPE),
            "max_abs_err": max(e for e, _ in errs),
            "ok": all(ok for _, ok in errs),
            "variants": _turns(bwd, pair, (q, k, v, do), o, lse, lo, True,
                               None),
            "bound_ms": bound32, "bound_by": by32,
            "plain_backward_ms": cuda_ms(lambda: attn_ref.attention_bwd_ref(
                q, k, v, do, causal=True, window=None), 5),
            "sdpa": sdpa32}
    out["fp32"] = fp32
    rows.append({"name": "flash_attn_bwd", "line": "flash_attn_bwd_" + pair[0],
                 "variant": "/".join(KERNEL_SYMBOLS["flash_attn_bwd"][pair[0]]),
                 "shape": list(BWD_FP32_SHAPE), "max_abs_err": fp32["max_abs_err"],
                 "ms": fp32["variants"][pair[0]]["ms"],
                 "plain_ms": fp32["plain_backward_ms"],
                 "bound_ms": bound32, "bound_by": by32, "library_ms": lib32})
    del qs, ks, vs, q, k, v, do, o, lse, lo
    torch.cuda.empty_cache()
    out["forward"] = _forward_rows(dev)
    for r in rows:
        r.update(route="cuda", source="src/repro_torch/kernels/csrc/"
                 "flash_attn_bwd.cu", replaces=REPLACES["flash_attn_bwd"],
                 study_launches=None)
    out["ok"] = bool(out["fp32_ok"] and max(rel) <= BWD_BF16_REL
                     and win["same_bits"] and fp32["ok"])
    return out, rows


def phase_lm_train(dev, scratch: Path) -> tuple[dict, dict, list]:
    """LM training on full-width h2o-danube-1.8b through the launcher's
    objects: (a) sync and (b) async-local runs with a compressed merge, and
    one sync step timed with the backward kernel and with the plain
    backward in its place, (c) one step's gradients held three ways, (d)
    the attention backward alone beside SDPA's, (e) a restart at the
    reduced config.  Returns the phase line, the launches of the main
    paths' kernels (``forward``: flash_attn's by variant in (a), (c)'s fp32
    layers and (e); ``bwd_wgmma``: (a)'s backward; ``bwd_simt_tiled``:
    (c)'s fp32 backward), and (d)'s kernels-line rows."""
    from repro_torch.kernels import common
    from repro_torch.launch import train
    from repro_torch.optim.sgd import sgd
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    sync, (cfg, state, batches) = _train_run(TRAIN_ARGV, scratch / "lm_sync")
    sync["expected_launches"] = 2 * cfg.n_layers * len(sync["losses"])
    sync["expected_bwd_launches"] = cfg.n_layers * len(sync["losses"])
    # one step with the backward kernel, with the plain backward in its
    # place, and with the kernel again, on the same weights and batch
    batch = next(batches)
    sync["split"] = _step_split(cfg, state[0], batch, TRAIN_LR)
    with common.plain_versions("flash_attn_bwd"):
        sync["split_plain_backward"] = _step_split(cfg, state[0], batch,
                                                   TRAIN_LR, profile=False)
    sync["split_again"] = _step_split(cfg, state[0], batch, TRAIN_LR,
                                      profile=False)
    del state, batches, batch
    torch.cuda.empty_cache()

    run_b, (_, state, batches) = _train_run(TRAIN_ARGV + TRAIN_ASYNC,
                                            scratch / "lm_async")
    # one more local step, then the int8 merge: its anchor the replicas'
    # start, each replica's drift quantized with error feedback
    local, cmerge = trainer.make_async_local_step(cfg, sgd(TRAIN_LR),
                                                  compress_merge=True)
    params_r, opt_r, _ = state
    del state
    anchor = {k: v[0].clone() for k, v in params_r.items()}
    bs = {k: v.reshape(2, -1, v.shape[1]) for k, v in next(batches).items()}
    params_r, _, _ = local(params_r, opt_r, bs)
    exact = {k: v.float().mean(0) for k, v in params_r.items()}
    t0 = time.perf_counter()
    merged, new_anchor, ef = cmerge(params_r, anchor, None)
    torch.cuda.synchronize()
    run_b["compressed_merge"] = {
        "seconds": time.perf_counter() - t0,
        "replicas_equal": all(torch.equal(v[0], v[1])
                              for v in merged.values()),
        "max_abs_vs_exact_mean": max(float((merged[k][0].float() - exact[k])
                                           .abs().max()) for k in exact),
        "max_abs_error_feedback": max(float(e.abs().max())
                                      for e in ef.values())}
    del params_r, opt_r, anchor, merged, new_anchor, ef, exact, batches
    torch.cuda.empty_cache()
    run_b["expected_launches"] = 2 * 2 * cfg.n_layers * len(run_b["losses"])
    run_b["expected_bwd_launches"] = 2 * cfg.n_layers * len(run_b["losses"])

    # (c) a fresh model and batch: one step's gradients held three ways
    from repro_torch.nn import transformer
    lm = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    batch = next(train.make_batch_fn(cfg, 2, LM_PREFILL, seed=3, device=dev))
    grads = _grads_held(cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()

    bwd, bwd_rows = _backward_alone(dev)
    torch.cuda.empty_cache()

    # (e) a restart at the reduced config (fp32), through the launcher's
    # main
    buf = io.StringIO()
    t0 = time.perf_counter()
    common.reset_launches()
    with contextlib.redirect_stdout(buf):
        losses = train.main(TRAIN_RESTART + ["--device", str(dev),
                                             "--ckpt-dir",
                                             str(scratch / "lm_restart")])
    restart = {"argv": TRAIN_RESTART, "seconds": time.perf_counter() - t0,
               "printed": buf.getvalue().strip(), "losses": losses,
               "flash_attn_launches_by_variant": forward_launches(),
               "restarts": int(re.search(r"restarts=(\d+)",
                                         buf.getvalue()).group(1))}
    restart["ok"] = bool(restart["restarts"] == 1 and losses[-1] < losses[0]
                         and len(losses) == 9)

    # the reference's own check: the last fresh batch's loss below the first
    ok_a = bool(sync["fresh_batch_loss_falls"] and sync["restarts"] == 0
                and sync["flash_attn_launches"] == sync["expected_launches"]
                and sync["flash_attn_bwd_launches"]
                == sync["expected_bwd_launches"]
                and sync["flash_attn_launches_by_variant"]["wgmma"]
                == sync["expected_launches"]
                # the profiled step's backward ran the wgmma kernels, a
                # pair a layer
                and all(c == cfg.n_layers for c in sync["split"][
                    "profiled_step"]["launches_by_kernel"].values())
                and all(np.isfinite(sync["losses"]))
                and sync["ckpt_steps"] == ["step_000000000"])
    ok_b = bool(run_b["fresh_batch_loss_falls"]
                and all(np.isfinite(run_b["losses"]))
                and run_b["replicas_equal"] == [False, True] * (TRAIN_STEPS
                                                                // 2)
                and run_b["flash_attn_launches"] == run_b["expected_launches"]
                and run_b["flash_attn_bwd_launches"]
                == run_b["expected_bwd_launches"]
                and run_b["compressed_merge"]["replicas_equal"])
    return {"phase": "lm_train", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
            "d_ff": cfg.d_ff, "vocab": cfg.vocab, "window": cfg.window,
            "dtype": str(cfg.param_dtype), "start_memory_gb": start_gb,
            "sync": {**sync, "ok": ok_a}, "async": {**run_b, "ok": ok_b},
            "grads": grads, "backward": bwd, "restart": restart,
            "seconds": time.perf_counter() - t_phase,
            "ok": bool(ok_a and ok_b and grads["ok"] and bwd["ok"]
                       and restart["ok"])}, {
        "forward": {kind: sum(run[kind] for run in (
            sync["flash_attn_launches_by_variant"],
            grads["fp32_2_layers"]["flash_attn_launches_by_variant"],
            restart["flash_attn_launches_by_variant"]))
            for kind in sync["flash_attn_launches_by_variant"]},
        "bwd_wgmma": sync["flash_attn_bwd_launches"],
        "bwd_simt_tiled": grads["fp32_2_layers"]["flash_attn_bwd_launches"]}, \
        bwd_rows


# ---------------------------------------------------------------------------
# ``--lm-train-probe``: phase lm_train's open questions, apart from the run
# ---------------------------------------------------------------------------

#: (c)'s gradients on other weights and batches: (weight seed, batch seed);
#: (0, 3) is the main run's
PROBE_SEEDS = ((0, 3), (1, 11), (2, 12), (4, 14)) + tuple(
    (w, 100 + w) for w in range(5, 17))
#: fresh-batch runs of the launcher's objects at (a)'s shape: (parameter
#: dtype, lr, steps)
PROBE_RUNS = ((torch.bfloat16, 4.0, 16), (torch.bfloat16, 1.0, 16),
              (torch.float32, 4.0, 4), (torch.float32, 1.0, 4))


def _sdpa_forward(q, k, v, causal, window):
    """``scaled_dot_product_attention`` with the end-aligned boolean mask
    and GQA: a library bf16 attention."""
    mask = end_aligned_mask(q.shape[2], k.shape[2], causal, window, q.device)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def _p_bf16_forward(q, k, v, causal, window):
    """The plain version with P rounded to bf16 before P.V and no lo half
    (the row sums still from the fp32 P): what the kernels' hi + lo split
    exists to avoid."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    sq, sk = q.shape[2], k.shape[2]
    mask = end_aligned_mask(sq, sk, causal, window, q.device)
    out = []
    for lo in range(0, sq, 512):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, lo:lo + 512].float(),
                         kf) * q.shape[3] ** -0.5
        if mask is not None:
            s = s.masked_fill(~mask[lo:lo + 512], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vf)
        out.append(o / torch.where(l == 0, 1.0, l))
    return torch.cat(out, dim=2).to(q.dtype)


def _window_short_forward(q, k, v, causal, window):
    """The plain version with the window one key short."""
    from repro_torch.kernels.flash_attn.ref import attention_ref

    return attention_ref(q, k, v, causal=causal,
                         window=None if window is None else window - 1)


def _window_dropped_forward(q, k, v, causal, window):
    """The plain version with no window."""
    from repro_torch.kernels.flash_attn.ref import attention_ref

    return attention_ref(q, k, v, causal=causal, window=None)


def _scale_high_forward(q, k, v, causal, window):
    """The plain version with the scores' scale 2^-8 too large."""
    from repro_torch.kernels.flash_attn.ref import attention_ref

    return attention_ref(q.float() * (1 + 2 ** -8), k, v, causal=causal,
                         window=window).to(q.dtype)


#: (c)'s loss rule's controls (``_loss_controls``): forwards wrong on
#: purpose in the forward kernel's place
LOSS_CONTROLS = {"p_bf16_without_lo": _p_bf16_forward,
                 "window_one_short": _window_short_forward,
                 "scale_2^-8_high": _scale_high_forward,
                 "window_dropped": _window_dropped_forward}


@contextlib.contextmanager
def routed_attention(forward=_sdpa_forward):
    """flash_attn's forward routed to ``forward(q, k, v, causal, window)``
    for the block (by default SDPA's, ``_sdpa_forward``), its backward
    still the operator's (the backward kernel): another attention in the
    forward kernel's place, a control for the gradient and loss rules."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn.ref import attention_ref

    dispatch = common.dispatch

    def routed(kernel, dev, *args, **kwargs):
        if kernel != "flash_attn":
            return dispatch(kernel, dev, *args, **kwargs)
        q, k, v = args
        causal, window = kwargs["causal"], kwargs["window"]
        out = forward(q, k, v, causal, window)
        if not kwargs.get("lse"):
            return out
        # the backward's statistics, which ``forward`` does not return, from
        # the plain version: its log-sum-exp, and out_lo such that out +
        # out_lo is its fp32 output
        full, lse, lo = attention_ref(q, k, v, causal=causal, window=window,
                                      with_lse=True)
        return out, lse, (full.float() + lo.float() - out.float()).to(q.dtype)

    common.dispatch = routed
    try:
        yield
    finally:
        common.dispatch = dispatch


def _grad_ratios(cfg, dev, weight_seed: int, batch_seed: int) -> dict:
    """(c)'s three ways plus the library control on one seeded model and
    batch, the kernel path once for each forward variant that takes the
    model's training shape: per leaf, each bf16 path's distance from the
    fp32 yardstick over the plain bf16 path's, by max and by RMS
    (``_held_bf16_grad``), and the loss's (``_held_bf16``)."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.launch import train
    from repro_torch.nn import transformer
    from repro_torch.train import trainer

    lm = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(weight_seed))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    batch = next(train.make_batch_fn(cfg, 2, LM_PREFILL, seed=batch_seed,
                                     device=dev))
    paths = {}
    for kind in attn_variants_taking(cfg.param_dtype, LM_PREFILL,
                                     cfg.n_heads // cfg.n_kv, cfg.hd):
        with forced_variant(attn_ops, kind):
            paths[f"kernel_{kind}"] = trainer.value_and_grad(cfg, params,
                                                             batch)
    with routed_attention():
        paths["sdpa"] = trainer.value_and_grad(cfg, params, batch)
    with common.plain_versions():
        loss_p, plain = trainer.value_and_grad(cfg, params, batch)
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        loss_32, g32 = trainer.value_and_grad(
            cfg32, {k: v.float() for k, v in params.items()}, batch)
    del params

    out = {"seeds": [weight_seed, batch_seed], "leaves": len(g32)}
    qs = (0, 0.5, 0.9, 0.99, 1)
    for name, (loss, g) in paths.items():
        held = {k: _held_bf16_grad(g[k], plain[k], g32[k]) for k in g32}
        ratios = {r: {k: h[r] for k, h in sorted(held.items())}
                  for r in ("max_ratio", "rms_ratio")}
        out[name] = {"loss": _held_bf16(loss, loss_p, loss_32, LOSS_ATOL),
                     "leaves_ok": sum(h["ok"] for h in held.values())}
        for r, by_leaf in ratios.items():
            ranked = sorted(by_leaf.values())
            out[name][f"{r}_quantiles"] = [ranked[int(q * (len(ranked) - 1))]
                                           for q in qs]
            out[name][f"{r}_over_1_5"] = {k: v for k, v in by_leaf.items()
                                          if v > BF16_MODEL_SLACK}
    return out


def _loss_controls(dev) -> dict:
    """(c)'s loss rule (``_held_bf16`` with LOSS_ATOL), leaf rule
    (``_held_bf16_grad``) and layer rule (``checked_attention``) on (c)'s
    model and batch, with each of LOSS_CONTROLS in the forward kernel's
    place: what each rule sees of a wrong forward, beside the layer rule
    on the kernel path.  ``ok``: the kernel path holds the layer rule at
    every call, and the rule fails the window one key short and the window
    dropped at one layer at least."""
    from repro_torch import configs
    from repro_torch.kernels import common
    from repro_torch.launch import train
    from repro_torch.nn import transformer
    from repro_torch.train import trainer

    t0 = time.perf_counter()
    cfg = configs.get("h2o-danube-1.8b")
    lm = transformer.init_params(cfg,
                                 torch.Generator(device=dev).manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    batch = next(train.make_batch_fn(cfg, 2, LM_PREFILL, seed=3, device=dev))
    with common.plain_versions():
        loss_p, plain = trainer.value_and_grad(cfg, params, batch)
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
        loss_32, g32 = trainer.value_and_grad(
            cfg32, {k: v.float() for k, v in params.items()}, batch)
    out = {"seeds": [0, 3], "leaves": len(g32)}
    with checked_attention() as calls:
        trainer.value_and_grad(cfg, params, batch)
    out["kernel"] = {"layers": _layer_summary(calls, cfg.n_layers)}
    for name, forward in LOSS_CONTROLS.items():
        with routed_attention(forward), checked_attention() as calls:
            loss, g = trainer.value_and_grad(cfg, params, batch)
        held = {k: _held_bf16_grad(g[k], plain[k], g32[k]) for k in g32}
        del g
        out[name] = {"loss": float(loss),
                     **_held_bf16(loss, loss_p, loss_32, LOSS_ATOL),
                     "leaves_ok": sum(h["ok"] for h in held.values()),
                     "max_rms_ratio": max(h["rms_ratio"]
                                          for h in held.values()),
                     "max_max_ratio": max(h["max_ratio"]
                                          for h in held.values()),
                     "layers": _layer_summary(calls, cfg.n_layers)}
        torch.cuda.empty_cache()
    out.update(loss_plain=float(loss_p), loss_fp32=float(loss_32),
               seconds=time.perf_counter() - t0,
               ok=bool(out["kernel"]["layers"]["ok"] and all(
                   out[name]["layers"]["failing_layers"]
                   for name in ("window_one_short", "window_dropped"))))
    return out


def _attention_accuracy(dev) -> dict:
    """Each bf16 forward variant's error a call at danube's training layer
    (B=2, S=8192, window 4096) through the operator asked for the
    statistics: its output to 16 bits (out + out_lo) and its bf16 output
    against the plain version in fp32 on the same bf16 inputs, and the
    share of bf16 elements where it differs from the plain bf16 version
    (whose own bf16 error is beside)."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    q, k, v = _attn_inputs(BWD_BF16_SHAPE, torch.bfloat16, dev, seed=5)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True,
                        window=4096)
    plain = attention_ref(q, k, v, causal=True, window=4096)
    out = {"shape": list(BWD_BF16_SHAPE),
           "plain_bf16_err_mean": float((plain.float() - ref).abs().mean())}
    for kind in attn_variants_taking(torch.bfloat16, LM_PREFILL, 4, 80):
        with forced_variant(attn_ops, kind):
            o, _, lo = torch.ops.repro_torch.flash_attn(q, k, v, True, 4096,
                                                        None, None, True)
        err16 = (o.float() + lo.float() - ref).abs()
        out[kind] = {"out16_err_mean": float(err16.mean()),
                     "out16_err_max": float(err16.max()),
                     "bf16_err_mean": float((o.float() - ref).abs().mean()),
                     "bf16_differs_from_plain": float(
                         (o != plain).float().mean())}
    return out


def _fresh_batch_run(dev, scratch: Path, dtype, lr: float,
                     steps: int) -> dict:
    """(a)'s run at another rate, length or parameter dtype, beside the
    same fresh batches' losses at the initial weights (the run's own
    draws, so ``fresh_minus_initial`` is what training did to each batch
    before it was seen), and the share of each group's weights the run
    changed."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.nn import transformer

    argv = list(TRAIN_ARGV)
    argv[argv.index("--lr") + 1] = str(lr)
    argv[argv.index("--steps") + 1] = str(steps)
    get = configs.get
    configs.get = lambda name: dataclasses.replace(get(name),
                                                   param_dtype=dtype)
    try:
        cfg = configs.get("h2o-danube-1.8b")
        lm0 = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        batches = train.make_batch_fn(cfg, 2, LM_PREFILL, device=dev)
        with torch.no_grad():
            initial = [float(transformer.loss_fn(lm0, cfg, next(batches)))
                       for _ in range(steps)]
        del batches
        run, (cfg, state, _) = _train_run(argv, scratch / "lm_probe")
    finally:
        configs.get = get
    groups: dict[str, list[int]] = {}
    with torch.no_grad():
        for k, p0 in lm0.named_parameters():
            group = k.split(".")[-1] if k.startswith("layers.") else k
            n = groups.setdefault(group, [0, 0])
            n[0] += int((state[0][k] != p0).sum())
            n[1] += p0.numel()
    del lm0, state
    torch.cuda.empty_cache()
    return {"dtype": str(dtype), "lr": lr, "steps": steps,
            "fresh_batch_losses": run["losses"],
            "initial_losses": initial,
            "fresh_minus_initial": [a - b for a, b in zip(run["losses"],
                                                          initial)],
            "fresh_batch_loss_falls": run["fresh_batch_loss_falls"],
            "steady_ms_per_step": run["steady_ms_per_step"],
            "changed_share": {g: c / n for g, (c, n) in groups.items()},
            "max_memory_allocated_gb": run["max_memory_allocated_gb"]}


def run_lm_train_probe(scratch: Path) -> int:
    """``python3 chip_smoke.py --lm-train-probe``: the env and build
    phases, then (c)'s gradient rule on PROBE_SEEDS with the library
    control, and (a)'s fresh-batch loss over PROBE_RUNS; one JSON line
    each, the card's name and power limit last."""
    from repro_torch import configs
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    cfg = configs.get("h2o-danube-1.8b")
    emit({"phase": "lm_train_probe", "part": "attention_accuracy",
          **_attention_accuracy(dev)})
    for weight_seed, batch_seed in PROBE_SEEDS:
        t = time.perf_counter()
        line = _grad_ratios(cfg, dev, weight_seed, batch_seed)
        emit({"phase": "lm_train_probe", "part": "grads", **line,
              "seconds": time.perf_counter() - t})
        torch.cuda.empty_cache()
    for dtype, lr, steps in PROBE_RUNS:
        t = time.perf_counter()
        line = _fresh_batch_run(dev, scratch, dtype, lr, steps)
        emit({"phase": "lm_train_probe", "part": "fresh_batch", **line,
              "seconds": time.perf_counter() - t})
    emit({"phase": "lm_train_probe", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    return 0


# ---------------------------------------------------------------------------
# Phase lm_families: the moe, hybrid, ssm, audio and vlm families
# ---------------------------------------------------------------------------

#: the families' largest architectures one card holds, served through the
#: launcher (tokens in) or through the prefill step and decode steps
#: (audio's frames and vlm's patches in: the engine feeds tokens alone)
FAMILY_SERVED = ("olmoe-1b-7b", "zamba2-1.2b", "xlstm-1.3b")
FAMILY_PREFILLED = ("musicgen-large", "llama-3.2-vision-11b")
FAMILY_ARGV = ["--requests", "8", "--slots", "4", "--max-new", "16",
               "--max-len", "128", "--seed", "0"]
#: the prefill step's batch and length, and the decode steps after it
FAMILY_PREFILL = (2, 512)
FAMILY_DECODE_STEPS = 16
#: the training runs: sequence length per architecture (vlm past its 1,600
#: patches, so its cross-attention runs Sq 2,048 > Sk 1,600; xlstm at 512,
#: since its sLSTM steps through time in a host loop: 46-60 s of the run at
#: 1,024), batch 1
FAMILY_TRAIN_SEQ = {"olmoe-1b-7b": 1024, "zamba2-1.2b": 1024,
                    "xlstm-1.3b": 512, "musicgen-large": 1024,
                    "llama-3.2-vision-11b": 2048}
FAMILY_TRAIN_STEPS = 2
#: SGD's rate: xlstm-1.3b's gradient at its initial weights is too large
#: for any usual rate (global norm 7.6e9, its largest element 8.5e7 in the
#: first mLSTM's gates: (b) records both), so its rate keeps the largest
#: update near 0.01, as the reference's own test scales its rate by the
#: gradient norm for this stiff model (tests/test_archs.py:46-48)
FAMILY_TRAIN_LR = {"xlstm-1.3b": 1e-10}
FAMILY_TRAIN_LR_DEFAULT = 0.01
#: the depth (c) holds each family at: full width, the reduced configs'
#: depths (a vlm superblock, a hybrid superblock and its tail of 2, an
#: xLSTM superblock)
FAMILY_CUT = {"moe": 2, "audio": 2, "vlm": 5, "hybrid": 8, "ssm": 8}
#: (d): the shapes of flash_attn these families bring, (label, (B, Hq, Hkv,
#: Sq, Sk, hd), causal)
FAMILY_ATTN = (
    ("hd 64, rep 1, causal (musicgen, zamba2)", (1, 32, 32, 1024, 1024, 64),
     True),
    ("hd 128, rep 1, causal (olmoe)", (1, 16, 16, 1024, 1024, 128), True),
    ("hd 128, rep 4, causal (llama-vision self)", (1, 32, 8, 2048, 2048, 128),
     True),
    ("cross Sq 2048 > Sk 1600, hd 128, rep 4", (1, 32, 8, 2048, 1600, 128),
     False),
    ("cross at prefill, Sq 512 < Sk 1600", (2, 32, 8, 512, 1600, 128), False),
    ("decode cross, Sq 1 over 1600", (2, 32, 8, 1, 1600, 128), False),
    ("decode hd 64, rep 1", (4, 32, 32, 1, 128, 64), True),
    ("decode hd 128, rep 1", (4, 16, 16, 1, 128, 128), True),
)
#: (e): the --ckpt round trip's architectures, reduced
FAMILY_CKPT = ("minitron-4b", "olmoe-1b-7b")


def _attention_layers(cfg) -> int:
    """flash_attn calls one forward (or decode step) makes."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers,
            "audio": cfg.n_layers, "vlm": cfg.n_layers,
            "hybrid": cfg.n_layers // 6, "ssm": 0}[cfg.family]


def _family_inputs(cfg, b: int, s: int, dev, seed: int) -> dict:
    """A model's inputs on the card: tokens, or the stub frontends'
    embeddings (audio's frames in place of tokens, vlm's 1,600 patches
    beside them)."""
    from repro_torch.data import modality_stubs

    rng = np.random.default_rng(seed)
    ins = {}
    if cfg.emb_in():
        ins["embeddings"] = modality_stubs.encodec_frames(
            rng, b, s, cfg.d_model, cfg.param_dtype, device=dev)
    else:
        ins["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
    if cfg.family == "vlm":
        ins["memory"] = modality_stubs.vit_patches(
            rng, b, cfg.n_memory, cfg.d_model, cfg.param_dtype, device=dev)
    return ins


def _family_serve(name: str, dev) -> tuple[object, dict, dict]:
    """A tokens-in family through the launcher's setup and engine, launch
    counts zeroed just before ``run`` and read just after."""
    from repro_torch.kernels import common
    from repro_torch.launch import serve

    args = serve.parse_args(["--arch", name] + FAMILY_ARGV)
    t0 = time.perf_counter()
    cfg, engine, reqs = serve.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    common.reset_launches()
    t0 = time.perf_counter()
    done = engine.run(reqs, max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.LAUNCHES["flash_attn"]
    tokens = sum(len(r.out) for r in done)
    out = {"path": "launch.serve", "setup_s": setup_s,
           "n_params": sum(p.numel() for p in engine.params.parameters()),
           "requests": len(reqs), "done": len(done), "tokens": tokens,
           "decode_steps": engine.steps, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ms_per_step": wall / engine.steps * 1e3,
           "flash_attn_launches": launches,
           "expected_launches": _attention_layers(cfg) * engine.steps,
           "tokens_in_range": all(0 <= t < cfg.vocab
                                  for r in done for t in r.out)}
    out["ok"] = bool(out["done"] == len(reqs) and out["tokens_in_range"]
                     and launches == out["expected_launches"])
    # where a step's time goes: four more steps for the 4 slots, profiled
    out["step_breakdown"] = _lm_profile(lambda: [
        engine._step(engine.last_tok, args.max_len - 8 + i)
        for i in range(4)], 4)
    if cfg.family == "moe":
        out["expert_bytes_per_step"] = _expert_bytes(cfg)
    return cfg, out, {"decode": launches, "backward": 0}


def _expert_bytes(cfg) -> dict:
    """A MoE decode step's bytes floor: the capacity buffer reaches every
    expert, so every expert's three matrices are read (in the model's
    dtype), and its time at the card's memory rate."""
    nbytes = (cfg.n_layers * cfg.moe_experts * 3 * cfg.d_model * cfg.d_ff
              * torch.finfo(cfg.param_dtype).bits // 8)
    return {"bytes": nbytes, "ms_at_hbm_rate": nbytes / HBM_BYTES_PER_S * 1e3}


def _family_prefill(name: str, dev) -> tuple[object, dict, dict]:
    """An embeddings-in family through ``trainer.make_prefill_step`` at
    FAMILY_PREFILL, then FAMILY_DECODE_STEPS ``decode_step``s from that
    cache (audio's next frame from the stub, vlm's next token the
    argmax), launch counts zeroed just before each and read just after."""
    from repro_torch import configs
    from repro_torch.data import modality_stubs
    from repro_torch.kernels import common
    from repro_torch.nn import decode, transformer
    from repro_torch.train import trainer

    cfg = configs.get(name)
    b, s = FAMILY_PREFILL
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    ins = _family_inputs(cfg, b, s, dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prefill = trainer.make_prefill_step(cfg)
    with torch.inference_mode():
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pre = prefill(params, ins)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = common.LAUNCHES["flash_attn"]
        by_variant = forward_launches()
        cache = decode.init_cache(cfg, b, s + FAMILY_DECODE_STEPS, dev)
        for key, t in pre.items():
            cache[key][..., :s, :].copy_(t)
        rng = np.random.default_rng(1)
        step_logits = []
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(FAMILY_DECODE_STEPS):
            if cfg.emb_in():
                one = {"embeddings": modality_stubs.encodec_frames(
                    rng, b, 1, cfg.d_model, cfg.param_dtype, device=dev)}
            else:
                one = {"tokens": logits.argmax(-1, keepdim=True).to(
                    torch.int32), "memory": ins["memory"]}
            logits, cache = decode.decode_step(params, cfg, cache, one, s + i)
            step_logits.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_launches = common.LAUNCHES["flash_attn"]
        step_breakdown = _lm_profile(lambda: [
            decode.decode_step(params, cfg, cache, one, s + i)
            for i in range(4)], 4)
    finite = bool(all(torch.isfinite(lg).all() for lg in step_logits))
    out = {"path": "trainer.make_prefill_step + decode.decode_step",
           "setup_s": setup_s,
           "n_params": sum(p.numel() for p in params.parameters()),
           "B": b, "S": s, "memory": cfg.n_memory if cfg.family == "vlm"
           else 0, "prefill_s": prefill_s,
           "prefill_tokens_per_s": b * s / prefill_s,
           "prefill_flash_attn_launches": prefill_launches,
           "decode_steps": FAMILY_DECODE_STEPS,
           "ms_per_step": decode_s / FAMILY_DECODE_STEPS * 1e3,
           "decode_flash_attn_launches": decode_launches,
           "expected_launches": _attention_layers(cfg),
           "logits_shape": list(logits.shape), "finite": finite,
           "step_breakdown": step_breakdown}
    out["ok"] = bool(finite and prefill_launches == _attention_layers(cfg)
                     and decode_launches
                     == _attention_layers(cfg) * FAMILY_DECODE_STEPS
                     and list(logits.shape) == [b, cfg.vocab])
    del params, cache, pre
    out["prefill_flash_attn_launches_by_variant"] = by_variant
    return cfg, out, {**by_variant, "decode": decode_launches,
                      "backward": 0}


def free_memory() -> None:
    """Collect the garbage that reference cycles hold (a step's autograd
    and checkpoint closures can keep a model's tensors alive past the
    phase that made them: the next model's peak would count them), then
    return the cached blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _family_train(name: str, dev, scratch: Path) -> tuple[dict, dict]:
    """``launch.train --arch name --batch 1 --seq S --steps 2`` with SGD,
    through the launcher's objects, launch counts zeroed just before
    ``loop.run`` and read just after.  The loop's checkpoint writes are
    switched off here (a full-width model's state is 13-37 GB of host
    copy a save; phase lm_train and (e) cover the writes)."""
    from repro_torch.kernels import common
    from repro_torch.launch import train
    from repro_torch.train import trainer

    seq = FAMILY_TRAIN_SEQ[name]
    argv = ["--arch", name, "--batch", "1", "--seq", str(seq), "--steps",
            str(FAMILY_TRAIN_STEPS), "--optimizer", "sgd", "--lr",
            str(FAMILY_TRAIN_LR.get(name, FAMILY_TRAIN_LR_DEFAULT))]
    args = train.parse_args(argv + ["--ckpt-dir", str(scratch / "families")])
    free_memory()
    start_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, loop, batches = train.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    loop.ckpt.maybe_save = lambda step, tree: False
    rec = _timed_loop(loop)
    # each step's gradient: global norm, largest element and its leaf
    grads_seen, value_and_grad = [], trainer.value_and_grad

    wgmma = KERNEL_SYMBOLS["flash_attn_bwd"]["wgmma"]
    ran = {}

    def recorded(*a, **kw):
        # the first step of a family with attention under the profiler:
        # what the card ran (xlstm's has none, and its time loop's
        # launches made a profiled step 8x longer on the card)
        if grads_seen or not _attention_layers(cfg):
            loss, grads = value_and_grad(*a, **kw)
        else:
            (loss, grads), got = counted(lambda: value_and_grad(*a, **kw),
                                         wgmma)
            ran.update(got)
        tops = {k: float(g.abs().max()) for k, g in grads.items()}
        top = max(tops, key=tops.get)
        grads_seen.append({
            "norm": float(sum(g.float().pow(2).sum()
                              for g in grads.values()) ** 0.5),
            "max": tops[top], "max_leaf": top,
            "finite": all(np.isfinite(v) for v in tops.values())})
        return loss, grads

    trainer.value_and_grad = recorded
    common.reset_launches()
    t0 = time.perf_counter()
    try:
        state, history = loop.run(batches, args.steps)
        torch.cuda.synchronize()
    finally:
        trainer.value_and_grad = value_and_grad
    wall = time.perf_counter() - t0
    launches = common.LAUNCHES["flash_attn"]
    by_variant = forward_launches()
    bwd_launches = common.LAUNCHES["flash_attn_bwd"]
    losses = train.losses_of(history)
    out = {"argv": argv, "setup_s": setup_s, "wall_s": wall,
           "losses": losses, "grads": grads_seen, "step_ms": rec["step_ms"],
           "tokens_per_s": seq / (rec["step_ms"][-1] / 1e3),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "start_memory_gb": start_gb,
           "flash_attn_launches": launches,
           "expected_launches": 2 * _attention_layers(cfg) * len(losses),
           "flash_attn_bwd_launches": bwd_launches,
           "first_step_bwd_kernel_launches": ran}
    out["ok"] = bool(len(losses) == FAMILY_TRAIN_STEPS
                     and bwd_launches == _attention_layers(cfg) * len(losses)
                     and all(c == _attention_layers(cfg)
                             for c in ran.values())
                     and all(np.isfinite(losses))
                     and all(g["finite"] for g in grads_seen)
                     and launches == out["expected_launches"])
    del state, loop, batches
    out["flash_attn_launches_by_variant"] = by_variant
    return out, {**by_variant, "decode": 0, "backward": bwd_launches}


def _family_held(name: str, dev) -> dict:
    """(c): the family at full width and FAMILY_CUT depth, in bf16 through
    the kernels and through the plain versions, and in fp32 through the
    plain versions (the yardstick): the prefill's hidden states and
    caches and four decode steps' logits by ``_held_bf16``, and every
    gradient leaf of one training step by ``_held_bf16_grad``.  The loss
    is recorded the same way but not held: one scalar's ratio spreads
    from 0.14 to 7.7 over seeds on either bf16 path (PR 22's probe,
    PERF.md §6)."""
    from repro_torch import configs
    from repro_torch.kernels import common
    from repro_torch.nn import decode, transformer
    from repro_torch.train import trainer

    full = configs.get(name)
    cfg = dataclasses.replace(full, n_layers=FAMILY_CUT[full.family])
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32)
    t0 = time.perf_counter()
    lm = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    p32 = {k: v.float() for k, v in params.items()}
    del lm
    seq = FAMILY_TRAIN_SEQ[name]
    ins = _family_inputs(cfg, 1, seq, dev, seed=2)
    ins32 = {k: (v.float() if v.is_floating_point() else v)
             for k, v in ins.items()}
    paths = (("kernel", cfg, params, ins, False),
             ("plain", cfg, params, ins, True),
             ("fp32", cfg32, p32, ins32, True))

    def plain_if(flag):
        return common.plain_versions() if flag else contextlib.nullcontext()

    outs = {}
    with torch.inference_mode():
        for label, c, p, x, plain in paths:
            lm = transformer.LM.from_tree(p).requires_grad_(False)
            with plain_if(plain):
                h, cache = transformer.forward(lm, c, x, mode="prefill")
                dc = decode.init_cache(c, 1, 8, dev)
                logits = []
                for i in range(4):
                    one = {k: (v if k == "memory" else v[:, i:i + 1])
                           for k, v in x.items()}
                    logits.append(decode.decode_step(lm, c, dc, one, i)[0])
            outs[label] = {"hidden": h, **{f"cache_{k}": v
                                           for k, v in cache.items()},
                           "decode_logits": torch.stack(logits)}
            del lm
    held = {k: _held_bf16(outs["kernel"][k], outs["plain"][k],
                          outs["fp32"][k]) for k in outs["kernel"]}
    del outs
    labels = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, seq)).astype(np.int32)).to(dev)
    grads = {}
    for label, c, p, x, plain in paths:
        with plain_if(plain):
            grads[label] = trainer.value_and_grad(c, p, {**x, "labels": labels})
    loss = _held_bf16(*(grads[k][0] for k in ("kernel", "plain", "fp32")))
    leaves = {k: _held_bf16_grad(grads["kernel"][1][k], grads["plain"][1][k],
                                 grads["fp32"][1][k])
              for k in grads["kernel"][1]}
    del grads, params, p32
    worst = max(leaves, key=lambda k: leaves[k]["max_ratio"])
    return {"n_layers": cfg.n_layers, "seq": seq,
            "cut": f"{full.n_layers} -> {cfg.n_layers} layers, full width",
            "forward": held, "loss": loss, "leaves": len(leaves),
            "leaves_ok": sum(h["ok"] for h in leaves.values()),
            "failing": sorted(k for k, h in leaves.items() if not h["ok"])[:8],
            "worst_leaf": {"name": worst, **leaves[worst]},
            "max_rms_ratio": max(h["rms_ratio"] for h in leaves.values()),
            "seconds": time.perf_counter() - t0,
            "ok": bool(all(h["ok"] for h in held.values())
                       and all(h["ok"] for h in leaves.values()))}


def _family_attention(dev) -> dict:
    """(d): each new flash_attn shape through the kernel against the
    plain version, the cross call's backward too (autograd through the
    kernel's forward and the backward kernel, against autograd through the
    plain forward in fp32), with the kernel's device ms beside
    ``scaled_dot_product_attention``'s."""
    import repro_torch.kernels as K
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    cases = []
    for n, (label, shape, causal) in enumerate(FAMILY_ATTN):
        q, k, v = _attn_inputs(shape, torch.bfloat16, dev, seed=300 + n)
        err, ok = close(K.flash_attention(q, k, v, causal=causal),
                        attention_ref(q, k, v, causal=causal), ATTN_BF16_TOL)
        mask = end_aligned_mask(shape[3], shape[4], causal, None, dev)
        in_bytes, flops = attn_work(q, k, causal, None)
        bound, by = bound_ms(in_bytes, flops, BF16_FLOPS_PER_S)
        cases.append({
            "case": label, "shape": list(shape), "causal": causal,
            "variant": attn_ops.variant(torch.bfloat16, shape[3],
                                        shape[1] // shape[2], shape[5]),
            "max_abs_err": err, "tol": ATTN_BF16_TOL, "ok": ok,
            "ms": cuda_ms(lambda: K.flash_attention(q, k, v, causal=causal),
                          10),
            "sdpa_ms": cuda_ms(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, attn_mask=mask,
                                   enable_gqa=True), 10),
            "bound_ms": bound, "bound_by": by})
    # the cross call's backward at the vlm training shape
    shape = FAMILY_ATTN[3][1]
    q, k, v = _attn_inputs(shape, torch.bfloat16, dev, seed=399)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(12)).to(torch.bfloat16)

    def grads_of(fn, dtype):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do.to(dtype))

    ref32 = grads_of(lambda *x: attention_ref(*x, causal=False),
                     torch.float32)
    mine = grads_of(lambda *x: K.flash_attention(*x, causal=False),
                    torch.bfloat16)
    rel = [float((a.float() - b).abs().max() / b.abs().max())
           for a, b in zip(mine, ref32)]
    mine32 = grads_of(lambda *x: K.flash_attention(*x, causal=False),
                      torch.float32)
    fp32 = [close(a, b, ATTN_TOL) for a, b in zip(mine32, ref32)]
    cases.append({"case": "cross backward Sq 2048 > Sk 1600, bf16 and fp32",
                  "shape": list(shape), "bf16_rel_err": rel,
                  "bf16_rel_limit": BWD_BF16_REL,
                  "fp32_max_abs_err": [e for e, _ in fp32],
                  "ok": bool(max(rel) <= BWD_BF16_REL
                             and all(ok for _, ok in fp32))})
    return {"cases": cases, "ok": all(c["ok"] for c in cases)}


def _family_ckpt(dev, scratch: Path) -> dict:
    """(e): ``launch.train --smoke --ckpt-dir D`` (a checkpoint every
    step, so the last holds the final weights), then ``launch.serve
    --smoke --ckpt D``: its engine serves the same tokens as an engine on
    the trainer's final parameters; flash_attn's launches by variant over
    both (the reduced configs are fp32)."""
    from repro_torch.kernels import common
    from repro_torch.launch import serve, train
    from repro_torch.nn import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    out = []
    common.reset_launches()
    for name in FAMILY_CKPT:
        d = scratch / f"ckpt-{name}"
        args = train.parse_args(["--arch", name, "--smoke", "--steps", "4",
                                 "--ckpt-every", "1", "--ckpt-dir", str(d),
                                 "--device", str(dev)])
        cfg, loop, batches = train.setup(args)
        (final, _), history = loop.run(batches, args.steps)
        losses = train.losses_of(history)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, restored, reqs = serve.setup(serve.parse_args(
                ["--arch", name, "--smoke", "--ckpt", str(d), "--device",
                 str(dev)]))
        twin = ServeEngine(cfg, transformer.LM.from_tree(final)
                           .requires_grad_(False), slots=4, max_len=128,
                           device=dev)
        a = [r.out for r in restored.run(reqs, max_ticks=4000)]
        b = [r.out for r in twin.run([Request(r.rid, r.prompt, r.max_new)
                                      for r in reqs], max_ticks=4000)]
        out.append({"arch": cfg.name, "losses": losses,
                    "printed": buf.getvalue().strip(),
                    "requests": len(reqs), "same_tokens": a == b,
                    "ok": bool(a == b and len(a) == len(reqs) and
                               f"restored checkpoint step {args.steps - 1}"
                               in buf.getvalue())})
        shutil.rmtree(d)
    return {"runs": out, "flash_attn_launches_by_variant": forward_launches(),
            "ok": all(r["ok"] for r in out)}


def phase_lm_families(dev, scratch: Path) -> tuple[dict, dict]:
    """The five families past dense at full width, one architecture at a
    time, each model freed before the next: (a) serving, (b) training,
    (c) held against the plain versions and fp32 at a cut depth; then (d)
    the new flash_attn shapes and (e) ``launch.serve --ckpt``.  Returns
    the phase line and the main paths' flash_attn launches by variant."""
    t_phase = time.perf_counter()
    runs, launches = {}, {"decode": 0, "mma": 0, "wgmma": 0, "simt": 0,
                          "simt_tiled": 0, "backward": 0}
    for name in FAMILY_SERVED + FAMILY_PREFILLED:
        free_memory()
        t0 = time.perf_counter()
        serve_fn = _family_serve if name in FAMILY_SERVED else _family_prefill
        cfg, served, counts = serve_fn(name, dev)
        trained, train_counts = _family_train(name, scratch=scratch, dev=dev)
        free_memory()
        held = _family_held(name, dev)
        for key in launches:
            launches[key] += counts.get(key, 0) + train_counts.get(key, 0)
        runs[name] = {"family": cfg.family, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model,
                      "heads": [cfg.n_heads, cfg.n_kv, cfg.hd],
                      "dtype": str(cfg.param_dtype), "serve": served,
                      "train": trained, "held": held,
                      "seconds": time.perf_counter() - t0,
                      "ok": bool(served["ok"] and trained["ok"]
                                 and held["ok"])}
    free_memory()
    attn = _family_attention(dev)
    free_memory()
    ckpt = _family_ckpt(dev, scratch)
    for kind in ("simt", "simt_tiled"):  # the reduced fp32 configs'
        launches[kind] += ckpt["flash_attn_launches_by_variant"][kind]
    return {"phase": "lm_families", "runs": runs, "flash_attn": attn,
            "ckpt": ckpt, "launches": launches,
            "seconds": time.perf_counter() - t_phase,
            "ok": bool(all(r["ok"] for r in runs.values()) and attn["ok"]
                       and ckpt["ok"])}, launches


def run_lm_families(scratch: Path) -> int:
    """``python3 chip_smoke.py --lm-families``: the env and build phases,
    then phase ``lm_families`` alone, the card's name and power limit
    last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    line, _ = phase_lm_families(dev, scratch)
    emit(line)
    print(smi, flush=True)
    return 0 if line["ok"] else 1


# ---------------------------------------------------------------------------
# Phase mesh: the port's mesh on a one-rank NCCL DeviceMesh, and the dry run
# on the production meshes
# ---------------------------------------------------------------------------

#: (b)'s decode on the mesh: slots, ticks, cache length
MESH_DECODE = (4, 8, 128)
#: (a)'s placed families at full width: (arch, sync steps, depth or None
#: for the config's own), at B=1 and phase lm_families' sequence
#: (FAMILY_TRAIN_SEQ); xlstm-1.3b at one superblock (its sLSTM loop costs
#: about 13 s a step at full depth)
MESH_FAMILIES = (("zamba2-1.2b", 2, None), ("olmoe-1b-7b", 2, None),
                 ("xlstm-1.3b", 1, 8))
#: (b)'s decodes beyond danube's
MESH_DECODED = ("zamba2-1.2b",)
#: (d)'s cells: (arch, shape, multi-pod, update)
MESH_CELLS = (("h2o-danube-1.8b", "train_4k", False, "sync"),
              ("h2o-danube-1.8b", "train_4k", True, "async"),
              ("olmoe-1b-7b", "prefill_32k", False, "sync"),
              ("minitron-4b", "decode_32k", True, "sync"),
              ("zamba2-1.2b", "long_500k", False, "sync"),
              ("zamba2-1.2b", "train_4k", False, "sync"),
              ("kimi-k2-1t-a32b", "train_4k", True, "sync"),
              ("command-r-35b", "prefill_32k", True, "sync"),
              # the cells a gathered gold logit's global [B, chunk, V]
              # block held over the card, before the vocab-parallel loss
              ("minitron-4b", "train_4k", False, "sync"),
              ("kimi-k2-1t-a32b", "train_4k", False, "sync"))
#: (d)'s cells whose per-rank peak must fit the card (the others' is
#: recorded beside it)
MESH_PEAK_HELD = (("zamba2-1.2b", "train_4k", False, "sync"),
                  ("minitron-4b", "train_4k", False, "sync"))
#: the H100's device memory, which a rank's arguments must fit
CARD_BYTES = 80e9
#: per-rank matmul flops x 256 against the unsharded step's
MESH_FLOPS_TOL = 0.10
#: a dry-run cell's time limit (a subprocess each, all at once)
MESH_CELL_TIMEOUT_S = 600


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_mesh(dev):
    """A one-rank NCCL process group and its ``(data=1, model=1)`` mesh,
    destroyed on the way out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(torch.device(dev).index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _full_tree(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _trees_err(a: dict, b: dict) -> tuple[float, bool]:
    """Max |a - b| over two trees' leaves, and whether every leaf is
    within one bf16 step (``ATTN_BF16_TOL``)."""
    err, ok = 0.0, True
    for k, x in a.items():
        x, y = x.float(), b[k].float()
        err = max(err, float((x - y).abs().max()))
        ok = ok and bool(torch.allclose(x, y, **ATTN_BF16_TOL))
    return err, ok


def _mesh_train(dev, mesh, cfg, params: dict, batches: list, *,
                lr: float = TRAIN_LR, exact: bool = False) -> tuple:
    """(a): sync steps with DTensor parameters against the mesh-less step
    on the same weights and batches; ms a step, peak memory and a profiled
    step's launches.  ``exact``: the losses and parameters on the mesh
    must equal the mesh-less steps' bit for bit, and a MoE family's
    mesh-less steps, run twice, the same bits (no
    ``torch.use_deterministic_algorithms``: every op on the path, the MoE
    combine included, sums in a fixed order).
    Returns the record, the mesh state and the main path's launches of
    flash_attn and of its backward."""
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.launch import specs as specs_mod
    from repro_torch.nn import transformer
    from repro_torch.optim.sgd import sgd
    from repro_torch.train import trainer

    opt = sgd(lr)
    p_specs = transformer.param_specs(cfg)
    plain = trainer.make_sync_step(cfg, opt)

    def plain_run():
        p, o, losses = params, opt.init(params), []
        for b in batches:
            p, o, loss = plain(p, o, b)
            losses.append(float(loss))
        return p, losses

    plain_params, plain_losses = plain_run()

    o_specs = trainer.opt_state_specs({"step": None}, p_specs)
    _, b_specs = specs_mod.batch_specs(cfg, "train", batches[0]["tokens"]
                                       .shape[1], batches[0]["tokens"]
                                       .shape[0])
    dp = trainer.distribute(params, mesh, trainer.resolve_tree(p_specs, mesh,
                                                               cfg))
    do = trainer.distribute(opt.init(params), mesh,
                            trainer.resolve_tree(o_specs, mesh, cfg))
    dbatches = [trainer.distribute(b, mesh, trainer.resolve_tree(
        b_specs, mesh, cfg)) for b in batches]
    step = trainer.make_sync_step(cfg, opt, mesh=mesh, param_specs=p_specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    ms, losses = [], []
    for b in dbatches:
        t0 = time.perf_counter()
        dp, do, loss = step(dp, do, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = common.LAUNCHES["flash_attn"]
    by_variant = forward_launches()
    bwd_launches = common.LAUNCHES["flash_attn_bwd"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    err, held = _trees_err(_full_tree(dp), plain_params)
    placements = {k: [repr(x) for x in v.placements] for k, v in
                  list(dp.items())[:3]}
    attn = _attention_layers(cfg)
    kind = attn_ops.call_variant(cfg.param_dtype, batches[0]["tokens"]
                                 .shape[1], cfg.n_heads // cfg.n_kv, cfg.hd,
                                 lse=True)
    names = KERNEL_SYMBOLS["flash_attn"][kind] + KERNEL_SYMBOLS[
        "flash_attn_bwd"]["wgmma"]
    prof = (counted(lambda: step(dp, do, dbatches[0]), names)[1]
            if attn else dict.fromkeys(names, 0))
    loss_err = max(abs(a - b) for a, b in zip(losses, plain_losses))
    state, repeats = (dp, do), None
    if exact and cfg.family == "moe":  # its steps again, once the mesh's
        # state is freed
        del dp, do, state
        free_memory()
        again, again_losses = plain_run()
        repeats = bool(again_losses == plain_losses and all(
            torch.equal(again[k], plain_params[k]) for k in plain_params))
        del again
        state = None
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "batch": list(batches[0]["tokens"].shape), "lr": lr,
           "losses": losses, "plain_losses": plain_losses,
           "loss_max_abs_err": loss_err, "params_max_abs_err": err,
           "exact": exact, "plain_repeats_bit_for_bit": repeats,
           "ms_per_step": ms, "peak_gb": peak, "launches": launches,
           "expected_launches": 2 * attn * len(batches),
           "bwd_launches": bwd_launches,
           "expected_bwd_launches": attn * len(batches),
           "profiled_step_launches": prof,
           "placements": placements}
    if exact:
        held = (repeats is not False and err == 0 and loss_err == 0
                and all(np.isfinite(losses)))
    else:
        held = held and all(np.isclose(a, b, **ATTN_BF16_TOL)
                            for a, b in zip(losses, plain_losses))
    rec["ok"] = bool(held and launches == rec["expected_launches"]
                     and bwd_launches == rec["expected_bwd_launches"]
                     and prof[names[0]] == 2 * attn
                     # one step's backward ran the wgmma pair a layer
                     and all(prof[n] == attn for n in names[1:]))
    del plain_params
    rec["flash_attn_variant"] = kind
    rec["launches_by_variant"] = by_variant
    return rec, state, {**by_variant, "backward": bwd_launches}


def _mesh_decode(dev, mesh, cfg, params: dict, *,
                 exact: bool = False) -> tuple[dict, int]:
    """(b): decode ticks with DTensor parameters and caches against the
    mesh-less decode on the same weights and tokens (``exact``: the
    logits bit for bit)."""
    from repro_torch.kernels import common
    from repro_torch.launch import specs as specs_mod
    from repro_torch.nn import decode, transformer
    from repro_torch.train import trainer

    b, ticks, max_len = MESH_DECODE
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (b, ticks))).to(dev)
    lm = transformer.LM.from_tree(params)
    plain_step = trainer.make_decode_step(cfg)
    cache = decode.init_cache(cfg, b, max_len, device=dev)
    plain = []
    for t in range(ticks):
        logits, cache = plain_step(lm, cache, {"tokens": tokens[:, t:t + 1]},
                                   t)
        plain.append(logits)
    del cache

    p_specs = transformer.param_specs(cfg)
    dlm = transformer.LM.from_tree(trainer.distribute(
        params, mesh, trainer.resolve_tree(p_specs, mesh, cfg)))
    c_shapes, c_specs = specs_mod.cache_shapes_and_specs(cfg, b, max_len)
    dcache = trainer.distribute(decode.init_cache(cfg, b, max_len,
                                                  device=dev), mesh,
                                trainer.resolve_tree(c_specs, mesh, cfg))
    _, b_specs = specs_mod.batch_specs(cfg, "decode", 1, b)
    b_pl = trainer.resolve_tree(b_specs, mesh, cfg)
    step = trainer.make_decode_step(cfg, mesh)
    ins = [trainer.distribute({"tokens": tokens[:, t:t + 1]}, mesh, b_pl)
           for t in range(ticks)]
    torch.cuda.synchronize()
    common.reset_launches()
    ms, err, held = [], 0.0, True
    for t in range(ticks):
        t0 = time.perf_counter()
        logits, dcache = step(dlm, dcache, ins[t], t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        err = max(err, float((logits - plain[t]).abs().max()))
        held = held and bool(torch.allclose(logits, plain[t],
                                            **ATTN_BF16_TOL))
    launches = common.LAUNCHES["flash_attn"]
    prof = counted(lambda: step(dlm, dcache, ins[-1], ticks - 1),
                   ("flash_attn_decode_kernel",))[1]
    attn = _attention_layers(cfg)
    rec = {"arch": cfg.name, "slots": b, "ticks": ticks, "max_len": max_len,
           "logits_max_abs_err": err, "ms_per_tick": ms,
           "ms_per_tick_median": statistics.median(ms[1:]),
           "launches": launches, "expected_launches": attn * ticks,
           "profiled_tick_launches": prof,
           "cache_placements": {k: [repr(x) for x in v.placements]
                                for k, v in dcache.items()}}
    if exact:
        held = err == 0
    rec["ok"] = bool(held and launches == rec["expected_launches"]
                     and prof["flash_attn_decode_kernel"] == attn)
    return rec, launches


def _mesh_rescale(dev, mesh, state, scratch: Path) -> dict:
    """(c): the state of (a) to the bare card and back with
    ``elastic_rescale``, and through a checkpoint written on the mesh and
    restored onto it (``tests/test_torch_mesh_state.py`` restores one onto
    another mesh and onto one device)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train import fault

    params, opt_state = state
    tree = {"params": params, "opt": opt_state}
    where = {"params": {k: str(dev) for k in params}, "opt": {"step": str(
        dev)}}
    back = {"params": {k: (mesh, v.placements) for k, v in params.items()},
            "opt": {k: (mesh, v.placements) for k, v in opt_state.items()}}
    t0 = time.perf_counter()
    bare = fault.elastic_rescale(tree, where)
    again = fault.elastic_rescale(bare, back)
    torch.cuda.synchronize()
    rescale_s = time.perf_counter() - t0
    full = _full_tree(tree)

    def equal(a, b):
        return all(torch.equal(_full_tree(a)[g][k], b[g][k])
                   for g in ("params", "opt") for k in b[g])

    t0 = time.perf_counter()
    save_checkpoint(scratch / "mesh_ckpt", 2, tree)
    save_s = time.perf_counter() - t0
    on_mesh, step = load_checkpoint(scratch / "mesh_ckpt", tree)
    shutil.rmtree(scratch / "mesh_ckpt", ignore_errors=True)
    rec = {"rescale_s": rescale_s, "save_s": save_s,
           "bare_equal": equal(bare, full), "back_equal": equal(again, full),
           "restored_on_mesh_equal": equal(on_mesh, full), "step": step,
           "bare_types": sorted({type(v).__name__
                                 for v in bare["params"].values()})}
    rec["ok"] = bool(rec["bare_equal"] and rec["back_equal"]
                     and rec["restored_on_mesh_equal"] and step == 2
                     and rec["bare_types"] == ["Tensor"])
    return rec


#: a step on one unsharded fake rank (arch, kind, seq, global batch), with
#: the dry run's counters: the dense sync cell's, for the flops check, and
#: phase lm_train (a)'s, for the roofline bound
_UNSHARDED = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.launch import dryrun
arch, kind, seq, gb = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:5])
with dryrun.fake_world(1):
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    print(json.dumps(dryrun.run_step(configs.get(arch), kind, seq, gb, mesh,
                                     device="cuda")))
"""
#: phase lm_train (a)'s step, traced for its roofline bound: (arch, batch,
#: sequence), TRAIN_ARGV's
DANUBE_STEP = ("h2o-danube-1.8b", 2, 8192)


def start_mesh_dryrun() -> dict:
    """(d)'s processes, all started at once: the cells, each ``python -m
    repro_torch.launch.dryrun`` with cuda fakes, the dense sync cell's step
    on one unsharded fake rank, and DANUBE_STEP's step on one.  The full
    run starts them with phase ``lm_families``, whose work is on the card,
    so that they trace on the host meanwhile; ``_mesh_dryrun`` reads
    them."""
    from repro_torch import configs

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def start(cmd):
        # output to files: a pipe nobody reads for minutes would fill and
        # stall the process
        out, err = (tempfile.TemporaryFile(mode="w+") for _ in range(2))
        return subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                                env=env, cwd=ROOT), out, err

    procs = {}
    for arch, shape, multi, update in MESH_CELLS:
        procs[(arch, shape, multi, update)] = start(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--update", update]
            + (["--multipod"] if multi else []))
    dense = MESH_CELLS[0]
    procs["unsharded"] = start([sys.executable, "-c", _UNSHARDED, dense[0],
                                *map(str, configs.SHAPES[dense[1]])])
    # at the lowest priority: the cells, the longest of them zamba2's,
    # keep the host's cores, and this trace takes what they leave
    arch, b, seq = DANUBE_STEP
    procs["danube_step"] = start(["nice", "-n", "19", sys.executable, "-c",
                                  _UNSHARDED, arch, "train", str(seq),
                                  str(b)])
    # a run that stops before phase mesh reads them leaves none behind
    atexit.register(lambda: [proc.kill() for proc, _, _ in procs.values()
                             if proc.poll() is None])
    return {"procs": procs, "t0": time.perf_counter()}


def _read_back(f) -> str:
    """What a process wrote to the temporary file ``f``; closes it."""
    with f:
        f.seek(0)
        return f.read()


def _roofline_row(arch: str, shape: str, mesh: str, kind: str, seq: int,
                  gb: int, res: dict) -> dict:
    """``roofline.analysis``'s row for one traced step, or the error it
    raised; ``ok`` where its three terms are finite and positive (a
    one-rank step's collective term may be 0)."""
    from repro_torch.roofline import analysis
    try:
        row = analysis.analyze({"arch": arch, "shape": shape, "mesh": mesh,
                                "kind": kind, "seq": seq, "global_batch": gb,
                                **res, "status": "ok"})
    except (KeyError, TypeError, ValueError, ZeroDivisionError) as e:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": repr(e), "ok": False}
    terms = [row["compute_s"], row["memory_s"]] + (
        [row["collective_s"]] if mesh != "1x1" else [])
    row["ok"] = all(math.isfinite(t) and t > 0 for t in terms)
    return row


#: a dry-run cell's roofline keys in phase mesh's line
ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_bound_s", "model_flops_per_dev",
                 "dot_flops_per_dev", "dot_flops_by_dtype",
                 "useful_compute_ratio", "hbm_bytes_per_dev", "hbm_top",
                 "collective_bytes_per_dev", "collective_by_kind",
                 "collective_by_link", "error", "ok")


def _roofline_table(rows: list[dict]) -> None:
    """(d)'s rows in ``dryrun_results/torch/roofline_mesh_cells.{json,md}``
    (the dry run's results directory, which ``.gitignore`` lists)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    dryrun.RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = dryrun.RESULTS_DIR / "roofline_mesh_cells"
    out.with_suffix(".json").write_text(json.dumps(rows, indent=1))
    out.with_suffix(".md").write_text(analysis.to_markdown(rows))


def _danube_bound(row: dict, measured_ms: float, source: str) -> dict:
    """Phase lm_train (a)'s step against the least time the card could
    take for the work its trace counted: the larger of its dot flops over
    the peaks and its traffic over the HBM bandwidth (one rank: no
    collective).  A bound above the measured step would mean the counts
    are wrong."""
    rec = {k: row.get(k) for k in ("compute_s", "memory_s",
                                   "model_flops_global", "dot_flops_per_dev",
                                   "dot_flops_by_dtype", "useful_compute_ratio",
                                   "hbm_bytes_per_dev", "hbm_top", "trace_s",
                                   "error")}
    rec.update(measured_ms=measured_ms, measured_by=source,
               nvidia_smi=nvidia_smi())
    if "error" in row or not row["ok"]:
        return {**rec, "ok": False}
    bound_ms = max(row["compute_s"], row["memory_s"]) * 1e3
    rec.update(bound_ms=bound_ms, bound_by="operations" if row["compute_s"]
               >= row["memory_s"] else "bytes",
               measured_over_bound=measured_ms / bound_ms)
    rec["ok"] = bool(bound_ms <= measured_ms)
    return rec


def _mesh_dryrun(started: dict) -> dict:
    """(d): the results of ``start_mesh_dryrun``'s processes, each within
    MESH_CELL_TIMEOUT_S of their start, and each cell's roofline row."""
    from repro_torch import configs
    procs, t0 = started["procs"], started["t0"]
    out = {}
    for key, (proc, out_file, err_file) in procs.items():
        try:
            proc.wait(timeout=max(1.0, MESH_CELL_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        stdout, stderr = (_read_back(f) for f in (out_file, err_file))
        if proc.returncode == 0:
            out[key] = json.loads(stdout.strip().splitlines()[-1])
        else:
            out[key] = {"status": "fail", "rc": proc.returncode,
                        "stderr": stderr[-2000:]}
    cells, roofline = [], []
    for arch, shape, multi, update in MESH_CELLS:
        r = out[(arch, shape, multi, update)]
        row = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi else "16x16", "update": update,
               "status": r.get("status")}
        if r.get("status") == "ok":
            mem = r["memory"]
            row.update({
                "argument_gb": mem["argument_bytes"] / 1e9,
                "output_gb": mem["output_bytes"] / 1e9,
                "peak_gb": mem["peak_bytes"] / 1e9,
                "flops": r["cost_analysis"]["flops"],
                "matmul_flops": r["matmul_flops"],
                "place_s": r["lower_s"], "trace_s": r["compile_s"],
                "collective_bytes": r["collective_bytes"],
                "largest_live": mem["largest_live"],
                "fits_card": mem["argument_bytes"] <= CARD_BYTES,
                # held for MESH_PEAK_HELD's cells, recorded for the others
                "peak_fits_card": mem["peak_bytes"] <= CARD_BYTES,
                "peak_held": (arch, shape, multi, update) in MESH_PEAK_HELD})
            kind, seq, gb = configs.SHAPES[shape]
            roof = _roofline_row(arch, shape, row["mesh"], kind, seq, gb, r)
            roofline.append({**roof, "update": update})
            row["roofline"] = {k: roof.get(k) for k in ROOFLINE_KEYS}
        else:
            row["error"] = r.get("stderr", "")[-600:]
        cells.append(row)
    _roofline_table(roofline)
    un = out["unsharded"]
    arch, b, seq = DANUBE_STEP
    danube = (_roofline_row(arch, f"B={b} S={seq}", "1x1", "train", seq, b,
                            out["danube_step"])
              if out["danube_step"].get("status") != "fail" else
              {"error": out["danube_step"].get("stderr", "")[-600:],
               "ok": False})
    danube["trace_s"] = out["danube_step"].get("compile_s")
    first = cells[0]
    ratio = (first["matmul_flops"] * 256 / un["matmul_flops"]
             if first["status"] == "ok" and "matmul_flops" in un else None)
    return {"cells": cells, "seconds": time.perf_counter() - t0,
            "unsharded_matmul_flops": un.get("matmul_flops"),
            "unsharded_flops": un.get("cost_analysis", {}).get("flops"),
            "unsharded_error": un.get("stderr", "")[-600:] or None,
            "dense_flops_ratio": ratio,
            "peak_over_card": [f"{c['arch']} {c['shape']} {c['mesh']}"
                               for c in cells
                               if not c.get("peak_fits_card", True)],
            "trace_s": {f"{c['arch']} {c['shape']} {c['mesh']} "
                        f"{c['update']}": c.get("trace_s") for c in cells},
            "danube_step": danube,
            "ok": bool(all(c["status"] == "ok" and c["fits_card"]
                           and (c["peak_fits_card"] or not c["peak_held"])
                           and c["roofline"]["ok"]
                           for c in cells)
                       and ratio is not None
                       and abs(ratio - 1) <= MESH_FLOPS_TOL)}


def _mesh_family(dev, mesh, name: str, steps: int,
                 depth: int | None) -> tuple[dict, dict]:
    """(a) and (b) for a placed family: its sync steps at full width (and
    ``depth`` layers where given), seeded random weights, B=1 at phase
    lm_families' sequence, held bit for bit to the mesh-less step; then,
    for MESH_DECODED, its decode ticks bit for bit.  Returns the record
    and its flash_attn launches by variant."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.nn import transformer

    free_memory()
    cfg = configs.get(name)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    lm = transformer.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    gen = train.make_batch_fn(cfg, 1, FAMILY_TRAIN_SEQ[name], seed=13,
                              device=dev)
    batches = [next(gen) for _ in range(steps)]
    t0 = time.perf_counter()
    rec, state, launches = _mesh_train(
        dev, mesh, cfg, params, batches, exact=True,
        lr=FAMILY_TRAIN_LR.get(name, FAMILY_TRAIN_LR_DEFAULT))
    rec["seconds"] = time.perf_counter() - t0
    del state, batches
    out, launches = {"train": rec}, {**launches, "decode": 0}
    if name in MESH_DECODED:
        t0 = time.perf_counter()
        out["decode"], launches["decode"] = _mesh_decode(dev, mesh, cfg,
                                                         params, exact=True)
        out["decode"]["seconds"] = time.perf_counter() - t0
    del params
    free_memory()
    out["ok"] = all(r["ok"] for r in out.values())
    return out, launches


def phase_mesh(dev, scratch: Path, dryrun: dict | None = None,
               step_ms: float | None = None) -> tuple[dict, dict]:
    """The port's mesh on the card: (a) two sync steps of full-width
    h2o-danube-1.8b on a one-rank NCCL ``(data=1, model=1)`` mesh with
    DTensor parameters, held to the mesh-less step, and MESH_FAMILIES'
    placed families (zamba2's Mamba2 on its heads, olmoe's experts,
    xlstm's mLSTM on its key dim and sLSTM on its rows) held bit for bit;
    (b) decode ticks on the mesh held to the mesh-less decode, danube's
    and zamba2's; (c) ``elastic_rescale`` and a checkpoint round trip of
    (a)'s danube state; (d) the dry run's cells on the production meshes,
    each with its roofline row (``roofline.analysis`` on the card's peaks
    and links), and DANUBE_STEP's trace on one fake rank, whose bound must
    not exceed phase lm_train (a)'s steady step (``step_ms``; without it,
    as in ``--mesh``, (a)'s second step on the one-rank mesh).
    (d)'s processes are the ones ``dryrun`` started (``start_mesh_dryrun``),
    else started here; they are read first, so that none holds a CUDA
    context while (a) trains.  Returns the phase line and (a)'s and (b)'s
    launches of flash_attn by variant and of its backward, counted from
    zero around each."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.nn import transformer

    t_phase = time.perf_counter()
    dry = _mesh_dryrun(dryrun or start_mesh_dryrun())
    free_memory()
    cfg = configs.get("h2o-danube-1.8b")
    lm = transformer.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    gen = train.make_batch_fn(cfg, 2, LM_PREFILL, seed=13, device=dev)
    batches = [next(gen) for _ in range(2)]
    families = {}
    with one_rank_mesh(dev) as mesh:
        t0 = time.perf_counter()
        sync, state, train_launches = _mesh_train(dev, mesh, cfg, params,
                                                  batches)
        sync["seconds"] = time.perf_counter() - t0
        del batches
        t0 = time.perf_counter()
        dec, decode_launches = _mesh_decode(dev, mesh, cfg, params)
        dec["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rescale = _mesh_rescale(dev, mesh, state, scratch)
        rescale["seconds"] = time.perf_counter() - t0
        del state, params
        for name, steps, depth in MESH_FAMILIES:
            families[name], launches = _mesh_family(dev, mesh, name, steps,
                                                    depth)
            for key, n in launches.items():
                if key != "decode":
                    train_launches[key] = train_launches.get(key, 0) + n
            decode_launches += launches["decode"]
    free_memory()
    source = "phase lm_train (a), steady ms a step"
    if step_ms is None:
        step_ms, source = sync["ms_per_step"][-1], "phase mesh (a), step 2"
    dry["danube_step"] = _danube_bound(dry["danube_step"], step_ms, source)
    return {"phase": "mesh", "arch": cfg.name, "mesh": "(data=1, model=1) "
            "NCCL", "train": sync, "decode": dec, "rescale": rescale,
            "families": families, "dryrun": dry, "nvidia_smi": nvidia_smi(),
            "seconds": time.perf_counter() - t_phase,
            "ok": bool(sync["ok"] and dec["ok"] and rescale["ok"]
                       and all(f["ok"] for f in families.values())
                       and dry["ok"] and dry["danube_step"]["ok"])}, {
        **train_launches, "decode": decode_launches}


def run_mesh(scratch: Path) -> int:
    """``python3 chip_smoke.py --mesh``: the env and build phases, then
    phase ``mesh`` alone, the card's name and power limit last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    line, _ = phase_mesh(dev, scratch)
    emit(line)
    print(smi, flush=True)
    return 0 if line["ok"] else 1


# ---------------------------------------------------------------------------
# Phase examples: the example twins on the card
# ---------------------------------------------------------------------------

#: each twin's arguments: its smoke size, on the card (no ``--device``)
EXAMPLES = (("torch_quickstart", []), ("torch_paper_study", []),
            ("torch_serve_lm", []), ("torch_train_lm", ["--steps", "10"]))


def phase_examples(scratch: Path) -> dict:
    """``examples/torch_*.py`` in this process (no start-up of their own),
    each through its ``main`` with no ``--device``: on ``cuda``, the
    port's kernels.  Their launches join no kernels-line count."""
    runs, t_phase = [], time.perf_counter()
    for name, argv in EXAMPLES:
        if name == "torch_train_lm":
            argv = argv + ["--ckpt", str(scratch / "train_lm_ckpt")]
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        buf, t0 = io.StringIO(), time.perf_counter()
        try:
            spec.loader.exec_module(mod)
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            error = None
        except (Exception, SystemExit) as e:  # a twin's failure is the row's
            error = repr(e)
        torch.cuda.synchronize()
        runs.append({"example": name, "argv": argv,
                     "seconds": time.perf_counter() - t0, "error": error,
                     "printed": buf.getvalue().strip().splitlines()[-6:],
                     "on_cuda": "cuda" in buf.getvalue()})
        free_memory()
    shutil.rmtree(scratch / "train_lm_ckpt", ignore_errors=True)
    return {"phase": "examples", "runs": runs,
            "seconds": time.perf_counter() - t_phase,
            "ok": all(r["error"] is None and r["on_cuda"] for r in runs)}


# ---------------------------------------------------------------------------
# Phase bench: the kernel bench, the tuner's candidates, the services'
# benches with the health monitor, and the host cost of the tuner's consult
# ---------------------------------------------------------------------------

#: the roofline share a bench row may reach before its bound is suspect
#: (wall times on the host's clock hold a launch's overhead, so a share
#: near 1 would mean the bound counts work the kernel does not do)
BENCH_MAX_FRACTION = 1.05
#: the flush stall injected into the monitored serving drive, past the
#: default latency SLO's 0.5 s p99
BENCH_FAULT_STALL_S = 0.6


def _breach_counts() -> dict[str, int]:
    from repro_torch.obs import metrics
    from repro_torch.obs.monitor import BREACH_PREFIX

    return {k[len(BREACH_PREFIX):]: v
            for k, v in metrics.snapshot()["counters"].items()
            if k.startswith(BREACH_PREFIX)}


def _quiet(fn):
    """``fn()`` with its prints (a producer's table) kept off stdout."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _bench_kernels(results: Path) -> dict:
    """``bench_kernels.run("paper")`` cold, then warm: every row checked on
    the card and true, every roofline share at most BENCH_MAX_FRACTION,
    both gates clean, the warm file byte-identical; launch counts zeroed
    just before the cold run and read just after."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels import common
    from repro_torch.study import claims

    out = results / "BENCH_kernels.json"
    common.reset_launches()
    t0 = time.perf_counter()
    rows = _quiet(lambda: bench_kernels.run("paper", out_json=out))
    seconds = time.perf_counter() - t0
    launches = {k: common.LAUNCHES[k] for k in bench_kernels.SHAPES}
    cold = out.read_bytes()
    warm = _quiet(lambda: bench_kernels.run("paper", out_json=out))
    gate = claims.check_bench_kernels(rows) + claims.check_bench_kernels(warm)
    byte_identical = out.read_bytes() == cold
    bad = [r["label"] for r in rows
           if r["pallas_match"] is not True
           or r["checked_backends"] != [common.CUDA]
           or r["roofline"]["roofline_fraction"] > BENCH_MAX_FRACTION]
    return {
        "ok": not bad and not gate and byte_identical
        and all(launches.values()),
        "seconds": seconds, "launches": launches, "bad_rows": bad,
        "violations": gate, "warm_byte_identical": byte_identical,
        "rows": [{"label": r["label"], "config": r["config"],
                  "wall_s": r["wall_s"], "pallas_match": r["pallas_match"],
                  "bound_s": r["roofline"]["bound_s"],
                  "bound": r["roofline"]["bound"],
                  "roofline_fraction": r["roofline"]["roofline_fraction"]}
                 for r in rows]}


def _tuner_cases(dev, covtype, w8a, realsim) -> list[tuple]:
    """(family, shape label, info, run(**cfg), tol, device-time reps) for
    each family at the bench's shape and at the main paths' shapes."""
    import repro_torch.kernels as K
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.core import sgd

    cases = []
    for kernel, shapes in bench_kernels.SHAPES.items():
        fam = bench_kernels._make_family(kernel, shapes["paper"], "float32",
                                         dev)
        tol = {"glm_sgd": EPOCH_TOL, "glm_sgd_sparse": EPOCH_TOL,
               "flash_attn": ATTN_TOL}.get(kernel, GRAD_TOL)
        cases.append((kernel, f"bench paper {shapes['paper']}", fam.info,
                      fam.call, tol, 20))
    rng = np.random.default_rng(3)
    # the serving bench's widest cell (bench_serve.PROFILES["ci"]: d=512,
    # batch 32, K=16): glm_score has no bench_kernels shape
    vb, ib, _, wb = _ell_inputs(rng, 32, 512, 16 * 0.6, 16, dev, seed=5)
    cases.append(("glm_score", "bench serve ci N=32 K=16 d=512",
                  {"dtype": "float32", "sparse": True, "n": 32, "d": 512,
                   "k": 16},
                  lambda **c: K.glm_score("lr", wb, vb, ib, **c), GRAD_TOL,
                  200))

    X, yd = covtype
    n, d = X.shape
    w = torch.from_numpy(rng.normal(0, 0.1, d).astype(np.float32)).to(dev)
    cases.append(("glm_grad", f"covtype N={n} d={d} row",
                  {"dtype": "float32", "n": n, "d": d},
                  lambda **c: K.glm_grad("lr", w, X, yd, **c), GRAD_TOL, 20))
    m, ys = w8a
    ns, k = m.values.shape
    ws = torch.from_numpy(rng.normal(0, 0.1, m.d).astype(np.float32)).to(dev)
    parts = torch.from_numpy(sgd.partition_indices(ns, 10)).to(dev).long()
    vp, ip, yp = m.values[parts], m.indices[parts], ys[parts]
    W10 = ws[None].repeat(10, 1)
    cases.append(("glm_sparse", f"w8a N={ns} K={k} d={m.d} R=1",
                  {"dtype": "float32", "sparse": True, "n": ns, "d": m.d,
                   "k": k, "replicas": 1},
                  lambda **c: K.ell_glm_grad("lr", ws, m.values, m.indices,
                                             ys, **c), GRAD_TOL, 20))
    cases.append(("glm_sparse", f"w8a R=10 per={vp.shape[1]} K={k} d={m.d}",
                  {"dtype": "float32", "sparse": True, "n": vp.shape[1],
                   "d": m.d, "k": k, "replicas": 10},
                  lambda **c: K.ell_glm_grad("lr", W10, vp, ip, yp, **c),
                  GRAD_TOL, 20))
    mr = realsim.ell
    wr = torch.from_numpy(rng.normal(0, 0.1, mr.d).astype(np.float32)).to(dev)
    for data, ell, wsc in (("w8a", m, ws), ("real-sim", mr, wr)):
        v, i = ell.values[:128], ell.indices[:128]
        cases.append(("glm_score", f"{data} N=128 K={v.shape[1]} d={ell.d}",
                      {"dtype": "float32", "sparse": True, "n": 128,
                       "d": ell.d, "k": v.shape[1]},
                      lambda v=v, i=i, wsc=wsc, **c: K.glm_score(
                          "lr", wsc, v, i, **c), GRAD_TOL, 200))
    for sk in (128, 4096):
        shape = (4, 32, 8, 1, sk, 80)
        qa, ka, va = _attn_inputs(shape, torch.bfloat16, dev, seed=7)
        cases.append(("flash_attn", f"danube decode B,Hq,Hkv,Sq,Sk,hd="
                      f"{list(shape)}",
                      {"dtype": "bfloat16", "batch": 4, "heads_q": 32,
                       "heads_kv": 8, "seq_q": 1, "seq_k": sk,
                       "head_dim": 80},
                      lambda qa=qa, ka=ka, va=va, **c: K.flash_attention(
                          qa, ka, va, causal=False, **c), ATTN_BF16_TOL, 200))
    cases.append(("glm_sgd", f"covtype N={n} d={d} B=16",
                  {"dtype": "float32", "n": n, "d": d, "micro_batch": 16},
                  lambda **c: K.glm_sgd_epoch("lr", w, X, yd, step=0.01,
                                              **c), EPOCH_TOL, 2))
    cases.append(("glm_sgd_sparse", f"w8a R=10 per={vp.shape[1]} K={k} "
                  f"d={m.d} B=10",
                  {"dtype": "float32", "sparse": True, "n": vp.shape[1],
                   "d": m.d, "k": k, "replicas": 10, "micro_batch": 10},
                  lambda **c: K.ell_sgd_epoch("lr", W10, vp, ip, yp,
                                              step=0.2, **c), EPOCH_TOL, 5))
    return cases


def canonical(cfg: dict) -> str:
    """A tuner config as a key (``{"splits": 8}`` -> ``'{"splits": 8}'``)."""
    return json.dumps(cfg, sort_keys=True)


#: rows a covtype epoch is held to its plain version on: the plain version's
#: loop at covtype's 581,012 rows takes a minute at micro-batch 1 (phase
#: parity holds the same prefix)
TUNER_SGD_ROWS = 4_100


def _tuner_candidates(dev, covtype, w8a, realsim, results: Path) -> list:
    """Every candidate of every tunable, held against the plain version at
    each case's shape (covtype's epochs on its first TUNER_SGD_ROWS rows),
    then the tuner's sweep there and the device time of its winner beside
    the plan's own pick."""
    import repro_torch.kernels as K
    from repro_torch.kernels import common, tune

    cache = tune.TuneCache(results / "tuner_cache")
    X, yd = covtype
    out = []
    for kernel, label, info, run, tol, reps in _tuner_cases(
            dev, covtype, w8a, realsim):
        check = run
        if label.startswith("covtype") and kernel == "glm_sgd":
            Xc, yc = X[:TUNER_SGD_ROWS], yd[:TUNER_SGD_ROWS]
            wc = torch.zeros(X.shape[1], device=dev)

            def check(**c):
                return K.glm_sgd_epoch("lr", wc, Xc, yc, step=0.01, **c)
        tunable = tune.TUNABLES[kernel]
        pick = tunable.pick(info)
        plain, checked = {}, []
        for cfg in tunable.candidates(info):
            mb = cfg.get("micro_batch")
            if mb not in plain:  # only a micro-batch changes the function
                with common.plain_versions():
                    plain[mb] = check(**cfg)
            err, ok = close(check(**cfg), plain[mb], tol)
            checked.append({"config": cfg, "max_abs_err": err, "ok": ok})
        rec = tune.tune(kernel, common.CUDA, info, run, cache=cache)
        names = tuple(s for syms in KERNEL_SYMBOLS[kernel].values()
                      for s in syms)
        # device times in turns (plan, winner, winner, plan), each the
        # mean of its two, so neither gains from running second
        times = {}
        order = [pick] if rec["config"] == pick else \
            [pick, rec["config"], rec["config"], pick]
        for cfg in order:
            times.setdefault(canonical(cfg), []).append(kernel_device_time(
                lambda: run(**cfg), reps, names)["device_ms"])
        times = {k: sum(v) / len(v) for k, v in times.items()}
        out.append({"kernel": kernel, "shape": label, "plan": pick,
                    "winner": rec["config"],
                    "plan_device_ms": times[canonical(pick)],
                    "winner_device_ms": times[canonical(rec["config"])],
                    "sweep_wall_s": {canonical(r["config"]): r["wall_s"]
                                     for r in rec["candidates"]},
                    "checks": checked,
                    "ok": bool(checked) and all(c["ok"] for c in checked)})
    return out


def _services(results: Path) -> dict:
    """``bench_serve.run("ci")`` with 1 and 2 consumers and
    ``bench_live.run("ci")``, their gates clean; then a monitored shadow
    drive of each, clean and with its fault: the clean ones must report no
    breach, ``--fault-stall`` a ``latency_p99`` breach and
    ``publish-stall`` a ``staleness`` one."""
    from repro_torch.benchmarks import bench_live, bench_serve
    from repro_torch.kernels import common
    from repro_torch.study import claims

    common.reset_launches()
    t0 = time.perf_counter()
    serve1 = _quiet(lambda: bench_serve.run(
        "ci", out_json=results / "BENCH_serve.json"))
    serve2 = _quiet(lambda: bench_serve.run(
        "ci", out_json=results / "BENCH_serve.json", consumers=2))
    live = _quiet(lambda: bench_live.run(
        "ci", out_json=results / "BENCH_live.json"))
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    seconds = time.perf_counter() - t0
    gates = (claims.check_bench_serve(serve1 + serve2)
             + claims.check_bench_live(live))
    monitored = []
    for name, fn, want in (
            ("serve", lambda: bench_serve.run(
                "ci", out_json=results / "mon_serve.json", monitor=True),
             None),
            ("serve --fault-stall", lambda: bench_serve.run(
                "ci", out_json=results / "mon_serve.json", monitor=True,
                fault_stall_s=BENCH_FAULT_STALL_S), "latency_p99"),
            ("live", lambda: bench_live.run(
                "ci", out_json=results / "mon_live.json", monitor=True),
             None),
            ("live --fault publish-stall", lambda: bench_live.run(
                "ci", out_json=results / "mon_live.json", monitor=True,
                fault="publish-stall"), "staleness")):
        before = _breach_counts()
        _quiet(fn)
        after = _breach_counts()
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v > before.get(k, 0)}
        ok = delta.get(want, 0) > 0 if want else not delta
        monitored.append({"run": name, "breaches": delta, "want": want,
                          "ok": ok})
    points = [{k: r.get(k) for k in ("label", "p50_s", "p99_s", "rps",
                                     "pallas_match", "checked_backends",
                                     "wall_s", "steps_per_s", "losses",
                                     "max_staleness_steps",
                                     "staleness_bound_steps")
               if r.get(k) is not None}
              for r in serve1 + serve2 + live]
    checked = all(r["pallas_match"] is True
                  and r["checked_backends"] == [common.CUDA]
                  for r in serve1 + serve2)
    return {"ok": not gates and checked and launches.get("glm_score", 0) > 0
            and all(m["ok"] for m in monitored),
            "seconds": seconds, "launches": launches, "violations": gates,
            "points": points, "monitored": monitored}


def paired_host_us(a, b, rounds: int = 20, blocks: int = 10,
                   block: int = 10) -> tuple[float, float]:
    """Host us per call of ``a`` and of ``b``, timed in alternating blocks
    of ``block`` calls, ``blocks`` pairs a round, each round behind a spin
    kernel that keeps the card busy (about 10 ms), so the calls only
    enqueue: the two share every round's conditions, and their difference
    is what ``b`` adds to ``a``."""
    a(), b()
    torch.cuda.synchronize()
    ta = tb = 0.0
    for _ in range(rounds):
        torch.cuda._sleep(10 * SLEEP_CYCLES)
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(block):
                a()
            t1 = time.perf_counter()
            for _ in range(block):
                b()
            tb += time.perf_counter() - t1
            ta += t1 - t0
        torch.cuda.synchronize()
    n = rounds * blocks * block
    return ta / n * 1e6, tb / n * 1e6


def _consult_cost(dev, w8a) -> dict:
    """The host cost of the tuner's memoised consult, with an empty cache
    and with a cached record (the plan's own pick, so every launch is the
    same):

    * ``added_us``: the work an unpinned wrapper call adds once its call
      was consulted — the call's key, the memo's answer (``tune.known``)
      and ``dispatch``'s second resolution of the flavor the wrapper
      resolved (the first one, with its read of the environment, was
      ``dispatch``'s own before) — timed alone over 100,000 calls;
    * ``wrapper_us``: host us per call of the decode wrapper (danube's
      serving shape, 4 slots over 128 keys) and of ``glm_score`` at a w8a
      flush (128 x 69), with the tuned argument pinned and unpinned, in
      alternating blocks (``paired_host_us``);
    * ``flush_us``: wall us of a ``GLMScoreEngine.flush`` of 128 w8a rows
      (one unpinned ``glm_score`` call), in turns: empty, record, record,
      empty.

    Each time the record is written, the next consult reads it once (the
    hit counter moves by one each time); the cache is left empty."""
    import repro_torch.kernels as K
    from repro_torch.kernels import common, tune
    from repro_torch.obs import metrics
    from repro_torch.serve.glm import GLMScoreEngine

    qa, ka, va = _attn_inputs((4, 32, 8, 1, 128, 80), torch.bfloat16, dev,
                              seed=7)
    m, _ = w8a
    rng = np.random.default_rng(4)
    ws = torch.from_numpy(rng.normal(0, 0.1, m.d).astype(np.float32)).to(dev)
    v, i = m.values[:128], m.indices[:128]
    calls = {
        "flash_attn": ({"dtype": "bfloat16", "batch": 4, "heads_q": 32,
                        "heads_kv": 8, "seq_q": 1, "seq_k": 128,
                        "head_dim": 80},
                       (qa.dtype, 4, 32, 8, 1, 128, 80), qa.device,
                       lambda **c: K.flash_attention(qa, ka, va,
                                                     causal=False, **c)),
        "glm_score": ({"dtype": "float32", "sparse": True, "n": 128,
                       "d": m.d, "k": v.shape[1]},
                      (v.dtype, 128, v.shape[1], m.d), v.device,
                      lambda **c: K.glm_score("lr", ws, v, i, **c)),
    }
    reqs = _requests(m.values[:128 * 100], m.indices[:128 * 100])
    cache = tune.TuneCache()
    empty_at_start = not any(cache.root.glob("*.json"))

    def records(on: bool) -> None:
        for path in cache.root.glob("*.json"):
            path.unlink()
        for kernel, (info, *_) in calls.items():
            if on:
                cache.put(cache.key(kernel, common.CUDA, info),
                          {"schema": tune.SCHEMA, "kernel": kernel,
                           "backend": common.CUDA,
                           "device_kind": tune.device_kind(),
                           "shape_class": tune.shape_class(info),
                           "config": tune.TUNABLES[kernel].pick(info),
                           "candidates": []})
        tune.forget()

    def added_us(kernel) -> float:
        info, key, device, _ = calls[kernel]
        param = tune.TUNABLES[kernel].params[0]
        n = 100_000
        t0 = time.perf_counter()
        for _ in range(n):
            backend = common.resolve_backend(kernel, device, common.CUDA)
            cfg = tune.known(kernel, backend, (*key,))
            if cfg is None:
                cfg = tune.consult(kernel, backend, lambda: info, key=key)
            cfg.get(param)
        return (time.perf_counter() - t0) / n * 1e6

    def flush_us() -> float:
        engine = GLMScoreEngine("lr", ws, ell_width=m.values.shape[1],
                                max_batch=128, queue_depth=len(reqs),
                                device=dev)
        for r in reqs:
            engine.try_admit(r)
        engine.flush()
        t0 = time.perf_counter()
        while engine.flush():
            pass
        return (time.perf_counter() - t0) / (len(reqs) // 128 - 1) * 1e6

    hits = {k: metrics.counter(f"kernel.tune_cache.hit.{k}").value
            for k in calls}
    out = {"added_us": {}, "wrapper_us": {}}
    flush = {"empty_cache": [], "cached_record": []}
    for state in ("empty_cache", "cached_record"):
        records(state == "cached_record")
        for kernel, (info, _, _, call) in calls.items():
            pick = tune.TUNABLES[kernel].pick(info)
            pinned, unpinned = paired_host_us(lambda: call(**pick), call)
            out["wrapper_us"].setdefault(kernel, {})[state] = {
                "pinned": pinned, "unpinned": unpinned,
                "added": unpinned - pinned}
            out["added_us"].setdefault(kernel, {})[state] = added_us(kernel)
    for state in ("empty_cache", "cached_record", "cached_record",
                  "empty_cache"):
        records(state == "cached_record")
        flush[state].append(flush_us())
    record_reads = {k: metrics.counter(f"kernel.tune_cache.hit.{k}").value
                    - hits[k] for k in calls}
    records(False)
    return {"ok": empty_at_start and all(record_reads.values()),
            "record_reads": record_reads, **out,
            "flush_us": {s: statistics.mean(x) for s, x in flush.items()},
            "flush_us_runs": flush}


def phase_bench(dev, covtype, w8a, realsim, results: Path) -> dict:
    """The kernel bench, every tuner candidate against the plain version,
    the serving and live benches with the health monitor, and the host cost
    of the tuner's consult; everything the benches write goes to
    ``results``, and the cache the wrappers consult (the script's own
    temporary ``REPRO_TORCH_TUNE_DIR``) is left empty."""
    from repro_torch.benchmarks import common as bcommon

    saved, bcommon.RESULTS_DIR = bcommon.RESULTS_DIR, results
    try:
        t0 = time.perf_counter()
        kernels = _bench_kernels(results)
        t1 = time.perf_counter()
        tuner = _tuner_candidates(dev, covtype, w8a, realsim, results)
        t2 = time.perf_counter()
        services = _services(results)
        t3 = time.perf_counter()
        consult = _consult_cost(dev, w8a)
        t4 = time.perf_counter()
        traced_services = _traced_services(results)
        t5 = time.perf_counter()
    finally:
        bcommon.RESULTS_DIR = saved
    return {"phase": "bench",
            "ok": kernels["ok"] and all(t["ok"] for t in tuner)
            and services["ok"] and consult["ok"] and traced_services["ok"],
            "seconds": {"kernels": t1 - t0, "tuner": t2 - t1,
                        "services": t3 - t2, "consult": t4 - t3,
                        "traced": t5 - t4},
            "kernels": kernels, "tuner": tuner, "services": services,
            "consult": consult, "traced": traced_services}


# ---------------------------------------------------------------------------
# Traced runs, the report CLI and the multi-worker sweep
# ---------------------------------------------------------------------------

#: phase sweep: worker processes sharing the card, the lanes and layers the
#: report must show, and the study kernels every worker lane must dispatch
SWEEP_WORKERS = 2
SWEEP_LANES = ("main", "shard0a0", "shard1a0")
SWEEP_LAYERS = ("engine", "kernel", "runner", "sweep")
#: phase bench's traced serving and live drives
SERVICE_LAYERS = ("kernel", "serve", "live")


@contextlib.contextmanager
def traced(root: Path, xprof: bool = False):
    """Span tracing (``REPRO_TRACE=1``) into ``root`` for a while, with the
    profiler capture (``REPRO_TRACE_XPROF=1``) if asked; the environment
    and the tracer are restored after, so no later phase traces."""
    from repro_torch.obs import trace

    keys = (trace.ENV_TRACE, trace.ENV_TRACE_DIR, trace.ENV_TRACE_TAG,
            trace.ENV_XPROF)
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({trace.ENV_TRACE: "1", trace.ENV_TRACE_DIR: str(root)})
    os.environ.pop(trace.ENV_TRACE_TAG, None)
    if xprof:
        os.environ[trace.ENV_XPROF] = "1"
    trace.refresh()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        trace.refresh()


def report_cli(root: Path) -> dict:
    """``python -m repro_torch.obs.report`` over ``root``, as a user runs
    it: ``--check``'s exit code and last words, ``--json``'s layers and
    lanes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.obs.report", str(root)]
    check = subprocess.run(cmd + ["--check"], env=env, capture_output=True,
                           text=True, timeout=300)
    js = subprocess.run(cmd + ["--json"], env=env, capture_output=True,
                        text=True, timeout=300)
    doc = json.loads(js.stdout) if js.returncode == 0 else {}
    return {"check_rc": check.returncode,
            "check": (check.stdout + check.stderr).strip()[-600:],
            "json_rc": js.returncode, "layers": doc.get("layers", []),
            "lanes": sorted(f["tag"] for f in doc.get("files", [])),
            "spans": sum(f["spans"] for f in doc.get("files", [])),
            "metrics_files": len(doc.get("metrics_files", []))}


def _traced_services(results: Path) -> dict:
    """One traced ``bench_serve`` drive and one traced ``bench_live``
    drive, then the report CLI over their trace dir: ``--check`` exits 0
    and the kernel, serve and live layers are there.  The drives get a
    results dir of their own: over the benches' warm caches they would
    serve every cell from disk and drive nothing."""
    from repro_torch.benchmarks import bench_live, bench_serve
    from repro_torch.benchmarks import common as bcommon

    results = results / "traced"
    root = results / "trace"
    t0 = time.perf_counter()
    saved, bcommon.RESULTS_DIR = bcommon.RESULTS_DIR, results
    try:
        with traced(root):
            _quiet(lambda: bench_serve.run(
                "ci", out_json=results / "BENCH_serve.json"))
            _quiet(lambda: bench_live.run(
                "ci", out_json=results / "BENCH_live.json"))
    finally:
        bcommon.RESULTS_DIR = saved
    rep = report_cli(root)
    rep["seconds"] = time.perf_counter() - t0
    rep["ok"] = (rep["check_rc"] == 0 and rep["json_rc"] == 0
                 and set(SERVICE_LAYERS) <= set(rep["layers"]))
    return rep


def sweep_trials() -> list:
    """The ci profile's trials of the Table 7 and Fig. 22 drivers, as their
    ``common.tune`` calls make them: each dataset, task and Table 7
    configuration (the drivers' replica guard kept) over the ci grid, and
    Fig. 22's ``SyncSGD()`` over the grid and ``AsyncLocalSGD(replicas=8)``
    over its two steps (the same keys as Table 7's cpu-par)."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.benchmarks import table7_async
    from repro_torch.core import sgd
    from repro_torch.study.spec import TrialSpec

    epochs = bcommon.PROFILES["ci"]["epochs"]
    out = []
    for name in bcommon.profile_datasets("ci"):
        dspec = bcommon.dataset_spec(name, "ci")
        n = dspec.profile().n
        for task in bcommon.TASKS:
            grids = [(s, STUDY_STEPS) for s in table7_async.CONFIGS.values()
                     if n >= s.replicas * 2]
            grids += [(sgd.SyncSGD(), STUDY_STEPS),
                      (sgd.AsyncLocalSGD(replicas=8, local_batch=1),
                       (1e-2, 1e-1))]
            out += [TrialSpec(dspec, task, strat, step, epochs)
                    for strat, steps in grids for step in steps]
    return out


def _events(path: Path, kind: str) -> list[dict]:
    return [e for e in map(json.loads, path.read_text().splitlines())
            if e.get("event") == kind]


def _capture_kernels(path: Path) -> list[str]:
    """The port's kernels a profiler capture's device events name."""
    symbols = {s for fam in KERNEL_SYMBOLS.values() for v in fam.values()
               for s in v}
    doc = json.loads(path.read_text())
    return sorted({s for ev in doc.get("traceEvents", [])
                   if ev.get("cat") == "kernel"
                   for s in symbols if s in ev.get("name", "")})


def phase_sweep(dev, scratch: Path) -> dict:
    """The multi-worker sweep on the card, traced, with the profiler
    capture on (``REPRO_TRACE_XPROF=1``): the ci profile's Table 7 and
    Fig. 22 trials (1) in this process from no cache, (2) through a
    ``Runner`` with a 2-worker ``LocalProcessExecutor`` from an empty cache
    into store A, (3) through the drivers themselves on a serial runner
    over that cache into store B (no cache miss; A and B byte-identical;
    one ``sweep_shard`` event for each worker and one ``sweep_merge``),
    every dispatched trial's losses held against (1); (4) one worker told
    to die after its first stack group (``--fault-after 1 --fault-flag``)
    over one dataset's Table 7 grid: requeued once, the cache complete, its
    losses held against (1); (5) the report CLI over the trace dir
    (``--check`` exits 0; the driver's and every worker attempt's lanes;
    the engine, kernel, runner and sweep layers), the lanes read through
    the port's ``export`` (every ``sweep.shard`` on the card, every worker
    ``kernel.dispatch`` on ``cuda``, the four study kernels among them);
    (6) every profiler capture under ``xprof/`` naming a port kernel, one
    for each worker attempt."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.benchmarks import fig22_sync_vs_async, table7_async
    from repro_torch.core import sgd
    from repro_torch.kernels import common
    from repro_torch.obs import export
    from repro_torch.study.runner import Runner
    from repro_torch.study.store import StudyStore
    from repro_torch.sweep import LocalProcessExecutor
    from repro_torch.sweep.worker import FAULT_EXIT

    root = scratch / "sweep"
    trace_dir, cache, jsonl = root / "trace", root / "cache", root / "runs.jsonl"
    trials = sweep_trials()
    modules = ["fig22_sync_vs_async", "table7_async"]
    line = {"phase": "sweep", "trials": len(trials),
            "unique_trials": len({t.key for t in trials}),
            "workers": SWEEP_WORKERS}
    with traced(trace_dir, xprof=True):
        # (1) serial and cold, in this process
        t0 = time.perf_counter()
        cold = Runner(cache_dir=None, device=dev).run(trials)
        torch.cuda.synchronize()
        line["serial_cold_s"] = time.perf_counter() - t0
        # (2) two worker processes on the card, from an empty cache
        store_a = StudyStore(root / "a.json", jsonl_path=jsonl)
        runner = Runner(cache_dir=cache, store=store_a, device=dev,
                        executor=LocalProcessExecutor(
                            SWEEP_WORKERS, work_dir=root / "work"))
        t0 = time.perf_counter()
        swept = runner.run(trials)
        line["sweep_s"] = time.perf_counter() - t0
        store_a.record_claims([], checked_modules=modules)
        a = store_a.write().read_bytes()
        # (3) the drivers, serial, over the merged cache
        store_b = StudyStore(root / "b.json", jsonl_path=jsonl)
        saved, bcommon.RESULTS_DIR = bcommon.RESULTS_DIR, root / "csv"
        bcommon.RUNNER = warm = Runner(cache_dir=cache, store=store_b,
                                       device=dev)
        try:
            _quiet(lambda: (table7_async.run("ci"),
                            fig22_sync_vs_async.run("ci")))
        finally:
            bcommon.RESULTS_DIR = saved
        store_b.record_claims([], checked_modules=modules)
        b = store_b.write().read_bytes()
        shards, merges = _events(jsonl, "sweep_shard"), _events(jsonl,
                                                                "sweep_merge")
        worst, held = 0.0, True
        for c, s in zip(cold, swept):
            err, ok = close(torch.tensor(s.losses), torch.tensor(c.losses),
                            LOSS_TOL)
            worst, held = max(worst, err), held and ok and not s.cached
        by_key = {t.key: c for t, c in zip(trials, cold)}
        # (4) a worker that dies after its first stack group
        subset = list({t.key: t for t in trials
                       if (t.dataset.name, t.task) == ("covtype", "lr")
                       and isinstance(t.strategy, sgd.AsyncLocalSGD)
                       }.values())
        rq_jsonl = root / "requeue.jsonl"
        store_c = StudyStore(root / "c.json", jsonl_path=rq_jsonl)
        requeued = Runner(
            cache_dir=root / "cache-requeue", store=store_c, device=dev,
            executor=LocalProcessExecutor(1, work_dir=root / "work",
                                          worker_args=(
                                              "--fault-after", "1",
                                              "--fault-flag",
                                              str(root / "fault-flag"))))
        rq = requeued.run(subset)
        store_c.write()
    rq_shards = _events(rq_jsonl, "sweep_shard")
    [rq_merge] = _events(rq_jsonl, "sweep_merge") or [{}]
    rq_err, rq_held = 0.0, True
    for t, r in zip(subset, rq):
        err, ok = close(torch.tensor(r.losses),
                        torch.tensor(by_key[t.key].losses), LOSS_TOL)
        rq_err, rq_held = max(rq_err, err), rq_held and ok
    line["store"] = {
        "byte_identical": a == b, "bytes": len(a),
        "warm_misses": warm.cache.misses, "warm_hits": warm.cache.hits,
        "shard_workers": sorted({e["worker"] for e in shards}),
        "shard_returncodes": [e["returncode"] for e in shards],
        "merge_events": len(merges),
        "merged": merges[0]["merged"] if merges else None}
    line["losses"] = {"tol": LOSS_TOL, "max_abs_err": worst, "held": held}
    line["requeue"] = {
        "trials": len(subset),
        "attempts": [(e["worker"], e["attempt"], e["returncode"])
                     for e in rq_shards],
        "retries": rq_merge.get("retries"),
        "complete": sorted(p.stem for p in (root / "cache-requeue")
                           .glob("*.json")) == sorted(t.key for t in subset),
        "max_abs_err": rq_err, "held": rq_held}
    # (5) the report CLI, and the lanes through the port's export
    rep = report_cli(trace_dir)
    lanes = export.collect([trace_dir])
    workers = [t for t in lanes if t.tag != "main"]
    devices = sorted({str(s.get("args", {}).get("device"))
                      for t in lanes for s in t.spans
                      if s["name"] == "sweep.shard"})
    dispatch = [s.get("args", {}) for t in workers for s in t.spans
                if s["name"] == "kernel.dispatch"]
    backends = sorted({d.get("backend") for d in dispatch})
    kernels = sorted({d.get("kernel") for d in dispatch})
    want_lanes = set(SWEEP_LANES) | {
        f"shard{w}a{a}" for w, a, _ in line["requeue"]["attempts"]}
    rep.update(devices=devices, worker_backends=backends,
               worker_kernels=kernels, want_lanes=sorted(want_lanes))
    line["report"] = rep
    # (6) one profiler capture a worker attempt, each naming a port kernel
    captures = {p.name: _capture_kernels(p)
                for p in sorted((trace_dir / "xprof").glob("*.json"))}
    worker_files = {f"{t.tag}-torch-{t.pid}.json" for t in workers}
    line["xprof"] = {"captures": captures,
                     "missing": sorted(worker_files - set(captures))}
    line["nvidia_smi"] = nvidia_smi()
    line["ok"] = bool(
        line["store"]["byte_identical"] and warm.cache.misses == 0
        and line["store"]["shard_workers"] == list(range(SWEEP_WORKERS))
        and all(rc == 0 for rc in line["store"]["shard_returncodes"])
        and len(merges) == 1 and held
        and [a for _, a, _ in line["requeue"]["attempts"]] == [0, 1]
        and [rc for _, _, rc in line["requeue"]["attempts"]]
        == [FAULT_EXIT, 0]
        and line["requeue"]["retries"] == 1 and line["requeue"]["complete"]
        and rq_held
        and rep["check_rc"] == 0 and set(SWEEP_LAYERS) <= set(rep["layers"])
        and want_lanes <= set(rep["lanes"])
        and devices and set(devices) <= {"cuda", "cuda:0"}
        and backends == [common.CUDA]
        and set(TRAIN_KERNELS) <= set(kernels)
        and not line["xprof"]["missing"]
        and all(captures.values()))
    return line


def make_row(rows: list, worst: dict):
    """The timing phase's ``row``: one timed row a call, appended to
    ``rows`` (``worst``: each family's worst error in phase kernels)."""
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

    return row


def wide_timing(row, news, dev) -> None:
    """The timing rows of the paper profile's widest shapes, each redesign
    beside the kernel it replaced there: glm_sgd's grid kernel at Table 4's
    seq epoch on news (its first 1,024 rows densified, 1,024 x 1,355,191,
    micro-batch 1, the driver's step 1e-3 from w = 0; the kernels line's
    row) and at d = 100,000 (2,003 rows, micro-batch 1), beside the global
    kernel; glm_sparse's hot kernel at rcv1's full size (677,399 x
    438; the kernels line's row) and at news's (19,996 x 2,729), beside
    the atomic kernel."""
    import repro_torch.kernels as K
    from repro_torch.benchmarks import table4_sync
    from repro_torch.core import sparse
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref
    from repro_torch.kernels.glm_sparse import ops as sparse_grad_ops
    from repro_torch.kernels.glm_sparse.ref import ell_glm_grad_ref

    mn, yn = news
    seq = table4_sync.DENSE_CAP_ROWS
    Xs = sparse.to_dense(sparse.ELLMatrix(mn.values[:seq], mn.indices[:seq],
                                          mn.d))
    ys, ws = yn[:seq], torch.zeros(mn.d, device=dev)
    g = torch.Generator(device=dev).manual_seed(100_000)
    Xw = torch.randn(2_003, 100_000, device=dev, generator=g)
    yw = torch.where(torch.rand(2_003, device=dev, generator=g) < 0.5, -1.0,
                     1.0)
    ww = torch.randn(100_000, device=dev, generator=g) * 0.1
    for label, X, y, w, step, line in (
            (f"news seq N={seq}", Xs, ys, ws, 1e-3, "glm_sgd_grid"),
            ("N=2003", Xw, yw, ww, 1.0 / 100_000, None)):
        n, d = X.shape

        def plain():
            return glm_sgd_epoch_ref("lr", w[None], X[None], y[None], step,
                                     1)[0]

        for kind in (sgd_ops.variant(d, 1), "global"):
            with forced_variant(sgd_ops, kind):
                row("glm_sgd", f"{label} d={d} MB=1 R=1 {kind}",
                    lambda: K.glm_sgd_epoch("lr", w, X, y, step=step,
                                            micro_batch=1), plain,
                    5 if kind == "grid" else 1, 1, nbytes(X, y, w, w),
                    4.0 * X.numel() + 8.0 * n, EPOCH_TOL,
                    line=line if kind == "grid" else None, variant=kind,
                    updates=n)
    del Xs, Xw
    torch.cuda.empty_cache()
    rcv1 = rcv1_dataset(dev)
    for label, (m, y), line in (("rcv1", rcv1, "glm_sparse_hot"),
                                ("news", news, None)):
        n, k = m.values.shape
        w = torch.randn(m.d, device=dev, generator=g) * 0.01
        nnz = int((m.values != 0).sum())

        def plain():
            return ell_glm_grad_ref("lr", w[None], m.values[None],
                                    m.indices[None], y[None])[0]

        for kind in (sparse_grad_ops.variant(m.d, k, 1), "atomic"):
            with forced_variant(sparse_grad_ops, kind):
                row("glm_sparse", f"{label} N={n} K={k} d={m.d} R=1 {kind}",
                    lambda: K.ell_glm_grad("lr", w, m.values, m.indices, y),
                    plain, 10, 1, ell_bytes(m.values) + nbytes(y, w, w),
                    4.0 * nnz + 8.0 * n, GRAD_TOL,
                    line=line if kind == "hot" else None, variant=kind)
    del rcv1
    torch.cuda.empty_cache()


def _again_in_turns(rows: list, ops, calls: list) -> None:
    """The device times of the last ``len(calls)`` rows taken once more, in
    the other order (A, B, then B, A), each call's variant forced on the
    family's ``ops``: a row's device time is the mean of its two, so
    neither kernel gains from running second.  ``calls``: ``(call, kind,
    family, reps)`` in the rows' order."""
    for timed, (call, kind, family, reps) in zip(rows[-1:-len(calls) - 1:-1],
                                                 calls[::-1]):
        with forced_variant(ops, kind):
            again = kernel_device_time(call, reps,
                                       KERNEL_SYMBOLS[family][kind])
        timed["device_ms_runs"] = [timed["device_ms"], again["device_ms"]]
        timed["device_ms"] = (timed["device_ms"] + again["device_ms"]) / 2
        if "updates" in timed:
            timed["device_us_per_update"] = \
                timed["device_ms"] * 1e3 / timed["updates"]


def dense_timing(row, rows: list, covtype, dev) -> None:
    """The timing rows of this slice's dense shapes, each redesign beside
    the kernel it replaced there, in turns (``_again_in_turns``): glm_sgd's
    rows kernel beside the smem kernel at covtype's ``SyncSGD(batch=1024)``
    epoch (the kernels line's row) and at mini-batch 4,096, and beside the
    global kernel at ``AsyncLocalSGD(replicas=10, local_batch=58,101)``'s
    replica epochs; glm_grad's wide kernel beside the row kernel at 2,003 x
    60,000, at the dense wide set (16,384 x 20,958: the kernels line's row)
    and at 16,384 x 2,048 (Fig. 25's widest point in the ``paper``
    profile)."""
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_grad.ref import glm_grad_ref
    from repro_torch.kernels.glm_sgd import ops as sgd_ops
    from repro_torch.kernels.glm_sgd.ref import glm_sgd_epoch_ref

    X, yd = covtype
    n, d = X.shape
    g = torch.Generator(device=dev).manual_seed(54)
    w = torch.randn(d, device=dev, generator=g) * 0.1
    step = COVTYPE_BATCH_STEP
    parts = torch.from_numpy(sgd.partition_indices(n, 10)).to(dev).long()
    Xp, yp = X[parts], yd[parts]
    W = w[None] * torch.linspace(-1.0, 1.0, 10, device=dev)[:, None]
    per = Xp.shape[1]
    for label, Xe, ye, we, mb, other, line, reps in (
            (f"covtype N={n} d={d} MB=1024 R=1", X[None], yd[None], w[None],
             1024, "smem", "glm_sgd_rows", (5, 1)),
            (f"covtype N={n} d={d} MB=4096 R=1", X[None], yd[None], w[None],
             4096, "smem", None, (10, 1)),
            (f"covtype R=10 per={per} d={d} MB={per}", Xp, yp, W, per,
             "global", None, (20, 1))):
        updates = -(-Xe.shape[1] // mb)

        def plain(Xe=Xe, ye=ye, we=we, mb=mb):
            return glm_sgd_epoch_ref("lr", we, Xe, ye, step, mb)

        def call(Xe=Xe, ye=ye, we=we, mb=mb):
            return K.glm_sgd_epoch("lr", we, Xe, ye, step=step,
                                   micro_batch=mb)

        calls = []
        for kind, r in zip(("rows", other), reps):
            with forced_variant(sgd_ops, kind):
                row("glm_sgd", f"{label} {kind}", call, plain, r, 1,
                    nbytes(Xe, ye, we, we),
                    4.0 * Xe.numel() + 8.0 * ye.numel(), EPOCH_TOL,
                    line=line if kind == "rows" else None, variant=kind,
                    updates=updates)
            rows[-1]["updates"] = updates
            if kind == "rows":
                rows[-1]["plan"] = list(sgd_ops.rows_plan(d, mb,
                                                          Xe.shape[0]))
            calls.append((call, kind, "glm_sgd", r))
        _again_in_turns(rows, sgd_ops, calls)
    del Xp, yp
    torch.cuda.empty_cache()
    for label, nw, dw, line in (
            ("N=2003 d=60000", 2_003, 60_000, None),
            (f"dense wide N={DENSE_WIDE['n']} d={DENSE_WIDE['d']}",
             DENSE_WIDE["n"], DENSE_WIDE["d"], "glm_grad_wide"),
            (f"Fig. 25 N={PAPER_ROWS} d=2048", PAPER_ROWS, 2_048, None)):
        Xw, yw = dense_wide_dataset(dev, nw, dw, seed=dw)
        ww = torch.randn(dw, device=dev, generator=g) * 0.01

        def plain(Xw=Xw, yw=yw, ww=ww):
            return glm_grad_ref("lr", ww, Xw, yw)

        def call(Xw=Xw, yw=yw, ww=ww):
            return K.glm_grad("lr", ww, Xw, yw)

        calls = []
        for kind in ("wide", "row"):
            with forced_variant(grad_ops, kind):
                row("glm_grad", f"{label} {kind}", call, plain, 20, 20,
                    nbytes(Xw, yw, ww, ww), 4.0 * Xw.numel() + 8.0 * nw,
                    GRAD_TOL, line=line if kind == "wide" else None,
                    variant=kind)
            if kind == "wide":
                rows[-1]["plan"] = list(grad_ops.wide_plan(dw))
            calls.append((call, kind, "glm_grad", 20))
        _again_in_turns(rows, grad_ops, calls)
        del Xw
        torch.cuda.empty_cache()


def long_rows_timing(row, rows: list, sets: dict, dev) -> None:
    """The timing rows of the sparse sets at their Table 3 row widths
    (``sets``: ``phase_long_rows``'), each live-prefix kernel beside the
    kernel it replaced there, in turns (``_again_in_turns``): real-sim's
    replica epochs of ``AsyncLocalSGD(8, 1)`` (the kernels line's
    live_smem row) and ``(10, 10)`` and its ``SyncSGD(batch=16)`` epoch on
    live_smem and smem; news's ``AsyncLocalSGD(8, 1)`` (the kernels line's
    live_global row) and ``(64, 1)`` replica epochs on live_global and
    global.  Bound: ``ell_bytes`` (every value, 4 bytes an index of a
    nonzero), the labels and the model read and written."""
    import repro_torch.kernels as K
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_sgd_sparse import ops as sparse_ops
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref

    shapes = {"real-sim": ((8, 1, "glm_sgd_sparse_live_smem", (3, 1)),
                           (10, 10, None, (3, 1)), (1, 16, None, (3, 1))),
              "news": ((NEWS_REPLICAS[0], 1, "glm_sgd_sparse_live_global",
                        (3, 1)), (NEWS_REPLICAS[1], 1, None, (3, 1)))}
    for name, (m, y) in sets.items():
        n, k = m.values.shape
        step = REALSIM_STEP if name == "real-sim" else NEWS_STEP
        for reps, mb, line, times in shapes[name]:
            parts = torch.from_numpy(sgd.partition_indices(n, reps)).to(
                dev).long()
            vp, ip, yp = m.values[parts], m.indices[parts], y[parts]
            Wp = torch.zeros(reps, m.d, device=dev)
            updates = -(-vp.shape[1] // mb)
            nnz = int((vp != 0).sum())

            def plain(vp=vp, ip=ip, yp=yp, Wp=Wp, mb=mb):
                return ell_sgd_epoch_ref("lr", Wp, vp, ip, yp, step, mb)

            def call(vp=vp, ip=ip, yp=yp, Wp=Wp, mb=mb):
                return K.ell_sgd_epoch("lr", Wp, vp, ip, yp, step=step,
                                       micro_batch=mb)

            new = sparse_ops.variant(m.d, k, mb)
            calls = []
            for kind, r in zip((new, "smem" if new == "live_smem"
                                else "global"), times):
                with forced_variant(sparse_ops, kind):
                    row("glm_sgd_sparse", f"{name} R={reps} per="
                        f"{vp.shape[1]} K={k} d={m.d} MB={mb} {kind}", call,
                        plain, r, 1, ell_bytes(vp) + nbytes(yp, Wp, Wp),
                        4.0 * nnz + 8.0 * yp.numel(), EPOCH_TOL,
                        line=line if kind == new else None, variant=kind,
                        updates=updates)
                rows[-1]["updates"] = updates
                if kind == new:
                    rows[-1]["plan"] = list(sparse_ops.live_plan(
                        m.d, mb, kind == "live_smem"))
                    rows[-1]["mean_live"] = float(sparse_ops.live_lengths(
                        vp).float().mean())
                calls.append((call, kind, "glm_sgd_sparse", r))
            _again_in_turns(rows, sparse_ops, calls)
            del vp, ip
            torch.cuda.empty_cache()


#: the shapes of ``wide_sweep``: (N, d) of ``dense_timing``'s wide rows
WIDE_SWEEP_SHAPES = ((2_003, 60_000), (PAPER_ROWS, 20_958),
                     (PAPER_ROWS, 2_048))


def wide_sweep(dev) -> list[dict]:
    """glm_grad's wide kernel at each of WIDE_SWEEP_SHAPES with every tile
    its plan takes as given (``block_rows``: rows of a stage, one exchange
    each), device ms and the clusters the card holds at once: what
    WIDE_STAGE_BYTES is set from."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_grad import ops as grad_ops

    out = []
    for n, d in WIDE_SWEEP_SHAPES:
        X, y = dense_wide_dataset(dev, n, d, seed=d)
        w = torch.full((d,), 0.01, device=dev)
        cluster, slice_ = grad_ops.wide_plan(d)[:2]
        for tile in range(1, grad_ops.WIDE_MAX_ROWS + 1):
            plan = grad_ops.wide_plan(d, tile)
            if plan[2] != tile:
                continue
            ms = kernel_device_time(
                lambda: K.glm_grad("lr", w, X, y, block_rows=tile), 10,
                KERNEL_SYMBOLS["glm_grad"]["wide"])["device_ms"]
            out.append({"n": n, "d": d, "plan": list(plan),
                        "clusters_at_once": grad_ops._wide_clusters(
                            plan, dev.index or 0),
                        "picked": plan == grad_ops.wide_plan(d),
                        "device_ms": ms})
        del X
        torch.cuda.empty_cache()
    return out


#: the micro-batches of ``rows_sweep`` (covtype's width): where the warp
#: kernel's ring holds a batch (up to 522 rows at d = 54) the rows kernel
#: runs beside it, past that beside the smem kernel
SWEEP_BATCHES = (16, 32, 48, 64, 96, 128, 256, 512, 600, 1024, 4096)


def rows_sweep(covtype) -> list[dict]:
    """glm_sgd's rows kernel beside the kernel each covtype micro-batch of
    SWEEP_BATCHES ran on before it (the warp kernel where its ring holds
    the batch, else the smem kernel), one epoch each, device ms in turns
    (A, B, B, A) and us an update: what ROWS_MIN_BATCH is set from."""
    import repro_torch.kernels as K
    from repro_torch.kernels.glm_sgd import ops as sgd_ops

    X, yd = covtype
    n, d = X.shape
    w = torch.zeros(d, device=X.device)
    out = []
    for mb in SWEEP_BATCHES:
        other = "warp" if sgd_ops.warp_plan(d, mb)[0] else "smem"

        def call(mb=mb):
            return K.glm_sgd_epoch("lr", w, X, yd, step=COVTYPE_BATCH_STEP,
                                   micro_batch=mb)

        times = {}
        for kind in ("rows", other, other, "rows"):
            with forced_variant(sgd_ops, kind):
                ms = kernel_device_time(call, 2, KERNEL_SYMBOLS["glm_sgd"][
                    kind])["device_ms"]
            times.setdefault(kind, []).append(ms)
        updates = -(-n // mb)
        out.append({"micro_batch": mb, "updates": updates,
                    "picked": sgd_ops.variant(d, mb),
                    **{f"{kind}_device_ms": statistics.mean(t)
                       for kind, t in times.items()},
                    **{f"{kind}_us_per_update": statistics.mean(t) * 1e3
                       / updates for kind, t in times.items()},
                    "runs": times})
    return out


def phase_timing(covtype, w8a, news, realsim, worst: dict
                 ) -> tuple[list[dict], list[dict], dict]:
    """Each kernel and its plain version at the main path's shapes: one
    timed row per kernel and variant (glm_grad: covtype on the ring kernel
    and on the two-pass row kernel it replaced; glm_score:
    the serving flushes' shapes (w8a at max_batch 128 and 32, real-sim at
    128), all of w8a and news' first 512 rows, on the flat kernel and on the
    group kernel it replaced, their device times taken twice in turns;
    glm_sgd: SyncSGD(batch=16) on the warp
    kernel and on the smem kernel it replaced, the R=8 B=1 replica epochs,
    and the cluster kernel beside the kernels it replaced: at Table 4's
    real-sim seq epoch (smem) and at d = 58,112 (global); glm_sgd_sparse:
    the R=10 replica epochs at B=10 (also on the shared-memory kernel the
    warp kernel replaced) and B=1, and news' R=8 and R=64 B=1
    epochs on the stream kernel and on the global kernel it replaced;
    glm_sparse: w8a at R=1 and R=10 x 6,470 on the smem kernel, on the
    atomic kernel it replaced and on the hot kernel; flash_attn: decode over
    the serving run's 128 keys and a full 4096-key window, prefill, and an
    fp32 call; ``wide_timing``'s and ``dense_timing``'s rows (glm_grad's
    wide kernel past 1,024 features, glm_sgd's rows kernel past the warp
    kernel's batches); the kernels line takes the rows marked ``line``), the decode wrapper's host us per call, a check of
    w8a's R=10 full-partition gradient, and the device time of a launch
    that does nothing (``torch.cuda._sleep(0)``)."""
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
    row = make_row(rows, worst)

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
    # (the row layout past the ring kernel: ``dense_timing``)
    Xw, yw, ww = _dense_inputs(rng, 2003, 60_000, X.device)
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
    plain_w8a = {mb: functools.partial(ell_sgd_epoch_ref, "lr", W, vp, ip, yp,
                                       0.2, mb) for mb in (10, 1)}
    # MB=10 on the warp kernel, on the shared-memory kernel it replaced,
    # and MB=1
    for mb, kind, line in ((10, sparse_ops.variant(m.d, k, 10),
                            "glm_sgd_sparse_warp"), (10, "smem", None),
                           (1, sparse_ops.variant(m.d, k, 1), None)):
        with forced_variant(sparse_ops, kind):
            row("glm_sgd_sparse",
                f"w8a N={ns} K={k} d={m.d} R=10 MB={mb} {kind}",
                lambda: K.ell_sgd_epoch("lr", W, vp, ip, yp, step=0.2,
                                        micro_batch=mb), plain_w8a[mb],
                10 if mb > 1 else 3, 1, ell_bytes(vp) + nbytes(yp, W, W),
                4.0 * nnz + 8.0 * ns, EPOCH_TOL, line=line, variant=kind,
                updates=-(-vp.shape[1] // mb))
    # SyncSGD() on w8a: the full-batch sparse sum gradient, and
    # AsyncLocalSGD(replicas=10, local_batch=6470)'s replica gradients, on
    # the smem kernel and on the atomic kernel it replaced
    for kind, line in (("smem", "glm_sparse_smem"), ("atomic", None),
                       ("hot", None)):
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
    wide_timing(row, news, X.device)
    dense_timing(row, rows, covtype, X.device)

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
    # the decode kernel) and over a full 4096-key window, at its prefill
    # (S=8192, window 4096: the wgmma kernel, beside the mma kernel it
    # replaced there) and at the vlm cross call (Sq 2,048 > Sk 1,600, both
    # kernels); the serving shape and the prefill are in the kernels line
    # (the mma kernel, which no main path runs now, beside it as a
    # predecessor with no line).  The yardstick
    # is one scaled_dot_product_attention with enable_gqa and the
    # end-aligned mask
    from repro_torch.kernels.flash_attn.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, shape, causal, window, reps, plain_reps, in_line in (
            ("decode", (4, 32, 8, 1, 128, 80), False, None, 200, 50, True),
            ("decode", (4, 32, 8, 1, 4096, 80), False, None, 200, 10, False),
            ("prefill", (1, 32, 8, LM_PREFILL, LM_PREFILL, 80), True, 4096,
             20, 2, True),
            ("vlm cross call", (1, 32, 8, 2048, 1600, 128), False, None, 50,
             5, False)):
        qa, ka, va = _attn_inputs(shape, torch.bfloat16, X.device, seed=7)
        mask = end_aligned_mask(shape[3], shape[4], causal, window, X.device)
        attn_bytes, attn_flops = attn_work(qa, ka, causal, window)
        chosen = attn_ops.variant(torch.bfloat16, shape[3],
                                  shape[1] // shape[2], shape[5])
        kinds = [chosen] + (["mma"] if shape[3] > 1 and chosen != "mma"
                            else [])

        def plain(qa=qa, ka=ka, va=va, causal=causal, window=window):
            return attention_ref(qa, ka, va, causal=causal, window=window)

        for kind in kinds:
            with forced_variant(attn_ops, kind):
                row("flash_attn", f"{label} B,Hq,Hkv,Sq,Sk,hd={list(shape)} "
                    f"bf16 causal={causal} window={window} {kind}",
                    lambda: K.flash_attention(qa, ka, va, causal=causal,
                                              window=window),
                    plain, reps, plain_reps, attn_bytes, attn_flops,
                    ATTN_BF16_TOL,
                    library=lambda: sdpa(qa, ka, va, attn_mask=mask,
                                         enable_gqa=True),
                    line=(f"flash_attn_{kind}" if in_line and kind == chosen
                          else None),
                    flops_per_s=BF16_FLOPS_PER_S, variant=kind)
        if label == "decode" and in_line:
            # the wrapper's host time per call, and the library call's
            rows[-1]["host_us_per_call"] = host_us(
                lambda: K.flash_attention(qa, ka, va, causal=causal))
            rows[-1]["library_host_us_per_call"] = host_us(
                lambda: sdpa(qa, ka, va, enable_gqa=True))
    # the fp32 variants, bound by fp32 operations outside the tensor cores:
    # each of FP32_TIMED in both, the variant ``ops.variant`` picks first,
    # then both device times again in the other order (A, B, B, A); the
    # kernels line's rows are the main paths' shapes, each on the variant
    # it picks (phase lm_train (c)'s fp32 layers on "simt_tiled", the
    # reduced fp32 configs' decode in lm_families (e) on "simt")
    for label, shape, causal, window, reps, plain_reps, line in FP32_TIMED:
        qa, ka, va = _attn_inputs(shape, torch.float32, X.device, seed=8)
        attn_bytes, attn_flops = attn_work(qa, ka, causal, window)
        chosen = attn_ops.variant(torch.float32, shape[3],
                                  shape[1] // shape[2], shape[5])
        kinds = [chosen] + [k for k in FP32_FORWARDS if k != chosen]

        def plain(qa=qa, ka=ka, va=va, causal=causal, window=window):
            return attention_ref(qa, ka, va, causal=causal, window=window)

        def call(qa=qa, ka=ka, va=va, causal=causal, window=window):
            return K.flash_attention(qa, ka, va, causal=causal, window=window)

        library, form = sdpa_fp32(qa, ka, va, causal, window)
        for kind in kinds:
            with forced_variant(attn_ops, kind):
                row("flash_attn", f"fp32 {label} B,Hq,Hkv,Sq,Sk,hd="
                    f"{list(shape)} causal={causal} window={window} {kind}",
                    call, plain, reps, plain_reps, attn_bytes, attn_flops,
                    ATTN_TOL, library=library,
                    line=(f"flash_attn_{kind}" if kind == chosen == line
                          else None), variant=kind)
            rows[-1]["library_form"] = form
        for kind, timed in zip(kinds[::-1], rows[-1:-3:-1]):
            with forced_variant(attn_ops, kind):
                again = kernel_device_time(
                    call, reps, KERNEL_SYMBOLS["flash_attn"][kind])["device_ms"]
            timed["device_ms_runs"] = [timed["device_ms"], again]
            timed["device_ms"] = (timed["device_ms"] + again) / 2
        del qa, ka, va, library
        torch.cuda.empty_cache()

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


def main(argv: list[str]) -> int:
    if argv not in ([], ["--lm-train-probe"], ["--lm-families"],
                    ["--mesh"], ["--attn-fwd"], ["--attn-bwd"], ["--wide"],
                    ["--dense"], ["--long-rows"]):
        print("usage: python3 chip_smoke.py [--lm-train-probe | "
              "--lm-families | --mesh | --attn-fwd | --attn-bwd | --wide | "
              "--dense | --long-rows]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    # the tuner's cache and switch: an empty cache of the run's own, so a
    # record in the home directory cannot change what the run measures, and
    # no sweep at unpinned call sites; phase bench writes under ``scratch``
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as scratch:
        os.environ["REPRO_TORCH_TUNE_DIR"] = str(Path(scratch) / "tune")
        os.environ.pop("REPRO_TORCH_KERNEL_AUTOTUNE", None)
        if argv == ["--lm-families"]:
            return run_lm_families(Path(scratch))
        if argv == ["--mesh"]:
            return run_mesh(Path(scratch))
        if argv == ["--attn-fwd"]:
            return run_attn_fwd()
        if argv == ["--attn-bwd"]:
            return run_attn_bwd()
        if argv == ["--wide"]:
            return run_wide()
        if argv == ["--dense"]:
            return run_dense()
        if argv == ["--long-rows"]:
            return run_long_rows()
        if argv:
            return run_lm_train_probe(Path(scratch))
        return run(Path(scratch))


def run_wide() -> int:
    """``python3 chip_smoke.py --wide``: the env and build phases, then the
    paper profile's widest datasets alone: ``wide_kernel_checks``, phase
    news (news and rcv1 at full size), phase study's (c) and
    ``wide_timing``'s rows, the card's name and power limit last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    cases, worst = wide_kernel_checks(dev)
    ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "cases": cases, "ok": ok})
    news = news_dataset(dev)
    rcv1 = rcv1_dataset(dev)
    line, launches = phase_news(news, rcv1, epochs=3)
    emit(line)
    ok = ok and line["ok"]
    del rcv1
    t0 = time.perf_counter()
    paper, paper_launches = _study_paper(dev)
    emit({"phase": "study", "paper": paper,
          "seconds": time.perf_counter() - t0, "ok": paper["ok"]})
    ok = ok and paper["ok"]
    torch.cuda.empty_cache()
    rows = []
    wide_timing(make_row(rows, worst), news, dev)
    for r in rows:
        r["launches"] = launches.get(r["line"]) if r["line"] else None
        r["study_launches"] = paper_launches.get(r["line"])
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "seconds_total": time.perf_counter() - t_start})
    ok = ok and all(r["ok"] for r in rows)
    print(smi, flush=True)
    return 0 if ok else 1


def run_dense() -> int:
    """``python3 chip_smoke.py --dense``: the env and build phases, then the
    dense paths past the Hopper designs' first shapes alone:
    ``dense_kernel_checks``, covtype's two paths past the warp kernel's
    ring and ``SyncSGD()`` on the dense wide set at full size (phase
    train's runs, launch counts read around each), the three at
    PARITY_ROWS rows against the plain versions (phase parity's),
    ``dense_timing``'s rows and ``rows_sweep``, the card's name and power
    limit last."""
    from repro_torch.data import synthetic
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    cases, worst = dense_kernel_checks(dev)
    ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "cases": cases, "ok": ok})
    cov = synthetic.paper_dataset("covtype", seed=0, device=dev)
    X, yd = cov.X, cov.y
    dense_wide = dense_wide_dataset(dev)
    runs, _, launches = train_runs(dense_batch_paths(X, yd)
                                   + dense_wide_path(*dense_wide), 4)
    train_ok = all(r["falling"] for r in runs) and [
        r["variants"] for r in runs] == [{"glm_sgd": "rows"}] * 2 + [
        {"glm_grad": "wide"}] and all(launches.values())
    emit({"phase": "train", "runs": runs, "launches": launches,
          "ok": train_ok})
    line = phase_parity(dense_batch_paths(X[:PARITY_ROWS], yd[:PARITY_ROWS])
                        + dense_wide_path(*(t[:PARITY_ROWS]
                                            for t in dense_wide)),
                        PARITY_ROWS, epochs=3)
    del dense_wide
    torch.cuda.empty_cache()
    emit(line)
    ok = ok and train_ok and line["ok"]
    rows = []
    dense_timing(make_row(rows, worst), rows, (X, yd), dev)
    for r in rows:
        r["launches"] = launches.get(r["line"]) if r["line"] else None
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "sweep": rows_sweep((X, yd)), "wide_sweep": wide_sweep(dev),
          "seconds_total": time.perf_counter() - t_start})
    ok = ok and all(r["ok"] for r in rows)
    print(smi, flush=True)
    return 0 if ok else 1


def long_rows_sets(dev) -> tuple[dict, float]:
    """``LONG_ROWS`` at full size drawn on the card (``long_rows_dataset``),
    and the seconds the draws took."""
    t0 = time.perf_counter()
    sets = {name: long_rows_dataset(dev, name) for name in LONG_ROWS}
    torch.cuda.synchronize()
    return sets, time.perf_counter() - t0


def run_long_rows() -> int:
    """``python3 chip_smoke.py --long-rows``: the env and build phases, then
    the paper's sparse sets at their Table 3 row widths alone:
    ``live_kernel_checks``, phase long_rows (real-sim and news at full size
    through their paths, and at a cut against the plain versions),
    ``long_rows_timing``'s rows (each live-prefix kernel and the kernel it
    replaced in turns), the card's name and power limit last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    cases, worst = live_kernel_checks(dev)
    ok = all(c["ok"] for c in cases)
    emit({"phase": "kernels", "cases": cases, "ok": ok})
    sets, data_seconds = long_rows_sets(dev)
    line, launches = phase_long_rows(sets)
    line["data_seconds"] = data_seconds
    emit(line)
    ok = ok and line["ok"]
    rows = []
    long_rows_timing(make_row(rows, worst), rows, sets, dev)
    for r in rows:
        r["launches"] = launches.get(r["line"]) if r["line"] else None
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "seconds_total": time.perf_counter() - t_start})
    ok = ok and all(r["ok"] for r in rows)
    print(smi, flush=True)
    return 0 if ok else 1


def run_attn_fwd() -> int:
    """``python3 chip_smoke.py --attn-fwd``: the env and build phases, then
    the attention forward alone: phase kernels' checks of every variant
    (``attention_forward_checks``), WGMMA_MIN_QUERIES's and
    TILED_MIN_QUERIES's sweeps, the fp32 rows (``_fp32_rows``), the
    forward rows of phase lm_train's (d), and phase lm_train (c)'s rules
    against forwards wrong on purpose (``_loss_controls``: it fails unless
    the layer rule fails a window one key short and a window dropped), the
    card's name and power limit last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    t0 = time.perf_counter()
    cases, worst = attention_forward_checks(dev)
    ok = all(c["ok"] for c in cases)
    emit({"phase": "attn_fwd", "cases": cases, "worst_picked_err": worst,
          "seconds": time.perf_counter() - t0, "ok": ok})
    t0 = time.perf_counter()
    emit({"phase": "attn_fwd_timing",
          "sweep": _forward_sweep(dev, torch.bfloat16),
          "fp32_sweep": _forward_sweep(dev, torch.float32),
          "fp32_rows": _fp32_rows(dev),
          "rows": _forward_rows(dev), "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    controls = _loss_controls(dev)
    emit({"phase": "loss_controls", **controls})
    print(smi, flush=True)
    return 0 if ok and controls["ok"] else 1


def run_attn_bwd() -> int:
    """``python3 chip_smoke.py --attn-bwd``: the env and build phases, then
    the attention backward alone: phase kernels' checks of every variant
    and phase lm_train's (d), the card's name and power limit last."""
    from repro_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = common.device()
    smi = nvidia_smi()
    emit(phase_env(smi))
    emit(phase_build())
    t0 = time.perf_counter()
    cases, _ = _attention_backward_checks(dev)
    alone, _ = _backward_alone(dev)
    ok = all(c["ok"] for c in cases) and alone["ok"]
    emit({"phase": "attn_bwd", "cases": cases, "backward": alone,
          "seconds": time.perf_counter() - t0, "ok": ok})
    print(smi, flush=True)
    return 0 if ok else 1


def run(scratch: Path) -> int:
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

    dense_wide = dense_wide_dataset(dev)
    line, launches, results = phase_train(covtype, w8a, 4, dense_wide)
    emit(line)
    if not line["ok"]:
        return 1
    line = phase_parity(main_path(covtype, w8a, PARITY_ROWS)
                        + dense_wide_path(*(t[:PARITY_ROWS]
                                            for t in dense_wide)),
                        PARITY_ROWS, epochs=3)
    emit(line)
    if not line["ok"]:
        return 1
    del dense_wide
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    news = news_dataset(dev)
    rcv1 = rcv1_dataset(dev)
    torch.cuda.synchronize()
    data_seconds = time.perf_counter() - t0
    line, news_launches = phase_news(news, rcv1, epochs=3)
    line["data_seconds"] = data_seconds
    emit(line)
    if not line["ok"]:
        return 1
    del rcv1
    launches.update(news_launches)

    # the sparse sets at their Table 3 row widths, and their timing rows
    # now, so that their 4.6 GB is free before the LM phases
    sets, data_seconds = long_rows_sets(dev)
    line, long_launches = phase_long_rows(sets)
    line["data_seconds"] = data_seconds
    emit(line)
    if not line["ok"]:
        return 1
    for name, count in long_launches.items():
        _count(launches, name, count)
    long_rows = []
    long_rows_timing(make_row(long_rows, worst), long_rows, sets, dev)
    del sets
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    line, study_launches = phase_study(dev)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not line["ok"]:
        return 1
    # the study path is the only one that runs glm_sgd's cluster and grid
    # variants
    launches["glm_sgd_cluster"] = study_launches["glm_sgd_cluster"]
    launches["glm_sgd_grid"] = study_launches["glm_sgd_grid"]
    torch.cuda.empty_cache()

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
    # flash_attn's forward launches by variant, as the wrapper counts them
    # (the decode variant's line counts phase lm's and the families'
    # serving calls)
    launches.update({f"flash_attn_{kind}": 0 for kind in FORWARD_LINES})

    def add_forward(counts: dict) -> None:
        for kind in FORWARD_LINES:
            launches[f"flash_attn_{kind}"] += counts.get(kind, 0)

    line, launches["flash_attn_decode"], prefill_launches = phase_lm(dev)
    add_forward(prefill_launches)
    emit(line)
    if not line["ok"]:
        return 1
    del line
    torch.cuda.empty_cache()
    line, train_launches, bwd_rows = phase_lm_train(dev, scratch)
    emit(line)
    if not line["ok"]:
        return 1
    # the forward's main paths: phase lm's prefill and the training run;
    # the backward's: the training run (bf16), and (c)'s fp32 layers
    add_forward(train_launches["forward"])
    launches["flash_attn_bwd_wgmma"] = train_launches["bwd_wgmma"]
    launches["flash_attn_bwd_simt_tiled"] = train_launches["bwd_simt_tiled"]
    step_ms = line["sync"]["steady_ms_per_step"]
    del line
    free_memory()
    dryrun = start_mesh_dryrun()   # traced on the host during lm_families
    line, family_launches = phase_lm_families(dev, scratch)
    emit(line)
    if not line["ok"]:
        return 1
    # the families' serving and decode steps, and their prefills and
    # training steps
    launches["flash_attn_decode"] += family_launches["decode"]
    add_forward(family_launches)
    launches["flash_attn_bwd_wgmma"] += family_launches["backward"]
    torch.cuda.empty_cache()

    line, mesh_launches = phase_mesh(dev, scratch, dryrun, step_ms)
    emit(line)
    if not line["ok"]:
        return 1
    # the mesh's training steps and decode ticks
    launches["flash_attn_decode"] += mesh_launches["decode"]
    add_forward(mesh_launches)
    launches["flash_attn_bwd_wgmma"] += mesh_launches["backward"]
    del line
    free_memory()

    line = phase_examples(scratch)
    emit(line)
    if not line["ok"]:
        return 1
    free_memory()

    line = phase_bench(dev, covtype, w8a, realsim, scratch / "bench")
    emit(line)
    if not line["ok"]:
        return 1

    t0 = time.perf_counter()
    line = phase_sweep(dev, scratch)
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not line["ok"]:
        return 1

    rows, full_checks, empty = phase_timing(covtype, w8a, news, realsim,
                                            worst)
    rows += long_rows
    checks += full_checks
    # a kernels-line row's error: the worst of its kernel's rows and checks
    # (the backward's rows: phase lm_train (d)'s)
    rows += bwd_rows
    for r in bwd_rows:
        r["launches"] = launches[r["line"]]
    for r in rows[:len(rows) - len(bwd_rows)]:
        r["launches"] = launches[r["line"]] if r["line"] else None
        r["study_launches"] = study_launches.get(r["line"])
        r["max_abs_err"] = max(
            [o["max_abs_err"] for o in rows
             if (o["name"], o["variant"]) == (r["name"], r["variant"])]
            + [c["max_abs_err"] for c in checks if c["kernel"] == r["name"]])
    emit({"phase": "timing", "nvidia_smi": smi, "rows": rows,
          "full_shape_checks": full_checks, "empty_launch": empty,
          "seconds_total": time.perf_counter() - t_start})
    # every row of the line was launched on a main path, and every
    # forward variant a main path launched has its row
    lines = {r["line"] for r in rows if r["line"]}
    if not all(r.get("ok", True) for r in rows + full_checks) or not all(
            launches[name] for name in lines) or any(
            launches[f"flash_attn_{kind}"] and f"flash_attn_{kind}" not in lines
            for kind in FORWARD_LINES):
        return 1

    print(smi)
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "variant",
            "study_launches")
    # device times where the row took them (the backward's rows time each
    # pass instead), us an update where the kernel runs a chain
    emit({"kernels": [{"name": r["line"], **{k: r[k] for k in keys},
                       **{k: r.get(k) for k in ("device_ms",
                                                "device_us_per_update")}}
                      for r in rows if r["line"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
