"""Analytic roofline annotations for the kernel microbenchmarks.

Each kernel family's useful work is priced analytically — the FLOPs the
math requires and the least HBM traffic of one launch — and held against
the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power
limit): HBM3 at 3.35 TB/s, fp32 outside the tensor cores at 67 TFLOP/s
(the GLM kernels and the fp32 ``flash_attn`` kernels), bf16 dense on the tensor
cores at 989 TFLOP/s (``flash_attn`` at bf16).  A card set below 700 W
runs slower than these peaks allow, so a share read against them names the
card's power limit beside it.

The costs are the reference package's (``repro/roofline/kernels.py``) at
fp32 with no mask, with two differences, both so that the bound stays a
lower bound of what the kernel must do:

* ``flash_attn``'s bytes are priced at the operands' width: the bf16
  kernels read and write bf16;
* with ``info["causal"]`` or ``info["window"]`` set, ``flash_attn``'s
  FLOPs count only the (query, key) pairs a query sees
  (:func:`visible_pairs`), not the full square.
"""
from __future__ import annotations

import numpy as np

#: the card the peaks describe
DEVICE = "NVIDIA H100 SXM"
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: fp32 FLOP/s outside the tensor cores
FP32_FLOPS_PER_S = 67e12
#: bf16 FLOP/s on the tensor cores, dense
BF16_FLOPS_PER_S = 989e12

#: bytes of an element of each dtype the families take
_WIDTH = {"float32": 4, "bfloat16": 2}


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs attention computes: query i sits at i + sk - sq
    and sees key j iff j <= its position (causal) and it is less than
    ``window`` behind."""
    pos = np.arange(sq) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def kernel_cost(kernel: str, info: dict) -> dict:
    """Useful FLOPs and minimum HBM bytes of one launch of ``kernel``.

    ``info`` is the call-info dict the tuner sees (n/d for the GLM
    families, k for ELL sparsity, batch/heads/seqs/head_dim for
    attention).  Sparse families are priced at their useful work (the
    gather/scatter math).  The GLM families are priced at fp32 whatever
    their operands' dtype: their kernels read fp32.
    """
    f32 = 4
    if kernel == "glm_grad":
        n, d = info["n"], info["d"]
        flops = 4.0 * n * d                      # X@w and X^T@pull
        bytes_ = f32 * (n * d + 2 * n + 2 * d)   # X, y, margins, w, g
    elif kernel == "glm_sgd":
        n, d = info["n"], info["d"]
        flops = 4.0 * n * d                      # same math per epoch
        bytes_ = f32 * (n * d + n + 2 * d)       # model stays resident
    elif kernel in ("glm_sparse", "glm_sgd_sparse"):
        n, d, k = info["n"], info["d"], info["k"]
        flops = 4.0 * n * k                      # gather-dot + scatter-add
        bytes_ = 2 * f32 * n * k + f32 * n + 2 * f32 * d
    elif kernel == "glm_score":
        n, d, k = info["n"], info["d"], info["k"]
        flops = 2.0 * n * k + n                  # gather-dot + link
        bytes_ = 2 * f32 * n * k + f32 * n + f32 * d
    elif kernel == "flash_attn":
        b = info["batch"]
        hq, hkv = info["heads_q"], info["heads_kv"]
        sq, sk, hd = info["seq_q"], info["seq_k"], info["head_dim"]
        causal, window = bool(info.get("causal")), info.get("window")
        pairs = (visible_pairs(sq, sk, causal, window) if causal or window
                 else sq * sk)
        flops = 4.0 * b * hq * pairs * hd        # QK^T and PV
        width = _WIDTH[info.get("dtype", "float32")]
        bytes_ = width * b * (2 * hq * sq * hd + 2 * hkv * sk * hd)
    else:
        raise KeyError(f"no cost model for kernel {kernel!r}")
    return {"flops": flops, "hbm_bytes": float(bytes_)}


def peak_flops(kernel: str, info: dict) -> float:
    """The FLOP/s peak ``kernel``'s math runs at: bf16 on the tensor cores
    for bf16 attention, fp32 outside them for everything else."""
    if kernel == "flash_attn" and info.get("dtype") == "bfloat16":
        return BF16_FLOPS_PER_S
    return FP32_FLOPS_PER_S


def annotate(kernel: str, info: dict, wall_s: float | None = None) -> dict:
    """Roofline terms of one trajectory point on the H100.

    Returns flops / hbm_bytes / arithmetic intensity, the card's
    compute-bound and memory-bound times (``compute_s``, ``memory_s``),
    their larger (``bound_s``), which term binds, the peaks used
    (``peaks``), and — given a measured ``wall_s`` — the achieved GFLOP/s
    and the fraction of the bound the measurement reached
    (``roofline_fraction``: at most 1 on the card, up to noise).
    """
    cost = kernel_cost(kernel, info)
    flops_per_s = peak_flops(kernel, info)
    compute_s = cost["flops"] / flops_per_s
    memory_s = cost["hbm_bytes"] / HBM_BYTES_PER_S
    bound_s = max(compute_s, memory_s)
    out = {
        **cost,
        "intensity_flops_per_byte": cost["flops"] / cost["hbm_bytes"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound_s": bound_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "peaks": {"device": DEVICE, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                  "flops_per_s": flops_per_s},
    }
    if wall_s:
        out["achieved_gflops"] = cost["flops"] / wall_s / 1e9
        out["roofline_fraction"] = bound_s / wall_s
    return out
