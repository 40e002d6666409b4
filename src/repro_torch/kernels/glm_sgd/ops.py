"""Public wrapper for the fused dense mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd.cu``: one launch per epoch.  :func:`variant`
picks the kernel from ``(d, micro_batch)`` alone:

* ``"warp"`` (``glm_sgd_warp_kernel``) for the paper's dense widths, d up to
  :data:`WARP_MAX_D` with a ring of at least two micro-batch tiles in shared
  memory: one block a replica, one warp carries the chain of dependent
  updates with the model in its registers, while the block's other warps
  prefetch the tiles.  The chain is the algorithm's, so this kernel shortens
  each update;
* ``"cluster"`` (``glm_sgd_cluster_kernel``) for every wider model up to
  :data:`CLUSTER_MAX` x 4,096 features (:func:`cluster_plan`): a
  thread-block cluster a replica, each block holding a slice of the model in
  its chain threads' registers and streaming its slice of the next rows
  through a ring; a batch's margins are summed across the cluster through
  distributed shared memory, in rank order, once an exchange;
* ``"smem"`` (``glm_sgd_kernel``, the first port) for what is left where
  ``d + micro_batch`` floats fit a block's 227 KB of shared memory: d up to
  :data:`WARP_MAX_D` with batches too long for the warp kernel's ring.  The
  cluster kernel takes any batch too, but there it sums each row's margin
  over a whole block where this kernel gives a warp whole rows, and ran up
  to 3.9x slower (``tools/cluster_sweep.py``);
* ``"global"`` (``glm_sgd_global_kernel``) for every model past the
  cluster's cap: the model stays in the output tensor in global memory, a
  row's margin is summed by the whole block, the batch's pulls go to a
  global scratch, and each feature's update belongs to one thread.

``torch-reference`` runs ref.py.  All take any ``n`` (a ragged tail is one
final smaller batch) and update in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sgd import ref as R

#: micro-batch when the caller does not pin one
DEFAULT_MICRO_BATCH = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


#: widest model the warp kernel holds in registers (32 values a lane)
WARP_MAX_D = 1024
#: most stages the warp kernel's ring holds ahead of the chain
WARP_MAX_STAGES = 16
#: rows a stage aims to hold: the chain waits and releases once a stage
WARP_STAGE_ROWS = 32


def smem_bytes(d: int, micro_batch: int) -> int:
    """Shared memory of one ``"smem"`` block: the model and the batch's
    pulls."""
    return 4 * (d + micro_batch)


def warp_columns(d: int) -> int:
    """Model values a lane of the warp kernel holds: ceil(d / 32) rounded
    up to a power of two (the kernel's template parameter C)."""
    c = 1
    while 32 * c < d:
        c *= 2
    return c


def warp_smem_bytes(d: int, micro_batch: int, stages: int, group: int) -> int:
    """Shared memory of one ``"warp"`` block (csrc/glm_sgd.cu lays it out
    the same way): two mbarriers a stage, the pulls of a batch, and
    ``stages`` stages of ``group * micro_batch`` rows of X as they lie in
    memory (after up to 3 floats of alignment, with ``32 * C`` floats of
    slack) and their labels, each rounded to 16 bytes."""
    rows = group * micro_batch
    stage = (common.padded(rows * d + 3, 4) + 32 * warp_columns(d)
             + common.padded(rows, 4))
    return 16 * stages + 4 * common.padded(micro_batch, 4) + 4 * stages * stage


def warp_plan(d: int, micro_batch: int) -> tuple[int, int]:
    """The warp kernel's ring as ``(stages, group)`` (``common.ring_plan``:
    stages of about WARP_STAGE_ROWS rows, up to WARP_MAX_STAGES; ``(0, 0)``
    where two single-batch stages do not fit)."""
    return common.ring_plan(
        lambda stages, group: warp_smem_bytes(d, micro_batch, stages, group),
        micro_batch, WARP_MAX_STAGES, WARP_STAGE_ROWS)


#: chain threads of a cluster kernel block (8 warps; 4 more warps copy)
CLUSTER_CHAIN_THREADS = 256
#: model values a chain thread holds in registers, the plan's first choice
#: and its cap: a block's slice is at most 256 x 8 = 2,048 features where
#: 16 blocks allow (d <= 32,768), else at most 4,096 (tools/cluster_sweep.py
#: times every cluster size a shape allows)
CLUSTER_VALUES = (8, 16)
CLUSTER_MAX_VALUES = CLUSTER_VALUES[-1]
#: most blocks a cluster (past 8 the launch checks that one can be placed)
CLUSTER_MAX = 16
#: most stages the cluster kernel's ring holds ahead of the chain
CLUSTER_MAX_STAGES = 8
#: most rows a fill of the ring (and one exchange) holds
CLUSTER_CHUNK_ROWS = 32


def cluster_smem_bytes(cluster: int, slice_: int, stages: int,
                       rows: int) -> int:
    """Shared memory of one ``"cluster"`` block (csrc/glm_sgd.cu lays it
    out the same way): two mbarriers a stage and two for the exchanges, the
    exchange slots of both parities (a fill's rows from each chain warp of
    each block of the cluster), ``stages`` stages of ``rows`` rows of the
    block's slice of X (each after up to 3 floats of alignment) and their
    labels, and the slack past the last row that a chain thread's
    unclamped reads of its :func:`cluster_values` reach."""
    row = common.padded(slice_ + 3, 4)
    slots = 2 * cluster * (CLUSTER_CHAIN_THREADS // 32) * rows
    slack = CLUSTER_CHAIN_THREADS * cluster_values(slice_) - slice_
    return (16 * (stages + 1) + 4 * slots
            + 4 * stages * (rows * row + common.padded(rows, 4)) + 4 * slack)


def cluster_values(slice_: int) -> int:
    """Model values a chain thread of the cluster kernel holds: the
    smallest of 4, 8, 16 that covers the slice (its template V)."""
    return next(v for v in (4, 8, CLUSTER_MAX_VALUES)
                if CLUSTER_CHAIN_THREADS * v >= slice_)


def _cluster_stages(cluster: int, slice_: int, rows: int) -> int:
    """Stages of ``rows`` rows that fit beside the rest (0 below two)."""
    for stages in range(CLUSTER_MAX_STAGES, 1, -1):
        if cluster_smem_bytes(cluster, slice_, stages, rows) \
                <= common.MAX_SMEM_BYTES:
            return stages
    return 0


def cluster_plan(d: int, micro_batch: int) -> tuple[int, int, int, int]:
    """The cluster kernel's plan as ``(cluster, slice, stages, rows)``:
    block ``b`` of a replica's cluster owns features ``[b * slice, (b + 1)
    * slice)`` of d (every block at least one), in its chain threads'
    registers, and streams them through a ring of ``stages`` fills of at
    most ``rows`` rows.  The clusters whose slices take at most 8 values a
    chain thread are the candidates where CLUSTER_MAX blocks allow it, else
    those at 16 (:data:`CLUSTER_VALUES`); the plan takes the smallest that
    leaves a ring of at least two stages of a whole batch (up to
    CLUSTER_CHUNK_ROWS rows), and where none does, the largest, with fills
    of as many rows as two stages allow, a batch then streamed twice (its
    margins, then its update).  ``(0, 0, 0, 0)`` past CLUSTER_MAX x 4,096
    features."""
    want = min(micro_batch, CLUSTER_CHUNK_ROWS)
    for values in CLUSTER_VALUES:
        sizes = [(c, -(-d // c)) for c in range(1, CLUSTER_MAX + 1)
                 if -(-d // c) <= CLUSTER_CHAIN_THREADS * values
                 and (c - 1) * -(-d // c) < d]
        if sizes:
            break
    else:
        return 0, 0, 0, 0
    for cluster, slice_ in sizes:
        stages = _cluster_stages(cluster, slice_, want)
        if stages:
            return cluster, slice_, stages, want
    cluster, slice_ = sizes[-1]
    rows = max(r for r in range(1, want) if _cluster_stages(cluster, slice_, r))
    return cluster, slice_, _cluster_stages(cluster, slice_, rows), rows


def variant(d: int, micro_batch: int) -> str:
    """The kernel that runs ``(d, micro_batch)``: ``"warp"`` up to
    WARP_MAX_D where a two-stage ring fits, ``"cluster"`` past WARP_MAX_D
    where :func:`cluster_plan` fits, else ``"smem"`` where the model and
    the batch's pulls fit a block's shared memory, else ``"global"``."""
    if d <= WARP_MAX_D:
        if warp_plan(d, micro_batch)[0]:
            return "warp"
    elif cluster_plan(d, micro_batch)[0]:
        return "cluster"
    if smem_bytes(d, micro_batch) <= common.MAX_SMEM_BYTES:
        return "smem"
    return "global"


@common.register_kernel("glm_sgd", common.CUDA)
def _glm_sgd_cuda(task, W, X, y, *, step, micro_batch):
    n_rep, n, d = X.shape
    kind = variant(d, micro_batch)
    X, y = common.cuda_operand(X), common.cuda_operand(y)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    scales = (step / micro_batch, step / tail if tail else 0.0)
    with common.on_device(X):
        if kind == "cluster":
            plan = cluster_plan(d, micro_batch)
            pulls = torch.empty((n_rep * plan[0], micro_batch),
                                dtype=torch.float32, device=X.device)
            fn = _build.function("glm_sgd", "glm_sgd_epoch_cluster", _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                                 _I, _I, _P)
            code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(),
                      pulls.data_ptr(), n_rep, n, d, micro_batch,
                      common.task_code(task), *scales, *plan,
                      common.stream(X))
        elif kind == "global":
            pulls = torch.empty((n_rep, micro_batch), dtype=torch.float32,
                                device=X.device)
            fn = _build.function("glm_sgd", "glm_sgd_epoch_global", _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _F, _F, _P)
            code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(),
                      pulls.data_ptr(), n_rep, n, d, micro_batch,
                      common.task_code(task), *scales, common.stream(X))
        else:
            stages, group = warp_plan(d, micro_batch) \
                if kind == "warp" else (0, 0)
            fn = _build.function("glm_sgd", "glm_sgd_epoch", _P, _P, _P, _I,
                                 _I, _I, _I, _I, _F, _F, _I, _I, _P)
            code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(), n_rep, n,
                      d, micro_batch, common.task_code(task), *scales,
                      stages, group, common.stream(X))
    _build.check("glm_sgd", code)
    common.count_launch("glm_sgd")
    return out


@common.register_kernel("glm_sgd", common.TORCH_REFERENCE)
def _glm_sgd_reference(task, W, X, y, *, step, micro_batch):
    return R.glm_sgd_epoch_ref(task, W, X, y, step, micro_batch)


def glm_sgd_epoch(
    task: str,
    w: torch.Tensor,   # [d]     or [R, d]
    X: torch.Tensor,   # [N, d]  or [R, N, d]
    y: torch.Tensor,   # [N]     or [R, N]
    *,
    step: float,
    micro_batch: int = DEFAULT_MICRO_BATCH,
    backend: str | None = None,
) -> torch.Tensor:
    """One mini-batch SGD epoch; returns the updated model (fp32, w's shape).

    With a replica axis every replica walks its own ``X[r]`` from ``w[r]``.
    """
    single = w.dim() == 1
    W, Xr, yr = (w[None], X[None], y[None]) if single else (w, X, y)
    n_rep, n, d = Xr.shape
    if W.shape != (n_rep, d) or yr.shape != (n_rep, n) or n < 1:
        raise ValueError(f"glm_sgd shapes: w {tuple(w.shape)}, X "
                         f"{tuple(X.shape)}, y {tuple(y.shape)}")
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    out = common.dispatch("glm_sgd", Xr.device, task, W, Xr, yr, step=step,
                          micro_batch=micro_batch, backend=backend)
    return out[0] if single else out
