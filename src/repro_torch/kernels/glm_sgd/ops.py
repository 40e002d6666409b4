"""Public wrapper for the fused dense mini-batch SGD epoch.

``cuda`` runs ``csrc/glm_sgd.cu``: one launch per epoch.  :func:`variant`
picks the kernel from ``(d, micro_batch)`` and, past the cluster's cap, the
replica count and the card's SMs:

* ``"warp"`` (``glm_sgd_warp_kernel``) for the paper's dense widths, d up to
  :data:`WARP_MAX_D` with a ring of at least two micro-batch tiles in shared
  memory: one block a replica, one warp carries the chain of dependent
  updates with the model in its registers, while the block's other warps
  prefetch the tiles.  The chain is the algorithm's, so this kernel shortens
  each update;
* ``"rows"`` (``glm_sgd_rows_kernel``) for the rest of d up to
  :data:`WARP_MAX_D`: batches the warp kernel's ring does not hold, and
  every batch of :data:`ROWS_MIN_BATCH` rows or more (:func:`rows_plan`): a
  thread-block cluster a replica, each batch's rows split over its blocks
  in contiguous runs, every block holding the whole model and streaming its
  run through a ring, its partial gradient summed across the cluster
  through distributed shared memory, in rank order, once a batch;
* ``"cluster"`` (``glm_sgd_cluster_kernel``) for every wider model up to
  :data:`CLUSTER_MAX` x 4,096 features (:func:`cluster_plan`): a
  thread-block cluster a replica, each block holding a slice of the model in
  its chain threads' registers and streaming its slice of the next rows
  through a ring; a batch's margins are summed across the cluster through
  distributed shared memory, in rank order, once an exchange;
* ``"smem"`` (``glm_sgd_kernel``, the first port): one block a replica,
  the model in shared memory; no shape picks it since the rows kernel took
  its batches, and it stays to be timed beside the rows kernel;
* ``"grid"`` (``glm_sgd_grid_kernel``) past the cluster's cap where
  :func:`grid_plan` fits (news's Table 4 seq epoch): the cluster kernel
  stretched over co-resident blocks, one a SM, each holding a slice of the
  model in registers and streaming its slice of the next rows through a
  ring; the blocks' partial margins meet in a global exchange of slots
  tagged with the exchange's number, each block summing them in block
  order;
* ``"global"`` (``glm_sgd_global_kernel``) for what the others refuse (a
  wide model of many replicas, or past :data:`GRID_MAX_VALUES` x 512
  features a SM): the model stays in the output tensor in global memory,
  a row's margin is summed by the whole block, the batch's pulls go to a
  global scratch, and each feature's update belongs to one thread.

``torch-reference`` runs ref.py.  All take any ``n`` (a ragged tail is one
final smaller batch) and update in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common, tune
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


#: chain warps of a rows kernel block (4 more warps copy)
ROWS_CHAIN_WARPS = 8
#: most blocks a replica's cluster of the rows kernel
ROWS_MAX_CLUSTER = 16
#: rows of a batch a block of the rows kernel takes at least, where the
#: batch has them: two a chain warp
ROWS_MIN_SHARE = 16
#: values a chain lane of the rows kernel keeps of a tile (RB rows of its
#: warp_columns(d) values)
ROWS_TILE_VALUES = 32
#: bytes of X a fill of the rows kernel's ring aims to hold, and its most
#: stages
ROWS_STAGE_BYTES = 16 * 1024
ROWS_MAX_STAGES = 4
#: from this many rows a batch the rows kernel takes d <= WARP_MAX_D from
#: the warp kernel, whose update is one warp's walk over the batch: the
#: sweep of ``chip_smoke.py --dense`` at covtype's width (device us an
#: update, warp against rows: 0.74 against 1.14 at 32 rows, 1.46 against
#: 1.16 at 48, 10.6 against 1.39 at 512; PERF.md, PR 32)
ROWS_MIN_BATCH = 48


def rows_smem_bytes(d: int, cluster: int, stages: int, frows: int) -> int:
    """Shared memory of one ``"rows"`` block (csrc/glm_sgd.cu lays it out
    the same way): two mbarriers a stage and two for the exchanges, the
    chain warps' partial gradients, the summed gradient, the exchange slots
    of both parities, and ``stages`` of the warp kernel's stages of
    ``frows`` rows."""
    c = warp_columns(d)
    dp = common.padded(d, 4)
    stage = (common.padded(frows * d + 3, 4) + 32 * c
             + common.padded(frows, 4))
    return (16 * (stages + 1)
            + 4 * (ROWS_CHAIN_WARPS * 32 * c + (1 + 2 * cluster) * dp)
            + 4 * stages * stage)


def _rows_fit(d: int, micro_batch: int, cluster: int
              ) -> tuple[int, int, int, int]:
    """The plan at a cluster size: a chain warp's tile of ``rb`` rows (the
    smallest power of two that covers a warp's share of a block's run,
    ``rb * warp_columns(d) <= ROWS_TILE_VALUES``), fills of the whole run
    or of whole tiles near ROWS_STAGE_BYTES, and the most stages that fit
    (0 below two)."""
    share = -(-micro_batch // cluster)
    per_warp = -(-share // ROWS_CHAIN_WARPS)
    c = warp_columns(d)
    rb = 1
    while rb < per_warp and 2 * rb * c <= ROWS_TILE_VALUES:
        rb *= 2
    tile = ROWS_CHAIN_WARPS * rb
    frows = min(share, max(tile, ROWS_STAGE_BYTES // (4 * d) // tile * tile))
    stages = next((s for s in range(ROWS_MAX_STAGES, 1, -1)
                   if rows_smem_bytes(d, cluster, s, frows)
                   <= common.MAX_SMEM_BYTES), 0)
    return cluster, rb, frows, stages


def rows_plan(d: int, micro_batch: int, n_rep: int = 1,
              sms: int = tune.H100_SMS) -> tuple[int, int, int, int]:
    """The rows kernel's plan as ``(cluster, rb, frows, stages)`` for
    ``n_rep`` replicas on ``sms`` SMs: each replica a cluster of the largest
    power of two of blocks up to ROWS_MAX_CLUSTER that leaves every block
    at least ROWS_MIN_SHARE rows of a batch and the replicas' clusters
    within the card (a power of two, so that clusters pack the card's
    GPCs), fewer where a ring of two stages does not fit beside the
    exchange; block ``k`` takes the run :func:`rows_split` gives it of each
    batch, in fills of at most ``frows`` rows through ``stages`` stages.
    ``(0, 0, 0, 0)`` past WARP_MAX_D."""
    if d > WARP_MAX_D:
        return 0, 0, 0, 0
    cap = max(1, min(ROWS_MAX_CLUSTER, sms // n_rep,
                     -(-micro_batch // ROWS_MIN_SHARE)))
    cluster = 1 << (cap.bit_length() - 1)
    while True:
        plan = _rows_fit(d, micro_batch, cluster)
        if plan[3] or cluster == 1:
            return plan
        cluster //= 2


def rows_split(batch_rows: int, cluster: int) -> list[tuple[int, int]]:
    """The run ``[lo, hi)`` of a batch of ``batch_rows`` rows each block of
    a rows cluster takes (csrc/glm_sgd.cu:RowsWalk): contiguous, in rank
    order, their lengths at most one apart, some empty where the batch is
    shorter than the cluster."""
    return [(k * batch_rows // cluster, (k + 1) * batch_rows // cluster)
            for k in range(cluster)]


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


#: chain threads of a grid kernel block (16 warps; 2 more warps copy)
GRID_CHAIN_THREADS = 512
#: most model values a chain thread of the grid kernel holds (its template
#: V: 4, 8, 16 or 24, the smallest that covers the slice)
GRID_MAX_VALUES = 24
#: most stages the grid kernel's ring holds ahead of the chain
GRID_MAX_STAGES = 8
#: most blocks a replica of the grid kernel (each lane of an exchange reads
#: 8 blocks' slots)
GRID_MAX_BLOCKS = 256


def grid_smem_bytes(slice_: int, stages: int, rows: int) -> int:
    """Shared memory of one ``"grid"`` block (csrc/glm_sgd.cu lays it out
    the same way): two mbarriers a stage, the 16 chain warps' partial
    margins of a fill and its pulls, and ``stages`` stages of ``rows`` rows
    of the block's slice of X (each after up to 3 floats of alignment) and
    their labels."""
    row = common.padded(slice_ + 3, 4)
    return (16 * stages
            + 4 * ((GRID_CHAIN_THREADS // 32) * rows + common.padded(rows, 4))
            + 4 * stages * (rows * row + common.padded(rows, 4)))


def _grid_stages(slice_: int, rows: int) -> int:
    """Stages of ``rows`` rows that fit beside the rest (0 below two)."""
    for stages in range(GRID_MAX_STAGES, 1, -1):
        if grid_smem_bytes(slice_, stages, rows) <= common.MAX_SMEM_BYTES:
            return stages
    return 0


def grid_plan(d: int, micro_batch: int, n_rep: int = 1,
              sms: int = tune.H100_SMS) -> tuple[int, int, int, int]:
    """The grid kernel's plan as ``(blocks, slice, stages, rows)`` for
    ``n_rep`` replicas on ``sms`` SMs: block ``b`` of a replica owns
    features ``[b * slice, (b + 1) * slice)`` of d (every block at least
    one) in its chain threads' registers, at most GRID_MAX_VALUES a thread,
    and streams them through a ring of ``stages`` fills of at most ``rows``
    rows (a whole batch up to CLUSTER_CHUNK_ROWS where two stages hold it,
    else as many rows as two stages allow, the batch then streamed twice).
    A replica takes ``sms // n_rep`` blocks, one a SM, so every block of
    the launch is co-resident; no more than the features need at one a
    chain thread.  ``(0, 0, 0, 0)`` where the slices or a two-stage ring do
    not fit."""
    per = min(sms // n_rep, GRID_MAX_BLOCKS)
    if per < 1:
        return 0, 0, 0, 0
    blocks = min(per, -(-d // GRID_CHAIN_THREADS))
    slice_ = -(-d // blocks)
    blocks = -(-d // slice_)
    if slice_ > GRID_CHAIN_THREADS * GRID_MAX_VALUES:
        return 0, 0, 0, 0
    want = min(micro_batch, CLUSTER_CHUNK_ROWS)
    rows = next((r for r in range(want, 0, -1) if _grid_stages(slice_, r)),
                0)
    if not rows:
        return 0, 0, 0, 0
    return blocks, slice_, _grid_stages(slice_, rows), rows


def variant(d: int, micro_batch: int, n_rep: int = 1,
            sms: int = tune.H100_SMS) -> str:
    """The kernel that runs ``(d, micro_batch)`` for ``n_rep`` replicas on
    ``sms`` SMs: up to WARP_MAX_D ``"warp"`` below ROWS_MIN_BATCH rows a
    batch where a two-stage ring fits, else ``"rows"``; ``"cluster"`` past
    WARP_MAX_D where :func:`cluster_plan` fits, ``"grid"`` past that where
    :func:`grid_plan` fits, else ``"global"``."""
    if d <= WARP_MAX_D:
        if micro_batch < ROWS_MIN_BATCH and warp_plan(d, micro_batch)[0]:
            return "warp"
        return "rows"
    if cluster_plan(d, micro_batch)[0]:
        return "cluster"
    if grid_plan(d, micro_batch, n_rep, sms)[0]:
        return "grid"
    return "global"


@common.register_kernel("glm_sgd", common.CUDA)
def _glm_sgd_cuda(task, W, X, y, *, step, micro_batch):
    n_rep, n, d = X.shape
    X, y = common.cuda_operand(X), common.cuda_operand(y)
    sms = common.sm_count(X.device)
    kind = variant(d, micro_batch, n_rep, sms)
    out = common.cuda_operand(W).clone()
    tail = n % micro_batch
    scales = (step / micro_batch, step / tail if tail else 0.0)
    with common.on_device(X):
        if kind == "rows":
            plan = rows_plan(d, micro_batch, n_rep, sms)
            fn = _build.function("glm_sgd", "glm_sgd_epoch_rows", _P, _P, _P,
                                 _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I,
                                 _P)
            code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(), n_rep, n,
                      d, micro_batch, common.task_code(task), *scales, *plan,
                      common.stream(X))
        elif kind == "grid":
            plan = grid_plan(d, micro_batch, n_rep, sms)
            blocks, rows = plan[0], plan[3]
            # one zeroed allocation: the exchange's tagged slots (8 bytes
            # each, tag 0 matches no exchange), then the pulls' scratch
            words = 2 * n_rep * 2 * blocks * rows
            buf = torch.zeros(words + n_rep * blocks * micro_batch,
                              dtype=torch.float32, device=X.device)
            fn = _build.function("glm_sgd", "glm_sgd_epoch_grid", _P, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                                 _I, _I, _I, _P)
            code = fn(X.data_ptr(), y.data_ptr(), out.data_ptr(),
                      buf[words:].data_ptr(), buf.data_ptr(), n_rep, n, d,
                      micro_batch, common.task_code(task), *scales, *plan,
                      common.stream(X))
        elif kind == "cluster":
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
    micro_batch: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """One mini-batch SGD epoch; returns the updated model (fp32, w's shape).

    With a replica axis every replica walks its own ``X[r]`` from ``w[r]``.
    ``micro_batch=None`` runs the tuner's cached pick for this call
    (:mod:`repro_torch.kernels.tune`), else DEFAULT_MICRO_BATCH.
    """
    single = w.dim() == 1
    W, Xr, yr = (w[None], X[None], y[None]) if single else (w, X, y)
    n_rep, n, d = Xr.shape
    if W.shape != (n_rep, d) or yr.shape != (n_rep, n) or n < 1:
        raise ValueError(f"glm_sgd shapes: w {tuple(w.shape)}, X "
                         f"{tuple(X.shape)}, y {tuple(y.shape)}")
    if micro_batch is None:
        backend = common.resolve_backend("glm_sgd", Xr.device, backend)
        key = (Xr.dtype, n_rep, n, d)
        cfg = tune.known("glm_sgd", backend, key)
        if cfg is None:
            cfg = tune.consult(
                "glm_sgd", backend,
                lambda: {"dtype": common.dtype_name(Xr), "n": n, "d": d,
                         "replicas": n_rep},
                lambda **c: common.dispatch("glm_sgd", Xr.device, task, W, Xr,
                                            yr, step=step, backend=backend,
                                            **c), key=key)
        micro_batch = cfg.get("micro_batch", DEFAULT_MICRO_BATCH)
    if micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
    out = common.dispatch("glm_sgd", Xr.device, task, W, Xr, yr, step=step,
                          micro_batch=micro_batch, backend=backend)
    return out[0] if single else out
