"""Public wrapper for the fused GLM gradient.

``cuda`` runs ``csrc/glm_grad.cu``: a launch that writes per-block partial
sums and a second launch that reduces them in a fixed order.
:func:`variant` picks the first launch's kernel from ``(d, layout)`` alone:

* ``"ring"`` (``glm_grad_ring_kernel``), the row layout up to
  :data:`RING_MAX_D`: persistent blocks (:data:`RING_BLOCKS_PER_SM` a SM)
  walk contiguous tiles of rows through a ring of :data:`RING_STAGES`
  shared-memory stages that a copy warp fills with ``cp.async``; margins
  and partials both read the staged tile, so X leaves HBM once, and each
  block writes one partial row (:func:`ring_plan` sizes the tiles);
* ``"wide"`` (``glm_grad_wide_kernel``), the row layout past RING_MAX_D
  up to :data:`WIDE_MAX_CLUSTER` x 4,096 features (:func:`wide_plan`): a
  thread-block cluster splits the features, each block streaming its slice
  of the rows through a ring; a tile's partial margins are summed across
  the cluster through distributed shared memory while the chain finishes
  the tile before, and the same staged rows feed the gradient, so X leaves
  HBM once; each cluster writes one partial row, which a second launch
  adds a thread a feature;
* ``"row"`` (``glm_grad_row_kernel``, the first port), the row layout past
  that: a block per tile of up to 256 rows (:func:`row_tile`), which it
  reads twice;
* ``"col"`` (``glm_grad_col_kernel``): a warp per 32 examples of the
  materialised ``[d, N]`` transpose.

``torch-reference`` runs ref.py.  All return the fp32 sum gradient ``[d]``
and take any ``N`` and ``d``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common, tune
from repro_torch.kernels.glm_grad import ref as R

LAYOUTS = ("row", "col")

#: threads of a ring block that read the staged tiles (a copy warp beside)
RING_CONSUMERS = 256
#: widest model the ring kernel takes: 4 features a consumer thread
RING_MAX_D = 4 * RING_CONSUMERS
#: bytes of X a ring stage aims to hold, and its most rows
RING_STAGE_BYTES = 32 * 1024
RING_MAX_TILE = 128
#: stages of the ring, and persistent ring blocks a SM: the fastest pair
#: at covtype of those tools/grad_plan_sweep.py times
RING_STAGES = 2
RING_BLOCKS_PER_SM = 3

_P, _I = ctypes.c_void_p, ctypes.c_int


#: threads of a wide block that hold the block's slice (4 copy warps
#: beside), most features each, and most blocks a cluster
WIDE_CHAIN_THREADS = 256
WIDE_MAX_VALUES = 16
WIDE_MAX_CLUSTER = 16
#: the wide kernel's widest model
WIDE_MAX_D = WIDE_MAX_CLUSTER * WIDE_CHAIN_THREADS * WIDE_MAX_VALUES
#: a wide stage's most rows (one exchange), and the ring's fewest and most
#: stages: the chain holds two stages at once (it sums a tile's margins
#: while the next tile's exchange is in flight), so a third lets the copy
#: warps run ahead.  ``chip_smoke.py --dense``'s sweep of every tile found
#: the most rows with three stages fastest at 60,000 and 20,958 features
#: (4 and 7 rows) and a two-stage ring 1.4-1.9x slower; past 8 rows a
#: tile's butterflies carry 16 rows (PERF.md, PR 32)
WIDE_MAX_ROWS = 8
WIDE_MIN_STAGES = 3
WIDE_MAX_STAGES = 8


def variant(d: int, layout: str) -> str:
    """The kernel that runs ``(d, layout)``: ``"ring"`` for the row layout
    up to RING_MAX_D, ``"wide"`` past that up to WIDE_MAX_D, ``"row"``
    past that, ``"col"`` for the col layout."""
    if layout == "col":
        return "col"
    if d <= RING_MAX_D:
        return "ring"
    return "wide" if d <= WIDE_MAX_D else "row"


#: exchanges a wide block keeps in flight (slot buffers and their barriers)
WIDE_SLOTS = 4


def wide_smem_bytes(cluster: int, slice_: int, stages: int, tile: int) -> int:
    """Shared memory of one ``"wide"`` block (csrc/glm_grad.cu lays it out
    the same way): two mbarriers a stage and one a slot buffer, the
    WIDE_SLOTS slot buffers (a tile's rows from each chain warp of each
    block of the cluster), and ``stages`` stages of ``tile`` rows of the
    block's slice (each after up to 3 floats of alignment) and their
    labels."""
    pad = common.padded
    return (8 * (2 * stages + WIDE_SLOTS) + 4 * WIDE_SLOTS * cluster * 8 * tile
            + 4 * stages * (tile * pad(slice_ + 3, 4) + pad(tile, 4)))


def _wide_stages(cluster: int, slice_: int, tile: int) -> int:
    """Stages of ``tile`` rows that fit beside the rest (0 below
    WIDE_MIN_STAGES)."""
    return next((s for s in range(WIDE_MAX_STAGES, WIDE_MIN_STAGES - 1, -1)
                 if wide_smem_bytes(cluster, slice_, s, tile)
                 <= common.MAX_SMEM_BYTES), 0)


@functools.lru_cache(maxsize=256)
def wide_plan(d: int, tile: int | None = None) -> tuple[int, int, int, int]:
    """The wide kernel's ``(cluster, slice, T, stages)``: block ``b`` of a
    cluster owns features ``[b * slice, (b + 1) * slice)`` (every block at
    least one), the cluster the smallest power of two of blocks whose
    slices take at most WIDE_MAX_VALUES features a chain thread (a power of
    two packs the card's GPCs); tiles of T rows (``tile``, else the most,
    up to WIDE_MAX_ROWS, that leave WIDE_MIN_STAGES stages) through the
    most stages that fit, fewer rows where ``tile``'s do not fit.
    ``(0, 0, 0, 0)`` past WIDE_MAX_D."""
    cluster = 1
    while -(-d // cluster) > WIDE_CHAIN_THREADS * WIDE_MAX_VALUES:
        cluster *= 2
        if cluster > WIDE_MAX_CLUSTER:
            return 0, 0, 0, 0
    slice_ = -(-d // cluster)
    tile = next((t for t in range(min(tile or WIDE_MAX_ROWS, WIDE_MAX_ROWS),
                                  0, -1)
                 if _wide_stages(cluster, slice_, t)), 0)
    if not tile:
        return 0, 0, 0, 0
    return cluster, slice_, tile, _wide_stages(cluster, slice_, tile)


def wide_split(n: int, tile: int, clusters: int) -> tuple[int, int]:
    """``(per_cluster, nparts)``: cluster c walks tiles ``[c *
    per_cluster, (c + 1) * per_cluster)`` of the ``ceil(n / tile)``, the
    ``nparts`` clusters each at least one, at most ``clusters``."""
    tiles = -(-n // tile)
    per = -(-tiles // max(1, min(clusters, tiles)))
    return per, -(-tiles // per)


@functools.lru_cache(maxsize=64)
def _wide_clusters(plan: tuple[int, int, int, int], device_index: int) -> int:
    """How many clusters of ``plan`` card ``device_index`` holds at once
    (cudaOccupancyMaxActiveClusters), so a launch runs in one wave."""
    with torch.cuda.device(device_index):
        got = _lib("glm_grad_wide_clusters", _I, _I, _I, _I)(*plan)
    if got < 1:
        raise RuntimeError(f"glm_grad wide plan {plan}: no cluster fits "
                           f"the card ({got})")
    return got


def ring_lanes(tile: int) -> int:
    """Lanes a row of a T-row tile in the margin pass: the largest power
    of two up to 32 with T * L <= RING_CONSUMERS."""
    lanes = 1
    while lanes < 32 and 2 * lanes * tile <= RING_CONSUMERS:
        lanes *= 2
    return lanes


@functools.lru_cache(maxsize=256)
def ring_plan(d: int, n: int, sms: int, tile: int | None = None
              ) -> tuple[int, int, int, int]:
    """The ring kernel's ``(T, L, per_block, blocks)`` for ``n`` rows of
    ``d`` features on ``sms`` SMs: tiles of T rows (``tile``, else about
    RING_STAGE_BYTES of X, at most RING_MAX_TILE), L lanes a row in the
    margin pass (:func:`ring_lanes`), and blocks of ``per_block``
    consecutive tiles, about RING_BLOCKS_PER_SM blocks a SM."""
    if tile is None:
        tile = max(1, min(RING_MAX_TILE, RING_STAGE_BYTES // (4 * d)))
    lanes = ring_lanes(tile)
    tiles = -(-n // tile)
    per_block = -(-tiles // (RING_BLOCKS_PER_SM * sms))
    return tile, lanes, per_block, -(-tiles // per_block)


#: rows of a "row" block at most, and at least
ROW_MAX_TILE, ROW_MIN_TILE = 256, 8


def row_tile(n: int, sms: int) -> int:
    """Rows of a ``"row"`` block: 256, or fewer (a multiple of 8, at least
    8) where that leaves the card fewer than two blocks a SM."""
    fill = n // (2 * sms) // ROW_MIN_TILE * ROW_MIN_TILE
    return max(ROW_MIN_TILE, min(ROW_MAX_TILE, fill))


@functools.lru_cache(maxsize=256)
def ring_skew(d: int, lanes: int) -> int:
    """How many of its features a row's first read is skewed by, per row:
    the smallest skew for which the margin pass's first reads of the rows
    of a warp (row r's lane l at word r * (d + L * skew) + l) hit the
    fewest shared-memory banks at once.  covtype's d = 54 at two lanes a
    row needs none: its rows lie 54 words apart, and 54 / 2 is odd."""
    def worst(skew):
        banks = [0] * 32
        for r in range(32 // lanes):
            for lane in range(lanes):
                banks[(r * (d + lanes * skew) + lane) % 32] += 1
        return max(banks)

    return min(range(32), key=lambda skew: (worst(skew), skew))


def ring_smem_bytes(d: int, tile: int, stages: int = RING_STAGES) -> int:
    """Shared memory of one ring block (csrc/glm_grad.cu lays it out the
    same way): two mbarriers a stage, the tile's pulls, w, the partials'
    reduction, and ``stages`` stages of T rows as they lie in memory (after
    up to 3 floats of alignment) and their labels, each rounded to 16
    bytes."""
    pad = common.padded
    stage = pad(tile * d + 3, 4) + pad(tile, 4)
    return (16 * stages + 4 * (pad(tile, 4) + pad(d, 4)
                               + pad(max(d, RING_CONSUMERS), 4))
            + 4 * stages * stage)


def _lib(name, *argtypes):
    return _build.function("glm_grad", name, *argtypes)


@common.register_kernel("glm_grad", common.CUDA)
def _glm_grad_cuda(task, w, X, y, *, layout, block_rows=None):
    n, d = X.shape
    X, y, w = (common.cuda_operand(t) for t in (X, y, w))
    kind = variant(d, layout)
    plan = ()  # the kernel's tiling, after the common arguments
    if kind == "ring":
        tile, lanes, per_block, nparts = ring_plan(
            d, n, common.sm_count(X.device), block_rows)
        plan = (tile, lanes, ring_skew(d, lanes), RING_STAGES, per_block,
                nparts)
        launch = _lib("glm_grad_ring", _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _P)
    elif kind == "wide":
        plan = wide_plan(d, block_rows)
        per, nparts = wide_split(n, plan[2],
                                 _wide_clusters(plan, X.device.index))
        plan = (*plan, per, nparts)
        launch = _lib("glm_grad_wide", _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _P)
    elif kind == "col":
        X = X.T.contiguous()  # materialised transpose: the col access path
        launch = _lib("glm_grad_col", _P, _P, _P, _P, _I, _I, _I, _P)
        nparts = common.padded(n, _lib("glm_grad_col_rows")()) // 32
    else:
        launch = _lib("glm_grad_row", _P, _P, _P, _P, _I, _I, _I, _I, _P)
        tile = block_rows or row_tile(n, common.sm_count(X.device))
        plan = (tile,)
        nparts = common.padded(n, tile) // tile
    # the wide kernel's few partial rows: a thread a feature
    reduce = _lib("glm_grad_sum" if kind == "wide" else "glm_grad_reduce",
                  _P, _P, _I, _I, _P)
    partial = torch.empty((nparts, d), dtype=torch.float32, device=X.device)
    g = torch.empty(d, dtype=torch.float32, device=X.device)
    with common.on_device(X):
        s = common.stream(X)
        _build.check("glm_grad", launch(X.data_ptr(), y.data_ptr(),
                                        w.data_ptr(), partial.data_ptr(), n,
                                        d, common.task_code(task), *plan, s))
        common.count_launch("glm_grad")
        _build.check("glm_grad", reduce(partial.data_ptr(), g.data_ptr(),
                                        nparts, d, s))
        common.count_launch("glm_grad")
    return g


@common.register_kernel("glm_grad", common.TORCH_REFERENCE)
def _glm_grad_reference(task, w, X, y, *, layout, block_rows=None):
    del layout, block_rows  # the access path and tiling are the kernel's
    return R.glm_grad_ref(task, w, X, y)


def glm_grad(
    task: str,
    w: torch.Tensor,   # [d]
    X: torch.Tensor,   # [N, d]
    y: torch.Tensor,   # [N]
    *,
    layout: str = "row",
    block_rows: int | None = None,
    backend: str | None = None,
) -> torch.Tensor:
    """Sum GLM gradient ``X^T pull(y * Xw)``.  Returns [d] fp32.

    ``block_rows`` sets the rows of the row layout's tiles (a ring or wide
    stage, or a row block); None runs the tuner's cached pick for this call
    (:mod:`repro_torch.kernels.tune`), else the plan's.  The col layout
    has no tiles to set.
    """
    n, d = X.shape
    if w.shape != (d,) or y.shape != (n,) or n < 1:
        raise ValueError(f"glm_grad shapes: w {tuple(w.shape)}, X "
                         f"{tuple(X.shape)}, y {tuple(y.shape)}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if block_rows is None and layout == "row":
        backend = common.resolve_backend("glm_grad", X.device, backend)
        key = (X.dtype, n, d)
        cfg = tune.known("glm_grad", backend, key)
        if cfg is None:
            cfg = tune.consult(
                "glm_grad", backend,
                lambda: {"dtype": common.dtype_name(X), "n": n, "d": d},
                lambda **c: common.dispatch("glm_grad", X.device, task, w, X,
                                            y, layout=layout,
                                            backend=backend, **c), key=key)
        block_rows = cfg.get("block_rows")
    return common.dispatch("glm_grad", X.device, task, w, X, y, layout=layout,
                           block_rows=block_rows, backend=backend)
