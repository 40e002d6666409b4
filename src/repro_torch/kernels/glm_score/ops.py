"""Public wrapper for the fused ELL scoring kernel.

``cuda`` runs ``csrc/glm_score.cu``: one launch per batch, the task link
applied in the same launch.  :func:`variant` picks the kernel from the
shape:

* ``"flat"`` (``glm_score_flat_kernel``) for rows of up to
  :data:`FLAT_MAX_K` entries: a block owns a run of whole rows
  (:func:`score_plan`); every thread loads its share of the run's values
  and indices as 16-byte vectors before any gather and issues all its
  gathers at once; a run of one row is summed by the whole block, a run
  of several from shared memory by :func:`row_lanes` lanes a row;
* ``"group"`` (``glm_score_kernel``, the first port) for longer rows: a
  warp (or a sub-warp for narrow rows) strides over each row.

Rows are independent, so any ``N`` runs unpadded and ``d`` has no limit
but device memory (news' d=1,355,191 runs the flat kernel).  Both sum each
row in an order the shape fixes: the same bits on every call.
``torch-reference`` runs ref.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_score import ref as R

#: most threads a block of the flat kernel runs
FLAT_THREADS = 256
#: 16-byte chunks a thread of the flat kernel may take (its template V)
FLAT_VECTORS = (1, 2, 4)
#: the most words a run spans: FLAT_THREADS threads of 4 chunks
RUN_WORDS = 4 * FLAT_THREADS * FLAT_VECTORS[-1]
#: longest row the flat kernel takes: the row and up to 3 words before its
#: first 16-byte boundary in one run
FLAT_MAX_K = RUN_WORDS - 3

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P)
_FLAT_ARGS = _ARGS[:-1] + (_I,) * 5 + (_P,)


def flat_smem_bytes(threads: int, vectors: int) -> int:
    """Shared memory of one flat block: its chunks' products."""
    return 16 * threads * vectors


def flat_shape(rows: int, k: int) -> tuple[int, int]:
    """``(threads, vectors)`` of a run of ``rows`` rows of ``k`` words: the
    fewest chunks a thread (one of FLAT_VECTORS) with which up to
    FLAT_THREADS threads hold the run and the up to 3 words before its first
    16-byte boundary, and the threads that takes, a multiple of 32."""
    chunks = -(-(rows * k + 3) // 4)
    vectors = next(v for v in FLAT_VECTORS if chunks <= FLAT_THREADS * v)
    return common.padded(-(-chunks // vectors), 32), vectors


def row_lanes(rows: int, k: int, threads: int) -> int:
    """Lanes that sum a row of a run of several: the power of two up to 32
    with the shortest chain, the rounds the block's groups take over the
    rows times each lane's reads and shuffles (a tie goes to the wider
    group).  A run of one row is summed by the whole block instead."""
    def chain(g):
        return -(-rows // (threads // g)) * (-(-k // g) + g.bit_length() - 1)

    return min((32, 16, 8, 4, 2, 1), key=chain)


@functools.lru_cache(maxsize=256)
def score_plan(n: int, k: int, sms: int) -> tuple[int, int, int, int, bool]:
    """The flat kernel's ``(rows, threads, vectors, lanes, gated)`` for
    ``n`` rows of ``k`` words on ``sms`` SMs: runs of ``rows`` rows,
    ``ceil(n / sms)`` so that a batch spreads over every SM (a row a block
    up to 132 rows), at most RUN_WORDS words; :func:`flat_shape`'s threads
    and chunks a thread; :func:`row_lanes`; and ``gated`` where the runs
    outnumber the SMs: a chunk's indices are then read only where one of
    its values is not 0 (one more round trip, hidden by the other
    blocks)."""
    rows = max(1, min(-(-n // sms), (RUN_WORDS - 3) // max(k, 1)))
    threads, vectors = flat_shape(rows, k)
    return (rows, threads, vectors, row_lanes(rows, k, threads),
            -(-n // rows) > sms)


def variant(n: int, k: int, d: int) -> str:
    """The kernel that scores an ``[n, k]`` batch under a ``[d]`` model:
    ``"flat"`` for rows of up to FLAT_MAX_K entries, else ``"group"``.
    The model is gathered through L2 at every ``d``, so ``d`` does not move
    the choice."""
    return "flat" if k <= FLAT_MAX_K else "group"


@common.register_kernel("glm_score", common.CUDA)
def _glm_score_cuda(task, w, values, indices):
    n, k = values.shape
    values, w = common.cuda_operand(values), common.cuda_operand(w)
    indices = common.cuda_operand(indices, torch.int32)
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    d = w.shape[0]
    ptrs = (values.data_ptr(), indices.data_ptr(), w.data_ptr(),
            out.data_ptr())
    with common.on_device(values):
        if variant(n, k, d) == "flat":
            fn = _build.function("glm_score", "glm_score_flat", *_FLAT_ARGS)
            code = fn(*ptrs, n, k, common.task_code(task),
                      *score_plan(n, k, common.sm_count(values.device)),
                      common.stream(values))
        else:
            fn = _build.function("glm_score", "glm_score", *_ARGS)
            code = fn(*ptrs, n, k, common.task_code(task),
                      common.stream(values))
    _build.check("glm_score", code)
    common.count_launch("glm_score")
    return out


@common.register_kernel("glm_score", common.TORCH_REFERENCE)
def _glm_score_reference(task, w, values, indices):
    return R.glm_score_ref(task, w, values, indices)


def glm_score(
    task: str,
    w: torch.Tensor,        # [d]
    values: torch.Tensor,   # [N, K]  zero-padded ELL
    indices: torch.Tensor,  # [N, K]  int32
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """Served scores of a padded-ELL batch; returns ``[N]`` fp32 — LR rows
    sigmoid probabilities, SVM rows raw margins (``core.glm.LINKS``)."""
    if w.dim() != 1 or values.dim() != 2 or indices.shape != values.shape \
            or values.shape[0] < 1:
        raise ValueError(
            f"glm_score shapes: w {tuple(w.shape)}, values "
            f"{tuple(values.shape)}, indices {tuple(indices.shape)}")
    common.task_code(task)
    common.check_indices("glm_score", indices, w.shape[0])
    return common.dispatch("glm_score", values.device, task, w, values,
                           indices, backend=backend)
