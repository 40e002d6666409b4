"""Public wrapper for the fused GLM gradient.

``cuda`` runs ``csrc/glm_grad.cu``: a launch that writes per-block partial
sums (row layout: a block per 256-row tile; col layout: a warp per 32
examples of the materialised ``[d, N]`` transpose) and a second launch that
reduces them in a fixed order.  ``torch-reference`` runs ref.py.  Both
return the fp32 sum gradient ``[d]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_grad import ref as R

LAYOUTS = ("row", "col")

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib(name, *argtypes):
    return _build.function("glm_grad", name, *argtypes)


@common.register_kernel("glm_grad", common.CUDA)
def _glm_grad_cuda(task, w, X, y, *, layout):
    n, d = X.shape
    X, y, w = (common.cuda_operand(t) for t in (X, y, w))
    if layout == "col":
        X = X.T.contiguous()  # materialised transpose: the col access path
        launch = _lib("glm_grad_col", _P, _P, _P, _P, _I, _I, _I, _P)
        rows = _lib("glm_grad_col_rows")()
        nparts = common.padded(n, rows) // 32
    else:
        tile = _lib("glm_grad_tile_rows")()
        # w, the tile's pulls, one partial per thread (256 threads = tile)
        common.check_smem("glm_grad", 4 * (d + 2 * tile), f"d={d}")
        launch = _lib("glm_grad_row", _P, _P, _P, _P, _I, _I, _I, _P)
        nparts = common.padded(n, tile) // tile
    reduce = _lib("glm_grad_reduce", _P, _P, _I, _I, _P)
    partial = torch.empty((nparts, d), dtype=torch.float32, device=X.device)
    g = torch.empty(d, dtype=torch.float32, device=X.device)
    with common.on_device(X):
        s = common.stream(X)
        _build.check("glm_grad", launch(X.data_ptr(), y.data_ptr(), w.data_ptr(),
                                        partial.data_ptr(), n, d,
                                        common.task_code(task), s))
        common.count_launch("glm_grad")
        _build.check("glm_grad", reduce(partial.data_ptr(), g.data_ptr(),
                                        nparts, d, s))
        common.count_launch("glm_grad")
    return g


@common.register_kernel("glm_grad", common.TORCH_REFERENCE)
def _glm_grad_reference(task, w, X, y, *, layout):
    del layout  # the access path is a kernel-layout concept
    return R.glm_grad_ref(task, w, X, y)


def glm_grad(
    task: str,
    w: torch.Tensor,   # [d]
    X: torch.Tensor,   # [N, d]
    y: torch.Tensor,   # [N]
    *,
    layout: str = "row",
    backend: str | None = None,
) -> torch.Tensor:
    """Sum GLM gradient ``X^T pull(y * Xw)``.  Returns [d] fp32."""
    n, d = X.shape
    if w.shape != (d,) or y.shape != (n,) or n < 1:
        raise ValueError(f"glm_grad shapes: w {tuple(w.shape)}, X "
                         f"{tuple(X.shape)}, y {tuple(y.shape)}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    return common.dispatch("glm_grad", X.device, task, w, X, y, layout=layout,
                           backend=backend)
