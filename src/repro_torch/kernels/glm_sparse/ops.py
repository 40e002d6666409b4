"""Public wrapper for the ELL sparse GLM gradient.

``cuda`` runs ``csrc/glm_sparse.cu``: one launch, a warp per row gathering
the model from global memory and scattering ``vals * pull`` with global
atomics into a zeroed gradient; replicas on the grid's second axis.  No
limit on d but device memory.  ``torch-reference`` runs ref.py.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sparse import ref as R

_P, _I = ctypes.c_void_p, ctypes.c_int


@common.register_kernel("glm_sparse", common.CUDA)
def _glm_sparse_cuda(task, W, values, indices, y):
    n_rep, n, k = values.shape
    d = W.shape[1]
    values, y, W = (common.cuda_operand(t) for t in (values, y, W))
    indices = common.cuda_operand(indices, torch.int32)
    G = torch.zeros((n_rep, d), dtype=torch.float32, device=values.device)
    fn = _build.function("glm_sparse", "ell_glm_grad", _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P)
    with common.on_device(values):
        code = fn(values.data_ptr(), indices.data_ptr(), y.data_ptr(),
                  W.data_ptr(), G.data_ptr(), n_rep, n, k, d,
                  common.task_code(task), common.stream(values))
    _build.check("glm_sparse", code)
    common.count_launch("glm_sparse")
    return G


@common.register_kernel("glm_sparse", common.TORCH_REFERENCE)
def _glm_sparse_reference(task, W, values, indices, y):
    return R.ell_glm_grad_ref(task, W, values, indices, y)


def ell_glm_grad(
    task: str,
    w: torch.Tensor,        # [d]     or [R, d]
    values: torch.Tensor,   # [N, K]  or [R, N, K]
    indices: torch.Tensor,  # [N, K]  or [R, N, K]  int32
    y: torch.Tensor,        # [N]     or [R, N]
    *,
    backend: str | None = None,
) -> torch.Tensor:
    """ELL sparse sum gradient; returns fp32 in w's shape."""
    single = w.dim() == 1
    args = (w[None], values[None], indices[None], y[None]) if single \
        else (w, values, indices, y)
    W, v, i, yr = args
    n_rep, n, _ = v.shape
    if W.shape[0] != n_rep or i.shape != v.shape or yr.shape != (n_rep, n) \
            or n < 1:
        raise ValueError(
            f"glm_sparse shapes: w {tuple(w.shape)}, values "
            f"{tuple(values.shape)}, indices {tuple(indices.shape)}, y "
            f"{tuple(y.shape)}")
    common.check_indices("glm_sparse", indices, W.shape[1])
    out = common.dispatch("glm_sparse", v.device, task, *args, backend=backend)
    return out[0] if single else out
