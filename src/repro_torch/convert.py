"""Carry state and problems across from the reference package.

Everything arrives as numpy arrays (a caller holding the reference's
arrays passes them through ``np.asarray``) and leaves as tensors on
``device`` (``cuda`` unless the caller says).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import glm, sparse
from repro_torch.kernels import common


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(common.device(device))


def state_from_reference(w, device=None) -> torch.Tensor:
    """A model ``w [d]`` (SyncSGD) or replica stack ``W [R, d]``
    (AsyncLocalSGD) as an fp32 tensor on ``device``."""
    w = np.asarray(w)
    if w.ndim not in (1, 2):
        raise ValueError(f"state is w [d] or W [R, d], got shape {w.shape}")
    return _tensor(w, np.float32, device)


def problem_from_reference(task: str, X, y, step: float,
                           device=None) -> glm.GLMProblem:
    """A dense ``GLMProblem`` with X [N, d] and y [N] on ``device``."""
    return glm.GLMProblem(task, _tensor(X, np.float32, device),
                          _tensor(y, np.float32, device), float(step))


def ell_from_reference(values, indices, d: int,
                       device=None) -> sparse.ELLMatrix:
    """An ``ELLMatrix`` (values fp32, indices int32) on ``device``."""
    return sparse.ELLMatrix(_tensor(values, np.float32, device),
                            _tensor(indices, np.int32, device), int(d))
