"""Kernel layer: hand-written Hopper kernels behind a dispatch registry.

Each family is ``ops.py`` (public wrapper + both flavors) / ``ref.py``
(plain PyTorch version) beside its CUDA source ``csrc/<family>.cu``.
Importing this package registers all families; see common.py for the
selection rules and the ``REPRO_TORCH_KERNEL_BACKEND`` override.
"""
from repro_torch.kernels import common  # noqa: F401  (must precede family imports)
from repro_torch.kernels.common import (  # noqa: F401
    CUDA,
    LAUNCHES,
    TORCH_REFERENCE,
    backends_for,
    dispatch,
    register_kernel,
    registered_kernels,
    reset_launches,
    resolve_backend,
)
from repro_torch.kernels.flash_attn import flash_attention  # noqa: F401
from repro_torch.kernels.glm_grad import glm_grad  # noqa: F401
from repro_torch.kernels.glm_score import glm_score  # noqa: F401
from repro_torch.kernels.glm_sgd import glm_sgd_epoch  # noqa: F401
from repro_torch.kernels.glm_sgd_sparse import ell_sgd_epoch  # noqa: F401
from repro_torch.kernels.glm_sparse import ell_glm_grad  # noqa: F401
