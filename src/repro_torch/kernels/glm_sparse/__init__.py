from repro_torch.kernels.glm_sparse.ops import ell_glm_grad  # noqa: F401
