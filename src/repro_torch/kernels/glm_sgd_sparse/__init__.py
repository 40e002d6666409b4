from repro_torch.kernels.glm_sgd_sparse.ops import ell_sgd_epoch  # noqa: F401
