from repro_torch.kernels.glm_sgd.ops import glm_sgd_epoch  # noqa: F401
