from repro_torch.kernels.glm_grad.ops import glm_grad  # noqa: F401
