from repro_torch.kernels.glm_score.ops import glm_score  # noqa: F401
