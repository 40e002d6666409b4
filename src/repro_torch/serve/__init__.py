"""Serving: the GLM scoring engine (:mod:`repro_torch.serve.glm`)."""
