"""Serving: the GLM scoring engine (:mod:`repro_torch.serve.glm`) and the
LM slot engine (:mod:`repro_torch.serve.engine`)."""
