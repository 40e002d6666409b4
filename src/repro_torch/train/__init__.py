"""Training infrastructure of the port: replica liveness and the merge
gate (:mod:`repro_torch.train.fault`)."""
