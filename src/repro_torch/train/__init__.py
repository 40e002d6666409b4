"""Training infrastructure of the port: the sync and async-local steps
(:mod:`repro_torch.train.trainer`), checkpoint/restart, replica liveness
and the merge gate (:mod:`repro_torch.train.fault`)."""
