"""Live training: online async-local SGD that trains while serving.

The port of the reference's live layer, over the port's replica-merge
kernels, its merge gate (:mod:`repro_torch.train.fault`) and its scoring
engine (:mod:`repro_torch.serve.glm`):

* :mod:`repro_torch.live.stream`  — deterministic seedable minibatch
  streams (synthetic planted-GLM + replayable chunked libsvm);
* :mod:`repro_torch.live.learner` — the replica-merge loop with liveness
  masking, kill/revive, optional int8 error-feedback merge compression,
  and kernel replica passes;
* :mod:`repro_torch.live.publish` — staleness-bounded snapshot
  publishing into the scoring engine, step-stamped per snapshot.
"""
from repro_torch.live.learner import LiveConfig, LiveLearner
from repro_torch.live.publish import SnapshotPublisher
from repro_torch.live.stream import LibsvmStream, StreamBatch, SyntheticStream

__all__ = [
    "LiveConfig",
    "LiveLearner",
    "LibsvmStream",
    "SnapshotPublisher",
    "StreamBatch",
    "SyntheticStream",
]
