"""Telemetry of the port: span tracing and metrics.

* :mod:`repro_torch.obs.trace`   — structured span tracer, one ``None``
  check per span when disabled; ``REPRO_TRACE=1`` writes JSONL traces.
* :mod:`repro_torch.obs.metrics` — process-local counters / gauges /
  histograms, persisted as a sidecar next to the traces.

Both keep the reference package's environment variables and file
schemas, under file names of their own (``...-torch-<pid>...``).
"""
from repro_torch.obs import metrics, trace  # noqa: F401
