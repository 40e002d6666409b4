"""Telemetry of the port: span tracing, metrics and runtime health.

* :mod:`repro_torch.obs.trace`   — structured span tracer, one ``None``
  check per span when disabled; ``REPRO_TRACE=1`` writes JSONL traces.
* :mod:`repro_torch.obs.metrics` — process-local counters / gauges /
  histograms, persisted as a sidecar next to the traces.
* :mod:`repro_torch.obs.digest`  — bounded fixed-edge streaming quantile
  digest (latency p50/p99 without sorting).
* :mod:`repro_torch.obs.monitor` — sliding-window SLO health monitor over
  the scoring engine and the live learner (``HealthMonitor``).

They keep the reference package's environment variables and file
schemas, under file names of their own (``...-torch-<pid>...``).
"""
from repro_torch.obs import digest, metrics, monitor, trace  # noqa: F401
from repro_torch.obs.digest import QuantileDigest  # noqa: F401
from repro_torch.obs.monitor import (  # noqa: F401
    DEFAULT_LIVE_SLOS,
    DEFAULT_SERVE_SLOS,
    EWMADrift,
    HealthMonitor,
    SLOSpec,
)
