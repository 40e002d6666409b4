"""Roofline annotations on the NVIDIA H100 SXM.

* :mod:`repro_torch.roofline.kernels` — analytic FLOPs and HBM bytes of one
  launch of each kernel family, and the card's bound for them.
* :mod:`repro_torch.roofline.counts` — the dry run's op counts (dot flops
  by dtype, collective wire bytes, an HBM-traffic proxy), where the
  reference parses XLA's HLO (``hlo.py``).
* :mod:`repro_torch.roofline.analysis` — deliverable (g): each dry-run
  cell's compute, memory and collective terms on the card's peaks and
  links.
"""
from repro_torch.roofline import kernels  # noqa: F401
