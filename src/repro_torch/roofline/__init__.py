"""Roofline annotations on the NVIDIA H100 SXM.

* :mod:`repro_torch.roofline.kernels` — analytic FLOPs and HBM bytes of one
  launch of each kernel family, and the card's bound for them.

The reference's ``analysis.py`` and ``hlo.py`` read XLA's HLO cost
analysis; they have no PyTorch counterpart here.
"""
from repro_torch.roofline import kernels  # noqa: F401
