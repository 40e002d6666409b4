"""Learning-rate schedules (step-decay is the paper's diminishing-step rule).

Each takes the optimizer's 0-d int32 step tensor and returns an fp32 0-d
tensor on its device."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def inverse_time(lr0: float, decay: float = 0.01):
    """alpha_t = alpha_0 / (1 + decay * t) — classic Robbins-Monro-style."""
    return lambda step: lr0 / (1.0 + decay * step.float())


def cosine(lr0: float, total_steps: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        s = step.float()
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr0 * warm * cos
    return f
