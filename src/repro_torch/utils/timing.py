"""Wall-clock timing helpers for benchmarks (device-synchronizing).

A timed call's result is waited for before the clock stops: on the card
PyTorch returns before the device finishes, so the helpers synchronize
the device of every CUDA tensor the call returned.  CPU tensors need no
wait.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


class Timer:
    """Context-manager wall timer (seconds)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dict values)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


def _block(x):
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


def time_stats(fn: Callable, *args, warmup: int = 2, iters: int = 5,
               **kwargs) -> dict:
    """Timing dispersion of ``fn(*args)`` with device sync.

    Returns ``{"median", "min", "mean", "std", "iters"}`` in wall-clock
    seconds.
    """
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "median": statistics.median(times),
        "min": min(times),
        "mean": statistics.fmean(times),
        "std": statistics.pstdev(times) if len(times) > 1 else 0.0,
        "iters": len(times),
    }


def median_time(fn: Callable, *args, warmup: int = 2, iters: int = 5, **kwargs) -> float:
    """Median wall-clock seconds of ``fn(*args)`` with device sync."""
    return time_stats(fn, *args, warmup=warmup, iters=iters,
                      **kwargs)["median"]
