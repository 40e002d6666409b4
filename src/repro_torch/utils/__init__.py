"""Benchmark helpers: device-synchronizing wall timers."""
from repro_torch.utils.timing import Timer, median_time, time_stats

__all__ = ["Timer", "median_time", "time_stats"]
