"""Straggler and failure policy for async-local training.

The port's copy of the reference's ``Heartbeat`` and ``MergeGate``: the
async-local update strategy is itself the straggler mitigation (replicas
never wait for each other between merges), and the gate skips a dead
replica at merge time (bounded staleness), so a dead replica degrades the
merge instead of halting it.  Pure numpy.  The reference's
``ResilientLoop`` and ``elastic_rescale`` need checkpointing and wait for
the LM substrate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    """Replica liveness bookkeeping.

    ``clock`` is injectable (monotonic seconds) so staleness tests pin
    time deterministically instead of sleeping."""

    n_replicas: int
    timeout_s: float = 300.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.last_seen = np.full(self.n_replicas, self.clock())

    def beat(self, replica: int):
        self.last_seen[replica] = self.clock()

    def alive(self) -> np.ndarray:
        return (self.clock() - self.last_seen) < self.timeout_s


class MergeGate:
    """Bounded-staleness merge policy for async-local training.

    ``should_merge(step)`` -> merge every K steps; ``alive_mask()`` lets the
    merge average only live replicas (a dead replica is dropped from the
    mean and re-seeded from the merged model when it returns)."""

    def __init__(self, merge_every: int, heartbeat: Heartbeat):
        self.merge_every = merge_every
        self.heartbeat = heartbeat

    def should_merge(self, step: int) -> bool:
        return step > 0 and step % self.merge_every == 0

    def alive_mask(self) -> np.ndarray:
        return self.heartbeat.alive()
