"""Fault tolerance: checkpoint/restart and the straggler policy.

* **Checkpoint/restart** — ``ResilientLoop`` wraps a step function with a
  ``CheckpointManager`` (async, keep-k).  On any step failure the loop
  restores the last checkpoint and replays.  Restore-on-start is the same
  code path (``resume=True``).
* **Straggler mitigation** — the async-local update strategy is itself the
  mitigation (replicas never wait for each other between merges), and
  ``MergeGate`` skips a dead replica at merge time (bounded staleness), so
  a dead replica degrades the merge instead of halting it.

The port's copy of the reference's ``Heartbeat``, ``MergeGate`` and
``ResilientLoop``; where the reference blocks on the state
(``jax.block_until_ready``) the loop synchronizes the state's card, and on
the CPU nothing.  Before it restores, the loop waits for the checkpoint
writer, so a save started before the failure is the one restored (the
reference reads whatever the writer has published by then).
``elastic_rescale`` re-places a live state on another mesh or placements
(grow or shrink): each leaf gathered whole, then distributed again, or
left a plain tensor on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.utils.tree import tree_leaves, tree_map


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


def _wait(state) -> None:
    """Wait for the state's card to finish the step (nothing on the CPU)."""
    leaf = next((x for x in tree_leaves(state)
                 if isinstance(x, torch.Tensor)), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


@dataclasses.dataclass
class ResilientLoop:
    """Step loop with checkpoint/restart and (simulated) failure injection."""

    step_fn: Callable                    # (state, batch) -> (state, metrics)
    ckpt: CheckpointManager
    state: Any
    resume: bool = True
    max_restore_retries: int = 3
    failure_hook: Callable[[int], bool] | None = None   # tests inject here

    def __post_init__(self):
        self.step = 0
        if self.resume:
            try:
                self.state, self.step = self.ckpt.restore(self.state)
                self.step += 1
            except FileNotFoundError:
                pass

    def run(self, batches, n_steps: int):
        """Returns (final_state, history).  Restores + replays on failure."""
        history = []
        it = iter(batches)
        while self.step < n_steps:
            batch = next(it)
            try:
                if self.failure_hook and self.failure_hook(self.step):
                    raise RuntimeError(f"injected failure @ step {self.step}")
                self.state, metrics = self.step_fn(self.state, batch)
                _wait(self.state)
            except Exception as e:  # noqa: BLE001 — restart on anything
                # the newest save may still be on the writer thread: let it
                # land, or the restore would miss it (or read it half written)
                self.ckpt.wait()
                restored = False
                for _ in range(self.max_restore_retries):
                    try:
                        self.state, self.step = self.ckpt.restore(self.state)
                        restored = True
                        break
                    except FileNotFoundError:
                        break
                if not restored:
                    raise RuntimeError(
                        f"step {self.step} failed and no checkpoint to "
                        f"restore") from e
                history.append(("restart", self.step, str(e)))
                self.step += 1
                continue
            history.append(("step", self.step, metrics))
            self.ckpt.maybe_save(self.step, self.state)
            self.step += 1
        self.ckpt.wait()
        return self.state, history


def elastic_rescale(state, new_shardings):
    """Re-place a live state onto a new mesh (grow/shrink).

    ``new_shardings`` holds ``state``'s containers; at each leaf either a
    ``(DeviceMesh, placements)`` pair, where the leaf becomes a DTensor on
    that mesh, or a device (``torch.device`` or its name), where it becomes
    a plain tensor there.  Each leaf is gathered whole first (a DTensor's
    ``full_tensor``, a collective every rank of its mesh joins)."""
    def one(x, where):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        if isinstance(where, (torch.device, str)):
            return full.to(where)
        mesh, placements = where
        return distribute_tensor(full.to(mesh.device_type), mesh, placements)

    return tree_map(one, state, new_shardings)
