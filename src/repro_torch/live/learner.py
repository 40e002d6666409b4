"""The live async-local SGD learner: replica-merge over a stream.

The port of the reference's learner: the paper's §5.1 replica-merge
scheme lifted to the continual setting.  The learner consumes an
unbounded :mod:`repro_torch.live.stream` minibatch sequence, runs one
local pass per replica per stream step, and merges the replicas every
``merge_every`` steps, with

* **bounded-staleness fault masking** — the merge averages only the
  replicas :class:`repro_torch.train.fault.MergeGate` reports alive; a
  dead replica's model is frozen and dropped from the mean, and on
  revival it is re-seeded from the latest merged model;
* **error-feedback compressed merges** — ``compress=True`` exchanges
  int8-quantized per-replica deltas from the last merged anchor
  (:mod:`repro_torch.optim.compress`), with a persistent per-replica
  error-feedback buffer;
* **kernel passes** — every replica pass goes through the kernel
  families with the replica axis they take (one launch per step for all
  replicas): dense -> ``glm_sgd``; sparse with ``local_batch == per`` ->
  ``glm_sparse`` then ``w - step/per * g``; otherwise ``glm_sgd_sparse``.
  ``kernel_backend=None`` takes the flavor the device implies, as in
  :mod:`repro_torch.core.sgd`.

The learner never writes ``W`` or ``anchor`` in place: every step and
merge makes new tensors, so a reference someone kept (the publisher's
copy, a test's) never changes under them.  Every step/merge emits
``live.step`` / ``live.merge`` spans and ``live.*`` counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Literal

import numpy as np
import torch

from repro_torch.core import sparse
from repro_torch.core.sgd import partition_indices
from repro_torch.kernels import common
from repro_torch.kernels.glm_sgd import glm_sgd_epoch
from repro_torch.kernels.glm_sgd_sparse import ell_sgd_epoch
from repro_torch.kernels.glm_sparse import ell_glm_grad
from repro_torch.live.stream import StreamBatch
from repro_torch.obs import metrics, trace
from repro_torch.optim import compress as C
from repro_torch.train.fault import Heartbeat, MergeGate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Knobs of the live loop (the offline ``AsyncLocalSGD`` axes plus
    the staleness/compression knobs the continual setting adds).

    replicas        R model replicas (paper's model-replication axis).
    step_size       SGD step alpha (constant; streams are unbounded).
    local_batch     per-replica update granularity (1 = incremental).
    merge_every     merge period in *stream steps* (staleness knob #1).
    access/rep_k    example->replica assignment within a chunk
                    (row-rr / row-ch + halos), as in the offline engine.
    compress        int8 error-feedback delta exchange at merges.
    kernel_backend  kernel flavor (None = the one the device implies).
    timeout_s       heartbeat staleness bound for the merge gate.
    """

    task: str = "lr"
    replicas: int = 4
    step_size: float = 0.05
    local_batch: int = 1
    merge_every: int = 4
    access: Literal["round_robin", "chunk"] = "chunk"
    rep_k: int = 0
    compress: bool = False
    kernel_backend: str | None = None
    timeout_s: float = 60.0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1: {self.replicas}")
        if self.merge_every < 1:
            raise ValueError(f"merge_every must be >= 1: {self.merge_every}")
        if self.local_batch < 1:
            raise ValueError(f"local_batch must be >= 1: {self.local_batch}")


class LiveLearner:
    """Replica-merge SGD over a live stream — see the module docstring.

    Single-threaded by design (call :meth:`step` from one thread);
    concurrency with the serving path happens through the publisher's
    ``swap_model``, which copies.  ``device`` is where the replicas live
    and the passes run: ``cuda`` unless the caller says.  ``clock`` feeds
    the heartbeat (injectable for deterministic staleness tests);
    :meth:`kill` / :meth:`revive` simulate replica death.
    """

    def __init__(self, config: LiveConfig, stream, *, device=None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self.stream = stream
        self.d = stream.d
        self.device = common.device(device)
        R = config.replicas
        parts = partition_indices(
            stream.n_batch, R, config.access, config.rep_k)
        self.per = parts.shape[1]
        if self.per < 1:
            raise ValueError(
                f"chunk of {stream.n_batch} rows cannot feed "
                f"{R} replicas")
        if self.per % config.local_batch:
            raise ValueError(
                f"local_batch must divide the per-replica partition "
                f"{self.per} (= n_batch//replicas + rep_k), got "
                f"{config.local_batch}")
        self._parts = parts
        self._parts_t = torch.from_numpy(parts).long().to(self.device)
        self.heartbeat = Heartbeat(R, config.timeout_s, clock=clock)
        self.gate = MergeGate(config.merge_every, self.heartbeat)
        zeros = dict(dtype=torch.float32, device=self.device)
        self.W: Tensor = torch.zeros((R, self.d), **zeros)
        self.anchor: Tensor = torch.zeros((self.d,), **zeros)
        self._ef: Tensor | None = (
            torch.zeros((R, self.d), **zeros) if config.compress else None)
        self.steps = 0
        self.merges = 0
        self.merges_skipped = 0
        #: optional health monitor with ``on_learner_step(learner)``
        self.monitor = None
        self._merge_hooks: list[Callable[["LiveLearner"], None]] = []
        self._iter = iter(stream)

    # -- the replica pass ----------------------------------------------------

    def _pass(self, batch: StreamBatch) -> Tensor:
        """Every replica's local pass over its partition of ``batch``:
        one kernel launch for all replicas."""
        cfg = self.config
        task, step, lb = cfg.task, cfg.step_size, cfg.local_batch
        backend, dev, parts = cfg.kernel_backend, self.device, self._parts_t
        y = torch.from_numpy(batch.y).to(dev)[parts]
        if getattr(self.stream, "dense", False):
            X = torch.from_numpy(batch.X).to(dev)[parts]
            return glm_sgd_epoch(task, self.W, X, y, step=step,
                                 micro_batch=lb, backend=backend)
        values = torch.from_numpy(batch.values).to(dev)[parts]
        # checked on the host before the copy: no read of the card per step
        indices = common.host_checked_indices(
            "live", batch.indices[self._parts], self.d, dev)
        if lb == self.per:
            # full-partition update: the glm_sparse sum gradient
            g = ell_glm_grad(task, self.W, values, indices, y,
                             backend=backend)
            return self.W - (step / self.per) * g
        return ell_sgd_epoch(task, self.W, values, indices, y, step=step,
                             micro_batch=lb, backend=backend)

    # -- liveness ------------------------------------------------------------

    def alive(self) -> np.ndarray:
        return self.gate.alive_mask()

    def kill(self, replica: int) -> None:
        """Simulate replica death: its heartbeat goes permanently stale
        (until :meth:`revive`), so it stops training and is dropped from
        merges."""
        self.heartbeat.last_seen[replica] = -np.inf
        metrics.counter("live.kills").inc()

    def revive(self, replica: int) -> None:
        """Revive a dead replica: fresh heartbeat + model re-seeded from
        the latest merged anchor (it rejoins the consensus, not its own
        stale past)."""
        self.heartbeat.beat(replica)
        W = self.W.clone()
        W[replica] = self.anchor
        self.W = W
        if self._ef is not None:
            ef = self._ef.clone()
            ef[replica] = 0.0
            self._ef = ef
        metrics.counter("live.revivals").inc()

    # -- the loop ------------------------------------------------------------

    @property
    def merged_model(self) -> Tensor:
        """The latest merged model ``[d]`` (zeros before the first
        merge) — what the publisher ships to the scoring engine."""
        return self.anchor

    def add_merge_hook(self, fn: Callable[["LiveLearner"], None]) -> None:
        """``fn(learner)`` runs after every completed merge (the
        publisher attaches here)."""
        self._merge_hooks.append(fn)

    def _mask(self, alive: np.ndarray) -> Tensor:
        return torch.from_numpy(alive).to(self.device)

    def step(self) -> StreamBatch:
        """One stream step: fetch the next chunk, run one local pass on
        every replica, keep it for the *alive* ones, merge when the gate
        says so.  Returns the consumed batch."""
        batch = next(self._iter)
        alive = self.gate.alive_mask()
        with trace.span("live.step", step=self.steps, seq=batch.seq,
                        alive=int(alive.sum())):
            W_new = self._pass(batch)
            self.W = torch.where(self._mask(alive)[:, None], W_new, self.W)
        # alive replicas made progress this step; dead ones stay silent
        for r in np.nonzero(alive)[0]:
            self.heartbeat.beat(int(r))
        self.steps += 1
        metrics.counter("live.steps").inc()
        if self.gate.should_merge(self.steps):
            self.merge()
        if self.monitor is not None:
            self.monitor.on_learner_step(self)
        return batch

    def merge(self) -> Tensor | None:
        """Average the alive replicas (optionally through the int8
        error-feedback channel), redistribute, and advance the anchor.
        Returns the merged model, or None when every replica is dead
        (the merge is skipped — the stream keeps flowing)."""
        alive = self.gate.alive_mask()
        n_alive = int(alive.sum())
        if n_alive == 0:
            self.merges_skipped += 1
            metrics.counter("live.merges_skipped").inc()
            if trace.enabled():
                trace.instant("live.merge_skipped", step=self.steps)
            return None
        with trace.span("live.merge", step=self.steps, merge=self.merges,
                        alive=n_alive,
                        compressed=bool(self.config.compress)):
            mask = self._mask(alive)
            if self.config.compress:
                merged, self._ef = _compressed_merge(
                    self.W, self.anchor, self._ef, mask)
            else:
                merged = _masked_mean(self.W, mask)
            self.W = torch.where(mask[:, None], merged.expand_as(self.W),
                                 self.W)
            self.anchor = merged
        self.merges += 1
        metrics.counter("live.merges").inc()
        for hook in self._merge_hooks:
            hook(self)
        return merged

    def run(self, n_steps: int) -> "LiveLearner":
        for _ in range(n_steps):
            self.step()
        return self

    def loss(self, eval_ell: sparse.ELLMatrix, y) -> float:
        """Holdout loss of the merged model (the served quantity)."""
        y = torch.as_tensor(y, dtype=torch.float32,
                            device=eval_ell.values.device)
        return float(sparse.loss(self.config.task, eval_ell, y,
                                 self.anchor.to(eval_ell.values.device)))


# ---------------------------------------------------------------------------
# merge math (plain tensor code)
# ---------------------------------------------------------------------------


def _masked_mean(W: Tensor, alive: Tensor) -> Tensor:
    """Mean over alive rows only (dead replicas dropped from the
    consensus, paper §5.1 merge thread + MergeGate masking)."""
    mask = alive.to(W.dtype)
    return (mask @ W) / torch.clamp(mask.sum(), min=1.0)


def _compressed_merge(W: Tensor, anchor: Tensor, ef: Tensor,
                      alive: Tensor) -> tuple[Tensor, Tensor]:
    """int8 error-feedback delta exchange: each alive replica quantizes
    ``w_r - anchor`` (plus its carried residual), the dequantized deltas
    average into the new anchor, residuals persist per replica.  Dead
    replicas exchange nothing and their feedback is frozen."""

    def one(w_r, ef_r):
        delta = (w_r - anchor) + ef_r
        q, s = C.quantize_leaf(delta)
        deq = C.dequantize_leaf(q, s, delta)
        return deq, delta - deq

    deq, ef_new = torch.func.vmap(one)(W, ef)
    mask = alive.to(W.dtype)
    mean_delta = (mask @ deq) / torch.clamp(mask.sum(), min=1.0)
    ef = torch.where(alive[:, None], ef_new, ef)
    return anchor + mean_delta, ef
