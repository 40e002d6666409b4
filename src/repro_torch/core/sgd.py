"""Parallel SGD engine — the paper's exploratory axes as configuration.

* **Model-update strategy** — ``SyncSGD`` (Algorithm 2: one update per
  batch, barriered) vs ``AsyncLocalSGD`` (R model replicas doing
  independent mini-batch/incremental updates over their partitions, merged
  periodically; the per-NUMA-node replica scheme of paper Section 5.1).
* **Model replication** — the replica count R.
* **Data access path** — ``round_robin`` interleaves examples across
  replicas, ``chunk`` gives contiguous ranges.
* **Data replication** — ``rep_k`` halo examples from the next partition
  (paper Section 5.2.3).

Every epoch goes through the kernel registry: dense full batch ->
``glm_grad``, dense mini-batch and every dense replica epoch -> ``glm_sgd``,
sparse full batch -> ``glm_sparse``, sparse mini-batch -> ``glm_sgd_sparse``.
The replica axis is a tensor axis the kernels take directly (one block per
replica).  ``kernel_backend=None`` picks the flavor from the data's device:
``cuda`` on the card, ``torch-reference`` on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np
import torch

from repro_torch.core import glm, sparse
from repro_torch.kernels import common
from repro_torch.kernels.glm_grad import glm_grad
from repro_torch.kernels.glm_sgd import glm_sgd_epoch
from repro_torch.kernels.glm_sgd_sparse import ell_sgd_epoch
from repro_torch.kernels.glm_sparse import ell_glm_grad
from repro_torch.obs import trace

AccessPath = Literal["round_robin", "chunk"]
MergeScheme = Literal["mean", "weighted"]

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SyncSGD:
    """Synchronous (transactional) updates.

    ``batch`` = B in Algorithm 1: None gives batch gradient descent (B = N),
    smaller B mini-batch synchronous SGD with an update barrier per batch.
    ``kernel_backend`` names the kernel flavor (``cuda`` /
    ``torch-reference``); None takes the one the data's device implies.
    """

    batch: int | None = None  # None -> full batch (B = N)
    kernel_backend: str | None = None

    @property
    def name(self) -> str:
        base = "sync" if self.batch is None else f"sync-b{self.batch}"
        if self.kernel_backend:
            base += f"[{self.kernel_backend}]"
        return base


@dataclasses.dataclass(frozen=True)
class AsyncLocalSGD:
    """Asynchronous replica-merge updates.

    replicas      R model replicas (model-replication granularity).
    local_batch   per-replica update granularity (1 = incremental Hogwild).
    merge_every   merge period in *epochs*; <1 merges several times per
                  epoch (0.25 => 4 merges/epoch).  Above 1 the reference
                  engine still merges every epoch, and so does this one.
    access        example->replica assignment (row-rr vs row-ch).
    rep_k         halo data replication (paper Section 5.2.3).
    """

    replicas: int = 8
    local_batch: int = 1
    merge_every: float = 1.0
    access: AccessPath = "chunk"
    rep_k: int = 0
    merge: MergeScheme = "mean"
    kernel_backend: str | None = None

    @property
    def name(self) -> str:
        base = (
            f"async-r{self.replicas}-b{self.local_batch}"
            f"-m{self.merge_every}-{self.access[:5]}-rep{self.rep_k}"
        )
        if self.kernel_backend:
            base += f"[{self.kernel_backend}]"
        return base


# ---------------------------------------------------------------------------
# Data partitioning (access path + rep-k halos)
# ---------------------------------------------------------------------------


def partition_indices(
    n: int, replicas: int, access: AccessPath = "chunk", rep_k: int = 0
) -> np.ndarray:
    """Example->replica assignment matrix ``[replicas, per + rep_k]``.

    ``chunk``       replica r gets the contiguous range [r*per, (r+1)*per).
    ``round_robin`` replica r gets examples r, r+R, r+2R, ...
    ``rep_k``       each replica also gets the first ``rep_k`` examples of
                    the following partitions in cyclic order (a halo).
    """
    per = n // replicas
    base = np.arange(per * replicas)
    if access == "chunk":
        parts = base.reshape(replicas, per)
    elif access == "round_robin":
        parts = base.reshape(per, replicas).T
    else:
        raise ValueError(access)
    if rep_k > 0:
        halos = []
        for r in range(replicas):
            stream = np.concatenate(
                [parts[(r + s) % replicas] for s in range(1, replicas + 1)])
            halos.append(stream[:rep_k])
        parts = np.concatenate([parts, np.stack(halos, axis=0)], axis=1)
    return parts.astype(np.int32)


def merge_replicas(W: torch.Tensor, scheme: MergeScheme = "mean") -> torch.Tensor:
    """Replica merge: average and redistribute (paper Section 5.1)."""
    if scheme == "mean":
        return W.mean(dim=0, keepdim=True).expand_as(W).contiguous()
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# Run loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunResult:
    """History of one SGD run (the three performance axes derive from it)."""

    losses: np.ndarray          # [epochs+1] loss after each epoch (incl. init)
    epoch_times: np.ndarray     # [epochs]   wall seconds per epoch
    strategy: str
    task: str
    #: the final state: w [d] (SyncSGD) or W [R, d] (AsyncLocalSGD)
    model: torch.Tensor | None = None

    def epochs_to(self, target: float) -> int | None:
        """Statistical efficiency: #epochs to reach loss <= target."""
        hit = np.nonzero(self.losses <= target)[0]
        return int(hit[0]) if len(hit) else None

    def time_to(self, target: float) -> float | None:
        """Time to convergence: sum of epoch times until target reached."""
        e = self.epochs_to(target)
        if e is None:
            return None
        return float(np.sum(self.epoch_times[:e]))

    @property
    def time_per_epoch(self) -> float:
        """Hardware efficiency: mean seconds per epoch."""
        return float(np.mean(self.epoch_times))


def _divisor_error(per: int, local_batch: int) -> ValueError:
    return ValueError(
        f"kernel epochs need local_batch to divide the partition size {per} "
        f"(= n//replicas + rep_k), got {local_batch}")


def make_epoch_fn(problem, strategy, *, sparse_data: bool = False):
    """Build a ``(state) -> state`` epoch function and its initial state.

    Returns ``(init_state, epoch_fn, loss_fn, merges_per_epoch)``.  For
    SyncSGD the state is ``w [d]``; for AsyncLocalSGD it is ``W [R, d]``.
    ``problem`` is a ``glm.GLMProblem`` or, with ``sparse_data``, a tuple
    ``(task, ELLMatrix, y, step)``; the state lives on its tensors' device.
    """
    if sparse_data:
        task, m, y, step = problem
        # before the first loss, which gathers with the indices
        common.check_indices("sgd", m.indices, m.d)
        n, d = m.shape
        dev = m.values.device
    else:
        task, X, y, step = problem.task, problem.X, problem.y, problem.step
        n, d = X.shape
        dev = X.device
    if task not in glm.PULLS:
        raise ValueError(f"unknown task {task!r}")
    backend = strategy.kernel_backend

    if isinstance(strategy, SyncSGD):
        batch = strategy.batch or n
        if sparse_data:
            def epoch(w):
                if batch >= n:
                    return w - step * ell_glm_grad(
                        task, w, m.values, m.indices, y, backend=backend)
                return ell_sgd_epoch(task, w, m.values, m.indices, y,
                                     step=step, micro_batch=batch,
                                     backend=backend)

            def loss_fn(w):
                return sparse.loss(task, m, y, w)
        else:
            def epoch(w):
                if batch >= n:
                    return w - step * glm_grad(task, w, X, y, backend=backend)
                return glm_sgd_epoch(task, w, X, y, step=step,
                                     micro_batch=batch, backend=backend)

            def loss_fn(w):
                return glm.LOSSES[task](w, X, y)

        init = torch.zeros(d, dtype=torch.float32, device=dev)
        return init, epoch, loss_fn, 0

    if not isinstance(strategy, AsyncLocalSGD):
        raise TypeError(f"unknown strategy {strategy!r}")
    R = strategy.replicas
    parts_np = partition_indices(n, R, strategy.access, strategy.rep_k)
    per = parts_np.shape[1]
    lb = strategy.local_batch
    # merge_every > 1 still merges once per epoch: the reference engine's
    # behaviour, kept for parity
    merges = (max(1, int(round(1.0 / strategy.merge_every)))
              if strategy.merge_every <= 1 else 1)
    parts = torch.from_numpy(parts_np).to(dev).long()
    y_p = y[parts]                                       # [R, per]

    if sparse_data:
        vals_p, idx_p = m.values[parts], m.indices[parts]   # [R, per, K]
        if lb == per:
            # full-partition update: the sum-gradient kernel, mean step
            def replica_epoch(W):
                return W - (step / per) * ell_glm_grad(
                    task, W, vals_p, idx_p, y_p, backend=backend)
        elif per % lb == 0:
            def replica_epoch(W):
                return ell_sgd_epoch(task, W, vals_p, idx_p, y_p, step=step,
                                     micro_batch=lb, backend=backend)
        else:
            raise _divisor_error(per, lb)

        def loss_fn(W):
            return sparse.loss(task, m, y, W[0])
    else:
        if per % lb:
            raise _divisor_error(per, lb)
        X_p = X[parts]                                       # [R, per, d]

        def replica_epoch(W):
            return glm_sgd_epoch(task, W, X_p, y_p, step=step,
                                 micro_batch=lb, backend=backend)

        def loss_fn(W):
            return glm.LOSSES[task](W[0], X, y)

    def epoch(W):
        for _ in range(merges):
            W = merge_replicas(replica_epoch(W), strategy.merge)
        return W

    init = torch.zeros((R, d), dtype=torch.float32, device=dev)
    return init, epoch, loss_fn, merges


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(problem, strategy, epochs: int, *, sparse_data: bool = False,
        record_time: bool = True) -> RunResult:
    """Run SGD for ``epochs`` passes, recording loss + wall time per pass.

    Epoch 1 is timed as set-up (it builds the kernels on first use), inside
    an ``engine.compile`` span; its time is replaced by the median of the
    others, as the reference does with its compile epoch.  Each later epoch
    runs inside an ``engine.epoch`` span.  The span names and attributes
    are the reference's.  ``record_time`` is the reference's keyword: like
    the reference, the engine times every epoch either way.
    """
    del record_time  # accepted for the reference's signature
    init, epoch_fn, loss_fn, merges = make_epoch_fn(
        problem, strategy, sparse_data=sparse_data)
    task = problem[0]
    dev = init.device

    state = init
    losses = [float(loss_fn(state))]
    with trace.span("engine.compile", strategy=strategy.name, task=task):
        state = epoch_fn(state)
        _sync(dev)
    losses.append(float(loss_fn(state)))
    times = [float("nan")]
    for e in range(epochs - 1):
        with trace.span("engine.epoch", epoch=e + 1, strategy=strategy.name,
                        merges=merges):
            t0 = time.perf_counter()
            state = epoch_fn(state)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        losses.append(float(loss_fn(state)))
    times[0] = float(np.nanmedian(times[1:])) if len(times) > 1 else 0.0
    return RunResult(
        losses=np.asarray(losses),
        epoch_times=np.asarray(times),
        strategy=strategy.name,
        task=task,
        model=state,
    )
