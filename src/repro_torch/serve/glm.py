"""GLM scoring service: batched admission over the fused scoring kernel.

The port of the reference package's scoring engine: a bounded FIFO of
padded-ELL requests, micro-batches padded to exactly ``max_batch`` rows
and scored in one ``glm_score`` launch (``kernels/csrc/glm_score.cu`` on
the card), and atomic snapshot hot-swap.

* **batched admission** — requests accumulate until ``max_batch`` are
  waiting or the oldest has waited ``flush_deadline_s``; a full queue
  rejects (``try_admit`` returns False).  Every request row is checked at
  admission: a row wider than ``ell_width``, ragged values/indices, or a
  feature index outside ``[0, d)`` raises there, so the kernel, which
  does not bounds-check its gathers, never sees one.
* **one copy in, one copy out** — a flush writes its rows, zero-padded,
  into a host buffer of the engine's (values as their bits, and indices;
  pinned when the engine scores on the card), copies it to the card in
  one transfer that does not wait, launches the kernel on PyTorch's
  current stream, and reads the scores back in one copy, which is the
  flush's only wait for the card.
* **atomic snapshot hot-swap** — the model is a :class:`ModelSnapshot`;
  ``swap_model`` stores its own copy of the weights on the engine's
  device and publishes the snapshot in one reference assignment, and a
  flush reads that reference once for its whole batch.  The copy is what
  keeps a snapshot immutable: PyTorch tensors can be written in place,
  and a caller that later updates the tensor it passed (a learner's
  model) must not change what is served under an old version.

Thread model: any number of producer threads may ``try_admit``/
``submit``; any number of consumer threads may ``flush`` (dequeue is
under the lock, scoring is outside it).  Every path is traced
(``serve.admit`` / ``serve.batch`` / ``serve.score`` spans) and counted
(``serve.*`` counters).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.core.glm import LINKS
from repro_torch.kernels import common
from repro_torch.kernels.glm_score import glm_score
from repro_torch.obs import metrics, trace


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One published model.  ``w`` is the [d] fp32 weight vector, owned by
    the engine (no one else holds a reference to write through);
    ``version`` increases by 1 per ``swap_model``.  ``step`` is the
    producer's progress stamp (the live learner step that produced this
    model); None for models with no live producer."""

    task: str
    w: torch.Tensor
    version: int
    step: int | None = None

    def __post_init__(self):
        if self.task not in LINKS:
            raise ValueError(f"unknown task {self.task!r}; "
                             f"one of {tuple(LINKS)}")


@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """One request row in padded-ELL form (values zero-padded to the
    engine's ``ell_width``; padded entries carry index 0, value 0)."""

    rid: int
    values: np.ndarray   # [<=K] float
    indices: np.ndarray  # [<=K] int


@dataclasses.dataclass(frozen=True)
class ScoreResponse:
    rid: int
    score: float           # LR: sigmoid probability; SVM: raw margin
    model_version: int     # the ONE snapshot that scored this request
    latency_s: float       # admission -> response wall time


def _own_copy(w, dev: torch.device) -> torch.Tensor:
    """A fresh fp32 [d] copy of ``w`` (array or tensor) on ``dev``."""
    return torch.as_tensor(w).to(dev, torch.float32, copy=True).reshape(-1)


class GLMScoreEngine:
    """Batched scoring over a trained GLM — see the module docstring.

    Parameters
    ----------
    task, w:
        The served model (``swap_model`` replaces it atomically).
    ell_width:
        Fixed ELL row width K.  Shorter request rows are zero-padded up;
        longer rows are rejected at admission (``ValueError``).
    max_batch:
        Rows per scoring launch; also the padded batch shape.
    queue_depth:
        Bound of the admission FIFO; a full queue rejects (``try_admit``
        returns False) instead of buffering unboundedly.
    flush_deadline_s:
        A non-full batch is flushed once its *oldest* request has waited
        this long (``maybe_flush``); ``flush`` ignores the deadline.
    device:
        Where the model lives and the batches are scored: ``cuda`` unless
        the caller says (``device="cpu"`` runs the plain version).
    clock:
        Injectable monotonic clock (tests pin deadlines without
        sleeping).
    fault_stall_s:
        Chaos hook: every flush sleeps this long before scoring — the
        stall a monitored benchmark injects to force a latency-SLO
        breach.  0 (the default) is a plain no-op.

    A :class:`repro_torch.obs.monitor.HealthMonitor` attaches through its
    ``attach_engine(engine)``, which sets ``self.monitor`` (any object
    with ``on_flush(n=, padded=, queue_depth=, latencies=)`` and
    ``on_reject()`` will do); with none attached the cost is one ``None``
    check.
    """

    def __init__(self, task: str, w, *, ell_width: int,
                 max_batch: int = 32, queue_depth: int = 256,
                 flush_deadline_s: float = 0.005, device=None,
                 clock: Callable[[], float] = time.monotonic,
                 fault_stall_s: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1: {queue_depth}")
        if ell_width < 1:
            raise ValueError(f"ell_width must be >= 1: {ell_width}")
        if fault_stall_s < 0:
            raise ValueError(f"fault_stall_s must be >= 0: {fault_stall_s}")
        self.ell_width = ell_width
        self.max_batch = max_batch
        self.queue_depth = queue_depth
        self.flush_deadline_s = flush_deadline_s
        self.fault_stall_s = fault_stall_s
        self.device = common.device(device)
        self.monitor = None
        self._clock = clock
        self._lock = threading.Lock()
        #: FIFO of (request, values row, indices row, t_admit); rows are
        #: checked and unpadded
        self._queue: deque = deque()
        #: host buffers of flushes not in flight (see ``_stage``)
        self._free: list[torch.Tensor] = []
        self._model = ModelSnapshot(task, _own_copy(w, self.device), version=0)
        self.d = self._model.w.shape[0]

    # -- model hot-swap ------------------------------------------------------

    @property
    def model(self) -> ModelSnapshot:
        """The currently published snapshot (atomic reference read)."""
        return self._model

    def swap_model(self, w, *, task: str | None = None,
                   step: int | None = None) -> ModelSnapshot:
        """Atomically publish a copy of ``w``; returns the new snapshot.

        In-flight batches keep scoring against the snapshot they read at
        dequeue time — a flush is consistent with exactly one version,
        never a mix.  The copy is enqueued on the current stream before
        any later flush's launch, and later writes to ``w`` do not reach
        it.  ``step`` stamps the producer's progress onto the snapshot.
        """
        w = _own_copy(w, self.device)
        with self._lock:
            old = self._model
            if w.shape != old.w.shape:
                raise ValueError(
                    f"swap_model shape mismatch: serving d={old.w.shape[0]}, "
                    f"got d={w.shape[0]}")
            snap = ModelSnapshot(task if task is not None else old.task,
                                 w, version=old.version + 1, step=step)
            self._model = snap
        metrics.counter("serve.model_swaps").inc()
        if trace.enabled():
            trace.instant("serve.swap", version=snap.version)
        return snap

    # -- admission -----------------------------------------------------------

    def _admit_row(self, req: ScoreRequest) -> tuple[np.ndarray, np.ndarray]:
        """The request's row as the engine's own fp32 values and int32
        indices, checked: a flush needs no read of the card to trust its
        indices."""
        vals = np.array(req.values, np.float32).reshape(-1)
        idx = np.asarray(req.indices).reshape(-1)
        if vals.shape != idx.shape:
            raise ValueError(
                f"request {req.rid}: values/indices length mismatch "
                f"({vals.shape[0]} vs {idx.shape[0]})")
        if vals.shape[0] > self.ell_width:
            raise ValueError(
                f"request {req.rid}: {vals.shape[0]} nonzeros exceed the "
                f"engine ell_width={self.ell_width}")
        common.check_host_indices(f"request {req.rid}", idx, self.d)
        return vals, idx.astype(np.int32)

    def try_admit(self, req: ScoreRequest) -> bool:
        """Enqueue one request; False when the bounded FIFO is full.

        Malformed rows (width over ``ell_width``, ragged values/indices,
        an index outside ``[0, d)``) raise — they could never score —
        while backpressure is a clean False so producers can retry/shed.
        """
        row = self._admit_row(req)
        with trace.span("serve.admit", rid=req.rid):
            with self._lock:
                full = len(self._queue) >= self.queue_depth
                if not full:
                    self._queue.append((req, *row, self._clock()))
        if full:
            metrics.counter("serve.rejected").inc()
            if self.monitor is not None:
                self.monitor.on_reject()
            return False
        metrics.counter("serve.admitted").inc()
        return True

    def submit(self, req: ScoreRequest, *, spin_s: float = 1e-4) -> None:
        """Blocking admit: spins (releasing the lock) until space frees.

        Only sensible when some other thread drains via ``flush``.
        """
        while not self.try_admit(req):
            time.sleep(spin_s)

    def __len__(self) -> int:
        return len(self._queue)

    # -- scoring -------------------------------------------------------------

    def _dequeue(self, limit: int) -> list:
        with self._lock:
            n = min(limit, len(self._queue))
            return [self._queue.popleft() for _ in range(n)]

    def _stage(self) -> torch.Tensor:
        """A host buffer for one batch: values (as their bits) and indices,
        ``[2, max_batch, ell_width]`` int32, pinned when the engine scores
        on the card so that the copy in does not wait.  Each flush in
        flight holds its own; a flush returns it once its scores are back,
        which is after its copy in has finished."""
        with self._lock:
            if self._free:
                return self._free.pop()
        return torch.zeros((2, self.max_batch, self.ell_width),
                           dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")

    def flush(self) -> list[ScoreResponse]:
        """Score up to ``max_batch`` queued requests (FIFO) now.

        The batch is padded to exactly ``max_batch`` all-zero rows (which
        score ``link(0)`` and are dropped).  Returns one response per
        dequeued request, in admission order, all stamped with the single
        snapshot that scored them.
        """
        entries = self._dequeue(self.max_batch)
        if not entries:
            return []
        snap = self._model       # ONE atomic snapshot read per batch
        n = len(entries)
        stage = self._stage()
        buf = stage.numpy()
        vals = buf[0].view(np.float32)
        for i, (_, v, ix, _) in enumerate(entries):
            k = v.shape[0]
            vals[i, :k], vals[i, k:] = v, 0.0
            buf[1, i, :k], buf[1, i, k:] = ix, 0
        buf[:, n:] = 0          # filler rows
        with trace.span("serve.batch", rows=n, padded=self.max_batch,
                        version=snap.version):
            if self.fault_stall_s:
                time.sleep(self.fault_stall_s)      # injected deadline stall
            with trace.span("serve.score", device=str(self.device)):
                batch = stage.to(self.device, non_blocking=True)
                indices = batch[1]
                # every row was checked against [0, d) at admission
                common.mark_indices_checked(indices, self.d)
                scores = glm_score(snap.task, snap.w,
                                   batch[0].view(torch.float32), indices)
                scores = scores.cpu().numpy()   # one copy out: the one wait
        with self._lock:
            self._free.append(stage)
        t1 = self._clock()
        metrics.counter("serve.scored").inc(n)
        metrics.counter("serve.batches").inc()
        responses = [
            ScoreResponse(req.rid, float(scores[i]), snap.version,
                          max(0.0, t1 - t_admit))
            for i, (req, _, _, t_admit) in enumerate(entries)
        ]
        if self.monitor is not None:
            self.monitor.on_flush(
                n=n, padded=self.max_batch, queue_depth=len(self._queue),
                latencies=[r.latency_s for r in responses])
        return responses

    def maybe_flush(self) -> list[ScoreResponse]:
        """Flush only when a batch is *due*: ``max_batch`` rows waiting,
        or the oldest request older than ``flush_deadline_s``."""
        with self._lock:
            if not self._queue:
                return []
            full = len(self._queue) >= self.max_batch
            overdue = (self._clock() - self._queue[0][3]
                       >= self.flush_deadline_s)
        if not (full or overdue):
            return []
        return self.flush()

    def drain(self, *, max_flushes: int = 10_000) -> list[ScoreResponse]:
        """Flush until the queue is empty; responses in admission order."""
        out: list[ScoreResponse] = []
        for _ in range(max_flushes):
            batch = self.flush()
            if not batch:
                break
            out.extend(batch)
        return out
