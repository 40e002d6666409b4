"""Staleness-bounded snapshot publishing: learner -> scoring engine.

The bridge between the two halves of the live loop.  The learner merges
every ``merge_every`` steps; the publisher ships every ``every_merges``-th
merged model into :meth:`repro_torch.serve.glm.GLMScoreEngine.swap_model`
— a copy of the model published in one atomic reference assignment, so
the serving path never observes a torn model, a later in-place write to
the learner's tensors never reaches a published snapshot, and every
response stays consistent with exactly one snapshot.  Each snapshot is stamped with the learner step that produced
it (``ModelSnapshot.step``), which makes staleness *measurable*: at any
moment, ``learner.steps - engine.model.step`` is how far the served
model lags training, and :meth:`SnapshotPublisher.bound_steps` is the
guaranteed ceiling (``every_merges * merge_every`` steps) as long as the
publisher is attached and merges are not being skipped (at least one
replica alive).

Publishes emit ``live.publish`` spans and a ``live.publishes`` counter,
completing the single-timeline story: ``live.step`` -> ``live.merge`` ->
``live.publish`` -> ``serve.batch`` in one Perfetto trace.
"""
from __future__ import annotations

from repro_torch.obs import metrics, trace
from repro_torch.serve.glm import GLMScoreEngine, ModelSnapshot


class SnapshotPublisher:
    """Publishes every ``every_merges``-th merged model to the engine.

    Attach with ``learner.add_merge_hook(publisher.on_merge)`` (or call
    :meth:`attach`).  ``history`` records ``(version, step, merge)`` per
    publish — the audit trail the chaos tests and the live benchmark
    check response versions against.
    """

    def __init__(self, engine: GLMScoreEngine, *, every_merges: int = 1):
        if every_merges < 1:
            raise ValueError(f"every_merges must be >= 1: {every_merges}")
        self.engine = engine
        self.every_merges = every_merges
        self.publishes = 0
        #: optional health monitor with ``on_publish(version=, step=)``:
        #: publishes are reported so a stalled publisher shows as silence
        self.monitor = None
        #: per-publish audit rows: {"version", "step", "merge"}
        self.history: list[dict] = []

    def attach(self, learner) -> "SnapshotPublisher":
        learner.add_merge_hook(self.on_merge)
        return self

    def on_merge(self, learner) -> ModelSnapshot | None:
        """Merge hook: publish when the merge count hits the period.

        Returns the published snapshot, or None when this merge is
        between publish points.
        """
        if learner.merges % self.every_merges:
            return None
        with trace.span("live.publish", step=learner.steps,
                        merge=learner.merges):
            snap = self.engine.swap_model(learner.merged_model,
                                          step=learner.steps)
        self.publishes += 1
        metrics.counter("live.publishes").inc()
        self.history.append({"version": snap.version, "step": learner.steps,
                             "merge": learner.merges})
        if self.monitor is not None:
            self.monitor.on_publish(version=snap.version, step=learner.steps)
        return snap

    @property
    def last(self) -> dict | None:
        return self.history[-1] if self.history else None

    def bound_steps(self, merge_every: int) -> int:
        """The staleness ceiling in learner steps: once the first
        snapshot is out, the served model never lags the newest merged
        model by more than ``every_merges * merge_every`` steps
        (provided merges are not skipped — i.e. >= 1 replica alive)."""
        return self.every_merges * merge_every

    def staleness(self, learner) -> int | None:
        """Current lag in learner steps of the *published* model behind
        the learner (None before the first publish)."""
        snap = self.engine.model
        if snap.step is None:
            return None
        return learner.steps - snap.step
