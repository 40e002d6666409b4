"""The port's health monitor (``repro_torch.obs.{digest,monitor}``) against
the reference's, on the CPU.

Both packages' digests take the same observations and both monitors the
same event sequence under the same injected clock; their quantiles, window
samples, SLO verdicts and summaries must be equal.  The port's own hooks
(``GLMScoreEngine``, ``LiveLearner``, ``SnapshotPublisher``) and its CLI over
the port's sidecar files are exercised beside the reference's.
"""
import json
import math

import numpy as np
import pytest

from repro.live import LiveConfig as JLiveConfig
from repro.live import LiveLearner as JLiveLearner
from repro.live import SnapshotPublisher as JPublisher
from repro.live import SyntheticStream as JStream
from repro.obs import digest as jdigest
from repro.obs import monitor as jmonitor
from repro.serve.glm import GLMScoreEngine as JEngine

from repro_torch.live import (LiveConfig, LiveLearner, SnapshotPublisher,
                              SyntheticStream)
from repro_torch.obs import digest, metrics, monitor, trace
from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest

TASK = "lr"


def _streams():
    rng = np.random.default_rng(0)
    return {
        "lognormal": list(rng.lognormal(-7, 1.5, 500)),
        "uniform": list(rng.uniform(1e-4, 2.0, 97)),
        "edges": list(jdigest.LATENCY_EDGES[::3]) + [0.0, 1e3],
        "one": [0.0123],
        "ties": [0.001] * 40 + [0.5] * 3,
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_digest_quantiles_equal_the_references(name):
    values = _streams()[name]
    ours, ref = digest.QuantileDigest(), jdigest.QuantileDigest()
    for v in values:
        ours.observe(v)
        ref.observe(v)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.snapshot() == ref.snapshot() and ours.mean == ref.mean
    # merge and the snapshot round trip agree too
    half = len(values) // 2
    a, b = digest.QuantileDigest(), digest.QuantileDigest()
    ja, jb = jdigest.QuantileDigest(), jdigest.QuantileDigest()
    for v in values[:half]:
        a.observe(v)
        ja.observe(v)
    for v in values[half:]:
        b.observe(v)
        jb.observe(v)
    merged = a.merge(b).snapshot()
    assert merged == ja.merge(jb).snapshot()
    assert merged["counts"] == ref.snapshot()["counts"]
    again = digest.QuantileDigest.from_snapshot(ours.snapshot())
    assert again.quantile(0.99) == ref.quantile(0.99)


def test_empty_digest_and_bad_input_as_the_reference():
    assert digest.QuantileDigest().quantile(0.5) is None
    with pytest.raises(ValueError):
        digest.QuantileDigest((1.0, 0.5))
    with pytest.raises(ValueError):
        digest.QuantileDigest().quantile(1.5)


@pytest.mark.parametrize("curve", [
    [10.0, 9.0, 8.5, 8.0, 7.9, 7.85, 7.84, 7.84, 7.84, 7.84],
    [1.0, 1.1, 1.5, 2.5, 4.0, 9.0],
    [3.0, 2.0, float("nan"), 1.0],
    [5.0, 5.0, 5.0, 5.0, 5.0],
])
def test_drift_watch_equals_the_references(curve):
    ours, ref = monitor.EWMADrift(), jmonitor.EWMADrift()
    for v in curve:
        ours.observe(v)
        ref.observe(v)
        assert (ours.status, ours.fast, ours.slow) \
            == (ref.status, ref.fast, ref.slow)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _spec_sets():
    tight = lambda mod: (  # noqa: E731
        mod.SLOSpec("lat", "p99_s", "<=", 0.01),
        mod.SLOSpec("tput", "rps", ">=", 1000.0),
        mod.SLOSpec("fill", "batch_fill", ">=", 0.75))
    return {"serve": lambda mod: mod.DEFAULT_SERVE_SLOS,
            "live": lambda mod: mod.DEFAULT_LIVE_SLOS, "tight": tight}


def _drive(mod, slos):
    """One event sequence through a monitor of ``mod``: flushes at several
    latencies and fills, rejects, a loss curve that turns upward, idle
    gaps and lazy rolls on the clock."""
    clock = _Clock()
    mon = mod.HealthMonitor(slos(mod), window_s=1.0, clock=clock)
    rng = np.random.default_rng(1)
    for step in range(40):
        clock.t += float(rng.uniform(0.05, 0.4))
        kind = step % 5
        if kind in (0, 1, 2):
            n = int(rng.integers(1, 9))
            lat = list(rng.lognormal(-5 + step / 10, 1.0, n))
            mon.on_flush(n=n, padded=8, queue_depth=int(rng.integers(0, 20)),
                         latencies=lat)
        elif kind == 3:
            mon.on_reject()
        else:
            mon.observe_loss(5.0 - 0.1 * step if step < 25
                             else 2.0 + 0.5 * (step - 25))
        if step in (12, 30):
            clock.t += 10.0             # an idle stretch
            mon.roll()
    clock.t += 2.0
    mon.roll()
    return mon


@pytest.mark.parametrize("slos", sorted(_spec_sets()))
def test_monitor_verdicts_equal_the_references(slos):
    specs = _spec_sets()[slos]
    ours, ref = _drive(monitor, specs), _drive(jmonitor, specs)
    assert ours.windows == ref.windows > 3
    assert ours.history == ref.history
    assert ours.breaches == ref.breaches
    assert ours.summary() == ref.summary()
    assert ours.table() == ref.table()


class _Learner:
    """The duck-typed learner and publisher the monitor reads."""

    class config:
        merge_every = 2

    def __init__(self):
        self.steps = 0


class _Publisher:
    def __init__(self, lags):
        self.lags = iter(lags)

    def bound_steps(self, merge_every):
        return 2 * merge_every

    def staleness(self, learner):
        return next(self.lags)


def test_staleness_verdicts_equal_the_references():
    lags = [None, 0, 1, 2, 3, 4, 5, 6, 1, 0, 9, None, 2]
    out = []
    for mod in (monitor, jmonitor):
        clock = _Clock()
        mon = mod.HealthMonitor(mod.DEFAULT_LIVE_SLOS, window_s=1.0,
                                clock=clock)
        lrn, pub = _Learner(), _Publisher(lags)
        mon.watch_live(lrn, pub)
        for i, _ in enumerate(lags):
            clock.t += 0.3
            mon.on_learner_step(lrn)
            if i % 4 == 0:
                mon.on_publish(version=i, step=i)
        clock.t += 1.0
        mon.roll()
        out.append((mon.history, mon.breaches))
    assert out[0] == out[1] and out[0][1].get("staleness", 0) >= 1


# ---------------------------------------------------------------------------
# the port's hooks
# ---------------------------------------------------------------------------


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 4)
    kw.setdefault("flush_deadline_s", 0.0)
    return GLMScoreEngine(TASK, np.zeros(16, np.float32), ell_width=2,
                          device="cpu", **kw)


def test_engine_flush_and_reject_report_into_windows():
    mon = monitor.HealthMonitor(monitor.DEFAULT_SERVE_SLOS, window_s=3600.0)
    eng = _engine()
    assert mon.attach_engine(eng) is mon and eng.monitor is mon
    for rid in range(6):                    # queue_depth 4: two shed
        eng.try_admit(ScoreRequest(rid, np.ones(2), np.zeros(2, int)))
    eng.drain()
    w = mon.roll()
    assert w["n_scored"] == 4 and w["rejected"] == 2
    assert w["flushes"] == 1 and w["batch_fill"] == 1.0
    assert w["p99_s"] > 0 and w["breaches"] == []


def test_engine_fault_stall_injects_a_latency_breach():
    mon = monitor.HealthMonitor((monitor.SLOSpec("lat", "p99_s", "<=", 0.02),),
                                window_s=3600.0)
    eng = _engine(fault_stall_s=0.05)
    assert eng.fault_stall_s == 0.05
    mon.attach_engine(eng)
    eng.try_admit(ScoreRequest(0, np.ones(2), np.zeros(2, int)))
    eng.flush()
    w = mon.roll()
    assert w["p99_s"] >= 0.05 and w["breaches"] == ["lat"]


def _stack(mod_live, engine_cls, **dev):
    live = mod_live
    stream = live["SyntheticStream"](n_batch=8, d=32, seed=0)
    cfg = live["LiveConfig"](task=TASK, replicas=2, step_size=0.1,
                             merge_every=2, compress=False)
    lrn = live["LiveLearner"](cfg, stream, **dev)
    eng = engine_cls(TASK, np.zeros(32, np.float32),
                     ell_width=stream.ell_width, max_batch=4, **dev)
    pub = live["SnapshotPublisher"](eng, every_merges=1).attach(lrn)
    return lrn, pub


def test_stalled_publisher_breaches_as_in_the_reference():
    """The port's learner and publisher report the same staleness into the
    port's monitor as the reference's into the reference's."""
    runs = []
    for mod, live, engine_cls, dev in (
            (monitor, dict(SyntheticStream=SyntheticStream,
                           LiveConfig=LiveConfig, LiveLearner=LiveLearner,
                           SnapshotPublisher=SnapshotPublisher),
             GLMScoreEngine, {"device": "cpu"}),
            (jmonitor, dict(SyntheticStream=JStream, LiveConfig=JLiveConfig,
                            LiveLearner=JLiveLearner,
                            SnapshotPublisher=JPublisher), JEngine, {})):
        lrn, pub = _stack(live, engine_cls, **dev)
        clock = _Clock()
        mon = mod.HealthMonitor(mod.DEFAULT_LIVE_SLOS, window_s=3600.0,
                                clock=clock)
        mon.watch_live(lrn, pub)
        assert lrn.monitor is mon and pub.monitor is mon
        lrn.run(2)
        pub.every_merges = 10 ** 9          # injected stall
        lrn.run(10)
        w = mon.roll()
        runs.append({k: w[k] for k in ("staleness_steps", "staleness_bound",
                                       "staleness_ratio", "publishes",
                                       "breaches")})
    assert runs[0] == runs[1]
    assert runs[0]["staleness_bound"] == 2 and "staleness" in runs[0]["breaches"]


# ---------------------------------------------------------------------------
# the CLI over the port's sidecars
# ---------------------------------------------------------------------------


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    monkeypatch.setenv(trace.ENV_TRACE_DIR, str(tmp_path))
    monkeypatch.delenv(trace.ENV_TRACE_TAG, raising=False)
    trace.refresh()
    metrics.reset()
    metrics._last_flush = 0.0
    yield tmp_path
    monkeypatch.delenv(trace.ENV_TRACE, raising=False)
    trace.refresh()
    metrics.reset()


def test_cli_counts_breaches_and_trace_instants(traced, capsys):
    clock = _Clock()
    mon = monitor.HealthMonitor((monitor.SLOSpec("lat", "p99_s", "<=", 1e-9),),
                                window_s=1.0, clock=clock)
    for _ in range(3):
        mon.on_flush(n=1, padded=1, queue_depth=0, latencies=[0.01])
        clock.t += 2.0
        mon.roll()
    path = metrics.flush(0)
    assert path is not None and "-torch-" in path.name
    assert monitor.main([str(traced), "--check"]) == 3
    assert "BREACH lat" in capsys.readouterr().out
    assert monitor.main([str(traced), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["breaches"] == {"lat": 3} and doc["windows"] == 3
    assert doc["trace_breach_events"] == 3
    assert math.isclose(doc["files"][0]["health"]["p99_s"], 0.01)


def test_cli_without_sidecars_fails_the_check(tmp_path, capsys):
    assert monitor.main([str(tmp_path), "--check"]) == 1
    assert "no metrics sidecars" in capsys.readouterr().err
    assert monitor.main([str(tmp_path)]) == 0
