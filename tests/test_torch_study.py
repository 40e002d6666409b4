"""Parity of the port's study layer with the JAX reference, on the CPU:
the step-size search (``core.convergence``), ``sparse.from_dense``, the
GLM task configs, the timing helpers, ``study/`` (specs and their keys,
the runner and its cache, the tuner, the claims and the advisor) and the
paper drivers (``repro_torch.benchmarks``).

The same seeded data goes through the reference (its plain XLA engine,
which the reference's runner uses for stacked grids) and through the port
on ``device="cpu"`` (the plain PyTorch versions of the port's kernels).
Loss histories agree to ``rtol=1e-4, atol=1e-4``; keys, steps, epoch
counts and claim strings are equal.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks import common as jbench
from benchmarks import table4_sync as jtable4
from benchmarks import table7_async as jtable7
from repro.configs import glm as jconfigs
from repro.core import convergence as jconv
from repro.core import glm as jglm
from repro.core import sgd as jsgd
from repro.core import sparse as jsparse
from repro.study import advisor as jadvisor
from repro.study import claims as jclaims
from repro.study import runner as jrunner
from repro.study import spec as jspec
from repro.study import store as jstore
from repro.study import tuner as jtuner
from repro.utils import timing as jtiming

from repro_torch.benchmarks import common as tbench
from repro_torch.benchmarks import fig22_sync_vs_async as tfig22
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import table4_sync as ttable4
from repro_torch.benchmarks import table7_async as ttable7
from repro_torch.configs import glm as tconfigs
from repro_torch.core import convergence as tconv
from repro_torch.core import glm as tglm
from repro_torch.core import sgd as tsgd
from repro_torch.core import sparse as tsparse
from repro_torch.study import advisor as tadvisor
from repro_torch.study import claims as tclaims
from repro_torch.study import runner as trunner
from repro_torch.study import spec as tspec
from repro_torch.study import store as tstore
from repro_torch.study import tuner as ttuner
from repro_torch.utils import timing as ttiming

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = "cpu"


def _port(jstrat):
    """The port's strategy with the reference strategy's fields."""
    return getattr(tsgd, type(jstrat).__name__)(**dataclasses.asdict(jstrat))


def _dspecs(**kw):
    return jspec.DatasetSpec(**kw), tspec.DatasetSpec(**kw)


STRATEGIES = (
    jsgd.SyncSGD(),
    jsgd.SyncSGD(batch=16),
    jsgd.AsyncLocalSGD(replicas=4, local_batch=1),
    jsgd.AsyncLocalSGD(replicas=8, local_batch=2, access="round_robin",
                       rep_k=2),
)


# ---------------------------------------------------------------------------
# core: the step-size grid, grid_search_step, from_dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(-6, 2), (-3, -1), (0, 0), (1, 0)])
def test_grid_step_sizes_match(lo, hi):
    assert tconv.grid_step_sizes(lo, hi) == jconv.grid_step_sizes(lo, hi)
    assert tconv.grid_step_sizes() == jconv.grid_step_sizes()


@pytest.mark.parametrize("task,jstrat", [("lr", STRATEGIES[0]),
                                         ("svm", STRATEGIES[2])],
                         ids=("lr-sync", "svm-async"))
def test_grid_search_step_picks_the_references_step(task, jstrat):
    from repro.data import synthetic as jsyn

    ds = jsyn.make_dense("g", 128, 12, seed=3)
    X, y = np.asarray(ds.X), np.asarray(ds.y)
    steps = (1e-3, 1e-2, 1e-1, 1.0)
    epochs = 4 if task == "lr" else 1

    def jproblem(s):
        return jglm.GLMProblem(task, jnp.asarray(X), jnp.asarray(y), s)

    def tproblem(s):
        return tglm.GLMProblem(task, torch.from_numpy(X), torch.from_numpy(y),
                               s)

    j0 = jsgd.run(jproblem(1e-2), jstrat, epochs)
    target = float(j0.losses[-1]) * 1.05
    jres = jconv.grid_search_step(jproblem, jstrat, epochs, target,
                                  steps=steps)
    tres = tconv.grid_search_step(tproblem, _port(jstrat), epochs, target,
                                  steps=steps)
    for s in steps:
        np.testing.assert_allclose(tres.all_results[s].losses,
                                   jres.all_results[s].losses, **TOL)
    # epochs to the target decide the rank unless two steps tie on them
    jep = {s: r.epochs_to(target) for s, r in jres.all_results.items()}
    assert {s: r.epochs_to(target) for s, r in tres.all_results.items()} == jep
    if list(jep.values()).count(jep[jres.best_step]) == 1:
        assert tres.best_step == jres.best_step
    assert isinstance(tres, tconv.GridSearchResult)


def test_grid_search_step_falls_back_when_everything_diverges():
    X = np.full((8, 2), np.inf, dtype=np.float32)
    y = np.ones(8, dtype=np.float32)
    steps = (1e-1, 1e-3, 1e-2)
    tres = tconv.grid_search_step(
        lambda s: tglm.GLMProblem("lr", torch.from_numpy(X),
                                  torch.from_numpy(y), s),
        tsgd.SyncSGD(), 2, 0.0, steps=steps)
    jres = jconv.grid_search_step(
        lambda s: jglm.GLMProblem("lr", jnp.asarray(X), jnp.asarray(y), s),
        jsgd.SyncSGD(), 2, 0.0, steps=steps)
    assert tres.best_step == jres.best_step == 1e-3
    assert not np.isfinite(tres.best_result.losses[-1])


@pytest.mark.parametrize("pad_to", (None, 1, 3, 9))
def test_from_dense_gives_the_references_arrays(pad_to):
    rng = np.random.default_rng(2)
    X = rng.normal(0, 1, (23, 11)).astype(np.float32)
    X[rng.random(X.shape) < 0.7] = 0.0
    X[4] = 0.0                                 # an empty row
    t = tsparse.from_dense(X, pad_to=pad_to, device=CPU)
    j = jsparse.from_dense(X, pad_to=pad_to)
    assert t.d == j.d == 11 and t.values.device.type == CPU
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert t.indices.dtype == torch.int32


# ---------------------------------------------------------------------------
# configs/glm.py
# ---------------------------------------------------------------------------


def test_glm_configs_are_the_references():
    assert tuple(tconfigs.GLM_CONFIGS) == tuple(jconfigs.GLM_CONFIGS)
    for name, jcfg in jconfigs.GLM_CONFIGS.items():
        tcfg = tconfigs.get_glm(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert (dataclasses.asdict(tcfg.async_strategy())
                == dataclasses.asdict(jcfg.async_strategy()))
        assert tcfg.async_strategy().name == jcfg.async_strategy().name
    with pytest.raises(KeyError):
        tconfigs.get_glm("mnist-lr")


@pytest.mark.parametrize("name", ("covtype-lr", "w8a-svm", "real-sim-lr",
                                  "rcv1-svm", "news-lr"))
def test_glm_config_make_dataset_is_byte_identical(name):
    t = tconfigs.get_glm(name).make_dataset(max_n=64, seed=1, device=CPU)
    j = jconfigs.get_glm(name).make_dataset(max_n=64, seed=1)
    assert (t.n, t.d, t.dense) == (j.n, j.d, j.dense)
    assert t.y.numpy().tobytes() == np.asarray(j.y).tobytes()
    if t.dense:
        assert t.X.numpy().tobytes() == np.asarray(j.X).tobytes()
    else:
        assert t.ell.values.numpy().tobytes() == np.asarray(
            j.ell.values).tobytes()
        assert t.ell.indices.numpy().tobytes() == np.asarray(
            j.ell.indices).tobytes()


# ---------------------------------------------------------------------------
# utils/timing.py
# ---------------------------------------------------------------------------


def test_timer_and_median_time_behave_like_the_references():
    with ttiming.Timer() as tt, jtiming.Timer() as jt:
        time.sleep(0.01)
    assert tt.elapsed >= jt.elapsed >= 0.01

    calls = {"t": 0, "j": 0}

    def make(key, out):
        def fn(x, scale=1.0):
            calls[key] += 1
            time.sleep(0.002)
            return out * scale
        return fn

    tstats = ttiming.time_stats(make("t", torch.ones(3)), 1, warmup=1,
                                iters=4, scale=2.0)
    jstats = jtiming.time_stats(make("j", jnp.ones(3)), 1, warmup=1,
                                iters=4, scale=2.0)
    assert calls == {"t": 5, "j": 5}
    assert set(tstats) == set(jstats) and tstats["iters"] == jstats["iters"]
    assert tstats["min"] <= tstats["median"] and tstats["median"] >= 0.002
    assert ttiming.median_time(make("t", torch.ones(1)), 0, warmup=0,
                               iters=1) >= 0.002
    # nested results on the CPU need no synchronize
    nested = {"a": (torch.zeros(1), [torch.ones(2)]), "b": 3}
    assert ttiming._block(nested) is nested


# ---------------------------------------------------------------------------
# study/spec.py: keys, round-trips, grids
# ---------------------------------------------------------------------------


DATASETS = (
    dict(name="covtype", max_n=256),
    dict(name="w8a", max_n=128, seed=3),
    dict(name="real-sim", max_n=64),
    dict(name="dense-d", n=96, d=7, seed=1),
    dict(name="w8a", source="real"),
    dict(name="covtype", source="real", split="test", max_n=20),
    dict(name="news", source="real", split="all"),
)


@pytest.mark.parametrize("dkw", DATASETS, ids=lambda d: json.dumps(d))
def test_trial_keys_equal_the_references_over_a_grid(dkw):
    jd, td = _dspecs(**dkw)
    assert td.to_dict() == jd.to_dict()
    assert td.cache_key_dict() == jd.cache_key_dict()
    assert dataclasses.asdict(td.profile()) == dataclasses.asdict(jd.profile())
    jstrats = STRATEGIES + (jsgd.SyncSGD(kernel_backend="pallas-interpret"),
                            jsgd.AsyncLocalSGD(replicas=64, merge_every=0.25))
    jg = jspec.grid([jd], ("lr", "svm"), jstrats, (1e-3, 1e-1), 5, seed=2)
    tg = tspec.grid([td], ("lr", "svm"), [_port(s) for s in jstrats],
                    (1e-3, 1e-1), 5, seed=2)
    assert [t.key for t in tg] == [t.key for t in jg]
    assert [t.stack_key for t in tg] == [t.stack_key for t in jg]
    assert [t.label for t in tg] == [t.label for t in jg]
    assert [t.sparse_data for t in tg] == [t.sparse_data for t in jg]
    for t, j in zip(tg, jg):
        assert t.to_dict() == j.to_dict()
        assert tspec.TrialSpec.from_dict(j.to_dict()) == t
        assert tspec.TrialSpec.from_dict(t.to_dict()).key == j.key
        assert t.with_step(0.5).key == j.with_step(0.5).key
    assert tspec.canonical_json(tg[0].to_dict()) == jspec.canonical_json(
        jg[0].to_dict())


def test_dataset_spec_validation_matches_the_reference():
    for bad in (dict(name="mnist"), dict(name="x", n=3),
                dict(name="w8a", source="real", n=3, d=2),
                dict(name="w8a", source="disk"),
                dict(name="w8a", split="train"),
                dict(name="w8a", source="real", split="dev"),
                dict(name="mnist", source="real")):
        with pytest.raises((ValueError, KeyError)) as terr:
            tspec.DatasetSpec(**bad)
        with pytest.raises((ValueError, KeyError)) as jerr:
            jspec.DatasetSpec(**bad)
        assert type(terr.value) is type(jerr.value)


# ---------------------------------------------------------------------------
# study/runner.py, store.py and tuner.py
# ---------------------------------------------------------------------------


RUN_CASES = (
    ("covtype", "lr", jsgd.SyncSGD(), 4),
    ("covtype", "lr", jsgd.AsyncLocalSGD(replicas=4, local_batch=1), 4),
    ("covtype", "svm", jsgd.SyncSGD(batch=16), 1),
    ("w8a", "lr", jsgd.SyncSGD(), 4),
    ("w8a", "lr", jsgd.AsyncLocalSGD(replicas=8, local_batch=2,
                                     access="round_robin", rep_k=2), 4),
    ("w8a", "svm", jsgd.AsyncLocalSGD(replicas=4, local_batch=1), 1),
)


@pytest.mark.parametrize("name,task,jstrat,epochs", RUN_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_runner_single_and_stacked_trials_match_the_references(
        name, task, jstrat, epochs, tmp_path):
    jd, td = _dspecs(name=name, max_n=128)
    steps = (1e-3, 1e-2, 1e-1)
    jtrials = [jspec.TrialSpec(jd, task, jstrat, s, epochs) for s in steps]
    ttrials = [tspec.TrialSpec(td, task, _port(jstrat), s, epochs)
               for s in steps]
    jres = jrunner.Runner().run(jtrials)               # stacked
    jsingle = jrunner.Runner().run_trial(jtrials[1])
    tr = trunner.Runner(tmp_path / "cache", device=CPU)
    tres = tr.run(ttrials)
    tsingle = trunner.Runner(device=CPU).run_trial(ttrials[1])
    for t, j in zip(tres + [tsingle], jres + [jsingle]):
        np.testing.assert_allclose(t.losses, j.losses, **TOL)
        assert t.stacked == j.stacked and len(t.epoch_times) == epochs
        assert (t.strategy, t.task) == (j.strategy, j.task)
    assert [r.stacked for r in tres] == [True] * 3 and not tsingle.stacked
    # stacked trials share the stack's time, split evenly
    assert all(np.array_equal(r.epoch_times, tres[0].epoch_times)
               for r in tres)
    assert (tr.cache.hits, tr.cache.misses) == (0, 3)
    again = tr.run(ttrials)
    assert tr.cache.hits == 3 and all(r.cached for r in again)
    for a, b in zip(again, tres):
        np.testing.assert_array_equal(a.losses, b.losses)


def test_runner_does_not_stack_forced_backends_and_refuses_an_executor(
        tmp_path):
    td = tspec.DatasetSpec("covtype", max_n=64)
    strat = tsgd.SyncSGD(kernel_backend="torch-reference")
    trials = [tspec.TrialSpec(td, "lr", strat, s, 2) for s in (1e-2, 1e-1)]
    res = trunner.Runner(device=CPU).run(trials)
    assert [r.stacked for r in res] == [False, False]
    # an executor needs a cache root to merge into, as the reference's
    for mod in (trunner, jrunner):
        with pytest.raises(ValueError, match="cache_dir"):
            mod.Runner(executor=object())
    runner = trunner.Runner(device=CPU)
    with pytest.raises(ValueError, match="cache_dir"):
        runner.executor = object()
    assert runner.executor is None and runner.dispatch_min_groups == 2
    cached = trunner.Runner(tmp_path / "cache", executor=object(), device=CPU)
    assert cached.executor is not None


def test_runner_datasets_live_on_its_device_and_default_to_cuda():
    assert trunner.Runner().device == torch.device("cuda")
    runner = trunner.Runner(device=CPU)
    ds = runner.dataset(tspec.DatasetSpec("w8a", source="real"))
    assert ds.ell.values.device.type == CPU and ds.content_hash
    assert runner.dataset(tspec.DatasetSpec("w8a", source="real")) is ds


def test_default_cache_and_store_paths_are_not_the_references():
    assert tstore.StudyStore().json_path != jstore.StudyStore().json_path
    assert tstore.StudyStore().json_path.parts[:2] == ("bench_results",
                                                      "torch")
    for name in ("TrajectoryStore", "KernelBenchStore", "ServeBenchStore",
                 "LiveBenchStore"):
        tpath = getattr(tstore, name)().json_path
        assert tpath != getattr(jstore, name)().json_path
        assert tpath.parts[:2] == ("bench_results", "torch")
    assert tbench.RUNNER.cache.root != jbench.RUNNER.cache.root
    assert tbench.RUNNER.cache.root.parts[-3:] == ("bench_results", "torch",
                                                   "study_cache")
    assert trunner.Runner().cache.root is None


def test_store_snapshot_and_events_match_the_references(tmp_path):
    jd, td = _dspecs(name="covtype", max_n=64)
    jt = jspec.TrialSpec(jd, "lr", jsgd.SyncSGD(), 1e-2, 2)
    tt = tspec.TrialSpec(td, "lr", tsgd.SyncSGD(), 1e-2, 2)
    res = trunner.TrialResult(losses=np.array([3.0, 2.0, 1.0]),
                              epoch_times=np.array([0.5, 0.5]),
                              strategy="sync", task="lr")
    stores = []
    for mod, trial, path in ((tstore, tt, tmp_path / "t.json"),
                             (jstore, jt, tmp_path / "j.json")):
        s = mod.StudyStore(path, jsonl_path=tmp_path / f"{path.stem}.jsonl")
        s.record_trial(trial, res)
        s.record_event("note", worker=1)
        s.record_claims(["b", "a"], ["table4_sync"])
        s.write()
        stores.append(s)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()

    def events(mod, path):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in mod.load_events(path)]

    assert events(tstore, tmp_path / "t.jsonl") == events(
        jstore, tmp_path / "j.jsonl") == [
            {"event": "note", "schema": tstore.EVENT_SCHEMA, "worker": 1}]
    loaded = tstore.StudyStore.load(tmp_path / "t.json")
    assert trunner.TrialResult.from_dict(
        loaded["trials"][tt.key]).final_loss == 1.0


@pytest.mark.parametrize("by", ("epochs", "time"))
@pytest.mark.parametrize("name,task,jstrat,epochs", RUN_CASES[::2],
                         ids=lambda v: getattr(v, "name", str(v)))
def test_tune_step_picks_the_references_step_and_target(name, task, jstrat,
                                                        epochs, by):
    jd, td = _dspecs(name=name, max_n=128)
    steps = (1e-3, 1e-2, 1e-1, 1.0)
    epochs += 1
    jt = jtuner.tune_step(jrunner.Runner(),
                          jspec.TrialSpec(jd, task, jstrat, 1.0, epochs),
                          steps=steps, by=by)
    tt = ttuner.tune_step(trunner.Runner(device=CPU),
                          tspec.TrialSpec(td, task, _port(jstrat), 1.0,
                                          epochs), steps=steps, by=by)
    assert tt.best_step == jt.best_step
    assert tt.best.key == jt.best.key
    np.testing.assert_allclose(tt.target, jt.target, **TOL)
    assert tt.best_result.epochs_to(tt.target) == jt.best_result.epochs_to(
        jt.target)
    for s in steps:
        np.testing.assert_allclose(tt.results[s].losses, jt.results[s].losses,
                                   **TOL)


def test_tune_many_matches_per_base_tune_step():
    td = tspec.DatasetSpec("covtype", max_n=128)
    bases = [tspec.TrialSpec(td, "lr", s, 1.0, 3)
             for s in (tsgd.SyncSGD(), tsgd.AsyncLocalSGD(replicas=4))]
    runner = trunner.Runner(device=CPU)
    many = ttuner.tune_many(runner, bases, steps=(1e-2, 1e-1), by="epochs")
    one = [ttuner.tune_step(runner, b, steps=(1e-2, 1e-1), by="epochs")
           for b in bases]
    assert [m.best_step for m in many] == [o.best_step for o in one]
    assert [m.target for m in many] == [o.target for o in one]


# ---------------------------------------------------------------------------
# study/claims.py
# ---------------------------------------------------------------------------


CLAIM_ROWS = {
    "table4_sync": [
        dict(dataset="covtype", task="lr", n=2048,
             paths_statistically_identical=True, speedup_sync_vs_seq=9.0),
        dict(dataset="w8a", task="svm", n=64,
             paths_statistically_identical=False, speedup_sync_vs_seq=0.5),
        dict(dataset="rs", task="lr", paths_statistically_identical=True,
             speedup_sync_vs_seq=0.9)],
    "fig11_model_replication": [
        dict(dataset="d", task="lr", replicas=1, final_loss=100.0),
        dict(dataset="d", task="lr", replicas=64, final_loss=50.0),
        dict(dataset="e", task="lr", replicas=8, final_loss=10.0),
        dict(dataset="e", task="lr", replicas=1, final_loss=10.1)],
    "fig14_data_replication": [
        dict(dataset="d", task="lr", rep_k=10, t_epoch_ms=0.5),
        dict(dataset="d", task="lr", rep_k=0, t_epoch_ms=1.0),
        dict(dataset="e", task="lr", rep_k=0, t_epoch_ms=1.0),
        dict(dataset="e", task="lr", rep_k=5, t_epoch_ms=0.9)],
    "bench_kernels": [
        dict(label="a", pallas_match=False, wall_s=2.0, baseline_wall_s=1.0),
        dict(label="b", pallas_match=None, wall_s=1.0)],
    "bench_serve": [
        dict(label="a", pallas_match=None, rps=0.0, p50_s=2.0, p99_s=1.0,
             baseline_p50_s=1.0),
        dict(label="b", pallas_match=True, rps=5.0, p50_s=1.0, p99_s=2.0)],
    "bench_live": [
        dict(kind="convergence", label="c", losses=[1.0, 0.95],
             steps_per_s=0.0, wall_s=3.0, baseline_wall_s=1.0),
        dict(kind="serve", label="s", max_staleness_steps=5,
             staleness_bound_steps=3, versions_monotone=False,
             max_version_served=0, rps=-1.0, p50_s=2.0, p99_s=1.0,
             baseline_p50_s=1.0)],
    "fig24_scale": [
        dict(axis="N", value=512, t_epoch_async_ms=1.0),
        dict(axis="N", value=2048, t_epoch_async_ms=20.0),
        dict(axis="d", value=32, t_epoch_async_ms=1.0)],
}


@pytest.mark.parametrize("module", tuple(CLAIM_ROWS))
def test_claim_checks_give_the_references_strings(module):
    tcheck, jcheck = tclaims.CHECKS[module], jclaims.CHECKS[module]
    assert tcheck.__name__ == jcheck.__name__
    rows = CLAIM_ROWS[module]
    assert tcheck(rows) == jcheck(rows)
    assert tcheck(rows)                          # each set violates
    assert tcheck(rows[:1]) == jcheck(rows[:1])
    assert tcheck([]) == jcheck([])
    assert tclaims.validate({module: rows}) == jclaims.validate({module: rows})


def test_claims_validate_and_constants_match():
    assert tclaims.validate(CLAIM_ROWS) == jclaims.validate(CLAIM_ROWS)
    assert tuple(tclaims.CHECKS) == tuple(jclaims.CHECKS)
    for name in ("TABLE4_TIMING_N_FLOOR", "KERNEL_REGRESSION_TOL",
                 "SERVE_REGRESSION_TOL", "LIVE_REGRESSION_TOL"):
        assert getattr(tclaims, name) == getattr(jclaims, name)


# ---------------------------------------------------------------------------
# study/advisor.py
# ---------------------------------------------------------------------------


CAPS = (dict(parallel_width=8, max_replicas=64, backends={}),
        dict(parallel_width=1024, max_replicas=16,
             backends={"glm_grad": ("reference",)}))
ADVISOR_STRATEGIES = STRATEGIES + (
    jsgd.AsyncLocalSGD(replicas=64, local_batch=4, merge_every=0.25),
    jsgd.AsyncLocalSGD(replicas=2048, local_batch=1),
    jsgd.SyncSGD(batch=1))


@pytest.mark.parametrize("caps", CAPS, ids=("cpu", "wide"))
@pytest.mark.parametrize("dkw", DATASETS[:5], ids=lambda d: d["name"])
def test_advisor_cost_model_and_space_match(dkw, caps):
    jd, td = _dspecs(**dkw)
    jprof, tprof = jd.profile(), td.profile()
    jcaps, tcaps = jadvisor.HostCaps(**caps), tadvisor.HostCaps(**caps)
    assert tcaps.to_dict() == jcaps.to_dict()
    model = jadvisor.CostModel(update_overhead=3.0, merge_unit=0.5, scale=2.0)
    tmodel = tadvisor.CostModel(**dataclasses.asdict(model))
    for jstrat in ADVISOR_STRATEGIES:
        tstrat = _port(jstrat)
        assert tadvisor.cost_features(tprof, tstrat, tcaps) == \
            jadvisor.cost_features(jprof, jstrat, jcaps)
        assert tadvisor.modeled_epoch_cost(tprof, tstrat, tcaps) == \
            jadvisor.modeled_epoch_cost(jprof, jstrat, jcaps)
        assert tadvisor.modeled_epoch_cost(tprof, tstrat, tcaps, tmodel) == \
            jadvisor.modeled_epoch_cost(jprof, jstrat, jcaps, model)
    for kb in ((None,), (None, "reference", "pallas-tpu")):
        tspace = tadvisor.candidate_space(tprof, tcaps, kernel_backends=kb)
        jspace = jadvisor.candidate_space(jprof, jcaps, kernel_backends=kb)
        assert [dataclasses.asdict(s) for s in tspace] == \
            [dataclasses.asdict(s) for s in jspace]
        assert [s.name for s in tspace] == [s.name for s in jspace]


def test_advisor_default_space_has_no_forced_backend():
    prof = tspec.DatasetSpec("covtype", max_n=128).profile()
    caps = tadvisor.HostCaps(8, 64, {"glm_grad": ("cuda",)})
    assert all(s.kernel_backend is None
               for s in tadvisor.candidate_space(prof, caps))


def test_hostcaps_detect_reads_torch_cuda():
    caps = tadvisor.HostCaps.detect()
    gpu = torch.cuda.is_available()
    assert caps.platform == ("gpu" if gpu else "cpu")
    assert caps.device_count == (torch.cuda.device_count() if gpu else 1)
    assert caps.parallel_width == 8 * caps.device_count   # no GPU lanes entry
    flavor = "cuda" if gpu else "torch-reference"
    assert caps.backends == {f: (flavor,)
                             for f in ("glm_grad", "glm_sgd", "glm_sparse")}
    assert caps.to_dict()["backends"]["glm_grad"] == [flavor]


def test_calibrate_matches_the_reference_on_one_store(tmp_path):
    rows = []
    for n in (64, 96, 128, 192):
        for strat in STRATEGIES:
            rows.append((n, strat))
    snap = {"trials": {}}
    for i, (n, jstrat) in enumerate(rows):
        t = jspec.TrialSpec(jspec.DatasetSpec("covtype", max_n=n), "lr",
                            jstrat, 1e-2, 3)
        snap["trials"][t.key] = {"spec": t.to_dict(), "derived": {
            "time_per_epoch_s": 1e-3 * (1 + i % 5) + 1e-6 * n}}
    jcaps = jadvisor.HostCaps(8, 64, {})
    tcaps = tadvisor.HostCaps(8, 64, {})
    assert dataclasses.asdict(tadvisor.calibrate(snap, tcaps)) == \
        dataclasses.asdict(jadvisor.calibrate(snap, jcaps))
    assert tadvisor.calibrate({"trials": {}}, tcaps) == \
        tadvisor.DEFAULT_COST_MODEL


def test_recommend_ranks_like_the_reference():
    jd, td = _dspecs(name="covtype", max_n=128)
    caps = dict(parallel_width=8, max_replicas=16, backends={})
    kw = dict(task="lr", steps=(1e-2, 1e-1), epochs=3)
    j = jadvisor.recommend(jd, jadvisor.HostCaps(**caps),
                           runner=jrunner.Runner(), **kw)
    t = tadvisor.recommend(td, tadvisor.HostCaps(**caps),
                           runner=trunner.Runner(device=CPU), **kw)
    assert [r.name for r in t.ranked] == [r.name for r in j.ranked]
    assert [r.best_step for r in t.ranked] == [r.best_step for r in j.ranked]
    assert [r.epochs_to_target for r in t.ranked] == \
        [r.epochs_to_target for r in j.ranked]
    assert [r.score for r in t.ranked] == [r.score for r in j.ranked]
    np.testing.assert_allclose(t.target, j.target, **TOL)
    assert set(t.to_dict()) == set(j.to_dict())


# ---------------------------------------------------------------------------
# the drivers (repro_torch.benchmarks) against the reference's
# ---------------------------------------------------------------------------


TINY = {"tiny": dict(max_n=128, epochs=3, datasets=("covtype", "w8a"),
                     real_datasets=("covtype", "w8a"))}


@pytest.fixture
def tiny_profile(tmp_path, monkeypatch):
    """Both packages' drivers on a tiny profile, fresh runners, CSVs into
    a tmp dir."""
    for mod, runner in ((tbench, trunner.Runner(device=CPU)),
                        (jbench, jrunner.Runner())):
        monkeypatch.setattr(mod, "PROFILES", {**mod.PROFILES, **TINY})
        monkeypatch.setattr(mod, "RUNNER", runner)
        monkeypatch.setattr(mod, "RESULTS_DIR", tmp_path / mod.__name__)
    return tmp_path


def test_driver_profiles_and_tasks_are_the_references():
    assert tbench.PROFILES == jbench.PROFILES
    assert tbench.TASKS == jbench.TASKS
    assert {k: _port(v).name for k, v in jtable7.CONFIGS.items()} == \
        {k: v.name for k, v in ttable7.CONFIGS.items()}


def _assert_rows_match(trows, jrows, time_keys):
    assert len(trows) == len(jrows) > 0
    for t, j in zip(trows, jrows):
        assert list(t) == list(j)
        for k in t:
            if k in time_keys:
                assert (t[k] is None) == (j[k] is None), k
            elif isinstance(j[k], float):
                np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=k)
            else:
                assert t[k] == j[k], k


def test_table7_rows_match_the_references(tiny_profile):
    _assert_rows_match(ttable7.run("tiny"), jtable7.run("tiny"),
                       ("t_iter_ms", "time_to_1pct_s"))
    assert (tiny_profile / tbench.__name__ / "table7_async.csv").exists()


def test_table4_rows_match_the_references(tiny_profile):
    time_keys = ("t_iter_sync_ms", "t_iter_comp_ms", "t_iter_seq_ms",
                 "speedup_fused_vs_comp", "speedup_sync_vs_seq",
                 "time_to_1pct_s")
    _assert_rows_match(ttable4.run("tiny"), jtable4.run("tiny"), time_keys)


@pytest.mark.parametrize("task", ("lr", "svm"))
def test_table4_seq_on_glm_sgd_is_the_references_incremental_epoch(task):
    rng = np.random.default_rng(5)
    X = rng.normal(0, 1, (200, 9)).astype(np.float32)
    y = np.where(rng.random(200) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, 9).astype(np.float32)
    out = ttable4.seq_epoch(task, torch.from_numpy(w), torch.from_numpy(X),
                            torch.from_numpy(y), 0.05)
    ref = jglm.incremental_epoch(task, jnp.asarray(w), jnp.asarray(X),
                                 jnp.asarray(y), 0.05)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the plain loop gives the same epoch
    loop = tglm.incremental_epoch(task, torch.from_numpy(w),
                                  torch.from_numpy(X), torch.from_numpy(y),
                                  0.05)
    np.testing.assert_allclose(out.numpy(), loop.numpy(), **TOL)


def test_table4_densifies_within_the_cap(monkeypatch):
    ds = tspec.DatasetSpec("w8a", max_n=96).load(device=CPU)
    dense = tsparse.to_dense(ds.ell).numpy()
    X, y = ttable4.dense_operands(ds)
    assert X.shape == (96, 300) and y.shape == (96,)
    np.testing.assert_array_equal(X.numpy(), dense)
    # past the cap, the first DENSE_CAP_ROWS rows (cut before densifying)
    monkeypatch.setattr(ttable4, "DENSE_CAP", 96 * 300 - 1)
    monkeypatch.setattr(ttable4, "DENSE_CAP_ROWS", 10)
    X, y = ttable4.dense_operands(ds)
    np.testing.assert_array_equal(X.numpy(), dense[:10])
    np.testing.assert_array_equal(y.numpy(), ds.y.numpy()[:10])


def test_fig22_and_run_write_the_ports_store(tiny_profile, capsys):
    rows = tfig22.run("tiny")
    assert [(r["dataset"], r["task"]) for r in rows] == [
        (d, t) for d in ("covtype", "w8a") for t in ("lr", "svm")]
    assert {r["winner"] for r in rows} <= {"sync", "async"}
    out = tiny_profile / "study.json"
    trun.main(["--profile", "tiny", "--only", "table4,fig22", "--device",
               CPU, "--out-json", str(out)])
    snap = json.loads(out.read_text())
    assert snap["claims"]["checked_modules"] == ["fig22_sync_vs_async",
                                                 "table4_sync"]
    assert snap["trials"] and "all paper-claim checks passed" in \
        capsys.readouterr().out
    assert tbench.RUNNER.device == torch.device(CPU)
    with pytest.raises(SystemExit):
        trun.main(["--only", "nosuch"])
