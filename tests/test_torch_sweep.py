"""The port's sweep scheduler (``repro_torch.sweep``) against the reference's
(``repro.sweep``), on the CPU.

Where both packages take the same input — the planner over the same trial
list, the merge over the same cache roots — their answers must be equal,
key for key (the trial keys are equal in both packages).  The executor and
its workers are the port's own processes: they run here with CPU workers
(``device="cpu"``), and hold the reference's contract — a 2-worker sweep
writes the same store bytes as a warm serial run, dead workers are
requeued, a SIGKILLed worker's partial sidecar stays readable, exhausted
retries merge before raising, scratch goes on success, a single stack group
runs in-process, the stack flag reaches the workers, and dispatched results
equal in-process ones.  The runner's device reaches every worker's command
line (``cuda`` by default), which is checked without launching.
"""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro.core import sgd as jsgd
from repro.study import runner as jrunner
from repro.study import spec as jspec
from repro.sweep import MergeConflict as JMergeConflict
from repro.sweep import merge_caches as jmerge_caches
from repro.sweep import plan as jplan

from repro_torch.core import sgd
from repro_torch.obs import metrics, trace
from repro_torch.study import spec, store
from repro_torch.study.runner import Runner, TrialResult
from repro_torch.sweep import (LocalProcessExecutor, MergeConflict, Shard,
                               ShardFailure, executor as executor_mod,
                               merge_caches, plan)

CPU = "cpu"
#: the study parity suite's tolerance (tests/test_torch_study.py)
TOL = dict(rtol=1e-4, atol=1e-4)


def _trials(datasets=("covtype",), tasks=("lr",), steps=(1e-2, 1e-1),
            epochs=2, max_n=96, pkg="torch"):
    s, opt = (spec, sgd) if pkg == "torch" else (jspec, jsgd)
    return list(s.grid(
        [s.DatasetSpec(d, max_n=max_n) for d in datasets], tasks,
        [opt.SyncSGD()], steps=steps, epochs=epochs))


def _both(**kw):
    return _trials(pkg="torch", **kw), _trials(pkg="jax", **kw)


def _shard_keys(shards):
    return [(s.worker, s.keys) for s in shards]


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _executor(tmp_path, workers=1, **kw):
    return LocalProcessExecutor(workers=workers, work_dir=tmp_path / "work",
                                **kw)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def test_plan_colocates_stack_groups_and_partitions_trials():
    trials, jtrials = _both(datasets=("covtype", "w8a"), tasks=("lr", "svm"))
    assert [t.key for t in trials] == [t.key for t in jtrials]
    shards = plan(trials, 2)
    assert _shard_keys(shards) == _shard_keys(jplan(jtrials, 2))
    assert {s.worker for s in shards} == {0, 1}
    keys = [k for s in shards for k in s.keys]
    assert sorted(keys) == sorted(t.key for t in trials)
    owner = {}
    for s in shards:
        for t in s.trials:
            assert owner.setdefault(t.stack_key, s.worker) == s.worker
    assert sorted(len(s.trials) for s in shards) == [4, 4]


def test_plan_weighs_groups_by_data_volume():
    """A full-size group rides alone; both packages weigh it alike."""
    big, jbig = _both(datasets=("covtype",), max_n=2048)
    small, jsmall = _both(datasets=("w8a",), tasks=("lr", "svm"),
                          steps=(1e-3, 1e-2, 1e-1), max_n=64)
    shards = plan(big + small, 2)
    assert _shard_keys(shards) == _shard_keys(jplan(jbig + jsmall, 2))
    by_worker = {s.worker: {t.dataset.name for t in s.trials} for s in shards}
    assert by_worker == {0: {"covtype"}, 1: {"w8a"}}


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
def test_plan_is_deterministic_and_drops_duplicates_and_empty_shards(
        workers):
    trials, jtrials = _both(datasets=("covtype", "w8a", "real-sim"),
                            tasks=("lr", "svm"))
    assert plan(trials, workers) == plan(trials, workers)
    assert _shard_keys(plan(trials + trials, workers)) == \
        _shard_keys(jplan(jtrials + jtrials, workers))
    assert sum(len(s.trials) for s in plan(trials + trials, workers)) == \
        len(trials)
    one = _trials()     # one stack group -> a single non-empty shard
    assert [len(s.trials) for s in plan(one, workers)] == [len(one)]
    with pytest.raises(ValueError, match="workers"):
        plan(trials, 0)


def test_shard_round_trips_through_dict_and_matches_the_references():
    trials, jtrials = _both()
    shard = plan(trials, 1)[0]
    doc = json.loads(json.dumps(shard.to_dict()))
    assert doc == json.loads(json.dumps(jplan(jtrials, 1)[0].to_dict()))
    assert Shard.from_dict(doc) == shard
    with pytest.raises(ValueError, match="schema"):
        Shard.from_dict({"schema": -1, "worker": 0, "trials": []})


# ---------------------------------------------------------------------------
# merge layer (same roots through both packages)
# ---------------------------------------------------------------------------


def _write_cache(root, entries: dict):
    root.mkdir(parents=True, exist_ok=True)
    for key, payload in entries.items():
        (root / f"{key}.json").write_text(spec.canonical_json(payload))


def _tree(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())} \
        if root.exists() else None


def _merge_both(tmp_path, sources, dest):
    """Run both packages' merge over copies of the same roots; returns the
    port's (report or exception, dest tree) and the reference's."""
    out = []
    for name, fn in (("torch", merge_caches), ("jax", jmerge_caches)):
        base = tmp_path / name
        shutil.copytree(tmp_path / "in", base)
        try:
            res = fn([base / s for s in sources], base / dest)
        except (MergeConflict, JMergeConflict) as e:
            res = e
        out.append((res, _tree(base / dest)))
    return out


def test_merge_unions_and_is_idempotent_on_identical_payloads(tmp_path):
    _write_cache(tmp_path / "in" / "a", {"k1": {"x": 1}, "k2": {"x": 2}})
    _write_cache(tmp_path / "in" / "b", {"k2": {"x": 2}, "k3": {"x": 3}})
    (ours, tree), (ref, jtree) = _merge_both(tmp_path, ["a", "b"], "dest")
    assert ours.to_dict() == ref.to_dict() == \
        {"merged": 3, "identical": 1, "sources": 2}
    assert tree == jtree and sorted(tree) == ["k1.json", "k2.json", "k3.json"]
    a, b, dest = (tmp_path / "torch" / n for n in ("a", "b", "dest"))
    rep2 = merge_caches([a, b], dest)
    assert (rep2.merged, rep2.identical) == (0, 4)
    rep3 = merge_caches([tmp_path / "nope"], dest)
    assert (rep3.merged, rep3.identical) == (0, 0)


def test_merge_conflict_raises_with_every_key_and_writes_nothing(tmp_path):
    _write_cache(tmp_path / "in" / "a",
                 {"k1": {"x": 1}, "k2": {"x": 2}, "ok": {"x": 0}})
    _write_cache(tmp_path / "in" / "b", {"k1": {"x": 9}, "k2": {"x": 8}})
    (ours, tree), (ref, jtree) = _merge_both(tmp_path, ["a", "b"], "dest")
    assert isinstance(ours, MergeConflict) and isinstance(ref, JMergeConflict)
    assert sorted(ours.keys) == sorted(ref.keys) == ["k1", "k2"]
    assert "k1" in str(ours) and "k2" in str(ours)
    assert tree is None and jtree is None      # all-or-nothing
    b, dest = tmp_path / "torch" / "b", tmp_path / "torch" / "dest"
    _write_cache(dest, {"k1": {"x": 1}})
    with pytest.raises(MergeConflict) as ei:
        merge_caches([b], dest)
    assert "k1" in ei.value.keys


def test_merge_skips_tmp_files(tmp_path):
    _write_cache(tmp_path / "in" / "a", {"k1": {"x": 1}})
    (tmp_path / "in" / "a" / ".k9.tmp.123").write_text("partial write")
    (ours, tree), (ref, jtree) = _merge_both(tmp_path, ["a"], "dest")
    assert ours.merged == ref.merged == 1
    assert tree == jtree and list(tree) == ["k1.json"]


# ---------------------------------------------------------------------------
# the runner's dispatch, the worker protocol and the executor
# ---------------------------------------------------------------------------


def test_runner_rejects_executor_without_cache():
    with pytest.raises(ValueError, match="cache_dir"):
        Runner(executor=LocalProcessExecutor(workers=2), device=CPU)
    r = Runner(device=CPU)
    with pytest.raises(ValueError, match="cache_dir"):
        r.executor = LocalProcessExecutor(workers=2)


def test_workers_run_on_the_runners_device_cuda_by_default(tmp_path,
                                                           monkeypatch):
    """The command line names the port's worker and carries the runner's
    device; nothing is launched (the fake process exits at once and
    leaves no payload, so the executor reports the missing trials)."""
    launched = []

    class _Exited:
        pid, returncode = 4242, 0

        def poll(self):
            return 0

    def fake_popen(cmd, **kw):
        launched.append((cmd, kw["env"]))
        return _Exited()

    monkeypatch.setattr(executor_mod.subprocess, "Popen", fake_popen)
    trials = _trials(tasks=("lr", "svm"))     # 2 stack groups
    for device, want in ((None, "cuda"), (CPU, "cpu")):
        launched.clear()
        runner = Runner(cache_dir=tmp_path / f"cache-{want}", device=device,
                        executor=_executor(tmp_path, max_retries=0))
        with pytest.raises(ShardFailure, match="missing"):
            runner.run(trials)
        [(cmd, env)] = launched
        assert cmd[:3] == [sys.executable, "-m", "repro_torch.sweep.worker"]
        assert cmd[cmd.index("--device") + 1] == want
        src = str(executor_mod.Path(executor_mod.repro_torch.__file__)
                  .resolve().parent.parent)
        assert env["PYTHONPATH"].split(":")[0] == src


def test_two_worker_sweep_reproduces_serial_store_bytes(tmp_path):
    trials = _trials(datasets=("covtype", "w8a"))

    def sweep(path, executor):
        st = store.StudyStore(path, jsonl_path=tmp_path / "runs.jsonl")
        Runner(cache_dir=tmp_path / "cache", store=st, executor=executor,
               device=CPU).run(trials)
        st.record_claims([], checked_modules=["mini"])
        return st.write().read_text()

    first = sweep(tmp_path / "a.json", _executor(tmp_path, workers=2))
    second = sweep(tmp_path / "b.json", None)       # serial, warm cache
    assert first == second
    assert "sweep_shard" not in first

    events = _events(tmp_path / "runs.jsonl")
    shard_events = [e for e in events if e.get("event") == "sweep_shard"]
    assert {e["worker"] for e in shard_events} == {0, 1}
    assert all(e["returncode"] == 0 for e in shard_events)
    assert sorted(k for e in shard_events for k in e["completed"]) == \
        sorted(t.key for t in trials)
    [merge] = [e for e in events if e.get("event") == "sweep_merge"]
    assert merge["merged"] == len(trials) and merge["workers"] == 2


def test_worker_death_requeues_unfinished_and_keeps_partial_cache(tmp_path):
    trials = _trials(tasks=("lr", "svm"))    # 2 stack groups x 2 trials
    st = store.StudyStore(tmp_path / "out.json",
                          jsonl_path=tmp_path / "runs.jsonl")
    ex = _executor(tmp_path, worker_args=(
        "--fault-after", "2", "--fault-flag", str(tmp_path / "flag")))
    out = Runner(cache_dir=tmp_path / "cache", store=st, executor=ex,
                 device=CPU).run(trials)
    st.write()
    assert all(np.isfinite(r.final_loss) for r in out)
    assert sorted(p.stem for p in (tmp_path / "cache").glob("*.json")) == \
        sorted(t.key for t in trials)

    events = _events(tmp_path / "runs.jsonl")
    shard_events = [e for e in events if e.get("event") == "sweep_shard"]
    assert [e["attempt"] for e in shard_events] == [0, 1]
    died, retried = shard_events
    assert died["returncode"] == 17 and len(died["completed"]) == 2
    assert sorted(died["requeued"]) == sorted(retried["keys"])
    assert retried["returncode"] == 0
    assert set(retried["keys"]) == \
        {t.key for t in trials} - set(died["completed"])
    [merge] = [e for e in events if e.get("event") == "sweep_merge"]
    assert merge["retries"] == 1 and merge["merged"] == len(trials)


def test_sigkilled_worker_keeps_readable_partial_metrics_sidecar(
        tmp_path, monkeypatch):
    monkeypatch.delenv(trace.ENV_TRACE, raising=False)
    monkeypatch.setenv(metrics.ENV_METRICS, "1")
    monkeypatch.setenv(trace.ENV_TRACE_DIR, str(tmp_path / "tracedir"))
    trace.refresh()

    trials = _trials(tasks=("lr", "svm"))
    st = store.StudyStore(tmp_path / "out.json",
                          jsonl_path=tmp_path / "runs.jsonl")
    ex = _executor(tmp_path, worker_args=(
        "--fault-after", "2", "--fault-mode", "kill",
        "--fault-flag", str(tmp_path / "flag")))
    out = Runner(cache_dir=tmp_path / "cache", store=st, executor=ex,
                 device=CPU).run(trials)
    st.write()
    assert len(out) == len(trials)

    died, retried = [e for e in _events(tmp_path / "runs.jsonl")
                     if e.get("event") == "sweep_shard"]
    assert died["returncode"] == -9 and retried["returncode"] == 0
    killed = sorted((tmp_path / "tracedir")
                    .glob("metrics-shard0a0-torch-*.json"))
    assert killed, "SIGKILLed worker left no metrics sidecar"
    snap = json.loads(killed[0].read_text())
    assert snap["schema"] == metrics.METRICS_SCHEMA and snap["counters"]
    assert not list((tmp_path / "tracedir").glob("*.tmp*"))


def test_retries_exhausted_raises_but_merges_completed_trials(tmp_path):
    trials = _trials(tasks=("lr", "svm"))
    st = store.StudyStore(tmp_path / "out.json",
                          jsonl_path=tmp_path / "runs.jsonl")
    ex = _executor(tmp_path, max_retries=0,
                   worker_args=("--fault-after", "2"))
    with pytest.raises(ShardFailure, match="unfinished"):
        Runner(cache_dir=tmp_path / "cache", store=st, executor=ex,
               device=CPU).run(trials)
    assert len(list((tmp_path / "cache").glob("*.json"))) == 2
    assert list((tmp_path / "work").glob("sweep-*"))
    st.write()
    events = _events(tmp_path / "runs.jsonl")
    [died] = [e for e in events if e.get("event") == "sweep_shard"]
    assert died["returncode"] == 17 and len(died["completed"]) == 2
    assert any(e.get("event") == "sweep_merge" for e in events)


def test_executor_cleans_scratch_after_success(tmp_path):
    Runner(cache_dir=tmp_path / "cache", executor=_executor(tmp_path),
           dispatch_min_groups=1, device=CPU).run(_trials(steps=(1e-2,)))
    assert list((tmp_path / "work").glob("sweep-*")) == []


def test_single_stack_group_stays_in_process(tmp_path):
    class _MustNotDispatch:
        def execute(self, trials, cache, *, stack=True, device=None):
            raise AssertionError("single-group dispatch reached executor")

    out = Runner(cache_dir=tmp_path / "cache", executor=_MustNotDispatch(),
                 device=CPU).run(_trials())
    assert [r.cached for r in out] == [False, False]


def test_dispatch_forwards_the_runners_stack_flag(tmp_path):
    trials = _trials()      # one 2-step stack group
    ex = _executor(tmp_path)
    out = Runner(cache_dir=tmp_path / "unstacked", stack=False, executor=ex,
                 dispatch_min_groups=1, device=CPU).run(trials)
    assert [r.stacked for r in out] == [False, False]
    out = Runner(cache_dir=tmp_path / "stacked", executor=ex,
                 dispatch_min_groups=1, device=CPU).run(trials)
    assert [r.stacked for r in out] == [True, True]


def test_dispatched_results_match_in_process_results(tmp_path):
    """Worker subprocesses compute the numbers the in-process runner does,
    and those the reference's runner does at the study suite's tolerance."""
    trials, jtrials = _both(steps=(1e-2,), epochs=3)
    dispatched = Runner(cache_dir=tmp_path / "cache",
                        executor=_executor(tmp_path), dispatch_min_groups=1,
                        device=CPU).run(trials)
    local = Runner(device=CPU).run(trials)
    ref = jrunner.Runner().run(jtrials)
    for a, b, j in zip(dispatched, local, ref):
        assert not a.cached
        np.testing.assert_array_equal(a.losses, b.losses)
        np.testing.assert_allclose(a.losses, j.losses, **TOL)
    payload = json.loads(
        (tmp_path / "cache" / f"{trials[0].key}.json").read_text())
    np.testing.assert_array_equal(TrialResult.from_dict(payload).losses,
                                  dispatched[0].losses)


def test_worker_cli_runs_a_shard_file_into_its_cache(tmp_path):
    """The worker as a user runs it: one shard file in, one trial file per
    key out, a progress line per stack group."""
    trials = _trials(tasks=("lr", "svm"))
    shard_path = tmp_path / "shard.json"
    shard_path.write_text(json.dumps(plan(trials, 1)[0].to_dict()))
    env = executor_mod._worker_env()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep.worker", "--shard",
         str(shard_path), "--cache-dir", str(tmp_path / "c"), "--device",
         CPU], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    progress = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [p["done"] for p in progress] == [2, 4]
    assert sorted(p.stem for p in (tmp_path / "c").glob("*.json")) == \
        sorted(t.key for t in trials)


def test_run_workers_attaches_a_process_executor(tmp_path, monkeypatch,
                                                 capsys):
    """``benchmarks.run --workers N`` hands the shared runner an N-worker
    executor whose scratch lives beside the port's results; the workers
    get the driver's ``--device``."""
    from repro_torch.benchmarks import common as bcommon
    from repro_torch.benchmarks import run as brun

    tiny = dict(max_n=64, epochs=2, datasets=("covtype",),
                real_datasets=("covtype",))
    monkeypatch.setattr(bcommon, "PROFILES", {**bcommon.PROFILES,
                                              "tiny": tiny})
    monkeypatch.setattr(bcommon, "RESULTS_DIR", tmp_path / "results")
    monkeypatch.setattr(bcommon, "RUNNER", bcommon.RUNNER)
    brun.main(["--profile", "tiny", "--only", "fig22", "--device", CPU,
               "--workers", "2", "--out-json", str(tmp_path / "s.json")])
    ex = bcommon.RUNNER.executor
    assert isinstance(ex, LocalProcessExecutor) and ex.workers == 2
    assert ex.work_dir == tmp_path / "results" / "sweep_workers"
    assert bcommon.RUNNER.device.type == CPU
    assert "all paper-claim checks passed" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        brun.main(["--workers", "0"])
    assert "--workers must be >= 1" in capsys.readouterr().err
