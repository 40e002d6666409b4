"""The port's trace exporter and report CLI (``repro_torch.obs.{export,
report}``) against the reference's, and the port's profiler twin of
``trace.xprof``, on the CPU.

The same hand-written trace and metrics files, one set named for each
package (``trace-main-<pid>.jsonl`` against ``trace-main-torch-<pid>.jsonl``),
go through both packages: parsing, stitching, the Chrome export and its
validation, the layers, the report's JSON and exit codes must be equal, the
self/total breakdown to 1e-12.  Malformed files raise the same errors.  The
port's breakdown leaves its input as it found it (the reference's writes
the child time into the span dicts, so its second call differs).
"""
import json
import os

import pytest
import torch

from repro.obs import export as jexport
from repro.obs import report as jreport

from repro_torch.obs import export, report, trace
from repro_torch.study import spec
from repro_torch.study.runner import Runner

PID_MAIN, PID_SHARD = 4100, 4200
#: anchors: the shard's clock starts 5 us later on the wall clock
META = {
    "main": {"kind": "meta", "schema": 1, "pid": PID_MAIN, "tag": "main",
             "t0_unix_ns": 1_700_000_000_000_000_000, "t0_perf_ns": 500,
             "argv": ["driver"]},
    "shard0a0": {"kind": "meta", "schema": 1, "pid": PID_SHARD,
                 "tag": "shard0a0",
                 "t0_unix_ns": 1_700_000_000_000_005_000, "t0_perf_ns": 90,
                 "argv": ["worker"]},
}


def _span(name, ts, dur, tid=1, depth=0, **args):
    rec = {"kind": "span", "name": name, "ts": ts, "dur": dur,
           "pid": 0, "tid": tid, "depth": depth}
    if args:
        rec["args"] = args
    return rec


RECORDS = {
    "main": [
        _span("sweep.execute", 1000, 9000, workers=1),
        _span("sweep.merge", 10_500, 300, roots=1),
        _span("runner.trial", 1200, 700, tid=2, key="k0"),
        _span("kernel.dispatch", 1250, 400, tid=2, depth=1,
              kernel="glm_grad", backend="torch-reference"),
        _span("engine.epoch", 1260, 100, tid=2, depth=2, epoch=1),
        {"kind": "instant", "name": "slo.breach", "ts": 1300, "dur": 0,
         "pid": 0, "tid": 2, "depth": 1, "args": {"slo": "lat"}},
    ],
    "shard0a0": [
        _span("sweep.shard", 100, 5000, worker=0, device="cpu"),
        _span("sweep.group", 150, 4000, depth=1, trials=2),
        _span("runner.stack", 200, 3000, depth=2, size=2),
        _span("kernel.dispatch", 300, 1000, depth=3, kernel="glm_sgd",
              backend="torch-reference"),
        _span("kernel.dispatch", 1400, 1000, depth=3, kernel="glm_sgd",
              backend="torch-reference"),
    ],
}
SIDECAR = {"schema": 1, "counters": {"study.trial_cache.miss": 2,
                                     "sweep.requeue": 1},
           "gauges": {}, "histograms": {}}


def _trace_name(tag, pid, pkg):
    return (f"trace-{tag}-torch-{pid}.jsonl" if pkg == "torch"
            else f"trace-{tag}-{pid}.jsonl")


def _write(root, pkg, records=RECORDS, meta=META, sidecar=SIDECAR):
    root.mkdir(parents=True, exist_ok=True)
    for tag, recs in records.items():
        m = meta.get(tag)
        lines = ([json.dumps(m)] if m is not None else []) + \
            [json.dumps(r) for r in recs]
        (root / _trace_name(tag, (m or META[tag])["pid"], pkg)) \
            .write_text("\n".join(lines) + "\n")
    if sidecar is not None:
        name = ("metrics-main-torch-4100.json" if pkg == "torch"
                else "metrics-main-4100.json")
        (root / name).write_text(json.dumps(sidecar))
    return root


@pytest.fixture
def dirs(tmp_path):
    return (_write(tmp_path / "torch", "torch"),
            _write(tmp_path / "jax", "jax"))


def _strip_paths(doc):
    doc = dict(doc)
    doc["files"] = [{k: v for k, v in f.items() if k != "path"}
                    for f in doc["files"]]
    doc.pop("metrics_files")
    return doc


def test_read_trace_and_collect_equal_the_references(dirs):
    tdir, jdir = dirs
    ours, ref = export.collect([tdir]), jexport.collect([jdir])
    assert [(t.tag, t.pid) for t in ours] == [(t.tag, t.pid) for t in ref] \
        == [("main", PID_MAIN), ("shard0a0", PID_SHARD)]
    for t, j in zip(ours, ref):
        assert (t.meta, t.spans, t.instants) == (j.meta, j.spans, j.instants)
        assert t.path.name.startswith(f"trace-{t.tag}-torch-")
        one = export.read_trace(t.path)
        assert (one.meta, one.spans) == (t.meta, t.spans)
        assert t.unix_ns(t.spans[0]["ts"]) == j.unix_ns(j.spans[0]["ts"])
    # a file named directly is read whatever its name
    assert len(export.collect([jdir / _trace_name("main", PID_MAIN, "jax")])) \
        == 1
    assert [p.name for p in export.metrics_sidecars([tdir])] == \
        ["metrics-main-torch-4100.json"]


def test_chrome_events_validation_and_layers_equal_the_references(dirs):
    tdir, jdir = dirs
    ours, ref = export.collect([tdir]), jexport.collect([jdir])
    events = export.chrome_events(ours)
    assert events == jexport.chrome_events(ref)
    assert {e["pid"] for e in events} == {1, 2}
    assert export.to_chrome(ours) == jexport.to_chrome(ref)
    assert export.validate_chrome(export.to_chrome(ours)) == []
    broken = {"traceEvents": [
        {"ph": "B", "name": "x", "pid": 1},
        {"ph": "X", "name": "", "pid": "1", "tid": None, "ts": -1,
         "dur": -2},
        {"ph": "i", "name": "y", "pid": 1, "tid": 1, "ts": "0"},
        {"ph": "M", "name": "process_name"}]}
    assert export.validate_chrome(broken) == jexport.validate_chrome(broken)
    assert len(export.validate_chrome(broken)) == 8
    assert export.validate_chrome({"traceEvents": {}}) == \
        jexport.validate_chrome({"traceEvents": {}})
    assert export.layers(ours) == jexport.layers(ref) == \
        ("engine", "kernel", "runner", "sweep")


def test_breakdown_first_call_equals_the_references(dirs):
    tdir, jdir = dirs
    ours = export.breakdown(export.collect([tdir]))
    ref = jexport.breakdown(jexport.collect([jdir]))
    assert sorted(ours) == sorted(ref)
    for name, a in ours.items():
        assert a["count"] == ref[name]["count"]
        for k in ("total_s", "self_s"):
            assert a[k] == pytest.approx(ref[name][k], rel=1e-12, abs=1e-12)
    # children are subtracted: sweep.shard (5000) minus sweep.group (4000)
    assert ours["sweep.shard"]["self_s"] == pytest.approx(1e-6, abs=1e-12)
    assert ours["kernel.dispatch"]["count"] == 3


def test_breakdown_leaves_its_input_alone_and_repeats(dirs):
    tdir, jdir = dirs
    traces = export.collect([tdir])
    before = json.dumps([t.spans for t in traces])
    first = export.breakdown(traces)
    assert export.breakdown(traces) == first
    assert json.dumps([t.spans for t in traces]) == before
    # the reference's second call counts the children twice (on purpose
    # not copied): a 100 ns span with one 60 ns child
    meta = {"main": META["main"]}
    recs = {"main": [_span("a", 1000, 100), _span("b", 1010, 60, depth=1)]}
    jtraces = jexport.collect([_write(tdir.parent / "q", "jax", recs, meta)])
    ttraces = export.collect([_write(tdir.parent / "p", "torch", recs, meta)])
    assert jexport.breakdown(jtraces)["a"]["self_s"] == pytest.approx(4e-8)
    assert jexport.breakdown(jtraces)["a"]["self_s"] == pytest.approx(-2e-8)
    for _ in range(2):
        assert export.breakdown(ttraces)["a"]["self_s"] == pytest.approx(4e-8)


def test_report_json_equals_the_references(dirs, capsys):
    tdir, jdir = dirs
    assert report.main([str(tdir), "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jreport.main([str(jdir), "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert ours["metrics_files"] == [str(tdir / "metrics-main-torch-4100.json")]
    ours, ref = _strip_paths(ours), _strip_paths(ref)
    ours_spans, ref_spans = ours.pop("spans"), ref.pop("spans")
    assert ours == ref
    assert ours["layers"] == ["engine", "kernel", "runner", "sweep"]
    assert ours["instants"] == {"slo.breach": 1}
    assert ours["counters"] == SIDECAR["counters"]
    assert sorted(ours_spans) == sorted(ref_spans)
    for name, a in ours_spans.items():
        for k, v in a.items():
            assert v == pytest.approx(ref_spans[name][k], rel=1e-12,
                                      abs=1e-12)


def test_report_table_lists_every_lane(dirs, capsys):
    tdir, _ = dirs
    assert report.main([str(tdir), "--top", "2"]) == 0
    out = capsys.readouterr().out
    assert "more span name(s)" in out and "layers: engine, kernel" in out
    assert "shard0a0" in out and "study.trial_cache.miss" in out


def test_report_check_and_perfetto_exit_codes_equal_the_references(
        dirs, tmp_path, capsys):
    tdir, jdir = dirs
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    assert report.main([str(tdir), "--check", "--perfetto", str(out_t)]) == \
        jreport.main([str(jdir), "--check", "--perfetto", str(out_j)]) == 0
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())
    assert "OK:" in capsys.readouterr().out
    # one problem per unreadable / too-new sidecar
    for d, name in ((tdir, "metrics-x-torch-1.json"),
                    (jdir, "metrics-x-1.json")):
        (d / name).write_text("{torn")
        (d / name.replace("x", "y")).write_text(json.dumps({"schema": 99}))
    assert report.main([str(tdir), "--check"]) == \
        jreport.main([str(jdir), "--check"]) == 2
    # no trace files: 1, pointing to the port's docs
    empty = tmp_path / "empty"
    empty.mkdir()
    assert report.main([str(empty), "--check"]) == \
        jreport.main([str(empty), "--check"]) == 1
    assert "README.md" in capsys.readouterr().err


def _defective(kind):
    """(records, meta) of a trace set with one defect in the main file."""
    recs = {k: list(v) for k, v in RECORDS.items()}
    meta = dict(META)
    if kind == "newer schema":
        meta["main"] = {**META["main"], "schema": 2}
    elif kind == "no meta line":
        meta.pop("main")
    elif kind == "unknown kind":
        recs["main"] = recs["main"] + [{"kind": "counter", "ts": 1}]
    return recs, meta


@pytest.mark.parametrize("kind", ["torn line", "newer schema",
                                  "no meta line", "unknown kind"])
def test_malformed_traces_raise_the_references_errors(tmp_path, kind,
                                                      capsys):
    recs, meta = _defective(kind)
    tdir = _write(tmp_path / "t", "torch", recs, meta)
    jdir = _write(tmp_path / "j", "jax", recs, meta)
    if kind == "torn line":
        for d in (tdir, jdir):
            [f] = [p for p in d.glob("trace-main-*")]
            with open(f, "a") as fh:
                fh.write('{"kind": "span", "name": "cut')
    with pytest.raises(ValueError) as ours:
        export.collect([tdir])
    with pytest.raises(ValueError) as ref:
        jexport.collect([jdir])
    want = {"torn line": "not JSON", "newer schema": "newer than this reader",
            "no meta line": "no meta line",
            "unknown kind": "unknown record kind"}[kind]
    assert want in str(ours.value) and want in str(ref.value)
    tail = str(ours.value).split(": ", 1)[1]
    assert tail.split(";")[0].split(" (")[0] == \
        str(ref.value).split(": ", 1)[1].split(";")[0].split(" (")[0]
    assert report.main([str(tdir), "--check"]) == \
        jreport.main([str(jdir), "--check"]) == 1
    assert "invalid trace" in capsys.readouterr().err


def test_collect_skips_the_references_files_in_a_shared_dir(tmp_path):
    shared = _write(tmp_path / "shared", "torch")
    _write(shared, "jax", sidecar=None)
    (shared / "metrics-main-4100.json").write_text(json.dumps(SIDECAR))
    assert [t.path.name for t in export.collect([shared])] == \
        ["trace-main-torch-4100.jsonl", "trace-shard0a0-torch-4200.jsonl"]
    assert [p.name for p in export.metrics_sidecars([shared])] == \
        ["metrics-main-torch-4100.json"]
    # the reference's glob reads both packages' files
    assert len(jexport.collect([shared])) == 4
    assert not (tmp_path / "trace-main-4100.jsonl").match(export.TRACE_GLOB)
    assert (tmp_path / "trace-main-torch-4100.jsonl").match(export.TRACE_GLOB)


# ---------------------------------------------------------------------------
# the profiler twin of trace.xprof
# ---------------------------------------------------------------------------


@pytest.fixture
def xprof_env(tmp_path, monkeypatch):
    monkeypatch.setenv(trace.ENV_TRACE, "1")
    monkeypatch.setenv(trace.ENV_TRACE_DIR, str(tmp_path))
    monkeypatch.delenv(trace.ENV_TRACE_TAG, raising=False)
    monkeypatch.setattr(trace, "_xprof_captured", False)
    trace.refresh()
    yield tmp_path
    monkeypatch.delenv(trace.ENV_TRACE, raising=False)
    trace.refresh()


def _work():
    a = torch.arange(64.0).reshape(8, 8)
    return float((a @ a).sum())


def _xprof_spans(root):
    return [s for t in export.collect([root]) for s in t.spans
            if s["name"] == "obs.xprof"]


def test_xprof_captures_once_per_process(xprof_env, monkeypatch):
    monkeypatch.setenv(trace.ENV_XPROF, "1")
    with trace.xprof("covtype/lr/sync@0.1x2"):
        assert _work() > 0
    with trace.xprof("w8a/lr/sync@0.1x2"):      # passes straight through
        _work()
    trace.refresh()                              # close the trace file
    [capture] = (xprof_env / "xprof").iterdir()
    assert capture.name == f"main-torch-{os.getpid()}.json"
    assert capture == trace.xprof_path(xprof_env, "main", os.getpid())
    doc = json.loads(capture.read_text())
    assert any(ev.get("name", "").startswith("aten::")
               for ev in doc["traceEvents"])
    [sp] = _xprof_spans(xprof_env)
    assert sp["args"] == {"label": "covtype/lr/sync@0.1x2"}


def test_xprof_passes_a_label_that_does_not_match(xprof_env, monkeypatch):
    monkeypatch.setenv(trace.ENV_XPROF, "w8a")
    with trace.xprof("covtype/lr/sync@0.1x2"):
        _work()
    assert not (xprof_env / "xprof").exists()
    assert not trace._xprof_captured
    monkeypatch.delenv(trace.ENV_XPROF)
    with trace.xprof("w8a/lr/sync@0.1x2"):       # unset: off
        _work()
    assert not (xprof_env / "xprof").exists()


def test_xprof_failure_lets_the_body_run(xprof_env, monkeypatch):
    monkeypatch.setenv(trace.ENV_XPROF, "1")

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with trace.xprof("covtype/lr"):
        ran.append(_work())
    assert ran and not (xprof_env / "xprof").exists()
    trace.refresh()
    assert len(_xprof_spans(xprof_env)) == 1


def test_runner_wraps_its_first_matching_stack_in_xprof(xprof_env,
                                                        monkeypatch):
    monkeypatch.setenv(trace.ENV_XPROF, "w8a")
    trials = [spec.TrialSpec(spec.DatasetSpec(name, max_n=64), "lr",
                             _sync(), step, 2)
              for name in ("covtype", "w8a") for step in (1e-2, 1e-1)]
    Runner(device="cpu").run(trials)
    trace.refresh()
    [sp] = _xprof_spans(xprof_env)
    assert sp["args"]["label"] == trials[2].label
    [stack] = [s for t in export.collect([xprof_env]) for s in t.spans
               if s["name"] == "runner.stack"
               and s["args"]["label"] == trials[2].label]
    assert stack["ts"] <= sp["ts"] and sp["dur"] <= stack["dur"]
    assert len(list((xprof_env / "xprof").iterdir())) == 1


def _sync():
    from repro_torch.core import sgd
    return sgd.SyncSGD()
