"""The port's three benchmark producers (``repro_torch.benchmarks.bench_kernels``,
``bench_serve``, ``bench_live``) against the reference's, on the CPU.

Their shapes, profiles, variants and labels are the reference's, and each
kernel family's bench inputs, run through the port on ``device="cpu"`` (the
plain versions), match the reference's bench call at the reference's
tolerance.  On the CPU no kernel flavor exists, so the kernel and serving
producers record no verdict (None, no checked backend) and their gates
report an unchecked run; a warm re-run is byte-identical, and ``--monitor``
leaves the trajectory byte-identical.  The CUDA kernels' verdicts come from
``chip_smoke.py``'s phase ``bench`` on the card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import bench_kernels as jbench_kernels
from benchmarks import bench_live as jbench_live
from benchmarks import bench_serve as jbench_serve
from benchmarks import common as jcommon

from repro_torch.benchmarks import bench_kernels, bench_live, bench_serve
from repro_torch.benchmarks import common
from repro_torch.serve.glm import GLMScoreEngine
from repro_torch.study import claims

ROOT = Path(__file__).resolve().parents[1]

TINY_SHAPES = {
    "glm_grad": {"ci": dict(n=32, d=16)},
    "glm_sgd": {"ci": dict(n=16, d=8)},
    "glm_sparse": {"ci": dict(n=16, d=128, k=4)},
    "glm_sgd_sparse": {"ci": dict(n=16, d=64, k=4)},
    "flash_attn": {"ci": dict(batch=1, heads_q=2, heads_kv=1, seq_q=16,
                              seq_k=16, head_dim=8)},
}
TINY_SERVE = {"ci": dict(n_requests=24, d=128, batches=(4, 8), ks=(2, 4))}
TINY_LIVE = {"ci": dict(d=64, n_batch=32, n_steps=8, merge_every=2,
                        step_size=0.2, replicas=(2,), compress=(False, True),
                        serve_replicas=2, max_batch=4, n_checkpoints=2)}
UNCHECKED = {
    "kernels": "kernels: no Pallas flavor was conformance-checked "
               "(every trajectory point is unchecked)",
    "serve": "serve: no Pallas flavor of glm_score was conformance-checked "
             "(every trajectory point is unchecked)",
}


@pytest.mark.parametrize("ours,ref,name", [
    (bench_kernels, jbench_kernels, "SHAPES"),
    (bench_kernels, jbench_kernels, "VARIANTS"),
    (bench_kernels, jbench_kernels, "TIMING_SCHEMA"),
    (bench_kernels, jbench_kernels, "STEP"),
    (bench_serve, jbench_serve, "PROFILES"),
    (bench_serve, jbench_serve, "TASK"),
    (bench_serve, jbench_serve, "TIMING_SCHEMA"),
    (bench_live, jbench_live, "PROFILES"),
    (bench_live, jbench_live, "FAULTS"),
    (bench_live, jbench_live, "TASK"),
    (bench_live, jbench_live, "TIMING_SCHEMA"),
], ids=lambda x: getattr(x, "__name__", x))
def test_constants_equal_the_references(ours, ref, name):
    assert getattr(ours, name) == getattr(ref, name)


def _run_all(tmp: Path, runs: dict) -> dict:
    """Each producer of the port and of the reference at the tiny shapes,
    into ``tmp``; returns the rows and the written files."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "RESULTS_DIR", tmp / "res")
        mp.setattr(jcommon, "RESULTS_DIR", tmp / "jres")
        mp.setenv("REPRO_TORCH_TUNE_DIR", str(tmp / "tune"))
        mp.setenv("REPRO_TUNE_DIR", str(tmp / "jtune"))
        for mod in (bench_kernels, jbench_kernels):
            mp.setattr(mod, "SHAPES", TINY_SHAPES)
        for mod in (bench_serve, jbench_serve):
            mp.setattr(mod, "PROFILES", TINY_SERVE)
        for mod in (bench_live, jbench_live):
            mp.setattr(mod, "PROFILES", TINY_LIVE)
        for name, fn in runs.items():
            path = tmp / f"{name}.json"
            out[name] = (fn(path), path)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cold runs (the reference's on its own auto backend)."""
    cpu = {"device": "cpu"}
    return _run_all(tmp_path_factory.mktemp("bench"), {
        "kernels": lambda p: bench_kernels.run("ci", out_json=p, **cpu),
        "serve": lambda p: bench_serve.run("ci", out_json=p, **cpu),
        "live": lambda p: bench_live.run("ci", out_json=p, **cpu),
        "jkernels": lambda p: jbench_kernels.run("ci", out_json=str(p)),
        "jserve": lambda p: jbench_serve.run("ci", out_json=str(p)),
        "jlive": lambda p: jbench_live.run("ci", out_json=str(p)),
    })


@pytest.mark.parametrize("name", ["kernels", "serve", "live"])
def test_labels_and_entry_fields_equal_the_references(runs, name):
    ours = json.loads(runs[name][1].read_text())["entries"]
    ref = json.loads(runs["j" + name][1].read_text())["entries"]
    assert sorted(ours) == sorted(ref)
    for label in ref:
        assert set(ours[label]) == set(ref[label]), label
        if "roofline" in ref[label]:
            # the card's terms replace the TPU's
            assert {k.removeprefix("tpu_") for k in ref[label]["roofline"]} \
                | {"peaks"} == set(ours[label]["roofline"])


@pytest.mark.parametrize("name", ["kernels", "serve"])
def test_no_verdict_on_the_cpu_and_the_gate_says_so(runs, name):
    rows = runs[name][0]
    assert rows and all(r["pallas_match"] is None
                        and r["checked_backends"] == [] for r in rows)
    assert all(r["backend"] == "torch-reference" for r in rows)
    check = {"kernels": claims.check_bench_kernels,
             "serve": claims.check_bench_serve}[name]
    assert check(rows) == [UNCHECKED[name]]
    # the reference checks its interpret flavor here, and passes
    jrows = runs["j" + name][0]
    assert all(r["pallas_match"] is True for r in jrows)


def test_live_gate_is_clean_on_the_cpu(runs):
    rows = runs["live"][0]
    assert claims.check_bench_live(rows) == []
    conv = [r for r in rows if r["kind"] == "convergence"]
    assert conv and all(r["losses"][-1] < r["losses"][0] for r in conv)
    assert {r["kind"] for r in rows} == {"convergence", "serve"}


def test_kernel_rows_carry_the_h100_roofline(runs):
    rows = runs["kernels"][0]
    attn = [r for r in rows if r["kernel"] == "flash_attn"]
    for r in rows:
        roof = r["roofline"]
        assert roof["peaks"]["device"] == "NVIDIA H100 SXM"
        assert 0 < roof["roofline_fraction"] <= 1.0
    # causal: the visible pairs, half the square and the diagonal
    s = TINY_SHAPES["flash_attn"]["ci"]
    assert attn[0]["roofline"]["flops"] == 4.0 * s["batch"] * s["heads_q"] \
        * s["head_dim"] * (s["seq_q"] * (s["seq_q"] + 1) // 2)
    # on the CPU the plain versions ignore launch geometry: nothing to
    # sweep; a micro-batch is part of the function and is tuned
    tuned = {r["kernel"]: r["config"] for r in rows
             if r["variant"] == "tuned"}
    assert set(tuned) == set(TINY_SHAPES)
    for kernel, config in tuned.items():
        assert (config == {}) == (kernel not in ("glm_sgd", "glm_sgd_sparse"))


@pytest.mark.parametrize("name", ["kernels", "serve", "live"])
def test_a_warm_rerun_is_byte_identical(runs, name):
    cold = runs[name][1].read_bytes()
    fn = {"kernels": bench_kernels.run, "serve": bench_serve.run,
          "live": bench_live.run}[name]
    rows, path = _run_all(runs[name][1].parent, {
        name: lambda p: fn("ci", out_json=p, device="cpu")})[name]
    assert path.read_bytes() == cold
    # the warm run gates against the (now committed) same-host trajectory
    if name == "kernels":
        assert all(r["baseline_wall_s"] == r["wall_s"] for r in rows)


@pytest.mark.parametrize("name", ["serve", "live"])
def test_monitor_leaves_the_trajectory_byte_identical(runs, name):
    cold = runs[name][1].read_bytes()
    res = runs[name][1].parent
    fn = {"serve": bench_serve.run, "live": bench_live.run}[name]
    _run_all(res, {name: lambda p: fn("ci", out_json=p, device="cpu",
                                      monitor=True)})
    assert runs[name][1].read_bytes() == cold


def test_serve_with_two_consumers(tmp_path):
    rows, _ = _run_all(tmp_path, {"serve": lambda p: bench_serve.run(
        "ci", out_json=p, device="cpu", consumers=2)})["serve"]
    assert len(rows) == 4 and all(r["label"].endswith("/c2")
                                  and r["consumers"] == 2 for r in rows)
    assert all(r["p99_s"] >= r["p50_s"] > 0 and r["rps"] > 0 for r in rows)
    assert claims.check_bench_serve(rows) == [UNCHECKED["serve"]]


def test_bad_arguments_raise(tmp_path):
    with pytest.raises(ValueError, match="fault_stall_s"):
        GLMScoreEngine("lr", np.zeros(4, np.float32), ell_width=2,
                       device="cpu", fault_stall_s=-1.0)
    with pytest.raises(ValueError, match="consumers"):
        bench_serve.run("ci", out_json=tmp_path / "s.json", consumers=0,
                        device="cpu")
    with pytest.raises(ValueError, match="monitor"):
        bench_serve.run("ci", out_json=tmp_path / "s.json",
                        fault_stall_s=0.1, device="cpu")
    with pytest.raises(ValueError, match="fault"):
        bench_live.run("ci", out_json=tmp_path / "l.json", fault="boom",
                       device="cpu")
    with pytest.raises(ValueError, match="monitor"):
        bench_live.run("ci", out_json=tmp_path / "l.json",
                       fault="diverge", device="cpu")


@pytest.mark.parametrize("kernel", sorted(TINY_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_inputs_match_the_references_call(kernel, dtype):
    """The port's bench call on the CPU against the reference's bench call
    (its auto backend, the Pallas kernel in interpret mode), on inputs both
    build from the same numpy seeds, at the reference's tolerance."""
    shape = TINY_SHAPES[kernel]["ci"]
    fam = bench_kernels._make_family(kernel, shape, dtype, "cpu")
    jfam = jbench_kernels._make_family(kernel, shape, dtype)
    assert fam.info == {**jfam.info, **({"causal": True}
                                        if kernel == "flash_attn" else {})}
    assert fam.tol == jfam.tol
    ours = fam.call(**fam.check).float().numpy()
    ref = np.asarray(jfam.call(**fam.check), np.float32)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=fam.tol[0], atol=fam.tol[1])


def test_serve_requests_are_the_references(tmp_path):
    reqs, vals, idx = bench_serve._requests(24, 128, 4, torch.device("cpu"))
    jreqs, jvals, jidx = jbench_serve._requests(24, 128, 4)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert [r.rid for r in reqs] == [r.rid for r in jreqs]


def test_cli_exits_nonzero_on_the_cpu_and_writes_under_bench_results(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_TUNE_DIR=str(tmp_path / "tune"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.bench_serve", "ci",
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no Pallas flavor of glm_score was conformance-checked" \
        in proc.stdout
    written = tmp_path / "bench_results" / "torch" / "BENCH_serve.json"
    assert written.is_file() and not (tmp_path / "BENCH_serve.json").exists()
