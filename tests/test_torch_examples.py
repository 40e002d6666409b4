"""The port's example twins (``examples/torch_*.py``) on the CPU.

Each twin runs with ``--device cpu`` at a smoke size in a subprocess and
prints its original's report; without ``--device`` it runs on ``cuda``
and, on this host with no card, fails rather than fall back to the CPU.
``torch_paper_study.run_grid`` is held to the reference's
``examples/paper_study.run_grid`` on the same seeded datasets, every
configuration's losses epoch by epoch at the engine suite's tolerance.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn

ROOT = Path(__file__).resolve().parents[1]
EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)

#: twin -> (smoke arguments, a line its report prints)
TWINS = {
    "torch_quickstart": (["--max-n", "256", "--epochs", "3"],
                         "optimal loss seen"),
    "torch_paper_study": (["--max-n", "256", "--epochs", "3"],
                          "== paper findings checked =="),
    "torch_serve_lm": (["--requests", "3", "--max-new", "4"],
                       "3/3 requests served on 2 slots"),
    "torch_train_lm": (["--steps", "3", "--batch", "2", "--seq", "32"],
                       "steps=3 loss"),
}


def run_twin(name: str, args: list[str], tmp_path: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, str(ROOT / "examples" /
                                               f"{name}.py"), *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_on_the_cpu_when_asked(name, tmp_path):
    args, line = TWINS[name]
    if name == "torch_train_lm":
        args = args + ["--ckpt", str(tmp_path / "ckpt")]
    r = run_twin(name, args + ["--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert line in r.stdout, r.stdout
    assert "cpu" in r.stdout


def test_train_twin_runs_async(tmp_path):
    r = run_twin("torch_train_lm", ["--steps", "4", "--batch", "2", "--seq",
                                    "32", "--update", "async",
                                    "--merge-every", "2", "--ckpt",
                                    str(tmp_path / "ckpt"), "--device",
                                    "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "update=async" in r.stdout and "steps=4 loss" in r.stdout


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_does_not_fall_back_to_the_cpu(name, tmp_path):
    """No ``--device``: the twin asks for ``cuda``, which this host lacks,
    and exits with an error before printing a report."""
    args, line = TWINS[name]
    r = run_twin(name, args, tmp_path)
    assert r.returncode != 0
    assert line not in r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr


@pytest.mark.parametrize("dataset,task", [("covtype", "lr"), ("w8a", "svm")])
def test_paper_study_grid_matches_the_reference(dataset, task):
    ref, twin = load("paper_study"), load("torch_paper_study")
    want = ref.run_grid(jsyn.paper_dataset(dataset, max_n=256, seed=0), task,
                        epochs=3)
    got = twin.run_grid(tsyn.paper_dataset(dataset, max_n=256, seed=0,
                                           device="cpu"), task, epochs=3)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].losses, want[k].losses,
                                   err_msg=k, **EPOCH_TOL)
