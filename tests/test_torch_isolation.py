"""The port stands alone: nothing under src/repro_torch/, chip_smoke.py
nor the example twins (examples/torch_*.py) imports JAX, the reference
package ``repro`` or the reference's drivers (the root ``benchmarks``
package, which imports ``repro``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("torch_*.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + TWINS
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_the_expected_modules():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"core/glm.py", "core/sparse.py", "core/sgd.py",
            "core/convergence.py", "data/synthetic.py", "convert.py",
            "kernels/common.py", "kernels/_build.py",
            "obs/trace.py", "obs/metrics.py", "serve/glm.py",
            "data/ingest/libsvm.py", "optim/compress.py", "train/fault.py",
            "live/__init__.py", "live/stream.py", "live/learner.py",
            "live/publish.py", "configs/__init__.py", "nn/param.py",
            "nn/layers.py", "nn/attention.py", "nn/transformer.py",
            "nn/decode.py", "serve/engine.py", "launch/serve.py",
            "utils/timing.py", "configs/glm.py", "data/ingest/__init__.py",
            "data/ingest/registry.py", "data/ingest/cache.py",
            "data/ingest/fixtures.py", "study/__init__.py", "study/spec.py",
            "study/store.py", "study/runner.py", "study/tuner.py",
            "study/claims.py", "study/advisor.py", "roofline/__init__.py",
            "roofline/kernels.py", "kernels/tune.py", "obs/digest.py",
            "obs/monitor.py", "obs/export.py", "obs/report.py",
            "sweep/__init__.py", "sweep/plan.py", "sweep/merge.py",
            "sweep/worker.py", "sweep/executor.py", "utils/tree.py",
            "optim/sgd.py", "optim/adam.py", "optim/clip.py",
            "optim/schedules.py", "data/pipeline.py", "train/trainer.py",
            "checkpoint/__init__.py", "checkpoint/checkpoint.py",
            "launch/train.py", "nn/moe.py", "nn/ssm.py", "nn/xlstm.py",
            "data/modality_stubs.py", "launch/mesh.py", "launch/specs.py",
            "launch/dryrun.py", "nn/local.py", "roofline/counts.py",
            "roofline/analysis.py"} <= names
    assert [p.name for p in TWINS] == [f"torch_{m}.py" for m in (
        "paper_study", "quickstart", "serve_lm", "train_lm")]
    assert {f"benchmarks/{m}.py" for m in (
        "common", "table7_async", "table4_sync", "fig22_sync_vs_async",
        "fig11_model_replication", "fig14_data_replication",
        "fig8_access_path", "table6_optimal", "fig24_scale", "run",
        "bench_kernels", "bench_serve", "bench_live")} <= names
    assert sorted(p.name for p in (PORT / "data" / "ingest" / "fixtures")
                  .glob("*.libsvm")) == [f"{n}.libsvm" for n in (
                      "covtype", "news", "real-sim", "skin", "w8a")]
    assert {f"configs/{m}.py" for m in (
        "minitron_4b", "command_r_35b", "h2o_danube_1_8b", "minitron_8b",
        "olmoe_1b_7b", "kimi_k2_1t_a32b", "musicgen_large", "zamba2_1_2b",
        "xlstm_1_3b", "llama_3_2_vision_11b")} <= names
    for fam in ("glm_sgd", "glm_grad", "glm_sgd_sparse", "glm_sparse",
                "glm_score", "flash_attn"):
        assert {f"kernels/{fam}/ops.py", f"kernels/{fam}/ref.py"} <= names
        assert (PORT / "kernels" / "csrc" / f"{fam}.cu").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'benchmarks'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
