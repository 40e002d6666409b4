"""The port's production meshes and dry run on ``"fake"`` process groups,
against the reference's numbers, on the CPU.

Each world runs in its own subprocess with its own time limit (a process
group is process state):

* ``make_production_mesh`` on fake worlds of 256 and 512 ranks gives the
  reference's ``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model:
  16}`` (``tests/test_launch.py::test_production_mesh_shapes``);
* the dry run's per-rank argument and output bytes on an 8-rank fake world
  equal, byte for byte, what the reference's compiled steps report on a
  ``jax.sharding.Mesh`` of Auto axes (``memory_analysis()``, jax 0.9.0,
  8 forced host devices): the sync step of reduced minitron-4b with
  ``seq_shard`` on ``(data=4, model=2)``, 148,996 and 148,840; the decode
  step of reduced zamba2-1.2b on ``(pod=2, data=2, model=2)``, 653,260 and
  105,528.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.launch import dryrun, mesh

REPO = Path(__file__).resolve().parents[1]


def run_py(code: str, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_production_mesh_shapes():
    res = run_py("""
        import json
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        out = {}
        for multi, size in ((False, 256), (True, 512)):
            with dryrun.fake_world(size):
                m = make_production_mesh(multi_pod=multi, device_type="cpu")
                out["multi" if multi else "single"] = dict(zip(
                    m.mesh_dim_names, m.shape))
        print(json.dumps(out))
    """, timeout=120)
    assert res["single"] == {"data": 16, "model": 16}
    assert res["multi"] == {"pod": 2, "data": 16, "model": 16}


#: cell -> (arch, seq_shard, mesh shape, axis names, kind, seq, global
#: batch, the reference's argument bytes, its output bytes)
MINI = {
    "sync": ("minitron-4b", True, (4, 2), ("data", "model"), "train", 16,
             8, 148_996, 148_840),
    "decode": ("zamba2-1.2b", False, (2, 2, 2), ("pod", "data", "model"),
               "decode", 32, 8, 653_260, 105_528),
}


@pytest.mark.parametrize("cell", sorted(MINI))
def test_dryrun_bytes_equal_the_references_memory_analysis(cell):
    *setup, arg_bytes, out_bytes = MINI[cell]
    res = run_py(f"""
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import configs
        from repro_torch.launch import dryrun
        arch, seq_shard, shape, names, kind, seq, gb = {setup!r}
        cfg = configs.reduced(configs.get(arch), seq_shard=seq_shard)
        with dryrun.fake_world(8):
            m = init_device_mesh("cpu", shape, mesh_dim_names=names)
            print(json.dumps(dryrun.run_step(dryrun.group_rule(cfg, m, gb),
                                             kind, seq, gb, m,
                                             device="cpu")))
    """, timeout=120)
    assert res["memory"]["argument_bytes"] == arg_bytes
    assert res["memory"]["output_bytes"] == out_bytes
    assert res["memory"]["temp_bytes"] is None
    # the step's own peak: at least what it was given, and its flops
    assert res["memory"]["peak_bytes"] >= arg_bytes
    assert res["cost_analysis"]["flops"] > res["matmul_flops"] > 0


def test_a_mesh_needs_a_process_group_and_says_so():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_host_mesh(device_type="cpu")


def test_results_go_under_dryrun_results_torch():
    assert dryrun.RESULTS_DIR.parts[-2:] == ("dryrun_results", "torch")
    assert dryrun._cell_name("minitron-4b", "train_4k", True, "async") == \
        "minitron-4b__train_4k__2x16x16__async.json"


def test_local_shape_takes_rank_zeros_chunk():
    from types import SimpleNamespace
    from torch.distributed.tensor import Replicate, Shard
    m = SimpleNamespace(size=lambda i: (16, 16)[i])
    # 8 kv heads over 16: rank 0 holds one (torch.chunk), XLA pads to one
    assert dryrun.local_shape((128, 8, 32768, 112), [Shard(0), Shard(2)],
                              m) == [8, 8, 2048, 112]
    assert dryrun.local_shape((10,), [Shard(0), Shard(0)], m) == [1]
    assert dryrun.local_shape((10, 3), [Replicate(), Replicate()], m) == \
        [10, 3]


def test_a_placed_mamba2_layer_splits_its_flops_over_the_ranks():
    """A reduced hybrid (8 heads, ``seq_shard``) on a fake ``(data=2,
    model=4)`` world: rank 0's flops over one Mamba2 layer's forward and
    backward, times the 8 ranks, within 10% of the unsharded layer's (each
    rank runs its batch rows on its 2 heads; ``B`` and ``C`` are computed
    whole on every rank), where the layer's weights gathered whole on
    every model rank would make it 4x."""
    res = run_py("""
        import json
        import torch
        from torch import nn
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch import configs
        from repro_torch.launch import dryrun
        from repro_torch.nn import param as pm
        from repro_torch.nn import transformer
        from repro_torch.train import trainer

        cfg = configs.reduced(configs.get("zamba2-1.2b"), d_model=256,
                              seq_shard=True, ssm_chunk=16)
        lm = transformer.init_params(cfg, pm.META)
        names = [k for k, _ in lm.named_parameters()
                 if k.startswith("mamba_blocks.0.0.")]
        specs = transformer.param_specs(cfg)

        def flops(mesh):
            counter = (dryrun.LocalFlopCounter if mesh else FlopCounterMode)
            with FakeTensorMode(allow_non_fake_inputs=True):
                x = torch.randn(8, 64, cfg.d_model, requires_grad=True)
                tree = {k: torch.randn(dict(lm.named_parameters())[k].shape)
                        for k in names}
                if mesh is not None:
                    x = distribute_tensor(x.detach(), mesh, trainer.placements(
                        trainer.resolve_spec(transformer.RESIDUAL, mesh, cfg),
                        mesh)).requires_grad_()
                    tree = trainer.distribute(tree, mesh, {
                        k: trainer.placements(trainer.resolve_spec(
                            specs[k], mesh, cfg), mesh) for k in names})
                own = {k[len("mamba_blocks.0.0."):]: nn.Parameter(v)
                       for k, v in tree.items()}
                layer = transformer.MixerBlock("mamba", nn.ParameterDict(
                    {k[len("mamba."):]: v for k, v in own.items()
                     if k != "norm"}), own["norm"])
                shard = trainer.make_shard_fn(mesh, cfg)
                with counter(display=False) as c:
                    y, _ = transformer.mamba_layer(x, layer, cfg, shard=shard)
                    y.sum().backward()
            return c.get_total_flops()

        plain = flops(None)
        with dryrun.fake_world(8):
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            rank = flops(mesh)
        print(json.dumps({"plain": plain, "rank": rank}))
    """, timeout=120)
    ratio = res["rank"] * 8 / res["plain"]
    assert abs(ratio - 1) <= 0.10, ratio
