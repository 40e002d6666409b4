"""The port's mesh state on a ``gloo`` world of 4 on the CPU: placing
batches, re-placing a live state, and checkpoints across meshes.

As in ``tests/test_torch_mesh.py`` (whose helpers this file shares), each
test runs one world in its own subprocess (``tests/torch_mesh_ranks.py``)
with its own time limit:

* ``TokenPipeline(mesh=...)``: each rank moves its own rows, and the
  assembled batches equal the reference's for the same seed;
* ``elastic_rescale`` and a checkpoint saved on ``(2, 2)``, restored onto
  ``(4, 1)`` and onto one device, values unchanged;
* ``ResilientLoop`` with a failing step: every rank restores the step
  rank 0 published last, and the ranks end with one state.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline

from test_torch_mesh import _model, _world


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_token_pipeline_on_a_mesh_assembles_the_references_batch(tmp_path):
    out = _world("pipeline", {}, tmp_path, timeout=90)
    want = iter(jpipeline.TokenPipeline(vocab=100, seq=16, global_batch=8,
                                        seed=3))
    want = [next(want) for _ in range(2)]
    for names, got in out.items():
        for mine, theirs in zip(got["batches"], want):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(mine[k].numpy(),
                                              np.asarray(theirs[k]))
        # each rank moved its own rows: 8 over the batch axes' 2 or 4 ranks
        assert got["local_rows"] == (4 if names == ("data", "model") else 2)
        assert got["placements"][-1] == "Replicate()"


def test_elastic_rescale_and_a_checkpoint_reshard_across_meshes(tmp_path):
    _, _, cfg, params = _model("minitron-4b")
    out = _world("rescale", {"params": params}, tmp_path, timeout=90)
    host = out["host"]
    for key in ("on41", "alone", "restored41", "restored1"):
        for k, v in host["params"].items():
            assert torch.equal(out[key]["params"][k], v), (key, k)
        assert int(out[key]["opt"]["step"]) == int(host["opt"]["step"])
    assert out["steps"] == [7, 7]
    wq = params["layers.0.attn.wq"].shape
    # (4, 1): wq's columns over a model axis of 1, whole on every rank
    assert out["on41_local"] == out["r41_local"] == list(wq)
    assert out["on41_placements"] == ["Replicate()", "Shard(dim=1)"]
    assert out["alone_types"] == ["Tensor"]


def test_resilient_loop_restores_one_step_on_every_rank(tmp_path):
    """Checkpoints every 2 steps, a failure at step 3 on every rank: rank
    0's writer may still hold step 2 when the others fail, and each rank
    must restore step 2 all the same, then replay to one state."""
    out = _world("resilient", {"rows": 1 << 13, "steps": 6}, tmp_path,
                 timeout=90)
    want = [("step", 0), ("step", 1), ("step", 2), ("restart", 2),
            ("step", 3), ("step", 4), ("step", 5)]
    for rank in out["ranks"]:
        assert rank["history"] == want
        # batches 1, 2, 3; batch 4 lost with the failed step; then 5, 6, 7
        assert rank["w"] == 1 + 2 + 3 + 5 + 6 + 7
