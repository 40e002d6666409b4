"""The placed families on the port's mesh: a ``gloo`` world of 4 on the
CPU, against the JAX reference's unsharded step.

As in ``tests/test_torch_mesh.py`` (whose helpers this file shares), each
test runs one world in its own subprocess (``tests/torch_mesh_ranks.py``,
case ``family``): one sync step of a reduced family on a mesh, held to the
reference's unsharded step on the same parameters and batch at the JAX
suite's gradient tolerance (``rtol=1e-4, atol=2e-3``), the reduced xLSTM
by each leaf's update in relative L2 within 1e-3 (its fp32 rounding grows
from layer to layer in the reference itself: ``tests/test_torch_families.py``).
Each case also holds what every rank's share ran on:

* zamba2-1.2b (``seq_shard``) on ``(data=2, model=2)``: each Mamba2 scan
  on its 2 batch rows and 1 of the 2 heads;
* xlstm-1.3b on ``(data=2, model=2)`` and, with 2 heads that do not
  divide the model axis, on ``(data=1, model=4)``: each mLSTM recurrence
  on its slice of the key dim;
* olmoe-1b-7b's gathered strategy on ``(data=2, model=2)``: one group a
  rank against every expert;
* kimi-k2-1t-a32b's all-to-all strategy with ``fsdp=True`` on ``(data=2,
  model=2)``: no rank's expert operand holds more than ``E / model``
  experts, gathered on the FSDP dim;
* command-r-35b with ``fsdp=True`` on ``(pod=2, data=2, model=1)``: the
  FSDP entry ``("data", "pod")`` placed in mesh order, each rank's shard
  of the reference's order's size.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim.sgd import sgd as jmake_sgd
from repro.train import trainer as jtrainer

from repro_torch import convert

from test_torch_mesh import LR, STEP_TOL, _batch, _model, _world

#: the reduced xLSTM's whole-model rule: each leaf's relative L2 distance
#: (10x the gradient tolerance's rtol, ``tests/test_torch_families.py``)
STIFF_L2 = 1e-3
DATA_MODEL = ((2, 2), ("data", "model"))
#: arch, test id, config overrides (the same on both sides), mesh, batch,
#: sequence
CASES = {
    "zamba2": ("zamba2-1.2b", {"seq_shard": True}, DATA_MODEL, 4, 16),
    "xlstm": ("xlstm-1.3b", {}, DATA_MODEL, 4, 16),
    "xlstm-heads-do-not-divide": ("xlstm-1.3b", {"n_heads": 2},
                                  ((1, 4), ("data", "model")), 4, 16),
    # d_ff 16: the tokens outweigh the experts, the gathered strategy
    "olmoe-gathered": ("olmoe-1b-7b", {"d_ff": 16, "moe_groups": 2,
                                       "moe_model_shards": 2, "seq_shard":
                                       True}, DATA_MODEL, 4, 256),
    "kimi-all-to-all": ("kimi-k2-1t-a32b", {"fsdp": True, "moe_groups": 2,
                                            "moe_model_shards": 2,
                                            "seq_shard": True},
                        DATA_MODEL, 4, 16),
    "command-r-fsdp-pods": ("command-r-35b", {"fsdp": True},
                            ((2, 2, 1), ("pod", "data", "model")), 4, 16),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_step(jcfg, jparams, batch):
    jstep = jtrainer.make_sync_step(jcfg, None, jmake_sgd(LR), None)
    jp, jo, jloss = jstep(jparams, jmake_sgd(LR).init(jparams),
                          jax.tree.map(jnp.asarray, batch))
    return jax.tree_util.tree_flatten_with_path(jp)[0], jo, jloss


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree, np.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_family_sync_step_matches_the_unsharded_reference(case,
                                                                 tmp_path):
    arch, overrides, mesh, b, s = CASES[case]
    jcfg, jparams, cfg, params = _model(arch, **overrides)
    batch = _batch(cfg.vocab, b, s, seed=17)
    out = _world("family", {"arch": arch, "overrides": overrides,
                            "mesh": mesh, "params": params, "lr": LR,
                            "batch": {k: torch.from_numpy(v)
                                      for k, v in batch.items()}},
                 tmp_path, timeout=300)
    want, jo, jloss = _reference_step(jcfg, jparams, batch)
    np.testing.assert_allclose(float(out["loss"]), float(jloss), **STEP_TOL)
    assert int(out["step"]) == int(jo["step"]) == 1
    mine = convert.lm_params_to_reference(out["params"], cfg)
    before = convert.lm_params_to_reference(params, cfg)
    for path, w in want:
        name = jax.tree_util.keystr(path)
        got = _leaf(mine, path)
        if cfg.family == "ssm":   # the update, normwise
            moved, should = got - _leaf(before, path), \
                np.asarray(w, np.float64) - _leaf(before, path)
            assert np.linalg.norm(moved - should) <= STIFF_L2 * \
                np.linalg.norm(should), name
        else:
            np.testing.assert_allclose(got, np.asarray(w), **STEP_TOL,
                                       err_msg=name)
    _holds_its_share(case, cfg, mesh, out)


def _holds_its_share(case, cfg, mesh, out):
    (shape, names), shares = mesh, out["shares"]
    model = shape[names.index("model")]
    rows = 4 // (shape[names.index("data")]
                 * (shape[0] if "pod" in names else 1))
    if cfg.family == "hybrid":
        heads = 2 * cfg.d_model // 64
        for rank in shares:
            scans = [m for m in rank["mamba"] if not m["dtensor"]]
            assert scans, "no Mamba2 scan ran on local tensors"
            assert {(m["rows"], m["heads"]) for m in scans} == \
                {(rows, heads // model)}
    elif cfg.family == "ssm":
        hd = 2 * cfg.d_model // cfg.n_heads
        for rank in shares:
            assert rank["mlstm"]
            assert {(m["rows"], m["keys"]) for m in rank["mlstm"]} == \
                {(rows, hd // model)}
    elif cfg.family == "moe":
        n = cfg.moe_experts
        for rank in shares:
            assert rank["experts"], "no expert product ran"
            for e in rank["experts"]:
                if case == "olmoe-gathered":   # one group a rank, all experts
                    assert e["he"][0] == 1 and e["w"][0] == n
                    assert e["w_placements"] == ["Replicate()"] * 2
                else:   # all-to-all: E / model experts, whole in d and ff
                    assert e["w"][0] == e["he"][1] == n // model
                    assert e["w_placements"] == ["Replicate()",
                                                 "Shard(dim=0)"]
                    assert e["w"][1:] in ([cfg.d_model, cfg.d_ff],
                                          [cfg.d_ff, cfg.d_model])
    else:   # FSDP over ("data", "pod"): the reference order's shard sizes
        up = out["local_shapes"]["layers.0.ffn.w_up"]
        assert up == [cfg.d_model // 4, cfg.d_ff]
        assert out["placements"]["layers.0.ffn.w_up"] == [
            "Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"]
