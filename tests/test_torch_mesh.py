"""The port's mesh on a ``gloo`` world of 4 on the CPU, against the JAX
reference and the port's mesh-less steps.

Each test runs one world in its own subprocess (``tests/torch_mesh_ranks.py``,
four ranks spawned by ``torch.multiprocessing`` and met at a
``FileStore``), with its own time limit, and holds what rank 0 returns:

* a sync step of reduced minitron-4b (``seq_shard=True``) on ``(data=2,
  model=2)`` against the reference's unsharded step on the same
  parameters and batch, at the JAX suite's gradient tolerance
  (``rtol=1e-4, atol=2e-3``);
* an async-local step and merge on ``(pod=2, data=1, model=2)`` against the
  port's mesh-less async step, and no collective of ``local_step`` joining
  ranks of both pods (``CommDebugMode``, the counterpart of the
  reference's "no pod-spanning collectives" in its HLO), where the merge
  crosses them.

``tests/test_torch_mesh_state.py`` holds the pipeline, ``elastic_rescale``
and checkpoints on such worlds, ``tests/test_torch_mesh_decode.py``
decode.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.nn import transformer as jtransformer
from repro.optim.sgd import sgd as jmake_sgd
from repro.train import trainer as jtrainer

from repro_torch import configs, convert
from repro_torch.nn import layers
from repro_torch.optim.sgd import sgd as make_sgd
from repro_torch.train import trainer

RANKS = Path(__file__).resolve().parent / "torch_mesh_ranks.py"
#: the JAX conformance suite's gradient tolerance
STEP_TOL = dict(rtol=1e-4, atol=2e-3)
#: the port's mesh-less step against the same step on a mesh: fp32, the
#: same arithmetic with partial sums reduced in another order (the port's
#: fp32 loss and gradient tolerance, ``tests/test_torch_train.py``)
MESH_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(case: str, inputs: dict, tmp_path: Path, timeout: float) -> dict:
    torch.save(inputs, tmp_path / "in.pt")
    r = subprocess.run([sys.executable, str(RANKS), case, str(tmp_path)],
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return torch.load(tmp_path / "out.pt")


def _model(arch: str, **kw):
    jcfg = jconfigs.reduced(jconfigs.get(arch), **kw)
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get(arch), **kw)
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")
    return jcfg, jparams, cfg, {k: v.detach() for k, v in
                                lm.named_parameters()}


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


def _close_tree(got: dict, want: dict, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **tol, err_msg=k)


def test_sync_step_on_a_2x2_mesh_matches_the_unsharded_reference(tmp_path):
    jcfg, jparams, cfg, params = _model("minitron-4b", seq_shard=True)
    batch = _batch(cfg.vocab, 8, 32, seed=11)
    out = _world("sync", {"params": params, "lr": LR,
                          "batch": {k: torch.from_numpy(v)
                                    for k, v in batch.items()}},
                 tmp_path, timeout=120)
    jstep = jtrainer.make_sync_step(jcfg, None, jmake_sgd(LR), None)
    jp, jo, jloss = jstep(jparams, jmake_sgd(LR).init(jparams),
                          jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(out["loss"]), float(jloss), **STEP_TOL)
    assert int(out["step"]) == int(jo["step"]) == 1
    mine = convert.lm_params_to_reference(out["params"], cfg)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = mine
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   **STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the parameters leave the step on their specs' placements
    assert out["placements"]["layers.0.attn.wq"] == ["Replicate()",
                                                     "Shard(dim=1)"]
    assert out["placements"]["embed"] == ["Replicate()", "Shard(dim=0)"]


def test_async_local_step_on_a_pod_mesh_matches_the_meshless_step(tmp_path):
    _, _, cfg, params = _model("minitron-4b")
    rng = np.random.default_rng(5)
    params_r = {k: torch.stack([v, v + torch.from_numpy(rng.normal(
        0, 0.01, v.shape).astype(np.float32))]) for k, v in params.items()}
    batch = _batch(cfg.vocab, 4, 32, seed=6)
    batch_r = {k: torch.from_numpy(v.reshape(2, 2, 32))
               for k, v in batch.items()}
    out = _world("async", {"params_r": params_r, "batch_r": batch_r,
                           "lr": LR}, tmp_path, timeout=120)
    opt = make_sgd(LR)
    local, merge = trainer.make_async_local_step(cfg, opt)
    state = trainer.stack_replicas([opt.init(trainer.replica(params_r, r))
                                    for r in range(2)])
    p, o, losses = local(params_r, state, batch_r)
    merged, _, _ = merge(p)
    np.testing.assert_allclose(out["losses"].numpy(), losses.numpy(),
                               **MESH_TOL)
    assert out["step"].tolist() == o["step"].tolist() == [1, 1]
    _close_tree(out["params"], p, MESH_TOL)
    _close_tree(out["merged"], merged, MESH_TOL)
    # local_step talks inside a pod only; the merge is what crosses pods
    pods = [set(range(0, 2)), set(range(2, 4))]
    assert out["local_groups"], "the local step ran no collective"
    for op, ranks in out["local_groups"]:
        assert any(set(ranks) <= pod for pod in pods), (op, ranks)
    assert any(not any(set(ranks) <= pod for pod in pods)
               for _, ranks in out["merge_groups"])


def test_loss_on_a_vocab_sharded_mesh_takes_the_gold_logit_by_a_mask(
        tmp_path):
    """The chunked loss on (data=2, model=2), the logits' vocab on
    ``"model"``: loss and gradients as the mesh-less loss's, with the
    normaliser and the gold logit (by a mask) taken on each rank's vocab
    shard, so no rank holds more of a chunk's logits than its own quarter:
    ``torch.gather``'s backward made the global ``[B, chunk, V]`` block on
    every rank (DTensor's ``new_zeros`` replicates), ``logsumexp`` the
    rank's rows over the whole vocab."""
    rng = np.random.default_rng(4)
    b, s, dm, vocab, chunk = 4, 16, 8, 64, 8
    inp = {"h": torch.from_numpy(rng.normal(0, 1, (b, s, dm))
                                 .astype(np.float32)),
           "emb": torch.from_numpy(rng.normal(0, 1, (vocab, dm))
                                   .astype(np.float32)),
           "labels": torch.from_numpy(rng.integers(0, vocab, (b, s))
                                      .astype(np.int32))}
    out = _world("xent", inp, tmp_path, timeout=120)
    h, emb = (inp[k].clone().requires_grad_() for k in ("h", "emb"))
    loss = layers.chunked_softmax_xent(h, emb, inp["labels"], chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(out["loss"]), float(loss.detach()),
                               **MESH_TOL)
    for k, want in (("h_grad", h.grad), ("emb_grad", emb.grad)):
        np.testing.assert_allclose(out[k].numpy(), want.numpy(), **MESH_TOL,
                                   err_msg=k)
    assert not out["gather"]
    # a rank's largest tensor is its own quarter of a chunk's logits
    assert out["largest"] == b * chunk * vocab // 4
