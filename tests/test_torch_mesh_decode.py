"""Decode on the port's mesh: a ``gloo`` world of 4 on the CPU.

As in ``tests/test_torch_mesh.py`` (whose helpers this file shares), each
test runs one world in its own subprocess (``tests/torch_mesh_ranks.py``)
with its own time limit: eight decode ticks of reduced minitron-4b,
zamba2-1.2b and xlstm-1.3b on ``(data=2, model=2)``, the caches sharded
by their specs (KV on the sequence over ``"model"``, Mamba2's states on
their heads, the mLSTM's on its key dim) and written in place, where they
stay from tick to tick, against the reference's mesh-less ``decode_step``
on the same parameters and tokens (the port's tolerance against the
reference, ``tests/test_torch_lm.py``; the reduced xLSTM's logits by
relative L2, as ``tests/test_torch_families.py`` holds that stiff model),
and against the port's mesh-less decode (the mesh's own tolerance; the
reduced xLSTM's logits and caches by relative L2 again, since the mesh sums
its key dim in another order and the model amplifies the rounding).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import decode as jdecode

from repro_torch.nn import decode, transformer
from repro_torch.train import trainer

from test_torch_mesh import MESH_TOL, _close_tree, _model, _world

#: the port against the reference, fp32 (``tests/test_torch_lm.py``)
REF_TOL = dict(rtol=1e-4, atol=1e-4)
#: the reduced xLSTM against the reference: relative L2 (its fp32 rounding
#: grows from layer to layer in the reference itself; the port's mesh-less
#: decode stands 5.7e-4 apart elementwise on these ticks), as
#: ``tests/test_torch_families.py`` holds its hidden states
STIFF_L2 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_decode_on_a_2x2_mesh_matches_the_meshless_decode(arch, tmp_path):
    """Eight ticks with the caches sharded (KV on the sequence over
    "model", Mamba2's states on their heads) and written in place: the
    logits against the reference's decode, and logits and caches against
    the port's mesh-less decode."""
    jcfg, jparams, cfg, params = _model(arch)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (4, 8)).astype(np.int64))
    out = _world("decode", {"arch": arch, "params": params,
                            "tokens": tokens, "max_len": 16},
                 tmp_path, timeout=120)
    lm = transformer.LM.from_tree(params)
    cache = decode.init_cache(cfg, 4, 16, device="cpu")
    want = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            logits, cache = decode.decode_step(lm, cfg, cache,
                                               {"tokens": tokens[:, t:t + 1]},
                                               t)
            want.append(logits)
    jcache, _ = jdecode.init_cache(jcfg, 4, 16)
    jstep = jax.jit(lambda p, c, t, i: jdecode.decode_step(
        p, jcfg, c, {"tokens": t}, i))
    ref = []
    for t in range(tokens.shape[1]):
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray(tokens[:, t:t + 1].numpy(),
                                            dtype=jnp.int32), jnp.int32(t))
        ref.append(np.asarray(jlogits))
    if cfg.family == "ssm":   # the stiff model: relative L2, each tick
        for tick, jtick in zip(out["logits"].numpy(), ref):
            assert np.linalg.norm(tick - jtick) <= STIFF_L2 * np.linalg.norm(
                jtick)
    else:
        np.testing.assert_allclose(out["logits"].numpy(), np.stack(ref),
                                   **REF_TOL)
    if cfg.family == "ssm":   # the mesh's other summation order, normwise
        for k, got in {"logits": out["logits"], **out["cache"]}.items():
            mine = torch.stack(want) if k == "logits" else cache[k]
            assert torch.linalg.norm(got - mine) <= STIFF_L2 * \
                torch.linalg.norm(mine), k
    else:
        np.testing.assert_allclose(out["logits"].numpy(),
                                   torch.stack(want).numpy(), **MESH_TOL)
        _close_tree(out["cache"], cache, MESH_TOL)
    # every cache leaf ends the ticks on its spec's placements
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    want = trainer.resolve_tree(decode.cache_specs(cfg), mesh, cfg)
    assert out["cache_placements"] == {k: [repr(x) for x in v]
                                       for k, v in want.items()}
    if cfg.family != "ssm":
        kv = "attn_k" if cfg.family == "hybrid" else "k"
        assert out["cache_placements"][kv][-1] == "Shard(dim=3)"
