"""Parity of the port's LM training path with the JAX reference, on the CPU.

The same seeded numpy inputs, and the same parameters (the reference's
``jax.random.PRNGKey(0)`` tree carried across by ``convert``), go through
the JAX functions and the port's on ``device="cpu"``, where attention runs
the ``flash_attn`` family's plain version and its plain backward
(``chip_smoke.py`` holds the CUDA kernel against them on the card).  The
configs are ``configs.reduced`` danube (windowed, gated) and minitron
(squared-ReLU): fp32, 2 layers, d 64.  Tolerances: losses and gradients
``rtol=1e-4, atol=1e-5``; optimizer steps and compression, fp32 arithmetic
in the same order, ``rtol=1e-6, atol=1e-7``; trajectories
``rtol=1e-4, atol=1e-4``.  The reference's own ``test_train_infra.py``
cases for these modules run here as port twins.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.launch import train as jlaunch
from repro.nn import attention as jattention
from repro.nn import layers as jlayers
from repro.nn import transformer as jtransformer
from repro.optim import clip as jclip
from repro.optim import compress as jcompress
from repro.optim import schedules as jschedules
from repro.optim.adam import adam as jmake_adam
from repro.optim.sgd import apply_updates as japply_updates
from repro.optim.sgd import sgd as jmake_sgd
from repro.optim.sgd import sgd_momentum as jsgd_momentum
from repro.train import fault as jfault
from repro.train import trainer as jtrainer
from repro.utils import tree as jtree

from repro_torch import configs, convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.flash_attn import ref as attn_ref
from repro_torch.launch import train as launch_train
from repro_torch.nn import layers, transformer
from repro_torch.optim import clip, compress, schedules
from repro_torch.optim.adam import adam as make_adam
from repro_torch.optim.sgd import apply_updates, sgd as make_sgd, sgd_momentum
from repro_torch.train import fault, trainer
from repro_torch.utils import tree

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=1e-6, atol=1e-7)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("h2o-danube-1.8b", "minitron-4b")
BATCH, SEQ = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' ops are too small to split across threads: a
    team of intra-op threads only adds its start and wait to each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _np(t):
    return tree.tree_map(lambda x: x.detach().numpy(), t)


def _torch(a):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), a)


def _jax(a):
    return tree.tree_map(jnp.asarray, a)


def _close_trees(got: dict, want: dict, tol):
    """Port and reference trees of one structure, leaf by leaf."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced fp32 model: (jax cfg, jax params, port cfg, port tree)."""
    jcfg = jconfigs.reduced(jconfigs.get(request.param))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get(request.param))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")
    return jcfg, jparams, cfg, {k: v.detach() for k, v in
                                lm.named_parameters()}


def _batch(vocab, b=BATCH, s=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


# ---------------------------------------------------------------------------
# Tree helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tree_add", "tree_sub", "tree_scale",
                                  "tree_axpy", "tree_mean", "tree_zeros_like",
                                  "tree_count", "tree_bytes", "tree_l2norm",
                                  "tree_cast"])
def test_tree_helpers_match_reference(name, rng):
    # keys in sorted order: jax.tree flattens a dict by sorted key
    a = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
         "n": {"b": rng.normal(0, 1, 5).astype(np.float32),
               "i": np.arange(3, dtype=np.int32)}}
    b = tree.tree_map(lambda x: (x * 2 + 1).astype(x.dtype), a)
    args = {"tree_add": (a, b), "tree_sub": (a, b), "tree_scale": (a, 0.5),
            "tree_axpy": (0.25, a, b), "tree_mean": ([a, b, a],),
            "tree_zeros_like": (a,), "tree_count": (a,), "tree_bytes": (a,),
            "tree_l2norm": (a,), "tree_cast": (a, "half")}[name]
    conv = {"half": (torch.float16, jnp.float16)}

    def port(x):
        if isinstance(x, (str, float)):
            return conv[x][0] if isinstance(x, str) else x
        return [_torch(t) for t in x] if isinstance(x, list) else _torch(x)

    def ref(x):
        if isinstance(x, (str, float)):
            return conv[x][1] if isinstance(x, str) else x
        return [_jax(t) for t in x] if isinstance(x, list) else _jax(x)

    got = getattr(tree, name)(*(port(x) for x in args))
    want = getattr(jtree, name)(*(ref(x) for x in args))
    if isinstance(want, int):
        assert got == want
        return
    got_l, want_l = tree.tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(g.numpy(), w, STEP_TOL)


# ---------------------------------------------------------------------------
# Optimizers, schedules, clipping
# ---------------------------------------------------------------------------

SCHEDULES = {
    "float": (lambda m: 0.1, lambda m: 0.1),
    "constant": (lambda m: m.constant(0.1), lambda m: m.constant(0.1)),
    "inverse_time": (lambda m: m.inverse_time(0.2, 0.5),
                     lambda m: m.inverse_time(0.2, 0.5)),
    "cosine": (lambda m: m.cosine(0.3, total_steps=5, warmup=1, floor=0.1),
               lambda m: m.cosine(0.3, total_steps=5, warmup=1, floor=0.1)),
}
OPTIMIZERS = {
    "sgd": (lambda lr: make_sgd(lr), lambda lr: jmake_sgd(lr)),
    "sgd_momentum": (lambda lr: sgd_momentum(lr, 0.8),
                     lambda lr: jsgd_momentum(lr, 0.8)),
    "adam": (lambda lr: make_adam(lr), lambda lr: jmake_adam(lr)),
}


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(opt, sched, rng):
    """Three steps of each optimizer under each schedule: updates, state
    and parameters against the reference's."""
    mine = OPTIMIZERS[opt][0](SCHEDULES[sched][0](schedules))
    theirs = OPTIMIZERS[opt][1](SCHEDULES[sched][1](jschedules))
    w = {"a": rng.normal(0, 1, (3, 5)).astype(np.float32),
         "b": rng.normal(0, 1, 7).astype(np.float32)}
    p, jp = _torch(w), _jax(w)
    state, jstate = mine.init(p), theirs.init(jp)
    for _ in range(3):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in w.items()}
        u, state = mine.update(_torch(g), state, p)
        ju, jstate = theirs.update(_jax(g), jstate, jp)
        p, jp = apply_updates(p, u), japply_updates(jp, ju)
        for k in w:
            _close(u[k], ju[k], STEP_TOL)
            _close(p[k], jp[k], STEP_TOL)
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert int(state["step"]) == int(jstate["step"]) == 3
    for key in set(state) - {"step"}:
        for k in w:
            _close(state[key][k], jstate[key][k], STEP_TOL)


def test_schedule_rate_promotes_bf16_updates_as_jax_does():
    g = {"w": torch.full((4,), 0.3, dtype=torch.bfloat16)}
    jg = {"w": jnp.full((4,), 0.3, dtype=jnp.bfloat16)}
    for lr, jlr in ((0.1, 0.1), (schedules.constant(0.1),
                                 jschedules.constant(0.1))):
        u, _ = make_sgd(lr).update(g, make_sgd(lr).init(g))
        ju, _ = jmake_sgd(jlr).update(jg, jmake_sgd(jlr).init(jg))
        assert str(u["w"].dtype).split(".")[-1] == str(ju["w"].dtype)
        _close(u["w"].float(), np.asarray(ju["w"], np.float32), STEP_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm, rng):
    g = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
         "b": {"c": rng.normal(0, 2, 9).astype(np.float32)}}
    got, norm = clip.clip_by_global_norm(_torch(g), max_norm)
    want, jnorm = jclip.clip_by_global_norm(_jax(g), max_norm)
    _close(norm, jnorm, STEP_TOL)
    _close(clip.global_norm(_torch(g)), jclip.global_norm(_jax(g)), STEP_TOL)
    _close_trees(got, want, STEP_TOL)


@pytest.mark.parametrize("opt_fn", [lambda: make_sgd(0.1),
                                    lambda: sgd_momentum(0.05),
                                    lambda: make_adam(0.1)],
                         ids=["sgd", "sgd_momentum", "adam"])
def test_optimizers_minimize_quadratic(opt_fn):
    w = {"a": torch.tensor([3.0, -2.0]), "b": torch.tensor([[1.5]])}
    opt = opt_fn()
    state = opt.init(w)
    for _ in range(100):
        grads = {k: 2 * v for k, v in w.items()}   # d/dw sum(w^2)
        u, state = opt.update(grads, state, w)
        w = apply_updates(w, u)
    assert sum(float(v.abs().sum()) for v in w.values()) < 0.05


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _ctree(rng):
    return {"a": rng.normal(0, 1, 300).astype(np.float32),
            "b": {"c": rng.normal(0, 1, (5, 7)).astype(np.float32)}}


def test_compress_tree_matches_reference_over_three_calls(rng):
    x = _ctree(rng)
    ef, jef = None, None
    for _ in range(3):
        qt, ef = compress.compress_tree(_torch(x), ef)
        jqt, jef = jcompress.compress_tree(_jax(x), jef)
        _close_trees(qt["q"], jqt["q"], dict(rtol=0, atol=0))
        _close_trees(qt["s"], jqt["s"], STEP_TOL)
        _close_trees(ef, jef, STEP_TOL)
        _close_trees(compress.decompress_tree(qt, _torch(x)),
                     jcompress.decompress_tree(jqt, _jax(x)), STEP_TOL)
    assert compress.compression_ratio(_torch(x)) == \
        jcompress.compression_ratio(_jax(x))


def test_compress_tree_single_pass_per_leaf(monkeypatch, rng):
    calls = {"n": 0}
    real = compress.quantize_leaf

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(compress, "quantize_leaf", counting)
    x = _torch(_ctree(rng))
    qt, ef = compress.compress_tree(x)
    assert calls["n"] == 2                       # exactly one pass per leaf
    deq = compress.decompress_tree(qt, x)
    for leaves in (qt["q"], qt["s"], ef, deq):
        assert set(leaves) == {"a", "b"} and set(leaves["b"]) == {"c"}
    for a, r, e in zip(tree.tree_leaves(x), tree.tree_leaves(deq),
                       tree.tree_leaves(ef)):
        _close(a - r, e.reshape(a.shape), dict(rtol=1e-5, atol=1e-6))


def test_error_feedback_reduces_bias(rng):
    x = {"w": torch.from_numpy(rng.normal(0, 1, 512).astype(np.float32))}
    ef, total = None, torch.zeros(512)
    for _ in range(20):
        qt, ef = compress.compress_tree(x, ef)
        total += compress.decompress_tree(qt, x)["w"]
    assert float((total - 20 * x["w"]).abs().max()) <= \
        float(ef["w"].abs().max()) + 1e-4


def test_compress_tree_error_feedback_unbiased_over_steps(rng):
    x = rng.normal(0, 1, 384).astype(np.float32)
    t_x = {"w": torch.from_numpy(x)}
    ef, total = None, np.zeros_like(x)
    for t in range(1, 31):
        qt, ef = compress.compress_tree(t_x, ef)
        total += compress.decompress_tree(qt, t_x)["w"].numpy()
        _close(t * x - total, ef["w"], dict(rtol=1e-4, atol=1e-4))
    assert np.max(np.abs(30 * x - total)) <= np.max(np.abs(x)) / 127 + 1e-5


@pytest.mark.parametrize("dtype,floor", [(torch.float32, 3.0),
                                         (torch.bfloat16, 1.9)])
def test_compression_ratio_of_a_tree(dtype, floor):
    t = {"w": torch.zeros(1 << 16, dtype=dtype)}
    assert compress.compression_ratio(t) > floor
    assert compress.compression_ratio(list(t.values())) == \
        compress.compression_ratio(t)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_token_batch_is_byte_identical():
    a = synthetic.token_batch(np.random.default_rng(7), 3, 11, 50)
    b = jsynthetic.token_batch(np.random.default_rng(7), 3, 11, 50)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_token_pipeline_and_shards_are_byte_identical():
    mine = iter(pipeline.TokenPipeline(vocab=100, seq=16, global_batch=4,
                                       seed=3, device="cpu"))
    theirs = iter(jpipeline.TokenPipeline(vocab=100, seq=16, global_batch=4,
                                          seed=3))
    for _ in range(3):
        a, b = next(mine), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32 and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    for n, shards, k in ((100, 4, 5), (37, 3, 0), (10, 5, 12)):
        for x, y in zip(pipeline.shard_with_halo(n, shards, k),
                        jpipeline.shard_with_halo(n, shards, k)):
            np.testing.assert_array_equal(x, y)
    X, y = np.arange(40.0).reshape(20, 2), np.arange(20.0)
    for (a, b), (c, d) in zip(pipeline.glm_shards(X, y, 3, 2),
                              jpipeline.glm_shards(X, y, 3, 2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_shard_with_halo_properties():
    shards = pipeline.shard_with_halo(100, 4, rep_k=5)
    assert all(len(s) == 30 for s in shards)
    base = np.concatenate([s[:25] for s in shards])
    assert sorted(base.tolist()) == list(range(100))
    np.testing.assert_array_equal(shards[0][-5:], np.arange(25, 30))
    np.testing.assert_array_equal(shards[3][-5:], np.arange(0, 5))


def test_token_pipeline_shapes():
    batch = next(iter(pipeline.TokenPipeline(vocab=100, seq=16,
                                             global_batch=4, device="cpu")))
    assert batch["tokens"].shape == batch["labels"].shape == (4, 16)
    assert int(batch["tokens"].max()) < 100


# ---------------------------------------------------------------------------
# Attention's gradient
# ---------------------------------------------------------------------------


def _attn_case(b, hq, hkv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for shape in (
        (b, hq, sq, hd), (b, hkv, sk, hd), (b, hkv, sk, hd), (b, hq, sq, hd))]


@pytest.mark.parametrize("causal,window,sq,sk,hq,hkv,hd", [
    (True, None, 600, 600, 4, 2, 16),    # two query chunks, the second ragged
    (True, 100, 600, 600, 4, 2, 16),     # the window slices each chunk's keys
    (True, 20, 40, 100, 4, 2, 16),       # queries end-aligned on longer keys
    (False, None, 48, 80, 4, 2, 16),
    # the families' head dims: rep 4 at hd 64, danube's window at hd 80,
    # rep 1 at hd 128 on ragged lengths
    (True, None, 600, 600, 4, 1, 64),
    (True, 100, 300, 300, 8, 2, 80),
    (True, None, 130, 201, 4, 4, 128),
    (True, 37, 77, 77, 4, 1, 80),        # lengths not multiples of 64
    (False, 20, 65, 130, 4, 2, 64),      # acausal window, ragged
    (False, None, 150, 70, 8, 2, 128),   # cross: Sq > Sk (vlm's call)
])
def test_flash_attention_grads_match_jax_chunked_attention(
        causal, window, sq, sk, hq, hkv, hd, monkeypatch):
    """Through the operator: on the CPU its backward is the family
    ``"flash_attn_bwd"``'s plain flavor, reached once a call."""
    calls = []
    plain = attn_ref.attention_bwd_ref
    monkeypatch.setattr(attn_ref, "attention_bwd_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    q, k, v, do = _attn_case(1, hq, hkv, sq, sk, hd)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    assert calls == [1]

    def f(q, k, v):
        return jnp.sum(jattention.chunked_attention(
            q, k, v, causal=causal, window=window, chunk_q=512) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, GRAD_TOL)


@pytest.mark.parametrize("causal,window,sq,sk,hq,hkv,hd", [
    (True, None, 70, 70, 4, 1, 16),     # causal, rep 4
    (True, 20, 60, 90, 4, 4, 32),       # a window, end-aligned, rep 1
    (False, None, 50, 30, 8, 2, 16),    # acausal cross: Sq > Sk, rep 4
    (False, 12, 40, 40, 4, 4, 8),       # an acausal window, rep 1
])
def test_saved_statistics_give_the_reference_gradients(
        causal, window, sq, sk, hq, hkv, hd):
    """The forward operator's log-sum-exp (base 2) is numpy's of the
    reference's scores, and the backward fed with it and with D =
    rowsum(dO o O) of the operator's output (the arithmetic of the
    ``"wgmma"`` and ``"simt_tiled"`` kernels) gives ``jax.grad`` of the
    reference's ``chunked_attention``."""
    q, k, v, do = _attn_case(1, hq, hkv, sq, sk, hd, seed=3)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse, _ = torch.ops.repro_torch.flash_attn(tq, tk, tv, causal,
                                                   window, None, None, True)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, hq // hkv, axis=1).astype(np.float64))
    qi = np.arange(sq)[:, None] + sk - sq
    kj = np.arange(sk)[None]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= kj <= qi
    if window is not None:
        vis &= qi - kj < window
    s = np.where(vis, s * hd ** -0.5, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    want_lse = (m[..., 0] + np.log(np.exp(s - m).sum(axis=-1))) / np.log(2)
    _close(lse, want_lse, GRAD_TOL)

    def attend(q, k, v):
        return jattention.chunked_attention(q, k, v, causal=causal,
                                            window=window, chunk_q=512)

    _close(out, attend(q, k, v), GRAD_TOL)
    want = jax.grad(lambda *x: jnp.sum(attend(*x) * do),
                    argnums=(0, 1, 2))(q, k, v)
    got = attn_ref.attention_bwd_ref(tq, tk, tv, tdo, causal=causal,
                                     window=window, lse=lse,
                                     dsum=(tdo * out).sum(-1))
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal,window,sq,sk,hq,hkv,hd", [
    (True, None, 70, 70, 4, 1, 16),     # causal, rep 4
    (True, 20, 60, 90, 4, 4, 32),       # a window, end-aligned, rep 1
    (False, None, 50, 30, 8, 2, 16),    # acausal cross: Sq > Sk, rep 4
])
def test_rounding_residual_restores_the_fp32_output_and_its_d(
        causal, window, sq, sk, hq, hkv, hd):
    """With bf16 operands the forward operator's ``out_lo`` is the rounding
    residual of its bf16 output: ``out + out_lo`` is the reference's fp32
    output (``chunked_attention`` on the same bf16 values) to 16 bits,
    where ``out`` alone is a bf16 step off, and D = rowsum(dO o (out +
    out_lo)), the ``"wgmma"`` backward's, is the reference's rowsum(dO o O)
    at GRAD_TOL."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _attn_case(1, hq, hkv, sq, sk, hd, seed=5))
    out, lse, lo = torch.ops.repro_torch.flash_attn(q, k, v, causal, window,
                                                    None, None, True)
    assert lo.shape == out.shape and lo.dtype == torch.bfloat16
    assert lse.shape == (1, hq, sq)
    want = np.asarray(jattention.chunked_attention(
        *(t.float().numpy() for t in (q, k, v)), causal=causal,
        window=window, chunk_q=512), dtype=np.float64)
    full = out.double() + lo.double()
    top = np.abs(want).max()
    err_full = float(np.abs(full.numpy() - want).max())
    err_out = float(np.abs(out.double().numpy() - want).max())
    assert err_full <= 2.0 ** -16 * top < err_out
    _close((do.float() * (out.float() + lo.float())).sum(-1),
           (do.double().numpy() * want).sum(-1), GRAD_TOL)


@pytest.mark.parametrize("causal,window,chunk", [
    (True, None, 7), (True, 5, 7), (True, 16, 64), (False, 9, 10),
    (False, None, 64)])
def test_attention_backward_alone_matches_autograd_of_the_plain_version(
        causal, window, chunk):
    q, k, v, do = (torch.from_numpy(x) for x in _attn_case(2, 6, 2, 30, 40,
                                                            8, seed=1))
    got = attn_ref.attention_bwd_ref(q, k, v, do, causal=causal,
                                     window=window, chunk=chunk)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attn_ref.attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


def test_attention_backward_in_bf16_keeps_the_operands_dtype():
    x16 = [torch.from_numpy(x).to(torch.bfloat16)
           for x in _attn_case(1, 4, 2, 64, 64, 16, seed=2)]
    want = attn_ref.attention_bwd_ref(*(x.float() for x in x16), window=24,
                                      chunk=16)
    got = attn_ref.attention_bwd_ref(*x16, window=24, chunk=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        # the products round S, P, dP and dS to bf16 (2^-9 each): the limit
        # chip_smoke holds the backward to at danube's training shape
        assert float((g.float() - w).abs().max()) <= \
            2 ** -6 * float(w.abs().max())


def test_attention_backward_restores_the_tf32_switches(monkeypatch):
    """The backward runs its products in full fp32 on the card and hands
    the caller's TF32 switches back as it found them.  (On the CPU
    ``plain_fp32`` sets nothing, so it is made to set them here.)"""
    def off(t):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(common, "plain_fp32", off)
    q, k, v, do = map(torch.from_numpy, _attn_case(1, 4, 2, 8, 8, 8))
    attn_ref.attention_bwd_ref(q, k, v, do, window=4)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_flash_attention_without_grad_mode_makes_no_graph():
    q, k, v, _ = (torch.from_numpy(x) for x in _attn_case(1, 2, 2, 8, 8, 8))
    q.requires_grad_()
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_softmax_xent_and_grads_match_jax(chunk, rng):
    h = rng.normal(0, 1, (2, 32, 64)).astype(np.float32)
    emb = rng.normal(0, 0.125, (256, 64)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 32)).astype(np.int32)
    th, temb = (torch.from_numpy(x).requires_grad_() for x in (h, emb))
    loss = layers.chunked_softmax_xent(th, temb, torch.from_numpy(labels),
                                       chunk=chunk)
    loss.backward()
    want, (gh, gemb) = jax.value_and_grad(
        lambda h, e: jlayers.chunked_softmax_xent(h, e, labels, chunk=chunk),
        argnums=(0, 1))(h, emb)
    _close(loss.detach(), want, GRAD_TOL)
    _close(th.grad, gh, GRAD_TOL)
    _close(temb.grad, gemb, GRAD_TOL)
    with pytest.raises(AssertionError):
        layers.chunked_softmax_xent(th, temb, torch.from_numpy(labels),
                                    chunk=12)


def test_loss_fn_and_every_gradient_match_jax(model):
    jcfg, jparams, cfg, params = model
    batch = _batch(cfg.vocab)
    loss, grads = trainer.value_and_grad(cfg, params, _torch(batch))
    jloss, jgrads = jax.value_and_grad(jtransformer.loss_fn)(
        jparams, jcfg, _jax(batch))
    _close(loss, jloss, GRAD_TOL)
    _close_trees(convert.lm_params_to_reference(grads, cfg), jgrads, GRAD_TOL)
    # the trainable module differentiates to the same leaves: the tied
    # embedding's gradient sums the gather's and the unembedding's
    lm = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu", trainable=True)
    transformer.loss_fn(lm, cfg, _torch(batch)).backward()
    _close_trees(convert.lm_params_to_reference(
        {k: p.grad for k, p in lm.named_parameters()}, cfg), jgrads, GRAD_TOL)


def test_trainable_flag_and_serving_default():
    """Serving's parameters do not require grad; ``requires_grad_()`` and
    ``convert``'s ``trainable`` turn it on; ``LM.from_tree`` makes leaves
    that require grad over the tree's own storage, in its order."""
    cfg = configs.reduced(configs.get("h2o-danube-1.8b"))
    lm = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in lm.parameters())
    ref = convert.lm_params_to_reference(lm, cfg)
    for trainable in (False, True):
        lm = convert.lm_params_from_reference(ref, cfg, device="cpu",
                                              trainable=trainable)
        assert all(p.requires_grad == trainable for p in lm.parameters())
    lm.requires_grad_(False).requires_grad_()
    assert all(p.requires_grad for p in lm.parameters())
    tree = {k: v.detach() for k, v in lm.named_parameters()}
    again = dict(transformer.LM.from_tree(tree).named_parameters())
    assert list(again) == list(tree)
    for k, p in again.items():
        assert p.is_leaf and p.requires_grad
        assert p.data_ptr() == tree[k].data_ptr()


def test_parameter_tree_roundtrips_through_the_reference_layout(model):
    jcfg, jparams, cfg, params = model
    back = convert.lm_params_to_reference(params, cfg)
    _close_trees(back, jparams, dict(rtol=0, atol=0))
    lm = convert.lm_params_from_reference(back, cfg, device="cpu")
    for k, v in lm.named_parameters():
        assert torch.equal(v, params[k])


def test_prefill_step_matches_reference(model):
    jcfg, jparams, cfg, params = model
    toks = _batch(cfg.vocab, b=2, s=8)["tokens"]
    logits, cache = trainer.make_prefill_step(cfg)(
        transformer.LM.from_tree(params).requires_grad_(False),
        {"tokens": _torch(toks)})
    jlogits, jcache = jtrainer.make_prefill_step(jcfg, None)(
        jparams, {"tokens": jnp.asarray(toks)})
    _close(logits, jlogits, TRAJ_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], TRAJ_TOL)


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_sync_step_matches_reference(model, micro_batches):
    jcfg, jparams, cfg, params = model
    batch = _batch(cfg.vocab, seed=micro_batches)
    step = trainer.make_sync_step(cfg, make_sgd(0.1),
                                  micro_batches=micro_batches)
    jstep = jtrainer.make_sync_step(jcfg, None, jmake_sgd(0.1), None,
                                    micro_batches=micro_batches)
    p, o, loss = step(params, make_sgd(0.1).init(params), _torch(batch))
    jp, jo, jloss = jstep(jparams, jmake_sgd(0.1).init(jparams), _jax(batch))
    _close(loss, jloss, GRAD_TOL)
    assert int(o["step"]) == int(jo["step"]) == 1
    _close_trees(convert.lm_params_to_reference(p, cfg), jp, GRAD_TOL)


def test_async_local_step_and_both_merges_match_reference(model, rng):
    """Two replicas drifted apart, one local step each, the mean merge,
    then three compressed merges with the anchor and the error feedback
    carried from merge to merge."""
    jcfg, jparams, cfg, params = model
    R = 2
    drift = {k: rng.normal(0, 0.01, v.shape).astype(np.float32)
             for k, v in params.items()}
    params_r = {k: torch.stack([v, v + torch.from_numpy(drift[k])])
                for k, v in params.items()}
    jdrift = convert.lm_params_to_reference(_torch(drift), cfg)
    jparams_r = jax.tree.map(lambda x, d: jnp.stack([x, x + d]), jparams,
                             jdrift)
    opt, jopt = make_sgd(0.1), jmake_sgd(0.1)
    local, merge = trainer.make_async_local_step(cfg, opt)
    _, cmerge = trainer.make_async_local_step(cfg, opt, compress_merge=True)
    jlocal, jmerge = jtrainer.make_async_local_step(jcfg, None, jopt, None)
    _, jcmerge = jtrainer.make_async_local_step(jcfg, None, jopt, None,
                                                compress_merge=True)
    jlocal = jax.jit(jlocal)   # eager merges: fp32 ops in the port's order
    batch = _batch(cfg.vocab, seed=5)
    batch_r = {k: v.reshape(R, BATCH // R, SEQ) for k, v in batch.items()}

    def as_ref(tree_r):
        return jax.tree.map(lambda *xs: np.stack(xs), *[
            convert.lm_params_to_reference(trainer.replica(tree_r, r), cfg)
            for r in range(R)])

    p, o, losses = local(params_r, trainer.stack_replicas(
        [opt.init(trainer.replica(params_r, r)) for r in range(R)]),
        _torch(batch_r))
    jp, jo, jlosses = jlocal(jparams_r, jax.vmap(jopt.init)(jparams_r),
                             _jax(batch_r))
    _close(losses, jlosses, GRAD_TOL)
    assert o["step"].tolist() == np.asarray(jo["step"]).tolist() == [1, 1]
    _close_trees(as_ref(p), jp, GRAD_TOL)

    # the merges hold the reference's merge_step on the port's tree: it
    # keeps a leaf per layer where the reference stacks the layers, and
    # the int8 blocks run over each leaf; the same replicas go in, so no
    # code can differ by a rounding tie
    merged, _, _ = merge(p)
    jmerged, _, _ = jmerge(_jax(_np(p)))
    _close_trees(merged, jmerged, GRAD_TOL)
    for v in merged.values():
        assert torch.equal(v[0], v[1])

    cur, anchor, ef = p, params, None
    jcur, janchor, jef = _jax(_np(p)), _jax(_np(params)), None
    for _ in range(3):
        cur, anchor, ef = cmerge(cur, anchor, ef)
        jcur, janchor, jef = jcmerge(jcur, janchor, jef)
        for mine, theirs in ((cur, jcur), (anchor, janchor), (ef, jef)):
            _close_trees(mine, theirs, STEP_TOL)
        for v in cur.values():
            assert torch.equal(v[0], v[1])


def test_async_local_merge_preserves_replica_mean(model):
    _, _, cfg, params = model
    _, merge = trainer.make_async_local_step(cfg, make_sgd(0.1))
    stacked = {k: torch.stack([x, x + 0.01]) for k, x in params.items()}
    merged, _, _ = merge(stacked)
    for k, m in merged.items():
        _close(m[0], stacked[k].mean(0), dict(rtol=1e-2, atol=1e-4))
        assert torch.equal(m[0], m[1])


def test_compressed_merge_tracks_mean(model, rng):
    _, _, cfg, params = model
    _, merge = trainer.make_async_local_step(cfg, make_sgd(0.1),
                                             compress_merge=True)
    drift = {k: torch.from_numpy(rng.normal(0, 0.01, x.shape)
                                 .astype(np.float32)) for k, x in params.items()}
    stacked = {k: torch.stack([x + drift[k], x - drift[k]])
               for k, x in params.items()}
    anchor, ef = params, None
    for _ in range(3):
        stacked, anchor, ef = merge(stacked, anchor, ef)
        for m in stacked.values():
            assert torch.equal(m[0], m[1])
    for k, m in stacked.items():
        assert float((m[0] - params[k]).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# Checkpoints and the resilient loop
# ---------------------------------------------------------------------------


def _ckpt_tree(rng):
    return {"a": torch.from_numpy(rng.normal(0, 1, (8, 4)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(0, 1, 3)).to(torch.bfloat16),
                  "d": torch.tensor([7], dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path, rng):
    t = _ckpt_tree(rng)
    save_checkpoint(tmp_path, 5, t)
    restored, step = load_checkpoint(tmp_path, tree.tree_zeros_like(t))
    assert step == 5
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_format_is_the_references_both_ways(tmp_path, rng):
    t = _ckpt_tree(rng)
    save_checkpoint(tmp_path / "port", 3, t)
    like = {"a": jnp.zeros((8, 4)), "b": {"c": jnp.zeros(3, jnp.bfloat16),
                                          "d": jnp.zeros(1, jnp.int32)}}
    theirs, step = jckpt.load_checkpoint(tmp_path / "port", like)
    assert step == 3
    for a, b in zip(tree.tree_leaves(t), jax.tree.leaves(theirs)):
        assert str(b.dtype) == str(a.dtype).split(".")[-1]
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    jckpt.save_checkpoint(tmp_path / "ref", 4, theirs)
    mine, step = load_checkpoint(tmp_path / "ref", tree.tree_zeros_like(t))
    assert step == 4
    for a, b in zip(tree.tree_leaves(t), tree.tree_leaves(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k(tmp_path):
    t = {"x": torch.zeros(3)}
    for s in range(6):
        save_checkpoint(tmp_path, s, t, keep=2)
    assert latest_step(tmp_path) == 5
    assert len(list(tmp_path.glob("step_*"))) == 2


def test_checkpoint_manager_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, every=2)
    t = {"x": torch.arange(4.0)}
    assert not mgr.maybe_save(1, t)
    assert mgr.maybe_save(2, t)
    mgr.wait()
    assert latest_step(tmp_path) == 2


def test_resilient_loop_restart(tmp_path):
    def step(state, batch):
        return state + batch, {"v": float(state)}

    fired = {"done": False}

    def failure(s):
        if s == 5 and not fired["done"]:
            fired["done"] = True
            return True
        return False

    loop = fault.ResilientLoop(step, CheckpointManager(tmp_path, every=2),
                               torch.zeros(()), resume=False,
                               failure_hook=failure)
    state, history = loop.run(iter(lambda: torch.ones(()), None), 8)
    kinds = [h[0] for h in history]
    assert kinds.count("restart") == 1 and kinds.count("step") >= 6
    # whichever checkpoint it restored (step 4's, or step 2's if the
    # writer had not finished), the replay ends where an unbroken run does
    assert float(state) == 8.0


def test_resilient_loop_restores_a_save_still_being_written(tmp_path,
                                                          monkeypatch):
    """A failure right after a save: the loop waits for the writer thread
    and restores that save, not an older one or none."""
    import repro_torch.checkpoint.checkpoint as ckpt_mod
    real = ckpt_mod.save_checkpoint

    def slow(*args, **kwargs):
        time.sleep(0.3)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow)
    fired = []

    def failure(s):
        if s == 1 and not fired:
            fired.append(s)
            return True
        return False

    loop = fault.ResilientLoop(lambda s, b: (s + b, {}),
                               CheckpointManager(tmp_path, every=10),
                               torch.zeros(()), resume=False,
                               failure_hook=failure)
    state, history = loop.run(iter(lambda: torch.ones(()), None), 4)
    assert [h[:2] for h in history] == [("step", 0), ("restart", 0),
                                        ("step", 1), ("step", 2), ("step", 3)]
    assert float(state) == 4.0


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_runs_on_cuda_unless_told():
    assert launch_train.parse_args([]).device is None
    assert common.device(launch_train.parse_args([]).device).type == "cuda"
    assert launch_train.parse_args(["--device", "cpu"]).device == "cpu"


def test_launcher_batches_match_the_references():
    cfg = configs.reduced(configs.get("minitron-4b"))
    jcfg = jconfigs.reduced(jconfigs.get("minitron-4b"))
    mine = launch_train.make_batch_fn(cfg, 3, 9, seed=4, device="cpu")
    theirs = jlaunch.make_batch_fn(jcfg, 3, 9, seed=4)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("extra", [
    [], ["--update", "async", "--merge-every", "2"],
    ["--inject-failure-at", "3"]],
    ids=["sync", "async", "restart"])
def test_launcher_trajectory_matches_reference(extra, tmp_path):
    """Eight steps of the reduced danube through each launcher, from the
    reference's PRNGKey(0) weights: loss for loss.  The restart restores
    step 0's checkpoint (the only one at the default ``--ckpt-every``),
    written three steps before the failure."""
    argv = ["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "8",
            "--lr", "0.3", *extra]
    want = jlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    args = launch_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "t"),
                                           "--device", "cpu"])
    jcfg = jconfigs.reduced(jconfigs.get("h2o-danube-1.8b"))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, loop, batches = launch_train.setup(
        args, params=convert.lm_params_from_reference(
            jax.tree.map(np.asarray, jparams), configs.reduced(
                configs.get("h2o-danube-1.8b")), device="cpu"))
    _, history = loop.run(batches, args.steps)
    got = launch_train.losses_of(history)
    assert len(got) == len(want)
    _close(got, want, TRAJ_TOL)
    assert [h[0] for h in history].count("restart") == \
        ("--inject-failure-at" in extra)
    assert got[-1] < got[0]


@pytest.mark.parametrize("lr,extra", [
    ("0.3", []), ("0.3", ["--update", "async", "--merge-every", "2"]),
    ("1.0", [])], ids=["sync-lr0.3", "async-lr0.3", "sync-lr1"])
def test_launcher_fresh_batch_trajectory_matches_reference(
        lr, extra, tmp_path, monkeypatch):
    """Without ``--smoke`` each step draws a fresh batch.  With both
    launchers' ``configs.get`` patched to the reduced danube, eight
    fresh-batch steps agree loss for loss, and so does the closing check:
    at lr 0.3 the reference's own fresh-batch loss rises and its assert
    fires, at lr 1 it falls."""
    name = "h2o-danube-1.8b"
    monkeypatch.setattr(jconfigs, "get", lambda n, get=jconfigs.get:
                        jconfigs.reduced(get(n)))
    monkeypatch.setattr(configs, "get", lambda n, get=configs.get:
                        configs.reduced(get(n)))
    histories = []
    run = jfault.ResilientLoop.run

    def recorded(self, *a, **kw):
        out = run(self, *a, **kw)
        histories.append(out[1])
        return out

    monkeypatch.setattr(jfault.ResilientLoop, "run", recorded)
    argv = ["--arch", name, "--steps", "8", "--lr", lr, *extra]
    try:
        jlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
        passed = True
    except AssertionError:
        passed = False
    want = [float(m["loss"]) for kind, _, m in histories[0] if kind == "step"]
    jparams, _ = jtransformer.init_params(jconfigs.get(name),
                                          jax.random.PRNGKey(0))
    args = launch_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "t"),
                                           "--device", "cpu"])
    cfg, loop, batches = launch_train.setup(
        args, params=convert.lm_params_from_reference(
            jax.tree.map(np.asarray, jparams), configs.get(name),
            device="cpu"))
    _, history = loop.run(batches, args.steps)
    got = launch_train.losses_of(history)
    assert cfg.n_layers == 2 and len(got) == len(want) == 8
    _close(got, want, TRAJ_TOL)
    assert (got[-1] < got[0]) == (want[-1] < want[0]) == passed
    assert passed == (lr == "1.0")


def test_launcher_main_trains_with_seeded_weights(tmp_path, capsys):
    losses = launch_train.main(["--arch", "minitron-4b", "--smoke", "--steps",
                                "4", "--device", "cpu", "--ckpt-dir",
                                str(tmp_path)])
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "restarts=0" in capsys.readouterr().out
    assert latest_step(tmp_path) == 0
