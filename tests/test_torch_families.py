"""Parity of the port's LM families with the JAX reference, on the CPU.

Every architecture of ``configs.ARCH_NAMES`` at ``configs.reduced`` in
fp32 (the dense ones too, through the paths the other families share):
the reference's ``PRNGKey(0)`` tree carried across by
``convert.lm_params_from_reference``, the same seeded numpy inputs through
the JAX functions and the port's on ``device="cpu"``, where attention runs
the ``flash_attn`` family's plain version (``chip_smoke.py`` holds the CUDA
kernel against it on the card).  Tolerances: model outputs and caches
``MODEL_TOL`` (``rtol=1e-4, atol=1e-4``), gradients ``GRAD_TOL``
(``1e-4/1e-5``), launcher trajectories ``TRAJ_TOL`` (``1e-4/1e-4``).

The reduced xLSTM is the exception, and not the port's doing: its mLSTM
normalizer divides by ``max(|n . q|, 1)`` where ``n`` sums input gates up
to ``e^8``, so fp32 rounding grows from layer to layer (layer by layer the
port is within MODEL_TOL).  On these inputs the port stands 14x
MODEL_TOL from the reference in the hidden states and 19x in the prefill
caches (relative L2 1.6e-4 and at most 3.1e-4), and 364x GRAD_TOL in the
gradients (relative L2 at most 8.2e-4); the reference against itself,
only its ``ssm_chunk`` changed (8 to 16, the same function), stands 15x
GRAD_TOL apart (2.8e-5).  No fp32 implementation can meet even 10x the
elementwise tolerances there, so xLSTM's hidden states, prefill caches and
gradients are held normwise (:func:`_held_normwise`: relative L2 within
10x the rtol), its loss and decode at MODEL_TOL, its layers one by one at
MODEL_TOL, and its launcher run at the first step (the reference's own
run fails its falling-loss check there).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import modality_stubs as jstubs
from repro.launch import train as jlaunch
from repro.nn import attention as jattention
from repro.nn import decode as jdecode
from repro.nn import moe as jmoe
from repro.nn import ssm as jssm
from repro.nn import transformer as jtransformer
from repro.nn import xlstm as jxlstm
from repro.serve import engine as jengine
from repro.train import fault as jfault
from repro.train import trainer as jtrainer

from repro_torch import configs, convert
from repro_torch.data import modality_stubs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.nn import attention, decode, moe, ssm, transformer, xlstm
from repro_torch.serve.engine import Request
from repro_torch.train import trainer

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = configs.ARCH_NAMES
B, S = 2, 16
#: the reduced xLSTM, whose fp32 rounding the model itself amplifies
STIFF = "xlstm-1.3b"
#: the stiff model's allowance: relative L2 distance per leaf within this
#: many times the tolerance's rtol (the most the rules allow a family that
#: cannot meet a tolerance in fp32)
STIFF_SLACK = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The reduced models' ops are too small to split across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


def _ratio(got, want, tol) -> float:
    """The largest |got - want| over its allowance ``atol + rtol |want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)
                        / (tol["atol"] + tol["rtol"] * np.abs(want))))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs(cfg, b, s, seed, labels=True) -> dict:
    """The reference's test inputs (tests/test_archs.py's order): numpy."""
    rng = np.random.default_rng(seed)
    ins = {}
    if cfg.emb_in():
        ins["embeddings"] = rng.normal(0, 1, (b, s, cfg.d_model)).astype(
            np.float32)
    else:
        ins["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        ins["memory"] = rng.normal(0, 1, (b, cfg.n_memory, cfg.d_model)
                                   ).astype(np.float32)
    if labels:
        ins["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return ins


def _j(ins):
    return {k: jnp.asarray(v) for k, v in ins.items()}


def _t(ins):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in ins.items()}


def _step_inputs(ins, t):
    return {k: (v if k == "memory" else v[:, t:t + 1]) for k, v in ins.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced fp32 model of each arch: (jax cfg, jax params, port cfg,
    port LM carried across)."""
    jcfg = jconfigs.reduced(jconfigs.get(request.param))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get(request.param))
    return jcfg, jparams, cfg, convert.lm_params_from_reference(
        _np(jparams), cfg, device="cpu")


def _reference_spread(jcfg, jparams, fn):
    """``fn(cfg)`` at the reference's ``ssm_chunk`` and at twice it: the
    reference against itself where only the chunking changes."""
    return (fn(jcfg), fn(dataclasses.replace(jcfg,
                                             ssm_chunk=2 * jcfg.ssm_chunk)))


def _held_normwise(got: dict, want: dict, tol) -> None:
    """The stiff model's rule: each leaf's relative L2 distance within
    STIFF_SLACK times ``tol``'s rtol."""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[k], np.float64) - w)
        assert d <= STIFF_SLACK * tol["rtol"] * np.linalg.norm(w), \
            (k, d / np.linalg.norm(w))


# ---------------------------------------------------------------------------
# The model: forward, prefill, decode, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_and_prefill_match_the_reference(model):
    """Hidden states (train and prefill) and every prefill cache leaf."""
    jcfg, jparams, cfg, params = model
    ins = _inputs(cfg, B, S, seed=1, labels=False)
    jh, jcache = jtransformer.forward(jparams, jcfg, _j(ins), mode="prefill")
    h, cache = transformer.forward(params, cfg, _t(ins), mode="prefill")
    assert set(cache) == set(jcache)
    got = {"hidden": h, **cache}
    want = {"hidden": jh, **jcache}
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype) == f"torch.{want[k].dtype}", k
    torch.testing.assert_close(transformer.forward(params, cfg, _t(ins)), h,
                               rtol=0, atol=0)
    if cfg.name.startswith(STIFF):
        _held_normwise(got, want, MODEL_TOL)
        return
    for k in got:
        _close(got[k], want[k], MODEL_TOL, k)


def test_decode_steps_from_a_fresh_cache_match_the_reference(model):
    """Four decode steps from ``init_cache``: logits at every step, then
    every cache leaf."""
    jcfg, jparams, cfg, params = model
    ins = _inputs(cfg, B, 4, seed=2, labels=False)
    jcache, _ = jdecode.init_cache(jcfg, B, 24)
    cache = decode.init_cache(cfg, B, 24, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    step = jax.jit(lambda p, c, i, t: jdecode.decode_step(p, jcfg, c, i, t))
    for t in range(4):
        one = _step_inputs(ins, t)
        jlogits, jcache = step(jparams, jcache, _j(one), jnp.int32(t))
        logits, same = decode.decode_step(params, cfg, cache, _t(one), t)
        assert same is cache and logits.dtype == torch.float32
        _close(logits, jlogits, MODEL_TOL, f"step {t}")
    for k in jcache:
        _close(cache[k], jcache[k], MODEL_TOL, k)


def test_loss_and_every_gradient_match_the_reference(model):
    jcfg, jparams, cfg, params = model
    batch = _inputs(cfg, B, S, seed=3)
    tree = {k: v.detach() for k, v in params.named_parameters()}
    loss, grads = trainer.value_and_grad(cfg, tree, _t(batch))
    jloss, jgrads = jax.value_and_grad(jtransformer.loss_fn)(
        jparams, jcfg, _j(batch))
    _close(loss, jloss, MODEL_TOL)
    got = _leaves(convert.lm_params_to_reference(grads, cfg))
    want = _leaves(jgrads)
    assert set(got) == set(want)
    if cfg.name.startswith(STIFF):
        _held_normwise(got, want, GRAD_TOL)
        return
    for k in want:
        _close(got[k], want[k], GRAD_TOL, k)


def test_the_reduced_xlstm_is_stiff_in_the_reference_itself():
    """Why xLSTM's whole-model rule is normwise: the reference against
    itself, only its chunking changed (8 to 16, the same function), already
    stands past 10x GRAD_TOL elementwise (measured 15x on these inputs,
    1,005x on others), while its relative L2 distances stay within the
    normwise rule."""
    jcfg = jconfigs.reduced(jconfigs.get(STIFF))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get(STIFF))
    batch = _j(_inputs(cfg, B, S, seed=3))
    want, again = _reference_spread(jcfg, jparams, lambda c: _leaves(
        jax.grad(jtransformer.loss_fn)(jparams, c, batch)))
    assert max(_ratio(again[k], want[k], GRAD_TOL) for k in want) > 10
    _held_normwise(again, want, GRAD_TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "h2o-danube-1.8b",
                                  "zamba2-1.2b", "xlstm-1.3b", "olmoe-1b-7b"])
def test_prefill_then_decode_matches_the_full_forward(arch):
    """tests/test_archs.py's check on the port: logits of a prefill of S
    tokens then a decode of token S equal a full forward's over S+1 (the
    K/V caches padded by 8 slots so the decode does not wrap), on the
    reference's PRNGKey(1) weights.  olmoe breaks that identity in the
    reference itself: its capacity drops tokens of the 34-token forward
    that the 2-token decode keeps, so there both of the port's logits are
    held to the reference's at MODEL_TOL instead, and the gap between
    them is asserted."""
    over = {"window": 64} if configs.get(arch).window else {}
    cfg = configs.reduced(configs.get(arch), **over)
    jcfg = jconfigs.reduced(jconfigs.get(arch), **over)
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.lm_params_from_reference(_np(jparams), cfg, device="cpu")
    toks = _inputs(cfg, B, S + 1, seed=4, labels=False)["tokens"]

    def run(forward, step, embed, tokens, pad):
        h = forward({"tokens": tokens})
        full = h[:, -1] @ embed.T
        _, cache = forward({"tokens": tokens[:, :S]}, mode="prefill")
        cache = {k: pad(v) if k in ("k", "v", "attn_k", "attn_v") else v
                 for k, v in cache.items()}
        return full, step(cache, {"tokens": tokens[:, S:S + 1]})[0]

    full, logits = run(
        lambda i, **kw: transformer.forward(params, cfg, i, **kw),
        lambda c, i: decode.decode_step(params, cfg, c, i, S),
        params.embed, torch.from_numpy(toks),
        lambda x: torch.nn.functional.pad(x, (0, 0, 0, 8)))
    if cfg.family != "moe":
        torch.testing.assert_close(logits, full.float(), rtol=2e-2, atol=2e-2)
        return
    jfull, jlogits = run(
        lambda i, **kw: jtransformer.forward(jparams, jcfg, i, **kw),
        lambda c, i: jdecode.decode_step(jparams, jcfg, c, i, jnp.int32(S)),
        jparams["embed"], jnp.asarray(toks),
        lambda x: jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, 8), (0, 0)]))
    _close(full, jfull, MODEL_TOL)
    _close(logits, jlogits, MODEL_TOL)
    assert float((logits - full).abs().max()) > 2e-2


# ---------------------------------------------------------------------------
# Parameters: init, dtypes and the round trip through the reference layout
# ---------------------------------------------------------------------------


def test_init_params_is_seeded_and_laid_out_like_the_reference(model):
    jcfg, jparams, cfg, _ = model
    a = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    b = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    assert list(dict(a.named_parameters())) == \
        list(dict(b.named_parameters()))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y) and not x.requires_grad
    assert convert.lm_shapes(cfg) == {k: v.shape for k, v in
                                      convert._flatten(_np(jparams)).items()}
    # in bf16 the reference's fp32 leaves stay fp32, in the port's init
    # and through convert
    base = configs.get(cfg.name[:-len("-smoke")])
    wide = configs.reduced(base, param_dtype=torch.bfloat16)
    jw, _ = jtransformer.init_params(
        jconfigs.reduced(jconfigs.get(base.name), param_dtype=jnp.bfloat16),
        jax.random.PRNGKey(0))
    fp32 = {k for k, v in convert._flatten(jw).items()
            if v.dtype == np.float32}
    assert fp32 == {k for k in convert.lm_shapes(wide)
                    if k.rsplit("/", 1)[-1] in convert.FP32_LEAVES}
    for lm in (transformer.init_params(wide, torch.Generator().manual_seed(0)),
               convert.lm_params_from_reference(_np(jw), wide, device="cpu")):
        for k, v in lm.named_parameters():
            want = (torch.float32 if k.rsplit(".", 1)[-1] in
                    convert.FP32_LEAVES else torch.bfloat16)
            assert v.dtype == want, k


def test_convert_round_trip_is_exact(model):
    jcfg, jparams, cfg, params = model
    back = convert.lm_params_to_reference(params, cfg)
    want = _leaves(jparams)
    got = _leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = convert.lm_params_from_reference(back, cfg, device="cpu")
    assert list(dict(again.named_parameters())) == \
        list(dict(params.named_parameters()))
    for (k, v), w in zip(again.named_parameters(), params.parameters()):
        assert torch.equal(v, w), k
    tree = {k: v.detach() for k, v in params.named_parameters()}
    rebuilt = transformer.LM.from_tree(tree)
    assert list(dict(rebuilt.named_parameters())) == list(tree)


def test_convert_checks_every_path_and_shape():
    cfg = configs.reduced(configs.get("zamba2-1.2b"))
    jparams, _ = jtransformer.init_params(
        jconfigs.reduced(jconfigs.get("zamba2-1.2b")), jax.random.PRNGKey(0))
    tree = _np(jparams)
    tree["mamba_blocks"]["mamba"]["conv"] = \
        tree["mamba_blocks"]["mamba"]["conv"][:, :, :-1]
    with pytest.raises(ValueError, match="shapes"):
        convert.lm_params_from_reference(tree, cfg, device="cpu")
    del tree["shared_attn"]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_reference(tree, cfg, device="cpu")


def test_hybrid_shares_one_attention_block_across_superblocks():
    """zamba2's shared block is one set of weights: its gradient sums over
    every superblock that applies it."""
    cfg = configs.reduced(configs.get("zamba2-1.2b"), n_layers=14)
    lm = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(lm.mamba_blocks) == 2 and len(lm.mamba_tail) == 2
    names = [k for k, _ in lm.named_parameters() if "attn" in k]
    assert all(k.startswith("shared_attn.") for k in names)
    batch = _t(_inputs(cfg, 1, 8, seed=5))
    tree = {k: v.detach() for k, v in lm.named_parameters()}
    _, grads = trainer.value_and_grad(cfg, tree, batch)
    assert grads["shared_attn.attn.wq"].abs().sum() > 0


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _torch_params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("cf,groups", [(2.0, 1), (1.25, 1), (0.5, 1),
                                       (1.25, 4)])
def test_moe_ffn_matches_the_reference(cf, groups, rng):
    """Routing, the capacity drop (0.5 drops), groups and the aux loss."""
    p, _ = jmoe.init_moe(jax.random.PRNGKey(0), 16, 32, 8, jnp.float32)
    x = rng.normal(0, 1, (64, 16)).astype(np.float32)
    want, jaux = jmoe.moe_ffn(x, p, top_k=2, capacity_factor=cf,
                              groups=groups)
    got, aux = moe.moe_ffn(torch.from_numpy(x), _torch_params(p), top_k=2,
                           capacity_factor=cf, groups=groups)
    _close(got, want, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


@pytest.mark.parametrize("top_k,cf", [(2, 1.25), (4, 0.5), (8, 2.0)])
def test_moe_combine_matches_the_scatter_add_without_index_add(
        top_k, cf, rng, monkeypatch):
    """The combine puts each weighted row back in its (token, slot) place
    and sums a token's ``top_k`` rows in slot order: against the
    ``index_add`` scatter it replaced (atomic on CUDA) on the same routing,
    and against the reference at top_k 2 to 8, drops included; the
    gradients through it as well.  No ``index_add`` runs, forward or
    backward."""
    p, _ = jmoe.init_moe(jax.random.PRNGKey(0), 16, 32, 8, jnp.float32)
    x = rng.normal(0, 1, (64, 16)).astype(np.float32)
    tp = {k: v.requires_grad_() for k, v in _torch_params(p).items()}
    cap = moe._capacity(64, top_k, 8, cf)
    down = torch.from_numpy(rng.normal(0, 1, (8 * cap + 1, 16))
                            .astype(np.float32))
    sel, _ = moe._route_group(torch.from_numpy(x), tp["router"].detach(),
                              top_k=top_k, capacity=cap, n_experts=8)
    token_ord, dest, w_ord, keep, _ = sel
    scattered = torch.zeros(64, 16).index_add(
        0, token_ord, down[dest] * (w_ord * keep)[:, None])

    def no_index_add(*a, **kw):
        raise AssertionError("index_add in the combine")

    monkeypatch.setattr(torch.Tensor, "index_add", no_index_add)
    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    monkeypatch.setattr(torch, "index_add", no_index_add)
    _close(moe._combine_group(down, sel, 64), scattered,
           MODEL_TOL)
    want, _ = jmoe.moe_ffn(x, p, top_k=top_k, capacity_factor=cf)
    xt = torch.from_numpy(x).requires_grad_()
    got, aux = moe.moe_ffn(xt, tp, top_k=top_k, capacity_factor=cf)
    _close(got.detach(), want, MODEL_TOL)
    (got.square().sum() + aux).backward()

    def jloss(x, p):
        out, aux = jmoe.moe_ffn(x, p, top_k=top_k, capacity_factor=cf)
        return jnp.sum(jnp.square(out)) + aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(x, p)
    _close(xt.grad, jgx, GRAD_TOL)
    for k in jgp:
        _close(tp[k].grad, jgp[k], GRAD_TOL, k)


def test_moe_capacity_drops_tokens_and_routing_conserves_mass(rng):
    """tests/test_nn.py's two MoE checks on the port."""
    p, _ = jmoe.init_moe(jax.random.PRNGKey(0), 16, 32, 8, jnp.float32)
    tp = _torch_params(p)
    x = torch.from_numpy(rng.normal(0, 1, (64, 16)).astype(np.float32))
    out, aux = moe.moe_ffn(x, tp, top_k=2, capacity_factor=2.0)
    assert out.shape == x.shape and float(aux) > 0
    assert float(out.abs().sum(-1).min()) > 0
    full, _ = moe.moe_ffn(x, tp, top_k=2, capacity_factor=8.0)
    tight, _ = moe.moe_ffn(x, tp, top_k=2, capacity_factor=0.25)
    assert int((tight.abs().sum(-1) == 0).sum()) > 0
    assert not torch.allclose(full, tight)
    assert moe._capacity(64, 2, 8, 0.25) == 8


def test_moe_dispatch_sort_is_stable_and_drops_past_capacity():
    """Tokens 0 and 1 pick expert 1, token 2 expert 0: sorted by expert,
    tokens keep their order within one; at capacity 1 token 1 goes to the
    drop row ``E * C``."""
    x = torch.eye(3)
    router = torch.tensor([[0.0, 5.0], [0.0, 5.0], [5.0, 0.0]])
    for capacity, dest, keep in ((8, [0, 8, 9], [True] * 3),
                                 (1, [0, 1, 2], [True, True, False])):
        (token_ord, d, _, k, _), _ = moe._route_group(
            x, router, top_k=1, capacity=capacity, n_experts=2)
        assert token_ord.tolist() == [2, 0, 1]
        assert d.tolist() == dest and k.tolist() == keep


def test_mamba2_matches_the_reference_and_its_recurrence(rng):
    """Chunked against the reference, and chunked against one recurrent
    step at a time (tests/test_nn.py's check); prefill's state lets decode
    continue."""
    p, _, meta = jssm.init_mamba2(jax.random.PRNGKey(0), 16, 8, jnp.float32,
                                  head_dim=8)
    tp = _torch_params(p)
    x = rng.normal(0, 0.5, (2, 32, 16)).astype(np.float32)
    want, (jh, jconv) = jssm.mamba2(x, p, meta, chunk=8)
    got, (h, conv) = ssm.mamba2(torch.from_numpy(x), tp, meta, chunk=8)
    _close(got, want, MODEL_TOL)
    _close(h, jh, MODEL_TOL)
    _close(conv, jconv, MODEL_TOL)
    hs, cv = ssm.init_decode_state(2, meta)
    ys = []
    for t in range(32):
        yt, (hs, cv) = ssm.mamba2(torch.from_numpy(x[:, t:t + 1]), tp, meta,
                                  state=hs, conv_state=cv)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), got, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(hs, h, rtol=1e-3, atol=1e-3)


def test_mamba2_chunk_is_the_largest_divisor_and_gradients_stay_finite():
    """At the full configs' chunk of 256 the decay above the diagonal
    overflows fp32.  The reference exponentiates it and masks after, so
    its gradient is NaN there (``0 * inf``), at the initial ``dt_bias``
    already; the port never exponentiates it: the same values, a finite
    gradient (a divergence on purpose, ROADMAP Queue 3)."""
    assert ssm._chunk(1024, 256) == 256 and ssm._chunk(300, 256) == 150
    assert ssm._chunk(7, 256) == 7
    jp, _, meta = jssm.init_mamba2(jax.random.PRNGKey(0), 16, 8, jnp.float32,
                                   head_dim=8)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 256, 16)))
    jgrads = jax.grad(lambda p: jssm.mamba2(x, p, meta, chunk=256)[0].sum())(
        jp)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads.values())
    p = _torch_params(jp)
    for v in p.values():
        v.requires_grad_()
    y, _ = ssm.mamba2(torch.from_numpy(x), p, meta, chunk=256)
    _close(y.detach(), jssm.mamba2(x, jp, meta, chunk=256)[0], MODEL_TOL)
    y.sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in p.values())


def test_mlstm_matches_the_reference_and_its_recurrence(rng):
    p, _, meta = jxlstm.init_mlstm(jax.random.PRNGKey(0), 16, 2, jnp.float32)
    tp = _torch_params(p)
    x = rng.normal(0, 0.5, (2, 32, 16)).astype(np.float32)
    want, jC = jxlstm.mlstm(x, p, meta, chunk=8)
    got, C = xlstm.mlstm(torch.from_numpy(x), tp, meta, chunk=8)
    _close(got, want, MODEL_TOL)
    _close(C, jC, MODEL_TOL)
    state = xlstm.init_mlstm_state(2, meta)
    ys = []
    for t in range(32):
        yt, state = xlstm.mlstm(torch.from_numpy(x[:, t:t + 1]), tp, meta,
                                state=state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), got, rtol=1e-3, atol=1e-3)


def test_slstm_matches_the_reference_and_splits_statefully(rng):
    p, _, meta = jxlstm.init_slstm(jax.random.PRNGKey(0), 16, 2, jnp.float32)
    tp = _torch_params(p)
    x = rng.normal(0, 0.5, (2, 32, 16)).astype(np.float32)
    want, jst = jxlstm.slstm(x, p, meta)
    got, st = xlstm.slstm(torch.from_numpy(x), tp, meta)
    _close(got, want, MODEL_TOL)
    for a, b in zip(st, jst):
        _close(a, b, MODEL_TOL)
    ya, sa = xlstm.slstm(torch.from_numpy(x[:, :16]), tp, meta)
    yb, _ = xlstm.slstm(torch.from_numpy(x[:, 16:]), tp, meta, state=sa)
    torch.testing.assert_close(torch.cat([ya, yb], 1), got, rtol=1e-4,
                               atol=1e-4)


def test_xlstm_layers_one_by_one_match_the_reference():
    """The stiff model's layers each at MODEL_TOL, every layer fed the
    reference's own input (its whole-model distance is rounding grown by
    the model, the module docstring)."""
    jcfg = jconfigs.reduced(jconfigs.get(STIFF))
    cfg = configs.reduced(configs.get(STIFF))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(_np(jparams), cfg, device="cpu")
    from repro.nn import layers as jlayers
    toks = _inputs(cfg, B, S, seed=6, labels=False)["tokens"]
    x = jlayers.embed(jnp.asarray(toks), jparams["embed"])
    meta = jtransformer._mlstm_meta(jcfg)
    for j in range(7):
        lp = jax.tree.map(lambda a: a[0, j], jparams["mlstm_blocks"])
        want, jC = jxlstm.mlstm(jlayers.rms_norm(x, lp["norm"]), lp["mix"],
                                meta, chunk=jcfg.ssm_chunk)
        got, C = transformer.mlstm_layer(torch.from_numpy(np.array(x)),
                                         params.mlstm_blocks[0][j], cfg)
        _close(got, x + want, MODEL_TOL, f"mlstm {j}")
        _close(C, jC, MODEL_TOL, f"C {j}")
        x = x + want
    sp = jax.tree.map(lambda a: a[0], jparams["slstm_blocks"])
    want, _ = jxlstm.slstm(jlayers.rms_norm(x, sp["norm"]), sp["mix"],
                           jtransformer._slstm_meta(jcfg))
    got, _ = transformer.slstm_layer(torch.from_numpy(np.array(x)),
                                     params.slstm_blocks[0], cfg)
    _close(got, x + want, MODEL_TOL, "slstm")


@pytest.mark.parametrize("s,m", [(40, 16), (16, 16), (1, 24)])
def test_cross_attention_matches_the_reference_past_its_memory(s, m, rng):
    """Every text query sees every memory key, also with more queries than
    keys (a vlm trains at S = 2,048 over 1,600 patches)."""
    p, _ = jattention.init_attention(jax.random.PRNGKey(0), 64, 4, 2, 16,
                                     jnp.float32)
    x = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    mem = rng.normal(0, 1, (2, m, 64)).astype(np.float32)
    want = jattention.cross_attention(x, mem, p, n_heads=4, n_kv=2,
                                      head_dim=16)
    got = attention.cross_attention(torch.from_numpy(x), torch.from_numpy(mem),
                                    _torch_params(p), n_heads=4, n_kv=2,
                                    head_dim=16)
    _close(got, want, MODEL_TOL)


def test_flash_attention_takes_more_queries_than_keys_only_unmasked():
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import ref as attn_ref
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 9, 8, generator=g, requires_grad=True)
    k, v = (torch.randn(1, 2, 5, 8, generator=g, requires_grad=True)
            for _ in range(2))
    out = flash_attention(q, k, v, causal=False)
    plain = attn_ref.attention_ref(q.detach(), k.detach(), v.detach(),
                                   causal=False)
    torch.testing.assert_close(out.detach(), plain, rtol=1e-5, atol=1e-6)
    # the plain backward against autograd through the plain forward
    do = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(attn_ref.attention_ref(q, k, v, causal=False),
                               (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for kw in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="1 <= Sq <= Sk"):
            flash_attention(q.detach(), k.detach(), v.detach(), **kw)


def test_modality_stubs_draw_the_references_values():
    for fn, jfn, shape in (
            (modality_stubs.encodec_frames, jstubs.encodec_frames, (2, 5, 8)),
            (modality_stubs.vit_patches, jstubs.vit_patches, (2, 7, 8))):
        got = fn(np.random.default_rng(3), *shape, dtype=torch.float32,
                 device="cpu")
        want = jfn(np.random.default_rng(3), *shape, dtype=jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bf = fn(np.random.default_rng(3), *shape, device="cpu")
        assert bf.dtype == torch.bfloat16 and bf.shape == shape


# ---------------------------------------------------------------------------
# Training: the prefill step, batches, and the launcher
# ---------------------------------------------------------------------------


def test_prefill_step_unembeds_audio_through_its_head():
    """musicgen's logits come from ``head``, not an embedding: the
    reference's ``make_prefill_step``."""
    name = "musicgen-large"
    jcfg = jconfigs.reduced(jconfigs.get(name))
    cfg = configs.reduced(configs.get(name))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_reference(_np(jparams), cfg, device="cpu")
    assert not hasattr(params, "embed")
    ins = _inputs(cfg, B, 8, seed=7, labels=False)
    logits, cache = trainer.make_prefill_step(cfg)(params, _t(ins))
    jlogits, jcache = jtrainer.make_prefill_step(jcfg, None)(jparams, _j(ins))
    assert logits.shape == (B, cfg.vocab)
    _close(logits, jlogits, MODEL_TOL)
    for k in ("k", "v"):
        _close(cache[k], jcache[k], MODEL_TOL)


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b",
                                  "olmoe-1b-7b"])
def test_launcher_batches_match_the_references(arch):
    cfg = configs.reduced(configs.get(arch))
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    mine = launch_train.make_batch_fn(cfg, 3, 9, seed=4, device="cpu")
    theirs = jlaunch.make_batch_fn(jcfg, 3, 9, seed=4)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trajectory_matches_the_reference(arch, tmp_path,
                                                   monkeypatch):
    """Four ``--smoke`` steps of each arch through each launcher, from the
    reference's PRNGKey(0) weights, at ``--lr 0.1``: loss for loss.  At
    0.3 the reduced kimi's third loss departs from the reference's while
    the weights before it agree to fp32 rounding: a token's top-2 experts
    flip at a near tie, a discontinuity of the routing.  The reduced
    xLSTM's reference run fails its own falling-loss check at this rate,
    and the port departs from it after the first step, so only its first
    loss is held."""
    histories = []
    run = jfault.ResilientLoop.run

    def recorded(self, *a, **kw):
        out = run(self, *a, **kw)
        histories.append(out[1])
        return out

    monkeypatch.setattr(jfault.ResilientLoop, "run", recorded)
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--lr", "0.1"]
    try:
        jlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
        assert arch != STIFF, "the reference's xLSTM run fell this time"
    except AssertionError as e:
        assert arch == STIFF and "loss did not decrease" in str(e)
    want = [float(m["loss"]) for kind, _, m in histories[0] if kind == "step"]
    jparams, _ = jtransformer.init_params(
        jconfigs.reduced(jconfigs.get(arch)), jax.random.PRNGKey(0))
    args = launch_train.parse_args(argv + ["--ckpt-dir", str(tmp_path / "t"),
                                           "--device", "cpu"])
    cfg, loop, batches = launch_train.setup(
        args, params=convert.lm_params_from_reference(
            _np(jparams), configs.reduced(configs.get(arch)), device="cpu"))
    _, history = loop.run(batches, args.steps)
    got = launch_train.losses_of(history)
    assert len(got) == len(want) == 4
    if arch == STIFF:
        _close(got[:1], want[:1], TRAJ_TOL)
        return
    _close(got, want, TRAJ_TOL)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# Serving: --ckpt, and the families the engine refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["minitron-4b", "olmoe-1b-7b",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_serve_restores_what_train_wrote(arch, tmp_path, capsys):
    """``launch.train --smoke --ckpt-dir`` then ``launch.serve --smoke
    --ckpt``: the restored engine serves the same tokens as the reference's
    ``ServeEngine`` on the trainer's final weights, carried across by
    ``lm_params_to_reference``."""
    ckpt = tmp_path / "ckpt"
    train_argv = ["--arch", arch, "--smoke", "--steps", "3", "--lr", "0.01",
                  "--ckpt-every", "1", "--ckpt-dir", str(ckpt),
                  "--device", "cpu"]
    args = launch_train.parse_args(train_argv)
    cfg, loop, batches = launch_train.setup(args)
    (final, _), history = loop.run(batches, args.steps)
    assert len(launch_train.losses_of(history)) == 3
    assert sorted(p.name for p in ckpt.glob("step_*"))[-1] == "step_000000002"

    done = launch_serve.main(["--arch", arch, "--smoke", "--ckpt", str(ckpt),
                              "--device", "cpu", "--requests", "4",
                              "--max-new", "5", "--max-len", "32"])
    assert "restored checkpoint step 2" in capsys.readouterr().out
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jparams = jax.tree.map(jnp.asarray,
                           convert.lm_params_to_reference(final, cfg))
    rng = np.random.default_rng(0)
    reqs = [jengine.Request(i, rng.integers(0, cfg.vocab,
                                            size=int(rng.integers(2, 9))),
                            max_new=5) for i in range(4)]
    jdone = jengine.ServeEngine(jcfg, jparams, slots=4, max_len=32).run(reqs)
    assert [r.out for r in done] == [r.out for r in jdone]
    assert len(done) == 4


def test_serve_restores_parameters_saved_alone(tmp_path):
    from repro_torch.checkpoint import save_checkpoint
    cfg = configs.reduced(configs.get("olmoe-1b-7b"))
    lm = transformer.init_params(cfg, torch.Generator().manual_seed(9))
    save_checkpoint(tmp_path, 7, {k: v.detach()
                                  for k, v in lm.named_parameters()})
    fresh = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    got, step = launch_serve.restore(str(tmp_path), fresh)
    assert step == 7
    for (k, a), b in zip(got.named_parameters(), lm.parameters()):
        assert torch.equal(a, b) and not a.requires_grad, k


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b"])
def test_serve_refuses_the_families_the_engine_cannot_step(arch):
    """The engine feeds tokens alone: audio and vlm are refused with a
    ValueError naming why; the reference's engine fails on them too (a
    KeyError for the embeddings or the memory)."""
    with pytest.raises(ValueError, match="tokens alone"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    eng = jengine.ServeEngine(jcfg, jparams, slots=2, max_len=16)
    with pytest.raises(KeyError):
        eng.run([jengine.Request(0, np.array([1, 2]), max_new=2)])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b", "xlstm-1.3b"])
def test_launch_serve_smoke_drains_its_queue_for_the_token_families(arch):
    done = launch_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                              "--requests", "5", "--max-new", "4"])
    assert len(done) == 5 and all(r.done and len(r.out) == 4 for r in done)
    assert all(0 <= t < configs.reduced(configs.get(arch)).vocab
               for r in done for t in r.out)
    assert isinstance(done[0], Request)
