"""Parity of the port's LM serving path with the JAX reference, on the CPU.

The same seeded numpy inputs, and the same parameters (the reference's
tree carried across by ``convert.lm_params_from_reference``), go through
the JAX functions and the port's on ``device="cpu"``, where attention runs
the ``flash_attn`` family's plain version (``chip_smoke.py`` holds the CUDA
kernel against it on the card).  Tolerances: fp32 attention
``rtol=1e-4, atol=1e-5``; model outputs the conformance suite's
``rtol=1e-4, atol=1e-4``.  The reference's ``chunked_attention`` runs as
XLA here, its Pallas kernel in ``pallas-interpret`` in
test_torch_kernels.py.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.nn import attention as jattention
from repro.nn import decode as jdecode
from repro.nn import layers as jlayers
from repro.nn import transformer as jtransformer
from repro.serve import engine as jengine

from repro_torch import configs, convert
from repro_torch.kernels import common
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import attention, decode, layers, transformer
from repro_torch.serve.engine import Request, ServeEngine

ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
ARCHS = ("minitron-4b", "h2o-danube-1.8b")


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """A reduced fp32 model of each served arch: (jax cfg, jax params,
    port cfg, port params carried across)."""
    jcfg = jconfigs.reduced(jconfigs.get(request.param))
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = configs.reduced(configs.get(request.param))
    return jcfg, jparams, cfg, convert.lm_params_from_reference(
        _np(jparams), cfg, device="cpu")


def _qkv(b, hq, hkv, sq, sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, hq, sq, hd)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, hd)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_configs_carry_the_reference_data():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(True) == jconfigs.cells(True)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for name in configs.ARCH_NAMES:
        for cfg, jcfg in ((configs.get(name), jconfigs.get(name)),
                          (configs.reduced(configs.get(name)),
                           jconfigs.reduced(jconfigs.get(name)))):
            mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
            assert mine.pop("param_dtype") == dtypes[theirs.pop("param_dtype")]
            assert mine == theirs and cfg.hd == jcfg.hd
    assert configs.parse_dtype("bfloat16") == torch.bfloat16
    assert configs.reduced(configs.get("h2o-danube-1.8b"), window=8).window == 8


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "musicgen-large",
                                  "zamba2-1.2b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
def test_unported_families_raise_naming_the_roadmap(name):
    cfg = configs.reduced(configs.get(name))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        transformer.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        decode.init_cache(cfg, 2, 16, device="cpu")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rms_norm_rotary_and_ffns_match_jax(rng):
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    _close(layers.rms_norm(*_t(x, w)), jlayers.rms_norm(x, w), MODEL_TOL)
    xr = rng.normal(0, 1, (2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(layers.rotary(*_t(xr, pos)), jlayers.rotary(xr, pos), MODEL_TOL)
    for gated in (True, False):
        p, _ = jlayers.init_ffn(jax.random.PRNGKey(1), 64, 128, jnp.float32,
                                gated=gated)
        mine = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        _close(layers.ffn(torch.from_numpy(x), mine, gated=gated),
               jlayers.ffn(x, p, gated=gated), MODEL_TOL)


def test_rms_norm_in_bf16_casts_back_before_the_scale():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    w = torch.full((64,), 1.5)
    y = layers.rms_norm(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = (layers.rms_norm(x.to(torch.bfloat16).float(), torch.ones(64))
            .to(torch.bfloat16) * torch.tensor(1.5, dtype=torch.bfloat16))
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,s,chunk_q", [
    (True, None, 64, 16),
    (True, 8, 64, 16),
    (False, None, 64, 16),
    (True, 16, 128, 16),     # sk > window + chunk_q: the reference's slice path
    (True, 24, 96, 32),
])
def test_chunked_attention_matches_jax(causal, window, s, chunk_q):
    q, k, v = _qkv(2, 4, 2, s, s, 16, seed=s)
    want = jattention.chunked_attention(q, k, v, causal=causal, window=window,
                                        chunk_q=chunk_q)
    got = attention.chunked_attention(*_t(q, k, v), causal=causal,
                                      window=window)
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("valid", [1, 7, 31, 32])
def test_decode_attention_matches_jax(valid):
    q, k, v = _qkv(3, 8, 2, 1, 32, 16, seed=valid)
    want = jattention.decode_attention(q, k, v, valid)
    got = attention.decode_attention(*_t(q, k, v), valid)
    _close(got, want, ATTN_TOL)


def test_decode_attention_ignores_entries_past_valid():
    q, k, v = _t(*_qkv(1, 4, 2, 1, 16, 16))
    before = attention.decode_attention(q, k, v, 9)
    k[:, :, 9:] = 1e4
    v[:, :, 9:] = float("nan")
    torch.testing.assert_close(attention.decode_attention(q, k, v, 9), before,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The model: prefill forward and decode steps
# ---------------------------------------------------------------------------


def test_forward_prefill_hidden_and_cache_match_jax(model):
    jcfg, jparams, cfg, params = model
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jh, jcache = jtransformer.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                      mode="prefill")
    h, cache = transformer.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                                   mode="prefill")
    assert cache["k"].shape == (cfg.n_layers, 2, cfg.n_kv, 40, cfg.hd)
    _close(h, jh, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    _close(cache["v"], jcache["v"], MODEL_TOL)
    _close(transformer.forward(params, cfg, {"tokens": torch.from_numpy(toks)}),
           jh, MODEL_TOL)
    with pytest.raises(ValueError, match="'train' or 'prefill'"):
        transformer.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                            mode="decode")


def test_decode_steps_past_the_window_match_jax():
    """Danube's ring cache: 20 steps through an 8-slot cache (window 8),
    logits and cache equal to the reference's at every step."""
    jcfg = jconfigs.reduced(jconfigs.get("h2o-danube-1.8b"), window=8)
    cfg = configs.reduced(configs.get("h2o-danube-1.8b"), window=8)
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(2))
    params = convert.lm_params_from_reference(_np(jparams), cfg, device="cpu")
    jcache, _ = jdecode.init_cache(jcfg, 2, 64)
    cache = decode.init_cache(cfg, 2, 64, device="cpu")
    assert cache["k"].shape[3] == 8 == jcache["k"].shape[3]
    step = jax.jit(lambda p, c, t, i: jdecode.decode_step(
        p, jcfg, c, {"tokens": t}, i))
    rng = np.random.default_rng(4)
    for t in range(20):
        toks = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jlogits, jcache = step(jparams, jcache, jnp.asarray(toks), jnp.int32(t))
        logits, cache = decode.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks)}, t)
        _close(logits, jlogits, MODEL_TOL)
    _close(cache["k"], jcache["k"], MODEL_TOL)
    _close(cache["v"], jcache["v"], MODEL_TOL)


def test_decode_takes_one_token_per_step(model):
    _, _, cfg, params = model
    cache = decode.init_cache(cfg, 1, 16, device="cpu")
    p = params.layers[0]
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="one token per step"):
        attention.self_attention(
            x, p.attn, n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.hd,
            positions=torch.zeros(1, 2, dtype=torch.int32),
            cache=(cache["k"][0], cache["v"][0], 0))


# ---------------------------------------------------------------------------
# Parameters across
# ---------------------------------------------------------------------------


def test_convert_unstacks_layers_and_checks_every_shape(model):
    jcfg, jparams, cfg, params = model
    tree = _np(jparams)
    assert len(params.layers) == cfg.n_layers
    for i, block in enumerate(params.layers):
        np.testing.assert_array_equal(block.attn["wq"].numpy(),
                                      tree["layers"]["attn"]["wq"][i])
        np.testing.assert_array_equal(block.norm2.numpy(),
                                      tree["layers"]["norm2"][i])
    assert not any(p.requires_grad for p in params.parameters())
    assert all(p.device == CPU for p in params.parameters())
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["wo"] = bad["layers"]["attn"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="shapes"):
        convert.lm_params_from_reference(bad, cfg, device="cpu")
    del bad["layers"]["ffn"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_reference(bad, cfg, device="cpu")


def test_init_params_is_seeded_and_shaped_like_the_reference(model):
    jcfg, jparams, cfg, _ = model
    a = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    b = transformer.init_params(cfg, torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    shapes = convert.lm_shapes(cfg)
    assert shapes == {k: v.shape for k, v in convert._flatten(_np(jparams)).items()}
    assert a.embed.shape == shapes["embed"]
    assert a.layers[1].ffn["w_down"].shape == shapes["layers/ffn/w_down"][1:]


# ---------------------------------------------------------------------------
# ServeEngine: greedy parity with the reference engine
# ---------------------------------------------------------------------------


def _requests(vocab, n=5, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=int(rng.integers(0, 6))),
             max_new + i % 3) for i in range(n)]


def test_serve_engine_greedy_tokens_match_jax(model):
    jcfg, jparams, cfg, params = model
    specs = _requests(cfg.vocab)
    jeng = jengine.ServeEngine(jcfg, jparams, slots=2, max_len=24)
    jdone = jeng.run([jengine.Request(i, p, m) for i, p, m in specs])
    eng = ServeEngine(cfg, params, slots=2, max_len=24, device="cpu")
    ticks = []
    tick = eng.tick
    eng.tick = lambda: ticks.append(tick())
    done = eng.run([Request(i, p, m) for i, p, m in specs])
    assert [r.rid for r in done] == [r.rid for r in jdone] == list(range(5))
    assert [r.out for r in done] == [r.out for r in jdone]
    assert list(eng.pos) == list(jeng.pos)
    _close(eng.cache["k"], jeng.cache["k"], MODEL_TOL)
    _close(eng.cache["v"], jeng.cache["v"], MODEL_TOL)
    # one decode step per prompt token and per tick that had a live slot
    assert eng.steps == sum(len(p) for _, p, _ in specs) + len(ticks)


# ---------------------------------------------------------------------------
# The reference's two quirks, reproduced
# ---------------------------------------------------------------------------


def _engines(model, max_len=16):
    jcfg, jparams, cfg, params = model
    return (jengine.ServeEngine(jcfg, jparams, slots=2, max_len=max_len),
            ServeEngine(cfg, params, slots=2, max_len=max_len, device="cpu"))


def _both(engines, fn):
    jeng, eng = engines
    fn(jeng, jengine.Request)
    fn(eng, Request)


def test_admission_writes_the_other_slots_cache_at_the_admitted_position(model):
    """Admission prefills through the decode step for all slots at
    ``idx = pos[slot]``: each prompt token of the new request also writes
    the live slots' K/V at that index, from their last token."""
    engines = _engines(model)
    jeng, eng = engines
    _both(engines, lambda e, R: (e.try_admit(R(0, np.array([3, 4, 5]), 4)),
                                 e.tick()))
    assert list(eng.pos) == [4, 0]
    before = eng.cache["k"][:, 0].clone()
    _both(engines, lambda e, R: e.try_admit(R(1, np.array([6, 7]), 4)))
    after = eng.cache["k"][:, 0]
    # slot 0's entries 0 and 1 (its own prompt) now hold its last token
    assert not torch.equal(after[:, :, :2], before[:, :, :2])
    assert torch.equal(after[:, :, 2:], before[:, :, 2:])
    assert list(eng.pos) == list(jeng.pos) == [4, 2]
    _close(eng.cache["k"], jeng.cache["k"], MODEL_TOL)
    _close(eng.cache["v"], jeng.cache["v"], MODEL_TOL)


def test_a_tick_uses_one_shared_index_for_every_slot(model):
    """A tick decodes every slot at ``idx = pos.max()``: a slot at
    position 2 is written at cache entry 4, with rotary position 4."""
    engines = _engines(model)
    jeng, eng = engines
    _both(engines, lambda e, R: (e.try_admit(R(0, np.array([3, 4, 5]), 4)),
                                 e.tick(), e.try_admit(R(1, np.array([6, 7]), 4))))
    before = eng.cache["k"][:, 1].clone()
    _both(engines, lambda e, R: e.tick())
    changed = (eng.cache["k"][:, 1] != before).any(dim=(0, 1, 3))
    assert changed.nonzero().flatten().tolist() == [4]
    assert list(eng.pos) == list(jeng.pos) == [5, 3]
    _close(eng.cache["k"], jeng.cache["k"], MODEL_TOL)
    _close(eng.cache["v"], jeng.cache["v"], MODEL_TOL)


# ---------------------------------------------------------------------------
# ServeEngine regressions (the reference's test_serve.py, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_setup():
    cfg = configs.reduced(configs.get("minitron-4b"))
    return cfg, transformer.init_params(cfg, torch.Generator().manual_seed(0))


def test_serve_engine_empty_prompt_admits(lm_setup):
    cfg, params = lm_setup
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    req = Request(0, np.asarray([], np.int32), max_new=3)
    assert eng.try_admit(req)           # no crash, slot taken
    assert eng.live[0] is req
    assert req.out == []                # no prompt-conditioned token yet
    done = eng.run([req], max_ticks=20)
    assert done == [req] and req.done
    assert 1 <= len(req.out) <= req.max_new + 1
    assert all(0 <= t < cfg.vocab for t in req.out)


def test_serve_engine_run_mixed_empty_and_real_prompts(lm_setup):
    cfg, params = lm_setup
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    reqs = [Request(0, np.asarray([], np.int32), max_new=2),
            Request(1, np.asarray([1, 2], np.int32), max_new=2),
            Request(2, np.asarray([], np.int32), max_new=2)]
    done = eng.run(reqs, max_ticks=50)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done and len(r.out) >= 1 for r in reqs)


def test_serve_engine_run_returns_each_request_once(lm_setup):
    cfg, params = lm_setup
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    reqs = [Request(i, np.asarray([1 + i], np.int32), max_new=2)
            for i in range(3)]
    done = eng.run(reqs, max_ticks=50)
    assert [r.rid for r in done] == [0, 1, 2]
    assert len({id(r) for r in done}) == 3


@pytest.mark.parametrize("example", range(5))
def test_serve_engine_admission_properties(lm_setup, example):
    """Seeded admit/tick interleavings: capacity respected, FIFO
    admission, nothing lost or duplicated, every admitted request
    terminates within its max_new bound."""
    cfg, params = lm_setup
    rnd = random.Random(example)
    slots = rnd.randint(1, 2)
    specs = [(rnd.randint(0, 2), rnd.randint(1, 3))
             for _ in range(rnd.randint(1, 4))]
    ops = [rnd.choice(["admit", "tick"]) for _ in range(rnd.randint(0, 8))]
    eng = ServeEngine(cfg, params, slots=slots, max_len=32, device="cpu")
    pending = [Request(i, np.arange(1, 1 + p, dtype=np.int32), max_new=m)
               for i, (p, m) in enumerate(specs)]
    admitted = []
    for op in ops + ["admit", "tick"] * (4 * len(specs)):
        assert len([r for r in eng.live if r is not None]) <= slots
        if op == "admit" and pending:
            if eng.try_admit(pending[0]):
                admitted.append(pending.pop(0))
            else:
                assert all(r is not None for r in eng.live)  # full => reject
        else:
            eng.tick()
        if not pending and all(r is None for r in eng.live):
            break
    assert [r.rid for r in admitted] == sorted(r.rid for r in admitted)
    assert len(admitted) == len(specs)
    for r in admitted:
        assert r.done
        assert 1 <= len(r.out) <= r.max_new + 1


# ---------------------------------------------------------------------------
# Sampling, devices and the launcher
# ---------------------------------------------------------------------------


def test_temperature_sampling_is_seeded_and_in_range(lm_setup):
    cfg, params = lm_setup

    def serve(temperature, seed):
        eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu",
                          temperature=temperature, seed=seed)
        reqs = [Request(i, np.array([1 + i, 2]), max_new=6) for i in range(3)]
        return [r.out for r in eng.run(reqs)]

    first, again = serve(1.0, 7), serve(1.0, 7)
    assert first == again
    assert all(0 <= t < cfg.vocab for out in first for t in out)
    assert all(len(out) == 6 for out in first)
    assert first != serve(0.0, 7)      # sampled, not greedy


def test_engine_runs_on_cuda_unless_told(lm_setup):
    cfg, params = lm_setup
    with pytest.raises(ValueError, match="parameters on cpu, engine on cuda"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").cache["k"].device == CPU
    assert common.device() == torch.device("cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_smoke_drains_its_queue_on_cpu(arch, capsys):
    done = launch_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                              "--requests", "6", "--max-new", "5"])
    assert len(done) == 6 and all(r.done and len(r.out) == 5 for r in done)
    assert "6/6 requests" in capsys.readouterr().out
