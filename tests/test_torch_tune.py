"""The port's launch-plan autotuner (``repro_torch.kernels.tune``) on the CPU.

Its shape classes and micro-batch grid are held to the reference's
``repro.kernels.tune`` on the same call infos; its cache, memo, switch and
feasibility check are exercised against a temporary cache directory; and
each family's wrapper is shown to pass a cached winner to
``common.dispatch`` as a keyword (a recording stub stands in for the
dispatch), and the plan's own pick (``None``) where there is no record.
Whether a tuned launch geometry runs right on the card is
``chip_smoke.py``'s phase ``bench``.
"""
import json

import pytest
import torch

from repro.kernels import tune as jtune

import repro_torch.kernels as tk
from repro_torch.kernels import common, tune
from repro_torch.obs import metrics

INFOS = (
    {"dtype": "float32", "n": 96, "d": 50},
    {"dtype": "float32", "n": 128, "d": 64},
    {"dtype": "bfloat16", "sparse": True, "n": 2048, "d": 4096, "k": 16},
    {"dtype": "float32", "n": 581_012, "d": 54, "micro_batch": 16},
    {"dtype": "float32", "n": 0, "d": 1, "causal": True},
    {"dtype": "float32", "batch": 2, "heads_q": 4, "heads_kv": 2,
     "seq_q": 256, "seq_k": 256, "head_dim": 64},
)


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """An empty cache of the test's own, the switch off, no memo."""
    monkeypatch.setenv(tune.ENV_TUNE_DIR, str(tmp_path / "tune"))
    monkeypatch.delenv(tune.ENV_AUTOTUNE, raising=False)
    tune.forget()
    yield tmp_path / "tune"
    tune.forget()


@pytest.mark.parametrize("info", INFOS, ids=range(len(INFOS)))
def test_shape_class_equals_the_references(info):
    assert tune.shape_class(info) == jtune.shape_class(info)


@pytest.mark.parametrize("n", [8, 16, 64, 96, 256, 1000, 2048, 6472, 581_016])
@pytest.mark.parametrize("kernel", ["glm_sgd", "glm_sgd_sparse"])
def test_micro_batch_candidates_equal_the_references(kernel, n):
    info = {"dtype": "float32", "n": n, "d": 54}
    assert tune.TUNABLES[kernel].candidates(info) \
        == jtune.TUNABLES[kernel].candidates(info)


def test_micro_batch_candidates_add_the_pick_at_a_ragged_n():
    """The reference's grid needs micro-batches that divide N (its Pallas
    epoch does); the port's kernels take a ragged tail, so the pick runs
    too."""
    info = {"dtype": "float32", "n": 12, "d": 54}
    ref = [c["micro_batch"] for c in jtune.TUNABLES["glm_sgd"].candidates(info)]
    got = [c["micro_batch"] for c in tune.TUNABLES["glm_sgd"].candidates(info)]
    assert ref == [1, 2, 4] and got == [1, 2, 4, 8]
    info["micro_batch"] = 10
    assert 10 in [c["micro_batch"]
                  for c in tune.TUNABLES["glm_sgd"].candidates(info)]


#: (kernel, call info) at the bench's and the main paths' shapes
PLANS = (
    ("glm_grad", {"dtype": "float32", "n": 581_012, "d": 54}),
    ("glm_grad", {"dtype": "float32", "n": 4096, "d": 512}),
    ("glm_grad", {"dtype": "float32", "n": 2003, "d": 60_000}),
    ("glm_score", {"dtype": "float32", "sparse": True, "n": 128, "d": 300,
                   "k": 69}),
    ("glm_score", {"dtype": "float32", "sparse": True, "n": 128,
                   "d": 20_958, "k": 307}),
    ("glm_score", {"dtype": "float32", "sparse": True, "n": 64_700, "d": 300,
                   "k": 69}),
    ("glm_sparse", {"dtype": "float32", "sparse": True, "n": 64_700,
                    "d": 300, "k": 69, "replicas": 1}),
    ("glm_sparse", {"dtype": "float32", "sparse": True, "n": 2048,
                    "d": 4096, "k": 16}),
    ("flash_attn", {"dtype": "bfloat16", "batch": 4, "heads_q": 32,
                    "heads_kv": 8, "seq_q": 1, "seq_k": 4096,
                    "head_dim": 80}),
    ("flash_attn", {"dtype": "bfloat16", "batch": 4, "heads_q": 32,
                    "heads_kv": 8, "seq_q": 1, "seq_k": 128,
                    "head_dim": 80}),
    ("glm_sgd", {"dtype": "float32", "n": 581_012, "d": 54,
                 "micro_batch": 16}),
)


@pytest.mark.parametrize("kernel,info", PLANS, ids=lambda x: str(x)[:40])
def test_grid_holds_the_plans_pick_and_only_feasible_configs(kernel, info):
    tunable = tune.TUNABLES[kernel]
    pick = tunable.pick(info)
    grid = tunable.candidates(info)
    assert pick in grid
    assert all(tunable.feasible(info, cfg) for cfg in grid)
    assert [c[tunable.params[0]] for c in grid] \
        == sorted({c[tunable.params[0]] for c in grid})


def test_grid_pick_is_each_familys_plan():
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.glm_grad import ops as grad_ops
    from repro_torch.kernels.glm_score import ops as score_ops
    from repro_torch.kernels.glm_sparse import ops as sparse_ops

    assert tune.TUNABLES["glm_grad"].pick(PLANS[0][1]) == {
        "block_rows": grad_ops.ring_plan(54, 581_012, tune.H100_SMS)[0]}
    assert tune.TUNABLES["glm_score"].pick(PLANS[3][1]) == {
        "block_rows": score_ops.score_plan(128, 69, tune.H100_SMS)[0]}
    assert tune.TUNABLES["glm_sparse"].pick(PLANS[6][1]) == {
        "lanes": sparse_ops.smem_lanes(69)}
    assert tune.TUNABLES["flash_attn"].pick(PLANS[8][1]) == {
        "splits": attn_ops.decode_plan(4, 8, 4096)[0]}


@pytest.mark.parametrize("kernel,info", [
    ("glm_score", {"dtype": "float32", "sparse": True, "n": 128, "d": 300,
                   "k": 5000}),                      # the group kernel
    ("glm_sparse", {"dtype": "float32", "sparse": True, "n": 10,
                    "d": 1_355_191, "k": 16}),       # the atomic kernel
    ("flash_attn", {"dtype": "bfloat16", "batch": 1, "heads_q": 32,
                    "heads_kv": 8, "seq_q": 512, "seq_k": 512,
                    "head_dim": 80}),                # the mma kernel
    ("flash_attn", {"dtype": "float32", "batch": 1, "heads_q": 4,
                    "heads_kv": 2, "seq_q": 1, "seq_k": 512,
                    "head_dim": 64}),                # the fp32 kernel
])
def test_variants_with_nothing_to_tune_have_the_single_candidate_empty(
        kernel, info, tmp_path):
    assert tune.TUNABLES[kernel].candidates(info) == ({},)
    calls = []
    rec = tune.tune(kernel, common.CUDA, info,
                    lambda **c: calls.append(c),
                    cache=tune.TuneCache(tmp_path))
    assert rec["config"] == {} and rec["candidates"] == [] and not calls


@pytest.mark.parametrize("kernel,info,swept", [
    ("glm_grad", {"dtype": "float32", "n": 512, "d": 128}, False),
    ("glm_score", {"dtype": "float32", "sparse": True, "n": 128, "d": 300,
                   "k": 69}, False),
    ("glm_sgd", {"dtype": "float32", "n": 64, "d": 8}, True),
])
def test_the_plain_versions_sweep_only_what_changes_the_function(
        kernel, info, swept, tmp_path):
    """Launch geometry does not change what a plain version computes, so
    on the plain versions it is not swept; a micro-batch does."""
    calls = []
    rec = tune.tune(kernel, common.TORCH_REFERENCE, info,
                    lambda **c: calls.append(c) or torch.zeros(1),
                    cache=tune.TuneCache(tmp_path))
    assert bool(calls) == swept and bool(rec["candidates"]) == swept
    assert (rec["config"] == {}) == (not swept)


def test_cache_round_trips_canonical_json(tmp_path):
    cache = tune.TuneCache(tmp_path)
    payload = {"config": {"block_rows": 8}, "z": [3, 1], "a": 1.5}
    cache.put("k1", payload)
    assert cache.get("k1") == payload
    assert (tmp_path / "k1.json").read_text() == tune.canonical_json(payload)
    assert tune.canonical_json(payload) == jtune.canonical_json(payload)
    assert cache.get("absent") is None


def test_cache_key_separates_kernels_backends_and_classes(tmp_path):
    cache = tune.TuneCache(tmp_path)
    info = {"dtype": "float32", "n": 96, "d": 50}
    key = cache.key("glm_grad", common.CUDA, info)
    assert key != cache.key("glm_sgd", common.CUDA, info)
    assert key != cache.key("glm_grad", common.TORCH_REFERENCE, info)
    assert key != cache.key("glm_grad", common.CUDA, {**info, "n": 200})
    assert key != cache.key("glm_grad", common.CUDA,
                            {**info, "dtype": "bfloat16"})
    # the same class: 96 and 128 rows, 50 and 64 features
    assert key == cache.key("glm_grad", common.CUDA,
                            {"dtype": "float32", "n": 128, "d": 64})


def test_device_kind_is_cpu_without_a_card():
    assert tune.device_kind() == "cpu"
    assert tune.timeable()


def _put(cache, kernel, info, config, backend=common.CUDA):
    cache.put(cache.key(kernel, backend, info),
              {"schema": tune.SCHEMA, "kernel": kernel, "backend": backend,
               "config": config})


def test_lookup_drops_foreign_keys(tmp_path):
    cache = tune.TuneCache(tmp_path)
    info = {"dtype": "float32", "n": 512, "d": 128}
    _put(cache, "glm_grad", info, {"block_rows": 32, "evil": 1})
    assert tune.lookup("glm_grad", common.CUDA, info, cache=cache) == {
        "block_rows": 32}
    assert tune.lookup("no_such_kernel", common.CUDA, info,
                       cache=cache) is None


def test_consult_is_empty_without_cache_or_switch(tune_dir):
    info = {"dtype": "float32", "n": 512, "d": 128}
    calls = []
    assert tune.consult("glm_grad", common.CUDA, info,
                        lambda **c: calls.append(c)) == {}
    assert not calls and not tune_dir.exists()


def test_consult_tunes_on_a_miss_with_the_switch(tune_dir, monkeypatch):
    monkeypatch.setenv(tune.ENV_AUTOTUNE, "1")
    info = {"dtype": "float32", "sparse": True, "n": 128, "d": 300, "k": 69}
    calls = []

    def run(**cfg):
        calls.append(cfg)
        return torch.zeros(1)

    cfg = tune.consult("glm_score", common.CUDA, info, run)
    grid = tune.TUNABLES["glm_score"].candidates(info)
    assert cfg in grid and {json.dumps(c) for c in calls} \
        == {json.dumps(c) for c in grid}
    rec = tune.TuneCache().get(tune.TuneCache().key("glm_score", common.CUDA,
                                                    info))
    assert rec["config"] == cfg and len(rec["candidates"]) == len(grid)
    # the next consult is the cached record: no sweep
    calls.clear()
    assert tune.consult("glm_score", common.CUDA, info, run) == cfg
    assert not calls


def test_lookup_reads_the_disk_once_per_call(tmp_path, monkeypatch):
    cache = tune.TuneCache(tmp_path)
    info = {"dtype": "float32", "n": 512, "d": 128}
    reads = []
    get = tune.TuneCache.get
    monkeypatch.setattr(tune.TuneCache, "get",
                        lambda self, key: reads.append(key) or get(self, key))
    tune.forget()
    for _ in range(5):
        assert tune.lookup("glm_grad", common.CUDA, info, cache=cache) is None
    assert len(reads) == 1          # a memoised miss stays a miss ...
    _put(cache, "glm_grad", info, {"block_rows": 64})
    for _ in range(5):
        assert tune.lookup("glm_grad", common.CUDA, info, cache=cache) == {
            "block_rows": 64}
    assert len(reads) == 2          # ... until a record is written
    # a wrapper's key and lazily built info: the info is built once
    built = []

    def info_fn():
        built.append(1)
        return info

    for _ in range(3):
        tune.lookup("glm_grad", common.CUDA, info_fn, cache=cache,
                    key=(torch.float32, 512, 128))
    assert len(built) == 1 and len(reads) == 3
    tune.forget()


def test_an_infeasible_cached_winner_is_a_miss(tmp_path):
    """``shape_class`` buckets k = 69 and k = 100 together; 59 rows of 69
    words fit a flat run, 59 rows of 100 do not."""
    cache = tune.TuneCache(tmp_path)
    tuned = {"dtype": "float32", "sparse": True, "n": 128, "d": 300, "k": 69}
    _put(cache, "glm_score", tuned, {"block_rows": 59})
    assert tune.lookup("glm_score", common.CUDA, tuned, cache=cache) == {
        "block_rows": 59}
    wider = {**tuned, "k": 100}
    assert cache.key("glm_score", common.CUDA, wider) \
        == cache.key("glm_score", common.CUDA, tuned)
    miss = metrics.counter("kernel.tune_cache.miss.glm_score")
    before = miss.value
    assert tune.lookup("glm_score", common.CUDA, wider, cache=cache) is None
    assert miss.value == before + 1


def _family_calls():
    """(family, tunable, info of the call, the call) on CPU tensors."""
    g = torch.Generator().manual_seed(0)
    X, y, w = torch.randn(40, 6, generator=g), torch.ones(40), torch.randn(6)
    v = torch.randn(40, 4, generator=g)
    i = torch.randint(0, 6, (40, 4), generator=g, dtype=torch.int32)
    q = torch.randn(1, 4, 1, 16, generator=g).bfloat16()
    k = torch.randn(1, 2, 300, 16, generator=g).bfloat16()
    return (
        ("glm_grad", "block_rows", {"dtype": "float32", "n": 40, "d": 6},
         lambda: tk.glm_grad("lr", w, X, y), 16),
        ("glm_sgd", "micro_batch",
         {"dtype": "float32", "n": 40, "d": 6, "replicas": 1},
         lambda: tk.glm_sgd_epoch("lr", w, X, y, step=0.1), 4),
        ("glm_score", "block_rows",
         {"dtype": "float32", "sparse": True, "n": 40, "d": 6, "k": 4},
         lambda: tk.glm_score("lr", w, v, i), 2),
        ("glm_sparse", "lanes",
         {"dtype": "float32", "sparse": True, "n": 40, "d": 6, "k": 4,
          "replicas": 1},
         lambda: tk.ell_glm_grad("lr", w, v, i, y), 16),
        ("glm_sgd_sparse", "micro_batch",
         {"dtype": "float32", "sparse": True, "n": 40, "d": 6, "k": 4,
          "replicas": 1},
         lambda: tk.ell_sgd_epoch("lr", w, v, i, y, step=0.1), 2),
        ("flash_attn", "splits",
         {"dtype": "bfloat16", "batch": 1, "heads_q": 4, "heads_kv": 2,
          "seq_q": 1, "seq_k": 300, "head_dim": 16},
         lambda: tk.flash_attention(q, k, k), 2),
    )


FAMILIES = [c[0] for c in _family_calls()]


@pytest.fixture
def recorded(monkeypatch):
    """``common.dispatch`` replaced by a stub that records its keywords."""
    seen = []

    def stub(kernel, dev, *args, backend=None, **kwargs):
        seen.append((kernel, backend, kwargs))
        return torch.zeros(1, 1)

    monkeypatch.setattr(common, "dispatch", stub)
    return seen


@pytest.mark.parametrize("family", FAMILIES)
def test_a_cached_winner_reaches_dispatch_as_a_keyword(family, tune_dir,
                                                        recorded):
    (_, param, info, call, value), = [c for c in _family_calls()
                                      if c[0] == family]
    _put(tune.TuneCache(), family, info, {param: value},
         backend=common.TORCH_REFERENCE)
    call()
    kernel, backend, kwargs = recorded[-1]
    assert (kernel, backend) == (family, common.TORCH_REFERENCE)
    assert kwargs[param] == value


@pytest.mark.parametrize("family", FAMILIES)
def test_without_a_record_the_plans_pick_runs(family, tune_dir, recorded):
    (_, param, _, call, _), = [c for c in _family_calls() if c[0] == family]
    call()
    kwargs = recorded[-1][2]
    if param == "micro_batch":
        from repro_torch.kernels.glm_sgd.ops import DEFAULT_MICRO_BATCH
        assert kwargs[param] == DEFAULT_MICRO_BATCH
    else:
        assert kwargs[param] is None    # the cuda flavor's own plan


@pytest.mark.parametrize("family", FAMILIES)
def test_the_plain_versions_ignore_the_geometry(family, tune_dir):
    """A cached winner changes no result of the plain versions except the
    fused epochs', whose micro-batch is part of the function."""
    (_, param, info, call, value), = [c for c in _family_calls()
                                      if c[0] == family]
    before = call()
    _put(tune.TuneCache(), family, info, {param: value},
         backend=common.TORCH_REFERENCE)
    after = call()
    if param == "micro_batch":
        assert not torch.equal(before, after)
    else:
        assert torch.equal(before, after)
