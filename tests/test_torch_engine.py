"""Parity of the port's SGD engine and its building blocks with the JAX
reference, on the CPU.

The same seeded data goes through ``repro.core.sgd.run`` with
``kernel_backend="pallas-interpret"`` (the Pallas kernel bodies) and through
``repro_torch.core.sgd.run`` on ``device="cpu"`` (the plain PyTorch
versions of the port's kernels).  Per-epoch losses agree to
``rtol=1e-4, atol=1e-4``.  LR is compared over several epochs; SVM one
epoch at a time, because its hinge pull flips for a margin within
round-off of 1.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import convergence as jconv
from repro.core import glm as jglm
from repro.core import sgd as jsgd
from repro.core import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.obs import trace as jtrace

from repro_torch import convert
from repro_torch.core import convergence as tconv
from repro_torch.core import glm as tglm
from repro_torch.core import sgd as tsgd
from repro_torch.core import sparse as tsparse
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import common
from repro_torch.obs import trace as ttrace

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = "cpu"
N, D = 128, 16


@pytest.fixture(scope="module")
def dense():
    ds = jsyn.make_dense("dense", N, D, seed=7)
    return ds.X, ds.y


@pytest.fixture(scope="module")
def ell():
    ds = jsyn.make_sparse("sp", N, 64, 5.0, 8, seed=4)
    return np.asarray(ds.ell.values), np.asarray(ds.ell.indices), ds.y


def _problems(task, data, sparse_data, step):
    if sparse_data:
        values, indices, y = data
        jp = (task, jsparse.ELLMatrix(jnp.asarray(values), jnp.asarray(indices),
                                      64), jnp.asarray(y), step)
        tp = (task, convert.ell_from_reference(values, indices, 64, CPU),
              torch.from_numpy(np.array(y)), step)
        return jp, tp
    X, y = data
    jp = jglm.GLMProblem(task, jnp.asarray(X), jnp.asarray(y), step)
    return jp, convert.problem_from_reference(task, X, y, step, CPU)


def _port_strategy(jstrat):
    return getattr(tsgd, type(jstrat).__name__)(
        **{f.name: getattr(jstrat, f.name) for f in dataclasses.fields(jstrat)
           if f.name != "kernel_backend"})


def _both(task, data, jstrat, epochs, step, sparse_data=False):
    jp, tp = _problems(task, data, sparse_data, step)
    tstrat = _port_strategy(jstrat)
    ref = jsgd.run(jp, dataclasses.replace(jstrat,
                                           kernel_backend="pallas-interpret"),
                   epochs, sparse_data=sparse_data)
    out = tsgd.run(tp, tstrat, epochs, sparse_data=sparse_data)
    return ref, out


DENSE_STRATEGIES = [
    (jsgd.SyncSGD(), 5e-4),
    (jsgd.SyncSGD(batch=16), 0.05),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=1), 5e-3),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=4), 0.02),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=4, access="round_robin"), 0.02),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=1, access="round_robin",
                        rep_k=3), 5e-3),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=4, rep_k=4,
                        merge_every=0.5), 0.02),
]

SPARSE_STRATEGIES = [
    (jsgd.SyncSGD(), 5e-3),
    (jsgd.SyncSGD(batch=16), 0.1),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=4), 0.1),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=N // 4), 0.5),
    (jsgd.AsyncLocalSGD(replicas=4, local_batch=1, access="round_robin",
                        rep_k=2), 0.05),
]


def _id(case):
    return case[0].name


@pytest.mark.parametrize("case", DENSE_STRATEGIES, ids=_id)
def test_run_dense_lr_losses_match_jax(case, dense):
    ref, out = _both("lr", dense, case[0], 3, case[1])
    assert out.strategy == case[0].name and out.task == "lr"
    assert out.losses.shape == (4,) and out.epoch_times.shape == (3,)
    assert out.losses[-1] < out.losses[0]
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


@pytest.mark.parametrize("case", SPARSE_STRATEGIES, ids=_id)
def test_run_sparse_lr_losses_match_jax(case, ell):
    ref, out = _both("lr", ell, case[0], 3, case[1], sparse_data=True)
    assert out.losses[-1] < out.losses[0]
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


@pytest.mark.parametrize("case", DENSE_STRATEGIES[:4], ids=_id)
def test_run_dense_svm_one_epoch_matches_jax(case, dense):
    ref, out = _both("svm", dense, case[0], 1, case[1])
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


@pytest.mark.parametrize("case", SPARSE_STRATEGIES[:4], ids=_id)
def test_run_sparse_svm_one_epoch_matches_jax(case, ell):
    ref, out = _both("svm", ell, case[0], 1, case[1], sparse_data=True)
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


@pytest.mark.parametrize("case", [DENSE_STRATEGIES[1], DENSE_STRATEGIES[3]],
                         ids=_id)
def test_run_result_carries_the_final_state(case, dense):
    """``RunResult.model`` is the state the last loss was taken of, and
    equals the reference run's final state (the scoring engine serves it)."""
    jstrat, step = case
    jp, tp = _problems("lr", dense, False, step)
    _, out = _both("lr", dense, jstrat, 2, step)
    init, _, loss_fn, _ = tsgd.make_epoch_fn(tp, _port_strategy(jstrat))
    assert out.model.shape == init.shape
    assert float(loss_fn(out.model)) == pytest.approx(out.losses[-1], rel=1e-6)
    jinit, jepoch, _, _ = jsgd.make_epoch_fn(jp, dataclasses.replace(
        jstrat, kernel_backend="pallas-interpret"))
    jstate = jinit
    for _ in range(2):
        jstate = jepoch(jstate)
    np.testing.assert_allclose(out.model.numpy(), np.asarray(jstate), **TOL)


@pytest.mark.parametrize("sparse_data", [False, True])
def test_epoch_from_random_state_carried_across(sparse_data, dense, ell):
    """A random replica stack, moved over by convert.state_from_reference,
    gives the same next state and loss on both sides."""
    strat = jsgd.AsyncLocalSGD(replicas=4, local_batch=4)
    data, d = (ell, 64) if sparse_data else (dense, D)
    jp, tp = _problems("lr", data, sparse_data, 0.05)
    W0 = np.random.default_rng(3).normal(0, 0.3, (4, d)).astype(np.float32)
    _, jepoch, jloss, _ = jsgd.make_epoch_fn(
        jp, dataclasses.replace(strat, kernel_backend="pallas-interpret"),
        sparse_data=sparse_data)
    _, tepoch, tloss, merges = tsgd.make_epoch_fn(
        tp, tsgd.AsyncLocalSGD(replicas=4, local_batch=4),
        sparse_data=sparse_data)
    assert merges == 1
    W_t = convert.state_from_reference(jnp.asarray(W0), CPU)
    assert W_t.dtype == torch.float32 and W_t.shape == (4, d)
    ref = jepoch(jnp.asarray(W0))
    out = tepoch(W_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(float(tloss(out)), float(jloss(ref)), **TOL)


def test_sync_minibatch_takes_a_ragged_n(dense):
    """The sync mini-batch path accepts n % batch != 0 (tail at step/|tail|),
    as the reference's ragged-tail oracle flavor does."""
    X, y = dense
    jp = jglm.GLMProblem("lr", jnp.asarray(X[:100]), jnp.asarray(y[:100]), 0.05)
    tp = convert.problem_from_reference("lr", X[:100], y[:100], 0.05, CPU)
    ref = jsgd.run(jp, jsgd.SyncSGD(batch=16, kernel_backend="reference"), 3)
    out = tsgd.run(tp, tsgd.SyncSGD(batch=16), 3)
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


#: news' width (Table 3): past a block's shared memory for every kernel
NEWS_D = 1_355_191


def _news_rows(n, k, seed):
    """ELL rows at news' width: 1..k nonzeros a row (value-0 padding at
    index 0 after them), indices anywhere in [0, NEWS_D), labels +-1."""
    rng = np.random.default_rng(seed)
    live = np.arange(k)[None] < rng.integers(1, k + 1, n)[:, None]
    values = (rng.normal(0, 1, (n, k)) * live).astype(np.float32)
    indices = (rng.integers(0, NEWS_D, (n, k)) * live).astype(np.int32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return values, indices, y


@pytest.mark.parametrize("task", ["lr", "svm"])
def test_run_sparse_at_news_width_matches_jax(task):
    """Table 7's news runs (AsyncLocalSGD at local_batch 1) on 36 rows at
    d = 1,355,191: the shape whose glm_sgd_sparse kernel keeps the model in
    global memory (the first port raised there), against the JAX engine."""
    values, indices, y = _news_rows(36, 24, seed=11)
    strat = jsgd.AsyncLocalSGD(replicas=2, local_batch=1)
    jp = (task, jsparse.ELLMatrix(jnp.asarray(values), jnp.asarray(indices),
                                  NEWS_D), jnp.asarray(y), 0.5)
    tp = (task, convert.ell_from_reference(values, indices, NEWS_D, CPU),
          torch.from_numpy(y), 0.5)
    epochs = 3 if task == "lr" else 1
    ref = jsgd.run(jp, dataclasses.replace(strat, kernel_backend="reference"),
                   epochs, sparse_data=True)
    out = tsgd.run(tp, _port_strategy(strat), epochs, sparse_data=True)
    assert out.losses[-1] < out.losses[0]
    assert out.model.shape == (2, NEWS_D)
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)


def test_run_takes_record_time_like_the_reference(dense):
    """``record_time=False`` is accepted, and the run is the same run."""
    _, tp = _problems("lr", dense, False, 0.05)
    strat = tsgd.SyncSGD(batch=16)
    out = tsgd.run(tp, strat, 3, record_time=False)
    base = tsgd.run(tp, strat, 3)
    np.testing.assert_array_equal(out.losses, base.losses)
    assert out.epoch_times.shape == (3,)


def _spans(path):
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    return [(ln["name"], tuple(sorted(ln.get("args", {}))))
            for ln in lines if ln["kind"] == "span"]


@pytest.mark.parametrize("sparse_data", [False, True])
def test_traced_run_records_the_references_engine_spans(
        sparse_data, dense, ell, tmp_path, monkeypatch):
    """A traced run writes ``engine.compile`` around the first epoch and
    ``engine.epoch`` around each timed one with the reference's attribute
    keys, and a ``kernel.dispatch`` (kernel, backend) inside each epoch."""
    data = ell if sparse_data else dense
    jp, tp = _problems("lr", data, sparse_data, 0.05)
    jstrat = jsgd.AsyncLocalSGD(replicas=4, local_batch=4,
                                kernel_backend="reference")
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TRACE_TAG", "engine")
    jtrace.refresh()
    ttrace.refresh()
    try:
        jsgd.run(jp, jstrat, 3, sparse_data=sparse_data)
        tsgd.run(tp, _port_strategy(jstrat), 3, sparse_data=sparse_data)
    finally:
        monkeypatch.delenv("REPRO_TRACE")
        jtrace.refresh()
        ttrace.refresh()
    port_file, = tmp_path.glob("trace-engine-torch-*.jsonl")
    ref_file, = [p for p in tmp_path.glob("trace-engine-*.jsonl")
                 if p != port_file]
    engine = [sp for sp in _spans(port_file) if sp[0].startswith("engine.")]
    assert engine == [sp for sp in _spans(ref_file)
                      if sp[0].startswith("engine.")]
    assert engine == [("engine.compile", ("strategy", "task"))] + [
        ("engine.epoch", ("epoch", "merges", "strategy"))] * 2
    dispatch = [sp for sp in _spans(port_file) if sp[0] == "kernel.dispatch"]
    assert dispatch == [("kernel.dispatch", ("backend", "kernel"))] * 3
    assert ("kernel.dispatch", ("backend", "kernel")) in _spans(ref_file)
    lines = [json.loads(ln) for ln in port_file.read_text().splitlines()]
    kernel = "glm_sgd_sparse" if sparse_data else "glm_sgd"
    assert {ln["args"]["kernel"] for ln in lines
            if ln.get("name") == "kernel.dispatch"} == {kernel}
    assert {ln["args"]["backend"] for ln in lines
            if ln.get("name") == "kernel.dispatch"} == {common.TORCH_REFERENCE}


def test_merge_every_above_one_merges_every_epoch_like_the_reference(dense):
    ref, out = _both("lr", dense,
                     jsgd.AsyncLocalSGD(replicas=4, local_batch=4,
                                        merge_every=2.0), 3, 0.02)
    np.testing.assert_allclose(out.losses, ref.losses, **TOL)
    _, every = _both("lr", dense, jsgd.AsyncLocalSGD(replicas=4, local_batch=4),
                     3, 0.02)
    np.testing.assert_allclose(out.losses, every.losses, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sparse_data", [False, True])
def test_async_rejects_local_batch_not_dividing_partition(sparse_data, dense, ell):
    _, tp = _problems("lr", ell if sparse_data else dense, sparse_data, 0.1)
    with pytest.raises(ValueError, match="divide the"):
        tsgd.make_epoch_fn(tp, tsgd.AsyncLocalSGD(replicas=4, local_batch=5),
                           sparse_data=sparse_data)


def test_sparse_problem_rejects_out_of_range_indices(ell):
    values, indices, y = ell
    bad = indices.copy()
    bad[0, 0] = 64
    tp = ("lr", convert.ell_from_reference(values, bad, 64, CPU),
          torch.from_numpy(np.array(y)), 0.1)
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        tsgd.make_epoch_fn(tp, tsgd.SyncSGD(), sparse_data=True)


def test_strategy_names_and_fields_match():
    for j in [jsgd.SyncSGD(), jsgd.SyncSGD(batch=16, kernel_backend="cuda"),
              jsgd.AsyncLocalSGD(replicas=3, local_batch=2, merge_every=0.25,
                                 access="round_robin", rep_k=1)]:
        fields = [f.name for f in dataclasses.fields(j)]
        t = getattr(tsgd, type(j).__name__)(**{f: getattr(j, f) for f in fields})
        assert [f.name for f in dataclasses.fields(t)] == fields
        assert t.name == j.name


@pytest.mark.parametrize("access", ["chunk", "round_robin"])
@pytest.mark.parametrize("n,replicas,rep_k", [(64, 4, 0), (67, 4, 3),
                                              (30, 3, 25), (8, 8, 1)])
def test_partition_indices_equal(access, n, replicas, rep_k):
    np.testing.assert_array_equal(
        tsgd.partition_indices(n, replicas, access, rep_k),
        jsgd.partition_indices(n, replicas, access, rep_k))


def test_merge_replicas_matches():
    W = np.random.default_rng(0).normal(0, 1, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tsgd.merge_replicas(torch.from_numpy(W)).numpy(),
        np.asarray(jsgd.merge_replicas(jnp.asarray(W))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Synthetic data: byte-identical for the same seed
# ---------------------------------------------------------------------------


def test_make_dense_is_byte_identical():
    j = jsyn.make_dense("x", 300, 13, seed=5)
    t = tsyn.make_dense("x", 300, 13, seed=5, device=CPU)
    assert t.X.numpy().tobytes() == j.X.tobytes()
    assert t.y.numpy().tobytes() == j.y.tobytes()


@pytest.mark.parametrize("pad_to", [None, 6])
def test_make_sparse_is_byte_identical(pad_to):
    j = jsyn.make_sparse("s", 200, 50, 4.0, 9, seed=2, pad_to=pad_to)
    t = tsyn.make_sparse("s", 200, 50, 4.0, 9, seed=2, pad_to=pad_to, device=CPU)
    assert t.ell.values.numpy().tobytes() == np.asarray(j.ell.values).tobytes()
    assert t.ell.indices.numpy().tobytes() == np.asarray(j.ell.indices).tobytes()
    assert t.ell.indices.dtype == torch.int32 and t.ell.d == j.ell.d
    assert t.y.numpy().tobytes() == j.y.tobytes()


@pytest.mark.parametrize("name", ["covtype", "w8a", "real-sim"])
def test_paper_dataset_is_byte_identical(name):
    assert tsyn.PAPER_DATASETS == jsyn.PAPER_DATASETS
    j = jsyn.paper_dataset(name, max_n=120, seed=1)
    t = tsyn.paper_dataset(name, max_n=120, seed=1, device=CPU)
    assert (t.n, t.d, t.dense) == (j.n, j.d, j.dense)
    if j.dense:
        assert t.X.numpy().tobytes() == j.X.tobytes()
    else:
        assert t.ell.values.numpy().tobytes() == np.asarray(j.ell.values).tobytes()
        assert t.ell.indices.numpy().tobytes() == np.asarray(j.ell.indices).tobytes()
    assert t.y.numpy().tobytes() == j.y.tobytes()


@pytest.mark.parametrize("name", ["covtype", "w8a"])
def test_datasets_and_ell_builders_default_to_the_card(name, monkeypatch):
    """Without ``device`` every tensor a builder makes goes where
    ``common.device()`` says (``cuda``); "meta" stands in for the card."""
    monkeypatch.setattr(common, "device",
                        lambda dev=None: torch.device("meta" if dev is None else dev))
    ds = tsyn.paper_dataset(name, max_n=64, seed=1)
    made = [ds.y, ds.X] if ds.dense else [ds.y, ds.ell.values, ds.ell.indices]
    rows_idx = [np.array([0, 3], np.int32), np.array([1], np.int32)]
    rows_val = [np.ones(2, np.float32), np.ones(1, np.float32)]
    made += list(tsparse.from_rows(rows_idx, rows_val, 4)[:2])
    made += list(tsparse.from_csr_parts(rows_idx, rows_val, 4).to_ell()[:2])
    assert {t.device.type for t in made} == {"meta"}
    cpu = tsyn.paper_dataset(name, max_n=64, seed=1, device=CPU)
    assert cpu.y.device.type == "cpu"


def test_w8a_pads_to_69():
    N, d, avg, mx, _ = tsyn.PAPER_DATASETS["w8a"]
    assert min(mx, max(int(avg * 6), 8)) == 69


# ---------------------------------------------------------------------------
# core.glm and core.sparse against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["lr", "svm"])
def test_glm_paths_match(task, dense):
    X, y = dense
    w = np.random.default_rng(1).normal(0, 0.3, D).astype(np.float32)
    jw, jX, jy = jnp.asarray(w), jnp.asarray(X), jnp.asarray(y)
    tw, tX, ty = (torch.from_numpy(np.array(a)) for a in (w, X, y))
    pairs = [
        (tglm.LOSSES[task](tw, tX, ty), jglm.LOSSES[task](jw, jX, jy)),
        (tglm.grad_fused(task, tw, tX, ty), jglm.grad_fused(task, jw, jX, jy)),
        (tglm.grad_primitive_composition(task, tw, tX, ty),
         jglm.grad_primitive_composition(task, jw, jX, jy)),
        (tglm.loss_and_grad(task, tw, tX, ty)[0],
         jglm.loss_and_grad(task, jw, jX, jy)[0]),
        (tglm.loss_and_grad(task, tw, tX, ty)[1],
         jglm.loss_and_grad(task, jw, jX, jy)[1]),
        (tglm.LINKS[task](tX @ tw), jglm.LINKS[task](jX @ jw)),
        (tglm.batch_gd_epoch(task, tw, tX, ty, 1e-3),
         jglm.batch_gd_epoch(task, jw, jX, jy, 1e-3)),
        (tglm.minibatch_epoch(task, tw, tX, ty, 0.05, 8),
         jglm.minibatch_epoch(task, jw, jX, jy, 0.05, 8)),
        (tglm.incremental_epoch(task, tw, tX[:32], ty[:32], 0.01),
         jglm.incremental_epoch(task, jw, jX[:32], jy[:32], 0.01)),
        (tglm.full_loss(tglm.GLMProblem(task, tX, ty, 0.1), tw),
         jglm.full_loss(jglm.GLMProblem(task, jX, jy, 0.1), jw)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("task", ["lr", "svm"])
def test_sparse_paths_match(task, ell):
    values, indices, y = ell
    w = np.random.default_rng(2).normal(0, 0.3, 64).astype(np.float32)
    jm = jsparse.ELLMatrix(jnp.asarray(values), jnp.asarray(indices), 64)
    tm = convert.ell_from_reference(values, indices, 64, CPU)
    jw, jy = jnp.asarray(w), jnp.asarray(y)
    tw, ty = torch.from_numpy(w), torch.from_numpy(np.array(y))
    pairs = [
        (tsparse.margins(tm, tw), jsparse.margins(jm, jw)),
        (tsparse.grad(task, tm, ty, tw), jsparse.grad(task, jm, jy, jw)),
        (tsparse.loss(task, tm, ty, tw), jsparse.loss(task, jm, jy, jw)),
        (tsparse.minibatch_epoch(task, tw, tm, ty, 0.1, 8),
         jsparse.minibatch_epoch(task, jw, jm, jy, 0.1, 8)),
        (tsparse.incremental_epoch(task, tw, tm, ty, 0.05),
         jsparse.incremental_epoch(task, jw, jm, jy, 0.05)),
        (tsparse.to_dense(tm), jsparse.to_dense(jm)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=2e-3)


def test_csr_matches():
    rng = np.random.default_rng(0)
    rows_idx = [np.sort(rng.choice(20, size=k, replace=False)).astype(np.int32)
                for k in (3, 1, 5, 2)]
    rows_val = [rng.normal(0, 1, len(r)).astype(np.float32) for r in rows_idx]
    j = jsparse.from_csr_parts(rows_idx, rows_val, 20)
    t = tsparse.from_csr_parts(rows_idx, rows_val, 20)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a, b)
    for pad in (None, 2):
        je, te = j.to_ell(pad), t.to_ell(pad, device=CPU)
        np.testing.assert_array_equal(te.values.numpy(), np.asarray(je.values))
        np.testing.assert_array_equal(te.indices.numpy(), np.asarray(je.indices))
    np.testing.assert_array_equal(t.select([2, 0]).to_dense(),
                                  j.select([2, 0]).to_dense())
    fr = tsparse.from_rows(rows_idx, rows_val, 20, device=CPU)
    np.testing.assert_array_equal(fr.values.numpy(),
                                  np.asarray(jsparse.from_rows(rows_idx, rows_val, 20).values))
    assert (t.n, t.nnz, t.avg_nnz, fr.shape, fr.max_nnz) == \
        (j.n, j.nnz, j.avg_nnz, (4, 20), 5)


# ---------------------------------------------------------------------------
# Convergence methodology and convert
# ---------------------------------------------------------------------------


def test_convergence_functions_match():
    assert tconv.thresholds(2.0) == jconv.thresholds(2.0)
    assert tconv.thresholds(-1.0, (0.1,)) == jconv.thresholds(-1.0, (0.1,))
    runs = [tsgd.RunResult(np.array(l), np.array([0.1, 0.2, 0.3]), "s", "lr")
            for l in ([5.0, 3.0, 2.0, 1.5], [5.0, 4.0, np.nan, np.inf],
                      [5.0, 2.9, 2.8, 2.7])]
    jruns = [jsgd.RunResult(r.losses, r.epoch_times, "s", "lr") for r in runs]
    assert tconv.optimal_loss(runs) == jconv.optimal_loss(jruns) == 1.5
    for r, jr in zip(runs, jruns):
        for by in ("time", "epochs"):
            assert tconv.rank_key(r, 2.9, by=by) == jconv.rank_key(jr, 2.9, by=by)
        assert r.epochs_to(2.9) == jr.epochs_to(2.9)
        assert r.time_to(2.9) == jr.time_to(2.9)
        assert r.time_per_epoch == jr.time_per_epoch


def test_convert_shapes_and_types():
    with pytest.raises(ValueError, match="state is w"):
        convert.state_from_reference(np.zeros((2, 2, 2)), CPU)
    w = convert.state_from_reference(np.arange(3, dtype=np.float64), CPU)
    assert w.dtype == torch.float32 and w.shape == (3,)
    p = convert.problem_from_reference("svm", np.ones((4, 3)), np.ones(4), 1, CPU)
    assert p.X.dtype == torch.float32 and p.step == 1.0 and p.task == "svm"
    m = convert.ell_from_reference(np.ones((2, 3)), np.zeros((2, 3), np.int64), 5, CPU)
    assert m.indices.dtype == torch.int32 and m.shape == (2, 5)
