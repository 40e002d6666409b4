"""Parity of the port's serving path with the JAX reference, on the CPU.

The same seeded numpy inputs go through the reference (``glm_score`` with
``backend="pallas-interpret"``, which runs the Pallas kernel body, and its
``GLMScoreEngine``) and through the port on ``device="cpu"``, where
``glm_score`` runs its plain PyTorch version.  Scores agree to the JAX
conformance suite's fp32 tolerance, ``rtol=1e-4, atol=2e-3``; filler rows
score exactly 0.5 (LR) and 0.0 (SVM).  The port's engine tests are those
of ``tests/test_serve.py`` for ``GLMScoreEngine``, run on the port, plus
the two things the port has to add: a snapshot stays put when the tensor
it was published from is written in place, and the launch counters count
exactly under threads.  The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.glm import LINKS as JLINKS
from repro.data import synthetic as jsynthetic
from repro.kernels.glm_score import glm_score as jglm_score
from repro.obs import trace as jtrace
from repro.serve.glm import GLMScoreEngine as JEngine
from repro.serve.glm import ScoreRequest as JRequest

import repro_torch.kernels as tk
from repro_torch.kernels import common
from repro_torch.kernels.glm_score import ref as score_ref
from repro_torch.live import LiveConfig, LiveLearner, SyntheticStream
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serve.glm import (GLMScoreEngine, ModelSnapshot,
                                   ScoreRequest)

TASKS = ("lr", "svm")
SCORE_TOL = dict(rtol=1e-4, atol=2e-3)
CPU = "cpu"


def _ell(n, d, k, seed=0):
    ds = jsynthetic.make_sparse("conf", n, d, k * 0.6, k, seed=d)
    w = np.random.default_rng(seed).normal(0, 0.5, d).astype(np.float32)
    return np.array(ds.ell.values), np.array(ds.ell.indices), w


def _both(task, w, values, indices):
    ref = jglm_score(task, jnp.asarray(w), jnp.asarray(values),
                     jnp.asarray(indices), block_rows=8,
                     backend="pallas-interpret")
    out = tk.glm_score(task, torch.from_numpy(w), torch.from_numpy(values),
                       torch.from_numpy(indices))
    return out, np.asarray(ref)


# ---------------------------------------------------------------------------
# glm_score
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 40, 6), (37, 300, 12)],
                         ids=["n64", "ragged-n37"])
@pytest.mark.parametrize("task", TASKS)
def test_glm_score_matches_jax_kernel(task, shape):
    values, indices, w = _ell(*shape)
    out, ref = _both(task, w, values, indices)
    assert out.dtype == torch.float32 and out.shape == (shape[0],)
    np.testing.assert_allclose(out.numpy(), ref, **SCORE_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_score_filler_rows_score_link_of_zero_exactly(task):
    values, indices, w = _ell(24, 64, 8, seed=2)
    values[[3, 10, 23]] = 0.0
    indices[[3, 10, 23]] = 0
    out, ref = _both(task, w, values, indices)
    want = 0.5 if task == "lr" else 0.0
    assert (out.numpy()[[3, 10, 23]] == want).all()
    assert (ref[[3, 10, 23]] == want).all()
    np.testing.assert_allclose(out.numpy(), ref, **SCORE_TOL)


@pytest.mark.parametrize("bad", [-1, 64])
def test_glm_score_refuses_out_of_range_indices(bad):
    values, indices, w = _ell(16, 64, 8)
    indices[5, 0] = bad
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        tk.glm_score("lr", torch.from_numpy(w), torch.from_numpy(values),
                     torch.from_numpy(indices))


def test_glm_score_registry_and_shape_errors():
    assert common.backends_for("glm_score") == (common.CUDA,
                                                common.TORCH_REFERENCE)
    values, indices, w = _ell(8, 32, 4)
    v, i, wt = (torch.from_numpy(a) for a in (values, indices, w))
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        tk.glm_score("lr", wt, v, i, backend="cuda")
    with pytest.raises(ValueError, match="glm_score shapes"):
        tk.glm_score("lr", wt, v, i[:, :2])
    with pytest.raises(ValueError, match="unknown task"):
        tk.glm_score("poisson", wt, v, i)
    np.testing.assert_array_equal(
        score_ref.glm_score_ref("svm", wt, v, i).numpy(),
        torch.sum(v * wt[i.long()], dim=1).numpy())


def test_launch_counter_counts_exactly_under_threads():
    """A registered cuda flavor called from several threads at once: no
    increment is lost (the live path launches from two threads)."""
    name = "thread_count_probe"

    @common.register_kernel(name, common.CUDA)
    def _probe():
        common.count_launch(name)

    per_thread, n_threads = 5000, 8
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)      # switch threads as often as possible
    try:
        common.reset_launches()
        threads = [threading.Thread(target=lambda: [
            common._REGISTRY[name][common.CUDA]() for _ in range(per_thread)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert common.LAUNCHES[name] == per_thread * n_threads
        common.reset_launches()
        assert common.LAUNCHES[name] == 0
        # the count is taken under the counters' lock: while another
        # holder has it, a launch's increment waits (CPython's GIL alone
        # does not promise that ``+=`` on a dict entry is atomic)
        with common._LAUNCH_LOCK:
            th = threading.Thread(target=common._REGISTRY[name][common.CUDA])
            th.start()
            th.join(timeout=0.2)
            assert th.is_alive() and common.LAUNCHES[name] == 0
        th.join(timeout=10)
        assert not th.is_alive() and common.LAUNCHES[name] == 1
    finally:
        sys.setswitchinterval(saved)
        common._REGISTRY.pop(name)
        common.LAUNCHES.pop(name)


# ---------------------------------------------------------------------------
# GLMScoreEngine: the reference's engine tests, on the port
# ---------------------------------------------------------------------------


def _score_engine(task="lr", d=24, k=3, **kw):
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.4, d).astype(np.float32)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 6)
    return GLMScoreEngine(task, w, ell_width=k, device=CPU, **kw), w


def _req(rid, d=24, k=3, seed=None):
    rng = np.random.default_rng(rid if seed is None else seed)
    nn = int(rng.integers(1, k + 1))
    idx = rng.choice(d, nn, replace=False)
    return ScoreRequest(rid, rng.normal(0, 1, nn), idx)


def _oracle(task, w, req):
    m = float(np.sum(np.asarray(req.values, np.float32)
                     * w[np.asarray(req.indices, np.int64)]))
    return float(JLINKS[task](jnp.float32(m)))


def test_score_engine_scores_match_links():
    for task in TASKS:
        eng, w = _score_engine(task)
        assert eng.device == torch.device(CPU)
        reqs = [_req(i) for i in range(3)]
        for r in reqs:
            assert eng.try_admit(r)
        out = eng.flush()               # 3 real rows in a 4-row padded batch
        assert [r.rid for r in out] == [0, 1, 2]
        for resp, req in zip(out, reqs):
            assert resp.score == pytest.approx(_oracle(task, w, req),
                                               abs=1e-4)
            assert resp.model_version == 0
            assert resp.latency_s >= 0.0


def test_score_engine_bounded_fifo_rejects_when_full():
    eng, _ = _score_engine(queue_depth=2)
    assert eng.try_admit(_req(0))
    assert eng.try_admit(_req(1))
    assert not eng.try_admit(_req(2))   # bounded: reject, don't buffer
    assert len(eng) == 2
    eng.flush()
    assert eng.try_admit(_req(2))       # space freed by the flush


def test_score_engine_flush_is_fifo_across_batches():
    eng, _ = _score_engine(max_batch=2, queue_depth=8)
    for i in range(5):
        assert eng.try_admit(_req(i))
    rids = [r.rid for r in eng.drain()]
    assert rids == [0, 1, 2, 3, 4]


def test_score_engine_rejects_malformed_rows():
    eng, _ = _score_engine(k=3)
    with pytest.raises(ValueError, match="exceed"):
        eng.try_admit(ScoreRequest(0, np.ones(4), np.arange(4)))
    with pytest.raises(ValueError, match="mismatch"):
        eng.try_admit(ScoreRequest(1, np.ones(2), np.arange(3)))
    with pytest.raises(ValueError, match="unknown task"):
        GLMScoreEngine("poisson", np.ones(4), ell_width=2, device=CPU)
    # the kernel does not bounds-check its gathers: admission does
    for bad in (-1, 24):
        with pytest.raises(ValueError, match="out of range"):
            eng.try_admit(ScoreRequest(2, np.ones(2), np.array([0, bad])))
    assert len(eng) == 0


def test_score_engine_reused_batch_buffer_holds_no_stale_entries():
    """Each flush fills the engine's one host buffer anew: a short row
    after a full one scores its own nonzeros only, and a request's arrays
    written after admission do not reach the batch."""
    eng, w = _score_engine(k=3, max_batch=2, queue_depth=4)
    full = ScoreRequest(0, np.full(3, 2.0), np.array([1, 2, 3]))
    short = ScoreRequest(1, np.array([0.5]), np.array([4]))
    later = ScoreRequest(2, np.array([1.0, -1.0]), np.array([5, 6]))
    for r in (full, short):
        assert eng.try_admit(r)
    first = eng.flush()
    assert eng.try_admit(later)
    expected = [_oracle("lr", w, r) for r in (full, short, later)]
    later.values[:] = 9.0               # after admission: not served
    second = eng.flush()                # one row: the other is filler
    assert [r.rid for r in first + second] == [0, 1, 2]
    for resp, want in zip(first + second, expected):
        assert resp.score == pytest.approx(want, abs=1e-6)
    assert len(eng._free) == 1


def test_score_engine_flush_deadline_with_injected_clock():
    now = [0.0]
    eng, _ = _score_engine(max_batch=4, queue_depth=8,
                           flush_deadline_s=0.5, clock=lambda: now[0])
    assert eng.try_admit(_req(0))
    assert eng.maybe_flush() == []      # 1 of 4 rows, deadline not reached
    now[0] = 0.6
    out = eng.maybe_flush()             # oldest row overdue -> flush
    assert [r.rid for r in out] == [0]
    assert out[0].latency_s == pytest.approx(0.6)
    for i in range(1, 5):
        assert eng.try_admit(_req(i))
    assert len(eng.maybe_flush()) == 4  # full batch flushes regardless


def test_score_engine_swap_model_atomic_versioning():
    eng, w = _score_engine("svm", d=24)
    assert eng.model.version == 0
    snap = eng.swap_model(np.zeros(24, np.float32))
    assert isinstance(snap, ModelSnapshot) and snap.version == 1
    assert eng.model is snap
    assert eng.try_admit(_req(7))
    (resp,) = eng.flush()
    assert resp.model_version == 1 and resp.score == 0.0
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.swap_model(np.zeros(23, np.float32))


def test_score_engine_admission_interleavings():
    """The reference's admission property, driven by seeded interleavings
    of admit/flush/maybe_flush/swap: the bounded queue never overfills,
    responses are FIFO with no loss or duplication, and every stamped
    version was published."""
    import random

    for seed in range(20):
        rnd = random.Random(seed)
        eng, w = _score_engine("lr", max_batch=3, queue_depth=5)
        pending = [_req(i) for i in range(rnd.randint(1, 12))]
        admitted, responses, version = [], [], 0
        for _ in range(rnd.randint(0, 20)):
            op = rnd.choice(["admit", "flush", "maybe", "swap"])
            assert len(eng) <= eng.queue_depth
            if op == "admit" and pending:
                full = len(eng) >= eng.queue_depth
                ok = eng.try_admit(pending[0])
                assert ok == (not full)
                if ok:
                    admitted.append(pending.pop(0))
            elif op == "flush":
                responses.extend(eng.flush())
            elif op == "maybe":
                responses.extend(eng.maybe_flush())
            elif op == "swap":
                version += 1
                eng.swap_model(np.roll(w, version))
        responses.extend(eng.drain())
        assert len(eng) == 0
        assert [r.rid for r in responses] == [r.rid for r in admitted]
        assert all(0 <= r.model_version <= version for r in responses)


def test_score_engine_hot_swap_chaos():
    """Score a steady request stream while swap_model fires from another
    thread: every response matches the oracle under exactly the ONE
    snapshot version it is stamped with, and the stream keeps flowing."""
    d, k, n_swaps = 32, 4, 25
    rng = np.random.default_rng(11)
    models = {v: rng.normal(0, 0.5, d).astype(np.float32)
              for v in range(n_swaps + 1)}
    eng = GLMScoreEngine("svm", models[0], ell_width=k, max_batch=8,
                         queue_depth=32, device=CPU)
    stop = threading.Event()

    def swapper():
        for v in range(1, n_swaps + 1):
            eng.swap_model(models[v])
            time.sleep(0.002)
        stop.set()

    th = threading.Thread(target=swapper)
    responses, reqs, rid = [], {}, 0
    th.start()
    try:
        while not stop.is_set() or rid == 0:
            for _ in range(8):
                r = _req(rid, d=d, k=k)
                reqs[rid] = r
                assert eng.try_admit(r)
                rid += 1
            batch = eng.flush()
            assert batch, "throughput dropped to zero mid-stream"
            responses.extend(batch)
    finally:
        th.join(timeout=60)
    assert not th.is_alive()
    for _ in range(8):
        r = _req(rid, d=d, k=k)
        reqs[rid] = r
        assert eng.try_admit(r)
        rid += 1
    responses.extend(eng.drain())
    assert [r.rid for r in responses] == list(range(rid))  # nothing lost
    mismatched = [
        (resp.rid, resp.model_version) for resp in responses
        if resp.score != pytest.approx(
            _oracle("svm", models[resp.model_version], reqs[resp.rid]),
            abs=1e-4)]
    assert not mismatched, f"responses inconsistent w/ snapshot: {mismatched}"
    versions = {r.model_version for r in responses}
    assert len(versions) >= 2, "swaps never interleaved with scoring"
    assert max(versions) == n_swaps     # the last published model served


@pytest.mark.parametrize("task", TASKS)
def test_score_engine_matches_jax_engine_with_mid_stream_swap(task):
    """One request stream with one swap halfway through both engines:
    equal versions, scores within tolerance, in admission order."""
    d, k, n = 48, 6, 40
    rng = np.random.default_rng(5)
    w0, w1 = (rng.normal(0, 0.5, d).astype(np.float32) for _ in range(2))
    jeng = JEngine(task, jnp.asarray(w0), ell_width=k, max_batch=8,
                   queue_depth=64, backend="pallas-interpret", block_rows=8)
    teng = GLMScoreEngine(task, w0, ell_width=k, max_batch=8,
                          queue_depth=64, device=CPU)
    out = {"jax": [], "torch": []}
    for rid in range(n):
        r = _req(rid, d=d, k=k)
        assert jeng.try_admit(JRequest(rid, r.values, r.indices))
        assert teng.try_admit(r)
        if rid == n // 2:
            out["jax"] += jeng.drain()
            out["torch"] += teng.drain()
            jeng.swap_model(jnp.asarray(w1))
            teng.swap_model(w1)
    out["jax"] += jeng.drain()
    out["torch"] += teng.drain()
    assert [r.rid for r in out["torch"]] == [r.rid for r in out["jax"]] \
        == list(range(n))
    assert [r.model_version for r in out["torch"]] == \
        [r.model_version for r in out["jax"]]
    assert {r.model_version for r in out["torch"]} == {0, 1}
    np.testing.assert_allclose([r.score for r in out["torch"]],
                               [r.score for r in out["jax"]], **SCORE_TOL)


def test_snapshot_immune_to_in_place_writes():
    """swap_model stores a copy: writing the published tensor in place,
    or a learner's anchor after it was published, moves no served
    score."""
    d, k = 32, 4
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.normal(0, 0.5, d).astype(np.float32))
    eng = GLMScoreEngine("lr", np.zeros(d, np.float32), ell_width=k,
                         max_batch=4, device=CPU)
    reqs = [_req(i, d=d, k=k) for i in range(4)]

    def scores():
        for r in reqs:
            assert eng.try_admit(r)
        return [r.score for r in eng.drain()]

    eng.swap_model(w)
    before = scores()
    w.mul_(-3.0).add_(1.0)              # the caller writes its tensor
    assert scores() == before
    assert not torch.equal(eng.model.w, w)

    stream = SyntheticStream(n_batch=32, d=d, max_nnz=k, seed=1)
    lrn = LiveLearner(LiveConfig(replicas=2, step_size=0.2, merge_every=1),
                      stream, device=CPU).run(3)
    eng.swap_model(lrn.merged_model, step=lrn.steps)
    published = scores()
    lrn.anchor.add_(10.0)               # a learner that wrote in place
    lrn.W.zero_()
    assert scores() == published
    lrn.run(2)                          # the learner itself never does
    assert scores() == published


# ---------------------------------------------------------------------------
# telemetry: the port's tracer and metrics beside the reference's
# ---------------------------------------------------------------------------


def test_tracers_of_both_packages_write_separate_files(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TRACE_TAG", "both")
    jtrace.refresh()
    ttrace.refresh()
    try:
        with jtrace.span("ref.span"):
            pass
        with ttrace.span("port.span", rows=3):
            ttrace.instant("port.instant")
        assert ttrace.current_path() != jtrace.current_path()
        assert tmetrics.sidecar_path().name.startswith("metrics-both-torch-")
    finally:
        monkeypatch.delenv("REPRO_TRACE")
        jtrace.refresh()
        ttrace.refresh()
    port_file, = tmp_path.glob("trace-both-torch-*.jsonl")
    lines = [json.loads(ln) for ln in port_file.read_text().splitlines()]
    assert lines[0]["kind"] == "meta" and lines[0]["schema"] == 1
    assert lines[0]["tag"] == "both"
    assert [(ln["kind"], ln["name"]) for ln in lines[1:]] == [
        ("instant", "port.instant"), ("span", "port.span")]
    assert lines[2]["args"] == {"rows": 3} and lines[2]["depth"] == 0
    ref_files = [p for p in tmp_path.glob("trace-both-*.jsonl")
                 if p != port_file]
    assert len(ref_files) == 1
    assert "port.span" not in ref_files[0].read_text()


def test_port_tracer_disabled_is_the_shared_noop(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    ttrace.refresh()
    assert not ttrace.enabled() and ttrace.current_path() is None
    assert ttrace.span("x", a=1) is ttrace.NOOP
    assert ttrace.instant("x") is None


def test_port_metrics_registry_snapshot():
    tmetrics.reset()
    tmetrics.counter("serve.batches").inc()
    tmetrics.counter("serve.batches").inc(2)
    tmetrics.gauge("q").set(4)
    h = tmetrics.histogram("lat")
    for v in (2e-6, 5e-3, 500.0):
        h.observe(v)
    snap = tmetrics.snapshot()
    assert snap["schema"] == 1
    assert snap["counters"] == {"serve.batches": 3}
    assert snap["gauges"] == {"q": 4.0}
    assert snap["histograms"]["lat"]["count"] == 3
    assert snap["histograms"]["lat"]["counts"][-1] == 1   # overflow bucket
    with pytest.raises(TypeError, match="already registered"):
        tmetrics.gauge("serve.batches")
    tmetrics.reset()
