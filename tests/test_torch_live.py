"""Parity of the port's live (train-while-serving) path with the JAX
reference, on the CPU.

The port's streams give byte-identical numpy batches for the same seed or
file; its libsvm parser, int8 quantizer and merge gate agree with the
reference's on the same inputs; and its ``LiveLearner`` on
``device="cpu"`` (every replica pass through the plain versions of the
port's kernel families) agrees step for step with the reference's
``LiveLearner(kernel_backend="pallas-interpret")`` (the Pallas kernel
bodies) on ``W`` and ``anchor`` at the epoch tolerance of the JAX
conformance suite, ``rtol=1e-4, atol=1e-4``.  The learner, publisher and
chaos tests of ``tests/test_live.py`` then run on the port.
"""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.glm import LINKS as JLINKS
from repro.data.ingest import libsvm as jlibsvm
from repro.live import LibsvmStream as JLibsvmStream
from repro.live import LiveConfig as JLiveConfig
from repro.live import LiveLearner as JLiveLearner
from repro.live import SyntheticStream as JSyntheticStream
from repro.optim import compress as jcompress
from repro.train.fault import Heartbeat as JHeartbeat
from repro.train.fault import MergeGate as JMergeGate

from repro_torch.data.ingest import libsvm as tlibsvm
from repro_torch.kernels import common
from repro_torch.live import (LibsvmStream, LiveConfig, LiveLearner,
                              SnapshotPublisher, SyntheticStream)
from repro_torch.optim import compress as tcompress
from repro_torch.serve.glm import GLMScoreEngine, ScoreRequest
from repro_torch.train.fault import Heartbeat, MergeGate

EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = "cpu"
D, NB = 32, 64
ROOT = Path(__file__).resolve().parents[1]
FIXTURES = sorted((ROOT / "src" / "repro" / "data" / "ingest" / "fixtures")
                  .glob("*.libsvm"))


def _stream(seed=3, **kw):
    kw.setdefault("n_batch", NB)
    kw.setdefault("d", D)
    return SyntheticStream(seed=seed, **kw)


def _cfg(**kw):
    kw.setdefault("task", "lr")
    kw.setdefault("replicas", 4)
    kw.setdefault("step_size", 0.2)
    kw.setdefault("merge_every", 2)
    return LiveConfig(**kw)


def _learner(cfg=None, stream=None, **kw):
    return LiveLearner(cfg or _cfg(), stream or _stream(), device=CPU, **kw)


def _libsvm_file(tmp_path, n_rows=25, d=10, zero_based=False):
    rng = np.random.default_rng(7)
    lo = 0 if zero_based else 1
    lines = []
    for _ in range(n_rows):
        label = int(rng.random() < 0.5)
        nnz = int(rng.integers(1, 5))
        idx = np.sort(rng.choice(np.arange(lo, d + lo), nnz, replace=False))
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in idx)
        lines.append(f"{label} {feats}")
    p = tmp_path / "stream.svm"
    p.write_text("\n".join(lines) + "\n")
    return p


def _same_batch(a, b):
    assert a.seq == b.seq
    for name in ("values", "indices", "y", "X"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


# ---------------------------------------------------------------------------
# streams, ingest, compression, the merge gate: the same bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("profile", [
    dict(d=32, avg_nnz=4.0, max_nnz=8),
    dict(d=2000, avg_nnz=51.3, max_nnz=307),
    dict(d=6, dense=True),
], ids=["sparse", "sparse-wide", "dense"])
def test_synthetic_stream_batches_are_byte_identical(profile):
    kw = dict(n_batch=48, seed=11, **profile)
    t, j = SyntheticStream(**kw), JSyntheticStream(**kw)
    assert t.ell_width == j.ell_width
    assert t.w_star.tobytes() == j.w_star.tobytes()
    for seq in (0, 1, 7):
        _same_batch(t.batch(seq), j.batch(seq))
    it_t, it_j = iter(t), iter(j)
    for _ in range(3):
        _same_batch(next(it_t), next(it_j))
    if not profile.get("dense"):
        (ell, y), (jell, jy) = t.holdout(96, device=CPU), j.holdout(96)
        assert ell.values.device == torch.device(CPU) and ell.d == jell.d
        assert ell.values.numpy().tobytes() == \
            np.asarray(jell.values).tobytes()
        assert ell.indices.numpy().tobytes() == \
            np.asarray(jell.indices).tobytes()
        assert y.tobytes() == jy.tobytes()
        assert t.n_batch == 48


def test_libsvm_stream_batches_are_byte_identical(tmp_path):
    p = _libsvm_file(tmp_path)
    t = LibsvmStream(p, n_batch=8, d=10, ell_width=4)
    j = JLibsvmStream(p, n_batch=8, d=10, ell_width=4)
    for _ in range(7):                  # wraps at EOF twice
        _same_batch(t.batch(), j.batch())
    assert len(list(LibsvmStream(p, n_batch=8, d=10, ell_width=4,
                                 loop=False))) == 3
    p0 = _libsvm_file(tmp_path, zero_based=True)
    with pytest.raises(tlibsvm.LibsvmFormatError, match="1-based"):
        LibsvmStream(p0, n_batch=8, d=10, ell_width=4).batch()
    with pytest.raises(tlibsvm.LibsvmFormatError, match="out of range"):
        LibsvmStream(p0, n_batch=8, d=5, ell_width=4, zero_based=True).batch()


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.stem)
def test_libsvm_parser_and_stream_agree_on_bundled_fixtures(path):
    assert FIXTURES, "bundled fixtures missing"
    csr, labels = tlibsvm.parse_file(path)
    jcsr, jlabels = jlibsvm.parse_file(path)
    assert csr.d == jcsr.d
    for name in ("indptr", "indices", "values"):
        a, b = getattr(csr, name), np.asarray(getattr(jcsr, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert labels.tobytes() == jlabels.tobytes()
    with open(path) as f, open(path) as g:
        rows = list(tlibsvm.iter_rows(f))
        jrows = list(jlibsvm.iter_rows(g))
    assert len(rows) == len(jrows) == csr.n
    for (la, ia, va), (lb, ib, vb) in zip(rows, jrows):
        assert la == lb and ia.tobytes() == ib.tobytes() \
            and va.tobytes() == vb.tobytes()
    k = int(csr.row_nnz.max())
    t = LibsvmStream(path, n_batch=16, d=csr.d, ell_width=k)
    j = JLibsvmStream(path, n_batch=16, d=csr.d, ell_width=k)
    for _ in range(4):
        _same_batch(t.batch(), j.batch())


def test_libsvm_write_roundtrip_matches_reference(tmp_path):
    csr, labels = tlibsvm.parse_file(FIXTURES[0])
    tlibsvm.write_libsvm(tmp_path / "t.svm", csr, labels)
    jlibsvm.write_libsvm(tmp_path / "j.svm", csr, labels)
    assert (tmp_path / "t.svm").read_bytes() == (tmp_path / "j.svm").read_bytes()
    with pytest.raises(tlibsvm.LibsvmFormatError, match="negative"):
        tlibsvm.parse_lines(["1 -3:0.5"])


@pytest.mark.parametrize("n", [256, 300, 5])
def test_quantize_leaf_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, n).astype(np.float32)
    x[0] = 127.0                      # block scale exactly 1.0 ...
    x[1:5] = (2.5, -3.5, 0.5, -0.5)   # ... so these sit halfway between steps
    if n > 256:
        x[256:] = 0.0                 # an all-zero block: scale 1
    q, s = tcompress.quantize_leaf(torch.from_numpy(x))
    jq, js = jcompress.quantize_leaf(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == jq.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 1:5].tolist() == [2, -4, 0, 0]   # half to even
    deq = tcompress.dequantize_leaf(q, s, torch.from_numpy(x))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcompress.dequantize_leaf(jq, js,
                                                          jnp.asarray(x))))
    assert tcompress.compression_ratio([torch.from_numpy(x)]) == \
        jcompress.compression_ratio(jnp.asarray(x))


def test_heartbeat_and_merge_gate_match_reference():
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731
    hb, jhb = Heartbeat(4, 5.0, clock=clock), JHeartbeat(4, 5.0, clock=clock)
    gate, jgate = MergeGate(3, hb), JMergeGate(3, jhb)
    for t, beats in ((2.0, (0, 1)), (4.0, (1,)), (6.5, (2,)), (9.0, ())):
        now[0] = 100.0 + t
        for r in beats:
            hb.beat(r)
            jhb.beat(r)
        assert gate.alive_mask().tolist() == jgate.alive_mask().tolist()
    assert gate.alive_mask().tolist() == [False, False, True, False]
    assert [gate.should_merge(s) for s in range(8)] == \
        [jgate.should_merge(s) for s in range(8)] == \
        [False, False, False, True, False, False, True, False]


# ---------------------------------------------------------------------------
# the learner, step for step against the reference
# ---------------------------------------------------------------------------


def _pair(cfg_kw, stream_kw, steps, faults=()):
    """Step both learners side by side; after every step W and the anchor
    agree.  ``faults``: (step, "kill"|"revive", replica)."""
    stream_kw = {"n_batch": NB, "d": D, "seed": 5, **stream_kw}
    cfg = dict(task="lr", replicas=4, step_size=0.2, merge_every=2, **cfg_kw)
    tl = LiveLearner(LiveConfig(**cfg), SyntheticStream(**stream_kw),
                     device=CPU)
    jl = JLiveLearner(JLiveConfig(kernel_backend="pallas-interpret", **cfg),
                      JSyntheticStream(**stream_kw))
    for i in range(steps):
        for at, what, r in faults:
            if at == i:
                getattr(tl, what)(r)
                getattr(jl, what)(r)
        tl.step()
        jl.step()
        np.testing.assert_allclose(tl.W.numpy(), np.asarray(jl.W), **EPOCH_TOL,
                                   err_msg=f"W after step {i + 1}")
        np.testing.assert_allclose(tl.anchor.numpy(), np.asarray(jl.anchor),
                                   **EPOCH_TOL,
                                   err_msg=f"anchor after step {i + 1}")
    assert (tl.steps, tl.merges, tl.merges_skipped) == \
        (jl.steps, jl.merges, jl.merges_skipped)
    return tl, jl


@pytest.mark.parametrize("compress", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("path", [
    ("dense", dict(local_batch=4), dict(dense=True, d=12)),
    ("glm_sgd_sparse", dict(local_batch=4), {}),
    ("glm_sparse", dict(local_batch=16), {}),
], ids=lambda p: p[0])
def test_live_learner_matches_reference_step_for_step(path, compress):
    _, cfg_kw, stream_kw = path
    tl, _ = _pair(dict(cfg_kw, compress=compress), stream_kw, steps=6)
    if compress:
        assert float(tl._ef.abs().sum()) > 0.0


def test_live_learner_matches_reference_through_kill_and_revive():
    faults = ((2, "kill", 1), (2, "kill", 3), (6, "revive", 1),
              (6, "revive", 3))
    for compress in (False, True):
        tl, _ = _pair(dict(local_batch=1, compress=compress), {}, steps=9,
                      faults=faults)
        assert tl.alive().all()


# ---------------------------------------------------------------------------
# the reference's learner and publisher tests, on the port
# ---------------------------------------------------------------------------


def test_live_learner_runs_on_cuda_unless_told():
    assert common.device(None) == torch.device("cuda")
    lrn = _learner()
    assert lrn.device == torch.device(CPU) and lrn.W.device == lrn.device


def test_live_learner_converges_and_merges():
    s = _stream()
    lrn = _learner(stream=s)
    ell, y = s.holdout(256, device=CPU)
    l0 = lrn.loss(ell, y)
    lrn.run(40)
    assert lrn.steps == 40 and lrn.merges == 20
    assert lrn.loss(ell, y) < 0.6 * l0
    for r in range(4):
        np.testing.assert_allclose(lrn.W[r].numpy(), lrn.anchor.numpy(),
                                   rtol=1e-6)


def test_live_learner_validates_local_batch():
    with pytest.raises(ValueError, match="local_batch must divide"):
        _learner(_cfg(local_batch=5))


def test_live_learner_compressed_merge_tracks_exact():
    s = _stream(seed=4)
    ell, y = s.holdout(256, device=CPU)
    exact = _learner(stream=s).run(30)
    comp = _learner(_cfg(compress=True), s).run(30)
    assert comp.loss(ell, y) == pytest.approx(exact.loss(ell, y), rel=0.05)
    assert float(comp._ef.abs().sum()) > 0.0


def test_live_learner_refuses_out_of_range_stream_indices():
    class Bad(SyntheticStream):
        def batch(self, seq):
            b = super().batch(seq)
            b.indices[3, 0] = self.d
            return b

    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        _learner(stream=Bad(n_batch=NB, d=D, seed=1)).step()


def test_live_learner_dead_replica_frozen_and_dropped():
    lrn = _learner()
    lrn.run(6)
    lrn.kill(2)
    assert lrn.alive().tolist() == [True, True, False, True]
    w_dead = lrn.W[2].clone()
    lrn.run(6)
    assert torch.equal(lrn.W[2], w_dead)                 # frozen
    anchor = lrn.anchor.numpy()
    assert not np.allclose(w_dead.numpy(), anchor)
    np.testing.assert_allclose(lrn.W[0].numpy(), anchor, rtol=1e-6)
    lrn.revive(2)
    np.testing.assert_array_equal(lrn.W[2].numpy(), anchor)
    lrn.run(1)
    assert not np.allclose(lrn.W[2].numpy(), anchor)    # training again


def test_live_learner_all_dead_skips_merge_but_streams_on():
    lrn = _learner()
    for r in range(4):
        lrn.kill(r)
    lrn.run(4)
    assert lrn.steps == 4
    assert lrn.merges == 0 and lrn.merges_skipped == 2
    assert not lrn.W.any()
    lrn.revive(0)
    lrn.run(2)
    assert lrn.merges == 1


def test_publisher_stamps_steps_and_bounds_staleness():
    s = _stream()
    eng = GLMScoreEngine("lr", np.zeros(D, np.float32),
                         ell_width=s.ell_width, max_batch=8, device=CPU)
    lrn = _learner(stream=s)
    pub = SnapshotPublisher(eng, every_merges=2).attach(lrn)
    assert eng.model.version == 0 and eng.model.step is None
    lrn.run(20)
    assert pub.publishes == 5
    assert eng.model.version == 5 and eng.model.step == 20
    assert [h["version"] for h in pub.history] == [1, 2, 3, 4, 5]
    assert [h["step"] for h in pub.history] == [4, 8, 12, 16, 20]
    bound = pub.bound_steps(lrn.config.merge_every)
    for _ in range(17):
        lrn.step()
        assert pub.staleness(lrn) <= bound
    np.testing.assert_allclose(eng.model.w.numpy(), lrn.anchor.numpy(),
                               rtol=1e-6)
    assert eng.model.w.data_ptr() != lrn.anchor.data_ptr()   # a copy


def test_publisher_validates_period():
    eng = GLMScoreEngine("lr", np.zeros(4, np.float32), ell_width=2,
                         device=CPU)
    with pytest.raises(ValueError, match="every_merges"):
        SnapshotPublisher(eng, every_merges=0)


# ---------------------------------------------------------------------------
# chaos: train while serving, kill/revive mid-stream
# ---------------------------------------------------------------------------


def _score_oracle(task, w, values, indices):
    m = float(np.sum(values * w[np.asarray(indices, np.int64)]))
    return float(JLINKS[task](jnp.float32(m)))


def test_live_chaos_train_while_serving():
    """The reference's acceptance run on the port: a learner trains and
    publishes while a scoring thread serves, replicas die and revive
    mid-stream.  (1) the fault run converges within tolerance of the
    no-fault run; (2) every response matches the one snapshot it is
    stamped with, versions non-decreasing; (3) staleness never exceeds
    the publisher bound; (4) scoring throughput is never zero."""
    s = _stream(seed=12)
    ell, y = s.holdout(256, device=CPU)
    n_steps = 48
    base_loss = _learner(stream=_stream(seed=12)).run(n_steps).loss(ell, y)

    lrn = _learner(stream=s)
    eng = GLMScoreEngine("lr", np.zeros(D, np.float32),
                         ell_width=s.ell_width, max_batch=8, queue_depth=64,
                         device=CPU)
    pub = SnapshotPublisher(eng, every_merges=1).attach(lrn)
    bound = pub.bound_steps(lrn.config.merge_every)
    published = {0: np.zeros(D, np.float32)}   # version -> weights
    lrn.add_merge_hook(lambda l: published.setdefault(
        eng.model.version, eng.model.w.numpy().copy()))

    responses, requests, flushes = [], {}, []
    stop = threading.Event()
    rng = np.random.default_rng(0)

    def server():
        rid = 0
        while not stop.is_set():
            for _ in range(4):
                nn = int(rng.integers(1, s.ell_width + 1))
                idx = rng.choice(D, nn, replace=False)
                req = ScoreRequest(rid, rng.normal(0, 1, nn), idx)
                if eng.try_admit(req):
                    requests[rid] = req
                    rid += 1
            out = eng.flush()
            flushes.append(len(out))
            responses.extend(out)
        responses.extend(eng.drain())

    th = threading.Thread(target=server)
    th.start()
    try:
        for i in range(n_steps):
            lrn.step()
            lag = pub.staleness(lrn)
            assert lag is None or lag <= bound
            if i == 12:
                lrn.kill(1)
                lrn.kill(3)
            if i == 28:
                lrn.revive(1)
                lrn.revive(3)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()

    assert lrn.loss(ell, y) < 1.35 * base_loss
    assert responses, "server thread never scored anything"
    for resp in responses:
        assert resp.model_version in published
        req = requests[resp.rid]
        want = _score_oracle("lr", published[resp.model_version],
                             np.asarray(req.values, np.float32), req.indices)
        assert resp.score == pytest.approx(want, abs=1e-4), resp
    seen = [r.model_version for r in responses]
    assert seen == sorted(seen)
    assert max(seen) >= 1
    np.testing.assert_allclose(eng.model.w.numpy(), lrn.anchor.numpy(),
                               rtol=1e-6)
    assert flushes and all(flushes), "scoring throughput dropped to zero"
    assert lrn.merges >= n_steps // lrn.config.merge_every - 1
