"""Parity of the port's kernel families with the JAX reference, on the CPU.

The same numpy inputs (seeded) go through the JAX family (``pallas-interpret``
runs the Pallas kernel body; ``reference`` its oracle, for the ragged shapes
the Pallas flavors refuse) and through the port on ``device="cpu"``, where
every family runs its plain PyTorch version.  Tolerances are the JAX
conformance suite's: gradients ``rtol=1e-4, atol=2e-3``, epochs
``rtol=1e-4, atol=1e-4``.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import synthetic as jsynthetic
from repro.kernels.flash_attn import flash_attention as jflash_attention
from repro.kernels.flash_attn.ref import attention_ref as jattention_ref
from repro.kernels.glm_grad import glm_grad as jglm_grad
from repro.kernels.glm_sgd import glm_sgd_epoch as jglm_sgd_epoch
from repro.kernels.glm_sgd_sparse import ell_sgd_epoch as jell_sgd_epoch
from repro.kernels.glm_sparse import ell_glm_grad as jell_glm_grad

import repro_torch.kernels as tk
from repro_torch.kernels import _build, common
from repro_torch.kernels.flash_attn import ops as attn_ops
from repro_torch.kernels.flash_attn import ref as attn_ref
from repro_torch.kernels.glm_grad import ops as grad_ops
from repro_torch.kernels.glm_sgd import ops as sgd_ops
from repro_torch.kernels.glm_sgd_sparse import ops as sgd_sparse_ops
from repro_torch.kernels.glm_sparse import ops as sparse_ops

TASKS = ("lr", "svm")
GRAD_TOL = dict(rtol=1e-4, atol=2e-3)
EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)     # fp32 attention
#: bf16 attention: fp32 inside, one rounding of the output, so an element
#: may land one bf16 step (2^-7 of its value) away (chip_smoke.py's)
ATTN_BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
CPU = torch.device("cpu")


def _dense(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, d).astype(np.float32)
    return X, y, w


def _ell(n, d, k, seed=0):
    ds = jsynthetic.make_sparse("conf", n, d, k * 0.6, k, seed=d)
    w = np.random.default_rng(seed).normal(0, 0.1, d).astype(np.float32)
    return (np.asarray(ds.ell.values), np.asarray(ds.ell.indices),
            np.asarray(ds.y), w)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---------------------------------------------------------------------------
# glm_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("task", TASKS)
def test_glm_grad_matches_jax_kernel(task, layout):
    X, y, w = _dense(96, 50)
    ref = jglm_grad(task, *_j(w, X, y), layout=layout, block_rows=16,
                    backend="pallas-interpret")
    out = tk.glm_grad(task, *_t(w, X, y), layout=layout)
    assert out.dtype == torch.float32 and out.shape == (50,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_grad_ragged_rows_match_jax_reference(task):
    X, y, w = _dense(93, 54, seed=1)
    ref = jglm_grad(task, *_j(w, X, y), backend="reference")
    for layout in ("row", "col"):
        out = tk.glm_grad(task, *_t(w, X, y), layout=layout)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


def test_glm_grad_rejects_bad_layout_and_shapes():
    X, y, w = _t(*_dense(8, 4))
    with pytest.raises(ValueError, match="layout"):
        tk.glm_grad("lr", w, X, y, layout="diag")
    with pytest.raises(ValueError, match="shapes"):
        tk.glm_grad("lr", w[:3], X, y)


@pytest.mark.parametrize("task", TASKS)
def test_glm_grad_row_past_shared_memory_matches_jax(task):
    """d = 60,000: past the ring kernel and past w in shared memory (the
    first port refused it), against the JAX reference."""
    assert grad_ops.variant(60_000, "row") == "row"
    X, y, w = _dense(19, 60_000, seed=4)
    ref = jglm_grad(task, *_j(w, X, y), backend="reference")
    out = tk.glm_grad(task, *_t(w, X, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("d,layout,want", [
    (3, "row", "ring"),                        # skin
    (54, "row", "ring"),                       # covtype
    (300, "row", "ring"),
    (grad_ops.RING_MAX_D, "row", "ring"),
    (grad_ops.RING_MAX_D + 1, "row", "row"),
    (60_000, "row", "row"),
    (54, "col", "col"),
    (60_000, "col", "col"),
])
def test_glm_grad_variant_is_chosen_from_the_shape(d, layout, want):
    assert grad_ops.variant(d, layout) == want


@pytest.mark.parametrize("d,n", [(3, 4_099), (54, 581_012), (54, 4_099),
                                 (300, 3_001), (1_024, 777), (54, 1)])
def test_glm_grad_ring_plan_covers_every_row_once(d, n):
    """Tiles of about 32 KB (at most 128 rows), a power-of-two lane count
    with T * L up to the 256 consumer threads, blocks of consecutive tiles,
    about three a SM, and a ring that leaves room for three blocks a SM."""
    tile, lanes, per_block, blocks = grad_ops.ring_plan(d, n, 132)
    assert 1 <= tile <= grad_ops.RING_MAX_TILE
    assert tile * d * 4 <= grad_ops.RING_STAGE_BYTES or tile == 1
    assert lanes & (lanes - 1) == 0 and lanes <= 32
    assert tile * lanes <= grad_ops.RING_CONSUMERS < 2 * tile * lanes \
        or lanes == 32
    tiles = -(-n // tile)
    assert (blocks - 1) * per_block < tiles <= blocks * per_block
    assert blocks <= grad_ops.RING_BLOCKS_PER_SM * 132
    assert grad_ops.RING_BLOCKS_PER_SM * (
        grad_ops.ring_smem_bytes(d, tile) + 1024) <= 233_472


@pytest.mark.parametrize("n,tile", [(581_012, 256), (67_584, 256),
                                    (67_583, 248), (2_003, 8), (1, 8)])
def test_glm_grad_row_tile_fills_the_card(n, tile):
    """The row kernel's blocks keep 256 rows at covtype's N; a smaller N
    takes fewer rows a block (multiples of 8) so that at least two blocks
    a SM run where N allows."""
    assert grad_ops.row_tile(n, 132) == tile
    assert tile == 8 or -(-n // tile) >= 2 * 132


def _first_read_banks(d, lanes, skew):
    banks = [0] * 32
    for r in range(32 // lanes):
        for lane in range(lanes):
            banks[(r * (d + lanes * skew) + lane) % 32] += 1
    return max(banks)


@pytest.mark.parametrize("d", [3, 7, 54, 100, 300, 1_024])
def test_glm_grad_ring_skew_spreads_a_warps_rows_over_the_banks(d):
    """The margin pass's first reads of a warp's rows hit as few banks at
    once as any skew allows: one each at covtype's d = 54 (rows 54 words
    apart, two lanes a row) with no skew, where a skew of one (rows 56
    words apart) put four reads on a bank."""
    lanes = grad_ops.ring_plan(d, 100_000, 132)[1]
    skew = grad_ops.ring_skew(d, lanes)
    best = min(_first_read_banks(d, lanes, a) for a in range(32))
    assert _first_read_banks(d, lanes, skew) == best
    if d == 54:
        assert (lanes, skew, best) == (2, 0, 1)
        assert _first_read_banks(54, 2, 1) == 4


def test_glm_grad_ring_plan_at_covtype():
    """covtype: 128-row tiles of 27,648 bytes, two lanes a row, 4,540 tiles
    in 379 blocks of 12 (379 partial rows where the first port wrote
    2,270); d = 300 runs 27-row tiles at 8 lanes a row."""
    assert grad_ops.ring_plan(54, 581_012, 132) == (128, 2, 12, 379)
    assert grad_ops.ring_plan(300, 64_700, 132)[:2] == (27, 8)
    assert grad_ops.ring_plan(1_024, 1_000, 132)[:2] == (8, 32)


# ---------------------------------------------------------------------------
# glm_sgd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_matches_jax_kernel(task, mb):
    X, y, w = _dense(32, 40)
    ref = jglm_sgd_epoch(task, *_j(w, X, y), step=0.02, micro_batch=mb,
                         backend="pallas-interpret")
    out = tk.glm_sgd_epoch(task, *_t(w, X, y), step=0.02, micro_batch=mb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_ragged_tail_matches_jax_reference(task):
    """n % micro_batch != 0: the tail is one smaller batch at step/|tail|."""
    X, y, w = _dense(30, 16, seed=2)
    ref = jglm_sgd_epoch(task, *_j(w, X, y), step=0.02, micro_batch=4,
                         backend="reference")
    out = tk.glm_sgd_epoch(task, *_t(w, X, y), step=0.02, micro_batch=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


def test_glm_sgd_replica_axis_matches_per_replica_jax():
    X, y, w = _dense(3 * 24, 20, seed=3)
    Xr, yr = X.reshape(3, 24, 20), y.reshape(3, 24)
    W = np.stack([w, -w, 2 * w])
    out = tk.glm_sgd_epoch("lr", *_t(W, Xr, yr), step=0.05, micro_batch=4)
    for r in range(3):
        ref = jglm_sgd_epoch("lr", *_j(W[r], Xr[r], yr[r]), step=0.05,
                             micro_batch=4, backend="pallas-interpret")
        np.testing.assert_allclose(out[r].numpy(), np.asarray(ref), **EPOCH_TOL)


@pytest.mark.parametrize("d,mb,want", [
    (3, 1, "warp"),                           # skin
    (54, 16, "warp"),                         # covtype, SyncSGD(batch=16)
    (54, 1, "warp"),                          # covtype, AsyncLocalSGD b1
    (300, 64, "warp"),
    (sgd_ops.WARP_MAX_D, 1, "warp"),
    (sgd_ops.WARP_MAX_D, 27, "warp"),         # the widest two-stage ring
    (sgd_ops.WARP_MAX_D, 28, "smem"),         # two stages no longer fit
    # these two ids name the kernel that took the shapes before the cluster
    # kernel did; kept so that the cases keep their names
    pytest.param(sgd_ops.WARP_MAX_D + 1, 1, "cluster", id="1025-1-smem"),
    pytest.param(20_000, 64, "cluster", id="20000-64-smem"),  # in chunks
    (20_958, 1, "cluster"),                   # real-sim: Table 4's seq
    (58_112, 10, "cluster"),                  # past a block's shared memory
    (100_000, 16, "global"),
    (16 * 4_096, 1, "cluster"),               # the cluster's widest
    (16 * 4_096 + 1, 1, "global"),            # past the cluster's cap
])
def test_glm_sgd_variant_is_chosen_from_the_shape(d, mb, want):
    assert sgd_ops.variant(d, mb) == want
    stages, group = sgd_ops.warp_plan(d, mb)
    if want == "warp":
        assert stages >= 2 and group >= 1
        assert sgd_ops.warp_smem_bytes(d, mb, stages, group) \
            <= common.MAX_SMEM_BYTES
    assert bool(sgd_ops.cluster_plan(d, mb)[0]) == (d <= 16 * 4_096)


@pytest.mark.parametrize("d,mb", [(1_025, 1), (1_025, 10), (1_025, 64),
                                  (4_096, 16), (20_958, 1), (20_958, 10),
                                  (32_768, 1), (32_769, 1),
                                  (20_000, 64), (58_111, 1), (58_112, 10),
                                  (65_536, 16), (16 * 4_096, 1),
                                  (16 * 4_096, 111)])
def test_glm_sgd_cluster_plan_gives_every_feature_one_block(d, mb):
    """Block b of a replica's cluster owns features [b * slice, (b + 1) *
    slice): every feature exactly one block, every block at least one, a
    slice the chain's 256 threads hold in 8 registers each where 16 blocks
    allow, else 16; the cluster is at most 16 blocks and the smallest such
    that leaves two stages of a whole batch (up to 32 rows), else the
    largest with fewer rows a fill; each block's shared memory within the
    card's 227 KB."""
    cluster, slice_, stages, rows = sgd_ops.cluster_plan(d, mb)
    owners = np.zeros(d, dtype=np.int64)
    for b in range(cluster):
        lo, hi = b * slice_, min(d, (b + 1) * slice_)
        assert hi > lo
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert 1 <= cluster <= sgd_ops.CLUSTER_MAX
    values = 8 if d <= 16 * 2_048 else 16
    assert slice_ <= 256 * values
    assert 2 <= stages <= sgd_ops.CLUSTER_MAX_STAGES
    assert sgd_ops.cluster_smem_bytes(cluster, slice_, stages, rows) \
        <= common.MAX_SMEM_BYTES
    want = min(mb, sgd_ops.CLUSTER_CHUNK_ROWS)
    assert 1 <= rows <= want
    if rows == want:
        # no smaller cluster holds two stages of the batch
        for c in range(1, cluster):
            s = -(-d // c)
            assert s > 256 * values or sgd_ops.cluster_smem_bytes(
                c, s, 2, rows) > common.MAX_SMEM_BYTES
    else:
        assert cluster == sgd_ops.CLUSTER_MAX
        assert sgd_ops.cluster_smem_bytes(cluster, slice_, 2, rows + 1) \
            > common.MAX_SMEM_BYTES


def test_glm_sgd_cluster_plan_at_the_main_paths_widths():
    """real-sim's seq epoch (d = 20,958, one row a batch) takes 11 blocks
    of 1,906 features (7.4 a chain thread) and an 8-stage ring; d = 58,112
    at micro-batch 1 takes 15 of 3,875 (past 16 x 2,048, up to 16 a
    thread), and at 10 the cap's 16, its batches in fills of 7 rows."""
    assert sgd_ops.cluster_plan(20_958, 1) == (11, 1_906, 8, 1)
    assert sgd_ops.cluster_plan(58_112, 1)[:2] == (15, 3_875)
    assert sgd_ops.cluster_plan(58_112, 10)[::3] == (16, 7)
    assert sgd_ops.cluster_plan(16 * 4_096 + 1, 1) == (0, 0, 0, 0)


def test_glm_sgd_warp_ring_holds_about_32_rows_a_stage():
    """covtype's batches group into 32-row stages, 16 of them; MB=1 stages
    32 batches each; a batch over 32 rows is a stage of its own."""
    assert sgd_ops.warp_plan(54, 16) == (sgd_ops.WARP_MAX_STAGES, 2)
    assert sgd_ops.warp_plan(54, 1) == (sgd_ops.WARP_MAX_STAGES, 32)
    assert sgd_ops.warp_plan(54, 64)[1] == 1
    assert sgd_ops.warp_columns(54) == 2 and sgd_ops.warp_columns(300) == 16


def test_glm_sgd_accepted_shapes_did_not_shrink():
    """Every (d, micro_batch) some variant took still runs: the shared-memory
    kernel's shapes up to WARP_MAX_D stay on the warp or shared-memory
    kernels and every wider one goes to the cluster kernel, as do the
    global kernel's up to the cluster's cap; the global kernel keeps the
    rest."""
    for d in (1, 3, 54, 300, 1023, 1024, 1025, 4096, 58_000, 58_111,
              58_112, 65_536, 65_537, 100_000, 200_000):
        for mb in (1, 2, 10, 16, 27, 28, 64, 111, 112):
            kind = sgd_ops.variant(d, mb)
            if d <= sgd_ops.WARP_MAX_D and \
                    sgd_ops.smem_bytes(d, mb) <= common.MAX_SMEM_BYTES:
                assert kind in ("warp", "smem")
            elif d <= 16 * 4_096:
                assert kind == "cluster"
            else:
                assert kind == "global"
    assert sgd_ops.variant(58_111, 1) == "cluster"
    assert sgd_ops.variant(58_112, 1) == "cluster"
    assert sgd_ops.variant(65_536, 16) == "cluster"
    assert sgd_ops.variant(100_000, 16) == "global"
    assert sgd_ops.variant(1_025, 57_087) == "cluster"  # smem's longest batch
    assert sgd_ops.variant(54, 60_000) == "global"   # a batch past the cap


@pytest.mark.parametrize("d,mb", [(58_112, 1), (58_112, 10), (100_000, 16),
                                  (140_000, 3)])
def test_glm_sgd_past_shared_memory_matches_jax(d, mb):
    """Models too wide for a block's shared memory (the cluster kernel's
    shapes up to its cap, the global kernel's past it; a ragged tail at
    micro-batches 10, 16 and 3) against the JAX reference."""
    assert sgd_ops.variant(d, mb) == ("cluster" if d <= 16 * 4_096
                                      else "global")
    X, y, w = _dense(23, d, seed=mb)
    ref = jglm_sgd_epoch("lr", *_j(w, X, y), step=0.01, micro_batch=mb,
                         backend="reference")
    out = tk.glm_sgd_epoch("lr", *_t(w, X, y), step=0.01, micro_batch=mb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


# ---------------------------------------------------------------------------
# glm_sgd_sparse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mb", [1, 4])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_matches_jax_kernel(task, mb):
    values, indices, y, w = _ell(32, 64, 6)
    ref = jell_sgd_epoch(task, *_j(w, values, indices, y), step=0.05,
                         micro_batch=mb, backend="pallas-interpret")
    out = tk.ell_sgd_epoch(task, *_t(w, values, indices, y), step=0.05,
                           micro_batch=mb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_ragged_tail_matches_jax_reference(task):
    values, indices, y, w = _ell(30, 60, 6, seed=1)
    ref = jell_sgd_epoch(task, *_j(w, values, indices, y), step=0.05,
                         micro_batch=8, backend="reference")
    out = tk.ell_sgd_epoch(task, *_t(w, values, indices, y), step=0.05,
                           micro_batch=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


def test_glm_sgd_sparse_over_shared_memory_raises_naming_the_limit():
    """news (d=1,355,191) cannot keep its model in a block's shared memory:
    it used to raise, naming the limit, and now routes to the global-memory
    variant, whose cuda flavor refuses only a tensor off the card."""
    d = jsynthetic.PAPER_DATASETS["news"][1]
    assert sgd_sparse_ops.smem_bytes(d, 8) > common.MAX_SMEM_BYTES
    for k, mb in ((2_729, 1), (2_729, 10), (4, 8)):
        assert sgd_sparse_ops.variant(d, k, mb) == "stream"
    assert sgd_sparse_ops.variant(d, sgd_sparse_ops.STREAM_MAX_K + 1, 1) \
        == "global"
    W, values, y = torch.zeros((1, d)), torch.ones((1, 8, 4)), torch.ones((1, 8))
    indices = torch.zeros((1, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        sgd_sparse_ops._ell_sgd_cuda("lr", W, values, indices, y, step=0.1,
                                     micro_batch=8)
    rcv1_d = jsynthetic.PAPER_DATASETS["rcv1"][1]
    assert sgd_sparse_ops.smem_bytes(rcv1_d, 10) <= common.MAX_SMEM_BYTES


@pytest.mark.parametrize("d,k,mb,want", [
    (300, 69, 10, "warp"),                    # w8a, AsyncLocalSGD r10 b10
    (300, 69, 1, "warp"),                     # w8a, local_batch=1
    (300, 69, 64, "warp"),
    (300, 1, 1, "warp"),                      # K = 1
    (20_958, 307, 1, "warp"),                 # real-sim: LiveLearner
    (47_236, 1_224, 10, "smem"),              # rcv1: rows past WARP_MAX_K
    (58_000, 69, 1, "smem"),                  # no ring fits beside the model
    (1_355_191, 2_729, 1, "stream"),          # news: Table 7's async b1
    (1_355_191, 2_729, 10, "stream"),         # batches streamed in chunks
    (1_355_191, 8_193, 1, "global"),          # rows past the stream's
])
def test_glm_sgd_sparse_variant_is_chosen_from_the_shape(d, k, mb, want):
    assert sgd_sparse_ops.variant(d, k, mb) == want
    stages, group = sgd_sparse_ops.warp_plan(d, k, mb)
    if want == "warp":
        assert stages >= 2 and group >= 1
        assert sgd_sparse_ops.warp_smem_bytes(d, k, mb, stages, group) \
            <= common.MAX_SMEM_BYTES
        assert 32 * sgd_sparse_ops.warp_columns(k) >= k


def test_glm_sgd_sparse_warp_ring_plans():
    """w8a's batches group into stages of about 32 rows (4 batches of 10,
    32 of 1), up to 16 stages; real-sim's 84 KB model leaves room for four
    stages of 15 rows; where two stages no longer fit the old kernel runs,
    and past the shared-memory cap the global-memory kernel does."""
    assert sgd_sparse_ops.warp_plan(300, 69, 10) == (10, 4)
    assert sgd_sparse_ops.warp_plan(300, 69, 1) == (12, 32)
    assert sgd_sparse_ops.warp_plan(20_958, 307, 1) == (4, 15)
    assert sgd_sparse_ops.warp_plan(58_000, 69, 1) == (0, 0)
    assert [sgd_sparse_ops.warp_columns(k) for k in (1, 32, 33, 69, 100, 307,
                                                      512)] \
        == [1, 1, 2, 3, 4, 12, 16]
    assert sgd_sparse_ops.variant(58_111, 69, 1) == "smem"
    assert sgd_sparse_ops.variant(58_112, 69, 1) == "stream"
    assert sgd_sparse_ops.variant(58_112, 1, 1) == "stream"


@pytest.mark.parametrize("k,mb", [(1, 1), (69, 10), (2_729, 1), (2_729, 10),
                                  (2_729, 64), (5_000, 3), (8_192, 1)])
def test_glm_sgd_sparse_stream_plan_gives_every_entry_one_owner(k, mb):
    """Entry k of a staged row belongs to chain thread k % 512 (its k // 512
    th register): every entry exactly one owner, at most 16 a thread; a
    fill holds the whole batch (up to 32 rows) where two such stages fit,
    else as many rows as two stages allow; each block's shared memory
    within the card's 227 KB."""
    stages, rows = sgd_sparse_ops.stream_plan(k, mb)
    threads = 32 * sgd_sparse_ops.STREAM_CHAIN_WARPS
    owners = np.zeros(k, dtype=np.int64)
    per = -(-k // threads)
    for t in range(threads):
        for c in range(per):
            if t + threads * c < k:
                owners[t + threads * c] += 1
    assert (owners == 1).all() and per <= 16
    assert 2 <= stages <= sgd_sparse_ops.STREAM_MAX_STAGES
    assert sgd_sparse_ops.stream_smem_bytes(k, stages, rows) \
        <= common.MAX_SMEM_BYTES
    want = min(mb, sgd_sparse_ops.STREAM_ROWS)
    assert 1 <= rows <= want
    if rows < want:
        assert sgd_sparse_ops.stream_smem_bytes(k, 2, rows + 1) \
            > common.MAX_SMEM_BYTES


def test_glm_sgd_sparse_stream_plan_at_news():
    """news' 2,729-entry rows: one row a fill and eight stages at
    micro-batch 1 (21.9 KB a row); at 10, two stages of five rows."""
    assert sgd_sparse_ops.stream_plan(2_729, 1) == (8, 1)
    assert sgd_sparse_ops.stream_plan(2_729, 10) == (2, 5)
    assert sgd_sparse_ops.stream_plan(sgd_sparse_ops.STREAM_MAX_K + 1, 1) \
        == (0, 0)


def _ell_shared(n, d, k, seed):
    """ELL rows that share their features: every row draws its nonzeros
    from the first 8 features, so the rows of a batch collide on them (the
    warp kernel's atomics), with row lengths 1..k and value-0 padding at
    index 0."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, k + 1, n)
    live = np.arange(k)[None] < nnz[:, None]
    values = (rng.normal(0, 1, (n, k)) * live).astype(np.float32)
    indices = (rng.integers(0, min(8, d), (n, k)) * live).astype(np.int32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, d).astype(np.float32)
    return values, indices, y, w


@pytest.mark.parametrize("mb", [1, 10])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_shared_features_ragged_tail_match_jax(task, mb):
    """The warp variant's shapes (w8a's K = 69, micro-batches 1 and 10, a
    ragged tail of 3 rows at 10) with features shared across the rows of a
    batch, against the JAX kernel."""
    values, indices, y, w = _ell_shared(43, 300, 69, seed=mb)
    assert sgd_sparse_ops.variant(300, 69, mb) == "warp"
    ref = jell_sgd_epoch(task, *_j(w, values, indices, y), step=0.05,
                         micro_batch=mb, backend="reference")
    out = tk.ell_sgd_epoch(task, *_t(w, values, indices, y), step=0.05,
                           micro_batch=mb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


# ---------------------------------------------------------------------------
# glm_sparse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_glm_sparse_matches_jax_kernel(task):
    values, indices, y, w = _ell(64, 64, 8)
    ref = jell_glm_grad(task, *_j(w, values, indices, y), block_rows=8,
                        d_block=128, backend="pallas-interpret")
    out = tk.ell_glm_grad(task, *_t(w, values, indices, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_sparse_ragged_rows_and_replica_axis(task):
    """n not a multiple of the Pallas row block, and R replicas at once."""
    values, indices, y, w = _ell(3 * 21, 48, 5, seed=2)
    v, i, yr = values.reshape(3, 21, 5), indices.reshape(3, 21, 5), y.reshape(3, 21)
    W = np.stack([w, 0.5 * w, -w])
    out = tk.ell_glm_grad(task, *_t(W, v, i, yr))
    for r in range(3):
        ref = jell_glm_grad(task, *_j(W[r], v[r], i[r], yr[r]),
                            backend="pallas-interpret", block_rows=8,
                            d_block=128)
        np.testing.assert_allclose(out[r].numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_glm_sparse_repeated_and_shared_features_match_jax(task):
    """The smem variant's shape (w8a's width and K = 69) with rows that
    share their features and repeat them (the warp's grouped adds), plus
    one feature three times in every row, and rows of all padding."""
    values, indices, y, w = _ell_shared(43, 300, 69, seed=5)
    values[:, -3:], indices[:, -3:] = 1.0, 5
    values[::7], indices[::7] = 0.0, 0
    assert sparse_ops.variant(300, 69, 1) == "smem"
    ref = jell_glm_grad(task, *_j(w, values, indices, y), backend="reference")
    out = tk.ell_glm_grad(task, *_t(w, values, indices, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("d,k,n_rep,want", [
    (300, 69, 1, "smem"),                     # w8a, SyncSGD()
    (300, 69, 10, "smem"),                    # w8a, async r10 b6470
    (20_958, 307, 8, "smem"),                 # real-sim: the live learner
    (29_024, 1, 1, "smem"),                   # two warps' copies, just
    (29_025, 1, 1, "atomic"),
    (47_236, 1_224, 1, "atomic"),             # rcv1
    (1_355_191, 2_729, 1, "atomic"),          # news
])
def test_glm_sparse_variant_is_chosen_from_the_shape(d, k, n_rep, want):
    assert sparse_ops.variant(d, k, n_rep) == want
    if want == "smem":
        assert sparse_ops.smem_warps(d) >= sparse_ops.SMEM_MIN_WARPS
        assert sparse_ops.smem_bytes(d, sparse_ops.smem_warps(d)) \
            <= common.MAX_SMEM_BYTES


@pytest.mark.parametrize("k,lanes", [(1, 4), (4, 4), (5, 8), (8, 8), (12, 4),
                                     (16, 16), (32, 32), (33, 4), (69, 8),
                                     (307, 4), (2_729, 4)])
def test_glm_sparse_lanes_leave_the_fewest_padded_slots(k, lanes):
    """w8a's K = 69 runs 9 passes of 8 lanes (72 slots), not 3 of 32 (96,
    the last pass with 5 live lanes); a tie goes to the wider group."""
    assert sparse_ops.smem_lanes(k) == lanes
    slots = lanes * -(-k // lanes)
    assert all(slots <= g * -(-k // g) for g in sparse_ops.SMEM_LANES)


@pytest.mark.parametrize("d,k,n_rep,n", [(300, 69, 1, 64_700),
                                         (300, 69, 10, 6_470),
                                         (20_958, 307, 8, 32),
                                         (300, 69, 1, 1), (300, 1, 3, 1_003)])
def test_glm_sparse_smem_plan_covers_every_row_once(d, k, n_rep, n):
    lanes, warps, per_block, blocks = sparse_ops.smem_plan(d, k, n_rep, n,
                                                           132)
    assert lanes == sparse_ops.smem_lanes(k)
    assert warps == sparse_ops.smem_warps(d)
    assert (blocks - 1) * per_block < n <= blocks * per_block
    assert blocks * n_rep <= sparse_ops.SMEM_BLOCKS_PER_SM * 132 \
        or blocks == 1
    assert blocks <= -(-n // (warps * 32 // lanes))  # a step a warp, at least


def test_glm_sparse_smem_plan_at_w8a():
    """w8a: 8 warps of 8-lane rows, 4 blocks a SM: 527 blocks of 123 rows
    for SyncSGD(), 52 a replica of 125 rows for 10 replicas; real-sim's
    84 KB copies leave two warps a block, one block a SM."""
    assert sparse_ops.smem_plan(300, 69, 1, 64_700, 132) == (8, 8, 123, 527)
    assert sparse_ops.smem_plan(300, 69, 10, 6_470, 132) == (8, 8, 125, 52)
    assert sparse_ops.smem_plan(20_958, 307, 1, 72_309, 132)[:2] == (4, 2)


# ---------------------------------------------------------------------------
# Registry rules
# ---------------------------------------------------------------------------


def _calls():
    X, y, w = _t(*_dense(16, 8))
    values, indices, ys, ws = _t(*_ell(16, 32, 4))
    return {
        "glm_grad": lambda **kw: tk.glm_grad("lr", w, X, y, **kw),
        "glm_sgd": lambda **kw: tk.glm_sgd_epoch("lr", w, X, y, step=0.1, **kw),
        "glm_sgd_sparse": lambda **kw: tk.ell_sgd_epoch(
            "lr", ws, values, indices, ys, step=0.1, **kw),
        "glm_sparse": lambda **kw: tk.ell_glm_grad("lr", ws, values, indices,
                                                   ys, **kw),
        "flash_attn": lambda: tk.flash_attention(*_t(*_qkv(1, 4, 2, 3, 9, 8))),
    }


@pytest.mark.parametrize("bad", [-1, 32])
@pytest.mark.parametrize("family", ["glm_sgd_sparse", "glm_sparse"])
def test_sparse_families_reject_out_of_range_indices(family, bad):
    """The range check runs in the wrapper before either flavor: the CUDA
    kernels index the model unchecked, so both flavors refuse the same
    operand."""
    values, indices, ys, ws = _t(*_ell(16, 32, 4))
    call = {"glm_sgd_sparse": lambda i: tk.ell_sgd_epoch(
                "lr", ws, values, i, ys, step=0.1),
            "glm_sparse": lambda i: tk.ell_glm_grad("lr", ws, values, i, ys)}[family]
    call(indices)
    indices[3, 0] = bad   # an in-place write: the operand is checked again
    with pytest.raises(ValueError, match=rf"{family}: .*\[0, 32\)"):
        call(indices)
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        call(indices.clone())


def test_plain_versions_route_cuda_tensors_to_the_plain_version():
    cuda = torch.device("cuda")
    with common.plain_versions():
        assert common.resolve_backend("glm_grad", cuda) == common.TORCH_REFERENCE
        assert common.resolve_backend("glm_grad", CPU) == common.TORCH_REFERENCE
    assert common.resolve_backend("glm_grad", cuda) == common.CUDA


def test_every_family_registers_both_flavors():
    assert common.registered_kernels() == (
        "flash_attn", "glm_grad", "glm_score", "glm_sgd", "glm_sgd_sparse",
        "glm_sparse")
    for fam in common.registered_kernels():
        assert common.backends_for(fam) == (common.CUDA, common.TORCH_REFERENCE)


@pytest.mark.parametrize("family", ["glm_grad", "glm_sgd", "glm_sgd_sparse",
                                    "glm_sparse"])
def test_cuda_flavor_on_cpu_tensor_raises(family):
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        _calls()[family](backend=common.CUDA)


def test_env_var_is_the_ports_own(monkeypatch):
    assert common.ENV_BACKEND == "REPRO_TORCH_KERNEL_BACKEND"
    calls = _calls()
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", common.CUDA)
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        calls["glm_grad"]()
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "reference")
    with pytest.raises(ValueError, match="not registered"):
        calls["glm_sgd"]()
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", common.TORCH_REFERENCE)
    assert torch.isfinite(calls["glm_sparse"]()).all()
    # the JAX registry's variable does not reach the port
    monkeypatch.delenv("REPRO_TORCH_KERNEL_BACKEND")
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "cuda")
    assert torch.isfinite(calls["glm_sgd_sparse"]()).all()


def test_call_site_backend_beats_env(monkeypatch):
    monkeypatch.setenv(common.ENV_BACKEND, common.CUDA)
    assert (common.resolve_backend("glm_grad", CPU, common.TORCH_REFERENCE)
            == common.TORCH_REFERENCE)
    monkeypatch.delenv(common.ENV_BACKEND)
    assert common.resolve_backend("glm_grad", CPU) == common.TORCH_REFERENCE
    assert (common.resolve_backend("glm_grad", torch.device("cuda"))
            == common.CUDA)
    with pytest.raises(RuntimeError, match="cannot take tensors on cuda"):
        common.resolve_backend("glm_grad", torch.device("cuda"),
                               common.TORCH_REFERENCE)
    with pytest.raises(KeyError):
        common.resolve_backend("no_such_kernel", CPU)


def test_cpu_calls_launch_nothing():
    before = dict(common.LAUNCHES)
    for call in _calls().values():
        call()
    assert common.LAUNCHES == before
    assert set(before) == set(common.registered_kernels())


def test_device_helper_defaults_to_cuda():
    assert common.device() == torch.device("cuda")
    assert common.device("cpu") == CPU


def test_tiling_helpers():
    assert common.padded(581_012, 256) == 581_120
    assert common.pick_block(64, 16, 8) == 16
    with pytest.raises(ValueError, match="pad the operand"):
        common.pick_block(6, 128, 8)


# ---------------------------------------------------------------------------
# flash_attn
# ---------------------------------------------------------------------------


def _qkv(b, hq, hkv, sq, sk, hd, seed=0):
    """Seeded q [B, Hq, Sq, hd], k, v [B, Hkv, Sk, hd]: every kv head its
    own draw, so a kernel that read the wrong kv head would show."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, hq, sq, hd)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, hd)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, sk, hd)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window,block_q,block_k", [
    (4, 2, 32, 32, True, None, 8, 8),      # causal, GQA 2:1
    (4, 2, 32, 32, True, 8, 8, 8),         # sliding window, tiles skipped
    (6, 2, 16, 48, True, 12, 8, 16),       # Sq < Sk (end-aligned), GQA 3:1
    (4, 1, 16, 32, False, None, 8, 8),     # acausal, one kv head
    (4, 4, 24, 40, False, 10, 8, 8),       # acausal window
    (4, 2, 1, 64, True, None, 1, 16),      # decode: Sq = 1, block_q = 1
])
def test_flash_attention_matches_jax_kernel(hq, hkv, sq, sk, causal, window,
                                            block_q, block_k):
    q, k, v = _qkv(2, hq, hkv, sq, sk, 16)
    want = jflash_attention(*_j(q, k, v), causal=causal, window=window,
                            block_q=block_q, block_k=block_k,
                            backend="pallas-interpret")
    got = tk.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.shape == (2, hq, sq, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("hq,hkv,sq,sk,hd,causal,window", [
    (4, 2, 5, 37, 16, True, None),
    (6, 3, 7, 40, 24, False, None),
    (4, 2, 33, 70, 80, True, 9),
    (4, 1, 20, 50, 128, False, 7),
    (32, 8, 1, 127, 80, True, None),       # danube's heads, one decode row
    (3, 1, 11, 11, 8, True, 1),            # window 1: each query sees itself
])
def test_flash_attention_ragged_matches_jax_reference(hq, hkv, sq, sk, hd,
                                                      causal, window):
    """Shapes the Pallas flavor refuses (ragged, odd head dims): the port
    against the reference's oracle with the kv heads repeated."""
    q, k, v = _qkv(1, hq, hkv, sq, sk, hd, seed=sk)
    rep = hq // hkv
    want = jattention_ref(*_j(q, np.repeat(k, rep, 1), np.repeat(v, rep, 1)),
                          causal=causal, window=window)
    got = tk.flash_attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_flash_attention_query_head_reads_kv_head_h_div_rep():
    """GQA grouping is the reference's repeat, not a tile: query head h
    reads kv head h // (Hq / Hkv)."""
    q, k, v = _t(*_qkv(1, 6, 3, 4, 10, 8, seed=5))
    out = tk.flash_attention(q, k, v)
    for h in range(6):
        one = tk.flash_attention(q[:, h:h + 1], k[:, h // 2:h // 2 + 1],
                                 v[:, h // 2:h // 2 + 1])
        torch.testing.assert_close(out[:, h:h + 1], one, rtol=0, atol=0)
        wrong = tk.flash_attention(q[:, h:h + 1], k[:, h % 3:h % 3 + 1],
                                   v[:, h % 3:h % 3 + 1])
        if h // 2 != h % 3:
            assert not torch.allclose(out[:, h:h + 1], wrong)


def test_flash_attention_reads_a_cache_prefix_and_masks_nothing_else():
    """Decode's call: one query over the first ``valid`` rows of a longer
    cache equals attention over those rows alone."""
    q, k, v = _t(*_qkv(2, 4, 2, 1, 12, 16, seed=2))
    for valid in (1, 5, 12):
        got = tk.flash_attention(q, k[:, :, :valid], v[:, :, :valid],
                                 causal=False)
        want = attn_ref.attention_ref(q, k[:, :, :valid].contiguous(),
                                      v[:, :, :valid].contiguous(),
                                      causal=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.allclose(tk.flash_attention(q, k[:, :, :1], v[:, :, :1]),
                          v[:, :, :1].repeat_interleave(2, 1))


def test_flash_attention_bf16_rounds_only_the_output():
    """fp32 inside, the output cast once to bf16 (the Pallas kernel's
    precision): within one bf16 step of the fp32 result on the same
    bf16 values."""
    q, k, v = (t.to(torch.bfloat16) for t in _t(*_qkv(1, 4, 2, 9, 21, 16)))
    got = tk.flash_attention(q, k, v, window=6)
    want = tk.flash_attention(q.float(), k.float(), v.float(), window=6)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype,sq,rep,want", [
    (torch.bfloat16, 15, 1, "decode"),   # 15 rows: short of an MMA's 16
    (torch.bfloat16, 16, 1, "mma"),
    (torch.bfloat16, 4, 4, "mma"),       # danube's rep: 4 positions fill 16
    (torch.bfloat16, 5, 3, "decode"),    # rep 3 (minitron): 15 rows
    (torch.bfloat16, 8192, 4, "mma"),    # danube's prefill
    (torch.bfloat16, 1, 4, "decode"),    # decode
    (torch.bfloat16, 1, 16, "mma"),      # decode with 16 heads a kv head
    (torch.float32, 8192, 4, "simt"),    # fp32: its tolerance needs fp32
    (torch.float32, 1, 4, "simt"),       # fp32 decode stays on the fp32 kernel
])
def test_flash_attention_variant_is_chosen_from_dtype_and_rows(dtype, sq,
                                                                rep, want):
    assert attn_ops.variant(dtype, sq, rep) == want
    # the C entry point's code: 0 flash_attn_kernel, 1 flash_attn_mma_kernel
    # (the decode kernel has an entry point of its own)
    assert attn_ops.VARIANTS.index(want) == {"simt": 0, "mma": 1,
                                             "decode": 2}[want]


@pytest.mark.parametrize("b,hkv,sk", [
    (4, 8, 1), (4, 8, 77), (4, 8, 127), (4, 8, 128), (4, 8, 129),
    (4, 8, 4096), (1, 8, 4096), (1, 1, 4096), (1, 1, 100_000), (64, 8, 4096),
    (33, 8, 4096), (300, 8, 5),
])
def test_decode_plan_puts_every_key_in_exactly_one_chunk(b, hkv, sk):
    """Chunk i holds keys [i * chunk, (i + 1) * chunk): every key in one
    chunk and none past Sk; the grid holds up to DECODE_TARGET_BLOCKS
    blocks, no more chunks than 128-key pieces of the cache, and at least
    132 blocks hold keys unless every chunk is already the smallest (128
    keys) or there is one a pair."""
    splits, chunk = attn_ops.decode_plan(b, hkv, sk)
    assert chunk % attn_ops.DECODE_CHUNK_MULTIPLE == 0 and chunk > 0
    owner = np.arange(sk) // chunk
    assert owner.max() < splits and splits * chunk >= sk
    counts = np.bincount(owner, minlength=splits)
    assert counts.sum() == sk and (counts[:owner.max()] == chunk).all()
    heads = b * hkv
    assert splits == max(1, min(attn_ops.DECODE_TARGET_BLOCKS // heads,
                                -(-sk // attn_ops.DECODE_CHUNK_MULTIPLE)))
    assert heads * splits <= max(heads, attn_ops.DECODE_TARGET_BLOCKS)
    busy = heads * -(-sk // chunk)
    assert busy >= 132 or chunk == attn_ops.DECODE_CHUNK_MULTIPLE \
        or splits == 1


def test_decode_plan_keeps_the_grid_as_the_cache_grows():
    """danube's decode at B=4: one chunk of 128 keys up to the serving
    run's 128, a chunk more for each 128 keys after, and eight chunks a kv
    head from 1,024 keys on, whatever Sk is (the grid a CUDA graph over
    the step would keep); eight of 512 at a full window."""
    plans = {sk: attn_ops.decode_plan(4, 8, sk)
             for sk in (1, 77, 128, 129, 1024, 1025, 4096)}
    assert plans[1] == plans[77] == plans[128] == (1, 128)
    assert plans[129] == (2, 128)
    assert plans[1024] == (8, 128) and plans[1025] == (8, 256)
    assert plans[4096] == (8, 512)
    assert attn_ops.decode_plan(64, 8, 4096) == (1, 4096)  # B=64: no split


@pytest.mark.parametrize("rows,want", [
    (1, (1, 1)), (2, (2, 1)), (3, (4, 1)), (4, (4, 1)), (5, (8, 1)),
    (8, (8, 1)), (9, (8, 2)), (15, (8, 2)),
])
def test_decode_rows_groups_at_most_eight_rows_a_block(rows, want):
    assert attn_ops.decode_rows(rows) == want


def test_decode_workspace_is_kept_and_grown_with_zero_tickets():
    ws = attn_ops._Workspace()
    part, tickets = ws.get(CPU, 100, 8)
    assert part.dtype == torch.float32 and tickets.dtype == torch.int32
    assert not tickets.any()
    assert ws.get(CPU, 50, 4) == (part, tickets)        # kept
    part2, tickets2 = ws.get(CPU, 200, 16)              # grown
    assert part2.numel() == 200 and tickets2.numel() == 16
    assert not tickets2.any()


def _chunk_states(q, k, v, *, causal, window, chunk):
    """The decode kernel's per-chunk softmax states in fp32, base 2: for
    each chunk of ``chunk`` keys the max visible score m (-inf where the
    chunk shows a row no key), l = sum 2^(s - m) and the unnormalised
    acc = sum 2^(s - m) v, rows [B, Hq, Sq]."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    sq, sk, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (hd ** -0.5 * np.log2(np.e)),
                     kf)
    qi = torch.arange(sq)[:, None] + (sk - sq)
    kj = torch.arange(sk)[None]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= qi - kj < window
    s = s.masked_fill(~mask, float("-inf"))
    states = []
    for lo in range(0, sk, chunk):
        sc = s[..., lo:lo + chunk]
        m = sc.amax(-1)
        p = torch.exp2(sc - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        states.append((m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p,
                                                  vf[:, :, lo:lo + chunk])))
    return states


def _merge_chunks(states):
    """The kernel's merge, in chunk order: M = max m, each chunk weighed
    2^(m - M) (0 where M = -inf), out = sum acc / sum l, 0 where l = 0."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        wt = torch.where(torch.isfinite(M), torch.exp2(m - M), 0.0)
        wt = torch.nan_to_num(wt)
        L = L + wt * l
        A = A + wt[..., None] * acc
    return A / torch.where(L == 0, 1.0, L)[..., None]


@pytest.mark.parametrize("sk,window,chunk", [
    (288, None, 128),    # three chunks, the last ragged
    (288, 40, 128),      # a window: the first two chunks see no key
    (144, None, 128),    # a last chunk of 16 keys
    (80, None, 128),     # one chunk
])
def test_decode_chunk_merge_matches_jax_kernel(sk, window, chunk):
    """The decode kernel's split-and-merge arithmetic at decode shapes
    (danube's rep 4 and hd 80, Sq = 1) against the JAX Pallas kernel in
    interpret mode, at the suite's fp32 tolerance."""
    q, k, v = _qkv(2, 8, 2, 1, sk, 80, seed=sk)
    want = jflash_attention(*_j(q, k, v), causal=True, window=window,
                            block_q=1, block_k=16, backend="pallas-interpret")
    states = _chunk_states(*_t(q, k, v), causal=True, window=window,
                           chunk=chunk)
    if window is not None:
        assert not torch.isfinite(states[0][0]).any()   # a chunk with no key
    got = _merge_chunks(states)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_decode_chunk_merge_zeroes_a_row_that_sees_no_key():
    """More queries than keys: the first rows sit before key 0, every chunk
    gives them m = -inf and l = 0, and the merge gives 0, not NaN."""
    q, k, v = _t(*_qkv(1, 4, 1, 6, 3, 16, seed=4))
    got = _merge_chunks(_chunk_states(q, k, v, causal=True, window=None,
                                      chunk=2))
    assert torch.isfinite(got).all() and not got[:, :, :3].any()
    torch.testing.assert_close(got, attn_ref.attention_ref(q, k, v,
                                                           causal=True),
                               **ATTN_TOL)


@pytest.mark.parametrize("valid", [1, 77, 128])
def test_flash_attention_decode_over_a_cache_prefix_matches_jax_kernel(valid):
    """The LM's decode call at the decode variant's shape (bf16 operands,
    Sq = 1, danube's rep 4 and hd 80, causal=False) over the first ``valid``
    rows of a 128-row cache, read in place, against the JAX kernel in
    interpret mode on the same bf16 values."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 8, 2, 1, 128, 80, seed=valid))
    assert attn_ops.variant(q.dtype, 1, 4) == "decode"
    kp, vp = k[:, :, :valid], v[:, :, :valid]
    got = tk.flash_attention(q, kp, vp, causal=False)
    want = jflash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (q, kp.contiguous(), vp.contiguous())),
                            causal=False, block_q=1, block_k=valid,
                            backend="pallas-interpret")
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.array(want.astype(jnp.float32))),
        **ATTN_BF16_TOL)


def _mma_arithmetic(q, k, v, *, causal, window, split):
    """The tensor-core kernel's arithmetic in plain PyTorch: bf16 q, k, v;
    scores in fp32 (bf16 products are exact in fp32); P in fp32 for the
    normaliser, and into P.V as bf16 hi + bf16 lo (``split``) or rounded
    once to bf16; sums in fp32."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    sq, sk, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * hd ** -0.5
    qi = torch.arange(sq)[:, None] + (sk - sq)
    kj = torch.arange(sk)[None]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= qi - kj < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    o = torch.einsum("bhqk,bhkd->bhqd", hi, vf)
    if split:
        lo = (p - hi).bfloat16().float()
        o = o + torch.einsum("bhqk,bhkd->bhqd", lo, vf)
    return o / p.sum(-1, keepdim=True)


def test_flash_attention_split_p_keeps_the_pallas_kernels_precision():
    """The design's precision argument, on the CPU: P split into bf16 hi +
    lo stays within ATTN_BF16_TOL of the JAX Pallas kernel (interpret mode,
    bf16, two layers' worth of danube-like calls: hd 80, rep 4, a window),
    and P rounded once to bf16 lands further from the fp32 result than the
    split does."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 8, 2, 48, 48, 80, seed=11))
    want = jflash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (q, k, v)),
                            causal=True, window=24, block_q=16, block_k=16,
                            backend="pallas-interpret")
    split = _mma_arithmetic(q, k, v, causal=True, window=24, split=True)
    torch.testing.assert_close(
        split.bfloat16().float(),
        torch.from_numpy(np.array(want.astype(jnp.float32))),
        **ATTN_BF16_TOL)
    fp32 = attn_ref.attention_ref(q.float(), k.float(), v.float(),
                                  causal=True, window=24)
    once = _mma_arithmetic(q, k, v, causal=True, window=24, split=False)
    err_split = float((split - fp32).abs().max())
    err_once = float((once - fp32).abs().max())
    assert err_split < 1e-5 and err_once > 10 * err_split


def test_flash_attention_plain_version_zeroes_a_row_that_sees_no_key():
    """The l == 0 guard: called directly with more queries than keys, the
    first queries sit before key 0 and see nothing: 0, not NaN."""
    q, k, v = _t(*_qkv(1, 2, 1, 3, 1, 8))
    out = attn_ref.attention_ref(q, k, v, causal=True)
    assert not out[:, :, :2].any()
    torch.testing.assert_close(out[:, :, 2], v[:, :, 0].expand(1, 2, 8))


@pytest.mark.parametrize("shapes,match", [
    (((1, 3, 4, 8), (1, 2, 4, 8)), "not a multiple of Hkv"),
    (((1, 4, 5, 8), (1, 2, 4, 8)), "1 <= Sq <= Sk"),
    (((1, 4, 4, 12), (1, 2, 4, 12)), "head dim 12"),
    (((1, 4, 4, 136), (1, 2, 4, 136)), "head dim 136"),
    (((1, 4, 4, 8), (2, 2, 4, 8)), "shapes"),
])
def test_flash_attention_rejects_bad_shapes(shapes, match):
    (qs, ks) = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        tk.flash_attention(q, k, k)


def test_flash_attention_rejects_mixed_dtypes_window_and_grad():
    q, k, v = _t(*_qkv(1, 4, 2, 3, 5, 8))
    with pytest.raises(ValueError, match="share one dtype"):
        tk.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="share one dtype"):
        tk.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="window must be >= 1"):
        tk.flash_attention(q, k, v, window=0)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward yet"):
        tk.flash_attention(q, k, v)
    with torch.no_grad():
        assert torch.isfinite(tk.flash_attention(q, k, v)).all()


def test_flash_attention_dispatches_on_the_device_alone(monkeypatch):
    """No backend argument: CPU tensors run the plain version; naming the
    kernel for them through the port's variable raises."""
    q, k, v = _t(*_qkv(1, 4, 2, 3, 5, 8))
    with pytest.raises(TypeError):
        tk.flash_attention(q, k, v, backend=common.TORCH_REFERENCE)
    monkeypatch.setenv(common.ENV_BACKEND, common.CUDA)
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        tk.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def test_build_compiles_each_source_for_sm90a(monkeypatch):
    assert _build.sources() == ["flash_attn", "glm_grad", "glm_score",
                                "glm_sgd", "glm_sgd_sparse", "glm_sparse"]
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command("glm_sgd", _build.library_path("glm_sgd"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/glm_sgd.cu")
    lib = _build.library_path("glm_sgd")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_build_types_each_entry_point_once(monkeypatch):
    """A launch looks its typed C entry point up: the first call loads the
    library and sets argtypes, later calls return the same object and
    load nothing."""
    loads = []

    def load(lib):
        loads.append(lib)
        return ctypes.CDLL(None)   # this process: libc's abs stands in

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    fn = _build.function("glm_sgd", "abs", ctypes.c_int)
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert fn(-3) == 3
    for _ in range(3):
        assert _build.function("glm_sgd", "abs", ctypes.c_int) is fn
    assert loads == ["glm_sgd"]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check("glm_sgd", 700)
