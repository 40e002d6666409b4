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
from repro_torch.kernels import _build, common, tune
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
    first port refused it; the wide kernel's shape), against the JAX
    reference."""
    assert grad_ops.variant(60_000, "row") == "wide"
    X, y, w = _dense(19, 60_000, seed=4)
    ref = jglm_grad(task, *_j(w, X, y), backend="reference")
    out = tk.glm_grad(task, *_t(w, X, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("d,layout,want", [
    (3, "row", "ring"),                        # skin
    (54, "row", "ring"),                       # covtype
    (300, "row", "ring"),
    (grad_ops.RING_MAX_D, "row", "ring"),
    # these two ids name the kernel that took the shapes before the wide
    # kernel did; kept so that the cases keep their names
    pytest.param(grad_ops.RING_MAX_D + 1, "row", "wide", id="1025-row-row"),
    pytest.param(60_000, "row", "wide", id="60000-row-row"),
    (20_958, "row", "wide"),                   # real-sim's width, dense
    (grad_ops.WIDE_MAX_D, "row", "wide"),      # the wide kernel's widest
    (grad_ops.WIDE_MAX_D + 1, "row", "row"),
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


@pytest.mark.parametrize("d", [1_025, 2_048, 2_049, 4_097, 20_958, 50_001,
                               60_000, grad_ops.WIDE_MAX_D])
def test_glm_grad_wide_plan_gives_every_feature_one_block(d):
    """Block b of a cluster owns features [b * slice, (b + 1) * slice):
    every feature exactly one block, every block at least one, a slice its
    256 chain threads hold in at most 16 values each; the cluster the
    smallest power of two of blocks that allows that, at most 16; tiles of
    at most WIDE_MAX_ROWS rows (one exchange each) through at least three
    stages (the chain holds two), each block's shared memory within the
    card's 227 KB."""
    cluster, slice_, tile, stages = grad_ops.wide_plan(d)
    owners = np.zeros(d, dtype=np.int64)
    for b in range(cluster):
        lo, hi = b * slice_, min(d, (b + 1) * slice_)
        assert hi > lo
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert cluster & (cluster - 1) == 0 and cluster <= grad_ops.WIDE_MAX_CLUSTER
    assert slice_ <= grad_ops.WIDE_CHAIN_THREADS * grad_ops.WIDE_MAX_VALUES
    assert cluster == 1 or -(-d // (cluster // 2)) > \
        grad_ops.WIDE_CHAIN_THREADS * grad_ops.WIDE_MAX_VALUES
    assert 1 <= tile <= grad_ops.WIDE_MAX_ROWS
    assert grad_ops.WIDE_MIN_STAGES <= stages <= grad_ops.WIDE_MAX_STAGES
    assert grad_ops.WIDE_MIN_STAGES == 3
    assert grad_ops.wide_smem_bytes(cluster, slice_, stages, tile) \
        <= common.MAX_SMEM_BYTES
    assert grad_ops.wide_plan(d, tile) == (cluster, slice_, tile, stages)


@pytest.mark.parametrize("n", [1, 3, 300, 2_003, 16_384])
@pytest.mark.parametrize("clusters", [1, 8, 10, 64])
def test_glm_grad_wide_split_gives_every_row_one_cluster(n, clusters):
    """Cluster c walks tiles [c * per, (c + 1) * per) of the ceil(n / T):
    every tile exactly one cluster, every cluster of the launch at least
    one, no more clusters than the card holds at once (one wave)."""
    tile = grad_ops.wide_plan(20_958)[2]
    per, nparts = grad_ops.wide_split(n, tile, clusters)
    tiles = -(-n // tile)
    owners = np.zeros(tiles, dtype=np.int64)
    for c in range(nparts):
        lo, hi = c * per, min(tiles, (c + 1) * per)
        assert hi > lo
        owners[lo:hi] += 1
    assert (owners == 1).all() and 1 <= nparts <= clusters


def test_glm_grad_wide_plan_at_the_paths_widths():
    """The dense wide set (real-sim's 20,958 features) takes 8 blocks of
    2,620 and 7-row tiles through 3 stages; 60,000 the cap's 16 blocks of
    3,750 and 4-row tiles; Fig. 25's 2,048 one block and 8-row tiles: the
    most rows that leave three stages, the fastest tiles of the sweep on
    the card; past 16 x 4,096 the plan refuses (the row kernel keeps the
    shape)."""
    assert grad_ops.wide_plan(20_958) == (8, 2_620, 7, 3)
    assert grad_ops.wide_plan(60_000) == (16, 3_750, 4, 3)
    assert grad_ops.wide_plan(2_048) == (1, 2_048, 8, 3)
    assert grad_ops.wide_plan(grad_ops.WIDE_MAX_D + 1) == (0, 0, 0, 0)


@pytest.mark.parametrize("d,n", [(2_048, 300), (20_958, 200)])
@pytest.mark.parametrize("task", TASKS)
def test_glm_grad_wide_shapes_match_jax(task, d, n):
    """The wide kernel's shapes (a cluster of 1 and of 8 blocks) against the
    JAX reference (its Pallas flavor holds no model this wide in VMEM)."""
    assert grad_ops.variant(d, "row") == "wide"
    X, y, w = _dense(n, d, seed=d % 89)
    ref = jglm_grad(task, *_j(w, X, y), backend="reference")
    out = tk.glm_grad(task, *_t(w, X, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


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
    # past ROWS_MIN_BATCH; the id names the kernel that took the shape
    # before the rows kernel did, kept so that the case keeps its name
    pytest.param(300, 64, "rows", id="300-64-warp"),
    (300, sgd_ops.ROWS_MIN_BATCH - 1, "warp"),
    (sgd_ops.WARP_MAX_D, 1, "warp"),
    (sgd_ops.WARP_MAX_D, 27, "warp"),         # the widest two-stage ring
    # two stages no longer fit; the id names the kernel that took the shape
    # before the rows kernel did, kept so that the case keeps its name
    pytest.param(sgd_ops.WARP_MAX_D, 28, "rows", id="1024-28-smem"),
    (54, 1024, "rows"),                       # covtype, SyncSGD(batch=1024)
    # these two ids name the kernel that took the shapes before the cluster
    # kernel did; kept so that the cases keep their names
    pytest.param(sgd_ops.WARP_MAX_D + 1, 1, "cluster", id="1025-1-smem"),
    pytest.param(20_000, 64, "cluster", id="20000-64-smem"),  # in chunks
    (20_958, 1, "cluster"),                   # real-sim: Table 4's seq
    (58_112, 10, "cluster"),                  # past a block's shared memory
    # these two ids name the kernel that took the shapes before the grid
    # kernel did; kept so that the cases keep their names
    pytest.param(100_000, 16, "grid", id="100000-16-global"),
    (16 * 4_096, 1, "cluster"),               # the cluster's widest
    pytest.param(16 * 4_096 + 1, 1, "grid", id="65537-1-global"),
    (1_355_191, 1, "grid"),                   # news: Table 4's seq epoch
    (1_355_191, 64, "grid"),                  # a batch in fills of 2 rows
    (512 * 24 * 132 + 1, 1, "global"),        # past the grid's slices
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
    kernel's shapes up to WARP_MAX_D stay on the warp kernel or go to the
    rows kernel (which also takes the global kernel's batches past shared
    memory there), every wider one goes to the cluster kernel, as do the
    global kernel's up to the cluster's cap; past it the grid kernel takes
    what its plan fits, and the global kernel keeps the rest."""
    for d in (1, 3, 54, 300, 1023, 1024, 1025, 4096, 58_000, 58_111,
              58_112, 65_536, 65_537, 100_000, 200_000):
        for mb in (1, 2, 10, 16, 27, 28, 64, 111, 112):
            kind = sgd_ops.variant(d, mb)
            if d <= sgd_ops.WARP_MAX_D and \
                    sgd_ops.smem_bytes(d, mb) <= common.MAX_SMEM_BYTES:
                assert kind in ("warp", "rows")
            elif d <= 16 * 4_096:
                assert kind == "cluster"
            else:
                assert kind == ("grid" if sgd_ops.grid_plan(d, mb)[0]
                                else "global")
                assert kind == "grid"  # every one of these widths at R = 1
    assert sgd_ops.variant(58_111, 1) == "cluster"
    assert sgd_ops.variant(58_112, 1) == "cluster"
    assert sgd_ops.variant(65_536, 16) == "cluster"
    assert sgd_ops.variant(100_000, 16) == "grid"
    assert sgd_ops.variant(100_000, 16, 200) == "global"  # too many replicas
    assert sgd_ops.variant(1_025, 57_087) == "cluster"  # smem's longest batch
    assert sgd_ops.variant(54, 60_000) == "rows"   # a batch past the cap


def _last_warp_batch(d):
    return max(mb for mb in range(1, 2_048) if sgd_ops.warp_plan(d, mb)[0])


@pytest.mark.parametrize("d", [1, 3, 54, 300, 1_000, sgd_ops.WARP_MAX_D])
def test_glm_sgd_rows_takes_the_batches_past_the_warp_ring(d):
    """Up to WARP_MAX_D the warp kernel keeps the batches its ring holds
    below ROWS_MIN_BATCH rows; the rows kernel takes every other batch,
    the ring's first refused one, ROWS_MIN_BATCH and a whole covtype
    partition among them, at any replica count."""
    last = _last_warp_batch(d)
    cut = min(last + 1, sgd_ops.ROWS_MIN_BATCH)
    assert sgd_ops.variant(d, cut - 1) == "warp"
    for mb in (cut, last + 1, sgd_ops.ROWS_MIN_BATCH, 58_101):
        for n_rep in (1, 8, 10, 64):
            assert sgd_ops.variant(d, mb, n_rep) == "rows"
    assert sgd_ops.variant(d + sgd_ops.WARP_MAX_D, 58_101) == "cluster"


def test_glm_sgd_rows_edges_at_the_paths_widths():
    """The warp kernel's ring holds 522 covtype rows a batch, 94 at d =
    300 and 27 at 1,024; covtype's SyncSGD(batch=1024) and its
    AsyncLocalSGD(10, 58,101) partitions run on the rows kernel, the first
    in clusters of 16 blocks of 64 rows, the second in 10 clusters of 8
    whose runs stream through 128-row fills."""
    assert [_last_warp_batch(d) for d in (54, 300, 1_024)] == [522, 94, 27]
    assert sgd_ops.variant(54, 1_024) == "rows"
    assert sgd_ops.variant(54, 58_101, 10) == "rows"
    assert sgd_ops.rows_plan(54, 1_024) == (16, 8, 64, 4)
    assert sgd_ops.rows_plan(54, 58_101, 10) == (8, 16, 128, 4)
    assert sgd_ops.rows_plan(1_025, 64) == (0, 0, 0, 0)


@pytest.mark.parametrize("n_rep", [1, 8, 10, 64])
@pytest.mark.parametrize("d,mb,n", [(54, 1_024, 581_012), (54, 58_101, 58_101),
                                    (54, 600, 605), (300, 128, 1_037),
                                    (1_024, 28, 203), (1_000, 100, 1_037),
                                    (3, 1_024, 5_000), (54, 4_096, 9_000)])
def test_glm_sgd_rows_plan_gives_every_row_one_block(d, mb, n, n_rep):
    """Each batch's rows go to the cluster's blocks in contiguous runs,
    every row exactly one block (a ragged tail shorter than the cluster
    leaves some runs empty); a cluster is a power of two of blocks up to
    16, so that the replicas' clusters fit the H100's 132 SMs in one wave;
    a chain warp's tile of rb rows keeps rb x C <= 32 values a lane; each
    block's fills and at least two stages fit its 227 KB."""
    cluster, rb, frows, stages = sgd_ops.rows_plan(d, mb, n_rep)
    assert cluster & (cluster - 1) == 0 and cluster <= sgd_ops.ROWS_MAX_CLUSTER
    assert n_rep * cluster <= tune.H100_SMS
    assert rb & (rb - 1) == 0
    assert rb * sgd_ops.warp_columns(d) <= sgd_ops.ROWS_TILE_VALUES
    assert 2 <= stages <= sgd_ops.ROWS_MAX_STAGES and frows >= 1
    assert sgd_ops.rows_smem_bytes(d, cluster, stages, frows) \
        <= common.MAX_SMEM_BYTES
    for start in range(0, n, mb):
        rows = min(mb, n - start)
        runs = sgd_ops.rows_split(rows, cluster)
        owners = np.zeros(rows, dtype=np.int64)
        for lo, hi in runs:
            owners[lo:hi] += 1
        assert (owners == 1).all()
        assert max(h - lo for lo, h in runs) - min(h - lo for lo, h in runs) \
            <= 1


@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_batches_past_the_warp_ring_match_jax(task):
    """The rows kernel's shapes: covtype's width at micro-batch 600 (past
    the warp kernel's 522-row ring) against the Pallas kernel (interpret
    mode, two whole batches), and with a ragged 37-row tail against the JAX
    reference."""
    assert sgd_ops.variant(54, 600) == "rows"
    X, y, w = _dense(1_237, 54, seed=600)
    ref = jglm_sgd_epoch(task, *_j(w, X[:1_200], y[:1_200]), step=0.05,
                         micro_batch=600, backend="pallas-interpret")
    out = tk.glm_sgd_epoch(task, *_t(w, X[:1_200], y[:1_200]), step=0.05,
                           micro_batch=600)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)
    ref = jglm_sgd_epoch(task, *_j(w, X, y), step=0.05, micro_batch=600,
                         backend="reference")
    out = tk.glm_sgd_epoch(task, *_t(w, X, y), step=0.05, micro_batch=600)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


def test_glm_sgd_full_partitions_match_per_replica_jax():
    """AsyncLocalSGD(replicas=10, local_batch=per)'s replica epochs: one
    mean update a replica (the rows kernel's shape), each replica against
    the Pallas kernel on its own partition."""
    X, y, w = _dense(10 * 60, 54, seed=10)
    Xr, yr = X.reshape(10, 60, 54), y.reshape(10, 60)
    W = w[None] * np.linspace(-1.0, 1.0, 10, dtype=np.float32)[:, None]
    assert sgd_ops.variant(54, 5_810, 10) == "rows"
    out = tk.glm_sgd_epoch("lr", *_t(W, Xr, yr), step=0.1, micro_batch=60)
    for r in range(10):
        ref = jglm_sgd_epoch("lr", *_j(W[r], Xr[r], yr[r]), step=0.1,
                             micro_batch=60, backend="pallas-interpret")
        np.testing.assert_allclose(out[r].numpy(), np.asarray(ref),
                                   **EPOCH_TOL)


@pytest.mark.parametrize("d,mb", [(58_112, 1), (58_112, 10), (100_000, 16),
                                  (140_000, 3)])
def test_glm_sgd_past_shared_memory_matches_jax(d, mb):
    """Models too wide for a block's shared memory (the cluster kernel's
    shapes up to its cap, the grid kernel's past it; a ragged tail at
    micro-batches 10, 16 and 3) against the JAX reference."""
    assert sgd_ops.variant(d, mb) == ("cluster" if d <= 16 * 4_096
                                      else "grid")
    X, y, w = _dense(23, d, seed=mb)
    ref = jglm_sgd_epoch("lr", *_j(w, X, y), step=0.01, micro_batch=mb,
                         backend="reference")
    out = tk.glm_sgd_epoch("lr", *_t(w, X, y), step=0.01, micro_batch=mb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EPOCH_TOL)


@pytest.mark.parametrize("d,mb,n_rep", [(65_537, 1, 1), (100_000, 1, 1),
                                        (100_000, 16, 1), (100_000, 16, 3),
                                        (140_000, 3, 1), (200_000, 111, 1),
                                        (1_355_191, 1, 1), (1_355_191, 10, 1),
                                        (1_355_191, 64, 1), (100_000, 1, 8),
                                        (512 * 24 * 132, 1, 1)])
def test_glm_sgd_grid_plan_gives_every_feature_one_block(d, mb, n_rep):
    """Block b of a replica's grid owns features [b * slice, (b + 1) *
    slice): every feature exactly one block, every block at least one, a
    slice its 512 chain threads hold in at most 24 registers each; the
    replicas' blocks co-resident on the H100's 132 SMs, one a SM; two
    stages or more of a whole batch (up to 32 rows) where they fit, else
    fewer rows a fill; each block's shared memory within 227 KB."""
    blocks, slice_, stages, rows = sgd_ops.grid_plan(d, mb, n_rep)
    owners = np.zeros(d, dtype=np.int64)
    for b in range(blocks):
        lo, hi = b * slice_, min(d, (b + 1) * slice_)
        assert hi > lo
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert n_rep * blocks <= 132
    assert slice_ <= sgd_ops.GRID_CHAIN_THREADS * sgd_ops.GRID_MAX_VALUES
    assert 2 <= stages <= sgd_ops.GRID_MAX_STAGES
    assert sgd_ops.grid_smem_bytes(slice_, stages, rows) \
        <= common.MAX_SMEM_BYTES
    want = min(mb, sgd_ops.CLUSTER_CHUNK_ROWS)
    assert 1 <= rows <= want
    if rows < want:
        assert sgd_ops.grid_smem_bytes(slice_, 2, rows + 1) \
            > common.MAX_SMEM_BYTES
    assert sgd_ops.variant(d, mb, n_rep) == "grid"


def test_glm_sgd_grid_plan_at_news_and_where_it_refuses():
    """news's Table 4 seq epoch takes all 132 SMs, 10,267 features a block
    (about 20 a chain thread) and a 5-stage ring of single rows; 8
    replicas of d = 100,000 take 16 blocks each.  The plan refuses (the
    global kernel keeps the shape) past 132 x 12,288 features on one
    replica and where the replicas outnumber the SMs."""
    assert sgd_ops.grid_plan(1_355_191, 1) == (132, 10_267, 5, 1)
    assert sgd_ops.grid_plan(100_000, 1, 8)[:2] == (16, 6_250)
    for d, mb, n_rep in ((512 * 24 * 132 + 1, 1, 1), (100_000, 1, 133),
                         (1_355_191, 1, 2)):
        assert sgd_ops.grid_plan(d, mb, n_rep) == (0, 0, 0, 0)
        assert sgd_ops.variant(d, mb, n_rep) == "global"
    # another card's SM count moves the plan: 114 SMs hold news at 11,888
    # features a block, 100 do not
    assert sgd_ops.grid_plan(1_355_191, 1, 1, 114)[:2] == (114, 11_888)
    assert sgd_ops.grid_plan(1_355_191, 1, 1, 100) == (0, 0, 0, 0)
    assert sgd_ops.variant(1_355_191, 1, 1, 100) == "global"


@pytest.mark.parametrize("d,mb,n", [(65_537, 1, 9), (70_001, 5, 13),
                                    (140_001, 3, 11)])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_grid_shapes_match_jax(task, d, mb, n):
    """The grid kernel's shapes (past the cluster's 65,536 features) at
    micro-batch 1 and ragged ones (13 rows at 5, 11 at 3) against the JAX
    reference (its Pallas flavor holds no model this wide in VMEM)."""
    assert sgd_ops.variant(d, mb) == "grid"
    X, y, w = _dense(n, d, seed=d % 97)
    ref = jglm_sgd_epoch(task, *_j(w, X, y), step=1.0 / d, micro_batch=mb,
                         backend="reference")
    out = tk.glm_sgd_epoch(task, *_t(w, X, y), step=1.0 / d, micro_batch=mb)
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
    # rows past the stream kernel's go to the live-prefix kernel in global
    # memory; the global kernel keeps the batches whose pulls leave it no
    # ring
    assert sgd_sparse_ops.variant(d, sgd_sparse_ops.STREAM_MAX_K + 1, 1) \
        == "live_global"
    assert sgd_sparse_ops.variant(d, sgd_sparse_ops.STREAM_MAX_K + 1,
                                  60_000) == "global"
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
    # rows past the stream's: the global kernel's until the live-prefix
    # kernel took them; the id names the kernel that took the shape first
    pytest.param(1_355_191, 8_193, 1, "live_global",
                 id="1355191-8193-1-global"),
    (20_958, 3_484, 1, "live_smem"),          # real-sim at Table 3's K
    (20_958, 3_484, 10, "live_smem"),
    (20_958, 3_484, 16, "live_smem"),
    (20_958, 3_484, 7_231, "live_smem"),      # a batch past a fill
    (1_355_191, 16_423, 1, "live_global"),    # news at Table 3's K
    (1_355_191, 16_423, 10, "live_global"),
    (1_355_191, 16_423, 60_000, "global"),    # pulls that leave no ring
])
def test_glm_sgd_sparse_variant_is_chosen_from_the_shape(d, k, mb, want):
    assert sgd_sparse_ops.variant(d, k, mb) == want
    stages, group = sgd_sparse_ops.warp_plan(d, k, mb)
    if want == "warp":
        assert stages >= 2 and group >= 1
        assert sgd_sparse_ops.warp_smem_bytes(d, k, mb, stages, group) \
            <= common.MAX_SMEM_BYTES
        assert 32 * sgd_sparse_ops.warp_columns(k) >= k
    if want.startswith("live"):
        smem_model = want == "live_smem"
        stages, words = sgd_sparse_ops.live_plan(d, mb, smem_model)
        assert stages >= sgd_sparse_ops.LIVE_MIN_STAGES
        assert words >= sgd_sparse_ops.LIVE_MIN_WORDS and words % 4 == 0
        assert sgd_sparse_ops.live_smem_bytes(d, mb, stages, words,
                                              smem_model) \
            <= common.MAX_SMEM_BYTES


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


@pytest.mark.parametrize("d,mb,smem_model,want", [
    (20_958, 1, True, (8, 2_204)),        # real-sim's model: 84 KB
    (20_958, 16, True, (8, 2_204)),
    (20_958, 7_231, True, (6, 2_376)),    # its pulls take 29 KB more
    (1_355_191, 1, False, (8, 3_480)),    # news: the model in global memory
    (1_355_191, 10, False, (8, 3_480)),
    (47_236, 10, True, (0, 0)),           # rcv1's 189 KB model: no ring
    (1_355_191, 60_000, False, (0, 0)),
])
def test_glm_sgd_sparse_live_plan_fits_a_block(d, mb, smem_model, want):
    """The most stages, up to eight, of the most words that fit beside the
    model (or the chain's partials) and the batch's pulls; none where four
    stages of 2,048 words do not fit; one more stage or four more words
    would not fit."""
    plan = sgd_sparse_ops.live_plan(d, mb, smem_model)
    assert plan == want
    stages, words = plan
    if stages:
        nbytes = lambda s, w: sgd_sparse_ops.live_smem_bytes(  # noqa: E731
            d, mb, s, w, smem_model)
        assert nbytes(stages, words) <= common.MAX_SMEM_BYTES
        assert nbytes(stages, words + 4) > common.MAX_SMEM_BYTES
        assert stages == sgd_sparse_ops.LIVE_MAX_STAGES or nbytes(
            stages + 1, sgd_sparse_ops.LIVE_MIN_WORDS) > common.MAX_SMEM_BYTES


def _live_rows(n, k, seed, spread=False):
    """Row lengths a live-prefix ring stages: log-normal around k / 40 in
    [1, k] (the first row at k), every 7th row all padding, and, with
    ``spread``, each row's live entries anywhere in its K slots."""
    rng = np.random.default_rng(seed)
    nnz = np.clip(np.exp(np.log(k / 40) + 0.8 * rng.normal(size=n)), 1,
                  k).astype(np.int64)
    nnz[0] = k
    live = np.arange(k)[None] < nnz[:, None]
    if spread:
        live = np.stack([rng.permutation(row) for row in live])
    live[::7] = False
    return live


#: a fill's pass in the live-prefix kernels (csrc/glm_sgd_sparse.cu): a
#: batch's margins, its scatter, or both (whole batches in one fill)
LIVE_MARGINS, LIVE_SCATTER, LIVE_BOTH = 0, 1, 2
#: a piece holds its row's first entries, its last; its batch is the
#: ragged tail
LIVE_FIRST, LIVE_LAST, LIVE_TAIL = 1, 2, 4


def _live_fills(lengths, micro_batch: int, words: int, group: bool = True,
                k: int = 0, first: int = 0) -> list[tuple[int, list]]:
    """The fills the live-prefix kernels' producer stages for one replica
    whose rows' live lengths (``ops.live_lengths``) are ``lengths``, in
    order, as ``(pass, pieces)``; a piece is ``(row, first entry, entries,
    word of its first value in the stage, flags)``.
    csrc/glm_sgd_sparse.cu:live_produce's walk: a batch's rows while they
    fit the stage's ``words`` and LIVE_PIECES (a row of padding takes no
    piece), each at a 4-word boundary plus its offset from a 16-byte
    boundary in memory (the replica's values start ``first`` words past one,
    rows ``k`` apart), then as much of the next row as the room left holds.
    A batch in one fill is LIVE_BOTH, and with ``group`` (the model in
    shared memory) the whole batches of up to 32 rows after it join it while
    each fits (``live_group``); a longer batch is its fills with
    LIVE_MARGINS, then again with LIVE_SCATTER."""
    n = len(lengths)
    tail_batch = n // micro_batch if n % micro_batch else -1

    def flags(r, done):
        return ((LIVE_FIRST if done == 0 else 0)
                | (LIVE_TAIL if r // micro_batch == tail_batch else 0))

    def fill(b1, pos, done, free, pieces):
        while (pos < b1 and len(pieces) < sgd_sparse_ops.LIVE_PIECES
               and free >= 4):
            left = int(lengths[pos]) - done
            if left <= 0:
                pos, done = pos + 1, 0
                continue
            at = words - free + (first + pos * k + done) % 4
            need = common.padded(left + 3, 4)
            if need <= free:
                pieces.append((pos, done, left, at,
                               flags(pos, done) | LIVE_LAST))
                free -= need
                pos, done = pos + 1, 0
                continue
            pieces.append((pos, done, free - 3, at, flags(pos, done)))
            done += free - 3
            free = 0
        return pos, done, free

    def batch_fits(b0, b1, free, pieces):
        rows = [int(x) for x in lengths[b0:b1] if x > 0]
        return (sum(common.padded(x + 3, 4) for x in rows) <= free
                and len(pieces) + len(rows) <= sgd_sparse_ops.LIVE_PIECES)

    fills = []
    b0 = 0
    while b0 < n:
        b1 = min(n, b0 + micro_batch)
        pieces = []
        pos, done, free = fill(b1, b0, 0, words, pieces)
        if pos >= b1:
            while (group and micro_batch <= 32 and b1 < n
                   and len(pieces) < sgd_sparse_ops.LIVE_PIECES and free >= 4
                   and batch_fits(b1, min(n, b1 + micro_batch), free,
                                  pieces)):
                c0, b1 = b1, min(n, b1 + micro_batch)
                pos, done, free = fill(b1, c0, 0, free, pieces)
            fills.append((LIVE_BOTH, pieces))
            b0 = b1
            continue
        fills.append((LIVE_MARGINS, pieces))
        while pos < b1:
            pieces = []
            pos, done, free = fill(b1, pos, done, words, pieces)
            fills.append((LIVE_MARGINS, pieces))
        pos, done = b0, 0
        while pos < b1:
            pieces = []
            pos, done, free = fill(b1, pos, done, words, pieces)
            fills.append((LIVE_SCATTER, pieces))
        b0 = b1
    return fills


@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("k,mb,words", [(3_484, 1, 2_204), (3_484, 16, 2_204),
                                        (3_484, 7_231, 2_376),
                                        (16_423, 1, 3_480), (16_423, 10, 3_480),
                                        (69, 40, 2_048), (1, 3, 2_048)])
def test_glm_sgd_sparse_live_fills_give_every_entry_one_owner(k, mb, words,
                                                              group):
    """Each live entry of a replica lies in exactly one piece of its batch's
    margins (a LIVE_BOTH or LIVE_MARGINS fill) and one of its scatter
    (LIVE_BOTH or LIVE_SCATTER); the pieces of a fill lie apart within its
    words at their rows' offsets from a 16-byte boundary, at most
    LIVE_PIECES of them, a batch's pieces consecutive; a row is pieces in
    order, the first flagged first and the last last, the ragged tail's
    flagged; a grouped fill holds whole batches only, and a batch that is
    not whole in one fill has its fills to itself."""
    n = 300 if mb < 1_000 else 2 * mb + 13
    live = _live_rows(n, k, seed=k + mb)
    lengths = sgd_sparse_ops.live_lengths(torch.from_numpy(
        live.astype(np.float32))).numpy()
    assert (lengths == np.where(live.any(1), k - np.argmax(live[:, ::-1], 1),
                                0)).all()
    first = 3
    fills = _live_fills(lengths, mb, words, group=group, k=k,
                                      first=first)
    for margins in (True, False):
        owned = np.zeros((n, k), dtype=np.int64)
        for kind, pieces in fills:
            if kind == (LIVE_SCATTER if margins
                        else LIVE_MARGINS):
                continue
            assert len(pieces) <= sgd_sparse_ops.LIVE_PIECES
            batches = {r // mb for r, *_ in pieces}
            if kind != LIVE_BOTH or not group:
                assert len(batches) <= 1
            ends = []
            for r, e0, count, at, flags in pieces:
                assert count > 0
                owned[r, e0:e0 + count] += 1
                assert at % 4 == (first + r * k + e0) % 4
                ends.append((at, at + count))
                assert bool(flags & LIVE_FIRST) == (e0 == 0)
                assert bool(flags & LIVE_LAST) \
                    == (e0 + count == lengths[r])
                assert bool(flags & LIVE_TAIL) \
                    == (r // mb == (n - 1) // mb and n % mb != 0)
            ends.sort()
            assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
            assert not ends or (ends[0][0] >= 0 and ends[-1][1] <= words)
            seen = [r // mb for r, *_ in pieces]
            assert seen == sorted(seen)
        want = np.arange(k)[None] < lengths[:, None]
        assert (owned == want).all()
    both = [r // mb for kind, pieces in fills
            if kind == LIVE_BOTH for r, *_ in pieces]
    split = {r // mb for kind, pieces in fills
             if kind != LIVE_BOTH for r, *_ in pieces}
    assert not split & set(both)
    if not group:
        assert len(set(both)) == len(
            [1 for kind, pieces in fills
             if kind == LIVE_BOTH and pieces])


def _live_epoch(task, w, values, indices, y, step, mb, words, group):
    """An epoch as the live-prefix chain runs it, from ``_live_fills``: a
    fill's batches in turn (each run of pieces of one batch), their
    pieces' margins summed piece by piece into their rows, each row's pull
    at its last piece, every pull of a batch against the same w, then the
    scatter from the pieces of its scatter fills."""
    from repro_torch.core import glm

    w = w.clone().double()
    v, i = values.double(), indices.long()
    lengths = sgd_sparse_ops.live_lengths(values).numpy()
    n = len(lengths)
    pull = glm.PULLS[task]
    acc = {}
    for kind, pieces in _live_fills(lengths, mb, words,
                                                  group=group):
        batch = []
        for at, piece in enumerate(pieces):
            batch.append(piece)
            if at + 1 < len(pieces) and pieces[at + 1][0] // mb \
                    == piece[0] // mb:
                continue
            rows = n % mb if batch[0][4] & LIVE_TAIL else mb
            if kind != LIVE_SCATTER:
                for r, e0, count, _, flags in batch:
                    m = 0.0 if flags & LIVE_FIRST else acc[r]
                    m += float((v[r, e0:e0 + count]
                                * w[i[r, e0:e0 + count]]).sum())
                    acc[r] = m
                    if flags & LIVE_LAST:
                        yr = torch.tensor(float(y[r]), dtype=torch.float64)
                        acc[r] = -step / rows * float(pull(yr * m, yr))
            if kind != LIVE_MARGINS:
                for r, e0, count, _, _ in batch:
                    w.index_add_(0, i[r, e0:e0 + count],
                                 acc[r] * v[r, e0:e0 + count])
            batch = []
        assert not batch
    return w.float()


@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("mb,words", [(1, 2_048), (10, 2_048), (16, 64),
                                      (23, 2_048), (40, 48)])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_live_fills_run_the_plain_epoch(task, mb, words, group):
    """The live-prefix chain's schedule (``_live_fills``) computes the plain
    version's epoch: rows of K = 300 with their padding spread through
    them and every 7th all padding, batches that fit a fill (grouped or
    alone) and batches over several (16 rows in 64-word stages, 40 in 48),
    a ragged tail."""
    k, n = 300, 203
    live = _live_rows(n, k, seed=mb, spread=True)
    rng = np.random.default_rng(mb)
    values = (rng.normal(0, 1, (n, k)) * live).astype(np.float32)
    indices = (rng.integers(0, 500, (n, k)) * live).astype(np.int32)
    values[1, :3], indices[1, :3] = 1.0, 5
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, 500).astype(np.float32)
    args = _t(w, values, indices, y)
    out = _live_epoch(task, *args, 0.05, mb, words, group)
    ref = sgd_sparse_ops.R.ell_sgd_epoch_ref(
        task, args[0][None], args[1][None], args[2][None], args[3][None],
        0.05, mb)[0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **EPOCH_TOL)


def test_glm_sgd_sparse_live_lengths_end_at_the_last_nonzero():
    """The length pass's plain version: a row of padding gives 0, a nonzero
    after a zero counts (padding need not come last), K = 1 takes 0 or 1,
    and a replica axis keeps its shape."""
    values = torch.tensor([[0.0, 0.0, 0.0, 0.0], [0.0, 2.0, 0.0, 0.0],
                           [1.0, 0.0, 0.0, -3.0], [0.0, 0.0, 0.5, 0.0]])
    assert sgd_sparse_ops.live_lengths(values).tolist() == [0, 2, 4, 3]
    assert sgd_sparse_ops.live_lengths(values).dtype == torch.int32
    assert sgd_sparse_ops.live_lengths(
        torch.tensor([[0.0], [4.0], [0.0]])).tolist() == [0, 1, 0]
    stacked = torch.stack([values, values.flip(1), torch.zeros(4, 4)])
    assert sgd_sparse_ops.live_lengths(stacked).tolist() == [
        [0, 2, 4, 3], [0, 3, 4, 2], [0, 0, 0, 0]]


def _long_rows(n, d, k, seed):
    """Padded-ELL rows of up to k entries with each row's padding spread
    through it, every 7th row all padding, one feature three times in the
    second row, and labels and a model, seeded."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, k + 1, n)
    live = np.arange(k)[None] < nnz[:, None]
    values = (rng.normal(0, 1, (n, k)) * live).astype(np.float32)
    indices = (rng.integers(0, d, (n, k)) * live).astype(np.int32)
    cols = rng.permutation(k)
    values, indices = values[:, cols].copy(), indices[:, cols].copy()
    values[::7], indices[::7] = 0.0, 0
    values[1, :3], indices[1, :3] = 1.0, 5
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, d).astype(np.float32)
    return values, indices, y, w


@pytest.mark.parametrize("mb", [1, 10])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_long_rows_in_shared_memory_match_jax_kernel(task, mb):
    """live_smem's shapes (rows past WARP_MAX_K, the model in shared
    memory) at K = 1,100, d = 2,000 with the padding spread through each
    row, rows of all padding and a feature repeated in a row, over three
    replicas, against the Pallas kernel (interpret mode; it takes no
    ragged tail)."""
    d, k, n, reps = 2_000, 1_100, 30, 3
    assert sgd_sparse_ops.variant(d, k, mb) == "live_smem"
    values, indices, y, w = _long_rows(n * reps, d, k, seed=mb)
    v, i, yr = (values.reshape(reps, n, k), indices.reshape(reps, n, k),
                y.reshape(reps, n))
    W = np.stack([w, 0.5 * w, -w])
    out = tk.ell_sgd_epoch(task, *_t(W, v, i, yr), step=0.05, micro_batch=mb)
    for r in range(reps):
        ref = jell_sgd_epoch(task, *_j(W[r], v[r], i[r], yr[r]), step=0.05,
                             micro_batch=mb, backend="pallas-interpret")
        np.testing.assert_allclose(out[r].numpy(), np.asarray(ref),
                                   **EPOCH_TOL)


@pytest.mark.parametrize("mb", [1, 10])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sgd_sparse_long_rows_in_global_memory_match_jax(task, mb):
    """live_global's shapes (rows past STREAM_MAX_K, the model past a
    block's shared memory) at K = 8,300, d = 70,000 with the padding spread
    through each row, rows of all padding, a feature repeated in a row and
    a ragged tail (23 rows at 10), over three replicas, against the JAX
    reference (its Pallas flavor holds no such one-hot)."""
    d, k, n, reps = 70_000, 8_300, 23, 3
    assert sgd_sparse_ops.variant(d, k, mb) == "live_global"
    values, indices, y, w = _long_rows(n * reps, d, k, seed=10 + mb)
    v, i, yr = (values.reshape(reps, n, k), indices.reshape(reps, n, k),
                y.reshape(reps, n))
    W = np.stack([w, 0.5 * w, -w])
    out = tk.ell_sgd_epoch(task, *_t(W, v, i, yr), step=0.05, micro_batch=mb)
    for r in range(reps):
        ref = jell_sgd_epoch(task, *_j(W[r], v[r], i[r], yr[r]), step=0.05,
                             micro_batch=mb, backend="reference")
        np.testing.assert_allclose(out[r].numpy(), np.asarray(ref),
                                   **EPOCH_TOL)


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
    # these three ids name the kernel that took the shapes before the hot
    # kernel did; kept so that the cases keep their names
    pytest.param(29_025, 1, 1, "hot", id="29025-1-1-atomic"),
    pytest.param(47_236, 1_224, 1, "hot",     # rcv1, its Table 3 max_nnz
                 id="47236-1224-1-atomic"),
    pytest.param(1_355_191, 2_729, 1, "hot",  # news
                 id="1355191-2729-1-atomic"),
    (47_236, 438, 1, "hot"),                  # rcv1, paper_dataset's pad
    (47_236, 438, 10, "hot"),
    (1_355_191, 16_423, 1, "hot"),            # news's Table 3 max_nnz
    (1_355_191, 16_897, 1, "atomic"),         # past HOT_MAX_K
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


@pytest.mark.parametrize("d,k,n_rep,n", [(47_236, 438, 1, 677_399),
                                         (47_236, 438, 1, 16_384),
                                         (1_355_191, 2_729, 1, 19_996),
                                         (47_236, 438, 10, 1_000),
                                         (29_025, 69, 1, 31),
                                         (58_000, 69, 200, 2_003)])
def test_glm_sparse_hot_plan_covers_every_row_once(d, k, n_rep, n):
    """A replica's rows in blocks of per_block consecutive rows, every row
    exactly once, no block with fewer rows than its 32 warps need for one
    each unless it is the only one; one block a SM over the replicas; the
    hot features' copy within a block's shared memory."""
    hot, blocks, per_block = sparse_ops.hot_plan(d, k, n_rep, n, 132)
    assert (blocks - 1) * per_block < n <= blocks * per_block
    assert blocks * n_rep <= 132 or blocks == 1
    assert blocks == 1 or per_block >= sparse_ops.HOT_WARPS
    assert hot == min(sparse_ops.HOT, d)
    assert 4 * hot <= common.MAX_SMEM_BYTES
    assert sparse_ops.hot_entries(k) in sparse_ops.HOT_ENTRIES
    assert 32 * sparse_ops.hot_entries(k) >= min(k, 32 * 16)


def test_glm_sparse_hot_plan_at_the_paper_widths():
    """rcv1 and news run 132 blocks of 32 warps; rcv1's rows (K = 438) fit
    the registers at 16 entries a lane, news's (K = 2,729) take 9 chunks of
    256 more; the plan refuses rows past HOT_MAX_K."""
    assert sparse_ops.hot_plan(47_236, 438, 1, 677_399, 132) \
        == (4_096, 132, 5_132)
    assert sparse_ops.hot_plan(1_355_191, 2_729, 1, 19_996, 132) \
        == (4_096, 132, 152)
    assert sparse_ops.hot_entries(438) == 16
    assert -(-(2_729 - 32 * 16) // 256) == 9 <= sparse_ops.HOT_MARKED_CHUNKS
    assert sparse_ops.hot_plan(1_355_191, sparse_ops.HOT_MAX_K + 1, 1, 10,
                               132) == (0, 0, 0)


def test_glm_sparse_hot_features_are_the_most_frequent():
    """The operand's most frequent features, each given its place in the
    list, every other feature -1; counted once for an operand, again after
    an in-place write."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.zipf(1.5, (200, 30)).clip(max=999).astype(
        np.int32) - 1)
    hot_list, slot = sparse_ops.hot_features(idx, 1000, 20)
    counts = np.bincount(idx.numpy().ravel(), minlength=1000)
    assert set(hot_list.tolist()) <= set(range(1000))
    assert len(set(hot_list.tolist())) == 20
    assert counts[hot_list.numpy()].min() >= np.sort(counts)[-20]
    assert (slot[hot_list.long()] == torch.arange(20, dtype=torch.int32)).all()
    assert int((slot >= 0).sum()) == 20
    assert sparse_ops.hot_features(idx, 1000, 20)[1] is slot
    idx[0, 0] = 998  # an in-place write: counted again
    assert sparse_ops.hot_features(idx, 1000, 20)[1] is not slot


@pytest.mark.parametrize("d,k", [(29_025, 69), (47_236, 438)])
@pytest.mark.parametrize("task", TASKS)
def test_glm_sparse_past_the_smem_cap_matches_jax(task, d, k):
    """The hot kernel's widths (one past the smem kernel's and rcv1's) with
    each row's padding spread through it, rows of all padding and a
    feature repeated in a row, against the JAX reference (the Pallas
    flavor routes d past 32,768 to it)."""
    assert sparse_ops.variant(d, k, 1) == "hot"
    rng = np.random.default_rng(d)
    n = 40
    nnz = rng.integers(1, k + 1, n)
    live = np.arange(k)[None] < nnz[:, None]
    values = (rng.normal(0, 1, (n, k)) * live).astype(np.float32)
    indices = (rng.integers(0, d, (n, k)) * live).astype(np.int32)
    cols = rng.permutation(k)
    values, indices = values[:, cols].copy(), indices[:, cols].copy()
    values[::7], indices[::7] = 0.0, 0
    values[1, :3], indices[1, :3] = 1.0, 5
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.normal(0, 0.1, d).astype(np.float32)
    ref = jell_glm_grad(task, *_j(w, values, indices, y), backend="reference")
    out = tk.ell_glm_grad(task, *_t(w, values, indices, y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)


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
        "flash_attn_bwd": lambda: torch.ops.repro_torch.flash_attn_bwd(
            *_t(*_qkv(1, 4, 2, 3, 9, 8)), torch.ones(1, 4, 3, 8),
            torch.ones(1, 4, 3, 8), torch.zeros(1, 4, 3),
            torch.zeros(1, 4, 3, 0), True, None),
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
        "flash_attn", "flash_attn_bwd", "glm_grad", "glm_score", "glm_sgd",
        "glm_sgd_sparse", "glm_sparse")
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


_MIN_Q = attn_ops.WGMMA_MIN_QUERIES


@pytest.mark.parametrize("dtype,sq,rep,hd,want", [
    (torch.bfloat16, 15, 1, 80, "decode"),   # 15 rows: short of an MMA's 16
    (torch.bfloat16, 16, 1, 80, "mma"),
    (torch.bfloat16, 4, 4, 80, "mma"),       # danube's rep: 4 positions fill 16
    (torch.bfloat16, 5, 3, 128, "decode"),   # rep 3 (minitron): 15 rows
    (torch.bfloat16, 8192, 4, 80, "wgmma"),  # danube's prefill: warpgroups
    (torch.bfloat16, 1, 4, 80, "decode"),    # decode
    (torch.bfloat16, 1, 16, 128, "mma"),     # decode with 16 heads a kv head
    (torch.float32, 8192, 4, 80, "simt_tiled"),  # fp32: its tolerance needs
                                                 # fp32, register-tiled
    (torch.float32, 1, 4, 80, "simt"),       # fp32 decode stays on the fp32 kernel
    # the TILED_MIN_QUERIES edge: a shorter fp32 chunk stays on "simt"
    (torch.float32, attn_ops.TILED_MIN_QUERIES - 1, 4, 80, "simt"),
    (torch.float32, attn_ops.TILED_MIN_QUERIES, 4, 80, "simt_tiled"),
    (torch.float32, 1024, 8, 8, "simt_tiled"),   # hd 8, rep 8
    # every head dim "wgmma" takes, at the vlm cross call's 2,048 queries
    *[(torch.bfloat16, 2048, 4, hd, "wgmma")
      for hd in attn_ops.WGMMA_HEAD_DIMS],
    # the WGMMA_MIN_QUERIES edge: a shorter query chunk stays on "mma"
    (torch.bfloat16, _MIN_Q - 1, 4, 80, "mma"),
    (torch.bfloat16, _MIN_Q, 4, 80, "wgmma"),
    (torch.bfloat16, _MIN_Q + 1, 1, 64, "wgmma"),
    # head dims "wgmma" does not take: 72 (a hd % 16 == 8 depth), 32, 120
    (torch.bfloat16, 8192, 4, 72, "mma"),
    (torch.bfloat16, 8192, 4, 32, "mma"),
    (torch.bfloat16, 8192, 1, 120, "mma"),
    (torch.float32, 8192, 4, 128, "simt_tiled"),  # fp32 at a "wgmma" head dim
])
def test_flash_attention_variant_is_chosen_from_dtype_and_rows(dtype, sq,
                                                                rep, hd, want):
    assert attn_ops.variant(dtype, sq, rep, hd) == want
    # the C entry point's code: 0 flash_attn_kernel, 1 flash_attn_mma_kernel,
    # 3 flash_attn_wgmma_kernel, 4 flash_attn_tiled_kernel (the decode
    # kernel has an entry point of its own)
    assert attn_ops.VARIANTS.index(want) == {"simt": 0, "mma": 1,
                                             "decode": 2, "wgmma": 3,
                                             "simt_tiled": 4}[want]


@pytest.mark.parametrize("arch", [
    "minitron-4b", "command-r-35b", "h2o-danube-1.8b", "minitron-8b",
    "olmoe-1b-7b", "kimi-k2-1t-a32b", "musicgen-large", "zamba2-1.2b",
    "llama-3.2-vision-11b"])
def test_flash_attention_training_forward_runs_wgmma(arch):
    """The training path's forward (the operator asked for the statistics,
    ``lse=True``) runs ``"wgmma"`` at every attention family's training
    shapes: ``train_4k``'s 4,096 queries and the single-card runs' 1,024
    and 2,048 (hd 64, 80, 112 and 128, rep 1 to 8); a decode-sized call
    with statistics runs ``"mma"``, never ``"decode"``."""
    from repro_torch import configs

    cfg = configs.get(arch)
    rep = cfg.n_heads // cfg.n_kv
    for sq in (configs.SHAPES["train_4k"][1], 1024, 2048):
        assert attn_ops.call_variant(cfg.param_dtype, sq, rep, cfg.hd,
                                     lse=True) == "wgmma"
    assert attn_ops.call_variant(cfg.param_dtype, 1, rep, cfg.hd,
                                 lse=True) == "mma"
    assert attn_ops.call_variant(cfg.param_dtype, 1, rep, cfg.hd,
                                 lse=False) in ("decode", "mma")


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
    assert attn_ops.variant(q.dtype, 1, 4, 80) == "decode"
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
    # inputs that require grad no longer raise: the call is differentiable
    # (the plain backward of flash_attn/ref.py), and its gradient is finite
    q.requires_grad_(True)
    tk.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
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


def test_flash_attention_backward_dispatches_on_the_device_alone(
        monkeypatch):
    """The operator's backward is the family ``"flash_attn_bwd"``: CPU
    tensors reach its plain flavor (``ref.attention_bwd_ref``) and launch
    nothing; naming the kernel for them raises; ``plain_versions`` can
    take it out alone."""
    q, k, v = _t(*_qkv(1, 4, 2, 5, 9, 8))
    do = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, q.shape).astype(np.float32))
    before = dict(common.LAUNCHES)
    out, lse, lo = torch.ops.repro_torch.flash_attn(q, k, v, True, 3, None,
                                                    None, True)
    # a call with no gradient to take asks for no statistics
    again, none, no_lo = torch.ops.repro_torch.flash_attn(q, k, v, True, 3,
                                                          None, None, False)
    assert torch.equal(again, out) and none.shape == (1, 4, 0)
    assert lse.shape == (1, 4, 5) and lse.dtype == torch.float32
    # fp32's output needs no rounding residual
    assert lo.shape == no_lo.shape == (1, 4, 5, 0)
    assert common.LAUNCHES == before
    got = torch.ops.repro_torch.flash_attn_bwd(q, k, v, do, out, lse, lo,
                                               True, 3)
    want = attn_ref.attention_bwd_ref(q, k, v, do, causal=True, window=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert common.LAUNCHES == before
    assert common.backends_for("flash_attn_bwd") == (common.CUDA,
                                                     common.TORCH_REFERENCE)
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        common.dispatch("flash_attn_bwd", CPU, q, k, v, do, out, lse, lo,
                        causal=True, window=3, backend=common.CUDA)
    cuda = torch.device("cuda")
    with common.plain_versions("flash_attn_bwd"):
        assert common.resolve_backend("flash_attn_bwd", cuda) == \
            common.TORCH_REFERENCE
        assert common.resolve_backend("flash_attn", cuda) == common.CUDA
    assert common.resolve_backend("flash_attn_bwd", cuda) == common.CUDA
    with pytest.raises(KeyError):
        with common.plain_versions("no_such_kernel"):
            pass
    monkeypatch.setenv(common.ENV_BACKEND, common.CUDA)
    with pytest.raises(RuntimeError, match="cannot take tensors on cpu"):
        torch.ops.repro_torch.flash_attn_bwd(q, k, v, do, out, lse, lo, True,
                                             3)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 72, "mma"),
    (torch.bfloat16, 48, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.float32, 80, "simt_tiled"), (torch.float32, 8, "simt_tiled"),
    (torch.float32, 128, "simt_tiled")])
def test_flash_attention_backward_variant_is_chosen_from_the_dtype(
        dtype, hd, want):
    """Pure: the dtype and head dim alone pick the kernels, the same on
    every call."""
    assert [attn_ops.bwd_variant(dtype, hd) for _ in range(3)] == [want] * 3
    assert want in attn_ops.BWD_VARIANTS
    assert set(attn_ops.BWD_TILES) == set(attn_ops.BWD_VARIANTS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_choice_covers_every_head_dim(dtype):
    """Every head dim the kernels take (8 to 128 in steps of 8) has one
    variant: bf16 goes to ``"wgmma"`` exactly at the families' 16-multiple
    widths from 64 (WGMMA_HEAD_DIMS), to ``"mma"`` below 64 and at the
    widths of 16 k + 8; fp32 always to ``"simt_tiled"``."""
    table = {hd: attn_ops.bwd_variant(dtype, hd)
             for hd in range(attn_ops.HEAD_DIM_MULTIPLE,
                             attn_ops.MAX_HEAD_DIM + 1,
                             attn_ops.HEAD_DIM_MULTIPLE)}
    assert len(table) == 16
    if dtype == torch.float32:
        assert set(table.values()) == {"simt_tiled"}
    else:
        assert [hd for hd, k in table.items() if k == "wgmma"] == \
            list(attn_ops.WGMMA_HEAD_DIMS) == [64, 80, 96, 112, 128]
        assert all(k == "mma" for hd, k in table.items()
                   if hd < 64 or hd % 16)
    assert table == {hd: attn_ops.bwd_variant(dtype, hd) for hd in table}


def _visible(sq, sk, causal, window):
    """The end-aligned visibility of every (query, key) pair: ``[sq, sk]``."""
    qpos = np.arange(sq)[:, None] + sk - sq
    kj = np.arange(sk)[None]
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis &= kj <= qpos
    if window is not None:
        vis &= qpos - kj < window
    return vis


@pytest.mark.parametrize("kind", ["mma", "wgmma", "simt_tiled",
                                  "forward_wgmma", "forward_simt_tiled"])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (300, 300, True, None),     # causal, a ragged last tile
    (300, 300, True, 64),       # a window
    (130, 130, True, 7),        # a window inside one tile
    (64, 64, True, 1),          # each query its own key
    (77, 201, True, 50),        # end-aligned on a longer key range
    (200, 513, True, None),     # end-aligned, ragged keys
    (1, 33, True, None),        # one query
    (300, 170, False, None),    # cross: Sq > Sk, every pair visible
    (100, 150, False, 20),      # acausal window
])
def test_flash_attention_backward_tiles_meet_every_visible_pair_once(
        kind, sq, sk, causal, window):
    """The kernel's walks as ``ops.bwd_k_range`` and ``ops.bwd_q_range``
    mirror them: in the dQ pass (and the ``"wgmma"`` forward, whose 128-query
    tiles walk the dQ pass's key range) each query tile meets the key tiles
    of its range, in the dK/dV pass each key tile the query tiles of its
    range (for every query head).  Over all meetings every visible (query,
    key) pair falls in exactly one of each pass, none is left out, no query
    tile walks a key that none of its queries sees, and every dK/dV meeting
    holds a visible pair (no tile is walked for nothing).  The fp32
    ``"simt_tiled"`` forward's 64-query tiles walk it too."""
    t = {"forward_wgmma": attn_ops.WGMMA_TILES,
         "forward_simt_tiled": attn_ops.FWD_TILED_TILES}.get(
        kind) or attn_ops.BWD_TILES[kind]
    vis = _visible(sq, sk, causal, window)
    dq = np.zeros((sq, sk), dtype=int)
    for qt in range(-(-sq // t["q_rows"])):
        begin, end = attn_ops.bwd_k_range(qt, sq, sk, causal, window,
                                          rows=t["q_rows"])
        assert 0 <= begin and end <= sk
        rows = slice(qt * t["q_rows"], (qt + 1) * t["q_rows"])
        assert vis[rows, begin:end].any(axis=0).all()
        for k0 in range(begin, end, t["k_tile"]):
            dq[rows, k0:min(k0 + t["k_tile"], end)] += 1
    counts = [dq]
    if not kind.startswith("forward_"):
        dkv = np.zeros((sq, sk), dtype=int)
        for kt in range(-(-sk // t["keys"])):
            first, stop = attn_ops.bwd_q_range(kt, sq, sk, causal, window,
                                               keys=t["keys"],
                                               q_tile=t["q_tile"])
            assert 0 <= first <= stop <= -(-sq // t["q_tile"])
            cols = slice(kt * t["keys"], (kt + 1) * t["keys"])
            for qt in range(first, stop):
                rows = slice(qt * t["q_tile"], (qt + 1) * t["q_tile"])
                dkv[rows, cols] += 1
                assert vis[rows, cols].any()
        counts.append(dkv)
    for count in counts:
        assert (count[vis] == 1).all()
        assert count.max() == 1


#: the shared memory an H100 block may use (bytes)
H100_BLOCK_SMEM = 232_448


@pytest.mark.parametrize("hd", range(attn_ops.HEAD_DIM_MULTIPLE,
                                     attn_ops.MAX_HEAD_DIM + 1,
                                     attn_ops.HEAD_DIM_MULTIPLE))
def test_flash_attention_tiled_forward_fits_a_block_at_every_head_dim(hd):
    """``fwd_tiled_smem`` mirrors csrc/flash_attn.cu's ``tiled_smem``: Q's
    64-row tile, two stages of 64-key K and V tiles (rows of hd + 4
    floats) and the 64 x 68 P tile fit an H100 block's 227 KB at every
    head dim the kernel takes (186,368 bytes at hd 128), and a row's
    stride keeps the 16 lanes' float4 reads on distinct banks (hd + 4
    floats an odd number of float4s)."""
    t = attn_ops.FWD_TILED_TILES
    ld = hd + 4
    smem = attn_ops.fwd_tiled_smem(hd)
    assert smem == 4 * (5 * t["q_rows"] * ld + t["q_rows"] * (t["k_tile"] + 4))
    assert smem <= H100_BLOCK_SMEM
    assert (ld // 4) % 2 == 1 and ld % 4 == 0
    if hd == attn_ops.MAX_HEAD_DIM:
        assert smem == 186_368


def test_flash_attention_window_inside_one_key_tile_matches_jax_kernel():
    """The fp32 plain version against the Pallas kernel (interpret mode)
    at the register-tiled forward's awkward edges: a window of 20 inside
    its 64-key tiles, rep 4, hd 72 (a hd % 16 == 8 depth) and two 64-query
    tiles."""
    q, k, v = _qkv(1, 8, 2, 128, 128, 72, seed=72)
    want = jflash_attention(*_j(q, k, v), causal=True, window=20,
                            block_q=64, block_k=64,
                            backend="pallas-interpret")
    got = tk.flash_attention(*_t(q, k, v), causal=True, window=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("causal,window", [(True, 16), (True, None),
                                           (False, None)])
def test_flash_attention_plain_bf16_is_the_fp32_plain_version_rounded(
        causal, window):
    """The plain version on bf16 q, k, v computes in fp32 and rounds once:
    it is the plain version on fp32 copies of them rounded to bf16, bit
    for bit, so one plain call gives chip_smoke's layer rule both its
    yardstick and the plain bf16 output (``checked_attention``)."""
    q, k, v = (t.to(torch.bfloat16)
               for t in _t(*_qkv(2, 8, 2, 40, 40, 16, seed=3)))
    bf16 = attn_ref.attention_ref(q, k, v, causal=causal, window=window)
    fp32 = attn_ref.attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal, window=window)
    assert torch.equal(bf16, fp32.to(torch.bfloat16))


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports torch and the port
    alone)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,n", [("real-sim", 40), ("news", 6)])
def test_long_rows_dataset_reaches_the_table3_width(name, n):
    """chip_smoke.py's draw of real-sim and news at their Table 3 row widths
    (phase long_rows), at a few rows on the CPU: K is the set's max_nnz, the
    first row holds exactly K entries, every other row at least one, the
    padding is value 0 at index 0, the indices lie in [0, d), and the labels
    are +-1."""
    smoke = _chip_smoke()
    m, y = smoke.long_rows_dataset("cpu", name, n=n)
    rows, d, _, max_nnz, _ = jsynthetic.PAPER_DATASETS[name]
    assert m.values.shape == m.indices.shape == (n, max_nnz)
    assert m.d == d and y.shape == (n,)
    assert int((m.values[0] != 0).sum()) == max_nnz
    live = sgd_sparse_ops.live_lengths(m.values)
    assert live[0] == max_nnz and (live >= 1).all()
    assert (m.indices[m.values == 0] == 0).all()
    assert (m.indices >= 0).all() and (m.indices < d).all()
    assert set(y.tolist()) <= {-1.0, 1.0}


def test_long_rows_paths_run_the_live_prefix_variants():
    """phase long_rows' paths at the cut its parity runs on and at full
    size pick the variants the phase checks (``LONG_ROWS_VARIANTS``): the
    live-prefix kernels for the mini-batch and async paths, glm_sparse's
    smem and hot kernels for SyncSGD()."""
    from repro_torch.core import sparse

    smoke = _chip_smoke()
    for name in smoke.LONG_ROWS:
        rows, d, _, k, _ = jsynthetic.PAPER_DATASETS[name]
        for n in (rows, smoke.LONG_ROWS_CUT[name]):
            # shapes alone: a broadcast row stands in for the draw
            m = sparse.ELLMatrix(torch.zeros(1, 1).expand(n, k),
                                 torch.zeros(1, 1, dtype=torch.int32)
                                 .expand(n, k), d)
            paths = smoke.long_rows_paths(name, (m, torch.ones(n)))
            assert [smoke.path_variants(*p[1:]) for p in paths] \
                == smoke.LONG_ROWS_VARIANTS[name]


def test_layer_rule_holds_the_plain_forward_and_fails_a_window_one_short():
    """chip_smoke.py's layer-by-layer attention rule (phase lm_train (c),
    ``checked_attention``) on the reduced danube config in bf16 (2 layers,
    window 16, S=64) through one training step: the plain forward (the
    kernel's place on the CPU) passes at every call, each layer's
    checkpointed recompute held to its forward's bits; the window one key
    short (``_window_short_forward``, routed into the forward's place)
    fails at every layer, where the loss alone barely moves."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.nn import transformer
    from repro_torch.train import trainer

    smoke = _chip_smoke()
    cfg = dataclasses.replace(configs.reduced(configs.get("h2o-danube-1.8b")),
                              param_dtype=torch.bfloat16)
    lm = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    batch = next(train.make_batch_fn(cfg, 2, 64, seed=3, device="cpu"))
    assert cfg.window < 64
    with smoke.checked_attention() as calls:
        trainer.value_and_grad(cfg, params, batch)
    held = smoke._layer_summary(calls, cfg.n_layers)
    assert held["ok"], held
    assert held["checked"] == held["recomputes"] == cfg.n_layers
    assert held["rms_ratios"] == [1.0] * cfg.n_layers
    with smoke.routed_attention(smoke._window_short_forward), \
            smoke.checked_attention() as calls:
        trainer.value_and_grad(cfg, params, batch)
    short = smoke._layer_summary(calls, cfg.n_layers)
    assert not short["ok"]
    assert short["failing_layers"] == list(range(cfg.n_layers))
    assert min(short["max_ratios"]) > smoke.BF16_MODEL_SLACK


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def test_build_compiles_each_source_for_sm90a(monkeypatch):
    assert _build.sources() == ["flash_attn", "flash_attn_bwd", "glm_grad",
                                "glm_score", "glm_sgd", "glm_sgd_sparse",
                                "glm_sparse"]
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
