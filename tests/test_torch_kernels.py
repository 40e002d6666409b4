"""Parity of the port's kernel families with the JAX reference, on the CPU.

The same numpy inputs (seeded) go through the JAX family (``pallas-interpret``
runs the Pallas kernel body; ``reference`` its oracle, for the ragged shapes
the Pallas flavors refuse) and through the port on ``device="cpu"``, where
every family runs its plain PyTorch version.  Tolerances are the JAX
conformance suite's: gradients ``rtol=1e-4, atol=2e-3``, epochs
``rtol=1e-4, atol=1e-4``.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import synthetic as jsynthetic
from repro.kernels.glm_grad import glm_grad as jglm_grad
from repro.kernels.glm_sgd import glm_sgd_epoch as jglm_sgd_epoch
from repro.kernels.glm_sgd_sparse import ell_sgd_epoch as jell_sgd_epoch
from repro.kernels.glm_sparse import ell_glm_grad as jell_glm_grad

import repro_torch.kernels as tk
from repro_torch.kernels import _build, common
from repro_torch.kernels.glm_sgd_sparse import ops as sgd_sparse_ops

TASKS = ("lr", "svm")
GRAD_TOL = dict(rtol=1e-4, atol=2e-3)
EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)
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
    """news (d=1,355,191) cannot keep its model in a block's shared memory."""
    d = jsynthetic.PAPER_DATASETS["news"][1]
    W, values, y = torch.zeros((1, d)), torch.ones((1, 8, 4)), torch.ones((1, 8))
    indices = torch.zeros((1, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=str(common.MAX_SMEM_BYTES)):
        sgd_sparse_ops._ell_sgd_cuda("lr", W, values, indices, y, step=0.1,
                                     micro_batch=8)
    rcv1_d = jsynthetic.PAPER_DATASETS["rcv1"][1]
    assert sgd_sparse_ops.smem_bytes(rcv1_d, 10) <= common.MAX_SMEM_BYTES


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
        "glm_grad", "glm_score", "glm_sgd", "glm_sgd_sparse", "glm_sparse")
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
# Build
# ---------------------------------------------------------------------------


def test_build_compiles_each_source_for_sm90a(monkeypatch):
    assert _build.sources() == ["glm_grad", "glm_score", "glm_sgd",
                                "glm_sgd_sparse", "glm_sparse"]
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command("glm_sgd", _build.library_path("glm_sgd"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/glm_sgd.cu")
    lib = _build.library_path("glm_sgd")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _build.check("glm_sgd", 700)
