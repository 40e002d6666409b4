"""Shared kernel infrastructure: backend dispatch registry, launch counters,
device helper and tiling helpers.

Each kernel family registers two flavors:

* ``cuda``             the hand-written Hopper kernel (``csrc/*.cu``, built
                       at first use by :mod:`repro_torch.kernels._build`);
* ``torch-reference``  the plain PyTorch version of the same function
                       (the family's ``ref.py``) — what the CPU tests run
                       and what ``chip_smoke.py`` holds each kernel against.

The flavor follows the device of the tensors: CUDA tensors go to the
kernel, CPU tensors to the plain version.  A call-site ``backend=`` or the
``REPRO_TORCH_KERNEL_BACKEND`` environment variable may name the flavor,
but only the one the device already implies: ``cuda`` on a CPU tensor and
``torch-reference`` on a CUDA tensor raise.  Nothing falls back from the
kernel to the plain version.  The one way to run the plain versions on the
card is :func:`plain_versions`, which checks the kernels against them.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable

import numpy as np
import torch

CUDA = "cuda"
TORCH_REFERENCE = "torch-reference"

#: every backend a family registers
BACKENDS = (CUDA, TORCH_REFERENCE)

ENV_BACKEND = "REPRO_TORCH_KERNEL_BACKEND"

#: task code each C entry point takes (csrc/common.cuh)
TASK_CODES = {"lr": 0, "svm": 1}

#: dynamic shared memory a Hopper block may opt into (227 KB)
MAX_SMEM_BYTES = 232_448

_REGISTRY: dict[str, dict[str, Callable]] = {}

#: launches of each hand-written kernel in this process; a cuda flavor
#: adds one per kernel launch, nothing else touches it
LAUNCHES: dict[str, int] = {}
#: guards LAUNCHES: the live path launches from a learner thread and a
#: serving thread at once, and ``+=`` on a dict entry is not atomic
_LAUNCH_LOCK = threading.Lock()

#: inside ``plain_versions()``: CUDA tensors go to the plain versions
_plain_on_card = False


def device(dev: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller says."""
    return torch.device("cuda" if dev is None else dev)


def register_kernel(kernel: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` flavor of ``kernel``.

    All flavors of one kernel share a call signature.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")

    def deco(fn):
        _REGISTRY.setdefault(kernel, {})[backend] = fn
        if backend == CUDA:
            LAUNCHES.setdefault(kernel, 0)
        return fn

    return deco


def registered_kernels() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def backends_for(kernel: str) -> tuple[str, ...]:
    impls = _REGISTRY.get(kernel, {})
    return tuple(b for b in BACKENDS if b in impls)


def resolve_backend(kernel: str, dev: torch.device,
                    backend: str | None = None) -> str:
    """The flavor of ``kernel`` for tensors on ``dev``.

    ``backend`` (call site) beats ``REPRO_TORCH_KERNEL_BACKEND``; either
    must name a registered flavor, and it must be the one ``dev`` implies.
    """
    impls = _REGISTRY.get(kernel)
    if not impls:
        raise KeyError(f"no kernel registered under {kernel!r}; "
                       f"known: {registered_kernels()}")
    natural = CUDA if dev.type == "cuda" and not _plain_on_card \
        else TORCH_REFERENCE
    forced = backend or os.environ.get(ENV_BACKEND) or None
    if forced is None:
        return natural
    if forced not in impls:
        raise ValueError(f"backend {forced!r} not registered for {kernel!r}; "
                         f"registered: {backends_for(kernel)}")
    if forced != natural:
        raise RuntimeError(
            f"backend {forced!r} for {kernel!r} cannot take tensors on "
            f"{dev}: {CUDA!r} runs CUDA tensors, {TORCH_REFERENCE!r} runs "
            f"CPU tensors")
    return forced


def dispatch(kernel: str, dev: torch.device, *args,
             backend: str | None = None, **kwargs):
    """Resolve the flavor for ``dev`` and call it."""
    b = resolve_backend(kernel, dev, backend)
    return _REGISTRY[kernel][b](*args, **kwargs)


@contextlib.contextmanager
def plain_versions():
    """Run every family's plain version on CUDA tensors for a while: the
    engine then runs the same code with the kernels taken out, which is
    what a kernel is checked against on the card."""
    global _plain_on_card
    saved, _plain_on_card = _plain_on_card, True
    try:
        yield
    finally:
        _plain_on_card = saved


def count_launch(kernel: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[kernel] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check_smem(kernel: str, nbytes: int, what: str) -> None:
    """Raise when a block would need more shared memory than Hopper has."""
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{kernel} needs {nbytes} bytes of shared memory for {what}, "
            f"beyond the {MAX_SMEM_BYTES}-byte (227 KB) per-block limit of "
            f"sm_90; a global-memory variant is not ported yet")


def ring_plan(nbytes: Callable[[int, int], int], micro_batch: int,
              max_stages: int, stage_rows: int) -> tuple[int, int]:
    """The ring of a fused epoch's warp kernel as ``(stages, group)``:
    stages of ``group`` micro-batches, about ``stage_rows`` rows each
    where at least four such stages fit in a block's shared memory (up to
    ``max_stages``), else one micro-batch a stage; ``(0, 0)`` when two
    single-batch stages do not fit.  ``nbytes(stages, group)`` is the
    block's shared memory for such a ring."""
    def fit(group):
        for stages in range(max_stages, 1, -1):
            if nbytes(stages, group) <= MAX_SMEM_BYTES:
                return stages
        return 0

    for group in range(-(-stage_rows // micro_batch), 0, -1):
        if fit(group) >= 4:
            return fit(group), group
    return (fit(1), 1) if fit(1) else (0, 0)


def check_indices(kernel: str, indices: torch.Tensor, d: int) -> None:
    """Raise unless every ELL index lies in [0, d): the kernels index the
    model with them unchecked.  The check reads the operand and waits for
    the card, so an operand that passed is marked with its version counter
    (which any in-place write bumps) and is not read again."""
    mark = (d, indices._version)
    if getattr(indices, "_repro_indices_ok", None) == mark:
        return
    if indices.numel():
        lo, hi = torch.aminmax(indices)
        if not bool((lo >= 0) & (hi < d)):
            raise ValueError(f"{kernel}: ELL indices must lie in [0, {d})")
    mark_indices_checked(indices, d)


def check_host_indices(what: str, indices: np.ndarray, d: int) -> None:
    """Raise unless every index of the host array ``indices`` lies in
    [0, d): the check of host data before it is copied to the card."""
    if indices.size and (indices.min() < 0 or indices.max() >= d):
        raise ValueError(f"{what}: index out of range [0, {d})")


def host_checked_indices(kernel: str, indices: np.ndarray, d: int,
                         dev: torch.device) -> torch.Tensor:
    """``indices`` on ``dev`` as int32, checked against [0, d) on the host
    before the copy, and marked as :func:`check_indices` marks an operand
    it has read: an operand built from host data each step then costs the
    card no read and no wait for the check."""
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    check_host_indices(kernel, indices, d)
    t = torch.from_numpy(indices).to(dev)
    mark_indices_checked(t, d)
    return t


def mark_indices_checked(indices: torch.Tensor, d: int) -> None:
    """Record that ``indices`` lies in [0, d), for a caller that checked
    the host data it was copied from."""
    indices._repro_indices_ok = (d, indices._version)


def plain_fp32(t: torch.Tensor) -> None:
    """Keep a plain version in full fp32 on the card (no TF32 products)."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def cuda_operand(t: torch.Tensor, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """A contiguous operand of ``dtype`` on the card, or raise."""
    if not t.is_cuda:
        raise ValueError(f"the cuda flavor takes CUDA tensors, got {t.device}")
    return t.to(dtype).contiguous()


def task_code(task: str) -> int:
    if task not in TASK_CODES:
        raise ValueError(f"unknown task {task!r}; one of {tuple(TASK_CODES)}")
    return TASK_CODES[task]


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s card (the raw handle
    PyTorch's own generated kernels launch on, without building a
    ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_SAME_DEVICE = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """A context in which a launch goes to ``t``'s card: nothing to switch
    when it is the current one already."""
    if t.device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(t.device)


def padded(size: int, multiple: int) -> int:
    return size + ((-size) % multiple)


def pick_block(size: int, preferred: int, multiple: int = 1) -> int:
    """Largest block <= preferred that divides ``size`` and is a multiple of
    ``multiple``; the whole extent when only that is aligned, else raise."""
    best = None
    b = multiple
    while b <= min(preferred, size):
        if size % b == 0:
            best = b
        b += multiple
    if best is not None:
        return best
    if size % multiple == 0:
        return size
    raise ValueError(
        f"no block <= {preferred} divides size {size} at multiple "
        f"{multiple}, and {size} is not itself a multiple of {multiple}; "
        f"pad the operand to {padded(size, multiple)}")
