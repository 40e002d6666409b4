"""Checkpointing: npz of every leaf + JSON manifest, async writer and
keep-last-k retention.

The reference's layout, which its ``load_checkpoint`` reads as well:

    <dir>/step_<N>/
        manifest.json     {step, time, leaves: [{path, key, dtype, shape}]}
        arrays.npz        one entry per flattened leaf

A step is written to a ``.tmp_step_<N>`` directory and renamed into place.
bf16 leaves are stored as their uint16 bits with ``"dtype": "bfloat16"``.
Trees are the port's (dicts, lists and tuples of tensors:
:mod:`repro_torch.utils.tree`); a leaf's path joins its dict keys and
sequence indices with ``/``, as the reference's does.  Loading puts each
leaf on ``device``, or where the like-tree's leaf lives.

A checkpoint is mesh-agnostic: a DTensor leaf is written as its full host
array (every rank gathers it; rank 0 of the process group writes, and
``save_checkpoint`` and ``CheckpointManager.wait`` hold every rank until
the step is published), and a load whose like-leaf is a DTensor places
the array on that leaf's mesh and placements (reshard on load), so a
state saved on one mesh restores onto another, or onto one device.
Writes happen on a background thread (training continues; ``wait()`` joins
before the next save — async checkpointing).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.utils.tree import tree_map


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix[:-1], tree)]
    return [pl for k, v in items for pl in _flatten_with_paths(
        v, f"{prefix}{k}/")]


def _host(x):
    """A leaf as it is written: a CPU tensor (a DTensor's full tensor,
    gathered on every rank), or what it was."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _writes() -> bool:
    """Whether this process writes: rank 0 of an initialised process group
    (every rank holds the same gathered tree), or a process without one."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = _host(x)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str | Path, step: int, tree, *,
                    keep: int | None = None) -> Path:
    """Blocking save.  Returns the step directory.  In a process group
    every rank gathers the DTensor leaves, rank 0 writes, and every rank
    returns once the step is published."""
    if _writes():
        step_dir = _write(directory, step, tree, keep=keep)
    else:
        for _, leaf in _flatten_with_paths(tree):
            _host(leaf)
        step_dir = Path(directory) / f"step_{step:09d}"
    _barrier()
    return step_dir


def _barrier():
    """Every rank of an initialised process group here before any goes on
    (a step rank 0 publishes is then there for all to read)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _write(directory: str | Path, step: int, tree, *,
           keep: int | None = None) -> Path:
    """Write ``tree`` as step ``step`` and publish it."""
    directory = Path(directory)
    step_dir = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "time": time.time(), "leaves": []}
    for i, (p, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        manifest["leaves"].append(
            {"path": p, "key": f"leaf_{i}", "dtype": dtype,
             "shape": list(arr.shape)})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp.rename(step_dir)       # atomic publish
    if keep:
        _retain(directory, keep)
    return step_dir


def _retain(directory: Path, keep: int):
    steps = sorted(d for d in directory.glob("step_*") if d.is_dir())
    for d in steps[:-keep]:
        shutil.rmtree(d)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    steps = sorted(directory.glob("step_*"))
    return int(steps[-1].name.split("_")[1]) if steps else None


def load_checkpoint(directory: str | Path, like_tree, *,
                    step: int | None = None, device=None):
    """Restore into the structure of ``like_tree``: ``(tree, step)``.  Each
    leaf lands on ``device``, or on its like-leaf's device."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    step_dir = directory / f"step_{step:09d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    by_path = {m["path"]: m for m in manifest["leaves"]}
    paths = iter(p for p, _ in _flatten_with_paths(like_tree))

    with np.load(step_dir / "arrays.npz") as data:
        def one(like):
            p = next(paths)
            m = by_path[p]
            arr = data[m["key"]]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch at {p}: {arr.shape} vs "
                                 f"{tuple(like.shape)}")
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if m["dtype"] == "bfloat16" else torch.from_numpy(arr))
            if isinstance(like, DTensor) and device is None:
                mesh = like.device_mesh
                return distribute_tensor(t.to(mesh.device_type), mesh,
                                         like.placements)
            dev = device if device is not None else getattr(
                like, "device", "cpu")
            return t.to(dev)

        return tree_map(one, like_tree), manifest["step"]


class CheckpointManager:
    """Async keep-k checkpointing driver used by the train loop."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 every: int = 100):
        self.directory = Path(directory)
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree) -> bool:
        """Copy ``tree`` to the host now and write it on a thread, every
        ``every`` steps (step 0 included)."""
        if step % self.every:
            return False
        self.wait()
        host_tree = tree_map(_host, tree)
        if not _writes():
            return True
        self._thread = threading.Thread(
            target=_write,
            args=(self.directory, step, host_tree),
            kwargs={"keep": self.keep}, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        """Join the writer; in a process group, then wait for every rank,
        so that none reads the newest step before rank 0 published it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()

    def restore(self, like_tree):
        return load_checkpoint(self.directory, like_tree)
