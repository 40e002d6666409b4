"""Multi-pod dry run: trace one step of every (arch x shape) cell on the
single-pod (16, 16) and multi-pod (2, 16, 16) meshes as rank 0 of a
``"fake"`` process group, under ``FakeTensorMode``; record per-rank bytes,
peak memory and flops.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # full sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod-only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 7 --cell-timeout 2400

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  Here rank 0 of a fake world of 256 or 512 ranks builds the
production ``DeviceMesh``, places the cell's parameters, optimizer state,
batch and cache as DTensors of fake tensors (no storage) by the resolved
specs, and runs the step: collectives return at once, every local op
runs on fakes, and the attention kernel's fake implementation stands in
for it.  The fakes live on ``cuda`` unless ``--device`` says (the CPU
tests pass ``cpu``).  A cell's result has the reference's keys:

* ``memory.argument_bytes`` / ``output_bytes``: rank 0's local shard bytes
  over the step's inputs / outputs (a Python ``int`` such as decode's
  ``idx`` counts as XLA's 4-byte scalar; outputs add XLA's 8-byte entry a
  leaf of the output tuple, the layers stacked as the reference stacks
  them, so the two compare with ``memory_analysis()``);
* ``memory.peak_bytes``: rank 0's live local bytes at their peak over the
  step, the arguments included (:class:`LocalMemory`: ``MemTracker``
  counts a DTensor op's output at its global size), and
  ``memory.largest_live`` the three largest local storages alive near it;
  ``temp_bytes`` is null (XLA's scratch has no counterpart);
* ``cost_analysis.flops``: ``FlopCounterMode`` over rank 0's share of each
  op (:class:`LocalFlopCounter`);
* ``collective_bytes`` (decode cells): by collective, the bytes each call
  returned to rank 0, summed over a step (:class:`LocalComms`, a
  ``CommDebugMode``, over a second trace of the step: in the measured one
  it would change what the other modes see);
* ``lower_s`` the placement, ``compile_s`` the traced step, in seconds.

No HLO is written.  In its place the measured trace also runs
``roofline/counts.py``'s counters (the counterpart of the reference's
``roofline/hlo.py``), which ``roofline/analysis.py`` reads, for every
cell kind: ``dot_flops_by_dtype`` (``cost_analysis.flops`` split by the
dtype of each op's first operand), ``hbm_bytes`` (the traffic proxy) and
``hbm_top`` (its largest ops), ``wire_bytes`` and ``wire_bytes_by_kind``
/ ``_by_link`` (the ring formulas' bytes a device).  Its
:class:`~repro_torch.roofline.counts.OpCounts` sits below the other two
modes and lets DTensor desugar each op first, so they see what they saw
without it: the mini cells' every other key is unchanged
(``tests/test_torch_roofline_analysis.py``).
Each cell runs in its own process when swept (``--all``: one subprocess a
cell, so a failure cannot take the sweep down; ``--jobs`` of them at once,
each killed past ``--cell-timeout`` seconds and recorded as ``timeout``).  Results land in
``dryrun_results/torch/<arch>__<shape>__<mesh>.json``, never in the
reference's ``dryrun_results/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import math
import subprocess
import sys
import time
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.counts import LocalFlopCounter, OpCounts

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results" / "torch"
#: bytes XLA counts for each leaf of a step's output tuple
TUPLE_ENTRY_BYTES = 8
#: bytes of a Python int argument (XLA's int32 scalar)
SCALAR_BYTES = 4


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``"fake"`` process group of ``size``
    ranks: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class LocalMemory(TorchDispatchMode):
    """Rank 0's live bytes over a step: every storage an op returns counts
    until it is freed, a DTensor's by its local shard, and ``peak`` is the
    most that lived at once.  It sits above DTensor (as ``FlopCounterMode``
    does), so the fakes DTensor makes at global shapes to propagate
    shardings stay out, and so do an op's own temporaries below it.
    ``track`` adds tensors made before (the step's arguments).

    A storage leaves the count once the last tensor this mode saw on it
    has died and the storage is gone: looked at the op after that tensor
    died, and, where something else still held it (saved for the
    backward), again every ``SWEEP`` ops, so the count can run high by
    what such holders freed in between.  ``largest`` lists the
    ``LARGEST`` biggest live storages (bytes, shape, dtype, the op that
    made them) when the count last stood past ``SNAP`` times the count at
    the list before: within that factor of the peak."""

    SWEEP = 256
    LARGEST = 3
    SNAP = 1.01

    def __init__(self):
        super().__init__()
        self.peak = self.total = self._ops = 0
        self._live: dict = {}      # storage -> [weak ref, bytes, tensors,
        #                                        (shape, dtype, op)]
        self._held: set = set()    # no tensor left, storage not yet freed
        self._recent: list = []    # tensors died since the last op
        self.largest: list = []
        self._snap = 0

    def track(self, tensors) -> None:
        for t in tensors:
            self._add(t, "argument")
        self._peak()

    def _peak(self) -> None:
        self.peak = max(self.peak, self.total)
        if self.total > self._snap * self.SNAP:
            self._snap = self.total
            self.largest = [
                {"bytes": e[1], "shape": list(e[3][0]), "dtype": e[3][1],
                 "op": e[3][2]}
                for e in heapq.nlargest(self.LARGEST, self._live.values(),
                                        key=lambda e: e[1])]

    def _add(self, t, op: str) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        entry = self._live.get(ref.cdata)
        if entry is None or entry[0].expired():
            if entry is not None:
                self.total -= entry[1]
                self._held.discard(ref.cdata)
            entry = self._live[ref.cdata] = [
                ref, st.nbytes(), 0,
                (tuple(t.shape), str(t.dtype).removeprefix("torch."), op)]
            self.total += entry[1]
        entry[2] += 1
        weakref.finalize(t, self._drop, ref.cdata, entry)

    def _drop(self, key, entry) -> None:
        entry[2] -= 1
        if entry[2] == 0 and self._live.get(key) is entry:
            self._held.add(key)
            self._recent.append(key)

    def _sweep_one(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            self._held.discard(key)
            return
        if entry[2]:
            self._held.discard(key)
        elif entry[0].expired():
            self._held.discard(key)
            del self._live[key]
            self.total -= entry[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        recent, self._recent = self._recent, []
        for key in recent:
            self._sweep_one(key)
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t, str(func.overloadpacket))
        self._peak()
        self._ops += 1
        if self._ops % self.SWEEP == 0:
            for key in list(self._held):
                self._sweep_one(key)
        return out


class LocalComms(CommDebugMode):
    """``CommDebugMode`` that also sums, by collective, the bytes of what
    each call returns to this rank."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket in self.comm_registry:
            name = str(func._overloadpacket).split(".")[-1]
            self.bytes[name] = self.bytes.get(name, 0) + sum(
                t.numel() * t.element_size() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
        return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tuple_entries(tree) -> int:
    """Leaves of ``tree`` as the reference's output tuple holds them: the
    port's one block a layer counts once a stack, as the reference stacks
    it (``layers.0.attn.wq`` and ``layers.1.attn.wq`` are one leaf)."""
    if isinstance(tree, dict):
        stacked = {".".join("*" if p.isdigit() else p for p in k.split("."))
                   for k, v in tree.items() if not isinstance(v, dict)}
        return len(stacked) + sum(tuple_entries(v) for v in tree.values()
                                  if isinstance(v, dict))
    if isinstance(tree, (list, tuple)):
        return sum(tuple_entries(v) for v in tree)
    return 1


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree's leaves (a Python int: 4)."""
    total = 0
    for x in _leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        total += (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else SCALAR_BYTES)
    return total


def local_shape(shape, placements, mesh) -> list[int]:
    """Rank 0's shard of ``shape``: each mesh dim that shards a tensor dim
    keeps its first (largest) chunk, as ``torch.chunk`` deals them."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return out


def place(shapes, placement_tree, mesh, device):
    """Fake DTensors of ``shapes``' meta tensors, rank 0's shards only."""
    if isinstance(shapes, dict):
        return {k: place(v, placement_tree[k], mesh, device)
                for k, v in shapes.items()}
    local = torch.empty(local_shape(shapes.shape, placement_tree, mesh),
                        dtype=shapes.dtype, device=device)
    return DTensor.from_local(local, mesh, placement_tree, run_check=False,
                              shape=shapes.shape, stride=shapes.stride())


def placed(tree, placement_tree, mesh):
    """An output tree on the placements the reference's out_shardings
    give it (a plain tensor counts as replicated)."""
    if isinstance(tree, dict):
        return {k: placed(v, placement_tree[k], mesh) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    return tree.redistribute(mesh, placement_tree)


def _replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim


def run_step(cfg, kind: str, seq: int, gb: int, mesh, *,
             update: str = "sync", device: str = "cuda") -> dict:
    """Trace one step of ``kind`` on ``mesh`` (inside a fake world) and
    measure it; ``cfg`` after the MoE group rule.  Returns the result's
    ``memory`` and ``cost_analysis`` and the two times."""
    from repro_torch.launch import specs as specs_mod
    from repro_torch.nn import transformer
    from repro_torch.optim.sgd import sgd as make_sgd
    from repro_torch.train import trainer

    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    batch_prod = math.prod(mesh.size(names.index(a)) for a in batch_axes)
    # a global batch the batch axes cannot split (long_500k's B=1):
    # replicate it and spread the KV caches over the whole mesh (the
    # steps' shard callback drops the batch axes from the activations)
    cell_extra = ({"batch": (), "kvseq": (*batch_axes, "model")}
                  if gb % batch_prod else None)

    def resolved(specs, extra=None):
        ex = dict(cell_extra or {})
        ex.update(extra or {})
        return trainer.resolve_tree(specs, mesh, cfg, extra=ex or None)

    p_shapes, p_specs = specs_mod.param_shapes_and_specs(cfg)
    b_shapes, b_specs = specs_mod.batch_specs(cfg, kind, seq, gb)
    rep = _replicated(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "train":
            # plain SGD: the paper's optimizer, state a step counter
            opt = make_sgd(1e-2)
            if update == "sync":
                params = place(p_shapes, resolved(p_specs), mesh, device)
                o_specs = trainer.opt_state_specs({"step": None}, p_specs)
                opt_state = place({"step": torch.empty((), dtype=torch.int32,
                                                       device="meta")},
                                  resolved(o_specs), mesh, device)
                batch = place(b_shapes, resolved(b_specs), mesh, device)
                step = trainer.make_sync_step(cfg, opt, mesh=mesh,
                                              param_specs=p_specs)
                args = (params, opt_state, batch)
                out_pl = (resolved(p_specs), resolved(o_specs), rep)
            else:  # async-local: replica axis over "pod"
                if "pod" not in names:
                    raise ValueError("async-local needs the pod axis")
                r = mesh.size(names.index("pod"))
                in_pod = {"batch": ("data",)}  # replica batch: data axis only

                def pod_specs(specs):
                    return {k: trainer.P("pod", *s) for k, s in specs.items()}

                def stack(shapes, lead):
                    return {k: torch.empty((*lead, *x.shape[len(lead) - 1:]),
                                           dtype=x.dtype, device="meta")
                            for k, x in shapes.items()}

                pp = resolved(pod_specs(p_specs), in_pod)
                params = place(stack(p_shapes, (r,)), pp, mesh, device)
                o_pl = {"step": resolved(trainer.P("pod"), in_pod)}
                opt_state = place({"step": torch.empty((r,), dtype=torch.int32,
                                                       device="meta")},
                                  o_pl, mesh, device)
                b_stack = {k: torch.empty((r, x.shape[0] // r, *x.shape[1:]),
                                          dtype=x.dtype, device="meta")
                           for k, x in b_shapes.items()}
                batch = place(b_stack, resolved(pod_specs(b_specs), in_pod),
                              mesh, device)
                step, _ = trainer.make_async_local_step(
                    cfg, opt, mesh=mesh, param_specs=p_specs)
                args = (params, opt_state, batch)
                out_pl = (pp, o_pl, resolved(trainer.P("pod"), in_pod))
        elif kind == "prefill":
            params = place(p_shapes, resolved(p_specs), mesh, device)
            batch = place(b_shapes, resolved(b_specs), mesh, device)
            step = trainer.make_prefill_step(cfg, mesh)
            args = (params, batch)
            out_pl = (rep, resolved(specs_mod.decode_mod.cache_specs(cfg)))
        else:  # decode
            c_shapes, c_specs = specs_mod.cache_shapes_and_specs(cfg, gb, seq)
            params = place(p_shapes, resolved(p_specs), mesh, device)
            cache = place(c_shapes, resolved(c_specs), mesh, device)
            batch = place(b_shapes, resolved(b_specs), mesh, device)
            step = trainer.make_decode_step(cfg, mesh)
            args = (params, cache, batch, seq - 1)
            out_pl = (rep, resolved(c_specs))
        arg_bytes = local_bytes(args)
        tensors = [x for x in _leaves(args) if isinstance(x, torch.Tensor)]
        if kind != "train":  # the serve steps take an LM over the tree
            args = (transformer.LM.from_tree(args[0]), *args[1:])
        t_lower = time.perf_counter() - t0
        memory = LocalMemory()
        memory.track(tensors)
        flops = LocalFlopCounter(display=False)
        counts = OpCounts()
        with counts, memory, flops:
            out = step(*args)
            out = tuple(placed(o, pl, mesh) for o, pl in zip(out, out_pl))
        t_step = time.perf_counter() - t0 - t_lower
        comms = LocalComms()
        if kind == "decode":   # the cache is written in place: a step again
            with comms:
                step(*args)
        peak = memory.peak
    return {"lower_s": t_lower, "compile_s": t_step,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": local_bytes(out)
                       + TUPLE_ENTRY_BYTES * tuple_entries(out),
                       "temp_bytes": None, "peak_bytes": peak,
                       "largest_live": memory.largest},
            "cost_analysis": {"flops": flops.get_total_flops()},
            "collective_bytes": comms.bytes,
            "matmul_flops": sum(
                n for op, n in flops.get_flop_counts()["Global"].items()
                if str(op).split(".")[-1] in MATMUL_OPS),
            "dot_flops_by_dtype": flops.by_dtype, **counts.record()}


#: the products a dense cell's matmul flops count (attention apart)
MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm")


def group_rule(cfg, mesh, gb: int):
    """The reference's MoE rule: group-local dispatch, one group a batch
    shard, on a model axis of the mesh's size."""
    if not cfg.moe_experts:
        return cfg
    names = mesh.mesh_dim_names
    shards = math.prod(mesh.size(names.index(a)) for a in ("pod", "data")
                       if a in names)
    return dataclasses.replace(cfg, moe_groups=min(shards, gb),
                               moe_model_shards=mesh.size(
                                   names.index("model")))


def run_cell(arch: str, shape: str, multi_pod: bool, update: str = "sync",
             device: str = "cuda") -> dict:
    """One production cell in a fake world of 256 or 512 ranks."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod

    kind, seq, gb = configs.SHAPES[shape]
    with fake_world(512 if multi_pod else 256):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type=device)
        cfg = group_rule(configs.get(arch), mesh, gb)
        res = run_step(cfg, kind, seq, gb, mesh, update=update, device=device)
    return {"arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16", "update": update,
            "kind": kind, "seq": seq, "global_batch": gb, "device": device,
            **res, "status": "ok"}


def _cell_name(arch, shape, multi_pod, update="sync", ext=".json"):
    mesh = "2x16x16" if multi_pod else "16x16"
    upd = "" if update == "sync" else f"__{update}"
    return f"{arch}__{shape}__{mesh}{upd}{ext}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--update", default="sync", choices=["sync", "async"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fakes' device (cuda unless given)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells a sweep runs at once")
    ap.add_argument("--cell-timeout", type=float, default=float("inf"),
                    help="seconds before a sweep's cell is killed")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if not args.all:
        res = run_cell(args.arch, args.shape, args.multipod, args.update,
                       device=args.device)
        out = RESULTS_DIR / _cell_name(args.arch, args.shape, args.multipod,
                                       args.update)
        out.write_text(json.dumps(res, indent=1))
        print(json.dumps(res))
        return 0

    # sweep: one subprocess per cell (fault isolation), --jobs at once
    from repro_torch import configs
    meshes = []
    if not args.multipod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    todo = []
    for mp in meshes:
        for arch, shape in configs.cells():
            out = RESULTS_DIR / _cell_name(arch, shape, mp)
            if out.exists() and not args.force:
                print(f"skip {out.name}")
            else:
                todo.append((arch, shape, mp, out))
    failures, running = [], {}
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape, mp, out = cell = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--device",
                   args.device] + (["--multipod"] if mp else [])
            print(f"=== {arch} {shape} {'2x16x16' if mp else '16x16'}",
                  flush=True)
            err = out.with_suffix(".stderr")
            with err.open("w") as f:
                running[subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=f)] = (
                        cell, time.time())
        time.sleep(1)
        for proc, ((arch, shape, mp, out), t0) in list(running.items()):
            late = time.time() - t0 > args.cell_timeout
            if proc.poll() is None and not late:
                continue
            if late and proc.poll() is None:
                proc.kill()
            proc.wait()
            del running[proc]
            err = out.with_suffix(".stderr")
            stderr = err.read_text()[-4000:]
            err.unlink()
            name = f"{arch} {shape} {'2x16x16' if mp else '16x16'}"
            if proc.returncode != 0:
                failures.append((arch, shape, mp))
                status = "timeout" if late else "fail"
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "status": status, "seconds": time.time() - t0,
                    "stderr": stderr[-4000:]}, indent=1))
                last = stderr.strip().splitlines()[-1] if stderr else "?"
                print(f"    {status.upper()} {name} ({time.time()-t0:.0f}s):"
                      f" {last}", flush=True)
            else:
                print(f"    ok {name} ({time.time()-t0:.0f}s)", flush=True)
    print(f"done; {len(failures)} failures: {failures}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
