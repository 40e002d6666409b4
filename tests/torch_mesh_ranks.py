"""Rank programs for ``tests/test_torch_mesh.py``: a ``gloo`` world of 4 on
the CPU, one process a rank (``torch.multiprocessing``, spawned) meeting at
a ``FileStore``.

    python tests/torch_mesh_ranks.py CASE DIR

Each rank reads ``DIR/in.pt`` (written by the test), runs ``CASE`` and
rank 0 writes what the test checks to ``DIR/out.pt``.  Imports no JAX:
the test holds the result against the reference in its own process.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.nn import (decode, layers, moe, ssm,  # noqa: E402
                            transformer, xlstm)
from repro_torch.nn.param import P  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402
from repro_torch.train import fault, trainer  # noqa: E402

WORLD = 4


class GroupedComms(CommDebugMode):
    """``CommDebugMode`` that also records the ranks of each collective's
    process group."""

    def __init__(self):
        super().__init__()
        self.groups = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
        if func._overloadpacket in self.comm_registry and names:
            # a functional collective's process group is its last string
            # argument (a reduction's op name comes before it)
            pg = dist.distributed_c10d._resolve_process_group(names[-1])
            self.groups.append((str(func._overloadpacket),
                                dist.get_process_group_ranks(pg)))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def case_sync(d: Path, inp: dict) -> dict:
    """One sync step on (data=2, model=2), seq_shard on."""
    cfg = configs.reduced(configs.get("minitron-4b"), seq_shard=True)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    p_specs = transformer.param_specs(cfg)
    b, s = inp["batch"]["tokens"].shape
    _, b_specs = specs.batch_specs(cfg, "train", s, b)
    opt = sgd(inp["lr"])
    o_specs = trainer.opt_state_specs({"step": None}, p_specs)
    params = trainer.distribute(inp["params"], mesh,
                                trainer.resolve_tree(p_specs, mesh, cfg))
    state = trainer.distribute(opt.init(inp["params"]), mesh,
                               trainer.resolve_tree(o_specs, mesh, cfg))
    batch = trainer.distribute(inp["batch"], mesh,
                               trainer.resolve_tree(b_specs, mesh, cfg))
    step = trainer.make_sync_step(cfg, opt, mesh=mesh, param_specs=p_specs)
    p, o, loss = step(params, state, batch)
    return {"params": _full(p), "loss": loss, "step": _full(o)["step"],
            "placements": {k: [repr(x) for x in v.placements]
                           for k, v in p.items()}}


class LocalSizes(CommDebugMode):
    """``CommDebugMode`` that also records the largest storage (in
    elements) of a rank's own tensors that any op returns (not the fake
    tensors of DTensor's sharding rules), and the ops that ran."""

    def __init__(self):
        super().__init__()
        self.largest, self.ops = 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.ops.add(str(func._overloadpacket))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and type(t) is torch.Tensor:
                self.largest = max(self.largest, t.untyped_storage().nbytes()
                                   // t.element_size())
        return out


def case_xent(d: Path, inp: dict) -> dict:
    """The chunked loss on (data=2, model=2): the hidden states on the
    batch, the tied embedding's vocab and the logits on ``"model"``; the
    loss, its gradients, and the largest local tensor of the forward and
    backward."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    h = DTensor.from_local(inp["h"].chunk(2)[mesh.get_local_rank(0)], mesh,
                           [Shard(0), Replicate()]).requires_grad_()
    emb = DTensor.from_local(inp["emb"].chunk(2)[mesh.get_local_rank(1)],
                             mesh, [Replicate(), Shard(0)]).requires_grad_()
    labels = DTensor.from_local(inp["labels"].chunk(2)[mesh.get_local_rank(0)],
                                mesh, [Shard(0), Replicate()])
    with LocalSizes() as seen:
        loss = layers.chunked_softmax_xent(h, emb, labels, chunk=8)
        loss.backward()
    return {"loss": loss.detach().full_tensor(), "h_grad": h.grad.full_tensor(),
            "emb_grad": emb.grad.full_tensor(), "largest": seen.largest,
            "gather": "aten.gather" in seen.ops}


class Shares:
    """What each rank's share of the placed families ran on, recorded
    around the functions that run it: the local heads and rows of every
    Mamba2 scan, the key columns of every mLSTM recurrence, and the local
    shapes and placements of every MoE expert product's operands."""

    def __init__(self):
        self.mamba, self.mlstm, self.experts = [], [], []
        self._undo = []
        self._wrap(ssm, "mamba2", lambda x, p, meta, **kw: self.mamba.append(
            {"rows": x.shape[0], "heads": meta["n_heads"],
             "dtensor": isinstance(x, DTensor)}))
        self._wrap(xlstm, "_mlstm_core", lambda qkv, gates, meta, **kw:
                   self.mlstm.append(
                       {"rows": qkv.shape[0],
                        "keys": (qkv.shape[-1] - meta["d_inner"])
                        // (2 * meta["n_heads"])}))
        self._wrap(moe.torch, "einsum", self._expert_product)

    def _expert_product(self, eq, *ops):
        if eq in ("gecd,edf->gecf", "gecf,efd->gecd"):
            he, w = ops
            self.experts.append({
                "he": list(he.to_local().shape),
                "w": list(w.to_local().shape),
                "w_placements": [repr(x) for x in w.placements]})

    def _wrap(self, mod, name, record):
        fn = getattr(mod, name)

        def spy(*args, **kwargs):
            record(*args, **kwargs)
            return fn(*args, **kwargs)

        setattr(mod, name, spy)
        self._undo.append((mod, name, fn))

    def undo(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)


def case_family(d: Path, inp: dict) -> dict:
    """One sync step of a reduced family on the mesh ``inp["mesh"]``
    (shape, axis names), recording each rank's share (:class:`Shares`)."""
    cfg = configs.reduced(configs.get(inp["arch"]), **inp["overrides"])
    shape, names = inp["mesh"]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    p_specs = transformer.param_specs(cfg)
    b, s = inp["batch"]["tokens"].shape
    _, b_specs = specs.batch_specs(cfg, "train", s, b)
    opt = sgd(inp["lr"])
    o_specs = trainer.opt_state_specs({"step": None}, p_specs)
    params = trainer.distribute(inp["params"], mesh,
                                trainer.resolve_tree(p_specs, mesh, cfg))
    state = trainer.distribute(opt.init(inp["params"]), mesh,
                               trainer.resolve_tree(o_specs, mesh, cfg))
    batch = trainer.distribute(inp["batch"], mesh,
                               trainer.resolve_tree(b_specs, mesh, cfg))
    step = trainer.make_sync_step(cfg, opt, mesh=mesh, param_specs=p_specs)
    shares = Shares()
    try:
        p, o, loss = step(params, state, batch)
    finally:
        shares.undo()
    every = [None] * WORLD
    dist.all_gather_object(every, {"mamba": shares.mamba,
                                   "mlstm": shares.mlstm,
                                   "experts": shares.experts})
    return {"params": _full(p), "loss": loss, "step": _full(o)["step"],
            "shares": every,
            "local_shapes": {k: list(v.to_local().shape)
                             for k, v in p.items()},
            "placements": {k: [repr(x) for x in v.placements]
                           for k, v in p.items()}}


def case_async(d: Path, inp: dict) -> dict:
    """A local step and a merge on (pod=2, data=1, model=2)."""
    cfg = configs.reduced(configs.get("minitron-4b"))
    mesh = init_device_mesh("cpu", (2, 1, 2),
                            mesh_dim_names=("pod", "data", "model"))
    p_specs = transformer.param_specs(cfg)
    in_pod = {"batch": ("data",)}
    pod = {k: P("pod", *v) for k, v in p_specs.items()}
    opt = sgd(inp["lr"])
    params_r = trainer.distribute(
        inp["params_r"], mesh,
        trainer.resolve_tree(pod, mesh, cfg, extra=in_pod))
    r = inp["params_r"]["embed"].shape[0]
    state = trainer.distribute(
        trainer.stack_replicas([opt.init(trainer.replica(inp["params_r"], i))
                                for i in range(r)]), mesh,
        trainer.resolve_tree({"step": P("pod")}, mesh, cfg, extra=in_pod))
    batch_r = trainer.distribute(
        inp["batch_r"], mesh,
        trainer.resolve_tree({k: P("pod", "batch", None)
                              for k in inp["batch_r"]}, mesh, cfg,
                             extra=in_pod))
    local, merge = trainer.make_async_local_step(cfg, opt, mesh=mesh,
                                                 param_specs=p_specs)
    with GroupedComms() as local_comms:
        p, o, losses = local(params_r, state, batch_r)
    with GroupedComms() as merge_comms:
        merged, _, _ = merge(p)
    return {"params": _full(p), "losses": losses.full_tensor(),
            "step": _full(o)["step"], "merged": _full(merged),
            "local_groups": local_comms.groups,
            "merge_groups": merge_comms.groups,
            "pods": [dist.get_process_group_ranks(mesh.get_group("pod"))]}


def case_pipeline(d: Path, inp: dict) -> dict:
    """Two batches of TokenPipeline(mesh=...) on two meshes."""
    out = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 1), ("pod", "data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        it = iter(pipeline.TokenPipeline(vocab=100, seq=16, global_batch=8,
                                         mesh=mesh, seed=3, device="cpu"))
        batches = [next(it) for _ in range(2)]
        out[names] = {
            "batches": [_full(b) for b in batches],
            "local_rows": batches[0]["tokens"].to_local().shape[0],
            "placements": [repr(x) for x in batches[0]["tokens"].placements]}
    return out


def case_rescale(d: Path, inp: dict) -> dict:
    """A state on (2, 2): elastic_rescale to (4, 1) and to one device; a
    checkpoint saved on (2, 2) restored onto (4, 1) and onto one device."""
    cfg = configs.reduced(configs.get("minitron-4b"))
    p_specs = transformer.param_specs(cfg)
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    opt = sgd(0.1)
    o_specs = trainer.opt_state_specs({"step": None}, p_specs)

    def placed(tree, mesh):
        return trainer.distribute(tree, mesh, trainer.resolve_tree(
            {"params": p_specs, "opt": o_specs}, mesh, cfg))

    host = {"params": inp["params"], "opt": opt.init(inp["params"])}
    state = placed(host, m22)
    on41 = fault.elastic_rescale(state, {
        "params": {k: (m41, pl) for k, pl in trainer.resolve_tree(
            p_specs, m41, cfg).items()},
        "opt": {"step": (m41, [Replicate(), Replicate()])}})
    alone = fault.elastic_rescale(state, {"params": {k: "cpu" for k in
                                                     p_specs},
                                          "opt": {"step": "cpu"}})
    save_checkpoint(d / "ckpt", 7, state)
    restored41, step41 = load_checkpoint(d / "ckpt", placed(host, m41))
    restored1, step1 = load_checkpoint(d / "ckpt", host, device="cpu")
    wq = "layers.0.attn.wq"
    return {"host": host, "on41": _full(on41), "alone": alone,
            "restored41": _full(restored41), "restored1": restored1,
            "steps": [step41, step1],
            "on41_local": list(on41["params"][wq].to_local().shape),
            "on41_placements": [repr(x) for x in on41["params"][wq].placements],
            "r41_local": list(restored41["params"][wq].to_local().shape),
            "alone_types": sorted({type(v).__name__ for v in
                                   alone["params"].values()})}


def case_resilient(d: Path, inp: dict) -> dict:
    """ResilientLoop on (data=2, model=2) with a checkpoint every 2 steps
    and a failure injected at step 3 on every rank: what each rank
    restored, its history and its final state."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    # large enough that rank 0's writer is still busy when the others fail
    state = {"w": trainer.distribute(
        {"w": torch.zeros(inp["rows"], 1024)}, mesh,
        {"w": trainer.placements(P("data", None), mesh)})["w"]}

    def step_fn(state, batch):
        return {"w": state["w"] + batch}, batch

    failed = []

    def fail_once(step):
        if step == 3 and not failed:
            failed.append(step)
            return True
        return False

    loop = fault.ResilientLoop(step_fn, CheckpointManager(d / "ckpt", every=2),
                               state, failure_hook=fail_once)
    final, history = loop.run(iter(range(1, 100)), inp["steps"])
    mine = {"history": [(kind, step) for kind, step, _ in history],
            "w": final["w"].full_tensor()[0, 0].item()}
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    return {"ranks": every}


def case_decode(d: Path, inp: dict) -> dict:
    """Prefill then decode ticks on (data=2, model=2): the KV caches
    sharded on the sequence over "model", written in place each tick."""
    cfg = configs.reduced(configs.get(inp["arch"]))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    p_specs = transformer.param_specs(cfg)
    params = trainer.distribute(inp["params"], mesh,
                                trainer.resolve_tree(p_specs, mesh, cfg))
    lm = transformer.LM.from_tree(params)
    b = inp["tokens"].shape[0]
    _, c_specs = specs.cache_shapes_and_specs(cfg, b, inp["max_len"])
    cache = trainer.distribute(
        decode.init_cache(cfg, b, inp["max_len"], device="cpu"), mesh,
        trainer.resolve_tree(c_specs, mesh, cfg))
    _, b_specs = specs.batch_specs(cfg, "decode", 1, b)
    step = trainer.make_decode_step(cfg, mesh)
    logits = []
    with torch.no_grad():
        for t in range(inp["tokens"].shape[1]):
            tok = trainer.distribute({"tokens": inp["tokens"][:, t:t + 1]},
                                     mesh, trainer.resolve_tree(
                                         b_specs, mesh, cfg))
            out, cache = step(lm, cache, tok, t)
            logits.append(out)
    return {"logits": torch.stack(logits), "cache": _full(cache),
            "cache_placements": {k: [repr(x) for x in v.placements]
                                 for k, v in cache.items()}}


CASES = {"sync": case_sync, "decode": case_decode, "family": case_family,
         "async": case_async, "xent": case_xent,
         "pipeline": case_pipeline, "rescale": case_rescale,
         "resilient": case_resilient}


def _rank(rank: int, case: str, d: str) -> None:
    torch.set_num_threads(1)
    d = Path(d)
    store = dist.FileStore(str(d / "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        out = CASES[case](d, torch.load(d / "in.pt"))
        if rank == 0:
            torch.save(out, d / "out.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, d = sys.argv[1], sys.argv[2]
    mp.start_processes(_rank, args=(case, d), nprocs=WORLD,
                       start_method="spawn")
