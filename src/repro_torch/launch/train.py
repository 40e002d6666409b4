"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b \
        --smoke --steps 50 --update async --merge-every 5

``--smoke`` trains the reduced same-family config with one repeated batch;
without it the full config trains on fresh batches.  Supports sync and
async-local update strategies, checkpoint/restart and failure injection
(``--inject-failure-at``).  Parameters are random, drawn from a seeded
generator on the device.  Runs on ``cuda`` unless ``--device cpu``.  As
the reference's launcher, it runs without a mesh: one device holds the
model and every replica.  The steps it builds take one
(``trainer.make_sync_step(..., mesh=...)``, a ``torch.distributed``
``DeviceMesh``); ``repro_torch.launch.dryrun`` traces them on the
production meshes.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import common
from repro_torch.nn import transformer
from repro_torch.optim.adam import adam as make_adam
from repro_torch.optim.sgd import sgd as make_sgd, sgd_momentum
from repro_torch.train import fault, trainer


def make_batch_fn(cfg, gb, seq, seed=0, fixed: bool = False, device=None):
    """Batches on ``device`` drawn as the reference draws them, in its
    order: "embeddings" [gb, seq, d] (audio) or "tokens" [gb, seq], then
    for vlm "memory" [gb, n_memory, d] (both N(0, 1) in the model's
    dtype), then "labels" [gb, seq] (int32).  ``fixed=True`` repeats one
    batch — smoke runs overfit it, which is the honest convergence check
    on synthetic data (fresh random tokens have no learnable structure
    beyond the marginal)."""
    rng = np.random.default_rng(seed)
    dev = common.device(device)

    def draw():
        return torch.from_numpy(
            rng.integers(0, cfg.vocab, (gb, seq)).astype(np.int32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dev).to(cfg.param_dtype)

    def one():
        ins = ({"embeddings": normal(gb, seq, cfg.d_model)} if cfg.emb_in()
               else {"tokens": draw()})
        if cfg.family == "vlm":
            ins["memory"] = normal(gb, cfg.n_memory, cfg.d_model)
        ins["labels"] = draw()
        return ins

    def gen():
        first = one()
        while True:
            yield first if fixed else one()

    return gen()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--update", default="sync", choices=["sync", "async"])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--merge-every", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, params: transformer.LM | None = None):
    """What ``main`` runs: ``(cfg, loop, batches)``.  ``params`` replaces
    the seeded initial weights (an LM on the run's device)."""
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    dev = common.device(args.device)
    opt = {"sgd": lambda: make_sgd(args.lr),
           "momentum": lambda: sgd_momentum(args.lr),
           "adam": lambda: make_adam(args.lr)}[args.optimizer]()
    if params is None:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
    tree = {k: v.detach() for k, v in params.named_parameters()}
    del params
    batches = make_batch_fn(cfg, args.batch, args.seq, fixed=args.smoke,
                            device=dev)

    if args.update == "sync":
        train_step = trainer.make_sync_step(cfg, opt)

        def step(state, batch):
            p, o, loss = train_step(*state, batch)
            return (p, o), {"loss": loss}

        state = (tree, opt.init(tree))
    else:
        R, me = args.replicas, args.merge_every
        local, merge = trainer.make_async_local_step(cfg, opt)

        def step(state, batch):
            p, o, t = state
            bs = {k: v.reshape(R, v.shape[0] // R, *v.shape[1:])
                  for k, v in batch.items()}
            p, o, loss = local(p, o, bs)
            if (int(t) + 1) % me == 0:
                p, _, _ = merge(p)
            return (p, o, t + 1), {"loss": loss.mean()}

        stacked = trainer.stack_replicas([tree] * R)
        del tree
        state = (stacked, trainer.stack_replicas(
            [opt.init(trainer.replica(stacked, r)) for r in range(R)]),
            torch.zeros((), dtype=torch.int32, device=dev))

    ckpt = CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                      "repro_torch_ckpt"),
        every=args.ckpt_every)
    failure = None
    if args.inject_failure_at is not None:
        fired = {"done": False}

        def failure(step_i):
            if step_i == args.inject_failure_at and not fired["done"]:
                fired["done"] = True
                return True
            return False

    loop = fault.ResilientLoop(step, ckpt, state, resume=False,
                               failure_hook=failure)
    return cfg, loop, batches


def losses_of(history) -> list[float]:
    return [float(m["loss"]) for kind, _, m in history if kind == "step"]


def main(argv=None):
    args = parse_args(argv)
    cfg, loop, batches = setup(args)
    t0 = time.perf_counter()
    _, history = loop.run(batches, args.steps)
    losses = losses_of(history)
    restarts = sum(kind == "restart" for kind, _, _ in history)
    print(f"arch={cfg.name} update={args.update} steps={len(losses)} "
          f"restarts={restarts} loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({time.perf_counter() - t0:.1f}s on {common.device(args.device)})")
    assert losses[-1] < losses[0], "loss did not decrease"
    return losses


if __name__ == "__main__":
    main()
