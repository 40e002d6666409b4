"""End-to-end driver on the PyTorch port: train a ~40M-param LM for a few
hundred steps.

Uses the h2o-danube family config scaled down as ``examples/train_lm.py``
scales it (the paper's update-strategy axis applies unchanged: pass
--update async to train per-replica models with periodic merges instead
of synchronous SGD).  The twin of ``examples/train_lm.py``; runs on
``cuda`` unless ``--device`` says otherwise.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 --update async
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 3 --batch 2 --seq 32
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import common
from repro_torch.launch.train import losses_of, make_batch_fn
from repro_torch.nn import transformer
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.train import fault, trainer

#: the async run's replicas
REPLICAS = 2


def lm_100m():
    """The danube-family config of ``examples/train_lm.py`` (8L x 512 with
    a 32k vocab)."""
    base = configs.get("h2o-danube-1.8b")
    return configs.reduced(
        base, n_layers=8, d_model=512, n_heads=8, n_kv=4, d_ff=1536,
        vocab=32_000, window=256, head_dim=64,
        attn_chunk=128, loss_chunk=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--update", default="sync", choices=["sync", "async"])
    ap.add_argument("--merge-every", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = common.device(args.device)

    cfg = lm_100m()
    lm = transformer.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0))
    params = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    n_params = sum(v.numel() for v in params.values())
    print(f"{cfg.name}: {n_params/1e6:.1f}M parameters, "
          f"update={args.update}, on {dev}")

    opt = sgd_momentum(args.lr, 0.9)
    batches = make_batch_fn(cfg, args.batch, args.seq, fixed=True,
                            device=dev)

    if args.update == "sync":
        train_step = trainer.make_sync_step(cfg, opt)

        def step(state, batch):
            p, o, loss = train_step(*state, batch)
            return (p, o), {"loss": loss}

        state = (params, opt.init(params))
    else:
        me = args.merge_every
        local, merge = trainer.make_async_local_step(cfg, opt)

        def step(state, batch):
            p, o, t = state
            bs = {k: v.reshape(REPLICAS, v.shape[0] // REPLICAS, *v.shape[1:])
                  for k, v in batch.items()}
            p, o, loss = local(p, o, bs)
            if (int(t) + 1) % me == 0:
                p, _, _ = merge(p)
            return (p, o, t + 1), {"loss": loss.mean()}

        stacked = trainer.stack_replicas([params] * REPLICAS)
        state = (stacked, trainer.stack_replicas(
            [opt.init(trainer.replica(stacked, r)) for r in range(REPLICAS)]),
            torch.zeros((), dtype=torch.int32, device=dev))
    del params

    ckpt = CheckpointManager(args.ckpt, keep=2, every=100)
    loop = fault.ResilientLoop(step, ckpt, state, resume=False)
    t0 = time.time()
    _, history = loop.run(batches, args.steps)
    losses = losses_of(history)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"steps={len(losses)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({dt:.0f}s, {toks/dt:.0f} tok/s)")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not decrease")
    return losses


if __name__ == "__main__":
    main()
