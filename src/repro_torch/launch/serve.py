"""Serving driver: batched requests against a (reduced or full) arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --requests 8 --slots 4 --max-new 16

``--smoke`` serves the reduced config; without it the full config is
served.  Parameters are random, drawn from a seeded generator on the
device (no checkpoint loading yet: ``--ckpt`` comes with the port of
``checkpoint/``).  Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import common
from repro_torch.nn import transformer
from repro_torch.serve.engine import Request, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """The engine and the requests ``main`` serves: (cfg, engine, reqs)."""
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.reduced(cfg)
    dev = common.device(args.device)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                         temperature=args.temperature, seed=args.seed,
                         device=dev)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=int(rng.integers(2, 9))),
                    max_new=args.max_new) for i in range(args.requests)]
    return cfg, engine, reqs


def main(argv=None):
    args = parse_args(argv)
    _, engine, reqs = setup(args)
    t0 = time.perf_counter()
    done = engine.run(reqs, max_ticks=4000)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"{len(done)}/{len(reqs)} requests; {tokens} tokens in {dt:.1f}s "
          f"({tokens / max(dt, 1e-9):.1f} tok/s on {args.slots} slots, "
          f"{engine.device})")
    if len(done) != len(reqs):
        raise RuntimeError("engine failed to drain the queue")
    return done


if __name__ == "__main__":
    main()
