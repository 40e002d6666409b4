"""Serve a small model with batched requests (continuous-batching engine)
on the PyTorch port.  The twin of ``examples/serve_lm.py``; runs on
``cuda`` unless ``--device`` says otherwise.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 6 --slots 2
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import common
from repro_torch.nn import transformer
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = common.device(args.device)

    cfg = configs.reduced(configs.get(args.arch))
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(cfg, params, slots=args.slots, max_len=128,
                         temperature=args.temperature, device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=rng.integers(2, 8)),
                    max_new=args.max_new)
            for i in range(args.requests)]

    t0 = time.time()
    done = engine.run(reqs, max_ticks=2000)
    dt = time.time() - t0
    total = sum(len(r.out) for r in done)
    print(f"{len(done)}/{len(reqs)} requests served on {args.slots} slots; "
          f"{total} tokens in {dt:.1f}s ({total/dt:.1f} tok/s) on {dev}")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt {list(r.prompt)} -> {r.out[:10]}...")
    if len(done) != len(reqs):
        raise SystemExit(f"served {len(done)} of {len(reqs)} requests")
    return done


if __name__ == "__main__":
    main()
