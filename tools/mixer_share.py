#!/usr/bin/env python3
"""Per-rank peak memory and flops of one placed recurrent mixer layer on
the single-pod production mesh, as rank 0 of a ``"fake"`` world, beside
the unsharded layer's flops.

    python3 tools/mixer_share.py [--device cpu] [--reduced]

For zamba2-1.2b's Mamba2 layer and xlstm-1.3b's mLSTM and sLSTM layers at
train_4k's batch and sequence (256 x 4,096) on ``(data=16, model=16)``:
one layer's forward and backward on fake DTensors placed by their specs
(the input on the residual's spec, as the step places it), under
``FakeTensorMode`` (no storage): rank 0's live local bytes at their peak
(``dryrun.LocalMemory``, the layer's weights and input counted; the
layer's share of a step's peak, which holds a superblock's saved
activations at once in its backward) and its flops
(``dryrun.LocalFlopCounter``); then the same layer on plain fakes, its
flops (``FlopCounterMode``).  Prints one JSON line: per layer, the peak
bytes, rank 0's flops, the unsharded flops and rank 0's flops times the
256 ranks over the unsharded flops (1 when the work splits evenly).
``--reduced``: the configs' reduced forms at B=32, S=64 on the same mesh
(a smoke run for the CPU).  The fakes live on ``cuda`` unless
``--device`` says.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.nn import param as pm  # noqa: E402
from repro_torch.nn import transformer  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

#: (label, arch, the layer's parameter prefix, its block kind, its layer fn)
LAYERS = (("mamba2", "zamba2-1.2b", "mamba_blocks.0.0.", "mamba",
           transformer.mamba_layer),
          ("mlstm", "xlstm-1.3b", "mlstm_blocks.0.0.", "mix",
           transformer.mlstm_layer),
          ("slstm", "xlstm-1.3b", "slstm_blocks.0.", "mix",
           transformer.slstm_layer))


def _layer(cfg, prefix: str, kind: str, tree: dict):
    own = {k[len(prefix):]: nn.Parameter(v) for k, v in tree.items()}
    return transformer.MixerBlock(kind, nn.ParameterDict(
        {k[len(kind) + 1:]: v for k, v in own.items() if k != "norm"}),
        own["norm"])


def measure(cfg, prefix: str, kind: str, fn, b: int, s: int, mesh,
            device: str) -> dict:
    """One layer's forward and backward: ``mesh`` None on plain fakes
    (flops), else on fake DTensors (rank 0's peak and flops)."""
    shapes = {k: v for k, v in transformer.init_params(cfg, pm.META)
              .named_parameters() if k.startswith(prefix)}
    specs = transformer.param_specs(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(b, s, cfg.d_model, dtype=cfg.param_dtype,
                        device=device)
        tree = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                for k, v in shapes.items()}
        memory = dryrun.LocalMemory()
        if mesh is None:
            counter = FlopCounterMode(display=False)
        else:
            x = dryrun.place(x, trainer.placements(trainer.resolve_spec(
                transformer.RESIDUAL, mesh, cfg), mesh), mesh, device)
            tree = dryrun.place(tree, {k: trainer.placements(
                trainer.resolve_spec(specs[k], mesh, cfg), mesh)
                for k in tree}, mesh, device)
            counter = dryrun.LocalFlopCounter(display=False)
        x.requires_grad_()
        layer = _layer(cfg, prefix, kind, tree)
        memory.track([x, *tree.values()])
        t0 = time.perf_counter()
        with memory, counter:
            y, _ = fn(x, layer, cfg, shard=trainer.make_shard_fn(mesh, cfg))
            # a loss over the rank's own shard: a DTensor sum's backward
            # would expand its gradient to the global shape on every rank
            (y.to_local() if mesh is not None else y).float().sum() \
                .backward()
        seconds = time.perf_counter() - t0
    return {"flops": counter.get_total_flops(), "peak_bytes": memory.peak,
            "largest_live": memory.largest, "trace_s": seconds}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    _, seq, gb = configs.SHAPES["train_4k"]
    b, s = (32, 64) if args.reduced else (gb, seq)
    out = {"mesh": "16x16", "batch": b, "seq": s, "device": args.device}
    for label, arch, prefix, kind, fn in LAYERS:
        cfg = configs.get(arch)
        if args.reduced:
            cfg = configs.reduced(cfg, seq_shard=cfg.seq_shard, n_heads=16,
                                  d_model=512, ssm_chunk=16)
        plain = measure(cfg, prefix, kind, fn, b, s, None, args.device)
        with dryrun.fake_world(256):
            mesh = mesh_mod.make_production_mesh(device_type=args.device)
            rank = measure(cfg, prefix, kind, fn, b, s, mesh, args.device)
        out[label] = {"arch": arch, "rank": rank,
                      "unsharded_flops": plain["flops"],
                      "flops_x_ranks_over_unsharded":
                          rank["flops"] * 256 / plain["flops"]}
        print(json.dumps({label: out[label]}), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
