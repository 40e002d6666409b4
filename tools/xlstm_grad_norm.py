#!/usr/bin/env python3
"""Full-width xlstm-1.3b's gradient at its initial weights, through the
JAX reference and through the port, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_grad_norm.py \
        [--layers 8] [--batch 2] [--seq 64] [--chunks 512,32,16]

The reference's weights (``init_params`` at ``jax.random.PRNGKey(0)``) at
full width, cut to its first superblock (7 mLSTM + 1 sLSTM layers), are
carried into the port by ``convert.lm_params_from_reference``; one batch of
tokens and labels is drawn with numpy (seed 3).  The loss and its gradient
go through both packages at each ``ssm_chunk`` of ``--chunks`` (the
config's 512 first; the chunking changes the order of the sums, not the
function), in fp32 and in bf16 (the config's own dtype, each package's
init in it).  Prints one JSON line: per dtype, package and chunk, the
loss, the global gradient norm and the relative L2 distance of the whole
gradient from the reference's at the config's chunk; and the port's
distance at the config's chunk beside the largest of the reference's own
distances (its spread over the chunkings), and 1e-3, the normwise rule of
``tests/test_torch_families.py`` for the reduced xLSTM (10 x its rtol).
Then, in fp32, the reference's gradient on its weights times
``1 + eps * N(0, 1)`` for each ``eps`` of ``--perturb`` (1e-7: about one
fp32 rounding of every weight), against the unperturbed one: how far a
rounding's worth of difference moves the gradient (its conditioning).

This imports both packages, so it runs on the CPU only; it is not a test.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro import configs as jconfigs  # noqa: E402
from repro.nn import transformer as jtransformer  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCH = "xlstm-1.3b"
#: the normwise rule's limit (relative L2)
LIMIT = 1e-3


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def norm(tree: dict) -> float:
    return float(np.sqrt(sum(np.sum(v * v) for v in tree.values())))


def reference_grads(jcfg, jparams, batch) -> tuple[float, dict]:
    loss, grads = jax.value_and_grad(jtransformer.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), leaves(grads)


def port_grads(cfg, jparams, batch) -> tuple[float, dict]:
    lm = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tree = {k: v.detach() for k, v in lm.named_parameters()}
    del lm
    loss, grads = trainer.value_and_grad(
        cfg, tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), leaves(convert.lm_params_to_reference(
        {k: v.float() for k, v in grads.items()}, cfg))


def rel_l2(got: dict, want: dict) -> float:
    return float(np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
                 / norm(want))


def perturbed(jfull, layers: int, jparams, batch, base: dict,
              eps_list: list) -> dict:
    """The reference's fp32 gradient with every fp32 weight times
    ``1 + eps * N(0, 1)`` (a fixed key), against ``base``."""
    jcfg = dataclasses.replace(jfull, n_layers=layers,
                               param_dtype=jnp.float32)
    flat, tdef = jax.tree_util.tree_flatten(jparams)
    keys = jax.random.split(jax.random.PRNGKey(7), len(flat))
    out = {}
    for eps in eps_list:
        noisy = [x * (1 + eps * jax.random.normal(k, x.shape))
                 if x.dtype == jnp.float32 else x for x, k in zip(flat, keys)]
        loss, grads = reference_grads(
            jcfg, jax.tree_util.tree_unflatten(tdef, noisy), batch)
        out[str(eps)] = {"loss": loss, "grad_norm": norm(grads),
                         "rel_l2": rel_l2(grads, base)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--chunks", default="512,32,16")
    ap.add_argument("--perturb", default="1e-7,1e-6")
    args = ap.parse_args()
    torch.set_num_threads(4)
    chunks = [int(c) for c in args.chunks.split(",")]
    jfull, full = jconfigs.get(ARCH), configs.get(ARCH)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, full.vocab, (args.batch, args.seq))
             .astype(np.int32) for k in ("tokens", "labels")}
    out = {"arch": ARCH, "layers": args.layers, "d_model": full.d_model,
           "heads": full.n_heads, "vocab": full.vocab, "batch": args.batch,
           "seq": args.seq, "config_chunk": full.ssm_chunk, "limit": LIMIT}
    t0 = time.perf_counter()
    for name, jdtype, dtype in (("fp32", jnp.float32, torch.float32),
                                ("bf16", jnp.bfloat16, torch.bfloat16)):
        jparams, _ = jtransformer.init_params(
            dataclasses.replace(jfull, n_layers=args.layers,
                                param_dtype=jdtype), jax.random.PRNGKey(0))
        runs, base = {"reference": {}, "port": {}}, None
        for chunk in chunks:
            jcfg = dataclasses.replace(jfull, n_layers=args.layers,
                                       param_dtype=jdtype, ssm_chunk=chunk)
            cfg = dataclasses.replace(full, n_layers=args.layers,
                                      param_dtype=dtype, ssm_chunk=chunk)
            for pkg, fn, c in (("reference", reference_grads, jcfg),
                               ("port", port_grads, cfg)):
                loss, grads = fn(c, jparams, batch)
                base = grads if base is None else base
                runs[pkg][chunk] = {"loss": loss, "grad_norm": norm(grads),
                                    "rel_l2": rel_l2(grads, base)}
        spread = max(r["rel_l2"] for r in runs["reference"].values())
        out[name] = {**runs, "port_rel_l2": runs["port"][chunks[0]]["rel_l2"],
                     "reference_spread": spread}
        if name == "fp32":
            out["fp32"]["perturbed"] = perturbed(
                jfull, args.layers, jparams, batch, base,
                [float(e) for e in args.perturb.split(",")])
        del jparams
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
