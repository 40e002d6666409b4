"""Roofline analysis over the dry run's cells on the NVIDIA H100
(deliverable g).

For each (arch x shape x mesh) cell the dry run wrote
(``python -m repro_torch.launch.dryrun``), derive the three roofline
terms from its op counts (``roofline/counts.py``, the counterpart of the
reference's ``hlo.py``):

    compute_s    = sum over dtypes of dot flops a device / that dtype's peak
    memory_s     = HBM-traffic proxy a device           / HBM bandwidth
    collective_s = sum over collectives of wire bytes a device / its link's bandwidth

plus MODEL_FLOPS (6 N_active D for training, 2 N_active D for inference),
the useful-compute ratio, the dominant term and a suggestion.

Peaks: one H100 SXM's, from ``roofline/kernels.py`` (NVIDIA's data sheet,
700 W): bf16 (and fp16) on the tensor cores at 989 TFLOP/s, everything
else at fp32's 67 TFLOP/s outside them (TF32 stays off in the port), HBM3
at 3.35 TB/s.

The link model (NVIDIA's DGX/HGX H100 documentation): nodes of 8 GPUs,
rank r in node ``r // 8``, joined inside a node by NVLink 4 through the
NVSwitches at 450 GB/s a direction a GPU, and across nodes by one 400
Gb/s ConnectX-7 NIC a GPU (50 GB/s) on a rail-optimised fabric.  A
collective's group inside one node moves its wire bytes at 450 GB/s; a
group that spans nodes with k of its ranks in each node runs k rings,
one a NIC, at min(k x 50, 450) GB/s.  On the production ``(data=16,
model=16)`` mesh a ``"model"`` group (16 consecutive ranks, two nodes, k
= 8) gets 400 GB/s, a ``"data"`` group (stride 16, k = 1) 50 GB/s, and
the ``"pod"`` axis 50 GB/s.  The model has no congestion (every ring at
its NICs' rate at once), no latency a message, and no overlap of the
three terms; the step's bound is the largest of them.

    PYTHONPATH=src python -m repro_torch.roofline.analysis [--mesh 16x16]

reads ``dryrun_results/torch/*__<mesh>.json`` and writes
``roofline_<mesh>.json`` and ``roofline_<mesh>.md`` beside them (the
glob is the reference's, so the ``__async`` cells stay out as they do
there).
"""
from __future__ import annotations

import argparse
import json
import math
from collections import Counter
from pathlib import Path

from repro_torch.roofline.kernels import (BF16_FLOPS_PER_S, FP32_FLOPS_PER_S,
                                          HBM_BYTES_PER_S)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results" / "torch"

#: dot flops a second by input dtype (anything else at fp32's rate)
PEAK_FLOPS = {"bfloat16": BF16_FLOPS_PER_S, "float16": BF16_FLOPS_PER_S,
              "float32": FP32_FLOPS_PER_S}
#: GPUs a node (HGX H100)
GPUS_PER_NODE = 8
#: NVLink 4 bytes/s a direction a GPU
NVLINK_BYTES_PER_S = 450e9
#: one 400 Gb/s NIC a GPU, bytes/s
NIC_BYTES_PER_S = 50e9
#: the class of a group inside one node
NVLINK = "nvlink"


def link_class(ranks) -> str:
    """``"nvlink"`` for a group inside one node, else ``"net xK"``: K of
    its ranks in each node it spans (the fewest, where they differ)."""
    per_node = Counter(r // GPUS_PER_NODE for r in ranks)
    if len(per_node) <= 1:
        return NVLINK
    return f"net x{min(per_node.values())}"


def link_bytes_per_s(link: str) -> float:
    """A link class's bandwidth a device (module docstring)."""
    if link == NVLINK:
        return NVLINK_BYTES_PER_S
    k = int(link.removeprefix("net x"))
    return min(k * NIC_BYTES_PER_S, NVLINK_BYTES_PER_S)


def param_counts(arch: str) -> tuple[float, float]:
    """(total, active-per-token) parameter counts, from the real init
    shapes; a routed expert's weights count top_k / experts of theirs
    (the reference's ``analysis.param_counts``)."""
    from repro_torch import configs
    from repro_torch.launch import specs as specs_mod

    cfg = configs.get(arch)
    shapes, _ = specs_mod.param_shapes_and_specs(cfg)
    total = active = 0.0
    for name, leaf in shapes.items():
        keys = name.split(".")
        n = math.prod(leaf.shape)
        total += n
        if cfg.moe_experts and "moe" in keys and any(
                k in ("w_up", "w_gate", "w_down") for k in keys):
            active += n * (cfg.moe_top_k / cfg.moe_experts)
        else:
            active += n
    return total, active


def model_flops(arch: str, kind: str, seq: int, gb: int) -> float:
    """Global MODEL_FLOPS a step: 6 N_active D (train), 2 N_active D
    (inference); D the tokens the step touches."""
    _, active = param_counts(arch)
    tokens = gb * (1 if kind == "decode" else seq)
    return (6.0 if kind == "train" else 2.0) * active * tokens


def compute_seconds(by_dtype: dict) -> float:
    return sum(f / PEAK_FLOPS.get(dt, FP32_FLOPS_PER_S)
               for dt, f in by_dtype.items())


def collective_seconds(by_link: dict) -> float:
    return sum(b / link_bytes_per_s(link) for link, b in by_link.items())


SUGGESTIONS = {
    "compute_s": ("cut flops that are not the model's: the checkpointed "
                  "blocks' and the chunked loss's recompute (save the "
                  "attention output instead), repeated work on replicated "
                  "dims (the mLSTM's v and xi), fp32 products onto bf16 "
                  "tensor cores"),
    "memory_s": ("fuse the elementwise chains around the attention kernels "
                 "(norms, rotary, gates, the loss) so that each activation "
                 "crosses HBM once; save less for the backward"),
    "collective_s": ("shrink what crosses the network: keep the \"kvseq\" "
                     "gather and the parameter gathers on NVLink groups, "
                     "send the merge's int8 codes, overlap the gradients' "
                     "reduce-scatter with the backward"),
}


def analyze_cell(json_path: Path) -> dict | None:
    """One cell's row (the reference's keys), or None where the cell's
    JSON predates the op counts."""
    return analyze(json.loads(Path(json_path).read_text()))


def analyze(meta: dict) -> dict | None:
    """:func:`analyze_cell` on a cell's record; the devices are the
    product of its mesh's sizes (``"16x16"``: 256, ``"1x1"``: one card)."""
    if meta.get("status") != "ok":
        return {"arch": meta.get("arch"), "shape": meta.get("shape"),
                "mesh": meta.get("mesh"), "status": "fail"}
    if "dot_flops_by_dtype" not in meta:
        return None
    n_dev = math.prod(int(n) for n in meta["mesh"].split("x"))
    dot_flops = float(sum(meta["dot_flops_by_dtype"].values()))
    terms = {"compute_s": compute_seconds(meta["dot_flops_by_dtype"]),
             "memory_s": meta["hbm_bytes"] / HBM_BYTES_PER_S,
             "collective_s": collective_seconds(meta["wire_bytes_by_link"])}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    mf = model_flops(meta["arch"], meta["kind"], meta["seq"],
                     meta["global_batch"])
    mf_dev = mf / n_dev
    return {
        "arch": meta["arch"], "shape": meta["shape"], "mesh": meta["mesh"],
        "kind": meta["kind"], "status": "ok", "devices": n_dev,
        **terms, "dominant": dominant, "step_time_bound_s": bound,
        "roofline_fraction": terms["compute_s"] / bound if bound else 0.0,
        "model_flops_global": mf, "model_flops_per_dev": mf_dev,
        "dot_flops_per_dev": dot_flops,
        "dot_flops_by_dtype": meta["dot_flops_by_dtype"],
        "useful_compute_ratio": mf_dev / dot_flops if dot_flops else 0.0,
        "hbm_bytes_per_dev": meta["hbm_bytes"], "hbm_top": meta["hbm_top"],
        "collective_bytes_per_dev": meta["wire_bytes"],
        "collective_by_kind": meta["wire_bytes_by_kind"],
        "collective_by_link": meta["wire_bytes_by_link"],
        "peak_bytes": meta["memory"].get("peak_bytes"),
        "argument_bytes": meta["memory"].get("argument_bytes"),
        "suggestion": SUGGESTIONS[dominant],
    }


def run(mesh: str = "16x16", pattern: str = "*",
        results: Path = RESULTS_DIR) -> list[dict]:
    """Every cell of ``mesh`` under ``results``; writes
    ``roofline_<mesh>.json`` there."""
    rows = []
    for p in sorted(Path(results).glob(f"{pattern}__{mesh}.json")):
        r = analyze_cell(p)
        if r:
            rows.append(r)
            print(f"{r['arch']:22s} {r['shape']:12s} "
                  f"dom={r.get('dominant', '-'):13s} "
                  f"C={r.get('compute_s', 0):8.3f}s "
                  f"M={r.get('memory_s', 0):8.3f}s "
                  f"X={r.get('collective_s', 0):8.3f}s "
                  f"useful={r.get('useful_compute_ratio', 0):5.2f}",
                  flush=True)
    out = Path(results) / f"roofline_{mesh}.json"
    out.write_text(json.dumps(rows, indent=1))
    print(f"wrote {out}")
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s "
           "| dominant "
           "| model TFLOPs/dev | useful ratio | roofline frac "
           "| collective GB by link |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.get("status") != "ok":
            continue
        links = ", ".join(f"{k} {v / 1e9:.3g}" for k, v in
                          sorted(r["collective_by_link"].items())) or "none"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.4g} "
            f"| {r['memory_s']:.4g} | {r['collective_s']:.4g} "
            f"| **{r['dominant'].replace('_s', '')}** "
            f"| {r['model_flops_per_dev'] / 1e12:.2f} "
            f"| {r['useful_compute_ratio']:.2f} "
            f"| {r['roofline_fraction']:.2f} | {links} |")
    return hdr + "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--pattern", default="*")
    args = ap.parse_args(argv)
    rows = run(args.mesh, args.pattern)
    (RESULTS_DIR / f"roofline_{args.mesh}.md").write_text(to_markdown(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
