#!/usr/bin/env python3
"""Time ``glm_score``'s flat kernel under other plans than its own, beside
the group kernel it replaced.

    python3 tools/score_sweep.py

The shapes are the serving path's and the timing phase's: the w8a stand-in
(K = 69, d = 300) at N = 128 and 32 (a flush at ``max_batch`` 128 and 32)
and all 64,700 rows, real-sim (K = 307, d = 20,958) at N = 128, and news'
first 512 rows (K = 2,729, d = 1,355,191, ``chip_smoke.news_dataset``).
At each it runs the group kernel, then the flat kernel at the plan
``ops.score_plan`` gives and at the other plans of ``plans``, then the plan
and the group kernel again; each plan is swapped in for its row and put
back.

Prints one JSON line per (shape, kernel, plan): device ms a call
(``chip_smoke.kernel_device_time``: the profiler's mean over the launches
it recorded in 200 calls), the byte bound (``chip_smoke.ell_bytes`` plus
the scores and the model entries touched), the largest difference from the
plain PyTorch version and whether five calls give the same bits; then
three floors at the shape, device ms from the profiler: an empty launch,
and PyTorch's copy of the values' first column and its row sum of the
values, kernels that read the operand once and gather nothing.  The
card's name and power limit lead the output.  Needs one card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def plans(n: int, k: int, sms: int):
    """The plan's (rows, threads, vectors, lanes, gated) first, then the
    others: runs of rows from 1 to the most a run holds, each with
    ``flat_shape``'s threads and chunks and ``row_lanes``' lanes, gated or
    not; then the plan's rows at every other lanes a row."""
    from repro_torch.kernels.glm_score import ops

    chosen = ops.score_plan(n, k, sms)
    seen = {chosen}
    yield chosen
    cap = (ops.RUN_WORDS - 3) // k
    candidates = []
    for rows in sorted({r for r in (1, 2, 4, 8, 16, 32, 64, cap // 4,
                                    cap // 2, cap) if 1 <= r <= cap}):
        threads, vectors = ops.flat_shape(rows, k)
        for gated in (False, True):
            candidates.append((rows, threads, vectors,
                               ops.row_lanes(rows, k, threads), gated))
    for lanes in (1, 2, 4, 8, 16, 32) if chosen[0] > 1 else ():
        candidates.append(chosen[:3] + (lanes,) + chosen[4:])
    for plan in candidates:
        if plan not in seen:
            seen.add(plan)
            yield plan


def main() -> int:
    if not torch.cuda.is_available():
        print("score_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch.kernels as K
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, common
    from repro_torch.kernels.glm_score import ops
    from repro_torch.kernels.glm_score.ref import glm_score_ref

    _build.build_all(["glm_score"])
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda")
    sms = common.sm_count(dev)
    w8 = synthetic.paper_dataset("w8a", seed=0, device=dev).ell
    rs = synthetic.paper_dataset("real-sim", seed=0, max_n=1_024,
                                 device=dev).ell
    news = cs.news_dataset(dev)[0]
    shapes = (("w8a", w8, 128), ("w8a", w8, 32), ("real-sim", rs, 128),
              ("w8a", w8, w8.shape[0]), ("news", news, 512))
    gen = torch.Generator(device=dev).manual_seed(1)
    saved_plan, saved_variant = ops.score_plan, ops.variant
    for data, m, n in shapes:
        v, i = m.values[:n].contiguous(), m.indices[:n].contiguous()
        w = torch.randn(m.d, device=dev, generator=gen) * 0.1
        ref = glm_score_ref("lr", w, v, i)
        touched = int(torch.unique(i[v != 0]).numel())
        bound = cs.bound_ms(cs.ell_bytes(v) + 4 * n + 4 * touched,
                            2.0 * int((v != 0).sum()) + 4.0 * n)[0]

        def score():
            return K.glm_score("lr", w, v, i)

        flat = [("flat", p) for p in plans(n, m.values.shape[1], sms)]
        # the group kernel and the plan once more at the end: their spread
        runs = [("group", None)] + flat + [flat[0], ("group", None)]
        for kind, plan in runs:
            ops.variant = lambda *_, kind=kind: kind
            if plan is not None:
                ops.score_plan = lambda *_, plan=plan: plan
            try:
                timed = cs.kernel_device_time(
                    score, 200, cs.KERNEL_SYMBOLS["glm_score"][kind])
                line = {"data": data, "n": n, "K": m.values.shape[1],
                        "d": m.d, "variant": kind,
                        "plan": None if plan is None else list(plan),
                        "planned": plan == saved_plan(n, m.values.shape[1],
                                                      sms),
                        **timed, "bound_ms": bound,
                        "max_abs_err": float((score() - ref).abs().max()),
                        "same_bits": cs.same_bits(score)}
            finally:
                ops.variant, ops.score_plan = saved_variant, saved_plan
            print(json.dumps(line), flush=True)
        # floors at this shape: an empty launch, and PyTorch's own kernels
        # that read the values once (a strided copy of one column, a row
        # sum): one round trip to memory and no gather
        for label, fn in (("empty launch", lambda: torch.cuda._sleep(0)),
                          ("values[:, 0].clone()", lambda: v[:, 0].clone()),
                          ("values.sum(1)", lambda: v.sum(1))):
            prof = cs.device_profile(fn, 200)
            print(json.dumps({
                "data": data, "n": n, "K": m.values.shape[1], "floor": label,
                "device_ms": sum(ms for ms, _ in prof.values()) / 200,
                "kernels": {cs.short_name(k): c for k, (_, c) in
                            prof.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
