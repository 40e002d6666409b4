#!/usr/bin/env python3
"""Where the cycles of glm_sgd_sparse's live-prefix kernels go, by role.

    python3 tools/live_cycles.py

Needs one card.  Builds an instrumented copy of
``src/repro_torch/kernels/csrc/glm_sgd_sparse.cu`` into
``build/live_cycles/`` (each replica's block adds ``clock64`` spans to a
device array: the producer warp's wait for a free stage and its staging of
a fill, the chain's wait for a full stage and its work on the fill) and
runs ``ell_sgd_live_smem_kernel`` at real-sim's paths (``AsyncLocalSGD(8,
1)``, ``(10, 10)``, ``SyncSGD(batch=16)``) and ``ell_sgd_live_global_kernel``
at news's (``AsyncLocalSGD(8, 1)``, ``(64, 1)``), both sets padded to their
Table 3 row widths (``chip_smoke.long_rows_dataset``).  Prints one JSON
line a shape: fills a replica, SM cycles a fill by role (means over the
replicas), us an update by CUDA events (the counters included), and the
result against the plain version.  The role whose cycles a fill are the
larger (producer staging, chain work) bounds the epoch; the other's wait
says how long it idles.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "live_cycles"
#: the counters of a block: producer wait, producer staging, fills, chain
#: wait, chain work
ROLES = ("producer_wait", "producer_fill", "fills", "chain_wait",
         "chain_work")
#: (set, replicas, micro-batch)
SHAPES = (("real-sim", 8, 1), ("real-sim", 10, 10), ("real-sim", 1, 16),
          ("news", 8, 1), ("news", 64, 1))

PROLOGUE = """
__device__ unsigned long long g_cycles[64 * 8];
#define SPAN(i, dt) do { g_cycles[blockIdx.x * 8 + (i)] += (dt); } while (0)
"""
EPILOGUE = """
extern "C" int live_cycles_read(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles)));
}
extern "C" int live_cycles_reset() {
  static unsigned long long zero[64 * 8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero)));
}
"""
#: (text, replacement): each text must occur exactly as often as given
EDITS = (
    ("constexpr int kLiveLengthWarps = 8;",
     PROLOGUE + "constexpr int kLiveLengthWarps = 8;", 1),
    ("""    const int s = f % stages, use = f / stages;
    if (use > 0) mbar_wait_or_trap(&empty[s], (use - 1) & 1);""",
     """    const int s = f % stages, use = f / stages;
    const long long t0 = clock64();
    if (use > 0) mbar_wait_or_trap(&empty[s], (use - 1) & 1);
    if (lane == 0) SPAN(0, clock64() - t0);""", 1),
    ("""  auto publish = [&](unsigned char* st, int pieces, int pass) {""",
     """  auto publish = [&](unsigned char* st, int pieces, int pass) {
    if (lane == 0) SPAN(2, 1);""", 1),
    ("""  const int batch = b0 / mb;
  while (pos < b1 && pieces < kLivePieces && free >= 4) {""",
     """  const long long t0 = clock64();
  const int batch = b0 / mb;
  while (pos < b1 && pieces < kLivePieces && free >= 4) {""", 1),
    ("""    break;
  }
}

// Stage whole batches""", """    break;
  }
  if (lane == 0) SPAN(1, clock64() - t0);
}

// Stage whole batches""", 1),
    ("""  const int tail_batch = n % mb ? n / mb : -1;""",
     """  const long long t0 = clock64();
  const int tail_batch = n % mb ? n / mb : -1;""", 1),
    ("""  return pos;
}""", """  if (lane == 0) SPAN(1, clock64() - t0);
  return pos;
}""", 1),
    ("""mbar_wait_or_trap(&full[s], parity);""",
     """const long long w0 = clock64();
      mbar_wait_or_trap(&full[s], parity);
      const long long c0 = clock64();
      if (threadIdx.x == 0) SPAN(3, c0 - w0);""", 2),
    ("""      if (threadIdx.x == 0) mbar_arrive(&empty[s]);""",
     """      if (threadIdx.x == 0) SPAN(4, clock64() - c0);
      if (threadIdx.x == 0) mbar_arrive(&empty[s]);""", 1),
    ("""    if (t == 0) mbar_arrive(&empty[s]);""",
     """    if (t == 0) SPAN(4, clock64() - c0);
    if (t == 0) mbar_arrive(&empty[s]);""", 1),
)


def instrumented_source() -> str:
    src = (CSRC / "glm_sgd_sparse.cu").read_text()
    for text, replacement, count in EDITS:
        found = src.count(text)
        if found != count:
            raise RuntimeError(f"found {found} of {count}: {text[:60]!r}")
        src = src.replace(text, replacement)
    return src + EPILOGUE


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    src = instrumented_source()
    OUT.mkdir(parents=True, exist_ok=True)
    name = hashlib.sha256(src.encode()).hexdigest()[:12]
    cu, lib = OUT / f"live_cycles-{name}.cu", OUT / f"live_cycles-{name}.so"
    if not lib.exists():
        cu.write_text(src)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
                        "-o", str(lib), str(cu)], check=True,
                       capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ell_sgd_epoch_live.argtypes = [P, P, P, P, P, I, I, I, I, I, I, F, F,
                                       I, I, I, P]
    dll.live_cycles_read.argtypes = [P]
    dll.live_cycles_reset.argtypes = []
    for fn in (dll.ell_sgd_epoch_live, dll.live_cycles_read,
               dll.live_cycles_reset):
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    from repro_torch.core import sgd
    from repro_torch.kernels.glm_sgd_sparse import ops
    from repro_torch.kernels.glm_sgd_sparse.ref import ell_sgd_epoch_ref

    if not torch.cuda.is_available():
        print("live_cycles: no CUDA device", file=sys.stderr)
        return 2
    dll = build()
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    sets, _ = cs.long_rows_sets(dev)
    for name, reps, mb in SHAPES:
        m, y = sets[name]
        parts = torch.from_numpy(sgd.partition_indices(m.shape[0], reps)).to(
            dev).long()
        vp, ip, yp = m.values[parts], m.indices[parts], y[parts]
        per, k = vp.shape[1:]
        smem_model = ops.variant(m.d, k, mb) == "live_smem"
        stages, words = ops.live_plan(m.d, mb, smem_model)
        lens = torch.empty(reps, per, dtype=torch.int32, device=dev)
        tail = per % mb
        step = cs.REALSIM_STEP if name == "real-sim" else cs.NEWS_STEP

        def call():
            W = torch.zeros(reps, m.d, device=dev)
            code = dll.ell_sgd_epoch_live(
                vp.data_ptr(), ip.data_ptr(), yp.data_ptr(), W.data_ptr(),
                lens.data_ptr(), reps, per, k, m.d, mb, 0, step / mb,
                step / tail if tail else 0.0, stages, words, int(smem_model),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"ell_sgd_epoch_live: cudaError {code}")
            return W

        err = cs.close(call(), ell_sgd_epoch_ref(
            "lr", torch.zeros(reps, m.d, device=dev), vp, ip, yp, step, mb),
            cs.EPOCH_TOL)
        dll.live_cycles_reset()
        call()
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 512)()
        dll.live_cycles_read(counts)
        sums = [sum(counts[b * 8 + i] for b in range(reps)) / reps
                for i in range(len(ROLES))]
        fills = sums[ROLES.index("fills")]
        ms = cs.cuda_ms(call, 3)
        print(json.dumps({
            "shape": f"{name} R={reps} per={per} K={k} MB={mb}",
            "kernel": "live_smem" if smem_model else "live_global",
            "plan": [stages, words], "fills_a_replica": fills,
            "cycles_a_fill": {role: total / fills for role, total in
                              zip(ROLES, sums) if role != "fills"},
            "ms": ms, "us_per_update": ms * 1e3 / -(-per // mb),
            "max_abs_err": err[0], "ok": err[1], "nvidia_smi": smi}),
            flush=True)
        del vp, ip
    return 0


if __name__ == "__main__":
    sys.exit(main())
