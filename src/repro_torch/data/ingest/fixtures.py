"""Deterministic miniature fixtures for the five real datasets.

The container builds offline, so the bundled fixtures are **not**
subsets of the downloaded files: they are seeded miniatures written in
the exact libsvm wire format of each source, matching its Table-3
shape — same feature-space width ``d``, same average row density, same
raw label alphabet (covtype/skin ship {1,2} labels, the text datasets
ship ±1), dense rows written densely.  Parsing a fixture therefore
exercises every code path the full download does (label mapping, base
detection, scaling, ELL conversion) while keeping tier-1 hermetic.

The port ships its own copy of the five files beside this module, byte
for byte the reference's.  Regenerate with::

    PYTHONPATH=src python -m repro_torch.data.ingest.fixtures

which rewrites ``src/repro_torch/data/ingest/fixtures/<name>.libsvm``
byte-identically (fixed seeds, fixed float precision).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.core import sparse as sparse_mod
from repro_torch.data.ingest import libsvm, registry

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"

#: fixture example counts — sized so the 80% train split is a power of
#: two (friendly to replica partitioning in the study engine)
FIXTURE_ROWS = {
    "covtype": 160, "w8a": 160, "real-sim": 160, "news": 48, "skin": 320,
}


def _row_nnz(rng, n: int, avg: float, lo: int, hi: int) -> np.ndarray:
    """Long-tailed nnz/row counts whose mean hits ``avg`` exactly."""
    counts = np.clip(rng.lognormal(np.log(max(avg, 1.5)), 0.8, size=n),
                     lo, hi).astype(np.int64)
    target = int(round(avg * n))
    i = 0
    while counts.sum() != target:      # nudge rows within [lo, hi] bounds
        delta = 1 if counts.sum() < target else -1
        j = i % n
        if lo <= counts[j] + delta <= hi:
            counts[j] += delta
        i += 1
    return counts


def make_fixture(name: str, seed: int | None = None):
    """(CSRMatrix, raw_labels) miniature for one registered dataset."""
    meta = registry.get(name)
    n = FIXTURE_ROWS[name]
    rng = np.random.default_rng(
        seed if seed is not None else sum(map(ord, name)))
    d = meta.d
    w_star = None
    if meta.dense:
        X = rng.uniform(0.0, 1.0, size=(n, d)).astype(np.float32)
        if name == "skin":               # raw RGB bytes, like the source
            X = np.floor(X * 256).clip(0, 255)
        rows_idx = [np.arange(d, dtype=np.int64)] * n
        rows_val = [X[i] for i in range(n)]
        w_star = rng.normal(0, 1, size=d).astype(np.float32)
        margins = (X - X.mean(axis=0)) @ w_star
    else:
        cap = min(meta.max_nnz, max(int(meta.avg_nnz * 4), 8))
        nnz = _row_nnz(rng, n, meta.avg_nnz, 1, cap)
        ranks = np.arange(1, d + 1, dtype=np.float64)
        probs = (1.0 / ranks) / (1.0 / ranks).sum()
        w_star = (rng.normal(0, 1, size=d) / np.sqrt(ranks)).astype(np.float32)
        rows_idx, rows_val, margins = [], [], np.zeros(n)
        for i in range(n):
            idx = np.sort(rng.choice(d, size=int(nnz[i]), replace=False,
                                     p=probs))
            val = rng.normal(0, 1, size=len(idx)).astype(np.float32)
            rows_idx.append(idx.astype(np.int64))
            rows_val.append(val)
            margins[i] = float(val @ w_star[idx])
    # planted labels with 5% flip noise, written in the raw alphabet:
    # dense sources (covtype, skin) use {1, 2}, the text sources use ±1
    y = np.where(margins >= np.median(margins), 1.0, -1.0)
    flip = rng.random(n) < 0.05
    y[flip] *= -1.0
    if meta.dense:
        raw = np.where(y > 0, meta.positive_label, 3.0 - meta.positive_label)
    else:
        raw = np.where(y > 0, 1.0, -1.0)
    csr = sparse_mod.from_csr_parts(rows_idx, rows_val, d)
    return csr, raw.astype(np.float32)


def write_all(out_dir: Path = FIXTURE_DIR) -> list[Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for name in registry.REAL_DATASETS:
        csr, raw = make_fixture(name)
        path = out_dir / f"{name}.libsvm"
        libsvm.write_libsvm(path, csr, raw)
        written.append(path)
        print(f"wrote {path} ({csr.n} rows, {csr.nnz} nnz, "
              f"avg {csr.avg_nnz:.2f})")
    return written


if __name__ == "__main__":
    write_all()
