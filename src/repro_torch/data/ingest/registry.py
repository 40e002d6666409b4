"""Registry of the paper's five real datasets (Table 3); the port's copy of
the reference's registry (the same metadata, tested equal).

Each entry records the Table-3 statistics of the *full* dataset
(``n``/``d``/``avg_nnz``/``density``/``task``), the canonical LIBSVM
mirror URL, and parsing policy (label mapping, feature scaling).  The
registry is pure metadata — fetching and parsing live in
:mod:`repro_torch.data.ingest.cache` / :mod:`repro_torch.data.ingest.libsvm`.

Integrity hashes: entries whose ``sha256`` is ``None`` use
trust-on-first-use — the first gated download records the observed hash
next to the blob and every later read verifies against it.  Pin a hash
here once a blob is vetted.
"""
from __future__ import annotations

import dataclasses

LIBSVM_BINARY = ("https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/"
                 "datasets/binary/")


@dataclasses.dataclass(frozen=True)
class RealDatasetMeta:
    """Table-3 row + ingestion policy for one real dataset."""

    name: str
    n: int                  # full-dataset example count (Table 3)
    d: int                  # feature count (Table 3)
    avg_nnz: float          # average nonzeros/example (Table 3)
    max_nnz: int            # maximum nonzeros/example (Table 3)
    dense: bool             # dense access path (covtype, skin)
    task: str               # learning task the paper runs on it
    url: str                # canonical full-dataset source
    sha256: str | None      # pinned blob hash (None = trust-on-first-use)
    positive_label: float   # raw label mapped to +1 (everything else → -1)
    scale_features: bool    # apply §6.1 per-feature max-abs scaling

    @property
    def density(self) -> float:
        """Fraction of nonzero entries (Table 3's sparsity column)."""
        return self.avg_nnz / self.d


#: the paper's five real datasets (Table 3), keyed by study name
REAL_DATASETS: dict[str, RealDatasetMeta] = {
    "covtype": RealDatasetMeta(
        name="covtype", n=581_012, d=54, avg_nnz=54.0, max_nnz=54,
        dense=True, task="binary", positive_label=2.0, scale_features=True,
        url=LIBSVM_BINARY + "covtype.libsvm.binary.scale.bz2", sha256=None),
    "w8a": RealDatasetMeta(
        name="w8a", n=64_700, d=300, avg_nnz=11.65, max_nnz=114,
        dense=False, task="binary", positive_label=1.0, scale_features=False,
        url=LIBSVM_BINARY + "w8a", sha256=None),
    "real-sim": RealDatasetMeta(
        name="real-sim", n=72_309, d=20_958, avg_nnz=51.30, max_nnz=3_484,
        dense=False, task="binary", positive_label=1.0, scale_features=False,
        url=LIBSVM_BINARY + "real-sim.bz2", sha256=None),
    "news": RealDatasetMeta(
        name="news", n=19_996, d=1_355_191, avg_nnz=454.99, max_nnz=16_423,
        dense=False, task="binary", positive_label=1.0, scale_features=False,
        url=LIBSVM_BINARY + "news20.binary.bz2", sha256=None),
    "skin": RealDatasetMeta(
        name="skin", n=245_057, d=3, avg_nnz=3.0, max_nnz=3,
        dense=True, task="binary", positive_label=1.0, scale_features=True,
        url=LIBSVM_BINARY + "skin_nonskin", sha256=None),
}


def get(name: str) -> RealDatasetMeta:
    try:
        return REAL_DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown real dataset {name!r}; registered: "
            f"{tuple(REAL_DATASETS)}") from None
