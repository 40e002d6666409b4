"""Real-dataset ingestion: parser → cache → split/scale → ELL.

The paper's headline numbers (Tables 4–7) are measured on five real
datasets; this package makes them loadable behind the same
``Dataset``/``DatasetSpec`` surface the synthetic stand-ins use, with the
tensors on ``device`` (``cuda`` unless the caller says):

    >>> from repro_torch.data import ingest
    >>> ds = ingest.load("w8a", device="cpu")   # bundled fixture, offline
    >>> ds.n, ds.d, ds.dense
    (128, 300, False)
    >>> ingest.content_hash("w8a")              # keys the trial cache
    '...'

Resolution order for the raw bytes:

1. a verified blob in the content-addressed cache
   (``$REPRO_DATA_DIR``, populated only when ``REPRO_ALLOW_DOWNLOAD=1``
   — see :mod:`repro_torch.data.ingest.cache`);
2. the bundled miniature fixture (``fixtures/<name>.libsvm`` beside this
   module, byte for byte the reference's; overridable via
   ``$REPRO_FIXTURE_DIR``) so the tests stay hermetic.

Post-parse processing matches the paper's §6.1 protocol: labels map to
±1 via the registry's ``positive_label``, examples split 80/20
train/test by a seeded permutation, and dense sources get per-feature
max-abs scaling **fit on the train split only**.  Every load option
plus the raw-byte sha256 folds into :func:`content_hash`, which
``TrialSpec.key`` embeds — a changed source file changes every
downstream trial-cache key.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

import torch

from repro_torch.core import sparse as sparse_mod
from repro_torch.data import synthetic
from repro_torch.kernels import common
from repro_torch.obs import metrics, trace
from repro_torch.data.ingest import cache, libsvm, registry
from repro_torch.data.ingest.cache import (DownloadDisabledError,  # noqa: F401
                                           IntegrityError)
from repro_torch.data.ingest.registry import (  # noqa: F401
    REAL_DATASETS, RealDatasetMeta)

TRAIN_FRACTION = 0.8
SPLITS = ("train", "test", "all")

_parse_memo: dict[tuple, tuple[sparse_mod.CSRMatrix, np.ndarray]] = {}
_digest_memo: dict[str, str] = {}
_profile_memo: dict[tuple, tuple[int, int, float, bool]] = {}
_verified: set[str] = set()     # blobs integrity-checked this process


def clear_cache() -> None:
    """Drop in-process memos (tests that swap fixture/data dirs)."""
    _parse_memo.clear()
    _digest_memo.clear()
    _profile_memo.clear()
    _verified.clear()


# ---------------------------------------------------------------------------
# Source resolution
# ---------------------------------------------------------------------------


def fixture_dir() -> Path:
    override = os.environ.get("REPRO_FIXTURE_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parent / "fixtures"


def fixture_path(name: str) -> Path:
    registry.get(name)
    return fixture_dir() / f"{name}.libsvm"


def source_path(name: str) -> tuple[Path, str]:
    """(path, kind) of the best available raw bytes for ``name``.

    ``kind`` is ``"full"`` when a verified cached download exists,
    ``"fixture"`` otherwise.  Never touches the network itself — use
    :func:`fetch_full` (gated) to populate the blob cache.
    """
    meta = registry.get(name)
    blob, _ = cache._blob_paths(meta.url)
    if blob.exists():
        # verify once per process: every TrialSpec.key access lands here
        # via content_hash, and re-hashing a multi-hundred-MB blob per
        # trial would dominate a sweep
        if str(blob) not in _verified:
            with trace.span("ingest.verify", dataset=name):
                cache.verify(blob, expected=meta.sha256)
            _verified.add(str(blob))
        return blob, "full"
    fx = fixture_path(name)
    if not fx.exists():
        raise FileNotFoundError(
            f"no cached blob and no fixture for {name!r} (looked at "
            f"{blob} and {fx})")
    return fx, "fixture"


def fetch_full(name: str) -> Path:
    """Download + verify the full dataset (needs REPRO_ALLOW_DOWNLOAD=1)."""
    meta = registry.get(name)
    return cache.fetch(meta.url, sha256=meta.sha256)


def raw_digest(name: str) -> str:
    """sha256 of the resolved raw source bytes (memoized per path)."""
    path, _ = source_path(name)
    key = str(path)
    if key not in _digest_memo:
        _digest_memo[key] = cache.sha256_file(path)
    return _digest_memo[key]


# ---------------------------------------------------------------------------
# Content hashing (trial-cache keys)
# ---------------------------------------------------------------------------


def content_hash(name: str, *, split: str = "train",
                 max_n: int | None = None, seed: int = 0) -> str:
    """16-hex digest of (raw bytes, every load option).

    This is what distinguishes two runs named "w8a" whose underlying
    data differ — it keys the study trial cache for real datasets.
    """
    payload = {"ingest": 1, "raw": raw_digest(name), "split": split,
               "max_n": max_n, "seed": seed}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Load pipeline: parse → label map → split → scale → ELL/dense
# ---------------------------------------------------------------------------


def _parsed(name: str) -> tuple[sparse_mod.CSRMatrix, np.ndarray]:
    meta = registry.get(name)
    path, _ = source_path(name)
    key = (name, str(path), raw_digest(name))
    if key not in _parse_memo:
        metrics.counter("ingest.parse_memo.miss").inc()
        with trace.span("ingest.parse", dataset=name):
            _parse_memo[key] = libsvm.parse_file(path, d=meta.d)
    else:
        metrics.counter("ingest.parse_memo.hit").inc()
    return _parse_memo[key]


def split_rows(n: int, split: str, seed: int) -> np.ndarray:
    """Deterministic 80/20 row split (sorted for access locality)."""
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")
    if split == "all":
        return np.arange(n)
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(n * TRAIN_FRACTION)
    rows = perm[:n_train] if split == "train" else perm[n_train:]
    return np.sort(rows)


def feature_scales(csr: sparse_mod.CSRMatrix,
                   fit_rows: np.ndarray) -> np.ndarray:
    """Per-feature max-abs over ``fit_rows`` (1.0 for untouched features).

    Max-abs keeps zeros zero, so scaling never densifies a sparse
    matrix — the §6.1-compatible choice for libsvm-style data.
    """
    fit = csr.select(fit_rows)
    scales = np.zeros(csr.d, dtype=np.float32)
    np.maximum.at(scales, fit.indices, np.abs(fit.values))
    scales[scales == 0.0] = 1.0
    return scales


def _apply_scales(csr: sparse_mod.CSRMatrix,
                  scales: np.ndarray) -> sparse_mod.CSRMatrix:
    return csr._replace(values=(csr.values / scales[csr.indices])
                        .astype(np.float32))


def load(name: str, *, split: str = "train", max_n: int | None = None,
         seed: int = 0, device=None) -> synthetic.Dataset:
    """Materialize one real dataset as a study-engine ``Dataset``.

    Dense sources produce ``X [n, d]``; sparse sources produce the ELL
    layout from :mod:`repro_torch.core.sparse`, padded to the split's maximum
    row width — the paper's §5.2.1 format, so **no feature is ever
    dropped**.  That width is what makes full news/real-sim ELL large
    (see docs/DATASETS.md); cap memory with ``max_n``.  ``max_n`` caps
    rows *after* the split.  The returned dataset carries
    :func:`content_hash` in ``content_hash``.  Its tensors are on
    ``device`` (``cuda`` unless the caller says).
    """
    meta = registry.get(name)
    csr, raw_labels = _parsed(name)
    rows = split_rows(csr.n, split, seed)
    if max_n is not None:
        rows = rows[:max_n]
    y = np.where(raw_labels == meta.positive_label, 1.0, -1.0) \
        .astype(np.float32)[rows]
    sub = csr.select(rows)
    if meta.scale_features:
        scales = feature_scales(csr, split_rows(csr.n, "train", seed)
                                if split != "all" else np.arange(csr.n))
        sub = _apply_scales(sub, scales)
    chash = content_hash(name, split=split, max_n=max_n, seed=seed)
    dev = common.device(device)
    y_t = torch.from_numpy(y).to(dev)
    if meta.dense:
        return synthetic.Dataset(name=name,
                                 X=torch.from_numpy(sub.to_dense()).to(dev),
                                 ell=None, y=y_t, d=meta.d, dense=True,
                                 content_hash=chash)
    ell = sub.to_ell(device=dev)     # pads to the max row width: lossless
    return synthetic.Dataset(name=name, X=None, ell=ell, y=y_t, d=meta.d,
                             dense=False, content_hash=chash)


def profile(name: str, *, split: str = "train", max_n: int | None = None,
            seed: int = 0) -> tuple[int, int, float, bool]:
    """(n, d, avg_nnz, dense) derived from the parsed data (memoized).

    Unlike the synthetic path, the profile comes from what the parser
    actually produced — a truncated or swapped source file shows up
    here (and in :func:`content_hash`) instead of being papered over by
    registry metadata.
    """
    key = (name, split, max_n, seed, raw_digest(name))
    if key not in _profile_memo:
        meta = registry.get(name)
        csr, _ = _parsed(name)
        rows = split_rows(csr.n, split, seed)
        if max_n is not None:
            rows = rows[:max_n]
        sub = csr.select(rows)
        avg = float(meta.d) if meta.dense else sub.avg_nnz
        _profile_memo[key] = (sub.n, meta.d, avg, meta.dense)
    return _profile_memo[key]
