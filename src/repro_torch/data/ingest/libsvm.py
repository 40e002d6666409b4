"""Streaming libsvm/svmlight parser → host-side CSR (no sklearn).

The format, one example per line::

    <label> [qid:<q>] <index>:<value> <index>:<value> ...  # comment

The port's own copy of the reference package's parser (it imports
nothing of that package); the rows and the CSR it builds are numpy, as
there.  Robustness rules:

* blank lines and ``#``-comment lines (full-line or trailing) are
  skipped / stripped;
* indices are 1-based per the libsvm convention unless a 0 index is
  observed anywhere (then the whole file is treated as 0-based);
  ``zero_based`` forces either reading;
* label-only rows are valid (an all-zero example);
* duplicate feature ids within a row are summed (the scatter-add
  semantics the repo's ELL layout applies to padded slots anyway);
* ``qid:`` tokens are ignored; arbitrary trailing whitespace is fine.

The parser is a generator over lines, so bz2-compressed full datasets
stream through :func:`parse_file` without materializing the text.
"""
from __future__ import annotations

import bz2
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core import sparse as sparse_mod


class LibsvmFormatError(ValueError):
    """A line that is not valid libsvm (bad token, negative index...)."""


def iter_rows(
    lines: Iterable[str],
) -> Iterator[tuple[float, np.ndarray, np.ndarray]]:
    """Yield ``(label, raw_indices, values)`` per example line.

    Indices are yielded exactly as written (base detection is a
    whole-file question — see :func:`parse_lines`); duplicates are
    already summed and indices sorted ascending.
    """
    for lineno, raw in enumerate(lines, 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        tokens = line.split()
        try:
            label = float(tokens[0])
        except ValueError:
            raise LibsvmFormatError(
                f"line {lineno}: bad label {tokens[0]!r}") from None
        idx, val = [], []
        for tok in tokens[1:]:
            if tok.startswith("qid:"):
                continue
            try:
                i_str, v_str = tok.split(":", 1)
                i, v = int(i_str), float(v_str)
            except ValueError:
                raise LibsvmFormatError(
                    f"line {lineno}: bad feature token {tok!r}") from None
            if i < 0:
                raise LibsvmFormatError(
                    f"line {lineno}: negative feature index {i}")
            idx.append(i)
            val.append(v)
        indices = np.asarray(idx, dtype=np.int64)
        values = np.asarray(val, dtype=np.float32)
        if len(indices):
            order = np.argsort(indices, kind="stable")
            indices, values = indices[order], values[order]
            uniq, inverse = np.unique(indices, return_inverse=True)
            if len(uniq) != len(indices):    # duplicate feature ids: sum
                summed = np.zeros(len(uniq), dtype=np.float32)
                np.add.at(summed, inverse, values)
                indices, values = uniq, summed
        yield label, indices, values


def parse_lines(
    lines: Iterable[str],
    *,
    d: int | None = None,
    zero_based: bool | None = None,
) -> tuple[sparse_mod.CSRMatrix, np.ndarray]:
    """Parse an entire stream into ``(CSRMatrix, raw_labels)``.

    ``d`` pins the feature-space width (the registry's Table-3 value —
    a subset file rarely touches the maximum feature id); None infers
    ``max_index + 1`` after base adjustment.  ``zero_based=None``
    auto-detects: libsvm is 1-based unless some row uses index 0.
    """
    labels: list[float] = []
    rows_idx: list[np.ndarray] = []
    rows_val: list[np.ndarray] = []
    saw_zero = False
    max_idx = -1
    for label, idx, val in iter_rows(lines):
        labels.append(label)
        rows_idx.append(idx)
        rows_val.append(val)
        if len(idx):
            saw_zero = saw_zero or int(idx[0]) == 0
            max_idx = max(max_idx, int(idx[-1]))
    base = (0 if saw_zero else 1) if zero_based is None else \
        (0 if zero_based else 1)
    if base == 1:
        if saw_zero:    # only reachable with forced zero_based=False
            raise LibsvmFormatError(
                "feature index 0 in a file forced to 1-based reading")
        rows_idx = [idx - 1 for idx in rows_idx]
        max_idx -= 1
    width = d if d is not None else max_idx + 1
    width = max(width, 1)
    if max_idx >= width:
        raise LibsvmFormatError(
            f"feature index {max_idx} out of range for d={width}")
    csr = sparse_mod.from_csr_parts(rows_idx, rows_val, width)
    return csr, np.asarray(labels, dtype=np.float32)


def parse_file(
    path: str | Path,
    *,
    d: int | None = None,
    zero_based: bool | None = None,
) -> tuple[sparse_mod.CSRMatrix, np.ndarray]:
    """Parse a (possibly bz2-compressed) libsvm file, streaming."""
    path = Path(path)
    opener = bz2.open if path.suffix == ".bz2" else open
    with opener(path, "rt") as f:
        return parse_lines(f, d=d, zero_based=zero_based)


def write_libsvm(
    path: str | Path,
    csr: sparse_mod.CSRMatrix,
    labels: np.ndarray,
    *,
    precision: int = 4,
) -> None:
    """Serialize CSR + labels back to 1-based libsvm text (fixtures)."""
    with open(path, "w") as f:
        for i in range(csr.n):
            idx, val = csr.row(i)
            feats = " ".join(
                f"{int(j) + 1}:{v:.{precision}g}" for j, v in zip(idx, val))
            label = int(labels[i]) if float(labels[i]).is_integer() \
                else labels[i]
            f.write(f"{label} {feats}".rstrip() + "\n")
