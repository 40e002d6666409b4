"""Content-addressed on-disk dataset cache with integrity hashes.

The port's copy of the reference's cache, with the same environment
variables and layout, so a blob one package fetched verifies for the other.

Layout (root = ``$REPRO_DATA_DIR``, default ``~/.cache/repro-sgd-data``)::

    <root>/blobs/<sha256-prefixed name>   raw downloaded files
    <root>/blobs/<name>.sha256            recorded hash (trust-on-first-use)

Network fetch is **disabled by default**: it runs only when
``REPRO_ALLOW_DOWNLOAD=1`` is set, so every tier-1 path stays hermetic
and resolves from the bundled fixtures instead
(:mod:`repro_torch.data.ingest.fixtures`).  Reads always re-hash the blob and
compare against the pinned registry hash (or the recorded first-use
hash) — a mismatch raises :class:`IntegrityError` rather than silently
training on corrupt data.
"""
from __future__ import annotations

import hashlib
import os
import urllib.parse
import urllib.request
from pathlib import Path


class DownloadDisabledError(RuntimeError):
    """Fetch requested while ``REPRO_ALLOW_DOWNLOAD`` is unset."""


class IntegrityError(RuntimeError):
    """A cached blob no longer matches its recorded/pinned sha256."""


def data_dir() -> Path:
    root = os.environ.get("REPRO_DATA_DIR")
    if root:
        return Path(root)
    return Path.home() / ".cache" / "repro-sgd-data"


def downloads_allowed() -> bool:
    return os.environ.get("REPRO_ALLOW_DOWNLOAD", "") == "1"


def sha256_file(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _blob_paths(url: str) -> tuple[Path, Path]:
    """(blob path, recorded-hash sidecar path) for one source URL."""
    fname = Path(urllib.parse.urlparse(url).path).name or "blob"
    blob = data_dir() / "blobs" / fname
    return blob, blob.with_name(blob.name + ".sha256")


def fetch(url: str, *, sha256: str | None = None) -> Path:
    """Return the verified local blob for ``url``, downloading if allowed.

    ``sha256`` pins the expected content hash (registry value).  When it
    is None, the hash observed on first download is recorded in a
    sidecar and later reads verify against that (trust-on-first-use).
    """
    blob, sidecar = _blob_paths(url)
    if not blob.exists():
        if not downloads_allowed():
            raise DownloadDisabledError(
                f"{blob.name} is not cached and downloads are disabled; "
                f"set REPRO_ALLOW_DOWNLOAD=1 to fetch {url} "
                f"(cache root: {data_dir()})")
        blob.parent.mkdir(parents=True, exist_ok=True)
        tmp = blob.with_name(blob.name + f".tmp.{os.getpid()}")
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as out:
            while True:
                block = r.read(1 << 20)
                if not block:
                    break
                out.write(block)
        digest = sha256_file(tmp)
        if sha256 is not None and digest != sha256:
            tmp.unlink()
            raise IntegrityError(
                f"downloaded {url}: sha256 {digest} != pinned {sha256}")
        tmp.replace(blob)
        sidecar.write_text(digest + "\n")
    return verify(blob, expected=sha256)


def verify(blob: Path, *, expected: str | None = None) -> Path:
    """Re-hash ``blob`` and check it against the pinned/recorded hash."""
    sidecar = blob.with_name(blob.name + ".sha256")
    digest = sha256_file(blob)
    pinned = expected
    if pinned is None and sidecar.exists():
        pinned = sidecar.read_text().strip()
    if pinned is None:           # nothing recorded yet: record now
        sidecar.write_text(digest + "\n")
        pinned = digest
    if digest != pinned:
        raise IntegrityError(
            f"{blob}: sha256 {digest} does not match recorded {pinned}; "
            f"delete the blob (and its .sha256 sidecar) to re-fetch")
    return blob
