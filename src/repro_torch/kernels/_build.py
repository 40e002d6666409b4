"""Build the hand-written kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/repro_torch_kernels/<name>-<hash>.so`` at the repository
root (a directory ``.gitignore`` lists), named by a hash of its source so an
edited kernel is rebuilt.  Nothing is prebuilt: the first call that needs a
kernel compiles it, and :func:`build_all` compiles every source at once, one
``nvcc`` process each, all started together.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code, so a launch the card refuses never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: typed C entry points by (library, name): typed once, not on every launch
_FUNCTIONS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "cuda kernels are compiled from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of the
    source and of the shared headers, so an edit to either rebuilds it."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every missing library in parallel; returns ptxas reports.

    Raises ``RuntimeError`` with the compiler's output when one fails.
    """
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{reports[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def function(lib: str, name: str, *argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``csrc/<lib>.cu``, typed: pointers and
    the stream as ``c_void_p``, returning the CUDA error code as ``int``.
    Typed on the first call and cached: a launch pays one dict lookup."""
    fn = _FUNCTIONS.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(lib, name)] = fn
    return fn


def check(kernel: str, code: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code:
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}")
