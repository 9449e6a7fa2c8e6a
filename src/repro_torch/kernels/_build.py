"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain ``extern "C"`` interface.  It is
compiled with nvcc for Hopper (``sm_90a``), with ``kernels/include/`` (the
shared PTX helpers) on the include path, into a shared library under
``kernels/_build/`` at first use, keyed on a hash of the source, the shared
headers and the flags, and loaded with ``ctypes``.  No PyTorch headers are compiled, so a
build takes seconds.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[Path, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin: "
        "the CUDA kernels cannot be built"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its hashed library exists; returns the
    library path.  The nvcc log (with ``-Xptxas -v``'s registers, shared
    memory and spills) is kept beside the library as ``.log``."""
    source = Path(source).resolve()
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", tmp,
         str(source)],
        capture_output=True, text=True,
    )
    build_seconds[source.stem] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source).resolve()
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]
