"""Build the port's CUDA sources with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
nvcc builds it in seconds into ``<repo>/.torch_ext/<name>-<hash>.so``; the
hash covers the source, the ``csrc/*.h`` headers and the flags, so an
edited source or header is rebuilt. The
library is loaded with ctypes. A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels cannot be built")
    return path


def library_path(name: str, source: Path | None = None) -> Path:
    """The library's path; its hash covers the source, the headers beside it
    and the flags."""
    source = CSRC / f"{name}.cu" if source is None else source
    parts = [source.read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.h"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str, source: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``source``, a library named ``name``)
    unless it is built already; returns the shared library's path. The
    compiler's output (registers, shared memory, spills) is kept beside it
    in ``<so>.log``."""
    source = CSRC / f"{name}.cu" if source is None else Path(source)
    so = library_path(name, source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    Path(str(so) + ".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed:\n{name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build sees a whole file
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
