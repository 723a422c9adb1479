"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds); it may include the shared
headers ``csrc/*.cuh``.  The library is named by a content hash of its
source, the headers and the flags, built at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``), and
published with an atomic rename, so concurrent builds never interleave and
a stale build is never loaded.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_BIN = "/usr/local/cuda/bin"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's command line and its compiler output (registers, spills) per source
BUILD_LOG: dict[str, str] = {}


def find_nvcc() -> str:
    """nvcc on PATH, then in $CUDA_HOME/bin, then in /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(os.path.join(DEFAULT_CUDA_BIN, "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        f"{DEFAULT_CUDA_BIN}; the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """The library's path, named by a hash of the flags, ``<name>.cu`` and
    every header under ``csrc/`` (a source may include any of them)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    so = library_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, f"{name}.cu"),
           "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, tmp, cmd, proc


def _finish(name: str, job) -> None:
    so, tmp, cmd, proc = job
    out, _ = proc.communicate(timeout=600)
    BUILD_LOG[name] = " ".join(cmd) + "\n" + out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic publish


def build(names) -> None:
    """Build the named sources, one nvcc each, all started together."""
    jobs = {name: _start(name) for name in names}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]
