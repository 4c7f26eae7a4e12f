"""Build and load the native libraries of ``gsplat_tpu_torch/csrc``: the
hand-written CUDA kernels and the host C++ libraries (the COLMAP reader,
the JPEG and TIFF codecs).

Each source is a plain ``extern "C"`` translation unit.  At first use a
kernel (with the shared ``*.cuh`` headers beside it) is compiled with
``nvcc`` for Hopper (``sm_90a``), and a host ``*.cpp`` with the system
C++ compiler (``$CXX``, else ``c++``), into a shared library under
``gsplat_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the source, the headers, the flags and the compiler's resolved path, written
by an atomic rename, and
loaded with ``ctypes``.  A second process finds the library already built;
concurrent processes never load a half-written one; a changed source builds
anew.

There is no fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No --use_fast_math: the kernels call IEEE expf, and their tolerance
# against the plain PyTorch versions assumes it.  -Xptxas -v only reports
# registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# gsplat_tpu/native/Makefile's flags
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LIBS: dict = {}
# name -> {"path", "seconds" (0.0 when the library was already built), "log"}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of gsplat_tpu_torch are compiled from gsplat_tpu_torch/csrc at "
        "first use and need the CUDA toolkit")


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on
    PATH."""
    for exe in (os.environ.get("CXX"), "c++", "g++"):
        path = exe and shutil.which(exe)
        if path:
            return path
    raise RuntimeError(
        "no C++ compiler ($CXX, c++, g++): gsplat_tpu_torch's host libraries "
        "(the COLMAP reader, the JPEG and TIFF codecs) are compiled from "
        "gsplat_tpu_torch/csrc/*.cpp at first use")


def _build(name: str, src: Path, deps: bytes, flags, find) -> ctypes.CDLL:
    """Compile ``src`` unless a library of the same source, ``deps``,
    ``flags`` and compiler (the file ``find`` resolves to) is built, load
    it and record it in ``BUILD_INFO``."""
    compiler = find()
    digest = hashlib.sha256(
        src.read_bytes() + deps + " ".join(flags).encode()
        + os.path.realpath(compiler).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed (exit {proc.returncode}) building {src}:"
                f"\n{proc.stdout}{proc.stderr}")
        log_path.write_text(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: a concurrent process never sees
                                    # a half-written library
    lib = ctypes.CDLL(str(lib_path))
    BUILD_INFO[name] = {
        "path": str(lib_path), "seconds": seconds,
        "log": log_path.read_text() if log_path.exists() else ""}
    _LIBS[name] = lib
    return lib


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with nvcc if needed and return the loaded
    library.  Every launch calls this: once loaded, it touches no file."""
    if name not in _LIBS:
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC_DIR.glob("*.cuh")))
        _build(name, CSRC_DIR / f"{name}.cu", headers, NVCC_FLAGS, find_nvcc)
    return _LIBS[name]


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler if needed and
    return the loaded library."""
    if name not in _LIBS:
        _build(name, CSRC_DIR / f"{name}.cpp", b"", CXX_FLAGS, find_cxx)
    return _LIBS[name]
