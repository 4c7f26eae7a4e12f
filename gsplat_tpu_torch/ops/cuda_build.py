"""Build and load the hand-written CUDA kernels of ``gsplat_tpu_torch/csrc``.

Each kernel source is a plain ``extern "C"`` translation unit (with the
shared ``*.cuh`` headers beside it).  At first use it is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``gsplat_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the source, the headers and the flags, and loaded with ``ctypes``.  A second
process finds the library already built; a changed source builds anew.

There is no fallback: a missing ``nvcc`` or a failed build raises.
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


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {src}:\n"
                f"{proc.stdout}{proc.stderr}")
        log_path.write_text(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: a concurrent process never sees
                                    # a half-written library
    lib = ctypes.CDLL(str(lib_path))
    BUILD_INFO[name] = {
        "path": str(lib_path), "seconds": seconds,
        "log": log_path.read_text() if log_path.exists() else ""}
    _LIBS[name] = lib
    return lib
