"""Packaging + native extension build.

Counterpart of the reference's CUDAExtension setup (``setup.py:1-52`` builds
the ``gaussian`` pybind module with nvcc).  Here the TPU compute path needs
no extension (Pallas kernels compile at trace time); the native piece is the
host-side C++ COLMAP parser, built as a plain shared library loaded via
ctypes (pybind11 is deliberately avoided — no binary Python ABI coupling).

``python setup.py build_native`` or ``pip install -e .`` both build it;
the package degrades gracefully to the pure-Python parser without it.
"""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

NATIVE_DIR = Path(__file__).parent / "gsplat_tpu" / "native"


def build_native_lib():
    subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True)


class BuildNative(Command):
    description = "build the native COLMAP reader shared library"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        build_native_lib()


class BuildPyWithNative(build_py):
    def run(self):
        try:
            build_native_lib()
        except Exception as e:  # toolchain-less installs still work
            print(f"warning: native colmap reader not built ({e}); "
                  "pure-python fallback will be used")
        super().run()


setup(
    name="gsplat-tpu",
    version="0.1.0",
    description="TPU-native 3D Gaussian Splatting (JAX/XLA/Pallas)",
    packages=find_packages(include=["gsplat_tpu", "gsplat_tpu.*",
                                    "gsplat_tpu_torch*"]),
    package_data={"gsplat_tpu.native": ["*.so", "*.cpp", "Makefile"],
                  "gsplat_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "opencv-python"],
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
)
