"""The port's native COLMAP reader (``gsplat_tpu_torch/csrc/colmap_reader.cpp``,
built by ``ops/cuda_build.load_host_library``) against the port's Python
parser and the JAX package's ``read_points3d_arrays``, on the CPU.

The port builds and loads its own library under ``gsplat_tpu_torch/_build/``;
nothing here needs ``gsplat_tpu/native/libcolmap_reader.so``, and the
loader is checked to open no path of the JAX package.
"""

import ctypes
import multiprocessing as mp
import struct

import numpy as np
import pytest

from gsplat_tpu.utils.colmap import read_points3d_arrays as j_read_arrays

from gsplat_tpu_torch.ops import cuda_build
from gsplat_tpu_torch.utils import colmap


def _points3d_bytes(n, seed=0, max_track=5):
    """A ``points3D.bin`` of ``n`` random points with tracks of 0 …
    ``max_track`` entries, and its (xyz f64, rgb u8)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, 10, (n, 3))
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    out = [struct.pack("<Q", n)]
    for i in range(n):
        out.append(struct.pack("<QdddBBBd", 7 * i + 1, *xyz[i], *rgb[i],
                               float(rng.random())))
        t = int(rng.integers(0, max_track + 1))
        out.append(struct.pack("<Q", t))
        out.append(rng.integers(0, 1000, 2 * t).astype("<i4").tobytes())
    return b"".join(out), xyz, rgb


@pytest.mark.parametrize("n", [0, 1, 333, 5000])
def test_native_matches_python_and_jax(tmp_path, n):
    buf, xyz, rgb = _points3d_bytes(n, seed=n)
    path = tmp_path / "points3D.bin"
    path.write_bytes(buf)
    pos_n, rgb_n = colmap.read_points3d_arrays(path)
    assert pos_n.dtype == np.float32 and rgb_n.dtype == np.uint8
    assert pos_n.shape == rgb_n.shape == (n, 3)
    # the native reader narrows the file's doubles to f32 as a cast does
    np.testing.assert_array_equal(pos_n, xyz.astype(np.float32))
    np.testing.assert_array_equal(rgb_n, rgb)
    pts = colmap.read_points3d_binary(path)
    if n:
        np.testing.assert_array_equal(
            pos_n, np.stack([p.xyz for p in pts.values()]).astype(np.float32))
        np.testing.assert_array_equal(
            rgb_n, np.stack([p.rgb for p in pts.values()]))
    pos_j, rgb_j = j_read_arrays(path)
    np.testing.assert_array_equal(pos_n, np.asarray(pos_j, np.float32))
    np.testing.assert_array_equal(rgb_n, rgb_j)


@pytest.mark.parametrize("cut", ["header", "record", "track", "count"])
def test_native_rejects_truncated(tmp_path, cut):
    buf, _, _ = _points3d_bytes(3, seed=1, max_track=0)
    rec = (len(buf) - 8) // 3                     # 51 bytes a point
    bad = {"header": buf[:5],
           "record": buf[:8 + rec + 20],
           "track": buf[:8 + rec - 4],
           "count": struct.pack("<Q", 4) + buf[8:]}[cut]
    assert colmap._native_points3d_arrays(bad) is None
    path = tmp_path / "points3D.bin"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match="malformed"):
        colmap.read_points3d_arrays(path)
    # a track longer than the buffer
    long_track = buf[:8 + 43] + struct.pack("<Q", 1 << 40)
    assert colmap._native_points3d_arrays(
        struct.pack("<Q", 1) + long_track[8:]) is None


def _fresh_build(monkeypatch, build_dir):
    """Point the build at ``build_dir`` and forget the loaded library."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build_dir)
    monkeypatch.delitem(cuda_build._LIBS, "colmap_reader", raising=False)


def test_loader_builds_its_own_library(tmp_path, monkeypatch):
    opened, ran = [], []
    cdll, run = ctypes.CDLL, cuda_build.subprocess.run

    def record_cdll(name, *a, **kw):
        opened.append(str(name))
        return cdll(name, *a, **kw)

    def record_run(cmd, *a, **kw):
        ran.append([str(c) for c in cmd])
        return run(cmd, *a, **kw)

    monkeypatch.setattr(ctypes, "CDLL", record_cdll)
    monkeypatch.setattr(cuda_build.subprocess, "run", record_run)
    _fresh_build(monkeypatch, tmp_path / "_build")
    lib = colmap._load_native()
    assert lib.count_points3d(struct.pack("<Q", 0), 8) == 0
    info = cuda_build.BUILD_INFO["colmap_reader"]
    assert info["seconds"] > 0 and len(ran) == 1
    src = str(cuda_build.CSRC_DIR / "colmap_reader.cpp")
    assert src in ran[0] and all(f in ran[0] for f in cuda_build.CXX_FLAGS)
    # the library is keyed by the source's and flags' hash, renamed into
    # place whole (no temporary left), and the only library loaded
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert built == [f"libcolmap_reader-{info['path'][-19:-3]}.log",
                     f"libcolmap_reader-{info['path'][-19:-3]}.so"]
    assert opened == [info["path"]]
    for path in opened + [c for cmd in ran for c in cmd]:
        assert "/gsplat_tpu/" not in path, path
    # a second process (here: a cleared cache) finds it built
    monkeypatch.delitem(cuda_build._LIBS, "colmap_reader")
    colmap._load_native()
    assert cuda_build.BUILD_INFO["colmap_reader"]["seconds"] == 0.0
    assert len(ran) == 1


def test_changed_compiler_builds_anew(tmp_path, monkeypatch):
    # the library is keyed by the compiler too: another compiler file (here
    # a wrapper of the same one) builds its own library beside the first
    _fresh_build(monkeypatch, tmp_path / "_build")
    first = colmap._load_native()
    path0 = cuda_build.BUILD_INFO["colmap_reader"]["path"]
    wrapper = tmp_path / "cxx"
    wrapper.write_text(f"#!/bin/sh\nexec {cuda_build.find_cxx()} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_cxx", lambda: str(wrapper))
    monkeypatch.delitem(cuda_build._LIBS, "colmap_reader")
    second = colmap._load_native()
    info = cuda_build.BUILD_INFO["colmap_reader"]
    assert info["path"] != path0 and info["seconds"] > 0
    assert str(wrapper) in info["log"]
    for lib in (first, second):
        assert lib.count_points3d(struct.pack("<Q", 0), 8) == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "find_cxx", lambda: "false")
    buf, _, _ = _points3d_bytes(4)
    path = tmp_path / "points3D.bin"
    path.write_bytes(buf)
    # no silent switch to the Python parser
    with pytest.raises(RuntimeError, match="colmap_reader.cpp"):
        colmap.read_points3d_arrays(path)


def _build_in(build_dir):
    from gsplat_tpu_torch.ops import cuda_build as cb

    cb.BUILD_DIR = build_dir
    lib = cb.load_host_library("colmap_reader")
    return int(lib.count_points3d(struct.pack("<Q", 0), 8))


def test_concurrent_builds_load_whole_libraries(tmp_path):
    # processes building into one directory at once each write their own
    # temporary and rename it: all of them load a whole library
    ctx = mp.get_context("spawn")
    with ctx.Pool(3) as pool:
        assert pool.map(_build_in, [tmp_path] * 3) == [0, 0, 0]
    assert [p.suffix for p in sorted(tmp_path.iterdir())] == [".log", ".so"]
