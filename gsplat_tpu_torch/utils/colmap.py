"""COLMAP sparse-reconstruction readers (binary + text) and binary writers.

Functional parity with the reference readers (reference ``utils.py:111``
read_cameras_binary, ``:181`` read_images_binary, ``:259`` read_points3d_binary
and the text variants), re-written around whole-file buffers and
``struct.unpack_from`` instead of per-field ``fid.read`` calls — the reference
issues one syscall per scalar, which is slow for multi-million-point scenes.
The writers (``write_cameras_binary``, ``write_images_binary``,
``write_points3d_binary``) write the bytes of the JAX package's test-fixture
writers (``tests/fixtures.py:14-38``), which its scene generator uses.

A copy of ``gsplat_tpu/utils/colmap.py`` (numpy only; the JAX package's
``utils`` ``__init__`` imports jax, so the port keeps its own).
``read_points3d_arrays`` parses ``points3D.bin`` with the port's native C++
reader, ``csrc/colmap_reader.cpp`` (a copy of the JAX package's), built at
first use with the system C++ compiler into ``gsplat_tpu_torch/_build/``
(``ops/cuda_build.load_host_library``) and loaded through ctypes; a failed
build raises.  ``read_points3d_binary``, which returns the tracks the native
reader skips, parses in Python.

File formats follow COLMAP ``src/base/reconstruction.cc``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Union

import numpy as np

_PathT = Union[str, Path]


@dataclass(frozen=True)
class CameraModel:
    model_id: int
    model_name: str
    num_params: int


@dataclass(frozen=True)
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass(frozen=True)
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


@dataclass(frozen=True)
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


# COLMAP camera model table (reference utils.py:55-67).
CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}

# Camera models whose params start with a SINGLE focal (f, cx, cy, ...):
# fx = fy = params[0].  All remaining models lead with (fx, fy, ...).
# The reference reads params[0]/params[1] as fx/fy unconditionally
# (splatter.py:499-500), which silently treats a SIMPLE_RADIAL's cx as fy;
# we extract per-model instead.
_SINGLE_FOCAL_MODELS = frozenset({
    "SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL", "FOV",
    "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
})


def camera_focals(cam: Camera) -> tuple:
    """(fx, fy) in pixels for any COLMAP camera model."""
    if cam.model in _SINGLE_FOCAL_MODELS:
        return float(cam.params[0]), float(cam.params[0])
    return float(cam.params[0]), float(cam.params[1])


def read_cameras_binary(path: _PathT) -> Dict[int, Camera]:
    buf = Path(path).read_bytes()
    (n_cameras,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras: Dict[int, Camera] = {}
    for _ in range(n_cameras):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        model = CAMERA_MODEL_IDS[model_id]
        params = np.frombuffer(buf, dtype="<f8", count=model.num_params, offset=off)
        off += 8 * model.num_params
        cameras[cam_id] = Camera(
            id=cam_id, model=model.model_name, width=width, height=height,
            params=np.asarray(params),
        )
    assert len(cameras) == n_cameras
    return cameras


def read_images_binary(path: _PathT) -> Dict[int, ColmapImage]:
    buf = Path(path).read_bytes()
    (n_images,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images: Dict[int, ColmapImage] = {}
    for _ in range(n_images):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        image_id = vals[0]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        camera_id = vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (n_pts2d,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(buf, dtype="<f8", count=3 * n_pts2d, offset=off
                            ).reshape(n_pts2d, 3)
        xys = rec[:, :2].copy()
        point3D_ids = rec[:, 2].view("<i8").copy()
        off += 24 * n_pts2d
        images[image_id] = ColmapImage(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
            name=name, xys=xys, point3D_ids=point3D_ids,
        )
    return images


def _read_points3d_binary_python(buf: bytes) -> Dict[int, Point3D]:
    (n_points,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    points: Dict[int, Point3D] = {}
    header = struct.Struct("<QdddBBBd")
    for _ in range(n_points):
        pid, x, y, z, r, g, b, err = header.unpack_from(buf, off)
        off += header.size
        (track_len,) = struct.unpack_from("<Q", buf, off)
        off += 8
        track = np.frombuffer(buf, dtype="<i4", count=2 * track_len, offset=off
                              ).reshape(track_len, 2)
        off += 8 * track_len
        points[pid] = Point3D(
            id=pid,
            xyz=np.array([x, y, z]),
            rgb=np.array([r, g, b]),
            error=err,
            image_ids=track[:, 0].copy(),
            point2D_idxs=track[:, 1].copy(),
        )
    return points


def read_points3d_binary(path: _PathT) -> Dict[int, Point3D]:
    return _read_points3d_binary_python(Path(path).read_bytes())


def read_points3d_arrays(path: _PathT):
    """(pos [N,3] f32, rgb [N,3] u8) of a ``points3D.bin`` through the
    native reader, without per-point dicts; raises on a malformed file.

    The training pipeline only consumes xyz+rgb (reference splatter.py:373-381
    loops the dict but only reads .xyz/.rgb); this avoids building N Python
    objects for multi-million point scenes.
    """
    arrays = _native_points3d_arrays(Path(path).read_bytes())
    if arrays is None:
        raise ValueError(f"{path}: not a COLMAP points3D.bin (truncated or "
                         "malformed)")
    return arrays


# ---------------------------------------------------------------------------
# binary writers (the layouts the readers above parse)
# ---------------------------------------------------------------------------

def write_cameras_binary(path: _PathT, cam_id: int, w: int, h: int,
                         fx: float, fy: float):
    """One PINHOLE camera (model id 1: fx, fy, cx = w/2, cy = h/2)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", cam_id, 1, w, h))
        f.write(struct.pack("<dddd", fx, fy, w / 2, h / 2))


def write_images_binary(path: _PathT, poses, cam_id: int):
    """``poses``: a list of (qvec wxyz, tvec, name), ids from 1, all on
    camera ``cam_id``, without 2-D points."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (q, t, name) in enumerate(poses):
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: _PathT, xyz, rgb):
    """Points with ids from 1, error 0.5 and a track of two entries (images
    1 and 2 at point index i), as the JAX package's fixtures write them."""
    head = struct.Struct("<QdddBBBd")
    track = struct.Struct("<Qiiii")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(b"".join(head.pack(i + 1, *p, *c, 0.5)
                         + track.pack(2, 1, i, 2, i)
                         for i, (p, c) in enumerate(zip(xyz, rgb))))


# ---------------------------------------------------------------------------
# text variants (reference utils.py:85-108, 144-178, 227-256)
# ---------------------------------------------------------------------------

def _data_lines(path: _PathT):
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: _PathT) -> Dict[int, Camera]:
    cameras: Dict[int, Camera] = {}
    for line in _data_lines(path):
        elems = line.split()
        cam_id = int(elems[0])
        cameras[cam_id] = Camera(
            id=cam_id, model=elems[1], width=int(elems[2]), height=int(elems[3]),
            params=np.array([float(v) for v in elems[4:]]),
        )
    return cameras


def read_images_text(path: _PathT) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    lines = list(_data_lines(path))
    for head, pts in zip(lines[0::2], lines[1::2]):
        elems = head.split()
        image_id = int(elems[0])
        pt = pts.split()
        xys = np.array([[float(x), float(y)] for x, y in zip(pt[0::3], pt[1::3])])
        xys = xys.reshape(-1, 2)
        images[image_id] = ColmapImage(
            id=image_id,
            qvec=np.array([float(v) for v in elems[1:5]]),
            tvec=np.array([float(v) for v in elems[5:8]]),
            camera_id=int(elems[8]),
            name=elems[9],
            xys=xys,
            point3D_ids=np.array([int(v) for v in pt[2::3]], dtype=np.int64),
        )
    return images


def read_points3d_text(path: _PathT) -> Dict[int, Point3D]:
    points: Dict[int, Point3D] = {}
    for line in _data_lines(path):
        elems = line.split()
        pid = int(elems[0])
        points[pid] = Point3D(
            id=pid,
            xyz=np.array([float(v) for v in elems[1:4]]),
            rgb=np.array([int(v) for v in elems[4:7]]),
            error=float(elems[7]),
            image_ids=np.array([int(v) for v in elems[8::2]]),
            point2D_idxs=np.array([int(v) for v in elems[9::2]]),
        )
    return points


def read_model(sparse_dir: _PathT):
    """Read (cameras, images, points) from a COLMAP sparse dir, preferring
    binary files, falling back to text (parity with COLMAP conventions)."""
    sparse_dir = Path(sparse_dir)
    if (sparse_dir / "cameras.bin").exists():
        return (
            read_cameras_binary(sparse_dir / "cameras.bin"),
            read_images_binary(sparse_dir / "images.bin"),
            read_points3d_binary(sparse_dir / "points3D.bin"),
        )
    return (
        read_cameras_text(sparse_dir / "cameras.txt"),
        read_images_text(sparse_dir / "images.txt"),
        read_points3d_text(sparse_dir / "points3D.txt"),
    )


# ---------------------------------------------------------------------------
# native (C++) fast path
# ---------------------------------------------------------------------------

def _load_native():
    """The port's native reader (``csrc/colmap_reader.cpp``), built at first
    use; raises when it cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("colmap_reader")
    lib.count_points3d.restype = ctypes.c_longlong
    lib.count_points3d.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.parse_points3d.restype = ctypes.c_int
    lib.parse_points3d.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
    ]
    return lib


def _native_points3d_arrays(buf: bytes):
    """(pos (N, 3) f32, rgb (N, 3) u8) of a ``points3D.bin`` buffer, or None
    when the buffer is malformed."""
    import ctypes

    lib = _load_native()
    n = lib.count_points3d(buf, len(buf))
    if n < 0:
        return None
    pos = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    ids = np.empty((n,), np.int64)
    ok = lib.parse_points3d(
        buf, len(buf),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if ok != 0:
        return None
    return pos, rgb
