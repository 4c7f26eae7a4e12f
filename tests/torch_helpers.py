"""Shared image-space scenes and a fake viser server for the
gsplat_tpu_torch tests (no JAX here: the card tests and ``chip_smoke.py``
import this file).

``image_space_pairs`` lives in ``gsplat_tpu_torch.synthetic`` so that
``chip_smoke.py`` checks the kernels on the same scenes as the tests.
"""

import numpy as np

from gsplat_tpu_torch.synthetic import image_space_pairs  # noqa: F401
from gsplat_tpu_torch.synthetic import image_space_sh

TILE = 16
# a crowd whose tile holds more than 256 pairs: six staged batches of
# either kernel
BIG_CROWD = dict(n=640, crowd=320)
# csrc/rasterize_bwd.cu stages kBatch = 64 pairs at a time and sums them in
# rounds of kSub = 32; csrc/rasterize_fwd.cu stages kBatch = 64 pairs too
BWD_BATCH, BWD_ROUND = 64, 32
FWD_BATCH = 64
# pairs per tile of ragged_pairs' 2 x 2 grid: one pair, one more than a
# staged batch (of either kernel), none, one more than a round
RAGGED_COUNTS = (1, BWD_BATCH + 1, 0, BWD_ROUND + 1)


def ragged_pairs(seed, tile, focal=40.0, sh=False):
    """Pairs already grouped by tile (the layout of ``pack_sorted``'s
    output): ``RAGGED_COUNTS[t]`` gaussians centred inside tile t of a
    2 x 2 grid of ``tile``-px tiles, 0.8-4 px wide (scaled by
    ``tile / 16``).
    → ``(geom (P, 8), color (P, 3) or SH (P, 27), tile_start (5,) int32,
    geo, sh_vecs (4, 3) or None)``, numpy."""
    rng = np.random.default_rng(seed)
    s = tile / 16
    n = sum(RAGGED_COUNTS)
    t = np.repeat(np.arange(len(RAGGED_COUNTS)), RAGGED_COUNTS)
    px = (t % 2 + rng.uniform(0.1, 0.9, n)) * tile
    py = (t // 2 + rng.uniform(0.1, 0.9, n)) * tile
    sig = rng.uniform(0.8, 4.0, (n, 2)) * s
    theta = rng.uniform(0, np.pi, n)
    ct, st = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([ct, -st], -1), np.stack([st, ct], -1)], -2)
    cov = np.einsum("nij,nj,nkj->nik", rot, (sig / focal) ** 2, rot)
    mean2d = np.stack([(px - tile) / focal, (py - tile) / focal], 1)
    geom = np.concatenate([mean2d, cov.reshape(n, 4),
                           rng.uniform(0.05, 0.99, (n, 1)),
                           np.zeros((n, 1))], 1).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tile_start = np.concatenate([[0], np.cumsum(RAGGED_COUNTS)]).astype(
        np.int32)
    geo = dict(n_tile_x=2, n_tile_y=2, tile_len_x=tile / focal,
               tile_len_y=tile / focal, leftmost=-tile / focal,
               topmost=-tile / focal)
    shv = None
    if sh:
        color, shv = image_space_sh(seed, color, geo, focal, tile=tile)
    return geom, color, tile_start, geo, shv


def bbox_boundary_rows(seed, n=20000):
    """Rows of ``_tile_bbox_rows`` ("dist" culling, a fixed radius) whose
    four box edges fall within a few ulps of a tile boundary of the bench
    grid (82 x 53 tiles of 16 / 1000): (spec fields, cx, cy, a, b, c, d,
    visible), f32.  A quotient just below a whole number floors one tile
    lower than its neighbour just above, so a division that rounds
    differently moves the box."""
    rng = np.random.default_rng(seed)
    geo = dict(n_tile_x=82, n_tile_y=53, tile_len_x=0.016, tile_len_y=0.016,
               leftmost=-0.6485, topmost=-0.42, method="dist",
               thresh=0.0004)
    r = np.float32(np.sqrt(geo["thresh"]))

    def centres(left, n_tiles):
        k = rng.integers(1, n_tiles - 2, n)
        edge = (k * np.float64(0.016) + left + r).astype(np.float32)
        steps = rng.integers(-4, 5, n)
        for s in (-1, 1):               # a few ulps either way
            for _ in range(4):
                edge = np.where(steps * s > 0, np.nextafter(
                    edge, np.float32(s * np.inf)), edge)
                steps = steps - s * (steps * s > 0)
        return edge

    cx, cy = centres(geo["leftmost"], 82), centres(geo["topmost"], 53)
    cov = rng.uniform(1e-6, 1e-5, (4, n)).astype(np.float32)
    cov[1:3] = 0.0
    return geo, cx, cy, *cov, np.ones(n, bool)


DIVISION_SITES = ("ground_truth", "adam", "split_scale", "sh_init")


def division_rows(site):
    """The operands of one division the port makes on the card by a Python
    number (or a CPU scalar) → (x, y): ``x`` a float32 array, ``y`` the
    divisor as the site has it.  Shared by the CPU test that shows a
    reciprocal multiply moves these rows
    (``test_torch_binning.py::test_divisions_differ_under_a_reciprocal``)
    and the card test that holds the port's site to the CPU bit for bit
    (``test_torch_cuda.py::test_divisions_on_cuda_match_cpu``)."""
    rng = np.random.default_rng(7)
    if site == "ground_truth":           # every 8-bit value, / 255
        return np.arange(256, dtype=np.float32), 255.0
    if site == "adam":                   # mu after t steps, / (1 - 0.9^t)
        t = 3
        return (rng.normal(0, 1e-3, 4096).astype(np.float32),
                float(np.float32(1.0) - np.float32(0.9) ** np.float32(t)))
    if site == "split_scale":            # gaussian scales, / 1.6
        return rng.uniform(1e-3, 0.3, 3 * 4096).astype(np.float32), 1.6
    if site == "sh_init":                # color logits, / C0
        from gsplat_tpu_torch.ops.sh import C0
        return rng.normal(0, 2.0, 3 * 4096).astype(np.float32), C0
    raise ValueError(site)


def assert_close_cols(a, b, atol_frac, rtol, what=""):
    """|a − b| ≤ atol_frac·colmax(b) + rtol·|b|, column by column: gradients
    of the focal-normalised covariance reach ~1e3 on these scenes while
    other entries sum to ~0 over a tile, so an absolute tolerance is stated
    as a fraction of each column's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bound = atol_frac * np.abs(b).max(axis=0, keepdims=True) \
        + rtol * np.abs(b)
    worst = (np.abs(a - b) / np.maximum(bound, 1e-30)).max()
    assert (np.abs(a - b) <= bound).all(), f"{what}: {worst:.3g} x bound"


# ---- a fake viser server (tests/test_viewer.py:97-171) ---------------------

class FakeControl:
    """A GUI control: a value, a name, a disabled flag and callbacks."""

    def __init__(self, value=None):
        self.value = value
        self.disabled = False
        self.name = ""
        self._cbs = []

    def on_update(self, fn):
        self._cbs.append(fn)
        return fn

    on_click = on_update

    def fire(self):
        for fn in self._cbs:
            fn(None)


class FakeCamera:
    """A client's camera: a c2w quaternion and position, aspect, fov."""

    def __init__(self, wxyz=(1.0, 0.0, 0.0, 0.0), position=(0.0, 0.0, 0.0),
                 aspect=1.5, fov=1.0):
        self.wxyz = np.asarray(wxyz, np.float64)
        self.position = np.asarray(position, np.float64)
        self.aspect = aspect
        self.fov = fov
        self.up_direction = None
        self._cbs = []

    def on_update(self, fn):
        self._cbs.append(fn)
        return fn

    def move(self, wxyz, position):
        """Set the pose and fire the camera's callbacks (a user's drag)."""
        self.wxyz = np.asarray(wxyz, np.float64)
        self.position = np.asarray(position, np.float64)
        for fn in self._cbs:
            fn(None)


class FakeClient:
    def __init__(self, camera=None):
        self.camera = camera or FakeCamera()
        self.images = []      # the pushed frames, (H, W, 3) float32

    def set_background_image(self, img, format="jpeg"):
        self.images.append(np.asarray(img))


class FakeServer:
    """The part of ``viser.ViserServer`` that ``run_viewer`` uses, with one
    client.  ``values`` sets a control's value when it is added (as if the
    user had moved it before the first frame); ``poses`` (c2w wxyz,
    position) moves the client's camera to the next pose each time the
    viewer asks for its clients to render a frame."""

    def __init__(self, values=None, camera=None, poses=()):
        self.controls = {}
        self.values = dict(values or {})
        self.client = FakeClient(camera)
        self.poses = list(poses)
        self._connect_cbs = []

    def _add(self, name, value):
        c = FakeControl(self.values.get(name, value))
        self.controls[name] = c
        return c

    def add_gui_slider(self, name, min, max, step, initial_value,
                       disabled=False):
        c = self._add(name, initial_value)
        c.disabled = disabled
        return c

    def add_gui_button(self, name):
        return self._add(name, None)

    def add_gui_checkbox(self, name, initial_value=False):
        return self._add(name, initial_value)

    def add_gui_text(self, name, initial_value="", disabled=False):
        return self._add(name, initial_value)

    def on_client_connect(self, fn):
        self._connect_cbs.append(fn)
        fn(self.client)
        return fn

    def get_clients(self):
        if self.poses:
            self.client.camera.move(*self.poses.pop(0))
        return {0: self.client}


def c2w_pose(w2c):
    """A 4x4 w2c → the (wxyz, position) of a viser camera at that pose."""
    from gsplat_tpu_torch.viewer import _rotmat_to_quat

    c2w = np.linalg.inv(np.asarray(w2c, np.float64))
    return _rotmat_to_quat(c2w[:3, :3]), c2w[:3, 3]
