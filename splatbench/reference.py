"""The benchmark's plain reference: render, train step, Adam and densify
rule of 3D Gaussian Splatting in plain PyTorch.

It imports nothing of the program.  Projection and binning are a frozen
copy of the plain arithmetic of ``gsplat_tpu_torch`` (``ops/projection.py``,
``ops/binning.py``), op for op: which tiles a gaussian reaches is decided by
a floor of f32 values, so the copy has to round as the program rounds for
the two to emit the same pairs.  Compositing is written afresh: every tile's
pairs padded into one (tiles, pairs, pixels) block, an exclusive cumprod of
(1 - alpha) for the transmittance, the per-pixel stop at T < 1e-4 and the
0.9999 alpha clamp of the reference CUDA rasterizer.  Its backward is
autograd, block by block (each block is recomputed with the image's
cotangent, so only one block's planes are held), not the program's
hand-derived formulas.  SSIM is the 11-tap gaussian window (sigma 1.5) as
eleven shifted multiply-adds a pass.

``precision`` selects the control of the benchmark's check:

- ``"f32"``: the reference;
- ``"tf32"``: SSIM's blurs with inputs and window rounded to TF32 (10-bit
  mantissa, f32 sums), what a TF32 matmul does;
- ``"bf16"``: each pair's position relative to its tile centre, its conic,
  opacity and colour rounded to bf16 before compositing (the design of the
  program's own bf16 render preset), f32 arithmetic.

``fault="half"`` takes the loss over the top half of the image rows only
(the mean over the rest), one of the faults the check must catch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STOP_THRESH = 1e-4       # a pixel stops at transmittance below this
ALPHA_MAX = 0.9999
DET_EPS = 1e-14
SCALE_EPS = 1e-4         # the "abs" scale activation's floor
SH_DIM = 9
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
GROUPS = ("opa", "rgb", "pos", "scale", "quat")
# elements of one (tiles, pairs, pixels) plane a block may hold
BLOCK_ELEMS = 1 << 26


class Grid:
    """A camera's image on 16-pixel tiles, padded to whole tiles and cropped
    back centred."""

    def __init__(self, width, height, focal_x, focal_y, tile=16):
        self.width, self.height = int(width), int(height)
        self.focal_x, self.focal_y = float(focal_x), float(focal_y)
        self.tile = tile
        self.padded_w = -(-self.width // tile) * tile
        self.padded_h = -(-self.height // tile) * tile
        self.n_tile_x = self.padded_w // tile
        self.n_tile_y = self.padded_h // tile
        self.n_tiles = self.n_tile_x * self.n_tile_y
        self.px = tile * tile
        self.tile_len_x = tile / self.focal_x
        self.tile_len_y = tile / self.focal_y
        self.leftmost = -self.padded_w / 2.0 / self.focal_x
        self.topmost = -self.padded_h / 2.0 / self.focal_y
        self.crop_top = (self.padded_h - self.height) // 2
        self.crop_left = (self.padded_w - self.width) // 2


def div_rn(x, y: float):
    """``x / y`` as one IEEE division (a divisor tensor on x's device)."""
    return x / torch.full((), y, dtype=x.dtype, device=x.device)


def sqrt_rn(x):
    """The correctly rounded f32 root on every device (the CPU's f32 root
    can round an ulp off; the f64 root rounded to f32 does not)."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def rotation(q) -> np.ndarray:
    """A wxyz quaternion → 3x3 rotation (float64)."""
    w, x, y, z = (float(v) for v in q)
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def ray_vectors(rot, tran, grid: Grid) -> np.ndarray:
    """(4, 3) float32 [camera centre, the top-left pixel's ray point, the
    steps of one pixel in x and in y], world space, for the SH view
    directions."""
    c2w = np.linalg.inv(np.asarray(rot, np.float64))
    tran = np.asarray(tran, np.float64)
    origin = -c2w @ tran
    lefttop = c2w @ (np.array([(-grid.padded_w / 2 + 0.5) / grid.focal_x,
                               (-grid.padded_h / 2 + 0.5) / grid.focal_y,
                               1.0]) - tran)
    dx = c2w @ np.array([1.0 / grid.focal_x, 0.0, 0.0])
    dy = c2w @ np.array([0.0, 1.0 / grid.focal_y, 0.0])
    return np.stack([origin, lefttop, dx, dy]).astype(np.float32)


# ---------------------------------------------------------------------------
# projection and binning: the program's plain arithmetic, op for op
# ---------------------------------------------------------------------------

def project(params, rot, tran, grid: Grid, near: float):
    """EWA projection → (mean2d (N, 2), cov2d (N, 4) as (a, b, b, d), depth
    (N,) = ||p_cam||, visible (N,)); differentiable in the parameters."""
    quat = params["quat"]
    quat = quat / sqrt_rn((quat * quat).sum(dim=-1, keepdim=True))
    s = torch.abs(params["scale"]) + SCALE_EPS
    pos = params["pos"]
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    p_c = torch.stack([px * rot[k, 0] + py * rot[k, 1] + pz * rot[k, 2]
                       + tran[k] for k in range(3)], dim=-1)
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    near_ok = z > near
    zs = torch.where(near_ok, z, torch.ones_like(z))
    xi, yi = x / zs, y / zs
    depth = sqrt_rn(x * x + y * y + z * z)
    half_w = grid.width * 1.2 / 2 / grid.focal_x
    half_h = grid.height * 1.2 / 2 / grid.focal_y
    visible = near_ok & (torch.abs(xi) < half_w) & (torch.abs(yi) < half_h)
    inv_z = 1.0 / zs
    inv_z2x = x * inv_z * inv_z
    inv_z2y = y * inv_z * inv_z
    w = rot
    u = [inv_z * w[0, k] - inv_z2x * w[2, k] for k in range(3)]
    v = [inv_z * w[1, k] - inv_z2y * w[2, k] for k in range(3)]
    qw, qx, qy, qz = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
          2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
          1 - 2 * (qx * qx + qy * qy)]]
    m = [s[:, j] * (r[0][j] * u[0] + r[1][j] * u[1] + r[2][j] * u[2])
         for j in range(3)]
    n = [s[:, j] * (r[0][j] * v[0] + r[1][j] * v[1] + r[2][j] * v[2])
         for j in range(3)]
    a = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    b = m[0] * n[0] + m[1] * n[1] + m[2] * n[2]
    d = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    return (torch.stack([xi, yi], dim=-1), torch.stack([a, b, b, d], dim=-1),
            depth, visible)


def screen(params, live, rot, tran, grid: Grid, near: float, use_sh: bool):
    """→ (geom (N, 8) [x, y, a, b, c, d, opacity, 0], colour (N, C), depth,
    visible): each gaussian as the compositor reads it."""
    mean2d, cov2d, depth, visible = project(params, rot, tran, grid, near)
    opa = torch.sigmoid(params["opa"])
    colour = params["rgb"] if use_sh else torch.sigmoid(params["rgb"])
    geom = torch.cat([mean2d, cov2d, opa[:, None],
                      torch.zeros_like(opa)[:, None]], dim=1)
    return geom, colour, depth, visible & live


def bin_pairs(geom, depth, visible, grid: Grid, k_max: int,
              thresh: float = 0.05):
    """The (gaussian, tile) pairs: depth order, each gaussian's tile
    rectangle at the ``thresh`` iso-probability ellipse, its first
    ``k_max`` tiles row-major, one stable sort by tile → (src (P,) gaussian
    of each pair, tile_start (T+1,) int64, clipped pairs)."""
    dev = geom.device
    n = depth.shape[0]
    geom, depth = geom.detach(), depth.detach()
    key = torch.where(visible, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(key, stable=True).indices
    g = geom[order]
    vis = visible[order]
    cx, cy, a, b, c, d = (g[:, i] for i in range(6))
    det_ok = a * d - b * c > 0
    log_t = -2.0 * math.log(thresh)
    shift_x = sqrt_rn(torch.clamp_min(a * log_t, 0.0))
    shift_y = sqrt_rn(torch.clamp_min(d * log_t, 0.0))
    x0 = torch.floor(div_rn(cx - shift_x - grid.leftmost, grid.tile_len_x))
    x1 = torch.floor(div_rn(cx + shift_x - grid.leftmost,
                            grid.tile_len_x)) + 1.0
    y0 = torch.floor(div_rn(cy - shift_y - grid.topmost, grid.tile_len_y))
    y1 = torch.floor(div_rn(cy + shift_y - grid.topmost,
                            grid.tile_len_y)) + 1.0
    x0 = torch.clamp(x0, 0, grid.n_tile_x).to(torch.int64)
    x1 = torch.clamp(x1, 0, grid.n_tile_x).to(torch.int64)
    y0 = torch.clamp(y0, 0, grid.n_tile_y).to(torch.int64)
    y1 = torch.clamp(y1, 0, grid.n_tile_y).to(torch.int64)
    ok = vis & det_ok
    zero = torch.zeros_like(x0)
    rw = torch.where(ok, torch.clamp_min(x1 - x0, 0), zero)
    rh = torch.where(ok, torch.clamp_min(y1 - y0, 0), zero)
    cover = rw * rh
    count = torch.clamp_max(cover, k_max)
    clipped = int(torch.clamp_min(cover - k_max, 0).sum())
    total = int(count.sum())
    rank = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                   output_size=total)
    first = torch.cumsum(count, 0) - count
    kk = torch.arange(total, device=dev) - first[rank]
    rw_g = torch.clamp_min(rw, 1)[rank]
    ky = torch.div(kk, rw_g, rounding_mode="floor")
    kx = kk - ky * rw_g
    tile = (x0[rank] + kx) + (y0[rank] + ky) * grid.n_tile_x
    tile_sorted, perm = torch.sort(tile, stable=True)
    src = order[rank[perm]]
    tile_start = torch.searchsorted(
        tile_sorted, torch.arange(grid.n_tiles + 1, device=dev,
                                  dtype=tile.dtype))
    return src, tile_start, clipped


# ---------------------------------------------------------------------------
# compositing
# ---------------------------------------------------------------------------

def pixel_centres(grid: Grid, tiles, relative=False):
    """Focal-normalised pixel centres of ``tiles`` → (len, Px) x and y;
    ``relative``: less the tile's centre (the bf16 control's frame)."""
    p = torch.arange(grid.px, device=tiles.device)
    row = torch.div(p, grid.tile, rounding_mode="floor")
    col = p - row * grid.tile
    tx = (tiles % grid.n_tile_x)[:, None]
    ty = torch.div(tiles, grid.n_tile_x, rounding_mode="floor")[:, None]
    idx = (tx * grid.tile + col[None]).to(torch.float32)
    idy = (ty * grid.tile + row[None]).to(torch.float32)
    pxc = div_rn(idx + 0.5 - grid.padded_w / 2, grid.focal_x)
    pyc = div_rn(idy + 0.5 - grid.padded_h / 2, grid.focal_y)
    if relative:
        pxc = pxc - div_rn(tx * grid.tile + grid.tile / 2 - grid.padded_w / 2,
                           grid.focal_x)
        pyc = pyc - div_rn(ty * grid.tile + grid.tile / 2 - grid.padded_h / 2,
                           grid.focal_y)
    return pxc, pyc


def sh_basis(dirs):
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([torch.full_like(x, C0), -C1 * y, C1 * z, -C1 * x,
                        C2[0] * x * y, C2[1] * y * z,
                        C2[2] * (2.0 * zz - xx - yy), C2[3] * x * z,
                        C2[4] * (xx - yy)], dim=-1)


def pixel_sh_basis(grid: Grid, tiles, rays):
    """Each pixel's SH basis → (len(tiles), 9, Px), from the camera's
    :func:`ray_vectors` (a (4, 3) tensor)."""
    p = torch.arange(grid.px, device=tiles.device)
    row = torch.div(p, grid.tile, rounding_mode="floor")
    col = p - row * grid.tile
    fx = ((tiles % grid.n_tile_x)[:, None] * grid.tile
          + col[None]).to(torch.float32)
    fy = (torch.div(tiles, grid.n_tile_x, rounding_mode="floor")[:, None]
          * grid.tile + row[None]).to(torch.float32)
    comps = [rays[1, k] + fx * rays[2, k] + fy * rays[3, k] - rays[0, k]
             for k in range(3)]
    n = sqrt_rn(comps[0] * comps[0] + comps[1] * comps[1]
                + comps[2] * comps[2])
    inv = 1.0 / (n + 1e-7)
    return sh_basis(torch.stack([c * inv for c in comps], -1)).permute(
        0, 2, 1)


def _blocks(counts: np.ndarray, px: int, budget: int):
    """Tiles with pairs, in order, grouped so that (tiles × most pairs of
    one of them × pixels) stays within ``budget`` elements → [tile ids]."""
    out, cur, cur_max = [], [], 0
    for t in np.nonzero(counts)[0]:
        c = int(counts[t])
        m = max(cur_max, c)
        if cur and (len(cur) + 1) * m * px > budget:
            out.append(cur)
            cur, m = [], c
        cur.append(int(t))
        cur_max = m
    if cur:
        out.append(cur)
    return out


def _block(geom, colour, src, starts, counts, tiles, grid: Grid, rays,
           precision, want_count=False):
    """One block of tiles composited → (out (B, 4, Px) [r, g, b, Σw],
    evaluations (B, Px) or None); differentiable in ``geom`` and
    ``colour`` (the per-gaussian tables)."""
    dev = geom.device
    m = int(counts.max())
    slot = torch.arange(m, device=dev)
    valid = slot[None] < counts[:, None]                       # (B, M)
    pos = torch.where(valid, starts[:, None] + slot[None],
                      starts[:, None])
    rows = src[pos]
    g = geom[rows]                                             # (B, M, 8)
    c = colour[rows]                                           # (B, M, C)
    rel = precision == "bf16"
    pxc, pyc = pixel_centres(grid, tiles, relative=rel)
    if rel:
        tx = (tiles % grid.n_tile_x).to(torch.float32)[:, None]
        ty = torch.div(tiles, grid.n_tile_x,
                       rounding_mode="floor").to(torch.float32)[:, None]
        tcx = grid.leftmost + (tx + 0.5) * grid.tile_len_x
        tcy = grid.topmost + (ty + 0.5) * grid.tile_len_y
        g = torch.cat([(g[..., 0] - tcx)[..., None],
                       (g[..., 1] - tcy)[..., None], g[..., 2:]], -1)
        g = g.to(torch.bfloat16).to(torch.float32)
        c = c.to(torch.bfloat16).to(torch.float32)
    gx, gy = g[..., 0:1], g[..., 1:2]
    a, b, cc, d = g[..., 2:3], g[..., 3:4], g[..., 4:5], g[..., 5:6]
    opa = g[..., 6:7]
    dx = pxc[:, None, :] - gx                                  # (B, M, Px)
    dy = pyc[:, None, :] - gy
    det = a * d - b * cc
    pn = 2.0 * det + DET_EPS
    pm = -(d * dx * dx - (b + cc) * dx * dy + a * dy * dy)
    alpha = torch.clamp_max(torch.exp(pm / pn) * opa, ALPHA_MAX)
    alpha = torch.where(valid[..., None], alpha, torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    incl = torch.cumprod(one_m, dim=1)
    t_before = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
    live = t_before >= STOP_THRESH
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    if c.shape[-1] == 3:
        cols = [c[..., ch:ch + 1] for ch in range(3)]
    else:
        shb = pixel_sh_basis(grid, tiles, rays)                # (B, 9, Px)
        cols = []
        for ch in range(3):
            logit = c[..., SH_DIM * ch, None] * shb[:, None, 0]
            for k in range(1, SH_DIM):
                logit = logit + c[..., SH_DIM * ch + k, None] * shb[:, None, k]
            cols.append(torch.sigmoid(logit))
    out = torch.stack([(w * col).sum(1) for col in cols] + [w.sum(1)], 1)
    evals = (live & valid[..., None]).sum(1) if want_count else None
    return out, evals


def composite(geom, colour, src, tile_start, grid: Grid, rays=None,
              precision="f32", cotangent=None, want_count=False):
    """Composite every tile → (T, 4, Px) rows [r, g, b, Σw] without
    gradients; with ``cotangent`` (T, 3, Px), the image's gradient, instead
    accumulate ``geom.grad`` and ``colour.grad`` (leaf tensors) block by
    block and return None; ``want_count`` also returns the evaluations,
    pairs a pixel composites before its transmittance stops it, (T, Px)."""
    dev = geom.device
    starts_all = tile_start[:-1]
    counts_all = tile_start[1:] - starts_all
    t_all, px = grid.n_tiles, grid.px
    out = None if cotangent is not None else torch.zeros(
        (t_all, 4, px), dtype=torch.float32, device=dev)
    evals = torch.zeros((t_all, px), dtype=torch.int64, device=dev) \
        if want_count else None
    for block in _blocks(counts_all.cpu().numpy(), px, BLOCK_ELEMS):
        tiles = torch.tensor(block, device=dev)
        if cotangent is None:
            with torch.no_grad():
                o, e = _block(geom, colour, src, starts_all[tiles],
                              counts_all[tiles], tiles, grid, rays,
                              precision, want_count)
            out[tiles] = o
            if want_count:
                evals[tiles] = e
        else:
            with torch.enable_grad():
                o, _ = _block(geom, colour, src, starts_all[tiles],
                              counts_all[tiles], tiles, grid, rays,
                              precision)
                (o[:, :3] * cotangent[tiles]).sum().backward()
    if want_count:
        return out, evals
    return out


def to_image(out, grid: Grid):
    """(T, C, Px) tile rows → (C, padded_h, padded_w)."""
    ch = out.shape[1]
    img = out.reshape(grid.n_tile_y, grid.n_tile_x, ch, grid.tile, grid.tile)
    return img.permute(2, 0, 3, 1, 4).reshape(ch, grid.padded_h,
                                               grid.padded_w)


def to_tiles(img, grid: Grid):
    """(C, padded_h, padded_w) → (T, C, Px), the inverse of
    :func:`to_image`."""
    ch = img.shape[0]
    t = img.reshape(ch, grid.n_tile_y, grid.tile, grid.n_tile_x, grid.tile)
    return t.permute(1, 3, 0, 2, 4).reshape(grid.n_tiles, ch, grid.px)


def crop(img, grid: Grid):
    t, l = grid.crop_top, grid.crop_left
    return img[:, t:t + grid.height, l:l + grid.width]


def camera_tensors(rot, tran, grid: Grid, device):
    """A pose as the reference takes it: rotation and translation f32
    tensors and the SH ray vectors."""
    rot = np.asarray(rot, np.float64)
    tran = np.asarray(tran, np.float64)
    return (torch.as_tensor(rot, dtype=torch.float32, device=device),
            torch.as_tensor(tran, dtype=torch.float32, device=device),
            torch.as_tensor(ray_vectors(rot, tran, grid), device=device))


def render(params, live, rot, tran, grid: Grid, scene, precision="f32"):
    """One view → the (3, H, W) image in [0, 1], cropped centred.
    ``scene`` holds ``near``, ``k_max``, ``thresh`` and ``use_sh``."""
    r, t, rays = camera_tensors(rot, tran, grid, params["pos"].device)
    with torch.no_grad():
        geom, colour, depth, vis = screen(params, live, r, t, grid,
                                          scene["near"], scene["use_sh"])
        src, starts, _ = bin_pairs(geom, depth, vis, grid, scene["k_max"],
                                   scene["thresh"])
        out = composite(geom, colour, src, starts, grid, rays, precision)
        return crop(torch.clamp(to_image(out[:, :3], grid), 0.0, 1.0), grid)


def count_evaluations(params, live, rot, tran, grid: Grid, scene):
    """The work of one view's compositing, as the algorithm needs it →
    dict(pairs, evaluations): evaluations are the pair-pixel products up
    to each pixel's stop."""
    r, t, rays = camera_tensors(rot, tran, grid, params["pos"].device)
    with torch.no_grad():
        geom, colour, depth, vis = screen(params, live, r, t, grid,
                                          scene["near"], scene["use_sh"])
        src, starts, _ = bin_pairs(geom, depth, vis, grid, scene["k_max"],
                                   scene["thresh"])
        _, evals = composite(geom, colour, src, starts, grid, rays,
                             want_count=True)
    return {"pairs": int(src.shape[0]), "evaluations": int(evals.sum())}


# ---------------------------------------------------------------------------
# loss, gradients and Adam
# ---------------------------------------------------------------------------

def _tf32(x):
    """Round f32 values to TF32's 10-bit mantissa, to nearest (ties
    away), as a TF32 matmul rounds its inputs."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Tf32Input(torch.autograd.Function):
    """A matmul's input rounded to TF32; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Tf32Cotangent(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to TF32:
    the input of the backward's matmul."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _window(size=11, sigma=1.5):
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _pass(x, win, dim):
    """One pass of the window along ``dim`` (1: rows, 2: columns), valid
    region, as ``len(win)`` shifted multiply-adds."""
    n = x.shape[dim] - len(win) + 1
    y = x.narrow(dim, 0, n) * float(win[0])
    for i in range(1, len(win)):
        y = y + x.narrow(dim, i, n) * float(win[i])
    return y


def _blur(x, win, precision):
    """(N, H, W) → (N, H-10, W-10): the separable 11-tap window, rows then
    columns.  In ``"tf32"`` each pass is a TF32 matmul's arithmetic: its
    inputs (the planes and the window) rounded to TF32 forward, and the
    gradient it receives rounded backward."""
    if precision != "tf32":
        return _pass(_pass(x, win, 1), win, 2)
    win = _tf32(torch.from_numpy(win)).numpy()
    y = _Tf32Cotangent.apply(_pass(_Tf32Input.apply(x), win, 1))
    return _Tf32Cotangent.apply(_pass(_Tf32Input.apply(y), win, 2))


def ssim(img, gt, precision="f32"):
    """Mean SSIM of two (C, H, W) images in [0, 1] (gaussian window,
    k1 0.01, k2 0.03, valid region)."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ch = img.shape[0]
    z = _blur(torch.cat([img, gt, img * img, gt * gt, img * gt]), _window(),
              precision)
    mu_p, mu_t = z[:ch], z[ch:2 * ch]
    s_pp = z[2 * ch:3 * ch] - mu_p * mu_p
    s_tt = z[3 * ch:4 * ch] - mu_t * mu_t
    s_pt = z[4 * ch:] - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * s_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (s_pp + s_tt + c2)
    return torch.mean(num / den)


def loss(img, gt, ssim_weight, precision="f32", fault=None):
    """(1 - w) L1 + w (1 - SSIM) of a (3, H, W) render against its ground
    truth."""
    if fault == "half":
        rows = img.shape[1] // 2
        img, gt = img[:, :rows], gt[:, :rows]
    l1 = torch.mean(torch.abs(img - gt))
    s = ssim(img, gt, precision)
    return (1 - ssim_weight) * l1 + ssim_weight * (1.0 - s)


def loss_and_grads(params, live, rot, tran, gt, grid: Grid, scene, train,
                   precision="f32", fault=None):
    """One view's loss and the gradient of every group → (loss, {group:
    grad}).  ``gt`` is the (3, H, W) uint8 ground truth."""
    dev = params["pos"].device
    r, t, rays = camera_tensors(rot, tran, grid, dev)
    leaves = {k: params[k].detach().requires_grad_(True) for k in GROUPS}
    with torch.enable_grad():
        geom, colour, depth, vis = screen(leaves, live, r, t, grid,
                                          scene["near"], scene["use_sh"])
    src, starts, _ = bin_pairs(geom, depth, vis, grid, scene["k_max"],
                               scene["thresh"])
    g_leaf = geom.detach().requires_grad_(True)
    c_leaf = colour.detach().requires_grad_(True)
    with torch.no_grad():
        out = composite(g_leaf, c_leaf, src, starts, grid, rays, precision)
    padded = to_image(out[:, :3], grid).requires_grad_(True)
    gt_f = gt.to(torch.float32) / torch.full((), 255.0, device=dev)
    with torch.enable_grad():
        img = crop(torch.clamp(padded, 0.0, 1.0), grid)
        value = loss(img, gt_f, train["ssim_weight"], precision, fault)
        value.backward()
    composite(g_leaf, c_leaf, src, starts, grid, rays, precision,
              cotangent=to_tiles(padded.grad, grid))
    torch.autograd.backward([geom, colour], [g_leaf.grad, c_leaf.grad])
    grads = {k: (leaves[k].grad if leaves[k].grad is not None
                 else torch.zeros_like(leaves[k])) for k in GROUPS}
    return float(value.detach()), grads


def learning_rates(train, i_iter) -> dict:
    """Each group's learning rate at ``i_iter``: a linear warm-up over
    ``n_iters_warmup``, then exponential decay to 1% at ``n_iters``."""
    base = {"opa": train["lr"] * train["lr_factor_for_opa"],
            "rgb": train["lr"] * train["lr_factor_for_rgb"],
            "pos": train["lr"],
            "scale": train["lr"] * train["lr_factor_for_scale"],
            "quat": train["lr"] * train["lr_factor_for_quat"]}
    w = train["n_iters_warmup"]
    if train["lr_decay"] != "exp":
        raise ValueError("the reference follows the 'exp' schedule only")
    if i_iter <= w:
        lam = i_iter / w
    else:
        lam = (0.01 ** (1.0 / (train["n_iters"] - w))) ** (i_iter - w)
    return {k: v * lam for k, v in base.items()}


def adam(params, grads, mu, nu, t, lrs, train):
    """One Adam step per group → (params, mu, nu)."""
    b1, b2, eps = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    new_p, new_mu, new_nu = {}, {}, {}
    for k in GROUPS:
        g = grads[k]
        m = b1 * mu[k] + (1 - b1) * g
        v = b2 * nu[k] + (1 - b2) * g * g
        new_p[k] = params[k] - lrs[k] * ((m / bc1) / (torch.sqrt(v / bc2)
                                                      + eps))
        new_mu[k], new_nu[k] = m, v
    return new_p, new_mu, new_nu


def follow(params, live, views, start, grid: Grid, scene, train,
           precision="f32", fault=None):
    """Train from ``params`` over ``views`` [(rot, tran, gt uint8)], one a
    step from iteration ``start`` → (losses, the first step's gradients,
    the parameters after the last step)."""
    p = {k: params[k].clone() for k in GROUPS}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for i, (rot, tran, gt) in enumerate(views):
        value, grads = loss_and_grads(p, live, rot, tran, gt, grid, scene,
                                      train, precision, fault)
        losses.append(value)
        if first is None:
            first = grads
        with torch.no_grad():
            p, mu, nu = adam(p, grads, mu, nu, i + 1,
                             learning_rates(train, start + i), train)
    return losses, first, p


def densify_rule(pre, train):
    """The adaptive control's decision on a state → dict of masks: keep
    (not pruned), split, clone.  ``pre`` holds the parameters, ``live``,
    ``accum_grad`` and ``grad_counter``."""
    grad = pre["accum_grad"] / (pre["grad_counter"][:, None] + 1e-3)
    s = torch.abs(pre["scale"]) + SCALE_EPS
    norm = sqrt_rn((s * s).sum(dim=-1))
    logit_002 = -math.log(1.0 / 0.02 - 1.0)
    keep = pre["live"] & (pre["opa"] > logit_002) \
        & (norm < train["delete_thresh"])
    g = grad.abs().amax(dim=-1)
    dens = keep & (g > train["grad_thresh"])
    split = dens & (norm > train["split_thresh"]) & bool(train["use_split"])
    clone = dens & (norm <= train["split_thresh"]) & bool(train["use_clone"])
    return {"keep": keep, "split": split, "clone": clone}
