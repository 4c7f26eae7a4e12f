"""Tiled front-to-back alpha compositing: the CUDA kernels and their plain
twins, forward and backward, RGB and SH, and the render preset.

The JAX package composites chunk-aligned pair buffers with the Pallas TPU
kernels ``_fwd_kernel`` / ``_bwd_kernel`` (``gsplat_tpu/ops/rasterize.py:
437-690``) behind the custom VJP ``_raster_pallas`` (``:823-877``), or with
``composite_chunks_jnp`` and autodiff.  Here the pairs arrive grouped by tile
(``ops/binning.pack_sorted``) and each direction has one contract with two
implementations:

- forward: :func:`composite_tiles_torch`, plain PyTorch vectorised over
  tiles (it steps over "the j-th chunk of every tile", with an exclusive
  cumprod of (1 − α) inside each chunk and the transmittance carried between
  chunks), and the kernels ``rasterize_fwd`` / ``rasterize_fwd_sh`` of
  ``csrc/rasterize_fwd.cu``;
- backward: :func:`composite_tiles_bwd_torch`, the JAX backward's own
  formulas chunk by chunk (recompute α and T, d_alpha by the suffix-color
  identity, the analytic 2-D gaussian derivatives), and the kernels
  ``rasterize_bwd`` / ``rasterize_bwd_sh`` of ``csrc/rasterize_bwd.cu``;
- the render preset (JAX's ``packed_bf16``): :func:`composite_tiles_preset_
  torch` and the kernels ``rasterize_fwd_preset`` (RGB) and
  ``rasterize_fwd_preset_sh`` (SH), forward only.

:class:`CompositeTiles` ties the f32 directions together as one
``torch.autograd.Function`` and :func:`composite_tiles` calls it.  The
tensors' device picks the route: CPU tensors run the plain versions, CUDA
tensors launch the kernels or raise.

Contract: ``geom (P, 8)`` f32, ``color (P, C)`` f32 (C = ``spec.color_dim``:
3 post-sigmoid RGB, or 27 SH coefficients, channel-major 3 × 9, with the
camera's ``sh_vecs (4, 3)`` [rays_o, lefttop, dx, dy]), ``tile_start
(T+1,)`` int32 → ``out (T, 4, Px)`` f32, rows 0–2 composited color and row 3
the accumulated weight Σw, the TPU kernel's row layout.  The backward takes
the ``(T, 4, Px)`` cotangent (row 3 is nonzero under weight normalisation)
and returns per-pair ``grad_geom (P, 8)`` (column 7 zero) and ``grad_color
(P, C)``; ``sh_vecs`` gets no gradient (``:873``).  Weight normalisation
happens outside, in :func:`assemble_image`, as in JAX.

SH color per pair and pixel is ``sigmoid(Σ_k coeff_k · basis_k)`` per
channel, the basis from the pixel's view direction (``_sh_pixel_basis``).
JAX contracts it with ``Precision.HIGHEST`` (full f32) on the f32 route;
the plain twin sums the nine products in order k = 0..8, the kernels with
f32 FMAs in the same order.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gsplat_tpu_torch.ops.binning import PackedPairs, PresetPairs, div_rn, \
    sqrt_rn
from gsplat_tpu_torch.ops.cuda_build import load_kernel_library
from gsplat_tpu_torch.ops.sh import SH_DIM, sh_basis

STOP_THRESH = 1e-4   # early-termination transmittance (gaussian.cu:906)
DET_EPS = 1e-14      # gaussian.cu:920
ALPHA_EPS = 1e-7     # backward 1/(1-alpha) guard (gaussian.cu:721)
ALPHA_MAX = 0.9999   # rasterize.py:247 clamp


class RasterSpec(NamedTuple):
    """Rasterizer geometry."""

    n_tile_x: int
    n_tile_y: int
    tile_h: int
    tile_w: int
    focal_x: float
    focal_y: float
    chunk_size: int = 128    # pairs per step of the plain version
    weight_normalize: bool = False
    color_dim: int = 3       # 3 (RGB) or 27 (SH degree 2, 3 × 9)

    @property
    def px(self) -> int:
        return self.tile_h * self.tile_w

    @property
    def n_tiles(self) -> int:
        return self.n_tile_x * self.n_tile_y

    @property
    def padded_w(self) -> int:
        return self.n_tile_x * self.tile_w

    @property
    def padded_h(self) -> int:
        return self.n_tile_y * self.tile_h


def _tile_pixel_ids(spec: RasterSpec, tiles: torch.Tensor):
    """Padded-image pixel ids of each tile's pixels → (len(tiles), Px) f32
    each (rasterize.py:162-171)."""
    p = torch.arange(spec.px, device=tiles.device)
    row = torch.div(p, spec.tile_w, rounding_mode="floor")
    col = p - row * spec.tile_w
    tx = (tiles % spec.n_tile_x)[:, None]
    ty = torch.div(tiles, spec.n_tile_x, rounding_mode="floor")[:, None]
    id_x = (tx * spec.tile_w + col[None, :]).to(torch.float32)
    id_y = (ty * spec.tile_h + row[None, :]).to(torch.float32)
    return id_x, id_y


def _tile_pixel_coords(spec: RasterSpec, tiles: torch.Tensor,
                       relative: bool = False):
    """Focal-normalized pixel centres on the padded grid → (len(tiles), Px)
    each (rasterize.py:174-193, same float32 arithmetic, divided as the
    kernels divide on the card too: ``binning.div_rn``).  ``relative``
    (the render preset) subtracts the tile centre by JAX's own formula,
    which rounds differently from the packer's (``ops/binning.
    pack_preset``); each side keeps its own."""
    id_x, id_y = _tile_pixel_ids(spec, tiles)
    pxc = div_rn(id_x + 0.5 - spec.padded_w / 2, spec.focal_x)
    pyc = div_rn(id_y + 0.5 - spec.padded_h / 2, spec.focal_y)
    if relative:
        tx = (tiles % spec.n_tile_x)[:, None]
        ty = torch.div(tiles, spec.n_tile_x, rounding_mode="floor")[:, None]
        tcx = div_rn(tx * spec.tile_w + spec.tile_w / 2 - spec.padded_w / 2,
                     spec.focal_x)
        tcy = div_rn(ty * spec.tile_h + spec.tile_h / 2 - spec.padded_h / 2,
                     spec.focal_y)
        pxc, pyc = pxc - tcx, pyc - tcy
    return pxc, pyc


def _sh_pixel_basis(spec: RasterSpec, tiles: torch.Tensor,
                    sh_vecs: torch.Tensor) -> torch.Tensor:
    """Per-pixel SH basis → (len(tiles), 9, Px) from the camera's RayInfo
    vectors ``sh_vecs`` (4, 3) = [rays_o, lefttop, dx, dy]: the float32
    expressions of ``_sh_pixel_basis`` (rasterize.py:196-225,
    gaussian.cu:845-861) on the padded grid, including ``1/(n + 1e-7)``."""
    fx, fy = _tile_pixel_ids(spec, tiles)
    comps = [sh_vecs[1, k] + fx * sh_vecs[2, k] + fy * sh_vecs[3, k]
             - sh_vecs[0, k] for k in range(3)]
    n = sqrt_rn(comps[0] * comps[0] + comps[1] * comps[1]
                + comps[2] * comps[2])
    inv = 1.0 / (n + 1e-7)                                        # cu:858
    dirs = torch.stack([c * inv for c in comps], dim=-1)          # (A, Px, 3)
    return sh_basis(dirs).permute(0, 2, 1)


def _check_inputs(geom, color, tile_start, spec: RasterSpec, sh_vecs=None):
    p = geom.shape[0]
    if geom.dtype != torch.float32 or color.dtype != torch.float32:
        raise TypeError(f"geom/color must be float32, got {geom.dtype}/"
                        f"{color.dtype}")
    if spec.color_dim not in (3, 3 * SH_DIM):
        raise ValueError(f"color_dim must be 3 or 27, got {spec.color_dim}")
    if geom.shape != (p, 8) or color.shape != (p, spec.color_dim):
        raise ValueError(f"expected geom (P, 8) and color (P, "
                         f"{spec.color_dim}), got {tuple(geom.shape)} and "
                         f"{tuple(color.shape)}")
    _check_tile_start(tile_start, spec)
    _check_sh_vecs(spec, sh_vecs)


def _check_sh_vecs(spec: RasterSpec, sh_vecs):
    if spec.color_dim != 3:
        if sh_vecs is None:
            raise ValueError("SH color (color_dim 27) needs the camera's "
                             "sh_vecs (4, 3)")
        if sh_vecs.dtype != torch.float32 or sh_vecs.shape != (4, 3):
            raise ValueError(f"sh_vecs must be (4, 3) float32, got "
                             f"{tuple(sh_vecs.shape)} {sh_vecs.dtype}")


def _check_tile_start(tile_start, spec: RasterSpec):
    if tile_start.dtype != torch.int32:
        raise TypeError(f"tile_start must be int32, got {tile_start.dtype}")
    if tile_start.shape != (spec.n_tiles + 1,):
        raise ValueError(f"tile_start must be ({spec.n_tiles + 1},), got "
                         f"{tuple(tile_start.shape)}")


def _check_bwd_inputs(out, grad_out, spec: RasterSpec):
    shape = (spec.n_tiles, 4, spec.px)
    for name, x in (("out", out), ("grad_out", grad_out)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


PRESET_SH_COLS = 32   # 27 SH coefficients and 5 zeros: one 64-byte row


def _check_preset_inputs(geom, color, tile_start, spec: RasterSpec,
                         sh_vecs=None):
    p = geom.shape[0]
    if geom.dtype != torch.bfloat16 or color.dtype != torch.bfloat16:
        raise TypeError(f"preset geom/color must be bfloat16, got "
                        f"{geom.dtype}/{color.dtype}")
    if spec.color_dim not in (3, 3 * SH_DIM):
        raise ValueError(f"color_dim must be 3 or 27, got {spec.color_dim}")
    cols = 4 if spec.color_dim == 3 else PRESET_SH_COLS
    if geom.shape != (p, 8) or color.shape != (p, cols):
        raise ValueError(f"expected preset geom (P, 8) and color (P, {cols}),"
                         f" got {tuple(geom.shape)} and "
                         f"{tuple(color.shape)}")
    _check_tile_start(tile_start, spec)
    _check_sh_vecs(spec, sh_vecs)


def _tile_chunks(tile_start: torch.Tensor, spec: RasterSpec):
    """Yield ``(act, pos, valid)`` for chunk j = 0, 1, … of every tile that
    still has pairs there: tile ids (A,), pair rows (A, G) (0 where not
    valid) and the (A, G) mask of real pairs."""
    dev = tile_start.device
    g_len = spec.chunk_size
    start = tile_start[:-1].to(torch.int64)
    count = tile_start[1:].to(torch.int64) - start
    n_steps = math.ceil(int(count.max()) / g_len) if spec.n_tiles else 0
    gidx = torch.arange(g_len, device=dev)
    for j in range(n_steps):
        act = torch.nonzero(count > j * g_len).squeeze(1)
        pos = start[act, None] + j * g_len + gidx[None, :]          # (A, G)
        valid = pos < (start[act] + count[act])[:, None]
        yield act, torch.where(valid, pos, torch.zeros_like(pos)), valid


def _chunk_alpha(g: torch.Tensor, pxc: torch.Tensor, pyc: torch.Tensor):
    """(A, G, 8) pair geometry and (A, 1, Px) pixel centres → the (A, G, Px)
    α and prob planes, and the terms the backward reuses
    (``rasterize.py:228-248``, same float32 arithmetic)."""
    gx, gy = g[..., 0:1], g[..., 1:2]
    a, b, cc, d = g[..., 2:3], g[..., 3:4], g[..., 4:5], g[..., 5:6]
    opa = g[..., 6:7]
    dx = pxc - gx                                               # (A, G, Px)
    dy = pyc - gy
    det = a * d - b * cc
    pn = 2.0 * det + DET_EPS
    pm = -(d * dx * dx - (b + cc) * dx * dy + a * dy * dy)
    prob = torch.exp(pm / pn)
    alpha = torch.clamp_max(prob * opa, ALPHA_MAX)
    return alpha, prob, (dx, dy, a, b, cc, d, opa, pm, pn)


def _chunk_colors(c: torch.Tensor, shb):
    """Per-pair colors of one chunk step, ``c`` (A, G, C) → 3 planes of
    (A, G, 1) (RGB) or (A, G, Px) (SH: sigmoid of the nine-term dot product
    with the tiles' basis ``shb`` (A, 9, Px), summed in order k = 0..8;
    ``_chunk_colors``, rasterize.py:317-332)."""
    if shb is None:
        return [c[..., ch:ch + 1] for ch in range(3)]
    cols = []
    for ch in range(3):
        logit = c[..., SH_DIM * ch, None] * shb[:, None, 0]
        for k in range(1, SH_DIM):
            logit = logit + c[..., SH_DIM * ch + k, None] * shb[:, None, k]
        cols.append(torch.sigmoid(logit))
    return cols


def _chunk_weights(alpha, valid, trans_act):
    """Mask dead slots, then the exclusive transmittance T, the live mask
    T ≥ 1e-4 and the weights w = α·T of one chunk step.  Transmittance is
    monotone, so carrying the full product and masking is exactly the
    per-pixel break of the CUDA kernels."""
    alpha = torch.where(valid[..., None], alpha, torch.zeros_like(alpha))
    one_m = 1.0 - alpha
    incl = torch.cumprod(one_m, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    t_before = excl * trans_act[:, None, :]
    live = t_before >= STOP_THRESH
    w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
    return one_m, t_before, live, w


def _composite_plain(geom, color, tile_start, spec: RasterSpec, relative,
                     shb_all):
    """The plain forward on checked f32 pairs: pixel centres absolute or
    tile-relative, colors RGB (``shb_all`` None) or SH."""
    dev = geom.device
    t_all, px = spec.n_tiles, spec.px
    out = torch.zeros((t_all, 4, px), dtype=torch.float32, device=dev)
    pxc_all, pyc_all = _tile_pixel_coords(
        spec, torch.arange(t_all, device=dev), relative)
    trans = torch.ones((t_all, px), dtype=torch.float32, device=dev)
    for act, pos, valid in _tile_chunks(tile_start, spec):
        g = geom[pos]                                               # (A, G, 8)
        alpha, _, _ = _chunk_alpha(g, pxc_all[act][:, None, :],
                                   pyc_all[act][:, None, :])
        one_m, t_before, _, w = _chunk_weights(alpha, valid, trans[act])
        cols = _chunk_colors(color[pos],
                             None if shb_all is None else shb_all[act])
        for ch in range(3):
            out[act, ch] += (w * cols[ch]).sum(dim=1)
        out[act, 3] += w.sum(dim=1)
        trans[act] = t_before[:, -1] * one_m[:, -1]
    return out


def _shb_all(spec: RasterSpec, sh_vecs, device):
    """Every tile's SH basis (T, 9, Px), or None for RGB."""
    if spec.color_dim == 3:
        return None
    return _sh_pixel_basis(spec, torch.arange(spec.n_tiles, device=device),
                           sh_vecs)


def composite_tiles_torch(geom: torch.Tensor, color: torch.Tensor,
                          tile_start: torch.Tensor, spec: RasterSpec,
                          sh_vecs: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain PyTorch compositor (the kernels' contract and yardstick)."""
    _check_inputs(geom, color, tile_start, spec, sh_vecs)
    return _composite_plain(geom, color, tile_start, spec, False,
                            _shb_all(spec, sh_vecs, geom.device))


def composite_tiles_preset_torch(geom: torch.Tensor, color: torch.Tensor,
                                 tile_start: torch.Tensor, spec: RasterSpec,
                                 sh_vecs: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch compositor of the render preset (JAX's ``packed_bf16``
    route, ``rasterize.py:184-192,285-300``): bf16 pairs ``geom (P, 8)``
    [x − tile centre x, y − tile centre y, a, b, c, d, opa, 0] and ``color``
    (``ops/binning.pack_preset``): ``(P, 4)`` [r, g, b, 0], or ``(P, 32)``,
    27 SH coefficients and 5 zeros, with the camera's ``sh_vecs``.  The
    values are widened to f32 and composited against tile-relative pixel
    centres; the SH basis takes the absolute pixel ids, as on the f32 route
    (``_sh_pixel_basis``).  The math and the accumulation are f32.  Same
    output as :func:`composite_tiles_torch`."""
    _check_preset_inputs(geom, color, tile_start, spec, sh_vecs)
    return _composite_plain(geom.to(torch.float32),
                            color[:, :spec.color_dim].to(torch.float32),
                            tile_start, spec, True,
                            _shb_all(spec, sh_vecs, geom.device))


def composite_tiles_bwd_torch(geom: torch.Tensor, color: torch.Tensor,
                              tile_start: torch.Tensor, out: torch.Tensor,
                              grad_out: torch.Tensor, spec: RasterSpec,
                              sh_vecs: torch.Tensor | None = None):
    """Plain PyTorch backward of the compositor (the backward kernels'
    contract and yardstick) → per-pair ``(grad_geom (P, 8), grad_color
    (P, C))``.

    The JAX backward's own formulas (``rasterize.py:585-657``), not autograd
    through the forward: each chunk step recomputes α, T, ``live`` and the
    colors C as :func:`composite_tiles_torch` does, then

      d_alpha = gc_dot·T − (gdotout − c_incl_dot) / (1 − α + 1e-7)

    where ``gc_dot = Σ_c g_c·C_c`` with Σw as a 4th color ≡ 1, ``gdotout =
    Σ_c g_c·out_c`` and ``c_incl_dot`` the inclusive running sum of
    ``w·gc_dot`` (carried between chunks).  d_alpha is zero where the pair
    is dead or the 0.9999 clamp is active; then come d_opa, the analytic
    ∂prob/∂(x, y, a, b, c, d) and the color gradient: ``Σ_px g·w`` (RGB),
    or per channel ``dcoef_k = Σ_px g·w·σ(1 − σ)·basis_k`` (SH).  Its
    working memory is one chunk step's (A, G, Px) planes.  Column 7 is
    zero.
    """
    _check_inputs(geom, color, tile_start, spec, sh_vecs)
    _check_bwd_inputs(out, grad_out, spec)
    dev = geom.device
    t_all, px = spec.n_tiles, spec.px
    grad_geom = torch.zeros_like(geom)
    grad_color = torch.zeros_like(color)
    pxc_all, pyc_all = _tile_pixel_coords(
        spec, torch.arange(t_all, device=dev))
    shb_all = _shb_all(spec, sh_vecs, dev)
    trans = torch.ones((t_all, px), dtype=torch.float32, device=dev)
    carry = torch.zeros((t_all, px), dtype=torch.float32, device=dev)
    gdotout = (grad_out[:, 0] * out[:, 0] + grad_out[:, 1] * out[:, 1]
               + grad_out[:, 2] * out[:, 2] + grad_out[:, 3] * out[:, 3])
    for act, pos, valid in _tile_chunks(tile_start, spec):
        g = geom[pos]                                               # (A, G, 8)
        alpha, prob, aux = _chunk_alpha(g, pxc_all[act][:, None, :],
                                        pyc_all[act][:, None, :])
        dx, dy, a, b, cc, d, opa, pm, pn = aux
        one_m, t_before, live, w = _chunk_weights(alpha, valid, trans[act])
        shb = None if shb_all is None else shb_all[act]
        cols = _chunk_colors(color[pos], shb)
        gout = grad_out[act][:, :, None, :]                     # (A, 4, 1, Px)
        gc_dot = (gout[:, 0] * cols[0] + gout[:, 1] * cols[1]
                  + gout[:, 2] * cols[2] + gout[:, 3])          # (A, G, Px)
        c_incl = carry[act][:, None, :] + torch.cumsum(w * gc_dot, dim=1)
        d_alpha = gc_dot * t_before \
            - (gdotout[act][:, None, :] - c_incl) / (one_m + ALPHA_EPS)
        # dead pairs, and no gradient through the 0.9999 clamp
        keep = live & valid[..., None] & (prob * opa < ALPHA_MAX)
        d_alpha = torch.where(keep, d_alpha, torch.zeros_like(d_alpha))
        d_prob = d_alpha * opa
        inv_pn2 = 1.0 / (pn * pn)
        dp = (prob / pn * (2.0 * d * dx - (b + cc) * dy),
              prob / pn * (2.0 * a * dy - (b + cc) * dx),
              prob * ((-dy * dy) * pn - (2.0 * d) * pm) * inv_pn2,
              prob * ((dx * dy) * pn - (-2.0 * cc) * pm) * inv_pn2,
              prob * ((dx * dy) * pn - (-2.0 * b) * pm) * inv_pn2,
              prob * ((-dx * dx) * pn - (2.0 * a) * pm) * inv_pn2)
        rows = [(d_prob * x).sum(dim=2) for x in dp]
        rows.append((d_alpha * prob).sum(dim=2))                # d_opa
        for ch in range(3):
            gw = gout[:, ch] * w
            if shb is None:
                rows.append(gw.sum(dim=2))
            else:
                # d logits = g_c·w·σ(1−σ); d coeff = d logits @ basisᵀ
                dlog = gw * cols[ch] * (1.0 - cols[ch])
                rows += [(dlog * shb[:, None, k]).sum(dim=2)
                         for k in range(SH_DIM)]
        rows = torch.stack(rows, dim=2)                         # (A, G, 7+C)
        rows_ok, pos_ok = rows[valid], pos[valid]
        grad_geom[pos_ok, :7] = rows_ok[:, :7]
        grad_color[pos_ok] = rows_ok[:, 7:]
        carry[act] = c_incl[:, -1]
        trans[act] = t_before[:, -1] * one_m[:, -1]
    return grad_geom, grad_color


def _check_device(name, tensors):
    """True for CPU tensors (plain version); False for CUDA tensors of one
    device (kernel); raises for anything else."""
    devices = {t.device for t in tensors if t is not None}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name} runs on CPU tensors (plain version) or on CUDA tensors "
            f"of one device (kernel); got {sorted(map(str, devices))}")
    return False


def _check_kernel_inputs(name, spec: RasterSpec, *tensors):
    if spec.px > 1024:
        raise ValueError(f"tile of {spec.px} pixels exceeds the kernels' "
                         "limit of 1024 (the backward's launch, "
                         "csrc/rasterize_bwd.cu: a block of up to 256 "
                         "threads of 4 pixels or 512 of 2)")
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{name} needs contiguous tensors")
    if tensors[0].data_ptr() % 16:
        raise ValueError("geom must be 16-byte aligned (16-byte loads)")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point → (its source csrc/<source>.cu, its number of pointer
# arguments).  Every entry point takes its pointers (unused ones null),
# then the grid ints, the focals and the stream.
KERNELS = {
    "rasterize_fwd": ("rasterize_fwd", 5),
    "rasterize_fwd_sh": ("rasterize_fwd", 5),
    "rasterize_fwd_preset": ("rasterize_fwd", 5),
    "rasterize_fwd_preset_sh": ("rasterize_fwd", 5),
    "rasterize_bwd": ("rasterize_bwd", 8),
    "rasterize_bwd_sh": ("rasterize_bwd", 8),
}
# kernel launches per entry point (one per launch, nowhere else)
LAUNCHES = dict.fromkeys(KERNELS, 0)


def _kernel(name: str):
    """The C entry point ``name``, built from its source and loaded at
    first use (``ops/cuda_build``)."""
    source, n_ptr = KERNELS[name]
    fn = getattr(load_kernel_library(source), name)
    fn.argtypes = [_PTR] * n_ptr + [_INT] * 6 + [_FLOAT] * 2 + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, spec: RasterSpec, *tensors):
    """Launch entry point ``name`` on the current stream of the first
    tensor's device (``None`` passes a null pointer); raise on a CUDA
    error, else count the launch."""
    fn = _kernel(name)
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors),
                spec.n_tiles, spec.n_tile_x, spec.tile_h, spec.tile_w,
                spec.padded_w, spec.padded_h, spec.focal_x, spec.focal_y,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def fast_division_check(n: int, seed: int, device) -> tuple[int, int, int]:
    """Hold ``csrc/fast_div.cuh``'s split division, which the forward
    kernels use for pm / pn, against the compiler's IEEE x / y on ``n``
    operand pairs drawn from ``seed``, on the card (``csrc/
    fast_div_check.cu``) → (quotients the split division takes, those that
    differ from x / y in any bit, those it leaves to the division)."""
    fn = load_kernel_library("fast_div_check").fast_div_check
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, _PTR, _PTR]
    fn.restype = ctypes.c_int
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(counts.device):
        rc = fn(n, seed, counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fast_div_check launch failed: CUDA error {rc}")
    taken, differ, left = (int(v) for v in counts.cpu())
    return taken, differ, left


def _composite_fwd(geom, color, tile_start, spec: RasterSpec, sh_vecs):
    """The forward wrapper: plain version on the CPU, kernel on CUDA."""
    sh = spec.color_dim != 3
    if _check_device("composite_tiles",
                     (geom, color, tile_start, sh_vecs if sh else None)):
        return composite_tiles_torch(geom, color, tile_start, spec, sh_vecs)
    _check_inputs(geom, color, tile_start, spec, sh_vecs)
    shv = sh_vecs.contiguous() if sh else None
    _check_kernel_inputs("composite_tiles", spec, geom, color, tile_start)
    out = torch.empty((spec.n_tiles, 4, spec.px), dtype=torch.float32,
                      device=geom.device)
    _launch("rasterize_fwd_sh" if sh else "rasterize_fwd", spec, geom, color,
            tile_start, shv, out)
    return out


def composite_tiles_bwd(geom: torch.Tensor, color: torch.Tensor,
                        tile_start: torch.Tensor, out: torch.Tensor,
                        grad_out: torch.Tensor, spec: RasterSpec,
                        sh_vecs: torch.Tensor | None = None):
    """Backward of :func:`composite_tiles` → per-pair ``(grad_geom (P, 8),
    grad_color (P, C))``, from the forward's ``out`` and its cotangent
    ``grad_out``, both ``(T, 4, Px)``.

    CPU tensors run :func:`composite_tiles_bwd_torch`.  CUDA tensors launch
    a Hopper kernel of ``csrc/rasterize_bwd.cu`` (built at first use),
    ``rasterize_bwd`` (RGB) or ``rasterize_bwd_sh`` (SH), which replace
    ``gsplat_tpu/ops/rasterize.py::_bwd_kernel``; a build or launch failure
    raises.  The outputs start as zeros, so the rows of pairs the kernel
    never reaches (every pixel of their tile stopped before them) read
    zero.  ``LAUNCHES`` counts kernel launches.
    """
    sh = spec.color_dim != 3
    if _check_device("composite_tiles_bwd",
                     (geom, color, tile_start, out, grad_out,
                      sh_vecs if sh else None)):
        return composite_tiles_bwd_torch(geom, color, tile_start, out,
                                         grad_out, spec, sh_vecs)
    _check_inputs(geom, color, tile_start, spec, sh_vecs)
    _check_bwd_inputs(out, grad_out, spec)
    shv = sh_vecs.contiguous() if sh else None
    _check_kernel_inputs("composite_tiles_bwd", spec, geom, color,
                         tile_start, out, grad_out)
    grad_geom = torch.zeros_like(geom)
    grad_color = torch.zeros_like(color)
    _launch("rasterize_bwd_sh" if sh else "rasterize_bwd", spec, geom, color,
            tile_start, shv, out, grad_out, grad_geom, grad_color)
    return grad_geom, grad_color


class CompositeTiles(torch.autograd.Function):
    """The compositor with its backward, the counterpart of the custom VJP
    ``_raster_pallas`` (``rasterize.py:823-877``).  The forward saves the
    pairs and its output; the backward maps the ``(T, 4, Px)`` cotangent to
    per-pair gradients with :func:`composite_tiles_bwd`.  ``tile_start``,
    ``spec`` and ``sh_vecs`` get none."""

    @staticmethod
    def forward(ctx, geom, color, tile_start, spec, sh_vecs):
        out = _composite_fwd(geom, color, tile_start, spec, sh_vecs)
        ctx.spec = spec
        ctx.save_for_backward(geom, color, tile_start, out, sh_vecs)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        geom, color, tile_start, out, sh_vecs = ctx.saved_tensors
        grad_geom, grad_color = composite_tiles_bwd(
            geom, color, tile_start, out, grad_out.contiguous(), ctx.spec,
            sh_vecs)
        return grad_geom, grad_color, None, None, None


def composite_tiles(geom: torch.Tensor, color: torch.Tensor,
                    tile_start: torch.Tensor, spec: RasterSpec,
                    sh_vecs: torch.Tensor | None = None) -> torch.Tensor:
    """Composite every tile: (T, 4, Px) rows [r, g, b, Σw], differentiable
    in ``geom`` and ``color`` through :class:`CompositeTiles`.

    CPU tensors run :func:`composite_tiles_torch`.  CUDA tensors launch a
    Hopper kernel of ``csrc/rasterize_fwd.cu`` (built at first use),
    ``rasterize_fwd`` (RGB) or ``rasterize_fwd_sh`` (SH, with ``sh_vecs``
    read on the device), which replace ``gsplat_tpu/ops/rasterize.py::
    _fwd_kernel``; a build or launch failure raises.  Any other device
    raises.  ``LAUNCHES`` counts kernel launches.
    """
    return CompositeTiles.apply(geom, color, tile_start, spec, sh_vecs)


class CompositeTilesPreset(torch.autograd.Function):
    """The render preset's compositor.  Render-only, as in JAX
    (``rasterize.py:847-850``): its backward raises."""

    @staticmethod
    def forward(ctx, geom, color, tile_start, spec, sh_vecs):
        sh = spec.color_dim != 3
        if _check_device("composite_tiles_preset",
                         (geom, color, tile_start, sh_vecs if sh else None)):
            return composite_tiles_preset_torch(geom, color, tile_start,
                                                spec, sh_vecs)
        _check_preset_inputs(geom, color, tile_start, spec, sh_vecs)
        shv = sh_vecs.contiguous() if sh else None
        _check_kernel_inputs("composite_tiles_preset", spec, geom, color,
                             tile_start)
        if color.data_ptr() % (16 if sh else 8):
            raise ValueError("preset color rows must be 16-byte (SH) or "
                             "8-byte (RGB) aligned")
        out = torch.empty((spec.n_tiles, 4, spec.px), dtype=torch.float32,
                          device=geom.device)
        _launch("rasterize_fwd_preset_sh" if sh else "rasterize_fwd_preset",
                spec, geom, color, tile_start, shv, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the bf16 render preset is render-only; train through "
            "composite_tiles (the f32 route)")


def composite_tiles_preset(geom: torch.Tensor, color: torch.Tensor,
                           tile_start: torch.Tensor, spec: RasterSpec,
                           sh_vecs: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Composite the render preset's bf16 pairs (``ops/binning.PresetPairs``)
    → (T, 4, Px) f32 rows [r, g, b, Σw].

    CPU tensors run :func:`composite_tiles_preset_torch`.  CUDA tensors
    launch ``rasterize_fwd_preset`` (RGB) or ``rasterize_fwd_preset_sh``
    (SH, with ``sh_vecs`` read on the device) of ``csrc/rasterize_fwd.cu``,
    which replace the ``packed_bf16`` variants of ``gsplat_tpu/ops/
    rasterize.py::_fwd_kernel``; a build or launch failure raises.
    Backward through it raises (render-only).
    """
    return CompositeTilesPreset.apply(geom, color, tile_start, spec, sh_vecs)


def assemble_image(tiles_color: torch.Tensor, tiles_accw: torch.Tensor,
                   spec: RasterSpec) -> torch.Tensor:
    """(T, 3, Px) + (T, Px) tile rows → (3, padded_h, padded_w) image,
    channel-major (rasterize.py:408-425)."""
    col = tiles_color
    if spec.weight_normalize:
        accw = tiles_accw[:, None, :]
        col = col / torch.where(accw < 0.01, torch.ones_like(accw), accw)
    img = col.reshape(spec.n_tile_y, spec.n_tile_x, 3, spec.tile_h,
                      spec.tile_w)
    img = img.permute(2, 0, 3, 1, 4)
    return img.reshape(3, spec.padded_h, spec.padded_w)


def rasterize(packed: PackedPairs, spec: RasterSpec,
              sh_vecs: torch.Tensor | None = None) -> torch.Tensor:
    """Packed pairs → (3, padded_h, padded_w) image, differentiable in the
    pairs' geometry and color."""
    out = composite_tiles(packed.geom, packed.color, packed.tile_start, spec,
                          sh_vecs)
    return assemble_image(out[:, :3], out[:, 3], spec)


def rasterize_preset(pairs: PresetPairs, spec: RasterSpec,
                     sh_vecs: torch.Tensor | None = None) -> torch.Tensor:
    """The render preset's pairs → (3, padded_h, padded_w) image
    (render-only)."""
    out = composite_tiles_preset(pairs.geom, pairs.color, pairs.tile_start,
                                 spec, sh_vecs)
    return assemble_image(out[:, :3], out[:, 3], spec)
