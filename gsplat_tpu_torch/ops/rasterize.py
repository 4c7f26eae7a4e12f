"""Tiled front-to-back alpha compositing: the CUDA kernels and their plain
twins, forward and backward.

The JAX package composites chunk-aligned pair buffers with the Pallas TPU
kernels ``_fwd_kernel`` / ``_bwd_kernel`` (``gsplat_tpu/ops/rasterize.py:
437-690``) behind the custom VJP ``_raster_pallas`` (``:823-877``), or with
``composite_chunks_jnp`` and autodiff.  Here the pairs arrive grouped by tile
(``ops/binning.pack_sorted``) and each direction has one contract with two
implementations:

- forward: :func:`composite_tiles_torch`, plain PyTorch vectorised over
  tiles (it steps over "the j-th chunk of every tile", with an exclusive
  cumprod of (1 − α) inside each chunk and the transmittance carried between
  chunks), and the kernel ``csrc/rasterize_fwd.cu``;
- backward: :func:`composite_tiles_bwd_torch`, the JAX backward's own
  formulas chunk by chunk (recompute α and T, d_alpha by the suffix-color
  identity, the analytic 2-D gaussian derivatives), and the kernel
  ``csrc/rasterize_bwd.cu``.

:class:`CompositeTiles` ties them together as one ``torch.autograd.Function``
and :func:`composite_tiles` calls it.  The tensors' device picks the route:
CPU tensors run the plain versions, CUDA tensors launch the kernels or raise.

Contract: ``geom (P, 8)`` f32, ``color (P, 3)`` f32, ``tile_start (T+1,)``
int32 → ``out (T, 4, Px)`` f32, rows 0–2 composited color and row 3 the
accumulated weight Σw, the TPU kernel's row layout.  The backward takes the
``(T, 4, Px)`` cotangent (row 3 is nonzero under weight normalisation) and
returns per-pair ``grad_geom (P, 8)`` (column 7 zero) and ``grad_color
(P, 3)``.  Weight normalisation happens outside, in :func:`assemble_image`,
as in JAX.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from gsplat_tpu_torch.ops.binning import PackedPairs
from gsplat_tpu_torch.ops.cuda_build import load_kernel_library

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


def _tile_pixel_coords(spec: RasterSpec, tiles: torch.Tensor):
    """Focal-normalized pixel centres on the padded grid → (len(tiles), Px)
    each (rasterize.py:174-183, same float32 arithmetic)."""
    p = torch.arange(spec.px, device=tiles.device)
    row = torch.div(p, spec.tile_w, rounding_mode="floor")
    col = p - row * spec.tile_w
    tx = (tiles % spec.n_tile_x)[:, None]
    ty = torch.div(tiles, spec.n_tile_x, rounding_mode="floor")[:, None]
    id_x = (tx * spec.tile_w + col[None, :]).to(torch.float32)
    id_y = (ty * spec.tile_h + row[None, :]).to(torch.float32)
    pxc = (id_x + 0.5 - spec.padded_w / 2) / spec.focal_x
    pyc = (id_y + 0.5 - spec.padded_h / 2) / spec.focal_y
    return pxc, pyc


def _check_inputs(geom, color, tile_start, spec: RasterSpec):
    p = geom.shape[0]
    if geom.dtype != torch.float32 or color.dtype != torch.float32:
        raise TypeError(f"geom/color must be float32, got {geom.dtype}/"
                        f"{color.dtype}")
    if tile_start.dtype != torch.int32:
        raise TypeError(f"tile_start must be int32, got {tile_start.dtype}")
    if geom.shape != (p, 8) or color.shape != (p, 3):
        raise ValueError(f"expected geom (P, 8) and color (P, 3), got "
                         f"{tuple(geom.shape)} and {tuple(color.shape)}")
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


def composite_tiles_torch(geom: torch.Tensor, color: torch.Tensor,
                          tile_start: torch.Tensor,
                          spec: RasterSpec) -> torch.Tensor:
    """Plain PyTorch compositor (the kernel's contract and yardstick)."""
    _check_inputs(geom, color, tile_start, spec)
    dev = geom.device
    t_all, px = spec.n_tiles, spec.px
    out = torch.zeros((t_all, 4, px), dtype=torch.float32, device=dev)
    pxc_all, pyc_all = _tile_pixel_coords(
        spec, torch.arange(t_all, device=dev))
    trans = torch.ones((t_all, px), dtype=torch.float32, device=dev)
    for act, pos, valid in _tile_chunks(tile_start, spec):
        g = geom[pos]                                               # (A, G, 8)
        c = color[pos]                                              # (A, G, 3)
        alpha, _, _ = _chunk_alpha(g, pxc_all[act][:, None, :],
                                   pyc_all[act][:, None, :])
        one_m, t_before, _, w = _chunk_weights(alpha, valid, trans[act])
        for ch in range(3):
            out[act, ch] += (w * c[..., ch:ch + 1]).sum(dim=1)
        out[act, 3] += w.sum(dim=1)
        trans[act] = t_before[:, -1] * one_m[:, -1]
    return out


def composite_tiles_bwd_torch(geom: torch.Tensor, color: torch.Tensor,
                              tile_start: torch.Tensor, out: torch.Tensor,
                              grad_out: torch.Tensor, spec: RasterSpec):
    """Plain PyTorch backward of the compositor (the backward kernel's
    contract and yardstick) → per-pair ``(grad_geom (P, 8), grad_color
    (P, 3))``.

    The JAX backward's own formulas (``rasterize.py:585-644``), not autograd
    through the forward: each chunk step recomputes α, T and ``live`` as
    :func:`composite_tiles_torch` does, then

      d_alpha = gc_dot·T − (gdotout − c_incl_dot) / (1 − α + 1e-7)

    where ``gc_dot = Σ_c g_c·C_c`` with Σw as a 4th color ≡ 1, ``gdotout =
    Σ_c g_c·out_c`` and ``c_incl_dot`` the inclusive running sum of
    ``w·gc_dot`` (carried between chunks).  d_alpha is zero where the pair
    is dead or the 0.9999 clamp is active; then come d_opa, the analytic
    ∂prob/∂(x, y, a, b, c, d) and ``grad_color = Σ_px g·w``.  Its working
    memory is one chunk step's (A, G, Px) planes.  Column 7 is zero.
    """
    _check_inputs(geom, color, tile_start, spec)
    _check_bwd_inputs(out, grad_out, spec)
    dev = geom.device
    t_all, px = spec.n_tiles, spec.px
    grad_geom = torch.zeros_like(geom)
    grad_color = torch.zeros_like(color)
    pxc_all, pyc_all = _tile_pixel_coords(
        spec, torch.arange(t_all, device=dev))
    trans = torch.ones((t_all, px), dtype=torch.float32, device=dev)
    carry = torch.zeros((t_all, px), dtype=torch.float32, device=dev)
    gdotout = (grad_out[:, 0] * out[:, 0] + grad_out[:, 1] * out[:, 1]
               + grad_out[:, 2] * out[:, 2] + grad_out[:, 3] * out[:, 3])
    for act, pos, valid in _tile_chunks(tile_start, spec):
        g = geom[pos]                                               # (A, G, 8)
        c = color[pos]                                              # (A, G, 3)
        alpha, prob, aux = _chunk_alpha(g, pxc_all[act][:, None, :],
                                        pyc_all[act][:, None, :])
        dx, dy, a, b, cc, d, opa, pm, pn = aux
        one_m, t_before, live, w = _chunk_weights(alpha, valid, trans[act])
        gout = grad_out[act][:, :, None, :]                     # (A, 4, 1, Px)
        gc_dot = (gout[:, 0] * c[..., 0:1] + gout[:, 1] * c[..., 1:2]
                  + gout[:, 2] * c[..., 2:3] + gout[:, 3])      # (A, G, Px)
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
        rows += [(gout[:, ch] * w).sum(dim=2) for ch in range(3)]
        rows = torch.stack(rows, dim=2)                         # (A, G, 10)
        rows_ok, pos_ok = rows[valid], pos[valid]
        grad_geom[pos_ok, :7] = rows_ok[:, :7]
        grad_color[pos_ok] = rows_ok[:, 7:]
        carry[act] = c_incl[:, -1]
        trans[act] = t_before[:, -1] * one_m[:, -1]
    return grad_geom, grad_color


def _check_device(name, tensors):
    """True for CPU tensors (plain version); False for CUDA tensors of one
    device (kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name} runs on CPU tensors (plain version) or on CUDA tensors "
            f"of one device (kernel); got {sorted(map(str, devices))}")
    return False


def _check_kernel_inputs(name, spec: RasterSpec, *tensors):
    if spec.px > 1024:
        raise ValueError(f"tile of {spec.px} pixels exceeds the kernel's "
                         "one-thread-per-pixel limit of 1024")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if tensors[0].data_ptr() % 16:
        raise ValueError("geom must be 16-byte aligned (float4 loads)")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signatures of csrc/<name>.cu: pointers, grid ints, focals, stream
_SIGNATURES = {
    "rasterize_fwd": [_PTR] * 4 + [_INT] * 6 + [_FLOAT] * 2 + [_PTR],
    "rasterize_bwd": [_PTR] * 7 + [_INT] * 6 + [_FLOAT] * 2 + [_PTR],
}


def _kernel(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu``, built and loaded
    at first use (``ops/cuda_build``)."""
    fn = getattr(load_kernel_library(name), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _composite_fwd(geom, color, tile_start, spec: RasterSpec):
    """The forward wrapper: plain version on the CPU, kernel on CUDA."""
    if _check_device("composite_tiles", (geom, color, tile_start)):
        return composite_tiles_torch(geom, color, tile_start, spec)
    _check_inputs(geom, color, tile_start, spec)
    _check_kernel_inputs("composite_tiles", spec, geom, color, tile_start)
    out = torch.empty((spec.n_tiles, 4, spec.px), dtype=torch.float32,
                      device=geom.device)
    launch = _kernel("rasterize_fwd")
    with torch.cuda.device(geom.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            geom.data_ptr(), color.data_ptr(), tile_start.data_ptr(),
            out.data_ptr(), spec.n_tiles, spec.n_tile_x, spec.tile_h,
            spec.tile_w, spec.padded_w, spec.padded_h, spec.focal_x,
            spec.focal_y, stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: CUDA error {rc}")
    composite_tiles.launches += 1
    return out


def composite_tiles_bwd(geom: torch.Tensor, color: torch.Tensor,
                        tile_start: torch.Tensor, out: torch.Tensor,
                        grad_out: torch.Tensor, spec: RasterSpec):
    """Backward of :func:`composite_tiles` → per-pair ``(grad_geom (P, 8),
    grad_color (P, 3))``, from the forward's ``out`` and its cotangent
    ``grad_out``, both ``(T, 4, Px)``.

    CPU tensors run :func:`composite_tiles_bwd_torch`.  CUDA tensors launch
    the Hopper kernel ``csrc/rasterize_bwd.cu`` (built at first use), which
    replaces ``gsplat_tpu/ops/rasterize.py::_bwd_kernel``; a build or launch
    failure raises.  The outputs start as zeros, so the rows of pairs the
    kernel never reaches (every pixel of their tile stopped before them)
    read zero.  ``composite_tiles_bwd.launches`` counts kernel launches.
    """
    if _check_device("composite_tiles_bwd",
                     (geom, color, tile_start, out, grad_out)):
        return composite_tiles_bwd_torch(geom, color, tile_start, out,
                                         grad_out, spec)
    _check_inputs(geom, color, tile_start, spec)
    _check_bwd_inputs(out, grad_out, spec)
    _check_kernel_inputs("composite_tiles_bwd", spec, geom, color,
                         tile_start, out, grad_out)
    if spec.px % 32:
        raise ValueError(f"tile of {spec.px} pixels is not a whole number "
                         "of 32-thread warps")
    grad_geom = torch.zeros_like(geom)
    grad_color = torch.zeros_like(color)
    launch = _kernel("rasterize_bwd")
    with torch.cuda.device(geom.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            geom.data_ptr(), color.data_ptr(), tile_start.data_ptr(),
            out.data_ptr(), grad_out.data_ptr(), grad_geom.data_ptr(),
            grad_color.data_ptr(), spec.n_tiles, spec.n_tile_x, spec.tile_h,
            spec.tile_w, spec.padded_w, spec.padded_h, spec.focal_x,
            spec.focal_y, stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_bwd launch failed: CUDA error {rc}")
    composite_tiles_bwd.launches += 1
    return grad_geom, grad_color


composite_tiles_bwd.launches = 0


class CompositeTiles(torch.autograd.Function):
    """The compositor with its backward, the counterpart of the custom VJP
    ``_raster_pallas`` (``rasterize.py:823-877``).  The forward saves the
    pairs and its output; the backward maps the ``(T, 4, Px)`` cotangent to
    per-pair gradients with :func:`composite_tiles_bwd`.  ``tile_start``
    and ``spec`` get none."""

    @staticmethod
    def forward(ctx, geom, color, tile_start, spec):
        out = _composite_fwd(geom, color, tile_start, spec)
        ctx.spec = spec
        ctx.save_for_backward(geom, color, tile_start, out)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        geom, color, tile_start, out = ctx.saved_tensors
        grad_geom, grad_color = composite_tiles_bwd(
            geom, color, tile_start, out, grad_out.contiguous(), ctx.spec)
        return grad_geom, grad_color, None, None


def composite_tiles(geom: torch.Tensor, color: torch.Tensor,
                    tile_start: torch.Tensor,
                    spec: RasterSpec) -> torch.Tensor:
    """Composite every tile: (T, 4, Px) rows [r, g, b, Σw], differentiable
    in ``geom`` and ``color`` through :class:`CompositeTiles`.

    CPU tensors run :func:`composite_tiles_torch`.  CUDA tensors launch the
    Hopper kernel ``csrc/rasterize_fwd.cu`` (built at first use), which
    replaces ``gsplat_tpu/ops/rasterize.py::_fwd_kernel``; a build or launch
    failure raises.  Any other device raises.  ``composite_tiles.launches``
    counts kernel launches.
    """
    return CompositeTiles.apply(geom, color, tile_start, spec)


composite_tiles.launches = 0


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


def rasterize(packed: PackedPairs, spec: RasterSpec) -> torch.Tensor:
    """Packed pairs → (3, padded_h, padded_w) image, differentiable in the
    pairs' geometry and color."""
    out = composite_tiles(packed.geom, packed.color, packed.tile_start, spec)
    return assemble_image(out[:, :3], out[:, 3], spec)
