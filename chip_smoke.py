#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gsplat_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the rasterizer kernels (gsplat_tpu_torch/csrc/rasterize_fwd.cu and
rasterize_bwd.cu, one nvcc each, in parallel, for sm_90a into
gsplat_tpu_torch/_build/), five entry points: the f32 RGB forward and
backward, the SH forward and backward (27 coefficients) and the bf16 render
preset's forward.  It holds each against its plain PyTorch version on a
tiny input, on a small scene (a tile of more than 256 pairs, an empty tile,
near-opaque, weight normalisation) and on one full-size view.  Then it
drives the port's paths on the bench scene (506,627 gaussians, 1297x840,
bench.py:84) through their entry points:

- RGB serving: 8 evaluation requests (make_eval_step: image, PSNR, SSIM)
  and 2 headless renders at 1024x656 (render_offscreen with the default
  config: the bf16 render preset);
- RGB training: 24 steps of make_train_step (TrainConfig defaults, SSIM
  weight 0.1, lr 1e-3 for every group as bench.py:274) over the 8 cameras
  whose ground truth it renders from a jittered copy of the table;
- SH serving, on the same scene with 27 SH coefficients (random degree-1/2
  bands, sh_ampl 0.35): 4 evaluation requests and 1 render_offscreen at
  sh_order=2 (SH keeps the f32 route in Fast Mode);
- SH training: 12 steps of make_train_step over 4 cameras.

Each path runs with the launch counts set to 0 just before it and read just
after.  It checks every output, compares one train step through the
kernels with one assembled from the plain versions (RGB and SH), measures
the preset's PSNR against the f32 render, times the routes per stage with
CUDA events, and prints:

- a JSON line {"kernels": [...]} with each entry point's launches on the
  paths, its max abs difference from the plain version and both times;
- the card's name and power limit (nvidia-smi);
- last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero without that last
line; so does a machine without CUDA.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL = 2e-4          # forward kernels vs plain, max abs on tile rows (the
                    # bound of tests/test_rasterize.py:40-41 against the
                    # oracle)
# backward kernels vs plain, per pair: |k - p| <= BWD_ATOL * colmax(p) +
# BWD_RTOL * |p|, the bound of tests/test_rasterize.py:96 with its atol taken
# relative to each column's largest gradient (covariance gradients reach
# ~1e3 in focal-normalised units); reason: summation order over 256 pixels,
# and pixels on the other side of the 1e-4 stop
BWD_ATOL, BWD_RTOL = 3e-4, 2e-3
FULL_REL_L2 = 1e-3  # backward at full size: relative L2 per column group
N_GAUSS, WIDTH, HEIGHT, FOCAL = 506_627, 1297, 840, 1000.0   # bench.py:84
N_CAMS = 48
EVAL_IDS = (0, 6, 12, 18, 24, 30, 36, 42)
OFFSCREEN = (1024, 656)
LR = 1e-3           # every group (bench.py:274)
# 24 steps, each of the 8 cameras 3 times; the third pass starts with the
# cameras' second half so the first and the last 4 steps see the same views
TRAIN_ORDER = EVAL_IDS * 2 + EVAL_IDS[4:] + EVAL_IDS[:4]
SH_AMPL = 0.35      # view-dependent bands (scripts/make_synth_scene.py:52)
SH_EVAL_IDS = (0, 12, 24, 36)
# 12 steps; the first and the last 4 see the same 4 views
SH_TRAIN_ORDER = SH_EVAL_IDS * 2 + SH_EVAL_IDS[2:] + SH_EVAL_IDS[:2]
JAX_PRESET_PSNR = 66.03   # BENCH_r05.json: JAX on a TPU v5e, image quality
DEVICE = "cuda:0"   # one card
_FWD, _BWD = "gsplat_tpu_torch/csrc/rasterize_fwd.cu", \
    "gsplat_tpu_torch/csrc/rasterize_bwd.cu"
KERNELS = {         # entry point → (source, the TPU kernel it replaces)
    "rasterize_fwd": (_FWD, "gsplat_tpu/ops/rasterize.py:437"),
    "rasterize_fwd_sh": (_FWD, "gsplat_tpu/ops/rasterize.py:459"),
    "rasterize_fwd_preset": (_FWD, "gsplat_tpu/ops/rasterize.py:475"),
    "rasterize_bwd": (_BWD, "gsplat_tpu/ops/rasterize.py:531"),
    "rasterize_bwd_sh": (_BWD, "gsplat_tpu/ops/rasterize.py:646"),
}
GROUPS = {"xy": (0, 2), "cov": (2, 6), "opa": (6, 7)}   # grad_geom columns


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def small_scene(device, opaque=False, sh=False):
    """The image-space scene of tests/test_torch_cuda.py on 4x3 tiles of
    16 px: tile (0, 0) holds more than 256 pairs (two kernel batches) and
    the right tile column stays empty.  → (packed, rspec, bspec, sh_vecs);
    with ``sh``, SH color (synthetic.image_space_sh), else sh_vecs None."""
    import torch

    from gsplat_tpu_torch.ops.binning import BinningSpec, pack_sorted
    from gsplat_tpu_torch.ops.rasterize import RasterSpec
    from gsplat_tpu_torch.synthetic import image_space_pairs, image_space_sh

    focal = 40.0
    geom, color, depth, visible, geo = image_space_pairs(
        0, n=640, crowd=320, focal=focal)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    shv = None
    if sh:
        color, shv = image_space_sh(0, color, geo, focal)
        shv = torch.from_numpy(shv).to(device)
    bspec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], 16, 16, focal, focal,
                       color_dim=27 if sh else 3)
    arrays = [torch.from_numpy(a).to(device)
              for a in (geom, color, depth, visible)]
    return pack_sorted(bspec, *arrays), rspec, bspec, shv


def cotangent(seed, shape, device, wn=True):
    """A random (T, 4, Px) cotangent from a numpy seed; row 3 (Σw) only
    when weight normalisation is on."""
    import torch

    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if not wn:
        g[:, 3] = 0.0
    return torch.from_numpy(g).to(device)


def bwd_compare(rz, packed, out, go, rspec, shv=None):
    """Backward kernel vs plain on the same pairs → (max abs, worst ratio
    to the per-pair bound, relative L2 per column group)."""
    import torch

    gg, gc = rz.composite_tiles_bwd(packed.geom, packed.color,
                                    packed.tile_start, out, go, rspec, shv)
    torch.cuda.synchronize()
    rg, rc = rz.composite_tiles_bwd_torch(packed.geom, packed.color,
                                          packed.tile_start, out, go, rspec,
                                          shv)
    check(bool((gg[:, 7] == 0).all()), "backward kernel wrote column 7")
    check(bool(torch.isfinite(gg).all() and torch.isfinite(gc).all()),
          "backward kernel: non-finite gradients")
    ratio, rel = 0.0, {}
    for k, r in ((gg, rg), (gc, rc)):
        bound = BWD_ATOL * r.abs().amax(0, keepdim=True) + BWD_RTOL * r.abs()
        ratio = max(ratio, float(((k - r).abs() / bound.clamp_min(1e-30))
                                 .max()))
    for name, (a, b) in GROUPS.items():
        rel[name] = float((gg[:, a:b] - rg[:, a:b]).norm()
                          / rg[:, a:b].norm().clamp_min(1e-30))
    rel["color"] = float((gc - rc).norm() / rc.norm().clamp_min(1e-30))
    err = max(float((gg - rg).abs().max()), float((gc - rc).abs().max()))
    return err, ratio, rel


def staged_frame(params, live, rot, tran, grid, cfg, bspec, rspec,
                 composite, events=None, shv=None, preset=False):
    """One render, stage by stage (the body of render_padded + crop), with
    the compositor passed in (its ``sh_vecs`` argument gets ``shv``; with
    ``preset`` it takes the bf16 preset pairs); records CUDA events between
    stages.  Returns the image and a dict of the intermediates."""
    import torch

    from gsplat_tpu_torch.ops.binning import pack_preset, pack_sorted
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.rasterize import assemble_image

    if events:
        events[0].record()
    proj = project_gaussians(
        params["pos"], params["quat"], params["scale"], rot, tran,
        near=cfg.near, half_width=grid.width * 1.2 / 2 / grid.focal_x,
        half_height=grid.height * 1.2 / 2 / grid.focal_y,
        scale_activation=cfg.scale_activation)
    visible = proj.visible & live
    opa = torch.sigmoid(params["opa"])
    color = params["rgb"] if cfg.use_sh_coeff else torch.sigmoid(
        params["rgb"])
    geom_n = torch.cat([proj.mean2d, proj.cov2d, opa[:, None],
                        torch.zeros_like(opa)[:, None]], dim=1)
    if events:
        events[1].record()
    packed = pack_sorted(bspec, geom_n, color, proj.depth, visible)
    pairs = pack_preset(bspec, packed) if preset else packed
    if events:
        events[2].record()
    if preset:
        out = composite(pairs.geom, pairs.color, pairs.tile_start, rspec)
    else:
        out = composite(packed.geom, packed.color, packed.tile_start, rspec,
                        shv)
    padded = assemble_image(out[:, :3], out[:, 3], rspec)
    img = torch.clamp(padded, 0.0, 1.0)
    t, l = grid.crop_top, grid.crop_left
    img = img[:, t:t + grid.height, l:l + grid.width]
    if events:
        events[3].record()
    return img, {"packed": packed, "pairs": pairs, "out": out,
                 "geom_n": geom_n, "padded": padded}


def plain_composite(backward=None):
    """The plain compositor with its plain backward (or ``backward``), as
    one autograd function: the counterpart of CompositeTiles on the plain
    versions."""
    import torch

    from gsplat_tpu_torch.ops import rasterize as rz

    bwd = backward or rz.composite_tiles_bwd_torch

    class PlainComposite(torch.autograd.Function):
        @staticmethod
        def forward(ctx, geom, color, tile_start, spec, shv):
            out = rz.composite_tiles_torch(geom, color, tile_start, spec, shv)
            ctx.spec = spec
            ctx.save_for_backward(geom, color, tile_start, out, shv)
            return out

        @staticmethod
        def backward(ctx, grad_out):
            geom, color, tile_start, out, shv = ctx.saved_tensors
            gg, gc = bwd(geom, color, tile_start, out,
                         grad_out.contiguous(), ctx.spec, shv)
            return gg, gc, None, None, None

    return PlainComposite.apply


def staged_step(st, rot, tran, gt, grid, cfg, tcfg, bspec, rspec, composite,
                marks=None, shv=None):
    """One train step assembled stage by stage: the body of make_train_step
    under TrainConfig defaults (no regularizers), with the compositor passed
    in.  With ``marks`` (a list), records a CUDA event at the end of each
    stage, the backward's stages through gradient hooks, in stream order.
    Returns (loss, grads, new params, new Adam state)."""
    import torch

    from gsplat_tpu_torch.ops.losses import l1_loss, ssim
    from gsplat_tpu_torch.train import GROUP_ORDER, adam_update

    def mark(label):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((label, ev))

    def hook(tensor, label):
        if marks is not None:
            tensor.register_hook(lambda grad: mark(label))

    check(tcfg.scale_reg == 0 and tcfg.opa_reg == 0,
          "staged_step has no regularizers")
    params = {k: st.params[k].detach().requires_grad_(True)
              for k in GROUP_ORDER}
    mark("start")
    with torch.enable_grad():
        img, mid = staged_frame(params, st.live, rot, tran, grid, cfg, bspec,
                                rspec, composite, shv=shv)
        w = tcfg.ssim_weight
        loss = (1 - w) * l1_loss(img, gt) \
            + w * (1.0 - ssim(img, gt, data_range=1.0, layout="chw"))
        mark("forward")
        hook(img, "backward: L1 + SSIM")
        hook(mid["out"], "backward: crop, clamp, assemble")
        hook(mid["packed"].geom, "backward: rasterizer")
        hook(mid["geom_n"], "backward: pack (row scatter-add)")
        grads = dict(zip(GROUP_ORDER, torch.autograd.grad(
            loss, [params[k] for k in GROUP_ORDER])))
        mark("backward: projection, activations")
    with torch.no_grad():
        new_p, new_opt = adam_update(st.params, grads, st.opt,
                                     torch.full((5,), LR, device=gt.device),
                                     tcfg.adam_b1, tcfg.adam_b2,
                                     tcfg.adam_eps)
        torch.maximum(st.accum_grad, torch.abs(grads["pos"]))  # as the step
    mark("Adam + accumulate")
    return loss.detach(), grads, new_p, new_opt


def reset_launches(rz):
    for name in rz.LAUNCHES:
        rz.LAUNCHES[name] = 0


def ground_truth_splat(table, cams, cfg, bspec, rspec, eval_ids,
                       composite_plain):
    """Render each evaluated camera's ground truth from the table with
    positions jittered by σ = 0.01 (plain route, bench.py:160-186) into
    ``cams["images"]`` and return the Splatter over the table and the
    scene's cameras."""
    import torch

    from gsplat_tpu_torch.models.splatter import SceneCameras, Splatter

    params, live = table.params(), table.live
    tgt = dict(params)
    jit_rng = np.random.default_rng(1)
    tgt["pos"] = params["pos"] + torch.from_numpy(
        jit_rng.normal(0, 0.01, tuple(params["pos"].shape)).astype(
            np.float32)).to(params["pos"].device)
    images = cams["images"]
    grid = cams["grid"]
    with torch.no_grad():
        for cid in eval_ids:
            gt, _ = staged_frame(tgt, live, cams["w2c_rot"][cid],
                                 cams["w2c_tran"][cid], grid, cfg, bspec,
                                 rspec, composite_plain,
                                 shv=cams["sh_vecs"][cid])
            images[cid] = (gt * 255).to(torch.uint8)
    return Splatter.from_scene(cfg, table, [SceneCameras(
        w2c_rot=cams["w2c_rot"], w2c_tran=cams["w2c_tran"],
        sh_vecs=cams["sh_vecs"], images=images, grid=grid,
        names=[f"cam{i:02d}" for i in range(N_CAMS)])])


def offscreen_poses(cams, cids):
    poses = []
    for cid in cids:
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = cams["w2c_rot"][cid].cpu().numpy()
        w2c[:3, 3] = cams["w2c_tran"][cid].cpu().numpy()
        poses.append(w2c)
    return poses


def check_eval(results, eval_ids):
    import torch

    for cid, (img, p, s) in zip(eval_ids, results):
        check(img.shape == (3, HEIGHT, WIDTH), f"eval image {img.shape}")
        check(bool(torch.isfinite(img).all()) and float(img.min()) >= 0
              and float(img.max()) <= 1, f"eval image {cid} not in [0, 1]")
        check(np.isfinite(float(p)) and np.isfinite(float(s)),
              f"camera {cid}: non-finite metrics")
        print(f"  eval cam {cid:2d}: psnr {float(p):.4f}  ssim "
              f"{float(s):.6f}", flush=True)


def check_frames(frames, shape):
    for fr in frames:
        check(fr.shape == shape, f"offscreen frame {fr.shape}")
        check(bool(np.isfinite(fr).all()) and fr.min() >= 0
              and fr.max() <= 1, "offscreen frame not in [0, 1]")
    means = [round(float(f.mean()), 6) for f in frames]
    print(f"  offscreen {shape[1]}x{shape[0]}: image means {means}",
          flush=True)


def train_burst(rz, label, train_step, eval_step, state0, order, lrs):
    """Drive make_train_step over ``order`` with the counts reset first;
    check the loss falls (same cameras first and last) and camera 0's PSNR
    rises.  → (final state, launches of this path)."""
    import torch

    from gsplat_tpu_torch.train import GROUP_ORDER

    phase(f"{label} training path: {len(order)} steps of make_train_step")
    live = state0.live
    psnr0 = float(eval_step(state0.params, live, 0)[1])
    torch.cuda.synchronize()
    reset_launches(rz)
    st, losses, metrics = state0, [], []
    t0 = time.perf_counter()
    for cid in order:
        st, m = train_step(st, cid, lrs)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(rz.LAUNCHES)
    print(f"{len(order)} steps in {wall:.3f} s wall; kernel launches "
          f"{json.dumps(launches)}", flush=True)
    for cid, m in zip(order, metrics):
        losses.append(float(m["loss"]))
        gm = {k: float(v) for k, v in m["grad_mean"].items()}
        check(np.isfinite(losses[-1]) and all(map(np.isfinite, gm.values())),
              f"camera {cid}: non-finite loss or gradient")
    for k in GROUP_ORDER:
        check(bool(torch.isfinite(st.params[k]).all()
                   and torch.isfinite(st.opt.mu[k]).all()),
              f"non-finite {k} after training")
    print("  loss per step: " + " ".join(f"{x:.5f}" for x in losses))
    m = metrics[-1]
    print(f"  last step: n_pairs {int(m['n_pairs'])}  n_visible "
          f"{int(m['n_visible'])}  n_clipped {int(m['n_clipped'])}  "
          f"grad_mean " + json.dumps({k: float(v) for k, v in
                                      m["grad_mean"].items()}), flush=True)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    psnr1 = float(eval_step(st.params, live, 0)[1])
    print(f"  mean loss, first 4 steps {first:.6f}, last 4 (same cameras) "
          f"{last:.6f}; camera 0 psnr {psnr0:.4f} -> {psnr1:.4f} dB",
          flush=True)
    check(last < first, f"{label}: the loss did not fall over the burst")
    check(psnr1 > psnr0, f"{label}: camera 0's PSNR did not rise")
    return st, launches


def one_step_check(rz, label, train_step, state0, cams, cid, cfg, tcfg,
                   bspec, rspec, lrs):
    """One make_train_step through the kernels against one assembled from
    the plain versions, from the same state."""
    import torch

    from gsplat_tpu_torch.models.splatter import render_cropped
    from gsplat_tpu_torch.train import GROUP_ORDER

    phase(f"{label}: one train step, make_train_step vs the plain versions")
    grid = cams["grid"]
    params, live = state0.params, state0.live
    rot, tran = cams["w2c_rot"][cid], cams["w2c_tran"][cid]
    shv = cams["sh_vecs"][cid]
    gt = cams["images"][cid].to(torch.float32) / 255.0
    st_k, m_k = train_step(state0, cid, lrs)
    loss_p, g_p, new_p, opt_p = staged_step(state0, rot, tran, gt, grid, cfg,
                                            tcfg, bspec, rspec,
                                            plain_composite(), shv=shv)
    torch.cuda.synchronize()
    d_loss = abs(float(m_k["loss"]) / float(loss_p) - 1)
    print(f"  loss kernel {float(m_k['loss']):.7f} plain {float(loss_p):.7f}"
          f" (rel {d_loss:.2e})", flush=True)
    check(d_loss <= 1e-5, f"{label} one step: loss differs")
    with torch.no_grad():
        # L1 is discontinuous where the image meets its 8-bit ground truth:
        # pixels whose residual changes sign between the two forwards get
        # an opposite L1 cotangent
        img_k, _ = render_cropped(params, live, rot, tran, grid, cfg, bspec,
                                  rspec, shv)
        img_p, _ = staged_frame(params, live, rot, tran, grid, cfg, bspec,
                                rspec, rz.composite_tiles_torch, shv=shv)
        flips = int((torch.sign(img_k - gt) != torch.sign(img_p - gt)).sum())
    print(f"  pixels whose L1 sign differs between the routes: {flips}",
          flush=True)
    # the backward kernel's own share: the plain forward with the kernel
    # backward against the all-plain step (the same image cotangent)
    _, g_h, _, _ = staged_step(state0, rot, tran, gt, grid, cfg, tcfg, bspec,
                               rspec, plain_composite(rz.composite_tiles_bwd),
                               shv=shv)
    rel_h = {k: float((g_h[k] - g_p[k]).norm() / g_p[k].norm())
             for k in GROUP_ORDER}
    print("  plain forward + kernel backward vs all plain, grad rel L2: "
          + json.dumps(rel_h), flush=True)
    del g_h
    b1 = tcfg.adam_b1
    for k in GROUP_ORDER:
        # from zero moments mu = (1 - b1)·g, so the kernel step's gradient
        # is mu / (1 - b1) up to one rounding
        g_k = st_k.opt.mu[k] / (1 - b1)
        rel = float((g_k - g_p[k]).norm() / g_p[k].norm().clamp_min(1e-30))
        dp = (st_k.params[k] - new_p[k]).abs()
        far = int((dp > 0.01 * LR).sum())
        i = int(dp.argmax())
        print(f"  {k:5s}: grad rel L2 {rel:.2e}; new params: {far} of "
              f"{dp.numel()} elements beyond 0.01 lr, max abs diff "
              f"{float(dp.max()):.3e} where g = {float(g_k.flatten()[i]):.3e}"
              f" (kernel) / {float(g_p[k].flatten()[i]):.3e} (plain)",
              flush=True)
        check(rel <= 1e-3, f"{label} one step: {k} gradients differ")
        # Adam's first step maps g to ~g/(|g| + 1e-8), a step of ~lr·sign(g)
        # wherever |g| >> 1e-8: a gradient near zero, or one that crosses a
        # discontinuity (L1's sign, a pixel either side of the 1e-4 stop),
        # moves by up to 2·lr between the routes.  Bound: every element
        # within 2·lr, and at most 1e-4 of the elements beyond 0.01·lr.
        check(bool((dp <= 2 * LR).all()), f"{label}: {k} params exploded")
        check(far <= 1e-4 * dp.numel(),
              f"{label} one step: {k}: {far} elements beyond 0.01 lr")
    del st_k, new_p, opt_p, g_p
    torch.cuda.empty_cache()


def time_frames(routes, order, params, live, cams, cids, cfg, bspec, rspec):
    """CUDA events per stage of staged_frame, routes taken in ``order``
    (2 warm-up views each time); → {route: [per-view rows]}."""
    import torch

    grid = cams["grid"]
    stats = {r: [] for r in routes}
    with torch.no_grad():
        for route in order:
            fn, preset = routes[route]
            for cid in cids[:2]:           # warm-up
                staged_frame(params, live, cams["w2c_rot"][cid],
                             cams["w2c_tran"][cid], grid, cfg, bspec, rspec,
                             fn, shv=cams["sh_vecs"][cid], preset=preset)
            for cid in cids:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                _, mid = staged_frame(params, live, cams["w2c_rot"][cid],
                                      cams["w2c_tran"][cid], grid, cfg,
                                      bspec, rspec, fn, events=ev,
                                      shv=cams["sh_vecs"][cid], preset=preset)
                torch.cuda.synchronize()
                pk = mid["packed"]
                stats[route].append(
                    (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                     ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[3]),
                     int(pk.n_pairs), int(pk.n_clipped), int(pk.n_visible)))
    for route, rows in stats.items():
        m = np.mean(np.array([r[:4] for r in rows]), axis=0)
        print(f"  {route:12s} ms/frame {m[3]:.3f}  (project {m[0]:.3f}  "
              f"pack {m[1]:.3f}  composite+assemble+crop {m[2]:.3f}); "
              f"{len(rows)} frames", flush=True)
    return stats


def time_steps(label, train_step, st, cams, cids, cfg, tcfg, bspec, rspec,
               lrs, composite):
    """make_train_step ms/step (CUDA events, 2 warm-up steps), then a step
    assembled stage by stage, by stage."""
    import torch

    grid = cams["grid"]
    for cid in cids[:2]:                    # warm-up
        st, _ = train_step(st, cid, lrs)
    torch.cuda.synchronize()
    step_ms = []
    for cid in cids:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        st, _ = train_step(st, cid, lrs)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    print(f"  {label} make_train_step ms/step {np.mean(step_ms):.3f} (min "
          f"{np.min(step_ms):.3f}, max {np.max(step_ms):.3f}); "
          f"{len(step_ms)} steps", flush=True)
    parts = {}
    for i, cid in enumerate(cids[:2] + cids):
        marks = []
        staged_step(st, cams["w2c_rot"][cid], cams["w2c_tran"][cid],
                    cams["images"][cid].to(torch.float32) / 255.0, grid, cfg,
                    tcfg, bspec, rspec, composite, marks=marks,
                    shv=cams["sh_vecs"][cid])
        torch.cuda.synchronize()
        if i < 2:
            continue                        # warm-up
        for (_, a), (lab, b) in zip(marks, marks[1:]):
            parts.setdefault(lab, []).append(a.elapsed_time(b))
    total = sum(np.mean(v) for v in parts.values())
    print(f"  {label} staged kernel-route step ms {total:.3f}, by stage "
          f"(stream order, mean of {len(cids)} steps):", flush=True)
    for lab, v in parts.items():
        print(f"    {lab:36s} {np.mean(v):8.3f}")
    return float(np.mean(step_ms))


def time_fn(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    import torch

    # ---- 1. environment ---------------------------------------------------
    phase("environment")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import gsplat_tpu_torch  # noqa: F401  (fails outside the repository)
    from gsplat_tpu_torch.config import SplatConfig, TrainConfig
    from gsplat_tpu_torch.models.splatter import make_specs, render_cropped
    from gsplat_tpu_torch.ops import cuda_build, rasterize as rz
    from gsplat_tpu_torch.ops.binning import pack_preset
    from gsplat_tpu_torch.ops.losses import psnr
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table
    from gsplat_tpu_torch.train import (init_train_state, make_eval_step,
                                        make_train_step)
    from gsplat_tpu_torch.viewer import render_offscreen

    check("jax" not in sys.modules, "the port pulled in jax")
    check(set(KERNELS) == set(rz.KERNELS), "KERNELS out of step with the "
          "port's entry points")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {kind}  count {torch.cuda.device_count()}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    max_err = {name: 0.0 for name in KERNELS}

    def note_err(name, err):
        max_err[name] = max(max_err[name], float(err))

    # ---- 2. build the kernels (one nvcc per source, in parallel) ----------
    phase("build")
    t0 = time.perf_counter()
    sources = sorted({src for src, _ in rz.KERNELS.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.load_kernel_library, sources))
    for name in KERNELS:
        rz._kernel(name)
    print(f"built {len(sources)} libraries ({len(KERNELS)} entry points) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src in sources:
        info = cuda_build.BUILD_INFO[src]
        print(f"  {src}: {info['path']} (nvcc {info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line
                print(f"    ptxas: {kernel}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"    ptxas: {line.strip()}")

    phase("tiny launches: kernel vs plain")
    tiny = rz.RasterSpec(2, 1, 16, 16, 20.0, 20.0)
    tiny_sh = tiny._replace(color_dim=27)
    g = torch.tensor([[0.1, 0.05, 0.01, 0.002, 0.002, 0.02, 0.8, 0.0]],
                     device=dev)
    c = torch.tensor([[0.2, 0.5, 0.9]], device=dev)
    c_sh = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.5, (1, 27)).astype(np.float32)).to(dev)
    shv_t = torch.tensor([[0.0, 0.0, 0.0], [-0.8, -0.4, 1.0],
                          [0.05, 0.0, 0.0], [0.0, 0.05, 0.0]], device=dev)
    s = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)
    for name, col, spec, shv in (("rasterize_fwd", c, tiny, None),
                                 ("rasterize_fwd_sh", c_sh, tiny_sh, shv_t)):
        out_k = rz.composite_tiles(g, col, s, spec, shv)
        torch.cuda.synchronize()
        err = float((out_k - rz.composite_tiles_torch(g, col, s, spec, shv))
                    .abs().max())
        print(f"  {name}: max abs diff {err:.3e}", flush=True)
        check(err <= TOL, f"tiny {name} launch disagrees: {err}")
        note_err(name, err)
        one = types.SimpleNamespace(geom=g, color=col, tile_start=s)
        bwd = name.replace("fwd", "bwd")
        err, ratio, _ = bwd_compare(rz, one, out_k,
                                    cotangent(0, tuple(out_k.shape), dev),
                                    spec, shv)
        print(f"  {bwd}: max abs diff {err:.3e} ({ratio:.3f} of the bound)",
              flush=True)
        check(ratio <= 1.0, f"tiny {bwd} launch disagrees: {err}")
        note_err(bwd, err)
    g16 = torch.cat([g[:, :2] - torch.tensor([[-0.4, 0.0]], device=dev),
                     g[:, 2:]], 1).to(torch.bfloat16)
    c16 = torch.cat([c, torch.zeros_like(c[:, :1])], 1).to(torch.bfloat16)
    out_k = rz.composite_tiles_preset(g16, c16, s, tiny)
    torch.cuda.synchronize()
    err = float((out_k - rz.composite_tiles_preset_torch(g16, c16, s, tiny))
                .abs().max())
    print(f"  rasterize_fwd_preset: max abs diff {err:.3e}", flush=True)
    check(err <= TOL, f"tiny preset launch disagrees: {err}")
    note_err("rasterize_fwd_preset", err)

    # ---- 3. kernels against the plain versions: small scene ---------------
    phase("kernels vs plain: small scene")
    for opaque in (False, True):
        for sh in (False, True):
            packed, rspec_s, bspec_s, shv = small_scene(dev, opaque, sh)
            fwd = "rasterize_fwd_sh" if sh else "rasterize_fwd"
            counts = torch.diff(packed.tile_start)
            check(int(counts.max()) > 256 and int((counts == 0).sum()) > 0,
                  "small scene needs a tile of > 256 pairs and an empty tile")
            a = rz.composite_tiles(packed.geom, packed.color,
                                   packed.tile_start, rspec_s, shv)
            b = rz.composite_tiles_torch(packed.geom, packed.color,
                                         packed.tile_start, rspec_s, shv)
            torch.cuda.synchronize()
            d = (a - b).abs()
            print(f"  {fwd} opaque={opaque}: max abs {float(d.max()):.3e}  "
                  f"mean abs {float(d.mean()):.3e}  (max pairs per tile "
                  f"{int(counts.max())})", flush=True)
            check(float(d.max()) <= TOL, f"small scene: {fwd} disagrees")
            check(bool((a[counts == 0] == 0).all()),
                  f"small scene: {fwd} wrote nonzero empty tiles")
            note_err(fwd, d.max())
            for wn in (False, True):
                go = cotangent(1 + wn, tuple(a.shape), dev, wn)
                err, ratio, rel = bwd_compare(rz, packed, b, go, rspec_s, shv)
                bwd = fwd.replace("fwd", "bwd")
                print(f"  {bwd} opaque={opaque} weight_normalize={wn}: max "
                      f"abs {err:.3e} ({ratio:.3f} of the per-pair bound); "
                      f"rel L2 {json.dumps(rel)}", flush=True)
                check(ratio <= 1.0, f"small scene: {bwd} disagrees")
                note_err(bwd, err)
                # NaN in the empty tiles' rows must reach no pair
                empty = counts == 0
                b2, go2 = b.clone(), go.clone()
                b2[empty] = float("nan")
                go2[empty] = float("nan")
                ref = rz.composite_tiles_bwd(packed.geom, packed.color,
                                             packed.tile_start, b, go,
                                             rspec_s, shv)
                nan = rz.composite_tiles_bwd(packed.geom, packed.color,
                                             packed.tile_start, b2, go2,
                                             rspec_s, shv)
                check(all(torch.equal(x, y) for x, y in zip(ref, nan)),
                      f"{bwd}: NaN in empty tiles' rows reached a pair")
            if not sh:
                pp = pack_preset(bspec_s, packed)
                a = rz.composite_tiles_preset(pp.geom, pp.color,
                                              pp.tile_start, rspec_s)
                b = rz.composite_tiles_preset_torch(pp.geom, pp.color,
                                                    pp.tile_start, rspec_s)
                torch.cuda.synchronize()
                d = float((a - b).abs().max())
                print(f"  rasterize_fwd_preset opaque={opaque}: max abs "
                      f"{d:.3e}", flush=True)
                check(d <= TOL, "small scene: preset kernel disagrees")
                note_err("rasterize_fwd_preset", d)

    phase("scene: bench.py synthetic table")
    t0 = time.perf_counter()
    table = synthetic_table(N_GAUSS, focal=FOCAL, scale_px=2.5,
                            frustum=(0.85, 0.55), device=dev)
    cams = synthetic_cameras(N_CAMS, WIDTH, HEIGHT, FOCAL, device=dev)
    grid = cams["grid"]
    cfg = SplatConfig()
    tcfg = TrainConfig(ssim_weight=0.1)
    bspec, rspec = make_specs(grid, cfg)
    params, live = table.params(), table.live
    print(f"{N_GAUSS} gaussians (capacity {table.capacity}), {N_CAMS} "
          f"cameras {WIDTH}x{HEIGHT}, {grid.n_tile_x}x{grid.n_tile_y} tiles; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    phase("kernels vs plain: full-size view")
    with torch.no_grad():
        _, mid0 = staged_frame(params, live, cams["w2c_rot"][0],
                               cams["w2c_tran"][0], grid, cfg, bspec,
                               rspec, rz.composite_tiles)
        pk0, out_k = mid0["packed"], mid0["out"]
        out_p = rz.composite_tiles_torch(pk0.geom, pk0.color, pk0.tile_start,
                                         rspec)
    torch.cuda.synchronize()
    d = (out_k - out_p).abs()
    print(f"  rasterize_fwd, n_pairs {int(pk0.n_pairs)}: max abs "
          f"{float(d.max()):.3e}  mean abs {float(d.mean()):.3e}", flush=True)
    check(float(d.max()) <= TOL, "full-size view: forward kernel disagrees")
    note_err("rasterize_fwd", d.max())
    go0 = cotangent(3, tuple(out_k.shape), dev)
    with torch.no_grad():
        err, ratio, rel = bwd_compare(rz, pk0, out_k, go0, rspec)
    print(f"  rasterize_bwd: max abs {err:.3e} ({ratio:.3f} of the per-pair "
          f"bound); rel L2 {json.dumps(rel)}", flush=True)
    check(max(rel.values()) <= FULL_REL_L2,
          f"full-size view: backward kernel disagrees ({rel})")
    note_err("rasterize_bwd", err)
    with torch.no_grad():
        _, midp = staged_frame(params, live, cams["w2c_rot"][0],
                               cams["w2c_tran"][0], grid, cfg, bspec, rspec,
                               rz.composite_tiles_preset, preset=True)
        pp0, out_pk = midp["pairs"], midp["out"]
        out_pp = rz.composite_tiles_preset_torch(pp0.geom, pp0.color,
                                                 pp0.tile_start, rspec)
    torch.cuda.synchronize()
    d = float((out_pk - out_pp).abs().max())
    print(f"  rasterize_fwd_preset: max abs {d:.3e}", flush=True)
    check(d <= TOL, "full-size view: preset kernel disagrees")
    note_err("rasterize_fwd_preset", d)
    # the preset's image quality against the f32 render, padded images
    # clipped to [0, 1] as bench.py:233-245 scores it
    preset_psnr = float(psnr(torch.clamp(midp["padded"], 0, 1),
                             torch.clamp(mid0["padded"], 0, 1), 1.0))
    print(f"  preset vs f32 PSNR at camera 0: {preset_psnr:.2f} dB (JAX "
          f"package on a TPU v5e, depth quantisation on: "
          f"{JAX_PRESET_PSNR} dB, BENCH_r05.json)", flush=True)
    check(preset_psnr > 40, "preset image far from the f32 render")
    del mid0, midp, out_p, out_pp
    torch.cuda.empty_cache()

    # ---- 4. ground truth, the scene's cameras -----------------------------
    phase("ground truth: jittered table, plain route (bench.py:160-186)")
    splat = ground_truth_splat(table, cams, cfg, bspec, rspec, EVAL_IDS,
                               rz.composite_tiles_torch)
    images = cams["images"]
    eval_step = make_eval_step(splat)
    train_step = make_train_step(splat, tcfg)
    off_w, off_h = OFFSCREEN
    off_f = FOCAL * off_w / WIDTH
    w2cs = offscreen_poses(cams, (1, 2))
    torch.cuda.synchronize()

    # ---- 5. serving path --------------------------------------------------
    phase("serving path: 8 eval requests + 2 offscreen renders (default "
          "config: the bf16 render preset)")
    reset_launches(rz)
    t0 = time.perf_counter()
    results = [eval_step(params, live, cid) for cid in EVAL_IDS]
    frames = [render_offscreen(splat, w2c, off_w, off_h, off_f, off_f)
              for w2c in w2cs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve = dict(rz.LAUNCHES)
    print(f"{len(results) + len(frames)} frames in {wall:.3f} s wall; "
          f"kernel launches {json.dumps(serve)}", flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=len(results), rasterize_fwd_preset=len(frames))
    check(serve == want, f"serving launches {serve} != {want}")
    check_eval(results, EVAL_IDS)
    check_frames(frames, (off_h, off_w, 3))

    phase("output check: kernel route vs plain route, same view")
    with torch.no_grad():
        img_p, _ = staged_frame(params, live, cams["w2c_rot"][EVAL_IDS[1]],
                                cams["w2c_tran"][EVAL_IDS[1]], grid, cfg,
                                bspec, rspec, rz.composite_tiles_torch)
        img_r, _ = render_cropped(params, live, cams["w2c_rot"][EVAL_IDS[1]],
                                  cams["w2c_tran"][EVAL_IDS[1]], grid, cfg,
                                  bspec, rspec)
    img_k = results[1][0]
    d_img = float((img_k - img_p).abs().max())
    gt1 = images[EVAL_IDS[1]].to(torch.float32) / 255.0
    print(f"  image max abs {d_img:.3e}; psnr kernel "
          f"{float(psnr(img_k, gt1, 1.0)):.4f} plain "
          f"{float(psnr(img_p, gt1, 1.0)):.4f}", flush=True)
    check(d_img <= TOL, "kernel-route image differs from the plain route")
    check(bool(torch.equal(img_r, img_k)),
          "render_cropped differs from the eval step's image")

    # ---- 6. training path -------------------------------------------------
    state0 = init_train_state(params, live)
    lrs = torch.full((5,), LR, device=dev)
    _, train = train_burst(rz, "RGB", train_step, eval_step, state0,
                           TRAIN_ORDER, lrs)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=len(TRAIN_ORDER),
                rasterize_bwd=len(TRAIN_ORDER))
    check(train == want, f"training launches {train} != {want}")

    # ---- 7. one step: kernel route vs plain route -------------------------
    one_step_check(rz, "RGB", train_step, state0, cams, EVAL_IDS[2], cfg,
                   tcfg, bspec, rspec, lrs)

    # ---- 8. timing --------------------------------------------------------
    phase("timing: render per stage (CUDA events, after warm-up)")
    stats = time_frames(
        {"f32 kernel": (rz.composite_tiles, False),
         "f32 plain": (rz.composite_tiles_torch, False),
         "preset": (rz.composite_tiles_preset, True)},
        ("f32 plain", "f32 kernel", "preset", "preset", "f32 kernel",
         "f32 plain"), params, live, cams, EVAL_IDS, cfg, bspec, rspec)
    for cid, row in zip(EVAL_IDS, stats["f32 kernel"][:len(EVAL_IDS)]):
        print(f"  view {cid:2d}: n_pairs {row[4]}  n_clipped {row[5]}  "
              f"n_visible {row[6]}")
    phase("timing: train step (CUDA events, after warm-up)")
    time_steps("RGB", train_step, state0, cams, EVAL_IDS, cfg, tcfg, bspec,
               rspec, lrs, rz.composite_tiles)

    # each kernel alone at the main path's shapes (view 0), in turns
    args = (pk0.geom, pk0.color, pk0.tile_start)
    pargs = (pp0.geom, pp0.color, pp0.tile_start)
    alone = {
        "rasterize_fwd": (lambda: rz.composite_tiles(*args, rspec),
                          lambda: rz.composite_tiles_torch(*args, rspec)),
        "rasterize_bwd": (
            lambda: rz.composite_tiles_bwd(*args, out_k, go0, rspec),
            lambda: rz.composite_tiles_bwd_torch(*args, out_k, go0, rspec)),
        "rasterize_fwd_preset": (
            lambda: rz.composite_tiles_preset(*pargs, rspec),
            lambda: rz.composite_tiles_preset_torch(*pargs, rspec)),
    }
    times = {}

    def time_alone(names, n_pairs):
        with torch.no_grad():
            for name in names:
                kernel, plain = alone[name]
                t = {"kernel": [], "plain": []}
                for route in ("plain", "kernel", "kernel", "plain"):
                    fn = kernel if route == "kernel" else plain
                    t[route].append(time_fn(fn, 50 if route == "kernel"
                                            else 5))
                times[name] = t
                print(f"  {name} alone (view 0, {n_pairs} pairs): kernel "
                      f"{t['kernel'][0]:.4f}/{t['kernel'][1]:.4f} ms, plain "
                      f"{t['plain'][0]:.3f}/{t['plain'][1]:.3f} ms",
                      flush=True)

    time_alone(("rasterize_fwd", "rasterize_bwd", "rasterize_fwd_preset"),
               int(pk0.n_pairs))
    del alone, splat, eval_step, train_step, state0, results, stats
    del table, params, pk0, pp0, out_k, out_pk, go0
    torch.cuda.empty_cache()

    # ---- 9. SH: the same scene with 27 coefficients -----------------------
    phase("SH scene: bench.py synthetic table, use_sh, sh_ampl "
          f"{SH_AMPL}")
    t0 = time.perf_counter()
    table = synthetic_table(N_GAUSS, focal=FOCAL, scale_px=2.5,
                            frustum=(0.85, 0.55), use_sh=True,
                            sh_ampl=SH_AMPL, device=dev)
    cams = synthetic_cameras(N_CAMS, WIDTH, HEIGHT, FOCAL, device=dev)
    grid = cams["grid"]
    cfg = SplatConfig(use_sh_coeff=True)
    bspec, rspec = make_specs(grid, cfg)
    check(rspec.color_dim == 27, "SH spec")
    params, live = table.params(), table.live
    print(f"rgb {tuple(params['rgb'].shape)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    phase("SH kernels vs plain: full-size view")
    shv0 = cams["sh_vecs"][0]
    with torch.no_grad():
        _, mid0 = staged_frame(params, live, cams["w2c_rot"][0],
                               cams["w2c_tran"][0], grid, cfg, bspec, rspec,
                               rz.composite_tiles, shv=shv0)
        pk0, out_k = mid0["packed"], mid0["out"]
        out_p = rz.composite_tiles_torch(pk0.geom, pk0.color, pk0.tile_start,
                                         rspec, shv0)
    torch.cuda.synchronize()
    d = (out_k - out_p).abs()
    print(f"  rasterize_fwd_sh, n_pairs {int(pk0.n_pairs)}: max abs "
          f"{float(d.max()):.3e}  mean abs {float(d.mean()):.3e}", flush=True)
    check(float(d.max()) <= TOL, "full-size view: SH forward disagrees")
    note_err("rasterize_fwd_sh", d.max())
    go0 = cotangent(4, tuple(out_k.shape), dev)
    with torch.no_grad():
        err, ratio, rel = bwd_compare(rz, pk0, out_k, go0, rspec, shv0)
    print(f"  rasterize_bwd_sh: max abs {err:.3e} ({ratio:.3f} of the "
          f"per-pair bound); rel L2 {json.dumps(rel)}", flush=True)
    check(ratio <= 1.0, "full-size view: SH backward outside the bound")
    check(max(rel.values()) <= FULL_REL_L2,
          f"full-size view: SH backward disagrees ({rel})")
    note_err("rasterize_bwd_sh", err)
    del mid0, out_p
    torch.cuda.empty_cache()

    phase("SH ground truth: jittered table, plain route")
    splat = ground_truth_splat(table, cams, cfg, bspec, rspec, SH_EVAL_IDS,
                               rz.composite_tiles_torch)
    eval_step = make_eval_step(splat)
    train_step = make_train_step(splat, tcfg)
    torch.cuda.synchronize()

    phase("SH serving path: 4 eval requests + 1 offscreen render at "
          "sh_order=2")
    reset_launches(rz)
    t0 = time.perf_counter()
    results = [eval_step(params, live, cid) for cid in SH_EVAL_IDS]
    frames = [render_offscreen(splat, w2c, off_w, off_h, off_f, off_f,
                               sh_order=2)
              for w2c in offscreen_poses(cams, (1,))]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sh_serve = dict(rz.LAUNCHES)
    print(f"{len(results) + len(frames)} frames in {wall:.3f} s wall; "
          f"kernel launches {json.dumps(sh_serve)}", flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd_sh=len(results) + len(frames))
    check(sh_serve == want, f"SH serving launches {sh_serve} != {want}")
    check_eval(results, SH_EVAL_IDS)
    check_frames(frames, (off_h, off_w, 3))
    with torch.no_grad():
        full = render_offscreen(splat, offscreen_poses(cams, (1,))[0], off_w,
                                off_h, off_f, off_f)
    band = float(np.abs(full - frames[0]).max())
    print(f"  sh_order=2 vs all bands: max abs {band:.3e}", flush=True)
    check(band > 1e-3, "sh_order=2 masked nothing")

    state0 = init_train_state(params, live)
    _, sh_train = train_burst(rz, "SH", train_step, eval_step, state0,
                              SH_TRAIN_ORDER, lrs)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd_sh=len(SH_TRAIN_ORDER),
                rasterize_bwd_sh=len(SH_TRAIN_ORDER))
    check(sh_train == want, f"SH training launches {sh_train} != {want}")

    one_step_check(rz, "SH", train_step, state0, cams, SH_EVAL_IDS[1], cfg,
                   tcfg, bspec, rspec, lrs)

    phase("SH timing: render per stage (CUDA events, after warm-up)")
    time_frames({"SH kernel": (rz.composite_tiles, False),
                 "SH plain": (rz.composite_tiles_torch, False)},
                ("SH plain", "SH kernel", "SH kernel", "SH plain"), params,
                live, cams, SH_EVAL_IDS, cfg, bspec, rspec)
    phase("SH timing: train step (CUDA events, after warm-up)")
    time_steps("SH", train_step, state0, cams, SH_EVAL_IDS, cfg, tcfg, bspec,
               rspec, lrs, rz.composite_tiles)
    args = (pk0.geom, pk0.color, pk0.tile_start)
    alone = {
        "rasterize_fwd_sh": (
            lambda: rz.composite_tiles(*args, rspec, shv0),
            lambda: rz.composite_tiles_torch(*args, rspec, shv0)),
        "rasterize_bwd_sh": (
            lambda: rz.composite_tiles_bwd(*args, out_k, go0, rspec, shv0),
            lambda: rz.composite_tiles_bwd_torch(*args, out_k, go0, rspec,
                                                 shv0)),
    }
    time_alone(("rasterize_fwd_sh", "rasterize_bwd_sh"), int(pk0.n_pairs))

    paths = {"RGB serving": serve, "RGB training": train,
             "SH serving": sh_serve, "SH training": sh_train}
    print("launches by path: " + json.dumps(paths), flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": repl,
        "launches": sum(p[name] for p in paths.values()),
        "launches_by_path": {k: p[name] for k, p in paths.items()},
        "max_abs_err": max_err[name],
        "ms": float(np.mean(times[name]["kernel"])),
        "plain_ms": float(np.mean(times[name]["plain"]))}
        for name, (src, repl) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)              # card name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
