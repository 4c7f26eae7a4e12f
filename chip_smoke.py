#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gsplat_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds both rasterizer kernels (gsplat_tpu_torch/csrc/rasterize_fwd.cu
and rasterize_bwd.cu, one nvcc each, in parallel, for sm_90a into
gsplat_tpu_torch/_build/) and holds each against its plain PyTorch version
on a tiny input, on a small scene (a tile of more than 256 pairs, an empty
tile, near-opaque, weight normalisation) and on one full-size view.  Then it
drives the port's two paths on the bench scene (506,627 gaussians,
1297x840, bench.py:84) through their entry points:

- serving: 8 evaluation requests (make_eval_step: image, PSNR, SSIM) and 2
  headless renders at 1024x656 (render_offscreen);
- training: 24 steps of make_train_step (TrainConfig defaults, SSIM weight
  0.1, lr 1e-3 for every group as bench.py:274) over the 8 cameras whose
  ground truth it renders from a jittered copy of the table.

Each path runs with the launch counts set to 0 just before it and read just
after.  It checks every output, compares one train step through the
kernels with one assembled from the plain versions, times both routes per
stage with CUDA events, and prints:

- a JSON line {"kernels": [...]} with each kernel's launches on the two
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

TOL = 2e-4          # forward kernel vs plain, max abs on tile rows (the
                    # bound of tests/test_rasterize.py:40-41 against the
                    # oracle)
# backward kernel vs plain, per pair: |k - p| <= BWD_ATOL * colmax(p) +
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
DEVICE = "cuda:0"   # one card
KERNELS = {
    "rasterize_fwd": ("gsplat_tpu_torch/csrc/rasterize_fwd.cu",
                      "gsplat_tpu/ops/rasterize.py:437"),   # _fwd_kernel
    "rasterize_bwd": ("gsplat_tpu_torch/csrc/rasterize_bwd.cu",
                      "gsplat_tpu/ops/rasterize.py:531"),   # _bwd_kernel
}
GROUPS = {"xy": (0, 2), "cov": (2, 6), "opa": (6, 7)}   # grad_geom columns


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def small_scene(device, opaque=False):
    """The image-space scene of tests/test_torch_cuda.py on 4x3 tiles of
    16 px: tile (0, 0) holds more than 256 pairs (two kernel batches) and
    the right tile column stays empty."""
    import torch

    from gsplat_tpu_torch.ops.binning import BinningSpec, pack_sorted
    from gsplat_tpu_torch.ops.rasterize import RasterSpec
    from gsplat_tpu_torch.synthetic import image_space_pairs

    focal = 40.0
    geom, color, depth, visible, geo = image_space_pairs(
        0, n=640, crowd=320, focal=focal)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    bspec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], 16, 16, focal, focal)
    arrays = [torch.from_numpy(a).to(device)
              for a in (geom, color, depth, visible)]
    return pack_sorted(bspec, *arrays), rspec


def cotangent(seed, shape, device, wn=True):
    """A random (T, 4, Px) cotangent from a numpy seed; row 3 (Σw) only
    when weight normalisation is on."""
    import torch

    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if not wn:
        g[:, 3] = 0.0
    return torch.from_numpy(g).to(device)


def bwd_compare(rz, packed, out, go, rspec):
    """Backward kernel vs plain on the same pairs → (max abs, worst ratio
    to the per-pair bound, relative L2 per column group)."""
    import torch

    gg, gc = rz.composite_tiles_bwd(packed.geom, packed.color,
                                    packed.tile_start, out, go, rspec)
    torch.cuda.synchronize()
    rg, rc = rz.composite_tiles_bwd_torch(packed.geom, packed.color,
                                          packed.tile_start, out, go, rspec)
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
                 composite, events=None):
    """One render, stage by stage (the body of render_padded + crop), with
    the compositor passed in; records CUDA events between stages.  Returns
    the image and a dict of the intermediates."""
    import torch

    from gsplat_tpu_torch.ops.binning import pack_sorted
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
    color = torch.sigmoid(params["rgb"])
    geom_n = torch.cat([proj.mean2d, proj.cov2d, opa[:, None],
                        torch.zeros_like(opa)[:, None]], dim=1)
    if events:
        events[1].record()
    packed = pack_sorted(bspec, geom_n, color, proj.depth, visible)
    if events:
        events[2].record()
    out = composite(packed.geom, packed.color, packed.tile_start, rspec)
    img = assemble_image(out[:, :3], out[:, 3], rspec)
    img = torch.clamp(img, 0.0, 1.0)
    t, l = grid.crop_top, grid.crop_left
    img = img[:, t:t + grid.height, l:l + grid.width]
    if events:
        events[3].record()
    return img, {"packed": packed, "out": out, "geom_n": geom_n}


def plain_composite(backward=None):
    """The plain compositor with its plain backward (or ``backward``), as
    one autograd function: the counterpart of CompositeTiles on the plain
    versions."""
    import torch

    from gsplat_tpu_torch.ops import rasterize as rz

    bwd = backward or rz.composite_tiles_bwd_torch

    class PlainComposite(torch.autograd.Function):
        @staticmethod
        def forward(ctx, geom, color, tile_start, spec):
            out = rz.composite_tiles_torch(geom, color, tile_start, spec)
            ctx.spec = spec
            ctx.save_for_backward(geom, color, tile_start, out)
            return out

        @staticmethod
        def backward(ctx, grad_out):
            geom, color, tile_start, out = ctx.saved_tensors
            gg, gc = bwd(geom, color, tile_start, out,
                         grad_out.contiguous(), ctx.spec)
            return gg, gc, None, None

    return PlainComposite.apply


def staged_step(st, rot, tran, gt, grid, cfg, tcfg, bspec, rspec, composite,
                marks=None):
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
                                rspec, composite)
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
    from gsplat_tpu_torch.models.splatter import (SceneCameras, Splatter,
                                                  make_specs, render_cropped)
    from gsplat_tpu_torch.ops import cuda_build, rasterize as rz
    from gsplat_tpu_torch.ops.losses import psnr
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table
    from gsplat_tpu_torch.train import (GROUP_ORDER, init_train_state,
                                        make_eval_step, make_train_step)
    from gsplat_tpu_torch.viewer import render_offscreen

    check("jax" not in sys.modules, "the port pulled in jax")
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

    # ---- 2. build both kernels (one nvcc each, in parallel) ---------------
    phase("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(rz._kernel, KERNELS))
    print(f"built {len(KERNELS)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNELS:
        info = cuda_build.BUILD_INFO[name]
        print(f"  {name}: {info['path']} (nvcc {info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    ptxas: {line.strip()}")

    phase("tiny launches: kernel vs plain")
    tiny = rz.RasterSpec(2, 1, 16, 16, 20.0, 20.0)
    g = torch.tensor([[0.1, 0.05, 0.01, 0.002, 0.002, 0.02, 0.8, 0.0]],
                     device=dev)
    c = torch.tensor([[0.2, 0.5, 0.9]], device=dev)
    s = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)
    out_k = rz.composite_tiles(g, c, s, tiny)
    torch.cuda.synchronize()
    err = float((out_k - rz.composite_tiles_torch(g, c, s, tiny)).abs().max())
    print(f"  forward: max abs diff {err:.3e}", flush=True)
    check(err <= TOL, f"tiny forward launch disagrees: {err}")
    max_err["rasterize_fwd"] = err

    one = types.SimpleNamespace(geom=g, color=c, tile_start=s)   # one pair
    err, ratio, _ = bwd_compare(rz, one, out_k,
                                cotangent(0, tuple(out_k.shape), dev), tiny)
    print(f"  backward: max abs diff {err:.3e} ({ratio:.3f} of the bound)",
          flush=True)
    check(ratio <= 1.0, f"tiny backward launch disagrees: {err}")
    max_err["rasterize_bwd"] = err

    # ---- 3. kernels against the plain versions: small scene ---------------
    phase("kernels vs plain: small scene")
    for opaque in (False, True):
        packed, rspec_s = small_scene(dev, opaque)
        counts = torch.diff(packed.tile_start)
        check(int(counts.max()) > 256 and int((counts == 0).sum()) > 0,
              "small scene needs a tile of > 256 pairs and an empty tile")
        a = rz.composite_tiles(packed.geom, packed.color, packed.tile_start,
                               rspec_s)
        b = rz.composite_tiles_torch(packed.geom, packed.color,
                                     packed.tile_start, rspec_s)
        torch.cuda.synchronize()
        d = (a - b).abs()
        print(f"  forward opaque={opaque}: max abs {float(d.max()):.3e}  "
              f"mean abs {float(d.mean()):.3e}  (max pairs per tile "
              f"{int(counts.max())})", flush=True)
        check(float(d.max()) <= TOL, "small scene: forward kernel disagrees")
        max_err["rasterize_fwd"] = max(max_err["rasterize_fwd"],
                                       float(d.max()))
        for wn in (False, True):
            go = cotangent(1 + wn, tuple(a.shape), dev, wn)
            err, ratio, rel = bwd_compare(rz, packed, b, go, rspec_s)
            print(f"  backward opaque={opaque} weight_normalize={wn}: max "
                  f"abs {err:.3e} ({ratio:.3f} of the per-pair bound); "
                  f"rel L2 {json.dumps(rel)}", flush=True)
            check(ratio <= 1.0, "small scene: backward kernel disagrees")
            max_err["rasterize_bwd"] = max(max_err["rasterize_bwd"], err)

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
    print(f"  forward, n_pairs {int(pk0.n_pairs)}: max abs "
          f"{float(d.max()):.3e}  mean abs {float(d.mean()):.3e}", flush=True)
    check(float(d.max()) <= TOL, "full-size view: forward kernel disagrees")
    max_err["rasterize_fwd"] = max(max_err["rasterize_fwd"], float(d.max()))
    go0 = cotangent(3, tuple(out_k.shape), dev)
    with torch.no_grad():
        err, ratio, rel = bwd_compare(rz, pk0, out_k, go0, rspec)
    print(f"  backward: max abs {err:.3e} ({ratio:.3f} of the per-pair "
          f"bound); rel L2 {json.dumps(rel)}", flush=True)
    check(max(rel.values()) <= FULL_REL_L2,
          f"full-size view: backward kernel disagrees ({rel})")
    max_err["rasterize_bwd"] = max(max_err["rasterize_bwd"], err)
    torch.cuda.empty_cache()

    # ---- 4. ground truth, the scene's cameras -----------------------------
    phase("ground truth: jittered table, plain route (bench.py:160-186)")
    tgt = dict(params)
    jit_rng = np.random.default_rng(1)
    tgt["pos"] = params["pos"] + torch.from_numpy(
        jit_rng.normal(0, 0.01, tuple(params["pos"].shape)).astype(
            np.float32)).to(dev)
    images = cams["images"]
    with torch.no_grad():
        for cid in EVAL_IDS:
            gt, _ = staged_frame(tgt, live, cams["w2c_rot"][cid],
                                 cams["w2c_tran"][cid], grid, cfg, bspec,
                                 rspec, rz.composite_tiles_torch)
            images[cid] = (gt * 255).to(torch.uint8)
    splat = Splatter.from_scene(cfg, table, [SceneCameras(
        w2c_rot=cams["w2c_rot"], w2c_tran=cams["w2c_tran"],
        sh_vecs=cams["sh_vecs"], images=images, grid=grid,
        names=[f"cam{i:02d}" for i in range(N_CAMS)])])
    eval_step = make_eval_step(splat)
    train_step = make_train_step(splat, tcfg)
    off_w, off_h = OFFSCREEN
    off_f = FOCAL * off_w / WIDTH
    w2cs = []
    for cid in (1, 2):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = cams["w2c_rot"][cid].cpu().numpy()
        w2c[:3, 3] = cams["w2c_tran"][cid].cpu().numpy()
        w2cs.append(w2c)
    torch.cuda.synchronize()

    # ---- 5. serving path --------------------------------------------------
    phase("serving path: 8 eval requests + 2 offscreen renders")
    rz.composite_tiles.launches = 0
    rz.composite_tiles_bwd.launches = 0
    t0 = time.perf_counter()
    results = [eval_step(params, live, cid) for cid in EVAL_IDS]
    frames = [render_offscreen(splat, w2c, off_w, off_h, off_f, off_f,
                               fast=False) for w2c in w2cs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve = (rz.composite_tiles.launches, rz.composite_tiles_bwd.launches)
    n_frames = len(results) + len(frames)
    print(f"{n_frames} frames in {wall:.3f} s wall; kernel launches "
          f"forward {serve[0]} backward {serve[1]}", flush=True)
    check(serve == (n_frames, 0),
          f"serving launches {serve} != ({n_frames}, 0)")
    for cid, (img, p, s) in zip(EVAL_IDS, results):
        check(img.shape == (3, HEIGHT, WIDTH), f"eval image {img.shape}")
        check(bool(torch.isfinite(img).all()) and float(img.min()) >= 0
              and float(img.max()) <= 1, f"eval image {cid} not in [0, 1]")
        check(np.isfinite(float(p)) and np.isfinite(float(s)),
              f"camera {cid}: non-finite metrics")
        print(f"  eval cam {cid:2d}: psnr {float(p):.4f}  ssim "
              f"{float(s):.6f}", flush=True)
    for fr in frames:
        check(fr.shape == (off_h, off_w, 3), f"offscreen frame {fr.shape}")
        check(bool(np.isfinite(fr).all()) and fr.min() >= 0
              and fr.max() <= 1, "offscreen frame not in [0, 1]")
    means = [round(float(f.mean()), 6) for f in frames]
    print(f"  offscreen {off_w}x{off_h}: image means {means}", flush=True)

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
    phase(f"training path: {len(TRAIN_ORDER)} steps of make_train_step")
    state0 = init_train_state(params, live)
    psnr0 = float(eval_step(params, live, 0)[1])
    torch.cuda.synchronize()
    rz.composite_tiles.launches = 0
    rz.composite_tiles_bwd.launches = 0
    lrs = torch.full((5,), LR, device=dev)
    st, losses, metrics = state0, [], []
    t0 = time.perf_counter()
    for cid in TRAIN_ORDER:
        st, m = train_step(st, cid, lrs)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train = (rz.composite_tiles.launches, rz.composite_tiles_bwd.launches)
    n_steps = len(TRAIN_ORDER)
    print(f"{n_steps} steps in {wall:.3f} s wall; kernel launches forward "
          f"{train[0]} backward {train[1]}", flush=True)
    check(train == (n_steps, n_steps),
          f"training launches {train} != ({n_steps}, {n_steps})")
    for cid, m in zip(TRAIN_ORDER, metrics):
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
    check(last < first, "the loss did not fall over the burst")
    check(psnr1 > psnr0, "camera 0's PSNR did not rise over the burst")

    # ---- 7. one step: kernel route vs plain route -------------------------
    phase("one train step: make_train_step vs the plain versions")
    cid = EVAL_IDS[2]
    rot, tran = cams["w2c_rot"][cid], cams["w2c_tran"][cid]
    gt = images[cid].to(torch.float32) / 255.0
    st_k, m_k = train_step(state0, cid, lrs)
    loss_p, g_p, new_p, opt_p = staged_step(state0, rot, tran, gt, grid, cfg,
                                            tcfg, bspec, rspec,
                                            plain_composite())
    torch.cuda.synchronize()
    d_loss = abs(float(m_k["loss"]) / float(loss_p) - 1)
    print(f"  loss kernel {float(m_k['loss']):.7f} plain {float(loss_p):.7f}"
          f" (rel {d_loss:.2e})", flush=True)
    check(d_loss <= 1e-5, "one step: loss differs")
    with torch.no_grad():
        # L1 is discontinuous where the image meets its 8-bit ground truth:
        # pixels whose residual changes sign between the two forwards get
        # an opposite L1 cotangent
        img_k, _ = render_cropped(params, live, rot, tran, grid, cfg, bspec,
                                  rspec)
        img_p, _ = staged_frame(params, live, rot, tran, grid, cfg, bspec,
                                rspec, rz.composite_tiles_torch)
        flips = int((torch.sign(img_k - gt) != torch.sign(img_p - gt)).sum())
    print(f"  pixels whose L1 sign differs between the routes: {flips}",
          flush=True)
    # the backward kernel's own share: the plain forward with the kernel
    # backward against the all-plain step (the same image cotangent)
    _, g_h, _, _ = staged_step(state0, rot, tran, gt, grid, cfg, tcfg, bspec,
                               rspec, plain_composite(rz.composite_tiles_bwd))
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
        check(rel <= 1e-3, f"one step: {k} gradients differ")
        # Adam's first step maps g to ~g/(|g| + 1e-8), a step of ~lr·sign(g)
        # wherever |g| >> 1e-8: a gradient near zero, or one that crosses a
        # discontinuity (L1's sign, a pixel either side of the 1e-4 stop),
        # moves by up to 2·lr between the routes.  Bound: every element
        # within 2·lr, and at most 1e-4 of the elements beyond 0.01·lr.
        check(bool((dp <= 2 * LR).all()), f"one step: {k} params exploded")
        check(far <= 1e-4 * dp.numel(),
              f"one step: {k}: {far} elements beyond 0.01 lr")
    del st_k, new_p, opt_p, g_p
    torch.cuda.empty_cache()

    # ---- 8. timing --------------------------------------------------------
    phase("timing: render per stage (CUDA events, after warm-up)")
    routes = {"kernel": rz.composite_tiles, "plain": rz.composite_tiles_torch}
    stats = {r: [] for r in routes}
    with torch.no_grad():
        for route in ("plain", "kernel", "kernel", "plain"):
            fn = routes[route]
            for cid in EVAL_IDS[:2]:       # warm-up
                staged_frame(params, live, cams["w2c_rot"][cid],
                             cams["w2c_tran"][cid], grid, cfg, bspec, rspec,
                             fn)
            for cid in EVAL_IDS:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                _, mid = staged_frame(params, live, cams["w2c_rot"][cid],
                                      cams["w2c_tran"][cid], grid, cfg,
                                      bspec, rspec, fn, events=ev)
                torch.cuda.synchronize()
                pk = mid["packed"]
                stats[route].append(
                    (ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                     ev[2].elapsed_time(ev[3]), ev[0].elapsed_time(ev[3]),
                     int(pk.n_pairs), int(pk.n_clipped), int(pk.n_visible)))
    for cid, row in zip(EVAL_IDS, stats["kernel"][:len(EVAL_IDS)]):
        print(f"  view {cid:2d}: n_pairs {row[4]}  n_clipped {row[5]}  "
              f"n_visible {row[6]}")
    for route, rows in stats.items():
        m = np.mean(np.array([r[:4] for r in rows]), axis=0)
        print(f"  {route:6s} ms/frame {m[3]:.3f}  (project {m[0]:.3f}  pack "
              f"{m[1]:.3f}  composite+assemble+crop {m[2]:.3f}); "
              f"{len(rows)} frames", flush=True)

    phase("timing: train step (CUDA events, after warm-up)")
    st = state0
    for cid in EVAL_IDS[:2]:                # warm-up
        st, _ = train_step(st, cid, lrs)
    torch.cuda.synchronize()
    step_ms = []
    for cid in EVAL_IDS:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        st, _ = train_step(st, cid, lrs)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    print(f"  make_train_step ms/step {np.mean(step_ms):.3f} (min "
          f"{np.min(step_ms):.3f}, max {np.max(step_ms):.3f}); "
          f"{len(step_ms)} steps", flush=True)
    parts = {}
    for i, cid in enumerate(EVAL_IDS[:2] + EVAL_IDS):
        marks = []
        staged_step(st, cams["w2c_rot"][cid], cams["w2c_tran"][cid],
                    images[cid].to(torch.float32) / 255.0, grid, cfg, tcfg,
                    bspec, rspec, rz.composite_tiles, marks=marks)
        torch.cuda.synchronize()
        if i < 2:
            continue                        # warm-up
        for (_, a), (label, b) in zip(marks, marks[1:]):
            parts.setdefault(label, []).append(a.elapsed_time(b))
    total = sum(np.mean(v) for v in parts.values())
    print(f"  staged kernel-route step ms {total:.3f}, by stage (stream "
          f"order, mean of {len(EVAL_IDS)} steps):", flush=True)
    for label, v in parts.items():
        print(f"    {label:36s} {np.mean(v):8.3f}")

    # each compositor direction alone at the main path's shapes (view 0)
    def time_fn(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    args = (pk0.geom, pk0.color, pk0.tile_start)
    fwd = {"kernel": lambda: rz.composite_tiles(*args, rspec),
           "plain": lambda: rz.composite_tiles_torch(*args, rspec)}
    bwd = {"kernel": lambda: rz.composite_tiles_bwd(*args, out_k, go0, rspec),
           "plain": lambda: rz.composite_tiles_bwd_torch(*args, out_k, go0,
                                                         rspec)}
    times = {}
    with torch.no_grad():
        for name, fns in (("rasterize_fwd", fwd), ("rasterize_bwd", bwd)):
            t = {r: [] for r in fns}
            for route in ("plain", "kernel", "kernel", "plain"):
                t[route].append(time_fn(fns[route],
                                        50 if route == "kernel" else 5))
            times[name] = t
            print(f"  {name} alone (view 0, {int(pk0.n_pairs)} pairs): "
                  f"kernel {t['kernel'][0]:.4f}/{t['kernel'][1]:.4f} ms, "
                  f"plain {t['plain'][0]:.3f}/{t['plain'][1]:.3f} ms",
                  flush=True)

    launches = {"rasterize_fwd": serve[0] + train[0],
                "rasterize_bwd": serve[1] + train[1]}
    print(f"launches: serving path {serve}, training path {train} "
          "(forward, backward)", flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": repl,
        "launches": launches[name], "max_abs_err": max_err[name],
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
