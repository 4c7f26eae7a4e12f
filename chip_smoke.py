#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gsplat_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the rasterizer kernels (gsplat_tpu_torch/csrc/rasterize_fwd.cu and
rasterize_bwd.cu, one nvcc each, in parallel, for sm_90a into
gsplat_tpu_torch/_build/; beside them the native COLMAP reader,
csrc/colmap_reader.cpp, the JPEG codec, csrc/jpeg_codec.cpp, the TIFF strip
codecs, csrc/tiff_codec.cpp, the WebP codec, csrc/webp_codec.cpp, the
GIF and Radiance HDR codecs, csrc/gif_hdr_codec.cpp, and the JPEG 2000
codec, csrc/jpeg2000_codec.cpp, and the AV1 decoder of the AVIF reader,
csrc/avif_codec.cpp, with the system C++ compiler), six entry points:
the f32 RGB forward and backward, the SH forward and backward (27
coefficients) and the bf16 render preset's forward, RGB and SH.  It holds
each against its plain PyTorch version on a tiny input, on a small scene (a
tile of more than 256 pairs, an empty tile, near-opaque, weight
normalisation; the forward kernels on 16x16 and 12x12 tiles) and on one
full-size view, whose pairs a tile it prints.
Then it drives the port's paths on the bench scene (506,627 gaussians,
1297x840, bench.py:84) through their entry points:

- RGB serving: 8 evaluation requests (make_eval_step: image, PSNR, SSIM)
  and 2 headless renders at 1024x656 (render_offscreen with the default
  config: the bf16 render preset);
- RGB training: 24 steps of make_train_step (TrainConfig defaults, SSIM
  weight 0.1, lr 1e-3 for every group as bench.py:274) over the 8 cameras
  whose ground truth it renders from a jittered copy of the table;
- SH serving, on the same scene with 27 SH coefficients (random degree-1/2
  bands, sh_ampl 0.35): 4 evaluation requests and 1 render_offscreen at
  sh_order=2 (SH keeps the f32 route in Fast Mode);
- SH training: 12 steps of make_train_step over 4 cameras;
- SH preset serving: 2 evaluation requests through the bf16 render preset
  (make_eval_step(preset=True)), held above 38 dB from the f32 SH image;
- the viewer server: run_viewer through the fake viser server of
  tests/torch_helpers.py, a client dragging its camera over the 8 eval poses
  at the Resolution slider's default (1024x688), f32 and Fast Mode, each
  pushed frame bit-identical to render_offscreen of its request's pose and
  timed with and without the double buffer, and a frame's stages (render,
  pinned copy, push) timed alone; the Near and Far sliders
  culling to black; the SH Order slider on the SH scene; live training, 3
  loop iterations of 10 Trainer steps;
- data-parallel training: two gloo ranks (processes) on the one card, one
  make_dp_train_step on cameras 0 and 6, both ranks' states bit-identical
  and the params within 1e-5 (relative L2) of one process averaging both
  cameras' gradients, the step and its all-reduce timed; an NCCL group of
  one rank; main --dp with more ranks than GPUs raises;
- bands: make_tile_sharded_render of the bench view at 832 rows (840 raises,
  naming 832), 2 and 4 bands (RGB) and 2 (SH) within 2e-4 of the one image
  at tiny culling settings, timed against it;
- the Trainer: Trainer.train over iterations 600-660 of the RGB scene (every
  8th camera a test camera, a densify event every 20 steps from 620, the
  first one growing the table), with its TEST evaluation and checkpoint;
  then adaptive_control on the card against the CPU, a save_full/load_full
  round trip, and the CLI (python -m gsplat_tpu_torch.train) on a small
  COLMAP scene it writes with PNG images;
- the at-scale run, in a temporary directory: the garden_hard scene built
  at its published size (scripts/make_synth_scene: 1.2M SH ground-truth
  gaussians rendered to 56 views at 1297x840, a 140k-point init), its oracle
  ceiling held within 0.05 dB of JAX's 42.82; its points3D.bin read by the
  native COLMAP reader and by the Python parser, the same 140,000 points bit
  for bit; scripts/run_garden_7k over
  iterations 0-1000 of the 7001-iteration schedule (RGB; densify events at
  700-1000, the capacity growth and K growth of JAX's run; the train step
  then timed by stage on that table), with every logged l1 finite, n_live <=
  capacity <= 524,288 and K <= 40 at each event and the capacity grown;
  a load_full of its last full_state.npz into a fresh Trainer, bit for bit,
  and the next step's loss from both; then 101 iterations with SH color;
  then the real-capture (JPEG) leg: the 56 views encoded with the port's
  write_jpeg into a JPEG copy of the scene, decoded and held to their PNGs
  (PSNR), loaded through Splatter on the card (each image read_jpeg's),
  run_garden_7k over iterations 0-200 from the JPEGs with its last logged
  l1 within a stated bound of the PNG run's (JPEG_L1_DRIFT), the image
  pyramid (python -m gsplat_tpu_torch.downsample --factor 2: 56 JPEGs at
  648x420) and the committed codec fixtures of tests/torch_jpeg/ bit for
  bit, with the codec's host seconds beside the CPU's model; then the other
  formats (image_io's TIFF, WebP, GIF, Radiance HDR, PFM, PAM, Sun raster,
  JPEG 2000, BMP and PNM readers and writers): the 56 views through
  write_tiff, write_webp, write_gif, write_hdr, write_pfm, write_pam,
  write_sunras and write_jpeg2000 into one copy of the scene a format and a
  few through write_bmp and write_pnm, each read back equal to its PNG
  (GIF: to gif_332, the plain 3-3-2 dither; HDR: to hdr_round_trip, the
  plain RGBE round trip), each format's encode and decode seconds a view
  (and a committed arithmetic-coded JPEG's, a committed lossy WebP's and
  two committed JPEG 2000 views', cv2's rate-limited reversible file and
  a 9/7 file in layers, tiles and precincts with SOP, EPH and PLT, whose
  decodes must hash as cv2's), every scene through Splatter with every
  ground-truth tensor equal to what its read-back was held to,
  run_garden_7k over iterations 0-200 from the PNG scene and from the
  TIFF, WebP and JPEG 2000 scenes with every logged l1, PSNR, pair count
  and TEST line equal, and from the
  GIF scene with its last l1 within the JPEG leg's bound of the PNG
  leg's, the pyramids over the TIFFs, the WebPs and the PFMs equal to the
  PNGs' and over the GIFs write_gif's bytes of the area means, over the
  JPEG 2000 files cv2's default (rate-4) JP2 bytes of them, the pyramids
  at a fractional (1.5) and an enlarging (0.5) factor over the PNGs equal
  to downsample_area of the views, and the committed fixtures of
  tests/torch_images/ (arithmetic, lossless, CMYK and cut-short JPEG,
  Adam7 PNG, TIFF and BigTIFF, BMP, PNM, WebP, GIF, HDR, PFM, PAM, Sun
  raster, JPEG 2000, cv2's rate-allocated JP2 bytes and INTER_AREA
  resizes, at full size too; AVIF from cv2 and Pillow) bit for bit; then
  AVIF (the port's AV1 decoder): the committed AVIF views of the 1297x840
  view (cv2's default, 10 and 12 bits, lossless, Pillow's tiles, 4:4:4,
  screen content, 4:2:2, 4:0:0, RGBA, film grain, libaom's denoiser and a
  3x2 grid) decoded to the SHA-256 of cv2's decode and timed, the screen
  content view's palette and intra block copy blocks counted, and
  make_synth_scene's mid preset built on the card and trained over
  iterations 0-200 from its PNGs, from the committed cv2 AVIF copies of
  its views, from Pillow's screen-content 4:2:2 RGBA copies and from
  Pillow's film grain copies, image sequences and colour kinds, and from
  copies in libaom's superres and delta loop filter and in the matrices
  libavif converts on its own path, and from libaom's key-frame-plus-inter
  copies and its copies at its default inter tools (motion-field
  projection, warped and global motion, OBMC, inter-intra) and at every
  default of libaom, compound prediction and skip mode among them, and
  from copies whose inter frames predict from references of another size
  (libaom's resize and superres), and from copies whose reference slots
  libaom rebuilds from ref_order_hint (each decode cv2's SHA-256) (the
  views of those kinds, of a frame libavif scales, of a key frame then an
  inter frame, of four frames at libaom's default inter tools, of four at
  every default, of four resized ones and of three with a slot rebuilt
  decoded to cv2's SHA-256 too, each shown using its tool, the compound,
  resized and rebuilt views timed beside cv2's default file), each
  AVIF leg's last l1 within the JPEG leg's bound of the PNG leg's; and
  from copies in JPEG 2000's HT code-blocks (raw codestreams and JPH
  files written on the host, lossless), whose log equals the cv2 AVIF
  leg's bit for bit.
  It prints the scene build's seconds, it/s and pairs a view before and
  after the K growth, the peak memory and the TEST PSNR/SSIM beside the
  committed 7001-iteration run's (runs/torch_7k_hard_rgb) and JAX's;
- the port's bench as users run it: python -m gsplat_tpu_torch.bench four
  times (BENCH_RUNS: 506,627 gaussians RGB and SH and 2.4M RGB with every
  phase, 2.4M SH rendering), each echoed, each exactly one JSON line
  without an error, ending at its last phase, every number finite, the RGB
  preset above 40 dB from the f32 image, the burst's PSNR above the
  untouched table's, and each kernel of its path launched;
- the bench table at 2.4M gaussians, RGB and SH: view 0's visible
  gaussians and pairs equal to JAX's (JAX_2M4), and each kernel that the
  bench's 2.4M runs launch (rasterize_fwd, rasterize_bwd and
  rasterize_fwd_preset on the RGB table, rasterize_fwd_sh on the SH one)
  there against its plain version (the bench_2m4 rows of the kernels line);
- the stage profiler (gsplat_tpu_torch/scripts/profile_trace.py) on the
  bench scene's RGB train step and on the at-scale step on iteration
  1000's table: device time by category, the gaps between launches, and
  the idle time without the profiler.

It also holds the forward kernels' split division (csrc/fast_div.cuh)
against the compiler's IEEE x / y, bit for bit, on 2^34 operand pairs, and
the tile boxes of the bench scene's view 0 on the card to the same boxes
computed on the CPU, every one equal.  On the at-scale tables the forward is
held to its plain version pixel by pixel, within a bound that grows with the
pairs the pixel evaluates (fwd_bound), and the tile with the largest
difference is composited in f64 beside both.

Each path runs with the launch counts set to 0 just before it and read just
after.  It checks every output, that two launches of each kernel on view 0
give the same bits, compares one train step through the
kernels with one assembled from the plain versions (RGB and SH), measures
the preset's PSNR against the f32 render, times the routes per stage with
CUDA events, and prints:

- a JSON line {"kernels": [...]} with each entry point's launches on the
  paths, its max abs difference from the plain version, its time and the
  plain version's, and its bound: the least time the card could take for
  the same work at view 0 (bytes over 3.35 TB/s, or the pair-pixel
  evaluations made before each pixel's stop times the flops of one, over
  67 TFLOP/s of f32; the larger);
- the card's name and power limit (nvidia-smi);
- last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero without that last
line; so does a machine without CUDA.  Nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
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
# the forward's split division against x / y: operand pairs a seed, seeds
DIV_CHECK_N, DIV_CHECK_SEEDS = 1 << 32, 4
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
SH_PRESET_PSNR = 38.0     # tests/test_fused_pack.py:326, JAX's bound
SH_PRESET_IDS = (0, 12)
# the Trainer path: iterations 600..660 with a densify event every 20 steps
# (620, 640, 660); 16 cameras, every 8th a test camera
TRAIN_START, TRAIN_END, N_ADAPTIVE = 600, 661, 20
TRAINER_CAMS = 16
CAPACITY_ROUND = 65536    # SplatConfig's default bucket
# the at-scale run: the garden_hard scene at its published size (1.2M SH GT
# gaussians, 56 views at 1297x840, a 140k-point init, a 524,288-slot
# ceiling), run_garden_7k over iterations 0-1000 (densify events at 700-1000,
# where JAX's K grew), then a short SH leg; only the iterations are cut, the
# learning-rate schedule stays the 7001-iteration run's (--stop_at)
FULL_ITERS, AT_SCALE_ITERS, AT_SCALE_SH_ITERS = 7001, 1001, 101
AT_SCALE_MAX_CAPACITY, AT_SCALE_K_CAP = 524288, 40
# The real-capture (JPEG) leg: run_garden_7k iterations (TEST @200 inside),
# and the bound on its last logged l1 against the PNG leg's at the same
# iteration: |l1_jpeg - l1_png| <= d + JPEG_L1_DRIFT * l1_png, d the largest
# per-view mean |JPEG - PNG| of the ground truth (the triangle inequality's
# share for one render) and JPEG_L1_DRIFT the trajectories' drift apart over
# 200 steps toward targets that differ by d (stated, with its reason,
# before the leg's first run on the card: PERF.md §6)
JPEG_ITERS, JPEG_L1_DRIFT = 201, 0.1
# the JAX package's run of this scene on a TPU v5e: the oracle ceiling
# (runs/7k_hard_r5/summary.json) and its TEST lines (train.log:5-33),
# iteration → (PSNR, SSIM)
JAX_CEILING = 42.82
JAX_TEST = {200: (16.0360, 0.4268), 400: (14.7038, 0.4273),
            600: (13.8436, 0.4207), 800: (15.6991, 0.3894),
            1000: (16.8923, 0.4209)}
PORT_RUN = "runs/torch_7k_hard_rgb/summary.json"   # the port's 7k RGB run
# the viewer server (run_viewer through the fake viser server of
# tests/torch_helpers.py): the Resolution slider's default at the camera
# aspect 1.5 (1024x688 by snap_resolution), the bench camera's horizontal
# field of view, the 8 eval poses; live training 3 loop iterations at the
# default period of 10
VIEWER_RES, VIEWER_ASPECT = 1024, 1.5
VIEWER_FOV = float(2 * np.arctan(WIDTH / 2 / FOCAL))
LIVE_LOOPS, LIVE_PERIOD = 3, 10
# data-parallel training: two gloo ranks on the one card, cameras 0 and 6
DP_CAMS = (0, 6)
DP_TIMED_STEPS, ALL_REDUCE_REPS = 5, 10
# band rendering: 840 px is 53 tile rows, which neither 2 nor 4 bands divide
# (make_tile_sharded_render raises naming 832 and 896); 832 is 52 rows.  The
# tiny culling settings make bands equal the one image to float tolerance
BAND_HEIGHT, BAND_COUNTS = 832, (2, 4)
TINY_CULL = dict(tile_culling_prob_thresh=1e-6, max_tiles_per_gaussian=64)
DEVICE = "cuda:0"   # one card
# the port's bench as users run it (python -m gsplat_tpu_torch.bench): four
# runs, (label, arguments, the last phase it records); its repeat cap
# (bench.MAX_REPS_CARD) is the first thing to cut if the call outgrows its
# time limit
BENCH_RUNS = (
    ("506k RGB", ["--phase", "all"], "psnr_burst"),
    ("506k SH", ["--use_sh_coeff", "1", "--phase", "all"], "psnr_burst"),
    ("2.4M RGB", ["--n_gauss", "2400000", "--phase", "all"], "psnr_burst"),
    ("2.4M SH", ["--n_gauss", "2400000", "--use_sh_coeff", "1", "--phase",
                 "render"], "render"),
)
PRESET_PSNR = 40.0      # RGB preset vs f32 (tests/test_fused_pack.py:290)
# the reference quality config's scale: view 0 of the bench table at 2.4M
# gaussians, JAX's (n_visible, n_pairs) on the CPU
# (tests/torch_pair_count_check.py --n_gauss 2400000, where the port on the
# CPU counts the same).  JAX's tune_budgets on the TPU counted 4,763,470
# pairs and 2,013,472 visible (runs/r5b_render_2m4.log; it reads camera 0,
# gsplat_tpu/synthetic.py:139): one fewer, a gaussian one ulp inside the
# frustum's y edge (#736264 or #2222183, y/z = 0.50399995 against 0.504,
# no tile) that the TPU's division puts on the edge
N_2M4, JAX_2M4, TPU_2M4_VISIBLE = 2_400_000, (2_013_473, 4_763_470), \
    2_013_472
_FWD, _BWD = "gsplat_tpu_torch/csrc/rasterize_fwd.cu", \
    "gsplat_tpu_torch/csrc/rasterize_bwd.cu"
KERNELS = {         # entry point → (source, the TPU kernel it replaces)
    "rasterize_fwd": (_FWD, "gsplat_tpu/ops/rasterize.py:437"),
    "rasterize_fwd_sh": (_FWD, "gsplat_tpu/ops/rasterize.py:459"),
    "rasterize_fwd_preset": (_FWD, "gsplat_tpu/ops/rasterize.py:475"),
    "rasterize_fwd_preset_sh": (_FWD, "gsplat_tpu/ops/rasterize.py:298"),
    "rasterize_bwd": (_BWD, "gsplat_tpu/ops/rasterize.py:531"),
    "rasterize_bwd_sh": (_BWD, "gsplat_tpu/ops/rasterize.py:646"),
}
# The least time of a kernel: the larger of its bytes (each input read once,
# each output written once) over HBM and its flops over the f32 CUDA-core
# peak; NVIDIA H100 SXM data sheet, at 700 W.
HBM_BYTES_S, F32_FLOPS_S = 3.35e12, 67e12
# f32 operations of one pair-pixel evaluation, counted from the plain twins'
# formulas (ops/rasterize.py), an exp and a division one each; the
# backward's per-pair sums one add a term.  Forward: the 2-D gaussian (~19),
# alpha, w and the accumulation of 3 colors and w (~9); SH adds 3 channels
# of 9 FMAs and a sigmoid (63).  Backward: the forward again (~20), d_alpha
# by the suffix identity (~15), the 6 geometry partials (~36) and the 10
# sums (~19); SH adds the colors (63), d logits (9) and 27 coefficient
# sums (54).
FLOPS_PER_EVAL = {"rasterize_fwd": 28, "rasterize_fwd_preset": 28,
                  "rasterize_fwd_sh": 91, "rasterize_fwd_preset_sh": 91,
                  "rasterize_bwd": 90, "rasterize_bwd_sh": 216}
GROUPS = {"xy": (0, 2), "cov": (2, 6), "opa": (6, 7)}   # grad_geom columns


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def small_scene(device, opaque=False, sh=False, tile=16):
    """The image-space scene of tests/test_torch_cuda.py on 4x3 tiles of
    ``tile`` px: tile (0, 0) holds more than 256 pairs (several kernel
    batches) and the right tile column stays empty.  → (packed, rspec,
    bspec, sh_vecs); with ``sh``, SH color (synthetic.image_space_sh), else
    sh_vecs None."""
    import torch

    from gsplat_tpu_torch.ops.binning import BinningSpec, pack_sorted
    from gsplat_tpu_torch.ops.rasterize import RasterSpec
    from gsplat_tpu_torch.synthetic import image_space_pairs, image_space_sh

    focal = 40.0
    geom, color, depth, visible, geo = image_space_pairs(
        0, n=640, crowd=320, focal=focal, tile=tile)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    shv = None
    if sh:
        color, shv = image_space_sh(0, color, geo, focal, tile=tile)
        shv = torch.from_numpy(shv).to(device)
    bspec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, focal,
                       focal, color_dim=27 if sh else 3)
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


def bwd_repeats(rz, name, packed, out, go, rspec, shv=None):
    """Two launches of a backward kernel on the same inputs give the same
    bits (one writer per row, a fixed summation order)."""
    import torch

    a = rz.composite_tiles_bwd(packed.geom, packed.color, packed.tile_start,
                               out, go, rspec, shv)
    b = rz.composite_tiles_bwd(packed.geom, packed.color, packed.tile_start,
                               out, go, rspec, shv)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two launches on the same inputs differ")
    print(f"  {name}: two launches bit-identical", flush=True)


def fwd_repeats(name, composite, *args):
    """Two launches of a forward kernel on the same inputs give the same
    bits (each pixel sums its pairs in order in one thread)."""
    import torch

    a = composite(*args)
    b = composite(*args)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          f"{name}: two launches on the same inputs differ")
    print(f"  {name}: two launches bit-identical", flush=True)


def pair_histogram(tile_start):
    """Print the pairs a tile of one view: max, p99, median, mean and a
    histogram in bins of 32 pairs."""
    import torch

    counts = torch.diff(tile_start).cpu().numpy()
    edges = np.arange(0, int(counts.max()) + 33, 32)
    hist, _ = np.histogram(counts, bins=edges)
    print(f"  pairs a tile over {counts.size} tiles: max {counts.max()}  "
          f"p99 {np.percentile(counts, 99):.0f}  median "
          f"{np.median(counts):.0f}  mean {counts.mean():.1f}; tiles by "
          f"[32 k, 32 k + 32): {hist.tolist()}", flush=True)


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
        names=[f"cam{i:02d}" for i in range(images.shape[0])])])


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


def evaluations(rz, geom, tile_start, spec, relative=False):
    """Pair-pixel evaluations the kernels make on these pairs, per pixel
    (T, Px): a pixel evaluates every pair of its tile until its
    transmittance drops below 1e-4 (the per-pixel stop), counted with the
    plain forward's own steps; ``relative`` for the preset's tile-relative
    centres."""
    import torch

    dev = geom.device
    tiles = torch.arange(spec.n_tiles, device=dev)
    pxc_all, pyc_all = rz._tile_pixel_coords(spec, tiles, relative)
    trans = torch.ones((spec.n_tiles, spec.px), device=dev)
    n_pix = torch.zeros((spec.n_tiles, spec.px), dtype=torch.int64,
                        device=dev)
    with torch.no_grad():
        for act, pos, valid in rz._tile_chunks(tile_start, spec):
            alpha, _, _ = rz._chunk_alpha(geom[pos].float(),
                                          pxc_all[act][:, None, :],
                                          pyc_all[act][:, None, :])
            one_m, t_before, live, _ = rz._chunk_weights(alpha, valid,
                                                         trans[act])
            n_pix[act] += (live & valid[..., None]).sum(1)
            trans[act] = t_before[:, -1] * one_m[:, -1]
    return n_pix


def fwd_bound(n_pix):
    """The forward kernel's bound against its plain version at a pixel that
    evaluates ``n_pix`` pairs: ``TOL + 3·n·u``, u = 2^-24.  Both composite
    the same pairs in the same order in f32 but round in another order: the
    kernel multiplies T by (1 - α) a pair at a time and sums w·c with FMAs,
    the plain version takes a cumprod inside 128-pair chunks and sums each
    chunk as a tree.  After i pairs each one's T carries at most i·u
    relative rounding error (i products), and each sum of its n terms at
    most n·u of Σ|w·c|, which is at most 1 (colors and Σw lie in [0, 1],
    Σw = 1 - T); so to first order the two differ by at most (2n + n)·u
    beyond ``TOL``, which holds the small-tile differences: the exp's
    rounding, and a pair whose T meets 1e-4 on one side only, which adds
    at most its w·c < 1e-4 (tests/test_rasterize.py:40-41)."""
    return TOL + 3.0 * n_pix.double() * 2.0 ** -24


def fwd_check(label, name, out, plain, n_pix):
    """The forward kernel's ``out`` against the plain version's, each pixel
    within :func:`fwd_bound` of the pairs it evaluates → (max abs, the
    worst pixel's (tile, pixel))."""
    import torch

    d = (out - plain).abs().amax(1)                                 # (T, Px)
    ratio = d.double() / fwd_bound(n_pix)
    worst = int(torch.argmax(d))
    w_ratio = int(torch.argmax(ratio))
    t, p = divmod(worst, d.shape[1])
    tr, pr = divmod(w_ratio, d.shape[1])
    print(f"  {label}: {name} max abs {float(d.max()):.3e} at tile {t} "
          f"pixel {p} ({int(n_pix[t, p])} pairs evaluated, bound "
          f"{float(fwd_bound(n_pix[t, p])):.3e}); worst ratio to the bound "
          f"{float(ratio.max()):.3f} at tile {tr} pixel {pr} "
          f"({int(n_pix[tr, pr])} pairs); most pairs a pixel evaluates "
          f"{int(n_pix.max())}", flush=True)
    check(float(ratio.max()) <= 1.0,
          f"{label}: {name} outside its per-pixel bound")
    return float(d.max()), (t, p)


def tile_f64(rz, geom, color, tile_start, spec, tile, pixel, out, plain):
    """One RGB tile composited in f64 from the same f32 pairs (the value
    both f32 versions round): prints each one's largest distance from it,
    and at ``pixel`` the kernel's difference from the plain version beside
    the f64 weight·color of the pairs on either side of the plain version's
    stop (a pixel whose T meets 1e-4 on one side only)."""
    import torch

    lo, hi = int(tile_start[tile]), int(tile_start[tile + 1])
    g, c = geom[lo:hi].double()[None], color[lo:hi].double()
    pxc, pyc = rz._tile_pixel_coords(
        spec, torch.tensor([tile], device=geom.device))
    alpha, _, _ = rz._chunk_alpha(g, pxc.double()[:, None, :],
                                  pyc.double()[:, None, :])
    one_m = 1.0 - alpha[0]                                       # (G, Px)
    t_before = torch.cat([torch.ones_like(one_m[:1]),
                          torch.cumprod(one_m, 0)[:-1]])
    live = t_before >= rz.STOP_THRESH
    w = torch.where(live, alpha[0] * t_before, torch.zeros_like(one_m))
    ref = torch.stack([(w * c[:, ch, None]).sum(0) for ch in range(3)]
                      + [w.sum(0)])                              # (4, Px)
    for who, x in (("kernel", out), ("plain", plain)):
        e = (x[tile].double() - ref).abs()
        print(f"  tile {tile} ({hi - lo} pairs) in f64: {who} max abs "
              f"{float(e.max()):.3e} from it, {float(e[:, pixel].max()):.3e}"
              f" at pixel {pixel}", flush=True)
    n = int(live[:, pixel].sum())
    wc = torch.cat([c, torch.ones_like(c[:, :1])], 1) \
        * (alpha[0][:, pixel] * t_before[:, pixel])[:, None]   # (G, 4)
    diff = (out[tile, :, pixel] - plain[tile, :, pixel]).double()

    def fmt(v):
        return "[" + ", ".join(f"{float(x):+.3e}" for x in v) + "]"

    print(f"  pixel {pixel}: kernel - plain {fmt(diff)}; f64 evaluates "
          f"{n} pairs; pair {n - 1}: T {float(t_before[n - 1, pixel]):.6e}, "
          f"w·c {fmt(wc[n - 1])}" + (
              f"; pair {n}: T {float(t_before[n, pixel]):.6e}, w·c "
              f"{fmt(wc[n])}" if n < hi - lo else ""), flush=True)


def kernel_bound(name, n_evals, tensors):
    """→ (bound ms, "bytes" or "operations"): ``tensors`` are the kernel's
    inputs and outputs, each counted once."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors
                  if t is not None)
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_evals * FLOPS_PER_EVAL[name] / F32_FLOPS_S * 1e3
    print(f"  {name} bound: {n_bytes / 1e6:.1f} MB ({t_bytes:.4f} ms), "
          f"{n_evals} evaluations x {FLOPS_PER_EVAL[name]} flops "
          f"({t_ops:.4f} ms)", flush=True)
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def write_colmap_scene(root, n_points=120, n_cameras=9, w=64, h=48,
                       focal=60.0, downsample=4, seed=0):
    """A small COLMAP scene (PINHOLE cameras, sparse/0/*.bin) whose images
    (images_<downsample>/*.png) the port's plain renderer draws from
    gaussians at the points, written by the port's COLMAP and PNG writers;
    the layout of the JAX package's test fixture
    (tests/fixtures.py::make_scene)."""
    import torch

    from gsplat_tpu_torch.models.camera import TileGrid
    from gsplat_tpu_torch.models.gaussians import table_from_numpy
    from gsplat_tpu_torch.models.splatter import make_specs, render_cropped
    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.utils.colmap import write_cameras_binary, \
        write_images_binary, write_points3d_binary
    from gsplat_tpu_torch.utils.image_io import write_png
    from gsplat_tpu_torch.utils.so3 import inverse_sigmoid

    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    img_dir = os.path.join(root, f"images_{downsample}")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    z = rng.uniform(2.0, 4.0, n_points)
    xyz = np.stack([rng.uniform(-0.35, 0.35, n_points) * z,
                    rng.uniform(-0.28, 0.28, n_points) * z, z], axis=1)
    rgb = (rng.uniform(0.2, 0.9, (n_points, 3)) * 255).astype(np.uint8)
    write_cameras_binary(os.path.join(sparse, "cameras.bin"), 1,
                         w * downsample, h * downsample, focal * downsample,
                         focal * downsample)
    poses = [(np.array([0.08 * (i - n_cameras / 2),
                        0.04 * ((i % 2) - 0.5), 0.0]), f"img_{i:03d}.png")
             for i in range(n_cameras)]
    write_images_binary(os.path.join(sparse, "images.bin"),
                        [((1.0, 0.0, 0.0, 0.0), -off, name)
                         for off, name in poses], 1)
    write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    # ground truth: opaque-ish isotropic gaussians at the points
    quat = np.tile(np.float32([1, 0, 0, 0]), (n_points, 1))
    table = table_from_numpy({
        "pos": xyz.astype(np.float32),
        "rgb": -np.log(255.0 / np.clip(rgb, 1, 254) - 1).astype(np.float32),
        "opa": np.full(n_points, inverse_sigmoid(0.8), np.float32),
        "quat": quat, "scale": np.full((n_points, 3), 0.06, np.float32),
        "live": np.ones(n_points, bool)}, n_points, "cpu")
    grid = TileGrid(width=w, height=h, focal_x=focal, focal_y=focal)
    cfg = SplatConfig()
    bspec, rspec = make_specs(grid, cfg)
    with torch.no_grad():
        for off, name in poses:
            img, _ = render_cropped(
                table.params(), table.live, torch.eye(3),
                torch.from_numpy(-off.astype(np.float32)), grid, cfg, bspec,
                rspec)
            write_png(os.path.join(img_dir, name),
                      (img.permute(1, 2, 0).numpy() * 255).astype(np.uint8))


def quantile_norm(table, cfg, q):
    """A quantile of the live gaussians' scale norms, to 3 digits (no
    gaussian sits on it to the last bit)."""
    import torch

    from gsplat_tpu_torch.ops.projection import activate_scale

    sn = activate_scale(table.scale[table.live], cfg.scale_activation)
    return float(f"{float(torch.quantile(sn.norm(dim=-1)[::4], q)):.3g}")


def trainer_path(rz, dev):
    """Trainer.train over iterations 600..660 on the RGB bench scene:
    → (the trainer, its launches, the per-step records)."""
    import torch

    from gsplat_tpu_torch.config import SplatConfig, TrainConfig
    from gsplat_tpu_torch.models.splatter import make_specs
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table
    from gsplat_tpu_torch.train import Trainer

    # the table one bucket up from its gaussians (524,288 slots, 0.97
    # full), as a trained table that densification filled would be
    table = synthetic_table(N_GAUSS, capacity_round=CAPACITY_ROUND,
                            focal=FOCAL, scale_px=2.5, frustum=(0.85, 0.55),
                            headroom=1.0, device=dev)
    cams = synthetic_cameras(TRAINER_CAMS, WIDTH, HEIGHT, FOCAL, device=dev)
    cfg = SplatConfig(capacity_round=CAPACITY_ROUND)
    bspec, rspec = make_specs(cams["grid"], cfg)
    splat = ground_truth_splat(table, cams, cfg, bspec, rspec,
                               range(TRAINER_CAMS), rz.composite_tiles_torch)
    # split every gaussian whose scale is in the top 6% and whose position
    # gradient is not zero (grad_thresh 1e-9, far below the default 2e-4):
    # the first event proposes more gaussians than the table has slots
    split_thresh = quantile_norm(table, cfg, 0.94)
    exp = os.path.join("chiprun_out", "chip_smoke_trainer")
    tcfg = TrainConfig(n_adaptive_control=N_ADAPTIVE, grad_thresh=1e-9,
                       split_thresh=split_thresh, exp=exp)
    tr = Trainer(splat, tcfg)
    check(len(tr.test_split) == TRAINER_CAMS // 8, "test split")
    records, events = [], []
    step = tr._step
    densify = tr._densify

    def timed_step(i, group=None):
        before = dict(rz.LAUNCHES)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        g, m = step(i, group)
        e1.record()
        torch.cuda.synchronize()
        records.append({"i": i, "ms": e0.elapsed_time(e1),
                        "loss": float(m["loss"]),
                        "n_pairs": int(m["n_pairs"]),
                        "launches": {k: rz.LAUNCHES[k] - before[k]
                                     for k in before}})
        return g, m

    def checked_densify(i, ac, in_reset):
        n0, cap0 = tr.splat.table.n_live, tr.splat.table.capacity
        densify(i, ac, in_reset)
        st, tbl = tr.last_densify, tr.splat.table
        events.append({"i": i, "n_live_before": n0, "capacity_before": cap0,
                       "n_live": tbl.n_live, "capacity": tbl.capacity,
                       "n_deleted": st.n_deleted, "n_cloned": st.n_cloned,
                       "n_split": st.n_split, "n_wanted": st.n_wanted,
                       "adam_t": int(tr.state.opt.t)})
        print(f"  densify @{i}: {json.dumps(events[-1])}", flush=True)

    tr._step, tr._densify = timed_step, checked_densify
    log = io.StringIO()
    reset_launches(rz)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        tr.train(n_iters=TRAIN_END, metrics_every=20, start=TRAIN_START)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    launches = dict(rz.LAUNCHES)
    print(f"{len(records)} steps in {wall:.3f} s wall (TEST evaluation and "
          f"checkpoint included); kernel launches {json.dumps(launches)}",
          flush=True)
    tr._step, tr._densify = step, densify
    return tr, launches, records, events, log.getvalue()


def check_trainer(tr, launches, records, events, log):
    check([r["i"] for r in records] == list(range(TRAIN_START, TRAIN_END)),
          "trainer steps")
    check([e["i"] for e in events] == list(range(TRAIN_START + N_ADAPTIVE,
                                                 TRAIN_END, N_ADAPTIVE)),
          f"densify events at {[e['i'] for e in events]}")
    for e in events:
        check(e["n_live"] == e["n_wanted"] == e["n_live_before"]
              - e["n_deleted"] + e["n_cloned"] + e["n_split"],
              f"densify @{e['i']}: n_live is not keep + clone + split")
        check(e["adam_t"] == 0, f"densify @{e['i']}: Adam not restarted")
    first = events[0]
    check(first["n_split"] >= 0.01 * first["n_live_before"],
          "fewer than 1% of the gaussians split")
    check(first["capacity"] > first["capacity_before"],
          "the first densify did not grow the table")
    check(all(np.isfinite(r["loss"]) for r in records), "non-finite loss")
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=1, rasterize_bwd=1)
    for r in records:
        check(r["launches"] == want,
              f"step {r['i']}: launches {r['launches']}")
    check("TEST @600:" in log, "no TEST line")
    # beyond the steps: TEST at 600 (per test camera its metrics, a warm-up
    # and 3 timed renders) and the render saved with the checkpoint
    want.update(rasterize_fwd=len(records) + 5 * len(tr.test_split) + 1,
                rasterize_bwd=len(records))
    check(launches == want, f"trainer launches {launches} != {want}")
    check(os.path.exists(os.path.join(tr.tcfg.exp, "ckpt.npz")),
          "the Trainer wrote no checkpoint")


def record_steps():
    """Patch Trainer._step (the class; Trainer.train takes its steps
    through it) to record each step's host time and pair count →
    (records, undo)."""
    from gsplat_tpu_torch.train import Trainer

    step = Trainer._step
    records = []

    def timed_step(self, i, group=None):
        t0 = time.perf_counter()
        g, m = step(self, i, group)
        # n_pairs stays a device scalar until the run ends: no extra sync
        records.append((i, time.perf_counter() - t0, m["n_pairs"]))
        return g, m

    def undo():
        Trainer._step = step

    Trainer._step = timed_step
    return records, undo


def densify_events(log):
    """The densify events of a run_garden_7k log: its lines "densify @i:
    n_live=.. capacity=.. K=.." → [{i, n_live, capacity, k, k_before}],
    k_before from the previous event or the "scene loaded" line."""
    events, k = [], None
    for line in log.splitlines():
        if line.startswith(("scene loaded:", "densify @")):
            f = dict(kv.split("=") for kv in line.split(":", 1)[1].split()
                     if "=" in kv)
            if line.startswith("densify @"):
                events.append({"i": int(line[9:line.index(":")]),
                               "n_live": int(f["n_live"]),
                               "capacity": int(f["capacity"]),
                               "k": int(f["K"]), "k_before": k})
            k = int(f["K"])
    return events


def run_7k(rz, argv):
    """run_garden_7k.main with the launch counts reset first and its output
    captured → (summary, trainer, launches, step records, log text)."""
    import torch

    from gsplat_tpu_torch.scripts import run_garden_7k

    records, undo = record_steps()
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(rz)
    try:
        with contextlib.redirect_stdout(out):
            summary, tr = run_garden_7k.main(argv)
        torch.cuda.synchronize()
    finally:
        undo()
    launches = dict(rz.LAUNCHES)
    records = [(i, dt, int(n)) for i, dt, n in records]
    return summary, tr, launches, records, out.getvalue()


def logged_l1(log):
    return [float(line.split("l1=")[1].split()[0])
            for line in log.splitlines() if line.startswith("iter ")]


def l1_by_iteration(log):
    """{iteration: l1} of a Trainer log's ``iter N: l1=...`` lines."""
    return {int(line.split()[1].rstrip(":")):
            float(line.split("l1=")[1].split()[0])
            for line in log.splitlines() if line.startswith("iter ")}


def step_rate(records, lo, hi):
    """Steps lo..hi-1: (it/s from the steps' host times, mean pairs)."""
    rows = [r for r in records if lo <= r[0] < hi]
    if not rows:
        return float("nan"), float("nan")
    return len(rows) / sum(r[1] for r in rows), \
        float(np.mean([r[2] for r in rows]))


def heaviest_view(params, live, views, grid, cfg):
    """The index of the view with the most pairs (projection and pack
    only); ``views`` are (rotation, translation, SH vectors) triples."""
    import torch

    from gsplat_tpu_torch.models.splatter import make_specs

    bspec, rspec = make_specs(grid, cfg)

    def blank(geom, color, tile_start, spec, shv):
        return torch.zeros((spec.n_tiles, 4, spec.px), device=geom.device)

    pairs = []
    with torch.no_grad():
        for rot, tran, shv in views:
            _, mid = staged_frame(params, live, rot, tran, grid, cfg, bspec,
                                  rspec, blank, shv=shv)
            pairs.append(int(mid["packed"].n_pairs))
    return int(np.argmax(pairs))


def at_scale_kernels(rz, label, params, live, view, grid, cfg, seed,
                     backward=True, preset=False):
    """One view of an at-scale table: the forward kernel (and the backward,
    with ``backward``; the RGB preset's forward on the bf16 preset pairs,
    with ``preset``) against its plain version on the same pairs, the pairs
    a tile, and each kernel alone against its plain version and its bound.
    ``view`` is (rotation, translation, SH vectors) → {kernel: {n_pairs,
    max_abs_err, ms, plain_ms, bound_ms, bound_by}}."""
    import torch

    from gsplat_tpu_torch.models.splatter import make_specs

    bspec, rspec = make_specs(grid, cfg)
    rot, tran, shv = view
    shv = shv if cfg.use_sh_coeff else None
    fwd = "rasterize_fwd_sh" if cfg.use_sh_coeff else "rasterize_fwd"
    with torch.no_grad():
        _, mid = staged_frame(params, live, rot, tran, grid, cfg, bspec,
                              rspec, rz.composite_tiles, shv=shv)
        pk, out = mid["packed"], mid["out"]
        plain = rz.composite_tiles_torch(pk.geom, pk.color, pk.tile_start,
                                         rspec, shv)
    torch.cuda.synchronize()
    n_pairs = int(pk.n_pairs)
    print(f"  {label}: {fwd}, n_pairs {n_pairs}", flush=True)
    n_pix = evaluations(rz, pk.geom, pk.tile_start, rspec)
    d, (tile, pixel) = fwd_check(label, fwd, out, plain, n_pix)
    if shv is None:
        tile_f64(rz, pk.geom, pk.color, pk.tile_start, rspec, tile, pixel,
                 out, plain)
    del plain, mid
    pair_histogram(pk.tile_start)
    args = (pk.geom, pk.color, pk.tile_start)
    n_ev = int(n_pix.sum())
    rows = {fwd: {"n_pairs": n_pairs, "max_abs_err": d, "bound": kernel_bound(
        fwd, n_ev, (*args, shv, out)), "fns": (
        lambda: rz.composite_tiles(*args, rspec, shv),
        lambda: rz.composite_tiles_torch(*args, rspec, shv))}}
    if backward:
        bwd = fwd.replace("fwd", "bwd")
        go = cotangent(seed, tuple(out.shape), out.device)
        with torch.no_grad():
            err, ratio, rel = bwd_compare(rz, pk, out, go, rspec, shv)
        print(f"  {label}: {bwd}: max abs {err:.3e} ({ratio:.3f} of the "
              f"per-pair bound); rel L2 {json.dumps(rel)}", flush=True)
        check(ratio <= 1.0, f"{label}: {bwd} outside the per-pair bound")
        check(max(rel.values()) <= FULL_REL_L2,
              f"{label}: {bwd} disagrees ({rel})")
        rows[bwd] = {"n_pairs": n_pairs, "max_abs_err": err,
                     "bound": kernel_bound(bwd, n_ev, (*args, shv, out, go,
                                                       pk.geom, pk.color)),
                     "fns": (lambda: rz.composite_tiles_bwd(
                         *args, out, go, rspec, shv),
                         lambda: rz.composite_tiles_bwd_torch(
                         *args, out, go, rspec, shv))}
    if preset:
        check(shv is None, f"{label}: the preset check is RGB only")
        pre = "rasterize_fwd_preset"
        with torch.no_grad():
            _, mid = staged_frame(params, live, rot, tran, grid, cfg, bspec,
                                  rspec, rz.composite_tiles_preset,
                                  preset=True)
            pp, out_p = mid["pairs"], mid["out"]
            plain = rz.composite_tiles_preset_torch(pp.geom, pp.color,
                                                    pp.tile_start, rspec)
        torch.cuda.synchronize()
        n_pix_p = evaluations(rz, pp.geom, pp.tile_start, rspec,
                              relative=True)
        d_p, _ = fwd_check(label, pre, out_p, plain, n_pix_p)
        del plain, mid
        p_args = (pp.geom, pp.color, pp.tile_start)
        rows[pre] = {"n_pairs": n_pairs, "max_abs_err": d_p,
                     "bound": kernel_bound(pre, int(n_pix_p.sum()),
                                           (*p_args, out_p)),
                     "fns": (lambda: rz.composite_tiles_preset(*p_args,
                                                               rspec),
                             lambda: rz.composite_tiles_preset_torch(
                                 *p_args, rspec))}
    with torch.no_grad():
        for name, row in rows.items():
            kernel, plain = row.pop("fns")
            row["ms"], row["plain_ms"] = time_fn(kernel, 20), \
                time_fn(plain, 1)
            row["bound_ms"], row["bound_by"] = row.pop("bound")
            print(f"  {name} alone ({label}, {n_pairs} pairs): kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
                  flush=True)
    return rows


def tile_boxes_check(params, live, cams, cfg, bspec):
    """View 0's tile boxes on the card against the CPU's from the same
    projected values: every box equal (the CPU counts JAX's and the TPU's
    1,002,683 pairs), so the card's division rounds as theirs
    (``ops/binning.div_rn``)."""
    import torch

    from gsplat_tpu_torch.ops.binning import _tile_bbox_rows
    from gsplat_tpu_torch.ops.projection import project_gaussians

    phase("tile boxes of view 0: the card against the CPU")
    grid = cams["grid"]
    with torch.no_grad():
        proj = project_gaussians(
            params["pos"], params["quat"], params["scale"],
            cams["w2c_rot"][0], cams["w2c_tran"][0], near=cfg.near,
            half_width=grid.width * 1.2 / 2 / grid.focal_x,
            half_height=grid.height * 1.2 / 2 / grid.focal_y,
            scale_activation=cfg.scale_activation)
        rows = (proj.mean2d[:, 0], proj.mean2d[:, 1], *proj.cov2d.unbind(1),
                proj.visible & live)
        card = _tile_bbox_rows(bspec, *rows)
        cpu = _tile_bbox_rows(bspec, *(r.cpu() for r in rows))
    k = bspec.max_tiles_per_gaussian
    pairs = [int(torch.clamp_max(b[2] * b[3], k).sum()) for b in (card, cpu)]
    differ = torch.zeros_like(cpu[0], dtype=torch.bool)
    for a, b in zip(card, cpu):
        differ |= a.cpu() != b
    print(f"  pairs {pairs[0]} on the card, {pairs[1]} on the CPU; "
          f"gaussians whose box differs: "
          f"{torch.nonzero(differ).flatten().tolist()}", flush=True)
    check(not bool(differ.any()), "the card's tile boxes differ from the "
          "CPU's")


def colmap_reader_check(path, n_points):
    """The port's native COLMAP reader (``csrc/colmap_reader.cpp``) against
    its Python parser on one ``points3D.bin``: the same points bit for bit
    (the file's doubles narrowed to f32)."""
    from gsplat_tpu_torch.ops import cuda_build
    from gsplat_tpu_torch.utils import colmap

    phase(f"native COLMAP reader vs the Python parser: {n_points} points")
    t0 = time.perf_counter()
    pos, rgb = colmap.read_points3d_arrays(path)
    t_native = time.perf_counter() - t0
    with open(path, "rb") as f:
        buf = f.read()
    t0 = time.perf_counter()
    pts = colmap._read_points3d_binary_python(buf)
    t_python = time.perf_counter() - t0
    xyz = np.stack([p.xyz for p in pts.values()]).astype(np.float32)
    col = np.stack([p.rgb for p in pts.values()]).astype(np.uint8)
    lib = cuda_build.BUILD_INFO["colmap_reader"]["path"]
    print(f"  {len(buf)} bytes; native {pos.shape[0]} points in "
          f"{t_native * 1e3:.1f} ms ({lib}), Python {len(pts)} in "
          f"{t_python * 1e3:.1f} ms; positions equal "
          f"{np.array_equal(pos, xyz)}, colors equal "
          f"{np.array_equal(rgb, col)}", flush=True)
    check(pos.shape == (n_points, 3) and len(pts) == n_points,
          f"COLMAP reader: {pos.shape[0]} / {len(pts)} points, want "
          f"{n_points}")
    check(np.array_equal(pos, xyz) and np.array_equal(rgb, col),
          "the native COLMAP reader differs from the Python parser")
    check("/gsplat_tpu/" not in lib, f"the reader came from {lib}")


def trainer_views(splat):
    """The Trainer's cameras as (rotation, translation, SH vectors)."""
    sc = splat.cameras
    return [(sc.w2c_rot[c], sc.w2c_tran[c], sc.sh_vecs[c])
            for c in range(sc.w2c_rot.shape[0])]


def at_scale_path(rz, dev):
    """The at-scale run on garden_hard: the scene built at its published
    size, run_garden_7k over iterations 0..AT_SCALE_ITERS - 1 (RGB), a
    resume check from its full state, and a short SH leg; after each leg
    its kernels on the heaviest view of its table against their plain
    versions.  → (launches by leg: scene build, RGB run, SH run; {leg:
    at_scale_kernels rows})."""
    import dataclasses

    import torch

    from gsplat_tpu_torch.models.splatter import Splatter
    from gsplat_tpu_torch.scripts import make_synth_scene
    from gsplat_tpu_torch.train import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_garden_hard_")
    try:
        scene = os.path.join(root, "scene")
        preset = make_synth_scene.PRESETS["garden_hard"]
        phase(f"at-scale scene: garden_hard ({preset['n_gt']} SH GT "
              f"gaussians, {preset['n_cams']} views at {preset['w']}x"
              f"{preset['h']}, {preset['n_points']} init points)")
        torch.cuda.synchronize()
        reset_launches(rz)
        built = make_synth_scene.main(scene, device=DEVICE,
                                      log=lambda msg: None, **preset)
        torch.cuda.synchronize()
        build = dict(rz.LAUNCHES)
        pairs = np.array([v["n_pairs"] for v in built["views"]])
        clipped = np.array([v["n_clipped"] for v in built["views"]])
        ceiling = built["oracle_ceiling_psnr"]
        print(f"  built in {built['seconds']:.1f} s; GT pairs a view: min "
              f"{pairs.min()} mean {pairs.mean():.0f} max {pairs.max()}; "
              f"clipped a view: mean {clipped.mean():.0f} max "
              f"{clipped.max()}; oracle ceiling {ceiling:.4f} dB (JAX "
              f"{JAX_CEILING}); kernel launches {json.dumps(build)}",
              flush=True)
        want = dict.fromkeys(KERNELS, 0)
        want.update(rasterize_fwd_sh=preset["n_cams"])
        check(build == want, f"scene build launches {build} != {want}")
        check(abs(ceiling - JAX_CEILING) <= 0.05,
              f"oracle ceiling {ceiling:.4f} dB, JAX {JAX_CEILING}")
        colmap_reader_check(os.path.join(scene, "sparse", "0",
                                         "points3D.bin"), preset["n_points"])
        gv = int(np.argmax(pairs))
        phase(f"at-scale kernels vs plain: the GT table, view {gv} (the "
              f"most pairs)")
        gt = built["table"]
        scale_rows = {"scene build": at_scale_kernels(
            rz, f"GT view {gv}", gt.params(), gt.live,
            make_synth_scene.view_inputs(*built["poses"][gv][:2],
                                         built["grid"], DEVICE),
            built["grid"], built["cfg"], seed=5, backward=False)}
        del built, gt
        torch.cuda.empty_cache()

        phase(f"at-scale RGB run: run_garden_7k, iterations 0-"
              f"{AT_SCALE_ITERS - 1}")
        torch.cuda.reset_peak_memory_stats(dev)
        exp = os.path.join(root, "rgb")
        t0 = time.perf_counter()
        summary, tr, rgb, records, log = run_7k(rz, [
            "--scene", scene, "--exp", exp, "--n_iters", str(FULL_ITERS),
            "--stop_at", str(AT_SCALE_ITERS), "--use_sh_coeff", "0",
            "--device", DEVICE])
        wall = time.perf_counter() - t0
        png_log = log
        print(log, end="")
        print(f"{len(records)} steps in {wall:.1f} s wall; kernel launches "
              f"{json.dumps(rgb)}", flush=True)
        check([r[0] for r in records] == list(range(AT_SCALE_ITERS)),
              "at-scale steps")
        check(all(np.isfinite(x) for x in logged_l1(log))
              and len(logged_l1(log)) >= AT_SCALE_ITERS // 50,
              "at-scale RGB: a logged l1 is not finite")
        n_test = len(tr.test_split)
        tests = summary["test_trajectory"]
        want = dict.fromkeys(KERNELS, 0)
        # a step each; per TEST and the final evaluate() 5 renders a test
        # camera (metrics, warm-up, 3 timed); the render saved at 1000
        want.update(rasterize_fwd=AT_SCALE_ITERS + 5 * n_test
                    * (len(tests) + 1) + 1, rasterize_bwd=AT_SCALE_ITERS)
        check(rgb == want, f"at-scale RGB launches {rgb} != {want}")
        events = densify_events(log)
        check([[e["i"], e["n_live"], e["capacity"]] for e in events]
              == [list(t) for t in summary["capacity_trajectory"][1:]],
              "densify log lines and capacity trajectory differ")
        check([e["i"] for e in events] == list(range(700, AT_SCALE_ITERS,
                                                     100)),
              f"densify events at {[e['i'] for e in events]}")
        cap0 = summary["capacity_trajectory"][0][2]
        for e in events:
            print(f"  densify @{e['i']}: {json.dumps(e)}", flush=True)
            check(e["n_live"] <= e["capacity"] <= AT_SCALE_MAX_CAPACITY,
                  f"densify @{e['i']}: n_live {e['n_live']} capacity "
                  f"{e['capacity']}")
            check(e["k"] <= AT_SCALE_K_CAP, f"densify @{e['i']}: K {e['k']}")
        check(max(e["capacity"] for e in events) > cap0,
              "the table's capacity never grew")
        grew = [e["i"] for e in events if e["k"] > e["k_before"]]
        cut = grew[0] if grew else AT_SCALE_ITERS
        (r0, p0), (r1, p1) = step_rate(records, 1, cut), \
            step_rate(records, cut + 1, AT_SCALE_ITERS)
        print(f"  K {events[0]['k_before']} -> "
              f"{tr.splat.cfg.max_tiles_per_gaussian} (grew at {grew}); "
              f"steps 1-{cut - 1}: {r0:.2f} it/s at {p0:.0f} pairs a view; "
              f"steps {cut + 1}-{AT_SCALE_ITERS - 1}:"
              f" {r1:.2f} it/s at {p1:.0f} pairs a view (max "
              f"{max(r[2] for r in records)}); wall "
              f"{summary['it_per_s_incl_compiles']:.2f} it/s with the "
              f"build, TESTs and saves; peak memory "
              f"{summary['peak_mem_gib']:.2f} GiB", flush=True)
        # the committed 7001-iteration run of this scene, same schedule
        full = {}
        if os.path.exists(PORT_RUN):
            with open(PORT_RUN) as f:
                full = {t[0]: t[1:] for t in json.load(f)["test_trajectory"]}
        print(f"  TEST (iteration: PSNR / SSIM here | {PORT_RUN} | JAX on a "
              f"TPU v5e):", flush=True)
        nan2 = (float("nan"), float("nan"))
        for it, p, s in tests:
            (fp, fs), (jp, js) = full.get(it, nan2), JAX_TEST.get(it, nan2)
            print(f"    {it:5d}: {p:.4f} / {s:.4f} | {fp:.4f} / {fs:.4f} | "
                  f"{jp:.4f} / {js:.4f}", flush=True)
            check(np.isfinite(p) and 0 < s <= 1, f"TEST @{it} out of range")
        check([t[0] for t in tests] == sorted(JAX_TEST),
              f"TEST iterations {[t[0] for t in tests]}")
        print(f"  final evaluate(): psnr {summary['final_psnr']:.4f} ssim "
              f"{summary['final_ssim']:.4f} fps {summary['final_fps']:.1f}; "
              f"{summary['n_gaussians']} gaussians", flush=True)

        sc = tr.splat.cameras
        phase(f"at-scale kernels vs plain: iteration {AT_SCALE_ITERS - 1}'s "
              f"table, the view with the most pairs")
        views = trainer_views(tr.splat)
        v = heaviest_view(tr.state.params, tr.state.live, views, sc.grid,
                          tr.splat.cfg)
        scale_rows["RGB run"] = at_scale_kernels(
            rz, f"view {v}", tr.state.params, tr.state.live, views[v],
            sc.grid, tr.splat.cfg, seed=6)
        torch.cuda.empty_cache()

        phase(f"at-scale timing: the train step on iteration "
              f"{AT_SCALE_ITERS - 1}'s table (CUDA events, after warm-up)")
        cams = {"w2c_rot": sc.w2c_rot, "w2c_tran": sc.w2c_tran,
                "sh_vecs": sc.sh_vecs, "images": sc.images, "grid": sc.grid}
        bspec, rspec = tr.splat.specs(sc.grid)
        time_steps("at-scale RGB", tr._train_step_for(0), tr.state, cams,
                   [int(c) for c in tr.train_split[:8]], tr.splat.cfg,
                   tr.tcfg, bspec, rspec, tr.lrs_at(AT_SCALE_ITERS),
                   rz.composite_tiles)
        phase(f"at-scale profile: the train step on iteration "
              f"{AT_SCALE_ITERS - 1}'s table (torch.profiler)")
        t0 = time.perf_counter()
        step, cam = tr._train_step_for(0), int(tr.train_split[0])
        lrs = tr.lrs_at(AT_SCALE_ITERS)
        profile_step(f"at-scale RGB train step, camera {cam}",
                     lambda: step(tr.state, cam, lrs))
        print(f"  {time.perf_counter() - t0:.1f} s", flush=True)

        phase("at-scale resume: load_full of the last full_state.npz into a "
              "fresh Trainer")
        path = os.path.join(exp, "full_state.npz")
        cfg = dataclasses.replace(tr.splat.cfg, max_tiles_per_gaussian=6)
        fresh = Trainer(Splatter(os.path.join(scene, "sparse", "0"),
                                 os.path.join(scene, "images_4"), cfg,
                                 device=DEVICE), tr.tcfg)
        check(fresh.load_full(path) == AT_SCALE_ITERS - 1,
              "load_full iteration")
        check(fresh.splat.cfg.max_tiles_per_gaussian
              == tr.splat.cfg.max_tiles_per_gaussian, "K not restored")
        check(fresh.splat.table.capacity == tr.splat.table.capacity
              and fresh.splat.table.n_live == tr.splat.table.n_live,
              "table not restored")
        check(same_state(tr.state, fresh.state),
              "load_full did not restore the state bit for bit")
        cam = int(tr.train_split[0])
        lrs = tr.lrs_at(AT_SCALE_ITERS)
        a, ma = tr._train_step_for(0)(tr.state, cam, lrs)
        b, mb = fresh._train_step_for(0)(fresh.state, cam, lrs)
        check(float(ma["loss"]) == float(mb["loss"]),
              "the next step's loss differs after load_full")
        print(f"  {os.path.getsize(path) / 1e6:.1f} MB; state bit-identical;"
              f" next step (camera {cam}) loss {float(ma['loss']):.6f} from "
              f"both, states after it bit-identical: {same_state(a, b)}",
              flush=True)
        del tr, fresh, a, b, ma, mb
        torch.cuda.empty_cache()

        phase(f"at-scale SH leg: run_garden_7k --use_sh_coeff 1, iterations "
              f"0-{AT_SCALE_SH_ITERS - 1}")
        summary, tr, sh, records, log = run_7k(rz, [
            "--scene", scene, "--exp", os.path.join(root, "sh"),
            "--n_iters", str(FULL_ITERS), "--stop_at",
            str(AT_SCALE_SH_ITERS), "--use_sh_coeff", "1",
            "--device", DEVICE, "--n_iters_test", str(AT_SCALE_SH_ITERS - 1)])
        print(log, end="")
        rate, mean_pairs = step_rate(records, 1, AT_SCALE_SH_ITERS)
        print(f"kernel launches {json.dumps(sh)}; {rate:.2f} it/s at "
              f"{mean_pairs:.0f} pairs a view", flush=True)
        check(all(np.isfinite(x) for x in logged_l1(log)),
              "at-scale SH: a logged l1 is not finite")
        want = dict.fromkeys(KERNELS, 0)
        want.update(rasterize_fwd_sh=AT_SCALE_SH_ITERS + 5 * len(
            tr.test_split) * 2, rasterize_bwd_sh=AT_SCALE_SH_ITERS)
        check(sh == want, f"at-scale SH launches {sh} != {want}")
        check(np.isfinite(summary["final_psnr"]), "SH leg: final PSNR")
        path = os.path.join(root, "sh", "full_state.npz")
        print(f"  full_state.npz {os.path.getsize(path) / 1e6:.1f} MB at "
              f"{tr.splat.table.capacity} slots", flush=True)
        phase(f"at-scale kernels vs plain: iteration {AT_SCALE_SH_ITERS - 1}"
              f"'s SH table, the view with the most pairs")
        views = trainer_views(tr.splat)
        v = heaviest_view(tr.state.params, tr.state.live, views,
                          tr.splat.cameras.grid, tr.splat.cfg)
        scale_rows["SH run"] = at_scale_kernels(
            rz, f"view {v}", tr.state.params, tr.state.live, views[v],
            tr.splat.cameras.grid, tr.splat.cfg, seed=7)
        del tr, views
        torch.cuda.empty_cache()
        jpeg = jpeg_capture_path(rz, scene, root, png_log)
        png_leg, tiff_leg, webp_leg, jp2_leg, gif_leg = image_formats_path(
            rz, scene, root)
        mid_png_leg, avif_leg, avif_screen_leg, avif_grain_leg, \
            avif_avis_leg, avif_colour_leg, avif_libavif_leg, \
            avif_inter_leg, avif_default_leg, avif_compound_leg, \
            avif_scaled_leg, avif_rebuilt_leg, tiff_mid_kinds_leg, \
            j2k_mid_ht_leg = avif_path(rz, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return (build, rgb, sh, jpeg, png_leg, tiff_leg, webp_leg, jp2_leg,
            gif_leg, mid_png_leg, avif_leg, avif_screen_leg,
            avif_grain_leg, avif_avis_leg, avif_colour_leg,
            avif_libavif_leg, avif_inter_leg, avif_default_leg,
            avif_compound_leg, avif_scaled_leg, avif_rebuilt_leg,
            tiff_mid_kinds_leg, j2k_mid_ht_leg), \
        scale_rows


def jpeg_capture_path(rz, scene, root, png_log):
    """The real-capture phase on garden_hard's 56 views: (a) each PNG view
    encoded with write_jpeg into a JPEG scene (images_4/img_XXX.JPG, the
    level run_garden_7k reads, and a sparse copy whose images.bin names
    them); (b) the JPEGs decoded and held to their PNGs (PSNR), then loaded
    through Splatter on the card; (c) run_garden_7k over iterations
    0..JPEG_ITERS - 1 of the RGB schedule from the JPEG scene, its last
    logged l1 beside the PNG leg's; (d) the image pyramid (python -m
    gsplat_tpu_torch.downsample --factor 2) over the 56 JPEGs; (e) the
    committed codec fixtures (tests/torch_jpeg/) bit for bit and byte for
    byte.  → the run's kernel launches."""
    import torch

    from gsplat_tpu_torch.bench import host_cpu
    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.splatter import Splatter
    from gsplat_tpu_torch.utils.image_io import read_jpeg, read_png, \
        write_jpeg

    host = host_cpu()
    phase(f"real capture (JPEG): garden_hard's views through write_jpeg, "
          f"read_jpeg, Splatter, run_garden_7k and downsample (host: {host})")
    torch.cuda.synchronize()
    reset_launches(rz)
    jscene = os.path.join(root, "scene_jpeg")
    src = os.path.join(scene, "images_4")
    dst = os.path.join(jscene, "images_4")
    sparse = os.path.join(jscene, "sparse", "0")
    os.makedirs(dst)
    os.makedirs(sparse)
    for name in ("cameras.bin", "points3D.bin"):
        shutil.copyfile(os.path.join(scene, "sparse", "0", name),
                        os.path.join(sparse, name))
    with open(os.path.join(scene, "sparse", "0", "images.bin"), "rb") as f:
        images_bin = f.read()
    pngs = sorted(n for n in os.listdir(src) if n.endswith(".png"))
    check(images_bin.count(b".png\x00") == len(pngs) == 56,
          f"{len(pngs)} PNG views, images.bin names "
          f"{images_bin.count(b'.png' + bytes(1))}")
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(images_bin.replace(b".png\x00", b".JPG\x00"))
    # (a) encode, (b) decode, each view timed alone
    views, enc_s, dec_s, psnrs, dmean = {}, [], [], [], []
    for name in pngs:
        img = read_png(os.path.join(src, name))
        jpg = os.path.join(dst, name[:-4] + ".JPG")
        t0 = time.perf_counter()
        write_jpeg(jpg, img)
        enc_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dec = read_jpeg(jpg)
        dec_s.append(time.perf_counter() - t0)
        check(dec.shape == img.shape and img.shape[2] == 3,
              f"{jpg}: decoded {dec.shape}, the PNG {img.shape}")
        diff = dec.astype(np.float64) - img
        mse = float(np.mean(diff * diff)) / 255.0 ** 2
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-20)))
        dmean.append(float(np.mean(np.abs(diff))) / 255.0)
        views[name[:-4] + ".JPG"] = dec
    size = sum(os.path.getsize(os.path.join(dst, n)) for n in views)
    h, w = img.shape[:2]
    print(f"  encode {sum(enc_s):.3f} s ({np.mean(enc_s) * 1e3:.2f} ms a "
          f"view), decode {sum(dec_s):.3f} s ({np.mean(dec_s) * 1e3:.2f} ms a"
          f" view), {len(views)} views at {w}x{h}, {size / 1e6:.2f}"
          f" MB of JPEG; PSNR against the PNG: min {min(psnrs):.3f} mean "
          f"{np.mean(psnrs):.3f} dB; mean |JPEG - PNG| max {max(dmean):.5f}"
          f" (host: {host})", flush=True)
    check(min(psnrs) > 30, f"a JPEG view at {min(psnrs):.2f} dB")
    t0 = time.perf_counter()
    splat = Splatter(sparse, dst, SplatConfig(), device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cams = splat.cameras
    check(len(splat.camera_groups) == 1 and cams.n_cameras == len(views)
          and cams.images.device.type == "cuda", "JPEG scene cameras")
    for i, name in enumerate(cams.names):
        check(torch.equal(cams.images[i].permute(1, 2, 0).cpu(),
                          torch.from_numpy(views[name])),
              f"{name}: Splatter's image is not read_jpeg's")
    print(f"  Splatter loaded the JPEG scene on the card in {load_s:.3f} s "
          f"({cams.n_cameras} views, {splat.table.n_live} gaussians); each"
          f" image read_jpeg's bit for bit", flush=True)
    check(sum(rz.LAUNCHES.values()) == 0, f"launches {dict(rz.LAUNCHES)}")
    del splat, cams
    torch.cuda.empty_cache()
    # (c) training from the JPEG scene
    summary, tr, launches, records, log = run_7k(rz, [
        "--scene", jscene, "--exp", os.path.join(root, "jpeg"), "--n_iters",
        str(FULL_ITERS), "--stop_at", str(JPEG_ITERS), "--use_sh_coeff", "0",
        "--device", DEVICE])
    print(log, end="")
    check([r[0] for r in records] == list(range(JPEG_ITERS)), "JPEG steps")
    l1 = l1_by_iteration(log)
    check(len(l1) >= JPEG_ITERS // 50 and all(np.isfinite(list(l1.values()))),
          "JPEG leg: a logged l1 is not finite")
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=JPEG_ITERS + 5 * len(tr.test_split) * (
        len(summary["test_trajectory"]) + 1), rasterize_bwd=JPEG_ITERS)
    check(launches == want, f"JPEG leg launches {launches} != {want}")
    png = l1_by_iteration(png_log)
    both = set(l1) & set(png)
    check(bool(both), "the JPEG and PNG legs logged no l1 at one iteration")
    last = max(both)
    bound = max(dmean) + JPEG_L1_DRIFT * png[last]
    rate, pairs = step_rate(records, 1, JPEG_ITERS)
    print(f"  iteration {last}: l1 {l1[last]:.4f} from JPEG, {png[last]:.4f}"
          f" from PNG, |difference| {abs(l1[last] - png[last]):.4f} <= bound "
          f"{bound:.4f}; TEST {summary['test_trajectory']}; {rate:.2f} it/s "
          f"at {pairs:.0f} pairs a view; kernel launches "
          f"{json.dumps(launches)}", flush=True)
    check(abs(l1[last] - png[last]) <= bound,
          f"JPEG leg l1 {l1[last]} vs PNG {png[last]}: beyond {bound}")
    del tr
    torch.cuda.empty_cache()
    # (d) the image pyramid over the JPEGs
    pyramid = os.path.join(root, "images_8_jpeg")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gsplat_tpu_torch.downsample", "--src", dst,
         "--dst", pyramid, "--factor", "2"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    down_s = time.perf_counter() - t0
    check(proc.returncode == 0 and not proc.stderr,
          f"downsample exit {proc.returncode}: {proc.stderr[-2000:]}")
    outs = sorted(os.listdir(pyramid))
    check(outs == sorted(views), f"downsample wrote {outs[:3]}...")
    # cv2's INTER_AREA size: the nearest integer, ties to even
    half = (int(np.rint(h / 2)), int(np.rint(w / 2)))
    check((h, w) != (840, 1297) or half == (420, 648), f"half size {half}")
    for name in outs:
        small = read_jpeg(os.path.join(pyramid, name))
        check(small.shape == (*half, 3), f"{name}: {small.shape}")
    print(f"  downsample --factor 2: {len(outs)} JPEGs at {half[1]}x"
          f"{half[0]} in {down_s:.3f} s (one process, its start included; "
          f"host: {host})", flush=True)
    # (e) the committed fixtures, the codec as the local compiler builds it
    helpers_dir = os.path.dirname(test_helpers().__file__)
    sys.path.insert(0, helpers_dir)
    import torch_make_jpeg_fixtures

    got = torch_make_jpeg_fixtures.check(scratch=root)
    print(f"  committed fixtures (tests/torch_jpeg/): {json.dumps(got)}",
          flush=True)
    check(all(got.values()) and len(got) == 7,
          f"codec fixtures differ: {got}")
    check(dict(rz.LAUNCHES) == launches, "launches after the JPEG leg")
    return launches


# The other formats' leg: BMP and PNM copies of this many views (TIFF: all)
FORMAT_VIEWS = 6
# a committed 1297x840 arithmetic-coded JPEG (progressive, restarts), for
# the decode seconds of that kind on the card's host
ARITH_VIEW = "tests/torch_images/timing_arith_1297x840.jpg"
LOSSY_WEBP_VIEW = "tests/torch_images/timing_lossy_1297x840.webp"
# committed 1297x840 JPEG 2000 views (torch_make_image_fixtures.TIMING_J2K):
# cv2's writer at X1000 = 50, and a 9/7 file in 3 layers, RPCL, tiles,
# precincts, SOP, EPH and PLT; each decode must hash as cv2's
J2K_VIEWS = ("tests/torch_images/timing_rate_1297x840.jp2",
             "tests/torch_images/timing_97_1297x840.jp2")


def _trainer_lines(log):
    """A run_garden_7k log's lines without their clocks: each ``iter`` line's
    iteration, l1, PSNR and pairs, each ``TEST`` line's PSNR and SSIM."""
    out = []
    for line in log.splitlines():
        if line.startswith("iter "):
            out.append(" ".join(line.split()[:5]))
        elif line.startswith("TEST "):
            out.append(" ".join(line.split()[:4]))
    return out


def _format_scene(scene, root, name, ext):
    """An empty copy of the scene for images of extension ``ext``: its
    sparse model, whose images.bin names them → (scene, images_4,
    sparse/0)."""
    fscene = os.path.join(root, name)
    dst = os.path.join(fscene, "images_4")
    sparse = os.path.join(fscene, "sparse", "0")
    for d in (dst, sparse):
        os.makedirs(d)
    for n in ("cameras.bin", "points3D.bin"):
        shutil.copyfile(os.path.join(scene, "sparse", "0", n),
                        os.path.join(sparse, n))
    with open(os.path.join(scene, "sparse", "0", "images.bin"), "rb") as f:
        images_bin = f.read()
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(images_bin.replace(b".png\x00", ext.encode() + b"\x00"))
    return fscene, dst, sparse


def image_formats_path(rz, scene, root):
    """The real-capture phase's other formats (utils/image_io beyond PNG and
    JPEG) on garden_hard's 56 views: (a) each PNG view through write_tiff,
    write_webp, write_jpeg2000, write_gif, write_hdr, write_pfm, write_pam
    and write_sunras into one scene a format (images_4/img_XXX.<ext> and
    sparse copies whose images.bin names them), FORMAT_VIEWS through
    write_bmp and write_pnm, each decoded back: equal to its PNG (TIFF,
    WebP, JPEG 2000, PFM, PAM, Sun raster, BMP, PPM), to gif_332 of it
    (GIF) and to hdr_round_trip of it (HDR); every format's encode and
    decode seconds a view timed, and the committed arithmetic-coded JPEG,
    lossy WebP and JPEG 2000 views and the YCbCr and CIELab TIFF views
    decoded (the WebP's, the JPEG 2000 views' and the TIFF views' pixels
    held to the SHA-256 of cv2's decode); (b) every scene
    through Splatter on the card, each ground-truth tensor equal to the PNG
    scene's (to the GIF and HDR maps' for those scenes); (c) run_garden_7k
    over iterations 0..JPEG_ITERS - 1 of the RGB schedule from the PNG,
    TIFF, WebP and JPEG 2000 scenes, the logged l1, PSNR, pair and TEST
    lines, the
    per-step pair counts and the final PSNR/SSIM equal (the input is
    lossless and the step deterministic), and from the GIF scene, its last
    l1 within d + JPEG_L1_DRIFT · l1_png of the PNG leg's (d the largest
    per-view mean |GIF - PNG|, the JPEG leg's rule); (d) the pyramid
    (python -m gsplat_tpu_torch.downsample --factor 2) over the TIFFs, the
    WebPs and the PFMs, equal to the PNGs' (downsample_area), over the
    GIFs, each file write_gif's bytes of downsample_area of its view, and
    over the JPEG 2000 files, each write_jpeg2000's bytes of it at cv2's
    default X1000 = 250 (rate 4); then --factor 1.5 and --factor 0.5 over
    the PNGs, each file downsample_area of its view; (e) the committed
    fixtures of tests/torch_images/ bit for bit and byte for byte, among
    them the SHA-256 of cv2's rate-4 JP2 of the committed 1297x840 view,
    which (a) also times.  → (the PNG leg's launches, the TIFF leg's, the
    WebP leg's, the JPEG 2000 leg's, the GIF leg's)."""
    import hashlib

    import torch

    from gsplat_tpu_torch.bench import host_cpu
    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.downsample import downsample_area
    from gsplat_tpu_torch.models.splatter import Splatter
    from gsplat_tpu_torch.utils import image_io

    helpers_dir = os.path.dirname(test_helpers().__file__)
    sys.path.insert(0, helpers_dir)
    import torch_make_image_fixtures as fx

    # the scenes after TIFF's and WebP's: read back equal to the PNG, but
    # GIF and HDR, held to their plain numpy maps (gif_332, hdr_round_trip)
    new_formats = (("gif", ".gif", image_io.write_gif),
                   ("hdr", ".hdr", image_io.write_hdr),
                   ("pfm", ".pfm", image_io.write_pfm),
                   ("pam", ".pam", image_io.write_pam),
                   ("ras", ".ras", image_io.write_sunras))
    host = host_cpu()
    phase(f"real capture (TIFF, WebP, JPEG 2000, GIF, HDR, PFM, PAM, Sun "
          f"raster, BMP, PNM): garden_hard's views through the writers, "
          f"read_image, "
          f"Splatter, run_garden_7k and downsample (host: {host})")
    torch.cuda.synchronize()
    reset_launches(rz)
    src = os.path.join(scene, "images_4")
    scenes = {"tiff": _format_scene(scene, root, "scene_tiff", ".tif"),
              "webp": _format_scene(scene, root, "scene_webp", ".webp"),
              "jp2": _format_scene(scene, root, "scene_jp2", ".jp2")}
    for kind, ext, _ in new_formats:
        scenes[kind] = _format_scene(scene, root, f"scene_{kind}", ext)
    exts = {"tiff": ".tif", "webp": ".webp", "jp2": ".jp2",
            **{kind: ext for kind, ext, _ in new_formats}}
    other = os.path.join(root, "bmp_pnm")
    os.makedirs(other)
    pngs = sorted(n for n in os.listdir(src) if n.endswith(".png"))
    check(len(pngs) == 56, f"{len(pngs)} PNG views")
    # (a) each format written and read back, each view timed alone
    secs = {k: [] for k in ("png read", "tiff write", "tiff read",
                            "webp write", "webp read", "jp2 write",
                            "jp2 read", "bmp write",
                            "bmp read", "ppm write", "ppm read")}
    for kind, _, _ in new_formats:
        secs[f"{kind} write"], secs[f"{kind} read"] = [], []
    secs["gif_332 (plain)"], secs["hdr_round_trip (plain)"] = [], []
    views, held, gif_mean, worst = {}, {}, [], {"gif": 0, "hdr": 0}
    for i, name in enumerate(pngs):
        t0 = time.perf_counter()
        img = image_io.read_png(os.path.join(src, name))
        secs["png read"].append(time.perf_counter() - t0)
        views[name] = img
        t0 = time.perf_counter()
        gif_want = image_io.gif_332(img)
        secs["gif_332 (plain)"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        hdr_want = image_io.hdr_round_trip(img)
        secs["hdr_round_trip (plain)"].append(time.perf_counter() - t0)
        held[name] = {"gif": gif_want, "hdr": hdr_want}
        for kind, want in held[name].items():
            worst[kind] = max(worst[kind], int(np.abs(
                want.astype(np.int64) - img).max()))
        gif_mean.append(float(np.mean(np.abs(
            gif_want.astype(np.float64) - img))) / 255.0)
        formats = [(kind, os.path.join(scenes[kind][1], name[:-4]
                                       + exts[kind]), writer)
                   for kind, writer in (("tiff", image_io.write_tiff),
                                        ("webp", image_io.write_webp),
                                        ("jp2", image_io.write_jpeg2000))]
        formats += [(kind, os.path.join(scenes[kind][1], name[:-4] + ext),
                     writer) for kind, ext, writer in new_formats]
        if i < FORMAT_VIEWS:
            formats += [("bmp", os.path.join(other, name[:-4] + ".bmp"),
                         image_io.write_bmp),
                        ("ppm", os.path.join(other, name[:-4] + ".ppm"),
                         image_io.write_pnm)]
        for kind, path, writer in formats:
            t0 = time.perf_counter()
            writer(path, img)
            secs[f"{kind} write"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = image_io.read_image(path)
            secs[f"{kind} read"].append(time.perf_counter() - t0)
            want = held[name].get(kind, img)
            check(back.shape == img.shape and np.array_equal(back, want),
                  f"{path}: read back differs from "
                  f"{'its PNG' if kind not in held[name] else kind}")
    h, w = img.shape[:2]
    here = os.path.dirname(os.path.abspath(__file__))
    for label, view in (("arithmetic JPEG read", ARITH_VIEW),
                        ("lossy WebP read", LOSSY_WEBP_VIEW)):
        for _ in range(3):
            t0 = time.perf_counter()
            dec = image_io.read_image(os.path.join(here, view))
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        check(dec.shape == (840, 1297, 3), f"{view}: {dec.shape}")
    digest = hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest()
    check(digest == fx.TIMING_WEBP_SHA256,
          f"{LOSSY_WEBP_VIEW}: decode SHA-256 {digest} is not cv2's "
          f"{fx.TIMING_WEBP_SHA256}")
    j2k_shas = []
    for label, view in zip(("JPEG 2000 rate-50 read", "JPEG 2000 9/7 read"),
                           J2K_VIEWS):
        for _ in range(3):
            t0 = time.perf_counter()
            dec = image_io.read_image(os.path.join(here, view))
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        sha = hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest()
        want = fx.TIMING_J2K[os.path.basename(view)]
        check(dec.shape == (840, 1297, 3) and sha == want,
              f"{view}: decode {dec.shape} SHA-256 {sha} is not cv2's {want}")
        j2k_shas.append(sha[:16] + "...")
    print(f"  the committed JPEG 2000 views decode as cv2 does (SHA-256 "
          f"{', '.join(j2k_shas)})", flush=True)
    # the committed YCbCr and CIELab TIFFs of the 1297x840 view (Pillow's,
    # Deflate), each decode held to cv2's SHA-256
    tiff_shas = []
    for label, name in (("TIFF YCbCr read", "timing_ycbcr_1297x840.tif"),
                        ("TIFF CIELab read", "timing_lab_1297x840.tif")):
        for _ in range(3):
            t0 = time.perf_counter()
            dec = image_io.read_image(os.path.join(fx.FOLDER, name))
            secs.setdefault(label, []).append(time.perf_counter() - t0)
        sha = hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest()
        check(dec.shape == (840, 1297, 3) and sha == fx.TIMING_TIFF[name],
              f"{name}: decode {dec.shape} SHA-256 {sha} is not cv2's")
        tiff_shas.append(sha[:16] + "...")
    print(f"  the committed YCbCr and CIELab TIFF views decode as cv2 does "
          f"(SHA-256 {', '.join(tiff_shas)})", flush=True)
    # a JPH file of HT code-blocks of the 1297x840 view, written on the host
    # (j2k_mid_file, lossless): its decode is cv2's (SHA-256) and the view
    garden = image_io.read_image(os.path.join(here, ARITH_VIEW))
    jph = os.path.join(root, "timing.jph")
    t0 = time.perf_counter()
    with open(jph, "wb") as f:
        f.write(fx.j2k_mid_file(garden, 1))
    t_jph = time.perf_counter() - t0
    for _ in range(3):
        t0 = time.perf_counter()
        dec = image_io.read_image(jph)
        secs.setdefault("jph read", []).append(time.perf_counter() - t0)
    sha = hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest()
    check(sha == fx.TIMING_JPH_SHA256 and np.array_equal(dec, garden),
          f"the JPH view: decode SHA-256 {sha} is not cv2's "
          f"{fx.TIMING_JPH_SHA256}, or not the view")
    print(f"  the JPH (HT) view: {os.path.getsize(jph)} bytes written in "
          f"{t_jph:.1f} s by the test-side writer, its decode cv2's "
          f"(SHA-256 {sha[:16]}...) and the view", flush=True)
    # cv2's default JP2 (X1000 = 250, rate 4) of the committed 1297x840
    # view, byte for byte: its SHA-256 (torch_make_image_fixtures.TIMING_CV2)
    rate4 = os.path.join(root, "rate4.jp2")
    for _ in range(3):
        t0 = time.perf_counter()
        image_io.write_jpeg2000(rate4, garden, 250)
        secs.setdefault("jp2 rate-4 write", []).append(
            time.perf_counter() - t0)
    with open(rate4, "rb") as f:
        rate4_bytes = f.read()
    sha = hashlib.sha256(rate4_bytes).hexdigest()
    check(sha == fx.TIMING_CV2["timing_default.jp2"],
          f"the rate-4 JP2 of {ARITH_VIEW}: SHA-256 {sha} is not cv2's")
    print(f"  the rate-4 JP2 of the committed view: {len(rate4_bytes)} bytes,"
          f" cv2's (SHA-256 {sha[:16]}...)", flush=True)
    sizes = {kind: sum(os.path.getsize(os.path.join(d, n))
                       for n in os.listdir(d))
             for kind, d in (("png", src), *((k, v[1])
                                             for k, v in scenes.items()))}
    print(f"  {len(views)} views at {w}x{h}, MB of each format's files: "
          f"{json.dumps({k: round(v / 1e6, 3) for k, v in sizes.items()})}"
          f" (bytes: {json.dumps(sizes)}); each read back equal to its PNG"
          f" (GIF to gif_332, HDR to hdr_round_trip); largest |GIF - PNG| "
          f"{worst['gif']}, |HDR - PNG| {worst['hdr']}, largest per-view "
          f"mean |GIF - PNG| {max(gif_mean):.5f}; the lossy WebP view's "
          f"decode is cv2's (SHA-256 {digest[:16]}...).  Seconds a view "
          f"(mean, min, max; host: {host}):", flush=True)
    for k, v in secs.items():
        print(f"    {k:24s} {np.mean(v):.4f} {min(v):.4f} {max(v):.4f} "
              f"({len(v)} views)", flush=True)
    print("image format seconds: " + json.dumps(
        {k: float(np.mean(v)) for k, v in secs.items()}), flush=True)
    # (b) the scenes on the card
    cams = {}
    for kind, (sp, im) in {"png": (os.path.join(scene, "sparse", "0"), src),
                           **{k: (v[2], v[1]) for k, v in scenes.items()}
                           }.items():
        t0 = time.perf_counter()
        splat = Splatter(sp, im, SplatConfig(), device=DEVICE)
        torch.cuda.synchronize()
        print(f"  Splatter loaded the {kind.upper()} scene on the card in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        cams[kind] = splat.cameras
        del splat
    a = cams["png"]
    for kind in scenes:
        b = cams.pop(kind)
        check(a.n_cameras == b.n_cameras == 56
              and b.images.device.type == torch.device(DEVICE).type
              and [n[:-4] for n in a.names]
              == [n.rsplit(".", 1)[0] for n in b.names],
              f"{kind.upper()} scene cameras")
        for i, name in enumerate(b.names):
            png = a.names[i]
            want = a.images[i] if kind not in held[png] else \
                torch.from_numpy(held[png][kind]).permute(2, 0, 1).to(DEVICE)
            check(torch.equal(b.images[i], want),
                  f"{name}: the {kind.upper()} scene's ground truth is not "
                  f"what its read-back was held to")
        for field in ("w2c_rot", "w2c_tran"):
            check(torch.equal(getattr(a, field), getattr(b, field)), field)
        held_to = "the PNG scene's" if kind not in held[png] else \
            f"{kind}'s plain map"
        print(f"  every ground-truth tensor of the {kind.upper()} scene "
              f"equal to {held_to} ({b.n_cameras} views)", flush=True)
        del b
    check(sum(rz.LAUNCHES.values()) == 0, f"launches {dict(rz.LAUNCHES)}")
    del cams, a
    torch.cuda.empty_cache()
    for kind in ("hdr", "pam", "ras"):          # not needed further
        shutil.rmtree(scenes.pop(kind)[0])
    # (c) training from the PNG, TIFF, WebP, JPEG 2000 and GIF scenes
    runs, logs = {}, {}
    for kind, sc in (("png", scene), *((k, scenes[k][0]) for k in
                                       ("tiff", "webp", "jp2", "gif"))):
        summary, tr, launches, records, log = run_7k(rz, [
            "--scene", sc, "--exp", os.path.join(root, f"leg_{kind}"),
            "--n_iters", str(FULL_ITERS), "--stop_at", str(JPEG_ITERS),
            "--use_sh_coeff", "0", "--device", DEVICE])
        check([r[0] for r in records] == list(range(JPEG_ITERS)),
              f"{kind} leg steps")
        want = dict.fromkeys(KERNELS, 0)
        want.update(rasterize_fwd=JPEG_ITERS + 5 * len(tr.test_split) * (
            len(summary["test_trajectory"]) + 1), rasterize_bwd=JPEG_ITERS)
        check(launches == want, f"{kind} leg launches {launches} != {want}")
        runs[kind] = (summary, launches, [r[2] for r in records],
                      _trainer_lines(log))
        logs[kind] = log
        rate, pairs = step_rate(records, 1, JPEG_ITERS)
        print(f"  {kind.upper()} leg: {rate:.2f} it/s at {pairs:.0f} pairs "
              f"a view; {' | '.join(runs[kind][3])}", flush=True)
        del tr
        torch.cuda.empty_cache()
    ps, pl, pp, plines = runs["png"]
    check(bool(plines) and any(x.startswith("TEST") for x in plines),
          "the PNG leg logged no TEST line")
    for kind in ("tiff", "webp", "jp2"):
        ts, tl, tp, tlines = runs[kind]
        up = kind.upper()
        check(tlines == plines, f"{up} leg lines {tlines} != PNG {plines}")
        check(tp == pp, f"the {up} leg's pairs a step differ from the PNG "
              f"leg's")
        check((ts["final_psnr"], ts["final_ssim"]) == (ps["final_psnr"],
                                                       ps["final_ssim"]),
              f"{up} final PSNR/SSIM {ts['final_psnr']} {ts['final_ssim']} "
              f"vs {ps['final_psnr']} {ps['final_ssim']}")
        check(tl == pl, f"{up} launches {tl} vs {pl}")
        print(f"  the {up} leg equals the PNG leg: {len(tlines)} logged "
              f"lines, {JPEG_ITERS} steps' pair counts, final PSNR "
              f"{ts['final_psnr']} SSIM {ts['final_ssim']}; launches "
              f"{json.dumps(tl)}", flush=True)
    l1, png = l1_by_iteration(logs["gif"]), l1_by_iteration(logs["png"])
    check(len(l1) >= JPEG_ITERS // 50 and all(np.isfinite(list(l1.values()))),
          "GIF leg: a logged l1 is not finite")
    both = set(l1) & set(png)
    check(bool(both), "the GIF and PNG legs logged no l1 at one iteration")
    last = max(both)
    bound = max(gif_mean) + JPEG_L1_DRIFT * png[last]
    gs = runs["gif"][0]
    print(f"  GIF leg, iteration {last}: l1 {l1[last]:.4f} from GIF, "
          f"{png[last]:.4f} from PNG, |difference| "
          f"{abs(l1[last] - png[last]):.4f} <= bound {bound:.4f}; final PSNR "
          f"{gs['final_psnr']} SSIM {gs['final_ssim']} (PNG {ps['final_psnr']}"
          f" {ps['final_ssim']}); launches {json.dumps(runs['gif'][1])}",
          flush=True)
    check(abs(l1[last] - png[last]) <= bound,
          f"GIF leg l1 {l1[last]} vs PNG {png[last]}: beyond {bound}")
    # (d) the pyramids against the PNGs' (GIF: write_gif's bytes, JP2:
    # write_jpeg2000's at cv2's default X1000 = 250)
    for kind in ("tiff", "webp", "pfm", "gif", "jp2"):
        ext = exts[kind]
        pyramid = os.path.join(root, f"images_8_{kind}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gsplat_tpu_torch.downsample", "--src",
             scenes[kind][1], "--dst", pyramid, "--factor", "2"],
            cwd=here, capture_output=True, text=True, timeout=600)
        down_s = time.perf_counter() - t0
        check(proc.returncode == 0 and not proc.stderr,
              f"downsample exit {proc.returncode}: {proc.stderr[-2000:]}")
        outs = sorted(os.listdir(pyramid))
        check(outs == sorted(n[:-4] + ext for n in pngs),
              f"downsample wrote {outs[:3]}...")
        nbytes = 0
        for name in outs:
            path = os.path.join(pyramid, name)
            nbytes += os.path.getsize(path)
            if kind in ("gif", "jp2"):
                ref = os.path.join(root, "pyramid_ref" + ext)
                if kind == "gif":
                    image_io.write_gif(ref, downsample_area(
                        image_io.read_gif(os.path.join(scenes[kind][1],
                                                       name)), 2))
                else:
                    image_io.write_jpeg2000(ref, downsample_area(
                        views[name[:-len(ext)] + ".png"], 2), 250)
                with open(ref, "rb") as f, open(path, "rb") as g:
                    check(f.read() == g.read(), f"{name}: the "
                          f"{kind.upper()} pyramid file is not the writer's "
                          f"bytes of the area mean")
                continue
            small = image_io.read_image(path)
            check(np.array_equal(small, downsample_area(
                views[name[:-len(ext)] + ".png"], 2)),
                f"{name}: the {kind.upper()} pyramid differs from the PNG's")
        held_to = {"gif": "write_gif of its area mean",
                   "jp2": "write_jpeg2000 of its area mean at X1000 250"
                   }.get(kind, "equal to the PNG pyramid")
        print(f"  downsample --factor 2: {len(outs)} {kind.upper()}s "
              f"({nbytes} bytes) in {down_s:.3f} s, each {held_to} (host: "
              f"{host})", flush=True)
    shutil.rmtree(scenes.pop("jp2")[0])         # not needed further
    # a fractional and an enlarging factor over the PNGs
    for factor in (1.5, 0.5):
        pyramid = os.path.join(root, f"images_png_f{factor}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gsplat_tpu_torch.downsample", "--src",
             src, "--dst", pyramid, "--factor", str(factor)],
            cwd=here, capture_output=True, text=True, timeout=600)
        down_s = time.perf_counter() - t0
        check(proc.returncode == 0 and not proc.stderr,
              f"downsample --factor {factor} exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        outs = sorted(os.listdir(pyramid))
        check(outs == pngs, f"downsample --factor {factor} wrote "
              f"{outs[:3]}...")
        for name in outs:
            small = image_io.read_png(os.path.join(pyramid, name))
            check(np.array_equal(small, downsample_area(views[name],
                                                        factor)),
                  f"{name}: the pyramid at {factor} is not downsample_area")
        print(f"  downsample --factor {factor}: {len(outs)} PNGs at "
              f"{small.shape[1]}x{small.shape[0]} in {down_s:.3f} s, each "
              f"downsample_area of its view (host: {host})", flush=True)
        shutil.rmtree(pyramid)
    # (e) the committed fixtures
    got = fx.check(scratch=root)
    bad = [k for k, v in got.items() if not v]
    print(f"  committed fixtures (tests/torch_images/): {len(got)} files, "
          f"{len(got) - len(bad)} as cv2 reads (or refuses) them; "
          f"{json.dumps(got)}", flush=True)
    check(not bad and len(got) == len(fx.CASES) + len(fx.REFUSED)
          + len(fx.GARBLED) + len(fx.ENCODED) + len(fx.ENCODED_J2K)
          + len(fx.ENCODED_J2K_RATE) + len(fx.RESIZED) + len(fx.TIMING_CV2)
          + len(fx.ROUND_TRIP) + len(fx.TIMING_AVIF)
          + len(fx.TIMING_TIFF),
          f"image fixtures differ: {bad}")
    return pl, runs["tiff"][1], runs["webp"][1], runs["jp2"][1], \
        runs["gif"][1]


# the committed AVIF views of tests/torch_images/ whose decodes chip_smoke
# times (torch_make_image_fixtures.TIMING_AVIF holds every AVIF view's
# SHA-256): cv2's default, 10-bit and 12-bit files of the 1297x840 view and
# a lossless 320x208 crop of it; Pillow's screen content (palette and intra
# block copy), 4:2:2, 4:0:0, RGBA (an alpha item), film grain (libaom's
# test vector 1) and denoiser files of it, and a 3x2 grid of Pillow's
# 4:4:4 tiles of it; Pillow's two-frame image sequences (avis) of it at its
# default, speed 3, speed 2 and aq-mode=1 (AVIS_TOOLS); Pillow's files of it
# with an ICC profile, limited range, a premultiplied alpha and an EXIF
# orientation 6 (irot), and cv2's default file with a BT.709 limited nclx;
# libaom's superres (denominator 12) and delta loop filter files of it,
# one in YCgCo (libavif's own path) and cv2's file of it at 1040x672 under
# an ispe of 1297x840 (libavif scales it: LIBAVIF_TOOLS); libaom's
# key frame of it translated, then an inter frame of it, and libaom at its
# default inter tools on the view translated twice, then the view itself
# (INTER_TOOLS); libaom at every default, compound prediction's too, on
# the view moved three times with sensor noise, then the view (its compound
# and skip-mode blocks: COMPOUND_VIEW, timed against AVIF_TIMED's first);
# libaom's key frame of it translated three times, then inter frames coded
# at 8/12 of its size predicting from it (its scaled blocks: RESIZE_VIEW,
# timed against AVIF_TIMED's first); libaom's error resilient frames of it
# translated twice, then of it, the last frame's LAST slot rebuilt from
# ref_order_hint (its rebuilt slot and the blocks that predict from it:
# REBUILT_VIEW, timed against AVIF_TIMED's first)
AVIF_TIMED = ("timing_default_1297x840.avif", "timing_d10_1297x840.avif",
              "timing_d12_1297x840.avif", "timing_lossless_320x208.avif",
              "timing_screen_1297x840.avif", "timing_422_1297x840.avif",
              "timing_400_1297x840.avif", "timing_alpha_1297x840.avif",
              "timing_grain_1297x840.avif", "timing_denoise_1297x840.avif",
              "timing_grid_1297x840.avif", "timing_avis_1297x840.avif",
              "timing_avis_s3_1297x840.avif", "timing_avis_s2_1297x840.avif",
              "timing_avis_aq_1297x840.avif", "timing_icc_1297x840.avif",
              "timing_limited_1297x840.avif", "timing_prem_1297x840.avif",
              "timing_irot_1297x840.avif", "timing_bt709_1297x840.avif",
              "timing_superres_1297x840.avif",
              "timing_deltalf_1297x840.avif", "timing_ycgco_1297x840.avif",
              "timing_scaled_1297x840.avif", "timing_inter_1297x840.avif",
              "timing_tools_1297x840.avif", "timing_compound_1297x840.avif",
              "timing_resize_1297x840.avif", "timing_rebuilt_1297x840.avif")
# the view of compound prediction and skip mode, whose decode must count
# compound blocks and skip-mode blocks (decode_av1's info[67:72])
COMPOUND_VIEW = "timing_compound_1297x840.avif"
# the view of inter frames predicted from a reference of another size,
# whose decode must count blocks predicted from a scaled reference
# (decode_av1's info[73])
RESIZE_VIEW = "timing_resize_1297x840.avif"
# the view of a reference slot rebuilt from ref_order_hint, whose decode
# must count a slot rebuilt and blocks predicted from it (decode_av1's
# info[80:84])
REBUILT_VIEW = "timing_rebuilt_1297x840.avif"
AVIF_REPS = 3
# the view whose palette and intra block copy blocks the phase counts
AVIF_SCREEN_VIEW = "timing_screen_1297x840.avif"
# the views whose film grain and grid the phase shows in use
AVIF_GRAIN_VIEWS = ("timing_grain_1297x840.avif",
                    "timing_denoise_1297x840.avif")
AVIF_GRID_VIEW = "timing_grid_1297x840.avif"
# each image sequence view, the tools its first frame must be shown to use
# (decode_av1's counts above 0): loop restoration's switchable frames and
# self-guided units, 128x128 superblocks and 2x2 tiles at speed 3, Wiener
# units at speed 2, blocks of two segment ids at aq-mode=1
AVIS_TOOLS = {
    "timing_avis_1297x840.avif": (),
    "timing_avis_s3_1297x840.avif": ("switchable", "sgrproj_units",
                                     "sb128", "tiles_2x2"),
    "timing_avis_s2_1297x840.avif": ("wiener_units",),
    "timing_avis_aq_1297x840.avif": ("segment_0_blocks",
                                     "segment_1_blocks"),
}


# each view of this slice's kinds and what its decode must show in use:
# superres's denominator (8: none) and loop restoration units on the
# upscaled frame; blocks with a nonzero delta loop filter level; YCgCo
# (matrix 8), which libavif converts on its own path; a frame of another
# size than its ispe (libavif scales it)
LIBAVIF_TOOLS = {
    "timing_superres_1297x840.avif": ("superres_denominator",
                                      "restoration_units"),
    "timing_deltalf_1297x840.avif": ("delta_lf_blocks",),
    "timing_ycgco_1297x840.avif": ("libavif_path",),
    "timing_scaled_1297x840.avif": ("scaled",),
}


# each view of the inter slices' kinds and what its decode must count above
# 0 (decode_av1's counters of the whole data): frames decoded, inter blocks
# (of any MV mode), NEWMV blocks; frames with motion-field projection and
# blocks whose MV stack took a temporal candidate (libaom's default inter
# tools; the phase prints the warped, OBMC and inter-intra counts too)
INTER_TOOLS = {
    "timing_inter_1297x840.avif": ("frames_after_the_first", "inter_blocks",
                                   "newmv_blocks"),
    "timing_tools_1297x840.avif": ("frames_after_the_first",
                                   "ref_mvs_frames", "temporal_blocks"),
}


def avif_path(rz, root):
    """AVIF scenes on the card: (a) every committed AVIF view
    (torch_make_image_fixtures.TIMING_AVIF: cv2's default, 10-bit, 12-bit
    and lossless files of the 1297x840 view or a crop of it, Pillow's 4x2
    tiles, 4:4:4, screen content, 4:2:2, 4:0:0, RGBA, film grain, the
    denoiser, a grid, and Pillow's two-frame image sequences) decoded by
    read_avif, each decode held to the SHA-256 of cv2's, AVIF_TIMED's over
    AVIF_REPS calls each (the line ``avif decode seconds: {...}``), the
    palette and intra block copy blocks of AVIF_SCREEN_VIEW counted by the
    decoder (both above 0), the grain of AVIF_GRAIN_VIEWS applied,
    AVIF_GRID_VIEW's tiles counted, and each sequence's first frame read
    from its track with the tools of AVIS_TOOLS counted above 0 (loop
    restoration units by type, blocks by segment id); (b) make_synth_scene's
    mid preset (seed 0: 24 views at 640x416) built on the card, and four
    copies of it whose images.bin names the committed AVIF_MID views (cv2's
    default AVIF of the same preset's views built on a CPU), the committed
    AVIF_MID_SCREEN views (Pillow's tune-content=screen, 4:2:2, with an
    alpha item), the committed AVIF_MID_GRAIN views (Pillow's film grain:
    libaom's test vectors, its denoiser), the committed AVIF_MID_AVIS
    views (Pillow's image sequences at speeds 2-4, some with aq-mode=1) and
    the committed AVIF_MID_COLOUR views (Pillow's ICC profile, EXIF
    orientations 2, 3 and 6, limited range and premultiplied RGBA in turn)
    and the committed AVIF_MID_LIBAVIF views (libaom's superres, its delta
    loop filter, the matrices libavif converts itself, in turn) and the
    committed AVIF_MID_INTER views (libaom's key frame of the view
    translated, then an inter frame of it) and the committed
    AVIF_MID_DEFAULT views (libaom at its default inter tools: a key frame,
    then two inter frames) and the committed AVIF_MID_COMPOUND views
    (libaom at every default, compound prediction's too: a key frame, then
    three inter frames, their compound and skip-mode blocks counted above
    0) and the committed AVIF_MID_SCALED views (libaom's key frame, then
    two inter frames resized to 8/d of it or coded with superres at 8/d,
    in turn; the views that predicted from a scaled reference counted
    above 0) and the committed AVIF_MID_REBUILT views (libaom's error
    resilient frames with a reference slot rebuilt from ref_order_hint, in
    turn one the last frame's blocks predict from, the same with inter
    frames resized to half (a 2x reference), and one whose buffer kept an
    earlier frame's state that a later frame without error resilience
    reads; each decode held to the SHA-256 of cv2's, REBUILT_MID_SHA256,
    and the views of each kind counted above 0 by the decoder), and a TIFF
    copy (tiff_mid_kinds) whose views are AVIF_MID's
    decodes written on the host in turn as 16-bit CIELab, 4:2:0 YCbCr
    under LZW and Predictor 2 and old-style LZW RGB
    (torch_make_image_fixtures.tiff_mid_file), each decode held to the
    SHA-256 of cv2's (TIFF_MID_SHA256) and the views that took each kind
    counted above 0, and a JPEG 2000 copy (j2k_mid_ht) whose views are
    AVIF_MID's decodes written on the host in turn as a raw codestream of
    HT cleanup passes and as a JPH file whose SigProp and MagRef passes
    finish plane 0 (torch_make_image_fixtures.j2k_mid_file, lossless), each
    decode held to the SHA-256 of cv2's (J2K_MID_SHA256) and to its AVIF
    decode, each kind counted above 0; each view's mean |AVIF (or TIFF,
    JPEG 2000) - PNG|; (c)
    run_garden_7k over iterations
    0..JPEG_ITERS - 1 of the RGB schedule from the PNG scene and from each
    AVIF scene and the TIFF one, each such leg's last logged l1 within d +
    JPEG_L1_DRIFT · l1_png of the PNG leg's (d the largest per-view mean
    |AVIF (or TIFF) - PNG| of its views, the JPEG and GIF legs' rule),
    every leg's it/s; the JPEG 2000 leg's logged lines, pairs a step,
    final PSNR/SSIM and launches equal to the cv2 AVIF leg's.  → (the PNG
    leg's launches, the cv2 AVIF leg's, the screen AVIF leg's, the grain
    AVIF leg's, the avis leg's, the colour leg's, the libavif leg's, the
    inter leg's, the default inter tools' leg's, the compound leg's, the
    scaled leg's, the rebuilt leg's, the TIFF kinds leg's, the JPEG 2000
    HT leg's).  LIBAVIF_TOOLS' and INTER_TOOLS' views are shown using
    their tools, COMPOUND_VIEW's compound and skip-mode blocks,
    RESIZE_VIEW's scaled blocks and REBUILT_VIEW's rebuilt slot and the
    blocks that predict from it counted and their read_avif seconds
    printed beside AVIF_TIMED's first's."""
    import hashlib

    import torch

    from gsplat_tpu_torch.bench import host_cpu
    from gsplat_tpu_torch.scripts import make_synth_scene
    from gsplat_tpu_torch.utils import image_io

    t_phase = time.perf_counter()
    helpers_dir = os.path.dirname(test_helpers().__file__)
    sys.path.insert(0, helpers_dir)
    import torch_make_image_fixtures as fx

    host = host_cpu()
    phase(f"AVIF: the committed views through read_avif, the mid scene "
          f"from AVIF, from the TIFF kinds and from HT JPEG 2000 through "
          f"run_garden_7k (host: {host})")
    # (a) the committed views
    secs, shas = {}, []
    for name, want in fx.TIMING_AVIF.items():
        path = os.path.join(fx.FOLDER, name)
        reps = AVIF_REPS if name in AVIF_TIMED else 1
        for _ in range(reps):
            t0 = time.perf_counter()
            dec = image_io.read_avif(path)
            dt = time.perf_counter() - t0
            if name in AVIF_TIMED:
                secs.setdefault(name, []).append(dt)
        sha = hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest()
        check(sha == want, f"{name}: decode {dec.shape} SHA-256 {sha} is "
              f"not cv2's {want}")
        shas.append(f"{name} {dec.shape[1]}x{dec.shape[0]} "
                    f"{sha[:12]}...")
    print(f"  the committed AVIF views decode as cv2 does: "
          f"{'; '.join(shas)}", flush=True)
    for name, v in secs.items():
        print(f"    read_avif {name:32s} {np.mean(v):.4f} {min(v):.4f} "
              f"{max(v):.4f} s ({len(v)} calls)", flush=True)
    print("avif decode seconds: " + json.dumps(
        {k: float(np.mean(v)) for k, v in secs.items()}), flush=True)
    with open(os.path.join(fx.FOLDER, AVIF_SCREEN_VIEW), "rb") as f:
        heif = image_io._Heif(f.read(), AVIF_SCREEN_VIEW)
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    tools = dict(screen_content_tools=info[18], intrabc_allowed=info[19],
                 palette_blocks=info[20], intrabc_blocks=info[21])
    print(f"  {AVIF_SCREEN_VIEW}: {json.dumps(tools)}", flush=True)
    check(tools["palette_blocks"] > 0 and tools["intrabc_blocks"] > 0,
          f"{AVIF_SCREEN_VIEW} decoded no palette or IntraBC block: {tools}")
    for name in AVIF_GRAIN_VIEWS:
        with open(os.path.join(fx.FOLDER, name), "rb") as f:
            heif = image_io._Heif(f.read(), name)
        heif.parse()
        info = image_io.decode_av1(heif.primary_item()[0])[1]
        check(info[22] == 1, f"{name}: no film grain applied")
    with open(os.path.join(fx.FOLDER, AVIF_GRID_VIEW), "rb") as f:
        heif = image_io._Heif(f.read(), AVIF_GRID_VIEW)
    heif.parse()
    tiles, _, grid = heif.primary_image()
    print(f"  {', '.join(AVIF_GRAIN_VIEWS)}: film grain applied; "
          f"{AVIF_GRID_VIEW}: a {grid[1]}x{grid[0]} grid of {len(tiles)} "
          f"tiles", flush=True)
    check(grid is not None and len(tiles) == 6,
          f"{AVIF_GRID_VIEW} is not a grid of 6 tiles: {grid}")
    for name, needs in AVIS_TOOLS.items():
        with open(os.path.join(fx.FOLDER, name), "rb") as f:
            heif = image_io._Heif(f.read(), name)
        heif.parse()
        check(heif.source == "tracks", f"{name}: not read from its track")
        info = image_io.decode_av1(heif.track_image(
            heif.colour_track()[0])[0])[1]
        tools = dict(switchable=int(3 in info[26:29]),
                     sgrproj_units=info[30], wiener_units=info[29],
                     sb128=info[12], tiles_2x2=int(info[10:12] == [2, 2]),
                     segment_0_blocks=info[32], segment_1_blocks=info[33])
        print(f"  {name}: loop restoration types (Y, U, V) {info[26:29]}, "
              f"{json.dumps(tools)}", flush=True)
        check(all(tools[k] > 0 for k in needs),
              f"{name}: the first frame used none of some of {needs}: "
              f"{tools}")
    for name, needs in LIBAVIF_TOOLS.items():
        with open(os.path.join(fx.FOLDER, name), "rb") as f:
            heif = image_io._Heif(f.read(), name)
        heif.parse()
        tiles, props, _ = heif.primary_image()
        info = image_io.decode_av1(tiles[0][0])[1]
        matrix = image_io._avif_cicp(props, info)[1]
        tools = dict(superres_denominator=int(info[40] != 8) * info[40],
                     coded_width=info[41],
                     restoration_units=info[29] + info[30],
                     delta_lf_blocks=info[44], matrix=matrix,
                     libavif_path=int(image_io._avif_matrix(
                         matrix, 1, True, info[2], 1, 1, name) ==
                         "libavif"),
                     scaled=int(tuple(info[:2]) != struct.unpack_from(
                         ">II", props[b"ispe"], 4)))
        print(f"  {name}: {json.dumps(tools)}", flush=True)
        check(all(tools[k] > 0 for k in needs),
              f"{name}: the decode used none of some of {needs}: {tools}")
    default, comp = np.mean(secs[AVIF_TIMED[0]]), np.mean(secs[COMPOUND_VIEW])
    print(f"  {COMPOUND_VIEW}: read_avif {comp:.4f} s a call, "
          f"{comp / default:.2f}x {AVIF_TIMED[0]}'s {default:.4f} s (this "
          f"call, host: {host})", flush=True)
    with open(os.path.join(fx.FOLDER, COMPOUND_VIEW), "rb") as f:
        counts = compound_counts(fx.compound_info(f.read()))
    print(f"  {COMPOUND_VIEW}: {json.dumps(counts)}", flush=True)
    check(sum(counts["compound_blocks"].values()) > 0 and
          counts["skip_mode_blocks"] > 0,
          f"{COMPOUND_VIEW} decoded no compound or no skip-mode block: "
          f"{counts}")
    resized = np.mean(secs[RESIZE_VIEW])
    print(f"  {RESIZE_VIEW}: read_avif {resized:.4f} s a call, "
          f"{resized / default:.2f}x {AVIF_TIMED[0]}'s {default:.4f} s (this "
          f"call, host: {host})", flush=True)
    with open(os.path.join(fx.FOLDER, RESIZE_VIEW), "rb") as f:
        counts = scaled_counts(fx.scaled_info(f.read()))
    print(f"  {RESIZE_VIEW}: {json.dumps(counts)}", flush=True)
    check(counts["scaled_blocks"] > 0,
          f"{RESIZE_VIEW} decoded no block from a scaled reference: "
          f"{counts}")
    rebuilt = np.mean(secs[REBUILT_VIEW])
    print(f"  {REBUILT_VIEW}: read_avif {rebuilt:.4f} s a call, "
          f"{rebuilt / default:.2f}x {AVIF_TIMED[0]}'s {default:.4f} s (this "
          f"call, host: {host})", flush=True)
    with open(os.path.join(fx.FOLDER, REBUILT_VIEW), "rb") as f:
        counts = rebuilt_counts(fx.rebuilt_info(f.read()))
    print(f"  {REBUILT_VIEW}: {json.dumps(counts)}", flush=True)
    check(counts["slots_rebuilt"] > 0 and counts["blocks_from_rebuilt"] > 0,
          f"{REBUILT_VIEW} rebuilt no slot or predicted no block from one: "
          f"{counts}")
    for name, needs in INTER_TOOLS.items():
        with open(os.path.join(fx.FOLDER, name), "rb") as f:
            heif = image_io._Heif(f.read(), name)
        heif.parse()
        info = image_io.decode_av1(heif.primary_item()[0])[1]
        tools = dict(frames_after_the_first=info[46] - 1,
                     intra_only_frames=info[47], show_existing=info[48],
                     inter_blocks=sum(info[49:53]),
                     blocks_by_mode=dict(zip(
                         ("nearestmv", "nearmv", "globalmv", "newmv"),
                         info[49:53])), newmv_blocks=info[52],
                     blocks_by_filters=dict(zip(
                         ("regular", "smooth", "sharp", "bilinear", "dual"),
                         info[53:58])), **dict(zip(
                             ("ref_mvs_frames", "temporal_blocks",
                              "localwarp_blocks", "localwarp_invalid",
                              "global_motion_refs", "global_warped_blocks",
                              "obmc_blocks", "interintra_smooth_blocks",
                              "interintra_wedge_blocks"), info[58:67])))
        print(f"  {name}: {json.dumps(tools)}", flush=True)
        check(all(tools[k] > 0 for k in needs),
              f"{name}: the decode used none of some of {needs}: {tools}")
    # (b) the mid scene, from PNG and from the committed AVIFs
    scene = os.path.join(root, "mid")
    preset = make_synth_scene.PRESETS["mid"]
    t0 = time.perf_counter()
    make_synth_scene.main(scene, device=DEVICE, log=lambda msg: None,
                          **preset)
    torch.cuda.synchronize()
    print(f"  mid scene built on the card in {time.perf_counter() - t0:.1f} "
          f"s ({preset['n_cams']} views at {preset['w']}x{preset['h']})",
          flush=True)
    src = os.path.join(scene, "images_4")
    pngs = sorted(n for n in os.listdir(src) if n.endswith(".png"))
    check(len(pngs) == 24, f"the mid scene has views {pngs}")
    scenes, means = {"png": scene}, {}
    for kind, folder in (("avif", fx.AVIF_MID),
                         ("avif_screen", fx.AVIF_MID_SCREEN),
                         ("avif_grain", fx.AVIF_MID_GRAIN),
                         ("avif_avis", fx.AVIF_MID_AVIS),
                         ("avif_colour", fx.AVIF_MID_COLOUR),
                         ("avif_libavif", fx.AVIF_MID_LIBAVIF),
                         ("avif_inter", fx.AVIF_MID_INTER),
                         ("avif_default", fx.AVIF_MID_DEFAULT),
                         ("avif_compound", fx.AVIF_MID_COMPOUND),
                         ("avif_scaled", fx.AVIF_MID_SCALED),
                         ("avif_rebuilt", fx.AVIF_MID_REBUILT)):
        sc, images, _ = _format_scene(scene, root, f"scene_{kind}", ".avif")
        committed = os.path.join(fx.FOLDER, folder)
        avifs = sorted(os.listdir(committed))
        check(avifs == [n[:-4] + ".avif" for n in pngs],
              f"the committed {folder} AVIFs {avifs} do not name the views "
              f"{pngs}")
        means[kind] = []
        for png, avif in zip(pngs, avifs):
            shutil.copyfile(os.path.join(committed, avif),
                            os.path.join(images, avif))
            a = image_io.read_avif(os.path.join(images, avif))
            b = image_io.read_png(os.path.join(src, png))
            check(a.shape == b.shape,
                  f"{avif}: {a.shape} vs the PNG's {b.shape}")
            means[kind].append(float(np.mean(np.abs(
                a.astype(np.float64) - b))) / 255.0)
        if kind == "avif_compound":
            views = []
            for n in avifs:
                with open(os.path.join(committed, n), "rb") as f:
                    views.append(compound_counts(fx.compound_info(f.read())))
            used = sum(sum(v["compound_blocks"].values()) > 0 and
                       v["skip_mode_blocks"] > 0 for v in views)
            total = {t: sum(v["compound_blocks"][t] for v in views)
                     for t in views[0]["compound_blocks"]}
            skips = sum(v["skip_mode_blocks"] for v in views)
            print(f"  {folder}: {used} of {len(views)} views with compound "
                  f"and skip-mode blocks; compound blocks by type "
                  f"{json.dumps(total)}, skip-mode blocks {skips}",
                  flush=True)
            check(sum(total.values()) > 0 and skips > 0,
                  f"{folder}: no compound or skip-mode block decoded")
        if kind == "avif_scaled":
            views = []
            for n in avifs:
                with open(os.path.join(committed, n), "rb") as f:
                    views.append(scaled_counts(fx.scaled_info(f.read())))
            used = sum(v["scaled_blocks"] > 0 for v in views)
            blocks = sum(v["scaled_blocks"] for v in views)
            superres = sum(v["superres_inter_frames"] > 0 for v in views)
            print(f"  {folder}: {used} of {len(views)} views predicted "
                  f"from a scaled reference ({blocks} blocks), {superres} "
                  f"with superres inter frames", flush=True)
            check(used > 0, f"{folder}: no block from a scaled reference")
        if kind == "avif_rebuilt":
            # each decode the SHA-256 of cv2's; each kind's views counted by
            # the decoder: a slot rebuilt and blocks predicted from it
            # (named, scaled: those blocks from a scaled reference too), and
            # reads of what the rebuilt buffer kept (leftover)
            took = dict.fromkeys(fx.REBUILT_KINDS, 0)
            for k, n in enumerate(avifs):
                a = image_io.read_avif(os.path.join(images, n))
                sha = hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                     ).hexdigest()
                check(sha == fx.REBUILT_MID_SHA256[n], f"{n}: decode SHA-256 "
                      f"{sha} is not cv2's {fx.REBUILT_MID_SHA256[n]}")
                with open(os.path.join(committed, n), "rb") as f:
                    data = f.read()
                c = rebuilt_counts(fx.rebuilt_info(data))
                kind_k = fx.REBUILT_KINDS[k % len(fx.REBUILT_KINDS)]
                took[kind_k] += int(c["slots_rebuilt"] > 0 and (
                    c["leftover_reads"] > 0 if kind_k == "leftover" else
                    c["blocks_from_rebuilt"] > 0 and (
                        kind_k == "named" or
                        scaled_counts(fx.scaled_info(data))[
                            "scaled_blocks"] > 0)))
            print(f"  {folder}: each decode cv2's (SHA-256); views that took "
                  f"each kind {json.dumps(took)}", flush=True)
            check(all(v > 0 for v in took.values()),
                  f"{folder}: a kind no view took: {took}")
        size = sum(os.path.getsize(os.path.join(committed, n))
                   for n in avifs)
        print(f"  {folder}: {len(avifs)} AVIF views, {size} bytes; mean "
              f"|AVIF - PNG| a view: min {min(means[kind]):.5f} max "
              f"{max(means[kind]):.5f}", flush=True)
        scenes[kind] = sc
    # the TIFF kinds cv2 reads that the port took last: AVIF_MID's views,
    # decoded, written here in turn as 16-bit CIELab, 4:2:0 YCbCr under
    # LZW and Predictor 2 and old-style LZW RGB (tiff_mid_file), each read
    # held to the SHA-256 of cv2's decode and shown taking its kind
    t0 = time.perf_counter()
    sc, images, _ = _format_scene(scene, root, "scene_tiff_mid_kinds", ".tif")
    committed = os.path.join(fx.FOLDER, fx.AVIF_MID)
    avifs = sorted(os.listdir(committed))
    took = dict.fromkeys(fx.TIFF_MID_KINDS, 0)
    means["tiff_mid_kinds"], size = [], 0
    for k, (png, avif) in enumerate(zip(pngs, avifs)):
        name = png[:-4] + ".tif"
        path = os.path.join(images, name)
        with open(path, "wb") as f:
            f.write(fx.tiff_mid_file(image_io.read_avif(
                os.path.join(committed, avif)), k))
        size += os.path.getsize(path)
        info = {}
        a = image_io.read_tiff(path, info)
        sha = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        check(sha == fx.TIFF_MID_SHA256[name], f"{name}: decode SHA-256 "
              f"{sha} is not cv2's {fx.TIFF_MID_SHA256[name]}")
        kind = fx.TIFF_MID_KINDS[k % len(fx.TIFF_MID_KINDS)]
        took[kind] += int(info[kind] > 0)
        b = image_io.read_png(os.path.join(src, png))
        check(a.shape == b.shape, f"{name}: {a.shape} vs the PNG's {b.shape}")
        means["tiff_mid_kinds"].append(float(np.mean(np.abs(
            a.astype(np.float64) - b))) / 255.0)
    print(f"  tiff_mid_kinds: {len(avifs)} TIFF views written on the host "
          f"from {fx.AVIF_MID} in {time.perf_counter() - t0:.1f} s, {size} "
          f"bytes, each decode cv2's (SHA-256); views that took each kind "
          f"{json.dumps(took)}; mean |TIFF - PNG| a view: min "
          f"{min(means['tiff_mid_kinds']):.5f} max "
          f"{max(means['tiff_mid_kinds']):.5f}", flush=True)
    check(all(v > 0 for v in took.values()),
          f"tiff_mid_kinds: a kind no view took: {took}")
    scenes["tiff_mid_kinds"] = sc
    # JPEG 2000's HT code-blocks: AVIF_MID's views, decoded, written on the
    # host in turn as a raw codestream of cleanup passes and as a JPH file
    # whose SigProp and MagRef passes finish plane 0 (j2k_mid_file,
    # lossless), each read held to the SHA-256 of cv2's decode, each kind
    # counted
    t0 = time.perf_counter()
    sc, images, sparse = _format_scene(scene, root, "scene_j2k_mid_ht",
                                       ".j2c")
    names = [png[:-4] + (".jph" if k % 2 else ".j2c")
             for k, png in enumerate(pngs)]
    with open(os.path.join(sparse, "images.bin"), "rb") as f:
        images_bin = f.read()
    for n in names:
        if n.endswith(".jph"):
            images_bin = images_bin.replace(n[:-4].encode() + b".j2c\x00",
                                            n.encode() + b"\x00")
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(images_bin)
    took = dict.fromkeys(fx.J2K_MID_KINDS, 0)
    means["j2k_mid_ht"], size, blocks = [], 0, {1: 0, 2: 0, 3: 0}
    t_write = 0.0
    for k, (png, avif, name) in enumerate(zip(pngs, avifs, names)):
        view = image_io.read_avif(os.path.join(committed, avif))
        stats = {}
        t1 = time.perf_counter()
        data = fx.j2k_mid_file(view, k, stats)
        t_write += time.perf_counter() - t1
        path = os.path.join(images, name)
        with open(path, "wb") as f:
            f.write(data)
        size += len(data)
        a = image_io.read_image(path)
        sha = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        check(sha == fx.J2K_MID_SHA256[name], f"{name}: decode SHA-256 "
              f"{sha} is not cv2's {fx.J2K_MID_SHA256[name]}")
        check(np.array_equal(a, view), f"{name}: not its AVIF decode")
        for n, c in stats["passes"].items():
            blocks[n] += c
        took["cleanup" if k % 2 == 0 else "refined"] += int(
            stats["passes"][1 if k % 2 == 0 else 3] > 0)
        b = image_io.read_png(os.path.join(src, png))
        means["j2k_mid_ht"].append(float(np.mean(np.abs(
            a.astype(np.float64) - b))) / 255.0)
    t_all = time.perf_counter() - t0
    print(f"  j2k_mid_ht: {len(names)} HT JPEG 2000 views written on the "
          f"host from {fx.AVIF_MID} in {t_write:.1f} s ({t_all:.1f} s with "
          f"the reads), {size} bytes, each decode cv2's "
          f"(SHA-256) and its AVIF decode; views that took each kind "
          f"{json.dumps(took)}; code-blocks by passes {json.dumps(blocks)}",
          flush=True)
    check(all(v > 0 for v in took.values()),
          f"j2k_mid_ht: a kind no view took: {took}")
    scenes["j2k_mid_ht"] = sc
    # (c) the legs
    runs = {}
    for kind, sc in scenes.items():
        summary, tr, launches, records, log = run_7k(rz, [
            "--scene", sc, "--preset", "mid", "--exp",
            os.path.join(root, f"mid_{kind}"), "--n_iters", str(FULL_ITERS),
            "--stop_at", str(JPEG_ITERS), "--use_sh_coeff", "0",
            "--device", DEVICE])
        check([r[0] for r in records] == list(range(JPEG_ITERS)),
              f"mid {kind} leg steps")
        want = dict.fromkeys(KERNELS, 0)
        want.update(rasterize_fwd=JPEG_ITERS + 5 * len(tr.test_split) * (
            len(summary["test_trajectory"]) + 1), rasterize_bwd=JPEG_ITERS)
        check(launches == want, f"mid {kind} leg launches {launches} != "
              f"{want}")
        rate, pairs = step_rate(records, 1, JPEG_ITERS)
        runs[kind] = (summary, launches, log, rate, [r[2] for r in records])
        print(f"  mid {kind.upper()} leg: {rate:.2f} it/s at {pairs:.0f} "
              f"pairs a view; {' | '.join(_trainer_lines(log))}", flush=True)
        del tr
        torch.cuda.empty_cache()
    png = l1_by_iteration(runs["png"][2])
    ps = runs["png"][0]
    for kind in ("avif", "avif_screen", "avif_grain", "avif_avis",
                 "avif_colour", "avif_libavif", "avif_inter", "avif_default",
                 "avif_compound", "avif_scaled", "avif_rebuilt",
                 "tiff_mid_kinds", "j2k_mid_ht"):
        l1 = l1_by_iteration(runs[kind][2])
        check(len(l1) >= JPEG_ITERS // 50 and
              all(np.isfinite(list(l1.values()))),
              f"{kind} leg: a logged l1 is not finite")
        both = set(l1) & set(png)
        check(bool(both), f"the {kind} and PNG legs logged no l1 at one "
              f"iteration")
        last = max(both)
        bound = max(means[kind]) + JPEG_L1_DRIFT * png[last]
        avs = runs[kind][0]
        fmt = "TIFF" if kind.startswith("tiff") else \
            "JPEG 2000" if kind.startswith("j2k") else "AVIF"
        print(f"  {kind.upper()} leg, iteration {last}: l1 {l1[last]:.4f} "
              f"from {fmt}, {png[last]:.4f} from PNG, |difference| "
              f"{abs(l1[last] - png[last]):.4f} <= bound {bound:.4f}; final "
              f"PSNR {avs['final_psnr']} SSIM {avs['final_ssim']} (PNG "
              f"{ps['final_psnr']} {ps['final_ssim']}); it/s {fmt} "
              f"{runs[kind][3]:.2f} PNG {runs['png'][3]:.2f}; launches "
              f"{json.dumps(runs[kind][1])}", flush=True)
        check(abs(l1[last] - png[last]) <= bound,
              f"{kind} leg l1 {l1[last]} vs PNG {png[last]}: beyond {bound}")
    # lossless: the HT JPEG 2000 leg is the cv2 AVIF leg, bit for bit
    js, jl, jlog, _, jp = runs["j2k_mid_ht"]
    as_, al, alog, _, ap = runs["avif"]
    jlines, alines = _trainer_lines(jlog), _trainer_lines(alog)
    check(bool(alines) and any(x.startswith("TEST") for x in alines),
          "the AVIF leg logged no TEST line")
    check(jlines == alines, f"j2k_mid_ht leg lines {jlines} != AVIF "
          f"{alines}")
    check(jp == ap, "the j2k_mid_ht leg's pairs a step differ from the "
          "AVIF leg's")
    check((js["final_psnr"], js["final_ssim"]) == (as_["final_psnr"],
                                                   as_["final_ssim"]),
          f"j2k_mid_ht final PSNR/SSIM {js['final_psnr']} "
          f"{js['final_ssim']} vs AVIF {as_['final_psnr']} "
          f"{as_['final_ssim']}")
    check(jl == al, f"j2k_mid_ht launches {jl} vs AVIF {al}")
    print(f"  the J2K_MID_HT leg equals the AVIF leg: {len(jlines)} logged "
          f"lines, {len(jp)} steps' pair counts, final PSNR "
          f"{js['final_psnr']} SSIM {js['final_ssim']}", flush=True)
    print(f"  the AVIF phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return runs["png"][1], runs["avif"][1], runs["avif_screen"][1], \
        runs["avif_grain"][1], runs["avif_avis"][1], \
        runs["avif_colour"][1], runs["avif_libavif"][1], \
        runs["avif_inter"][1], runs["avif_default"][1], \
        runs["avif_compound"][1], runs["avif_scaled"][1], \
        runs["avif_rebuilt"][1], runs["tiff_mid_kinds"][1], \
        runs["j2k_mid_ht"][1]


def compound_counts(t) -> dict:
    """torch_make_image_fixtures.compound_info's counts of an AVIF item,
    named: compound blocks by type, skip-mode blocks, single-reference
    blocks beside a compound neighbour."""
    return dict(compound_blocks=dict(zip(
        ("average", "distance", "wedge", "diffwtd"), t[:4])),
        skip_mode_blocks=t[4], single_beside_compound=t[5])


def rebuilt_counts(t) -> dict:
    """torch_make_image_fixtures.rebuilt_info's counts of an AVIF item,
    named."""
    return dict(zip(("slots_rebuilt", "frames_naming_rebuilt",
                     "blocks_from_rebuilt", "leftover_reads", "frames"), t))


def scaled_counts(t) -> dict:
    """torch_make_image_fixtures.scaled_info's counts of an AVIF item,
    named."""
    return dict(zip(("scaled_blocks", "superres_inter_frames",
                     "switch_frames", "unwarped_blocks",
                     "superres_reference_frames", "scaled_compound_blocks",
                     "scaled_obmc_blocks", "frames"), t))


def finite(x):
    """Every number in a JSON value is finite."""
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(finite(v) for v in x)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return bool(np.isfinite(x))
    return True


def bench_path():
    """The port's bench as users run it: ``python -m gsplat_tpu_torch.bench``
    once for each of BENCH_RUNS, on the card.  Each prints exactly one JSON
    line without an ``error`` key, ends at its last phase, with every number
    finite, the RGB preset above PRESET_PSNR from the f32 image and the
    burst's PSNR above the untouched table's; each kernel of its path
    launched → {label: (the JSON line, seconds)}."""
    rows = {}
    for label, argv, last in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gsplat_tpu_torch.bench", "--device",
             DEVICE, *argv],
            capture_output=True, text=True, timeout=900)
        sec = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        for ln in proc.stderr.splitlines():
            if ln.startswith("#"):
                print(f"  bench {label} {ln}", flush=True)
        print(f"  bench {label} ({' '.join(argv)}), {sec:.1f} s: "
              f"{lines[-1] if lines else '(no line)'}", flush=True)
        if proc.returncode or len(lines) != 1:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        check(proc.returncode == 0, f"bench {label}: rc {proc.returncode}")
        check(len(lines) == 1, f"bench {label}: {len(lines)} stdout lines")
        out = json.loads(lines[0])
        check("error" not in out, f"bench {label}: {out.get('error')}")
        check(out["phase_done"] == last,
              f"bench {label}: phase_done {out['phase_done']} != {last}")
        check(finite(out), f"bench {label}: a number is not finite")
        sh = out["color"] == "sh27"
        if not sh and last != "train":
            check(out["preset_vs_f32_psnr"] > PRESET_PSNR,
                  f"bench {label}: preset {out['preset_vs_f32_psnr']} dB")
        if last == "psnr_burst":
            check(out["psnr_after_burst"] > out["psnr_before_burst"],
                  f"bench {label}: the burst's PSNR did not rise")
        want = ["rasterize_fwd_sh" if sh else "rasterize_fwd"]
        if not sh:
            want.append("rasterize_fwd_preset")
        if last == "psnr_burst":
            want.append("rasterize_bwd_sh" if sh else "rasterize_bwd")
        check(all(out["launches"].get(k, 0) > 0 for k in want),
              f"bench {label}: launches {out['launches']}, want {want}")
        rows[label] = (out, sec)
    return rows


def bench_2m4_view0(rz, dev):
    """View 0 of the bench table at 2.4M gaussians, RGB then SH, each table
    freed before the next: its visible gaussians and pairs equal to JAX's;
    on the RGB table rasterize_fwd, rasterize_bwd and rasterize_fwd_preset
    (on the preset's bf16 pairs), on the SH table rasterize_fwd_sh (the
    bench's 2.4M SH run only renders), each against its plain version there
    (at_scale_kernels: per-pixel and per-pair bounds, pairs a tile, times
    against plain and bound) → their rows."""
    import torch

    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.splatter import make_specs, render_padded
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table

    cams = synthetic_cameras(N_CAMS, WIDTH, HEIGHT, FOCAL, with_images=False,
                             device=dev)
    grid = cams["grid"]
    view = (cams["w2c_rot"][0], cams["w2c_tran"][0], cams["sh_vecs"][0])
    rows = {}
    for use_sh in (False, True):
        label = f"2.4M {'SH' if use_sh else 'RGB'} view 0"
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        table = synthetic_table(N_2M4, focal=FOCAL, scale_px=2.5,
                                use_sh=use_sh, frustum=(0.85, 0.55),
                                device=dev)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        cfg = SplatConfig(use_sh_coeff=use_sh)
        bspec, rspec = make_specs(grid, cfg)
        params, live = table.params(), table.live
        with torch.no_grad():
            _, aux = render_padded(params, live, view[0], view[1], grid, cfg,
                                   bspec, rspec, view[2])
        counts = (int(aux["n_visible"]), int(aux["n_pairs"]))
        print(f"  {label}: {N_2M4} gaussians (capacity {table.capacity}), "
              f"the table built on the host in {built:.2f} s; n_visible "
              f"{counts[0]} n_pairs {counts[1]} n_clipped "
              f"{int(aux['n_clipped'])} (JAX on the CPU: n_visible "
              f"{JAX_2M4[0]} n_pairs {JAX_2M4[1]}; on the TPU n_visible "
              f"{TPU_2M4_VISIBLE}, runs/r5b_render_2m4.log)", flush=True)
        check(counts == JAX_2M4, f"{label}: {counts} != JAX's {JAX_2M4}")
        rows.update(at_scale_kernels(rz, label, params, live, view, grid,
                                     cfg, seed=8, backward=not use_sh,
                                     preset=not use_sh))
        print(f"  {label}: peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        del table, params, live, aux
        torch.cuda.empty_cache()
    return rows


def profile_step(label, fn):
    """``profile_trace.trace_and_attribute`` on ``fn`` (3 calls after a
    warm-up): the device time by category, the host gaps between launches,
    the top ops, and the categories plus the gaps checked against the
    traced window → the attribution."""
    from gsplat_tpu_torch.scripts import profile_trace as pt

    res = pt.trace_and_attribute(fn, device=DEVICE)
    pt.report(res, label, top_ops=15, log=lambda m: print("  " + m))
    total = sum(res["categories"].values()) + res["gaps_ms"]
    check(abs(total - res["window_ms"]) <= 1e-6 * res["window_ms"],
          f"{label}: categories and gaps {total} != window "
          f"{res['window_ms']}")
    check(any(k.startswith("kernel ") for k in res["categories"]),
          f"{label}: no hand kernel in the trace")
    print("  profile " + json.dumps({
        "label": label, "reps": res["reps"],
        "untraced_ms": res["untraced_ms"], "window_ms": res["window_ms"],
        "gaps_ms": res["gaps_ms"], "categories": res["categories"]}),
        flush=True)
    return res


def bits(x):
    """The bits of a tensor, NaN included: the dead slots that
    densification leaves (zero quaternions, as in JAX) carry NaN parameters
    after a step."""
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_state(s0, s1):
    """Two TrainStates equal bit for bit."""
    import torch

    return all(torch.equal(bits(getattr(s0, f)), bits(getattr(s1, f)))
               for f in ("live", "accum_grad", "grad_counter")) \
        and torch.equal(s0.opt.t, s1.opt.t) and all(
            torch.equal(bits(d0[k]), bits(d1[k])) for d0, d1 in (
                (s0.params, s1.params), (s0.opt.mu, s1.opt.mu),
                (s0.opt.nu, s1.opt.nu)) for k in d0)


def test_helpers():
    """tests/torch_helpers.py (no JAX there): the fake viser server that
    drives run_viewer without viser or a browser."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_helpers

    return torch_helpers


def viewer_camera(pose):
    """A fake client's pose → (w2c, W, H, focal_x, focal_y) as run_viewer
    computes them at the Resolution slider's default."""
    from gsplat_tpu_torch.viewer import camera_to_w2c, snap_resolution

    w, h, fov = snap_resolution(VIEWER_RES, VIEWER_ASPECT, VIEWER_FOV)
    return camera_to_w2c(*pose), w, h, w / 2 / np.tan(fov / 2), \
        h / 2 / np.tan(fov / 2)


def viewer_run(rz, splat, poses, values=None, trainer=None, loops=None):
    """run_viewer with a fake server whose client drags its camera through
    ``poses`` (one frame each), the launch counts reset just before →
    (server, launches, wall s)."""
    import torch

    from gsplat_tpu_torch.viewer import run_viewer

    th = test_helpers()
    srv = th.FakeServer(values={"Resolution": VIEWER_RES, **(values or {})},
                        poses=poses, camera=th.FakeCamera(
                            aspect=VIEWER_ASPECT, fov=VIEWER_FOV))
    torch.cuda.synchronize()
    reset_launches(rz)
    t0 = time.perf_counter()
    run_viewer(splat, server=srv, trainer=trainer,
               max_iters=loops or len(poses))
    torch.cuda.synchronize()
    return srv, dict(rz.LAUNCHES), time.perf_counter() - t0


def offscreen_of(splat, srv, pose, fast, device_out=False):
    """render_offscreen of a pose with the server's slider values."""
    from gsplat_tpu_torch.viewer import render_offscreen

    c = srv.controls
    return render_offscreen(splat, *viewer_camera(pose),
                            near=float(c["Near"].value),
                            far=float(c["Far"].value),
                            sh_order=int(c["SH Order"].value), fast=fast,
                            device_out=device_out)


def viewer_path(rz, splat, label, fast):
    """run_viewer over the 8 eval poses on one route: every pushed frame is
    render_offscreen's of its request's pose bit for bit, in order; then
    the frame time with the double buffer (run_viewer) and without it (a
    blocking render_offscreen and push a frame), in turns, and a frame's
    stages alone → (launches of the checked run, {"double buffer": ms a
    frame, "blocking": ...})."""
    import torch

    from gsplat_tpu_torch.viewer import _to_host

    th = test_helpers()
    sc = splat.cameras
    poses = [th.c2w_pose(w2c) for w2c in offscreen_poses(
        {"w2c_rot": sc.w2c_rot, "w2c_tran": sc.w2c_tran}, EVAL_IDS)]
    values = {"Fast Mode (bf16)": fast}
    viewer_run(rz, splat, poses[:2], values)              # warm-up
    srv, launches, wall = viewer_run(rz, splat, poses, values)
    name = "rasterize_fwd_preset" if fast else "rasterize_fwd"
    want = dict.fromkeys(KERNELS, 0)
    want[name] = len(poses)
    check(launches == want, f"{label} launches {launches} != {want}")
    frames = srv.client.images
    check(len(frames) == len(poses), f"{label}: {len(frames)} frames pushed")
    _, w, h, _, _ = viewer_camera(poses[0])
    for k, (pose, img) in enumerate(zip(poses, frames)):
        check(img.shape == (h, w, 3) and img.dtype == np.float32,
              f"{label}: frame {k} {img.shape} {img.dtype}")
        check(np.array_equal(img, offscreen_of(splat, srv, pose, fast)),
              f"{label}: pushed frame {k} is not request {k}'s render")
    check(all(np.abs(a - b).max() > 1e-3 for a, b in zip(frames, frames[1:])),
          f"{label}: consecutive poses gave the same frame")
    check_frames(frames, (h, w, 3))
    fps = srv.controls["FPS"].value
    client = th.FakeClient()

    def blocking():
        t0 = time.perf_counter()
        for pose in poses:
            img = offscreen_of(splat, srv, pose, fast)
            client.set_background_image(img.astype(np.float32))
        return time.perf_counter() - t0

    def stages():
        """A frame's stages one after another, each waited for: the render
        (device_out), the pinned copy to the host, the push."""
        t = dict.fromkeys(("render", "copy", "push"), 0.0)
        for pose in poses:
            t0 = time.perf_counter()
            img = offscreen_of(splat, srv, pose, fast, device_out=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            host, _ = _to_host(img)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            client.set_background_image(host.numpy().astype(np.float32))
            t3 = time.perf_counter()
            for k, a, b in (("render", t0, t1), ("copy", t1, t2),
                            ("push", t2, t3)):
                t[k] += 1e3 * (b - a) / len(poses)
        return t

    walls = {"double buffer": [wall], "blocking": []}
    for route in ("blocking", "blocking", "double buffer"):
        walls[route].append(blocking() if route == "blocking" else
                            viewer_run(rz, splat, poses, values)[2])
    ms = {r: [1e3 * x / len(poses) for x in v] for r, v in walls.items()}
    split = [stages() for _ in range(2)]
    print(f"  {label}: {len(poses)} frames at {w}x{h}, each bit-identical "
          f"to render_offscreen of its pose; FPS readout {fps}; ms a frame "
          f"(host clock, a fake push without viser's JPEG encode or "
          f"websocket): double buffer "
          f"{'/'.join(f'{x:.3f}' for x in ms['double buffer'])}, blocking "
          f"{'/'.join(f'{x:.3f}' for x in ms['blocking'])}; stages alone "
          + ", ".join(f"{k} {'/'.join(f'{s[k]:.3f}' for s in split)}"
                      for k in split[0]), flush=True)
    return launches, {r: float(np.mean(v)) for r, v in ms.items()}


def viewer_culling(rz, splat):
    """Near and Far sliders that cull everything push a black frame; the
    default ones do not."""
    th = test_helpers()
    pose = th.c2w_pose(offscreen_poses(
        {"w2c_rot": splat.cameras.w2c_rot,
         "w2c_tran": splat.cameras.w2c_tran}, (0,))[0])
    for values in ({"Far": 1e-3}, {"Near": 1e6}, {}):
        srv, _, _ = viewer_run(rz, splat, [pose], values)
        img = srv.client.images[0]
        black = not img.any()
        check(black == bool(values), f"viewer {values or 'defaults'}: "
              f"frame max {img.max():.3g}")
        print(f"  viewer sliders {values or 'default'}: frame max "
              f"{img.max():.4f}", flush=True)


def viewer_sh_path(rz, splat):
    """The SH Order slider on the SH scene (rasterize_fwd_sh, Fast Mode
    keeps SH on f32): order 1 against the default 3 → launches."""
    th = test_helpers()
    pose = th.c2w_pose(offscreen_poses(
        {"w2c_rot": splat.cameras.w2c_rot,
         "w2c_tran": splat.cameras.w2c_tran}, (1,))[0])
    srv3, l3, _ = viewer_run(rz, splat, [pose])
    srv1, l1, _ = viewer_run(rz, splat, [pose], {"SH Order": 1})
    want = dict.fromkeys(KERNELS, 0)
    want["rasterize_fwd_sh"] = 1
    check(l3 == l1 == want, f"viewer SH launches {l3} {l1} != {want}")
    f3, f1 = srv3.client.images[0], srv1.client.images[0]
    check(np.array_equal(f3, offscreen_of(splat, srv3, pose, True)),
          "viewer SH frame is not render_offscreen's")
    band = float(np.abs(f3 - f1).max())
    print(f"  viewer SH Order 1 vs 3: max abs {band:.3e}", flush=True)
    check(band > 1e-3, "the SH Order slider changed nothing")
    return {k: l3[k] + l1[k] for k in l3}


def viewer_training_path(rz, splat):
    """run_viewer with a Trainer over a copy of the RGB scene: LIVE_LOOPS
    loop iterations at the default period → launches."""
    import torch

    from gsplat_tpu_torch.config import SplatConfig, TrainConfig
    from gsplat_tpu_torch.models.splatter import Splatter
    from gsplat_tpu_torch.train import Trainer

    th = test_helpers()
    live = Splatter.from_scene(SplatConfig(), splat.table,
                               splat.camera_groups)
    tr = Trainer(live, TrainConfig())
    step, losses = tr.train_step, []

    def recorded(i):
        m = step(i)
        losses.append(m["loss"])
        return m

    tr.train_step = recorded
    pose = th.c2w_pose(offscreen_poses(
        {"w2c_rot": splat.cameras.w2c_rot,
         "w2c_tran": splat.cameras.w2c_tran}, (0,))[0])
    srv, launches, wall = viewer_run(rz, live, [pose], trainer=tr,
                                     loops=LIVE_LOOPS)
    losses = [float(x) for x in losses]
    n = LIVE_LOOPS * LIVE_PERIOD
    print(f"  {n} steps and {len(srv.client.images)} frames in {wall:.3f} s"
          f" wall; loss {losses[0]:.5f} -> {losses[-1]:.5f}; kernel "
          f"launches {json.dumps(launches)}", flush=True)
    check(tr._gui_iter == n and len(losses) == n,
          f"live training: _gui_iter {tr._gui_iter}, {len(losses)} steps")
    check(all(np.isfinite(losses)), "live training: a loss is not finite")
    check(len(srv.client.images) == LIVE_LOOPS, "live training frames")
    check(torch.equal(live.table.pos, tr.state.params["pos"]),
          "the viewer's table is not the trained one")
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=n, rasterize_bwd=n,
                rasterize_fwd_preset=LIVE_LOOPS)
    check(launches == want, f"live training launches {launches} != {want}")
    return launches


def state_leaves(st):
    return [st.live, st.accum_grad, st.grad_counter, st.opt.t] + [
        d[k] for d in (st.params, st.opt.mu, st.opt.nu) for k in sorted(d)]


def dp_rank(rank, world, store, gt, out):
    """A rank of the data-parallel phase, on the one card with gloo: the
    bench scene (its ground truth ``gt`` for DP_CAMS from the parent), one
    checked make_dp_train_step on camera DP_CAMS[rank], then the step and
    the all-reduce timed; its result (or its exception) goes to ``out``."""
    import hashlib

    import torch
    import torch.distributed as dist

    from gsplat_tpu_torch.config import SplatConfig, TrainConfig
    from gsplat_tpu_torch.models.splatter import SceneCameras, Splatter
    from gsplat_tpu_torch.ops import rasterize as rz
    from gsplat_tpu_torch.parallel.data_parallel import make_dp_train_step
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table
    from gsplat_tpu_torch.train import COUNTERS, GROUP_ORDER, \
        init_train_state

    torch.cuda.set_device(DEVICE)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        table = synthetic_table(N_GAUSS, focal=FOCAL, scale_px=2.5,
                                frustum=(0.85, 0.55), device=DEVICE)
        cams = synthetic_cameras(N_CAMS, WIDTH, HEIGHT, FOCAL, device=DEVICE)
        for cid, img in gt.items():
            cams["images"][cid] = torch.from_numpy(img).to(DEVICE)
        splat = Splatter.from_scene(SplatConfig(), table, [SceneCameras(
            w2c_rot=cams["w2c_rot"], w2c_tran=cams["w2c_tran"],
            sh_vecs=cams["sh_vecs"], images=cams["images"],
            grid=cams["grid"], names=[str(i) for i in range(N_CAMS)])])
        step = make_dp_train_step(splat, TrainConfig(ssim_weight=0.1))
        st0 = init_train_state(table.params(), table.live)
        lrs = torch.full((5,), LR, device=DEVICE)
        cam = DP_CAMS[rank]
        torch.cuda.synchronize()
        reset_launches(rz)
        st, m = step(st0, cam, lrs)
        torch.cuda.synchronize()
        res = {"launches": dict(rz.LAUNCHES), "loss": float(m["loss"]),
               "counters": {k: int(m[k]) for k in COUNTERS}}
        digest = hashlib.sha256()
        for leaf in state_leaves(st):
            digest.update(bits(leaf).cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()
        if rank == 0:
            res["params"] = {k: st.params[k].cpu().numpy()
                             for k in GROUP_ORDER}
        del st
        ms = []
        for _ in range(DP_TIMED_STEPS + 1):      # the first is a warm-up
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st0, cam, lrs)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        # the step's all-reduce alone: the same buffer size (5 groups' grads
        # and 4 metrics; "max" accumulation sends no visibility count)
        buf = torch.zeros(sum(v.numel() for v in st0.params.values()) + 4,
                          device=DEVICE)
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(ALL_REDUCE_REPS):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        res.update(step_ms=ms[1:], buffer_floats=buf.numel(),
                   all_reduce_ms=1e3 * (time.perf_counter() - t0)
                   / ALL_REDUCE_REPS)
        out.put((rank, res))
    except BaseException as e:         # reported to the parent, re-raised
        out.put((rank, RuntimeError(f"rank {rank}: {e!r}")))
        raise
    finally:
        dist.destroy_process_group()


def dp_path(rz, splat):
    """Data-parallel training on the one card: two gloo ranks (processes)
    one make_dp_train_step on cameras DP_CAMS, both ranks' states
    bit-identical, the params against one process averaging both cameras'
    gradients, the counters the larger camera's; then an NCCL group of 1
    rank, and main's --dp with more ranks than GPUs → {path: launches}."""
    import multiprocessing as mp

    import torch
    import torch.distributed as dist

    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.parallel.data_parallel import make_dp_train_step
    from gsplat_tpu_torch.train import COUNTERS, GROUP_ORDER, apply_grads, \
        init_train_state, make_grad_fn, make_train_step
    from gsplat_tpu_torch.train import main as train_main

    gt = {c: splat.cameras.images[c].cpu().numpy() for c in DP_CAMS}
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    procs = [ctx.Process(target=dp_rank, args=(
        r, len(DP_CAMS), os.path.join(store, "gloo"), gt, out))
        for r in range(len(DP_CAMS))]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r in sorted(got):
        if isinstance(got[r], BaseException):
            raise got[r]
    check(all(p.exitcode == 0 for p in procs),
          f"rank exit codes {[p.exitcode for p in procs]}")
    r0, r1 = got[0], got[1]
    check(r0["digest"] == r1["digest"],
          "the two ranks' states differ after the step")
    check(r0["loss"] == r1["loss"] and r0["counters"] == r1["counters"],
          "the two ranks' metrics differ")
    tcfg = TrainConfig(ssim_weight=0.1)
    st0 = init_train_state(splat.table.params(), splat.table.live)
    lrs = torch.full((5,), LR, device=DEVICE)
    grad_fn = make_grad_fn(splat, tcfg)
    per_cam = [grad_fn(st0, c) for c in DP_CAMS]
    mean = {k: sum(g[k] for g, _, _ in per_cam) / len(per_cam)
            for k in GROUP_ORDER}
    ref = apply_grads(st0, mean, None, lrs, tcfg)
    rel = {k: float(np.linalg.norm(r0["params"][k]
                                   - ref.params[k].cpu().numpy())
                    / np.linalg.norm(ref.params[k].cpu().numpy()))
           for k in GROUP_ORDER}
    loss = float(np.mean([float(m["loss"]) for _, m, _ in per_cam]))
    counters = {k: max(int(aux[k]) for _, _, aux in per_cam)
                for k in COUNTERS}
    print(f"  2 gloo ranks on {DEVICE} ({wall:.1f} s with the processes' "
          f"start): states bit-identical ({r0['digest'][:12]}); loss "
          f"{r0['loss']:.7f} (one process {loss:.7f}); params rel L2 vs one "
          f"process averaging cameras {DP_CAMS}: {json.dumps(rel)}; "
          f"counters {json.dumps(r0['counters'])}", flush=True)
    check(max(rel.values()) <= 1e-5, f"data-parallel params differ: {rel}")
    check(abs(r0["loss"] / loss - 1) <= 1e-5, "data-parallel loss differs")
    check(r0["counters"] == counters,
          f"counters {r0['counters']} != the larger camera's {counters}")
    for r in (r0, r1):
        print(f"  rank step ms {' '.join(f'{x:.3f}' for x in r['step_ms'])}"
              f"; all-reduce of {r['buffer_floats']} floats "
              f"({4 * r['buffer_floats'] / 1e6:.1f} MB) "
              f"{r['all_reduce_ms']:.3f} ms", flush=True)
    paths = {"data-parallel step, 2 gloo ranks": {
        k: r0["launches"][k] + r1["launches"][k] for k in KERNELS}}

    phase("data-parallel step: an NCCL group of 1 rank vs make_train_step")
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "nccl"), world_size=1, rank=0)
    try:
        one = make_train_step(splat, tcfg)(st0, DP_CAMS[0], lrs)[0]
        torch.cuda.synchronize()
        reset_launches(rz)
        st, _ = make_dp_train_step(splat, tcfg)(st0, DP_CAMS[0], lrs)
        torch.cuda.synchronize()
        paths["data-parallel step, NCCL 1 rank"] = dict(rz.LAUNCHES)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    rel = {k: float((st.params[k] - one.params[k]).norm()
                    / one.params[k].norm()) for k in GROUP_ORDER}
    print(f"  params rel L2 {json.dumps(rel)}; bit-identical "
          f"{same_state(st, one)}", flush=True)
    check(max(rel.values()) <= 1e-5, f"NCCL step differs: {rel}")
    for path, launches in paths.items():
        want = dict.fromkeys(KERNELS, 0)
        n = len(DP_CAMS) if "gloo" in path else 1
        want.update(rasterize_fwd=n, rasterize_bwd=n)
        check(launches == want, f"{path} launches {launches} != {want}")

    n = torch.cuda.device_count() + 1
    try:
        train_main(["--data", "none", "--dp", str(n)])
        msg = None
    except SystemExit as e:
        msg = str(e)
    print(f"  main --dp {n}: {msg}", flush=True)
    check(msg is not None and f"{n - 1} visible" in msg,
          "main --dp with more ranks than GPUs did not raise naming the "
          "count")
    return paths


def bands_path(rz, splat, sh_splat):
    """Band rendering of the bench view: the ValueError at 840 px, then 2
    and 4 bands at BAND_HEIGHT against the one image at the tiny culling
    settings (RGB; SH 2 bands), the default settings' difference printed,
    and the band renders timed against the one image → launches."""
    import torch

    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.camera import TileGrid
    from gsplat_tpu_torch.models.splatter import make_specs, render_padded
    from gsplat_tpu_torch.parallel.tile_parallel import \
        make_tile_sharded_render

    try:
        make_tile_sharded_render(splat.cameras.grid, splat.cfg, 4)
        msg = None
    except ValueError as e:
        msg = str(e)
    print(f"  4 bands at {HEIGHT} px: {msg}", flush=True)
    check(msg is not None and f"height {BAND_HEIGHT}" in msg,
          "4 bands of 840 px did not raise naming 832")
    grid = TileGrid(WIDTH, BAND_HEIGHT, FOCAL, FOCAL)

    def view(sp):
        c = sp.cameras
        return (sp.table.params(), sp.table.live, c.w2c_rot[0],
                c.w2c_tran[0], c.sh_vecs[0])

    def full(sp, cfg):
        bspec, rspec = make_specs(grid, cfg)
        *args, shv = view(sp)
        return render_padded(*args, grid, cfg, bspec, rspec, shv)[0]

    tiny = SplatConfig(**TINY_CULL)
    tiny_sh = SplatConfig(use_sh_coeff=True, **TINY_CULL)
    renders = {n: make_tile_sharded_render(grid, tiny, n)
               for n in BAND_COUNTS}
    sh_render = make_tile_sharded_render(grid, tiny_sh, 2)
    with torch.no_grad():
        ref, ref_sh = full(splat, tiny), full(sh_splat, tiny_sh)
        torch.cuda.synchronize()
        reset_launches(rz)
        imgs = {n: r(*view(splat)) for n, r in renders.items()}
        img_sh = sh_render(*view(sh_splat))
        torch.cuda.synchronize()
    launches = dict(rz.LAUNCHES)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd=sum(BAND_COUNTS), rasterize_fwd_sh=2)
    check(launches == want, f"band launches {launches} != {want}")
    for label, img, r in [(f"{n} bands", imgs[n], ref) for n in imgs] + [
            ("2 SH bands", img_sh, ref_sh)]:
        d = float((img - r).abs().max())
        print(f"  {label} at {WIDTH}x{BAND_HEIGHT}, tiny culling: max abs "
              f"{d:.3e} from the one image", flush=True)
        check(img.shape == r.shape and d <= TOL,
              f"{label} differ from the one image: {d}")
    dflt = SplatConfig()
    times = {"one image": []}
    with torch.no_grad():
        one = full(splat, dflt)
        fns = {"one image": lambda: full(splat, dflt)}
        for n in BAND_COUNTS:
            r = make_tile_sharded_render(grid, dflt, n)
            d = float((r(*view(splat)) - one).abs().max())
            print(f"  {n} bands, default culling: max abs {d:.3e} from the "
                  f"one image", flush=True)
            fns[f"{n} bands"] = (lambda r=r: r(*view(splat)))
            times[f"{n} bands"] = []
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(time_fn(fns[name], 10))
    print("  render ms at default culling (CUDA events, 10 renders; bands "
          "one after another on the card): " + "; ".join(
              f"{k} {'/'.join(f'{x:.3f}' for x in v)}"
              for k, v in times.items()), flush=True)
    return launches


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
    from gsplat_tpu_torch.models.gaussians import adaptive_control
    from gsplat_tpu_torch.train import (Trainer, init_train_state,
                                        make_eval_step, make_train_step)
    from gsplat_tpu_torch.train import main as train_main
    from gsplat_tpu_torch.viewer import render_offscreen, snap_resolution

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
    # the kernels' sources, and the self-check of the forward's split
    # division (csrc/fast_div_check.cu); beside them the host libraries
    # (csrc/colmap_reader.cpp, csrc/jpeg_codec.cpp, csrc/tiff_codec.cpp,
    # csrc/webp_codec.cpp, csrc/gif_hdr_codec.cpp, csrc/jpeg2000_codec.cpp,
    # csrc/avif_codec.cpp; the system C++ compiler)
    sources = sorted({src for src, _ in rz.KERNELS.values()}
                     | {"fast_div_check"})
    host_libs = ("colmap_reader", "jpeg_codec", "tiff_codec", "webp_codec",
                 "gif_hdr_codec", "jpeg2000_codec", "avif_codec")
    with ThreadPoolExecutor(len(sources) + len(host_libs)) as pool:
        hosts = [pool.submit(cuda_build.load_host_library, name)
                 for name in host_libs]
        list(pool.map(cuda_build.load_kernel_library, sources))
        for h in hosts:
            h.result()
    for name in KERNELS:
        rz._kernel(name)
    print(f"built {len(sources) + len(host_libs)} libraries ({len(KERNELS)} "
          f"entry points, the division check, the COLMAP reader, the JPEG, "
          f"TIFF, WebP, GIF/HDR, JPEG 2000 and AVIF codecs) in "
          f"{time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in host_libs:
        info = cuda_build.BUILD_INFO[name]
        print(f"  {name}: {info['path']} (c++ {info['seconds']:.2f} s)")
    for src in sources:
        info = cuda_build.BUILD_INFO[src]
        print(f"  {src}: {info['path']} (nvcc {info['seconds']:.2f} s)")
        for line in info["log"].splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line
                print(f"    ptxas: {kernel}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"    ptxas: {line.strip()}")

    phase("split division (csrc/fast_div.cuh) vs the compiler's x / y")
    taken = differ = left = 0
    for seed in range(1, 1 + DIV_CHECK_SEEDS):
        t, d, lft = rz.fast_division_check(DIV_CHECK_N, seed, dev)
        taken, differ, left = taken + t, differ + d, left + lft
    print(f"  {taken} quotients taken by the split division, {differ} "
          f"differ from x / y in any bit; {left} left to the division",
          flush=True)
    check(differ == 0 and taken > 0 and left > 0,
          "the split division differs from x / y")

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
    c16_sh = torch.cat([c_sh, torch.zeros_like(c_sh[:, :5])], 1).to(
        torch.bfloat16)
    out_k = rz.composite_tiles_preset(g16, c16_sh, s, tiny_sh, shv_t)
    torch.cuda.synchronize()
    err = float((out_k - rz.composite_tiles_preset_torch(
        g16, c16_sh, s, tiny_sh, shv_t)).abs().max())
    print(f"  rasterize_fwd_preset_sh: max abs diff {err:.3e}", flush=True)
    check(err <= TOL, f"tiny SH preset launch disagrees: {err}")
    note_err("rasterize_fwd_preset_sh", err)

    # ---- 3. kernels against the plain versions: small scene ---------------
    phase("kernels vs plain: small scene (16x16 tiles; the forward kernels "
          "also on 12x12)")
    for tile, opaque, sh in [(t, o, h) for t in (16, 12) for o in (False, True)
                             for h in (False, True)]:
        packed, rspec_s, bspec_s, shv = small_scene(dev, opaque, sh, tile)
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
        print(f"  {fwd} {tile}x{tile} opaque={opaque}: max abs "
              f"{float(d.max()):.3e}  mean abs {float(d.mean()):.3e}  "
              f"(max pairs per tile {int(counts.max())})", flush=True)
        check(float(d.max()) <= TOL, f"small scene: {fwd} disagrees")
        check(bool((a[counts == 0] == 0).all()),
              f"small scene: {fwd} wrote nonzero empty tiles")
        note_err(fwd, d.max())
        # the backward kernels here on 16x16 tiles (the card tests take
        # 8x8 and 12x12 tiles)
        for wn in ((False, True) if tile == 16 else ()):
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
        pre = "rasterize_fwd_preset_sh" if sh else "rasterize_fwd_preset"
        pp = pack_preset(bspec_s, packed)
        a = rz.composite_tiles_preset(pp.geom, pp.color, pp.tile_start,
                                      rspec_s, shv)
        b = rz.composite_tiles_preset_torch(pp.geom, pp.color,
                                            pp.tile_start, rspec_s, shv)
        torch.cuda.synchronize()
        d = float((a - b).abs().max())
        print(f"  {pre} {tile}x{tile} opaque={opaque}: max abs {d:.3e}",
              flush=True)
        check(d <= TOL, f"small scene: {pre} disagrees")
        check(bool((a[counts == 0] == 0).all()),
              f"small scene: {pre} wrote nonzero empty tiles")
        note_err(pre, d)

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
    tile_boxes_check(params, live, cams, cfg, bspec)

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
    pair_histogram(pk0.tile_start)
    with torch.no_grad():
        fwd_repeats("rasterize_fwd", rz.composite_tiles, pk0.geom, pk0.color,
                    pk0.tile_start, rspec)
    go0 = cotangent(3, tuple(out_k.shape), dev)
    with torch.no_grad():
        err, ratio, rel = bwd_compare(rz, pk0, out_k, go0, rspec)
    print(f"  rasterize_bwd: max abs {err:.3e} ({ratio:.3f} of the per-pair "
          f"bound); rel L2 {json.dumps(rel)}", flush=True)
    check(max(rel.values()) <= FULL_REL_L2,
          f"full-size view: backward kernel disagrees ({rel})")
    note_err("rasterize_bwd", err)
    bwd_repeats(rz, "rasterize_bwd", pk0, out_k, go0, rspec)
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
    fwd_repeats("rasterize_fwd_preset", rz.composite_tiles_preset, pp0.geom,
                pp0.color, pp0.tile_start, rspec)
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
    bounds = {}
    n_ev = int(evaluations(rz, pk0.geom, pk0.tile_start, rspec).sum())
    n_ev_p = int(evaluations(rz, pp0.geom, pp0.tile_start, rspec,
                             True).sum())
    print(f"  view 0: {n_ev} pair-pixel evaluations ({n_ev_p} on the "
          f"preset's pairs) of {int(pk0.n_pairs) * rspec.px} pair-pixels",
          flush=True)
    bounds["rasterize_fwd"] = kernel_bound("rasterize_fwd", n_ev, (
        pk0.geom, pk0.color, pk0.tile_start, out_k))
    bounds["rasterize_bwd"] = kernel_bound("rasterize_bwd", n_ev, (
        pk0.geom, pk0.color, pk0.tile_start, out_k, go0, pk0.geom,
        pk0.color))
    bounds["rasterize_fwd_preset"] = kernel_bound(
        "rasterize_fwd_preset", n_ev_p, (pp0.geom, pp0.color,
                                         pp0.tile_start, out_pk))
    rgb_splat = splat     # the viewer, data-parallel and band phases
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
    with torch.no_grad():
        fwd_repeats("rasterize_fwd_sh", rz.composite_tiles, pk0.geom,
                    pk0.color, pk0.tile_start, rspec, shv0)
    go0 = cotangent(4, tuple(out_k.shape), dev)
    with torch.no_grad():
        err, ratio, rel = bwd_compare(rz, pk0, out_k, go0, rspec, shv0)
    print(f"  rasterize_bwd_sh: max abs {err:.3e} ({ratio:.3f} of the "
          f"per-pair bound); rel L2 {json.dumps(rel)}", flush=True)
    check(ratio <= 1.0, "full-size view: SH backward outside the bound")
    check(max(rel.values()) <= FULL_REL_L2,
          f"full-size view: SH backward disagrees ({rel})")
    note_err("rasterize_bwd_sh", err)
    bwd_repeats(rz, "rasterize_bwd_sh", pk0, out_k, go0, rspec, shv0)
    pp_sh = pack_preset(bspec, pk0)
    with torch.no_grad():
        out_pks = rz.composite_tiles_preset(pp_sh.geom, pp_sh.color,
                                            pp_sh.tile_start, rspec, shv0)
        out_pps = rz.composite_tiles_preset_torch(
            pp_sh.geom, pp_sh.color, pp_sh.tile_start, rspec, shv0)
    torch.cuda.synchronize()
    d = float((out_pks - out_pps).abs().max())
    print(f"  rasterize_fwd_preset_sh: max abs {d:.3e}", flush=True)
    check(d <= TOL, "full-size view: SH preset kernel disagrees")
    note_err("rasterize_fwd_preset_sh", d)
    fwd_repeats("rasterize_fwd_preset_sh", rz.composite_tiles_preset,
                pp_sh.geom, pp_sh.color, pp_sh.tile_start, rspec, shv0)
    n_ev = int(evaluations(rz, pk0.geom, pk0.tile_start, rspec).sum())
    n_ev_p = int(evaluations(rz, pp_sh.geom, pp_sh.tile_start, rspec,
                             True).sum())
    bounds["rasterize_fwd_sh"] = kernel_bound("rasterize_fwd_sh", n_ev, (
        pk0.geom, pk0.color, pk0.tile_start, shv0, out_k))
    bounds["rasterize_bwd_sh"] = kernel_bound("rasterize_bwd_sh", n_ev, (
        pk0.geom, pk0.color, pk0.tile_start, shv0, out_k, go0, pk0.geom,
        pk0.color))
    bounds["rasterize_fwd_preset_sh"] = kernel_bound(
        "rasterize_fwd_preset_sh", n_ev_p, (pp_sh.geom, pp_sh.color,
                                            pp_sh.tile_start, shv0, out_pks))
    del mid0, out_p, out_pps
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

    phase("SH preset serving path: 2 eval requests through the bf16 render "
          "preset (make_eval_step(preset=True))")
    preset_step = make_eval_step(splat, preset=True)
    torch.cuda.synchronize()
    reset_launches(rz)
    pres = [preset_step(params, live, cid) for cid in SH_PRESET_IDS]
    torch.cuda.synchronize()
    sh_preset = dict(rz.LAUNCHES)
    print(f"kernel launches {json.dumps(sh_preset)}", flush=True)
    want = dict.fromkeys(KERNELS, 0)
    want.update(rasterize_fwd_preset_sh=len(pres))
    check(sh_preset == want, f"SH preset launches {sh_preset} != {want}")
    check_eval(pres, SH_PRESET_IDS)
    check(SH_EVAL_IDS[0] == SH_PRESET_IDS[0] == 0, "camera 0")
    sh_preset_psnr = float(psnr(pres[0][0], results[0][0], 1.0))
    print(f"  SH preset vs SH f32 PSNR at camera 0: {sh_preset_psnr:.2f} dB "
          f"(bound > {SH_PRESET_PSNR}, tests/test_fused_pack.py:326)",
          flush=True)
    check(sh_preset_psnr > SH_PRESET_PSNR,
          "SH preset image far from the f32 SH render")

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
    psargs = (pp_sh.geom, pp_sh.color, pp_sh.tile_start)
    alone["rasterize_fwd_preset_sh"] = (
        lambda: rz.composite_tiles_preset(*psargs, rspec, shv0),
        lambda: rz.composite_tiles_preset_torch(*psargs, rspec, shv0))
    time_alone(("rasterize_fwd_sh", "rasterize_bwd_sh",
                "rasterize_fwd_preset_sh"), int(pk0.n_pairs))
    sh_splat = splat
    del alone, splat, eval_step, preset_step, train_step, state0, results
    del pres, table, params, live, pk0, pp_sh, out_k, out_pks, go0, psargs
    del args
    torch.cuda.empty_cache()

    # ---- 10. the viewer server, data-parallel training, bands -------------
    w, h, _ = snap_resolution(VIEWER_RES, VIEWER_ASPECT, VIEWER_FOV)
    phase(f"viewer path: run_viewer (fake viser server), {len(EVAL_IDS)} "
          f"frames over the eval poses at {w}x{h}, f32 and Fast Mode")
    viewer_f32, viewer_ms = viewer_path(rz, rgb_splat, "viewer f32", False)
    viewer_fast, viewer_fast_ms = viewer_path(rz, rgb_splat,
                                              "viewer Fast Mode", True)
    viewer_culling(rz, rgb_splat)
    phase("viewer path: the SH Order slider on the SH scene")
    viewer_sh = viewer_sh_path(rz, sh_splat)
    phase(f"viewer path: live training, {LIVE_LOOPS} loop iterations at "
          f"period {LIVE_PERIOD}")
    viewer_train = viewer_training_path(rz, rgb_splat)
    phase(f"data-parallel step: 2 gloo ranks on one card, cameras "
          f"{DP_CAMS}")
    dp = dp_path(rz, rgb_splat)
    phase(f"bands: make_tile_sharded_render, {BAND_COUNTS} bands")
    bands = bands_path(rz, rgb_splat, sh_splat)
    print(f"  viewer ms a frame: f32 {json.dumps(viewer_ms)}, Fast Mode "
          f"{json.dumps(viewer_fast_ms)}", flush=True)
    del rgb_splat, sh_splat
    torch.cuda.empty_cache()

    # ---- 11. the Trainer, densification, full state, CLI ------------------
    phase(f"Trainer path: Trainer.train, iterations {TRAIN_START}-"
          f"{TRAIN_END - 1}, RGB bench scene, {TRAINER_CAMS} cameras")
    tr, trainer_launches, records, events, log = trainer_path(rz, dev)
    check_trainer(tr, trainer_launches, records, events, log)
    first = events[0]["i"]
    for label, rows in (
            (f"before the first densify ({TRAIN_START + 1}-{first - 1})",
             [r for r in records if TRAIN_START < r["i"] < first]),
            (f"after it ({first + 1}-{first + N_ADAPTIVE - 1})",
             [r for r in records if first < r["i"] < first + N_ADAPTIVE]),
            ("densify steps (the step and its event)",
             [r for r in records if r["i"] in [e["i"] for e in events]])):
        print(f"  Trainer step ms {label}: mean "
              f"{np.mean([r['ms'] for r in rows]):.3f} (min "
              f"{np.min([r['ms'] for r in rows]):.3f}, max "
              f"{np.max([r['ms'] for r in rows]):.3f}); mean n_pairs "
              f"{np.mean([r['n_pairs'] for r in rows]):.0f}; "
              f"{len(rows)} steps", flush=True)
    ev = tr.evaluate()
    print(f"  evaluate(): {json.dumps(ev)}", flush=True)
    check(np.isfinite(ev["psnr"]) and 0 < ev["ssim"] <= 1 and ev["fps"] > 0,
          "evaluate() out of range")

    phase("densify: adaptive_control on the card vs the CPU, same inputs")
    tbl = tr.splat.table
    rng = np.random.default_rng(5)
    grad = torch.from_numpy(np.abs(rng.normal(0, 3e-4, (tbl.capacity, 3)))
                            .astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(tbl.capacity, 2, 3))
                           .astype(np.float32))
    # about half the gradients pass grad_thresh; the larger half of those
    # split, the smaller clone, and the top 1% of scales are deleted
    kw = dict(taus=quantile_norm(tbl, tr.splat.cfg, 0.5),
              delete_thresh=quantile_norm(tbl, tr.splat.cfg, 0.99),
              grad_thresh=2e-4, clone_dt=0.01, use_clone=True, use_split=True)
    tg, sg = adaptive_control(tbl, grad.to(dev), eps.to(dev), **kw)
    tc, sc = adaptive_control(tbl.to("cpu"), grad, eps, **kw)
    print(f"  card {sg}\n  cpu  {sc}", flush=True)
    check(sg == sc and sc.n_split > 0 and sc.n_cloned > 0
          and sc.n_deleted > 0, "densify stats differ or miss a branch")
    check(torch.equal(tg.live.cpu(), tc.live), "densify live masks differ")
    worst = 0.0
    for k in ("pos", "rgb", "opa", "quat", "scale"):
        a, b = getattr(tg, k).cpu(), getattr(tc, k)
        err = float(((a - b).abs() / (b.abs() + b.abs().max())).max())
        worst = max(worst, err)
    print(f"  params: max |card - cpu| / (|cpu| + max|cpu|) {worst:.3e}",
          flush=True)
    check(worst <= 1e-6, "densify params differ beyond 1e-6 relative")
    del tg, tc, grad, eps

    phase("full state: save_full -> load_full on the card")
    path = os.path.join(tr.tcfg.exp, "full_state.npz")
    tr.save_full(path, TRAIN_END)
    st0 = tr.state
    tr2 = Trainer(tr.splat, tr.tcfg)
    check(tr2.load_full(path) == TRAIN_END, "load_full iteration")
    st1 = tr2.state

    check(same_state(st0, st1), "load_full did not restore the state bit "
          "for bit")
    cam = int(tr.train_split[0])
    step = tr2._train_step_for(0)
    a, ma = step(st0, cam, tr2.lrs_at(TRAIN_END))
    b, mb = step(st1, cam, tr2.lrs_at(TRAIN_END))
    check(float(ma["loss"]) == float(mb["loss"]) and same_state(a, b),
          "the next step differs after load_full")
    print(f"  {os.path.getsize(path) / 1e6:.1f} MB; state bit-identical; "
          f"next step identical (loss {float(ma['loss']):.6f})", flush=True)
    del tr, tr2, st0, st1, a, b, step, tbl
    torch.cuda.empty_cache()

    phase("CLI: gsplat_tpu_torch.train.main on a COLMAP scene with PNGs")
    root = os.path.join("chiprun_out", "chip_smoke_cli")
    write_colmap_scene(os.path.join(root, "scene"))
    exp = os.path.join(root, "exp")
    log = io.StringIO()
    reset_launches(rz)
    with contextlib.redirect_stdout(log):
        train_main(["--data", os.path.join(root, "scene"), "--n_iters", "41",
                    "--n_iters_warmup", "5", "--n_iters_test", "20",
                    "--exp", exp, "--metrics_every", "10", "--lr", "0.01",
                    "--capacity_round", "256", "--device", DEVICE])
    torch.cuda.synchronize()
    cli = dict(rz.LAUNCHES)
    print(log.getvalue(), end="")
    print(f"kernel launches {json.dumps(cli)}", flush=True)
    check("TEST @20:" in log.getvalue() and "TEST @40:" in log.getvalue(),
          "the CLI printed no TEST line")
    check(os.path.exists(os.path.join(exp, "ckpt.npz")),
          "the CLI wrote no ckpt.npz")
    check(cli["rasterize_bwd"] == 41 and cli["rasterize_fwd"] > 41,
          f"CLI launches {cli}")

    # ---- 12. the at-scale run ----------------------------------------------
    (scene_build, at_scale_rgb, at_scale_sh, at_scale_jpeg, at_scale_png,
     at_scale_tiff, at_scale_webp, at_scale_jp2, at_scale_gif, mid_png,
     mid_avif, mid_avif_screen, mid_avif_grain, mid_avif_avis,
     mid_avif_colour, mid_avif_libavif, mid_avif_inter,
     mid_avif_default, mid_avif_compound, mid_avif_scaled,
     mid_avif_rebuilt, mid_tiff_kinds, mid_j2k_ht), scale_rows = \
        at_scale_path(rz, dev)
    at_scale = {name: {} for name in KERNELS}
    for leg, rows in scale_rows.items():
        for name, row in rows.items():
            note_err(name, row["max_abs_err"])
            at_scale[name][leg] = row

    # ---- 13. the bench, the 2.4M scale, the profiler ---------------------
    torch.cuda.empty_cache()
    phase(f"bench: python -m gsplat_tpu_torch.bench, {len(BENCH_RUNS)} runs")
    t0 = time.perf_counter()
    bench = bench_path()
    print(f"  bench phase {time.perf_counter() - t0:.1f} s", flush=True)
    phase(f"bench scale {N_2M4}: view 0 against JAX, its kernels vs plain")
    t0 = time.perf_counter()
    reset_launches(rz)
    rows_2m4 = bench_2m4_view0(rz, dev)
    for name, row in rows_2m4.items():
        note_err(name, row["max_abs_err"])
    torch.cuda.empty_cache()
    print(f"  2.4M phase {time.perf_counter() - t0:.1f} s", flush=True)
    phase("profile: the bench scene's RGB train step, view 0 "
          "(torch.profiler)")
    t0 = time.perf_counter()
    from gsplat_tpu_torch.bench import build_scene
    from gsplat_tpu_torch.scripts import profile_trace
    scene = build_scene(N_GAUSS, WIDTH, HEIGHT, FOCAL, profile_trace.M_CAMS,
                        False, dev)
    _, bench_step = profile_trace.view0_fns(*scene)
    profile_step("bench scene RGB train step, view 0", bench_step)
    del scene, bench_step
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t0:.1f} s", flush=True)

    paths = {"RGB serving": serve, "RGB training": train,
             "SH serving": sh_serve, "SH training": sh_train,
             "SH preset serving": sh_preset, "viewer f32": viewer_f32,
             "viewer Fast Mode": viewer_fast, "viewer SH": viewer_sh,
             "viewer live training": viewer_train, **dp, "bands": bands,
             "Trainer": trainer_launches, "CLI": cli,
             "at-scale scene build": scene_build,
             "at-scale RGB run": at_scale_rgb, "at-scale SH run": at_scale_sh,
             "at-scale JPEG run": at_scale_jpeg,
             "at-scale PNG 0-200 run": at_scale_png,
             "at-scale TIFF run": at_scale_tiff,
             "at-scale WebP run": at_scale_webp,
             "at-scale JPEG 2000 run": at_scale_jp2,
             "at-scale GIF run": at_scale_gif,
             "mid PNG 0-200 run": mid_png, "mid AVIF run": mid_avif,
             "mid AVIF screen run": mid_avif_screen,
             "mid AVIF grain run": mid_avif_grain,
             "mid AVIF avis run": mid_avif_avis,
             "mid AVIF colour run": mid_avif_colour,
             "mid AVIF libavif run": mid_avif_libavif,
             "mid AVIF inter run": mid_avif_inter,
             "mid AVIF default inter tools run": mid_avif_default,
             "mid AVIF compound run": mid_avif_compound,
             "mid AVIF scaled run": mid_avif_scaled,
             "mid AVIF rebuilt run": mid_avif_rebuilt,
             "mid TIFF kinds run": mid_tiff_kinds,
             "mid JPEG 2000 HT run": mid_j2k_ht,
             **{f"bench {label}": {name: out["launches"].get(name, 0)
                                   for name in KERNELS}
                for label, (out, _) in bench.items()}}
    print("launches by path: " + json.dumps(paths), flush=True)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": repl,
        "launches": sum(p[name] for p in paths.values()),
        "launches_by_path": {k: p[name] for k, p in paths.items()},
        "max_abs_err": max_err[name],
        "ms": float(np.mean(times[name]["kernel"])),
        "plain_ms": float(np.mean(times[name]["plain"])),
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        # no single PyTorch call composites tiles
        "library_ms": None,
        # the same, on the heaviest view of each at-scale leg's table
        "at_scale": at_scale[name],
        # the same, at view 0 of the bench table at 2.4M gaussians
        "bench_2m4": rows_2m4.get(name)}
        for name, (src, repl) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)              # card name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
