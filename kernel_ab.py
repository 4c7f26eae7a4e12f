#!/usr/bin/env python3
"""Same-run A/B of the forward rasterizer (csrc/rasterize_fwd.cu) against
another source of it, on one NVIDIA GPU.

Run from the repository root:

    mkdir -p _archive/other
    git show <commit>:gsplat_tpu_torch/csrc/rasterize_fwd.cu \\
        > _archive/other/rasterize_fwd.cu
    git show <commit>:gsplat_tpu_torch/csrc/sh_color.cuh \\
        > _archive/other/sh_color.cuh
    python3 kernel_ab.py --other _archive/other \\
        [--variant NAME OLD NEW ...] [--sass DIR]

It builds this tree's source, the other one and each variant (this tree's
source with the text OLD replaced by NEW) with the port's nvcc flags, one
nvcc each, in parallel, and prints ptxas's registers and shared memory.  On
view 0 of chip_smoke.py's bench scene (RGB, then SH) it launches every
forward entry point of each build through ctypes on the same pairs, checks
that two launches give the same bits, compares each output with the other
source's bit for bit and with the plain version, and times the builds in
turns (each 50 launches, CUDA events; the order of the builds, then the
reverse).  The last line is a JSON object of the results.  With --sass,
cuobjdump's SASS of this tree's build is written to DIR.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs

ENTRY_POINTS = ("rasterize_fwd", "rasterize_fwd_preset", "rasterize_fwd_sh",
                "rasterize_fwd_preset_sh")
BUILD_DIR = os.path.join("gsplat_tpu_torch", "_build", "kernel_ab")


def build(name, src_dir, subs, sass_dir):
    """Compile ``src_dir``/rasterize_fwd.cu with the substitutions ``subs``
    → (name, library path, nvcc's log)."""
    from gsplat_tpu_torch.ops import cuda_build

    d = os.path.join(BUILD_DIR, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, f), d)
    text = open(os.path.join(src_dir, "rasterize_fwd.cu")).read()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    src = os.path.join(d, "rasterize_fwd.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, "librasterize_fwd.so")
    nvcc = cuda_build.find_nvcc()
    p = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{p.stdout}{p.stderr}")
    if sass_dir and name == "this":
        dump = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
            capture_output=True, text=True, check=True).stdout
        with open(os.path.join(sass_dir, "rasterize_fwd.sass"), "w") as f:
            f.write(dump)
    return name, lib, p.stdout + p.stderr


def launch(lib, name, spec, geom, color, tile_start, shv, out):
    import torch

    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(geom.data_ptr(), color.data_ptr(), tile_start.data_ptr(),
            None if shv is None else shv.data_ptr(), out.data_ptr(),
            spec.n_tiles, spec.n_tile_x, spec.tile_h, spec.tile_w,
            spec.padded_w, spec.padded_h, spec.focal_x, spec.focal_y,
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"{name}: CUDA error {rc}")


def view0(sh):
    """View 0 of the bench scene → (rspec, packed f32 pairs, preset pairs,
    sh_vecs or None)."""
    import torch

    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.splatter import make_specs
    from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table

    kw = dict(use_sh=True, sh_ampl=cs.SH_AMPL) if sh else {}
    table = synthetic_table(cs.N_GAUSS, focal=cs.FOCAL, scale_px=2.5,
                            frustum=(0.85, 0.55), device=cs.DEVICE, **kw)
    cams = synthetic_cameras(cs.N_CAMS, cs.WIDTH, cs.HEIGHT, cs.FOCAL,
                             device=cs.DEVICE)
    cfg = SplatConfig(use_sh_coeff=sh)
    bspec, rspec = make_specs(cams["grid"], cfg)
    shv = cams["sh_vecs"][0].contiguous() if sh else None

    def no_composite(geom, color, tile_start, spec, shv=None):
        return torch.zeros((spec.n_tiles, 4, spec.px), device=geom.device)

    with torch.no_grad():
        _, mid = cs.staged_frame(table.params(), table.live,
                                 cams["w2c_rot"][0], cams["w2c_tran"][0],
                                 cams["grid"], cfg, bspec, rspec,
                                 no_composite, shv=shv, preset=True)
    return rspec, mid["packed"], mid["pairs"], shv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="directory holding the other rasterize_fwd.cu and "
                         "its headers")
    ap.add_argument("--variant", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--sass", help="write this build's SASS here")
    args = ap.parse_args(argv)

    import torch

    from gsplat_tpu_torch.ops import rasterize as rz

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
    here = os.path.join("gsplat_tpu_torch", "csrc")
    jobs = [("other", args.other, []), ("this", here, [])] + \
        [(n, here, [(old, new)]) for n, old, new in args.variant]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j, args.sass), jobs))
    libs = {}
    for name, lib, log in built:
        libs[name] = ctypes.CDLL(lib)
        print(f"built {name}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    names = list(libs)
    torch.cuda.set_device(cs.DEVICE)
    res = {}
    for sh in (False, True):
        rspec, pk, pp, shv = view0(sh)
        counts = torch.diff(pk.tile_start).cpu().numpy()
        print(f"view 0, {'SH' if sh else 'RGB'}: {int(pk.n_pairs)} pairs, "
              f"{counts.size} tiles; pairs a tile max {counts.max()} p99 "
              f"{np.percentile(counts, 99):.0f} mean {counts.mean():.1f}",
              flush=True)
        for name in ENTRY_POINTS[2 * sh:2 * sh + 2]:
            pairs = pp if "preset" in name else pk
            args3 = (pairs.geom, pairs.color, pairs.tile_start)
            outs = {}
            for v in names:
                a, b = (torch.full((rspec.n_tiles, 4, rspec.px), float("nan"),
                                   device=cs.DEVICE) for _ in range(2))
                launch(libs[v], name, rspec, *args3, shv, a)
                launch(libs[v], name, rspec, *args3, shv, b)
                torch.cuda.synchronize()
                cs.check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                         f"{v} {name}: two launches differ")
                outs[v] = a
            plain = (rz.composite_tiles_preset_torch if "preset" in name
                     else rz.composite_tiles_torch)
            ref = plain(*args3, rspec, shv)
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                ms[v].append(cs.time_fn(lambda: launch(
                    libs[v], name, rspec, *args3, shv, outs[v]), 50))
            for v in names:
                same = torch.equal(outs[v].view(torch.int32),
                                   outs["other"].view(torch.int32))
                n_diff = int((outs[v] != outs["other"]).sum())
                err = float((outs[v] - ref).abs().max())
                print(f"  {name:24s} {v:12s} ms {ms[v][0]:.4f}/{ms[v][1]:.4f}"
                      f"  bits == other: {same} ({n_diff} differ)  max abs "
                      f"vs plain {err:.3e}", flush=True)
                res.setdefault(name, {})[v] = {
                    "ms": ms[v], "bits_equal_other": same, "n_diff": n_diff,
                    "max_abs_vs_plain": err}
        del pk, pp
        torch.cuda.empty_cache()
    print(json.dumps({"kernel_ab": res, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
