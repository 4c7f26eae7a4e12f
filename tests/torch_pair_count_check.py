"""Per-gaussian tile counts at view 0 of the bench scene: the JAX package
against the port, both on the CPU, or the port on the card against itself on
the CPU.

The bench scene (``bench.py:84,110-112``: 506,627 gaussians,
``scale_px=2.5``, ``frustum=(0.85, 0.55)``, 48 cameras at 1297x840, focal
1000, K = 6) is projected through each package's ``project_gaussians`` and
binned through its ``_tile_bbox_rows``; the script prints each package's
visible count and pair count (Σ min(cover, K)), and every gaussian whose
cover or visibility differs, with the projected values that decide it.  On
the H100 the port counts 1,002,681 pairs there and the TPU 1,002,683
(``BENCH_r05.json``).  With ``--device cuda`` (no jax needed: the card's
machine has none) it holds the port on the card against the port on the
CPU instead.  ``--n_gauss`` sets the table's size (the reference's
quality-config scale is 2,400,000: JAX's ``tune_budgets`` counted 2,013,472
visible and 4,763,470 pairs there, ``runs/r5b_render_2m4.log``).  Not a
pytest test (~15 s, ~3 GB at 506,627; ~15 GB at 2.4M):

    python tests/torch_pair_count_check.py [--device cuda] [--n_gauss N]
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import argparse  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch import synthetic as tsyn  # noqa: E402
from gsplat_tpu_torch.config import SplatConfig  # noqa: E402
from gsplat_tpu_torch.models.splatter import make_specs  # noqa: E402
from gsplat_tpu_torch.ops import binning as tbin  # noqa: E402
from gsplat_tpu_torch.ops.projection import project_gaussians  # noqa: E402

N, W, H, FOCAL, CAMS = 506_627, 1297, 840, 1000.0, 48


def jax_cover(kw, n=N):
    """(visible, cover, mean2d, cov2d) of view 0 through the JAX package on
    the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gsplat_tpu import synthetic as jsyn
    from gsplat_tpu.config import SplatConfig as JCfg
    from gsplat_tpu.models.splatter import make_specs as j_make_specs
    from gsplat_tpu.ops import binning as jbin
    from gsplat_tpu.ops.projection import project_gaussians as j_project

    jt = jsyn.synthetic_table(n, focal=FOCAL, scale_px=2.5,
                              frustum=(0.85, 0.55))
    jc = jsyn.synthetic_cameras(CAMS, W, H, FOCAL, with_images=False)
    jbspec, _ = j_make_specs(jc["grid"], jt.capacity, JCfg(), 3)
    jp = j_project(jt.pos, jt.quat, jt.scale, jnp.asarray(jc["w2c_rot"][0]),
                   jnp.asarray(jc["w2c_tran"][0]), **kw)
    vis = np.asarray(jp.visible & jt.live)
    m, cv = np.asarray(jp.mean2d), np.asarray(jp.cov2d)
    _, _, rw, rh = jbin._tile_bbox_rows(
        jbspec, jnp.asarray(m[:, 0]), jnp.asarray(m[:, 1]),
        *(jnp.asarray(cv[:, i]) for i in range(4)), jnp.asarray(vis))
    return vis, np.asarray(rw, np.int64) * np.asarray(rh, np.int64), m, cv


def port_cover(kw, device, n=N):
    """(visible, cover, mean2d, cov2d) of view 0 through the port on
    ``device``."""
    tt = tsyn.synthetic_table(n, focal=FOCAL, scale_px=2.5,
                              frustum=(0.85, 0.55), device=device)
    tc = tsyn.synthetic_cameras(CAMS, W, H, FOCAL, with_images=False,
                                device=device)
    bspec, _ = make_specs(tc["grid"], SplatConfig())
    with torch.no_grad():
        tp = project_gaussians(tt.pos, tt.quat, tt.scale, tc["w2c_rot"][0],
                               tc["w2c_tran"][0], **kw)
        vis = tp.visible & tt.live
        _, _, rw, rh = tbin._tile_bbox_rows(
            bspec, tp.mean2d[:, 0], tp.mean2d[:, 1], *tp.cov2d.unbind(1),
            vis)
    return tuple(x.cpu().numpy() for x in (vis, rw * rh, tp.mean2d,
                                           tp.cov2d))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu",
                    help="cpu: JAX vs the port; cuda: the port on the card "
                         "vs the port on the CPU")
    ap.add_argument("--n_gauss", type=int, default=N)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    cfg = SplatConfig()
    K = cfg.max_tiles_per_gaussian
    kw = dict(near=cfg.near, half_width=W * 1.2 / 2 / FOCAL,
              half_height=H * 1.2 / 2 / FOCAL,
              scale_activation=cfg.scale_activation)
    ref_name = "jax (CPU)" if a.device == "cpu" else "port (CPU)"
    ref = jax_cover(kw, a.n_gauss) if a.device == "cpu" \
        else port_cover(kw, "cpu", a.n_gauss)
    out = port_cover(kw, a.device, a.n_gauss)
    name = f"port ({a.device})"
    print(f"{a.n_gauss:,} gaussians, view 0")
    for n, (vis, cover, _, _) in ((ref_name, ref), (name, out)):
        print(f"{n:11s}: n_visible {int(vis.sum()):,}  pairs "
              f"{int(np.minimum(cover, K).sum()):,}  (K = {K})")
    (rvis, rcov, rm, rcv), (vis, cov, m, cv) = ref, out
    rel = np.abs(cv - rcv) / np.abs(rcv).max(1, keepdims=True)
    print(f"mean2d: max |{name} - {ref_name}| "
          f"{float(np.abs(m - rm)[rvis].max()):.3e} px, differing in "
          f"{int((m != rm)[rvis].any(1).sum()):,} visible gaussians; cov2d "
          f"in {int((cv != rcv)[rvis].any(1).sum()):,}, max rel "
          f"{float(rel[rvis].max()):.3e}")
    diff = np.nonzero((rcov != cov) | (rvis != vis))[0]
    print(f"gaussians whose visibility or cover differs: {len(diff)}")
    for g in diff:
        print(f"  #{g}: visible {bool(rvis[g])} / {bool(vis[g])}; cover "
              f"{rcov[g]} / {cov[g]}; mean2d {rm[g].tolist()} / "
              f"{m[g].tolist()}; cov2d {rcv[g].tolist()} / {cv[g].tolist()}")


if __name__ == "__main__":
    main()
