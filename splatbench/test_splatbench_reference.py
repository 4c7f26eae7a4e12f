"""The benchmark's plain reference against the program's plain route at a
tiny size on the CPU: the same pairs bit for bit, the same image and
gradients to f32 rounding, the same densify decision; and the TF32
control's rounding."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from splatbench import port, scene
from splatbench import reference as ref
from splatbench.conftest import DATA

DEV = torch.device("cpu")


def tiny(conf: str, n=6000, scale_px=None):
    """A tiny configuration of ``conf`` dense enough that tiles hold more
    than 128 pairs (several of the program's plain chunks)."""
    c = json.loads((DATA / "configs" / f"{conf}.json").read_text())
    c.update(n_gaussians=n, width=72, height=56, focal=80.0, n_cameras=16,
             capacity_round=512)
    if scale_px:
        c["scale_px"] = scale_px
    return c


CONFS = ["garden-fast-506k-sh", "garden-quality-2400k-rgb"]


def program_pairs(config, table, rot, tran):
    from gsplat_tpu_torch.models.camera import TileGrid
    from gsplat_tpu_torch.models.splatter import make_specs
    from gsplat_tpu_torch.ops.binning import pack_sorted
    from gsplat_tpu_torch.ops.projection import project_gaussians

    cfg = port.splat_config(config)
    grid = TileGrid(config["width"], config["height"], config["focal"],
                    config["focal"])
    bspec, _ = make_specs(grid, cfg)
    rot_t = torch.as_tensor(rot, dtype=torch.float32)
    tran_t = torch.as_tensor(tran, dtype=torch.float32)
    p = project_gaussians(table["pos"], table["quat"], table["scale"], rot_t,
                          tran_t, near=cfg.near,
                          half_width=grid.width * 1.2 / 2 / grid.focal_x,
                          half_height=grid.height * 1.2 / 2 / grid.focal_y)
    opa = torch.sigmoid(table["opa"])
    geom = torch.cat([p.mean2d, p.cov2d, opa[:, None],
                      torch.zeros_like(opa)[:, None]], 1)
    return pack_sorted(bspec, geom, table["rgb"], p.depth,
                       p.visible & table["live"])


@pytest.mark.parametrize("conf", CONFS)
def test_pairs_are_the_programs_bit_for_bit(conf):
    config = tiny(conf, scale_px=8.0)          # some cover more than K tiles
    table = scene.draw_table(config, 3, DEV)
    grid = scene.grid_of(config)
    consts = scene.scene_consts(config)
    for rot, tran in scene.ring(config)[:3]:
        packed = program_pairs(config, table, rot, tran)
        r, t, _ = ref.camera_tensors(rot, tran, grid, DEV)
        params = {k: table[k] for k in port.PARAMS}
        geom, colour, depth, vis = ref.screen(params, table["live"], r, t,
                                              grid, consts["near"],
                                              consts["use_sh"])
        src, starts, clipped = ref.bin_pairs(geom, depth, vis, grid,
                                             consts["k_max"])
        assert torch.equal(starts, packed.tile_start.long())
        assert torch.equal(geom[src], packed.geom)
        assert clipped == int(packed.n_clipped) and clipped > 0
        assert int((starts[1:] - starts[:-1]).max()) > 128


@pytest.mark.parametrize("conf", CONFS)
def test_render_matches_the_programs_plain_route(conf):
    config = tiny(conf)
    table = scene.draw_table(config, 4, DEV)
    splat = port.splatter(config, table, port.scene_cameras(
        config, scene.ring(config), None, DEV))
    grid = scene.grid_of(config)
    for w2c in [scene.pose(np.random.default_rng(s), {"yaw": 0.05,
                                                      "x": 0.1, "y": 0.03})
                for s in range(2)]:
        got = torch.as_tensor(port.render(splat, w2c, config))
        want = ref.render({k: table[k] for k in port.PARAMS}, table["live"],
                          w2c[:3, :3], w2c[:3, 3], grid,
                          scene.scene_consts(config))
        assert float((got.permute(2, 0, 1) - want).abs().max()) < 2e-5


@pytest.mark.parametrize("conf", CONFS)
def test_gradients_match_the_programs(conf):
    """One step's loss and every group's gradient: the reference's autograd
    through its compositor against the program's hand-derived backward."""
    from gsplat_tpu_torch.train import init_train_state, make_grad_fn

    config = tiny(conf, n=3000)
    table = scene.draw_table(config, 5, DEV)
    cams = scene.ring(config)
    gt = scene.ground_truth(table, config, 5, cams)
    splat = port.splatter(config, table,
                          port.scene_cameras(config, cams, gt, DEV))
    tcfg = port.train_config(config, 0)
    st = init_train_state(splat.table.params(), splat.table.live)
    grads, metrics, _ = make_grad_fn(splat, tcfg)(st, 1)
    loss, want = ref.loss_and_grads({k: table[k] for k in port.PARAMS},
                                    table["live"], cams[1][0], cams[1][1],
                                    gt[1], scene.grid_of(config),
                                    scene.scene_consts(config),
                                    config["train"])
    assert abs(float(metrics["loss"]) - loss) <= 1e-5 * loss
    for k, g in want.items():
        rel = float((grads[k] - g).norm() / g.norm())
        assert rel < 1e-3, k


def test_densify_decision_is_the_programs():
    from gsplat_tpu_torch.models.gaussians import adaptive_control

    config = tiny("garden-quality-2400k-rgb", n=3000)
    table = scene.draw_table(config, 6, DEV)
    g = torch.Generator().manual_seed(0)
    cap = table["pos"].shape[0]
    accum = torch.rand((cap, 3), generator=g) * 4e-4
    table["opa"][:50] = -5.0                       # pruned: opacity < 0.02
    table["scale"][50:150] *= 6.0                  # split: norm > 0.05
    tbl = port.splatter(config, table, port.scene_cameras(
        config, scene.ring(config), None, DEV)).table
    grad_avg = accum / (torch.ones(cap)[:, None] + 1e-3)
    t = config["train"]
    _, stats = adaptive_control(
        tbl, grad_avg, torch.zeros((cap, 2, 3)), taus=t["split_thresh"],
        delete_thresh=t["delete_thresh"], grad_thresh=t["grad_thresh"],
        clone_dt=0.01, use_clone=t["use_clone"], use_split=t["use_split"])
    rule = ref.densify_rule(dict(table, accum_grad=accum,
                                 grad_counter=torch.ones(cap)), t)
    assert int((table["live"] & ~rule["keep"]).sum()) == stats.n_deleted
    assert int(rule["split"].sum()) == stats.n_split > 0
    assert int(rule["clone"].sum()) == stats.n_cloned == 0


def test_tf32_rounding_and_its_gradient():
    # to nearest, ties away from zero
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11 + 2.0 ** -13,
                      -3.0 - 2.0 ** -10, 3.0 + 2.0 ** -9])
    assert torch.equal(ref._tf32(x), torch.tensor(
        [1.0, 1.0, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9, 3.0 + 2.0 ** -9]))
    torch.manual_seed(0)
    img = torch.rand(3, 30, 40, requires_grad=True)
    gt = torch.rand(3, 30, 40)
    grads = {}
    for p in ("f32", "tf32"):
        s = ref.ssim(img, gt, p)
        grads[p], = torch.autograd.grad(s, img)
    rel = float((grads["tf32"] - grads["f32"]).norm() / grads["f32"].norm())
    assert 0 < rel < 0.05
