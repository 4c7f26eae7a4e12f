"""The benchmark's inputs, made from ``--seed``: the gaussian table, the
camera ring, the ground truth and the viewer's poses.

The table is drawn on the device with a seeded ``torch.Generator`` in two
calls (uniforms and normals), as the bench scene of the repository draws it
on the host: positions uniform in a camera's frustum over a depth range,
scales giving ``scale_px`` pixels on screen, random rotations, colours
uniform in [0.05, 0.95] (with SH: the DC terms, and higher bands N(0,
``sh_ampl``)), one opacity, padded to the capacity with dead slots.  The
ground truth of each camera is the table with its positions jittered by
N(0, ``jitter``), rendered by the plain reference and quantised to uint8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from splatbench import reference as ref

PARAMS = ("pos", "rgb", "opa", "quat", "scale")


def sub_seed(seed: int, tag: int) -> int:
    """An independent 63-bit seed for stream ``tag`` of run ``seed``."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def capacity(config) -> int:
    """Slots of the table: n × headroom rounded up to whole rounds."""
    r = config["capacity_round"]
    return max(math.ceil(config["n_gaussians"] * config["headroom"] / r) * r,
               r)


def draw_table(config, seed: int, device) -> dict:
    """The table → {pos, rgb, opa, quat, scale, live, n_live}."""
    n = config["n_gaussians"]
    cap = capacity(config)
    use_sh = config["splat"]["use_sh_coeff"]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    u = torch.rand((n, 9), generator=gen, device=device)
    g = torch.randn((n, 4 + (27 if use_sh else 0)), generator=gen,
                    device=device)
    lo, hi = config["depth_range"]
    fx, fy = config["frustum"]
    z = lo + (hi - lo) * u[:, 0]
    x = (2 * u[:, 1] - 1) * fx * z
    y = (2 * u[:, 2] - 1) * fy * z
    scale = (0.5 + u[:, 3:6]) * (config["scale_px"] / config["focal"]) \
        * z[:, None]
    rgb01 = 0.05 + 0.9 * u[:, 6:9]
    rgb = torch.log(rgb01 / (1 - rgb01))
    if use_sh:
        coef = g[:, 4:].reshape(n, 3, 9) * config["sh_ampl"]
        coef[:, :, 0] = rgb / ref.C0
        rgb = coef.reshape(n, 27)
    logit = math.log(config["opacity"] / (1 - config["opacity"]))
    dead_opa = math.log(1e-4 / (1 - 1e-4))
    t = {"pos": torch.zeros((cap, 3), device=device),
         "rgb": torch.zeros((cap, rgb.shape[1]), device=device),
         "opa": torch.full((cap,), dead_opa, device=device),
         "quat": torch.zeros((cap, 4), device=device),
         "scale": torch.zeros((cap, 3), device=device),
         "live": torch.arange(cap, device=device) < n}
    t["quat"][:, 0] = 1.0
    t["pos"][:n] = torch.stack([x, y, z], 1)
    t["rgb"][:n] = rgb
    t["opa"][:n] = logit
    t["quat"][:n] = g[:, :4]
    t["scale"][:n] = scale
    t["n_live"] = n
    return t


def ring(config) -> list:
    """The cameras: a ring of slightly turned and shifted poses looking
    down +z → [(rot (3, 3) float64, tran (3,) float64)]."""
    m = config["n_cameras"]
    out = []
    for i in range(m):
        angle = 0.05 * math.sin(2 * math.pi * i / m)
        rot = ref.rotation([math.cos(angle / 2), 0.0, math.sin(angle / 2),
                            0.0])
        tran = np.array([0.05 * (i % 5 - 2), 0.03 * (i % 3 - 1), 0.0])
        out.append((rot, tran))
    return out


def grid_of(config) -> ref.Grid:
    return ref.Grid(config["width"], config["height"], config["focal"],
                    config["focal"])


def scene_consts(config, k_max=None) -> dict:
    """What the reference needs of the configuration to render."""
    s = config["splat"]
    return {"near": s["near"], "use_sh": s["use_sh_coeff"],
            "k_max": s["max_tiles_per_gaussian"] if k_max is None else k_max,
            "thresh": s["tile_culling_prob_thresh"]}


def ground_truth(table, config, seed: int, cams) -> torch.Tensor:
    """Each camera's ground truth: the table jittered, rendered by the
    reference → (M, 3, H, W) uint8."""
    dev = table["pos"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(sub_seed(seed, 1))
    params = {k: table[k] for k in PARAMS}
    params["pos"] = params["pos"] + config["jitter"] * torch.randn(
        params["pos"].shape, generator=gen, device=dev)
    grid = grid_of(config)
    consts = scene_consts(config)
    return torch.stack([
        (ref.render(params, table["live"], rot, tran, grid, consts) * 255
         ).to(torch.uint8) for rot, tran in cams])


def pose(rng: np.random.Generator, traffic) -> np.ndarray:
    """A viewer pose inside the ring's span → 4x4 world-to-camera
    (float64)."""
    yaw = rng.uniform(-traffic["yaw"], traffic["yaw"])
    w2c = np.eye(4)
    w2c[:3, :3] = ref.rotation([math.cos(yaw / 2), 0.0, math.sin(yaw / 2),
                                0.0])
    w2c[:3, 3] = [rng.uniform(-traffic["x"], traffic["x"]),
                  rng.uniform(-traffic["y"], traffic["y"]), 0.0]
    return w2c
