"""The port's scene tools vs the JAX package's, on the CPU: the COLMAP
writers, the synthetic scene generator (``scripts/make_synth_scene.py``), the
at-scale run script (``scripts/run_garden_7k.py``, driven at a tiny size)
and the image pyramid (``downsample.py``).

JAX's scene generator runs as the JAX tests run it on the CPU: its Pallas
forward in interpret mode, with its ``SplatConfig`` name replaced by one
that sets ``plane_mode="dense"`` so that its SH colors stay f32 (ROADMAP,
"Tests").  Each tolerance is stated where it is used.
"""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.viewer import _rotmat_to_quat as j_rotmat_to_quat

from gsplat_tpu_torch.config import SplatConfig, TrainConfig
from gsplat_tpu_torch.downsample import downsample_area
from gsplat_tpu_torch.downsample import main as downsample_main
from gsplat_tpu_torch.models.splatter import Splatter
from gsplat_tpu_torch.scripts import make_synth_scene as tms
from gsplat_tpu_torch.scripts import run_garden_7k as trun
from gsplat_tpu_torch.train import GROUP_ORDER, Trainer
from gsplat_tpu_torch.utils import colmap as tcolmap
from gsplat_tpu_torch.utils.image_io import read_png, write_png
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np
from gsplat_tpu_torch.viewer import _rotmat_to_quat

from fixtures import write_cameras_bin, write_images_bin, write_points3d_bin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny orbit SH scene of the garden_hard kind: 3,000 GT gaussians with
# view-dependent bands and sensor noise, 6 cameras at 64x48
TINY = dict(n_gt=3000, n_points=400, n_cams=6, w=64, h=48, focal=60.0,
            capacity_round=1024, scale_px=1.6, opa=0.6, orbit=True,
            use_sh=True, sh_ampl=0.35, noise_std=2.0)
COLMAP_FILES = ("cameras.bin", "images.bin", "points3D.bin")
# the run script at a tiny size: a densify event every 10 steps, TEST every
# 20, a full-state save every 10, a 4,096-slot ceiling
RUN_FLAGS = ["--device", "cpu", "--metrics_every", "10", "--save_every",
             "10", "--capacity_round", "1024", "--max_capacity", "4096",
             "--n_adaptive_control", "10", "--n_iters_warmup", "5",
             "--n_iters_test", "20", "--grad_thresh", "1e-7"]
RESUME_AT = 600          # the seeded state: densify events come after 600
FIRST_END, SECOND_END = 641, 661


def _jax_scene_script():
    """JAX's scripts/make_synth_scene.py as a module, its SplatConfig name
    bound to one with the dense plane (f32 SH colors)."""
    spec = importlib.util.spec_from_file_location(
        "jax_make_synth_scene", os.path.join(REPO, "scripts",
                                             "make_synth_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SplatConfig = lambda **kw: JCfg(plane_mode="dense", **kw)
    return mod


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The tiny scene written by JAX's generator and by the port's (CPU)."""
    root = tmp_path_factory.mktemp("scenes")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    _jax_scene_script().main(jdir, pair_capacity=None, **TINY)
    built = tms.main(tdir, device="cpu", log=lambda msg: None, **TINY)
    return jdir, tdir, built


# ---- (a) the COLMAP writers ----------------------------------------------

def _colmap_inputs():
    rng = np.random.default_rng(0)
    poses = [(np.array([1.0, 0.0, 0.0, 0.0]) + rng.normal(0, 0.1, 4),
              rng.normal(0, 1, 3), f"img_{i:03d}.png") for i in range(5)]
    xyz = rng.normal(0, 2, (37, 3))
    rgb = rng.integers(0, 256, (37, 3)).astype(np.uint8)
    return poses, xyz, rgb


@pytest.mark.parametrize("name", COLMAP_FILES)
def test_colmap_writers_match_the_fixtures(name, tmp_path):
    poses, xyz, rgb = _colmap_inputs()
    ours, theirs = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    if name == "cameras.bin":
        tcolmap.write_cameras_binary(ours, 1, 5188, 3360, 4000.0, 3999.5)
        write_cameras_bin(theirs, 1, 5188, 3360, 4000.0, 3999.5)
        cam = tcolmap.read_cameras_binary(ours)[1]
        assert (cam.model, cam.width, cam.height) == ("PINHOLE", 5188, 3360)
        np.testing.assert_array_equal(cam.params, [4000.0, 3999.5, 2594,
                                                   1680])
    elif name == "images.bin":
        tcolmap.write_images_binary(ours, poses, 1)
        write_images_bin(theirs, poses, 1)
        back = tcolmap.read_images_binary(ours)
        assert sorted(back) == [1, 2, 3, 4, 5]
        for i, (q, t, n) in enumerate(poses):
            im = back[i + 1]
            np.testing.assert_array_equal(im.qvec, q)
            np.testing.assert_array_equal(im.tvec, t)
            assert (im.name, im.camera_id, len(im.xys)) == (n, 1, 0)
    else:
        tcolmap.write_points3d_binary(ours, xyz, rgb)
        write_points3d_bin(theirs, xyz, rgb)
        pos, col = tcolmap.read_points3d_arrays(ours)
        np.testing.assert_array_equal(pos, xyz.astype(np.float32))
        np.testing.assert_array_equal(col, rgb)
        pts = tcolmap._read_points3d_binary_python(open(ours, "rb").read())
        assert pts[37].error == 0.5
        np.testing.assert_array_equal(pts[37].image_ids, [1, 2])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_rotmat_to_quat_matches_jax():
    rng = np.random.default_rng(1)
    quats = list(rng.normal(size=(20, 4)))
    # half-turns about each axis and a diagonal one: the trace is -1, the
    # fallback branch
    quats += [np.array([0.0, 1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0, 0.0]),
              np.array([0.0, 0.0, 0.0, 1.0]), np.array([0.0, 1.0, 1.0, 0.0])]
    for q in quats:
        r = quat_to_rotmat_np(q / np.linalg.norm(q))
        ours = _rotmat_to_quat(r)
        np.testing.assert_array_equal(ours, j_rotmat_to_quat(r))
        back = quat_to_rotmat_np(ours)
        np.testing.assert_allclose(back, r, atol=1e-12)


# ---- (b) the scene generator against JAX's ---------------------------------

@pytest.mark.parametrize("name", COLMAP_FILES)
def test_scene_colmap_files_match_jax(scenes, name):
    jdir, tdir, _ = scenes
    with open(os.path.join(jdir, "sparse", "0", name), "rb") as a, \
            open(os.path.join(tdir, "sparse", "0", name), "rb") as b:
        assert a.read() == b.read()


def test_scene_images_match_jax(scenes):
    jdir, tdir, built = scenes
    names = sorted(os.listdir(os.path.join(jdir, "images_4")))
    assert names == [f"img_{i:03d}.png" for i in range(TINY["n_cams"])]
    differ = 0
    for name in names:
        j = read_png(os.path.join(jdir, "images_4", name)).astype(int)
        t = read_png(os.path.join(tdir, "images_4", name)).astype(int)
        assert t.shape == (TINY["h"], TINY["w"], 3)
        # the same f32 render on both sides up to summation order: a value
        # next to a rounding boundary may land 1 LSB apart (measured: 2 of
        # the 55,296 values, 0.004%)
        assert np.abs(j - t).max() <= 1, name
        differ += int((j != t).sum())
    assert differ <= 1e-3 * len(names) * TINY["h"] * TINY["w"] * 3
    assert [v["name"] for v in built["views"]] == names
    assert all(v["n_pairs"] > 0 for v in built["views"])


def test_scene_ceiling_matches_jax(scenes):
    jdir, tdir, built = scenes
    with open(os.path.join(jdir, "gt_ceiling.json")) as f:
        j = json.load(f)
    with open(os.path.join(tdir, "gt_ceiling.json")) as f:
        t = json.load(f)
    # JAX writes the ceiling rounded to 0.01 dB; the noise is the same
    # draw, so only the 1-LSB pixels move it
    assert abs(built["oracle_ceiling_psnr"] - j["oracle_ceiling_psnr"]) \
        <= 0.01
    assert t == j


def test_scene_generator_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tms.main(str(tmp_path / "s"), log=lambda msg: None, **TINY)
    assert tms.build_argparser().parse_args(["out"]).device == "cuda"
    assert trun.build_argparser().parse_args([]).device == "cuda"


# ---- (c) the run script: densify, summary, resume -------------------------

def _jax_summary_keys():
    """The keys of the summary dict in JAX's scripts/run_garden_7k.py."""
    with open(os.path.join(REPO, "scripts", "run_garden_7k.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "summary"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in JAX's run_garden_7k.py")


def _bits(x):
    # bitwise, NaN included (dead slots after a densify hold NaN)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same_state(a, b):
    return all(torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))
               for f in ("live", "accum_grad", "grad_counter")) \
        and torch.equal(a.opt.t, b.opt.t) and all(
            torch.equal(_bits(x[k]), _bits(y[k])) for x, y in (
                (a.params, b.params), (a.opt.mu, b.opt.mu),
                (a.opt.nu, b.opt.nu)) for k in GROUP_ORDER)


@pytest.fixture(scope="module")
def runs(scenes, tmp_path_factory):
    """Two calls of run_garden_7k.main on the port's tiny scene, both on
    the schedule of a run to 660: 601-640 from a state seeded at iteration
    600 (densify events at 610-640, stopped by --stop_at), then a resume to
    660; the second call's restored state is kept."""
    _, tdir, _ = scenes
    exp = str(tmp_path_factory.mktemp("run") / "exp")
    os.makedirs(exp)
    seed = Trainer(Splatter(os.path.join(tdir, "sparse", "0"),
                            os.path.join(tdir, "images_4"),
                            SplatConfig(capacity_round=1024), device="cpu"),
                   TrainConfig())
    seed.save_full(os.path.join(exp, "full_state.npz"), RESUME_AT)
    flags = ["--scene", tdir, "--exp", exp] + RUN_FLAGS
    # the first call stops at FIRST_END on the schedule of the whole run
    first, tr1 = trun.main(flags + ["--n_iters", str(SECOND_END),
                                    "--stop_at", str(FIRST_END)])
    saved = os.path.join(exp, "first_full_state.npz")
    shutil.copy(os.path.join(exp, "full_state.npz"), saved)
    restored = []
    load_full = Trainer.load_full

    def capture(self, path):
        i = load_full(self, path)
        restored.append((i, self.state))
        return i

    Trainer.load_full = capture
    try:
        second, tr2 = trun.main(flags + ["--n_iters", str(SECOND_END)])
    finally:
        Trainer.load_full = load_full
    with open(os.path.join(exp, "train.log")) as f:
        log = f.read()
    return dict(first=first, second=second, tr1=tr1, tr2=tr2, exp=exp,
                saved=saved, restored=restored, log=log)


def test_run_summary_has_jax_keys(runs):
    added = {"device", "peak_mem_gib", "test_trajectory"}
    for s in (runs["first"], runs["second"]):
        assert set(s) == _jax_summary_keys() | added
        assert s["device"] == "cpu" and s["peak_mem_gib"] is None
    with open(os.path.join(runs["exp"], "summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(runs["second"]))
    first = runs["first"]
    assert first["n_iters"] == FIRST_END and first["scene_preset"] == \
        "garden_hard" and first["max_capacity"] == 4096
    assert first["oracle_ceiling"]["n_gt"] == TINY["n_gt"]
    assert np.isfinite(first["final_psnr"]) and 0 < first["final_ssim"] <= 1
    assert [t[0] for t in first["test_trajectory"]] == [620, 640]
    assert os.path.exists(os.path.join(runs["exp"], "ckpt.npz"))
    assert os.path.exists(os.path.join(runs["exp"], "summary_partial.json"))


def test_run_densifies_and_logs_the_capacity(runs):
    traj = runs["first"]["capacity_trajectory"]
    assert [t[0] for t in traj] == [RESUME_AT + 1, 610, 620, 630, 640]
    for _, n_live, capacity in traj:
        assert n_live <= capacity <= 4096
    assert traj[-1][1] > traj[0][1]             # the table grew
    assert "densify @610:" in runs["log"] and "TEST @640:" in runs["log"]
    assert f"resumed from {runs['exp']}" in runs["log"]


def test_run_resume_restores_the_state_bit_for_bit(runs):
    (i, st), = runs["restored"]
    assert i == FIRST_END - 1                   # the last iteration trained
    # the restored state is the one the first call ended with
    assert _same_state(st, runs["tr1"].state)
    with np.load(runs["saved"]) as z:
        assert int(z["i_iter"]) == FIRST_END - 1
        for k in GROUP_ORDER:
            np.testing.assert_array_equal(
                st.params[k].numpy().view(np.int32),
                z[f"p_{k}"].view(np.int32))


def test_run_resume_trains_on_from_the_resume_point(runs):
    second = runs["second"]
    traj = second["capacity_trajectory"]
    assert [t[0] for t in traj] == [FIRST_END, 650, 660]
    assert traj[0][1:] == runs["first"]["capacity_trajectory"][-1][1:]
    assert [t[0] for t in second["test_trajectory"]] == [660]
    assert f"iter {SECOND_END - 1}:" in runs["log"]
    assert not any(line.startswith(f"iter {FIRST_END - 1}:")
                   for line in runs["log"].split("resumed from")[-1]
                   .splitlines())


# ---- (d) the image pyramid -----------------------------------------------

@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_cv2_inter_area(factor, tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(factor)
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    imgs = {"a.png": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
            # sizes that do not divide: cv2 rounds the output size and
            # averages the partial blocks at the edge
            "b.png": rng.integers(0, 256, (43, 67, 3), dtype=np.uint8)}
    for name, img in imgs.items():
        write_png(str(src / name), img)
    (src / "notes.txt").write_text("not an image")
    downsample_main(["--src", str(src), "--dst", str(dst), "--factor",
                     str(factor)])
    assert sorted(os.listdir(dst)) == sorted(imgs)
    for name, img in imgs.items():
        ref = cv2.resize(img, dsize=None, fx=1 / factor, fy=1 / factor,
                         interpolation=cv2.INTER_AREA)
        out = read_png(str(dst / name))
        assert out.shape == ref.shape
        # bit for bit (cv2's whole-factor path: block means, half to even,
        # whole 2 x 2 blocks half up)
        np.testing.assert_array_equal(out, ref, err_msg=name)


# sizes: odd sides, and widths x 3 channels that are not a multiple of the
# 16 bytes of cv2's SIMD rows (its linear resize has a vector body and a
# scalar tail)
_AREA_SIZES = [(43, 67), (31, 29), (17, 129), (48, 64)]
# fractional shrinks (resizeArea_; 2.0000001 and 2.9999999 are near a
# whole number but not within DBL_EPSILON of it), enlargements (the linear
# resize with INTER_AREA's weights) and whole factors (the block means)
_AREA_FACTORS = [1.5, 2.25, 1 / 0.7, 3.3, 1.1, 2.0000001, 2.9999999,
                 0.5, 0.75, 0.3, 2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("size", _AREA_SIZES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("factor", _AREA_FACTORS, ids=lambda f: f"{f:.7g}")
def test_downsample_area_matches_cv2_resize(factor, size):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(size[0] * 1000 + size[1])
    noise = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    ramp = np.clip(np.cumsum(rng.normal(0, 9, size + (3,)), axis=1) + 128,
                   0, 255).astype(np.uint8)
    for img in (noise, ramp):
        ref = cv2.resize(img, None, fx=1 / factor, fy=1 / factor,
                         interpolation=cv2.INTER_AREA)
        out = downsample_area(img, factor)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("factor", [2, 3])
def test_downsample_zero_side_fails_as_cv2_asserts(factor, tmp_path):
    # a 1x3 image at factor 2 or 3 would be 0 rows high: cv2.resize asserts
    # (!dsize.empty()) and the JAX script dies there, after the files
    # before it; so does the port, naming the file
    cv2 = pytest.importorskip("cv2")
    tiny = np.arange(9, dtype=np.uint8).reshape(1, 3, 3)
    with pytest.raises(cv2.error, match="dsize.empty"):
        cv2.resize(tiny, None, fx=1 / factor, fy=1 / factor,
                   interpolation=cv2.INTER_AREA)
    with pytest.raises(ValueError, match="3x1 image"):
        downsample_area(tiny, factor)
    src = tmp_path / "src"
    src.mkdir()
    write_png(str(src / "a.png"), np.full((8, 8, 3), 7, np.uint8))
    write_png(str(src / "b.png"), tiny)
    write_png(str(src / "c.png"), np.full((8, 8, 3), 9, np.uint8))
    for script, out in ((["downsample.py"], "jax"),
                        (["-m", "gsplat_tpu_torch.downsample"], "port")):
        proc = subprocess.run(
            [sys.executable, *script, "--src", str(src), "--dst",
             str(tmp_path / out), "--factor", str(factor)], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, out
        assert proc.stdout.split() == ["a.png"], out
        assert sorted(os.listdir(tmp_path / out)) == ["a.png"], out
    assert str(src / "b.png") in proc.stderr
    np.testing.assert_array_equal(read_png(str(tmp_path / "jax" / "a.png")),
                                  read_png(str(tmp_path / "port" / "a.png")))


@pytest.mark.parametrize("factor", [0, -2, float("inf"), float("nan")])
def test_downsample_fails_where_cv2_fails_on_the_factor(factor, tmp_path):
    # JAX's 1 / 0 raises ZeroDivisionError; cv2.resize asserts a positive
    # finite scale for the others
    cv2 = pytest.importorskip("cv2")
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises((ZeroDivisionError, cv2.error)):
        cv2.resize(img, None, fx=1 / factor, fy=1 / factor,
                   interpolation=cv2.INTER_AREA)
    with pytest.raises(ValueError, match="finite number > 0"):
        downsample_area(img, factor)
    with pytest.raises(SystemExit, match="--factor"):
        downsample_main(["--src", str(tmp_path), "--dst",
                         str(tmp_path / "dst"), "--factor", str(factor)])
    assert not (tmp_path / "dst").exists()


def test_scene_tools_leave_cv2_and_jax_unloaded():
    code = (
        "import sys\n"
        "import gsplat_tpu_torch.downsample, "
        "gsplat_tpu_torch.scripts.make_synth_scene, "
        "gsplat_tpu_torch.scripts.run_garden_7k\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'jax', 'gsplat_tpu', 'fixtures'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
