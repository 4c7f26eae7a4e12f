"""The Trainer and its CLI, PyTorch port vs the JAX package, on the CPU.

The COLMAP fixture scene of ``tests/test_train_e2e.py:20-34`` (100 points,
9 cameras, 64x48 PNGs, ``capacity_round=128``, K = 12).  JAX runs its jnp
compositor on the dense plane (``use_pallas=False``), the port its plain
versions.  Both trainers take ``train_step(i)`` for i = 601..610 with a
densify event every 5 steps; their camera draws come from the same numpy
generator, and the port is fed the split noise JAX draws
(``gsplat_tpu/train.py:550``, ``models/gaussians.py:184``).  Each tolerance
is stated where it is used.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.train import Trainer as JTrainer
from gsplat_tpu.train import bounded_k_growth as j_k_growth

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.train import GROUP_ORDER, Trainer, bounded_k_growth, \
    main
from gsplat_tpu_torch.utils.image_io import read_png, write_png
from gsplat_tpu_torch.utils.timer import StageTimer

from fixtures import make_scene

torch.set_num_threads(1)
STEPS = range(601, 611)
TKW = dict(n_iters_test=0, n_save_train_img=0, n_adaptive_control=5,
           grad_thresh=1e-7, split_thresh=0.225, use_clone=True,
           use_split=True, seed=1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_scene(d, n_points=100, n_cameras=9, w=64, h=48)
    return d


def _paths(scene):
    return os.path.join(scene, "sparse", "0"), \
        os.path.join(scene, "images_4")


def _t_splat(scene, **kw):
    kw = dict(dict(capacity_round=128, max_tiles_per_gaussian=12), **kw)
    return TSplatter(*_paths(scene), TCfg(**kw), device="cpu")


def _j_splat(scene):
    return JSplatter(*_paths(scene), JCfg(
        plane_mode="dense", use_pallas=False, capacity_round=128,
        max_tiles_per_gaussian=12))


def _feed_jax_noise(tr, seed):
    """Make the port's trainer draw JAX's split noise: one key split per
    densify event, ``normal(sub, (capacity, 2, 3))`` per control run."""
    keys = [jax.random.PRNGKey(seed), None]
    densify = tr._densify

    def wrapped(i, ac, in_reset):
        keys[0], keys[1] = jax.random.split(keys[0])
        densify(i, ac, in_reset)

    tr._densify = wrapped
    tr._split_noise = lambda cap: torch.from_numpy(
        np.array(jax.random.normal(keys[1], (cap, 2, 3))))


@pytest.fixture(scope="module")
def runs(scene):
    jt = JTrainer(_j_splat(scene), JTCfg(**TKW))
    tt = Trainer(_t_splat(scene), TTCfg(**TKW))
    _feed_jax_noise(tt, TKW["seed"])
    out = {"l1": [], "n_live": [], "live": [], "jt": jt, "tt": tt}
    for i in STEPS:
        jm, tm = jt.train_step(i), tt.train_step(i)
        out["l1"].append((float(jm["l1"]), float(tm["l1"])))
        if i % 5 == 0:
            out["n_live"].append((int(jt.splat.table.n_live),
                                  tt.splat.table.n_live))
            out["live"].append((np.asarray(jt.state.live),
                                tt.state.live.numpy()))
    return out


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_trainer_steps_match_jax(runs):
    j, t = np.array(runs["l1"]).T
    # the train step's parity (tests/test_torch_train.py) over 10 steps and
    # two densify events; Adam's first step after each fresh start moves
    # near-zero gradients by ~lr·sign(g), so the bound is rtol 1e-4
    # (measured <= 3e-5)
    np.testing.assert_allclose(t, j, rtol=1e-4)


def test_trainer_densify_matches_jax(runs):
    assert len(runs["n_live"]) == 2
    for (jn, tn), (jl, tl) in zip(runs["n_live"], runs["live"]):
        assert tn == jn
        np.testing.assert_array_equal(tl, jl)
    # 100 → 200 overflowed the 128 slots: grown and run again; then grown
    # by maybe_grow
    assert runs["n_live"][0][1] == 200
    jt, tt = runs["jt"], runs["tt"]
    assert tt.splat.table.capacity == jt.splat.table.capacity > 256
    assert int(tt.state.opt.t) == int(jt.state.opt.t) == 0   # a new Adam
    assert tt.last_densify.n_cloned > 0 and tt.last_densify.n_split > 0


def test_trainer_final_params_match_jax(runs):
    jt, tt = runs["jt"], runs["tt"]
    for k in GROUP_ORDER:
        # relative L2 1e-4 per group (the l1 bound's reason; measured
        # <= 1e-5)
        assert _rel_l2(tt.state.params[k], jt.state.params[k]) < 1e-4, k


def test_full_state_carries_across(runs, scene, tmp_path):
    jt, tt = runs["jt"], runs["tt"]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jt.save_full(jpath, 610)
    fresh = Trainer(_t_splat(scene), TTCfg(**TKW))
    assert fresh.load_full(jpath) == 610
    st, js = fresh.state, jax.device_get(jt.state)
    for k in GROUP_ORDER:
        for a, b in ((st.params[k], js.params[k]), (st.opt.mu[k],
                                                     js.opt.mu[k]),
                     (st.opt.nu[k], js.opt.nu[k])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(st.live.numpy(), np.asarray(js.live))
    np.testing.assert_array_equal(st.accum_grad.numpy(),
                                  np.asarray(js.accum_grad))
    assert int(st.opt.t) == int(js.opt.t)
    assert fresh.splat.table.n_live == int(jt.splat.table.n_live)
    assert fresh.splat.table.capacity == jt.splat.table.capacity
    # and back: JAX resumes the port's file
    fresh.splat.cfg.max_tiles_per_gaussian = 14
    fresh.save_full(tpath, 611)
    assert jt.load_full(tpath) == 611
    assert jt.splat.cfg.max_tiles_per_gaussian == 14
    for k in GROUP_ORDER:
        np.testing.assert_array_equal(np.asarray(jt.state.params[k]),
                                      st.params[k].numpy())
    assert jt.splat.cfg.pair_capacity is None
    # the port's own round trip is bit-identical, K included
    again = Trainer(_t_splat(scene), TTCfg(**TKW))
    assert again.load_full(tpath) == 611
    assert again.splat.cfg.max_tiles_per_gaussian == 14
    for k in GROUP_ORDER:
        assert torch.equal(again.state.params[k], st.params[k])
        assert torch.equal(again.state.opt.nu[k], st.opt.nu[k])


def test_densify_overflow_retry(scene):
    # gsplat_tpu's test_train_e2e.py:103-130: an overflowing control step
    # drops nothing; the trainer grows the table and runs it again
    def run(capacity_round):
        tr = Trainer(_t_splat(scene, capacity_round=capacity_round),
                     TTCfg(grad_thresh=0.0, split_thresh=0.0,
                           delete_thresh=100.0, seed=3))
        tr.state = tr.state._replace(
            accum_grad=torch.ones_like(tr.state.accum_grad),
            grad_counter=torch.ones_like(tr.state.grad_counter))
        tr._densify(700, True, False)
        return tr.splat.table

    tight, ample = run(128), run(1024)
    assert ample.n_live == tight.n_live == 200
    assert tight.capacity > 128 and ample.capacity == 1024


def test_evaluate_keys_and_ranges(runs):
    tt = runs["tt"]
    ev = tt.evaluate(fps_repeats=2)
    assert set(ev) == {"psnr", "ssim", "fps", "fps_frames", "n_pairs"}
    assert 5.0 < ev["psnr"] < 60.0 and 0.0 < ev["ssim"] <= 1.0
    assert ev["fps"] > 0 and ev["fps_frames"] == 2 * len(tt.test_split) == 4
    assert ev["n_pairs"] == int(tt._last_metrics["n_pairs"]) > 0
    one = tt.test(0)
    assert one["image"].shape == (3, 48, 64)
    assert np.isclose(ev["psnr"], np.mean([tt.test(int(c))["psnr"]
                                           for c in tt.test_split]))


def test_resume_reapplies_pyramid_switch(scene):
    # gsplat_tpu's test_train_e2e.py:145-171
    sp = _t_splat(scene)
    tr = Trainer(sp, TTCfg(n_iters=401, n_iters_warmup=5, n_iters_test=0,
                           n_save_train_img=0, n_adaptive_control=10**9,
                           render_downsample_start=8, render_downsample=4,
                           seed=1))
    calls = []
    sp.switch_resolution = lambda f: calls.append(f)
    sp.cfg.render_downsample = 8          # built at the warm-start level
    tr.train(n_iters=401, start=401)      # resumed past 400: the guard
    assert calls == [4]
    sp.cfg.render_downsample = 4          # already there: no switch
    calls.clear()
    tr.train(n_iters=401, start=401)
    assert calls == []
    sp.cfg.render_downsample = 8          # a fresh run does not pre-apply
    calls.clear()
    tr.train(n_iters=1, start=0)
    assert calls == []


def test_cli_trains_tests_and_saves(scene, tmp_path, capsys):
    exp = str(tmp_path / "exp")
    main(["--data", scene, "--n_iters", "41", "--n_iters_warmup", "5",
          "--n_iters_test", "20", "--n_save_train_img", "40", "--exp", exp,
          "--metrics_every", "10", "--lr", "0.01", "--capacity_round",
          "256", "--jacobian_track", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "TEST @20:" in out and "TEST @40:" in out
    l1 = [float(x.split("l1=")[1].split()[0]) for x in out.splitlines()
          if x.startswith("iter ")]
    assert len(l1) >= 4 and l1[-1] < l1[0]
    with np.load(os.path.join(exp, "ckpt.npz")) as z:
        assert z["pos"].shape == (100, 3)
    img = read_png(os.path.join(exp, "imgs", "train_40.png"))
    assert img.shape == (48, 64, 3) and img.max() > 0


@pytest.mark.parametrize("flags", [
    ["--test", "1"], ["--use_pallas", "0"],
    ["--fused_pack", "1"], ["--gather_colors", "1"], ["--gather_geom", "0"],
    ["--quant_depth", "0"], ["--bf16_pack", "0"], ["--cull_sublsb", "0"],
    ["--pad_rows", "-1"]])
def test_cli_rejects_what_the_port_leaves_out(flags, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--data", "nowhere", "--device", "cpu"] + flags)
    if flags[0] == "--test":
        assert "--test 1 requires --gui 1" in str(e.value)


def test_cli_gui_without_viser_exits_naming_it(scene, monkeypatch):
    # --gui 1 loads the scene, then serves it: without viser it exits
    monkeypatch.setitem(sys.modules, "viser", None)
    with pytest.raises(SystemExit, match="viser is not installed"):
        main(["--data", scene, "--gui", "1", "--test", "1", "--device",
              "cpu", "--capacity_round", "256"])


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_cli_dp_needs_a_gpu_a_rank(device, monkeypatch):
    # no fallback to fewer devices or to gloo on the card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dp 2 .*(1 visible|cuda:1)"):
        main(["--data", "nowhere", "--dp", "2", "--device", device])


def test_cli_dp_trains_on_the_cpu(scene, tmp_path, capfd):
    # 2 gloo ranks; the opacity reset at 10 is a host event (rank 0's state
    # broadcast); each rank checks at the end that the replicas are equal
    exp = str(tmp_path / "exp")
    main(["--data", scene, "--n_iters", "21", "--n_iters_warmup", "5",
          "--n_iters_test", "20", "--exp", exp, "--metrics_every", "10",
          "--lr", "0.01", "--capacity_round", "256", "--n_opa_reset", "10",
          "--device", "cpu", "--dp", "2"])
    out = capfd.readouterr().out
    assert out.count("TEST @20:") == 1          # rank 0 alone reports
    l1 = [float(x.split("l1=")[1].split()[0]) for x in out.splitlines()
          if x.startswith("iter ")]
    assert len(l1) == 3 and np.isfinite(l1).all()
    with np.load(os.path.join(exp, "ckpt.npz")) as z:
        assert z["pos"].shape == (100, 3)


def test_entry_points_default_to_the_card():
    # no silent CPU fallback: without a card the default device raises
    if torch.cuda.is_available():
        assert tsyn.synthetic_table(64, capacity_round=64).device.type \
            == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tsyn.synthetic_table(64, capacity_round=64)
    with pytest.raises((RuntimeError, AssertionError)):
        tsyn.synthetic_cameras(1, 32, 32, 30.0)


@pytest.mark.parametrize("k,need,capacity,cap,rows", [
    (6, 0, 65536, 64, 16_777_216), (6, 40, 65536, 64, 16_777_216),
    (12, 9, 1_000_000, 64, 16_777_216), (20, 300, 200_000, 64, 16_777_216),
    (62, 500, 1000, 64, 16_777_216), (64, 500, 1000, 64, 16_777_216),
    (6, 50, 2_000_000, 64, 16_777_216)])
def test_bounded_k_growth_matches_jax(k, need, capacity, cap, rows):
    kw = dict(max_tiles_per_gaussian=k, max_tiles_cap=cap,
              max_plane_rows=rows)
    assert bounded_k_growth(TCfg(**kw), capacity, need) == j_k_growth(
        JCfg(plane_mode="dense", **kw), capacity, need)


def test_png_io_matches_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img[:, :20] = 90                      # flat runs: other PNG filters
    for level in (0, 3, 9):
        p = str(tmp_path / f"c{level}.png")
        cv2.imwrite(p, img[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(read_png(p), img)
    rgba = np.concatenate([img, np.full((37, 53, 1), 7, np.uint8)], 2)
    cv2.imwrite(str(tmp_path / "a.png"), rgba[..., [2, 1, 0, 3]])
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "w.png"))[..., ::-1], img)


def _png_variant(kind, img, tmp_path):
    """A PNG of ``kind`` holding ``img``'s content → its path."""
    import zlib
    import struct

    Image = pytest.importorskip("PIL.Image")
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / f"{kind}.png")
    rng = np.random.default_rng(1)
    g = img[..., 1]
    if kind == "gray8":
        Image.fromarray(g, "L").save(path)
    elif kind == "gray_alpha":
        Image.fromarray(np.stack([g, img[..., 0]], 2), "LA").save(path)
    elif kind in ("palette8", "palette_trns", "palette4"):
        n = 16 if kind == "palette4" else 256
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        im = Image.fromarray(g if n == 256 else g % n, "P")
        im.putpalette(pal.flatten().tolist())
        kw = {"bits": 4} if kind == "palette4" else {}
        if kind == "palette_trns":
            kw["transparency"] = bytes(range(256))
        im.save(path, **kw)
    elif kind == "gray1":
        Image.fromarray(g > 127).save(path)
    elif kind in ("gray2", "gray4"):        # written by hand: 2 or 4 bits
        depth = int(kind[-1])
        vals = g >> (8 - depth)
        rows = b""
        for r in vals:
            bits = "".join(format(int(x), f"0{depth}b") for x in r)
            bits += "0" * (-len(bits) % 8)
            rows += b"\x00" + int(bits, 2).to_bytes(len(bits) // 8, "big")

        def chunk(k, b):
            return (struct.pack(">I", len(b)) + k + b
                    + struct.pack(">I", zlib.crc32(k + b)))
        h, w = g.shape
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
                ">IIBBBBB", w, h, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    elif kind in ("rgb16", "rgba16", "gray16"):
        v = rng.integers(0, 65536, img.shape[:2] + (
            {"rgb16": 3, "rgba16": 4, "gray16": 1}[kind],), dtype=np.uint16)
        cv2.imwrite(path, v[..., 0] if kind == "gray16" else v)
    return path


@pytest.mark.parametrize("kind", ["gray8", "gray_alpha", "palette8",
                                  "palette_trns", "palette4", "gray1",
                                  "gray2", "gray4", "rgb16", "rgba16",
                                  "gray16"])
def test_png_variants_match_cv2(tmp_path, kind):
    # what a capture pipeline may hold: cv2.imread(IMREAD_COLOR) replicates
    # gray, looks up the palette, drops alpha and keeps 16-bit samples'
    # high byte; read_png must give the same pixels
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).integers(0, 256, (13, 21, 3),
                                            dtype=np.uint8)
    path = _png_variant(kind, img, tmp_path)
    np.testing.assert_array_equal(read_png(path), cv2.imread(path)[..., ::-1])


def test_stage_timer_records_on_the_cpu():
    StageTimer.reset()
    for _ in range(3):
        with StageTimer("stage", device="cpu"):
            torch.ones(10).sum()
    with StageTimer("off", debug=False):
        pass
    means = StageTimer.means()
    assert set(means) == {"stage"} and means["stage"] >= 0
    assert len(StageTimer.recorder["stage"]) == 3
    StageTimer.reset()


def test_scene_loads_without_cv2(scene, tmp_path, monkeypatch):
    # the card's machine has no cv2: PNGs, JPEGs, WebPs and AVIFs load
    # through utils/image_io, equal to what JAX reads with cv2 (Pillow's
    # 4:2:2 and film grain AVIFs and a grid too, against cv2's recorded
    # decodes, cv2's file with a SMPTE 240 nclx, which libavif converts on
    # its own path, an intra-only frame first, libaom's OBMC and compound
    # prediction, an inter frame from a reference of another size, a
    # reference slot libaom rebuilds from ref_order_hint); and a scene
    # whose first view is such a rebuilt-slot AVIF (written under the
    # view's own name: both packages read by signature) loads to what
    # JAX's Splatter loads with cv2
    import shutil

    import torch_avif_oracles as oracle
    import torch_make_image_fixtures as fx

    cv2 = pytest.importorskip("cv2")
    from gsplat_tpu_torch.models.splatter import load_scene_camera_groups, \
        read_image

    ref = _j_splat(scene).cameras.images      # JAX reads them with cv2
    view = np.asarray(ref[0]).transpose(1, 2, 0)[..., ::-1]
    jpg, webp = tmp_path / "photo.jpg", tmp_path / "photo.webp"
    cv2.imwrite(str(jpg), view)
    cv2.imwrite(str(webp), view, [cv2.IMWRITE_WEBP_QUALITY, 90])
    want = cv2.cvtColor(cv2.imread(str(jpg)), cv2.COLOR_BGR2RGB)
    want_webp = cv2.cvtColor(cv2.imread(str(webp)), cv2.COLOR_BGR2RGB)
    avif = tmp_path / "photo.avif"
    cv2.imwrite(str(avif), view)
    want_avif = cv2.cvtColor(cv2.imread(str(avif)), cv2.COLOR_BGR2RGB)
    # the rebuilt-slot copy of the scene
    rebuilt = str(tmp_path / "rebuilt_scene")
    shutil.copytree(scene, rebuilt)
    images4 = _paths(rebuilt)[1]
    first = sorted(os.listdir(images4))[0]
    bgr = cv2.imread(os.path.join(images4, first))
    h, w = bgr.shape[:2]
    stream = oracle.libaom_encode_frames(
        [fx.yuv_planes(fx.translated(bgr, t, -t), 6) for t in (2, 1, 0)], 8,
        1, 1, controls={"cpu-used": 5, "error-resilient-mode": 1})
    wrap = lambda st: fx.inter_avif(st, w, h, 8, "420")   # noqa: E731
    data = wrap(fx.rebuilt_stream(stream, "named", np.random.default_rng(0),
                                  wrap))
    assert fx.rebuilt_info(data)[2] > 0
    with open(os.path.join(images4, first), "wb") as f:
        f.write(data)
    ref_rebuilt = np.asarray(_j_splat(rebuilt).cameras.images)
    monkeypatch.setitem(sys.modules, "cv2", None)
    groups = load_scene_camera_groups(*_paths(scene), 4, device="cpu")
    assert groups[0].images.shape == (9, 3, 48, 64)
    np.testing.assert_array_equal(groups[0].images.numpy(), np.asarray(ref))
    groups = load_scene_camera_groups(*_paths(rebuilt), 4, device="cpu")
    np.testing.assert_array_equal(groups[0].images.numpy(), ref_rebuilt)
    assert not np.array_equal(ref_rebuilt, np.asarray(ref))
    np.testing.assert_array_equal(read_image(str(jpg)), want)
    np.testing.assert_array_equal(read_image(str(webp)), want_webp)
    np.testing.assert_array_equal(read_image(str(avif)), want_avif)
    images = os.path.join(os.path.dirname(__file__), "torch_images")
    for name in ("avif_pil_422", "avif_pil_grain", "avif_grid",
                 "avif_smpte240", "avif_intra_only", "avif_unported_obmc",
                 "avif_unported_compound", "avif_unported_ref_size",
                 "avif_unported_ref_order_hint"):
        np.testing.assert_array_equal(
            read_image(os.path.join(images, name + ".avif")),
            read_png(os.path.join(images, name + ".want.png")))


def test_densify_k_guard_grows_k(scene):
    # more than 0.5% of the pairs clipped: K grows (bounded_k_growth), the
    # specs follow it and the cached steps are rebuilt
    tr = Trainer(_t_splat(scene), TTCfg(**TKW))
    tr.train_step(601)
    assert tr._step_cache and tr.splat.specs()[0].max_tiles_per_gaussian == 12
    tr._last_metrics = {"n_clipped": torch.tensor(100),
                        "n_pairs": torch.tensor(1000),
                        "n_max_tiles": torch.tensor(40)}
    tr._densify(605, True, False)
    assert tr.splat.cfg.max_tiles_per_gaussian == 24 == bounded_k_growth(
        TCfg(max_tiles_per_gaussian=12), tr.splat.table.capacity, 40)
    assert not tr._step_cache
    assert tr.splat.specs()[0].max_tiles_per_gaussian == 24
    tr.train_step(606)                     # a step at the new K
