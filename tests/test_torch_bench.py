"""PyTorch port vs the JAX package: the bench (``gsplat_tpu_torch/bench.py``
against the root ``bench.py``).

On a small bench-kind scene (the same synthetic table and cameras in both
packages, bit-identical draws; 100x70 pixels, so the padded image is
cropped by (5, 6) pixels): the oracle ground truth within 1 LSB of JAX's
``render_cropped`` of the same jittered table; a 3-step burst from a
mid-training state equal to JAX's ``jax.grad(make_loss_fn)`` + ``adam_update`` + the |∇pos| max
(loss rtol 1e-5, params rel L2 1e-4: PERF.md's train-step parity); from
the bench's own fresh state the same losses, params within max(1e-4, 2x)
the distance of JAX's one-ulp twin (every position moved by one ulp) from
JAX, and the burst's PSNR within 0.01 dB of JAX's under the same centred
crop.  The JAX
bench crops its oracle and its PSNR top-left (``bench.py:179``, ``:325``),
which at a padded size is another image: recorded here as the reference's
fault.  Then the command: one JSON line with JAX's keys, an ``error`` line
(rc 0) for ``--device cuda`` without a card, and the TPU layout flags
rejected.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import make_specs as j_specs
from gsplat_tpu.models.splatter import render_cropped as j_cropped
from gsplat_tpu.models.splatter import render_padded as j_padded
from gsplat_tpu.ops.losses import psnr as j_psnr
from gsplat_tpu.synthetic import synthetic_cameras as j_cameras
from gsplat_tpu.synthetic import synthetic_table as j_table
from gsplat_tpu.train import adam_update as j_adam
from gsplat_tpu.train import init_adam as j_init_adam
from gsplat_tpu.train import make_loss_fn as j_loss_fn

from gsplat_tpu_torch import bench
from gsplat_tpu_torch.config import SplatConfig, TrainConfig
from gsplat_tpu_torch.models.splatter import make_specs
from gsplat_tpu_torch.synthetic import synthetic_cameras, synthetic_table

torch.set_num_threads(1)
N, W, H, FOCAL, M, K = 2000, 100, 70, 80.0, 3, 3
TABLE = dict(focal=FOCAL, scale_px=2.5, frustum=(0.85, 0.55),
             capacity_round=256)
# the JAX bench's keys (BENCH_r05.json, bench.py:117-331)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "phase_done",
            "backend", "n_gaussians", "resolution", "color",
            "render_fps_f32_route", "render_route", "render_fps_bf16_preset",
            "preset_vs_f32_psnr", "render_fps", "render_fps_vs_baseline",
            "psnr_after_burst"}
TPU_FLAGS = ("--fused_pack", "--gather_colors", "--gather_geom",
             "--quant_depth", "--bf16_pack", "--post_align", "--pad_rows",
             "--cull_sublsb", "--chunk_size", "--px_split")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def mid_state(params, seed=2):
    """A mid-training Adam state over ``params`` (numpy): nonzero moments,
    t = 4, as ``tests/test_torch_train.py::_start_state`` makes it, so
    that Adam's g / (sqrt(nu) + 1e-8) is not fed noise-level gradients from
    nu = 0 → (mu, nu, t, accum)."""
    rng = np.random.default_rng(seed)
    mu = {k: rng.normal(0, 1e-5, v.shape).astype(np.float32)
          for k, v in params.items()}
    nu = {k: np.abs(rng.normal(0, 1e-9, v.shape)).astype(np.float32)
          for k, v in params.items()}
    accum = np.abs(rng.normal(0, 1e-6, params["pos"].shape)) \
        .astype(np.float32)
    return mu, nu, 4, accum


@pytest.fixture(scope="module")
def scene():
    """Both packages' scene and specs, the port's oracle images, and each
    package's 3-step burst from the untouched table (a fresh state, as the
    bench takes it) and from a mid-training state, and JAX's fresh burst
    from its one-ulp twin of the table."""
    from gsplat_tpu.train import AdamState as JAdam
    from gsplat_tpu_torch.train import AdamState, TrainState

    jt, tt = j_table(N, **TABLE), synthetic_table(N, device="cpu", **TABLE)
    jc, tc = j_cameras(M, W, H, FOCAL), synthetic_cameras(M, W, H, FOCAL,
                                                         device="cpu")
    jcfg = JCfg(plane_mode="dense", use_pallas=False, capacity_round=256)
    tcfg = SplatConfig(capacity_round=256)
    jbs, jrs = j_specs(jc["grid"], jt.capacity, jcfg, 3)
    tbs, trs = make_specs(tc["grid"], tcfg)
    tc["images"] = bench.oracle_gt(tt.params(), tt.live, tc, tcfg, tbs, trs)
    images = np.asarray(tc["images"].numpy())

    # the port's bursts, as the bench takes them
    step = bench.make_step(tc, tcfg, TrainConfig(ssim_weight=0.1), tbs, trs)

    def port_burst(st):
        losses = []
        for c in range(K):
            st, loss = step(st, c % M)
            losses.append(float(loss))
        return st, losses

    fresh, fresh_losses = port_burst(bench.fresh_state(tt))
    t_psnr = bench.view_psnr(fresh.params, fresh.live, tc, tcfg, tbs, trs)
    mu, nu, t, acc = mid_state({k: v.numpy() for k, v in tt.params().items()})

    def tens(d):
        return {k: torch.from_numpy(v.copy()) for k, v in d.items()}

    st0 = bench.fresh_state(tt)
    mid, mid_losses = port_burst(TrainState(
        st0.params, st0.live, AdamState(tens(mu), tens(nu),
                                        torch.tensor(t, dtype=torch.int32)),
        torch.from_numpy(acc.copy()), st0.grad_counter))

    # JAX's (bench.py:266-285), on the same images
    jtc = JTCfg(ssim_weight=0.1)
    loss_fn = j_loss_fn(jc["grid"], jcfg, jtc, jbs, jrs)

    def jax_burst(p, opt, accum):
        losses = []
        for c in range(K):
            gt = jnp.asarray(images[c % M]).astype(jnp.float32) / 255.0
            grads, (m, _, _) = jax.grad(loss_fn, has_aux=True)(
                p, jt.live, jc["w2c_rot"][c % M], jc["w2c_tran"][c % M],
                jc["sh_vecs"][c % M], gt)
            p, opt = j_adam(p, grads, opt,
                            jnp.full((5,), bench.LR, jnp.float32),
                            jtc.adam_b1, jtc.adam_b2, jtc.adam_eps)
            accum = jnp.maximum(accum, jnp.abs(grads["pos"]))
            losses.append(float(m["loss"]))
        return p, accum, losses

    jp, jp_acc, j_fresh_losses = jax_burst(
        jt.params(), j_init_adam(jt.params()),
        jnp.zeros_like(jt.params()["pos"]))
    # JAX's one-ulp twin: the same burst with every position moved by one
    # ulp (np.nextafter, as tests/torch_long_parity.py's jax_f32_twin)
    twin = dict(jt.params())
    twin["pos"] = jnp.asarray(np.nextafter(np.asarray(twin["pos"]),
                                           np.float32(np.inf)))
    jtw, jtw_acc, _ = jax_burst(twin, j_init_adam(twin),
                                jnp.zeros_like(twin["pos"]))
    img, _ = j_cropped(jp, jt.live, jc["w2c_rot"][0], jc["w2c_tran"][0],
                       jc["sh_vecs"][0], jc["grid"], jcfg, jbs, jrs)
    j_psnr0 = float(j_psnr(img, jnp.asarray(images[0]).astype(jnp.float32)
                           / 255.0, data_range=1.0))

    def jx(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    jmid, jmid_acc, j_mid_losses = jax_burst(
        jt.params(), JAdam(jx(mu), jx(nu), jnp.asarray(t, jnp.int32)),
        jnp.asarray(acc))
    return dict(jt=jt, jc=jc, jcfg=jcfg, jbs=jbs, jrs=jrs, images=images,
                fresh=(fresh_losses, j_fresh_losses, t_psnr, j_psnr0),
                fresh_params=(fresh, jp, jp_acc, jtw, jtw_acc),
                mid=(mid, mid_losses, jmid, jmid_acc, j_mid_losses))


def test_oracle_gt_matches_jax(scene):
    s = scene
    jt, jc = s["jt"], s["jc"]
    tgt = dict(jt.params())
    tgt["pos"] = tgt["pos"] + jnp.asarray(np.random.default_rng(1).normal(
        0, bench.JITTER, tgt["pos"].shape), jnp.float32)
    for c in range(M):
        img, _ = j_cropped(tgt, jt.live, jc["w2c_rot"][c], jc["w2c_tran"][c],
                           jc["sh_vecs"][c], jc["grid"], s["jcfg"], s["jbs"],
                           s["jrs"])
        want = np.asarray((img * 255).astype(jnp.uint8)).astype(np.int32)
        got = s["images"][c].astype(np.int32)
        assert got.shape == (3, H, W)
        assert np.abs(got - want).max() <= 1
        assert got.std() > 10          # the scene, not a blank frame


def test_burst_matches_jax(scene):
    # from a mid-training state: loss rtol 1e-5 and params rel L2 1e-4 per
    # group (PERF.md's train-step parity).  From nu = 0 Adam's first steps
    # turn gradients at the f32 noise level (L1's sign at pixels where
    # render and ground truth meet) into lr-sized moves, so the fresh burst
    # is held by its losses and its PSNR and its params by JAX's one-ulp
    # twin (below)
    st, losses, p, accum, j_losses = scene["mid"]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for k in ("pos", "rgb", "opa", "quat", "scale"):
        assert rel_l2(st.params[k].detach().numpy(), p[k]) <= 1e-4, k
    assert rel_l2(st.accum_grad.numpy(), accum) <= 1e-4
    assert losses[-1] < losses[0]


def test_fresh_burst_matches_jax(scene):
    # the bench's psnr_after_burst: K steps from a fresh state, the loss of
    # each within rtol 1e-5 and view 0's PSNR within 0.01 dB of JAX's under
    # the same centred crop
    losses, j_losses, t_psnr, j_psnr0 = scene["fresh"]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert abs(t_psnr - j_psnr0) <= 0.01


def test_fresh_burst_params_within_the_twin_floor(scene):
    # the bench's own state: K steps from a fresh state (nu = 0).  Each
    # group's params (and the |∇pos| max) within max(1e-4, 2x) the rel L2
    # by which JAX's one-ulp twin ends from JAX: the noise floor of Adam's
    # first steps, which move every element by ~lr whatever its gradient's
    # size, so gradients at the f32 noise level decide a sign
    st, jp, jp_acc, jtw, jtw_acc = scene["fresh_params"]
    pairs = [(k, st.params[k].detach().numpy(), jp[k], jtw[k])
             for k in ("pos", "rgb", "opa", "quat", "scale")]
    pairs.append(("accum_grad", st.accum_grad.numpy(), jp_acc, jtw_acc))
    for k, port, ref, tw in pairs:
        got, floor = rel_l2(port, ref), rel_l2(tw, ref)
        print(f"fresh burst {k}: rel L2 from JAX: port {got:.3e}, one-ulp "
              f"twin {floor:.3e}; port from the twin {rel_l2(port, tw):.3e}")
        assert got <= max(1e-4, 2.0 * floor), (k, got, floor)


def test_reference_bench_crops_top_left(scene):
    # bench.py:179 and :325 take img[:, :h, :w] of the padded render;
    # render_cropped (the loss's crop, gsplat_tpu/train.py:84) is centred
    s = scene
    jt, jc = s["jt"], s["jc"]
    grid = jc["grid"]
    assert (grid.crop_top, grid.crop_left) == (5, 6)
    pad, _ = j_padded(jt.params(), jt.live, jc["w2c_rot"][0],
                      jc["w2c_tran"][0], jc["sh_vecs"][0], grid, s["jcfg"],
                      s["jbs"], s["jrs"])
    top_left = np.asarray(jnp.clip(pad[:, :H, :W], 0.0, 1.0))
    centred, _ = j_cropped(jt.params(), jt.live, jc["w2c_rot"][0],
                           jc["w2c_tran"][0], jc["sh_vecs"][0], grid,
                           s["jcfg"], s["jbs"], s["jrs"])
    assert np.abs(top_left - np.asarray(centred)).max() > 0.1


@pytest.mark.parametrize("argv,last", [
    ([], "psnr_burst"),
    (["--use_sh_coeff", "1", "--phase", "render"], "render"),
])
def test_main_prints_one_json_line(argv, last, capsys, monkeypatch):
    # the CPU proxy and its repeat cap cut so the whole command runs in
    # seconds
    monkeypatch.setattr(bench, "CPU_PROXY", dict(
        n_gauss=0, w=64, h=48, focal=60.0, m_cams=2, k_small=1, k_big=1))
    monkeypatch.setattr(bench, "MAX_REPS_CPU", 2)
    rc = bench.main(["--device", "cpu", "--n_gauss", "2000", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert "error" not in out and out["phase_done"] == last
    sh = bool(argv)
    want = set(JAX_KEYS)
    if sh:      # no preset for SH (bench.py:217), no train phase
        want -= {"render_fps_bf16_preset", "preset_vs_f32_psnr",
                 "psnr_after_burst"}
    assert want <= set(out), want - set(out)
    assert out["metric"] == ("render_fps@2k_gaussians_64x48_sh" if sh
                             else "train_it_per_s@2k_gaussians_64x48")
    assert out["backend"] == "cpu" and out["n_gaussians"] == 2000
    assert out["unit"] == ("fps" if sh else "it/s") and out["value"] > 0
    for key in ("host_cpu", "host_load", "spread", "reps", "device"):
        assert key in out
    if not sh:
        assert out["render_route"] == "packed_bf16"
        assert out["preset_vs_f32_psnr"] > 40
        assert out["psnr_after_burst"] > out["psnr_before_burst"]


def test_cuda_without_a_card_reports_an_error(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert "is_available() is False" in out["error"]
    assert out["phase_done"] == "none" and out["value"] == -1.0


@pytest.mark.parametrize("flag", TPU_FLAGS)
def test_tpu_layout_flags_are_rejected(flag):
    with pytest.raises(SystemExit):
        bench.build_argparser().parse_args([flag, "1"])
