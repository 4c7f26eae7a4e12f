"""The train step, PyTorch port vs the JAX package, on the CPU.

The pieces first (``trunc_exp`` and projection gradients, L1/SSIM gradients,
``adam_update``, ``lrs_at``), then the whole ``make_train_step``: one table,
camera and optimizer state, carried across with
``train_state_from_jax_arrays``, stepped 1 and 3 times by both packages.
JAX renders through its jnp compositor and through the Pallas kernels in
interpret mode; the port's CPU route is the plain compositor and its plain
backward behind ``CompositeTiles``.  Each tolerance is stated where it is
used.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import synthetic as jsyn
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import SceneCameras as JCams
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.ops import losses as jl
from gsplat_tpu.ops.projection import project_gaussians as j_project
from gsplat_tpu.ops.projection import trunc_exp as j_trunc_exp
from gsplat_tpu.train import GROUP_ORDER as J_GROUPS
from gsplat_tpu.train import AdamState as JAdam
from gsplat_tpu.train import Trainer as JTrainer
from gsplat_tpu.train import TrainState as JState
from gsplat_tpu.train import adam_update as j_adam
from gsplat_tpu.train import init_adam as j_init_adam
from gsplat_tpu.train import make_loss_fn as j_loss_fn
from gsplat_tpu.train import make_train_step as j_train_step
from gsplat_tpu.utils.so3 import quat_to_rotmat_np

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import SceneCameras as TCams
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.ops import losses as tl
from gsplat_tpu_torch.ops.projection import project_gaussians as t_project
from gsplat_tpu_torch.ops.projection import trunc_exp as t_trunc_exp
from gsplat_tpu_torch.train import (GROUP_ORDER, AdamState, adam_update,
                                    lrs_at, make_loss_fn, make_train_step)
from gsplat_tpu_torch.utils.checkpoint import (table_from_jax_arrays,
                                               train_state_from_jax_arrays)

torch.set_num_threads(1)

N, W, H, FOCAL = 2000, 96, 64, 80.0      # the scene of test_torch_render.py
TABLE_KEYS = ("pos", "rgb", "opa", "quat", "scale", "live")
LR = 1e-3                                # every group, as bench.py:274


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- the pieces -------------------------------------------------------------

def test_trunc_exp_grad_matches_jax():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    t_trunc_exp(tx).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(j_trunc_exp(v)))(jnp.asarray(x))
    # exp(clamp(x, -1, 1)): e^-1 and e^1 outside [-1, 1]
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gj), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy()[[0, -1]],
                               np.exp([-1.0, 1.0]), rtol=1e-6)


@pytest.mark.parametrize("act", ["abs", "exp"])
def test_projection_grads_match_jax(act):
    rng = np.random.default_rng(20)
    n = 1500
    rot = quat_to_rotmat_np(rng.normal(size=4) * [5, 1, 1, 1])
    tran = rng.normal(0, 0.2, 3)
    # points in a camera frustum with z in [1, 5] (ROADMAP §3: closer to
    # the camera the two packages' R p + t orders differ beyond 1e-6)
    z = rng.uniform(1.0, 5.0, n)
    p_c = np.stack([rng.uniform(-1.1, 1.1, n) * z,
                    rng.uniform(-0.8, 0.8, n) * z, z], axis=1)
    arrs = [np.asarray(a, np.float32) for a in (
        (p_c - tran) @ rot, rng.normal(size=(n, 4)),
        rng.uniform(-0.3, 0.3, (n, 3)), rot, tran)]
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((n, 2), (n, 4), (n,))]
    args = (0.3, 0.8, 0.6, act)

    def j_loss(pos, quat, scale):
        pr = j_project(pos, quat, scale, *map(jnp.asarray, arrs[3:]), *args)
        return sum(jnp.sum(f * c) for f, c in
                   zip((pr.mean2d, pr.cov2d, pr.depth), cts))

    gj = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs[:3]))
    tp = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
    pr = t_project(*tp, *map(torch.from_numpy, arrs[3:]), *args)
    sum((f * torch.from_numpy(c)).sum() for f, c in
        zip((pr.mean2d, pr.cov2d, pr.depth), cts)).backward()
    # R p + t in two summation orders (~1 ulp) carried through the chain:
    # relative L2 per input 1e-5, elementwise 1e-4 of the input's scale
    for t, j, name in zip(tp, gj, ("pos", "quat", "scale")):
        j = np.asarray(j)
        assert _rel_l2(t.grad, j) < 1e-5, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max(), err_msg=name)


def test_loss_grads_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(0.7 * np.roll(a, 1, axis=2) + 0.3 * rng.uniform(0, 1, a.shape),
                0, 1).astype(np.float32)
    for t_fn, j_fn in (
            (lambda x: tl.ssim(x, torch.from_numpy(b), layout="chw"),
             lambda x: jl.ssim(x, jnp.asarray(b), layout="chw")),
            (lambda x: tl.l1_loss(x, torch.from_numpy(b)),
             lambda x: jl.l1_loss(x, jnp.asarray(b)))):
        ta = torch.from_numpy(a).requires_grad_()
        t_fn(ta).backward()
        gj = np.asarray(jax.grad(j_fn)(jnp.asarray(a)))
        # f32 banded matmuls in two libraries' orders: rtol 1e-5 of the
        # gradient's scale
        np.testing.assert_allclose(ta.grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max())


def test_ssim_backward_holds_full_f32():
    # TF32 on globally must not reach the blur's backward
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (3, 24, 30)).astype(
        np.float32)) for _ in range(2))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        x = a.clone().requires_grad_()
        tl.ssim(x, b, layout="chw").backward()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = a.clone().requires_grad_()
    tl.ssim(y, b, layout="chw").backward()
    torch.testing.assert_close(x.grad, y.grad, atol=0, rtol=0)


def _adam_inputs(seed, t):
    rng = np.random.default_rng(seed)
    shapes = {"opa": (50,), "rgb": (50, 3), "pos": (50, 3), "scale": (50, 3),
              "quat": (50, 4)}

    def draw(scale=1.0):
        return {k: (rng.normal(size=s) * scale).astype(np.float32)
                for k, s in shapes.items()}

    params, grads = draw(), draw(1e-3)
    grads["pos"][:5] = [1e-9, 0.0, -1e-9]        # near Adam's eps
    mu, nu = draw(1e-4), {k: np.abs(v) for k, v in draw(1e-6).items()}
    lrs = np.array([0.03, 0.03, 0.003, 0.003, 0.001], np.float32)
    return params, grads, mu, nu, np.int32(t), lrs


@pytest.mark.parametrize("t", [0, 7])
def test_adam_update_matches_jax(t):
    params, grads, mu, nu, tt, lrs = _adam_inputs(t, t)
    jp, js = j_adam(*[{k: jnp.asarray(v) for k, v in d.items()}
                      for d in (params, grads)],
                    JAdam(mu={k: jnp.asarray(v) for k, v in mu.items()},
                          nu={k: jnp.asarray(v) for k, v in nu.items()},
                          t=jnp.asarray(tt)),
                    jnp.asarray(lrs), 0.9, 0.99, 1e-8)

    def tt_(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    tp, ts = adam_update(tt_(params), tt_(grads),
                         AdamState(mu=tt_(mu), nu=tt_(nu),
                                   t=torch.tensor(int(tt), dtype=torch.int32)),
                         torch.from_numpy(lrs), 0.9, 0.99, 1e-8)
    assert int(ts.t) == int(js.t) == t + 1 and ts.t.dtype == torch.int32
    assert tuple(GROUP_ORDER) == tuple(J_GROUPS)
    # the same float32 expressions; XLA and PyTorch may round pow, sqrt and
    # the divisions 1 ulp apart: rtol 1e-6, atol 1e-6 of lr on the params
    for k in GROUP_ORDER:
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-6, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   rtol=1e-6, atol=1e-15, err_msg=k)
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_lrs_at_matches_jax():
    for decay in ("exp", "official", "none"):
        kw = dict(lr=0.003, n_iters=7001, n_iters_warmup=300, lr_decay=decay)
        jt = types.SimpleNamespace(tcfg=JTCfg(**kw))
        for i in (0, 1, 150, 300, 301, 2500, 7000):
            t = lrs_at(TTCfg(**kw), i, device="cpu")
            assert t.dtype == torch.float32 and t.shape == (5,)
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(JTrainer.lrs_at(jt, i)))


# ---- the whole step ---------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """One table and three cameras in both packages (bit-identical)."""
    jt = jsyn.synthetic_table(N, capacity_round=256, focal=FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55))
    jc = jsyn.synthetic_cameras(3, W, H, FOCAL)
    tc = tsyn.synthetic_cameras(3, W, H, FOCAL, device="cpu")
    table = table_from_jax_arrays(
        {k: np.asarray(getattr(jt, k)) for k in TABLE_KEYS}, device="cpu")
    return jt, jc, table, tc


def _splatters(scenes, use_pallas, wn):
    jt, jc, table, tc = scenes
    jcfg = JCfg(plane_mode="dense", use_pallas=use_pallas, capacity_round=256,
                render_weight_normalize=wn)
    js = JSplatter.__new__(JSplatter)     # an in-memory scene, no COLMAP
    js.cfg, js.table, js._specs_cache = jcfg, jt, {}
    js.camera_groups = [JCams(w2c_rot=jc["w2c_rot"], w2c_tran=jc["w2c_tran"],
                              sh_vecs=jc["sh_vecs"], images=jc["images"],
                              grid=jc["grid"], names=["c0", "c1", "c2"])]
    js.cameras = js.camera_groups[0]
    ts = TSplatter.from_scene(
        TCfg(capacity_round=256, render_weight_normalize=wn), table,
        [TCams(w2c_rot=tc["w2c_rot"], w2c_tran=tc["w2c_tran"],
               sh_vecs=tc["sh_vecs"], images=tc["images"], grid=tc["grid"],
               names=["c0", "c1", "c2"])])
    return js, ts


def _start_state(jt, seed):
    """A mid-training JAX state: perturbed params, nonzero moments, t = 4."""
    rng = np.random.default_rng(seed)
    p = {k: v + jnp.asarray(rng.normal(0, 0.02, v.shape), jnp.float32)
         for k, v in jt.params().items()}
    opt = j_init_adam(p)
    opt = JAdam(mu={k: v + jnp.asarray(rng.normal(0, 1e-5, v.shape),
                                       jnp.float32)
                    for k, v in opt.mu.items()},
                nu={k: v + jnp.asarray(np.abs(rng.normal(0, 1e-9, v.shape)),
                                       jnp.float32)
                    for k, v in opt.nu.items()},
                t=jnp.asarray(4, jnp.int32))
    # fresh buffers throughout: JAX's step donates its input state
    return JState(p, jnp.array(jt.live), opt,
                  jnp.asarray(np.abs(rng.normal(0, 1e-6, p["pos"].shape)),
                              jnp.float32),
                  jnp.zeros(jt.capacity, jnp.float32))


def test_loss_and_grads_match_jax(scenes):
    # the gradients of one step, group by group, from make_loss_fn
    jt, jc, table, tc = scenes
    js, ts = _splatters(scenes, use_pallas=False, wn=False)
    tcfg_kw = dict(ssim_weight=0.2, scale_reg=0.01, opa_reg=0.01)
    jst = _start_state(jt, 1)
    st = train_state_from_jax_arrays(jax.tree.map(np.asarray, jst), "cpu")
    bs, rs = js.specs(jc["grid"])
    tbs, trs = ts.specs(tc["grid"])
    jf = j_loss_fn(jc["grid"], js.cfg, JTCfg(**tcfg_kw), bs, rs)
    tf = make_loss_fn(tc["grid"], ts.cfg, TTCfg(**tcfg_kw), tbs, trs)
    cam = 1
    gt = jc["images"][cam].astype(jnp.float32) / 255.0
    gj, (mj, _, _) = jax.jit(jax.grad(jf, has_aux=True))(
        jst.params, jst.live, jc["w2c_rot"][cam], jc["w2c_tran"][cam],
        jc["sh_vecs"][cam], gt)
    params = {k: v.clone().requires_grad_() for k, v in st.params.items()}
    loss, (mt, aux, _) = tf(params, st.live, tc["w2c_rot"][cam],
                            tc["w2c_tran"][cam],
                            tc["images"][cam].to(torch.float32) / 255.0)
    loss.backward()
    assert int(aux["n_pairs"]) > 1000
    for k in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   err_msg=k)
    for k in GROUP_ORDER:
        # two f32 backward routes: relative L2 1e-5 per group
        assert _rel_l2(params[k].grad, gj[k]) < 1e-5, k


def _run(step, st, n_steps, lrs):
    ms = []
    for i in range(n_steps):
        st, m = step(st, i % 3, lrs)
        ms.append(m)
    return st, ms


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("use_pallas,wn,accum", [
    (False, False, "max"), (True, False, "max"), (False, True, "mean")])
def test_train_step_matches_jax(scenes, use_pallas, wn, accum, n_steps):
    jt, jc, table, tc = scenes
    js, ts = _splatters(scenes, use_pallas, wn)
    kw = dict(ssim_weight=0.1, grad_accum_method=accum)
    jst = _start_state(jt, 2)
    st = train_state_from_jax_arrays(jax.tree.map(np.asarray, jst), "cpu")
    jstep = j_train_step(js, JTCfg(**kw), interpret=use_pallas)
    tstep = make_train_step(ts, TTCfg(**kw))
    jst, jms = _run(jstep, jst, n_steps, jnp.full((5,), LR, jnp.float32))
    st, tms = _run(tstep, st, n_steps, torch.full((5,), LR))
    for jm, tm in zip(jms, tms):
        # loss: the same render within 1e-4 (test_torch_render.py), the
        # same L1/SSIM arithmetic: rtol 1e-5 (measured <= 3e-7)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for k in ("n_pairs", "n_clipped", "n_visible", "n_max_tiles"):
            assert int(tm[k]) == int(jm[k]), k
        # mean |grad| per group: two f32 backward routes, rtol 1e-5
        # (measured <= 3e-7)
        for k in GROUP_ORDER:
            np.testing.assert_allclose(float(tm["grad_mean"][k]),
                                       float(jm["grad_mean"][k]),
                                       rtol=1e-5, err_msg=k)
    assert int(st.opt.t) == int(jst.opt.t) == 4 + n_steps
    for k in GROUP_ORDER:
        # moments: relative L2 1e-5 (gradients from two f32 backward
        # routes in other summation orders; measured <= 2e-6)
        assert _rel_l2(st.opt.mu[k], jst.opt.mu[k]) < 1e-5, k
        assert _rel_l2(st.opt.nu[k], jst.opt.nu[k]) < 1e-5, k
        # params: atol 0.01·lr (measured <= 2.4e-4·lr, an ulp of the
        # parameter).  The start state's second moments keep Adam's
        # g/(sqrt(nu) + 1e-8) away from tiny-gradient noise; from nu = 0 a
        # gradient near 1e-8 would move by a visible fraction of lr.
        np.testing.assert_allclose(st.params[k].numpy(),
                                   np.asarray(jst.params[k]),
                                   atol=0.01 * LR, rtol=0, err_msg=k)
    assert _rel_l2(st.accum_grad, jst.accum_grad) < 1e-5
    np.testing.assert_allclose(st.grad_counter.numpy(),
                               np.asarray(jst.grad_counter), atol=0)


@pytest.mark.parametrize("b", [0.9, 0.99, 0.999])
def test_bias_correction_is_the_cpu_expression(b):
    # the table behind adam_update's 1 - b**t (the same bits on the card,
    # test_torch_cuda.py::test_divisions_on_cuda_match_cpu[adam]) holds the
    # 0-d f32 expression the CPU evaluates, and 1 past its end
    from gsplat_tpu_torch.train import bias_correction

    steps = torch.arange(0, 20001, 7, dtype=torch.int32)
    want = torch.stack([1.0 - b ** s.to(torch.float32) for s in steps])
    assert torch.equal(bias_correction(b, steps), want)
    assert float(bias_correction(b, torch.tensor(10 ** 6))) == 1.0
