"""The whole slice, PyTorch port vs the JAX package: one gaussian table and
camera through project → pack → composite → assemble → clip → crop.

The JAX side renders with the dense plane (exact depth ranks, f32) through
its jnp compositor and through the Pallas kernel in interpret mode; the port
renders on the CPU, so its compositor is the plain PyTorch version.  The
images must agree within atol 1e-4.
"""

import dataclasses

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from gsplat_tpu import synthetic as jsyn
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.models.splatter import make_specs as j_specs
from gsplat_tpu.models.splatter import render_cropped as j_render

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.models.splatter import make_specs as t_specs
from gsplat_tpu_torch.models.splatter import render_cropped as t_render
from gsplat_tpu_torch.utils.checkpoint import table_from_jax_arrays

torch.set_num_threads(1)

N, W, H, FOCAL = 2000, 96, 64, 80.0
TABLE_KEYS = ("pos", "rgb", "opa", "quat", "scale", "live")


@pytest.fixture(scope="module")
def jax_scene():
    table = jsyn.synthetic_table(N, capacity_round=256, focal=FOCAL,
                                 scale_px=3.0, frustum=(0.85, 0.55))
    cams = jsyn.synthetic_cameras(3, W, H, FOCAL)
    return table, cams


def test_synthetic_scene_bit_identical(jax_scene):
    jt, jc = jax_scene
    tt = tsyn.synthetic_table(N, capacity_round=256, focal=FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55),
                              device="cpu")
    tc = tsyn.synthetic_cameras(3, W, H, FOCAL, device="cpu")
    assert tt.n_live == int(jt.n_live) and tt.capacity == jt.capacity
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    for k in ("w2c_rot", "w2c_tran", "sh_vecs", "images"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)
    assert dataclasses.asdict(tc["grid"]) == dataclasses.asdict(jc["grid"])
    # the other defaults and the ball layout too
    a = tsyn.synthetic_table(300, capacity_round=128, seed=3,
                             ball=(0.0, 0.0, 4.0, 1.0, 4.0), device="cpu")
    b = jsyn.synthetic_table(300, capacity_round=128, seed=3,
                             ball=(0.0, 0.0, 4.0, 1.0, 4.0))
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(a, k).numpy(),
                                      np.asarray(getattr(b, k)), err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("wn", [False, True])
def test_render_cropped_matches_jax(jax_scene, use_pallas, wn):
    jt, jc = jax_scene
    grid = jc["grid"]
    jcfg = JCfg(plane_mode="dense", use_pallas=use_pallas, capacity_round=256,
                render_weight_normalize=wn)
    tcfg = TCfg(capacity_round=256, render_weight_normalize=wn)
    table = table_from_jax_arrays(
        {k: np.asarray(getattr(jt, k)) for k in TABLE_KEYS}, device="cpu")
    bs, rs = j_specs(grid, jt.capacity, jcfg, 3)
    tbs, trs = t_specs(grid, tcfg)
    for cam in (0, 2):
        ji, jaux = j_render(jt.params(), jt.live, jc["w2c_rot"][cam],
                            jc["w2c_tran"][cam], jc["sh_vecs"][cam], grid,
                            jcfg, bs, rs, interpret=use_pallas)
        ti, taux = t_render(table.params(), table.live,
                            torch.from_numpy(np.array(jc["w2c_rot"][cam])),
                            torch.from_numpy(np.array(jc["w2c_tran"][cam])),
                            grid, tcfg, tbs, trs)
        assert ti.shape == (3, H, W)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
        for k in ("n_pairs", "n_clipped", "n_visible", "n_max_tiles"):
            assert int(taux[k]) == int(jaux[k]), k
        np.testing.assert_array_equal(taux["visible"].numpy(),
                                      np.asarray(jaux["visible"]))
        assert int(taux["n_clipped"]) > 0    # the K cap is exercised
