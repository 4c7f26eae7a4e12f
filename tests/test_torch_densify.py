"""Adaptive density control, PyTorch port vs the JAX package, on the CPU.

One table made from a numpy seed, one averaged |∇pos|, and the split noise
drawn by ``jax.random.normal`` from the key JAX's ``adaptive_control``
draws it from (``gsplat_tpu/models/gaussians.py:184``) and handed to the
port's.  Live masks, ``n_live`` and the stats must be equal; parameters
within rtol 1e-6 (the split sample ``pos + (R S) ε`` sums its three terms
in another order than XLA's einsum: an ulp of the offset).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.models.gaussians import GaussianTable as JTable
from gsplat_tpu.models.gaussians import adaptive_control as j_control
from gsplat_tpu.models.gaussians import grow_capacity as j_grow
from gsplat_tpu.models.gaussians import reset_opacity as j_reset

from gsplat_tpu_torch.models.gaussians import adaptive_control, \
    grow_capacity, reset_opacity
from gsplat_tpu_torch.utils.checkpoint import table_from_jax_arrays

torch.set_num_threads(1)
KEYS = ("pos", "rgb", "opa", "quat", "scale")


def _tables(seed, cap=256, n_live=150, act="abs", sh=False):
    """The same table in both packages: live rows first, a few dead ones
    among them, opacities either side of logit(0.02), scales either side
    of the split and delete thresholds."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.005, 0.12, (cap, 3))
    scale[:6] = 2.0                               # oversized: deleted
    scale = np.log(scale) if act == "exp" else scale * rng.choice(
        [-1.0, 1.0], (cap, 3))                    # abs activation
    live = np.arange(cap) < n_live
    live[[3, 40, 77]] = False
    a = {"pos": rng.normal(0, 1, (cap, 3)),
         "rgb": rng.normal(0, 1, (cap, 27 if sh else 3)),
         "opa": rng.normal(-1.0, 2.0, cap),
         "quat": rng.normal(0, 1, (cap, 4)), "scale": scale}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a["live"] = live
    a["n_live"] = np.int32(live.sum())
    jt = JTable(**{k: jnp.asarray(v) for k, v in a.items()})
    return jt, table_from_jax_arrays(a, "cpu")


def _grad(seed, cap, scale=3e-4):
    return np.abs(np.random.default_rng(seed + 100).normal(
        0, scale, (cap, 3))).astype(np.float32)


def _check(jt, tt, jstats, tstats):
    assert tt.n_live == int(jt.n_live)
    np.testing.assert_array_equal(tt.live.numpy(), np.asarray(jt.live))
    assert (tstats.n_deleted, tstats.n_cloned, tstats.n_split,
            tstats.overflowed, tstats.n_wanted) == (
        int(jstats.n_deleted), int(jstats.n_cloned), int(jstats.n_split),
        bool(jstats.overflowed), int(jstats.n_wanted))
    for k in KEYS:
        j = np.asarray(getattr(jt, k))
        np.testing.assert_allclose(getattr(tt, k).numpy(), j, rtol=1e-6,
                                   atol=1e-6 * np.abs(j).max(), err_msg=k)


CASES = {   # name → (taus, use_clone, use_split, grad scale)
    "delete": (0.05, True, True, 0.0),
    "clone": (10.0, True, False, 3e-4),
    "split": (0.0, False, True, 3e-4),
    "mixed": (0.08, True, True, 3e-4),
}


@pytest.mark.parametrize("agg,act", [("max", "abs"), ("mean", "exp")])
@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_control_matches_jax(case, agg, act):
    taus, use_clone, use_split, gs = CASES[case]
    jt, tt = _tables(1, act=act)
    grad = _grad(1, jt.capacity, gs)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (jt.capacity, 2, 3)))
    kw = dict(taus=taus, delete_thresh=1.5, grad_thresh=2e-4, clone_dt=0.01)
    jn, js = j_control(jt, jnp.asarray(grad), key, **kw,
                       use_clone=jnp.asarray(use_clone),
                       use_split=jnp.asarray(use_split),
                       scale_activation=act, grad_aggregation=agg)
    tn, ts = adaptive_control(tt, torch.from_numpy(grad),
                              torch.from_numpy(eps), **kw,
                              use_clone=use_clone, use_split=use_split,
                              scale_activation=act, grad_aggregation=agg)
    _check(jn, tn, js, ts)
    assert ts.n_deleted > 0 and not ts.overflowed
    assert (ts.n_cloned > 0) == (case in ("clone", "mixed"))
    assert (ts.n_split > 0) == (case in ("split", "mixed"))
    # the input table is left as it was (the overflow retry reruns it)
    np.testing.assert_array_equal(tt.pos.numpy(), np.asarray(jt.pos))


@pytest.mark.parametrize("sh", [False, True])
def test_adaptive_control_overflow_matches_jax(sh):
    # 200 live in 256 slots, every one proposes a split or a clone: the
    # compacted table is clamped to capacity and n_wanted says what was
    # proposed
    jt, tt = _tables(2, n_live=200, sh=sh)
    grad = np.full((jt.capacity, 3), 1e-3, np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (jt.capacity, 2, 3)))
    kw = dict(taus=0.08, delete_thresh=1.5, grad_thresh=2e-4, clone_dt=0.01)
    jn, js = j_control(jt, jnp.asarray(grad), key, **kw,
                       use_clone=jnp.asarray(True),
                       use_split=jnp.asarray(True))
    tn, ts = adaptive_control(tt, torch.from_numpy(grad),
                              torch.from_numpy(eps), **kw, use_clone=True,
                              use_split=True)
    _check(jn, tn, js, ts)
    assert ts.overflowed and ts.n_wanted > tt.capacity
    assert tn.n_live == tt.capacity


def test_reset_opacity_matches_jax():
    jt, tt = _tables(3)
    j, t = j_reset(jt), reset_opacity(tt)
    np.testing.assert_array_equal(t.opa.numpy(), np.asarray(j.opa))
    assert (t.opa[~tt.live] == tt.opa[~tt.live]).all()


@pytest.mark.parametrize("kw", [
    dict(), dict(min_capacity=900), dict(min_capacity=900, max_capacity=640),
    dict(headroom=1.0), dict(max_capacity=128)])
def test_grow_capacity_matches_jax(kw):
    jt, tt = _tables(4, n_live=230)
    j, t = j_grow(jt, 128, **kw), grow_capacity(tt, 128, **kw)
    assert t.capacity == j.capacity and t.n_live == int(j.n_live)
    for k in KEYS + ("live",):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    if t.capacity == tt.capacity:
        assert t is tt                     # nothing to grow: the same table
