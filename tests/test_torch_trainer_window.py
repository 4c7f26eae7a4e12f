"""``Trainer.train``'s windows and a densify event in the at-scale regime,
PyTorch port vs the JAX package, on the CPU.

The COLMAP fixture scene of ``tests/test_torch_trainer.py`` (100 points, 9
cameras, 64x48 PNGs).  JAX runs its jnp compositor on the dense plane, the
port its plain versions; the port is fed JAX's split noise.

- ``Trainer.train`` runs windows of steps that end at every host event.
  JAX's window (``window_scan``) hands its K guard the window max of the
  binning counters (``gsplat_tpu/train.py:211-221``); the port's must too.
- A densify event from one shared state at K = 24 whose proposals overflow
  the table and grow it past the first capacity bucket, with the K guard
  fed the same window counters: the same live mask, gaussians, capacity and
  K (the row bound on the grown capacity).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsplat_tpu.train as jtrain
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter

from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch import train as ttrain
from gsplat_tpu_torch.train import COUNTERS, GROUP_ORDER, Trainer, \
    bounded_k_growth
from gsplat_tpu_torch.utils.checkpoint import train_state_from_jax_arrays

from fixtures import make_scene

torch.set_num_threads(1)
TKW = dict(n_iters_test=0, n_save_train_img=0, n_adaptive_control=5,
           grad_thresh=1e-7, split_thresh=0.225, use_clone=True,
           use_split=True, seed=1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_scene(d, n_points=100, n_cameras=9, w=64, h=48)
    return os.path.join(d, "sparse", "0"), os.path.join(d, "images_4")


def _feed_jax_noise(tr, seed):
    """The port's trainer draws JAX's split noise: one key split per densify
    event, ``normal(sub, (capacity, 2, 3))`` per control run."""
    keys = [jax.random.PRNGKey(seed), None]
    densify = tr._densify

    def wrapped(i, ac, in_reset):
        keys[0], keys[1] = jax.random.split(keys[0])
        densify(i, ac, in_reset)

    tr._densify = wrapped
    tr._split_noise = lambda cap: torch.from_numpy(
        np.array(jax.random.normal(keys[1], (cap, 2, 3))))


def _pair(scene, tkw=TKW, **skw):
    """A JAX and a port Trainer on the scene with the same configs."""
    jt = jtrain.Trainer(JSplatter(*scene, JCfg(
        plane_mode="dense", use_pallas=False, **skw)), JTCfg(**tkw))
    tt = Trainer(TSplatter(*scene, TCfg(**skw), device="cpu"), TTCfg(**tkw))
    _feed_jax_noise(tt, tkw["seed"])
    return jt, tt


def _record_events(tr, out):
    """Record K, live count and capacity after each densify event."""
    densify = tr._densify

    def wrapped(i, ac, in_reset):
        densify(i, ac, in_reset)
        out.append((i, int(tr.splat.cfg.max_tiles_per_gaussian),
                    int(tr.splat.table.n_live),
                    int(tr.splat.table.capacity)))

    tr._densify = wrapped


def test_window_metrics_takes_the_counters_max_and_the_last_losses():
    steps = [{"l1": torch.tensor(0.5), "n_pairs": torch.tensor(90),
              "n_clipped": torch.tensor(7), "n_max_tiles": torch.tensor(3),
              "n_visible": torch.tensor(40)},
             {"l1": torch.tensor(0.25), "n_pairs": torch.tensor(80),
              "n_clipped": torch.tensor(9), "n_max_tiles": torch.tensor(2),
              "n_visible": torch.tensor(41)}]
    w = None
    for m in steps:
        w = ttrain.window_metrics(w, m)
    assert float(w["l1"]) == 0.25
    assert {k: int(w[k]) for k in COUNTERS} == {
        "n_pairs": 90, "n_clipped": 9, "n_max_tiles": 3, "n_visible": 41}
    assert ttrain.window_metrics(None, steps[0]) is steps[0]


def test_train_windows_feed_the_k_guard_as_jax(scene):
    # K = 2 on 4x3 tiles: most steps clip pairs, so the K guard reads its
    # counters at both events; windows of 5 steps end at the densify events
    # 605 and 610 (n_adaptive_control 5)
    skw = dict(capacity_round=128, max_tiles_per_gaussian=2,
               max_tiles_cap=12)
    jt, tt = _pair(scene, **skw)
    ev_j, ev_t = [], []
    _record_events(jt, ev_j)
    _record_events(tt, ev_t)
    jh = jt.train(611, metrics_every=5, log=lambda s: None, start=601)
    th = tt.train(611, metrics_every=5, log=lambda s: None, start=601)
    assert len(ev_t) == 2 and ev_t[0][1] > 2
    # K, live gaussians and capacity after each event, as JAX's
    assert ev_t == ev_j
    # the last window's metrics: its counters' max, its last step's loss
    for k in COUNTERS:
        assert int(tt._last_metrics[k]) == int(jt._last_metrics[k]), k
    # Adam restarts at each event; the steps agree as in
    # tests/test_torch_trainer.py (rtol 1e-4)
    np.testing.assert_allclose(th["l1"], jh["l1"], rtol=1e-4)
    np.testing.assert_array_equal(tt.state.live.numpy(),
                                  np.asarray(jt.state.live))


def test_densify_at_k24_grows_past_the_first_bucket(scene, monkeypatch):
    # 100 gaussians in 128 slots (64-slot buckets), every one densified:
    # ~200 proposals overflow the table, which grows to
    # round(1.1 · n_wanted) = 256 (two buckets) before the control runs
    # again.  The K guard then grows K = 24 toward 40 but the row bound
    # (256 · K <= 9216) stops it at 36; at the pre-growth capacity it
    # would have allowed 40.
    skw = dict(capacity_round=64, max_tiles_per_gaussian=24,
               max_tiles_cap=40, max_plane_rows=9216)
    jt, tt = _pair(scene, **skw)
    for i in range(601, 605):               # no event before 605
        jm = jt.train_step(i)
    assert jt.splat.table.capacity == tt.splat.table.capacity == 128
    # one shared state: JAX's after its steps, carried into the port
    tt.state = train_state_from_jax_arrays(
        jax.tree.map(np.asarray, jt.state), "cpu")
    tt._sync_table_from_state()
    # the same window counters for both K guards: 5% of the pairs clipped,
    # a gaussian over 48 tiles
    window = dict(n_pairs=1000, n_clipped=50, n_max_tiles=48, n_visible=90)
    jt._last_metrics = dict(jm, **{k: jnp.int32(v)
                                   for k, v in window.items()})
    tt._last_metrics = {k: torch.tensor(v) for k, v in window.items()}
    # half the gaussians above the split threshold, half cloned
    norm = np.linalg.norm(np.abs(np.asarray(jt.state.params["scale"])[:100]),
                          axis=1)
    jt.tcfg.split_thresh = tt.tcfg.split_thresh = float(np.median(norm))
    stats = {}
    control = jtrain.adaptive_control

    def recorded(*a, **kw):
        out = control(*a, **kw)
        stats.setdefault("runs", []).append(out[1])
        return out

    monkeypatch.setattr(jtrain, "adaptive_control", recorded)
    jt._densify(605, True, False)
    tt._densify(605, True, False)

    js = stats["runs"][-1]
    assert len(stats["runs"]) == 2                 # overflowed, ran again
    ts = tt.last_densify
    assert (int(js.n_deleted), int(js.n_cloned), int(js.n_split)) == \
        (ts.n_deleted, ts.n_cloned, ts.n_split)
    assert ts.n_cloned > 0 and ts.n_split > 0
    assert tt.splat.table.capacity == int(jt.splat.table.capacity) == 256
    assert tt.splat.table.n_live == int(jt.splat.table.n_live) > 128
    assert tt.splat.cfg.max_tiles_per_gaussian == \
        jt.splat.cfg.max_tiles_per_gaussian == 36
    assert bounded_k_growth(TCfg(**skw), 128, 48) == 40
    assert bounded_k_growth(TCfg(**skw), 256, 48) == 36
    # the same live mask exactly, and the gaussians in the same slots: kept
    # rows bit for bit, clones and split samples from the same noise within
    # f32 rounding (rel 1e-6 of each group's scale)
    np.testing.assert_array_equal(tt.state.live.numpy(),
                                  np.asarray(jt.state.live))
    live = tt.state.live.numpy()
    for k in GROUP_ORDER:
        j = np.asarray(jt.state.params[k])[live]
        t = tt.state.params[k].numpy()[live]
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-6 * np.abs(j).max(), err_msg=k)
