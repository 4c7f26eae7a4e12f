"""Rank processes of the gsplat_tpu_torch data-parallel tests (no JAX: the
ranks are spawned, and import only this file and the port).

``run_ranks(fn, world, store_dir, *args)`` starts ``world`` ranks of
``fn(rank, world, *args)`` on the CPU with gloo, meeting at a file store
under ``store_dir``, and returns their results by rank.
"""

import multiprocessing as mp
import os

import torch

TIMEOUT_S = 120


def _main(fn, rank, world, store, out, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        out.put((rank, fn(rank, world, *args)))
    except BaseException as e:  # reported to the test, then re-raised
        out.put((rank, e))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, store_dir, *args):
    """→ [fn's result on rank r for r in range(world)]; a rank's exception
    is raised here."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(target=_main, args=(fn, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(out.get(timeout=TIMEOUT_S) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT_S)
            if p.is_alive():
                p.kill()
    for r in range(world):
        if isinstance(results[r], BaseException):
            raise results[r]
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


def load_splat(scene, **kw):
    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.splatter import Splatter

    kw = dict(dict(capacity_round=128, max_tiles_per_gaussian=12), **kw)
    return Splatter(os.path.join(scene, "sparse", "0"),
                    os.path.join(scene, "images_4"), SplatConfig(**kw),
                    device="cpu")


def _numpy(st):
    """A TrainState's leaves as numpy arrays, by name."""
    from gsplat_tpu_torch.train import GROUP_ORDER

    out = {f"params.{k}": st.params[k].numpy() for k in GROUP_ORDER}
    out.update({f"mu.{k}": st.opt.mu[k].numpy() for k in GROUP_ORDER})
    out.update({f"nu.{k}": st.opt.nu[k].numpy() for k in GROUP_ORDER})
    out.update(live=st.live.numpy(), t=int(st.opt.t),
               accum_grad=st.accum_grad.numpy(),
               grad_counter=st.grad_counter.numpy())
    return out


def dp_session(rank, world, scene, cams, lr, trainer_kw, steps, band_scene,
               band_kw):
    """One rank: the data-parallel step on camera ``cams[rank]`` for each
    accumulation method, the same step with every rank on camera 0 (and
    rank 0's one-device step there), the Trainer over ``steps`` with
    ``dp=world``, and ``world`` bands of ``band_scene``'s camera 0 (its
    config ``band_kw``) gathered over the group."""
    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.parallel.data_parallel import make_dp_train_step, \
        replicas_equal
    from gsplat_tpu_torch.parallel.tile_parallel import \
        make_tile_sharded_render
    from gsplat_tpu_torch.train import Trainer, init_train_state, \
        make_train_step

    sp = load_splat(scene)
    lrs = torch.full((5,), lr)
    res = {}
    for method in ("max", "mean"):
        tcfg = TrainConfig(grad_accum_method=method)
        st0 = init_train_state(sp.table.params(), sp.table.live)
        step = make_dp_train_step(sp, tcfg)
        st, m = step(st0, cams[rank], lrs)
        res[method] = {"state": _numpy(st), "loss": float(m["loss"]),
                       "l1": float(m["l1"]),
                       "counters": {k: int(m[k]) for k in (
                           "n_pairs", "n_clipped", "n_max_tiles",
                           "n_visible")}}
        if method == "max":
            res["same_camera"] = _numpy(step(st0, 0, lrs)[0])
            if rank == 0:
                res["one_device"] = _numpy(make_train_step(sp, tcfg)(
                    st0, 0, lrs)[0])
    tr = Trainer(load_splat(scene), TrainConfig(dp=world, **trainer_kw))
    n0 = tr.splat.table.n_live
    for i in steps:
        tr.train_step(i)
    res["trainer"] = {"state": _numpy(tr.state), "n_live0": n0,
                      "n_live": tr.splat.table.n_live,
                      "capacity": tr.splat.table.capacity,
                      "replicas_equal": replicas_equal(tr.state)}
    bsp = load_splat(band_scene, **band_kw)
    c = bsp.cameras
    band = make_tile_sharded_render(c.grid, bsp.cfg, world,
                                    process_group=torch.distributed.group
                                    .WORLD)
    res["bands"] = band(bsp.table.params(), bsp.table.live, c.w2c_rot[0],
                        c.w2c_tran[0]).numpy()
    return res
