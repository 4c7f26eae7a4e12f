"""The interactive viewer (viser) and headless rendering of any camera.

The port of ``gsplat_tpu/viewer.py``:

- ``render_offscreen`` (``:62-161``): any pose, resolution and focal, with
  optional near/far clip planes applied through the live mask, the SH order
  slider's band mask, and the Fast Mode render preset; ``device_out`` keeps
  the image on the device for the server's double buffer;
- ``snap_resolution`` and ``RES_LADDER`` (``:43-59``), copied as they are:
  the port has no compile signatures to bound, but a frame the server pushes
  then has JAX's size and focal for the same slider and camera;
- ``run_viewer`` (``:164-307``): the viser server with the reference's
  control surface, live training between frames through
  ``Trainer.train_step``, and the double-buffered push: each frame is copied
  into pinned host memory behind its own render, and the previous frame is
  pushed while the device renders this one;
- ``_rotmat_to_quat``: a rotation → a COLMAP quaternion.

viser is imported only by ``run_viewer`` when no server is passed; the
tests drive the loop through a fake server.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from gsplat_tpu_torch.models.camera import TileGrid, ray_info
from gsplat_tpu_torch.models.splatter import make_specs, render_cropped
from gsplat_tpu_torch.ops.binning import sqrt_rn
from gsplat_tpu_torch.ops.projection import world_to_camera
from gsplat_tpu_torch.ops.sh import SH_DIM
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np
from gsplat_tpu_torch.utils.timer import span

# SH band sizes: order o keeps the first o^2 of the 9 deg-2 coefficients
_SH_COEFFS_PER_ORDER = {1: 1, 2: 4, 3: 9, 4: 9}
# the id of each render_offscreen call's serve.request span
_REQUESTS = itertools.count()


def camera_to_w2c(wxyz: np.ndarray, position: np.ndarray) -> np.ndarray:
    """viser camera (c2w quaternion + position) → 4x4 w2c
    (visergui.py:14-23)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = quat_to_rotmat_np(wxyz)
    c2w[:3, 3] = position
    return np.linalg.inv(c2w)


# The GUI's resolution ladder: slider and viewport sizes snap to a few
# widths, heights to tile multiples and the field of view to 0.5° steps
# (JAX's bound on XLA compile signatures; kept so that the port's frames
# have JAX's sizes for the same controls).
RES_LADDER = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def snap_resolution(width: int, aspect: float, fov: float,
                    tile: int = 16) -> tuple[int, int, float]:
    """(W, H, fov) quantized: W to the ladder, H to tile multiples, fov to
    0.5-degree steps."""
    w = min(RES_LADDER, key=lambda r: abs(r - width))
    h = max(int(round(w / aspect / tile)) * tile, tile)
    fov_q = round(float(fov) / np.deg2rad(0.5)) * np.deg2rad(0.5)
    return w, h, fov_q


@torch.no_grad()
def render_offscreen(splat, w2c: np.ndarray, width: int, height: int,
                     focal_x: float, focal_y: float,
                     near: float | None = None, far: float | None = None,
                     sh_order: int | None = None, fast: bool | None = None,
                     device_out: bool = False):
    """Render an arbitrary camera → (H, W, 3) numpy image, or with
    ``device_out`` the (3, H, W) tensor on the table's device, returned
    without a sync of its own (the pack's pair-count read is the render's
    only one).

    ``near`` culls by camera z and ``far`` by Euclidean depth ||p_cam||
    (gaussian.cu:1208, :1217); when ``near`` is given the projection's own
    near plane drops to 0.1 so the slider value is the binding cull, as in
    JAX.  ``sh_order`` (SH models) keeps the first ``sh_order``² of each
    channel's 9 coefficients.  ``fast`` (default ``cfg.fast_drawing``)
    renders an RGB model through the bf16 render preset; SH models keep the
    f32 route, as JAX's Fast Mode does (viewer.py:90-100).
    """
    with span("serve.request", id=next(_REQUESTS)):
        cfg = splat.cfg
        if fast is None:
            fast = bool(cfg.fast_drawing)
        preset = fast and not cfg.use_sh_coeff
        if near is not None:
            cfg = dataclasses.replace(cfg, near=min(float(cfg.near), 0.1))
        grid = TileGrid(width=int(width), height=int(height),
                        focal_x=focal_x, focal_y=focal_y,
                        tile_h=cfg.tile_h, tile_w=cfg.tile_w)
        bspec, rspec = make_specs(grid, cfg)
        dev = splat.table.device
        rot = torch.as_tensor(np.asarray(w2c[:3, :3], np.float32), device=dev)
        tran = torch.as_tensor(np.asarray(w2c[:3, 3], np.float32), device=dev)
        params = splat.table.params()
        live = splat.table.live
        shv = None
        if cfg.use_sh_coeff:
            shv = torch.as_tensor(np.stack(list(ray_info(
                w2c[:3, :3], w2c[:3, 3], grid.padded_height, grid.padded_width,
                focal_x, focal_y).values())), dtype=torch.float32, device=dev)
            keep = _SH_COEFFS_PER_ORDER.get(int(sh_order), SH_DIM) \
                if sh_order is not None else SH_DIM
            if keep < SH_DIM:
                # zero the truncated bands per channel (27 = 3 channels x 9)
                mask = torch.zeros(3, SH_DIM, dtype=torch.float32, device=dev)
                mask[:, :keep] = 1.0
                params = dict(params, rgb=params["rgb"] * mask.reshape(-1))
        if near is not None or far is not None:
            p_c = world_to_camera(params["pos"], rot, tran)
            if near is not None:
                live = live & (p_c[:, 2] > near)
            if far is not None:
                live = live & (sqrt_rn((p_c * p_c).sum(dim=-1)) < far)
        img, _ = render_cropped(params, live, rot, tran, grid, cfg, bspec,
                                rspec, shv, preset)
        if device_out:
            return img
        with span("serve.to_host"):
            return img.permute(1, 2, 0).cpu().numpy()


def _to_host(img: torch.Tensor):
    """Start the copy of a (3, H, W) frame to the host as (H, W, 3) → (host
    tensor, the event after the copy, or None on the CPU).  On a card the
    transpose runs on the device and the copy goes into pinned memory
    behind the frame's own render on the current stream, so waiting on the
    event waits for this frame only."""
    hwc = img.permute(1, 2, 0)
    if img.device.type != "cuda":
        return hwc, None
    host = torch.empty(hwc.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(hwc.contiguous(), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(img.device))
    return host, done


def run_viewer(splat, port: int = 6789, trainer=None, server=None,
               max_iters: int | None = None):
    """Serve the scene; with a ``trainer``, train live between frames.

    ``server`` injects a viser-compatible server (the tests pass a fake);
    by default a ``viser.ViserServer(port=port)`` is made, and a missing
    viser raises ``SystemExit``.  ``max_iters`` bounds the main loop (None:
    run forever).

    Each loop iteration that is not paused runs ``Train Viewer Update
    Period`` calls of ``trainer.train_step``, from ``trainer._gui_iter``,
    each with its own host events (JAX's ``train_window`` applies only its
    last iteration's, ``gsplat_tpu/train.py:541``).  Then every client gets
    a frame at its camera, rendered at ``snap_resolution`` of the Resolution
    slider; the previous frame is pushed after this one's render is queued.
    """
    if server is None:
        try:
            import viser
        except ImportError as e:
            raise SystemExit(
                "viser is not installed in this environment; install it to "
                "use --gui, or use render_offscreen() for headless rendering"
            ) from e
        server = viser.ViserServer(port=port)

    # --- control surface (the reference's visergui.py:36-68) --------------
    reset_view = server.add_gui_button("Reset View")
    update_period = server.add_gui_slider(
        "Train Viewer Update Period", min=1, max=100, step=1,
        initial_value=10, disabled=True)
    pause_training = server.add_gui_button("Pause Training")
    sh_order = server.add_gui_slider("SH Order", min=1, max=4, step=1,
                                     initial_value=3)
    resolution = server.add_gui_slider("Resolution", min=384, max=4096,
                                       step=2, initial_value=1024)
    near = server.add_gui_slider("Near", min=0.1, max=30, step=0.5,
                                 initial_value=0.3)
    far = server.add_gui_slider("Far", min=30.0, max=1000.0, step=10.0,
                                initial_value=1000.0)
    show_train_cam = server.add_gui_checkbox("Show Train Camera",
                                             initial_value=False)
    fast_mode = server.add_gui_checkbox(
        "Fast Mode (bf16)", initial_value=bool(splat.cfg.fast_drawing))
    fps_text = server.add_gui_text("FPS", initial_value="-1", disabled=True)

    # pending: (client, host frame, its copy's event) of the double buffer
    state = {"update": True, "paused": False, "iter": 0, "frustums": [],
             "pending": None}
    render_times = deque(maxlen=3)

    def flush_pending():
        """Push the previous frame once its own copy has landed."""
        if state["pending"] is None:
            return
        client_, host, done = state["pending"]
        state["pending"] = None
        if done is not None:
            done.synchronize()
        client_.set_background_image(host.numpy().astype(np.float32),
                                     format="jpeg")

    for ctl in (resolution, near, far, sh_order, fast_mode):
        @ctl.on_update
        def _(_):
            state["update"] = True

    @pause_training.on_click
    def _(_):
        state["paused"] = not state["paused"]
        update_period.disabled = not state["paused"]
        pause_training.name = ("Resume Training" if state["paused"]
                               else "Pause Training")

    @reset_view.on_click
    def _(_):
        state["update"] = True
        for client in server.get_clients().values():
            r = quat_to_rotmat_np(np.asarray(client.camera.wxyz))
            client.camera.up_direction = r @ np.array([0.0, -1.0, 0.0])

    @show_train_cam.on_update
    def _(_):
        state["update"] = True
        if show_train_cam.value and not state["frustums"] \
                and getattr(splat, "cameras", None) is not None:
            cams = splat.cameras
            g = cams.grid
            fov = 2 * np.arctan(g.height / 2 / g.focal_y)
            for i in range(cams.n_cameras):
                w2c = np.eye(4, dtype=np.float32)
                w2c[:3, :3] = cams.w2c_rot[i].cpu().numpy()
                w2c[:3, 3] = cams.w2c_tran[i].cpu().numpy()
                c2w = np.linalg.inv(w2c)
                try:
                    f = server.scene.add_camera_frustum(
                        f"/train_cams/{i}", fov=float(fov),
                        aspect=g.width / g.height, scale=0.1,
                        position=c2w[:3, 3],
                        wxyz=_rotmat_to_quat(c2w[:3, :3]))
                    state["frustums"].append(f)
                except AttributeError:  # older viser scene APIs
                    break
        for f in state["frustums"]:
            f.visible = bool(show_train_cam.value)

    @server.on_client_connect
    def _(client):
        @client.camera.on_update
        def _(_):
            state["update"] = True

    print(f"viewer on port {port}"
          + (" (live training)" if trainer is not None else ""))
    while max_iters is None or state["iter"] < max_iters:
        state["iter"] += 1
        if trainer is not None and not state["paused"]:
            i0 = getattr(trainer, "_gui_iter", 0)
            k = int(update_period.value)
            for i in range(i0, i0 + k):
                trainer.train_step(i)
            trainer._gui_iter = i0 + k
            trainer._sync_table_from_state()
            state["update"] = True
        if not state["update"]:
            flush_pending()   # idle: push the last double-buffered frame
            time.sleep(0.01)
            continue
        state["update"] = False
        for client in server.get_clients().values():
            cam = client.camera
            w2c = camera_to_w2c(np.asarray(cam.wxyz),
                                np.asarray(cam.position))
            W, H, fov = snap_resolution(int(resolution.value), cam.aspect,
                                        cam.fov)
            focal_x = W / 2 / np.tan(fov / 2)
            focal_y = H / 2 / np.tan(fov / 2)
            t0 = time.perf_counter()
            # queue this frame and its copy to the host, then push the
            # previous one while the device renders (the pack's pair-count
            # read has already waited for the previous frame's copy)
            img = render_offscreen(
                splat, w2c, W, H, focal_x, focal_y,
                near=float(near.value), far=float(far.value),
                sh_order=int(sh_order.value), fast=bool(fast_mode.value),
                device_out=True)
            frame = _to_host(img)
            flush_pending()
            state["pending"] = (client, *frame)
            render_times.append(time.perf_counter() - t0)
            fps_text.value = f"{1.0 / np.mean(render_times):.3g}"
    flush_pending()


def _rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 rotation → wxyz quaternion (``gsplat_tpu/viewer.py:310-326``;
    camera poses of the scene generator and the viewer's frustum markers)."""
    w = np.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    if w < 1e-8:
        # a half-turn: the branch of the largest diagonal element
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + r[i, i] - r[j, j] - r[k, k])) * 2
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
        return q
    return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w),
                     (r[0, 2] - r[2, 0]) / (4 * w),
                     (r[1, 0] - r[0, 1]) / (4 * w)])
