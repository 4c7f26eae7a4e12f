"""mfu.render (serve): the traced frames' f32 operations (projection and
the compositor's forward, ``counts.frame_flops``) over their untraced,
synchronised time, as a share of the H100's 67 TFLOP/s.  Moves
``render_fps``."""

from splatbench import counts


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "render" or not t["frames"]:
        return None
    flops = sum(counts.frame_flops(f) for f in t["frames"])
    return 100.0 * flops / t["untraced_s"] / counts.F32_FLOPS_S
