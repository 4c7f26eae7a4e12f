"""composite_fwd_roofline.render (kernels): the least time of the traced
frames' forward compositing over the device time of the kernels the
profiler names ``rasterize_fwd*``.  Moves ``render_fps``."""

from splatbench import counts, tracing


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "render" or not t["frames"]:
        return None
    k = tracing.kernel_seconds(t["kernel_s"], "rasterize_fwd")
    if k <= 0:
        return None
    least = sum(counts.least_seconds(
        f["evaluations"], counts.FWD_FLOPS[f["colour"]],
        counts.fwd_bytes(f["pairs"], f["colour"], f["n_pix"], f["n_tiles"]))
        for f in t["frames"])
    return 100.0 * least / k
