"""composite_bwd_roofline.train (kernels): the least time of the traced
steps' backward compositing over the device time of the kernels the
profiler names ``rasterize_bwd*``.  The least time of a step is the larger
of its evaluations × the backward's flops over 67 TFLOP/s and its bytes
over 3.35 TB/s (``counts``).  Moves ``train_it_per_s``."""

from splatbench import counts, tracing


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "train" or not t["steps"]:
        return None
    k = tracing.kernel_seconds(t["kernel_s"], "rasterize_bwd")
    if k <= 0:
        return None
    least = sum(counts.least_seconds(
        s["evaluations"], counts.BWD_FLOPS[s["colour"]],
        counts.bwd_bytes(s["pairs"], s["colour"], s["n_pix"], s["n_tiles"]))
        for s in t["steps"])
    return 100.0 * least / k
