"""mfu.train (step): the traced train steps' f32 operations over their
untraced, synchronised time, as a share of the H100's 67 TFLOP/s.  The
operations are the benchmark's count (``counts.train_step_flops``) on each
step's own inputs.  Moves ``train_it_per_s``."""

from splatbench import counts


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "train" or not t["steps"]:
        return None
    flops = sum(counts.train_step_flops(s) for s in t["steps"])
    return 100.0 * flops / t["untraced_s"] / counts.F32_FLOPS_S
