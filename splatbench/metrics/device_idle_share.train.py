"""device_idle_share.train (device): the untraced time of the traced train
steps less the profiler's busy time (the union of device intervals), over
the untraced time.  Moves ``train_it_per_s``."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "train" or t["untraced_s"] <= 0:
        return None
    return 100.0 * (t["untraced_s"] - t["busy_s"]) / t["untraced_s"]
