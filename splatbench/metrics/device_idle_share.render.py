"""device_idle_share.render (device): the traced frames' window less the
profiler's busy time (the union of device intervals), over that window.
Moves ``render_fps``.

Both times come from the one traced call.  Each frame's copy into pageable
host memory shows on the device for as long as the host takes to stage
it, and the profiler slows the host, so the traced busy time can exceed
the untraced loop's whole time: against that time the 2.4M render read
-13.6% (H100 80GB HBM3)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kind"] != "render" or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
