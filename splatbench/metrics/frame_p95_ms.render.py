"""frame_p95_ms.render (serve): the 95th percentile of every request's
latency in the window, from the call to the image on the host.  Moves
``render_fps``.  It is a per-layer metric: under the process's default
allocator the tail swings from run to run (17-24% within a set of runs of
the 2.4M render) past any bound an end-to-end metric may have."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies")
    return float(np.percentile(np.array(lat) * 1e3, 95)) if lat else None
