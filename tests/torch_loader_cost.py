"""Host time of ``load_kernel_library`` once the library is loaded: every
kernel launch of the port calls it (``ops/rasterize._kernel``), so its cost
is paid once a launch.  Needs nvcc and a card (it builds the forward
kernel once); not a pytest test.

    python tests/torch_loader_cost.py [ROOT]

ROOT is the checkout whose ``gsplat_tpu_torch`` is timed (default: this
one), so an unpacked older commit can be timed beside it in one run.
"""

import os
import sys
import time

ROOT = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gsplat_tpu_torch.ops import cuda_build  # noqa: E402

REPS = 1000

cuda_build.load_kernel_library("rasterize_fwd")
for _ in range(2):
    t0 = time.perf_counter()
    for _ in range(REPS):
        cuda_build.load_kernel_library("rasterize_fwd")
    print(f"{cuda_build.__file__}: "
          f"{(time.perf_counter() - t0) / REPS * 1e6:.1f} us a call",
          flush=True)
