"""Entry point of the benchmark: one run of one cell.

    python3 splatbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The clock of ``setup_s`` starts here.
Every build and kernel cache is kept inside the checkout at a fixed path:
the port's own kernel builds go to ``gsplat_tpu_torch/_build/``; PyTorch's
extension, Triton's and CUDA's caches to ``.splatbench_cache/``.

The process runs with the settings a user's process gets: PyTorch's,
OpenMP's and glibc's defaults.
"""

import time

CLOCK0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".splatbench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from splatbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], CLOCK0, ROOT))
