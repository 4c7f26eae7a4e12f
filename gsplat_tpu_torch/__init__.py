"""gsplat_tpu_torch — the PyTorch + CUDA port of ``gsplat_tpu``.

The JAX package ``gsplat_tpu`` beside it is the unchanged reference.  The
port keeps its module names (``models/camera.py``, ``ops/binning.py``,
``ops/rasterize.py``, ...) so each counterpart sits at the same path, and
its public functions keep the JAX layouts: channel-major ``(3, H, W)``
images and per-tile rows ``(T, 3, Px)`` plus ``(T, Px)``.

Plain tensor code is PyTorch.  The compositor, forward and backward, is
hand-written CUDA for Hopper (``csrc/rasterize_fwd.cu``,
``csrc/rasterize_bwd.cu``), built with ``nvcc`` at first use; on a CPU
tensor the same wrapper runs its plain PyTorch version.  The entry points
(``Splatter``, ``synthetic``, ``load_checkpoint``, the CLI) put their
tensors on the card unless the caller asks for ``device="cpu"``.

This package imports neither ``jax`` nor ``gsplat_tpu``.
"""

__version__ = "0.1.0"

from gsplat_tpu_torch.config import SplatConfig, TrainConfig  # noqa: F401
