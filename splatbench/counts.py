"""The yardstick's arithmetic: the chip's peaks and the operations and bytes
the algorithm needs, counted from its inputs (never from the program's
tensors, so the count measures the same work whatever implements it).

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM.

Operations of one pair-pixel evaluation of the compositor (f32, an exp and
a division one each), counted from its formulas: forward, the 2-D gaussian
(~19), alpha, the weight and the sums of three colours and Σw (~9): 28; SH
adds three channels of nine multiply-adds and a sigmoid: 91.  Backward, the
forward again (~20), d_alpha by the suffix identity (~15), the six geometry
partials (~36) and ten sums (~19): 90; SH adds the colours (63), the logit
gradients (9) and 27 coefficient sums (54): 216.
"""

from __future__ import annotations

F32_FLOPS_S = 67e12
HBM_BYTES_S = 3.35e12

FWD_FLOPS = {3: 28, 27: 91}          # by colour width
BWD_FLOPS = {3: 90, 27: 216}
GEOM_FLOATS = 6                      # x, y, the conic's a, b, d, opacity
# per live gaussian: projection with the tile rectangle (~180), its
# backward (~2x)
PROJECT_FWD, PROJECT_BWD = 180, 360
ADAM_PER_FLOAT = 14                  # both moments, the update, the step
# per pixel and channel: L1 (3 forward, 2 backward); SSIM's five planes
# blurred by an 11-tap window in two passes (5 x 2 x 21) and its map (~20),
# its backward twice that
LOSS_PER_PIXEL = 5 + 3 * (5 * 2 * 21 + 20)


def params_per_gaussian(colour: int) -> int:
    return 3 + colour + 1 + 4 + 3


def fwd_bytes(pairs: int, colour: int, n_pix: int, n_tiles: int) -> int:
    """The forward compositor: each pair's geometry and colour read once,
    the image (three colours and Σw a pixel) written once, the tile
    ranges."""
    return 4 * (pairs * (GEOM_FLOATS + colour) + 4 * n_pix + n_tiles + 1)


def bwd_bytes(pairs: int, colour: int, n_pix: int, n_tiles: int) -> int:
    """The backward compositor: each pair's geometry and colour read once
    and its gradient written once, the image's cotangent and the forward's
    image read once, the tile ranges."""
    return 4 * (2 * pairs * (GEOM_FLOATS + colour) + (3 + 4) * n_pix
                + n_tiles + 1)


def least_seconds(evals: int, flops: int, n_bytes: int) -> float:
    """The least time of a kernel: the larger of its operations over the
    f32 peak and its bytes over HBM's."""
    return max(evals * flops / F32_FLOPS_S, n_bytes / HBM_BYTES_S)


def train_step_flops(step: dict) -> float:
    """One train step: the compositor forward and backward, projection
    forward and backward, L1 + SSIM forward and backward, Adam."""
    c = step["colour"]
    return (step["evaluations"] * (FWD_FLOPS[c] + BWD_FLOPS[c])
            + step["n_live"] * (PROJECT_FWD + PROJECT_BWD
                                + ADAM_PER_FLOAT * params_per_gaussian(c))
            + step["pixels"] * 3 * LOSS_PER_PIXEL)


def frame_flops(frame: dict) -> float:
    """One render: projection and the compositor forward."""
    return (frame["evaluations"] * FWD_FLOPS[frame["colour"]]
            + frame["n_live"] * PROJECT_FWD)
