"""The yardstick's peaks and work counts, frozen here so that a change to
the program cannot move them.

Copied from ``gpu_stereo_matching_tpu_torch/bench/roofline.py`` (``bound``,
``fused_sad_work``, ``remap_work``, the peaks) and from the inline counts of
``chip_smoke.py`` for the SAD volume, the argmin and the median. The work is
the function's, whatever implements it: each input byte read once, each
output byte written once, and the operations of its plainest formulation.

Peaks: NVIDIA's H100 SXM data sheet, 3.35e12 bytes a second of HBM3 and
67e12 32-bit operations a second outside the tensor cores. A main path that
moves onto the integer tensor cores could read past 100% of the operations
term; a later benchmark change would then count it against the tensor-core
peak.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound_s(operations: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of operations over
    the operations peak and bytes over the memory peak."""
    return max(operations / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def bound_by(operations: float, nbytes: float) -> str:
    """Which peak sets :func:`bound_s`: ``"operations"`` or ``"bytes"``."""
    return "operations" if operations / PEAK_OPS_PER_S >= nbytes / PEAK_BYTES_PER_S else "bytes"


def fused_sad_work(height: int, width: int, num_disp: int, frames: int = 1) -> tuple:
    """(operations, bytes) of fused SAD + WTA over ``frames`` (H, W) pairs:
    per pixel and disparity 2 operations for the absolute difference, 2 for
    the vertical and 2 for the horizontal running sum, 2 for the (min,
    argmin) update; per pixel 2 bytes in (the u8 pair) and 4 out."""
    px = frames * height * width
    return 8 * num_disp * px, 6 * px


def remap_work(frames: int, n: int, views: int, bgr: bool) -> tuple:
    """(operations, bytes) of the rig's front end over ``views`` views of
    ``frames`` frames of ``n`` output pixels. Per output pixel once: the maps
    (8 bytes), two floors, four subtractions and four compares (10
    operations). Per pixel and frame: 1 (gray) or 3 (BGR) bytes in and 1
    out; the interpolation's 6 multiplies, 3 adds, the rounding and 2 clamps
    (12); from BGR, each of the 4 taps turned into gray first, a multiply,
    two fused multiply-adds, the rounding and 2 clamps (8)."""
    per_frame = 12 + (4 * 8 if bgr else 0)
    return (views * (10 * n + frames * n * per_frame),
            views * (8 * n + frames * n * ((3 if bgr else 1) + 1)))


def sad_volume_work(height: int, width: int, num_disp: int, frames: int = 1) -> tuple:
    """(operations, bytes) of the materialised SAD volume: 6 operations per
    pixel and disparity; 2 bytes in and 4 * D out per pixel."""
    px = frames * height * width
    return 6 * num_disp * px, (2 + 4 * num_disp) * px


def wta_work(height: int, width: int, num_disp: int, volumes: int = 1) -> tuple:
    """(operations, bytes) of the argmin over ``volumes`` (D, H, W) int32
    volumes: a compare and a select per element; the volume in, the int32
    disparities out."""
    px = volumes * height * width
    return 2 * num_disp * px, (4 * num_disp + 4) * px


def median_work(height: int, width: int, radius: int, frames: int = 1) -> tuple:
    """(operations, bytes) of the clipped-window uint8 median by Huang's
    count: 2 (2r + 1) histogram updates and a 32-bin scan per pixel; 1 byte
    in, 1 out."""
    px = frames * height * width
    return (2 * (2 * radius + 1) + 32) * px, 2 * px
