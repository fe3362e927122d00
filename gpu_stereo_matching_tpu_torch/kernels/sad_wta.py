"""Fused SAD + WTA block matching: the CUDA kernels ``csrc/sad_wta.cu``
(whole disparity range -> disparity) and ``csrc/sad_wta_key.cu`` (a partial
range -> packed keys, for a disparity-sharded mesh) and their plain torch
twins.

All reproduce the fused TPU kernel of
``gpu_stereo_matching_tpu/kernels/sad_wta.py``, whose invalid columns
(``x < d``) cost the full-window constant ``255 * (2r + 1)`` after the
vertical sum, even at the top and bottom ``r`` rows. The unfused ops path
(``models/block_matching.py``) charges ``255 *`` the clipped row count
there instead, so the two can pick different disparities within ``r`` rows
of the border; each side here is held to its own JAX counterpart.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises. Each kernel has two hand-written bodies: the strip body of
``csrc/sad_strips.cuh`` (radius 1..7), which both sources instantiate, and a
general body (every other radius up to 112). The choice is made in C, from
``(num_disparities, radius)`` alone for the whole-range kernel and from
``(count, total_disparities, radius)`` alone for the key kernel;
:func:`kernel_body` and :func:`launch_plan`, :func:`key_kernel_body` and
:func:`key_launch_plan` say which one a shape takes and how it is launched.

``fused_block_matching(..., mxu=True)`` is JAX's banded matrix-unit body
(``_packed_pair_body_mxu``): the same integers, with the vertical window sum
as a product by a 0/1 band. On a CUDA tensor it launches the integer
tensor-core kernel ``csrc/sad_wta_mma.cu`` (``mma.sync`` on u8), which takes
the horizontal sum as a band product too, over V's two byte planes; its
plain twin, :func:`fused_block_matching_mma_reference`, repeats both
products in float64. Like JAX's, it serves the packed-pair configurations
only (:func:`_packed_pair_supported`).
"""

from __future__ import annotations

import ctypes

import torch

from gpu_stereo_matching_tpu_torch.core.validation import check_gray_pair
from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.ops.aggregate import box_filter_sum

# Kernel launches since import (or since a caller reset them to 0): the
# whole-range kernel, the partial-range key kernel and the tensor-core kernel.
LAUNCHES = 0
KEY_LAUNCHES = 0
MMA_LAUNCHES = 0

# The general bodies' blocks are 128 or 256 threads wide, 2r + 32 of them at
# least.
MAX_RADIUS = 112


def _abs_diff(li, ri, d: int) -> torch.Tensor:
    """|L(x) - R(x - d)|, 0 where x < d."""
    w = li.shape[-1]
    diff = torch.zeros_like(li)
    diff[..., d:] = (li[..., d:] - ri[..., : w - d]).abs()
    return diff


def _horizontal_sad(v, col, d: int, radius: int) -> torch.Tensor:
    """The fused formula after the vertical sum ``v`` (int32): columns
    ``x < d`` cost ``255 * (2r + 1)``, then the clipped horizontal sum."""
    v = torch.where(col < d, 255 * (2 * radius + 1), v)
    return box_filter_sum(v, radius, dims=(-1,))


def _fused_sad(li, ri, col, d: int, radius: int) -> torch.Tensor:
    """SAD map of one disparity by the fused formula, int32 in and out."""
    v = box_filter_sum(_abs_diff(li, ri, d), radius, dims=(-2,))
    return _horizontal_sad(v, col, d, radius)


def _winner_take_all(shape, device, num_disparities: int, sad_of) -> torch.Tensor:
    """Argmin over ``0 <= d < num_disparities`` of ``sad_of(d)`` (int32,
    ``shape``), ties to the smallest d."""
    best = torch.full(shape, torch.iinfo(torch.int32).max, dtype=torch.int32, device=device)
    best_d = torch.zeros(shape, dtype=torch.int32, device=device)
    for d in range(num_disparities):
        sad = sad_of(d)
        upd = sad < best
        best = torch.where(upd, sad, best)
        best_d = torch.where(upd, d, best_d)
    return best_d


def fused_block_matching_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the kernel: (..., H, W) uint8 -> (..., H, W) int32."""
    li = left_gray.to(torch.int32)
    ri = right_gray.to(torch.int32)
    col = torch.arange(left_gray.shape[-1], device=left_gray.device)
    return _winner_take_all(li.shape, left_gray.device, num_disparities,
                            lambda d: _fused_sad(li, ri, col, d, radius))


# Rows of a tile and of a warp of the tensor-core kernel (csrc/sad_wta_mma.cu),
# and of its twin's vertical band product; output columns of a warp, and of
# its twin's horizontal band product; rows of an m16n8k32 product (a row
# half of a warp); n-tile width.
MMA_TILE_H = 32
MMA_WARP_W = 64
MMA_M = 16
MMA_N = 8


def _packed_pair_supported(num_disparities: int, radius: int) -> bool:
    """Whether the configuration is packed-pair, as JAX's function says:
    two disparities a pass need an even count, the packed key needs ``d``
    in 8 bits, and a 16-bit half must hold a full window of invalid costs
    (``255 * (2r + 1)**2 < 2**15``, r = 1..5). The ``mxu`` variant takes
    these configurations only."""
    k = 2 * radius + 1
    return (
        num_disparities % 2 == 0
        and num_disparities <= 256
        and radius >= 1
        and 255 * k * k < (1 << 15)
    )


def _banded_vertical_matrix(tile_h: int, halo_rows: int, k: int, dtype=torch.float64,
                            device=None) -> torch.Tensor:
    """(tile_h, halo_rows) 0/1 band: row i sums input rows [i, i + k)."""
    ri = torch.arange(tile_h, device=device)[:, None]
    ci = torch.arange(halo_rows, device=device)[None, :]
    return ((ci >= ri) & (ci < ri + k)).to(dtype)


def _horizontal_band_product(v: torch.Tensor, band: torch.Tensor, radius: int) -> torch.Tensor:
    """``v`` (..., H, W) summed along rows over each column's window by the
    kernel's per-warp band product: ``64 + 2r`` columns a tile (0 outside
    the image) times the ``(64 + 2r, 64)`` band."""
    w = v.shape[-1]
    tiles = -(-w // MMA_WARP_W)
    padded = torch.nn.functional.pad(v, (radius, tiles * MMA_WARP_W - w + radius))
    slabs = padded.unfold(-1, MMA_WARP_W + 2 * radius, MMA_WARP_W)  # (..., H, tiles, 64 + 2r)
    out = slabs @ band                                               # (..., H, tiles, 64)
    return out.reshape(*out.shape[:-2], tiles * MMA_WARP_W)[..., :w]


def fused_block_matching_mma_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the tensor-core kernel: (..., H, W) uint8 ->
    (..., H, W) int32, by the kernel's arithmetic in float64 (exact: every
    product and sum is an integer below 2**15). Per 32-row tile the vertical
    sum is ``band @ diff`` over the tile's ``32 + 2r`` halo rows (rows
    outside the image 0); the columns ``x < d`` take the invalid constant
    ``255 * (2r + 1)``; then V's two byte planes, ``V % 256`` and ``V //
    256``, each go through the horizontal band product of 64-column tiles,
    and ``SAD = lo + 256 hi``; then the argmin of
    :func:`fused_block_matching_reference`."""
    h, w = left_gray.shape[-2:]
    r, dev = radius, left_gray.device
    tiles = -(-h // MMA_TILE_H)
    halo = MMA_TILE_H + 2 * r
    vband = _banded_vertical_matrix(MMA_TILE_H, halo, 2 * r + 1, device=dev)
    hband = _banded_vertical_matrix(MMA_WARP_W, MMA_WARP_W + 2 * r, 2 * r + 1, device=dev).T
    rows = (0, 0, r, tiles * MMA_TILE_H - h + r)
    lp = torch.nn.functional.pad(left_gray.to(torch.float64), rows)
    rp = torch.nn.functional.pad(right_gray.to(torch.float64), rows)
    col = torch.arange(w, device=dev)
    invalid = float(255 * (2 * r + 1))

    def sad_of(d):
        slabs = _abs_diff(lp, rp, d).unfold(-2, halo, MMA_TILE_H)  # (..., tiles, W, halo)
        v = vband @ slabs.transpose(-1, -2)                         # (..., tiles, 32, W)
        v = v.reshape(*v.shape[:-3], tiles * MMA_TILE_H, w)[..., :h, :]
        v = torch.where(col < d, invalid, v)
        hi = torch.div(v, 256, rounding_mode="floor")
        lo = v - 256 * hi
        sad = _horizontal_band_product(lo, hband, r) + 256 * _horizontal_band_product(hi, hband, r)
        return sad.to(torch.int32)

    return _winner_take_all(left_gray.shape, dev, num_disparities, sad_of)


def _launch(left: torch.Tensor, right: torch.Tensor, num_disparities: int,
            radius: int) -> torch.Tensor:
    global LAUNCHES
    _build.require_cuda(left, "fused block matching")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("fused block matching: inputs must be contiguous")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"fused block matching: radius {radius} not in [0, {MAX_RADIUS}]")
    lib = _build.load_library()
    b, h, w = left.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_wta_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            b, h, w, num_disparities, radius, stream,
        )
    _build.check(lib, err, "gsm_sad_wta_u8")
    LAUNCHES += 1
    return out


def _launch_mma(left: torch.Tensor, right: torch.Tensor, num_disparities: int,
                radius: int) -> torch.Tensor:
    global MMA_LAUNCHES
    _build.require_cuda(left, "fused block matching (mxu)")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("fused block matching (mxu): inputs must be contiguous")
    lib = _build.load_library()
    b, h, w = left.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_wta_mma_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            b, h, w, num_disparities, radius, stream,
        )
    _build.check(lib, err, "gsm_sad_wta_mma_u8")
    MMA_LAUNCHES += 1
    return out


BODIES = ("general", "strips")
_PLAN_FIELDS = ("tile_rows", "tile_cols", "threads", "blocks", "blocks_per_sm", "sms")


def kernel_body(num_disparities: int, radius: int) -> str:
    """Which body of the CUDA kernel ``(num_disparities, radius)`` runs:
    ``"strips"`` or ``"general"``. Builds the library; needs no card."""
    return BODIES[_build.load_library().gsm_sad_wta_body(num_disparities, radius)]


def _plan(entry: str, args, device, bodies=BODIES, names=_PLAN_FIELDS) -> dict:
    """The plan that C entry ``entry`` fills for ``args`` on ``device``;
    its first field indexes ``bodies``, the others are ``names``."""
    lib = _build.load_library()
    fields = (ctypes.c_int * (1 + len(names)))()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, fields)
    _build.check(lib, err, entry)
    plan = {"body": bodies[fields[0]], **dict(zip(names, fields[1:]))}
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


def launch_plan(shape, num_disparities: int, radius: int, device="cuda") -> dict:
    """How the kernel launches for a ``(B, H, W)`` batch on ``device``: its
    body, tile, threads per block, blocks, and the blocks an SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) beside the SM count,
    from which ``waves`` = blocks / (blocks_per_sm * sms)."""
    return _plan("gsm_sad_wta_plan", (*shape, num_disparities, radius), device)


def mma_launch_plan(shape, num_disparities: int, radius: int, device="cuda") -> dict:
    """:func:`launch_plan` for the tensor-core kernel (one body, ``"mma"``),
    with the dynamic shared memory a block takes (``shared_bytes``)."""
    return _plan("gsm_sad_wta_mma_plan", (*shape, num_disparities, radius), device,
                 bodies=("mma",), names=_PLAN_FIELDS + ("shared_bytes",))


def mma_tensor_ops(shape, num_disparities: int, radius: int) -> int:
    """Tensor-core operations (2 a u8 multiply-add, band zeros included) that
    the tensor-core kernel issues for a ``(B, H, W)`` batch: per warp of
    32 x 64 outputs that holds a pixel of the image, per disparity and per
    16-row half, one m16n8k32 product per 8-column n-tile of its ``64 + 2r``
    V columns (the vertical sum) and two per output n-tile (the horizontal
    sum over V's two byte planes)."""
    b, h, w = shape
    halves = b * -(-h // MMA_TILE_H) * -(-w // MMA_WARP_W) * (MMA_TILE_H // MMA_M)
    vertical = -(-(MMA_WARP_W + 2 * radius) // MMA_N)
    horizontal = 2 * (MMA_WARP_W // MMA_N)
    return halves * num_disparities * (vertical + horizontal) * (2 * MMA_M * MMA_N * 32)


def key_kernel_body(count: int, total_disparities: int, radius: int) -> str:
    """Which body of the key kernel a range of ``count`` of
    ``total_disparities`` runs at ``radius``: ``"strips"`` or ``"general"``.
    Builds the library; needs no card."""
    return BODIES[_build.load_library().gsm_sad_key_body(count, total_disparities, radius)]


def key_launch_plan(shape, count: int, total_disparities: int, radius: int,
                    device="cuda") -> dict:
    """:func:`launch_plan` for the key kernel over a range of ``count`` of
    ``total_disparities`` (where the range starts does not change it): the
    strip body's shared memory shrinks with ``count``, so the blocks an SM
    holds are asked per ``count``."""
    return _plan("gsm_sad_key_plan", (*shape, count, total_disparities, radius), device)


def fused_block_matching(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
    mxu: bool = False,
) -> torch.Tensor:
    """Disparity of a (H, W) uint8 pair -> (H, W) int32.

    ``mxu=True`` (packed-pair configurations only, else ``ValueError``)
    computes both window sums on the tensor cores
    (``csrc/sad_wta_mma.cu``); the integers are the same."""
    check_gray_pair(left_gray, right_gray, num_disparities, "fused_block_matching")
    if mxu and not _packed_pair_supported(num_disparities, radius):
        raise ValueError("mxu variant requires a packed-pair config")
    if left_gray.dim() != 2:
        raise ValueError("fused_block_matching: expected (H, W); use the batched form")
    if left_gray.device.type == "cpu":
        plain = fused_block_matching_mma_reference if mxu else fused_block_matching_reference
        return plain(left_gray, right_gray, num_disparities, radius)
    launch = _launch_mma if mxu else _launch
    return launch(left_gray[None], right_gray[None], num_disparities, radius)[0]


def fused_block_matching_batched(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    num_disparities: int = 64,
    radius: int = 5,
) -> torch.Tensor:
    """Disparities of (B, H, W) uint8 pairs -> (B, H, W) int32, one launch."""
    check_gray_pair(left_gray, right_gray, num_disparities, "fused_block_matching_batched")
    if left_gray.dim() != 3:
        raise ValueError("fused_block_matching_batched: expected (B, H, W)")
    if left_gray.device.type == "cpu":
        return fused_block_matching_reference(left_gray, right_gray, num_disparities, radius)
    return _launch(left_gray, right_gray, num_disparities, radius)


def fused_block_matching_key_reference(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    d_start: int,
    count: int,
    total_disparities: int,
    radius: int = 5,
) -> torch.Tensor:
    """Plain torch twin of the key kernel: (..., H, W) uint8 -> (..., H, W)
    int32, the minimum over ``d_start <= d < d_start + count`` of
    ``SAD(d) * total_disparities + d``."""
    li = left_gray.to(torch.int32)
    ri = right_gray.to(torch.int32)
    col = torch.arange(left_gray.shape[-1], device=left_gray.device)
    best = torch.full(li.shape, torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=left_gray.device)
    for d in range(d_start, d_start + count):
        sad = _fused_sad(li, ri, col, d, radius)
        best = torch.minimum(best, sad * total_disparities + d)
    return best


def _launch_key(left: torch.Tensor, right: torch.Tensor, d_start: int, count: int,
                total_disparities: int, radius: int) -> torch.Tensor:
    global KEY_LAUNCHES
    _build.require_cuda(left, "fused_block_matching_key")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("fused_block_matching_key: inputs must be contiguous")
    if radius > MAX_RADIUS:
        raise ValueError(
            f"fused_block_matching_key: the kernel takes radius <= {MAX_RADIUS}, got {radius}"
        )
    lib = _build.load_library()
    b, h, w = left.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=left.device)
    with torch.cuda.device(left.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gsm_sad_key_u8(
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            b, h, w, d_start, count, total_disparities, radius, stream,
        )
    _build.check(lib, err, "gsm_sad_key_u8")
    KEY_LAUNCHES += 1
    return out


def fused_block_matching_key(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    d_start: int,
    count: int,
    total_disparities: int,
    radius: int = 5,
) -> torch.Tensor:
    """Partial-range WTA of a (H, W) or (B, H, W) uint8 pair -> int32 keys of
    the same shape: the minimum over ``d_start <= d < d_start + count`` of
    ``SAD(d) * total_disparities + d``, SAD by the fused formula.

    It is what one shard of a disparity-sharded mesh computes: the
    elementwise minimum of the shards' keys, taken ``% total_disparities``,
    is the disparity over the whole range with ties to the smallest d. A
    batch is one launch. The image's top and bottom rows are its borders; a
    caller that passes a slab with halo rows crops them itself.

    ``d_start`` is a plain int. Raises ``ValueError`` when the range leaves
    ``[0, total_disparities)`` or when the largest key,
    ``255 * (2r + 1)**2 * total_disparities + total_disparities``, does not
    fit int32 (the JAX function checks neither and would wrap there).
    """
    what = "fused_block_matching_key"
    check_gray_pair(left_gray, right_gray, total_disparities, what)
    if radius < 0:
        raise ValueError(f"{what}: radius {radius} < 0")
    if count < 1 or d_start < 0 or d_start + count > total_disparities:
        raise ValueError(
            f"{what}: range [{d_start}, {d_start + count}) is empty or leaves "
            f"[0, {total_disparities})"
        )
    k = 2 * radius + 1
    if 255 * k * k * total_disparities + total_disparities >= 2**31:
        raise ValueError(
            f"{what}: a key of radius {radius} and {total_disparities} disparities "
            "does not fit int32"
        )
    if left_gray.device.type == "cpu":
        return fused_block_matching_key_reference(
            left_gray, right_gray, d_start, count, total_disparities, radius
        )
    if left_gray.dim() == 2:
        return _launch_key(left_gray[None], right_gray[None], d_start, count,
                           total_disparities, radius)[0]
    return _launch_key(left_gray, right_gray, d_start, count, total_disparities, radius)
