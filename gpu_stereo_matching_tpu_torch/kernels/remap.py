"""Bilinear uint8 remap and the rig's front end: the CUDA kernels of ``csrc/remap.cu``.

The TPU kernel they replace (``remap_bilinear_u8_planned``) sweeps a
host-built offset plan because the TPU cannot gather per pixel; the CUDA
kernels gather their taps directly, so no plan exists here. Two entries:

- :func:`remap_bilinear_u8_direct`, the TPU kernel's contract: (H, W) or
  (B, H, W) uint8 through (Ho, Wo) float32 maps. Plain twin:
  :func:`gpu_stereo_matching_tpu_torch.ops.remap.remap_bilinear_u8`. A
  thread owns 8 output pixels in two groups of 4 adjacent ones, reads their
  maps once and loops over the frames; the C entry takes the vector body (a
  group's maps as 16-byte loads, its bytes as one 4-byte store a frame)
  where Ho * Wo is a multiple of 4 and the maps and the output are aligned,
  else the scalar body; :data:`BODY_LAUNCHES` counts the launches of each.
- :func:`rectify_gray_pair`, the rig's front end: both views' BGR frames to
  rectified gray in one launch of ``front_end_kernel``. Plain twin:
  :func:`gpu_stereo_matching_tpu_torch.ops.remap.rectify_gray_pair`. A block
  owns a tile of :data:`TILE_ROWS` x :data:`TILE_COLS` output pixels of one
  view and reduces its valid taps to the source window they read. Gathering
  each tap's three bytes and turning them into gray loads and converts every
  source pixel about four times, once for each output pixel whose taps touch
  it; so where the window fits the staging budget (:data:`WINDOW_ROWS` x
  :data:`WINDOW_COLS` source pixels) the tile takes the staged path: per
  frame its window's BGR rows are copied into shared memory by ``cp.async``,
  the next frame's in flight, each staged pixel is turned into gray once, and
  every output pixel interpolates four of those levels. Otherwise (wild,
  flipped or strongly distorted maps) the tile gathers, as the kernel did
  before. The choice is per tile, from the maps; :func:`front_end_tiles`
  counts the tiles of each path by the kernel's rule, and
  :func:`front_end_plan` says how a shape launches.

A tensor on the CPU runs the plain twin; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gpu_stereo_matching_tpu_torch.kernels import _build
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import _plan
from gpu_stereo_matching_tpu_torch.ops import remap as plain

# Kernel launches since import (or since a caller reset them to 0): the u8
# remap entry, the front-end entry, and the u8 entry's launches by body.
LAUNCHES = 0
PAIR_LAUNCHES = 0
BODIES = ("scalar", "vector")
BODY_LAUNCHES = dict.fromkeys(BODIES, 0)
_PLAN_FIELDS = ("pixels_per_thread", "threads", "blocks", "blocks_per_sm", "sms",
                "pixels_per_group")
_FRONT_END_PLAN_FIELDS = ("pixels_per_thread", "threads", "blocks", "blocks_per_sm", "sms",
                          "tile_rows", "tile_cols", "frames_per_block", "window_rows",
                          "window_cols", "shared_bytes")
# The front end's tiles and staging budget (csrc/remap.cu kTileRows,
# kTileCols, kWindowRows, kWindowCols).
TILE_ROWS, TILE_COLS = 16, 128
WINDOW_ROWS, WINDOW_COLS = 28, 160


def _check_maps(what: str, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    if map_x.dim() != 2 or map_x.shape != map_y.shape:
        raise ValueError(
            f"{what}: maps must be equal-shape 2-D, got {tuple(map_x.shape)} "
            f"vs {tuple(map_y.shape)}"
        )
    if map_x.dtype != torch.float32 or map_y.dtype != torch.float32:
        raise TypeError(f"{what}: maps must be float32, got {map_x.dtype}/{map_y.dtype}")


def _check(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> None:
    if src.dim() not in (2, 3) or src.dtype != torch.uint8:
        raise ValueError(
            f"remap: expected a (H, W) or (B, H, W) uint8 source, got "
            f"{tuple(src.shape)} {src.dtype}"
        )
    if src.shape[-2] < 2 or src.shape[-1] < 2:
        raise ValueError(f"remap: source {tuple(src.shape)} is smaller than 2x2")
    _check_maps("remap", map_x, map_y)
    if not (src.device == map_x.device == map_y.device):
        raise ValueError(
            f"remap: source on {src.device}, maps on {map_x.device}/{map_y.device}"
        )


def _launch(entry: str, tensors, out: torch.Tensor, shape) -> None:
    """Call C entry ``entry`` on the tensors' pointers and ``shape``, on the
    current stream of ``out``'s device; for the u8 entry, count the body it
    ran."""
    lib = _build.load_library()
    body = ctypes.c_int(-1)
    u8 = entry == "gsm_remap_bilinear_u8"
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), out.data_ptr(), *shape,
                                  *((ctypes.byref(body),) if u8 else ()), stream)
    _build.check(lib, err, entry)
    if u8:
        BODY_LAUNCHES[BODIES[body.value]] += 1


def remap_bilinear_u8_direct(
    src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Remap (H, W) or (B, H, W) uint8 through (Ho, Wo) float32 maps.

    A batch is one launch, which reads the maps once.
    """
    global LAUNCHES
    _check(src, map_x, map_y)
    if src.device.type == "cpu":
        return plain.remap_bilinear_u8(src, map_x, map_y)
    _build.require_cuda(src, "remap")
    if not (src.is_contiguous() and map_x.is_contiguous() and map_y.is_contiguous()):
        raise ValueError("remap: source and maps must be contiguous")
    batched = src if src.dim() == 3 else src[None]
    b, hs, ws = batched.shape
    ho, wo = map_x.shape
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=src.device)
    _launch("gsm_remap_bilinear_u8", (batched, map_x, map_y), out, (b, hs, ws, ho, wo))
    LAUNCHES += 1
    return out if src.dim() == 3 else out[0]


def rectify_gray_pair(
    left_bgr: torch.Tensor,
    right_bgr: torch.Tensor,
    left_map_x: torch.Tensor,
    left_map_y: torch.Tensor,
    right_map_x: torch.Tensor,
    right_map_y: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' (H, W, 3) or (B, H, W, 3) uint8 BGR frames -> their
    block-matching gray, remapped through each view's (Ho, Wo) float32 maps:
    two (Ho, Wo) or (B, Ho, Wo) uint8 tensors, views of one output.

    On the card, one launch for both views and every frame.
    """
    global PAIR_LAUNCHES
    if (left_bgr.dim() not in (3, 4) or left_bgr.shape[-1] != 3
            or left_bgr.dtype != torch.uint8 or right_bgr.shape != left_bgr.shape
            or right_bgr.dtype != torch.uint8):
        raise ValueError(
            f"rectify_gray_pair: expected two equal (H, W, 3) or (B, H, W, 3) uint8 BGR "
            f"batches, got {tuple(left_bgr.shape)} {left_bgr.dtype} and "
            f"{tuple(right_bgr.shape)} {right_bgr.dtype}"
        )
    if left_bgr.shape[-3] < 2 or left_bgr.shape[-2] < 2:
        raise ValueError(f"rectify_gray_pair: frames {tuple(left_bgr.shape)} are smaller than 2x2")
    _check_maps("rectify_gray_pair", left_map_x, left_map_y)
    _check_maps("rectify_gray_pair", right_map_x, right_map_y)
    if left_map_x.shape != right_map_x.shape:
        raise ValueError(
            f"rectify_gray_pair: the views' maps differ in shape, {tuple(left_map_x.shape)} "
            f"vs {tuple(right_map_x.shape)}"
        )
    tensors = (left_bgr, right_bgr, left_map_x, left_map_y, right_map_x, right_map_y)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"rectify_gray_pair: tensors on several devices: {[str(t.device) for t in tensors]}"
        )
    if left_bgr.device.type == "cpu":
        return plain.rectify_gray_pair(*tensors)
    _build.require_cuda(left_bgr, "rectify_gray_pair")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rectify_gray_pair: frames and maps must be contiguous")
    b = left_bgr.shape[0] if left_bgr.dim() == 4 else 1
    hs, ws = left_bgr.shape[-3:-1]
    ho, wo = left_map_x.shape
    out = torch.empty((2, b, ho, wo), dtype=torch.uint8, device=left_bgr.device)
    _launch("gsm_rectify_gray_pair", tensors, out, (b, hs, ws, ho, wo))
    PAIR_LAUNCHES += 1
    if left_bgr.dim() == 3:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


def _tile_windows(map_x: torch.Tensor, map_y: torch.Tensor, frame_hw) -> torch.Tensor:
    """Whether each (TILE_ROWS, TILE_COLS) tile of one view takes the staged
    path, by ``front_end_kernel``'s rule: its valid taps' floors span at most
    WINDOW_ROWS - 1 rows and WINDOW_COLS - 1 columns (the taps below and to
    the right make the window), and it has one. (tiles_y, tiles_x) bool."""
    hs, ws = frame_hw
    ho, wo = map_x.shape
    ty, tx = -(-ho // TILE_ROWS), -(-wo // TILE_COLS)

    def tiles(m, fill):
        m = torch.nn.functional.pad(m, (0, tx * TILE_COLS - wo, 0, ty * TILE_ROWS - ho),
                                    value=fill)
        return m.reshape(ty, TILE_ROWS, tx, TILE_COLS).transpose(1, 2).reshape(ty, tx, -1)

    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    valid = (x0 >= 0) & (y0 >= 0) & (x0 <= ws - 2) & (y0 <= hs - 2)
    inf = float("inf")
    span = []
    for f in (x0, y0):
        hi = tiles(torch.where(valid, f, -inf), -inf).amax(-1)
        lo = tiles(torch.where(valid, f, inf), inf).amin(-1)
        span.append(hi - lo + 2)
    any_valid = tiles(valid.float(), 0.0).amax(-1) > 0
    return any_valid & (span[1] <= WINDOW_ROWS) & (span[0] <= WINDOW_COLS)


def front_end_tiles(frame_hw, left_map_x: torch.Tensor, left_map_y: torch.Tensor,
                    right_map_x: torch.Tensor, right_map_y: torch.Tensor) -> dict:
    """The front end's tiles over both views' maps of (H, W) = ``frame_hw``
    sources: ``staged`` (the window fits the staging budget), ``gathered``
    (it does not, or no tap of the tile is valid) and ``staged_share`` in
    %. On a card ``front_end_tiles_kernel`` counts them by the kernel's own
    rule (one launch, then a synchronizing read); on the CPU its mirror."""
    maps = (left_map_x, left_map_y, right_map_x, right_map_y)
    for x, y in (maps[:2], maps[2:]):
        _check_maps("front_end_tiles", x, y)
    if left_map_x.shape != right_map_x.shape or len({m.device for m in maps}) != 1:
        raise ValueError("front_end_tiles: the views' maps differ in shape or device")
    if left_map_x.device.type == "cpu":
        staged = sum(int(_tile_windows(x, y, frame_hw).sum()) for x, y in (maps[:2], maps[2:]))
        total = 2 * -(-left_map_x.shape[0] // TILE_ROWS) * -(-left_map_x.shape[1] // TILE_COLS)
        gathered = total - staged
    else:
        _build.require_cuda(left_map_x, "front_end_tiles")
        if not all(m.is_contiguous() for m in maps):
            raise ValueError("front_end_tiles: maps must be contiguous")
        lib = _build.load_library()
        counts = torch.zeros(2, dtype=torch.int32, device=left_map_x.device)
        with torch.cuda.device(counts.device):
            err = lib.gsm_front_end_tiles(*(m.data_ptr() for m in maps), *frame_hw,
                                          *left_map_x.shape, counts.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "gsm_front_end_tiles")
        staged, gathered = counts.tolist()
    return {"staged": staged, "gathered": gathered,
            "staged_share": 100.0 * staged / (staged + gathered)}


def front_end_plan(frame_hw, map_hw, batch: int = 1, views: int = 2, device="cuda",
                   maps=None) -> dict:
    """How a launch runs on ``device`` for (``batch``, *``frame_hw``)
    sources and ``map_hw`` maps: ``views=2`` the front end, ``views=1`` the
    u8 entry (with aligned allocations). Both give the body, the output
    pixels a thread owns, threads per block, blocks, blocks an SM holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the SMs and
    ``waves`` = blocks / (blocks_per_sm * sms); the u8 entry the adjacent
    pixels of a group; the front end its tile (``tile_rows`` x
    ``tile_cols``), the frames a block runs (``frames_per_block``; the
    frames split into groups only where the tiles would not fill the card),
    the staging budget (``window_rows`` x ``window_cols`` source pixels) and
    the block's ``shared_bytes``. Given both views' ``maps`` (left x, left
    y, right x, right y on ``device``), the front end's plan adds
    :func:`front_end_tiles`' counts as ``staged_tiles``, ``gathered_tiles``
    and ``staged_share``."""
    if views == 1:
        return _plan("gsm_remap_plan", (batch, *frame_hw, *map_hw), device, BODIES,
                     _PLAN_FIELDS)
    if views != 2:
        raise ValueError(f"front_end_plan: views must be 1 or 2, got {views}")
    plan = _plan("gsm_front_end_plan", (batch, *frame_hw, *map_hw), device, ("tiled",),
                 _FRONT_END_PLAN_FIELDS)
    if maps is not None:
        tiles = front_end_tiles(frame_hw, *maps)
        plan.update(staged_tiles=tiles["staged"], gathered_tiles=tiles["gathered"],
                    staged_share=tiles["staged_share"])
    return plan
