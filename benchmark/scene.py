"""Seeded stereo frames: the one generator that every traffic mix's
``scene`` parameters drive.

A frame pair is a textured scene seen by both cameras: the right view is a
sum of value noise at the mix's ``texture_scales`` (pixels a cell), with a
shared luminance and a colour offset per channel, plus pixel noise of
``noise_level`` grey levels; the left view is the right one shifted by a
known disparity field, a ramp across the background in
``background_disparity`` with ``objects`` rectangles (each side a share
``object_size_frac`` of the image) at a disparity drawn from
``object_disparity``, all capped at ``max_disparity``. Every call of the
kernels does the same work whatever the content; the content keeps the LR
check's and the median's inputs those of a real scene.

Everything is drawn on ``device`` from one ``torch.Generator`` seeded by
``seed``, in a few large calls: the same seed gives the same frames on the
same kind of device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _value_noise(g, frames: int, channels: int, hw, cell: int, device) -> torch.Tensor:
    """(frames, channels, H, W) noise in [-1, 1], smooth over ``cell`` pixels."""
    h, w = hw
    coarse = _uniform(g, (frames, channels, h // cell + 2, w // cell + 2), -1.0, 1.0, device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)


def disparity_field(g, frames: int, hw, scene: dict, device) -> torch.Tensor:
    """(frames, H, W) int64 disparities of the mix's scene."""
    h, w = hw
    lo, hi = scene["background_disparity"]
    ends = _uniform(g, (frames, 2), lo, hi, device)
    x = torch.linspace(0.0, 1.0, w, device=device)
    field = ends[:, :1, None] + (ends[:, 1:, None] - ends[:, :1, None]) * x[None, None, :]
    field = field.expand(frames, h, w).clone()
    n_lo, n_hi = scene["objects"]
    count = int(n_hi)
    boxes = torch.rand((frames, count, 5), generator=g, device=device)
    present = torch.arange(count, device=device)[None, :] < torch.randint(
        n_lo, n_hi + 1, (frames, 1), generator=g, device=device)
    s_lo, s_hi = scene["object_size_frac"]
    d_lo, d_hi = scene["object_disparity"]
    ys = torch.arange(h, device=device)[None, :, None]
    xs = torch.arange(w, device=device)[None, None, :]
    for k in range(count):
        bh = (s_lo + (s_hi - s_lo) * boxes[:, k, 0]) * h
        bw = (s_lo + (s_hi - s_lo) * boxes[:, k, 1]) * w
        y0 = boxes[:, k, 2] * (h - bh)
        x0 = boxes[:, k, 3] * (w - bw)
        d = d_lo + (d_hi - d_lo) * boxes[:, k, 4]
        inside = ((ys >= y0[:, None, None]) & (ys < (y0 + bh)[:, None, None])
                  & (xs >= x0[:, None, None]) & (xs < (x0 + bw)[:, None, None])
                  & present[:, k, None, None])
        field = torch.where(inside, torch.maximum(field, d[:, None, None]), field)
    return field.round().clamp(0, scene["max_disparity"]).long()


def frame_pairs(g, frames: int, hw, scene: dict, device) -> tuple:
    """(left, right): two (frames, H, W, 3) uint8 BGR batches, contiguous."""
    h, w = hw
    luma = sum(_value_noise(g, frames, 1, hw, cell, device) for cell in scene["texture_scales"])
    chroma = 0.25 * _value_noise(g, frames, 3, hw, max(scene["texture_scales"]), device)
    right = 128.0 + 40.0 * (luma + chroma)
    right = right + _uniform(g, right.shape, -1.0, 1.0, device) * scene["noise_level"]
    right = right.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    disp = disparity_field(g, frames, hw, scene, device)
    src = (torch.arange(w, device=device)[None, None, :] - disp).clamp(min=0)
    left = torch.gather(right, 2, src[..., None].expand(frames, h, w, 3)).contiguous()
    return left, right


def frame_pool(seed: int, batch: int, pool_batches: int, hw, scene: dict, device) -> list:
    """``pool_batches`` (left, right) batches of ``batch`` pairs made from
    ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [frame_pairs(g, batch, hw, scene, device) for _ in range(pool_batches)]


def cell_pool(config: dict, mix: dict, seed: int, device) -> list:
    """The frame pool of a cell: the mix's batches at the configuration's
    size, in the device's memory."""
    return frame_pool(seed, mix["batch"], mix["pool_batches"], config["image_hw"],
                      mix["scene"], device)
