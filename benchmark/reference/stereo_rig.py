"""Plain PyTorch reference of the calibrated rig: BGR -> block-matching gray
-> bilinear remap -> fused SAD + WTA, or the post-filtered "bm+" matcher
(SAD volume, both argmins, the right view, the LR check, the median).

Written for the benchmark from the semantics the rig states, and independent
of the program: it imports nothing of it and takes nothing it made. Each
float operation is its own torch operation, so nothing is contracted into a
fused multiply-add, and every sum is an exact integer. It runs on any
device, a frame at a time, with every disparity of the frame in one volume.

``front_end_dtype`` is the precision of the bilinear interpolation: float32
is the configuration's; ``torch.bfloat16`` is the control, the nearest
precision below it, which the comparison has to fail.
"""

from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.rectify import rectification_maps_from_calibration

INT32_MAX = torch.iinfo(torch.int32).max
# Block-matching gray: the Rec.601 weights applied to (B, G, R) in storage
# order, each product and partial sum rounded once to float32, then rounded
# half to even.
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def maps(config: dict) -> tuple:
    """The rig's four float32 maps (left x, left y, right x, right y) from the
    configuration's calibration, as NumPy arrays."""
    c = config["calibration"]
    calib = types.SimpleNamespace(**{k: np.asarray(v, np.float64) for k, v in c.items()})
    (lx, ly), (rx, ry) = rectification_maps_from_calibration(calib, tuple(config["image_hw"]))
    return lx, ly, rx, ry


def gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., H, W) uint8 block-matching gray."""
    w = np.asarray(GRAY_WEIGHTS, np.float32).astype(np.float64)
    c = bgr.to(torch.float64)
    acc = (c[..., 0] * float(w[0])).to(torch.float32)
    for k in (1, 2):
        acc = (c[..., k] * float(w[k]) + acc.to(torch.float64)).to(torch.float32)
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)


def remap(src: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          dtype=torch.float32) -> torch.Tensor:
    """Bilinear remap of an (H, W) uint8 image through (H, W) float32 maps.
    A pixel whose four taps are not all inside the image is 0; the result
    is rounded half to even and saturated to uint8."""
    h, w = src.shape
    x0f, y0f = torch.floor(map_x), torch.floor(map_y)
    inside = (x0f >= 0) & (y0f >= 0) & (x0f <= w - 2) & (y0f <= h - 2)
    x0 = torch.where(inside, x0f, 0.0).long()
    y0 = torch.where(inside, y0f, 0.0).long()
    flat = src.reshape(-1).to(dtype)
    at = y0 * w + x0
    q11, q12, q21, q22 = flat[at], flat[at + 1], flat[at + w], flat[at + w + 1]
    fx = (map_x - x0f).to(dtype)
    fy = (map_y - y0f).to(dtype)
    top = (1.0 - fy) * ((1.0 - fx) * q11 + fx * q12)
    bottom = fy * ((1.0 - fx) * q21 + fx * q22)
    out = torch.where(inside, (top + bottom).to(torch.float32), 0.0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _box(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Sum over the clipped window ``[i - r, i + r]`` along ``dim`` (int32)."""
    n = x.shape[dim]
    c = torch.cumsum(x, dim=dim, dtype=torch.int32)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    c = torch.cat([zero, c], dim=dim)
    i = torch.arange(n, device=x.device)
    hi = torch.clamp(i + radius + 1, max=n)
    lo = torch.clamp(i - radius, min=0)
    return c.index_select(dim, hi) - c.index_select(dim, lo)


def _abs_diff_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                     invalid: int) -> torch.Tensor:
    """(D, H, W) int32 ``|L(y, x) - R(y, x - d)|``, ``invalid`` where x < d."""
    h, w = left.shape
    li, ri = left.to(torch.int32), right.to(torch.int32)
    vol = torch.full((num_disp, h, w), invalid, dtype=torch.int32, device=left.device)
    for d in range(num_disp):
        vol[d, :, d:] = (li[:, d:] - ri[:, : w - d]).abs()
    return vol


def fused_disparity(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                    radius: int) -> torch.Tensor:
    """The fused matcher's disparity of an (H, W) uint8 pair: the vertical
    clipped sum of the absolute differences (0 where x < d), then columns
    x < d cost the full-window constant ``255 (2r + 1)``, then the clipped
    horizontal sum; the argmin over d, ties to the smallest."""
    w = left.shape[-1]
    v = _box(_abs_diff_volume(left, right, num_disp, 0), radius, 1)
    col = torch.arange(w, device=left.device)
    d = torch.arange(num_disp, device=left.device)
    v = torch.where((col[None, :] < d[:, None])[:, None, :], 255 * (2 * radius + 1), v)
    return torch.argmin(_box(v, radius, 2), dim=0).to(torch.int32)


def _median_u8(x: torch.Tensor, radius: int) -> torch.Tensor:
    """The ``(n // 2 + 1)``-th smallest of each clipped (2r + 1)**2 window of
    an (H, W) uint8 image, ``n`` the pixels of the window inside the image."""
    h, w = x.shape
    k = 2 * radius + 1
    big = 1 << 12  # above every uint8 value: pads sort last
    xp = F.pad(x.to(torch.int16)[None, None], (radius,) * 4, value=big)[0, 0]
    stack = torch.stack([xp[dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)])
    stack = torch.sort(stack, dim=0).values
    ones = torch.ones((h, w), dtype=torch.int32, device=x.device)
    n = _box(_box(ones, radius, 0), radius, 1)
    return torch.gather(stack, 0, (n // 2).long()[None])[0].to(torch.uint8)


def plus_disparity(left: torch.Tensor, right: torch.Tensor, config: dict) -> torch.Tensor:
    """The post-filtered matcher's disparity of an (H, W) uint8 pair."""
    num_disp, radius = config["num_disparities"], config["sad_radius"]
    sad = _box(_box(_abs_diff_volume(left, right, num_disp, config["invalid_cost"]),
                    radius, 1), radius, 2)
    disp = torch.argmin(sad, dim=0).to(torch.int32)
    if config["lr_consistency"]:
        _, h, w = sad.shape
        # Right view: right(d, y, x) = left(d, y, x + d), INT32_MAX past the image.
        src = torch.arange(w, device=sad.device)[None, :] + torch.arange(num_disp, device=sad.device)[:, None]
        sad_r = torch.gather(sad, 2, src.clamp(max=w - 1)[:, None, :].expand(num_disp, h, w))
        sad_r.masked_fill_((src > w - 1)[:, None, :], INT32_MAX)
        del sad
        disp_r = torch.argmin(sad_r, dim=0).to(torch.int32)
        del sad_r
        x = torch.arange(w, device=disp.device)[None, :]
        at = x - disp
        dr = torch.gather(disp_r, 1, at.clamp(0, w - 1))
        ok = (disp > 0) & (at >= 0) & ((disp - dr).abs() <= config["lr_max_diff"])
        disp = torch.where(ok, disp, 0)
    if config["median_radius"] > 0:
        disp = _median_u8(disp.to(torch.uint8), config["median_radius"]).to(torch.int32)
    return disp


def disparities(config: dict, rig_maps, left_bgr: torch.Tensor, right_bgr: torch.Tensor,
                front_end_dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR batches -> (B, H, W) int32 disparities on the
    device of ``rig_maps`` (four (H, W) float32 tensors), frame by frame."""
    lx, ly, rx, ry = rig_maps
    out = []
    for lb, rb in zip(left_bgr, right_bgr):
        lb, rb = lb.to(lx.device), rb.to(lx.device)
        gl = remap(gray(lb), lx, ly, front_end_dtype)
        gr = remap(gray(rb), rx, ry, front_end_dtype)
        if config["fused"]:
            out.append(fused_disparity(gl, gr, config["num_disparities"], config["sad_radius"]))
        else:
            out.append(plus_disparity(gl, gr, config))
    return torch.stack(out)
