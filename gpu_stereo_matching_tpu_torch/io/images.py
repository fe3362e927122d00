"""Image file I/O (host side, NumPy).

The reference leans on OpenCV ``imread/imwrite`` (BGR byte order throughout,
e.g. ``BlockMatching/Caller.cpp:12-13``, ``STMatching/StereoDisparity.cpp:43-44``).
We load through PIL into NumPy and keep the engine's convention as **BGR
uint8** so the cost/weight semantics line up with the reference constants.

The port's own copy of the JAX package's ``io/images.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from PIL import Image


def load_image_bgr(path: str | os.PathLike) -> np.ndarray:
    """Load an image file as (H, W, 3) uint8 in BGR channel order."""
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return rgb[..., ::-1].copy()


def load_image_gray(path: str | os.PathLike) -> np.ndarray:
    """Load an image file as (H, W) uint8 gray (PIL's Rec.601 conversion)."""
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save a uint8 image; 3-channel input is interpreted as BGR."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    Image.fromarray(arr).save(path)


def resize_bilinear_u8(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize (used to reproduce the reference demos'
    downsampling, e.g. 320×200 in ``Caller.cpp:40-45``)."""
    h, w = size_hw
    if img.ndim == 3:
        pil = Image.fromarray(img[..., ::-1])
        out = np.asarray(pil.resize((w, h), Image.BILINEAR), dtype=np.uint8)
        return out[..., ::-1].copy()
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((w, h), Image.BILINEAR), dtype=np.uint8)
