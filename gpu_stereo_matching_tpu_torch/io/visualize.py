"""Disparity visualization helpers (the reference's ``imshow`` analog).

The reference displays gray disparity windows (``Caller.cpp:23``,
``imshow``); headless environments get files instead: plain scaled gray or
a turbo-colormapped PNG with invalid pixels blacked out.

The port's own copy of the JAX package's ``io/visualize.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import numpy as np

# Piecewise-polynomial approximation of the Turbo colormap (Google, 2019).
_TURBO_COEFFS = np.array(
    [
        [0.13572138, 4.61539260, -42.66032258, 132.13108234, -152.94239396, 59.28637943],
        [0.09140261, 2.19418839, 4.84296658, -14.18503333, 4.27729857, 2.82956604],
        [0.10667330, 12.64194608, -60.58204836, 110.36276771, -89.90310912, 27.34824973],
    ]
)


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] → (…, 3) uint8 RGB via the Turbo polynomial."""
    x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
    powers = np.stack([x**i for i in range(6)], axis=-1)
    rgb = powers @ _TURBO_COEFFS.T
    return np.clip(np.rint(rgb * 255.0), 0, 255).astype(np.uint8)


def colorize_disparity(
    disp: np.ndarray,
    max_disparity: float | None = None,
    invalid_value: int = 0,
    mark_invalid: bool = True,
) -> np.ndarray:
    """Disparity map → (H, W, 3) uint8 BGR visualization."""
    d = np.asarray(disp, dtype=np.float64)
    scale = float(max_disparity) if max_disparity else max(float(d.max()), 1.0)
    rgb = turbo_colormap(d / scale)
    if mark_invalid:
        rgb = np.where((d == invalid_value)[..., None], 0, rgb)
    return rgb[..., ::-1].copy()  # engine convention is BGR
