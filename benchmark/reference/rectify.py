"""Bouguet rectification and the undistort-rectify maps, in NumPy float64.

A frozen copy of the program's ``calib/rectify.py`` (the arithmetic op for
op, as the OpenCV calls ``cv::stereoRectify`` with ``CALIB_ZERO_DISPARITY``
and ``cv::initUndistortRectifyMap`` compute it), so that the reference works
out the rig's maps again from the configuration's calibration.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * kx + (1.0 - np.cos(theta)) * (kx @ kx)


def _matrix_to_rodrigues(mat: np.ndarray) -> np.ndarray:
    # Standard log map; angles here are small (rectification half-rotations).
    cos_t = np.clip((np.trace(mat) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    axis = (
        np.array(
            [mat[2, 1] - mat[1, 2], mat[0, 2] - mat[2, 0], mat[1, 0] - mat[0, 1]]
        )
        / (2.0 * np.sin(theta))
    )
    return axis * theta


def _distort_normalized(
    x: np.ndarray, y: np.ndarray, dist: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the 5-term (k1, k2, p1, p2, k3) model to normalized coords."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist[:5])
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _undistort_normalized(
    xd: np.ndarray, yd: np.ndarray, dist: np.ndarray, iters: int = 20
) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the distortion model by fixed-point iteration (as OpenCV's
    ``undistortPoints`` does)."""
    k1, k2, p1, p2, k3 = (float(v) for v in dist[:5])
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) * icdist
        y = (yd - dy) * icdist
    return x, y


@dataclasses.dataclass(frozen=True)
class RectificationResult:
    R1: np.ndarray  # (3, 3) left rectification rotation
    R2: np.ndarray  # (3, 3) right rectification rotation
    P1: np.ndarray  # (3, 4) left rectified projection
    P2: np.ndarray  # (3, 4) right rectified projection
    Q: np.ndarray   # (4, 4) disparity-to-depth reprojection matrix


def stereo_rectify(
    k1: np.ndarray,
    d1: np.ndarray,
    k2: np.ndarray,
    d2: np.ndarray,
    image_size_hw: Tuple[int, int],
    rotation: np.ndarray,
    translation: np.ndarray,
    zero_disparity: bool = True,
) -> RectificationResult:
    """Bouguet stereo rectification (the ``cv::stereoRectify`` computation).

    ``rotation``/``translation`` map left-camera coordinates to right-camera
    coordinates. ``zero_disparity`` mirrors ``CV_CALIB_ZERO_DISPARITY`` (both
    principal points set equal), which is what the reference passes.
    """
    h, w = image_size_hw
    t_vec = np.asarray(translation, dtype=np.float64).reshape(3)
    r_mat = np.asarray(rotation, dtype=np.float64)

    # Split the inter-camera rotation evenly between both views.
    om = _matrix_to_rodrigues(r_mat)
    r_half = _rodrigues_to_matrix(-0.5 * om)
    t = r_half @ t_vec

    # Rotate so the baseline becomes the dominant (x or y) axis.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t[idx] > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww *= np.arccos(np.clip(abs(t[idx]) / np.linalg.norm(t), -1.0, 1.0)) / nw
    w_rot = _rodrigues_to_matrix(ww)

    rect1 = w_rot @ r_half.T
    rect2 = w_rot @ r_half
    t_rect = rect2 @ t_vec

    # New common focal length: the average of both cameras' focals on the
    # non-baseline axis (modern OpenCV stereoRectify behavior).
    fc_new = 0.5 * (float(k1[idx ^ 1, idx ^ 1]) + float(k2[idx ^ 1, idx ^ 1]))

    # New principal points: center the undistorted-rectified image corners.
    cc_new = []
    for k_mat, dist, rect in ((k1, d1, rect1), (k2, d2, rect2)):
        corners = np.array(
            [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], dtype=np.float64
        )
        xn = (corners[:, 0] - k_mat[0, 2]) / k_mat[0, 0]
        yn = (corners[:, 1] - k_mat[1, 2]) / k_mat[1, 1]
        xu, yu = _undistort_normalized(xn, yn, np.asarray(dist, dtype=np.float64))
        pts = np.stack([xu, yu, np.ones(4)], axis=0)
        proj = rect @ pts
        px = fc_new * proj[0] / proj[2]
        py = fc_new * proj[1] / proj[2]
        cc_new.append(
            (
                (w - 1) / 2.0 - float(np.mean(px)),
                (h - 1) / 2.0 - float(np.mean(py)),
            )
        )

    if zero_disparity:
        cx = (cc_new[0][0] + cc_new[1][0]) * 0.5
        cy = (cc_new[0][1] + cc_new[1][1]) * 0.5
        cc_new = [(cx, cy), (cx, cy)]
    elif idx == 0:
        cy = (cc_new[0][1] + cc_new[1][1]) * 0.5
        cc_new = [(cc_new[0][0], cy), (cc_new[1][0], cy)]
    else:
        cx = (cc_new[0][0] + cc_new[1][0]) * 0.5
        cc_new = [(cx, cc_new[0][1]), (cx, cc_new[1][1])]

    p1 = np.array(
        [
            [fc_new, 0, cc_new[0][0], 0],
            [0, fc_new, cc_new[0][1], 0],
            [0, 0, 1, 0],
        ]
    )
    p2 = np.array(
        [
            [fc_new, 0, cc_new[1][0], 0],
            [0, fc_new, cc_new[1][1], 0],
            [0, 0, 1, 0],
        ]
    )
    p2[idx, 3] = t_rect[idx] * fc_new

    q = np.zeros((4, 4))
    q[0, 0] = q[1, 1] = 1.0
    q[0, 3] = -cc_new[0][0]
    q[1, 3] = -cc_new[0][1]
    q[2, 3] = fc_new
    q[3, 2] = -1.0 / t_rect[idx]
    q[3, 3] = (cc_new[0][idx] - cc_new[1][idx]) / t_rect[idx]

    return RectificationResult(R1=rect1, R2=rect2, P1=p1, P2=p2, Q=q)


def undistort_rectify_maps(
    k_mat: np.ndarray,
    dist: np.ndarray,
    rect: np.ndarray,
    new_p: np.ndarray,
    image_size_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """``cv::initUndistortRectifyMap`` equivalent → float32 (map_x, map_y).

    For every rectified pixel: back-project through the new projection,
    un-rotate by ``rect``, re-apply the distortion, and project through the
    original intrinsics.
    """
    h, w = image_size_hw
    new_k = np.asarray(new_p, dtype=np.float64)[:, :3]
    i_r = np.linalg.inv(new_k @ np.asarray(rect, dtype=np.float64))

    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    vec = np.stack([u, v, np.ones_like(u)], axis=0).reshape(3, -1)
    xyw = i_r @ vec
    x = xyw[0] / xyw[2]
    y = xyw[1] / xyw[2]
    xd, yd = _distort_normalized(x, y, np.asarray(dist, dtype=np.float64))
    map_x = (k_mat[0, 0] * xd + k_mat[0, 2]).reshape(h, w)
    map_y = (k_mat[1, 1] * yd + k_mat[1, 2]).reshape(h, w)
    return map_x.astype(np.float32), map_y.astype(np.float32)


def rectification_maps_from_calibration(
    calib, image_size_hw: Tuple[int, int]
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """End-to-end: calibration → ((left map_x, map_y), (right map_x, map_y)).

    Mirrors the reference's ``Rectify`` helper (``Utility.cpp:228-234``).
    """
    res = stereo_rectify(
        calib.left_intrinsics,
        calib.left_distortion,
        calib.right_intrinsics,
        calib.right_distortion,
        image_size_hw,
        calib.rotation,
        calib.translation,
        zero_disparity=True,
    )
    left_maps = undistort_rectify_maps(
        calib.left_intrinsics, calib.left_distortion, res.R1, res.P1, image_size_hw
    )
    right_maps = undistort_rectify_maps(
        calib.right_intrinsics, calib.right_distortion, res.R2, res.P2, image_size_hw
    )
    return left_maps, right_maps
