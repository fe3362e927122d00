"""Camera + stereo calibration from chessboard corners (Zhang's method).

Native replacement for the reference's interactive OpenCV calibration
(``CalibrationTest``, ``BlockMatching/Utility.cpp:97-196``, which drives
``findChessboardCorners`` + ``calibrateCamera``/``stereoCalibrate`` and
writes the YAML this engine loads). The math is implemented from scratch:

* homography estimation per view (normalized DLT),
* closed-form intrinsics from the absolute-conic constraints (Zhang 2000),
* extrinsics per view from the homographies,
* joint nonlinear refinement (intrinsics + 5-term distortion + per-view
  poses) by Levenberg–Marquardt (`scipy.optimize.least_squares`),
* stereo extrinsics (R, T) from paired views with joint refinement.

Corner *detection* is pluggable: any (N, 2) pixel-corner source works;
:func:`detect_chessboard_corners` uses OpenCV when available (acquisition
tooling, not part of the compute path).

The port's own copy of the JAX package's ``calib/zhang.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from gpu_stereo_matching_tpu_torch.calib.rectify import (
    _distort_normalized,
    _matrix_to_rodrigues,
    _rodrigues_to_matrix,
)


def chessboard_object_points(
    cols: int, rows: int, square_size: float = 1.0
) -> np.ndarray:
    """(N, 2) planar chessboard corner coordinates (Z = 0 plane)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    return (np.stack([xs, ys], axis=-1).reshape(-1, 2) * square_size).astype(
        np.float64
    )


def detect_chessboard_corners(
    image_gray: np.ndarray,
    pattern_cols: int,
    pattern_rows: int,
    backend: str = "native",
) -> Optional[np.ndarray]:
    """Detect inner chessboard corners → (N, 2) float pixel coords or None.

    ``backend="native"`` (default) runs the framework's own detector
    (``calib.chessboard``: saddle-response + lattice growing + homography
    completion — no OpenCV in the product path; it finds more of the
    bundled Chess boards than ``cv::findChessboardCorners``).
    ``backend="opencv"`` uses OpenCV when importable (kept as an external
    cross-check, per SURVEY §2.4).
    """
    if backend == "native":
        from gpu_stereo_matching_tpu_torch.calib.chessboard import (
            detect_chessboard_corners_native,
        )

        return detect_chessboard_corners_native(
            image_gray, pattern_cols, pattern_rows
        )
    if backend != "opencv":
        raise ValueError(f"unknown backend: {backend!r}")
    try:
        import cv2
    except ImportError:
        return None
    ok, corners = cv2.findChessboardCorners(
        image_gray, (pattern_cols, pattern_rows)
    )
    if not ok:
        return None
    corners = cv2.cornerSubPix(
        image_gray,
        corners,
        (5, 5),
        (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
    )
    return corners.reshape(-1, 2).astype(np.float64)


# ----------------------------------------------------------- homography/DLT


def _normalization_transform(pts: np.ndarray) -> np.ndarray:
    mean = pts.mean(axis=0)
    scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - mean, axis=1)), 1e-12)
    return np.array(
        [[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1]]
    )


def estimate_homography(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Planar homography via normalized DLT: img ~ H · [X, Y, 1]."""
    t_obj = _normalization_transform(obj_xy)
    t_img = _normalization_transform(img_xy)
    n = len(obj_xy)
    src = (t_obj @ np.hstack([obj_xy, np.ones((n, 1))]).T).T
    dst = (t_img @ np.hstack([img_xy, np.ones((n, 1))]).T).T
    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y, _ = src[i]
        u, v, _ = dst[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(a)
    h_norm = vt[-1].reshape(3, 3)
    h = np.linalg.inv(t_img) @ h_norm @ t_obj
    return h / h[2, 2]


# ------------------------------------------------------- Zhang closed form


def _v_ij(h: np.ndarray, i: int, j: int) -> np.ndarray:
    return np.array(
        [
            h[0, i] * h[0, j],
            h[0, i] * h[1, j] + h[1, i] * h[0, j],
            h[1, i] * h[1, j],
            h[2, i] * h[0, j] + h[0, i] * h[2, j],
            h[2, i] * h[1, j] + h[1, i] * h[2, j],
            h[2, i] * h[2, j],
        ]
    )


def intrinsics_from_homographies(homographies: Sequence[np.ndarray]) -> np.ndarray:
    """Closed-form K from ≥3 planar views (Zhang's B-matrix method)."""
    v = []
    for h in homographies:
        v.append(_v_ij(h, 0, 1))
        v.append(_v_ij(h, 0, 0) - _v_ij(h, 1, 1))
    v = np.asarray(v)
    _, _, vt = np.linalg.svd(v)
    b11, b12, b22, b13, b23, b33 = vt[-1]

    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(lam / b11)
    fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    return np.array([[fx, skew, cx], [0, fy, cy], [0, 0, 1]])


def extrinsics_from_homography(k: np.ndarray, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view (R, t) from K and the view homography."""
    k_inv = np.linalg.inv(k)
    lam = 1.0 / np.linalg.norm(k_inv @ h[:, 0])
    r1 = lam * (k_inv @ h[:, 0])
    r2 = lam * (k_inv @ h[:, 1])
    t = lam * (k_inv @ h[:, 2])
    r3 = np.cross(r1, r2)
    r = np.stack([r1, r2, r3], axis=1)
    # Project onto SO(3)
    u, _, vt = np.linalg.svd(r)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = -r
    return r, t


# ------------------------------------------------------------- projection


def project_points(
    obj_xy: np.ndarray,
    rvec: np.ndarray,
    tvec: np.ndarray,
    k: np.ndarray,
    dist: np.ndarray,
) -> np.ndarray:
    """Project planar (N, 2) object points with the 5-term model → (N, 2)."""
    r = _rodrigues_to_matrix(np.asarray(rvec, dtype=np.float64))
    pts3 = np.hstack([obj_xy, np.zeros((len(obj_xy), 1))])
    cam = pts3 @ r.T + np.asarray(tvec, dtype=np.float64)
    x = cam[:, 0] / cam[:, 2]
    y = cam[:, 1] / cam[:, 2]
    xd, yd = _distort_normalized(x, y, np.asarray(dist, dtype=np.float64))
    u = k[0, 0] * xd + k[0, 1] * yd + k[0, 2]
    v = k[1, 1] * yd + k[1, 2]
    return np.stack([u, v], axis=-1)


@dataclasses.dataclass
class CameraCalibration:
    intrinsics: np.ndarray        # (3, 3)
    distortion: np.ndarray        # (5,)
    rvecs: List[np.ndarray]       # per-view rotation vectors
    tvecs: List[np.ndarray]       # per-view translations
    rms_error: float              # reprojection RMS in pixels


def calibrate_camera(
    obj_xy: np.ndarray,
    image_points: Sequence[np.ndarray],
    refine: bool = True,
    fix_skew: bool = True,
) -> CameraCalibration:
    """Single-camera calibration from planar views (Zhang + LM refinement)."""
    homographies = [estimate_homography(obj_xy, ip) for ip in image_points]
    k0 = intrinsics_from_homographies(homographies)
    if fix_skew:
        k0[0, 1] = 0.0
    poses = [extrinsics_from_homography(k0, h) for h in homographies]
    rvecs = [_matrix_to_rodrigues(r) for r, _ in poses]
    tvecs = [t for _, t in poses]
    dist0 = np.zeros(5)

    if not refine:
        rms = _rms(obj_xy, image_points, k0, dist0, rvecs, tvecs)
        return CameraCalibration(k0, dist0, rvecs, tvecs, rms)

    from scipy.optimize import least_squares

    n_views = len(image_points)

    def pack(k, dist, rvecs, tvecs):
        intr = [k[0, 0], k[1, 1], k[0, 2], k[1, 2]]
        return np.concatenate(
            [intr, dist] + [np.concatenate([rvecs[i], tvecs[i]]) for i in range(n_views)]
        )

    def unpack(p):
        fx, fy, cx, cy = p[:4]
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        dist = p[4:9]
        rv, tv = [], []
        for i in range(n_views):
            base = 9 + 6 * i
            rv.append(p[base : base + 3])
            tv.append(p[base + 3 : base + 6])
        return k, dist, rv, tv

    def residuals(p):
        k, dist, rv, tv = unpack(p)
        res = []
        for i in range(n_views):
            proj = project_points(obj_xy, rv[i], tv[i], k, dist)
            res.append((proj - image_points[i]).ravel())
        return np.concatenate(res)

    sol = least_squares(residuals, pack(k0, dist0, rvecs, tvecs), method="lm")
    k, dist, rvecs, tvecs = unpack(sol.x)
    rms = _rms(obj_xy, image_points, k, dist, rvecs, tvecs)
    return CameraCalibration(k, dist, list(rvecs), list(tvecs), rms)


def _rms(obj_xy, image_points, k, dist, rvecs, tvecs) -> float:
    errs = []
    for ip, rv, tv in zip(image_points, rvecs, tvecs):
        proj = project_points(obj_xy, rv, tv, k, dist)
        errs.append(((proj - ip) ** 2).sum(axis=1))
    return float(np.sqrt(np.mean(np.concatenate(errs))))


@dataclasses.dataclass
class StereoCalibrationResult:
    rotation: np.ndarray      # right w.r.t. left
    translation: np.ndarray
    rms_error: float


def stereo_calibrate(
    obj_xy: np.ndarray,
    left_points: Sequence[np.ndarray],
    right_points: Sequence[np.ndarray],
    left: CameraCalibration,
    right: CameraCalibration,
    refine: bool = True,
) -> StereoCalibrationResult:
    """Estimate the fixed (R, T) between two rigidly mounted cameras.

    Initial estimate: average of per-view relative poses
    ``R = R_r · R_lᵀ``; optional joint LM refinement over (R, T) and the
    left-camera per-view poses with both cameras' reprojection residuals.
    """
    rel_rs, rel_ts = [], []
    for (rl, tl), (rr, tr) in zip(
        zip(map(_rodrigues_to_matrix, left.rvecs), left.tvecs),
        zip(map(_rodrigues_to_matrix, right.rvecs), right.tvecs),
    ):
        r_rel = rr @ rl.T
        rel_rs.append(_matrix_to_rodrigues(r_rel))
        rel_ts.append(tr - r_rel @ tl)
    r0 = np.mean(rel_rs, axis=0)
    t0 = np.mean(rel_ts, axis=0)

    if not refine:
        rms = _stereo_rms(obj_xy, left_points, right_points, left, right, r0, t0,
                          left.rvecs, left.tvecs)
        return StereoCalibrationResult(_rodrigues_to_matrix(r0), t0, rms)

    from scipy.optimize import least_squares

    n_views = len(left_points)

    def residuals(p):
        rv_rel, tv_rel = p[:3], p[3:6]
        res = []
        r_rel = _rodrigues_to_matrix(rv_rel)
        for i in range(n_views):
            base = 6 + 6 * i
            rv_l, tv_l = p[base : base + 3], p[base + 3 : base + 6]
            proj_l = project_points(obj_xy, rv_l, tv_l, left.intrinsics, left.distortion)
            r_l = _rodrigues_to_matrix(rv_l)
            r_r = r_rel @ r_l
            t_r = r_rel @ tv_l + tv_rel
            proj_r = project_points(
                obj_xy, _matrix_to_rodrigues(r_r), t_r,
                right.intrinsics, right.distortion,
            )
            res.append((proj_l - left_points[i]).ravel())
            res.append((proj_r - right_points[i]).ravel())
        return np.concatenate(res)

    p0 = np.concatenate(
        [r0, t0]
        + [np.concatenate([left.rvecs[i], left.tvecs[i]]) for i in range(n_views)]
    )
    sol = least_squares(residuals, p0, method="lm")
    rv_rel, tv_rel = sol.x[:3], sol.x[3:6]
    rvl = [sol.x[6 + 6 * i : 9 + 6 * i] for i in range(n_views)]
    tvl = [sol.x[9 + 6 * i : 12 + 6 * i] for i in range(n_views)]
    rms = _stereo_rms(obj_xy, left_points, right_points, left, right, rv_rel, tv_rel,
                      rvl, tvl)
    return StereoCalibrationResult(_rodrigues_to_matrix(rv_rel), tv_rel, rms)


def _stereo_rms(obj_xy, lp, rp, left, right, rv_rel, tv_rel, rvl, tvl) -> float:
    r_rel = _rodrigues_to_matrix(np.asarray(rv_rel))
    errs = []
    for i in range(len(lp)):
        proj_l = project_points(obj_xy, rvl[i], tvl[i], left.intrinsics, left.distortion)
        r_l = _rodrigues_to_matrix(np.asarray(rvl[i]))
        r_r = r_rel @ r_l
        t_r = r_rel @ np.asarray(tvl[i]) + np.asarray(tv_rel)
        proj_r = project_points(
            obj_xy, _matrix_to_rodrigues(r_r), t_r, right.intrinsics, right.distortion
        )
        errs.append(((proj_l - lp[i]) ** 2).sum(axis=1))
        errs.append(((proj_r - rp[i]) ** 2).sum(axis=1))
    return float(np.sqrt(np.mean(np.concatenate(errs))))
