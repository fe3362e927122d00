"""The port's calibration toolkit (``calib/zhang.py``, ``calib/chessboard.py``):
the checks of ``tests/test_zhang.py`` and ``tests/test_chessboard.py`` (all
but the one that reads a real capture) run on the port's functions, and
each port function gives what the JAX package's gives on the same inputs."""

import numpy as np
import pytest

from gpu_stereo_matching_tpu.calib import chessboard as jboard
from gpu_stereo_matching_tpu.calib import zhang as jzhang
from gpu_stereo_matching_tpu_torch.calib import chessboard as tboard
from gpu_stereo_matching_tpu_torch.calib import zhang as tzhang
from gpu_stereo_matching_tpu_torch.calib.rectify import _matrix_to_rodrigues, _rodrigues_to_matrix
from tests.test_chessboard import _match_sets, render_board
from tests.test_zhang import DIST_TRUE, K_TRUE


def _views(rng, n_views, k, dist, jitter=0.0):
    """``tests/test_zhang.py::_synthetic_views`` through the port's
    ``project_points``."""
    obj = tzhang.chessboard_object_points(9, 6, square_size=25.0)
    img_pts = []
    for _ in range(n_views):
        rv = rng.uniform(-0.35, 0.35, 3)
        tv = np.array([rng.uniform(-60, 60), rng.uniform(-40, 40), rng.uniform(600, 900)])
        pts = tzhang.project_points(obj, rv, tv, k, dist)
        np.testing.assert_array_equal(pts, jzhang.project_points(obj, rv, tv, k, dist))
        if jitter:
            pts = pts + rng.normal(0, jitter, pts.shape)
        img_pts.append(pts)
    return obj, img_pts


def _same_camera(ours, theirs):
    np.testing.assert_array_equal(ours.intrinsics, theirs.intrinsics)
    np.testing.assert_array_equal(ours.distortion, theirs.distortion)
    for a, b in zip(ours.rvecs + ours.tvecs, theirs.rvecs + theirs.tvecs):
        np.testing.assert_array_equal(a, b)
    assert ours.rms_error == theirs.rms_error


def test_object_points_and_homography_roundtrip():
    obj = tzhang.chessboard_object_points(9, 6, 25.0)
    np.testing.assert_array_equal(obj, jzhang.chessboard_object_points(9, 6, 25.0))
    h_true = np.array([[1.1, 0.02, 5.0], [-0.03, 0.95, -3.0], [1e-4, -2e-4, 1.0]])
    pts = np.hstack([obj, np.ones((len(obj), 1))]) @ h_true.T
    pts = pts[:, :2] / pts[:, 2:3]
    h = tzhang.estimate_homography(obj, pts)
    np.testing.assert_allclose(h, h_true, atol=1e-8)
    np.testing.assert_array_equal(h, jzhang.estimate_homography(obj, pts))


def test_closed_form_steps_agree(rng):
    obj, img_pts = _views(rng, 5, K_TRUE, np.zeros(5))
    hs = [tzhang.estimate_homography(obj, p) for p in img_pts]
    k = tzhang.intrinsics_from_homographies(hs)
    np.testing.assert_array_equal(k, jzhang.intrinsics_from_homographies(hs))
    np.testing.assert_allclose(k, K_TRUE, rtol=1e-6, atol=1e-3)
    for h in hs:
        for a, b in zip(tzhang.extrinsics_from_homography(k, h),
                        jzhang.extrinsics_from_homography(k, h)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("refine", [True, False])
def test_calibrate_camera_recovers_parameters(rng, refine):
    obj, img_pts = _views(rng, 8, K_TRUE, DIST_TRUE)
    cal = tzhang.calibrate_camera(obj, img_pts, refine=refine)
    _same_camera(cal, jzhang.calibrate_camera(obj, img_pts, refine=refine))
    if refine:
        assert cal.rms_error < 1e-5
        np.testing.assert_allclose(cal.intrinsics, K_TRUE, atol=0.05)
        np.testing.assert_allclose(cal.distortion, DIST_TRUE, atol=1e-4)


def test_calibrate_camera_noisy(rng):
    obj, img_pts = _views(rng, 12, K_TRUE, DIST_TRUE, jitter=0.3)
    cal = tzhang.calibrate_camera(obj, img_pts)
    _same_camera(cal, jzhang.calibrate_camera(obj, img_pts))
    assert cal.rms_error < 0.5
    np.testing.assert_allclose(cal.intrinsics[0, 0], K_TRUE[0, 0], rtol=0.01)
    np.testing.assert_allclose(cal.intrinsics[1, 2], K_TRUE[1, 2], rtol=0.02)


@pytest.mark.parametrize("refine", [True, False])
def test_stereo_calibrate_recovers_rig(rng, refine):
    r_true = _rodrigues_to_matrix(np.array([0.01, 0.03, -0.005]))
    t_true = np.array([-47.0, -0.1, -0.3])
    k2 = K_TRUE * np.array([[1.01], [1.005], [1.0]])
    obj = tzhang.chessboard_object_points(9, 6, 25.0)
    lp, rp = [], []
    for _ in range(8):
        rv = rng.uniform(-0.3, 0.3, 3)
        tv = np.array([rng.uniform(-50, 50), rng.uniform(-30, 30), rng.uniform(600, 900)])
        r_l = _rodrigues_to_matrix(rv)
        lp.append(tzhang.project_points(obj, rv, tv, K_TRUE, DIST_TRUE))
        rp.append(tzhang.project_points(obj, _matrix_to_rodrigues(r_true @ r_l),
                                        r_true @ tv + t_true, k2, DIST_TRUE))
    cal_l, cal_r = tzhang.calibrate_camera(obj, lp), tzhang.calibrate_camera(obj, rp)
    res = tzhang.stereo_calibrate(obj, lp, rp, cal_l, cal_r, refine=refine)
    theirs = jzhang.stereo_calibrate(obj, lp, rp, jzhang.calibrate_camera(obj, lp),
                                     jzhang.calibrate_camera(obj, rp), refine=refine)
    np.testing.assert_array_equal(res.rotation, theirs.rotation)
    np.testing.assert_array_equal(res.translation, theirs.translation)
    assert res.rms_error == theirs.rms_error
    if refine:
        assert res.rms_error < 1e-3
        np.testing.assert_allclose(res.rotation, r_true, atol=1e-5)
        np.testing.assert_allclose(res.translation, t_true, atol=1e-2)


def _detect_both(img, cols, rows, **kwargs):
    ours = tboard.detect_chessboard_corners_native(img, cols, rows, **kwargs)
    theirs = jboard.detect_chessboard_corners_native(img, cols, rows, **kwargs)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        np.testing.assert_array_equal(ours, theirs)
    return ours


def test_detect_synthetic_square_board(rng):
    img, gt = render_board(8, 8, noise=2.0, rng=rng)
    got = _detect_both(img, 8, 8)
    assert got is not None and got.shape == (64, 2)
    assert _match_sets(got, gt, 0.5)
    np.testing.assert_array_equal(tzhang.detect_chessboard_corners(img, 8, 8), got)


def test_detect_synthetic_nonsquare_board(rng):
    img, gt = render_board(9, 6, noise=1.0, rng=rng)
    got = _detect_both(img, 9, 6)
    assert got is not None and got.shape == (54, 2)
    assert _match_sets(got, gt, 0.5)
    steps = np.diff(got.reshape(6, 9, 2), axis=1).reshape(-1, 2)
    assert np.linalg.norm(steps.std(axis=0)) < 2.0


def test_detect_orientation_canonical(rng):
    img, _ = render_board(8, 8, noise=1.0, rng=rng)
    got = _detect_both(img, 8, 8)
    got_rot = _detect_both(np.ascontiguousarray(np.rot90(img, 2)), 8, 8)
    assert got is not None and got_rot is not None
    h, w = img.shape
    back = np.stack([w - 1 - got_rot[:, 0], h - 1 - got_rot[:, 1]], 1)
    np.testing.assert_allclose(np.sort(back, axis=0), np.sort(got, axis=0), atol=0.5)
    assert (got[1] - got[0])[0] > 0 and (got_rot[1] - got_rot[0])[0] > 0


def test_detect_rejects_blank_and_noise(rng):
    assert _detect_both(np.full((120, 160), 128, np.uint8), 8, 8) is None
    assert _detect_both(rng.integers(0, 256, (120, 160), dtype=np.uint8), 8, 8) is None


def test_subpix_refine_converges_on_ideal_saddle():
    yy, xx = np.mgrid[0:41, 0:41].astype(np.float64)
    img = (128 + 100 * np.tanh((xx - 20.3) / 2) * np.tanh((yy - 19.6) / 2)).astype(np.float32)
    pts, ok = tboard.refine_corners_subpix(img, [(19.0, 21.0)])
    jpts, jok = jboard.refine_corners_subpix(img, [(19.0, 21.0)])
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(ok, jok)
    assert ok[0]
    np.testing.assert_allclose(pts[0], [20.3, 19.6], atol=0.1)


@pytest.mark.parametrize("radius,normalize", [(4, True), (3, False)])
def test_saddle_response_peaks_at_corner(radius, normalize):
    img, gt = render_board(4, 4)
    resp = tboard.saddle_response(img.astype(np.float32), radius, normalize)
    np.testing.assert_array_equal(
        resp, jboard.saddle_response(img.astype(np.float32), radius, normalize))
    y, x = np.unravel_index(np.argmax(resp), resp.shape)
    assert np.hypot(gt[:, 0] - x, gt[:, 1] - y).min() < 2.5


def test_detect_backends():
    """``opencv`` is imported only when asked for; without it both packages
    find nothing, with it both find the same corners. Another name raises."""
    img, _ = render_board(6, 5, square=20)
    ours = tzhang.detect_chessboard_corners(img, 6, 5, backend="opencv")
    theirs = jzhang.detect_chessboard_corners(img, 6, 5, backend="opencv")
    assert (ours is None) == (theirs is None)
    if ours is not None:
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="unknown backend"):
        tzhang.detect_chessboard_corners(img, 6, 5, backend="sift")


def test_calib_yaml_roundtrip_of_a_calibration(tmp_path, rng):
    """``tests/test_chessboard.py::test_calib_yaml_roundtrip`` on the port's
    YAML I/O, read back by both packages."""
    from gpu_stereo_matching_tpu.io.calib_yaml import load_opencv_stereo_yaml as jload
    from gpu_stereo_matching_tpu_torch.io.calib_yaml import (
        StereoCalibration,
        load_opencv_stereo_yaml,
        save_opencv_stereo_yaml,
    )

    calib = StereoCalibration(
        left_intrinsics=np.array([[1100.5, 0, 640.2], [0, 1099.0, 360.7], [0, 0, 1]]),
        right_intrinsics=np.array([[1102.1, 0, 644.9], [0, 1101.3, 351.0], [0, 0, 1]]),
        left_distortion=np.array([0.1, -0.2, 0.001, -0.002, 0.05]),
        right_distortion=np.array([0.11, -0.22, 0.0, 0.0, 0.01]),
        rotation=np.eye(3) + rng.normal(0, 1e-3, (3, 3)),
        translation=np.array([-46.99, -0.11, -0.24]),
    )
    save_opencv_stereo_yaml(tmp_path / "calib.yml", calib)
    for back in (load_opencv_stereo_yaml(tmp_path / "calib.yml"), jload(tmp_path / "calib.yml")):
        for field in ("left_intrinsics", "right_intrinsics", "left_distortion",
                      "right_distortion", "rotation", "translation"):
            np.testing.assert_array_equal(getattr(back, field), getattr(calib, field))
