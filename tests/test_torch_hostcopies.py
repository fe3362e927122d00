"""The port's own copies of the plain-numpy host modules (configuration,
calibration YAML, image I/O, disparity colouring, rectification maps) give
what the JAX package's modules give on the same inputs, so the copies
cannot drift unseen. Only the tests import both packages."""

import dataclasses

import numpy as np
import pytest

from gpu_stereo_matching_tpu.calib import rectify as jrectify
from gpu_stereo_matching_tpu.core import config as jconfig
from gpu_stereo_matching_tpu.io import calib_yaml as jyaml
from gpu_stereo_matching_tpu.io import images as jimages
from gpu_stereo_matching_tpu.io import visualize as jvis
from gpu_stereo_matching_tpu_torch.calib import rectify as trectify
from gpu_stereo_matching_tpu_torch.core import config as tconfig
from gpu_stereo_matching_tpu_torch.io import calib_yaml as tyaml
from gpu_stereo_matching_tpu_torch.io import images as timages
from gpu_stereo_matching_tpu_torch.io import visualize as tvis


def _calibration(module, distorted=True):
    """A 720p rig: ~1000 px focal length, a 60 mm baseline, a slight
    relative rotation."""
    c, s = np.cos(0.004), np.sin(0.004)
    return module.StereoCalibration(
        left_intrinsics=np.array([[1002.5, 0, 641.3], [0, 1001.8, 358.9], [0, 0, 1.0]]),
        right_intrinsics=np.array([[998.7, 0, 636.2], [0, 998.1, 362.4], [0, 0, 1.0]]),
        left_distortion=np.array([-0.081, 0.024, 4e-4, -3e-4, 0.0]) * distorted,
        right_distortion=np.array([-0.077, 0.019, -2e-4, 5e-4, 0.0]) * distorted,
        rotation=np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]]),
        translation=np.array([-60.2, 0.35, -0.8]),
    )


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("CostConstants", {}),
        ("CostConstants", {"tau_color": 5.0, "alpha": 0.3}),
        ("BlockMatchingConfig", {}),
        ("BlockMatchingConfig", {"num_disparities": 8, "sad_radius": 2, "lr_consistency": True,
                                 "median_radius": 3}),
        ("SegmentTreeConfig", {}),
        ("SegmentTreeConfig", {"iterate": True, "sigma": 0.2}),
        ("MeshConfig", {}),
        ("MeshConfig", {"data": 2, "space": 4, "disp": 2}),
    ],
)
def test_configs_have_the_same_fields_and_defaults(name, kwargs):
    ours = getattr(tconfig, name)(**kwargs)
    theirs = getattr(jconfig, name)(**kwargs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]


def test_config_properties_agree():
    assert tconfig.BlockMatchingConfig(sad_radius=3).window_area == 49
    ours, theirs = tconfig.MeshConfig(2, 3, 4), jconfig.MeshConfig(2, 3, 4)
    assert ours.axis_names == theirs.axis_names
    assert ours.shape == theirs.shape and ours.num_devices == theirs.num_devices == 24
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.data = 1


@pytest.mark.parametrize("size_hw,distorted", [((72, 128), True), ((48, 64), False), ((90, 160), True)])
def test_rectification_maps_are_bit_identical(size_hw, distorted):
    scale = size_hw[1] / 1280.0

    def maps(module, calib_module):
        calib = _calibration(calib_module, distorted)
        k1, k2 = calib.left_intrinsics.copy(), calib.right_intrinsics.copy()
        k1[:2] *= scale
        k2[:2] *= scale
        calib = dataclasses.replace(calib, left_intrinsics=k1, right_intrinsics=k2)
        return module.rectification_maps_from_calibration(calib, size_hw)

    ours, theirs = maps(trectify, tyaml), maps(jrectify, jyaml)
    for (ox, oy), (jx, jy) in zip(ours, theirs):
        assert ox.dtype == jx.dtype and ox.shape == size_hw
        np.testing.assert_array_equal(ox, jx)
        np.testing.assert_array_equal(oy, jy)


def test_stereo_rectify_results_are_identical():
    calib = _calibration(tyaml)
    args = (calib.left_intrinsics, calib.left_distortion, calib.right_intrinsics,
            calib.right_distortion, (720, 1280), calib.rotation, calib.translation)
    ours, theirs = trectify.stereo_rectify(*args), jrectify.stereo_rectify(*args)
    for field in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, field.name), getattr(theirs, field.name))


@pytest.mark.parametrize("writer,reader", [(tyaml, jyaml), (jyaml, tyaml), (tyaml, tyaml)])
def test_calibration_yaml_crosses_between_the_loaders(tmp_path, writer, reader):
    calib = _calibration(writer)
    path = tmp_path / "calib.yml"
    writer.save_opencv_stereo_yaml(path, calib)
    back = reader.load_opencv_stereo_yaml(path)
    for field in dataclasses.fields(calib):
        np.testing.assert_array_equal(getattr(back, field.name), getattr(calib, field.name))


def test_yaml_files_are_byte_identical(tmp_path):
    tyaml.save_opencv_stereo_yaml(tmp_path / "a.yml", _calibration(tyaml))
    jyaml.save_opencv_stereo_yaml(tmp_path / "b.yml", _calibration(jyaml))
    assert (tmp_path / "a.yml").read_bytes() == (tmp_path / "b.yml").read_bytes()


@pytest.mark.parametrize("max_disp", [None, 64, 16])
def test_colorize_disparity_agrees(max_disp):
    disp = np.random.default_rng(3).integers(0, 64, (20, 30)).astype(np.int32)
    args = (disp,) if max_disp is None else (disp, max_disp)
    np.testing.assert_array_equal(tvis.colorize_disparity(*args), jvis.colorize_disparity(*args))
    x = np.linspace(-0.2, 1.2, 50)
    np.testing.assert_array_equal(tvis.turbo_colormap(x), jvis.turbo_colormap(x))


@pytest.mark.parametrize("saver,loader", [(timages, jimages), (jimages, timages)])
def test_images_round_trip_between_the_packages(tmp_path, saver, loader):
    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (12, 17, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (12, 17), dtype=np.uint8)
    saver.save_image(tmp_path / "c.png", bgr)
    saver.save_image(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(loader.load_image_bgr(tmp_path / "c.png"), bgr)
    np.testing.assert_array_equal(loader.load_image_gray(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(
        loader.load_image_gray(tmp_path / "c.png"), saver.load_image_gray(tmp_path / "c.png")
    )


def test_resize_bilinear_agrees():
    img = np.random.default_rng(5).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        timages.resize_bilinear_u8(img, (12, 25)), jimages.resize_bilinear_u8(img, (12, 25))
    )


def test_port_rig_takes_either_package_calibration():
    """The rig reads the calibration's fields only, so a calibration of the
    JAX package's type builds the same maps as the port's own."""
    import torch

    from gpu_stereo_matching_tpu_torch.models.streaming import MAP_NAMES, StereoRig

    def small(module):
        calib = _calibration(module)
        k1, k2 = calib.left_intrinsics.copy(), calib.right_intrinsics.copy()
        k1[:2] *= 0.05
        k2[:2] *= 0.05
        return dataclasses.replace(calib, left_intrinsics=k1, right_intrinsics=k2)

    cfg = tconfig.BlockMatchingConfig(num_disparities=4, sad_radius=1)
    ours = StereoRig(small(tyaml), (36, 64), cfg)
    theirs = StereoRig(small(jyaml), (36, 64), cfg)
    for name in MAP_NAMES:
        assert torch.equal(getattr(ours, name), getattr(theirs, name))
