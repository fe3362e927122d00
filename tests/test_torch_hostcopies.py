"""The port's own copies of the plain-numpy host modules (configuration,
calibration YAML, image I/O, disparity colouring, rectification maps, the
Middlebury scenes and metrics, the Zhang toolkit, chessboard detection,
capture I/O and the heavy-path plan builders of ``tree/hpd.py``) give
what the JAX package's modules give on the same inputs, so the copies
cannot drift unseen. Only the tests import both packages."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from gpu_stereo_matching_tpu.calib import rectify as jrectify
from gpu_stereo_matching_tpu.core import config as jconfig
from gpu_stereo_matching_tpu.io import calib_yaml as jyaml
from gpu_stereo_matching_tpu.io import images as jimages
from gpu_stereo_matching_tpu.io import middlebury as jmb
from gpu_stereo_matching_tpu.io import visualize as jvis
from gpu_stereo_matching_tpu_torch.calib import rectify as trectify
from gpu_stereo_matching_tpu_torch.core import config as tconfig
from gpu_stereo_matching_tpu_torch.io import calib_yaml as tyaml
from gpu_stereo_matching_tpu_torch.io import images as timages
from gpu_stereo_matching_tpu_torch.io import middlebury as tmb
from gpu_stereo_matching_tpu_torch.io import visualize as tvis
from tests.torch_st_helpers import fresh_registries  # noqa: F401


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
    ours = StereoRig(small(tyaml), (36, 64), cfg, device="cpu")
    theirs = StereoRig(small(jyaml), (36, 64), cfg, device="cpu")
    for name in MAP_NAMES:
        assert torch.equal(getattr(ours, name), getattr(theirs, name))


def _gt_pair(seed, h=20, w=31):
    """Random third-size GT maps (0 = unknown) and a disparity map."""
    rng = np.random.default_rng(seed)
    gt_l = rng.integers(0, 3 * 12, (h, w)).astype(np.uint8)
    gt_r = np.clip(gt_l.astype(int) + rng.integers(-4, 5, (h, w)), 0, 255).astype(np.uint8)
    gt_l[rng.random((h, w)) < 0.1] = 0
    return gt_l, gt_r, rng.integers(0, 14, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_middlebury_metrics_agree(seed):
    gt_l, gt_r, disp = _gt_pair(seed)
    assert tmb.GT_SCALE == jmb.GT_SCALE
    mask = tmb.nonocc_mask(gt_l, gt_r)
    np.testing.assert_array_equal(mask, jmb.nonocc_mask(gt_l, gt_r))
    np.testing.assert_array_equal(tmb.nonocc_mask(gt_l, gt_r, 2.0), jmb.nonocc_mask(gt_l, gt_r, 2.0))
    for kwargs in ({}, {"delta": 1.0}, {"disp_scale": 4.0, "gt_scale": 1.0}, {"mask": mask}):
        assert tmb.bad_pixel_rate(disp, gt_l, **kwargs) == jmb.bad_pixel_rate(disp, gt_l, **kwargs)


def test_middlebury_scenes_load_alike(tmp_path):
    """Scenes with and without ground truth and a folder that is no scene."""
    rng = np.random.default_rng(6)
    for name, gt in (("Art", True), ("Computer", False)):
        d = tmp_path / name
        d.mkdir()
        for view in ("view1", "view5"):
            timages.save_image(d / f"{view}.png", rng.integers(0, 256, (9, 13, 3), dtype=np.uint8))
        if gt:
            for disp in ("disp1", "disp5"):
                timages.save_image(d / f"{disp}.png", rng.integers(0, 256, (9, 13), dtype=np.uint8))
    (tmp_path / "notes").mkdir()
    for gt_only in (False, True):
        assert (tmb.list_middlebury_scenes(tmp_path, gt_only)
                == jmb.list_middlebury_scenes(tmp_path, gt_only)
                == (["Art"] if gt_only else ["Art", "Computer"]))
    for name in ("Art", "Computer"):
        ours, theirs = tmb.load_middlebury_scene(tmp_path, name), jmb.load_middlebury_scene(
            tmp_path, name)
        assert ours.name == theirs.name == name
        for field in ("left_bgr", "right_bgr", "gt_left", "gt_right"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert (a is None) == (b is None) == (name == "Computer" and field.startswith("gt"))
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rel", ["calib/zhang.py", "calib/chessboard.py", "io/capture.py"])
def test_copied_modules_differ_only_in_imports_and_a_note(rel):
    """The copy is the JAX module line for line, its imports re-pointed at
    the port's copies and a note added to its docstring."""
    root = Path(__file__).resolve().parents[1]
    theirs = (root / "gpu_stereo_matching_tpu" / rel).read_text().splitlines()
    ours = (root / "gpu_stereo_matching_tpu_torch" / rel).read_text().splitlines()
    note = ["", f"The port's own copy of the JAX package's ``{rel}`` (plain numpy, the same",
            "arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two", "together."]
    end = theirs.index('"""', 1)
    assert ours == [line.replace("from gpu_stereo_matching_tpu.", "from gpu_stereo_matching_tpu_torch.")
                    for line in theirs[:end] + note + theirs[end:]]
    assert any("gpu_stereo_matching_tpu_torch." in line for line in ours)


def test_capture_sources_agree(tmp_path):
    """Pairs by index from a directory, frames from a list, pairs written
    to disk, and a camera source that cannot open its cameras."""
    from gpu_stereo_matching_tpu.io import capture as jcap
    from gpu_stereo_matching_tpu_torch.io import capture as tcap

    rng = np.random.default_rng(7)
    src = tmp_path / "src"
    src.mkdir()
    for name in ("Left_0", "Right_0", "Left_2", "Right_2", "Left_3", "Right_10", "Left_x"):
        timages.save_image(src / f"{name}.png", rng.integers(0, 256, (6, 9, 3), dtype=np.uint8))
    ours, theirs = tcap.DirectorySource(str(src)), jcap.DirectorySource(str(src))
    assert ours.pairs == theirs.pairs and [Path(p).name for p, _ in ours.pairs] == [
        "Left_0.png", "Left_2.png"]
    listed = [(str(src / "Left_0.png"), str(src / "Right_2.png"))]
    for a, b in zip(list(tcap.PairListSource(listed).frames()) + list(ours.frames()),
                    list(jcap.PairListSource(listed).frames()) + list(theirs.frames())):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    written = tcap.capture_pairs(ours, str(tmp_path / "a"), max_pairs=1)
    assert [tuple(Path(p).name for p in pair) for pair in written] == [("Left_0.jpg", "Right_0.jpg")]
    jcap.capture_pairs(theirs, str(tmp_path / "b"), max_pairs=1)
    for name in ("Left_0.jpg", "Right_0.jpg"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert tcap.capture_pairs(tcap.PairListSource([]), str(tmp_path / "c")) == []
    for module in (tcap, jcap):
        with pytest.raises(RuntimeError, match="camera"):
            next(module.CameraSource(90, 91, num_frames=1).frames())


def _hpd_trees(n, h, w):
    """``n`` segment trees of random grids, as the port's and as the JAX
    package's ``SegmentTree`` over the same arrays."""
    from gpu_stereo_matching_tpu.tree import builder as jb
    from gpu_stereo_matching_tpu_torch.tree import builder as tb

    out = []
    for seed in range(n):
        ea, _eb = tb.grid_edges(h, w)
        weights = (np.random.default_rng(seed).random(len(ea)) * 60).astype(np.float32)
        tree = tb.build_segment_tree(weights, h, w, tau=100.0, min_size=6, penalty=5.0)
        out.append((tree, jb.SegmentTree(**{f: getattr(tree, f) for f in (
            "height", "width", "bfs_order", "parent", "parent_dist", "level_of",
            "level_start", "dfs_order", "subtree_size")})))
    return out


@pytest.mark.parametrize("hw", [(9, 12), (1, 17)])
def test_hpd_host_builders_agree(fresh_registries, hw):
    """``tree/hpd.py``'s host functions, each on the same inputs in both
    packages: ``_packed_arrays_numpy``, ``_plan_order_from_packed`` over the
    packed arrays it gave, ``code_plan`` over that plan."""
    from gpu_stereo_matching_tpu.tree import hpd as jh
    from gpu_stereo_matching_tpu_torch.tree import hpd as th

    (tree, jtree), = _hpd_trees(1, *hw)
    caps, ints, floats = th._packed_arrays_numpy(tree, 0.1)
    jcaps, jints, jfloats = jh._packed_arrays_numpy(jtree, 0.1)
    assert [tuple(c) for c in caps] == [tuple(c) for c in jcaps]
    np.testing.assert_array_equal(ints, jints)
    np.testing.assert_array_equal(floats, jfloats)
    plan = th._plan_order_from_packed(tree.num_nodes, caps, ints, floats)
    jplan = jh._plan_order_from_packed(jtree.num_nodes, jcaps, jints, jfloats)
    assert (plan.total_pos, plan.rounds_meta) == (jplan.total_pos, jplan.rounds_meta)
    np.testing.assert_array_equal(plan.ints.numpy(), jplan.ints)
    np.testing.assert_array_equal(plan.floats.numpy(), jplan.floats)
    coded = th.code_plan(plan, tree, 0.1)
    jcoded = jh.code_plan(jplan, jtree, 0.1, device=False)
    assert coded.layout_key == jcoded.layout_key
    for name in ("ints", "codes", "table"):
        np.testing.assert_array_equal(getattr(coded, name).numpy(), getattr(jcoded, name))


@pytest.mark.parametrize("b", [2, 3])
def test_merge_plans_agrees(fresh_registries, b):
    from gpu_stereo_matching_tpu.tree import hpd as jh
    from gpu_stereo_matching_tpu_torch.tree import hpd as th

    trees = _hpd_trees(b, 10, 13)
    th.converged_plan_batch([t for t, _ in trees], 0.1)
    jh.converged_plan_batch([j for _, j in trees], 0.1)
    ours = th.merge_plans([th.PlanOrderPlan.from_tree(t, 0.1) for t, _ in trees])
    theirs = jh.merge_plans([jh.PlanOrderPlan.from_tree(j, 0.1, device=False) for _, j in trees])
    assert (ours.num_nodes, ours.total_pos, ours.rounds_meta) == (
        theirs.num_nodes, theirs.total_pos, theirs.rounds_meta)
    np.testing.assert_array_equal(ours.ints.numpy(), theirs.ints)
    np.testing.assert_array_equal(ours.floats.numpy(), theirs.floats)
