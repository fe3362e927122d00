"""The port's ``bm`` command and device parsing, on the CPU."""

import numpy as np
import pytest
import torch
from PIL import Image

from gpu_stereo_matching_tpu_torch.cli.main import main
from gpu_stereo_matching_tpu_torch.device import resolve_device
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching
from gpu_stereo_matching_tpu_torch.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig


@pytest.fixture
def gray_pair(tmp_path):
    rng = np.random.default_rng(9)
    left = rng.integers(0, 256, (20, 36), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    Image.fromarray(left).save(lp)
    Image.fromarray(right).save(rp)
    return left, right, str(lp), str(rp)


@pytest.mark.parametrize("fused", [False, True])
def test_bm_writes_scaled_disparity(tmp_path, gray_pair, capsys, fused):
    left, right, lp, rp = gray_pair
    out = tmp_path / "d.png"
    argv = ["bm", lp, rp, str(out), "--gray", "--disparities", "8", "--radius", "2",
            "--device", "cpu"]
    assert main(argv + (["--fused"] if fused else [])) == 0
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    if fused:
        disp = fused_block_matching(lt, rt, 8, 2)
    else:
        disp = block_matching_pipeline(lt, rt, BlockMatchingConfig(num_disparities=8, sad_radius=2))
    want = np.clip(disp.numpy() * 4, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    assert "wrote" in capsys.readouterr().out


def test_bm_bgr_input(tmp_path):
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "l.png")
    Image.fromarray(np.roll(img, -2, axis=1)).save(tmp_path / "r.png")
    out = tmp_path / "d.png"
    assert main(["bm", str(tmp_path / "l.png"), str(tmp_path / "r.png"), str(out),
                 "--disparities", "4", "--radius", "1", "--fused", "--device", "cpu"]) == 0
    assert np.asarray(Image.open(out)).shape == (16, 24)


def test_bm_defaults_to_the_card(tmp_path, gray_pair):
    """Without ``--device`` the command runs on the card; without a card it
    raises, it does not fall back."""
    from gpu_stereo_matching_tpu_torch.cli.main import build_parser

    left, right, lp, rp = gray_pair
    out = tmp_path / "d.png"
    argv = ["bm", lp, rp, str(out), "--gray", "--disparities", "8", "--radius", "2"]
    assert build_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        assert main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
        assert not out.exists()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_resolve_device_cuda_absent_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:1")


@pytest.fixture
def bgr_pair_files(tmp_path):
    rng = np.random.default_rng(11)
    left = rng.integers(0, 256, (12, 20, 3), dtype=np.uint8)
    right = np.ascontiguousarray(np.roll(left, -2, axis=1))
    Image.fromarray(left[..., ::-1]).save(tmp_path / "l.png")
    Image.fromarray(right[..., ::-1]).save(tmp_path / "r.png")
    return left, right, str(tmp_path / "l.png"), str(tmp_path / "r.png")


def test_st_writes_the_st1_disparity(tmp_path, bgr_pair_files, capsys):
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.models.segment_tree import st1_disparity

    left, right, lp, rp = bgr_pair_files
    out = tmp_path / "d.png"
    assert main(["st", lp, rp, str(out), "--max-disp", "6", "--scale", "8", "--sigma", "0.2",
                 "--device", "cpu"]) == 0
    want = st1_disparity(left, right, SegmentTreeConfig(max_disp_levels=6, disparity_scale=8,
                                                        sigma=0.2), device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want.numpy())
    assert "wrote" in capsys.readouterr().out


def test_st_defaults_and_refuses_st2(tmp_path, bgr_pair_files, capsys):
    """The defaults; ``--method st2`` writes the ST-2 map (within the ST-2
    band of the JAX map); a method that is neither is refused."""
    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig as JaxConfig
    from gpu_stereo_matching_tpu.models.segment_tree import st2_disparity as jax_st2
    from gpu_stereo_matching_tpu_torch.cli.main import build_parser
    from gpu_stereo_matching_tpu_torch.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu_torch.models.segment_tree import st2_disparity

    left, right, lp, rp = bgr_pair_files
    args = build_parser().parse_args(["st", lp, rp, str(tmp_path / "d.png")])
    assert (args.device, args.method, args.max_disp, args.scale, args.sigma) == \
        ("cuda", "st1", 60, 4, 0.1)
    out = tmp_path / "d.png"
    assert main(["st", lp, rp, str(out), "--method", "st2", "--max-disp", "6",
                 "--device", "cpu"]) == 0
    got = np.asarray(Image.open(out))
    want = st2_disparity(left, right, SegmentTreeConfig(max_disp_levels=6), device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    assert float(np.mean(got == jax_st2(left, right, JaxConfig(max_disp_levels=6)))) >= 0.97
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["st", lp, rp, str(tmp_path / "e.png"), "--method", "st3", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
    assert not (tmp_path / "e.png").exists()


def _jax_cli(argv):
    """The JAX package's command, without its compile-cache setup."""
    from gpu_stereo_matching_tpu.cli import main as jcli

    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


@pytest.fixture
def rig_files(tmp_path):
    """A calibration YAML of a 90x160 rig (the hostcopies test's 720p rig
    scaled down) and a BGR pair of that size."""
    from gpu_stereo_matching_tpu_torch.io import calib_yaml

    c, s = np.cos(0.004), np.sin(0.004)
    scale = 160 / 1280
    k1 = np.array([[1002.5, 0, 641.3], [0, 1001.8, 358.9], [0, 0, 1.0]])
    k2 = np.array([[998.7, 0, 636.2], [0, 998.1, 362.4], [0, 0, 1.0]])
    k1[:2] *= scale
    k2[:2] *= scale
    calib = calib_yaml.StereoCalibration(
        left_intrinsics=k1, right_intrinsics=k2,
        left_distortion=np.array([-0.081, 0.024, 4e-4, -3e-4, 0.0]),
        right_distortion=np.array([-0.077, 0.019, -2e-4, 5e-4, 0.0]),
        rotation=np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]]),
        translation=np.array([-60.2, 0.35, -0.8]),
    )
    calib_yaml.save_opencv_stereo_yaml(tmp_path / "calib.yml", calib)
    rng = np.random.default_rng(12)
    for name in ("l", "r"):
        Image.fromarray(rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)).save(
            tmp_path / f"{name}.png")
    return [str(tmp_path / n) for n in ("calib.yml", "l.png", "r.png")]


@pytest.mark.parametrize("extra", [[], ["--size", "80x45"], ["--size", "80x45",
                                                              "--keep-intrinsics"]])
def test_rectify_equals_the_jax_command(tmp_path, rig_files, capsys, extra):
    """The PNGs of ``rectify --device cpu`` (the front end's plain twin)
    equal the JAX command's (gray, then the remap) bit for bit."""
    calib, lp, rp = rig_files
    args = ["rectify", "--calib", calib, "--left", lp, "--right", rp, *extra]
    assert main(args + ["--out-prefix", str(tmp_path / "ours"), "--device", "cpu"]) == 0
    assert _jax_cli(args + ["--out-prefix", str(tmp_path / "theirs")]) == 0
    hw = (45, 80) if extra else (90, 160)
    for view in ("left", "right"):
        ours = np.asarray(Image.open(tmp_path / f"ours_{view}.png"))
        theirs = np.asarray(Image.open(tmp_path / f"theirs_{view}.png"))
        assert ours.shape == hw and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, theirs)
        assert ours.any()
    out = capsys.readouterr().out
    assert out.count(f"_left.png / _right.png ({hw[1]}x{hw[0]})") == 2


def test_rectify_defaults_to_the_card(tmp_path, rig_files):
    from gpu_stereo_matching_tpu_torch.cli.main import build_parser

    calib, lp, rp = rig_files
    argv = ["rectify", "--calib", calib, "--left", lp, "--right", rp, "--out-prefix",
            str(tmp_path / "o")]
    assert build_parser().parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
        assert not (tmp_path / "o_left.png").exists()


def test_calibrate_writes_the_jax_commands_yaml(tmp_path, capsys):
    """On rendered boards (the JAX CLI test's views, smaller), the YAML
    equals the JAX command's byte for byte, and so do the printed lines."""
    from tests.test_chessboard import render_board

    rng = np.random.default_rng(13)
    views = [
        np.array([[1.0, 0.03, 24.0], [0.02, 1.0, 20.0], [0, 0, 1.0]]),
        np.array([[0.96, -0.02, 36.0], [0.03, 1.02, 24.0], [1e-4, 0, 1.0]]),
        np.array([[1.05, 0.01, 18.0], [-0.02, 0.97, 32.0], [0, 1e-4, 1.0]]),
        np.array([[0.99, 0.05, 30.0], [0.01, 1.04, 16.0], [-1e-4, 1e-4, 1.0]]),
    ]
    shift = np.array([[1.0, 0, -5.0], [0, 1.0, 0], [0, 0, 1.0]])
    for i, h_mat in enumerate(views):
        for side, h in (("Left", h_mat), ("Right", shift @ h_mat)):
            img, _ = render_board(6, 6, square=20, h_mat=h, size=(210, 240), noise=1.0, rng=rng)
            Image.fromarray(img).save(tmp_path / f"{side}_{i}.png")
    globs = [str(tmp_path / "Left_*.png"), str(tmp_path / "Right_*.png")]
    flags = ["--cols", "6", "--rows", "6", "--square-size", "20"]
    assert main(["calibrate", *globs, str(tmp_path / "ours.yml"), *flags]) == 0
    ours_out = capsys.readouterr().out
    assert _jax_cli(["calibrate", *globs, str(tmp_path / "theirs.yml"), *flags]) == 0
    theirs_out = capsys.readouterr().out
    assert "wrote" in ours_out and "(4 pairs)" in ours_out
    assert ours_out.replace("ours.yml", "theirs.yml") == theirs_out
    assert (tmp_path / "ours.yml").read_bytes() == (tmp_path / "theirs.yml").read_bytes()


def test_calibrate_unpaired_captures(tmp_path, capsys):
    (tmp_path / "Left_0.png").touch()
    rc = main(["calibrate", str(tmp_path / "Left_*.png"), str(tmp_path / "Right_*.png"),
               str(tmp_path / "o.yml")])
    assert rc == 2 and "unpaired captures: 1 left vs 0 right" in capsys.readouterr().out
    assert main(["calibrate", str(tmp_path / "none_*.png"), str(tmp_path / "none_*.png"),
                 str(tmp_path / "o.yml")]) == 2
    assert not (tmp_path / "o.yml").exists()
