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
