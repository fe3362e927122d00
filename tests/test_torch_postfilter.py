"""The block-matching post-filter slice ("bm+": WTA over the SAD volume, LR
consistency, median) in the port, against the JAX package on the CPU,
bit-exact: LR mask, the median's sort / histogram / CTMF paths, the whole
pipeline, the rig's unfused branch and the CLI. Then the dispatch to the
kernels, and the median kernel vs its twin on a card."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.io.visualize import colorize_disparity
from gpu_stereo_matching_tpu.kernels.ctmf_median import ctmf_median_u8 as jax_ctmf
from gpu_stereo_matching_tpu.models import block_matching as jbm
from gpu_stereo_matching_tpu.models.streaming import StereoRig as JaxRig
from gpu_stereo_matching_tpu.ops import postprocess as jpp
from gpu_stereo_matching_tpu.utils.cache import ArtifactCache as JaxCache
from gpu_stereo_matching_tpu_torch import convert
from gpu_stereo_matching_tpu_torch.cli.main import main as cli_main
from gpu_stereo_matching_tpu_torch.kernels import ctmf_median as tcm
from gpu_stereo_matching_tpu_torch.kernels import split_phase as tsp
from gpu_stereo_matching_tpu_torch.kernels.sad_wta import fused_block_matching
from gpu_stereo_matching_tpu_torch.models import block_matching as tbm
from gpu_stereo_matching_tpu_torch.models.streaming import StereoRig
from gpu_stereo_matching_tpu_torch.ops import postprocess as tpp
from tests import oracles

BM_PLUS = BlockMatchingConfig(
    num_disparities=64, sad_radius=5, lr_consistency=True, lr_max_diff=1, median_radius=3
)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_lr_consistency_mask_matches_jax_and_oracle():
    rng = np.random.default_rng(1)
    dl = rng.integers(0, 8, (9, 15), dtype=np.int32)
    dr = rng.integers(0, 8, (9, 15), dtype=np.int32)
    for max_diff in (0, 1, 2):
        got = tpp.lr_consistency_mask(_t(dl), _t(dr), max_diff)
        assert got.dtype == torch.bool
        want = np.asarray(jpp.lr_consistency_mask(jnp.asarray(dl), jnp.asarray(dr), max_diff))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpp.lr_consistency_mask(_t(dl), _t(dr), 1).numpy(), oracles.lr_mask_oracle(dl, dr, 1)
    )


@pytest.mark.parametrize("method", ["sort", "histogram"])
@pytest.mark.parametrize("shape,radius", [((14, 19), 3), ((2, 11, 23), 2), ((9, 16), 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_median_matches_jax(method, shape, radius, masked):
    img = _u8(2, shape)
    mask = np.random.default_rng(3).random(shape[-2:]) > 0.3 if masked else None
    want = np.asarray(jpp.median_filter_u8(
        jnp.asarray(img), radius, method=method,
        valid_mask=None if mask is None else jnp.asarray(mask)))
    got = tpp.median_filter_u8(_t(img), radius, method=method,
                               valid_mask=None if mask is None else _t(mask))
    assert got.dtype == torch.uint8 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_median_auto_matches_oracle_and_radius_zero_is_identity():
    img = _u8(4, (3, 10, 11))
    got = tpp.median_filter_u8(_t(img), 1)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([oracles.median_oracle(img[c], 1) for c in range(3)])
    )
    x = _t(img)
    assert tpp.median_filter_u8(x, 0) is x and tcm.ctmf_median_u8(x, 0) is x


@pytest.mark.parametrize("method", ["sort", "histogram", "ctmf"])
def test_median_all_invalid_windows_give_255(method):
    img = _u8(5, (16, 20))
    mask = np.ones((16, 20), bool)
    mask[2:12, 4:16] = False  # windows of r = 2 inside this block see no valid pixel
    want = np.asarray(jpp.median_filter_u8(jnp.asarray(img), 2, method="sort",
                                           valid_mask=jnp.asarray(mask)))
    got = tpp.median_filter_u8(_t(img), 2, method=method, valid_mask=_t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[4:10, 6:14] == 255).all()


# The shapes of tests/test_kernels.py's CTMF tests.
@pytest.mark.parametrize("hw,radius", [((20, 30), 1), ((33, 150), 4), ((40, 260), 7), ((16, 128), 9)])
def test_ctmf_twin_matches_jax_ctmf(hw, radius):
    img = _u8(6, hw)
    want = np.asarray(jax_ctmf(jnp.asarray(img), radius, interpret=True))
    got = tcm.ctmf_median_u8(_t(img), radius)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpp.median_filter_u8(_t(img), radius, method="ctmf").numpy(), want)


def test_ctmf_twin_valid_mask_matches_jax_ctmf():
    img = _u8(7, (26, 140))
    mask = np.random.default_rng(8).random((26, 140)) > 0.3
    want = np.asarray(jax_ctmf(jnp.asarray(img), 4, valid_mask=jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(tcm.ctmf_median_u8(_t(img), 4, _t(mask)).numpy(), want)


def test_ctmf_constant_images_and_checks():
    for value in (0, 255):
        x = torch.full((17, 131), value, dtype=torch.uint8)
        assert torch.equal(tcm.ctmf_median_u8(x, 4), x)
    u8 = torch.zeros((8, 12), dtype=torch.uint8)
    with pytest.raises(ValueError, match="radius <= 60"):
        tcm.ctmf_median_u8(u8, 61)
    with pytest.raises(ValueError, match="radius <= 127"):
        tcm.median_u8(u8, 128)
    img = _u8(9, (30, 40))
    want = tpp.median_filter_u8(_t(img), 61, method="histogram")
    np.testing.assert_array_equal(tcm.median_u8(_t(img), 61).numpy(), want.numpy())
    with pytest.raises(ValueError, match="uint8"):
        tcm.ctmf_median_u8(u8.to(torch.int32), 2)
    with pytest.raises(ValueError, match="valid_mask"):
        tcm.ctmf_median_u8(u8, 2, torch.ones((8, 11), dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown method"):
        tpp.median_filter_u8(u8, 2, method="bogus")


@pytest.mark.parametrize(
    "shape,cfg",
    [
        ((30, 120), BM_PLUS),
        ((2, 16, 40), BlockMatchingConfig(num_disparities=8, sad_radius=2, lr_consistency=True,
                                          lr_max_diff=0, median_radius=4)),
        ((13, 17), BlockMatchingConfig(num_disparities=5, sad_radius=0, median_radius=2)),
    ],
)
def test_bm_plus_pipeline_matches_jax(shape, cfg):
    left, right = _u8(9, shape), _u8(10, shape)
    want = np.asarray(jbm.block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    got = tbm.block_matching_pipeline(_t(left), _t(right), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbm.block_matching_reference(_t(left), _t(right), cfg).numpy(), want)


def test_bm_plus_pipeline_matches_oracles():
    """As tests/test_block_matching.py::test_block_matching_lr_median."""
    rng = np.random.default_rng(1234)
    left = rng.integers(0, 256, size=(14, 20), dtype=np.uint8)
    right = rng.integers(0, 256, size=(14, 20), dtype=np.uint8)
    cfg = BlockMatchingConfig(num_disparities=6, sad_radius=1, lr_consistency=True, median_radius=1)
    got = tbm.block_matching_pipeline(_t(left), _t(right), cfg).numpy()
    sad = oracles.box_sum_oracle(oracles.ad_cost_volume_oracle(left, right, 6), 1)
    disp_l = oracles.wta_oracle(sad)
    sad_r = np.full_like(sad, np.iinfo(np.int32).max)
    for d in range(6):
        sad_r[d, :, : 20 - d] = sad[d, :, d:]
    disp = np.where(oracles.lr_mask_oracle(disp_l, oracles.wta_oracle(sad_r), 1), disp_l, 0)
    want = oracles.median_oracle(disp.astype(np.uint8), 1).astype(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def tiny_calib():
    """The calibration of tests/test_streaming.py."""
    from gpu_stereo_matching_tpu.io.calib_yaml import StereoCalibration

    k = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    return StereoCalibration(
        left_intrinsics=k,
        right_intrinsics=k * np.array([[1.02], [1.01], [1.0]]),
        left_distortion=np.array([0.01, -0.02, 0.0, 0.0, 0.0]),
        right_distortion=np.array([0.02, -0.01, 0.0, 0.0, 0.0]),
        rotation=np.eye(3),
        translation=np.array([-5.0, 0.0, 0.0]),
    )


@pytest.mark.parametrize(
    "cfg",
    [
        BlockMatchingConfig(num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=3),
        BlockMatchingConfig(num_disparities=6, sad_radius=1, lr_consistency=True, median_radius=4),
    ],
)
def test_rig_unfused_branch_matches_jax_rig(tmp_path, tiny_calib, cfg):
    """The port's ``fused=False`` rig, its maps carried from the JAX rig by
    ``convert.load_maps``, against ``StereoRig(use_pallas=False)``."""
    size_hw = (24, 32)
    jrig = JaxRig(tiny_calib, size_hw, cfg, cache=JaxCache(str(tmp_path)), use_pallas=False)
    rig = convert.load_maps(StereoRig(tiny_calib, size_hw, cfg, device="cpu", fused=False),
                            [np.asarray(m) for m in jrig._maps])
    lb, rb = _u8(11, (3, *size_hw, 3)), _u8(12, (3, *size_hw, 3))
    want = np.asarray(jrig.process_batch(jnp.asarray(lb), jnp.asarray(rb)))
    np.testing.assert_array_equal(np.asarray(jrig.process(lb[0], rb[0])), want[0])
    single = rig.process(lb[0], rb[0])
    assert single.dtype == torch.int32 and tuple(single.shape) == size_hw
    np.testing.assert_array_equal(single.numpy(), want[0])
    np.testing.assert_array_equal(rig.process_batch(lb, rb).numpy(), want)


def test_fused_rig_ignores_post_filters(tiny_calib):
    """As the JAX rig with ``use_pallas=True``: LR and median are ignored."""
    size_hw = (24, 32)
    plain = BlockMatchingConfig(num_disparities=8, sad_radius=2)
    post = BlockMatchingConfig(num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=3)
    lb, rb = _u8(13, (2, *size_hw, 3)), _u8(14, (2, *size_hw, 3))
    a = StereoRig(tiny_calib, size_hw, post, device="cpu").process_batch(lb, rb)
    b = StereoRig(tiny_calib, size_hw, plain, device="cpu").process_batch(lb, rb)
    c = StereoRig(tiny_calib, size_hw, post, device="cpu", fused=False).process_batch(lb, rb)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture
def gray_pair(tmp_path):
    rng = np.random.default_rng(15)
    left = rng.integers(0, 256, (20, 36), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)
    lp, rp = tmp_path / "l.png", tmp_path / "r.png"
    Image.fromarray(left).save(lp)
    Image.fromarray(right).save(rp)
    return left, right, str(lp), str(rp)


@pytest.mark.parametrize("extra,cfg", [
    (["--lr-check", "--median-radius", "2"],
     BlockMatchingConfig(num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=2)),
    (["--median-radius", "1"], BlockMatchingConfig(num_disparities=8, sad_radius=2, median_radius=1)),
    (["--lr-check", "--median-radius", "2", "--fused"], None),
])
def test_cli_post_filter_flags(tmp_path, gray_pair, extra, cfg):
    left, right, lp, rp = gray_pair
    out = tmp_path / "d.png"
    argv = ["bm", lp, rp, str(out), "--gray", "--disparities", "8", "--radius", "2", "--device", "cpu"]
    assert cli_main(argv + extra) == 0
    if cfg is None:  # --fused ignores the post-filters
        disp = fused_block_matching(_t(left), _t(right), 8, 2)
    else:
        disp = tbm.block_matching_pipeline(_t(left), _t(right), cfg)
    want = np.clip(disp.numpy() * 4, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


def test_cli_colorize(tmp_path, gray_pair):
    left, right, lp, rp = gray_pair
    out = tmp_path / "c.png"
    assert cli_main(["bm", lp, rp, str(out), "--gray", "--disparities", "8", "--radius", "2",
                     "--lr-check", "--median-radius", "1", "--colorize", "--device", "cpu"]) == 0
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=1)
    disp = tbm.block_matching_pipeline(_t(left), _t(right), cfg).numpy()
    img = np.asarray(Image.open(out))
    assert img.shape == (20, 36, 3)
    np.testing.assert_array_equal(img[..., ::-1], colorize_disparity(disp, 8))


def _record_launches(monkeypatch):
    """Replace the three launchers with recorders returning empty tensors of
    the kernels' output shapes, so a device tensor's path can be traced on a
    machine without a card."""
    calls = []

    def volume(left, right, num_d, radius, invalid):
        calls.append("sad_volume")
        return torch.empty((num_d, *left.shape), dtype=torch.int32, device=left.device)

    def wta(sad):
        calls.append("wta_from_sad")
        return torch.zeros(sad.shape[1:], dtype=torch.int32, device=sad.device)

    def median(x, radius, valid_mask):
        calls.append("median")
        return torch.empty_like(x)

    monkeypatch.setattr(tsp, "_launch_volume", volume)
    monkeypatch.setattr(tsp, "_launch_wta", wta)
    monkeypatch.setattr(tcm, "_launch", median)
    return calls


def test_device_tensors_reach_the_launchers(monkeypatch):
    """Off the CPU, ``median_filter_u8(method="auto")`` and the bm+
    pipeline go to the kernels' launchers, never to the plain twins."""
    calls = _record_launches(monkeypatch)
    meta = torch.empty((2, 8, 12), dtype=torch.uint8, device="meta")
    out = tpp.median_filter_u8(meta, 3)
    assert calls == ["median"] and out.shape == meta.shape
    # Past the JAX kernel's r <= 60, "auto" still takes the kernel, to r = 127.
    tpp.median_filter_u8(meta, 127)
    assert calls == ["median"] * 2
    with pytest.raises(ValueError, match="radius <= 127"):
        tpp.median_filter_u8(meta, 128)
    calls.clear()
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1, lr_consistency=True, median_radius=3)
    disp = tbm.block_matching_pipeline(meta, meta, cfg)
    assert disp.shape == (2, 8, 12) and disp.dtype == torch.int32
    assert calls == ["sad_volume", "wta_from_sad", "wta_from_sad", "median"] * 2
    calls.clear()
    tbm.block_matching_reference(_t(_u8(16, (8, 12))), _t(_u8(17, (8, 12))), cfg)
    assert calls == []


def test_non_cpu_tensor_never_gets_the_median_twin():
    meta = torch.empty((8, 12), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tcm.ctmf_median_u8(meta, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,radius",
    [((40, 70), 1), ((2, 33, 150), 3), ((40, 260), 7), ((90, 130), 60), ((150, 300), 127)],
)
@pytest.mark.parametrize("masked", [False, True])
def test_median_kernel_matches_twin_on_card(cuda_device, shape, radius, masked):
    img = torch.from_numpy(_u8(18, shape)).to(cuda_device)
    mask = None
    if masked:
        m = np.random.default_rng(19).random(shape[-2:]) > 0.3
        m[5:30, 10:60] = False
        mask = torch.from_numpy(m).to(cuda_device)
    before = tcm.LAUNCHES
    got = tpp.median_filter_u8(img, radius, valid_mask=mask)
    torch.cuda.synchronize()
    assert tcm.LAUNCHES == before + 1
    assert torch.equal(got, tpp.median_filter_u8(img, radius, method="histogram", valid_mask=mask))


@pytest.mark.gpu
def test_bm_plus_pipeline_on_card_reaches_the_kernels(cuda_device):
    left, right = _u8(20, (2, 60, 200)), _u8(21, (2, 60, 200))
    lt, rt = _t(left).to(cuda_device), _t(right).to(cuda_device)
    before = (dict(tsp.LAUNCHES), tcm.LAUNCHES)
    got = tbm.block_matching_pipeline(lt, rt, BM_PLUS)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["sad_volume"] == before[0]["sad_volume"] + 2
    assert tsp.LAUNCHES["wta_from_sad"] == before[0]["wta_from_sad"] + 4
    assert tcm.LAUNCHES == before[1] + 2
    assert torch.equal(got, tbm.block_matching_reference(lt, rt, BM_PLUS))
    np.testing.assert_array_equal(got.cpu().numpy(), tbm.block_matching_pipeline(_t(left), _t(right), BM_PLUS).numpy())
