"""The slice as a whole: the port's StereoRig on the CPU, its maps carried over
from the JAX rig through ``convert.py``, against the JAX Pallas pipeline
that ``StereoRig(use_pallas=True)`` runs (gray -> planned remap -> fused
block matching, Pallas in interpret mode), bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.io.calib_yaml import StereoCalibration, save_opencv_stereo_yaml
from gpu_stereo_matching_tpu.kernels.remap import remap_bilinear_u8_planned
from gpu_stereo_matching_tpu.kernels.sad_wta import fused_block_matching
from gpu_stereo_matching_tpu.models.streaming import StereoRig as JaxRig
from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr
from gpu_stereo_matching_tpu.utils.cache import ArtifactCache as JaxCache
from gpu_stereo_matching_tpu.utils.profiling import StageTimer as JaxStageTimer
from gpu_stereo_matching_tpu_torch import convert
from gpu_stereo_matching_tpu_torch.models.streaming import MAP_NAMES, StereoRig, rig_from_yaml
from gpu_stereo_matching_tpu_torch.utils.cache import ArtifactCache, content_key
from gpu_stereo_matching_tpu_torch.utils.profiling import StageTimer


@pytest.fixture
def tiny_calib():
    """The calibration of tests/test_streaming.py."""
    k = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    return StereoCalibration(
        left_intrinsics=k,
        right_intrinsics=k * np.array([[1.02], [1.01], [1.0]]),
        left_distortion=np.array([0.01, -0.02, 0.0, 0.0, 0.0]),
        right_distortion=np.array([0.02, -0.01, 0.0, 0.0, 0.0]),
        rotation=np.eye(3),
        translation=np.array([-5.0, 0.0, 0.0]),
    )


def _jax_pallas_frame(jrig, left_bgr, right_bgr, cfg):
    lplan, rplan = jrig._remap_plans
    assert lplan is not None and rplan is not None
    rl = remap_bilinear_u8_planned(gray_blockmatching_bgr(jnp.asarray(left_bgr)), lplan, interpret=True)
    rr = remap_bilinear_u8_planned(gray_blockmatching_bgr(jnp.asarray(right_bgr)), rplan, interpret=True)
    return np.asarray(
        fused_block_matching(rl, rr, cfg.num_disparities, cfg.sad_radius, tile_h=8, interpret=True)
    )


@pytest.mark.parametrize("size_hw,num_d,radius", [((24, 32), 4, 1), ((48, 64), 8, 2)])
def test_rig_matches_jax_pallas_pipeline(tmp_path, tiny_calib, size_hw, num_d, radius):
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=radius)
    jrig = JaxRig(tiny_calib, size_hw, cfg, cache=JaxCache(str(tmp_path)), use_pallas=True)
    rig = convert.load_maps(StereoRig(tiny_calib, size_hw, cfg, device="cpu"), [np.asarray(m) for m in jrig._maps])
    rng = np.random.default_rng(11)
    lb = rng.integers(0, 256, (2, *size_hw, 3), dtype=np.uint8)
    rb = rng.integers(0, 256, (2, *size_hw, 3), dtype=np.uint8)
    want = np.stack([_jax_pallas_frame(jrig, lb[i], rb[i], cfg) for i in range(2)])

    single = rig.process(lb[0], rb[0])
    assert single.dtype == torch.int32 and tuple(single.shape) == size_hw
    np.testing.assert_array_equal(single.numpy(), want[0])
    np.testing.assert_array_equal(rig.process_batch(lb, rb).numpy(), want)
    np.testing.assert_array_equal(rig(torch.from_numpy(lb), torch.from_numpy(rb)).numpy(), want)


@pytest.mark.parametrize("fused", [True, False])
def test_process_records_the_frame_stage_as_the_jax_rig(tmp_path, tiny_calib, fused):
    """``process(..., timer=)`` records one fenced ``"frame"`` span per call,
    under the JAX rig's stage name, and returns what it returns without a
    timer; ``process_batch`` takes no timer in either package."""
    size_hw = (24, 32)
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    jrig = JaxRig(tiny_calib, size_hw, cfg, cache=JaxCache(str(tmp_path)), use_pallas=False)
    rig = StereoRig(tiny_calib, size_hw, cfg, device="cpu", fused=fused)
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, (*size_hw, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (*size_hw, 3), dtype=np.uint8)
    timer, jtimer = StageTimer(), JaxStageTimer()
    plain = rig.process(left, right)
    for n in (1, 2):
        assert torch.equal(rig.process(left, right, timer=timer), plain)
        jrig.process(left, right, timer=jtimer)
        assert [s.name for s in timer.spans] == ["frame"] * n
        assert [s.name for s in timer.spans] == [s.name for s in jtimer.spans]
    assert timer.as_dict().keys() == jtimer.as_dict().keys() == {"frame"}
    assert timer.as_dict()["frame"] == pytest.approx(timer.total_seconds) and \
        timer.total_seconds >= 0
    import inspect

    for cls in (StereoRig, JaxRig):
        assert list(inspect.signature(cls.process).parameters)[1:] == [
            "left_bgr", "right_bgr", "timer"]
        assert "timer" not in inspect.signature(cls.process_batch).parameters


def test_convert_carries_the_maps(tmp_path, tiny_calib):
    size_hw = (24, 32)
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    jrig = JaxRig(tiny_calib, size_hw, cfg, cache=JaxCache(str(tmp_path)), use_pallas=False)
    maps = [np.asarray(m) for m in jrig._maps]
    shifted = [m + np.float32(0.25) for m in maps]
    rig = convert.load_maps(StereoRig(tiny_calib, size_hw, cfg, device="cpu"), shifted)
    for name, m in zip(MAP_NAMES, shifted):
        np.testing.assert_array_equal(getattr(rig, name).numpy(), m)
    assert set(rig.state_dict()) == set(MAP_NAMES)
    # Loading in place leaves the map cache of a second rig untouched.
    cache = ArtifactCache()
    a = StereoRig(tiny_calib, size_hw, cfg, cache=cache, device="cpu")
    convert.load_maps(a, shifted)
    b = StereoRig(tiny_calib, size_hw, cfg, cache=cache, device="cpu")
    np.testing.assert_array_equal(b.left_map_x.numpy(), maps[0])


def test_convert_rejects_bad_maps(tiny_calib):
    size_hw = (24, 32)
    rig = StereoRig(tiny_calib, size_hw, BlockMatchingConfig(num_disparities=4, sad_radius=1),
                    device="cpu")
    good = np.zeros(size_hw, np.float32)
    with pytest.raises(ValueError, match="expected 4 maps"):
        convert.load_maps(rig, [good] * 3)
    with pytest.raises(TypeError, match="float32"):
        convert.load_maps(rig, [good.astype(np.float64)] * 4)
    with pytest.raises(ValueError, match="rig size"):
        convert.load_maps(rig, [np.zeros((24, 31), np.float32)] * 4)


def test_map_cache_directory_reused(tmp_path, tiny_calib):
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    cache = ArtifactCache(str(tmp_path))
    StereoRig(tiny_calib, (16, 24), cfg, cache=cache, device="cpu")
    files = sorted(p.name for p in tmp_path.glob("*.pkl"))
    assert len(files) == 1
    StereoRig(tiny_calib, (16, 24), cfg, cache=ArtifactCache(str(tmp_path)), device="cpu")
    assert sorted(p.name for p in tmp_path.glob("*.pkl")) == files


def test_memory_only_cache_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cache = ArtifactCache()
    calls = []
    assert cache.get_or_compute("k", lambda: calls.append(1) or 7) == 7
    assert cache.get_or_compute("k", lambda: calls.append(1) or 8) == 7
    assert calls == [1] and list(tmp_path.iterdir()) == []


def test_content_key_matches_jax_package():
    from gpu_stereo_matching_tpu.utils.cache import content_key as jax_key

    parts = ("rectify-maps", np.arange(6.0).reshape(2, 3), (24, 32))
    assert content_key(*parts) == jax_key(*parts)


def test_rig_from_yaml_scales_intrinsics(tmp_path, tiny_calib):
    path = tmp_path / "calib.yml"
    save_opencv_stereo_yaml(path, tiny_calib)
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    rig = rig_from_yaml(str(path), (48, 64), cfg, scale_intrinsics_from=(24, 32),
                        device="cpu")
    jrig = JaxRig(tiny_calib, (24, 32), cfg, cache=JaxCache(str(tmp_path)), use_pallas=False)
    assert tuple(rig.left_map_x.shape) == (48, 64)
    # Doubled intrinsics at doubled size map pixel centres to about twice
    # the coordinates of the small rig.
    np.testing.assert_allclose(
        rig.left_map_x.numpy()[::2, ::2], 2 * np.asarray(jrig._maps[0]), atol=0.1
    )


def test_rig_rejects_wrong_frames(tiny_calib):
    rig = StereoRig(tiny_calib, (16, 24), BlockMatchingConfig(num_disparities=4, sad_radius=1),
                    device="cpu")
    frame = np.zeros((16, 24, 3), np.uint8)
    with pytest.raises(ValueError, match="BGR frames"):
        rig.process(frame[:, :20], frame[:, :20])
    with pytest.raises(ValueError, match="BGR frames"):
        rig.process_batch(frame, frame)
    with pytest.raises(ValueError, match="BGR frames"):
        rig.process(frame.astype(np.float32), frame.astype(np.float32))


def test_rig_defaults_to_the_card(tmp_path, tiny_calib):
    """``StereoRig`` and ``rig_from_yaml`` run on the card unless the caller
    names the CPU; without a card they raise, they do not fall back."""
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    path = tmp_path / "calib.yml"
    save_opencv_stereo_yaml(path, tiny_calib)
    if torch.cuda.is_available():
        assert StereoRig(tiny_calib, (16, 24), cfg).device.type == "cuda"
        assert rig_from_yaml(str(path), (16, 24), cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StereoRig(tiny_calib, (16, 24), cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rig_from_yaml(str(path), (16, 24), cfg)


@pytest.mark.parametrize("fn", [StereoRig.__init__, rig_from_yaml])
def test_rig_device_default_is_cuda(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("fused", [True, False])
def test_front_end_is_one_call_per_rig_call(monkeypatch, tiny_calib, fused):
    """``process`` and ``process_batch`` each make one call of the front end
    (one launch on the card), with both views and the rig's maps."""
    from gpu_stereo_matching_tpu_torch.models import streaming

    calls = []
    real = streaming.rectify_gray_pair

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(streaming, "rectify_gray_pair", counting)
    size_hw = (24, 32)
    rig = StereoRig(tiny_calib, size_hw, BlockMatchingConfig(num_disparities=4, sad_radius=1),
                    device="cpu", fused=fused)
    rng = np.random.default_rng(5)
    left = rng.integers(0, 256, (2, *size_hw, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (2, *size_hw, 3), dtype=np.uint8)
    rig.process(left[0], right[0])
    assert len(calls) == 1
    rig.process_batch(left, right)
    assert len(calls) == 2
    for args, shape in zip(calls, [(*size_hw, 3), (2, *size_hw, 3)]):
        assert tuple(args[0].shape) == tuple(args[1].shape) == shape
        assert all(a is getattr(rig, name) for a, name in zip(args[2:], MAP_NAMES))
