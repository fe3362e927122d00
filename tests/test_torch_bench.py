"""The port's benches (``gpu_stereo_matching_tpu_torch/bench/``) and its
``bench`` command on the CPU, at tiny sizes: each runs to its end and prints
the JAX bench's keys; ``micro``'s keys, ``st_profile``'s plan and image
sizes, the filter roofline's row and scan counts and the scaling model's
strategies and bytes equal the JAX package's. Without a card every bench
asked for the card raises. On a card (``-m gpu``) the headline and
``micro`` run tiny."""

import json
import os

import numpy as np
import pytest
import torch

from gpu_stereo_matching_tpu.bench import micro as jmicro
from gpu_stereo_matching_tpu.bench import roofline as jroofline
from gpu_stereo_matching_tpu.bench import scaling as jscaling
from gpu_stereo_matching_tpu.bench import st_profile as jst_profile
from gpu_stereo_matching_tpu.cli import main as jcli
from gpu_stereo_matching_tpu.tree.builder import build_segment_tree as jbuild
from gpu_stereo_matching_tpu.tree.stride import StridePlan as JStridePlan
from gpu_stereo_matching_tpu.utils import cache as jcache
from gpu_stereo_matching_tpu_torch import bench
from gpu_stereo_matching_tpu_torch.bench import (
    headline,
    micro,
    roofline,
    scaling,
    st2_streaming,
    st_config3,
    st_hd,
    st_profile,
    st_streaming,
    streaming,
)
from gpu_stereo_matching_tpu_torch.cli import main as tcli
from gpu_stereo_matching_tpu_torch.io.calib_yaml import save_opencv_stereo_yaml
from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, resize_bilinear_u8, save_image
from gpu_stereo_matching_tpu_torch.tree.builder import build_segment_tree, color_edge_weights
from gpu_stereo_matching_tpu_torch.tree.stride import StridePlan
from tests.torch_st_helpers import fresh_registries  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ST runs SegmentTreeConfig() (D = 60), so the scene is wider than 60.
SCENE_HW = (32, 64)


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """A Middlebury-style ``Synth`` scene: the art view scaled to
    ``SCENE_HW``, the right view shifted by 0-8 px by row."""
    root = tmp_path_factory.mktemp("scenes")
    h, w = SCENE_HW
    left = resize_bilinear_u8(load_image_bgr(os.path.join(ROOT, "examples", "art_left.png")),
                              SCENE_HW)
    shift = 8 * np.arange(h) // (h - 1)
    cols = np.minimum(np.arange(w)[None, :] + shift[:, None], w - 1)
    right = np.ascontiguousarray(left[np.arange(h)[:, None], cols])
    os.makedirs(root / "Synth")
    save_image(root / "Synth" / "view1.png", left)
    save_image(root / "Synth" / "view5.png", right)
    return str(root)


def test_micro_keys_match_jax(capsys):
    got = micro.run_micro_benchmarks(16, 32, 2, device="cpu")
    want = jmicro.run_micro_benchmarks(16, 32, 2)
    assert set(got) == {k.replace("_tpu", "_device") for k in want}
    assert all(v > 0 for v in got.values())
    assert "device: cpu" in capsys.readouterr().out


def test_headline_prints_bench_py_keys(capsys):
    fps = headline.main(batch=2, reps=1, height=24, width=40, num_disp=8, radius=2,
                        device="cpu")
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and fps > 0
    assert set(lines[0]) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[0]["metric"] == "block_matching_24p_8disp_fps_per_chip"


def test_bench_command_dispatches_to_the_headline(monkeypatch):
    calls = []
    monkeypatch.setattr(headline, "main", lambda **kw: calls.append(kw) or 1.0)
    assert tcli.main(["bench"]) == 0
    assert calls == [{}]

    def commands(parser):
        return set(parser._subparsers._group_actions[0].choices)

    assert commands(tcli.build_parser()) == commands(jcli.build_parser())


def test_streaming_on_a_synthetic_yaml(tmp_path, capsys):
    path = str(tmp_path / "calib.yml")
    save_opencv_stereo_yaml(path, streaming.synthetic_calibration())
    fps = streaming.run_streaming_benchmark(path, 24, 40, (720, 1280), num_frames=2,
                                            num_disparities=8, radius=2, reps=1, device="cpu")
    (line,) = _json_lines(capsys.readouterr().out)
    assert fps > 0 and line["metric"] == "rig_streaming_24p_8disp_fps"
    assert set(line) == {"metric", "value", "unit"}


def test_st_profile_sizes_match_jax(fresh_registries, scene_root, monkeypatch, capsys):
    monkeypatch.setattr(jcache, "enable_jit_cache", lambda *a, **k: None)
    got = st_profile.run_profile(scene_root, "Synth", group_size=2, reps=1, device="cpu")
    want = jst_profile.run_profile(scene_root, "Synth", group_size=2, reps=1)
    assert set(got) == set(want)
    sizes = [k for k in want if k.endswith("_mb") or k.endswith("_mb_per_frame")]
    assert sizes and {k: got[k] for k in sizes} == {k: want[k] for k in sizes}
    assert all(got[k] > 0 for k in got if k.endswith("_ms") or k.endswith("_ms_per_frame"))
    assert set(_json_lines(capsys.readouterr().out)[0]) == set(want)


@pytest.mark.parametrize("run,keys", [
    (lambda root: st_streaming.run_st_streaming_benchmark(
        root, "Synth", num_frames=2, group_size=2, workers=2, device="cpu"),
     [{"metric", "value", "unit"}] * 2),
    (lambda root: st2_streaming.run_st2_streaming_benchmark(
        root, "Synth", num_frames=2, group_size=2, workers=2, device="cpu"),
     [{"metric", "value", "unit"}] * 2),
    # JAX's ``compile_plus_first_s`` is ``first_call_s``: nothing compiles.
    (lambda root: st_hd.run_st_hd(root, "Synth", group_size=2, reps=1, bands_list=(2,),
                                  workers=2, size_hw=SCENE_HW, device="cpu"),
     [{"shape", "group", "tree_build_ms_per_frame", "plan_emit_ms_per_frame", "total_pos",
       "pad_over_n", "plan_mb_per_frame", "first_call_s", "device_ms_per_frame",
       "device_fps_per_chip"},
      {"shape", "group", "bands", "host_cpus", "host_ms_per_frame", "plan_mb_per_frame",
       "device_ms_per_frame", "device_fps_per_chip", "bad2_vs_global_pct", "host_solvent"}]),
    (lambda root: st_config3.run_config3(root, "Synth", num_disp=16, group=2, device="cpu"),
     [{"metric", "value", "unit", "ms_per_frame"}, {"metric", "value", "unit"}]),
], ids=["st_streaming", "st2_streaming", "st_hd", "st_config3"])
def test_st_bench_runs_and_prints_the_jax_keys(fresh_registries, scene_root, capsys, run, keys):
    out = run(scene_root)
    lines = _json_lines(capsys.readouterr().out)
    assert [set(x) for x in lines] == keys
    assert out


def test_st_bench_metric_names(fresh_registries, scene_root, capsys):
    st_streaming.run_st_streaming_benchmark(scene_root, "Synth", num_frames=2, group_size=2,
                                            device="cpu")
    st2_streaming.run_st2_streaming_benchmark(scene_root, "Synth", num_frames=2, group_size=2,
                                              device_rate_lean=False, device="cpu")
    h, w = SCENE_HW
    assert [x["metric"] for x in _json_lines(capsys.readouterr().out)] == [
        f"st1_device_{h}x{w}_fps_per_chip", f"st1_streaming_e2e_{h}x{w}_fps",
        f"st2_device_{h}x{w}_fps_per_chip_resident", f"st2_streaming_e2e_{h}x{w}_fps"]


def test_filter_roofline_counts_match_jax(fresh_registries, scene_root):
    from gpu_stereo_matching_tpu_torch.io.middlebury import load_middlebury_scene

    left = load_middlebury_scene(scene_root, "Synth").left_bgr
    h, w = left.shape[:2]
    weights = color_edge_weights(left)
    tree, jtree = build_segment_tree(weights, h, w), jbuild(weights, h, w)
    got = roofline.st_filter_roofline(StridePlan.from_tree(tree, 0.1), 60, 2.0)
    want = jroofline.st_filter_roofline(JStridePlan.from_tree(jtree, 0.1, device=False), 60, 2.0)
    assert got["gather_rows"] == want["gather_rows"] > 0
    assert got["scan_ops"] == want["scan_vpu_ops"] == 2 * got["scan_elems"] * 60 * 6
    assert got["gather_bytes"] == got["gather_rows"] * 60 * 4
    assert got["bound_ms"] == max(got["gather_hbm_floor_ms"], got["scan_ops_ms"])


def test_fused_roofline_is_the_function_bound():
    row = roofline.fused_sad_roofline(1080, 1920, 64, 5, 0.0564)
    assert f"{row['bound_ms']:.4g}" == "0.01585" and row["bound"] == "operations"
    assert (row["ops"], row["hbm_bytes"]) == roofline.fused_sad_work(1080, 1920, 64)
    assert row["measured_over_bound"] == pytest.approx(0.0564 / row["bound_ms"])
    front = roofline.remap_roofline(720, 1280, 16, 0.1)
    assert (front["ops"], front["hbm_bytes"]) == roofline.remap_work(16, 720 * 1280, 2, True)
    assert not [n for n in dir(roofline) if n.startswith("V5E") or n == "GATHER_NS_PER_ROW"]


def test_roofline_main_with_given_times(capsys):
    rows = roofline.main(["--sad-1080p-ms", "0.06", "--sad-4k-ms", "0.24", "--remap-ms", "0.2"])
    assert [r["kernel"] for r in rows] == ["fused_sad_wta", "fused_sad_wta",
                                           "rectify_gray_pair", "st_stride_filter"]
    assert "skipped" in rows[-1]
    assert len(_json_lines(capsys.readouterr().out)) == 4


@pytest.mark.parametrize("n_chips", [4, 8])
def test_scaling_prediction_matches_jax(n_chips):
    kw = dict(h=720, w=1280, sad_radius=4, median_radius=2, n_chips=n_chips)
    got = scaling.predict_scaling_efficiency(**kw, compute_ms_per_frame=0.0564)
    want = jscaling.predict_scaling_efficiency(**kw)
    assert [(r["strategy"], r["comm_bytes_per_frame"]) for r in got] == \
        [(r["strategy"], r["comm_bytes_per_frame"]) for r in want]
    assert all(0 < r["predicted_efficiency"] <= 1 for r in got)
    disp = next(r for r in got if r["strategy"].startswith("disp_wta"))
    assert not disp["meets_85pct"]


def test_scaling_prediction_prints_the_worst_prescribed(capsys):
    rows = scaling.print_scaling_prediction(compute_ms_per_frame=0.0564)
    last = _json_lines(capsys.readouterr().out)[-1]
    assert last["metric"] == "predicted_scaling_efficiency_config5"
    assert last["value"] == min(r["predicted_efficiency"] for r in rows
                                if "not prescribed" not in r["strategy"])
    model = scaling.key_allreduce_model_ms()
    assert model == pytest.approx(1.5 * 8 * 1080 * 1920 * 4 / 4.5e11 * 1e3)


def test_bench_exports_match_jax():
    import gpu_stereo_matching_tpu.bench as jbench

    names = {"evaluate_scene", "run_middlebury_suite", "run_micro_benchmarks",
             "run_scaling_benchmark", "run_streaming_benchmark"}
    assert set(bench.__all__) == names and names <= set(vars(jbench))
    assert bench.run_micro_benchmarks is micro.run_micro_benchmarks
    assert bench.run_streaming_benchmark is streaming.run_streaming_benchmark
    assert bench.run_scaling_benchmark is scaling.run_scaling_benchmark


def test_benches_raise_without_a_card(scene_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    calls = [
        lambda: headline.main(batch=1, reps=1, height=8, width=16, num_disp=4, radius=1),
        lambda: micro.run_micro_benchmarks(8, 16, 1),
        lambda: streaming.run_streaming_benchmark(str(tmp_path / "absent.yml")),
        lambda: st_profile.run_profile(scene_root, "Synth"),
        lambda: st_streaming.run_st_streaming_benchmark(scene_root, "Synth"),
        lambda: st2_streaming.run_st2_streaming_benchmark(scene_root, "Synth"),
        lambda: st_hd.run_st_hd(scene_root, "Synth"),
        lambda: st_config3.run_config3(scene_root, "Synth"),
        lambda: roofline.main([]),
        lambda: scaling.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benches' kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_headline_and_micro_on_the_card(cuda_device, capsys):
    fps = headline.main(batch=2, reps=1, height=64, width=128, num_disp=16, radius=2)
    (line,) = _json_lines(capsys.readouterr().out)
    assert fps > 0 and "card" in line
    got = micro.run_micro_benchmarks(32, 64, 2)
    assert all(v > 0 for v in got.values())
    assert capsys.readouterr().out.startswith("card: ")
