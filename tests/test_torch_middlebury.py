"""The port's Middlebury harness (``bench/middlebury.py``) and the
``middlebury`` command on the CPU, against the JAX package's on a scene
written to a temporary directory: a textured view, its copy shifted by 6
columns, and ground truth of 3 × the shift in both views, as Middlebury's
third-size scenes store it. Block matching is exact in both packages, so
its rates are equal; the ST filters sum floats in their own orders (XLA
contracts some multiply-adds), so ST-1 is held to 0.01 and ST-2 to 0.03 of
the rate, the shares of equal pixels the ST tests hold. Then the OpenCV
baselines where ``cv2`` is installed, and on a card the card against the
CPU."""

import contextlib
import io

import numpy as np
import pytest
import torch
from PIL import Image

from gpu_stereo_matching_tpu.bench import middlebury as jbench
from gpu_stereo_matching_tpu.cli import main as jcli
from gpu_stereo_matching_tpu.io import middlebury as jmb
from gpu_stereo_matching_tpu_torch.bench import middlebury as tbench
from gpu_stereo_matching_tpu_torch.cli.main import main as tcli
from gpu_stereo_matching_tpu_torch.io import middlebury as tmb
from tests.torch_st_helpers import fresh_registries  # noqa: F401

SHIFT = 6
TOLERANCE = {"bm": 0.0, "bm+": 0.0, "st1": 0.01, "st2": 0.03}


def _write_scene(root, name="Synth", h=24, w=96, gt=True):
    """``view1.png``/``view5.png`` (BGR as Middlebury's PNGs hold RGB) and,
    with ``gt``, ``disp1.png``/``disp5.png``."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, (h, (w + SHIFT + 3) // 4, 3), dtype=np.uint8)
    base = np.repeat(base, 4, axis=1)[:, :w + SHIFT]
    d = root / name
    d.mkdir(parents=True)
    Image.fromarray(np.ascontiguousarray(base[:, SHIFT:])).save(d / "view1.png")
    Image.fromarray(np.ascontiguousarray(base[:, :w])).save(d / "view5.png")
    if gt:
        disp = np.full((h, w), 3 * SHIFT, np.uint8)
        disp[:, :SHIFT] = 0
        Image.fromarray(disp).save(d / "disp1.png")
        Image.fromarray(disp).save(d / "disp5.png")
    return root


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = _write_scene(tmp_path_factory.mktemp("middlebury"))
    _write_scene(root, "NoGT", gt=False)
    return root


@pytest.mark.parametrize("pipeline", ["bm", "bm+", "st1", "st2"])
def test_evaluate_scene_matches_jax(fresh_registries, scene_root, pipeline):
    got = tbench.evaluate_scene(tmb.load_middlebury_scene(scene_root, "Synth"), pipeline,
                                device="cpu")
    want = jbench.evaluate_scene(jmb.load_middlebury_scene(scene_root, "Synth"), pipeline)
    assert (got.scene, got.pipeline) == ("Synth", pipeline) and got.seconds > 0
    assert got.bad2 == pytest.approx(want.bad2, abs=TOLERANCE[pipeline])
    assert got.bad2_nonocc == pytest.approx(want.bad2_nonocc, abs=TOLERANCE[pipeline])
    assert set(got.as_dict()) == set(want.as_dict())


def _lines(text):
    """Printed lines without the times."""
    return [line.rsplit(" ", 2)[0].rstrip() if line.endswith(" ms") else line
            for line in text.splitlines()]


def test_suite_and_command_match_jax(fresh_registries, scene_root, capsys):
    """``run_middlebury_suite`` lists the scenes with ground truth; the
    command prints a line a pipeline and scene, then the mean, as the JAX
    command does."""
    got = tbench.run_middlebury_suite(str(scene_root), ["bm", "st1"], device="cpu")
    printed = capsys.readouterr().out
    assert [(r.scene, r.pipeline) for r in got] == [("Synth", "bm"), ("Synth", "st1")]
    assert tcli(["middlebury", "--root", str(scene_root), "--pipelines", "bm,st1",
                 "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert _lines(ours)[:2] == _lines(printed)
    with contextlib.redirect_stdout(io.StringIO()) as theirs:
        assert jcli.main(["middlebury", "--root", str(scene_root), "--pipelines", "bm,st1"]) == 0
    assert _lines(ours)[0] == _lines(theirs.getvalue())[0]  # bm: exact in both
    assert ours.splitlines()[-1].startswith("mean bad-2.0 over 2 runs: ")
    both = tbench.run_middlebury_suite(str(scene_root), ["bm"], scenes=["NoGT", "Synth"],
                                       device="cpu")
    assert [(r.scene, r.bad2 is None) for r in both] == [("NoGT", True), ("Synth", False)]
    assert "NoGT         bm   bad2=     n/a nonocc=     n/a" in capsys.readouterr().out


def test_harness_refuses_and_asks_for_the_card(scene_root, monkeypatch):
    scene = tmb.load_middlebury_scene(scene_root, "Synth")
    with pytest.raises(ValueError, match="unknown pipeline 'sgm'"):
        tbench.evaluate_scene(scene, "sgm", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.evaluate_scene(scene, "bm")


@pytest.mark.parametrize("pipeline", ["opencv-bm", "opencv-sgbm"])
def test_opencv_baselines_match_jax(scene_root, pipeline):
    pytest.importorskip("cv2")
    got = tbench.evaluate_scene(tmb.load_middlebury_scene(scene_root, "Synth"), pipeline,
                                device="cpu")
    want = jbench.evaluate_scene(jmb.load_middlebury_scene(scene_root, "Synth"), pipeline)
    assert (got.bad2, got.bad2_nonocc) == (want.bad2, want.bad2_nonocc)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_harness_on_the_card_equals_the_cpu(card, scene_root):
    """Each pipeline's rates on the card equal the CPU's; bm launches E1 and
    E2 once, bm+ E1, E2, E2's right-view body with the LR check and D once
    each, ST-1 D once, ST-2 D three times."""
    from gpu_stereo_matching_tpu_torch.kernels import ctmf_median, split_phase

    def counts():
        return (split_phase.LAUNCHES["sad_volume"], split_phase.LAUNCHES["wta_from_sad"],
                split_phase.LAUNCHES["lr_check_from_sad"], ctmf_median.LAUNCHES)

    scene = tmb.load_middlebury_scene(scene_root, "Synth")
    for pipeline, launches in (("bm", (1, 1, 0, 0)), ("bm+", (1, 1, 1, 1)),
                               ("st1", (0, 0, 0, 1)), ("st2", (0, 0, 0, 3))):
        before = counts()
        got = tbench.evaluate_scene(scene, pipeline, device=card)
        after = counts()
        assert tuple(a - b for a, b in zip(after, before)) == launches
        want = tbench.evaluate_scene(scene, pipeline, device="cpu")
        assert (got.bad2, got.bad2_nonocc) == (want.bad2, want.bad2_nonocc)
