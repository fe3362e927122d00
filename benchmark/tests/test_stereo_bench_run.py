"""Whole runs of the harness on the CPU at a tiny size: the result line's
keys, a correct run, and each fault planted under the entry coming out not
correct; a float system whose reference excuses its near-ties, and what the
excuse may and may not hide; the refusals; one short run on the card where
there is one."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.control import control
from benchmark.registry import BENCHMARK_JSON, HERE, Registry
from benchmark.run import comparison_of, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**31 + 101


def test_a_run_is_correct_and_its_line_ends_with_the_checks(stand_in, tiny):
    result, lines, checks = run_cell(tiny, stand_in, SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"frames_per_s", "call_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["disparity_mismatch_px"] == {"value": 0, "at_most": 0}
    assert result["checks"]["pool_batches_checked"] == {"value": 2, "at_least": 2}
    assert checks[0] == "check disparity_mismatch_px 0 at_most 0"
    # The excused line only under a stated comparison (the rig's are exact).
    excused = ["disparity_excused_px"] if comparison_of(tiny.cell(stand_in).config) else []
    assert [c.split()[1] for c in checks] == ["disparity_mismatch_px", *excused,
                                             "frames_checked", "pool_batches_checked"]
    assert list(json.loads(lines[0])) == ["setup_stages_s"]
    json.dumps(result)


def test_a_traced_run_gives_the_per_layer_metrics_and_a_breakdown(tiny):
    result, lines, _ = run_cell(tiny, "plus.tiny", SEED, 1.0, True, torch.device("cpu"), 0.0)
    assert list(result) == KEYS + ["breakdown", "checks"]
    assert result["correct"]
    # The CPU has no device trace: only the readers with something to read report.
    assert set(result["metrics"]) == {"device_idle_pct", "entry.enqueue_ms"}
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(json.loads(lines[1])) == {"kernels_by_metric", "other"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault, stand_in, tiny):
    result, _, _ = run_cell(tiny, stand_in, SEED, 0.5, False, torch.device("cpu"), 0.0,
                            wrap=faults.for_config(tiny.cell(stand_in).config)[fault])
    assert not result["correct"]
    assert result["failed"] >= 1 and result["checks"]["disparity_mismatch_px"]["value"] > 0


def test_a_state_left_unchanged_fails_on_every_seed(stand_in, tiny):
    """Every batch of the pool is compared, so maps that never change after
    the first call fail whatever calls the seed draws."""
    for seed in range(2**31 + 1, 2**31 + 9):
        result, _, _ = run_cell(tiny, stand_in, seed, 0.2, False, torch.device("cpu"), 0.0,
                                wrap=faults.unchanged_state)
        assert not result["correct"], seed
        assert result["checks"]["pool_batches_checked"]["value"] == 2


CPU = torch.device("cpu")


@pytest.mark.parametrize("flip,share,correct", [
    ("none", 0.01, True),
    ("excused", 0.01, True),       # every excused pixel off: all of it excused
    ("unexcused", 0.01, False),    # one pixel off outside the mask
    ("excused", 0.001, False),     # the reference excuses more than the share allows
])
def test_a_float_configuration_excuses_only_its_reference_s_near_ties(flip, share, correct,
                                                                       toy):
    registry = toy({"toy_flip": flip, "comparison": {
        "excused_share_at_most": share, "why": "near-ties"}})
    result, _, lines = run_cell(registry, "toy.tiny", SEED, 0.5, False, CPU, 0.0)
    checks = result["checks"]
    assert result["correct"] == correct
    assert list(checks) == ["disparity_mismatch_px", "disparity_excused_px", "frames_checked",
                            "pool_batches_checked"]
    excused = checks["disparity_excused_px"]
    assert excused["of"] == checks["frames_checked"]["value"] * 128 * 256
    assert excused["at_most"] == int(share * excused["of"])
    assert 0.002 < excused["value"] / excused["of"] < 0.01  # about one sum in 128
    assert lines[1] == (f"check disparity_excused_px {excused['value']} at_most "
                        f"{excused['at_most']} of {excused['of']}")
    unexcused = checks["disparity_mismatch_px"]["value"]
    assert unexcused == (checks["frames_checked"]["value"] // 2 if flip == "unexcused" else 0)
    assert result["failed"] == (0 if flip != "unexcused" else unexcused)


@pytest.mark.parametrize("wrap", ["control", *sorted(faults.FAULTS)])
def test_under_a_comparison_the_control_and_each_fault_are_not_correct(wrap, toy):
    """They fail on pixels the reference does not excuse, with the excused
    share inside its limit."""
    registry = toy()
    cell = registry.cell("toy.tiny")
    planted = (control(registry, "toy.tiny", CPU) if wrap == "control"
               else faults.for_config(cell.config)[wrap])
    for seed in (SEED, SEED + 1, 7):
        result, _, _ = run_cell(registry, "toy.tiny", seed, 0.3, False, CPU, 0.0, wrap=planted)
        checks = result["checks"]
        assert not result["correct"] and result["failed"] >= 1, seed
        assert checks["disparity_mismatch_px"]["value"] > 0
        assert checks["disparity_excused_px"]["value"] <= checks["disparity_excused_px"]["at_most"]


def test_the_altered_answer_alters_one_pixel_a_tile_under_a_comparison():
    maps = torch.zeros(2, 100, 130, dtype=torch.uint8)
    entry = lambda left, right: maps  # noqa: E731
    tiled = faults.for_config({"comparison": {}})["altered_answer"](entry)(None, None)
    assert int((tiled != maps).sum()) == 2 * 3 and not tiled[1].any()
    assert tiled[0, 32, 32] == 1 and tiled[0, 82, 129] == 1  # a ragged tile's own centre
    single = faults.for_config({})["altered_answer"](entry)(None, None)
    assert int((single != maps).sum()) == 1 and single[0, 50, 65] == 1


@pytest.mark.parametrize("changes,match", [
    ({"comparison": None}, "states no comparison"),
    ({"comparison": {"excused_share_at_most": 0.02, "why": "too much"}}, "a share in"),
])
def test_a_mask_without_a_bounded_comparison_raises(changes, match, toy):
    registry = toy(changes)
    with pytest.raises(ValueError, match=match):
        run_cell(registry, "toy.tiny", SEED, 0.2, False, CPU, 0.0)


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd)


def test_without_a_card_it_refuses_and_prints_no_result(tmp_path):
    """Here there is no card; in a copy holding only BENCHMARK.json and the
    benchmark's folder the program is missing too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCHMARK_JSON, tmp_path / "BENCHMARK.json")
    args = ["--workload", "rig800-fused.resident-b16", "--seed", str(SEED), "--seconds", "1"]
    for cwd in (HERE.parent, tmp_path):
        out = _run(args, cwd)
        assert out.returncode != 0 and out.stdout.strip() == ""
    assert _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1"],
                HERE.parent).returncode != 0


@pytest.mark.gpu
def test_a_short_run_on_the_card(cuda_device):
    result, _, checks = run_cell(Registry(), "rig800-fused.resident-b16", SEED, 1.0, False,
                                 cuda_device, 0.0)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
