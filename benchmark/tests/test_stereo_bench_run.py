"""Whole runs of the harness on the CPU at a tiny size: the result line's
keys, a correct run, and each fault planted under the entry coming out not
correct; the refusals; one short run on the card where there is one."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import faults
from benchmark.registry import BENCHMARK_JSON, HERE, Registry
from benchmark.run import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**31 + 101


@pytest.mark.parametrize("cell", ["fused.tiny", "plus.tiny"])
def test_a_run_is_correct_and_its_line_ends_with_the_checks(cell, tiny):
    result, lines, checks = run_cell(tiny, cell, SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert list(result) == KEYS + ["checks"]
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"frames_per_s", "call_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["disparity_mismatch_px"] == {"value": 0, "at_most": 0}
    assert result["checks"]["pool_batches_checked"] == {"value": 2, "at_least": 2}
    assert checks[0] == "check disparity_mismatch_px 0 at_most 0"
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
@pytest.mark.parametrize("cell", ["fused.tiny", "plus.tiny"])
def test_a_planted_fault_is_not_correct(fault, cell, tiny):
    result, _, _ = run_cell(tiny, cell, SEED, 0.5, False, torch.device("cpu"), 0.0,
                            wrap=faults.FAULTS[fault])
    assert not result["correct"]
    assert result["failed"] >= 1 and result["checks"]["disparity_mismatch_px"]["value"] > 0


@pytest.mark.parametrize("cell", ["fused.tiny", "plus.tiny"])
def test_a_state_left_unchanged_fails_on_every_seed(cell, tiny):
    """Every batch of the pool is compared, so maps that never change after
    the first call fail whatever calls the seed draws."""
    for seed in range(2**31 + 1, 2**31 + 9):
        result, _, _ = run_cell(tiny, cell, seed, 0.2, False, torch.device("cpu"), 0.0,
                                wrap=faults.unchanged_state)
        assert not result["correct"], seed
        assert result["checks"]["pool_batches_checked"]["value"] == 2


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
