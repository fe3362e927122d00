"""A cell added by new files and entries alone, as a later change adds one:
the toy float system (``toy_float_system.py``, with a ``tiny`` and a
``CALL_SPAN`` of its own), its configuration and mix, and its name in every
metric's ``workloads`` list, in a temporary directory. Its stand-in joins
the tiny registry beside the rig's, runs through ``run_cell``, and its calls
are read by its own span."""

import json
from pathlib import Path

import torch

from benchmark import trace
from benchmark.registry import BENCHMARK_JSON, HERE, Registry
from benchmark.run import run_cell
from benchmark.tests.conftest import STAND_INS, TOY_CONFIG, tiny_registry

CPU = torch.device("cpu")
SEED = 2**31 + 303
TOY_CELL = "toy-proof.stream"
TOY_SOURCE = Path(__file__).with_name("toy_float_system.py")
TOY_STAND_IN = "toy-proof.tiny"


def _with_cell(root: Path, cell: str, system: str, source: str) -> Registry:
    """The registry under ``root`` (the benchmark's, at first) with one more
    cell ``cell``: the toy configuration, named by the cell's first part,
    run by ``systems/<system>.py`` (``source``), on a mix of its own; its
    name is appended to every metric's ``workloads``."""
    for kind in ("configs", "traffic", "systems"):
        (root / kind).mkdir(parents=True, exist_ok=True)
    (root / "systems" / f"{system}.py").write_text(source)
    config = cell.split(".")[0]
    (root / "configs" / f"{config}.json").write_text(json.dumps(
        {**TOY_CONFIG, "name": config, "system": system, "image_hw": [720, 1280]}))
    mix = json.loads((HERE / "traffic" / "resident-b8.json").read_text())
    mix.update(name="toy-stream", batch=4)
    (root / "traffic" / "toy-stream.json").write_text(json.dumps(mix))
    spec_path = root / "BENCHMARK.json"
    spec = json.loads((spec_path if spec_path.is_file() else BENCHMARK_JSON).read_text())
    spec["configs"].append({"name": config, "source": "a toy", "reduced": [], "why": "toy",
                            "file": f"benchmark/configs/{config}.json"})
    spec["workloads"].append({"name": cell, "config": config, "traffic": "toy-stream",
                              "chips": 1, "why": "toy"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    spec_path.write_text(json.dumps(spec))
    return Registry(spec_path, [root, HERE])


def _toy_tiny(tmp_path) -> Registry:
    base = _with_cell(tmp_path / "base", TOY_CELL, "toy_proof", TOY_SOURCE.read_text())
    return tiny_registry(tmp_path / "tiny", base)


def test_a_cell_added_by_files_and_entries_gets_a_stand_in_that_runs(tmp_path):
    tiny = _toy_tiny(tmp_path)
    assert [w["name"] for w in tiny.spec["workloads"]] == [*STAND_INS, TOY_STAND_IN]
    assert tiny.config(TOY_STAND_IN)["image_hw"] == [128, 256]
    for metric in tiny.spec["end_to_end"] + tiny.spec["per_layer"]:
        assert metric.get("workloads", [TOY_STAND_IN])[-1] == TOY_STAND_IN, metric["name"]
    for cell in [*STAND_INS, TOY_STAND_IN]:
        result, _, checks = run_cell(tiny, cell, SEED, 0.5, False, CPU, 0.0)
        assert result["correct"], (cell, checks)
        assert set(result["metrics"]) == {"frames_per_s", "call_p95_ms", "setup_s"}


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


# A window of 1000 us holding two toy calls of 2 launches each and a kernel.
TOY_EVENTS = [
    _x("user_annotation", trace.WINDOW, 0.0, 1000.0),
    _x("user_annotation", "toy.process_batch", 100.0, 300.0),
    _x("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0),
    _x("cuda_runtime", "cudaLaunchKernel", 220.0, 5.0),
    _x("user_annotation", "toy.process_batch", 500.0, 300.0),
    _x("cuda_runtime", "cudaLaunchKernel", 520.0, 5.0),
    _x("cuda_runtime", "cudaLaunchKernel", 620.0, 5.0),
    _x("kernel", "toy_kernel", 150.0, 100.0),
]


def test_the_new_cell_s_calls_are_read_by_its_own_span(tmp_path, monkeypatch):
    """``run_cell`` hands the readers the system's ``CALL_SPAN``: the toy's
    traced run counts its calls' launches, the rig's finds no call in it."""
    tiny = _toy_tiny(tmp_path)
    monkeypatch.setattr(trace, "profiled", lambda fn: (fn(), trace.parse(TOY_EVENTS)))
    toy, _, _ = run_cell(tiny, TOY_STAND_IN, SEED, 0.5, True, CPU, 0.0)
    assert toy["correct"] and toy["metrics"]["entry.launches"]["value"] == 2.0
    assert toy["metrics"]["device_idle.in_program_pct"]["value"] > 0
    rig, _, _ = run_cell(tiny, STAND_INS[0], SEED, 0.5, True, CPU, 0.0)
    assert rig["correct"] and "entry.launches" not in rig["metrics"]


def test_a_cell_whose_system_has_no_stand_in_is_left_out(tmp_path):
    _with_cell(tmp_path / "base", TOY_CELL, "toy_proof", TOY_SOURCE.read_text())
    base = _with_cell(tmp_path / "base", "no-tiny.stream", "no_tiny",
                      "from benchmark.tests.toy_float_system import build, reference\n")
    tiny = tiny_registry(tmp_path / "tiny", base)
    assert [w["name"] for w in tiny.spec["workloads"]] == [*STAND_INS, TOY_STAND_IN]
    for metric in tiny.spec["end_to_end"] + tiny.spec["per_layer"]:
        assert "no-tiny.stream" not in metric.get("workloads", [])
