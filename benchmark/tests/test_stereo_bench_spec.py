"""BENCHMARK.json against the benchmark's contract, and every part it names
found by name; a configuration, a mix, a metric and cells added from a
temporary directory without editing a file that is there."""

import json
import re

import pytest

from benchmark.registry import BENCHMARK_JSON, HERE, Registry
from benchmark.run import MAX_EXCUSED_SHARE, comparison_of

SPEC = json.loads(BENCHMARK_JSON.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E_NAMES = [m["name"] for m in SPEC["end_to_end"]]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # 24 cells of 14 runs (and 2 more), each with a minute's margin and each cell
    # with 3 minutes to compile, fit in 12 hours at this length.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(BENCHMARK_JSON.read_bytes()) <= 64 * 1024


def test_names_units_and_one_line_fields():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    names = [e["name"] for e in named]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in SPEC[group]]
        assert len(group_names) == len(set(group_names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("metric", SPEC["end_to_end"], ids=E2E_NAMES)
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_has_a_reader_that_names_its_layer(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["moves"] in E2E_NAMES
    assert set(metric["workloads"]) <= set(CELLS)
    reader = Registry().metric(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (metric["layer"], metric["unit"],
                                                         metric["moves"])
    assert metric["unit"] == "%" or "roofline" not in metric["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports_enough(cell):
    found = Registry().cell(cell)
    assert found.chips == 1
    reported = [m["name"] for m in found.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert found.per_layer
    config = next(c for c in SPEC["configs"] if c["name"] == found.config["name"])
    assert config["file"].startswith("benchmark/") and config["reduced"] == found.config["reduced"]
    assert found.config["source"] == config["source"]


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_a_stated_comparison_excuses_a_bounded_share_for_a_reason(name):
    config = Registry().config(name)
    comparison = comparison_of(config)
    assert comparison == config.get("comparison")
    if comparison is not None:
        assert 0 <= comparison["excused_share_at_most"] <= MAX_EXCUSED_SHARE
        assert comparison["why"].strip() and "\n" not in comparison["why"]


@pytest.mark.parametrize("comparison", [
    {"excused_share_at_most": 0.011, "why": "over the most"},
    {"excused_share_at_most": -0.001, "why": "under nothing"},
    {"excused_share_at_most": 0.001, "why": " "},
    {"excused_share_at_most": 0.001},
    {"excused_share_at_most": "0.001", "why": "not a number"},
    {"excused_share_at_most": 0.001, "why": "near-ties", "margin": 1e-5},
])
def test_a_comparison_out_of_bounds_is_refused(comparison):
    with pytest.raises(ValueError):
        comparison_of({"name": "c", "comparison": comparison})
    assert comparison_of({"name": "c"}) is None
    assert MAX_EXCUSED_SHARE == 0.01


def test_configs_and_files_are_one_to_one():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries only: a configuration, a mix, a
    metric and the cells that use them."""
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    config = json.loads((HERE / "configs" / "rig800-plus.json").read_text())
    config.update(name="rig800-plus-r3", sad_radius=3)
    (tmp_path / "configs" / "rig800-plus-r3.json").write_text(json.dumps(config))
    mix = json.loads((HERE / "traffic" / "resident-b8.json").read_text())
    mix.update(name="resident-b4", batch=4)
    (tmp_path / "traffic" / "resident-b4.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "calls_per_s.py").write_text(
        "LAYER = 'Entry: StereoRig.process_batch'\n"
        "def read(run):\n    return len(run.span_calls)\n")
    spec = json.loads(BENCHMARK_JSON.read_text())
    spec["workloads"].append({"name": "rig800-plus.resident-b4", "config": "rig800-plus",
                              "traffic": "resident-b4", "chips": 1, "why": "smaller batches"})
    spec["workloads"].append({"name": "rig800-plus-r3.resident-b8", "config": "rig800-plus-r3",
                              "traffic": "resident-b8", "chips": 1, "why": "a smaller window"})
    spec["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "Entry: StereoRig.process_batch",
                              "moves": "frames_per_s", "workloads": ["rig800-plus.resident-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    registry = Registry(tmp_path / "BENCHMARK.json", [tmp_path, HERE])
    cell = registry.cell("rig800-plus.resident-b4")
    assert cell.traffic["batch"] == 4 and cell.config["name"] == "rig800-plus"
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s"]
    assert registry.metric("calls_per_s").read(type("R", (), {"span_calls": [1, 2]})) == 2
    assert registry.cell("rig800-plus-r3.resident-b8").config["sad_radius"] == 3
    with pytest.raises(KeyError):
        registry.cell("rig800-plus.resident-b3")
