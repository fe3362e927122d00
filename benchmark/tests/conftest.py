"""A tiny registry beside the real one: the configurations cut to 40x64 at
16 disparities, a traffic mix of 2 pairs a call, and a BENCHMARK.json whose
cells use them, all in a temporary directory; nothing of ``benchmark/`` is
edited. A toy registry adds a float system whose reference excuses pixels
(``toy_float_system.py``)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

# One thread a test process: parallel workers would otherwise oversubscribe
# the cores and stretch a run's short window to a call or two.
torch.set_num_threads(1)

from benchmark.registry import BENCHMARK_JSON, HERE, Registry


def tiny_registry(root: Path) -> Registry:
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    spec = json.loads(BENCHMARK_JSON.read_text())
    for name in ("rig800-fused", "rig800-plus"):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg.update(name=f"{name}-tiny", image_hw=[40, 64], num_disparities=16, sad_radius=2)
        for key in ("left_intrinsics", "right_intrinsics"):
            k = cfg["calibration"][key]
            k[0][0] /= 20
            k[1][1] /= 20
            k[0][2], k[1][2] = 32.0, 20.0
        (root / "configs" / f"{name}-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "resident-b8.json").read_text())
    mix.update(name="resident-b8-tiny", batch=2, pool_batches=2)
    mix["scene"].update(max_disparity=12, background_disparity=[1, 5],
                        object_disparity=[4, 12], texture_scales=[2, 4, 8])
    (root / "traffic" / "resident-b8-tiny.json").write_text(json.dumps(mix))
    cells = {"fused.tiny": ("rig800-fused-tiny", "resident-b8-tiny"),
             "plus.tiny": ("rig800-plus-tiny", "resident-b8-tiny")}
    stands_for = {"rig800-fused.resident-b16": ["fused.tiny"],
                  "rig800-plus.resident-b8": ["plus.tiny"]}
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                         for n, (c, t) in cells.items()]
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [t for w in metric["workloads"] for t in stands_for[w]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root / "BENCHMARK.json", [root, HERE])


TOY_CONFIG = {"name": "toy-float", "system": "toy_float", "image_hw": [128, 256],
              "quantum": 128, "toy_flip": "none",
              "comparison": {"excused_share_at_most": 0.01,
                             "why": "sums on a step of the quantum may round either way"}}


def toy_registry(root: Path, changes: dict = None) -> Registry:
    """The tiny registry and a cell ``toy.tiny`` of the toy float system,
    its configuration ``TOY_CONFIG`` with ``changes`` (None drops a key)."""
    tiny_registry(root)
    (root / "systems").mkdir()
    shutil.copy(Path(__file__).with_name("toy_float_system.py"), root / "systems" / "toy_float.py")
    cfg = {**TOY_CONFIG, **(changes or {})}
    cfg = {k: v for k, v in cfg.items() if v is not None}
    (root / "configs" / "toy-float.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "toy.tiny", "config": "toy-float",
                              "traffic": "resident-b8-tiny", "chips": 1, "why": "toy"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root / "BENCHMARK.json", [root, HERE])


@pytest.fixture
def tiny(tmp_path) -> Registry:
    return tiny_registry(tmp_path)


@pytest.fixture
def toy(tmp_path):
    """``toy(changes)``: the toy registry in a temporary directory."""
    return lambda changes=None: toy_registry(tmp_path, changes)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
