"""A tiny registry beside the real one: each configuration that a cell
uses, cut to a CPU test's size by its system's ``tiny``, on a traffic mix
of 2 pairs a call, and a BENCHMARK.json whose cells are those stand-ins,
all in a temporary directory; nothing of ``benchmark/`` is edited. A toy
registry adds a float system whose reference excuses pixels
(``toy_float_system.py``)."""

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

# One thread a test process: parallel workers would otherwise oversubscribe
# the cores and stretch a run's short window to a call or two.
torch.set_num_threads(1)

from benchmark.registry import HERE, Registry

TINY_MIX = "resident-b8-tiny"


def stand_ins(base: Registry) -> dict:
    """``{cell: tiny configuration}`` for each cell of ``base`` whose
    system has ``tiny``; the cells of one configuration share its stand-in,
    which is named by the tiny configuration's ``name``. A cell whose
    system has none is left out."""
    found, names = {}, {}
    for w in base.spec["workloads"]:
        cfg = base.config(w["config"])
        system = base.system(cfg["system"])
        if not hasattr(system, "tiny"):
            continue
        small = system.tiny(cfg)
        if names.setdefault(small["name"], w["config"]) != w["config"]:
            raise ValueError(f"configurations {names[small['name']]} and {w['config']} "
                             f"have one stand-in, {small['name']}")
        found[w["name"]] = small
    return found


def tiny_registry(root: Path, base: Registry = None) -> Registry:
    """The stand-ins of ``base`` (the benchmark's own by default) as cells
    of a registry under ``root``, each on the tiny mix (batch 2, a pool of
    2, the small scene); each metric's ``workloads`` lists the stand-ins of
    the cells it lists."""
    base = base or Registry()
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    spec = copy.deepcopy(base.spec)
    stands_for = {}
    for cell, small in stand_ins(base).items():
        (root / "configs" / f"{small['name']}.json").write_text(json.dumps(small))
        stands_for[cell] = small["name"]
    mix = json.loads((HERE / "traffic" / "resident-b8.json").read_text())
    mix.update(name=TINY_MIX, batch=2, pool_batches=2)
    mix["scene"].update(max_disparity=12, background_disparity=[1, 5],
                        object_disparity=[4, 12], texture_scales=[2, 4, 8])
    (root / "traffic" / f"{TINY_MIX}.json").write_text(json.dumps(mix))
    spec["workloads"] = [{"name": n, "config": n, "traffic": TINY_MIX, "chips": 1, "why": "tiny"}
                         for n in dict.fromkeys(stands_for.values())]
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = list(dict.fromkeys(
                stands_for[w] for w in metric["workloads"] if w in stands_for))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(root / "BENCHMARK.json", [root, *base.roots])


# The benchmark's own stand-ins, which the run, fault and control tests are
# parametrised over (``stand_in``).
STAND_INS = sorted({small["name"] for small in stand_ins(Registry()).values()})


def pytest_generate_tests(metafunc):
    if "stand_in" in metafunc.fixturenames:
        metafunc.parametrize("stand_in", STAND_INS)


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
                              "traffic": TINY_MIX, "chips": 1, "why": "toy"})
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
