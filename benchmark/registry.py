"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

A cell of ``workloads`` names a configuration and a traffic mix; each lives
in a file of its own, ``configs/<config>.json`` and ``traffic/<traffic>.json``.
A configuration names its system, ``systems/<system>.py``, which builds the
program's entry and its plain reference. A metric is a reader,
``metrics/<name>.py``. Each is looked up in the registry's roots in order,
so adding a cell, a mix, a metric or a system is adding files and entries.

A system module provides:

- ``build(config, device)``: the program built for ``config`` on ``device``,
  an object whose ``process_batch(left, right)`` takes a batch of (B, H, W, 3)
  uint8 frame pairs and returns the batch's maps, one (H, W) map a pair, in
  the integer dtype its reference gives (the rig's: int32);
- ``reference(config, device, control=False)``: ``(left, right) -> maps`` by
  the plain reference, which imports nothing of the program; under a
  configuration that states a ``comparison`` it returns ``(maps, excused)``
  (``run.py::split_reference``); ``control=True`` computes it in the
  precision below the configuration's (``control.py``);
- optionally ``tiny(config)``: ``config`` cut to a CPU test's size, its
  ``name`` the stand-in's (``tests/conftest.py::tiny_registry``);
- optionally ``CALL_SPAN``: the span the program opens around a call of its
  entry, which the span readers count calls by (``spans.CALL`` where absent).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional, Sequence

HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Registry:
    def __init__(self, spec_path: Path = BENCHMARK_JSON, roots: Sequence[Path] = (HERE,)) -> None:
        self.spec = json.loads(Path(spec_path).read_text())
        self.roots = [Path(r) for r in roots]
        self._modules: dict = {}

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise KeyError(f"no file {name}{suffix} under {[str(r / kind) for r in self.roots]}")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads(self._find(kind, name, ".json").read_text())

    def _module(self, kind: str, name: str):
        if (kind, name) not in self._modules:
            path = self._find(kind, name, ".py")
            safe = "".join(c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{safe}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[kind, name] = module
        return self._modules[kind, name]

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def system(self, name: str):
        return self._module("systems", name)

    def cell(self, name: str) -> Cell:
        found: Optional[dict] = next(
            (w for w in self.spec["workloads"] if w["name"] == name), None)
        if found is None:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        return Cell(
            name=name,
            config=self.config(found["config"]),
            traffic=self.traffic(found["traffic"]),
            chips=int(found["chips"]),
            end_to_end=[m for m in self.spec["end_to_end"] if _reports(m, name)],
            per_layer=[m for m in self.spec["per_layer"] if _reports(m, name)],
        )
