"""The readings that the comparison's limit is set from, on the card, at a
cell's own size and load (the benchmark's own runs do not run this).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2 [--control-seconds 8] [--faults]

Each reading is a run of the cell through the harness's own ``run_cell``,
compared with the reference as every run is:

- Program: a short window of the cell per seed; the largest mismatch is the
  lower reading. Where the configuration states a ``comparison``, the
  largest share of the pixels compared that the reference excused is
  ``excused_share_max``, which the limit of that share is set above.
- Control: the reference with its front end interpolated in bfloat16, the
  precision below the configuration's float32, put in the program's place
  under the entry; its runs have to come out not correct, and the smallest
  mismatch, unexcused pixels only, is the upper reading. Its window is long
  enough for every batch of the pool to be called twice.
- ``--faults``: a short run with each fault of ``faults.py`` planted under
  the entry (``faults.for_config``), on each control seed, which has to come
  out not correct.

One JSON line a reading, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(registry, name: str, device):
    """``wrap`` for ``run_cell``: the entry replaced by the reference in
    bfloat16."""
    from benchmark.run import split_reference

    cfg = registry.cell(name).config
    system = registry.system(cfg["system"])

    def wrap(entry):
        reference = system.reference(cfg, device, control=True)
        return lambda left, right: split_reference(reference(left, right))[0]

    return wrap


def excused_share(checks: dict) -> Optional[float]:
    """The share of the pixels compared that the reference excused, where
    the configuration states a comparison."""
    excused = checks.get("disparity_excused_px")
    return None if excused is None else excused["value"] / max(excused["of"], 1)


def reading(kind: str, seed: int, result: dict, **extra) -> dict:
    checks = result["checks"]
    found = {"kind": kind, **extra, "seed": seed, "correct": result["correct"],
             "attempted": result["attempted"], "failed": result["failed"],
             **{k: v["value"] for k, v in checks.items()}}
    if "disparity_excused_px" in checks:
        found["excused_share"] = excused_share(checks)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's runs")
    ap.add_argument("--control-seeds", required=True, help="comma-separated seeds of the control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seconds", type=float, default=8.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import faults
    from benchmark.registry import Registry
    from benchmark.run import run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    registry = Registry()
    program, upper, program_correct, control_correct, shares = [], [], [], [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _, _ = run_cell(registry, args.workload, seed, args.seconds, False, device,
                                time.perf_counter())
        program.append(result["checks"]["disparity_mismatch_px"]["value"])
        shares.append(excused_share(result["checks"]))
        program_correct.append(result["correct"])
        print(json.dumps(reading("program", seed, result)), flush=True)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        result, _, _ = run_cell(registry, args.workload, seed, args.control_seconds, False,
                                device, time.perf_counter(),
                                wrap=control(registry, args.workload, device))
        upper.append(result["checks"]["disparity_mismatch_px"]["value"])
        control_correct.append(result["correct"])
        print(json.dumps(reading("control", seed, result)), flush=True)
    failed_faults = []
    if args.faults:
        for seed in (int(s) for s in args.control_seeds.split(",")):
            for name, fault in faults.for_config(registry.cell(args.workload).config).items():
                result, _, _ = run_cell(registry, args.workload, seed, args.seconds, False,
                                        device, time.perf_counter(), wrap=fault)
                failed_faults.append(not result["correct"])
                print(json.dumps(reading("fault", seed, result, fault=name)), flush=True)
    print(json.dumps({"kind": "summary", "workload": args.workload,
                      "lower_reading": max(program), "upper_reading": min(upper),
                      "excused_share_max": None if None in shares else max(shares),
                      "program_correct": program_correct, "control_correct": control_correct,
                      "faults_caught": f"{sum(failed_faults)}/{len(failed_faults)}",
                      "card": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
