"""One run of one benchmark cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, system and metric readers are found by name
(``registry.py``). A run builds the system from the configuration, makes
its frames from the seed, warms up the cell's own shapes, and then drives a
closed loop of calls for ``--seconds`` (``window.py``). With ``--trace 1``
the first half of the window is timed by the benchmark's spans alone and
the second half, at most ``TRACE_CAP_S``, runs under the profiler
(``trace.py``); the cell's per-layer metrics are read from both. After the
window a sample of the calls' outputs, drawn from the seed, is compared with
the plain reference (``systems/<system>.py``), and the last line of standard
output is the result. A configuration whose program computes in floating
point may state a ``comparison``: its reference then also marks the pixels
where its own answer is a near-tie, and a mismatch there is excused, up to
the share the configuration allows (``comparison_of``).

It refuses to run without enough CUDA devices, and refuses to print a
result if the process holds ``jax``, ``jaxlib``, ``flax`` or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Kernel and compiler caches at fixed places inside the checkout.
CACHE_DIR = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_stereo_matching_tpu")
TRACE_CAP_S = 4.0
# The largest share of the pixels compared that a configuration may let its
# reference excuse.
MAX_EXCUSED_SHARE = 0.01


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    batch: int
    setup_s: float
    call_span: str  # the span the program opens around a call (the system's CALL_SPAN)
    calls: list = dataclasses.field(default_factory=list)  # the untraced window's calls
    t_start: float = 0.0
    t_end: float = 0.0
    span_calls: list = dataclasses.field(default_factory=list)  # traced runs: the untraced part
    trace: object = None
    traced_calls: int = 0


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def comparison_of(config: dict) -> Optional[dict]:
    """The configuration's ``comparison``, ``{"excused_share_at_most": x,
    "why": reason}``, or None where its maps are compared exactly; a
    comparison that allows more than ``MAX_EXCUSED_SHARE`` or gives no
    reason is an error."""
    found = config.get("comparison")
    if found is None:
        return None
    share, why = found.get("excused_share_at_most"), found.get("why")
    if (set(found) != {"excused_share_at_most", "why"} or not isinstance(share, (int, float))
            or not 0 <= share <= MAX_EXCUSED_SHARE or not str(why).strip()):
        raise ValueError(f"{config.get('name')}: a comparison is {{'excused_share_at_most': "
                         f"a share in [0, {MAX_EXCUSED_SHARE}], 'why': a reason}}, not {found}")
    return found


def split_reference(answer) -> tuple:
    """A reference's answer as (maps, excused): a reference may return the
    bool mask of the pixels where its own answer is a near-tie beside its
    maps; excused is None where it returns the maps alone."""
    import torch

    if not isinstance(answer, tuple):
        return answer, None
    maps, excused = answer
    if excused.dtype != torch.bool or tuple(excused.shape) != tuple(maps.shape):
        raise ValueError(f"an excused mask is a bool tensor of the maps' shape "
                         f"{tuple(maps.shape)}, not {excused.dtype} {tuple(excused.shape)}")
    return maps, excused


def check_outputs(sample, pool: list, expected_of: Callable) -> dict:
    """Compare each sampled call's output with the reference's for its
    frames; every call of a pool batch gets the same frames. A mismatch at
    a pixel that the reference excuses is not counted; ``excused_px`` counts
    the excused pixels of the calls compared (None where the reference
    excuses none), ``pixels`` the pixels compared."""
    expected, mismatch, frames, wrong_calls = {}, 0, 0, 0
    excused_px, pixels = None, 0
    for index, out in sample.kept:
        p = index % len(pool)
        if p not in expected:
            expected[p] = split_reference(expected_of(*pool[p]))
        want, excused = expected[p]
        if tuple(out.shape) != tuple(want.shape) or out.dtype != want.dtype:
            bad = want.numel()
        else:
            differ = out.to(want.device) != want
            if excused is not None:
                differ &= ~excused
            bad = int(differ.sum())
        if excused is not None:
            excused_px = (excused_px or 0) + int(excused.sum())
        mismatch += bad
        frames += want.shape[0]
        pixels += want.numel()
        wrong_calls += bad > 0
    return {"mismatch_px": mismatch, "frames": frames, "wrong_calls": wrong_calls,
            "pool_batches": len(expected), "excused_px": excused_px, "pixels": pixels}


def run_cell(registry, name: str, seed: int, seconds: float, traced: bool, device,
             t_process: float, wrap: Optional[Callable] = None, stages=None) -> tuple:
    """One run of cell ``name``: (result, earlier lines, check lines).
    ``wrap`` replaces the entry by ``wrap(entry)`` (the tests' faults);
    ``stages`` holds the set-up's seconds so far, by stage."""
    import torch

    from benchmark import scene, spans, trace, window

    cell = registry.cell(name)
    cfg, mix = cell.config, cell.traffic
    comparison = comparison_of(cfg)
    cuda = device.type == "cuda"
    stages = dict(stages or {})

    def stage(label: str) -> None:
        if cuda:
            torch.cuda.synchronize(device)
        stages[label] = time.perf_counter() - t_process - sum(stages.values())

    system = registry.system(cfg["system"])
    step = system.build(cfg, device).process_batch
    if wrap is not None:
        step = wrap(step)
    stage("system")
    batch, in_flight = mix["batch"], mix["in_flight"]
    pool = scene.cell_pool(cfg, mix, seed, device)
    stage("frames")
    step(*pool[0])
    stage("first_call")
    for _ in range(2):
        for pair in pool:
            step(*pair)
    stage("warm_up")
    clock = window.CudaClock(device) if cuda else window.HostClock()
    sample = window.Sample(seed, len(pool))
    run = Run(cfg, mix, batch, time.perf_counter() - t_process,
              getattr(system, "CALL_SPAN", spans.CALL))

    def loop(secs: float, first: int = 0):
        return window.closed_loop(step, pool, batch, secs, in_flight, clock, sample, first)

    if not traced:
        run.calls, run.t_start, run.t_end = loop(seconds)
        attempted = len(run.calls)
    else:
        run.span_calls, _, _ = loop(seconds / 2)
        (calls, _, _), run.trace = trace.profiled(
            lambda: loop(min(seconds / 2, TRACE_CAP_S), len(run.span_calls)))
        run.traced_calls = len(calls)
        attempted = len(run.span_calls) + len(calls)

    metrics, lines = {}, [json.dumps({"setup_stages_s": stages})]
    for spec in cell.per_layer if traced else cell.end_to_end:
        value = registry.metric(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if traced:
        by_name = trace.seconds_by_name(run.trace.kernels())
        layers, named = {}, set()
        for spec in cell.per_layer:
            kernels = getattr(registry.metric(spec["name"]), "KERNELS", ())
            if kernels:
                layers[spec["name"]] = {k: v for k, v in by_name.items() if k in kernels}
                named.update(kernels)
        other = {k: v for k, v in by_name.items() if k not in named}
        lines.append(json.dumps({"kernels_by_metric": layers, "other": other}))
    lines.append(json.dumps({"clock": clock.report()}))

    del step
    if cuda:
        torch.cuda.empty_cache()
    found = check_outputs(sample, pool, system.reference(cfg, device))
    if found["excused_px"] is not None and comparison is None:
        raise ValueError(f"the reference of {cfg['name']} excuses pixels, but the "
                         "configuration states no comparison")
    batches = max(min(len(pool), sample.seen), 1)
    checks = {"disparity_mismatch_px": {"value": found["mismatch_px"], "at_most": 0}}
    if comparison is not None:
        allowed = math.floor(comparison["excused_share_at_most"] * found["pixels"])
        checks["disparity_excused_px"] = {"value": found["excused_px"] or 0,
                                          "at_most": allowed, "of": found["pixels"]}
    checks["frames_checked"] = {"value": found["frames"], "at_least": batches * batch}
    checks["pool_batches_checked"] = {"value": found["pool_batches"], "at_least": batches}
    correct = all(v["value"] <= v.get("at_most", v["value"])
                  and v["value"] >= v.get("at_least", v["value"]) for v in checks.values())

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": found["wrong_calls"], "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": trace.top(trace.seconds_by_name(run.trace.device)),
            "idle_gaps": trace.top(trace.idle_gaps(run.trace)),
        }
    result["checks"] = checks
    check_lines = [f"check {k} {v['value']} " + " ".join(f"{b} {x}" for b, x in v.items()
                                                           if b != "value")
                   for k, v in checks.items()]
    return result, lines, check_lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)

    import torch

    from benchmark.registry import Registry

    imported = time.perf_counter() - T_PROCESS
    registry = Registry()
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: the cell needs {cell.chips} CUDA device(s); this machine has {count}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.synchronize(device)
    stages = {"imports": imported, "cuda_context": time.perf_counter() - T_PROCESS - imported}
    result, lines, check_lines = run_cell(registry, args.workload, args.seed, args.seconds,
                                          bool(args.trace), device, T_PROCESS, stages=stages)
    found = forbidden_modules()
    if found:
        print(f"run: the process holds modules it must not load: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line)
    sys.stdout.flush()
    print("\n".join(check_lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
