"""Measurement harnesses of the port.

Exports the JAX package's ``bench`` names, each loaded from its module at
first use, so that ``python -m gpu_stereo_matching_tpu_torch.bench.<name>``
does not import the module it is about to run.
"""

import importlib

_EXPORTS = {
    "evaluate_scene": "middlebury",
    "run_middlebury_suite": "middlebury",
    "run_micro_benchmarks": "micro",
    "run_scaling_benchmark": "scaling",
    "run_streaming_benchmark": "streaming",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
