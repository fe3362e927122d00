"""Device selection: the caller names the device; nothing is guessed."""

from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device) -> torch.device:
    """Parse ``"cpu"``, ``"cuda"`` or ``"cuda:N"``.

    Raises if a CUDA device is asked for and this process has none (or not
    that many); there is no silent switch to the CPU.
    """
    dev = torch.device(spec)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {spec!r}: expected cpu or cuda[:N]")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {spec!r} requested but CUDA is not available")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {spec!r} requested but only {torch.cuda.device_count()} "
            "CUDA device(s) exist"
        )
    return dev
