"""Halo rows for window ops on an image tiled over the ``space`` axis.

As ``gpu_stereo_matching_tpu/parallel/halo.py``: a window op (SAD
aggregation, median) on a band of the image needs ``radius`` rows from each
neighbouring band. The global top and bottom receive zero rows, which are
real rows of the slab to whatever runs on it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def extend_with_row_halos(shards: Sequence[torch.Tensor], radius: int) -> List[torch.Tensor]:
    """Extend each band with ``radius`` rows of its neighbours.

    ``shards``: the (..., H_local, W) bands of one image in ``space`` order,
    each on its own device. Returns, in the same order and on the same
    devices, bands of ``H_local + 2 * radius`` rows: the rows above come
    from the previous band's bottom edge and the rows below from the next
    band's top edge, copied to the receiving band's device; the first
    band's top and the last band's bottom are zeros. ``radius <= 0``
    returns the input.
    """
    shards = list(shards)
    if radius <= 0:
        return shards
    for x in shards:
        if x.shape[-2] < radius:
            raise ValueError(
                f"extend_with_row_halos: a band of {x.shape[-2]} rows cannot give "
                f"{radius} halo rows"
            )
    out = []
    last = len(shards) - 1
    for j, x in enumerate(shards):
        zeros = torch.zeros_like(x[..., :radius, :])
        from_prev = zeros if j == 0 else shards[j - 1][..., -radius:, :].to(x.device)
        from_next = zeros if j == last else shards[j + 1][..., :radius, :].to(x.device)
        out.append(torch.cat([from_prev, x, from_next], dim=-2))
    return out
