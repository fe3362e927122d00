"""Halo rows for window ops on an image tiled over the ``space`` axis.

As ``gpu_stereo_matching_tpu/parallel/halo.py``: a window op (SAD
aggregation, median) on a band of the image needs ``radius`` rows from each
neighbouring band. The global top and bottom receive zero rows, which are
real rows of the slab to whatever runs on it. Between bands that one
process holds, rows are tensor copies; between bands of two ranks of a
process group they move point to point, all of one call's messages posted
together (``parallel/collectives.py::exchange``): the two ``ppermute``s
of JAX ``halo.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from gpu_stereo_matching_tpu_torch.parallel.collectives import exchange


def _edge(band: torch.Tensor, radius: int, below: bool) -> torch.Tensor:
    """The rows a band gives its neighbour: its bottom rows to the band
    below, its top rows to the band above."""
    return band[..., -radius:, :] if below else band[..., :radius, :]


def extend_with_row_halos(
    shards: Sequence[Optional[torch.Tensor]], radius: int, owners: Optional[Sequence[int]] = None
) -> List[Optional[torch.Tensor]]:
    """Extend each band with ``radius`` rows of its neighbours.

    ``shards``: the (..., H_local, W) bands of one image in ``space`` order,
    each on its own device. Returns, in the same order and on the same
    devices, bands of ``H_local + 2 * radius`` rows: the rows above come
    from the previous band's bottom edge and the rows below from the next
    band's top edge, copied to the receiving band's device; the first
    band's top and the last band's bottom are zeros. ``radius <= 0``
    returns the input.

    ``owners``: the rank that holds each band, where the bands span the
    ranks of a process group. Every rank holding a band calls this with
    the same ``owners``; its own bands are tensors and the others None
    (and stay None in the result). Rows that cross to another rank are
    sent and received in one exchange.
    """
    shards = list(shards)
    if radius <= 0:
        return shards
    rank = None if owners is None else dist.get_rank()

    def mine(j):
        return owners is None or owners[j] == rank

    for x in shards:
        if x is not None and x.shape[-2] < radius:
            raise ValueError(
                f"extend_with_row_halos: a band of {x.shape[-2]} rows cannot give "
                f"{radius} halo rows"
            )
    last = len(shards) - 1
    # (source band, receiving band) of every message, in one order on every
    # rank; a message's index is its tag.
    crossing = [] if owners is None else [
        (src, j) for j in range(len(shards)) for src in (j - 1, j + 1)
        if 0 <= src <= last and owners[src] != owners[j]
    ]
    sends = [(_edge(shards[src], radius, src < j), owners[j], tag)
             for tag, (src, j) in enumerate(crossing) if mine(src)]
    recvs = [((src, j), owners[src], tag) for tag, (src, j) in enumerate(crossing) if mine(j)]
    got = exchange(sends, [(shards[j][..., :radius, :], peer, tag)
                           for (_, j), peer, tag in recvs])
    received = {msg: rows for (msg, _, _), rows in zip(recvs, got)}

    def rows_from(src, j):
        if not 0 <= src <= last:
            return torch.zeros_like(shards[j][..., :radius, :])
        if (src, j) in received:
            return received[(src, j)]
        return _edge(shards[src], radius, src < j).to(shards[j].device)

    return [
        torch.cat([rows_from(j - 1, j), x, rows_from(j + 1, j)], dim=-2) if mine(j) else None
        for j, x in enumerate(shards)
    ]
