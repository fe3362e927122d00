"""Tensors between the ranks of a ``torch.distributed`` process group.

A mesh that spans processes (``parallel/mesh.py::process_mesh``) moves halo
rows point to point and reduces packed keys over a subgroup. NCCL moves
device tensors directly. Gloo's send and receive read host pointers, so
under gloo a CUDA tensor is staged through host memory: copied to the host
before it leaves, back to its device after it arrives. That is what lets two
gloo ranks share one card (NCCL refuses two ranks on one card). Gloo on CPU
tensors, and NCCL, stage nothing.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


def _wire_device(t: torch.Tensor, group=None) -> torch.device:
    """Where the backend reads ``t``: the host under gloo, a card under NCCL
    (``t``'s own, or this rank's for a host tensor)."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    if t.device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _wire(t: torch.Tensor, group=None) -> torch.Tensor:
    return t.to(_wire_device(t, group)).contiguous()


def exchange(
    sends: Sequence[Tuple[torch.Tensor, int, int]],
    recvs: Sequence[Tuple[torch.Tensor, int, int]],
) -> List[torch.Tensor]:
    """Post every send and receive of one exchange together
    (``dist.batch_isend_irecv``) and wait for all of them.

    ``sends``: ``(tensor, peer, tag)``; ``recvs``: ``(like, peer, tag)``,
    where the received tensor takes the shape, dtype and device of
    ``like``. Both ends must list their messages to one peer in the same
    order (NCCL matches them by order, gloo by tag). Returns the received
    tensors in ``recvs`` order.
    """
    if not sends and not recvs:
        return []
    ops = [dist.P2POp(dist.isend, _wire(t), peer, tag=tag) for t, peer, tag in sends]
    bufs = [torch.empty(like.shape, dtype=like.dtype, device=_wire_device(like))
            for like, _, _ in recvs]
    ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
            for buf, (_, peer, tag) in zip(bufs, recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(like.device) for buf, (like, _, _) in zip(bufs, recvs)]


def all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """``dist.all_reduce(op)`` of ``t`` over ``group``; the result on
    ``t``'s device (``t`` itself may be overwritten)."""
    wire = _wire(t, group)
    dist.all_reduce(wire, op=op, group=group)
    return wire.to(t.device)


def barrier() -> None:
    """Wait for every rank; under NCCL on this rank's card."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
