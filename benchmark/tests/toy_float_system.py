"""A toy system under test whose answers are a float computation, for the
harness's tests of an excused comparison; the tests copy it into a registry
of their own as ``systems/toy_float.py``.

A pixel's answer is the sum of both views' channels over ``quantum``,
floored, as uint8. The reference sums exactly in integers and excuses the
pixels whose sum lies on a step of ``quantum``, where a float sum may fall
on either side. The configuration's ``toy_flip`` plants mismatches in the
program's maps: ``excused`` lowers every excused pixel by one,
``unexcused`` raises the first pixel that is not excused. The control sums
in bfloat16. Its calls are counted by a span of its own, ``CALL_SPAN``,
and ``tiny`` cuts it to 128x256."""

from __future__ import annotations

import torch

CALL_SPAN = "toy.process_batch"


def _sums(left, right):
    return left.int().sum(-1) + right.int().sum(-1)


def build(config: dict, device: torch.device):
    quantum, flip = config["quantum"], config["toy_flip"]

    class Toy:
        @staticmethod
        def process_batch(left, right):
            out = ((left.float() + right.float()) / quantum).sum(-1).floor().to(torch.uint8)
            on_step = _sums(left, right) % quantum == 0
            if flip == "excused":
                out[on_step] -= 1
            elif flip == "unexcused":
                out.view(-1)[int(torch.nonzero(~on_step.view(-1))[0])] += 1
            return out

    return Toy()


def reference(config: dict, device: torch.device, control: bool = False):
    quantum = config["quantum"]

    def answer(left, right):
        if control:
            low = (left.bfloat16() + right.bfloat16()) / quantum
            return low.sum(-1).floor().to(torch.uint8)
        sums = _sums(left, right)
        return (sums // quantum).to(torch.uint8), sums % quantum == 0

    return answer


def tiny(config: dict) -> dict:
    config.update(name=f"{config['name']}.tiny", image_hw=[128, 256])
    return config
