"""Faults planted under the timed path, which the comparison has to catch:
each wraps the system's entry. The cells run on one card, so no exchange
between cards can be left out."""

from __future__ import annotations

import functools
from typing import Optional

import torch


def unchanged_state(entry):
    """Every call returns the first call's maps, never computed again."""
    first = []

    def step(left, right):
        if not first:
            first.append(entry(left, right))
        return first[0]

    return step


def half_batch(entry):
    """Only the first half of each batch is matched; the second half repeats it."""

    def step(left, right):
        half = max(1, left.shape[0] // 2)
        out = entry(left[:half].contiguous(), right[:half].contiguous())
        return torch.cat([out, out], dim=0)[: left.shape[0]]

    return step


def altered_answer(entry, tile: Optional[int] = None):
    """One disparity of each call's first frame is off by one: the centre
    one or, with ``tile``, the centre one of every ``tile`` x ``tile`` tile
    of it, so that the pixels a reference excuses cannot hide the fault."""

    def step(left, right):
        out = entry(left, right).clone()
        h, w = out.shape[1], out.shape[2]
        size = tile or max(h, w)
        ys = torch.tensor([(y + min(y + size, h)) // 2 for y in range(0, h, size)])
        xs = torch.tensor([(x + min(x + size, w)) // 2 for x in range(0, w, size)])
        out[0, ys[:, None].to(out.device), xs[None, :].to(out.device)] += 1
        return out

    return step


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer)}
TILE = 64


def for_config(config: dict) -> dict:
    """The faults to plant under a configuration's entry: where it states a
    ``comparison``, the altered answer alters one pixel in every tile."""
    if "comparison" not in config:
        return dict(FAULTS)
    return {**FAULTS, "altered_answer": functools.partial(altered_answer, tile=TILE)}
