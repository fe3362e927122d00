"""Faults planted under the timed path, which the comparison has to catch:
each wraps the system's entry. The cells run on one card, so no exchange
between cards can be left out."""

from __future__ import annotations

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


def altered_answer(entry):
    """One disparity of each call's first frame is off by one."""

    def step(left, right):
        out = entry(left, right).clone()
        out[0, out.shape[1] // 2, out.shape[2] // 2] += 1
        return out

    return step


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer)}
