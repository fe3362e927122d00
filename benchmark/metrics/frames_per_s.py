"""Disparity maps the card delivers: the frames of every call that finished
inside the window, over the window's seconds (host clock)."""

from benchmark import window


def read(run):
    return window.frames_per_s(run.calls, run.t_start, run.t_end)
