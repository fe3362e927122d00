"""Port ``core/validation.py`` against the JAX package's: ``check_bgr_pair``
and ``check_maps`` accept and refuse the same inputs with the same messages;
``check_gray_pair`` accepts what the JAX one accepts."""

import numpy as np
import pytest
import torch

from gpu_stereo_matching_tpu.core import validation as jval
from gpu_stereo_matching_tpu_torch.core import validation as tval


def _outcome(fn, *args):
    """(exception type, message), or (None, result) when ``fn`` accepts."""
    try:
        return None, fn(*args)
    except (TypeError, ValueError) as e:
        return type(e), str(e)


def _both(name, arrays, *rest):
    want = _outcome(getattr(jval, name), *arrays, *rest)
    got = _outcome(getattr(tval, name), *(torch.from_numpy(a) for a in arrays), *rest)
    return got, want


BGR = np.zeros((6, 9, 3), np.uint8)


@pytest.mark.parametrize("left,right,num_d", [
    (BGR, BGR, 9),                                         # accepted: D = W
    (BGR, BGR, 1),
    (BGR, BGR, 10),                                        # D > W
    (BGR[..., 0], BGR[..., 0], 4),                         # gray, not BGR
    (BGR[None], BGR[None], 4),                             # a batch
    (np.zeros((6, 9, 4), np.uint8), np.zeros((6, 9, 4), np.uint8), 4),
    (BGR, BGR[:5], 4),                                     # shapes differ
    (BGR.astype(np.float32), BGR, 4),
    (BGR, BGR.astype(np.int32), 4),
])
@pytest.mark.parametrize("what", ["image", "st1_disparity"])
def test_check_bgr_pair_matches_jax(left, right, num_d, what):
    got, want = _both("check_bgr_pair", (left, right), num_d, what)
    assert got == want


def test_check_bgr_pair_default_label_matches_jax():
    got, want = _both("check_bgr_pair", (BGR, BGR), 10)
    assert got == want and got[0] is ValueError and got[1].startswith("image: max_disp_levels=10")


@pytest.mark.parametrize("map_x,map_y", [
    (np.zeros((6, 9), np.float32), np.ones((6, 9), np.float32)),   # accepted
    (np.zeros((6, 9), np.float32), np.zeros((6, 8), np.float32)),
    (np.zeros((1, 6, 9), np.float32), np.zeros((1, 6, 9), np.float32)),
    (np.zeros(9, np.float32), np.zeros(9, np.float32)),
])
def test_check_maps_matches_jax(map_x, map_y):
    got, want = _both("check_maps", (map_x, map_y))
    assert got == want
    got, want = _both("check_maps", (map_x, map_y), "left maps")
    assert got == want
    if got[0] is None:
        assert got[1] == (6, 9) and isinstance(got[1], tuple)


def test_check_gray_pair_accepts_what_jax_accepts():
    gray = np.zeros((6, 9), np.uint8)
    for arrays, num_d in (((gray, gray), 9), ((gray[None], gray[None]), 3)):
        got, want = _both("check_gray_pair", arrays, num_d, "bm")
        assert got == want == (None, None)
