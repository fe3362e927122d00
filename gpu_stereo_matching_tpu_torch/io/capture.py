"""Stereo frame acquisition: file/directory sources + optional camera.

Parity layer for the reference's interactive capture tooling — ``photo``
(stereo-pair capture to disk, ``BlockMatching/Utility.cpp:198-226``),
``CamTest`` (webcam smoke check, ``test.cu:78-97``) and the capture side of
``CalibrationTest`` (``Utility.cpp:97-196``). The engine consumes a
:class:`StereoFrameSource`; shipping sources:

* :class:`PairListSource` — explicit (left, right) path pairs,
* :class:`DirectorySource` — ``Left_*/Right_*`` naming as in the bundled
  ``Chess/`` sets,
* :class:`CameraSource` — live OpenCV ``VideoCapture`` devices when
  available (acquisition-side only; never on the compute path).

The port's own copy of the JAX package's ``io/capture.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gpu_stereo_matching_tpu_torch.io.images import load_image_bgr, save_image

StereoFrame = Tuple[np.ndarray, np.ndarray]  # (left_bgr, right_bgr)


class StereoFrameSource:
    def frames(self) -> Iterator[StereoFrame]:
        raise NotImplementedError


class PairListSource(StereoFrameSource):
    def __init__(self, pairs: Sequence[Tuple[str, str]]) -> None:
        self.pairs = list(pairs)

    def frames(self) -> Iterator[StereoFrame]:
        for lp, rp in self.pairs:
            yield load_image_bgr(lp), load_image_bgr(rp)


class DirectorySource(StereoFrameSource):
    """Pairs ``Left_<i>`` / ``Right_<i>`` files (the Chess-set convention)."""

    def __init__(self, directory: str, left_glob: str = "Left_*",
                 right_glob: str = "Right_*") -> None:
        def index_of(path: str) -> int:
            m = re.search(r"_(\d+)\.", os.path.basename(path))
            return int(m.group(1)) if m else -1

        lefts = {index_of(p): p for p in glob.glob(os.path.join(directory, left_glob))}
        rights = {index_of(p): p for p in glob.glob(os.path.join(directory, right_glob))}
        common = sorted(set(lefts) & set(rights))
        self.pairs = [(lefts[i], rights[i]) for i in common if i >= 0]

    def frames(self) -> Iterator[StereoFrame]:
        for lp, rp in self.pairs:
            yield load_image_bgr(lp), load_image_bgr(rp)


class CameraSource(StereoFrameSource):
    """Two live cameras via OpenCV (the reference's capture path)."""

    def __init__(self, left_index: int = 0, right_index: int = 1,
                 num_frames: Optional[int] = None) -> None:
        self.left_index = left_index
        self.right_index = right_index
        self.num_frames = num_frames

    def frames(self) -> Iterator[StereoFrame]:
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("camera capture requires OpenCV") from e
        cap_l = cv2.VideoCapture(self.left_index)
        cap_r = cv2.VideoCapture(self.right_index)
        if not (cap_l.isOpened() and cap_r.isOpened()):
            raise RuntimeError(
                f"cannot open cameras {self.left_index}/{self.right_index}"
            )
        try:
            count = 0
            while self.num_frames is None or count < self.num_frames:
                ok_l, frame_l = cap_l.read()
                ok_r, frame_r = cap_r.read()
                if not (ok_l and ok_r):
                    break
                yield frame_l, frame_r
                count += 1
        finally:
            cap_l.release()
            cap_r.release()


def capture_pairs(
    source: StereoFrameSource,
    out_dir: str,
    max_pairs: int = 22,
    prefix: Tuple[str, str] = ("Left", "Right"),
) -> List[Tuple[str, str]]:
    """Persist stereo pairs as ``Left_i.jpg``/``Right_i.jpg`` (the reference's
    ``photo`` output convention, ``Utility.cpp:217-218``)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, (left, right) in enumerate(source.frames()):
        if i >= max_pairs:
            break
        lp = os.path.join(out_dir, f"{prefix[0]}_{i}.jpg")
        rp = os.path.join(out_dir, f"{prefix[1]}_{i}.jpg")
        save_image(lp, left)
        save_image(rp, right)
        written.append((lp, rp))
    return written
