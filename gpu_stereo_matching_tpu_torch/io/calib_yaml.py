"""OpenCV-YAML stereo calibration loader (no OpenCV dependency).

Parses the ``%YAML:1.0`` + ``!!opencv-matrix`` files the reference reads with
``cv::FileStorage`` (``BlockMatching/Utility.cpp:16-42``): intrinsics
``LeftMat``/``RightMat``, 5-term distortion ``LeftDist``/``RightDist``, the
inter-camera rotation ``RotationVec`` (a full 3×3 matrix despite the name)
and translation ``TranslationVec``.

The port's own copy of the JAX package's ``io/calib_yaml.py`` (plain numpy, the same
arithmetic op for op); ``tests/test_torch_hostcopies.py`` holds the two
together.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import yaml


@dataclasses.dataclass(frozen=True)
class StereoCalibration:
    left_intrinsics: np.ndarray   # (3, 3)
    right_intrinsics: np.ndarray  # (3, 3)
    left_distortion: np.ndarray   # (5,) k1 k2 p1 p2 k3
    right_distortion: np.ndarray  # (5,)
    rotation: np.ndarray          # (3, 3) right-camera rotation w.r.t. left
    translation: np.ndarray       # (3,) in the calibration's length units


def _parse_opencv_yaml(text: str) -> dict:
    # Strip the YAML 1.0 directive and the opencv-matrix type tags, which
    # stock PyYAML refuses; the remaining document is plain YAML.
    text = re.sub(r"^%YAML:1\.0\s*\n", "", text)
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text)


def _matrix(node: dict) -> np.ndarray:
    rows, cols = int(node["rows"]), int(node["cols"])
    data = np.asarray(node["data"], dtype=np.float64)
    return data.reshape(rows, cols)


def load_opencv_stereo_yaml(path: str | os.PathLike) -> StereoCalibration:
    with open(path, "r") as f:
        doc = _parse_opencv_yaml(f.read())
    return StereoCalibration(
        left_intrinsics=_matrix(doc["LeftMat"]),
        right_intrinsics=_matrix(doc["RightMat"]),
        left_distortion=_matrix(doc["LeftDist"]).reshape(-1),
        right_distortion=_matrix(doc["RightDist"]).reshape(-1),
        rotation=_matrix(doc["RotationVec"]),
        translation=_matrix(doc["TranslationVec"]).reshape(-1),
    )


def _emit_matrix(name: str, mat: np.ndarray) -> str:
    mat = np.asarray(mat, np.float64)
    if mat.ndim == 1:
        mat = mat.reshape(1, -1)
    vals = ", ".join(repr(float(v)) for v in mat.reshape(-1))
    return (
        f"{name}: !!opencv-matrix\n"
        f"   rows: {mat.shape[0]}\n"
        f"   cols: {mat.shape[1]}\n"
        f"   dt: d\n"
        f"   data: [ {vals} ]\n"
    )


def save_opencv_stereo_yaml(
    path: str | os.PathLike, calib: StereoCalibration
) -> None:
    """Write the same ``%YAML:1.0`` + ``!!opencv-matrix`` format the
    reference's calibration tool produces (``Utility.cpp:173-175``);
    round-trips through :func:`load_opencv_stereo_yaml` and is readable by
    ``cv::FileStorage``."""
    doc = "%YAML:1.0\n---\n"
    doc += _emit_matrix("LeftMat", calib.left_intrinsics)
    doc += _emit_matrix("LeftDist", calib.left_distortion.reshape(1, -1))
    doc += _emit_matrix("RightMat", calib.right_intrinsics)
    doc += _emit_matrix("RightDist", calib.right_distortion.reshape(1, -1))
    doc += _emit_matrix("RotationVec", calib.rotation)
    doc += _emit_matrix("TranslationVec", calib.translation.reshape(3, 1))
    with open(path, "w") as f:
        f.write(doc)
