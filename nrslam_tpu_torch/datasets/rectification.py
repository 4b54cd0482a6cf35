"""Stereo rectification for the Hamlyn sequences (counterpart of
nrslam_tpu/datasets/rectification.py).

The reference hardcodes per-sequence stereo calibrations and rectifies with
cv::stereoRectify + initUndistortRectifyMap when splitting the videos
(reference modules/datasets/hamlyn.cc:152-249). This module carries the
same calibrations as data; the rectification itself is OpenCV's whole job,
so ``rectify_maps`` / ``rectify_pair`` import ``cv2`` when called and raise a
clear error where it is missing (host-side, one-time cache preparation, off
the metric path).

Calibrations transcribed from hamlyn.cc:152-198 (the active Hamlyn 20/21
block; Hamlyn 01 is the commented-out variant there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StereoCalibration(NamedTuple):
    K_left: np.ndarray    # [3, 3]
    D_left: np.ndarray    # distortion coeffs
    K_right: np.ndarray
    D_right: np.ndarray
    R: np.ndarray         # right-from-left rotation
    T: np.ndarray         # right-from-left translation
    image_size: tuple     # (width, height)


# hamlyn.cc:152-170 (active "Use this for Hamlyn 20-21" block).
HAMLYN_20_21 = StereoCalibration(
    K_left=np.array([[755.312744, 0.0, 327.875],
                     [0.0, 420.477722, 165.484406],
                     [0.0, 0.0, 1.0]]),
    D_left=np.array([-0.186853, 0.122769, -0.010146, -0.003869]),
    K_right=np.array([[759.047791, 0.0, 391.990051],
                      [0.0, 415.329529, 151.748993],
                      [0.0, 0.0, 1.0]]),
    D_right=np.array([-0.197641, 0.213583, -0.00037, -0.010498]),
    R=np.array([[0.999835, 0.001024, 0.018154],
                [-0.001085, 0.999994, 0.003314],
                [-0.018151, -0.003333, 0.99983]]),
    T=np.array([-5.196155, -0.030411, 0.212897]),
    image_size=(720, 288),
)

# hamlyn.cc:175-192 (commented "Use this for Hamlyn 01" block).
HAMLYN_01 = StereoCalibration(
    K_left=np.array([[381.914307, 0.0, 168.108963],
                     [0.0, 383.797882, 126.979446],
                     [0.0, 0.0, 1.0]]),
    D_left=np.array([-0.333236, 0.925076, 0.003847, 0.000916]),
    K_right=np.array([[381.670013, 0.0, 129.929291],
                      [0.0, 382.582397, 120.092186],
                      [0.0, 0.0, 1.0]]),
    D_right=np.array([-0.329342, 0.699034, 0.004927, 0.008194]),
    R=np.array([[0.999906, 0.006813, -0.011930],
                [-0.006722, 0.999948, 0.007680],
                [0.011981, -0.007599, 0.999899]]),
    T=np.array([5.382236, 0.067659, -0.039156]),
    image_size=(320, 240),
)

CALIBRATIONS = {
    "hamlyn_01": HAMLYN_01,
    "hamlyn_20": HAMLYN_20_21,
    "hamlyn_21": HAMLYN_20_21,
}


def rectified_size(calib: StereoCalibration) -> tuple:
    """The reference's enlarged rectified canvas (hamlyn.cc:172, 192):
    (w, h*1.79) for 20/21; (2w, 2h) for 01."""
    w, h = calib.image_size
    if calib is HAMLYN_01 or calib.image_size == (320, 240):
        return (2 * w, 2 * h)
    return (w, int(h * 1.79))


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("stereo rectification requires OpenCV (cv2), "
                           "which is not installed") from e
    return cv2


def rectify_maps(calib: StereoCalibration):
    """Rectification remap grids + rectified projection matrices.

    Mirrors hamlyn.cc:195-199: CALIB_ZERO_DISPARITY onto the enlarged canvas.
    """
    cv2 = _cv2()
    new_size = rectified_size(calib)
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        calib.K_left, calib.D_left.reshape(1, 4),
        calib.K_right, calib.D_right.reshape(1, 4),
        calib.image_size, calib.R, calib.T.reshape(3, 1),
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1, newImageSize=new_size)
    map_l = cv2.initUndistortRectifyMap(
        calib.K_left, calib.D_left, R1, P1[:3, :3], new_size, cv2.CV_32FC1)
    map_r = cv2.initUndistortRectifyMap(
        calib.K_right, calib.D_right, R2, P2[:3, :3], new_size, cv2.CV_32FC1)
    return map_l, map_r, P1, P2


def rectify_pair(calib: StereoCalibration, left: np.ndarray,
                 right: np.ndarray):
    """Rectify one stereo pair; returns (left_r, right_r, fx, baseline_f)."""
    cv2 = _cv2()
    map_l, map_r, P1, P2 = rectify_maps(calib)
    left_r = cv2.remap(left, map_l[0], map_l[1], cv2.INTER_LINEAR)
    right_r = cv2.remap(right, map_r[0], map_r[1], cv2.INTER_LINEAR)
    fx = P1[0, 0]
    bf = -P2[0, 3]  # = fx * baseline
    return left_r, right_r, fx, bf
