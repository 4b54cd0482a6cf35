"""Per-frame depth-RMSE evaluation against ground truth (counterpart of
nrslam_tpu/eval/evaluator.py; reference frame_evaluator.cc, the
precomputed-depth path of system.cc:179-184).

Ground-truth depths come from bilinear interpolation of a depth image at the
tracked keypoints; the metric is an iteratively scale-aligned depth RMSE (10
Gauss-Newton steps on a scalar scale over the 95% best residuals,
frame_evaluator.cc:134-226). Nothing is read back per frame: the evaluator
keeps device scalars and fetches them in one transfer when asked.
"""

from __future__ import annotations

import math

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import image as image_ops
from nrslam_tpu_torch.slam.state import take
from nrslam_tpu_torch.utils import stats


def _aligned_rmse(est, gt, valid, inlier_fraction: float):
    """(rmse, scale) after 10 trimmed Gauss-Newton steps on the scale."""
    n_valid = torch.sum(valid.to(torch.float32))
    n_inliers = torch.clamp(n_valid * inlier_fraction, min=1.0)
    k = torch.clamp(n_inliers.to(torch.int32) - 1, 0, est.shape[0] - 1)
    scale = torch.ones((), dtype=torch.float32, device=est.device)
    rmse = scale
    for _ in range(10):
        r = gt - scale * est
        r2 = torch.where(valid, r * r, torch.full_like(r, math.inf))
        th = take(torch.sort(r2).values, k)
        w = (valid & (r2 <= th)).to(torch.float32)
        H = torch.sum(w * est * est)
        g = torch.sum(w * (-r * est))
        scale = scale - g / torch.clamp(H, min=1e-12)
        r_aligned = gt - scale * est
        rmse = torch.sqrt(torch.sum(w * r_aligned * r_aligned)
                          / torch.clamp(torch.sum(w), min=1.0))
    return rmse, scale


def _scale_aligned_rmse(est, gt, valid, inlier_fraction: float = 0.95,
                        iqr_reject: bool = False):
    """Iteratively scale-aligned depth RMSE over masked arrays.
    ``iqr_reject`` first drops depths whose |est - gt| exceeds
    q3 + 1.5 IQR (the stereo-GT pre-filter, frame_evaluator.cc:138-159)."""
    valid = valid & torch.isfinite(gt) & torch.isfinite(est)
    if iqr_reject:
        err = torch.abs(est - gt)
        valid = valid & (err <= stats.iqr_upper_threshold(err, valid))
    return _aligned_rmse(est, gt, valid, inlier_fraction)[0]


def _depth_rmse_impl(keypoints, positions, valid, Tcw: se3.SE3, depth_image,
                     cam: cameras.Camera, inlier_fraction: float = 0.95):
    """(rmse, scale) of the estimated camera-frame depths of ``positions``
    against the depth image sampled at ``keypoints``."""
    est = se3.apply(Tcw, positions)[..., 2]
    gt_depth = image_ops.bilinear_sample(depth_image, keypoints)
    ray = cameras.unproject(cam, keypoints)
    gt = (ray / ray[..., 2:3])[..., 2] * gt_depth
    valid = valid & torch.isfinite(gt) & torch.isfinite(est)
    return _aligned_rmse(est, gt, valid, inlier_fraction)


class FrameEvaluator:
    """Accumulates per-frame RMSE like the reference's results file. Frames
    evaluated after the collapse latch (``state.lost``) are recorded as NaN
    and dropped from the history (the reference's file ends there)."""

    def __init__(self, flush_every: int = 256):
        self._rmse_dev = []
        self._scale_dev = []
        self._rmse_host = []
        self._scale_host = []
        self._flush_every = flush_every

    def _flush(self):
        if self._rmse_dev:
            both = torch.stack([torch.stack(self._rmse_dev),
                                torch.stack(self._scale_dev)]).tolist()
            self._rmse_host.extend(both[0])
            self._scale_host.extend(both[1])
            self._rmse_dev = []
            self._scale_dev = []

    def evaluate(self, state, cam: cameras.Camera, depth_image):
        """The frame's RMSE as a device scalar (not read back)."""
        valid = state.slot_used & (state.status == 0)  # TRACKED_WITH_3D
        rmse, scale = _depth_rmse_impl(state.keypoints, state.positions,
                                       valid, state.Tcw, depth_image, cam)
        rmse = torch.where(state.lost, torch.full_like(rmse, math.nan), rmse)
        self._rmse_dev.append(rmse)
        self._scale_dev.append(scale)
        if len(self._rmse_dev) >= self._flush_every:
            self._flush()
        return rmse

    @property
    def rmse_history(self):
        self._flush()
        return [r for r in self._rmse_host if math.isfinite(r)]

    @property
    def scale_history(self):
        self._flush()
        return [s for s, r in zip(self._scale_host, self._rmse_host)
                if math.isfinite(r)]

    def save(self, path):
        with open(path, "w") as f:
            for r in self.rmse_history:
                f.write(f"{r}\n")
