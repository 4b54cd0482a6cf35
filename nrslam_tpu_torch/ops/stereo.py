"""Stereo matchers on a rectified pair (counterpart of
nrslam_tpu/ops/stereo.py; reference modules/stereo/):

- ``stereo_lucas_kanade``: KLT left -> right, gated on row agreement
  (< 2 px) and positive disparity, depth = bf / disparity
  (stereo_lucas_kanade.cc:39-75).
- ``stereo_pattern_matching``: normalised cross-correlation along the
  epipolar row, accepted at corr > 0.99, depth = bf / disparity
  (stereo_pattern_matching.cc:33-93). All disparities are sampled in one
  batched gather ([D x P, win, win]), not one launch sequence per
  disparity.
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.ops import image as image_ops
from nrslam_tpu_torch.ops import klt


def _depth_points(cam: cameras.Camera, bf: float, keypoints, disparity):
    """Camera-frame points at depth bf / disparity along each keypoint's
    ray."""
    depth = bf / torch.clamp(disparity, min=1e-6)
    ray = cameras.unproject(cam, keypoints)
    return ray / ray[..., 2:3] * depth[:, None]


def stereo_lucas_kanade(cam: cameras.Camera, bf: float, left, right,
                        keypoints, valid,
                        config: klt.KLTConfig = klt.KLTConfig(),
                        min_ssim: float = 0.5):
    """KLT left -> right + disparity depth. Returns (points3d [P, 3],
    ok [P])."""
    pyr_l = klt.build_pyramid(left, config)
    pyr_r = klt.build_pyramid(right, config)
    refs = klt.set_reference(pyr_l, keypoints, valid, config)
    status0 = torch.where(valid, klt.TRACKED, klt.BAD).to(torch.int32)
    pts_r, status = klt.track(pyr_r, refs, keypoints, status0, config,
                              min_ssim=min_ssim)

    row_gap = torch.abs(pts_r[:, 1] - keypoints[:, 1])
    disparity = keypoints[:, 0] - pts_r[:, 0]
    ok = valid & klt.is_usable(status) & (row_gap < 2.0) & (disparity > 0)
    return _depth_points(cam, bf, keypoints, disparity), ok


def _centered(windows):
    """Windows minus their means, and their norms (+1e-12 under the root)."""
    w = windows - torch.mean(windows, dim=(-2, -1), keepdim=True)
    return w, torch.sqrt(torch.sum(w * w, dim=(-2, -1)) + 1e-12)


def stereo_pattern_matching(cam: cameras.Camera, bf: float, left, right,
                            keypoints, valid, win: int = 11,
                            max_disparity: int = 96,
                            min_corr: float = 0.99):
    """NCC template search along the rectified epipolar line. Returns
    (points3d [P, 3], ok [P]). The best disparity is the first maximum of
    the correlation (``torch.argmax``, as ``jnp.argmax``), refined by a
    parabola through the correlations at best - 1, best, best + 1 with best
    clipped to [1, D - 2]."""
    P, D = keypoints.shape[0], max_disparity
    tmpl, tnorm = _centered(image_ops.gather_windows(left, keypoints, win))

    disps = torch.arange(D, dtype=torch.float32, device=keypoints.device)
    shift = torch.stack([disps, torch.zeros_like(disps)], dim=-1)   # [D, 2]
    cand = keypoints[None] - shift[:, None]                         # [D, P, 2]
    w, wn = _centered(image_ops.gather_windows(right, cand, win))
    corrs = torch.sum(w * tmpl, dim=(-2, -1)) / (wn * tnorm)        # [D, P]
    best_corr = torch.amax(corrs, dim=0)
    best = torch.argmax(corrs, dim=0)

    bm = torch.clamp(best, 1, D - 2)
    cm1, c0, cp1 = (torch.gather(corrs, 0, (bm + k)[None])[0]
                    for k in (-1, 0, 1))
    denom = cm1 - 2 * c0 + cp1
    offset = torch.where(torch.abs(denom) > 1e-9,
                         0.5 * (cm1 - cp1) / denom, torch.zeros_like(denom))
    disparity = bm.to(torch.float32) + torch.clamp(offset, -1.0, 1.0)

    ok = valid & (best_corr > min_corr) & (disparity > 0.5)
    return _depth_points(cam, bf, keypoints, disparity), ok
