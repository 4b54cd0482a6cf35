"""Trajectory metrics: ATE and RPE after a Sim(3)/SE(3) Umeyama alignment
(counterpart of nrslam_tpu/eval/metrics.py). Poses are the port's ``SE3``;
the metrics are computed in numpy on the host."""

from __future__ import annotations

import numpy as np

from nrslam_tpu_torch.geometry import se3


def camera_centers(poses_tcw) -> np.ndarray:
    """Tcw list -> camera centers in world frame [N, 3]."""
    return np.stack([se3.inverse(T).t.detach().cpu().numpy()
                     for T in poses_tcw])


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity (s, R, t) with dst ~= s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _aligned_centers(est_poses, gt_poses, with_scale: bool):
    est = camera_centers(est_poses)
    gt = camera_centers(gt_poses)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    s, R, t = umeyama(est, gt, with_scale)
    return (s * (R @ est.T)).T + t, gt


def ate_rmse(est_poses, gt_poses, with_scale: bool = True) -> float:
    """Absolute trajectory error after Umeyama alignment."""
    aligned, gt = _aligned_centers(est_poses, gt_poses, with_scale)
    err = np.linalg.norm(aligned - gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe_trans_rmse(est_poses, gt_poses, delta: int = 5,
                   with_scale: bool = True) -> float:
    """RMSE of the error of delta-frame relative displacements after one
    global alignment (the drift-robust companion of ATE)."""
    aligned, gt = _aligned_centers(est_poses, gt_poses, with_scale)
    d_est = aligned[delta:] - aligned[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))
