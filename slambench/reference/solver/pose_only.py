"""Pose-only camera optimization (motion-only BA).

Counterpart of nrslam_tpu/solver/pose_only.py (reference
CameraPoseOptimization, g2o_optimization.cc:50-146): one SE(3) vertex, a
unary reprojection edge per TRACKED_WITH_3D landmark, Huber delta^2 = 5.99;
three rounds of <= 10 LM iterations, each round restarting from the seed and
re-levelling edges by their chi2 at the previous round's optimum.

``camera_pose_optimization`` runs the plain version below on every device.
"""

from __future__ import annotations

import torch

from slambench.reference.geometry import cameras, se3
from slambench.reference.solver import core, residuals

TH_2DOF = 5.99


def _pose_system(cam, Tcw, X, obs, w_mask):
    """Weighted 6x6 normal equations for the unary reprojection edges."""
    e, J, _ = residuals.reprojection(cam, Tcw, X, obs)
    chi2 = torch.sum(e * e, dim=-1)
    w_huber = core.huber_weight(chi2, TH_2DOF) * w_mask
    H = torch.einsum("pri,p,prj->ij", J, w_huber, J)
    g = torch.einsum("pri,p,pr->i", J, w_huber, e)
    total = torch.sum(core.huber_rho(chi2, TH_2DOF) * w_mask)
    return H, g, total, chi2


def _lm_rounds(cam, Tcw0: se3.SE3, X, obs, w_mask, n_iters: int) -> se3.SE3:
    """n_iters LM trips from Tcw0; every update is gated on ``run = ~done``
    so the fixed trip count reproduces the early-exit schedule exactly."""
    H, g, chi2_cur, _ = _pose_system(cam, Tcw0, X, obs, w_mask)
    lam = core.lm_lambda_init(torch.diagonal(H))
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    T = Tcw0
    for _ in range(n_iters):
        dx = core.solve_dense(H, g, lam)
        T_new = se3.retract(T, dx)
        H_new, g_new, chi2_new, _ = _pose_system(cam, T_new, X, obs, w_mask)
        rho = core.gain_ratio(chi2_cur, chi2_new, dx, lam, g)
        lam_new, nu_new, accepted = core.lm_lambda_update(lam, nu, rho)
        run = ~done
        acc = accepted & run
        T = se3.SE3(torch.where(acc, T_new.q, T.q),
                    torch.where(acc, T_new.t, T.t))
        H = torch.where(acc, H_new, H)
        g = torch.where(acc, g_new, g)
        chi2_cur = torch.where(acc, chi2_new, chi2_cur)
        lam = torch.where(run, lam_new, lam)
        nu = torch.where(run, nu_new, nu)
        done = done | (acc & (torch.dot(dx, dx) < 1e-12))
    return T


def camera_pose_optimization_plain(cam: cameras.Camera, Tcw0: se3.SE3,
                                   landmarks, obs, valid,
                                   rounds=(10, 10, 10)) -> se3.SE3:
    """Plain PyTorch driver (the CPU path and the kernel's oracle)."""
    level0 = valid
    T = Tcw0
    for n in rounds:
        T = _lm_rounds(cam, Tcw0, landmarks, obs, level0.to(torch.float32), n)
        _, _, _, chi2 = _pose_system(cam, T, landmarks, obs,
                                     valid.to(torch.float32))
        level0 = valid & (chi2 <= TH_2DOF)
    return T


def camera_pose_optimization(cam: cameras.Camera, Tcw0: se3.SE3, landmarks,
                             obs, valid, rounds=(10, 10, 10)) -> se3.SE3:
    """Optimize the camera pose against fixed world landmarks [P, 3] with
    pixel observations [P, 2] on the ``valid`` [P] slots."""
    return camera_pose_optimization_plain(cam, Tcw0, landmarks, obs, valid,
                                          rounds)
