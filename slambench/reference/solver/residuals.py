"""Analytic residual + Jacobian blocks (counterpart of
nrslam_tpu/solver/residuals.py, main-path factors).

Residual ``e`` with ``chi2 = e^T Omega e``; pose Jacobians are with respect
to a left-multiplied twist ``[omega, v]``.
"""

from __future__ import annotations

import torch

from slambench.reference.geometry import cameras, se3


def expmap_point_jacobian(pc):
    """d(exp(delta) * pc)/d(delta) at 0: [..., 3, 6] = [-[pc]x | I]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        torch.stack([zero, z, -y, one, zero, zero], -1),
        torch.stack([-z, zero, x, zero, one, zero], -1),
        torch.stack([y, -x, zero, zero, zero, one], -1),
    ]
    return torch.stack(rows, dim=-2)


def reprojection(cam: cameras.Camera, Tcw: se3.SE3, X_world, obs):
    """e = obs - project(Tcw * X) with (J_pose [..., 2, 6],
    J_point [..., 2, 3]) (J_point also serves a deformation delta)."""
    pc = se3.apply(Tcw, X_world)
    e = obs - cameras.project(cam, pc)
    dpi = -cameras.projection_jacobian(cam, pc)
    J_pose = dpi @ expmap_point_jacobian(pc)
    R = se3.quat_to_matrix(Tcw.q)
    J_point = dpi @ R
    return e, J_pose, J_point
