"""Local deformable bundle adjustment over the keyframe window
(counterpart of nrslam_tpu/solver/bundle_adjustment.py).

Variables: K keyframe poses + one landmark copy per keyframe. Factors:
reprojection (info 4, Huber 5.99), unrobust springs (info 100) per keyframe
and 4-ary temporal dampers (info 1/(0.1 scale)^2, Huber 0.584) between
consecutive keyframes. 5 LM steps, each a block-Jacobi PCG with edge-list
Hessian-vector products (gathers + ``index_add_``).

``local_deformable_ba`` runs the plain driver ``local_deformable_ba_plain``
on every device.

Unobserved copies take part in no factor. Both routes drop their terms
rather than multiplying them by a zero mask: an invalid keyframe slot holds
zero positions at the identity pose, whose projection is 0/0, and 0 * NaN
would poison every sum. (The JAX package's op-level driver does multiply,
so on a window with invalid slots every one of its LM steps is rejected and
its BA leaves the window unchanged; its Pallas kernel sanitises those copies
and solves the window, as both routes here do.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.geometry import cameras, se3
from slambench.reference.solver import core, residuals
from slambench.reference.solver.pose_deformation import PairEdges
from slambench.reference.utils.tree import tree_map

TH_2DOF = 5.99
TH_3DOF = 0.584
INFO_REPROJECTION = 1.0 / (0.5 ** 2)
INFO_POSITION = 1.0 / (0.1 ** 2)
SPRING_K = 1.1


class BAProblem(NamedTuple):
    obs: torch.Tensor        # [K, P, 2]
    obs_valid: torch.Tensor  # [K, P]
    kf_valid: torch.Tensor   # [K]
    pairs: PairEdges
    scale: torch.Tensor


def _masks(problem: BAProblem):
    obs_ok = problem.obs_valid & problem.kf_valid[:, None]
    pv = problem.pairs.valid
    spring = (obs_ok[:, problem.pairs.i] & obs_ok[:, problem.pairs.j]
              & pv[None])
    damper = spring[:-1] & spring[1:]
    return obs_ok, spring, damper


def _edge_diff(x, i, j):
    """x[:, i] - x[:, j] for x [K, P, ...]."""
    return x[:, i] - x[:, j]


def _scatter_edges(vals, i, j, P):
    """[K, E, ...] -> [K, P, ...]: +vals at i, -vals at j."""
    out = torch.zeros((vals.shape[0], P) + vals.shape[2:], dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(1, i, vals)
    out.index_add_(1, j, -vals)
    return out


def _scatter_both(vals, i, j, P):
    out = torch.zeros((vals.shape[0], P) + vals.shape[2:], dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(1, i, vals)
    out.index_add_(1, j, vals)
    return out


def _shift_add(x, d):
    """x[:-1] -= d; x[1:] += d (the damper's per-keyframe endpoint signs)."""
    zero = torch.zeros_like(d[:1])
    return x - torch.cat([d, zero]) + torch.cat([zero, d])


def _system(cam, poses: se3.SE3, L, problem: BAProblem, obs_mask,
            spring_mask, damper_mask, info_s):
    """chi2, gradient, hvp and block diagonal of the BA normal equations.
    Parameter layout [K*6 twists, K*P*3 landmarks]."""
    K, P, _ = L.shape
    pairs = problem.pairs
    i, j = pairs.i, pairs.j

    e_r, J_pose, J_land = residuals.reprojection(
        cam, tree_map(lambda x: x[:, None], poses), L, problem.obs)
    live = obs_mask[..., None] > 0
    e_r = torch.where(live, e_r, torch.zeros_like(e_r))
    J_pose = torch.where(live[..., None], J_pose, torch.zeros_like(J_pose))
    J_land = torch.where(live[..., None], J_land, torch.zeros_like(J_land))
    chi2_r = INFO_REPROJECTION * torch.sum(e_r * e_r, dim=-1)
    w_r = INFO_REPROJECTION * core.huber_weight(chi2_r, TH_2DOF) * obs_mask

    diff = _edge_diff(L, i, j)
    dist = torch.linalg.norm(diff, dim=-1)
    safe_d0 = torch.clamp(pairs.d0, min=1e-12)[None]
    e_p = SPRING_K * (dist - pairs.d0[None]) / safe_d0
    chi2_p = INFO_POSITION * e_p * e_p
    w_p = INFO_POSITION * spring_mask
    a = (SPRING_K / safe_d0)[..., None] * diff \
        / torch.clamp(dist, min=1e-12)[..., None]

    ddiff = _edge_diff(L[1:] - L[:-1], i, j)
    e_d = pairs.w[None, :, None] * ddiff
    chi2_d = info_s * torch.sum(e_d * e_d, dim=-1)
    w_d = info_s * core.huber_weight(chi2_d, TH_3DOF) * damper_mask
    wd2 = w_d * pairs.w[None] ** 2

    chi2 = (torch.sum(core.huber_rho(chi2_r, TH_2DOF) * obs_mask)
            + torch.sum(chi2_p * spring_mask)
            + torch.sum(core.huber_rho(chi2_d, TH_3DOF) * damper_mask))

    g_pose = torch.einsum("kpri,kp,kpr->ki", J_pose, w_r, e_r)
    g_land = torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, e_r)
    g_land = g_land + _scatter_edges((w_p * e_p)[..., None] * a, i, j, P)
    g_land = _shift_add(g_land, _scatter_edges(wd2[..., None] * ddiff, i, j,
                                               P))
    g = torch.cat([g_pose.reshape(-1), g_land.reshape(-1)])

    H_pose = torch.einsum("kpri,kp,kprj->kij", J_pose, w_r, J_pose)
    D = torch.einsum("kprl,kp,kprm->kplm", J_land, w_r, J_land)
    eye3 = torch.eye(3, dtype=L.dtype, device=L.device)
    aaT = w_p[..., None, None] * a[..., :, None] * a[..., None, :]
    D = D + _scatter_both(aaT, i, j, P)
    wd2p = _scatter_both(wd2, i, j, P)[..., None, None] * eye3
    zero = torch.zeros_like(wd2p[:1])
    D = D + torch.cat([wd2p, zero]) + torch.cat([zero, wd2p])

    def hvp(v, lam):
        vp = v[:K * 6].reshape(K, 6)
        vl = v[K * 6:].reshape(K, P, 3)
        r_lin = (torch.einsum("kpri,ki->kpr", J_pose, vp)
                 + torch.einsum("kprl,kpl->kpr", J_land, vl))
        out_pose = torch.einsum("kpri,kp,kpr->ki", J_pose, w_r, r_lin)
        out_land = torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, r_lin)
        dv = _edge_diff(vl, i, j)
        pv = (w_p * torch.sum(a * dv, dim=-1))[..., None] * a
        out_land = out_land + _scatter_edges(pv, i, j, P)
        sv = wd2[..., None] * _edge_diff(vl[1:] - vl[:-1], i, j)
        out_land = _shift_add(out_land, _scatter_edges(sv, i, j, P))
        return torch.cat([out_pose.reshape(-1), out_land.reshape(-1)]) \
            + lam * v

    return chi2, g, hvp, (H_pose, D)


def _block_preconditioner(H_pose, D, lam):
    K, P = D.shape[0], D.shape[1]
    eye6 = torch.eye(6, dtype=H_pose.dtype, device=H_pose.device)
    eye3 = torch.eye(3, dtype=D.dtype, device=D.device)
    Hp_inv = core.inv_small(H_pose + lam * eye6)
    D_inv = core.inv3x3(D + lam * eye3)

    def apply(r):
        zp = torch.einsum("kij,kj->ki", Hp_inv, r[:K * 6].reshape(K, 6))
        zl = torch.einsum("kplm,kpm->kpl", D_inv, r[K * 6:].reshape(K, P, 3))
        return torch.cat([zp.reshape(-1), zl.reshape(-1)])

    return apply


def local_deformable_ba_plain(cam: cameras.Camera, poses0: se3.SE3, L0,
                              problem: BAProblem, n_iters: int = 5,
                              cg_iters: int = 32):
    """Plain PyTorch driver (the CPU path and the kernel's oracle)."""
    K, P, _ = L0.shape
    sigma_s = 0.1 * problem.scale
    info_s = 1.0 / (sigma_s * sigma_s)
    pairs = problem.pairs
    problem = problem._replace(pairs=pairs._replace(
        i=pairs.i.to(torch.int64), j=pairs.j.to(torch.int64)))
    obs_mask, spring_mask, damper_mask = (
        m.to(torch.float32) for m in _masks(problem))

    chi2_cur, _, _, (H_pose0, D0) = _system(cam, poses0, L0, problem,
                                            obs_mask, spring_mask,
                                            damper_mask, info_s)
    diag0 = torch.cat([
        torch.diagonal(H_pose0, dim1=-2, dim2=-1).reshape(-1),
        torch.diagonal(D0, dim1=-2, dim2=-1).reshape(-1)])
    lam = core.lm_lambda_init(diag0)
    nu = torch.full_like(lam, 2.0)

    q, t, L = poses0.q, poses0.t, L0
    for _ in range(n_iters):
        poses = se3.SE3(q, t)
        _, g, hvp, (H_pose, D) = _system(cam, poses, L, problem, obs_mask,
                                         spring_mask, damper_mask, info_s)
        m_inv = _block_preconditioner(H_pose, D, lam)
        dx = core.pcg(lambda v: hvp(v, lam), -g, m_inv, cg_iters)
        poses_new = se3.retract(poses, dx[:K * 6].reshape(K, 6))
        L_new = L + dx[K * 6:].reshape(K, P, 3)
        chi2_new, _, _, _ = _system(cam, poses_new, L_new, problem, obs_mask,
                                    spring_mask, damper_mask, info_s)
        rho = core.gain_ratio(chi2_cur, chi2_new, dx, lam, g)
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        q = torch.where(accepted, poses_new.q, q)
        t = torch.where(accepted, poses_new.t, t)
        L = torch.where(accepted, L_new, L)
        chi2_cur = torch.where(accepted, chi2_new, chi2_cur)
    return se3.SE3(q, t), L


def local_deformable_ba(cam: cameras.Camera, poses0: se3.SE3, L0,
                        problem: BAProblem, n_iters: int = 5,
                        cg_iters: int = 32):
    """Window BA from poses0 [K] and landmark seeds L0 [K, P, 3].
    Returns (poses [K], landmarks [K, P, 3])."""
    return local_deformable_ba_plain(cam, poses0, L0, problem, n_iters,
                                     cg_iters)
