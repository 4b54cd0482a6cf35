"""Keyframe-axis sharded local deformable bundle adjustment (counterpart of
nrslam_tpu/parallel/ba_shard.py).

Reprojection and spring factors touch one keyframe's variables; the 4-ary
temporal dampers couple consecutive keyframes only. Each of the n ranks
owns a contiguous block of ``K / n`` keyframes (poses, landmark copies,
observations); the pair table and the map scale are replicated. A damper
between a block's last keyframe and the next block's first is evaluated by
the owning (left) block on a halo of the neighbour's first-keyframe
landmarks (``sharding.recv_next``); its gradient, diagonal and
Hessian-vector contributions to the neighbour go back by the reverse halo
(``sharding.send_next``). Scalars (chi2, the CG dot products, the LM gain)
are SUM-reduced and lambda0 MAX-reduced, so every rank steps the same LM
trajectory.

The math is factor for factor the single-process plain driver's
(``solver/bundle_adjustment._system``): edge gathers and ``index_add_``
scatters over the ``(i, j)`` pair list, and unobserved copies dropped from
every factor (their Jacobians zeroed, not multiplied by a zero mask).
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import sharding
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.solver import core, residuals
from nrslam_tpu_torch.solver.bundle_adjustment import (
    INFO_POSITION, INFO_REPROJECTION, SPRING_K, TH_2DOF, TH_3DOF, BAProblem,
    _block_preconditioner, _edge_diff, _scatter_both, _scatter_edges)
from nrslam_tpu_torch.utils.tree import tree_map


def _ends(x, d, first_sign: float):
    """x with ``first_sign * d[k]`` added to row k and ``d[k]`` to row k+1
    (the internal dampers' two ends; ``d`` has one row fewer than x, none
    for a one-keyframe block)."""
    out = x.clone()
    out[:-1] += first_sign * d
    out[1:] += d
    return out


def _system_block(mesh: Mesh, cam, poses: se3.SE3, L, obs, obs_mask,
                  spring_mask, damper_int, damper_bnd, pairs, info_s):
    """chi2 (reduced), gradient, hvp and block diagonal of this rank's
    keyframe block [Kl, ...] with the boundary halo terms.
    ``damper_bnd`` [E] masks the boundary dampers this block owns (zero on
    the last rank)."""
    Kl, P, _ = L.shape
    i, j = pairs.i, pairs.j

    e_r, J_pose, J_land = residuals.reprojection(
        cam, tree_map(lambda x: x[:, None], poses), L, obs)
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

    # Internal dampers [Kl-1, E] and the boundary damper [E] on the halo.
    ddiff_i = _edge_diff(L[1:] - L[:-1], i, j)
    chi2_di = info_s * torch.sum((pairs.w[None, :, None] * ddiff_i) ** 2,
                                 dim=-1)
    w_di = info_s * core.huber_weight(chi2_di, TH_3DOF) * damper_int
    wd2_i = w_di * pairs.w[None] ** 2

    dflow_b = sharding.recv_next(mesh, L[0]) - L[-1]
    ddiff_b = dflow_b[i] - dflow_b[j]
    chi2_db = info_s * torch.sum((pairs.w[:, None] * ddiff_b) ** 2, dim=-1)
    w_db = info_s * core.huber_weight(chi2_db, TH_3DOF) * damper_bnd
    wd2_b = w_db * pairs.w ** 2

    chi2_local = (torch.sum(core.huber_rho(chi2_r, TH_2DOF) * obs_mask)
                  + torch.sum(chi2_p * spring_mask)
                  + torch.sum(core.huber_rho(chi2_di, TH_3DOF) * damper_int)
                  + torch.sum(core.huber_rho(chi2_db, TH_3DOF) * damper_bnd))
    chi2, = sharding.all_reduce_sum(mesh, chi2_local)

    def boundary(vals):
        """The owning block's last keyframe gets -vals, the next block's
        first +vals (the damper's endpoint signs across the cut)."""
        out = torch.zeros((Kl,) + vals.shape, dtype=vals.dtype,
                          device=vals.device)
        out[-1] -= vals
        out[0] += sharding.send_next(mesh, vals)
        return out

    g_pose = torch.einsum("kpri,kp,kpr->ki", J_pose, w_r, e_r)
    g_land = torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, e_r)
    g_land = g_land + _scatter_edges((w_p * e_p)[..., None] * a, i, j, P)
    g_land = _ends(g_land, _scatter_edges(wd2_i[..., None] * ddiff_i,
                                          i, j, P), -1.0)
    g_land = g_land + boundary(_scatter_edges(
        (wd2_b[:, None] * ddiff_b)[None], i, j, P)[0])
    g = torch.cat([g_pose.reshape(-1), g_land.reshape(-1)])

    H_pose = torch.einsum("kpri,kp,kprj->kij", J_pose, w_r, J_pose)
    D = torch.einsum("kprl,kp,kprm->kplm", J_land, w_r, J_land)
    eye3 = torch.eye(3, dtype=L.dtype, device=L.device)
    aaT = w_p[..., None, None] * a[..., :, None] * a[..., None, :]
    D = D + _scatter_both(aaT, i, j, P)
    wd2p = _ends(torch.zeros((Kl, P), dtype=L.dtype, device=L.device),
                 _scatter_both(wd2_i, i, j, P), 1.0)
    # The boundary damper adds to the diagonal of both its ends.
    wd2p_b = _scatter_both(wd2_b[None], i, j, P)[0]
    wd2p[-1] += wd2p_b
    wd2p[0] += sharding.send_next(mesh, wd2p_b)
    D = D + wd2p[..., None, None] * eye3

    def hvp(v, lam):
        vp = v[:Kl * 6].reshape(Kl, 6)
        vl = v[Kl * 6:].reshape(Kl, P, 3)
        r_lin = (torch.einsum("kpri,ki->kpr", J_pose, vp)
                 + torch.einsum("kprl,kpl->kpr", J_land, vl))
        out_pose = torch.einsum("kpri,kp,kpr->ki", J_pose, w_r, r_lin)
        out_land = torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, r_lin)
        dv = _edge_diff(vl, i, j)
        pv = (w_p * torch.sum(a * dv, dim=-1))[..., None] * a
        out_land = out_land + _scatter_edges(pv, i, j, P)
        sv = wd2_i[..., None] * _edge_diff(vl[1:] - vl[:-1], i, j)
        out_land = _ends(out_land, _scatter_edges(sv, i, j, P), -1.0)
        dvf_b = sharding.recv_next(mesh, vl[0]) - vl[-1]
        sv_b = wd2_b[:, None] * (dvf_b[i] - dvf_b[j])
        out_land = out_land + boundary(
            _scatter_edges(sv_b[None], i, j, P)[0])
        return torch.cat([out_pose.reshape(-1), out_land.reshape(-1)]) \
            + lam * v

    return chi2, g, hvp, (H_pose, D)


def _pcg_dist(mesh: Mesh, hvp, b, m_inv, iters: int, tol: float = 1e-8):
    """``core.pcg`` on a keyframe-distributed vector: block-local vectors,
    SUM-reduced dot products, the same ``done`` mask."""
    def dot(*pairs):
        return sharding.all_reduce_sum(
            mesh, *(torch.dot(u, v) for u, v in pairs))

    x = torch.zeros_like(b)
    r = b
    z = m_inv(r)
    p = z
    rz, b2 = dot((r, z), (b, b))
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        hp = hvp(p)
        denom, = dot((p, hp))
        alpha = torch.where(torch.abs(denom) > 0, rz / denom, zero)
        alpha = torch.where(done, zero, alpha)
        x = x + alpha * p
        r = r - alpha * hp
        z = m_inv(r)
        rz_new, rr = dot((r, z), (r, r))
        beta = torch.where(torch.abs(rz) > 0, rz_new / rz, zero)
        p = z + beta * p
        done = done | (rr <= tol * tol * b2)
        rz = torch.where(done, rz, rz_new)
    return x


def local_deformable_ba_kf_sharded(mesh: Mesh, cam: cameras.Camera,
                                   poses0: se3.SE3, L0, problem: BAProblem,
                                   n_iters: int = 5, cg_iters: int = 32):
    """Keyframe-axis sharded BA solve with ``local_deformable_ba``'s
    contract: every rank passes the whole window (poses0 [K], L0 [K, P, 3],
    the problem), solves its block and returns the whole solved window,
    gathered. K must split evenly over the ranks."""
    n, rank = mesh.world_size, mesh.rank
    K, P, _ = L0.shape
    assert K % n == 0, f"K={K} not divisible by {n} ranks"
    Kl = K // n
    block = slice(rank * Kl, (rank + 1) * Kl)

    pairs = problem.pairs
    pairs = pairs._replace(i=pairs.i.to(torch.int64),
                           j=pairs.j.to(torch.int64))
    sigma_s = 0.1 * problem.scale
    info_s = 1.0 / (sigma_s * sigma_s)
    obs_ok = (problem.obs_valid & problem.kf_valid[:, None])[block] \
        .to(torch.float32)
    spring = (obs_ok[:, pairs.i] * obs_ok[:, pairs.j]
              * pairs.valid[None].to(torch.float32))
    damper_int = spring[:-1] * spring[1:]
    has_next = float(rank < n - 1)
    damper_bnd = spring[-1] * sharding.recv_next(mesh, spring[0]) * has_next
    obs = problem.obs[block]

    def system(q, t, L):
        return _system_block(mesh, cam, se3.SE3(q, t), L, obs, obs_ok,
                             spring, damper_int, damper_bnd, pairs, info_s)

    q, t, L = poses0.q[block], poses0.t[block], L0[block]
    chi2_cur, _, _, (H_pose0, D0) = system(q, t, L)
    diag0 = torch.cat([
        torch.diagonal(H_pose0, dim1=-2, dim2=-1).reshape(-1),
        torch.diagonal(D0, dim1=-2, dim2=-1).reshape(-1)])
    lam = core.LM_TAU * sharding.all_reduce_max(mesh, torch.amax(diag0))[0]
    nu = torch.full_like(lam, 2.0)
    for _ in range(n_iters):
        _, g, hvp, (H_pose, D) = system(q, t, L)
        m_inv = _block_preconditioner(H_pose, D, lam)
        dx = _pcg_dist(mesh, lambda v: hvp(v, lam), -g, m_inv, cg_iters)
        poses_new = se3.retract(se3.SE3(q, t), dx[:Kl * 6].reshape(Kl, 6))
        L_new = L + dx[Kl * 6:].reshape(Kl, P, 3)
        chi2_new, _, _, _ = system(poses_new.q, poses_new.t, L_new)
        denom, = sharding.all_reduce_sum(mesh, torch.dot(dx, lam * dx - g))
        rho = (chi2_cur - chi2_new) / torch.where(
            torch.abs(denom) > 0, denom, torch.ones_like(denom))
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        q = torch.where(accepted, poses_new.q, q)
        t = torch.where(accepted, poses_new.t, t)
        L = torch.where(accepted, L_new, L)
        chi2_cur = torch.where(accepted, chi2_new, chi2_cur)
    q, t, L = sharding.all_gather_rows(mesh, [q, t, L])
    return se3.SE3(q, t), L
