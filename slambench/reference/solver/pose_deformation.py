"""Joint camera-pose + deformation optimization (the tracking backbone).

Counterpart of nrslam_tpu/solver/pose_deformation.py (reference
CameraPoseAndDeformationOptimization, g2o_optimization.cc:148-557).

Variables: one SE(3) twist + a per-point 3D flow. Factors per
TRACKED_WITH_3D point: reprojection of ``rest + flow`` (info 4, Huber 5.99),
spatial dampers ``w (f_i - f_j)`` (info 1/(0.1 scale)^2, Huber 0.584) and
springs ``1.1 (||X_i - X_j|| - d0)/d0`` (info 100, Huber 0.584) over the
deduplicated neighbour pairs. Two rounds of <= 10 LM steps, each solved by a
10-trip block-Jacobi PCG; edges re-level between rounds.

Edge terms gather ``flows[i]``/``flows[j]`` and scatter back with
``index_add_`` over the ``(i, j)`` edge list. ``pose_deformation_optimization``
runs the plain driver here on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.geometry import cameras, se3
from slambench.reference.solver import core, residuals
from slambench.reference.utils import stats

TH_2DOF = 5.99
TH_3DOF = 0.584
SIGMA_REPROJECTION = 0.5
SIGMA_POSITION = 0.1
SPRING_K = 1.1


class PairEdges(NamedTuple):
    """Flattened undirected pair-edge table (spatial + position factors)."""

    i: torch.Tensor      # [E] int
    j: torch.Tensor      # [E] int
    w: torch.Tensor      # [E] RBF weight
    d0: torch.Tensor     # [E] rest distance
    valid: torch.Tensor  # [E] bool


def pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0, nbr_valid) -> PairEdges:
    """Deduplicated pair edges from a [P, K] neighbour table: directed
    (i, j) survives iff i < j or the reverse entry is not a valid neighbour."""
    P, K = nbr_idx.shape
    nbr_idx = nbr_idx.to(torch.int64)
    src = torch.arange(P, device=nbr_idx.device).repeat_interleave(K)
    dst = nbr_idx.reshape(-1)
    w = nbr_w.reshape(-1)
    d0 = nbr_d0.reshape(-1)
    valid = nbr_valid.reshape(-1)
    rev = nbr_idx[dst]
    rev_valid = nbr_valid[dst]
    mutual = torch.any((rev == src[:, None]) & rev_valid, dim=-1)
    keep = valid & ((src < dst) | ~mutual)
    return PairEdges(src, dst, w, d0, keep)


def edge_budget(P: int, E_raw: int) -> int:
    """Live-edge budget ceil(K/2)*P + P for a raw directed P*K table."""
    K = max(1, -(-E_raw // max(P, 1)))
    return (-(-K // 2) + 1) * P


def compact_pairs(pairs: PairEdges, P: int, point_valid=None) -> PairEdges:
    """Keep the budget's highest-weight live edges (ties lowest index
    first, as jax.lax.top_k); no-op when the table already fits."""
    E_raw = pairs.i.shape[0]
    budget = ((min(E_raw, edge_budget(P, E_raw)) + 127) // 128) * 128
    if E_raw <= budget:
        return pairs
    base = pairs.valid
    if point_valid is not None:
        base = base & point_valid[pairs.i] & point_valid[pairs.j]
    score = torch.where(base, pairs.w, torch.full_like(pairs.w, -float("inf")))
    esel = torch.sort(score, descending=True, stable=True).indices[:budget]
    return PairEdges(i=pairs.i[esel], j=pairs.j[esel], w=pairs.w[esel],
                     d0=pairs.d0[esel], valid=base[esel])


class Linearization(NamedTuple):
    """System linearized at one (pose, flows) point."""

    g: torch.Tensor        # [6+3P]
    chi2: torch.Tensor     # robustified total
    H_pose: torch.Tensor   # [6, 6]
    D_flow: torch.Tensor   # [P, 3, 3]
    J_pose: torch.Tensor   # [P, 2, 6]
    J_flow: torch.Tensor   # [P, 2, 3]
    w_r: torch.Tensor      # [P]
    ws: torch.Tensor       # [E]
    w_p: torch.Tensor      # [E]
    a: torch.Tensor        # [E, 3]
    chi2_r: torch.Tensor   # [P]
    chi2_s: torch.Tensor   # [E]


def _scatter_edges(vals, i, j, P):
    """sum_e (+vals[e] at i[e], -vals[e] at j[e]) -> [P, ...]."""
    out = torch.zeros((P,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, i, vals)
    out.index_add_(0, j, -vals)
    return out


def _scatter_both(vals, i, j, P):
    """sum_e vals[e] at both endpoints -> [P, ...]."""
    out = torch.zeros((P,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, i, vals)
    out.index_add_(0, j, vals)
    return out


def _system(cam, Tcw, rest, obs, flows, pairs, masks, infos):
    """Linearize at (Tcw, flows). Parameter layout [twist(6), flows(3P)]."""
    point_mask, spatial_mask, spring_mask = masks
    info_r, info_s, info_p = infos
    P = rest.shape[0]

    e_r, J_pose, J_flow = residuals.reprojection(cam, Tcw, rest + flows, obs)
    chi2_r = info_r * torch.sum(e_r * e_r, dim=-1)

    dflow = flows[pairs.i] - flows[pairs.j]
    e_s = pairs.w[:, None] * dflow
    chi2_s = info_s * torch.sum(e_s * e_s, dim=-1)

    diff = (rest[pairs.i] - rest[pairs.j]) + dflow
    dist = torch.linalg.norm(diff, dim=-1)
    safe_d0 = torch.clamp(pairs.d0, min=1e-12)
    e_p = SPRING_K * (dist - pairs.d0) / safe_d0
    chi2_p = info_p * e_p * e_p

    w_r = info_r * core.huber_weight(chi2_r, TH_2DOF) * point_mask
    w_s = info_s * core.huber_weight(chi2_s, TH_3DOF) * spatial_mask
    w_p = info_p * core.huber_weight(chi2_p, TH_3DOF) * spring_mask

    chi2_total = (torch.sum(core.huber_rho(chi2_r, TH_2DOF) * point_mask)
                  + torch.sum(core.huber_rho(chi2_s, TH_3DOF) * spatial_mask)
                  + torch.sum(core.huber_rho(chi2_p, TH_3DOF) * spring_mask))

    ws = pairs.w * pairs.w * w_s
    safe_dist = torch.clamp(dist, min=1e-12)
    a = (SPRING_K / safe_d0)[:, None] * diff / safe_dist[:, None]

    g_pose = torch.einsum("pri,p,pr->i", J_pose, w_r, e_r)
    g_flow = torch.einsum("prk,p,pr->pk", J_flow, w_r, e_r)
    gs = (w_s * pairs.w)[:, None] * e_s + (w_p * e_p)[:, None] * a
    g_flow = g_flow + _scatter_edges(gs, pairs.i, pairs.j, P)
    g = torch.cat([g_pose, g_flow.reshape(-1)])

    H_pose = torch.einsum("pri,p,prj->ij", J_pose, w_r, J_pose)
    D_flow = torch.einsum("prk,p,prl->pkl", J_flow, w_r, J_flow)
    eye3 = torch.eye(3, dtype=rest.dtype, device=rest.device)
    D_flow = D_flow + _scatter_both(ws, pairs.i, pairs.j, P)[:, None, None] \
        * eye3
    aaT = w_p[:, None, None] * a[:, :, None] * a[:, None, :]
    D_flow = D_flow + _scatter_both(aaT, pairs.i, pairs.j, P)

    return Linearization(g, chi2_total, H_pose, D_flow, J_pose, J_flow, w_r,
                         ws, w_p, a, chi2_r, chi2_s)


def _make_hvp(lin: Linearization, pairs: PairEdges):
    """Gauss-Newton Hessian-vector operator from a carried linearization."""
    P = lin.J_flow.shape[0]

    def hvp(v, lam):
        vp = v[:6]
        vf = v[6:].reshape(P, 3)
        r_lin = (torch.einsum("pri,i->pr", lin.J_pose, vp)
                 + torch.einsum("prk,pk->pr", lin.J_flow, vf))
        out_pose = torch.einsum("pri,p,pr->i", lin.J_pose, lin.w_r, r_lin)
        out_flow = torch.einsum("prk,p,pr->pk", lin.J_flow, lin.w_r, r_lin)
        dv = vf[pairs.i] - vf[pairs.j]
        ev = (lin.ws[:, None] * dv
              + (lin.w_p * torch.sum(lin.a * dv, dim=-1))[:, None] * lin.a)
        out_flow = out_flow + _scatter_edges(ev, pairs.i, pairs.j, P)
        return torch.cat([out_pose, out_flow.reshape(-1)]) + lam * v

    return hvp


def _block_preconditioner(H_pose, D_flow, lam):
    """Inverse of the (pose 6x6, per-point 3x3) diagonal blocks + lam I."""
    P = D_flow.shape[0]
    eye6 = torch.eye(6, dtype=H_pose.dtype, device=H_pose.device)
    eye3 = torch.eye(3, dtype=H_pose.dtype, device=H_pose.device)
    Hp_inv = core.inv_small(H_pose + lam * eye6)
    Df_inv = core.inv3x3(D_flow + lam * eye3)

    def apply(r):
        zp = Hp_inv @ r[:6]
        zf = torch.einsum("pkl,pl->pk", Df_inv, r[6:].reshape(P, 3))
        return torch.cat([zp, zf.reshape(-1)])

    return apply


def _lm_optimize(cam, Tcw0, rest, obs, pairs, masks, infos, n_iters,
                 cg_iters):
    """LM with the linearization carried across iterations; each update is
    gated on ``run = ~done`` (fixed trip count, identical result)."""
    P = rest.shape[0]
    flows = torch.zeros_like(rest)
    lin = _system(cam, Tcw0, rest, obs, flows, pairs, masks, infos)
    diag0 = torch.cat([torch.diagonal(lin.H_pose),
                       torch.diagonal(lin.D_flow, dim1=-2, dim2=-1)
                       .reshape(-1)])
    lam = core.lm_lambda_init(diag0)
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=rest.device)
    Tq, Tt = Tcw0.q, Tcw0.t
    for _ in range(n_iters):
        hvp = _make_hvp(lin, pairs)
        m_inv = _block_preconditioner(lin.H_pose, lin.D_flow, lam)
        dx = core.pcg(lambda v: hvp(v, lam), -lin.g, m_inv, cg_iters)
        T_new = se3.retract(se3.SE3(Tq, Tt), dx[:6])
        flows_new = flows + dx[6:].reshape(P, 3)
        lin_new = _system(cam, T_new, rest, obs, flows_new, pairs, masks,
                          infos)
        rho = core.gain_ratio(lin.chi2, lin_new.chi2, dx, lam, lin.g)
        lam_new, nu_new, accepted = core.lm_lambda_update(lam, nu, rho)
        run = ~done
        acc = accepted & run
        Tq = torch.where(acc, T_new.q, Tq)
        Tt = torch.where(acc, T_new.t, Tt)
        flows = torch.where(acc, flows_new, flows)
        lin = Linearization(*(torch.where(acc, a, b)
                              for a, b in zip(lin_new, lin)))
        lam = torch.where(run, lam_new, lam)
        nu = torch.where(run, nu_new, nu)
        done = done | (acc & (torch.dot(dx, dx) < 1e-12))
    return se3.SE3(Tq, Tt), flows


class PoseDeformationResult(NamedTuple):
    Tcw: se3.SE3
    flows: torch.Tensor            # [P, 3]
    reproj_inlier: torch.Tensor    # [P] bool
    deform_ok: torch.Tensor        # [P] bool
    median_deformation: torch.Tensor


def _post_gates(flows, chi2_r, point_valid):
    """Reprojection gate + IQR deformation gate + median magnitude."""
    reproj_inlier = point_valid & (chi2_r <= TH_2DOF)
    mag = torch.linalg.norm(flows, dim=-1)
    iqr_th = stats.iqr_upper_threshold(mag, point_valid)
    deform_ok = point_valid & (mag < iqr_th)
    median_def = stats.masked_median(mag, point_valid)
    return reproj_inlier, deform_ok, median_def


def infos_for(scale):
    """(info_r, info_s, info_p) with the spatial sigma 0.1 * scale."""
    sigma_s = 0.1 * scale
    return (1.0 / SIGMA_REPROJECTION ** 2, 1.0 / (sigma_s * sigma_s),
            1.0 / SIGMA_POSITION ** 2)


def pose_deformation_plain(cam, Tcw0, rest, obs, point_valid, pairs, scale,
                           rounds=(10, 10), cg_iters: int = 10):
    """Plain PyTorch schedule on an already-compacted edge table.
    Returns (Tcw, flows [P, 3], chi2_r [P]) like the kernel wrapper."""
    infos = infos_for(scale)
    pairs = pairs._replace(i=pairs.i.to(torch.int64),
                           j=pairs.j.to(torch.int64))
    pair_base = (pairs.valid & point_valid[pairs.i]
                 & point_valid[pairs.j]).to(torch.float32)
    pmask = point_valid.to(torch.float32)
    full = (pmask, pair_base, pair_base)
    point_mask, spatial_mask = pmask, pair_base

    T, flows = Tcw0, torch.zeros_like(rest)
    for n in rounds:
        masks = (point_mask, spatial_mask, pair_base)
        T, flows = _lm_optimize(cam, Tcw0, rest, obs, pairs, masks, infos,
                                n, cg_iters)
        lin = _system(cam, T, rest, obs, flows, pairs, full, infos)
        point_mask = pmask * (lin.chi2_r <= TH_2DOF).to(torch.float32)
        spatial_mask = pair_base * (lin.chi2_s <= TH_3DOF).to(torch.float32)

    lin_final = _system(cam, T, rest, obs, flows, pairs, full, infos)
    return T, flows, lin_final.chi2_r


def pose_deformation_optimization(cam: cameras.Camera, Tcw0: se3.SE3, rest,
                                  obs, point_valid, pairs: PairEdges, scale,
                                  rounds=(10, 10),
                                  cg_iters: int = 10) -> PoseDeformationResult:
    """Full two-round schedule + post-gating.

    rest [P, 3] world rest positions, obs [P, 2], point_valid [P]
    (TRACKED_WITH_3D), pairs the deduplicated neighbour edges, scale the
    global map scale (spatial sigma 0.1 * scale).
    """
    pairs = compact_pairs(pairs, rest.shape[0], point_valid)
    T, flows, chi2_r = pose_deformation_plain(
        cam, Tcw0, rest, obs, point_valid, pairs, scale, rounds, cg_iters)
    reproj_inlier, deform_ok, median_def = _post_gates(flows, chi2_r,
                                                       point_valid)
    return PoseDeformationResult(T, flows, reproj_inlier, deform_ok,
                                 median_def)


def lost_point_drag(flows, lost_nbr_idx, lost_nbr_w, lost_nbr_valid, scale,
                    n_irls: int = 10):
    """Drag lost landmarks along their neighbours' flow: per point, an IRLS
    robust weighted mean of neighbour flows (g2o_optimization.cc:476-556).
    Returns [L, 3]."""
    sigma_s = 0.1 * scale
    info_s = 1.0 / (sigma_s * sigma_s)
    nbr_flows = flows[lost_nbr_idx]
    w = lost_nbr_w * lost_nbr_valid.to(torch.float32)
    valid_f = lost_nbr_valid.to(torch.float32)
    f = torch.zeros((lost_nbr_idx.shape[0], 3), dtype=flows.dtype,
                    device=flows.device)
    for _ in range(n_irls):
        r = f[:, None, :] - nbr_flows
        chi2 = info_s * torch.sum((w[..., None] * r) ** 2, dim=-1)
        wt = w * w * core.huber_weight(chi2, TH_3DOF) * valid_f
        denom = torch.sum(wt, dim=-1, keepdim=True)
        f_new = torch.sum(wt[..., None] * nbr_flows, dim=1) \
            / torch.clamp(denom, min=1e-12)
        f = torch.where(denom > 0, f_new, f)
    return f
