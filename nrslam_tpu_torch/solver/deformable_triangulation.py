"""Deformable landmark triangulation, batched over candidates (counterpart
of nrslam_tpu/solver/deformable_triangulation.py; see its docstring for the
world-frame parameterisation and the structured Hessian
``blockdiag(B_t) + Laplacian(W) (x) I_3``).

Per candidate: rigid pre-gates, neighbour-depth seeds, 10 LM iterations
each solved by a 12-trip block-Jacobi PCG, then the damper/reprojection
acceptance gates and the last-frame depth along the last ray.

``deformable_triangulate`` dispatches on the device of its inputs: CUDA
tensors go to the hand-written kernel (``deformable_triangulation_cuda``,
csrc/deformable_triangulation.cu: one launch a call, which raises if it
cannot build or launch, and counts the LM steps its candidates accepted as
``profiler.device_count("triangulation.lm_accepted")``); CPU tensors run
``deformable_triangulate_plain``, the kernel's oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrslam_tpu_torch.geometry import cameras, se3, triangulation
from nrslam_tpu_torch.solver import core
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.tree import tree_map

INFO_REPROJECTION = 1.0 / (0.5 ** 2)
SIGMA_SPATIAL = 0.1
INFO_SPATIAL = 1.0 / (SIGMA_SPATIAL ** 2)
TH_3DOF = 7.815
REPROJ_REJECT = 5.99 * 10.0


class TriangulationInputs(NamedTuple):
    obs: torch.Tensor          # [C, T, 2]
    track_valid: torch.Tensor  # [C, T]
    nbr_pos: torch.Tensor      # [C, NB, T, 3]
    nbr_valid: torch.Tensor    # [C, NB, T]
    cand_valid: torch.Tensor   # [C]


def _first_last_idx(track_valid):
    T = track_valid.shape[-1]
    idx = torch.arange(T, device=track_valid.device)
    first = torch.amin(torch.where(track_valid, idx, T), dim=-1)
    last = torch.amax(torch.where(track_valid, idx, -1), dim=-1)
    return torch.clamp(first, 0, T - 1), torch.clamp(last, 0, T - 1)


def _take_t(x, t):
    """x[c, t[c]] for x [C, T, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), t]


def rigid_pregate(cam, inputs: TriangulationInputs, Tcw: se3.SE3,
                  rad_per_pixel: float):
    """First/last-frame rigid triangulation gates. Returns [C] bool."""
    first, last = _first_last_idx(inputs.track_valid)
    obs_f = _take_t(inputs.obs, first)
    obs_l = _take_t(inputs.obs, last)
    T_f = se3.index(Tcw, first)
    T_l = se3.index(Tcw, last)

    ray_f = cameras.unit_rays(cam, obs_f)
    ray_l = cameras.unit_rays(cam, obs_l)
    X = triangulation.triangulate_midpoint(ray_l, ray_f, T_l, T_f)

    Xf = se3.apply(T_f, X)
    Xl = se3.apply(T_l, X)
    e_f = triangulation.squared_reprojection_error(obs_f,
                                                   cameras.project(cam, Xf))
    e_l = triangulation.squared_reprojection_error(obs_l,
                                                   cameras.project(cam, Xl))
    n1 = X - se3.inverse(T_f).t
    n2 = X - se3.inverse(T_l).t
    parallax = triangulation.rays_parallax(n1, n2)
    return (torch.isfinite(X).all(dim=-1) & (e_f <= 5.991) & (e_l <= 5.991)
            & (parallax >= rad_per_pixel * 5.0))


def _seeds(cam, inputs: TriangulationInputs, Tcw: se3.SE3):
    """Per-frame camera-frame seeds from mean neighbour depth."""
    nbr_cam = se3.apply(tree_map(lambda x: x[None, None], Tcw),
                        inputs.nbr_pos)
    depths = nbr_cam[..., 2]
    w = inputs.nbr_valid.to(torch.float32)
    n_nbr = torch.sum(w, dim=1)
    depth_seed = torch.sum(depths * w, dim=1) / torch.clamp(n_nbr, min=1.0)
    seed_ok = (n_nbr > 0) & (depth_seed > 0)
    rays = cameras.unproject(cam, inputs.obs)
    return rays * depth_seed[..., None], seed_ok


def _assemble(cam, V, inputs, frame_mask, pair_mask, flow_obs, Rcw, tcw):
    """chi2 [C], g [C,T,3], B [C,T,3,3], diag_L [C,T], Wsym [C,T,T],
    chi2_r [C,T], chi2_s [C,T,T,NB] at world-frame vertices V [C,T,3]."""
    Xc = torch.einsum("tij,ctj->cti", Rcw, V) + tcw[None]
    e_r = inputs.obs - cameras.project(cam, Xc)
    Jp = cameras.projection_jacobian(cam, Xc)
    Jr = -torch.einsum("ctri,tij->ctrj", Jp, Rcw)
    chi2_r = INFO_REPROJECTION * torch.sum(e_r * e_r, dim=-1)
    w_r = INFO_REPROJECTION * frame_mask

    dflow = V[:, None, :, :] - V[:, :, None, :]
    e_s = flow_obs - dflow[:, :, :, None, :]
    chi2_s = INFO_SPATIAL * torch.sum(e_s * e_s, dim=-1)
    w_s = INFO_SPATIAL * core.huber_weight(chi2_s, TH_3DOF) * pair_mask

    chi2 = (torch.sum(chi2_r * frame_mask, dim=-1)
            + torch.sum(core.huber_rho(chi2_s, TH_3DOF) * pair_mask,
                        dim=(-1, -2, -3)))

    g = torch.einsum("ctri,ct,ctr->cti", Jr, w_r, e_r)
    s = torch.sum(w_s[..., None] * e_s, dim=3)
    g = g + torch.sum(s, dim=2) - torch.sum(s, dim=1)

    B = torch.einsum("ctri,ct,ctrj->ctij", Jr, w_r, Jr)
    w_sum = torch.sum(w_s, dim=3)
    Wsym = w_sum + w_sum.transpose(1, 2)
    diag_L = torch.sum(Wsym, dim=2)
    return chi2, g, B, diag_L, Wsym, chi2_r, chi2_s


def _batched_pcg(B, diag_L, Wsym, lam, b, n_iters: int):
    """(H + lam I) x = b per candidate, block-Jacobi PCG."""
    eye3 = torch.eye(3, dtype=b.dtype, device=b.device)
    dl = diag_L + lam[:, None]
    Minv = core.inv3x3(B + dl[..., None, None] * eye3)

    def dotc(x, y):
        return torch.sum(x * y, dim=(1, 2))

    def hv(v):
        return (torch.einsum("ctij,ctj->cti", B, v) + dl[..., None] * v
                - torch.einsum("ctu,cuk->ctk", Wsym, v))

    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("ctij,ctj->cti", Minv, r)
    p = z
    rz = dotc(r, z)
    zero = torch.zeros_like(rz)
    for _ in range(n_iters):
        hp = hv(p)
        php = dotc(p, hp)
        alpha = torch.where(php > 0, rz / torch.clamp(php, min=1e-30), zero)
        x = x + alpha[:, None, None] * p
        r = r - alpha[:, None, None] * hp
        z = torch.einsum("ctij,ctj->cti", Minv, r)
        rz_new = dotc(r, z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), zero)
        p = z + beta[:, None, None] * p
        rz = rz_new
    return x


def deformable_triangulate(cam, inputs: TriangulationInputs, Tcw: se3.SE3,
                           rad_per_pixel: float, min_track: int = 5,
                           n_iters: int = 10, cg_iters: int = 12):
    """Batched deformable triangulation. Tcw: [T] buffer poses.
    Returns (landmarks_world [C, 3], ok [C])."""
    if inputs.obs.device.type == "cpu":
        return deformable_triangulate_plain(cam, inputs, Tcw, rad_per_pixel,
                                            min_track, n_iters, cg_iters)
    from nrslam_tpu_torch.solver import deformable_triangulation_cuda
    X, ok, accepted = deformable_triangulation_cuda.triangulate(
        cam, inputs, Tcw, rad_per_pixel, min_track, n_iters, cg_iters)
    profiler.device_count("triangulation.lm_accepted", accepted)
    return X, ok


def deformable_triangulate_plain(cam, inputs: TriangulationInputs,
                                 Tcw: se3.SE3, rad_per_pixel: float,
                                 min_track: int = 5, n_iters: int = 10,
                                 cg_iters: int = 12):
    """Plain PyTorch triangulation (the CPU path and the kernel's oracle)."""
    C, T, _ = inputs.obs.shape
    dev = inputs.obs.device

    track_len = torch.sum(inputs.track_valid.to(torch.int32), dim=-1)
    pre_ok = (inputs.cand_valid & (track_len >= min_track)
              & rigid_pregate(cam, inputs, Tcw, rad_per_pixel))

    X0, seed_ok = _seeds(cam, inputs, Tcw)
    seeds_all_ok = torch.all(seed_ok | ~inputs.track_valid, dim=-1)
    pre_ok = pre_ok & seeds_all_ok

    Twc = se3.inverse(Tcw)
    Rcw = se3.quat_to_matrix(Tcw.q)
    tcw = Tcw.t

    V0 = se3.apply(tree_map(lambda x: x[None], Twc), X0)
    V0 = torch.where(inputs.track_valid[..., None], V0,
                     torch.ones_like(V0))

    flow_obs = (inputs.nbr_pos[:, :, None, :, :]
                - inputs.nbr_pos[:, :, :, None, :])   # [C, NB, T1, T2, 3]
    flow_obs = flow_obs.permute(0, 2, 3, 1, 4)        # [C, T1, T2, NB, 3]

    tri = torch.triu(torch.ones((T, T), dtype=torch.bool, device=dev), 1)
    pair_mask = inputs.track_valid[:, :, None] & inputs.track_valid[:, None, :]
    nbr_both = (inputs.nbr_valid[:, :, None, :]
                & inputs.nbr_valid[:, :, :, None]).permute(0, 2, 3, 1)
    first, _ = _first_last_idx(inputs.track_valid)
    nbr_at_first = inputs.nbr_valid[torch.arange(C, device=dev), :, first]
    pair_mask = (pair_mask[:, :, :, None] & nbr_both
                 & nbr_at_first[:, None, None, :]
                 & tri[None, :, :, None]).to(torch.float32)
    frame_mask = inputs.track_valid.to(torch.float32)

    chi2_cur, g, B, dL, W, _, _ = _assemble(cam, V0, inputs, frame_mask,
                                            pair_mask, flow_obs, Rcw, tcw)
    diag = torch.amax(torch.diagonal(B, dim1=-2, dim2=-1), dim=-1)
    lam = core.LM_TAU * torch.amax(diag + dL, dim=-1)
    nu = torch.full((C,), 2.0, dtype=V0.dtype, device=dev)

    V = V0
    for _ in range(n_iters):
        dx = _batched_pcg(B, dL, W, lam, -g, cg_iters)
        dx = torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx))
        V_new = V + dx
        chi2_new, g_new, B_new, dL_new, W_new, _, _ = _assemble(
            cam, V_new, inputs, frame_mask, pair_mask, flow_obs, Rcw, tcw)
        denom = torch.sum(dx * (lam[:, None, None] * dx - g), dim=(1, 2))
        rho = (chi2_cur - chi2_new) / torch.where(
            torch.abs(denom) > 0, denom, torch.ones_like(denom))
        lam, nu, accepted = core.lm_lambda_update(lam, nu, rho)
        acc = accepted[:, None, None]
        V = torch.where(acc, V_new, V)
        chi2_cur = torch.where(accepted, chi2_new, chi2_cur)
        g = torch.where(acc, g_new, g)
        B = torch.where(acc[..., None], B_new, B)
        dL = torch.where(accepted[:, None], dL_new, dL)
        W = torch.where(acc, W_new, W)

    _, _, _, _, _, chi2_r, chi2_s = _assemble(cam, V, inputs, frame_mask,
                                              pair_mask, flow_obs, Rcw, tcw)
    n_pairs = torch.sum(pair_mask, dim=(-1, -2, -3))
    bad_pairs = torch.sum((chi2_s > TH_3DOF) * pair_mask, dim=(-1, -2, -3))
    pairs_ok = bad_pairs <= 0.5 * torch.clamp(n_pairs, min=1.0)
    n_frames = torch.sum(frame_mask, dim=-1)
    bad_frames = torch.sum((chi2_r > REPROJ_REJECT) * frame_mask, dim=-1)
    frames_ok = bad_frames <= 0.5 * torch.clamp(n_frames, min=1.0)

    _, last = _first_last_idx(inputs.track_valid)
    V_last = _take_t(V, last)
    X_last = se3.apply(se3.index(Tcw, last), V_last)
    ray = cameras.unproject(cam, _take_t(inputs.obs, last))
    ray = ray / ray[..., 2:3]
    depth = X_last[..., 2]
    landmark_world = se3.apply(se3.index(Twc, last), ray * depth[..., None])

    ok = (pre_ok & pairs_ok & frames_ok & (n_pairs > 0)
          & torch.isfinite(landmark_world).all(dim=-1))
    return landmark_world, ok
