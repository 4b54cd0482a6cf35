"""The keyframe window BA of the point-sharded frame, partitioned over the
ranks' contiguous ``P / n`` slot blocks (``sharding.rank_block``).

The counterpart of the JAX package's BA on a window whose per-keyframe
landmark copies and observations ``[W, P, ...]`` sit on the ``pt`` mesh
axis (nrslam_tpu/parallel/sharding.py places the keyframe ring so, and XLA
partitions ``bundle_adjustment.local_deformable_ba`` over the points).
Here the collectives are explicit, in ``solve_shard``'s design:

- a rank owns all W copies of its points and their edge-ends
  (``sharding.rank_ends`` over the edges some keyframe's spring uses); the
  4-ary dampers couple copies (k, p) and (k + 1, p), so they stay on the
  rank, as they stay on a block of the cluster kernel
  (csrc/bundle_adjustment.cu);
- every rank holds the same W pose twists, pose 6x6 blocks and gradient,
  chi2, LM scalars (lambda, nu, the gain ratio) and CG scalars, computed
  from all-reduced partial sums taken per chunk of ``solve_shard.CHUNK``
  global points and added in chunk order, so n ranks give the bits of one
  where the ranks' blocks are whole chunks;
- the landmark 3x3 blocks, the reprojection terms of the rank's copies and
  the spring and damper terms at its edge-ends (in the edge's (i, j)
  orientation; an edge's chi2 counted at its i end) stay on the rank;
- the landmark copies, the search direction and the trial copies travel
  whole, ``[W, P, 3]`` (one ``all_reduce`` each, ``sharding.block_and_sums``
  with the step's partial sums), as the joint solve's z does.

Collectives of one call: the first linearisation's sums (with each rank's
largest landmark-block diagonal, for lambda0), then per LM step one to
start the PCG (z and the r.z, r.r partials), two per CG trip (the pose part
of H p and p.Hp; then z with its partials, or after the last trip the trial
copies with the gain ratio's landmark partial) and one for the trial
linearisation's sums: 1 + n_iters (2 + 2 cg_iters).

The plain route here runs on CPU tensors; CUDA tensors go to the phase
kernels of csrc/bundle_adjustment_shard.cu (``bundle_adjustment_cuda
.shard``), which make the same collectives between their launches. Masked
terms are skipped (selected out), never multiplied by zero, and unobserved
copies are returned unchanged, as both single-process routes do.
"""

from __future__ import annotations

import functools

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import sharding
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.parallel.solve_shard import (_TRIU, _gather_rows,
                                                   _reduce_rows)
from nrslam_tpu_torch.solver import core, residuals
from nrslam_tpu_torch.solver.bundle_adjustment import (
    INFO_POSITION, INFO_REPROJECTION, SPRING_K, TH_2DOF, TH_3DOF, BAProblem,
    _masks)
from nrslam_tpu_torch.utils.tree import tree_map


class _Ends:
    """This rank's edge-ends over the edges some spring uses: local point
    ``lp``, sign ``s`` (+1 at the edge's i), both endpoints, RBF weight,
    clamped rest distance, the spring mask [W, ends] and the damper mask
    [W - 1, ends]."""

    def __init__(self, mesh, pairs, spring, damper, P):
        live = torch.any(spring, dim=0)
        ptr, edge, sign = sharding.rank_ends(mesh, pairs.i, pairs.j, live, P)
        k0, k1 = int(ptr[0]), int(ptr[-1])
        e = edge[k0:k1].to(torch.int64)
        self.s = sign[k0:k1]
        self.lp = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=spring.device),
            (ptr[1:] - ptr[:-1]).to(torch.int64))
        self.i, self.j = pairs.i[e], pairs.j[e]
        self.w = pairs.w[e]
        self.d0 = torch.clamp(pairs.d0[e], min=1e-12)
        self.spring, self.damper = spring[:, e], damper[:, e]
        self.iend = self.s > 0


def _scatter(vals, lp, m):
    """[W, ends, ...] -> [W, m, ...]: each end's value added at its local
    point."""
    out = vals.new_zeros((vals.shape[0], m) + vals.shape[2:])
    return out.index_add_(1, lp, vals)


def _ends_sum(spring_term, sv):
    """Each copy's edge-end term from the spring term at its keyframe and
    the damper terms sv [W - 1] to keyframes k + 1 (-) and k - 1 (+)."""
    zero = torch.zeros_like(sv[:1])
    return spring_term - torch.cat([sv, zero]) + torch.cat([zero, sv])


class _Lin:
    """A linearisation of the rank's copies: per point the pose-system
    terms [m, 28 W + 1], per copy the landmark gradient, 3x3 blocks,
    Jacobians and IRLS weights, per end the spring direction and weights;
    the reduced system (H [W, 6, 6], g [W, 6], chi2) is set by the
    caller."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def where(self, cond, other):
        return _Lin(**{k: torch.where(cond, v, other.__dict__[k])
                       for k, v in self.__dict__.items()})


def _linearize(cam, poses: se3.SE3, L, obs, ok, blk, ends: _Ends, info_s):
    """The block's terms at (poses [W], copies L [W, P, 3]):
    ``bundle_adjustment._system`` on the rank's copies [W, m] (``obs``,
    ``ok`` their observations and mask) and edge-ends."""
    W, m = obs.shape[0], obs.shape[1]
    e_r, J_pose, J_land = residuals.reprojection(
        cam, tree_map(lambda x: x[:, None], poses), L[:, blk], obs)
    live = ok[..., None]
    e_r = torch.where(live, e_r, torch.zeros_like(e_r))
    J_pose = torch.where(live[..., None], J_pose, torch.zeros_like(J_pose))
    J_land = torch.where(live[..., None], J_land, torch.zeros_like(J_land))
    chi2_r = INFO_REPROJECTION * torch.sum(e_r * e_r, dim=-1)
    zero = torch.zeros_like(chi2_r)
    w_r = torch.where(ok, INFO_REPROJECTION * core.huber_weight(chi2_r,
                                                                TH_2DOF), zero)
    rho_r = torch.where(ok, core.huber_rho(chi2_r, TH_2DOF), zero)

    dl = L[:, ends.i] - L[:, ends.j]                           # [W, ends, 3]
    dist = torch.linalg.norm(dl, dim=-1)
    e_p = SPRING_K * (dist - ends.d0) / ends.d0
    w_p = torch.where(ends.spring, torch.full_like(dist, INFO_POSITION),
                      torch.zeros_like(dist))
    a = torch.where(ends.spring[..., None], (SPRING_K / ends.d0)[:, None]
                    * dl / torch.clamp(dist, min=1e-12)[..., None],
                    torch.zeros_like(dl))
    dd = dl[1:] - dl[:-1]                                   # [W - 1, ends, 3]
    chi2_d = info_s * ends.w * ends.w * torch.sum(dd * dd, dim=-1)
    wd2 = torch.where(ends.damper, info_s * core.huber_weight(
        chi2_d, TH_3DOF) * ends.w * ends.w, torch.zeros_like(chi2_d))
    s = ends.s[:, None]

    chi2_e = (torch.sum(torch.where(ends.spring, INFO_POSITION * e_p * e_p,
                                    torch.zeros_like(e_p)), dim=0)
              + torch.sum(torch.where(ends.damper, core.huber_rho(
                  chi2_d, TH_3DOF), torch.zeros_like(chi2_d)), dim=0))
    chi2_pt = torch.zeros(m, dtype=L.dtype, device=L.device).index_add_(
        0, ends.lp, torch.where(ends.iend, chi2_e, torch.zeros_like(chi2_e)))

    g_pose = torch.einsum("kpri,kp,kpr->kpi", J_pose, w_r, e_r)
    g_land = (torch.einsum("kprl,kp,kpr->kpl", J_land, w_r, e_r)
              + _scatter(s * _ends_sum((w_p * e_p)[..., None] * a,
                                       wd2[..., None] * dd), ends.lp, m))
    eye3 = torch.eye(3, dtype=L.dtype, device=L.device)
    zero1 = torch.zeros_like(wd2[:1])
    wd2_k = torch.cat([wd2, zero1]) + torch.cat([zero1, wd2])
    D = (torch.einsum("kprl,kp,kprm->kplm", J_land, w_r, J_land)
         + _scatter((w_p[..., None, None] * a[..., :, None] * a[..., None, :]
                     + wd2_k[..., None, None] * eye3), ends.lp, m))
    H = torch.einsum("kpri,kp,kprj->kpij", J_pose, w_r, J_pose)[
        ..., _TRIU[0], _TRIU[1]]
    terms = torch.cat([torch.cat([H, g_pose, rho_r[..., None]], dim=-1)
                       .permute(1, 0, 2).reshape(m, 28 * W),
                       chi2_pt[:, None]], dim=1)
    return _Lin(terms=terms, g_land=g_land, D=D, J_pose=J_pose,
                J_land=J_land, w_r=w_r, w_p=w_p, a=a, wd2=wd2)


def _unpack(s, W: int):
    """(H [W, 6, 6] symmetric, g [W, 6], chi2) from a system's sums."""
    per = s[:28 * W].reshape(W, 28)
    H = s.new_zeros((W, 6, 6))
    H[:, _TRIU[0], _TRIU[1]] = per[:, :21]
    H[:, _TRIU[1], _TRIU[0]] = per[:, :21]
    return H, per[:, 21:27], s[28 * W] + torch.sum(per[:, 27])


def _hv_land(lin, ends, p_full, p_pose, lam, blk, m):
    """H p of the rank's copies (+ lambda p) and the pose part's terms per
    point [m, 6 W + 1] (J_pose^T w_r r per keyframe, then p.Hp)."""
    W = p_pose.shape[0]
    p_l = p_full[:, blk]
    r_lin = (torch.einsum("kpri,ki->kpr", lin.J_pose, p_pose)
             + torch.einsum("kprl,kpl->kpr", lin.J_land, p_l))
    dv = p_full[:, ends.i] - p_full[:, ends.j]
    spring = (lin.w_p * torch.sum(lin.a * dv, dim=-1))[..., None] * lin.a
    sv = lin.wd2[..., None] * (dv[1:] - dv[:-1])
    hp = (torch.einsum("kprl,kp,kpr->kpl", lin.J_land, lin.w_r, r_lin)
          + _scatter(ends.s[:, None] * _ends_sum(spring, sv), ends.lp, m)
          + lam * p_l)
    pose = torch.einsum("kpri,kp,kpr->kpi", lin.J_pose, lin.w_r, r_lin)
    return hp, torch.cat([pose.permute(1, 0, 2).reshape(m, 6 * W),
                          torch.sum(p_l * hp, dim=(0, 2))[:, None]], dim=1)


def _whole(mesh, x, blk, P, terms):
    """One collective: the rank's copies x [W, m, 3] gathered to [W, P, 3]
    with the chunk rows of ``terms``; returns (the whole copies, the
    column sums of the reduced rows)."""
    W, m = x.shape[0], x.shape[1]
    whole, s = _gather_rows(mesh, x.permute(1, 0, 2).reshape(m, 3 * W),
                            terms, blk, P)
    return whole.reshape(P, W, 3).permute(1, 0, 2), s


def _pcg(mesh, lin, lam, ends, blk, P, iters: int, tol: float = 1e-8):
    """``core.pcg`` with ``bundle_adjustment._system``'s Hessian-vector
    product and its block-Jacobi preconditioner over the ranks' blocks;
    returns (x of the poses [W, 6], x of the rank's copies [W, m, 3]). The
    last trip's z is not gathered: the trial step's collective follows."""
    W, m = lin.w_r.shape
    eye6 = torch.eye(6, dtype=lam.dtype, device=lam.device)
    eye3 = torch.eye(3, dtype=lam.dtype, device=lam.device)
    Hp_inv = core.inv_small(lin.H + lam * eye6)
    D_inv = core.inv3x3(lin.D + lam * eye3)

    def precondition(r_p, r_l):
        return (torch.einsum("kij,kj->ki", Hp_inv, r_p),
                torch.einsum("kplm,kpm->kpl", D_inv, r_l))

    def partials(r_l, z_l):
        return torch.stack([torch.sum(r_l * z_l, dim=(0, 2)),
                            torch.sum(r_l * r_l, dim=(0, 2))], 1)

    r_p, r_l = -lin.g, -lin.g_land
    x_p, x_l = torch.zeros_like(r_p), torch.zeros_like(r_l)
    z_p, z_l = precondition(r_p, r_l)
    p_full, s = _whole(mesh, z_l, blk, P, partials(r_l, z_l))
    rz = torch.sum(r_p * z_p) + s[0]
    b2 = torch.sum(r_p * r_p) + s[1]
    p_p = z_p
    done = torch.zeros((), dtype=torch.bool, device=lam.device)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    for t in range(iters):
        hp_l, terms = _hv_land(lin, ends, p_full, p_p, lam, blk, m)
        red = _reduce_rows(mesh, terms, blk, P)[0]
        hp_p = red[:6 * W].reshape(W, 6) + lam * p_p
        denom = torch.sum(p_p * hp_p) + red[6 * W]
        alpha = torch.where(torch.abs(denom) > 0, rz / denom, zero)
        alpha = torch.where(done, zero, alpha)
        x_p = x_p + alpha * p_p
        x_l = x_l + alpha * p_full[:, blk]
        r_p = r_p - alpha * hp_p
        r_l = r_l - alpha * hp_l
        z_p, z_l = precondition(r_p, r_l)
        if t == iters - 1:
            break
        z_full, s = _whole(mesh, z_l, blk, P, partials(r_l, z_l))
        rz_new = torch.sum(r_p * z_p) + s[0]
        rr = torch.sum(r_p * r_p) + s[1]
        beta = torch.where(torch.abs(rz) > 0, rz_new / rz, zero)
        p_full = z_full + beta * p_full
        p_p = z_p + beta * p_p
        done = done | (rr <= tol * tol * b2)
        rz = torch.where(done, rz, rz_new)
    return x_p, x_l


def _ba_plain(mesh, cam, poses0, L0, obs, obs_ok, ends, info_s, blk,
              n_iters: int, cg_iters: int):
    """``bundle_adjustment.local_deformable_ba_plain`` over the ranks'
    blocks. Returns (poses [W], copies [W, P, 3]), the same on every
    rank."""
    W, P, _ = L0.shape
    ok = obs_ok[:, blk]

    def linearize(poses, L):
        return _linearize(cam, poses, L, obs, ok, blk, ends, info_s)

    lin = linearize(poses0, L0)
    # lambda0 from the largest diagonal: each rank's landmark-block maximum
    # at its slot of a zero-filled [n] row, summed with the pose system.
    dmax = L0.new_zeros(mesh.world_size)
    dmax[mesh.rank] = torch.amax(torch.diagonal(lin.D, dim1=-2, dim2=-1))
    s, dmax = _reduce_rows(mesh, lin.terms, blk, P, dmax)
    lin.H, lin.g, lin.chi2 = _unpack(s, W)
    lam = core.lm_lambda_init(torch.cat([
        torch.diagonal(lin.H, dim1=-2, dim2=-1).reshape(-1), dmax]))
    nu = torch.full_like(lam, 2.0)
    poses, L = poses0, L0
    for _ in range(n_iters):
        x_p, x_l = _pcg(mesh, lin, lam, ends, blk, P, cg_iters)
        poses_new = se3.retract(poses, x_p)
        L_new, s = _whole(mesh, L[:, blk] + x_l, blk, P, torch.sum(
            x_l * (lam * x_l - lin.g_land), dim=(0, 2))[:, None])
        lin_new = linearize(poses_new, L_new)
        lin_new.H, lin_new.g, lin_new.chi2 = _unpack(_reduce_rows(
            mesh, lin_new.terms, blk, P)[0], W)
        denom = torch.sum(x_p * (lam * x_p - lin.g)) + s[0]
        rho = (lin.chi2 - lin_new.chi2) / torch.where(
            torch.abs(denom) > 0, denom, torch.ones_like(denom))
        lam, nu, acc = core.lm_lambda_update(lam, nu, rho)
        poses = se3.SE3(torch.where(acc, poses_new.q, poses.q),
                        torch.where(acc, poses_new.t, poses.t))
        L = torch.where(acc, L_new, L)
        lin = lin_new.where(acc, lin)
    return poses, L


def local_deformable_ba_sharded(mesh: Mesh, cam: cameras.Camera,
                                poses0: se3.SE3, L0, problem: BAProblem,
                                n_iters: int = 5, cg_iters: int = 32):
    """``bundle_adjustment.local_deformable_ba`` over the ranks' point
    blocks: poses0 [W] and the copies L0 [W, P, 3] whole (the same on every
    rank), ``problem.obs`` [W, m, 2] the rank's block of the observations,
    ``problem.obs_valid`` [W, P] whole, the pair table whole (global
    indices). Returns (poses [W], copies [W, P, 3]), the same on every
    rank; unobserved copies are L0's."""
    W, P, _ = L0.shape
    blk = sharding.rank_block(mesh, P)
    if problem.obs.shape != (W, blk.stop - blk.start, 2) \
            or problem.obs_valid.shape != (W, P):
        raise ValueError("ba_points: expected obs [W, P/n, 2] and obs_valid "
                         "[W, P]")
    pairs = problem.pairs
    problem = problem._replace(pairs=pairs._replace(
        i=pairs.i.to(torch.int64), j=pairs.j.to(torch.int64)))
    obs_ok, spring, damper = _masks(problem)
    sigma_s = 0.1 * torch.as_tensor(problem.scale, dtype=L0.dtype,
                                    device=L0.device)
    info_s = 1.0 / (sigma_s * sigma_s)
    if L0.device.type == "cpu":
        ends = _Ends(mesh, problem.pairs, spring, damper, P)
        poses, L = _ba_plain(mesh, cam, poses0, L0, problem.obs, obs_ok,
                             ends, info_s, blk, n_iters, cg_iters)
    else:
        from nrslam_tpu_torch.solver import bundle_adjustment_cuda
        poses, L = bundle_adjustment_cuda.shard(
            cam, poses0, L0, problem.obs, obs_ok, problem.pairs, spring,
            damper, info_s, n_iters, cg_iters, blk, mesh.rank,
            mesh.world_size, functools.partial(sharding.all_reduce_, mesh))
    return poses, torch.where(obs_ok[..., None], L, L0)


def mesh_ba(mesh: Mesh):
    """The window BA hook of the sharded frame (``tracking.Solves.ba``):
    ``local_deformable_ba_sharded`` on this mesh."""
    def ba(cam, poses0, L0, problem, n_iters: int = 5, cg_iters: int = 32):
        return local_deformable_ba_sharded(mesh, cam, poses0, L0, problem,
                                           n_iters, cg_iters)
    return ba
