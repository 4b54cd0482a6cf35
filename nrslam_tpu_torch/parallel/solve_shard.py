"""The pose-only and joint solves of the point-sharded frame, partitioned
over the ranks' contiguous ``P / n`` slot blocks (``sharding.rank_block``).

The counterpart of the JAX package's solves on a ``pt``-sharded state
(nrslam_tpu/parallel/sharding.py: the 6x6 pose normal equations, chi2
totals and CG dot products become sums over the ranks, and the pair edges
read the flows of other ranks' points). Here the collectives are explicit:

- what every rank must hold the same (the pose, the LM scalars lambda, nu,
  rho and ``done``, the CG scalars alpha, beta, r.z and ``done``, the pose
  part of every CG vector) is computed on every rank from all-reduced sums;
- what is per point is computed only by the rank that owns the point; an
  edge's terms by the owners of both its ends (an edge crossing ranks
  twice), each adding them to its own end, as a block of the cluster
  kernel does for its points (``sharding.rank_ends``);
- a gather travels with the partial sums of the same step in one
  ``all_reduce`` (``sharding.block_and_sums``);
- a partial sum is taken per chunk of ``CHUNK`` consecutive global points
  into that chunk's row of a zero-filled ``[chunks, S]`` buffer, and the
  reduced rows are added in chunk order, so where the ranks' blocks are
  whole chunks the sums, and so the results, do not depend on the number
  of ranks (on the card bit for bit: the kernels sum each chunk in a fixed
  order).

Per LM trip the pose-only solve reduces 28 sums a chunk (21 of the upper
6x6, 6 of g, the robust chi2). Per LM step the joint solve makes one
collective to
start its PCG (z, gathered, and the r.z, b.b partials), two per CG trip
(the pose part of H p and p.Hp; then z gathered with the r.z, r.r
partials, from which every rank forms p = z + beta p over all P), the
last trip's second one carrying the trial flows and the gain ratio's
partials instead, and one for the trial linearisation's sums. A call also
gathers the rest positions and point mask once, reduces each round's first
linearisation with the ranks' largest flow-block diagonals (lambda0), and
gathers the final per-point chi2.

Each driver is the plain route on CPU tensors and dispatches to the
hand-written phase kernels on CUDA tensors (``pose_only_cuda.shard``,
``pose_deformation_cuda.shard``), which make the same collectives between
their launches; a kernel that cannot build or launch raises. With no
process group (``Mesh.group is None``) the same code solves the whole
problem in one process.
"""

from __future__ import annotations

import functools

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.parallel import sharding
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.slam import tracking
from nrslam_tpu_torch.solver import core, residuals
from nrslam_tpu_torch.solver import pose_deformation as pd
from nrslam_tpu_torch.solver import pose_only

_TRIU = torch.triu_indices(6, 6)
# Points a chunk of the partial sums covers (csrc/*_shard.cu's kChunk).
CHUNK = 64

# The partitioned solves' share of ``sharding.traffic`` (the collectives'
# count and bytes of ``mesh_solves``: pose-only, joint and window BA) since
# its ``reset``.
traffic = sharding.Traffic()


def _rows(terms, blk: slice, P: int):
    """[ceil(P / CHUNK), S]: the per-point ``terms`` [m, S] of the rank's
    points ``blk`` summed by chunk, zero outside the rank's chunks."""
    nc = -(-P // CHUNK)
    chunk = torch.arange(blk.start, blk.stop, device=terms.device) // CHUNK
    return terms.new_zeros((nc, terms.shape[1])).index_add_(0, chunk, terms)


def _reduce_rows(mesh, terms, blk, P, *extra):
    """One collective: the rank's chunk rows of ``terms`` and the ``extra``
    tensors summed over the ranks; returns (the column sums of the
    reduced rows [S], the reduced extras)."""
    rows = _rows(terms, blk, P)
    flat = torch.cat([rows.reshape(-1), *(x.reshape(-1) for x in extra)])
    sharding.all_reduce_(mesh, flat)
    n = rows.numel()
    return flat[:n].reshape(rows.shape).sum(0), flat[n:]


def _gather_rows(mesh, block, terms, blk, P):
    """One collective: this rank's ``block`` [m, w] gathered to [P, w] with
    the chunk rows of ``terms`` [m, 2]; returns (the whole [P, w], the
    column sums of the reduced rows)."""
    rows = _rows(terms, blk, P)
    whole, s = sharding.block_and_sums(mesh, block, rows, P)
    return whole, s.reshape(rows.shape).sum(0)


def _system_terms(J, w, e, rho):
    """Per point [m, 28]: the 21 upper entries of J^T w J, J^T w e, rho."""
    H = torch.einsum("pri,p,prj->pij", J, w, J)[:, _TRIU[0], _TRIU[1]]
    return torch.cat([H, torch.einsum("pri,p,pr->pi", J, w, e),
                      rho[:, None]], dim=1)


def _unpack(s):
    """(H [6, 6] symmetric, g [6], chi2) from a system's 28 sums."""
    H = torch.zeros((6, 6), dtype=s.dtype, device=s.device)
    H[_TRIU[0], _TRIU[1]] = s[:21]
    H[_TRIU[1], _TRIU[0]] = s[:21]
    return H, s[21:27], s[27]


# ---------------------------------------------------------------------------
# Pose-only
# ---------------------------------------------------------------------------

def _pose_terms(cam, T, X, obs, w_mask):
    """Per-point normal-equation terms [m, 28] (``pose_only._pose_system``
    before its sums) and the chi2 [m]."""
    e, J, _ = residuals.reprojection(cam, T, X, obs)
    chi2 = torch.sum(e * e, dim=-1)
    w = core.huber_weight(chi2, pose_only.TH_2DOF) * w_mask
    return _system_terms(J, w, e, core.huber_rho(chi2, pose_only.TH_2DOF)
                         * w_mask), chi2


def _pose_lm(mesh, cam, T0: se3.SE3, X, obs, w_mask, blk, P,
             n_iters: int):
    """``pose_only._lm_rounds`` with the normal equations summed over the
    ranks (one collective of 28 sums a chunk per evaluation)."""
    def system(T):
        return _unpack(_reduce_rows(
            mesh, _pose_terms(cam, T, X, obs, w_mask)[0], blk, P)[0])

    H, g, chi2_cur = system(T0)
    lam = core.lm_lambda_init(torch.diagonal(H))
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    T = T0
    for _ in range(n_iters):
        dx = core.solve_dense(H, g, lam)
        T_new = se3.retract(T, dx)
        H_new, g_new, chi2_new = system(T_new)
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


def camera_pose_optimization_sharded(mesh: Mesh, cam: cameras.Camera,
                                     T0: se3.SE3, X_blk, obs_blk, valid_blk,
                                     rounds=(10, 10, 10)) -> se3.SE3:
    """``pose_only.camera_pose_optimization`` over the ranks' point blocks:
    this rank's landmarks [m, 3], observations [m, 2] and mask [m]; the
    same pose on every rank. The re-level between rounds is per point, on
    the rank's own points (no collective)."""
    P = X_blk.shape[0] * mesh.world_size
    blk = sharding.rank_block(mesh, P)
    if X_blk.device.type != "cpu":
        from nrslam_tpu_torch.solver import pose_only_cuda
        return pose_only_cuda.shard(
            cam, T0, X_blk, obs_blk, valid_blk, rounds, blk, P,
            functools.partial(sharding.all_reduce_, mesh))
    level = valid_blk
    T = T0
    for n in rounds:
        T = _pose_lm(mesh, cam, T0, X_blk, obs_blk, level.to(torch.float32),
                     blk, P, n)
        chi2 = _pose_terms(cam, T, X_blk, obs_blk,
                           valid_blk.to(torch.float32))[1]
        level = valid_blk & (chi2 <= pose_only.TH_2DOF)
    return T


# ---------------------------------------------------------------------------
# Joint pose + deformation
# ---------------------------------------------------------------------------

class _Ends:
    """This rank's edge-ends (``sharding.rank_ends``) and their edges'
    constants: local point ``lp``, sign ``s`` (+1 at the edge's i), both
    endpoints, RBF weight, rest distance, base mask and rest difference."""

    def __init__(self, mesh, pairs, base, rest, P):
        ptr, edge, sign = sharding.rank_ends(mesh, pairs.i, pairs.j, base, P)
        k0, k1 = int(ptr[0]), int(ptr[-1])
        e = edge[k0:k1].to(torch.int64)
        self.s = sign[k0:k1]
        self.lp = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=rest.device),
            (ptr[1:] - ptr[:-1]).to(torch.int64))
        self.i, self.j = pairs.i[e], pairs.j[e]
        self.w, self.d0 = pairs.w[e], pairs.d0[e]
        self.base = base[e].to(torch.float32)
        self.drest = rest[self.i] - rest[self.j]
        self.iend = self.s > 0


class _Lin:
    """A linearisation of the rank's block: the reduced pose system (H, g,
    chi2) and the block's per-point and per-end terms."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def where(self, cond, other):
        return _Lin(**{k: torch.where(cond, v, other.__dict__[k])
                       for k, v in self.__dict__.items()})


def _scatter(vals, lp, m):
    out = torch.zeros((m,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, lp, vals)


def _linearize(cam, T, rest_blk, obs_blk, flows, blk, ends, masks, infos):
    """The block's terms at (T, flows [P, 3]): ``pose_deformation._system``
    on the rank's points and edge-ends, with the pose system per point
    (each edge's robust chi2 counted at the point of its i end); the
    reduced system (H, g, chi2) is set by the caller."""
    point_mask, spatial_mask, spring_mask = masks
    info_r, info_s, info_p = infos
    m = rest_blk.shape[0]
    e_r, J_pose, J_flow = residuals.reprojection(cam, T, rest_blk + flows[blk],
                                                 obs_blk)
    chi2_r = info_r * torch.sum(e_r * e_r, dim=-1)

    dflow = flows[ends.i] - flows[ends.j]
    e_s = ends.w[:, None] * dflow
    chi2_s = info_s * torch.sum(e_s * e_s, dim=-1)
    diff = ends.drest + dflow
    dist = torch.linalg.norm(diff, dim=-1)
    safe_d0 = torch.clamp(ends.d0, min=1e-12)
    e_p = pd.SPRING_K * (dist - ends.d0) / safe_d0
    chi2_p = info_p * e_p * e_p

    w_r = info_r * core.huber_weight(chi2_r, pd.TH_2DOF) * point_mask
    w_s = info_s * core.huber_weight(chi2_s, pd.TH_3DOF) * spatial_mask
    w_p = info_p * core.huber_weight(chi2_p, pd.TH_3DOF) * spring_mask
    rho_e = (core.huber_rho(chi2_s, pd.TH_3DOF) * spatial_mask
             + core.huber_rho(chi2_p, pd.TH_3DOF) * spring_mask)
    rho = (core.huber_rho(chi2_r, pd.TH_2DOF) * point_mask
           + _scatter(torch.where(ends.iend, rho_e, torch.zeros_like(rho_e)),
                      ends.lp, m))

    ws = ends.w * ends.w * w_s
    a = (pd.SPRING_K / safe_d0)[:, None] * diff \
        / torch.clamp(dist, min=1e-12)[:, None]
    gs = (w_s * ends.w)[:, None] * e_s + (w_p * e_p)[:, None] * a
    g_flow = torch.einsum("prk,p,pr->pk", J_flow, w_r, e_r) \
        + _scatter(ends.s[:, None] * gs, ends.lp, m)
    eye3 = torch.eye(3, dtype=rest_blk.dtype, device=rest_blk.device)
    D = (torch.einsum("prk,p,prl->pkl", J_flow, w_r, J_flow)
         + _scatter(ws, ends.lp, m)[:, None, None] * eye3
         + _scatter(w_p[:, None, None] * a[:, :, None] * a[:, None, :],
                    ends.lp, m))
    return _Lin(terms=_system_terms(J_pose, w_r, e_r, rho), g_flow=g_flow,
                D=D, J_pose=J_pose, J_flow=J_flow, w_r=w_r, ws=ws, w_p=w_p,
                a=a, chi2_r=chi2_r, chi2_s=chi2_s)


def _pcg(mesh, lin, lam, ends, blk, P, iters: int, tol: float = 1e-8):
    """``core.pcg`` with ``pose_deformation._make_hvp`` and the block-Jacobi
    preconditioner over the ranks' blocks; returns (x pose [6], x of the
    rank's flows [m, 3]). The last trip's z is not gathered: the trial
    step's collective follows it instead."""
    m = lin.w_r.shape[0]
    eye6 = torch.eye(6, dtype=lam.dtype, device=lam.device)
    eye3 = torch.eye(3, dtype=lam.dtype, device=lam.device)
    Hp_inv = core.inv_small(lin.H + lam * eye6)
    Df_inv = core.inv3x3(lin.D + lam * eye3)
    r_p, r_f = -lin.g, -lin.g_flow
    x_p, x_f = torch.zeros_like(r_p), torch.zeros_like(r_f)
    z_p = Hp_inv @ r_p
    z_f = torch.einsum("pkl,pl->pk", Df_inv, r_f)
    p_full, s = _gather_rows(mesh, z_f, torch.stack(
        [torch.sum(r_f * z_f, -1), torch.sum(r_f * r_f, -1)], 1), blk, P)
    rz = torch.dot(r_p, z_p) + s[0]
    b2 = torch.dot(r_p, r_p) + s[1]
    p_p = z_p
    done = torch.zeros((), dtype=torch.bool, device=lam.device)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    for t in range(iters):
        p_f = p_full[blk]
        r_lin = (torch.einsum("pri,i->pr", lin.J_pose, p_p)
                 + torch.einsum("prk,pk->pr", lin.J_flow, p_f))
        dv = p_full[ends.i] - p_full[ends.j]
        ev = (lin.ws[:, None] * dv
              + (lin.w_p * torch.sum(lin.a * dv, dim=-1))[:, None] * lin.a)
        hp_f = (torch.einsum("prk,p,pr->pk", lin.J_flow, lin.w_r, r_lin)
                + _scatter(ends.s[:, None] * ev, ends.lp, m) + lam * p_f)
        red = _reduce_rows(mesh, torch.cat([
            torch.einsum("pri,p,pr->pi", lin.J_pose, lin.w_r, r_lin),
            torch.sum(p_f * hp_f, -1, keepdim=True)], 1), blk, P)[0]
        hp_p = red[:6] + lam * p_p
        denom = torch.dot(p_p, hp_p) + red[6]
        alpha = torch.where(torch.abs(denom) > 0, rz / denom, zero)
        alpha = torch.where(done, zero, alpha)
        x_p = x_p + alpha * p_p
        x_f = x_f + alpha * p_f
        r_p = r_p - alpha * hp_p
        r_f = r_f - alpha * hp_f
        z_p = Hp_inv @ r_p
        z_f = torch.einsum("pkl,pl->pk", Df_inv, r_f)
        if t == iters - 1:
            break
        z_full, s = _gather_rows(mesh, z_f, torch.stack(
            [torch.sum(r_f * z_f, -1), torch.sum(r_f * r_f, -1)], 1), blk, P)
        rz_new = torch.dot(r_p, z_p) + s[0]
        rr = torch.dot(r_p, r_p) + s[1]
        beta = torch.where(torch.abs(rz) > 0, rz_new / rz, zero)
        p_full = z_full + beta * p_full
        p_p = z_p + beta * p_p
        done = done | (rr <= tol * tol * b2)
        rz = torch.where(done, rz, rz_new)
    return x_p, x_f


def _joint_lm(mesh, cam, T0, rest_blk, obs_blk, blk, ends, masks, infos, P,
              n_iters: int, cg_iters: int):
    """``pose_deformation._lm_optimize`` over the ranks' blocks; returns
    (T, flows [P, 3], the same on every rank)."""
    flows = torch.zeros((P, 3), dtype=rest_blk.dtype, device=rest_blk.device)

    def linearize(T, f):
        return _linearize(cam, T, rest_blk, obs_blk, f, blk, ends, masks,
                          infos)

    lin = linearize(T0, flows)
    # lambda0 from the largest diagonal: each rank's flow-block maximum at
    # its slot of a zero-filled [n] row, summed with the pose system.
    dmax = rest_blk.new_zeros(mesh.world_size)
    dmax[mesh.rank] = torch.amax(torch.diagonal(lin.D, dim1=-2, dim2=-1))
    s, dmax = _reduce_rows(mesh, lin.terms, blk, P, dmax)
    lin.H, lin.g, lin.chi2 = _unpack(s)
    lam = core.lm_lambda_init(torch.cat([torch.diagonal(lin.H), dmax]))
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros((), dtype=torch.bool, device=rest_blk.device)
    T = T0
    for _ in range(n_iters):
        x_p, x_f = _pcg(mesh, lin, lam, ends, blk, P, cg_iters)
        T_new = se3.retract(T, x_p)
        flows_new, s = _gather_rows(
            mesh, flows[blk] + x_f,
            torch.stack([torch.sum(x_f * (lam * x_f - lin.g_flow), -1),
                         torch.sum(x_f * x_f, -1)], 1), blk, P)
        lin_new = linearize(T_new, flows_new)
        lin_new.H, lin_new.g, lin_new.chi2 = _unpack(_reduce_rows(
            mesh, lin_new.terms, blk, P)[0])
        denom = torch.dot(x_p, lam * x_p - lin.g) + s[0]
        dx2 = torch.dot(x_p, x_p) + s[1]
        rho = (lin.chi2 - lin_new.chi2) / torch.where(
            torch.abs(denom) > 0, denom, torch.ones_like(denom))
        lam_new, nu_new, accepted = core.lm_lambda_update(lam, nu, rho)
        run = ~done
        acc = accepted & run
        T = se3.SE3(torch.where(acc, T_new.q, T.q),
                    torch.where(acc, T_new.t, T.t))
        flows = torch.where(acc, flows_new, flows)
        lin = lin_new.where(acc, lin)
        lam = torch.where(run, lam_new, lam)
        nu = torch.where(run, nu_new, nu)
        done = done | (acc & (dx2 < 1e-12))
    return T, flows


def _joint_plain(mesh, cam, T0, rest, rest_blk, obs_blk, point_valid, pairs,
                 base, scale, rounds, cg_iters):
    """``pose_deformation.pose_deformation_plain`` over the ranks' blocks.
    Returns (T, flows [P, 3], chi2_r [P]), the same on every rank."""
    P = rest.shape[0]
    blk = sharding.rank_block(mesh, P)
    infos = pd.infos_for(scale)
    ends = _Ends(mesh, pairs, base, rest, P)
    pmask = point_valid[blk].to(torch.float32)
    full = (pmask, ends.base, ends.base)
    point_mask, spatial_mask = pmask, ends.base
    T = T0
    flows = torch.zeros((P, 3), dtype=rest.dtype, device=rest.device)
    for n in rounds:
        T, flows = _joint_lm(mesh, cam, T0, rest_blk, obs_blk, blk, ends,
                             (point_mask, spatial_mask, ends.base), infos, P,
                             n, cg_iters)
        lin = _linearize(cam, T, rest_blk, obs_blk, flows, blk, ends, full,
                         infos)
        point_mask = pmask * (lin.chi2_r <= pd.TH_2DOF).to(torch.float32)
        spatial_mask = ends.base * (lin.chi2_s <= pd.TH_3DOF).to(
            torch.float32)
    lin = _linearize(cam, T, rest_blk, obs_blk, flows, blk, ends, full, infos)
    chi2_r, _ = sharding.block_and_sums(mesh, lin.chi2_r[:, None],
                                        lin.chi2_r.new_zeros(0), P)
    return T, flows, chi2_r[:, 0]


def pose_deformation_sharded(mesh: Mesh, cam: cameras.Camera, T0: se3.SE3,
                             rest_blk, obs_blk, valid_blk,
                             pairs: pd.PairEdges, scale, rounds=(10, 10),
                             cg_iters: int = 10) -> pd.PoseDeformationResult:
    """``pose_deformation.pose_deformation_optimization`` over the ranks'
    point blocks: this rank's rest positions [m, 3], observations [m, 2]
    and mask [m]; ``pairs`` the whole edge table (global indices, the
    same on every rank). One gather gives every rank the rest positions
    and mask its edges and the post-gates read; the edge table is
    compacted as in one process. Returns the result with the whole flows
    [P, 3] and gates [P], the same on every rank."""
    m = rest_blk.shape[0]
    P = m * mesh.world_size
    whole, _ = sharding.block_and_sums(
        mesh, torch.cat([rest_blk, valid_blk.to(rest_blk.dtype)[:, None]],
                        dim=1), rest_blk.new_zeros(0), P)
    rest, point_valid = whole[:, :3], whole[:, 3] > 0
    pairs = pd.compact_pairs(pairs, P, point_valid)
    pairs = pairs._replace(i=pairs.i.to(torch.int64),
                           j=pairs.j.to(torch.int64))
    base = pairs.valid & point_valid[pairs.i] & point_valid[pairs.j]
    if rest_blk.device.type == "cpu":
        T, flows, chi2_r = _joint_plain(mesh, cam, T0, rest, rest_blk,
                                        obs_blk, point_valid, pairs, base,
                                        scale, rounds, cg_iters)
    else:
        from nrslam_tpu_torch.solver import pose_deformation_cuda
        T, flows, chi2_r = pose_deformation_cuda.shard(
            cam, T0, rest, obs_blk, point_valid, pairs, base, scale, rounds,
            cg_iters, sharding.rank_block(mesh, P), mesh.rank,
            mesh.world_size, functools.partial(sharding.all_reduce_, mesh))
    reproj_inlier, deform_ok, median_def = pd._post_gates(flows, chi2_r,
                                                          point_valid)
    return pd.PoseDeformationResult(T, flows, reproj_inlier, deform_ok,
                                    median_def)


# ---------------------------------------------------------------------------
# The frame's solves
# ---------------------------------------------------------------------------

def mesh_solves(mesh: Mesh) -> tracking.Solves:
    """``tracking.Solves`` of the sharded frame: the pose-only and joint
    solves take the rank's block (``sharding.local_block``) of the whole
    [P] arrays the frame gathered, the window BA the whole window with the
    keyframe ring's columns of the observations (``ba_points``); each runs
    partitioned over the ranks."""
    from nrslam_tpu_torch.parallel import ba_points

    def block(x):
        return sharding.local_block(mesh, x, 0)

    def counted(fn):
        def run(*args, **kw):
            count, nbytes = sharding.traffic.count, sharding.traffic.bytes
            out = fn(*args, **kw)
            traffic.count += sharding.traffic.count - count
            traffic.bytes += sharding.traffic.bytes - nbytes
            return out
        return run

    @counted
    def pose(cam, T0, X, obs, valid):
        return camera_pose_optimization_sharded(mesh, cam, T0, block(X),
                                                block(obs), block(valid))

    @counted
    def joint(cam, T0, rest, obs, valid, pairs, scale):
        return pose_deformation_sharded(mesh, cam, T0, block(rest),
                                        block(obs), block(valid), pairs,
                                        scale)

    return tracking.Solves(pose, joint, counted(ba_points.mesh_ba(mesh)))
