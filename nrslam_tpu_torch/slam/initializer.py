"""Monocular map initialisation: KLT track accumulation + batched
essential-matrix RANSAC on bearing rays + midpoint triangulation gates
(counterpart of nrslam_tpu/slam/initializer.py; reference
MonocularMapInitializer + EssentialMatrixInitialization).

Same math, constants and deviations as the JAX package: stratified sampling
(one member of each of 8 Lloyd's-kmeans clusters per hypothesis), a static
batch of hypotheses scored at once, a least-squares refit of E on the best
inlier set, and a three-step two-view refinement on the success frame only.

Random draws are explicit inputs: ``_kmeans`` takes its permutation
``perm [N]`` and ``find_essential_ransac`` its Gumbel noise
``gumbel [H, N]``, so any device (and the JAX package's own draws) can feed
the same samples. The JAX package's ``lax.cond`` branches (reset on too few
matches, refinement on success) are host branches here, read once per init
frame; init frames may synchronise, steady frames never run this module.

The small decompositions (the 8x9 and 3x3 SVDs, the refit's 9x9 ``eigh``)
run on the host's LAPACK whatever the device: the refit's normal matrix
spans ~1e7 in eigenvalue, and cuSOLVER's float32 ``eigh`` on an H100
returned a smallest eigenvalue of -2.8e-7 where LAPACK gives 1.28e-5 for
the same matrix, enough to turn the refit E into one that loses inliers.
So do the determinants that orient the candidate rotations. An attempt's
device work falls into four pieces between three host round trips (see
"Essential matrix machinery"), which ``init_graph.InitGraphs`` captures
one graph each on the card; the eager functions here run the same pieces
in the same order on any device.

While a tracer is on (``utils.profiler.tracing``), the stages are spans
(``nrslam.init.reset``, ``klt``, ``kmeans``, ``ransac``, ``reconstruct``,
``refine``), and so are the host's LAPACK calls (``nrslam.init.lapack``)
and every wait of the host on the device (``nrslam.init.sync``: the copies
to the host and the flags read), so that an init frame's wall splits into
issue, sync and LAPACK.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nrslam_tpu_torch.geometry import cameras, se3, triangulation
from nrslam_tpu_torch.ops import klt, shi_tomasi
from nrslam_tpu_torch.utils import profiler


class InitializerConfig(NamedTuple):
    max_features: int = 1024
    min_matches: int = 100
    max_frames_from_ref: int = 30
    min_triangulated: int = 100
    max_low_parallax_frac: float = 0.25
    n_hypotheses: int = 64
    epipolar_threshold: float = 0.005
    rad_per_pixel: float = 0.002
    nms_radius: int = 7
    klt_min_ssim: float = 0.5
    kmeans_clusters: int = 8
    kmeans_iters: int = 10


class InitializerState(NamedTuple):
    ref_keypoints: torch.Tensor   # [F, 2]
    cur_keypoints: torch.Tensor   # [F, 2]
    track_id: torch.Tensor        # [F] int32
    status: torch.Tensor          # [F] int32 (TRACKED while alive)
    valid: torch.Tensor           # [F] slot holds a feature
    refs: klt.KLTRefs
    frames_from_ref: torch.Tensor  # int32
    next_track_id: torch.Tensor    # int32


class InitializationResult(NamedTuple):
    success: torch.Tensor          # bool
    Tcw: se3.SE3                   # current camera from world (ref camera)
    ref_keypoints: torch.Tensor    # [F, 2]
    cur_keypoints: torch.Tensor    # [F, 2]
    landmarks: torch.Tensor        # [F, 3] world (= reference-camera) frame
    point_ok: torch.Tensor         # [F]
    track_id: torch.Tensor         # [F]


def reset(pyramid, mask, next_track_id, klt_config: klt.KLTConfig,
          config: InitializerConfig) -> InitializerState:
    """Fresh features + KLT reference (ResetInitialization,
    monocular_map_initializer.cc:81-98)."""
    with profiler.span("nrslam.init.reset"):
        return _reset(pyramid, mask, next_track_id, klt_config, config)


def _reset(pyramid, mask, next_track_id, klt_config: klt.KLTConfig,
           config: InitializerConfig) -> InitializerState:
    img = pyramid[0][0]
    xy, valid, _ = shi_tomasi.detect(img, config.max_features,
                                     nms_radius=config.nms_radius, mask=mask)
    refs = klt.set_reference(pyramid, xy, valid, klt_config)
    F_ = config.max_features
    next_track_id = torch.as_tensor(next_track_id, dtype=torch.int32,
                                    device=img.device)
    ids = next_track_id + torch.arange(F_, dtype=torch.int32,
                                       device=img.device)
    track_id = torch.where(valid, ids, torch.full_like(ids, -1))
    n_new = torch.sum(valid.to(torch.int32), dtype=torch.int32)
    status = torch.where(valid, klt.TRACKED, klt.BAD).to(torch.int32)
    return InitializerState(
        ref_keypoints=xy, cur_keypoints=xy, track_id=track_id, status=status,
        valid=valid, refs=refs,
        frames_from_ref=torch.zeros((), dtype=torch.int32, device=img.device),
        next_track_id=next_track_id + n_new)


def track_frame(state: InitializerState, pyramid, klt_config: klt.KLTConfig,
                config: InitializerConfig):
    """KLT data association against the reference image. Returns
    (state, n_matches). Tallies ``initializer.tracked_frames`` (on the
    card one launch of the KLT kernel each)."""
    profiler.tally("initializer.tracked_frames")
    pts, status = klt.track(pyramid, state.refs, state.cur_keypoints,
                            state.status, klt_config,
                            min_ssim=config.klt_min_ssim)
    tracked = state.valid & (status == klt.TRACKED)
    n = torch.sum(tracked.to(torch.int32), dtype=torch.int32)
    return state._replace(cur_keypoints=pts, status=status,
                          frames_from_ref=state.frames_from_ref + 1), n


def _track(state: InitializerState, pyramid, klt_config: klt.KLTConfig,
           config: InitializerConfig):
    """``track_frame``, and whether the reference has to be re-seeded: too
    few matches, or the window past ``max_frames_from_ref``. Returns
    (state, reset_needed)."""
    state, n = track_frame(state, pyramid, klt_config, config)
    return state, ((n < config.min_matches)
                   | (state.frames_from_ref > config.max_frames_from_ref))


# ---------------------------------------------------------------------------
# Essential matrix machinery
# ---------------------------------------------------------------------------

def _kmeans(points, valid, k: int, iters: int, perm):
    """Fixed-iteration Lloyd's kmeans over valid 2D points -> labels [N];
    initial centres are the first k valid points in ``perm`` order."""
    order = torch.sort((~valid[perm]).to(torch.int8), stable=True).indices
    centers = points[perm[order][:k]]
    vmask = valid[:, None].to(points.dtype)

    def nearest(c):
        return torch.argmin(torch.sum((points[:, None] - c[None]) ** 2,
                                      dim=-1), dim=-1)

    for _ in range(iters):
        one_hot = F.one_hot(nearest(centers), k).to(points.dtype) * vmask
        counts = torch.sum(one_hot, dim=0)
        sums = one_hot.T @ points
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    return nearest(centers)


class Constants(NamedTuple):
    """The attempt's constant tensors (``constants``), made outside any
    captured piece: a CUDA graph's capture cannot copy from the host."""

    s: torch.Tensor   # [3] an essential matrix's singular values (1, 1, 0)
    W: torch.Tensor   # [3, 3] the decomposition's rotation about z


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def constants(device, dtype=torch.float32) -> Constants:
    """The attempt's constants on ``device`` (two host-to-device copies)."""
    return Constants(
        s=torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=device),
        W=torch.tensor(_W, dtype=dtype, device=device))


class Sample(NamedTuple):
    """An attempt's rays and its stratified sample (``_sample``)."""

    ref_rays: torch.Tensor   # [F, 3]
    cur_rays: torch.Tensor   # [F, 3]
    tracked: torch.Tensor    # [F]
    A: torch.Tensor          # [H, 8, 9] each hypothesis' 8-point system


class Scored(NamedTuple):
    """The best hypothesis and the refit's normal matrix (``_score``)."""

    E: torch.Tensor          # [3, 3]
    inliers: torch.Tensor    # [F]
    M: torch.Tensor          # [9, 9]


# The device work of an attempt, cut at its three host round trips (the
# decompositions run on the host's LAPACK, module docstring):
#   _sample       rays, k-means, the stratified sample, the 8-point systems
#   host          _eight_point_host: the SVD of each system, its null
#                 vector E and the SVD of E
#   _score        the projected hypotheses, their inliers, the best one and
#                 the refit's normal matrix M
#   host          _refit_host: eigh(M) and the SVD of its smallest
#                 eigenvector
#   _choose       the refit E, kept where it loses no inliers
#   host          _decompose_host: the SVD of E and its rotations' signs
#   _reconstruct  the pose, the triangulated points and the success flag
# Each host step takes what it needs from tensors already on the host, so
# the round trips carry the same bits as one round trip per decomposition
# would. ``init_graph.InitGraphs`` captures each device piece as a graph.

def _on_host(fn, *args, out=None):
    """``fn`` on host copies of ``args``; its results back on the device of
    ``args[0]``, or copied into the tensors of ``out`` (returned)."""
    with profiler.span("nrslam.init.sync"):
        host = [a.cpu() for a in args]
    with profiler.span("nrslam.init.lapack"):
        res = fn(*host)
    if out is None:
        return tuple(r.to(args[0].device) for r in res)
    for o, r in zip(out, res):
        o.copy_(r)
    return out


def _design(ref_rays, cur_rays):
    """The epipolar constraint's row [..., 9] of each correspondence."""
    return torch.cat([ref_rays * cur_rays[..., 0:1],
                      ref_rays * cur_rays[..., 1:2],
                      ref_rays * cur_rays[..., 2:3]], dim=-1)


def _eight_point_host(A):
    """Host: E from 8 correspondences, batched over hypotheses
    (essential_matrix_initialization.cc:180-212), as the SVD (u, vt) of
    the null vector of each 8-point system ``A [..., 8, 9]``."""
    _, _, vt = torch.linalg.svd(A)
    u, _, vt = torch.linalg.svd(vt[..., 8, :].reshape(vt.shape[:-2]
                                                       + (3, 3)))
    return u, vt


def _refit_host(M):
    """Host: the SVD (u, vt) of the smallest eigenvector of ``M``."""
    _, vecs = torch.linalg.eigh(M)
    u, _, vt = torch.linalg.svd(vecs[:, 0].reshape(3, 3))
    return u, vt


def _decompose_host(E):
    """Host: the SVD of E and whether each candidate rotation, u W^T vt and
    u W vt, has a negative determinant: (u, vt, flip [2])."""
    u, _, vt = torch.linalg.svd(E)
    W = torch.tensor(_W, dtype=E.dtype)
    flip = torch.stack([torch.linalg.det(u @ W.T @ vt) < 0,
                        torch.linalg.det(u @ W @ vt) < 0])
    return u, vt, flip


def _project(u, vt, c: Constants):
    """The closest essential matrix (singular values 1, 1, 0) to the one
    whose SVD is u, vt, negated as in the reference's sign convention."""
    return -(u @ (c.s[:, None] * vt))


def _eight_point(ref_rays, cur_rays):
    """E from 8 correspondences, batched over hypotheses."""
    return _project(*_on_host(_eight_point_host, _design(ref_rays,
                                                         cur_rays)),
                    constants(ref_rays.device, ref_rays.dtype))


def _epipolar_inliers(E, ref_rays, cur_rays, threshold: float):
    """Angular epipolar test (essential_matrix_initialization.cc:236-256)."""
    Er = torch.einsum("...ij,nj->...ni", E, ref_rays)
    Er = Er / torch.clamp(torch.linalg.norm(Er, dim=-1, keepdim=True),
                          min=1e-12)
    cosang = torch.sum(Er * cur_rays[None], dim=-1)
    err = torch.abs(math.pi / 2 - torch.arccos(torch.clamp(cosang, -1.0,
                                                           1.0)))
    return err < threshold


def _sample_rays(ref_rays, cur_rays, tracked, config: InitializerConfig,
                 perm, gumbel) -> Sample:
    """The stratified sample: ``perm [N]`` seeds the kmeans, ``gumbel [H,
    N]`` picks one tracked member of every cluster per hypothesis (argmax
    of the noise)."""
    with profiler.span("nrslam.init.kmeans"):
        labels = _kmeans(ref_rays[:, :2] / torch.clamp(ref_rays[:, 2:3],
                                                       min=1e-6),
                         tracked, config.kmeans_clusters,
                         config.kmeans_iters, perm)
    clusters = torch.arange(config.kmeans_clusters, device=labels.device)
    member = tracked[None] & (labels[None] == clusters[:, None])   # [C, N]
    w = torch.where(member[None], gumbel[:, None, :],
                    torch.full_like(gumbel[:, None, :], -math.inf))
    sample_idx = torch.argmax(w, dim=-1)                           # [H, C]
    return Sample(ref_rays, cur_rays, tracked,
                  _design(ref_rays[sample_idx], cur_rays[sample_idx]))


def _sample(cam, state: InitializerState, config: InitializerConfig, perm,
            gumbel) -> Sample:
    """The tracked set's rays and the stratified sample."""
    tracked = state.valid & (state.status == klt.TRACKED)
    ref_rays = cameras.unit_rays(cam, state.ref_keypoints)
    cur_rays = cameras.unit_rays(cam, state.cur_keypoints)
    return _sample_rays(ref_rays, cur_rays, tracked, config, perm, gumbel)


def _score(u, vt, sample: Sample, config: InitializerConfig,
           c: Constants) -> Scored:
    """Every hypothesis (its 8-point E's SVD u, vt [H, 3, 3]) scored by its
    inliers; the best, and the normal matrix of its inlier set."""
    E = _project(u, vt, c)                                        # [H, 3, 3]
    inl = _epipolar_inliers(E, sample.ref_rays, sample.cur_rays,
                            config.epipolar_threshold) & sample.tracked[None]
    scores = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(scores).reshape(1)
    E_best, inl_best = E[best][0], inl[best][0]
    # Refit on the full inlier set: smallest eigenvector of the
    # inlier-weighted normal matrix, kept only if it loses no inliers.
    A = _design(sample.ref_rays, sample.cur_rays)                 # [N, 9]
    M = torch.einsum("ni,nj,n->ij", A, A, inl_best.to(A.dtype))
    return Scored(E_best, inl_best, M)


def _choose(u, vt, scored: Scored, sample: Sample,
            config: InitializerConfig, c: Constants):
    """The refit E (the SVD u, vt of M's smallest eigenvector) where it
    loses no inliers, else the best hypothesis. Returns (E, inliers [N])."""
    Er = _project(u, vt, c)
    inl_r = _epipolar_inliers(Er[None], sample.ref_rays, sample.cur_rays,
                              config.epipolar_threshold)[0] & sample.tracked
    keep = torch.sum(inl_r.to(torch.int32)) >= torch.sum(
        scored.inliers.to(torch.int32))
    return (torch.where(keep, Er, scored.E),
            torch.where(keep, inl_r, scored.inliers))


def _ransac(sample: Sample, config: InitializerConfig, c: Constants):
    """Batched RANSAC + least-squares refit on a sample. Returns (E,
    inliers [N])."""
    scored = _score(*_on_host(_eight_point_host, sample.A), sample, config,
                    c)
    return _choose(*_on_host(_refit_host, scored.M), scored, sample, config,
                   c)


def find_essential_ransac(ref_rays, cur_rays, tracked,
                          config: InitializerConfig, perm, gumbel):
    """Batched stratified RANSAC + least-squares refit. ``perm [N]`` seeds
    the kmeans, ``gumbel [H, N]`` picks one tracked member of every cluster
    per hypothesis (argmax of the noise). Returns (E, inliers [N])."""
    with profiler.span("nrslam.init.ransac"):
        return _ransac(_sample_rays(ref_rays, cur_rays, tracked, config,
                                    perm, gumbel), config,
                       constants(ref_rays.device, ref_rays.dtype))


def _cameras(u, vt, flip, ref_rays, cur_rays, inliers,
             c: Constants) -> se3.SE3:
    """Decompose E (its SVD u, vt; ``flip``: the candidate rotations'
    negative determinants), pick the smaller rotation, orient t by ray
    consensus (essential_matrix_initialization.cc:284-318)."""
    R1 = u @ c.W.T @ vt
    R1 = torch.where(flip[0], -R1, R1)
    R2 = u @ c.W @ vt
    R2 = torch.where(flip[1], -R2, R2)
    R = torch.where(torch.trace(R2) > torch.trace(R1), R2, R1)
    t = u[:, 2] / torch.linalg.norm(u[:, 2])

    w = inliers.to(u.dtype)
    away = torch.sum(w * torch.sign(torch.sum(
        (ref_rays @ R.T - cur_rays) * (cur_rays - t[None]), dim=-1)))
    t = torch.where(away < 0, -t, t)
    return se3.SE3(se3.matrix_to_quat(R), t)


def reconstruct_cameras(E, ref_rays, cur_rays, inliers) -> se3.SE3:
    """Decompose E, pick the smaller rotation, orient t by ray consensus
    (essential_matrix_initialization.cc:284-318)."""
    return _cameras(*_on_host(_decompose_host, E), ref_rays, cur_rays,
                    inliers, constants(E.device, E.dtype))


def reconstruct_points(cam, Tcw: se3.SE3, ref_uv, cur_uv, inliers,
                       config: InitializerConfig):
    """Midpoint triangulation + parallax/depth/reprojection gates
    (essential_matrix_initialization.cc:320-410). Returns
    (landmarks [N, 3], ok [N], low_parallax [N])."""
    ref_rays = cameras.unit_rays(cam, ref_uv)
    cur_rays = cameras.unit_rays(cam, cur_uv)
    T_ref = se3.identity(device=ref_uv.device)
    X = triangulation.triangulate_midpoint(ref_rays, cur_rays, T_ref, Tcw)

    t_wc = se3.inverse(Tcw).t
    parallax = triangulation.rays_parallax(X, X - t_wc)
    low_parallax = inliers & (parallax < config.rad_per_pixel * 5.0)

    Xc = se3.apply(Tcw, X)
    proj_ref = cameras.project(cam, X)
    proj_cur = cameras.project(cam, Xc)
    ok = (inliers
          & torch.isfinite(X).all(dim=-1)
          & ~low_parallax
          & (X[:, 2] > 0) & (Xc[:, 2] > 0)
          & (triangulation.squared_reprojection_error(ref_uv, proj_ref)
             <= 5.991)
          & (triangulation.squared_reprojection_error(cur_uv, proj_cur)
             <= 5.991))
    return X, ok, low_parallax


def _reconstruct(cam, u, vt, flip, state: InitializerState, sample: Sample,
                 inliers, config: InitializerConfig,
                 c: Constants) -> InitializationResult:
    """The pose from E (its SVD u, vt and its rotations' ``flip``), the
    triangulated points and the success flag."""
    Tcw = _cameras(u, vt, flip, sample.ref_rays, sample.cur_rays, inliers, c)
    X, ok, low_par = reconstruct_points(cam, Tcw, state.ref_keypoints,
                                        state.cur_keypoints, inliers, config)
    n_ok = torch.sum(ok.to(torch.int32))
    n_low = torch.sum(low_par.to(torch.int32))
    n_inl = torch.sum(inliers.to(torch.int32))
    success = ((n_ok >= config.min_triangulated)
               & (n_low <= config.max_low_parallax_frac
                  * torch.clamp(n_inl, min=1)))
    return InitializationResult(
        success=success, Tcw=Tcw, ref_keypoints=state.ref_keypoints,
        cur_keypoints=state.cur_keypoints, landmarks=X, point_ok=ok,
        track_id=state.track_id)


def _attempt(cam, state: InitializerState, config: InitializerConfig, perm,
             gumbel):
    """Rigid initialisation attempt without the refinement. Returns
    (InitializationResult, RANSAC inliers [F])."""
    c = constants(state.ref_keypoints.device)
    with profiler.span("nrslam.init.ransac"):
        sample = _sample(cam, state, config, perm, gumbel)
        E, inliers = _ransac(sample, config, c)
    with profiler.span("nrslam.init.reconstruct"):
        result = _reconstruct(cam, *_on_host(_decompose_host, E), state,
                              sample, inliers, config, c)
    return result, inliers


def _refine(cam, result: InitializationResult, inliers,
            config: InitializerConfig) -> InitializationResult:
    """Two-view refinement of a successful attempt: alternate pose-only LM
    against the triangulated structure with midpoint re-triangulation,
    three times (initializer.py:337-350 of the JAX package). Tallies
    ``initializer.refines`` (on the card three launches of the pose-only
    kernel each)."""
    from nrslam_tpu_torch.solver import pose_only

    T, X, ok = result.Tcw, result.landmarks, result.point_ok
    ok_r = ok
    with profiler.span("nrslam.init.refine"):
        for _ in range(3):
            T = pose_only.camera_pose_optimization(cam, T, X,
                                                   result.cur_keypoints, ok)
            X, ok_r, _ = reconstruct_points(cam, T, result.ref_keypoints,
                                            result.cur_keypoints, inliers,
                                            config)
    profiler.tally("initializer.refines")
    return result._replace(Tcw=T, landmarks=X, point_ok=ok & ok_r)


def try_initialize(cam, state: InitializerState, config: InitializerConfig,
                   perm, gumbel) -> InitializationResult:
    """Full rigid initialisation attempt on the current track set; the
    refinement runs on success (one host read of the flag)."""
    result, inliers = _attempt(cam, state, config, perm, gumbel)
    with profiler.span("nrslam.init.sync"):
        success = bool(result.success)
    if success:
        result = _refine(cam, result, inliers, config)
    return result


def init_step(state: InitializerState, pyramid, mask, perm, gumbel, cam,
              klt_config: klt.KLTConfig, config: InitializerConfig):
    """One init-phase frame (monocular_map_initializer.cc:100-133): track
    against the reference; attempt the initialisation on the tracked set;
    if matches dropped below min_matches or the window exceeded
    max_frames_from_ref, re-seed the reference from this frame and reject
    the attempt. Both flags are read in one host transfer; the reset (a
    Shi-Tomasi detection + reference extraction) and the refinement run only
    when their flag is set. Returns (state, result)."""
    with profiler.span("nrslam.init.klt"):
        state_t, reset_needed = _track(state, pyramid, klt_config, config)
    result, inliers = _attempt(cam, state_t, config, perm, gumbel)
    with profiler.span("nrslam.init.sync"):
        do_reset, success = torch.stack([reset_needed,
                                         result.success]).tolist()
    if success:
        result = _refine(cam, result, inliers, config)
    state_new = state_t
    if do_reset:
        state_new = reset(pyramid, mask, state_t.next_track_id, klt_config,
                          config)
    return state_new, result._replace(success=result.success & ~reset_needed)
