"""Per-frame tracking: data association, pose + deformation, point reuse,
keyframe policy (counterpart of nrslam_tpu/slam/tracking.py).

Each step is a (state, inputs) -> state transform over the SlamState
NamedTuple; the whole frame runs without reading a device value back. The
steps that touch the deformation graph work on this process's block of
rows, ``rows.block`` (``graph.Rows``; every row in a single process), and
``rows`` makes their results whole.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nrslam_tpu_torch.geometry import cameras, se3, triangulation
from nrslam_tpu_torch.ops import klt, shi_tomasi
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam.state import Config, SlamState
from nrslam_tpu_torch.solver import (bundle_adjustment, pose_deformation,
                                     pose_only)
from nrslam_tpu_torch.utils import profiler


class Solves(NamedTuple):
    """The frame's solves: the two of ``track_camera_and_deformation`` on
    the whole ``[P]`` arrays, ``pose_only(cam, T0, X, obs, valid) -> SE3``
    and ``joint(cam, T0, rest, obs, valid, pairs, scale) ->
    PoseDeformationResult``, and the keyframe's window BA of
    ``mapping.keyframe_mapping``, ``ba(cam, poses0, L0, problem,
    cg_iters=...) -> (poses [W], L [W, P, 3])`` with L0 and
    ``problem.obs_valid`` whole and ``problem.obs`` the keyframe ring's
    columns this process holds. ``WHOLE`` solves in this process (the
    whole-solver kernels on the card); the sharded frame passes
    ``parallel.solve_shard.mesh_solves``."""

    pose_only: Callable
    joint: Callable
    ba: Callable


WHOLE = Solves(pose_only.camera_pose_optimization,
               pose_deformation.pose_deformation_optimization,
               bundle_adjustment.local_deformable_ba)


def update_triangulated_points(state: SlamState) -> SlamState:
    """Promote JUST_TRIANGULATED -> TRACKED_WITH_3D (tracking.cc:508-527)."""
    promote = state.slot_used & (state.status == klt.JUST_TRIANGULATED)
    return state._replace(
        status=torch.where(promote, klt.TRACKED_WITH_3D, state.status))


def data_association(state: SlamState, pyramid, config: Config) -> SlamState:
    """KLT-track every usable slot into the new frame."""
    pts, status = klt.track(pyramid, state.refs, state.keypoints,
                            state.status, config.klt_config,
                            min_ssim=config.klt_min_ssim,
                            use_initial_flow=True)
    return state._replace(keypoints=pts, status=status)


def track_camera_and_deformation(state: SlamState, cam, config: Config,
                                 rows: graph_mod.Rows = graph_mod.ALL,
                                 solves: Solves = WHOLE):
    """Motion-model seed -> pose-only -> joint pose+deformation, then
    graph maintenance and the lost-point drag (tracking.cc:291-330). The
    graph's rows give the neighbour table and take the update and the
    ``starved`` test; ``solves`` run the two solves."""
    T_seed = se3.compose(state.motion_model, state.Tcw)
    prev_Tcw = state.Tcw

    with3d = state_mod.tracked_with_3d(state)
    T_pose = solves.pose_only(cam, T_seed, state.positions,
                              state.keypoints, with3d)

    nbr_idx, nbr_w, nbr_d0, nbr_valid = rows.gather(
        *graph_mod.top_k_neighbors(state.graph, with3d,
                                   config.regularizers_per_point))
    nbr_valid = nbr_valid & with3d[:, None]
    pairs = pose_deformation.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                                  nbr_valid)

    res = solves.joint(cam, T_pose, state.positions, state.keypoints,
                       with3d, pairs, state.scale)

    accept = res.reproj_inlier & res.deform_ok
    profiler.device_count("tracking.rejected", with3d & ~accept)
    positions = torch.where(accept[:, None], state.positions + res.flows,
                            state.positions)
    status = torch.where(with3d & ~accept, klt.TRACKED, state.status)

    new_graph, good = graph_mod.update_vertices(state.graph, positions,
                                                res.reproj_inlier, rows)
    inlier = res.reproj_inlier[rows.block]
    (starved,) = rows.gather(
        inlier & (good < (config.regularizers_per_point - 1) // 2))
    status = torch.where(starved, klt.BAD, status)

    lost = (state.slot_used & state.has_3d
            & (status != klt.TRACKED_WITH_3D)
            & (status != klt.JUST_TRIANGULATED))
    drag = pose_deformation.lost_point_drag(
        res.flows, nbr_idx, nbr_w, nbr_valid & res.reproj_inlier[nbr_idx],
        state.scale)
    positions = torch.where(lost[:, None], positions + drag, positions)

    return state._replace(
        Tcw=res.Tcw,
        positions=positions,
        status=status,
        graph=new_graph,
        deformation_mag=res.median_deformation,
        motion_model=se3.compose(res.Tcw, se3.inverse(prev_Tcw)),
    )


def point_reuse(state: SlamState, pyramid, cam, config: Config) -> SlamState:
    """Re-acquire lost / out-of-frame mappoints with a 2-level KLT seeded at
    their projections (tracking.cc:394-505)."""
    h, w = pyramid[0][0].shape
    usable_now = klt.is_usable(state.status) & state.slot_used

    Xc = se3.apply(state.Tcw, state.positions)
    proj = cameras.project(cam, Xc)
    in_image = ((Xc[..., 2] > 0)
                & (proj[:, 0] >= 0) & (proj[:, 0] < w)
                & (proj[:, 1] >= 0) & (proj[:, 1] < h)
                & torch.isfinite(proj).all(dim=-1))
    candidates = state.slot_used & state.has_3d & ~usable_now & in_image

    reuse_cfg = config.klt_config._replace(max_level=1)
    reuse_refs = state.refs.level_slice(2)
    seeds = torch.where(candidates[:, None], proj, state.keypoints)
    seed_status = torch.where(
        candidates, klt.TRACKED_WITH_3D,
        torch.full_like(state.status, state_mod.NOT_IN_FRAME))
    pts, st = klt.track(pyramid[:2], reuse_refs, seeds, seed_status,
                        reuse_cfg, min_ssim=config.klt_min_ssim_reuse,
                        use_initial_flow=True)

    err = triangulation.squared_reprojection_error(proj, pts)
    reacquired = candidates & (st == klt.TRACKED_WITH_3D) & (err <= 5.99)
    profiler.device_count("tracking.reuse_candidates", candidates)
    profiler.device_count("tracking.reused", reacquired)
    return state._replace(
        keypoints=torch.where(reacquired[:, None], pts, state.keypoints),
        status=torch.where(reacquired, klt.TRACKED_WITH_3D, state.status))


def create_keyframe(state: SlamState, pyramid, mask,
                    config: Config) -> SlamState:
    """Extract new features into free (or recycled) slots, snapshot the
    keyframe and refresh the KLT reference (tracking.cc:350-392)."""
    state = add_keyframe_features(state, pyramid, mask, config)
    return refresh_reference(state, pyramid, mask, config)


def add_keyframe_features(state: SlamState, pyramid, mask, config: Config,
                          rows: graph_mod.Rows = graph_mod.ALL) -> SlamState:
    """``create_keyframe`` up to the keyframe snapshot: everything but the
    KLT reference, which ``refresh_reference`` sets per slot. The keyframe
    ring holds the columns of ``rows.block`` (all in one process)."""
    img = pyramid[0][0]
    usable = klt.is_usable(state.status) & state.slot_used

    # Occupied map for the NMS poisoning; duplicate pixels accumulate.
    h, w = img.shape
    yy = torch.clamp(torch.round(state.keypoints[:, 1]).to(torch.int64),
                     0, h - 1)
    xx = torch.clamp(torch.round(state.keypoints[:, 0]).to(torch.int64),
                     0, w - 1)
    occ = torch.zeros(h * w, dtype=torch.float32, device=img.device)
    occ.index_add_(0, yy * w + xx, usable.to(torch.float32))
    occ = (occ > 0).reshape(h, w)

    xy, det_valid, _ = shi_tomasi.detect(
        img, config.max_new_keypoints, nms_radius=config.nms_radius,
        mask=mask, occupied=occ)

    dead = state.slot_used & ~usable & ~state.has_3d
    slot_used = state.slot_used & ~dead
    _, slot_idx = state_mod.top_k_stable((~slot_used).to(torch.float32),
                                         config.max_new_keypoints)
    can_place = (~slot_used)[slot_idx] & det_valid

    new_ids = state.next_track_id + torch.cumsum(
        can_place.to(torch.int32), 0, dtype=torch.int32) - 1
    track_id = state.track_id.index_copy(
        0, slot_idx, torch.where(can_place, new_ids, state.track_id[slot_idx]))
    slot_used = slot_used.index_copy(0, slot_idx,
                                     slot_used[slot_idx] | can_place)
    keypoints = state.keypoints.index_copy(
        0, slot_idx, torch.where(can_place[:, None], xy,
                                 state.keypoints[slot_idx]))
    status = torch.where(dead, state_mod.NOT_IN_FRAME, state.status)
    status = status.index_copy(
        0, slot_idx, torch.where(can_place, klt.TRACKED, status[slot_idx]))
    has_3d = state.has_3d.index_copy(
        0, slot_idx, state.has_3d[slot_idx] & ~can_place)
    profiler.device_count("keyframe.new_features", can_place)

    graph = graph_mod.remove_landmarks(state.graph, dead, rows)
    state = state._replace(
        slot_used=slot_used, track_id=track_id, keypoints=keypoints,
        status=status, has_3d=has_3d, graph=graph,
        next_track_id=state.next_track_id
        + torch.sum(can_place.to(torch.int32), dtype=torch.int32))

    return state_mod.insert_keyframe(state, rows.block)


def refresh_reference(state: SlamState, pyramid, mask,
                      config: Config) -> SlamState:
    """The KLT reference of every usable slot on the keyframe's image."""
    usable = klt.is_usable(state.status) & state.slot_used
    refs = klt.set_reference(pyramid, state.keypoints, usable,
                             config.klt_config, mask=mask)
    return state._replace(refs=refs)


class FrameResult(NamedTuple):
    n_tracked_3d: torch.Tensor
    lost: torch.Tensor


def process_frame(state: SlamState, pyramid, mask, cam: cameras.Camera,
                  config: Config, make_keyframe: bool):
    """One tracking step (Tracking::TrackImage steady state); each part
    begins a stage of the captured frame (``profiler.stage``)."""
    profiler.stage("tracking.klt")
    state = update_triangulated_points(state)
    state = data_association(state, pyramid, config)
    profiler.stage("tracking.solve")
    state = track_camera_and_deformation(state, cam, config)
    profiler.stage("tracking.reuse")
    state = point_reuse(state, pyramid, cam, config)

    n3d = torch.sum(state_mod.tracked_with_3d(state).to(torch.int32),
                    dtype=torch.int32)
    if make_keyframe:
        profiler.stage("tracking.keyframe")
        state = create_keyframe(state, pyramid, mask, config)
    profiler.stage("tracking.bookkeeping")
    state = state_mod.insert_temporal_snapshot(state)
    lost = state.lost | (n3d < config.min_tracked_exit)
    state = state._replace(lost=lost)
    return state, FrameResult(n_tracked_3d=n3d, lost=lost)
