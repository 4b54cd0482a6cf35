"""Per-frame mapping: landmark triangulation and local deformable BA
(counterpart of nrslam_tpu/slam/mapping.py).

Non-keyframes run dual-path triangulation (rigid midpoint + deformable) with
the 1.5x majority vote and star edges; keyframes run the windowed BA and
refresh the live frame from the newest keyframe.

Work per slot (the neighbour search, the rigid path, the graph) runs on
this process's block of rows, ``rows.block`` (``graph.Rows``; the state's
graph holds those rows), and the deformable path on its share of the
candidates; ``rows`` makes the results whole. A single process holds every
row (``graph.ALL``).
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras, se3, triangulation
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam import tracking
from nrslam_tpu_torch.slam.state import Config, SlamState
from nrslam_tpu_torch.solver import bundle_adjustment as ba
from nrslam_tpu_torch.solver import deformable_triangulation as dt
from nrslam_tpu_torch.solver import pose_deformation as pd


def _last_snapshot_index(state: SlamState):
    key = torch.where(state.tb_valid, state.tb_frame_id,
                      torch.full_like(state.tb_frame_id, -1))
    return torch.argmax(key)


def _closest_mapped_neighbors(state: SlamState, config: Config,
                              rows: graph_mod.Rows = graph_mod.ALL):
    """The <= 11 nearest TRACKED_WITH_3D keypoints of every slot in the last
    snapshot within [min_px, max_px]; a closer neighbour disqualifies. For
    the slots of ``rows`` against every keypoint. Returns (nbr_idx [R, NB],
    nbr_valid [R, NB], cand_ok [R])."""
    last = _last_snapshot_index(state)
    kps = state_mod.take(state.tb_keypoints, last)
    with3d = state_mod.take(state.tb_with3d, last)

    d = torch.linalg.norm(kps[rows.block, None] - kps[None], dim=-1)
    pairable = with3d[None, :] & graph_mod.off_diagonal(
        rows, kps.shape[0], d.device)
    too_close = torch.any(pairable & (d < config.tri_min_neighbors_px), dim=1)
    ok_pair = pairable & (d <= config.tri_max_neighbors_px) \
        & (d >= config.tri_min_neighbors_px)
    score = torch.where(ok_pair, -d, torch.full_like(d, -float("inf")))
    top_s, nbr_idx = state_mod.top_k_stable(score, config.tri_num_neighbors)
    nbr_valid = torch.isfinite(top_s)
    cand_ok = ~too_close & torch.any(nbr_valid, dim=1)
    return nbr_idx, nbr_valid, cand_ok


def _rigid_triangulation(state: SlamState, cam, config: Config, order,
                         order_valid, candidates,
                         rows: graph_mod.Rows = graph_mod.ALL):
    """Rigid midpoint path with rigidity/parallax/reprojection gates
    (mapping.cc:117-189), for the slots of ``rows``. Returns (landmarks
    [R, 3], ok [R])."""
    mine = rows.block
    tb_tracked = state.tb_tracked[:, mine][order]
    tb_kps = state.tb_keypoints[:, mine][order]
    poses = se3.index(state.tb_pose, order)
    def_mag = state.tb_def_mag[order]
    T = order.shape[0]

    track = tb_tracked & order_valid[:, None]
    idx = torch.arange(T, device=order.device)[:, None]
    first = torch.amin(torch.where(track, idx, T), dim=0)
    last = torch.amax(torch.where(track, idx, -1), dim=0)
    has_track = last >= first
    first_c = torch.clamp(first, 0, T - 1)
    last_c = torch.clamp(last, 0, T - 1)

    in_window = (idx >= first_c[None, :]) & (idx <= last_c[None, :]) \
        & order_valid[:, None]
    rigid = ~torch.any(in_window
                       & (def_mag[:, None] > config.rigidity_threshold), dim=0)

    pr = torch.arange(track.shape[1], device=order.device)
    kp_first = tb_kps[first_c, pr]
    kp_last = tb_kps[last_c, pr]
    T_first = se3.index(poses, first_c)
    T_last = se3.index(poses, last_c)

    ray_first = cameras.unit_rays(cam, kp_first)
    ray_last = cameras.unit_rays(cam, kp_last)
    X = triangulation.triangulate_midpoint(ray_last, ray_first, T_last,
                                           T_first)

    n1 = X - se3.inverse(T_first).t
    n2 = X - se3.inverse(T_last).t
    parallax = triangulation.rays_parallax(n1, n2)
    parallax_ok = ((parallax >= config.rad_per_pixel * 10.0)
                   & (parallax <= config.rad_per_pixel * 20.0))

    X1 = se3.apply(T_last, X)
    X2 = se3.apply(T_first, X)
    reproj_ok = (
        (X1[:, 2] > 0) & (X2[:, 2] > 0)
        & (triangulation.squared_reprojection_error(
            kp_last, cameras.project(cam, X1)) <= 5.991)
        & (triangulation.squared_reprojection_error(
            kp_first, cameras.project(cam, X2)) <= 5.991))

    ok = (candidates[mine] & has_track & rigid & parallax_ok & reproj_ok
          & torch.isfinite(X).all(dim=-1))
    return X, ok


def _deformable_inputs(state: SlamState, order, order_valid, nbr_idx,
                       nbr_valid, candidates, sel):
    """TriangulationInputs of the slots ``sel`` [S] from the chronological
    temporal ring."""
    tb_tracked = state.tb_tracked[:, sel][order]
    tb_kps = state.tb_keypoints[:, sel][order]
    tb_pos = state.tb_positions[order]
    tb_3d = state.tb_with3d[order]
    nbr_idx, nbr_valid = nbr_idx[sel], nbr_valid[sel]

    track = (tb_tracked & order_valid[:, None]).T
    obs = tb_kps.transpose(0, 1)
    nbr_pos = tb_pos[:, nbr_idx, :].permute(1, 2, 0, 3)   # [S, NB, T, 3]
    nbr_ok = tb_3d[:, nbr_idx].permute(1, 2, 0) \
        & nbr_valid[:, :, None] & order_valid[None, None, :]
    return dt.TriangulationInputs(obs=obs, track_valid=track,
                                  nbr_pos=nbr_pos, nbr_valid=nbr_ok,
                                  cand_valid=candidates[sel])


def assemble_triangulation_inputs(state: SlamState, config: Config,
                                  rows: graph_mod.Rows = graph_mod.ALL):
    """Candidates + the deformable inputs of this process's share of the
    compacted candidates. Returns (candidates [P], inputs [C_r], cand_sel
    [C], order, order_valid, buffer poses [T])."""
    last = _last_snapshot_index(state)
    candidates = (state_mod.take(state.tb_valid, last)
                  & state_mod.take(state.tb_tracked, last)
                  & ~state_mod.take(state.tb_with3d, last)
                  & state.slot_used & ~state.has_3d)
    nbr_idx, nbr_valid, nbr_ok = rows.gather(
        *_closest_mapped_neighbors(state, config, rows))
    candidates = candidates & nbr_ok

    order = state_mod.chronological_temporal_order(state)
    order_valid = state.tb_valid[order]
    poses = se3.index(state.tb_pose, order)

    C = min(config.max_triangulation_candidates, candidates.shape[0])
    _, cand_sel = state_mod.top_k_stable(candidates.to(torch.float32), C)
    inputs_c = _deformable_inputs(state, order, order_valid, nbr_idx,
                                  nbr_valid, candidates, rows.share(cand_sel))
    return candidates, inputs_c, cand_sel, order, order_valid, poses


def landmark_triangulation(state: SlamState, cam, config: Config,
                           rows: graph_mod.Rows = graph_mod.ALL) -> SlamState:
    """Dual-path triangulation with the 1.5x majority vote
    (mapping.cc:65-257)."""
    (candidates, inputs_c, cand_sel, order, order_valid,
     poses) = assemble_triangulation_inputs(state, config, rows)

    X_rigid, ok_rigid = rows.gather(*_rigid_triangulation(
        state, cam, config, order, order_valid, candidates, rows))
    C = cand_sel.shape[0]
    X_def_c, ok_def_c = (x[:C] for x in rows.gather(
        *dt.deformable_triangulate(cam, inputs_c, poses,
                                   config.rad_per_pixel)))
    P = candidates.shape[0]
    X_def = torch.zeros((P, 3), dtype=X_def_c.dtype,
                        device=X_def_c.device).index_copy(0, cand_sel, X_def_c)
    ok_def = torch.zeros(P, dtype=torch.bool,
                         device=X_def_c.device).index_copy(0, cand_sel,
                                                           ok_def_c)
    ok_def = ok_def & candidates

    n_rigid = torch.sum(ok_rigid.to(torch.int32))
    n_def = torch.sum(ok_def.to(torch.int32))
    use_rigid = n_rigid > (1.5 * n_def)
    use_def = n_def >= (1.5 * n_rigid)

    insert = torch.where(use_rigid, ok_rigid, use_def & ok_def)
    X_new = torch.where(use_rigid, X_rigid, X_def)

    positions = torch.where(insert[:, None], X_new, state.positions)
    status = torch.where(insert, klt.JUST_TRIANGULATED, state.status)
    has_3d = state.has_3d | insert

    current = state.slot_used & ((status == klt.TRACKED_WITH_3D)
                                 | (status == klt.JUST_TRIANGULATED))
    graph = graph_mod.add_edges(state.graph, positions, insert,
                                current & ~insert, rows)
    return state._replace(positions=positions, status=status, has_3d=has_3d,
                          graph=graph)


def keyframe_mapping(state: SlamState, cam, config: Config,
                     rows: graph_mod.Rows = graph_mod.ALL,
                     solves: tracking.Solves = tracking.WHOLE) -> SlamState:
    """Local deformable BA over the <= 5 newest keyframes plus the tracking
    frame refresh (mapping.cc:36-58, 266-270). The keyframe ring holds the
    columns of ``rows.block``: the window's copies and masks are made whole
    (``rows.gather_columns``), and ``solves.ba`` (the window BA) gets the
    ring's columns of the observations."""
    W = config.ba_window
    P = state.positions.shape[0]
    key = torch.where(state.kf_valid, state.kf_id,
                      torch.full_like(state.kf_id, -1))
    order = state_mod.argsort_stable(-key)[:W].flip(0)   # oldest -> newest
    win_valid = state.kf_valid[order]
    n_win = torch.sum(win_valid.to(torch.int32))

    poses0 = se3.index(state.kf_pose, order)
    obs = state.kf_keypoints[order]
    L0, obs_valid = rows.gather_columns(
        state.kf_positions[order], state.kf_obs[order] & win_valid[:, None])

    eligible = torch.any(obs_valid, dim=0)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = rows.gather(
        *graph_mod.top_k_neighbors(state.graph, eligible,
                                   config.regularizers_per_point))
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                    nbr_valid & eligible[:, None])
    pairs = pd.compact_pairs(pairs, P, eligible)

    problem = ba.BAProblem(obs=obs, obs_valid=obs_valid, kf_valid=win_valid,
                           pairs=pairs, scale=state.scale)
    poses1, L1 = solves.ba(cam, poses0, L0, problem,
                           cg_iters=config.ba_cg_iters)

    run = n_win >= 3
    poses1 = se3.SE3(torch.where(run, poses1.q, poses0.q),
                     torch.where(run, poses1.t, poses0.t))
    L1 = torch.where(run, L1, L0)

    kf_pose = se3.SE3(state.kf_pose.q.index_copy(0, order, poses1.q),
                      state.kf_pose.t.index_copy(0, order, poses1.t))
    kf_positions = state.kf_positions.index_copy(0, order,
                                                 L1[:, rows.block])

    # The newest keyframe's copies (the window's last) refresh the map.
    newest = order[-1:]
    positions = torch.where(obs_valid[-1][:, None], L1[-1], state.positions)
    Tcw = se3.SE3(torch.where(run, kf_pose.q[newest][0], state.Tcw.q),
                  torch.where(run, kf_pose.t[newest][0], state.Tcw.t))
    return state._replace(kf_pose=kf_pose, kf_positions=kf_positions,
                          positions=positions, Tcw=Tcw)


def do_mapping(state: SlamState, cam: cameras.Camera, config: Config,
               has_new_keyframe: bool,
               rows: graph_mod.Rows = graph_mod.ALL,
               solves: tracking.Solves = tracking.WHOLE) -> SlamState:
    """Mapping::DoMapping (mapping.cc:36-54); ``solves.ba`` runs the
    keyframe's window BA."""
    if has_new_keyframe:
        return keyframe_mapping(state, cam, config, rows, solves)
    return landmark_triangulation(state, cam, config, rows)
