"""The sizes the kernels' yardstick needs, read from the states a traced
frame ran on with the reference's own functions (``slambench/reference``;
the program's states are read, never changed):

- the joint solve's live edges: the deduplicated neighbour pairs of the
  slots tracked with a 3D point when the frame began, both ends live
  (``tracking.track_camera_and_deformation``'s table, after the edge
  budget);
- the keyframe BA's window: the valid keyframes of the newest
  ``ba_window`` and the live edges between eligible slots, read from the
  state the keyframe frame ended with (its new keyframe inserted).
"""

from __future__ import annotations

import torch

from slambench.reference.slam import graph as graph_mod
from slambench.reference.slam import state as state_mod
from slambench.reference.slam import tracking
from slambench.reference.solver import pose_deformation as pd


def joint_live_edges(state, regularizers: int) -> int:
    st = tracking.update_triangulated_points(state)
    with3d = state_mod.tracked_with_3d(st)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = graph_mod.top_k_neighbors(
        st.graph, with3d, regularizers)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                    nbr_valid & with3d[:, None])
    pairs = pd.compact_pairs(pairs, with3d.shape[0], with3d)
    live = pairs.valid & with3d[pairs.i] & with3d[pairs.j]
    return int(live.sum())


def ba_window(state, window: int, regularizers: int):
    """(K valid keyframes in the window, live edges) of the keyframe BA."""
    key = torch.where(state.kf_valid, state.kf_id,
                      torch.full_like(state.kf_id, -1))
    order = state_mod.argsort_stable(-key)[:window]
    win_valid = state.kf_valid[order]
    obs_valid = state.kf_obs[order] & win_valid[:, None]
    eligible = torch.any(obs_valid, dim=0)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = graph_mod.top_k_neighbors(
        state.graph, eligible, regularizers)
    pairs = pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                    nbr_valid & eligible[:, None])
    pairs = pd.compact_pairs(pairs, eligible.shape[0], eligible)
    live = pairs.valid & eligible[pairs.i] & eligible[pairs.j]
    return int(win_valid.sum()), int(live.sum())
