"""The SLAM state: fixed-capacity landmark slots, keyframe ring, temporal
ring, deformation graph (counterpart of nrslam_tpu/slam/state.py; same
fields, same capacities, same constants).

Ring writes select the row with ``torch.where`` on a device-side slot index,
so no step reads a device scalar back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrslam_tpu_torch.geometry import se3
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.utils.device import resolve

NOT_IN_FRAME = 6


class Config(NamedTuple):
    """Capacities and reference knobs (identical to the JAX Config)."""

    max_points: int = 512
    max_keyframes: int = 8
    ba_window: int = 5
    temporal_window: int = 20
    klt_win: int = 21
    klt_levels: int = 5
    klt_iters: int = 10
    klt_epsilon: float = 1e-4
    klt_min_eig: float = 1e-4
    klt_min_ssim: float = 0.7
    klt_min_ssim_init: float = 0.5
    klt_min_ssim_reuse: float = 0.75
    keyframe_every: int = 5
    nms_radius: int = 7
    max_new_keypoints: int = 256
    regularizers_per_point: int = 11
    graph_sigma: float = 10.5
    rad_per_pixel: float = 0.002
    rigidity_threshold: float = 0.004
    min_tracked_exit: int = 10
    tri_min_neighbors_px: float = 20.0
    tri_max_neighbors_px: float = 500.0
    tri_num_neighbors: int = 11
    max_triangulation_candidates: int = 128
    ba_cg_iters: int = 16

    @property
    def klt_config(self) -> klt.KLTConfig:
        return klt.KLTConfig(win=self.klt_win, max_level=self.klt_levels - 1,
                             max_iters=self.klt_iters,
                             epsilon=self.klt_epsilon,
                             min_eig_threshold=self.klt_min_eig)


class SlamState(NamedTuple):
    slot_used: torch.Tensor     # [P] bool
    track_id: torch.Tensor      # [P] int32
    has_3d: torch.Tensor        # [P] bool
    positions: torch.Tensor     # [P, 3]
    keypoints: torch.Tensor     # [P, 2]
    status: torch.Tensor        # [P] int32
    Tcw: se3.SE3
    frame_id: torch.Tensor      # int32 scalar
    deformation_mag: torch.Tensor
    refs: klt.KLTRefs
    graph: graph_mod.GraphState
    kf_valid: torch.Tensor      # [K]
    kf_id: torch.Tensor         # [K] int32
    kf_pose: se3.SE3            # [K]
    kf_keypoints: torch.Tensor  # [K, P, 2]
    kf_obs: torch.Tensor        # [K, P] bool
    kf_positions: torch.Tensor  # [K, P, 3]
    kf_next: torch.Tensor       # int32 ring head
    tb_valid: torch.Tensor      # [T]
    tb_frame_id: torch.Tensor   # [T] int32
    tb_pose: se3.SE3            # [T]
    tb_keypoints: torch.Tensor  # [T, P, 2]
    tb_tracked: torch.Tensor    # [T, P] bool
    tb_with3d: torch.Tensor     # [T, P] bool
    tb_positions: torch.Tensor  # [T, P, 3]
    tb_def_mag: torch.Tensor    # [T]
    scale: torch.Tensor
    next_track_id: torch.Tensor
    motion_model: se3.SE3
    lost: torch.Tensor          # bool scalar collapse latch


def empty_state(config: Config, image_shape, device=None,
                rows: graph_mod.Rows = graph_mod.ALL) -> SlamState:
    """On the card unless ``device`` says otherwise (``utils.device``);
    the graph holds ``rows`` (all P by default: a rank of a sharded run
    holds its P / n)."""
    device = resolve(device)
    P = config.max_points
    K = config.max_keyframes
    T = config.temporal_window
    L = config.klt_levels
    W = config.klt_win
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    refs = klt.KLTRefs(points=zeros(P, 2), patch=zeros(P, L, W, W),
                       patch_grad=zeros(P, L, W, W, 2), mean_i=zeros(P, L),
                       mean_i2=full((P, L), 1.0, f32),
                       valid=zeros(P, L, dtype=torch.bool))
    return SlamState(
        slot_used=zeros(P, dtype=torch.bool),
        track_id=full((P,), -1, i32),
        has_3d=zeros(P, dtype=torch.bool),
        positions=zeros(P, 3),
        keypoints=zeros(P, 2),
        status=full((P,), NOT_IN_FRAME, i32),
        Tcw=se3.identity(device=device),
        frame_id=zeros(dtype=i32),
        deformation_mag=zeros(),
        refs=refs,
        graph=graph_mod.empty(P, config.graph_sigma, device=device,
                              rows=rows),
        kf_valid=zeros(K, dtype=torch.bool),
        kf_id=full((K,), -1, i32),
        kf_pose=se3.identity((K,), device=device),
        kf_keypoints=zeros(K, P, 2),
        kf_obs=zeros(K, P, dtype=torch.bool),
        kf_positions=zeros(K, P, 3),
        kf_next=zeros(dtype=i32),
        tb_valid=zeros(T, dtype=torch.bool),
        tb_frame_id=full((T,), -1, i32),
        tb_pose=se3.identity((T,), device=device),
        tb_keypoints=zeros(T, P, 2),
        tb_tracked=zeros(T, P, dtype=torch.bool),
        tb_with3d=zeros(T, P, dtype=torch.bool),
        tb_positions=zeros(T, P, 3),
        tb_def_mag=zeros(T),
        scale=full((), 1.0, f32),
        next_track_id=zeros(dtype=i32),
        motion_model=se3.identity(device=device),
        lost=zeros(dtype=torch.bool),
    )


def tracked_with_3d(state: SlamState):
    return state.slot_used & (state.status == klt.TRACKED_WITH_3D)


def set_row(arr, slot, value):
    """``arr`` with row ``slot`` (a device scalar) replaced by ``value``."""
    rows = torch.arange(arr.shape[0], device=arr.device) == slot
    rows = rows.reshape((-1,) + (1,) * (arr.dim() - 1))
    return torch.where(rows, value.to(arr.dtype).unsqueeze(0), arr)


def insert_temporal_snapshot(state: SlamState) -> SlamState:
    """Snapshot the tracked slots into ring slot frame_id % T and bump the
    frame id (map.cc:106-118, temporal_buffer.cc:28-56)."""
    T = state.tb_valid.shape[0]
    slot = torch.remainder(state.frame_id, T)
    tracked = state.slot_used & ((state.status == klt.TRACKED)
                                 | (state.status == klt.TRACKED_WITH_3D))
    with3d = tracked_with_3d(state)
    true = torch.ones((), dtype=torch.bool, device=slot.device)
    return state._replace(
        tb_valid=set_row(state.tb_valid, slot, true),
        tb_frame_id=set_row(state.tb_frame_id, slot, state.frame_id),
        tb_pose=se3.SE3(set_row(state.tb_pose.q, slot, state.Tcw.q),
                        set_row(state.tb_pose.t, slot, state.Tcw.t)),
        tb_keypoints=set_row(state.tb_keypoints, slot, state.keypoints),
        tb_tracked=set_row(state.tb_tracked, slot, tracked),
        tb_with3d=set_row(state.tb_with3d, slot, with3d),
        tb_positions=set_row(state.tb_positions, slot, state.positions),
        tb_def_mag=set_row(state.tb_def_mag, slot, state.deformation_mag),
        frame_id=state.frame_id + 1,
    )


def insert_keyframe(state: SlamState, cols: slice = slice(0, None)
                    ) -> SlamState:
    """KeyFrame creation from the current frame (keyframe.cc:26-55). The
    ring's ``[K, P, ...]`` leaves hold the slot columns ``cols`` (all of
    them in one process; a rank of the point-sharded frame holds its
    block)."""
    K = state.kf_valid.shape[0]
    slot = torch.remainder(state.kf_next, K)
    true = torch.ones((), dtype=torch.bool, device=slot.device)
    return state._replace(
        kf_valid=set_row(state.kf_valid, slot, true),
        kf_id=set_row(state.kf_id, slot, state.frame_id),
        kf_pose=se3.SE3(set_row(state.kf_pose.q, slot, state.Tcw.q),
                        set_row(state.kf_pose.t, slot, state.Tcw.t)),
        kf_keypoints=set_row(state.kf_keypoints, slot,
                             state.keypoints[cols]),
        kf_obs=set_row(state.kf_obs, slot, tracked_with_3d(state)[cols]),
        kf_positions=set_row(state.kf_positions, slot,
                             state.positions[cols]),
        kf_next=state.kf_next + 1,
    )


def take(x, i):
    """``x[i]`` for a device scalar index without reading it on the host
    (indexing with a 0-d tensor would call ``.item()``)."""
    return x[i.reshape(1)][0]


def argsort_stable(key):
    """jnp.argsort order (stable, ascending)."""
    return torch.sort(key, stable=True).indices


def top_k_stable(x, k: int):
    """jax.lax.top_k order: largest first, ties lowest index first."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def chronological_temporal_order(state: SlamState):
    """Ring indices sorted oldest -> newest (invalid slots last)."""
    key = torch.where(state.tb_valid, state.tb_frame_id,
                      torch.full_like(state.tb_frame_id, 2 ** 30))
    return argsort_stable(key)


def allocate_slots(state: SlamState, n: int):
    """Up to n free slot indices (free = unused), lowest index first."""
    free = ~state.slot_used
    _, idx = top_k_stable(free.to(torch.float32), n)
    return idx, free[idx]
