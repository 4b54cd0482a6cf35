"""One steady-state SLAM frame on a state sharded over the landmark slots
(the counterpart of running the JAX package's ``_process_frame_impl`` /
``_fused_frame_impl`` on a ``pt``-sharded state, where XLA inserts the
collectives; here they are explicit).

Per frame, on every rank:

1. the pyramid of the (replicated) frame;
2. point-parallel over the rank's own slots: the promotion of
   just-triangulated points and the KLT data association;
3. one gather of the state's point-axis arrays (all but the KLT
   references, which never leave their rank), then on the gathered arrays
   ``tracking.track_camera_and_deformation``: the pose-only LM and the
   joint pose+deformation solve (on the card, the pose-only and the joint
   kernel on every rank), the graph update and the lost-point drag;
4. point reuse's KLT, point-parallel again on the rank's rows, and one
   gather of the keypoints and statuses it changed;
5. on the gathered arrays: on keyframes the new features and the keyframe
   snapshot, the temporal snapshot, the LOST latch and the mapping
   (triangulation; on keyframes the window BA, on the card the BA kernel on
   every rank). Every rank runs the same code on the same bits, so every
   rank must end with the same state: a checksum of each rank's
   (``sharding.digest``) is compared across ranks, and every rank raises
   if they differ;
6. the rank's rows of the result, with the KLT references refreshed on its
   own slots on keyframes.

Ties in the stable top-k and argsort orders (graph neighbours, new slots,
triangulation candidates) are taken on the gathered arrays, never per
shard. The pose-only and joint solves and the graph stay replicated:
row-sharding them is later work.
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.parallel import sharding
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.slam import mapping as mapping_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam import tracking
from nrslam_tpu_torch.slam.state import Config, SlamState
from nrslam_tpu_torch.utils import tree
from nrslam_tpu_torch.utils.tree import tree_map


def state_axes(config: Config, image_shape):
    """``sharding.point_axes`` of a whole SlamState of this configuration
    (from shapes alone, on the meta device)."""
    return sharding.point_axes(
        state_mod.empty_state(config, image_shape, "meta"), config.max_points)


def _rows(mesh: Mesh, full, axes):
    """This rank's block of every point-axis leaf of ``full``."""
    return tree_map(lambda x, d: x if d is None or x is None
                    else sharding.local_block(mesh, x, d), full, axes)


def frame_step_sharded(mesh: Mesh, local_state: SlamState, gray, mask,
                       cam: cameras.Camera, config: Config,
                       make_kf: bool):
    """``slam.system.frame_step`` on this rank's shard of the state
    (``sharding.shard_state``). Returns (the rank's shard of the new state,
    the frame's ``tracking.FrameResult``, the same on every rank)."""
    axes = state_axes(config, tuple(gray.shape))
    old = local_state
    pyramid = klt.build_pyramid(gray, config.klt_config)

    s = tracking.update_triangulated_points(local_state)
    s = tracking.data_association(s, pyramid, config)

    refs = s.refs
    full = sharding.unshard_state(s._replace(refs=None), mesh,
                                  axes._replace(refs=None))
    full = tracking.track_camera_and_deformation(full, cam, config)

    mine = _rows(mesh, full, axes)._replace(refs=refs)
    mine = tracking.point_reuse(mine, pyramid, cam, config)
    keypoints, status = sharding.all_gather_rows(
        mesh, [mine.keypoints, mine.status])
    full = full._replace(keypoints=keypoints, status=status)

    n3d = torch.sum(state_mod.tracked_with_3d(full).to(torch.int32),
                    dtype=torch.int32)
    if make_kf:
        full = tracking.add_keyframe_features(full, pyramid, mask, config)
    full = state_mod.insert_temporal_snapshot(full)
    lost = full.lost | (n3d < config.min_tracked_exit)
    full = mapping_mod.do_mapping(full._replace(lost=lost), cam, config,
                                  has_new_keyframe=make_kf)
    if not sharding.same_on_ranks(mesh, sharding.digest(full)):
        raise RuntimeError("the ranks computed different states from the "
                           "same gathered arrays")

    new = _rows(mesh, full, axes)._replace(refs=refs)
    if make_kf:
        new = tracking.refresh_reference(new, pyramid, mask, config)
    new = tree.where(old.lost, old, new)
    result = tracking.FrameResult(
        n_tracked_3d=torch.where(old.lost, torch.zeros_like(n3d), n3d),
        lost=old.lost | lost)
    return new, result
