"""One steady-state SLAM frame on a state sharded over the landmark slots
(the counterpart of running the JAX package's ``_process_frame_impl`` /
``_fused_frame_impl`` on a ``pt``-sharded state, where XLA inserts the
collectives; here they are explicit).

Between frames each rank holds (``state_axes``, ``shard_state``) its
contiguous ``P / n`` slots of every ``[P]`` array, its ``[P / n, P]`` rows
of the deformation graph, its ``[K, P / n]`` columns of the keyframe ring
and the KLT references of its slots; the temporal ring ``[T, P]`` is
replicated (every rank writes the same snapshot from the gathered ``[P]``
arrays), as are poses, ring heads and scalars. Per frame, on every rank:

1. the pyramid of the (replicated) frame;
2. point-parallel over the rank's own slots: the promotion of
   just-triangulated points and the KLT data association;
3. one gather of the state's ``[P]`` arrays (``gather_axes``); the graph,
   the keyframe ring and the KLT references never leave their rank;
4. ``tracking.track_camera_and_deformation`` on the gathered arrays with the
   rank's graph rows (``sharding.MeshRows``): the neighbour table's top-k
   on the rank's rows, gathered to ``[P, k]``; the pose-only and joint
   solves partitioned over the ranks' slot blocks
   (``solve_shard.mesh_solves``: each rank solves for its ``P / n``
   points and their edge-ends, the pose and the LM and CG scalars from
   all-reduced sums; on the card the sharded phase kernels, never the
   whole-solver ones); the graph update and the ``starved`` test on the
   rank's rows, ``starved`` gathered; the lost-point drag;
5. point reuse's KLT on the rank's slots, and one gather of the keypoints
   and statuses it changed;
6. on keyframes the new features (dropping the recycled slots' edges from
   the rank's rows) and the keyframe snapshot of the rank's columns; the
   temporal snapshot and the LOST latch; the mapping: the triangulation's
   neighbour search and rigid path on the rank's slots (gathered), the
   deformable path on the rank's ``C / n`` block of the candidates
   (gathered), both reading the replicated temporal ring, the vote
   replicated and the new edges on the rank's rows; on keyframes the
   window's copies and masks gathered once, the neighbour table on the
   rank's rows (gathered) and the window BA partitioned over the ranks'
   slot blocks (``ba_points``; on the card the phase kernels of
   csrc/bundle_adjustment_shard.cu), which gives every rank the whole
   solved copies: the rank keeps its columns, the newest keyframe's copies
   refresh the ``[P]`` positions;
7. a checksum of every leaf all ranks hold the same (``sharding.digest``:
   pose, the gathered ``[P]`` arrays, the temporal ring, the keyframe
   ring's poses and heads) compared across ranks; every rank raises if
   they differ. The graph rows and keyframe ring columns differ between
   ranks by design;
8. the rank's slots of the result, with the KLT references refreshed on
   them on keyframes.

Only ``[P]``, ``[P, k]`` and window (``[W, P, ...]``, once a keyframe)
arrays are gathered; no ``[P, P]`` array is gathered or built whole on a
rank, and a non-keyframe gathers no ring. Ties in the stable top-k and
argsort orders (the triangulation candidates, new slots, the BA window) are
taken on gathered or replicated arrays, and a row's top-k (graph
neighbours, triangulation neighbours) on its whole columns. The pose-only
and joint solves and the window BA are partitioned; they sum in another
order than the whole-solver ones, so a sharded frame agrees with
``system.frame_step`` within float tolerance, not bit for bit; they sum by
chunk of points, so any number of ranks gives the bits of one.
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.parallel import sharding, solve_shard
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.slam import mapping as mapping_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam import tracking
from nrslam_tpu_torch.slam.state import Config, SlamState
from nrslam_tpu_torch.utils import tree
from nrslam_tpu_torch.utils.tree import tree_map


# The payloads of the gather of the state's [P] arrays at the start of
# each frame (``sharding.Traffic``) since its ``reset``.
traffic = sharding.Traffic()

# The keyframe ring's point-axis leaves (a rank keeps its columns) and the
# temporal ring's (replicated in the sharded frame).
KF_RING = ("kf_keypoints", "kf_obs", "kf_positions")
TEMPORAL_RING = ("tb_keypoints", "tb_tracked", "tb_with3d", "tb_positions")


def _frame_placement(axes):
    return axes._replace(**{f: None for f in TEMPORAL_RING})


def state_axes(config: Config, image_shape):
    """The sharded frame's placement of a whole SlamState of this
    configuration, from shapes alone (on the meta device):
    ``sharding.point_axes`` with the temporal ring replicated. An int is
    the axis a leaf shards along, None a replicated leaf."""
    return _frame_placement(sharding.point_axes(
        state_mod.empty_state(config, image_shape, "meta"),
        config.max_points))


def gather_axes(config: Config, image_shape):
    """``state_axes`` of the leaves a frame gathers (its ``[P]`` arrays):
    not the KLT references, the graph or the keyframe ring, which stay on
    their rank."""
    return state_axes(config, image_shape)._replace(
        refs=None, graph=None, **{f: None for f in KF_RING})


def shard_state(state, mesh: Mesh, config: Config):
    """This rank's shard of a whole SlamState in the sharded frame's
    placement (``state_axes``; ``sharding.unshard_state`` with those axes
    is its inverse). A state without its graph (None) is placed without
    it."""
    P = config.max_points
    if P % mesh.world_size:
        raise ValueError(f"max_points={P} does not split over "
                         f"{mesh.world_size} ranks")
    return sharding.place(state, mesh, _frame_placement(
        sharding.point_axes(state, P)))


def _slots(mesh: Mesh, full, axes):
    """This rank's block of every leaf of ``full`` that ``axes`` shards
    (copies, so the gathered arrays are freed); the rest as ``full`` holds
    it (the graph holds the rank's rows already)."""
    mine = tree_map(lambda x, d: x if d is None or x is None
                    else sharding.local_block(mesh, x, d).clone(
                        memory_format=torch.contiguous_format),
                    full._replace(graph=None), axes)
    return mine._replace(graph=full.graph)


def frame_step_sharded(mesh: Mesh, local_state: SlamState, gray, mask,
                       cam: cameras.Camera, config: Config,
                       make_kf: bool):
    """``slam.system.frame_step`` on this rank's shard of the state
    (``shard_state``: the graph's leaves are the rank's ``[P / n, P]``
    rows, the keyframe ring's its ``[K, P / n]`` columns). Returns (the
    rank's shard of the new state, the frame's ``tracking.FrameResult``,
    the same on every rank)."""
    axes = gather_axes(config, tuple(gray.shape))
    solves = solve_shard.mesh_solves(mesh)
    rows = sharding.MeshRows(mesh, config.max_points)
    old = local_state
    pyramid = klt.build_pyramid(gray, config.klt_config)

    s = tracking.update_triangulated_points(local_state)
    s = tracking.data_association(s, pyramid, config)

    refs = s.refs
    count, nbytes = sharding.traffic.count, sharding.traffic.bytes
    full = sharding.unshard_state(s._replace(refs=None, graph=None), mesh,
                                  axes)._replace(graph=s.graph)
    traffic.count += sharding.traffic.count - count
    traffic.bytes += sharding.traffic.bytes - nbytes
    full = tracking.track_camera_and_deformation(full, cam, config, rows,
                                                 solves)

    mine = _slots(mesh, full, axes)._replace(refs=refs)
    mine = tracking.point_reuse(mine, pyramid, cam, config)
    keypoints, status = sharding.all_gather_rows(
        mesh, [mine.keypoints, mine.status])
    full = full._replace(keypoints=keypoints, status=status)

    n3d = torch.sum(state_mod.tracked_with_3d(full).to(torch.int32),
                    dtype=torch.int32)
    if make_kf:
        full = tracking.add_keyframe_features(full, pyramid, mask, config,
                                              rows)
    full = state_mod.insert_temporal_snapshot(full)
    lost = full.lost | (n3d < config.min_tracked_exit)
    full = mapping_mod.do_mapping(full._replace(lost=lost), cam, config,
                                  make_kf, rows, solves)
    if not sharding.same_on_ranks(mesh, sharding.digest(full._replace(
            graph=None, **{f: None for f in KF_RING}))):
        raise RuntimeError("the ranks computed different states from the "
                           "same gathered arrays")

    new = _slots(mesh, full, axes)._replace(refs=refs)
    if make_kf:
        new = tracking.refresh_reference(new, pyramid, mask, config)
    new = tree.where(old.lost, old, new)
    result = tracking.FrameResult(
        n_tracked_3d=torch.where(old.lost, torch.zeros_like(n3d), n3d),
        lost=old.lost | lost)
    return new, result
