"""The point-sharded frame captured as one CUDA graph per frame kind on an
NCCL process group: the counterpart of the JAX package's jitted SPMD frame
step (nrslam_tpu/slam/system.py::_fused_frame_impl on a ``pt``-sharded
state, where XLA partitions the frame and inserts its all-gathers and
psums into one program, nrslam_tpu/parallel/sharding.py).

``ShardFrameGraph`` captures ``tracking_shard.frame_step_unchecked`` once
with ``make_keyframe`` False and once with it True (``frame_graph
.KindGraphs``: each in a ``torch.cuda.CUDAGraph`` with its own pool, over
the rank's packed shard, ``FrameResult`` and checksum extremes, the frame
and the mask). Everything a rank runs in a frame goes into the graph: the
plain ops, the partitioned solves' phase kernels with their
``all_reduce``s, the frame's gathers and the row-sharded graph's and
mapping's collectives. ``step`` replays one graph and then compares the
ranks' checksums on the host (``tracking_shard.check_agreed``), which
capture forbids inside the graph: it raises on every rank where they
differ.

Every rank must build its graphs at the same point (they capture in the
same order) and replay the same kind for the same frame: each replay runs
the captured collectives, which pair up across ranks in order. NCCL only:
gloo's collectives run on the host and cannot be captured, and one
process (no group) has ``system.frame_step``'s ``FrameGraph``. A capture
or a replay that fails raises; nothing falls back to the eager sharded
frame.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.parallel import tracking_shard
from nrslam_tpu_torch.parallel.sharding import Mesh
from nrslam_tpu_torch.slam import frame_graph
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils import tree


def check_collective_capture(mesh: Mesh) -> float:
    """Capture a doubling and one ``all_reduce`` on the mesh's group in a
    CUDA graph and replay it: the check that this torch and NCCL capture
    collectives. The communicator is made first by an eager
    ``all_reduce`` (a capture cannot make it). Rank r holds r + 1 before
    the replay, so every element holds n (n + 1) after it over n ranks
    (at world size 1 NCCL's in-place ``all_reduce`` launches nothing, and
    the doubling is what the replay shows). Returns that value; raises if
    the capture or the replay fails or the value is wrong."""
    dev = mesh.device
    warm = torch.zeros(1, device=dev)
    dist.all_reduce(warm, group=mesh.group)
    torch.cuda.synchronize(dev)
    x = torch.zeros(4, device=dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph,
                              capture_error_mode=ShardFrameGraph.capture_mode):
            x.mul_(2.0)
            dist.all_reduce(x, group=mesh.group)
        x.fill_(mesh.rank + 1.0)
        graph.replay()
        torch.cuda.synchronize(dev)
    except RuntimeError as e:
        raise RuntimeError(f"ShardFrameGraph: an all_reduce on "
                           f"{dist.get_backend(mesh.group)} cannot be "
                           f"captured and replayed: {e}") from e
    n = mesh.world_size
    want = float(n * (n + 1))
    if not torch.equal(x, torch.full_like(x, want)):
        raise RuntimeError(f"ShardFrameGraph: a replayed all_reduce gave "
                           f"{x.tolist()}, expected {want}")
    return want


class ShardFrameGraph(frame_graph.KindGraphs):
    """Both kinds of the point-sharded frame captured on this rank over
    static buffers; ``step`` replays one. Built on every rank at once from
    the rank's shard of the first steady state (``tracking_shard
    .shard_state``), the frame's ``gray`` and ``mask``, the camera, the
    config and a ``Mesh`` whose group is NCCL, which the graphs keep.
    Readings as ``frame_graph.KindGraphs``."""

    # A capture on the main thread tolerates the NCCL watchdog thread's
    # CUDA calls in the same process.
    capture_mode = "thread_local"

    def __init__(self, local_state, gray, mask, cam: cameras.Camera,
                 config: Config, mesh: Mesh):
        self.cam, self.config, self.mesh = cam, config, mesh
        n_checked = len(tree.leaves(tracking_shard.checked_leaves(
            local_state)))
        check = torch.zeros((2, n_checked), dtype=torch.int64,
                            device=gray.device)
        super().__init__(
            (local_state, frame_graph.result_like(local_state), check),
            gray, mask)

    def _check(self) -> None:
        """Raise, naming every reason, unless the mesh has an NCCL group
        and every input lies on the mesh's CUDA device."""
        why = []
        if self.mesh.group is None:
            why.append("a mesh with no process group (one process steps "
                       "slam.frame_graph.FrameGraph)")
        elif dist.get_backend(self.mesh.group) != "nccl":
            why.append(f"a {dist.get_backend(self.mesh.group)} group "
                       "(only NCCL collectives can be captured)")
        dev = torch.device(self.mesh.device)
        for x in (self.buf, self.gray, self.mask, self.cam.params):
            if x.device.type != "cuda" or x.device != dev:
                why.append(f"a tensor on {x.device}, expected CUDA tensors "
                           f"on the mesh's device {dev} (the CPU runs "
                           "tracking_shard.frame_step_sharded)")
                break
        if why:
            raise ValueError("ShardFrameGraph: " + "; ".join(why))
        check_collective_capture(self.mesh)

    def _body(self, views, kf: bool) -> None:
        tracking_shard.body(self.mesh, views[0], self.gray, self.mask,
                            self.cam, self.config, kf, views)

    def _capture(self, kf: bool):
        try:
            return super()._capture(kf)
        except RuntimeError as e:
            kind = "keyframe" if kf else "non-keyframe"
            raise RuntimeError(f"ShardFrameGraph: the {kind} cannot be "
                               f"captured: {e}") from e

    def step(self, local_state, gray, mask, make_keyframe: bool):
        """``tracking_shard.frame_step_sharded(mesh, local_state, gray,
        mask, cam, config, make_keyframe)`` by replay: the same kind on
        every rank. Returns (the rank's shard of the new state,
        FrameResult), a snapshot that no later step writes into; raises on
        every rank when the ranks' checksums differ."""
        new, result, check = self._replay(local_state, gray, mask,
                                          make_keyframe)
        tracking_shard.check_agreed(check)
        return new, result
