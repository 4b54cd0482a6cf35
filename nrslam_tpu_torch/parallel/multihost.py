"""Process-group bring-up and host-local feeding of a sharded run
(counterpart of nrslam_tpu/parallel/multihost.py).

Nothing here tells a program of a cluster: the caller gives the rendezvous
(an ``init_method`` URL such as ``tcp://host:port`` or ``file://path``, or a
``torch.distributed`` store), the world size, its rank and the backend.
The backend is the caller's choice and nothing falls back: ``gloo`` where
ranks share a device (or run on the CPU), ``nccl`` where each rank owns a
card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nrslam_tpu_torch.parallel import sharding
from nrslam_tpu_torch.parallel.sharding import Mesh


def initialize(backend: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               init_method: Optional[str] = None, store=None) -> bool:
    """``torch.distributed.init_process_group``; a no-op (False) for one
    process. Several processes need an explicit ``backend``."""
    if world_size is None or world_size <= 1:
        return False
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank)
    return True


def global_mesh(device=None, axis: str = "pt") -> Mesh:
    """The mesh over every rank of the default group (one rank without
    one), with this rank's tensors on ``device``."""
    return sharding.make_mesh(device, axis)


def replicate_frame(mesh: Mesh, frame_np) -> torch.Tensor:
    """A frame every rank read for itself, on this rank's device, checked
    to be the same frame on every rank (single-camera SLAM: each rank
    tracks its points in the same image)."""
    frame = torch.as_tensor(np.asarray(frame_np)).to(mesh.device)
    if not sharding.same_on_ranks(mesh, frame):
        raise ValueError("the ranks were fed different frames")
    return frame


def shard_points(mesh: Mesh, arr_np, axis: int = 0) -> torch.Tensor:
    """This rank's host-local shard of a point-axis array, on its device;
    every rank's shard must have the same extent along ``axis``."""
    shard = torch.as_tensor(np.asarray(arr_np)).to(mesh.device)
    if not sharding.same_on_ranks(
            mesh, torch.tensor([shard.shape[axis]], device=mesh.device)):
        raise ValueError("the ranks were fed different shard sizes")
    return shard
