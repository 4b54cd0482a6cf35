"""The SLAM state sharded over the landmark-slot axis across the ranks of a
``torch.distributed`` process group (counterpart of
nrslam_tpu/parallel/sharding.py).

``shard_state`` gives each rank a contiguous block of ``P / n`` landmark
slots of every array whose extent along some axis is ``max_points`` (the
first such axis: ``[P, P]`` graph matrices shard by rows, the keyframe and
temporal rings ``[K, P, ...]`` / ``[T, P, ...]`` along their point axis);
everything else (poses, ring heads, scalars) is replicated. ``place``
takes any other placement (the sharded frame keeps its temporal ring
replicated: ``tracking_shard.state_axes``). Eager PyTorch has no SPMD
partitioner, so the collectives are explicit (``tracking_shard``,
``ba_shard``); ``MeshRows`` is the rank's block of graph rows for the
row-block graph, tracking and mapping functions (``slam.graph.Rows``).

Every collective here is an ``all_reduce``: a gather is the SUM of a
zero-filled buffer with one block per rank, a halo exchange is a gather
read at the neighbour's block. PyTorch's gloo backend runs only
``broadcast`` and ``all_reduce`` on CUDA tensors, so the one code path
serves gloo on CPU tensors (the tests), gloo with several ranks sharing one
card, and NCCL with one card per rank. Summing zeros into a value is exact,
so a gather returns every block bit for bit. Without a process group (a
single process) every collective is the identity.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.solver import pose_only
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.device import resolve
from nrslam_tpu_torch.utils.tree import tree_map


class Mesh(NamedTuple):
    """This process's place in a 1-D mesh of ranks: its rank, the number of
    ranks, the process group (None: a single process, no collectives), the
    device its tensors live on and the mesh axis's name."""

    rank: int
    world_size: int
    group: Optional[object]
    device: torch.device
    axis: str = "pt"


def make_mesh(device=None, axis: str = "pt", group=None) -> Mesh:
    """The mesh over ``group`` (the default group where one is initialised,
    else a single process) with this rank's tensors on ``device`` (the
    card unless told otherwise, ``utils.device``)."""
    device = resolve(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(0, 1, None, device, axis)
    return Mesh(dist.get_rank(group), dist.get_world_size(group), group,
                device, axis)


# ---------------------------------------------------------------------------
# Collectives (all_reduce only)
# ---------------------------------------------------------------------------

# The shares the collectives in flight also count under (``share``).
_shares = []


def _tally(x) -> None:
    """Tally one collective's payload ``x`` (``utils.profiler``): one
    payload and its bytes (the buffer each rank hands to the collective; a
    ring all-reduce moves about twice that per rank) under ``collectives``
    and each share in flight, its elements in ``collectives.largest``."""
    nbytes = x.numel() * x.element_size()
    for name in ("collectives", *_shares):
        profiler.tally(f"{name}.payloads")
        profiler.tally(f"{name}.bytes", nbytes)
    profiler.tally_max("collectives.largest", x.numel())


@contextlib.contextmanager
def share(name: str):
    """The block's collectives also tallied as ``<name>.payloads`` and
    ``<name>.bytes``."""
    _shares.append(name)
    try:
        yield
    finally:
        _shares.pop()


def _wire(x):
    """``x`` in a dtype every backend reduces (bool travels as uint8)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _all_reduce_packed(mesh: Mesh, tensors, op):
    """One ``all_reduce`` per dtype over the flattened ``tensors``."""
    tensors = list(tensors)
    if mesh.group is None:
        return tensors
    out = [None] * len(tensors)
    by_dtype = {}
    for k, x in enumerate(tensors):
        by_dtype.setdefault(_wire(x).dtype, []).append(k)
    for ks in by_dtype.values():
        flat = torch.cat([_wire(tensors[k]).reshape(-1) for k in ks])
        _tally(flat)
        dist.all_reduce(flat, op=op, group=mesh.group)
        for k, part in zip(ks, torch.split(
                flat, [tensors[k].numel() for k in ks])):
            out[k] = part.reshape(tensors[k].shape).to(tensors[k].dtype)
    return out


def all_reduce_sum(mesh: Mesh, *tensors):
    """Each tensor summed over the ranks (one collective per dtype)."""
    return tuple(_all_reduce_packed(mesh, tensors, dist.ReduceOp.SUM))


def all_reduce_max(mesh: Mesh, *tensors):
    """Each tensor's elementwise maximum over the ranks."""
    return tuple(_all_reduce_packed(mesh, tensors, dist.ReduceOp.MAX))


def all_gather_rows(mesh: Mesh, tensors, dims=None):
    """Every rank's block of each tensor, concatenated in rank order along
    its ``dims`` entry (default 0): one SUM of a zero-filled buffer per
    dtype. The blocks must have equal extents."""
    tensors = list(tensors)
    dims = [0] * len(tensors) if dims is None else list(dims)
    if mesh.group is None:
        return tensors
    bufs = []
    for x, d in zip(tensors, dims):
        m = x.shape[d]
        shape = list(x.shape)
        shape[d] = m * mesh.world_size
        buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
        buf.narrow(d, mesh.rank * m, m).copy_(x)
        bufs.append(buf)
    return _all_reduce_packed(mesh, bufs, dist.ReduceOp.SUM)


def all_reduce_(mesh: Mesh, buf):
    """``buf`` summed over the ranks in place (one collective; the kernel
    routes of the sharded solves reduce their packed buffers with it).
    Returns ``buf``."""
    if mesh.group is not None:
        _tally(buf)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def block_and_sums(mesh: Mesh, block, sums, extent: int):
    """One collective that gathers and reduces at once: this rank's
    ``block`` [m, w] lands at its ``rank_block`` rows of a zero-filled
    [extent, w] buffer, followed by its partial ``sums`` [s]; the SUM over
    the ranks gives every rank the whole [extent, w] array (zeros added,
    so every block bit for bit) and the summed [s]."""
    b = rank_block(mesh, extent)
    w = block.shape[1]
    buf = torch.zeros(extent * w + sums.numel(), dtype=block.dtype,
                      device=block.device)
    buf[b.start * w:b.stop * w] = block.reshape(-1)
    buf[extent * w:] = sums.reshape(-1)
    all_reduce_(mesh, buf)
    return buf[:extent * w].reshape(extent, w), buf[extent * w:]


def rank_ends(mesh: Mesh, i, j, live, extent: int):
    """This rank's edge-ends: (ptr [m + 1], edge [2E], sign [2E]) with
    ``pose_deformation_cuda.incidence_csr``'s edge and sign rows and its
    pointer row restricted to the rank's ``rank_block`` of points, so the
    ends of local point l sit at positions [ptr[l], ptr[l + 1]) (global
    positions, each point's live incident edges in edge order, +1 where
    the point is the edge's i). The rank is to the world what a block is
    to the cluster kernel (``cluster_layout``)."""
    from nrslam_tpu_torch.solver.pose_deformation_cuda import incidence_csr

    ptr, edge, sign = incidence_csr(i, j, live, extent)
    b = rank_block(mesh, extent)
    return ptr[b.start:b.stop + 1], edge, sign


def rank_block(mesh: Mesh, extent: int) -> slice:
    """This rank's contiguous block of an axis of ``extent``: ``[rank * m,
    (rank + 1) * m)``, m = extent / n (the layout of every sharded axis)."""
    m = extent // mesh.world_size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


class MeshRows(graph_mod.Rows):
    """This rank's block of the graph's rows (``rank_block``): row results
    are gathered (``all_gather_rows``), hit counts MAX-reduced, and an axis
    of any length shared out in contiguous blocks of ``ceil(N / n)``."""

    def __init__(self, mesh: Mesh, max_points: int):
        super().__init__(rank_block(mesh, max_points))
        self.mesh = mesh

    def gather(self, *blocks):
        return tuple(all_gather_rows(self.mesh, blocks))

    def gather_columns(self, *blocks):
        # One gather: each [W, m, ...] block as float32 rows [m, W * d],
        # side by side; bool comes back as > 0.
        W, m = blocks[0].shape[:2]
        flat = [b.reshape(W, m, -1).to(torch.float32) for b in blocks]
        widths = [f.shape[-1] for f in flat]
        (whole,) = self.gather(torch.cat(flat, dim=-1).transpose(0, 1)
                               .reshape(m, -1))
        parts = torch.split(whole.reshape(whole.shape[0], W, -1)
                            .transpose(0, 1), widths, dim=-1)
        return tuple(
            (p > 0 if b.dtype == torch.bool else p.to(b.dtype))
            .reshape(W, -1, *b.shape[2:]).contiguous()
            for p, b in zip(parts, blocks))

    def reduce_max(self, x):
        return all_reduce_max(self.mesh, x)[0]

    def share(self, x):
        size = -(-x.shape[0] // self.mesh.world_size)
        start = self.mesh.rank * size
        idx = torch.arange(start, start + size, device=x.device)
        return x[torch.clamp(idx, max=x.shape[0] - 1)]


def extremes(mesh: Mesh, x):
    """[2, ...]: each element's largest value over the ranks and the
    negated smallest (one MAX of (x, -x)), the device half of
    ``same_on_ranks``: no host read, so a CUDA graph can capture it."""
    v = x.to(torch.float64 if x.is_floating_point() else torch.int64)
    return all_reduce_max(mesh, torch.stack([v, -v]))[0]


def agree(ext) -> bool:
    """The host half of ``same_on_ranks``: whether ``extremes``' largest
    and smallest values are equal everywhere. Every rank holds the same
    ``ext``, so every rank reads the same answer."""
    return bool(torch.equal(ext[0], -ext[1]))


def same_on_ranks(mesh: Mesh, x) -> bool:
    """Whether every rank holds the same ``x``."""
    return agree(extremes(mesh, x))


def digest(tree):
    """[L] int64: a checksum of the bytes of each tensor leaf of ``tree``,
    each byte weighted by its position (so a permutation changes it). The
    sharded frame compares it across ranks over the leaves every rank holds
    the same (``same_on_ranks``): not the graph's rows nor the keyframe
    ring's columns, which differ between ranks by design."""
    sums = []

    def add(x):
        if isinstance(x, torch.Tensor):
            b = x.reshape(-1).contiguous().view(torch.uint8).to(torch.int64)
            w = torch.arange(b.numel(), device=b.device) % 65521 + 1
            sums.append(torch.sum(b * w))
        return x

    tree_map(add, tree)
    return torch.stack(sums)


def _blocks(mesh: Mesh, x):
    """[n, ...]: every rank's ``x``."""
    return all_gather_rows(mesh, [x[None]])[0]


def recv_next(mesh: Mesh, x):
    """Rank b gets rank b+1's ``x``; the last rank gets zeros (JAX
    ``_perm_recv_next``)."""
    if mesh.group is None or mesh.rank == mesh.world_size - 1:
        _blocks(mesh, x)  # every rank takes part in the collective
        return torch.zeros_like(x)
    return _blocks(mesh, x)[mesh.rank + 1]


def send_next(mesh: Mesh, x):
    """Rank b's ``x`` lands on rank b+1; rank 0 gets zeros (JAX
    ``_perm_send_next``)."""
    if mesh.group is None or mesh.rank == 0:
        _blocks(mesh, x)
        return torch.zeros_like(x)
    return _blocks(mesh, x)[mesh.rank - 1]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _spec_for(shape, max_points: int) -> Optional[int]:
    """The axis sharded over the mesh: the first whose extent is
    ``max_points`` (None: replicated)."""
    for d, n in enumerate(shape):
        if n == max_points:
            return d
    return None


def local_block(mesh: Mesh, x, d: int):
    """This rank's block of ``x`` along axis ``d`` (``rank_block``)."""
    b = rank_block(mesh, x.shape[d])
    return x.narrow(d, b.start, b.stop - b.start)


def place(state, mesh: Mesh, axes):
    """This rank's block of every tensor leaf of ``state`` (any tree) along
    its ``axes`` entry (``rank_block``; None: replicated), on the mesh's
    device, copies that own their memory (the whole arrays can be
    freed)."""
    def put(x, d):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.to(mesh.device)
        return x if d is None else local_block(mesh, x, d).clone(
            memory_format=torch.contiguous_format)

    return tree_map(put, state, axes)


def shard_state(state, mesh: Mesh, max_points: int):
    """This rank's contiguous ``P / n`` slots of every point-axis array of
    ``state`` (any tree; ``point_axes``), the rest replicated: the JAX
    package's ``shard_state`` placement (``place``)."""
    if max_points % mesh.world_size:
        raise ValueError(f"max_points={max_points} does not split over "
                         f"{mesh.world_size} ranks")
    return place(state, mesh, point_axes(state, max_points))


def point_axes(state, max_points: int):
    """The tree of ``state``'s sharded axes (an int, or None where the leaf
    is replicated), read off the full shapes. A shard's own shapes cannot
    say it: a replicated ``[K]`` ring has the extent of a ``P / n`` block
    when K = P / n."""
    return tree_map(lambda x: _spec_for(x.shape, max_points)
                    if isinstance(x, torch.Tensor) else None, state)


def unshard_state(local_state, mesh: Mesh, axes):
    """The whole state from every rank's shard (``shard_state``'s inverse,
    ``axes`` from ``point_axes`` of the full state): the point-axis arrays
    gathered, the rest as this rank holds them."""
    leaves, dims = [], []

    def collect(x, d):
        if isinstance(x, torch.Tensor) and d is not None:
            leaves.append(x)
            dims.append(d)
        return x

    tree_map(collect, local_state, axes)
    gathered = iter(all_gather_rows(mesh, leaves, dims))
    return tree_map(lambda x, d: next(gathered)
                    if isinstance(x, torch.Tensor) and d is not None else x,
                    local_state, axes)


def replicate(tree, mesh: Mesh):
    """Every leaf on the mesh's device (each rank holds all of it)."""
    return tree_map(lambda x: torch.as_tensor(x).to(mesh.device)
                    if x is not None and not isinstance(x, str) else x, tree)


# ---------------------------------------------------------------------------
# The pose normal equations over point shards
# ---------------------------------------------------------------------------

def pose_system_sharded(mesh: Mesh, cam: cameras.Camera):
    """``fn(q, t, X, obs, w) -> (H [6, 6], g [6], chi2)``: each rank's
    partial normal equations of the unary reprojection edges over its point
    shard (Huber 5.99 IRLS, ``pose_only._pose_system``), then one
    ``all_reduce`` gives every rank the global system (JAX
    ``pose_system_shard_map``)."""
    def fn(q, t, X, obs, w):
        H, g, total, _ = pose_only._pose_system(cam, se3.SE3(q, t), X, obs,
                                                w)
        return all_reduce_sum(mesh, H, g, total)

    return fn
