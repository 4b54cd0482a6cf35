"""Wrapper of the joint pose+deformation LM kernel
(csrc/pose_deformation.cu), the counterpart of
nrslam_tpu/solver/pose_deformation_pallas.py.

The wrapper keeps the Pallas wrapper's edge handling: the (already
compacted) edge table is padded to a multiple of 128 with masked edges, the
base pair mask ``valid & point_valid[i] & point_valid[j]`` is formed here and
rest distances are clamped to >= 1e-12. It also builds, once per call and
with device ops only, the kernel's per-block layout (``cluster_layout``):
which points each block of the cluster owns and, through the CSR of each
point's incident live edges, which edge-ends. Post-gates stay in
``pose_deformation.pose_deformation_optimization``.

``prepare`` builds a launch's inputs and layout, ``launch`` runs the kernel
on them (``pose_deformation_cuda`` does both). Takes CUDA tensors only and
raises otherwise, or when the card refuses the cluster; the plain version is
``pose_deformation.pose_deformation_plain``. A launch tallies
``pose_deformation.launches`` and keeps ``pose_deformation.last_work``, the
device header it wrote (``WORK_FIELDS``; ``utils.profiler``).

``shard`` is the partitioned route of the sharded frame
(``parallel.solve_shard``): the phase kernels of
csrc/pose_deformation_shard.cu over a rank's points and their edge-ends,
each phase one thread block cluster whose blocks own whole chunks of the
rank's points (``shard_plan``: the blocks and the per-end table, device
ops), with the caller's all-reduce between launches. It tallies
``pose_deformation_shard.calls`` and its launches by phase and keeps
``pose_deformation_shard.last_work`` (``SHARD_WORK_FIELDS``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.utils import profiler

# The counts a ``shard`` call's device row holds.
SHARD_WORK_FIELDS = ("lm_steps", "cg_trips", "linearizations")

# The int32 header the kernels write at the start of their scratch.
WORK_FIELDS = ("lm_steps", "cg_trips", "linearizations", "blocks",
               "edge_ends_in_smem", "full_vectors_in_smem", "smem_bytes",
               "owned_state_in_smem")


def incidence_csr(i, j, live, P: int):
    """(ptr [P+1], edge [2E], sign [2E]) listing, for every point, its live
    incident edges in edge order (+1 where it is the edge's i, -1 for j).
    Dead edges' entries sort to the end, past ptr[P]."""
    E = i.shape[0]
    dev = i.device
    # Both ends of edge e at positions 2e, 2e + 1: a stable sort by point
    # keeps each point's edges in edge order.
    keys = torch.stack([torch.where(live, i, P), torch.where(live, j, P)],
                       dim=1).reshape(-1)
    eid = torch.arange(E, dtype=torch.int32,
                       device=dev).repeat_interleave(2)
    sign = 1.0 - 2.0 * (torch.arange(2 * E, device=dev) % 2).to(
        torch.float32)
    sorted_keys, perm = torch.sort(keys, stable=True)
    ptr = torch.searchsorted(sorted_keys,
                             torch.arange(P + 1, device=dev, dtype=keys.dtype))
    return (ptr.to(torch.int32).contiguous(), eid[perm].contiguous(),
            sign[perm].contiguous())


class Layout(NamedTuple):
    """Per-block layout of a cluster launch. Block r owns the points
    [pt_off[r], pt_off[r+1]) (ceil(P / blocks) rounded up to a multiple of
    4 each, the last ones fewer) and the edge-ends at CSR positions
    [inc_ptr[pt_off[r]], inc_ptr[pt_off[r+1]]): its points' incident live
    edges, each point's in edge order."""

    pt_off: torch.Tensor    # [blocks + 1] int32
    inc_ptr: torch.Tensor   # [P + 1] int32
    inc_edge: torch.Tensor  # [2E] int32
    inc_sign: torch.Tensor  # [2E] float32, +1 at the edge's i, -1 at j


def cluster_layout(i, j, live, P: int, blocks: int) -> Layout:
    """The layout for ``blocks`` blocks, from device ops (no host sync)."""
    step = (-(-P // blocks) + 3) // 4 * 4
    pt_off = torch.clamp(torch.arange(blocks + 1, dtype=torch.int32,
                                      device=i.device) * step, max=P)
    return Layout(pt_off.contiguous(), *incidence_csr(i, j, live, P))


class Prepared(NamedTuple):
    """One launch's device arguments in the C entry point's order, sizes,
    and the outputs each launch overwrites."""

    tensors: tuple
    sizes: tuple
    scratch: torch.Tensor
    out: tuple  # (pose [8], flows [P, 3], chi2 [P])


def prepare(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs, point_valid,
            pairs, scale, rounds=(10, 10), cg_iters: int = 10) -> Prepared:
    """Inputs, layout, scratch and outputs of one launch (device ops)."""
    from nrslam_tpu_torch.solver.pose_deformation import infos_for

    P = rest.shape[0]
    if rest.shape != (P, 3) or obs.shape != (P, 2) \
            or point_valid.shape != (P,):
        raise ValueError("pose_deformation: expected rest [P,3], obs [P,2], "
                         "point_valid [P]")
    if len(rounds) > 4:
        raise ValueError("pose_deformation: at most 4 rounds")
    i = pairs.i.to(torch.int64)
    j = pairs.j.to(torch.int64)
    E_raw = i.shape[0]
    E = ((E_raw + 127) // 128) * 128
    pad = E - E_raw
    base = pairs.valid & point_valid[i] & point_valid[j]
    i = F.pad(i, (0, pad))
    j = F.pad(j, (0, pad))
    w = F.pad(pairs.w.to(torch.float32), (0, pad))
    d0 = torch.clamp(F.pad(pairs.d0.to(torch.float32), (0, pad), value=1.0),
                     min=1e-12)
    base = F.pad(base, (0, pad))

    info_r, info_s, info_p = infos_for(torch.as_tensor(
        scale, dtype=torch.float32, device=rest.device))
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        Tcw0.q.to(torch.float32), Tcw0.t.to(torch.float32),
        torch.stack([torch.full_like(info_s, info_r), info_s,
                     torch.full_like(info_s, info_p)])]).contiguous()

    tensors = (params, rest.to(torch.float32).contiguous(),
               obs.to(torch.float32).contiguous(),
               point_valid.to(torch.float32).contiguous(),
               i.to(torch.int32).contiguous(), j.to(torch.int32).contiguous(),
               w, d0, base.to(torch.float32).contiguous())
    dev = kernels.require_cuda("pose_deformation", *tensors)
    lib = kernels.library()
    tensors += cluster_layout(i, j, base, P,
                              lib.nrslam_pose_deformation_blocks())
    n_ends = 2 * E
    scratch = torch.empty(lib.nrslam_pose_deformation_scratch(P, n_ends),
                          dtype=torch.float32, device=dev)
    out = (torch.empty(8, dtype=torch.float32, device=dev),
           torch.empty((P, 3), dtype=torch.float32, device=dev),
           torch.empty(P, dtype=torch.float32, device=dev))
    it = list(rounds) + [0] * (4 - len(rounds))
    sizes = (P, E, n_ends, kernels.CAMERA_KINDS[cam.kind], len(rounds), *it, cg_iters)
    return Prepared(tensors, sizes, scratch, out)


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (pose [8], flows [P, 3],
    chi2 [P]), the tensors of ``prep.out``."""
    dev = prep.scratch.device
    rc = kernels.library().nrslam_pose_deformation(
        *(t.data_ptr() for t in (*prep.tensors, prep.scratch, *prep.out)),
        *prep.sizes, kernels.stream_of(dev))
    kernels.check_launch("pose_deformation", rc)
    profiler.tally("pose_deformation.launches")
    profiler.keep("pose_deformation.last_work",
                  prep.scratch[:len(WORK_FIELDS)].view(torch.int32))
    return prep.out


def pose_deformation_cuda(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs,
                          point_valid, pairs, scale, rounds=(10, 10),
                          cg_iters: int = 10):
    """Run the whole joint schedule in one launch. rest [P, 3], obs [P, 2],
    point_valid [P] bool, pairs a compacted PairEdges. Returns
    (Tcw, flows [P, 3], chi2_r [P])."""
    out_pose, out_flows, out_chi2 = launch(prepare(
        cam, Tcw0, rest, obs, point_valid, pairs, scale, rounds, cg_iters))
    q = out_pose[:4]
    return se3.SE3(q / torch.linalg.norm(q), out_pose[4:7]), out_flows, \
        out_chi2


# csrc/pose_deformation_shard.cu's phases, and the arguments of its kernels.
_PHASES = ("init", "lin", "step", "hv", "cg")
_START, _TRIAL = 0, 1
_NEXT_CG, _NEXT_RELEVEL, _NEXT_FINAL = 0, 1, 2


class ShardPlan(NamedTuple):
    """A rank's plan for the partitioned routes' phase kernels: the blocks
    of each phase's cluster on whole chunks of the rank's points, and the
    per-end table in the owners' CSR order (``incidence_csr``: each point's
    live incident edges in edge order, dead edges past ``inc_ptr[P]``)."""

    chunk_off: torch.Tensor  # [C + 1] int32: block b owns the chunks
    #                          [chunk_off[b], chunk_off[b + 1])
    inc_ptr: torch.Tensor    # [P + 1] int32
    ends: torch.Tensor       # [2E, 4] int32: i, j, far end, sign (+1 at i)
    edge: torch.Tensor       # [2E] int64: the edge at each position


def shard_plan(i, j, live, P: int, block: slice, max_blocks: int,
               chunk: int = 64) -> ShardPlan:
    """The plan of the rank that owns ``block`` of the P points, over the
    edges (i, j) whose ``live`` is set (device ops, no host sync): its
    chunks (``block``'s points // ``chunk``, n of them) shared out over C =
    min(max_blocks, n) blocks, block b taking chunks [g0 + b n // C, g0 +
    (b + 1) n // C); the table covers every CSR position, so every rank
    holds the same one."""
    g0, g1 = block.start // chunk, (block.stop - 1) // chunk
    n = g1 - g0 + 1
    b = torch.arange(min(max_blocks, n) + 1, dtype=torch.int64,
                     device=i.device)
    chunk_off = (g0 + torch.div(b * n, b.shape[0] - 1,
                                rounding_mode="floor")).to(torch.int32)
    ptr, edge, sign = incidence_csr(i, j, live, P)
    e = edge.to(torch.int64)
    ie, je = i.to(torch.int64)[e], j.to(torch.int64)[e]
    far = torch.where(sign > 0, je, ie)
    ends = torch.stack([ie, je, far, sign.to(torch.int64)], dim=1).to(
        torch.int32).contiguous()
    return ShardPlan(chunk_off.contiguous(), ptr, ends, e)


def shard_phase_launches(rounds=(10, 10), cg_iters: int = 10) -> dict:
    """The phase launches one ``shard`` call makes with this schedule."""
    steps = sum(rounds)
    return {"init": 1, "lin": len(rounds) + steps,
            "step": len(rounds) + steps, "hv": steps * cg_iters,
            "cg": steps * cg_iters}


def shard(cam: cameras.Camera, Tcw0: se3.SE3, rest, obs, point_valid, pairs,
          base, scale, rounds, cg_iters: int, block: slice, rank: int,
          n: int, reduce):
    """The joint solve over this rank's ``block`` of the points as phase
    kernels (csrc/pose_deformation_shard.cu): rest [P, 3] and point_valid
    [P] of every point, obs [m, 2] of the block, ``pairs`` the compacted
    edge table (int64 i, j) and ``base`` its live mask; ``reduce`` sums a
    buffer over the n ranks in place (``sharding.all_reduce_``) between
    launches, as ``solve_shard`` lays out. Returns (Tcw, flows [P, 3],
    chi2_r [P]), the same on every rank. Raises if a kernel cannot build or
    launch."""
    from nrslam_tpu_torch.solver.pose_deformation import infos_for

    P = rest.shape[0]
    p0, m = block.start, block.stop - block.start
    rounds = tuple(int(k) for k in rounds)
    if obs.shape != (m, 2) or point_valid.shape != (P,):
        raise ValueError("pose_deformation shard: expected obs [m,2], "
                         "point_valid [P]")
    if not rounds or min(rounds) < 0 or cg_iters < 1:
        raise ValueError(f"pose_deformation shard: rounds {rounds}, "
                         f"cg_iters {cg_iters}")
    info_r, info_s, info_p = infos_for(torch.as_tensor(
        scale, dtype=torch.float32, device=rest.device))
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        Tcw0.q.to(torch.float32), Tcw0.t.to(torch.float32),
        torch.stack([torch.full_like(info_s, info_r), info_s,
                     torch.full_like(info_s, info_p)])]).contiguous()
    inputs = (params, F.pad(rest.to(torch.float32), (0, 1)).contiguous(),
              point_valid.to(torch.float32).contiguous(),
              obs.to(torch.float32).contiguous())
    dev = kernels.require_cuda("pose_deformation shard", *inputs)
    lib = kernels.library()
    n_ends = 2 * pairs.i.shape[0]
    lay = (ctypes.c_long * 8)()
    kernels.check_launch("pose_deformation shard layout",
                         lib.nrslam_joint_shard_layout(
                             m, P, n_ends, n, ctypes.addressof(lay)))
    total, red_at, reds_at, st_at, st_n, work_at, chunk, max_blocks = lay
    plan = shard_plan(pairs.i, pairs.j, base, P, block, max_blocks, chunk)
    e = plan.edge
    econ = torch.stack([
        pairs.w.to(torch.float32)[e],
        torch.clamp(pairs.d0.to(torch.float32), min=1e-12)[e],
        base.to(torch.float32)[e], torch.zeros_like(e, dtype=torch.float32)],
        dim=1).contiguous()
    tensors = (*inputs, plan.ends, econ, plan.inc_ptr, plan.chunk_off)
    C = plan.chunk_off.shape[0] - 1
    nc = -(-P // chunk)
    scratch = torch.zeros(total, dtype=torch.float32, device=dev)
    red = scratch[red_at:red_at + 3 * P + 2 * nc]
    reds = scratch[reds_at:reds_at + 28 * nc + n]
    out_pose = torch.empty(8, dtype=torch.float32, device=dev)
    out_flows = torch.empty((P, 3), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    args = (ptrs[0], kernels.CAMERA_KINDS[cam.kind], *ptrs[1:], scratch.data_ptr(),
            out_pose.data_ptr(), out_flows.data_ptr(), P, m, p0, n_ends,
            rank, n, kernels.stream_of(dev))
    q = 0  # launches so far: launch q reads st's slot q % 2

    def run(phase, arg=0):
        nonlocal q
        rc = lib.nrslam_joint_shard(_PHASES.index(phase), arg, q & 1, C,
                                    *args)
        kernels.check_launch(f"pose_deformation shard {phase}", rc)
        profiler.tally(f"pose_deformation_shard.{phase}")
        q += 1

    run("init")
    for r, n_lm in enumerate(rounds):
        after = _NEXT_FINAL if r + 1 == len(rounds) else _NEXT_RELEVEL
        run("lin", _START)
        reduce(reds)
        run("step", _NEXT_CG if n_lm else after)
        for it in range(n_lm):
            reduce(red)
            for t in range(cg_iters):
                # arg: first / last trip, then the trip's p slot.
                run("hv", int(t == 0) | (t & 1) << 1)
                reduce(reds[:7 * nc])
                run("cg", int(t == cg_iters - 1) | (t & 1) << 1)
                reduce(red)
            run("lin", _TRIAL)
            reduce(reds[:28 * nc])
            run("step", 4 | (_NEXT_CG if it + 1 < n_lm else after))
    reduce(red[:P])
    profiler.tally("pose_deformation_shard.calls")
    at = st_at + (q & 1) * st_n + work_at
    profiler.keep("pose_deformation_shard.last_work",
                  scratch[at:at + len(SHARD_WORK_FIELDS)])
    return se3.SE3(out_pose[:4], out_pose[4:7]), out_flows, red[:P]
