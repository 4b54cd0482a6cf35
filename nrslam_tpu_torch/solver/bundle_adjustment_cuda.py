"""Wrapper of the local deformable BA kernel (csrc/bundle_adjustment.cu), the
counterpart of nrslam_tpu/solver/bundle_adjustment_pallas.py.

The wrapper forms the factor masks as ``bundle_adjustment._masks`` does
(observed copies [K, P], springs [K, E], dampers [K-1, E] padded with a zero
row to [K, E]), clamps rest distances to >= 1e-12 and builds, once per call,
the kernel's per-block layout (``pose_deformation_cuda.cluster_layout``) over
the edges any keyframe uses; one edge table serves all K keyframes. It reads
nothing back to the host: sizes come from tensor shapes. Unlike the Pallas
wrapper it does not sanitise unobserved copies: the kernel skips every
masked term and returns those copies unchanged.

``prepare`` builds a launch's inputs and layout, ``launch`` runs the kernel
on them (``local_deformable_ba_cuda`` does both). Takes CUDA tensors only
and raises otherwise, or when the card refuses the cluster; the plain
version is ``bundle_adjustment.local_deformable_ba_plain``. A launch
tallies ``bundle_adjustment.launches`` and keeps
``bundle_adjustment.last_work``, the device header it wrote
(``pose_deformation_cuda.WORK_FIELDS``; ``utils.profiler``).

``shard`` is the partitioned route of the sharded frame
(``parallel.ba_points``): the phase kernels of
csrc/bundle_adjustment_shard.cu over a rank's points, all their copies and
their edge-ends (over the edges some spring uses), each phase one thread
block cluster whose blocks own whole chunks of the rank's points
(``shard_tables``), with the caller's all-reduce between launches. It
tallies ``bundle_adjustment_shard.calls`` and its launches by phase and
keeps ``bundle_adjustment_shard.last_work`` (``SHARD_WORK_FIELDS``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.solver.pose_deformation_cuda import (
    SHARD_WORK_FIELDS, WORK_FIELDS, Prepared, cluster_layout, shard_plan)
from nrslam_tpu_torch.utils import profiler

MAX_K = 8

def prepare(cam: cameras.Camera, poses0: se3.SE3, L0, problem,
            n_iters: int = 5, cg_iters: int = 32) -> Prepared:
    """Inputs, layout, scratch and outputs of one launch (device ops)."""
    from nrslam_tpu_torch.solver.bundle_adjustment import _masks

    K, P, _ = L0.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"bundle_adjustment: 1 <= K <= {MAX_K}, got {K}")
    if problem.obs.shape != (K, P, 2) or problem.obs_valid.shape != (K, P) \
            or poses0.q.shape != (K, 4):
        raise ValueError("bundle_adjustment: expected poses0 [K], L0 [K,P,3], "
                         "obs [K,P,2], obs_valid [K,P]")
    pairs = problem.pairs
    i = pairs.i.to(torch.int64)
    j = pairs.j.to(torch.int64)
    E = i.shape[0]
    obs_ok, spring, damper = _masks(problem._replace(
        pairs=pairs._replace(i=i, j=j)))
    dmask = torch.cat([damper, torch.zeros_like(spring[:1])])

    sigma_s = 0.1 * torch.as_tensor(problem.scale, dtype=torch.float32,
                                    device=L0.device)
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        torch.cat([poses0.q.to(torch.float32), poses0.t.to(torch.float32),
                   torch.zeros((K, 1), dtype=torch.float32,
                               device=L0.device)], dim=-1).reshape(-1),
        (1.0 / (sigma_s * sigma_s)).reshape(1)]).contiguous()

    tensors = (params, L0.to(torch.float32).contiguous(),
               problem.obs.to(torch.float32).contiguous(),
               obs_ok.to(torch.float32).contiguous(),
               i.to(torch.int32).contiguous(), j.to(torch.int32).contiguous(),
               pairs.w.to(torch.float32).contiguous(),
               torch.clamp(pairs.d0.to(torch.float32), min=1e-12).contiguous(),
               spring.to(torch.float32).contiguous(),
               dmask.to(torch.float32).contiguous())
    dev = kernels.require_cuda("bundle_adjustment", *tensors)
    lib = kernels.library()
    tensors += cluster_layout(i, j, torch.any(spring, 0), P,
                              lib.nrslam_ba_blocks())
    n_ends = 2 * E
    scratch = torch.empty(lib.nrslam_ba_scratch(K, P, n_ends),
                          dtype=torch.float32, device=dev)
    out = (torch.empty((K, 8), dtype=torch.float32, device=dev),
           torch.empty((K, P, 3), dtype=torch.float32, device=dev))
    sizes = (K, P, E, n_ends, kernels.CAMERA_KINDS[cam.kind], n_iters, cg_iters)
    return Prepared(tensors, sizes, scratch, out)


def launch(prep: Prepared):
    """Run the kernel on a prepared launch; returns (poses [K, 8],
    landmarks [K, P, 3]), the tensors of ``prep.out``."""
    dev = prep.scratch.device
    rc = kernels.library().nrslam_ba(
        *(t.data_ptr() for t in (*prep.tensors, prep.scratch, *prep.out)),
        *prep.sizes, kernels.stream_of(dev))
    kernels.check_launch("bundle_adjustment", rc)
    profiler.tally("bundle_adjustment.launches")
    profiler.keep("bundle_adjustment.last_work",
                  prep.scratch[:len(WORK_FIELDS)].view(torch.int32))
    return prep.out


def local_deformable_ba_cuda(cam: cameras.Camera, poses0: se3.SE3, L0,
                             problem, n_iters: int = 5, cg_iters: int = 32):
    """Drop-in for the plain driver on CUDA tensors: poses0 [K], L0 [K, P, 3],
    ``problem`` a ``bundle_adjustment.BAProblem``. Returns (poses [K],
    landmarks [K, P, 3])."""
    out_pose, out_L = launch(prepare(cam, poses0, L0, problem, n_iters,
                                     cg_iters))
    q = out_pose[:, :4]
    return se3.SE3(q / torch.linalg.norm(q, dim=-1, keepdim=True),
                   out_pose[:, 4:7]), out_L


# csrc/bundle_adjustment_shard.cu's phases, and the arguments of its kernels.
_PHASES = ("init", "lin", "step", "hv", "cg")
_START, _TRIAL = 0, 1
_NEXT_CG, _NEXT_FINAL = 0, 1


def shard_phase_launches(n_iters: int = 5, cg_iters: int = 16) -> dict:
    """The phase launches one ``shard`` call makes with this schedule (the
    defaults are the keyframe's: 5 LM steps, ``Config.ba_cg_iters``)."""
    return {"init": 1, "lin": 1 + n_iters, "step": 1 + n_iters,
            "hv": n_iters * cg_iters, "cg": n_iters * cg_iters}


def shard_tables(pairs, spring, damper, P: int, block: slice,
                 max_blocks: int, chunk: int = 64):
    """The route's ``ShardPlan`` over the edges some keyframe's spring uses
    and its per-end constants [2E, 4] float32: w, d0 (clamped >= 1e-12),
    the int32 bits of the masks (spring bit k, damper (k, k + 1) bit 8 + k)
    and 0 (device ops)."""
    W = spring.shape[0]
    plan = shard_plan(pairs.i, pairs.j, torch.any(spring, 0), P, block,
                      max_blocks, chunk)
    k = torch.arange(W, dtype=torch.int32, device=spring.device)[:, None]
    bits = torch.sum(spring.to(torch.int32) << k, 0) + torch.sum(
        damper.to(torch.int32) << (8 + k[:-1]), 0)
    e = plan.edge
    econ = torch.stack([
        pairs.w.to(torch.float32)[e],
        torch.clamp(pairs.d0.to(torch.float32), min=1e-12)[e],
        bits.to(torch.int32)[e].view(torch.float32),
        torch.zeros_like(e, dtype=torch.float32)], dim=1).contiguous()
    return plan, econ


def shard(cam: cameras.Camera, poses0: se3.SE3, L0, obs, obs_ok, pairs,
          spring, damper, info_s, n_iters: int, cg_iters: int, block: slice,
          rank: int, n: int, reduce):
    """The window BA over this rank's ``block`` of the points as phase
    kernels (csrc/bundle_adjustment_shard.cu): poses0 [W] and L0 [W, P, 3]
    whole, obs [W, m, 2] of the block, obs_ok [W, P], the pair table (int64
    i, j) with its spring [W, E] and damper [W - 1, E] masks, ``info_s``
    the damper information; ``reduce`` sums a buffer over the n ranks in
    place (``sharding.all_reduce_``) between launches, as ``ba_points``
    lays out. Returns (poses [W], copies [W, P, 3]), the same on every
    rank. Raises if a kernel cannot build or launch."""
    W, P, _ = L0.shape
    p0, m = block.start, block.stop - block.start
    if not 1 <= W <= MAX_K or obs.shape != (W, m, 2) \
            or obs_ok.shape != (W, P) or poses0.q.shape != (W, 4):
        raise ValueError("bundle_adjustment shard: expected poses0 [W], L0 "
                         "[W,P,3], obs [W,m,2], obs_ok [W,P], W <= "
                         f"{MAX_K}")
    if n_iters < 1 or cg_iters < 1:
        raise ValueError(f"bundle_adjustment shard: n_iters {n_iters}, "
                         f"cg_iters {cg_iters}")
    dev = L0.device
    params = torch.cat([
        F.pad(cam.params.to(torch.float32), (0, 8 - cam.params.shape[0])),
        torch.cat([poses0.q.to(torch.float32), poses0.t.to(torch.float32),
                   torch.zeros((W, 1), dtype=torch.float32, device=dev)],
                  dim=-1).reshape(-1),
        torch.as_tensor(info_s, dtype=torch.float32, device=dev).reshape(1)])
    inputs = (params.contiguous(),
              L0.to(torch.float32).transpose(0, 1).contiguous(),
              obs_ok.to(torch.float32).transpose(0, 1).contiguous(),
              obs.to(torch.float32).transpose(0, 1).contiguous())
    dev = kernels.require_cuda("bundle_adjustment shard", *inputs)
    lib = kernels.library()
    n_ends = 2 * pairs.i.shape[0]
    lay = (ctypes.c_long * 9)()
    kernels.check_launch("bundle_adjustment shard layout",
                         lib.nrslam_ba_shard_layout(
                             W, m, P, n_ends, n, ctypes.addressof(lay)))
    total, red_at, reds_at, st_at, st_n, work_at, chunk, S, max_blocks = lay
    plan, econ = shard_tables(pairs, spring, damper, P, block, max_blocks,
                              chunk)
    tensors = (*inputs, plan.ends, econ, plan.inc_ptr, plan.chunk_off)
    C = plan.chunk_off.shape[0] - 1
    nc = -(-P // chunk)
    scratch = torch.zeros(total, dtype=torch.float32, device=dev)
    n3 = 3 * W * P
    red = scratch[red_at:red_at + n3 + 2 * nc]
    reds = scratch[reds_at:reds_at + S * nc + n]
    out_pose = torch.empty((W, 8), dtype=torch.float32, device=dev)
    out_L = torch.empty((P, W, 3), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in tensors]
    args = (ptrs[0], kernels.CAMERA_KINDS[cam.kind], *ptrs[1:], scratch.data_ptr(),
            out_pose.data_ptr(), out_L.data_ptr(), W, P, m, p0, n_ends, rank,
            n, kernels.stream_of(dev))
    q = 0  # launches so far: launch q reads st's slot q % 2

    def run(phase, arg=0):
        nonlocal q
        rc = lib.nrslam_ba_shard(_PHASES.index(phase), arg, q & 1, C, *args)
        kernels.check_launch(f"bundle_adjustment shard {phase}", rc)
        profiler.tally(f"bundle_adjustment_shard.{phase}")
        q += 1

    run("init")
    run("lin", _START)
    reduce(reds)
    run("step", _NEXT_CG)
    for it in range(n_iters):
        reduce(red)
        for t in range(cg_iters):
            last = t == cg_iters - 1
            # arg: first / last trip, then the trip's p slot.
            run("hv", int(t == 0) | (t & 1) << 1)
            reduce(reds[:(6 * W + 1) * nc])
            run("cg", int(last) | (t & 1) << 1)
            reduce(red[:n3 + (nc if last else 2 * nc)])
        run("lin", _TRIAL)
        reduce(reds[:S * nc])
        run("step", 4 | (_NEXT_CG if it + 1 < n_iters else _NEXT_FINAL))
    profiler.tally("bundle_adjustment_shard.calls")
    at = st_at + (q & 1) * st_n + work_at
    profiler.keep("bundle_adjustment_shard.last_work",
                  scratch[at:at + len(SHARD_WORK_FIELDS)])
    return se3.SE3(out_pose[:, :4], out_pose[:, 4:7]), out_L.transpose(0, 1)
