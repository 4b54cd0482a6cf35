"""Wrapper of the pose-only LM kernel (csrc/pose_only.cu), the counterpart
of nrslam_tpu/solver/pose_only_pallas.py.

``prepare`` checks the inputs, casts only where a cast is needed (the main
path's inputs are already float32, contiguous and bool), plans where the
points live (``plan``) and allocates the output; ``launch`` is the one
kernel launch (``camera_pose_optimization_cuda`` does both). The kernel
reads the camera, the seed pose and the bool mask through their own
pointers and writes q normalised, so a call launches one device kernel.
Takes CUDA tensors only and raises otherwise; the plain PyTorch version is
``pose_only.camera_pose_optimization_plain``. A launch tallies
``pose_only.launches`` and keeps ``pose_only.last_lm_steps``, a device
tensor [1] holding the LM steps it ran (``utils.profiler``).

``shard`` is the partitioned route of the sharded frame
(``parallel.solve_shard``): the phase kernels of csrc/pose_only_shard.cu
over a rank's points, with the caller's all-reduce between launches; it
tallies ``pose_only_shard.calls`` and its launches by phase
(``pose_only_shard.<phase>``) and keeps ``pose_only_shard.last_lm_steps``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from nrslam_tpu_torch import kernels
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.utils import profiler

# The thread count aims at this many points a thread.
POINTS_PER_THREAD = 3
MIN_THREADS = 64


class Plan(NamedTuple):
    """Where one launch keeps its points. One block of ``threads`` threads;
    the first ``n_reg`` points in registers (point i with thread i %
    threads), the next ``n_sh`` in dynamic shared memory, the last ``n_gl``
    in global memory (their re-level state in a global byte row);
    ``smem_bytes`` of dynamic shared memory: two reduction buffers of 32
    floats a warp, then 21 bytes a shared point."""

    threads: int
    n_reg: int
    n_sh: int
    n_gl: int
    smem_bytes: int


def plan(P: int, smem_avail: int, max_threads: int, reg_pts: int,
         threads: Optional[int] = None) -> Plan:
    """The residency plan for P points under the kernel's limits
    (``limits``: ``max_threads`` a block, ``reg_pts`` points a thread in
    registers, ``smem_avail`` dynamic shared bytes): ``threads`` (default:
    about POINTS_PER_THREAD points a thread, a multiple of 32 in
    [MIN_THREADS, max_threads]), registers first, then shared memory as far
    as ``smem_avail`` bytes hold them, then global memory. No P is
    refused."""
    if threads is None:
        want = -(-max(P, 1) // POINTS_PER_THREAD)
        threads = min(max_threads, max(MIN_THREADS, -(-want // 32) * 32))
    if threads % 32 or not 32 <= threads <= max_threads:
        raise ValueError(f"pose_only: threads {threads} not a multiple of 32 "
                         f"in [32, {max_threads}]")
    red_bytes = 4 * 2 * threads
    n_reg = min(P, reg_pts * threads)
    n_sh = min(P - n_reg, max(0, (smem_avail - red_bytes) // 21))
    return Plan(threads, n_reg, n_sh, P - n_reg - n_sh, red_bytes + 21 * n_sh)


@functools.lru_cache(maxsize=None)
def limits(lib: ctypes.CDLL, device: int) -> tuple:
    """(max threads, points in registers a thread, dynamic shared bytes a
    block may use) of the built kernel on ``device``: its compile-time
    constants and the device's opt-in, read from the library."""
    out = (ctypes.c_int * 3)()
    kernels.check_launch("pose_only limits",
                         lib.nrslam_pose_only_limits(device,
                                                     ctypes.addressof(out)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _schedule(rounds: tuple, device: torch.device) -> torch.Tensor:
    """The LM steps of each round as a device int32 row, made once per
    schedule and device (a host-to-device copy), so calls copy nothing."""
    return torch.tensor(rounds or (0,), dtype=torch.int32, device=device)


class Prepared(NamedTuple):
    """One launch: the kernel's input tensors in the C entry point's order,
    the global state row of the points that live in global memory (None
    when none do), the output [8], the plan and (P, kind, rounds)."""

    tensors: tuple
    gl_state: Optional[torch.Tensor]
    out: torch.Tensor
    plan: Plan
    sizes: tuple


def prepare(cam: cameras.Camera, Tcw0: se3.SE3, landmarks, obs, valid,
            rounds=(10, 10, 10), threads: Optional[int] = None) -> Prepared:
    """Checks, casts where needed, plans and allocates one launch.
    ``threads`` overrides the plan's thread count, to check or time other
    plans."""
    P = landmarks.shape[0]
    if landmarks.shape != (P, 3) or obs.shape != (P, 2) \
            or valid.shape != (P,):
        raise ValueError("pose_only: expected landmarks [P,3], obs [P,2], "
                         "valid [P]")
    rounds = tuple(int(n) for n in rounds)
    if any(n < 0 for n in rounds):
        raise ValueError(f"pose_only: negative LM steps in rounds {rounds}")
    if cam.params.shape != (kernels.CAMERA_PARAMS[cam.kind],) \
            or Tcw0.q.shape != (4,) or Tcw0.t.shape != (3,):
        raise ValueError("pose_only: expected one camera and one pose")

    def f32(t):
        return t.to(torch.float32).contiguous()

    tensors = (f32(cam.params), f32(Tcw0.q), f32(Tcw0.t), f32(landmarks),
               f32(obs), valid.to(torch.bool).contiguous().view(torch.uint8))
    dev = kernels.require_cuda("pose_only", *tensors)
    max_threads, reg_pts, avail = limits(kernels.library(), dev.index)
    pl = plan(P, avail, max_threads, reg_pts, threads)
    gl_state = (torch.empty(pl.n_gl, dtype=torch.uint8, device=dev)
                if pl.n_gl else None)
    out = torch.empty(8, dtype=torch.float32, device=dev)
    return Prepared(tensors + (_schedule(rounds, dev),), gl_state, out, pl,
                    (P, kernels.CAMERA_KINDS[cam.kind], len(rounds)))


def launch(prep: Prepared) -> torch.Tensor:
    """Run the kernel on a prepared launch; returns ``prep.out`` = (q
    normalised, t, LM steps run)."""
    pl = prep.plan
    rc = kernels.library().nrslam_pose_only(
        *(t.data_ptr() for t in prep.tensors),
        None if prep.gl_state is None else prep.gl_state.data_ptr(),
        prep.out.data_ptr(), *prep.sizes, pl.threads, pl.n_reg, pl.n_sh,
        pl.smem_bytes, kernels.stream_of(prep.out.device))
    kernels.check_launch("pose_only", rc)
    profiler.tally("pose_only.launches")
    profiler.keep("pose_only.last_lm_steps", prep.out[7:])
    return prep.out


def camera_pose_optimization_cuda(cam: cameras.Camera, Tcw0: se3.SE3,
                                  landmarks, obs, valid,
                                  rounds=(10, 10, 10)) -> se3.SE3:
    """Drop-in for the plain driver on CUDA tensors: landmarks [P, 3],
    obs [P, 2], valid [P] bool; any number of rounds."""
    out = launch(prepare(cam, Tcw0, landmarks, obs, valid, rounds))
    return se3.SE3(out[:4], out[4:7])


@functools.lru_cache(maxsize=None)
def _shard_layout(lib: ctypes.CDLL) -> tuple:
    """(floats of the device row, offset of the result, of the seed, of the
    trial pose, points a chunk of the partial sums covers) of
    csrc/pose_only_shard.cu."""
    out = (ctypes.c_int * 5)()
    kernels.check_launch("pose_only shard layout",
                         lib.nrslam_pose_shard_layout(ctypes.addressof(out)))
    return tuple(out)


def shard_phase_launches(rounds=(10, 10, 10)) -> dict:
    """The phase launches one ``shard`` call makes with this schedule."""
    evaluations = sum(rounds) + len(rounds)
    return {"partials": evaluations, "step": evaluations,
            "relevel": len(rounds) - 1}


def shard(cam: cameras.Camera, Tcw0: se3.SE3, X, obs, valid, rounds,
          block: slice, P: int, reduce) -> se3.SE3:
    """The pose-only solve over this rank's points X [m, 3], obs [m, 2],
    valid [m] (CUDA tensors), the ``block`` of the P points, as phase
    kernels (csrc/pose_only_shard.cu): per LM trip the rank's partial sums
    by chunk of points, ``reduce`` (an in-place sum of them over the ranks,
    ``sharding.all_reduce_``), the LM step on the device; the re-level
    between rounds on the rank's points. The same pose on every rank (q
    normalised). Raises if a kernel cannot build or launch."""
    m = X.shape[0]
    rounds = tuple(int(n) for n in rounds)
    if X.shape != (m, 3) or obs.shape != (m, 2) or valid.shape != (m,):
        raise ValueError("pose_only shard: expected X [m,3], obs [m,2], "
                         "valid [m]")
    if not rounds or any(n < 0 for n in rounds):
        raise ValueError(f"pose_only shard: rounds {rounds}")
    params = F.pad(cam.params.to(torch.float32),
                   (0, 8 - cam.params.shape[0])).contiguous()
    X = X.to(torch.float32).contiguous()
    obs = obs.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous().view(torch.uint8)
    dev = kernels.require_cuda("pose_only shard", params, X, obs, valid)
    lib = kernels.library()
    n_st, out_at, seed_at, trial_at, chunk = _shard_layout(lib)
    nc = -(-P // chunk)
    st = torch.zeros(n_st, dtype=torch.float32, device=dev)
    st[seed_at:seed_at + 4] = Tcw0.q
    st[seed_at + 4:seed_at + 7] = Tcw0.t
    level = valid.clone()
    red = torch.empty(28 * nc, dtype=torch.float32, device=dev)
    kind, stream = kernels.CAMERA_KINDS[cam.kind], kernels.stream_of(dev)

    def run(phase, rc):
        kernels.check_launch(f"pose_only shard {phase}", rc)
        profiler.tally(f"pose_only_shard.{phase}")

    for r, n in enumerate(rounds):
        for k in range(n + 1):
            run("partials", lib.nrslam_pose_shard_partials(
                params.data_ptr(), st.data_ptr(),
                seed_at if k == 0 else trial_at, X.data_ptr(),
                obs.data_ptr(), level.data_ptr(), m, block.start, P, kind,
                int(k > 0), red.data_ptr(), stream))
            reduce(red)
            run("step", lib.nrslam_pose_shard_step(
                st.data_ptr(), red.data_ptr(), nc, int(k == 0), stream))
        if r + 1 < len(rounds):
            run("relevel", lib.nrslam_pose_shard_relevel(
                params.data_ptr(), st.data_ptr(), X.data_ptr(),
                obs.data_ptr(), valid.data_ptr(), level.data_ptr(), m, kind,
                stream))
    profiler.tally("pose_only_shard.calls")
    profiler.keep("pose_only_shard.last_lm_steps", st[out_at + 7:out_at + 8])
    return se3.SE3(st[out_at:out_at + 4], st[out_at + 4:out_at + 7])
