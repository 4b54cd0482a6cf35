#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nrslam_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py
(``python3 chip_smoke.py --witness`` instead runs only the main path's
System three ways, the card with the kernels, the card with the plain
drivers, the CPU, and prints each one's accuracy and how far their
trajectories drift apart; ``python3 chip_smoke.py --wrappers TREE`` only
times the pose-only, joint and BA wrappers of the package in TREE, e.g.
another commit's ``git archive``: measurements, not checks.)

Phases (any failure raises and exits non-zero; nothing is caught; each
prints its seconds):
  1. require a CUDA device; print the card's name and power limit;
  2. build the three hand-written kernels from csrc/ with nvcc (sm_90a, one
     nvcc per source, all started together) and print ptxas's register,
     stack, spill and shared-memory report ([ptxas]); both instantiations
     of the pose-only kernel (pinhole, KB8) must show no spills;
  3. kernel phase: at the frame's shapes (P=768, E=5376 from a K=11 kNN
     graph on a seeded scene) and at the 320x240 slice's (P=384, E=2688),
     pinhole and KB8, the pose-only and joint kernels against their plain
     PyTorch versions on the card, with the CPU tests' tolerances and the
     tighter same-device gates below; then the keyframe-BA kernel at the
     keyframe's shapes (K=5, P=768, E=5376, noisy seeds, ~25% of copies
     unobserved), pinhole, KB8 and a window with 3 of 5 valid slots,
     against the plain BA driver, with unobserved copies checked unchanged.
     Every kernel must give the same bits on two launches ([determinism]).
     Kernels timed with CUDA events as the median of 20 after warm-up,
     alone on prepared inputs and through their wrappers, plain versions
     as the median of 20 (pose-only) or 5 (joint, BA); each with the work
     it reports (LM steps, CG trips, linearisations) and its bound. The
     pose-only kernel also: one wrapper call runs exactly one device kernel
     (torch.profiler), a 5-round schedule held to plain, and the spread of
     3 seeded permutations of its points ([spread], a measurement);
  3a. the sharded routes (parallel/solve_shard.py on CUDA tensors: the
     phase kernels of csrc/pose_only_shard.cu and
     csrc/pose_deformation_shard.cu, whose partial sums a process group
     would all-reduce between launches) in this process without a group,
     so each solves the whole problem: at P=768 (E=5376) and P=384,
     pinhole and KB8, the pose (|dq|, |dt|) and every valid point's flow
     against the whole-solver kernels and against the plain drivers, on
     the rigid scene (deform_amp=0) under the same-device gates below, and
     at P=768 on the deformed scene under 3x the plain driver's own spread
     over 8 seeded permutations of the points (never below the same-device
     gates); two calls bit-identical ([determinism]); each call's phase
     launches as pose_only_cuda / pose_deformation_cuda
     .shard_phase_launches count them. Timed at pinhole P=768 deformed:
     the wrapper (CUDA events), the sum of its phase launches' device time
     (torch.profiler) and the whole-solver wrapper, with the bound of the
     work the call reports;
  3b. shared-memory overflow: the pose-only kernel with its points in
     shared memory too (P=768 with 64 threads), and at the sizes that take
     each plan by default (P=131 in registers only, 4096 in shared and
     16384 in global memory, on the scene made rigid), and P=16384 on the
     deformed scene, held to 3x the plain driver's own spread under 8
     permutations on the card; the joint at P=4096 and 9216 and the BA at
     K=8 with P=768, 1536 and 2048, where edge-end records, the full vector
     copies or the owned state no longer fit in shared memory; each against
     the plain drivers under the same gates ([overflow]);
  4. slice parity: 6 frames of frame_step at 320x240/P=384 on CUDA (with
     the kernels) and on the CPU (plain versions) from one start state;
  5. system parity: System.track_image_with_depth from frame 0 on the
     synthetic sequence (320x240 with more relief and a faster camera, see
     system_parity; P=384, the test_e2e initializer) on CUDA and on the
     CPU with the same draws, through the init, bootstrap_map
     and two keyframes: equal statuses every frame (so the same init
     frame), slice tolerances on every tracked frame;
  6. the slice timed at 320x240/P=384/128 new keypoints, then at scale:
     640x480/P=768/256 new keypoints. Each: 4 warm-up frames (two under
     torch.cuda.set_sync_debug_mode("error"), which raises on a host
     synchronisation it detects), then 10 timed frames at the 1-in-5
     keyframe cadence; checks the map is alive, the pose-only and joint
     kernels launched once per frame and the BA kernel once per keyframe;
  7. the main path: System.track_image_with_depth from frame 0 on the
     synthetic sequence at 640x480, P=768, 256 new keypoints, default
     initializer (1024 features), 60 frames: init frame, ms per init /
     keyframe / non-keyframe frame, median depth RMSE, Sim(3) ATE, and the
     launch counts (pose-only once per steady frame + 3 per two-view
     refinement, joint once per steady frame, BA once per keyframe), which
     the kernels' record reports;
  8. the pose-only kernel against its plain version on the inputs the main
     path's two-view refinement gave it (P = 1024 features, only the
     triangulated ones valid), at the same-device gate, and timed (bare
     launch and wrapper);
  9. [disk-hamlyn], the disk path at full width: datasets/hamlyn_export
     writes 60 stereo frames of the 640x480 scene (deformation 0.02) as
     PNGs, then ``python -m nrslam_tpu_torch.apps.run_slam --dataset
     hamlyn`` runs in process on the card (P=768, stereo evaluation, RMSE
     file, PLY, checkpoint): TRACKING, >= 30 tracked frames, median stereo
     RMSE finite and < 0.5, one finite RMSE line per tracked frame, a
     non-empty PLY, launches as the path dictates, the checkpoint restored
     bit for bit; then the NCC matcher on the card against the CPU on the
     last frame's inputs (ok masks agree on >= 99% of slots, relative
     median depth difference <= 1e-4); ms per init / keyframe /
     non-keyframe frame and of the stereo evaluation;
 10. [disk-simulation]: datasets/simulation_export writes a 320x240 KB8
     scene (30 frames, 16-bit PNG depth), the CLI runs it on the card
     through Settings' KannalaBrandt8 branch and a masker of a
     BorderFilter and a PredefinedFilter read from a PNG (P=384, viz
     dumps): TRACKING, finite median depth RMSE, the predefined mask on
     the card, launches as the path dictates, the dumps read back; the
     native loader, where it builds, decodes the exported frames as png.py
     and the port's RGB -> gray do (else the compiler's reason);
 11. [collapse]: System.track_image_with_depth at 320x240/P=384 with
     auto_reinitialize and lost_check_every=1: tracked until >= 9
     keyframes have gone into the 8-slot ring (it wrapped), then 4 black
     frames, within which LOST must latch, then the scene again: the
     re-initialisation must succeed and the run end TRACKING with >= 10
     tracked 3D points and finite positions; prints each status change;
 12. [parallel]: 4 ranks spawned on this card (parallel.dryrun.World,
     gloo over a FileStore in the scratch directory; started before phase
     3 and idle until now) hold, each against its single-process
     counterpart on the card: the pose normal equations sharded over P=768
     points (<= 1e-5 max|H|); the pose-only solve and then the joint
     solve partitioned over the ranks' P/4 blocks (the phase kernels on
     every rank, partial sums all-reduced between launches) against the
     whole-solver kernels at pinhole P=768 on the rigid scene under the
     same-device gates, every rank the same bits (dryrun.report_solves);
     the window BA partitioned over
     the ranks' P/4 point blocks (W=5: P=768 with 5 and 3 of 5 slots
     valid, P=4096 with 5)
     against the whole-solver BA kernel and plain under the same-device BA
     gate and bit for bit against this process running it as one rank,
     with its phase launches (dryrun.report_points_ba); the
     keyframe-sharded BA at the ring's size (K=8, P=768, E from the K=11
     kNN graph, n_iters=5, cg_iters=32) against the plain BA (poses <= 2e-4,
     landmarks <= 2e-3, RMSE < 0.2x its start), and a window with 5 of 8
     valid; the row-sharded frame_step (each rank builds the seeded
     problem with only its [P/4, P] graph rows) at 640x480/256 new
     keypoints, P=768 for 6 frames with keyframes at frames 3 and 5 and
     P=4096 for 3 frames with a keyframe at frame 3 (dryrun.FRAME_RUNS: at
     P=768 the second keyframe's window holds 3 valid keyframes, so its
     BA's result is applied), the pose-only and joint
     solves and the keyframe's window BA partitioned (the keyframe ring's
     columns on their rank, the temporal ring replicated, neither
     gathered), against system.frame_step in this process with
     those three solves by the plain drivers (n_tracked_3d equal, Tcw.t
     <= 1e-4, positions <= 1e-3, statuses equal on >= 98% of slots, the
     keyframe ring's validity equal, its poses <= 1e-4 and copies <= 1e-3,
     at
     P=768 the graph gathered once at the end: edges and bad flags equal,
     distances and weights <= 1e-3) and bit for bit against this process
     running frame_step_sharded as one rank (every leaf of the state, the
     counts and flags of every frame), and that one rank with one
     process's solves bit for bit against system.frame_step (the frame's
     own work: dryrun.structure_against_one_process; also at
     P=4096 with keyframes at frames 2 and 3, where the BA is applied);
     the readings against
     system.frame_step with the whole-solver kernels are printed (at
     P=4096 that frame flips one point's gate against the plain drivers:
     PERF.md §6); launches on every rank as dryrun.frame_launches
     counts them: per frame one partitioned pose-only and one partitioned
     joint call and per keyframe one partitioned window BA with their phase
     launches, no whole-solver pose-only, joint or BA launch; every
     collective payload under P*P/4 elements; each frame's collective
     bytes and the partitioned solves' bytes and collectives equal to
     dryrun.PREDICTED; the frame raises unless every rank's state
     checksum equals the others' after each frame);
     then the keyframe-sharded BA in this process on NCCL with world size
     1 under the same gates. Prints ms/frame of the sharded and the
     single-process frame (four processes share the card: a
     measurement), each rank's collective payload bytes per frame beside
     the whole-state gather's (worked out from its gathers) and the
     prediction, the partitioned solves' share of them (collectives and
     bytes) beside theirs, and at P=4096 each rank's peak allocated memory
     over the frames beside the single process's and the prediction.
The line before the last is the kernels' JSON record (launches on the main
path, error, times, bound: ``ms`` is the wrapper call, ``kernel_ms`` the
bare launch on prepared inputs); the sharded routes' entries count rank
0's phase launches over the [parallel] frames, ``kernel_ms`` is the device
time of one call's phase launches, ``max_abs_err`` their largest
difference from the whole-solver kernels on the rigid scene. The last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version on the same card, both float32. The CPU tests'
# tolerances compare two frameworks and would pass a kernel that drops a
# term; these are set about 10x above the largest differences measured on an
# NVIDIA H100 (pose |dq|, |dt| <= 8.3e-7; max per-point |dflow| <= 1.9e-5).
SAME_DEVICE_POSE_TOL = 1e-5
SAME_DEVICE_FLOW_TOL = 2e-4
# Keyframe BA kernel vs plain driver, same card, both float32: about 10x
# above the largest differences of the first runs on an NVIDIA H100 (pose
# |dq| <= 4.1e-7, |dt| <= 2.7e-6; landmark copies |dL| <= 3.0e-6). On these
# windows the plain driver with one CG trip fewer, one LM step fewer, a
# damper sign flipped, a spring or damper term dropped, the damper left out
# of the Jacobi blocks or lambda0 x10 moves max(|dq|, |dt|, |dL|) by
# >= 1.78e-3 (CPU, float32), and no CG solve converges early in 16 trips.
SAME_DEVICE_BA_TOL = 3e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def quat_err(qa, qb) -> float:
    return min(float(torch.linalg.norm(qa - qb)),
               float(torch.linalg.norm(qa + qb)))


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3 bandwidth. A kernel's bound is the larger
# of its operations over the first and its bytes over the second.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(flops: float, nbytes: float):
    """(bound_ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# Float operations the LM solves need, from the work each call reports (LM
# steps, CG trips, linearisations) and the problem's sizes; each edge term
# is counted once, although the kernels form it at both endpoints.
def joint_flops(work, P: int, E_live: int) -> float:
    """Per CG trip ~140 per point (reprojection Hv, 6x6 pose partials, the
    CG vector updates) and ~24 per live edge (damper + spring Hv term and
    its scatter); per linearisation ~220 per point (projection, Jacobians,
    H / g partials) and ~70 per live edge; per LM step ~70 per point (3x3
    block inverses, PCG start, trial flows)."""
    return (work["cg_trips"] * (140 * P + 24 * E_live)
            + work["linearizations"] * (220 * P + 70 * E_live)
            + work["lm_steps"] * 70 * P)


def ba_flops(work, K: int, P: int, E_live: int) -> float:
    """As joint_flops per landmark copy (K P) and per (keyframe, live edge),
    where a trip also carries the damper terms: ~105 per copy and ~36 per
    (keyframe, live edge) per trip."""
    return (work["cg_trips"] * (105 * K * P + 36 * K * E_live)
            + work["linearizations"] * (220 * K * P + 70 * K * E_live)
            + work["lm_steps"] * 70 * K * P)


def pose_only_flops(lm_steps: int, n_valid: int, rounds: int = 3) -> float:
    """~180 per valid point per evaluation of the 6x6 normal equations
    (transform, projection, Jacobian, 21 H + 6 g + chi2 partials), one
    evaluation per LM step plus one to start each round; ~40 per valid
    point per re-level (transform, projection, chi2), one between rounds."""
    return n_valid * (180 * (lm_steps + rounds) + 40 * (rounds - 1))


def pose_only_passes(lm_steps: int, rounds: int = 3) -> int:
    """Passes over the points one call makes: an evaluation per LM step and
    one to start each round, and a re-level between rounds (the last
    round's is not run)."""
    return lm_steps + rounds + (rounds - 1)


def pose_only_bytes(prep) -> int:
    """Inputs read once (camera, seed, points, observations, mask, schedule)
    and the output [8] written once."""
    return nbytes(*prep.tensors, prep.out)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def read_work(header):
    from nrslam_tpu_torch.solver.pose_deformation_cuda import WORK_FIELDS
    return dict(zip(WORK_FIELDS, header.tolist()))


def kernel_record(kernel_ms, wrapper_ms, plain_ms, flops, n_bytes, work):
    """A kernel's entry of the JSON record (its error is added later):
    ``ms`` is the wrapper call's time, as in every earlier record;
    ``kernel_ms`` the bare launch on prepared inputs."""
    bound_ms, by = bound(flops, n_bytes)
    return {"ms": wrapper_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "work": work}


def check_deterministic(label: str, launch, prep):
    """Two launches on the same prepared inputs give the same bits."""
    first = [t.clone() for t in launch(prep)]
    second = launch(prep)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[determinism] {label}: two launches bit-identical={same}")
    if not same:
        raise AssertionError(f"{label}: two launches on the same inputs "
                             "differ")


def check_pose_only(label, cam, T0, X, obs, valid, rounds=(10, 10, 10)):
    """Kernel 1 against the plain driver on one problem: |dq|, |dt| below
    SAME_DEVICE_POSE_TOL (the CPU tests' 1e-4 is implied), two launches
    bit-identical. Returns (max error, LM steps, the prepared launch, the
    plain driver's pose)."""
    from nrslam_tpu_torch.solver import pose_only
    from nrslam_tpu_torch.solver import pose_only_cuda as poc

    T_k = poc.camera_pose_optimization_cuda(cam, T0, X, obs, valid, rounds)
    steps = int(poc.last_lm_steps.item())
    T_p = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid,
                                                   rounds)
    dq, dt = quat_err(T_k.q, T_p.q), float(torch.linalg.norm(T_k.t - T_p.t))
    prep = poc.prepare(cam, T0, X, obs, valid, rounds)
    print(f"[kernel] pose_only {label}: |dq|={dq:.3e} |dt|={dt:.3e} (tol "
          f"{SAME_DEVICE_POSE_TOL:.0e}); {steps} LM steps; plan "
          f"{prep.plan._asdict()}")
    if not (dq < SAME_DEVICE_POSE_TOL and dt < SAME_DEVICE_POSE_TOL):
        raise AssertionError(f"pose_only {label} disagrees with plain")
    check_deterministic(f"pose_only {label}", lambda p: (poc.launch(p),),
                        prep)
    return (max(dq, float(torch.max(torch.abs(T_k.t - T_p.t)))), steps, prep,
            T_p)


SPREAD_PERMS = 8


def perm_spread(solve, cam, T0, X, obs, valid, T_ref, n: int):
    """The largest |dq|, |dt| of ``solve`` on n seeded permutations of the
    points against ``T_ref``, its unpermuted solve: what float32 summation
    order alone does to this problem."""
    dq = dt = 0.0
    for seed in range(n):
        perm = torch.randperm(X.shape[0], generator=torch.Generator()
                              .manual_seed(seed)).to(X.device)
        T = solve(cam, T0, X[perm], obs[perm], valid[perm])
        dq = max(dq, quat_err(T.q, T_ref.q))
        dt = max(dt, float(torch.linalg.norm(T.t - T_ref.t)))
    return dq, dt


def device_kernels_per_call(fn) -> dict:
    """The device operations one call of ``fn`` runs, by name, from
    torch.profiler (after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def pose_only_extras(dev):
    """Kernel 1 beyond the main shapes' checks: device kernels per wrapper
    call (must be 1), a 5-round schedule held to plain, and the spread that
    summation order alone gives (the kernel on 3 seeded permutations of the
    P=768 points against the unpermuted call; a measurement)."""
    from nrslam_tpu_torch.bench_problem import solver_problem
    from nrslam_tpu_torch.solver import pose_only_cuda as poc

    cam, T0, X, obs, valid, _ = solver_problem("pinhole", device=dev,
                                               with_pairs=False)
    ops = device_kernels_per_call(
        lambda: poc.camera_pose_optimization_cuda(cam, T0, X, obs, valid))
    n_ops = sum(ops.values())
    print(f"[kernel] pose_only: one wrapper call runs {n_ops} device "
          f"kernel(s) (torch.profiler): {ops}")
    if n_ops != 1:
        raise AssertionError(f"pose_only wrapper ran {n_ops} device kernels, "
                             "expected 1")
    err = check_pose_only("pinhole P=768 rounds=(3, 5, 2, 4, 6)", cam, T0, X,
                          obs, valid, rounds=(3, 5, 2, 4, 6))[0]
    solve = poc.camera_pose_optimization_cuda
    dq, dt = perm_spread(solve, cam, T0, X, obs, valid,
                         solve(cam, T0, X, obs, valid), 3)
    print(f"[spread] pose_only pinhole P=768: the kernel on 3 seeded "
          f"permutations of the points against the unpermuted call: max "
          f"|dq|={dq:.3e} |dt|={dt:.3e} (summation order alone; the "
          f"same-device gate is {SAME_DEVICE_POSE_TOL:.0e})")
    return err


def check_no_spills(log: str, kernel: str, instances: int):
    """ptxas's report (``-Xptxas -v``) of each of ``instances``
    instantiations of ``kernel`` shows no spill stores or loads. Fails when
    there is no report to read."""
    if not log:
        raise AssertionError(f"{kernel}: no ptxas report in kernels.build_log "
                             "(it is written beside the library at build)")
    lines = log.splitlines()
    reports = [lines[k + 1] for k, line in enumerate(lines[:-1])
               if "Function properties for" in line and kernel in line]
    clean = [r for r in reports
             if "0 bytes spill stores, 0 bytes spill loads" in r]
    print(f"[ptxas] {kernel}: {len(clean)} of {len(reports)} instantiations "
          f"without spills (expected {instances})")
    if len(reports) != instances or len(clean) != instances:
        raise AssertionError(f"{kernel}: spills or unexpected "
                             f"instantiations: {reports}")


def check_joint(label, cam, seed, X, obs, valid, cp):
    """The joint kernel against the plain driver on one problem: the CPU
    tests' tolerances, the same-device gates, two launches bit-identical.
    Returns (max error, the work the kernel reports, the prepared
    launch)."""
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc

    Tk, fk, ck = pdc.pose_deformation_cuda(cam, seed, X, obs, valid, cp, 1.0)
    work = read_work(pdc.last_work)
    Tp, fp, cpl = pd.pose_deformation_plain(cam, seed, X, obs, valid, cp, 1.0)
    dq, dt = quat_err(Tk.q, Tp.q), float(torch.linalg.norm(Tk.t - Tp.t))
    dflow = torch.linalg.norm(fk - fp, dim=-1)[valid]
    fmag = max(float(torch.median(torch.linalg.norm(fp, dim=-1))), 0.01)
    med = float(torch.median(dflow))
    flips = float(torch.mean(((ck <= pd.TH_2DOF) & valid)
                             .ne((cpl <= pd.TH_2DOF) & valid).float()))
    max_dflow = float(torch.max(dflow))
    print(f"[kernel] pose_deformation {label}: E={int(cp.i.shape[0])} "
          f"|dq|={dq:.3e} |dt|={dt:.3e} (tol {SAME_DEVICE_POSE_TOL:.0e}) "
          f"median|dflow|={med:.3e} "
          f"(tol {5e-3 * max(fmag / 0.01, 1.0):.3e}) "
          f"inlier flips={flips:.4f} (tol 0.03) "
          f"max|dflow|={max_dflow:.3e} (tol {SAME_DEVICE_FLOW_TOL:.0e})")
    if not (dq < 2e-3 and dt < 2e-3 and flips < 0.03
            and med < 5e-3 * max(fmag / 0.01, 1.0)):
        raise AssertionError(f"pose_deformation {label} disagrees")
    if not (dq < SAME_DEVICE_POSE_TOL and dt < SAME_DEVICE_POSE_TOL
            and max_dflow < SAME_DEVICE_FLOW_TOL):
        raise AssertionError(f"pose_deformation {label} disagrees with "
                             "plain beyond the same-device gates")
    prep = pdc.prepare(cam, seed, X, obs, valid, cp, 1.0)
    check_deterministic(f"pose_deformation {label}", pdc.launch, prep)
    return max(dq, dt, max_dflow), work, prep


def check_ba(label, cam, poses0, L0, prob, cg):
    """The BA kernel against the plain driver on one window: the CPU tests'
    1e-3 (tests/test_bundle_adjustment_pallas.py), the same-device gate on
    pose and every observed landmark copy, unobserved copies bit for bit,
    two launches bit-identical. Returns (max error, work, prepared
    launch)."""
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    K = L0.shape[0]
    pk, Lk = bac.local_deformable_ba_cuda(cam, poses0, L0, prob, cg_iters=cg)
    work = read_work(bac.last_work)
    pp, Lp = ba.local_deformable_ba_plain(cam, poses0, L0, prob, cg_iters=cg)
    live = prob.kf_valid
    seen = prob.obs_valid & live[:, None]
    dq = max(quat_err(pk.q[k], pp.q[k]) for k in range(K) if live[k])
    dt = float(torch.max(torch.linalg.norm(pk.t - pp.t, dim=-1)[live]))
    dL = float(torch.max(torch.linalg.norm(Lk - Lp, dim=-1)[seen]))
    moved = float(torch.max(torch.linalg.norm(Lp - L0, dim=-1)[seen]))
    same = bool(torch.equal(Lk[~seen], L0[~seen]))
    print(f"[kernel] bundle_adjustment {label}: E={prob.pairs.i.shape[0]} "
          f"|dq|={dq:.3e} |dt|={dt:.3e} max|dL|={dL:.3e} "
          f"(tol 1e-3, same-device {SAME_DEVICE_BA_TOL:.0e}; the plain "
          f"BA moved copies by up to {moved:.3e}) unobserved copies "
          f"unchanged={same}")
    if not (dq < 1e-3 and dt < 1e-3 and dL < 1e-3 and same):
        raise AssertionError(f"bundle_adjustment {label} disagrees")
    if not (dq < SAME_DEVICE_BA_TOL and dt < SAME_DEVICE_BA_TOL
            and dL < SAME_DEVICE_BA_TOL):
        raise AssertionError(f"bundle_adjustment {label} disagrees with "
                             "plain beyond the same-device gate")
    prep = bac.prepare(cam, poses0, L0, prob, cg_iters=cg)
    check_deterministic(f"bundle_adjustment {label}", bac.launch, prep)
    return max(dq, dt, dL), work, prep


def kernel_phase(dev):
    """Each kernel vs its plain version at the main-path shapes."""
    from nrslam_tpu_torch.bench_problem import solver_problem
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    rec = {}
    err_po = err_pd = 0.0
    for kind, P in (("pinhole", 768), ("kb8", 768), ("pinhole", 384),
                    ("kb8", 384)):
        cam, T0, X, obs, valid, pairs = solver_problem(kind, device=dev, P=P)
        main = P == 768
        label = f"{kind} P={P}"

        # Kernel 1: the same-device gate, two launches bit-identical; the
        # bare launch and the wrapper timed.
        err, po_steps, prep, T_p = check_pose_only(label, cam, T0, X, obs,
                                                   valid)
        err_po = max(err_po, err)
        ms_a = cuda_ms(lambda: pose_only_cuda.launch(prep))
        ms_k = cuda_ms(lambda: pose_only_cuda.camera_pose_optimization_cuda(
            cam, T0, X, obs, valid))
        ms_p = float("nan")
        if main:
            ms_p = cuda_ms(lambda: pose_only.camera_pose_optimization_plain(
                cam, T0, X, obs, valid))
        flops = pose_only_flops(po_steps, int(valid.sum()))
        n_b = pose_only_bytes(prep)
        b_ms, by = bound(flops, n_b)
        print(f"[kernel] pose_only {label}: kernel alone {ms_a:.4f} ms, "
              f"wrapper {ms_k:.4f} ms, plain {ms_p:.4f} ms; {po_steps} LM "
              f"steps, {1e3 * ms_a / pose_only_passes(po_steps):.3f} us per "
              f"pass (kernel alone / (LM steps + 3 rounds + 2 re-levels)); "
              f"bound "
              f"{b_ms:.6f} ms ({by}: {flops / 1e6:.3f} MFLOP, "
              f"{n_b / 1e6:.4f} MB), kernel/bound {ms_a / b_ms:.0f}")
        if main and kind == "pinhole":
            rec["pose_only"] = kernel_record(ms_a, ms_k, ms_p, flops, n_b,
                                             {"lm_steps": po_steps})

        # Kernel 2: the tolerances of tests/test_pose_deformation_pallas.py,
        # then the same-device gates on pose and on every point's flow.
        cp = pd.compact_pairs(pairs, X.shape[0], valid)
        err, work, prep = check_joint(label, cam, T_p, X, obs, valid, cp)
        err_pd = max(err_pd, err)
        ms_a = cuda_ms(lambda: pdc.launch(prep))
        ms_k = cuda_ms(lambda: pdc.pose_deformation_cuda(
            cam, T_p, X, obs, valid, cp, 1.0))
        E_live = int(prep.tensors[-3][-1]) // 2  # layout's inc_ptr[P]
        flops = joint_flops(work, P, E_live)
        n_b = nbytes(*prep.tensors, *prep.out)
        b_ms, by = bound(flops, n_b)
        ms_p = float("nan")
        if main:
            ms_p = cuda_ms(lambda: pd.pose_deformation_plain(
                cam, T_p, X, obs, valid, cp, 1.0), warmup=1, reps=5)
        print(f"[kernel] pose_deformation {label}: kernel alone {ms_a:.4f} ms, "
              f"wrapper {ms_k:.4f} ms, plain {ms_p:.4f} ms "
              f"(E={int(cp.i.shape[0])}, {E_live} live edges); work {work}; "
              f"{1e3 * ms_a / max(work['cg_trips'], 1):.2f} us per CG trip; "
              f"bound {b_ms:.6f} ms ({by}: {flops / 1e6:.2f} MFLOP, "
              f"{n_b / 1e6:.3f} MB), kernel/bound {ms_a / b_ms:.0f}")
        if main and kind == "pinhole":
            rec["pose_deformation"] = kernel_record(ms_a, ms_k, ms_p, flops,
                                                    n_b, work)
    rec["pose_only"]["err"] = max(err_po, pose_only_extras(dev))
    rec["pose_deformation"]["err"] = err_pd
    rec["bundle_adjustment"] = ba_kernel_phase(dev)
    torch.cuda.synchronize()
    return rec


def phase_kernel_ms(fn, names) -> tuple:
    """(device ms of the phase kernels of one call of ``fn``, their
    launches), from torch.profiler after one warm-up call: the sum of the
    CUDA kernels whose name holds ``nrslam`` and one of ``names``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "nrslam" in e.key and any(k in e.key for k in names)):
            us += getattr(e, "device_time_total", None) or e.cuda_time_total
            n += e.count
    return us / 1e3, n


def permuted(perm, X, obs, valid, pairs):
    """The problem with its points reordered by ``perm`` (edges keep their
    order and follow their endpoints)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return X[perm], obs[perm], valid[perm], pairs._replace(
        i=inv[pairs.i.long()], j=inv[pairs.j.long()])


def joint_spread(cam, seed, X, obs, valid, cp, n: int):
    """The plain joint driver's own spread on this card under n seeded
    permutations of the points against its unpermuted solve: (largest
    |dq|, |dt|; largest per-point |dflow| over valid points)."""
    from nrslam_tpu_torch.solver import pose_deformation as pd

    T_r, f_r, _ = pd.pose_deformation_plain(cam, seed, X, obs, valid, cp, 1.0)
    dpose = dflow = 0.0
    for k in range(n):
        perm = torch.randperm(X.shape[0], generator=torch.Generator()
                              .manual_seed(k)).to(X.device)
        T, f, _ = pd.pose_deformation_plain(
            cam, seed, *permuted(perm, X, obs, valid, cp), 1.0)
        dpose = max(dpose, quat_err(T.q, T_r.q),
                    float(torch.linalg.norm(T.t - T_r.t)))
        back = torch.empty_like(f)
        back[perm] = f
        dflow = max(dflow, float(torch.max(torch.linalg.norm(
            back - f_r, dim=-1)[valid])))
    return dpose, dflow


def shard_kernel_phase(dev, whole: dict):
    """The sharded pose-only and joint routes (parallel/solve_shard.py on
    CUDA tensors: the phase kernels of csrc/pose_only_shard.cu and
    csrc/pose_deformation_shard.cu) in this process without a process
    group, so they solve the whole problem, held to the whole-solver
    kernels and to the plain drivers at P=768 (E=5376) and P=384, pinhole
    and KB8: on the rigid scene (deform_amp=0) under the same-device gates;
    on the deformed scene (P=768) within 3x the plain driver's own spread
    over SPREAD_PERMS seeded permutations of the points (never below the
    same-device gates); two calls bit-identical; each call's phase
    launches as ``shard_phase_launches`` counts them. Times the wrapper
    (CUDA events) and the sum of its phase launches (torch.profiler) beside
    the whole-solver kernel; the plain drivers' times are ``whole``'s (the
    [kernel] records, the same problem). Returns the two routes'
    records."""
    from nrslam_tpu_torch.bench_problem import solver_problem
    from nrslam_tpu_torch.parallel import sharding, solve_shard
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only
    from nrslam_tpu_torch.solver import pose_only_cuda as poc

    mesh = sharding.make_mesh(dev)
    assert mesh.group is None
    rec, err = {}, {"pose_only_shard": 0.0, "pose_deformation_shard": 0.0}
    for kind, P, deform in (("pinhole", 768, 0.0), ("pinhole", 768, 0.05),
                            ("kb8", 768, 0.0), ("kb8", 768, 0.05),
                            ("pinhole", 384, 0.0), ("kb8", 384, 0.0)):
        cam, T0, X, obs, valid, pairs = solver_problem(
            kind, device=dev, P=P, deform_amp=deform)
        label = f"{kind} P={P} {'rigid' if deform == 0 else 'deformed'}"

        def pose_call():
            return solve_shard.camera_pose_optimization_sharded(
                mesh, cam, T0, X, obs, valid)

        before = dict(poc.shard_launches)
        T_s = pose_call()
        one = {k: v - before[k] for k, v in poc.shard_launches.items()}
        T_w = poc.camera_pose_optimization_cuda(cam, T0, X, obs, valid)
        T_p = pose_only.camera_pose_optimization_plain(cam, T0, X, obs,
                                                       valid)
        T_2 = pose_call()
        same = torch.equal(T_s.q, T_2.q) and torch.equal(T_s.t, T_2.t)
        d_w = max(quat_err(T_s.q, T_w.q), float(torch.linalg.norm(
            T_s.t - T_w.t)))
        d_p = max(quat_err(T_s.q, T_p.q), float(torch.linalg.norm(
            T_s.t - T_p.t)))
        tol, gate = SAME_DEVICE_POSE_TOL, "same-device gate"
        if deform:
            sq, st = perm_spread(pose_only.camera_pose_optimization_plain,
                                 cam, T0, X, obs, valid, T_p, SPREAD_PERMS)
            tol = max(tol, 3 * max(sq, st))
            gate = (f"3x the plain driver's spread under {SPREAD_PERMS} "
                    f"permutations, {max(sq, st):.3e}")
        print(f"[kernel] pose_only_shard {label}: against the whole-solver "
              f"kernel {d_w:.3e}, against plain {d_p:.3e} (tol {tol:.3e}, "
              f"{gate}); phase launches {one}")
        print(f"[determinism] pose_only_shard {label}: two calls "
              f"bit-identical={same}")
        if not (same and d_w < tol and d_p < tol
                and one == poc.shard_phase_launches()):
            raise AssertionError(f"pose_only_shard {label} outside gates")
        if not deform:
            err["pose_only_shard"] = max(err["pose_only_shard"], d_w)

        cp = pd.compact_pairs(pairs, P, valid)
        seed = T_p

        def joint_call():
            return solve_shard.pose_deformation_sharded(
                mesh, cam, seed, X, obs, valid, pairs, 1.0)

        before = dict(pdc.shard_launches)
        r_s = joint_call()
        one_j = {k: v - before[k] for k, v in pdc.shard_launches.items()}
        work = dict(zip(pdc.SHARD_WORK_FIELDS,
                        pdc.shard_last_work.int().tolist()))
        r_2 = joint_call()
        same = (torch.equal(r_s.flows, r_2.flows)
                and torch.equal(r_s.Tcw.q, r_2.Tcw.q)
                and torch.equal(r_s.Tcw.t, r_2.Tcw.t))
        T_k, f_k, _ = pdc.pose_deformation_cuda(cam, seed, X, obs, valid, cp,
                                                1.0)
        T_j, f_j, _ = pd.pose_deformation_plain(cam, seed, X, obs, valid, cp,
                                                1.0)

        def diffs(T, f):
            return (max(quat_err(r_s.Tcw.q, T.q), float(torch.linalg.norm(
                r_s.Tcw.t - T.t))), float(torch.max(torch.linalg.norm(
                    r_s.flows - f, dim=-1)[valid])))

        (dpw, dfw), (dpp, dfp) = diffs(T_k, f_k), diffs(T_j, f_j)
        tp, tf, gate = SAME_DEVICE_POSE_TOL, SAME_DEVICE_FLOW_TOL, \
            "same-device gates"
        if deform:
            sp, sf = joint_spread(cam, seed, X, obs, valid, cp, SPREAD_PERMS)
            tp, tf = max(tp, 3 * sp), max(tf, 3 * sf)
            gate = (f"3x the plain driver's spread under {SPREAD_PERMS} "
                    f"permutations, pose {sp:.3e}, flow {sf:.3e}")
        print(f"[kernel] pose_deformation_shard {label}: against the "
              f"whole-solver kernel pose {dpw:.3e} max|dflow| {dfw:.3e}, "
              f"against plain pose {dpp:.3e} max|dflow| {dfp:.3e} (tol pose "
              f"{tp:.3e}, flow {tf:.3e}, {gate}); work {work}; phase "
              f"launches {one_j}")
        print(f"[determinism] pose_deformation_shard {label}: two calls "
              f"bit-identical={same}")
        if not (same and dpw < tp and dpp < tp and dfw < tf and dfp < tf
                and one_j == pdc.shard_phase_launches()):
            raise AssertionError(f"pose_deformation_shard {label} outside "
                                 "gates")
        if not deform:
            err["pose_deformation_shard"] = max(
                err["pose_deformation_shard"], dpw, dfw)

        if (kind, P, deform) != ("pinhole", 768, 0.05):
            continue
        # Timed at the [kernel] records' problem (pinhole, P=768, deformed).
        ms_po, ms_pd = cuda_ms(pose_call), cuda_ms(joint_call, 2, 10)
        k_po, n_po = phase_kernel_ms(pose_call, ("partials_kernel",
                                                 "step_kernel",
                                                 "relevel_kernel"))
        k_pd, n_pd = phase_kernel_ms(joint_call, ("init_kernel", "lin_kernel",
                                                  "step_kernel", "hv_kernel",
                                                  "cg_kernel"))
        w_po = cuda_ms(lambda: poc.camera_pose_optimization_cuda(
            cam, T0, X, obs, valid))
        w_pd = cuda_ms(lambda: pdc.pose_deformation_cuda(
            cam, seed, X, obs, valid, cp, 1.0))
        p_po = whole["pose_only"]["plain_ms"]
        p_pd = whole["pose_deformation"]["plain_ms"]
        steps = int(poc.shard_last_steps.item())
        flops = pose_only_flops(steps, int(valid.sum()))
        n_b = nbytes(cam.params, T0.q, T0.t, X, obs, valid) + 7 * 4
        rec["pose_only_shard"] = kernel_record(k_po, ms_po, p_po, flops, n_b,
                                               {"lm_steps": steps})
        E_live = int((cp.valid & valid[cp.i.long()]
                      & valid[cp.j.long()]).sum())
        jflops = joint_flops(work, P, E_live)
        jb = (nbytes(cam.params, seed.q, seed.t, X, obs, valid, cp.i, cp.j,
                     cp.w, cp.d0, cp.valid) + nbytes(r_s.flows)
              + 4 * P + 7 * 4)
        rec["pose_deformation_shard"] = kernel_record(k_pd, ms_pd, p_pd,
                                                      jflops, jb, work)
        for name, ms, k_ms, n_k, whole, plain in (
                ("pose_only_shard", ms_po, k_po, n_po, w_po, p_po),
                ("pose_deformation_shard", ms_pd, k_pd, n_pd, w_pd, p_pd)):
            r = rec[name]
            print(f"[kernel] {name} {label}: wrapper {ms:.4f} ms, its "
                  f"{n_k} phase launches {k_ms:.4f} ms of device time "
                  f"(torch.profiler), the whole-solver wrapper "
                  f"{whole:.4f} ms, plain {plain:.4f} ms; bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']}), phase "
                  f"kernels / bound {k_ms / r['bound_ms']:.0f}")
    for name in rec:
        rec[name]["err"] = err[name]
    torch.cuda.synchronize()
    return rec


def ba_shard_kernel_phase(dev, whole: dict):
    """The window BA's partitioned route (parallel/ba_points.py on CUDA
    tensors: the phase kernels of csrc/bundle_adjustment_shard.cu) in this
    process without a process group, so it solves the whole window, at the
    keyframe's shapes (W=5, P=768, E=5376, Config().ba_cg_iters), held to
    the whole-solver BA kernel and to the plain BA under the same-device BA
    gate on pose and every observed copy: pinhole on the deformed (0.02)
    and the rigid window, KB8, a window with 3 of 5 slots valid, and the
    deformed pinhole window at the sharded frame's P=4096;
    unobserved copies unchanged; two calls bit-identical; each call's phase
    launches as ``shard_phase_launches`` counts them. Times the wrapper
    (CUDA events) and the sum of its phase launches' device time
    (torch.profiler) on the deformed pinhole window beside the
    whole-solver wrapper; plain's time is ``whole``'s (the [kernel] record,
    the same window). Returns the route's record."""
    from nrslam_tpu_torch.bench_problem import ba_problem
    from nrslam_tpu_torch.parallel import ba_points, sharding
    from nrslam_tpu_torch.slam.state import Config
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    mesh = sharding.make_mesh(dev)
    assert mesh.group is None
    cg = Config().ba_cg_iters
    err, rec = 0.0, None
    for kind, n_valid, deform, P in (
            ("pinhole", 5, 0.02, 768), ("pinhole", 5, 0.0, 768),
            ("kb8", 5, 0.02, 768), ("pinhole", 3, 0.02, 768),
            ("pinhole", 5, 0.02, 4096)):
        cam, poses0, L0, prob = ba_problem(kind, n_valid, device=dev,
                                           deform_amp=deform, P=P)
        label = (f"{kind} P={P} {n_valid}/5 valid "
                 f"{'rigid' if deform == 0 else 'deformed'}")

        def call():
            return ba_points.local_deformable_ba_sharded(
                mesh, cam, poses0, L0, prob, 5, cg)

        before = dict(bac.shard_launches)
        p_s, L_s = call()
        one = {k: v - before[k] for k, v in bac.shard_launches.items()}
        work = dict(zip(("lm_steps", "cg_trips", "linearizations"),
                        bac.shard_last_work.int().tolist()))
        p_2, L_2 = call()
        same = (torch.equal(L_s, L_2) and torch.equal(p_s.q, p_2.q)
                and torch.equal(p_s.t, p_2.t))
        live = prob.kf_valid
        seen = prob.obs_valid & live[:, None]

        def diffs(p, L):
            dq = max(quat_err(p_s.q[k], p.q[k]) for k in range(5) if live[k])
            dt = float(torch.max(torch.linalg.norm(p_s.t - p.t,
                                                   dim=-1)[live]))
            return max(dq, dt), float(torch.max(torch.linalg.norm(
                L_s - L, dim=-1)[seen]))

        (dpw, dLw) = diffs(*bac.local_deformable_ba_cuda(cam, poses0, L0,
                                                         prob, cg_iters=cg))
        (dpp, dLp) = diffs(*ba.local_deformable_ba_plain(cam, poses0, L0,
                                                         prob, 5, cg))
        unchanged = bool(torch.equal(L_s[~seen], L0[~seen]))
        tol = SAME_DEVICE_BA_TOL
        print(f"[kernel] bundle_adjustment_shard {label}: against the "
              f"whole-solver kernel pose {dpw:.3e} max|dL| {dLw:.3e}, "
              f"against plain pose {dpp:.3e} max|dL| {dLp:.3e} (tol "
              f"{tol:.0e}, same-device gate); unobserved copies unchanged="
              f"{unchanged}; work {work}; phase launches {one}")
        print(f"[determinism] bundle_adjustment_shard {label}: two calls "
              f"bit-identical={same}")
        if not (same and unchanged and max(dpw, dLw, dpp, dLp) < tol
                and one == bac.shard_phase_launches(cg_iters=cg)):
            raise AssertionError(f"bundle_adjustment_shard {label} outside "
                                 "gates")
        err = max(err, dpw, dLw)
        if (kind, n_valid, deform, P) != ("pinhole", 5, 0.02, 768):
            continue
        ms = cuda_ms(call, 2, 10)
        k_ms, n_k = phase_kernel_ms(call, ("init_kernel", "lin_kernel",
                                           "step_kernel", "hv_kernel",
                                           "cg_kernel"))
        w_ms = cuda_ms(lambda: bac.local_deformable_ba_cuda(
            cam, poses0, L0, prob, cg_iters=cg))
        E_live = int(torch.any(ba._masks(prob._replace(
            pairs=prob.pairs._replace(i=prob.pairs.i.long(),
                                      j=prob.pairs.j.long())))[1],
            dim=0).sum())
        flops = ba_flops(work, 5, L0.shape[1], E_live)
        n_b = (nbytes(cam.params, poses0.q, poses0.t, L0, prob.obs,
                      prob.obs_valid, prob.pairs.i, prob.pairs.j,
                      prob.pairs.w, prob.pairs.d0, prob.pairs.valid)
               + nbytes(L_s) + 5 * 7 * 4)
        rec = kernel_record(k_ms, ms, whole["bundle_adjustment"]["plain_ms"],
                            flops, n_b, work)
        print(f"[kernel] bundle_adjustment_shard {label}: wrapper {ms:.4f} "
              f"ms, its {n_k} phase launches {k_ms:.4f} ms of device time "
              f"(torch.profiler), the whole-solver wrapper {w_ms:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms; {E_live} live edges; bound "
              f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}: "
              f"{flops / 1e6:.2f} MFLOP, {n_b / 1e6:.3f} MB), phase kernels "
              f"/ bound {k_ms / rec['bound_ms']:.0f}")
    rec["err"] = err
    torch.cuda.synchronize()
    return rec


def ba_kernel_phase(dev):
    """Kernel 3 vs the plain BA driver at the keyframe's shapes: the CPU
    tests' 1e-3 (tests/test_bundle_adjustment_pallas.py), then the
    same-device gate, on pose and on every observed landmark copy;
    unobserved copies returned bit for bit."""
    from nrslam_tpu_torch.bench_problem import ba_problem
    from nrslam_tpu_torch.slam.state import Config
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac

    cg = Config().ba_cg_iters
    r = None
    err = 0.0
    for kind, n_valid in (("pinhole", 5), ("kb8", 5), ("pinhole", 3)):
        cam, poses0, L0, prob = ba_problem(kind, n_valid, device=dev)
        label = f"{kind} {n_valid}/5 valid"
        e, work, prep = check_ba(label, cam, poses0, L0, prob, cg)
        err = max(err, e)
        ms_a = cuda_ms(lambda: bac.launch(prep))
        ms_k = cuda_ms(lambda: bac.local_deformable_ba_cuda(
            cam, poses0, L0, prob, cg_iters=cg))
        ms_p = cuda_ms(lambda: ba.local_deformable_ba_plain(
            cam, poses0, L0, prob, cg_iters=cg), warmup=1, reps=5)
        K, P = L0.shape[0], L0.shape[1]
        E_live = int(prep.tensors[-3][-1]) // 2  # layout's inc_ptr[P]
        flops = ba_flops(work, K, P, E_live)
        n_b = nbytes(*prep.tensors, *prep.out)
        b_ms, by = bound(flops, n_b)
        print(f"[kernel] bundle_adjustment {label}: kernel alone {ms_a:.4f} "
              f"ms, wrapper {ms_k:.4f} ms, plain {ms_p:.4f} ms (K={K}, "
              f"P={P}, cg_iters={cg}, {E_live} live edges); work {work}; "
              f"{1e3 * ms_a / max(work['cg_trips'], 1):.2f} us per CG trip; "
              f"bound {b_ms:.6f} ms ({by}: {flops / 1e6:.2f} MFLOP, "
              f"{n_b / 1e6:.3f} MB), kernel/bound {ms_a / b_ms:.0f}")
        if n_valid == 5 and kind == "pinhole":
            r = kernel_record(ms_a, ms_k, ms_p, flops, n_b, work)
    r["err"] = err
    return r


def block_ends(prep) -> int:
    """The most edge-ends any block of a prepared launch owns."""
    off, ptr = prep.tensors[-4].long(), prep.tensors[-3].long()
    return int(torch.max(ptr[off[1:]] - ptr[off[:-1]]))


def overflow_phase(dev):
    """The shared-memory plans the main path does not reach, each held to
    the plain driver under the same gates as the main shapes: the pose-only
    kernel at P=768 with 64 threads (points in shared memory too), then at
    P=131, 4096 and 16384 (see below); the joint at P=4096 (full copies in
    global memory, z exchanged by pulls, edge-end records overflowing) and
    P=9216 (owned state in global memory too); the BA at K=8 with P=768
    (edge-end records overflowing), P=1536 (full copies in global memory)
    and P=2048 (owned state in global memory).
    Each case checks that its launch took the plan it is meant to force
    (the kernel's header)."""
    from nrslam_tpu_torch.bench_problem import ba_problem, solver_problem
    from nrslam_tpu_torch.slam.state import Config
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only

    def report(name, label, work, prep, launch, forced):
        ends = block_ends(prep)
        plan = {"owned state in smem": work["owned_state_in_smem"],
                "full copies in smem": work["full_vectors_in_smem"],
                "edge-end records in smem": work["edge_ends_in_smem"],
                "most edge-ends of a block": ends}
        ms = cuda_ms(lambda: launch(prep), warmup=1, reps=5)
        print(f"[overflow] {name} {label}: plan {plan}, kernel alone "
              f"{ms:.4f} ms, work {work}")
        want = {"records": work["edge_ends_in_smem"] < ends,
                "full": work["full_vectors_in_smem"] == 0,
                "owned": work["owned_state_in_smem"] == 0}
        if not all(want[f] for f in forced):
            raise AssertionError(f"{name} {label}: the launch did not take "
                                 f"the plan it was meant to force {forced}")

    # Kernel 1: a plan with points in shared memory forced at P=768 on the
    # frame's problem, then the sizes that take each plan by default (P=131
    # ragged in registers, 4096 in shared memory, 16384 also in global
    # memory) on the same scene made rigid, all under the same-device gate;
    # then P=16384 on the deformed scene. There the unmodelled flow (up to
    # ~8 px) leaves points at the 5.99 re-level threshold, so float32
    # summation order alone moves the solve (the plain driver on the CPU
    # under a permutation of the points: up to 4.7e-4, rigid <= 3.3e-6):
    # that case is held to 3x the plain driver's own spread on the card
    # under SPREAD_PERMS seeded permutations of the same problem (never
    # below the same-device gate), and both readings are printed.
    from nrslam_tpu_torch.solver import pose_only_cuda as poc
    for P, deform, threads, where in ((768, 0.05, 64, "shared"),
                                      (131, 0.0, None, "registers"),
                                      (4096, 0.0, None, "shared"),
                                      (16384, 0.0, None, "global"),
                                      (16384, 0.05, None, "global")):
        cam, T0, X, obs, valid, _ = solver_problem(
            "pinhole", device=dev, P=P, with_pairs=False, deform_amp=deform)
        prep = poc.prepare(cam, T0, X, obs, valid, threads=threads)
        pl = prep.plan
        label = (f"pinhole P={P} {'rigid' if deform == 0 else 'deformed'} "
                 f"threads={pl.threads} ({where})")
        out = poc.launch(prep)
        T_p = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid)
        dq, dt = quat_err(out[:4], T_p.q), float(torch.linalg.norm(
            out[4:7] - T_p.t))
        check_deterministic(f"pose_only {label}", lambda p: (poc.launch(p),),
                            prep)
        ms = cuda_ms(lambda: poc.launch(prep), warmup=1, reps=5)
        tol, gate = SAME_DEVICE_POSE_TOL, "same-device gate"
        if deform and P > 768:
            sq, st = perm_spread(pose_only.camera_pose_optimization_plain,
                                 cam, T0, X, obs, valid, T_p, SPREAD_PERMS)
            tol = max(SAME_DEVICE_POSE_TOL, 3 * max(sq, st))
            gate = (f"3x the plain driver's spread under {SPREAD_PERMS} "
                    f"permutations on this card, |dq|={sq:.3e} "
                    f"|dt|={st:.3e}")
        print(f"[overflow] pose_only {label}: plan {pl._asdict()}, "
              f"|dq|={dq:.3e} |dt|={dt:.3e} (tol {tol:.3e}, {gate}), "
              f"kernel alone {ms:.4f} ms")
        took = {"registers": pl.n_sh == pl.n_gl == 0,
                "shared": pl.n_sh > 0 and pl.n_gl == 0,
                "global": pl.n_gl > 0}[where]
        if not took:
            raise AssertionError(f"pose_only {label}: the plan does not keep "
                                 f"points in {where} memory")
        if not (dq < tol and dt < tol):
            raise AssertionError(f"pose_only {label} disagrees with plain")

    for P, forced in ((4096, ("full", "records")), (9216, ("owned",))):
        cam, T0, X, obs, valid, pairs = solver_problem("pinhole", device=dev,
                                                       P=P)
        seed = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid)
        cp = pd.compact_pairs(pairs, P, valid)
        label = f"pinhole P={P}"
        _, work, prep = check_joint(label, cam, seed, X, obs, valid, cp)
        report("pose_deformation", label, work, prep, pdc.launch, forced)
    cg = Config().ba_cg_iters
    for P, forced in ((768, ("records",)), (1536, ("full", "records")),
                      (2048, ("owned",))):
        cam, poses0, L0, prob = ba_problem("pinhole", 8, device=dev, K=8, P=P)
        label = f"pinhole K=8 P={P}"
        _, work, prep = check_ba(label, cam, poses0, L0, prob, cg)
        report("bundle_adjustment", label, work, prep, bac.launch, forced)


def compare_states(a, b, label: str):
    """Slice tolerances, landmarks matched by track id: statuses equal on
    >= 98% of the ids either state uses, pose <= 1e-3, positions and
    keypoints of the status-agreeing landmarks within a median of 1e-3.
    (When both states hold the same ids in the same slots, as the slice
    phase's do, this is the slot-by-slot comparison.)"""
    ida = torch.where(a.slot_used, a.track_id, -1).cpu()
    idb = torch.where(b.slot_used, b.track_id, -1).cpu()
    match = (ida[:, None] == idb[None, :]) & (ida[:, None] >= 0)
    has = match.any(dim=1)
    jb = match.to(torch.int32).argmax(dim=1)
    n_ids = int(a.slot_used.sum()) + int(b.slot_used.sum()) - int(has.sum())
    agree = has & (a.status.cpu() == b.status.cpu()[jb])
    frac = float(agree.sum()) / max(n_ids, 1)
    dq = quat_err(a.Tcw.q.cpu(), b.Tcw.q.cpu())
    dt = float(torch.linalg.norm(a.Tcw.t.cpu() - b.Tcw.t.cpu()))
    dpos = torch.linalg.norm(a.positions.cpu() - b.positions.cpu()[jb],
                             dim=-1)[agree]
    dkp = torch.linalg.norm(a.keypoints.cpu() - b.keypoints.cpu()[jb],
                            dim=-1)[agree]
    mp, mk = float(torch.median(dpos)), float(torch.median(dkp))
    print(f"[slice-parity] {label}: status agree {frac:.4f} of {n_ids} "
          f"landmarks |dq|={dq:.2e} |dt|={dt:.2e} median|dpos|={mp:.2e} "
          f"median|dkp|={mk:.2e}")
    if not (frac >= 0.98 and dq <= 1e-3 and dt <= 1e-3 and mp <= 1e-3
            and mk <= 1e-3):
        raise AssertionError(f"slice parity failed at {label}")


def slice_parity(dev):
    from nrslam_tpu_torch import bench_problem, convert
    from nrslam_tpu_torch.slam import system

    s_cpu, frames, mask, cam, config = bench_problem.build_bench_problem(
        384, 240, 320, 128, device="cpu")
    s_gpu = convert.to_device(s_cpu, dev)
    f_gpu = [f.to(dev) for f in frames]
    m_gpu, cam_gpu = mask.to(dev), convert.to_device(cam, dev)
    for i, kf in enumerate([False, True, False, True, False, True]):
        s_cpu, _ = system.frame_step(s_cpu, frames[i], mask, cam, config, kf)
        s_gpu, _ = system.frame_step(s_gpu, f_gpu[i], m_gpu, cam_gpu, config,
                                     kf)
        compare_states(s_gpu, s_cpu, f"frame {i} kf={kf}")


def system_parity(dev):
    """The System from frame 0 on the card and on the CPU, same frames and
    draws, through the init, bootstrap_map and two keyframes.

    The scene is the default 320x240 one with more relief (1.0 instead of
    0.25) and a faster camera (0.03 instead of 0.012 per frame): with the
    defaults the surface is nearly planar and the init's baseline small,
    which leaves the two-view geometry ill-determined in float32. There, a
    1e-5 px change of the tracked keypoints (the card's KLT differs from
    the CPU's by up to 3e-5 px) moves the bootstrap's landmarks by ~6e-3
    and can flip which frame initialises (measured on the CPU; on an NVIDIA
    H100 the card initialised one frame before the CPU). Here the same
    change moves them by ~2e-5."""
    from nrslam_tpu_torch import convert
    from nrslam_tpu_torch.datasets import synthetic
    from nrslam_tpu_torch.slam import initializer, system
    from nrslam_tpu_torch.slam.state import Config

    scene = synthetic.SceneConfig(relief=1.0, motion_translation=0.03)
    seq = synthetic.SyntheticSequence(scene, n_frames=40, device="cpu")
    cam = synthetic.camera(scene, device="cpu")
    config = Config(max_points=384, max_new_keypoints=128,
                    rad_per_pixel=1.0 / scene.fx)
    init_config = initializer.InitializerConfig(
        max_features=384, min_matches=60, min_triangulated=50,
        rad_per_pixel=1.0 / scene.fx, n_hypotheses=48)
    s_cpu = system.System(cam, config, init_config)
    s_gpu = system.System(convert.to_device(cam, dev), config, init_config)
    init_frame, keyframes = None, 0
    for i in range(len(seq)):
        gray, depth, _ = seq.get_frame(i)
        o_cpu = s_cpu.track_image_with_depth(gray, depth)
        o_gpu = s_gpu.track_image_with_depth(gray, depth)
        if s_cpu.status != s_gpu.status:
            raise AssertionError(f"system parity: frame {i} status "
                                 f"{s_gpu.status} on the card, "
                                 f"{s_cpu.status} on the CPU")
        if s_cpu.status != system.TRACKING:
            continue
        if init_frame is None:
            init_frame = i
            print(f"[system-parity] both initialised at frame {i}")
        compare_states(s_gpu.state, s_cpu.state, f"system frame {i}")
        d_rmse = abs(float(o_gpu["depth_rmse"]) - float(o_cpu["depth_rmse"]))
        if d_rmse > 1e-3:
            raise AssertionError(f"system parity: depth RMSE differs by "
                                 f"{d_rmse} at frame {i}")
        keyframes += bool(o_cpu.get("keyframe"))
        if keyframes == 2:
            break
    if init_frame is None or keyframes < 2:
        raise AssertionError(f"system parity: init frame {init_frame}, "
                             f"{keyframes} keyframes in {len(seq)} frames")
    print(f"[system-parity] 320x240 P=384 relief {scene.relief} speed "
          f"{scene.motion_translation}: "
          f"init frame {init_frame} equal, "
          f"tracked frames {init_frame}-{i} within the slice tolerances, "
          f"{keyframes} keyframes (last BA window "
          f"{int(s_gpu.state.kf_valid.sum())} keyframes)")


def slice_at_scale(dev, card: str, P: int, H: int, W: int, new_kp: int):
    """4 warm-up frames (the last two under sync_debug_mode="error"), then 10
    timed frames at the 1-in-5 keyframe cadence. Returns the launch counts
    of the timed run."""
    from nrslam_tpu_torch import bench_problem
    from nrslam_tpu_torch.slam import system
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    state, frames, mask, cam, config = bench_problem.build_bench_problem(
        P, H, W, new_kp, device=dev)
    s = state
    for i, kf in enumerate([False, True]):
        s, _ = system.frame_step(s, frames[i], mask, cam, config, kf)
    torch.cuda.synchronize()
    # No host synchronisation on the frame path (both specializations).
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, kf in enumerate([False, True]):
            s, _ = system.frame_step(s, frames[2 + i], mask, cam, config, kf)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)

    reset_launches()
    n = 10
    t0 = time.perf_counter()
    for i in range(n):
        s, res = system.frame_step(s, frames[i % len(frames)], mask, cam,
                                   config, (i % 5) == 4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"pose_only": pose_only_cuda.launches,
                "pose_deformation": pdc.launches,
                "bundle_adjustment": bac.launches}
    n3d, lost = int(res.n_tracked_3d), bool(res.lost)
    finite = bool(torch.isfinite(s.positions).all())
    print(f"[scale] {W}x{H} P={P}: {n} frames in {dt:.3f} s = "
          f"{n / dt:.2f} frames/s, {1e3 * dt / n:.2f} ms/frame on {card}; "
          f"n_tracked_3d={n3d} lost={lost} finite={finite} "
          f"launches={launches}; warm-up frames 3-4 had no host syncs")
    if lost or n3d < 10 or not finite:
        raise AssertionError("slice at scale: map lost or non-finite")
    check_launches(f"scale {W}x{H}", n, n // 5)


def run_system(dev, n: int = 60):
    """System.track_image_with_depth from frame 0 on the synthetic sequence
    at 640x480, P=768, 256 new keypoints, default initializer, on `dev`.
    Returns the run's record: per-frame ms by kind, init frame, the camera
    position of every tracked frame, median depth RMSE, Sim(3) ATE, the
    launch counts, the two-view refinements and the inputs of their
    pose-only solves."""
    from nrslam_tpu_torch.datasets import synthetic
    from nrslam_tpu_torch.eval import metrics
    from nrslam_tpu_torch.slam import initializer, system
    from nrslam_tpu_torch.slam.state import Config
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    scene = synthetic.SceneConfig(height=480, width=640, deform_amp=0.02)
    seq = synthetic.SyntheticSequence(scene, n_frames=n, device=dev)
    cam = synthetic.camera(scene, dev)
    config = Config(max_points=768, max_new_keypoints=256,
                    rad_per_pixel=1.0 / scene.fx)
    sysm = system.System(cam, config)
    reset_launches()
    ms = {"init": [], "keyframe": [], "non-keyframe": []}
    est, gt, poses, init_frame, out = [], [], {}, None, {}
    refine_inputs = []
    solve = pose_only.camera_pose_optimization

    def recording_solve(cam, T0, X, obs, valid, *args):
        if sysm.status != system.TRACKING:
            refine_inputs.append((cam, T0, X, obs, valid))
        return solve(cam, T0, X, obs, valid, *args)

    pose_only.camera_pose_optimization = recording_solve
    try:
        for i in range(n):
            gray, depth, T_gt = seq.get_frame(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            was_init = sysm.status != system.TRACKING
            out = sysm.track_image_with_depth(gray, depth)
            torch.cuda.synchronize()
            dt_ms = 1e3 * (time.perf_counter() - t0)
            kind = "init" if was_init else (
                "keyframe" if out["keyframe"] else "non-keyframe")
            ms[kind].append(dt_ms)
            if sysm.status == system.TRACKING:
                init_frame = i if init_frame is None else init_frame
                est.append(sysm.state.Tcw)
                gt.append(T_gt)
                poses[i] = sysm.state.Tcw.t.cpu()
    finally:
        pose_only.camera_pose_optimization = solve
    return {
        "status": sysm.status, "tracking": sysm.status == system.TRACKING,
        "ms": ms, "init_frame": init_frame, "poses": poses,
        "rmse": statistics.median(sysm.evaluator.rmse_history),
        "ate": metrics.ate_rmse(est, gt, with_scale=True),
        "n_tracked": len(est), "n3d": int(out.get("n_tracked_3d", 0)),
        "finite": sysm.state is not None and bool(
            torch.isfinite(sysm.state.positions).all()),
        "launches": {"pose_only": pose_only_cuda.launches,
                     "pose_deformation": pdc.launches,
                     "bundle_adjustment": bac.launches},
        "refines": initializer.refines, "refine_inputs": refine_inputs}


def system_at_scale(dev, card: str, n: int = 60):
    """The main path: the System from frame 0 at 640x480, P=768. Returns
    the launch counts of the run and the inputs of the pose-only solves
    made on init frames (the two-view refinement's)."""
    run = run_system(dev, n)
    ms, launches, refines = run["ms"], run["launches"], run["refines"]
    steady = len(ms["keyframe"]) + len(ms["non-keyframe"])
    med = {k: statistics.median(v) if v else float("nan")
           for k, v in ms.items()}
    print(f"[system] 640x480 P=768 on {card}: {n} frames, status "
          f"{run['status']}, init frame {run['init_frame']} ({refines} "
          f"two-view refinements), init frames {len(ms['init'])} median "
          f"{med['init']:.2f} ms (first {ms['init'][0]:.2f} ms), keyframes "
          f"{len(ms['keyframe'])} median {med['keyframe']:.2f} ms, "
          f"non-keyframes {len(ms['non-keyframe'])} median "
          f"{med['non-keyframe']:.2f} ms; median depth RMSE "
          f"{run['rmse']:.5f}, Sim3 ATE {run['ate']:.6f} over "
          f"{run['n_tracked']} tracked frames; n_tracked_3d={run['n3d']} "
          f"finite={run['finite']} launches={launches}")
    if not run["tracking"] or run["n3d"] < 10 or not run["finite"]:
        raise AssertionError("system at scale: not tracking, < 10 tracked "
                             "3D points or non-finite positions")
    check_launches("system", steady, len(ms["keyframe"]))
    if len(run["refine_inputs"]) != 3 * refines:
        raise AssertionError(f"{len(run['refine_inputs'])} pose-only solves "
                             f"on init frames, expected 3 x {refines} "
                             "refinements")
    return launches, run["refine_inputs"]


def system_witness(dev, card: str):
    """The main path's accuracy by three routes with the same frames and
    draws: the card with the kernels, the card with the plain drivers in
    their place, and the CPU (plain drivers). Prints each route's init
    frame, median depth RMSE and Sim(3) ATE, and how far its tracked camera
    positions are from the first route's. A measurement, not a gate."""
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    swaps = ((pose_only_cuda, "camera_pose_optimization_cuda",
              pose_only.camera_pose_optimization_plain),
             (pdc, "pose_deformation_cuda", pd.pose_deformation_plain),
             (bac, "local_deformable_ba_cuda", ba.local_deformable_ba_plain))
    runs = {"card, kernels": run_system(dev)}
    saved = [getattr(m, name) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        runs["card, plain drivers"] = run_system(dev)
    finally:
        for (m, name, _), fn in zip(swaps, saved):
            setattr(m, name, fn)
    runs["CPU, plain drivers"] = run_system(torch.device("cpu"))
    for label, run in runs.items():
        print(f"[witness] 640x480 P=768 {label} on {card}: status "
              f"{run['status']}, init frame {run['init_frame']}, median "
              f"depth RMSE {run['rmse']:.6f}, Sim3 ATE {run['ate']:.6f} over "
              f"{run['n_tracked']} tracked frames, launches "
              f"{run['launches']}")
    for a, b in (("card, kernels", "card, plain drivers"),
                 ("card, kernels", "CPU, plain drivers"),
                 ("card, plain drivers", "CPU, plain drivers")):
        pa, pb = runs[a]["poses"], runs[b]["poses"]
        common = sorted(set(pa) & set(pb))
        d = [float(torch.linalg.norm(pa[i] - pb[i])) for i in common]
        first = {th: next((i for i, x in zip(common, d) if x > th), None)
                 for th in (1e-5, 1e-4, 1e-3)}
        print(f"[witness] camera position |dt|, {a} against {b}, over "
              f"{len(common)} common tracked frames: at the first "
              f"{d[0] if d else float('nan'):.3e}, max "
              f"{max(d, default=float('nan')):.3e}; first frame above "
              + ", ".join(f"{th:.0e}: {f}" for th, f in first.items()))


def time_wrappers(dev, card: str):
    """The pose-only, joint and BA wrapper calls of the package imported
    (from this checkout, or from another commit's unpacked tree given on the
    command line) at the main-path shapes (pose-only also at the init
    refine's P=1024): median of 20 after 3 warm-ups, CUDA events. Run it for
    two trees in one call to compare them on one card."""
    from nrslam_tpu_torch.bench_problem import ba_problem, solver_problem
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    out = []
    for kind, P in (("pinhole", 768), ("kb8", 768), ("pinhole", 1024)):
        cam, T0, X, obs, valid, _ = solver_problem(kind, device=dev, P=P)
        out.append((f"pose-only {kind} P={P}", cuda_ms(
            lambda: pose_only_cuda.camera_pose_optimization_cuda(
                cam, T0, X, obs, valid))))
    for kind in ("pinhole", "kb8"):
        cam, T0, X, obs, valid, pairs = solver_problem(kind, device=dev)
        seed = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid)
        cp = pd.compact_pairs(pairs, X.shape[0], valid)
        out.append((f"joint {kind} P=768", cuda_ms(
            lambda: pdc.pose_deformation_cuda(cam, seed, X, obs, valid, cp,
                                              1.0))))
    for kind, n_valid in (("pinhole", 5), ("kb8", 5), ("pinhole", 3)):
        cam, poses0, L0, prob = ba_problem(kind, n_valid, device=dev)
        out.append((f"BA {kind} {n_valid}/5", cuda_ms(
            lambda: bac.local_deformable_ba_cuda(cam, poses0, L0, prob,
                                                 cg_iters=16))))
    print(f"[wrappers] {os.path.dirname(os.path.dirname(pdc.__file__))} on "
          f"{card}: " + "; ".join(f"{n} {ms:.4f} ms" for n, ms in out))


def refine_kernel_check(inputs, rec):
    """Kernel 1 vs its plain version on the inputs the main path's two-view
    refinement gave it (P = max_features, only triangulated points valid),
    at the same-device gate, two launches bit-identical; the first solve
    timed, bare launch and wrapper."""
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    r = rec["pose_only"]
    for n, (cam, T0, X, obs, valid) in enumerate(inputs):
        err, steps, prep, _ = check_pose_only(
            f"init refine solve {n} P={X.shape[0]} valid={int(valid.sum())}",
            cam, T0, X, obs, valid)
        r["err"] = max(r["err"], err)
        if n == 0:
            first = (cam, T0, X, obs, valid, steps, prep)
    cam, T0, X, obs, valid, steps, prep = first
    ms_a = cuda_ms(lambda: pose_only_cuda.launch(prep))
    ms_k = cuda_ms(lambda: pose_only_cuda.camera_pose_optimization_cuda(
        cam, T0, X, obs, valid))
    ms_p = cuda_ms(lambda: pose_only.camera_pose_optimization_plain(
        cam, T0, X, obs, valid))
    flops = pose_only_flops(steps, int(valid.sum()))
    b_ms, by = bound(flops, pose_only_bytes(prep))
    print(f"[kernel] pose_only init refine: kernel alone {ms_a:.4f} ms, "
          f"wrapper {ms_k:.4f} ms, plain {ms_p:.4f} ms (P={X.shape[0]}); "
          f"{steps} LM steps, {1e3 * ms_a / pose_only_passes(steps):.3f} us "
          f"per pass; "
          f"bound {b_ms:.6f} ms ({by}), kernel/bound {ms_a / b_ms:.0f}")


class FrameTimer:
    """Times the System's entry points while a CLI run drives them, with a
    synchronize before and after each call: per frame its kind (init,
    keyframe, non-keyframe), its ms, and the ms of the evaluation on top of
    ``track_image`` (the stereo matcher and its RMSE, or the depth RMSE)."""

    def __init__(self, system_mod):
        self.system_mod = system_mod
        self.frames = []   # (kind, ms, evaluation ms, evaluated)

    def __enter__(self):
        System = self.system_mod.System
        self.saved = {name: getattr(System, name) for name in (
            "track_image", "track_image_with_depth",
            "track_image_with_stereo")}
        inner = {}
        track = self.saved["track_image"]

        def track_image(system, img):
            t0 = time.perf_counter()
            out = track(system, img)
            torch.cuda.synchronize()
            inner["ms"] = 1e3 * (time.perf_counter() - t0)
            return out

        def outer(fn):
            def timed(system, *args, **kwargs):
                was_init = system.status != self.system_mod.TRACKING
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(system, *args, **kwargs)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                kind = "init" if was_init else (
                    "keyframe" if out["keyframe"] else "non-keyframe")
                self.frames.append((kind, ms, ms - inner["ms"],
                                    "stereo_rmse" in out
                                    or "depth_rmse" in out))
                return out
            return timed

        System.track_image = track_image
        System.track_image_with_depth = outer(
            self.saved["track_image_with_depth"])
        System.track_image_with_stereo = outer(
            self.saved["track_image_with_stereo"])
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.system_mod.System, name, fn)

    def count(self, *kinds) -> int:
        return sum(kind in kinds for kind, *_ in self.frames)

    def summary(self) -> str:
        med = {k: statistics.median([ms for kind, ms, *_ in self.frames
                                     if kind == k] or [float("nan")])
               for k in ("init", "keyframe", "non-keyframe")}
        evals = [e for *_, e, done in self.frames if done]
        return (", ".join(f"{k} frames {self.count(k)} median {v:.2f} ms"
                          for k, v in med.items())
                + f"; evaluation on {len(evals)} tracked frames median "
                f"{statistics.median(evals or [float('nan')]):.2f} ms; "
                f"System calls {sum(ms for _, ms, *_ in self.frames) / 1e3:.2f}"
                " s in all")


def reset_launches():
    from nrslam_tpu_torch.slam import initializer
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    pose_only_cuda.launches = pdc.launches = bac.launches = 0
    initializer.refines = 0


def check_launches(label: str, steady: int, keyframes: int) -> dict:
    """The kernels' launch counts of the run since reset_launches(), held
    to what the path dictates: the pose-only kernel once per steady frame
    and 3 times per two-view refinement, the joint once per steady frame,
    the BA once per keyframe."""
    from nrslam_tpu_torch.slam import initializer
    from nrslam_tpu_torch.solver import bundle_adjustment_cuda as bac
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only_cuda

    launches = {"pose_only": pose_only_cuda.launches,
                "pose_deformation": pdc.launches,
                "bundle_adjustment": bac.launches}
    want = {"pose_only": steady + 3 * initializer.refines,
            "pose_deformation": steady, "bundle_adjustment": keyframes}
    print(f"[{label}] launches {launches} ({initializer.refines} two-view "
          f"refinements, {steady} steady frames, {keyframes} keyframes)")
    if launches != want or not all(launches.values()):
        raise AssertionError(f"{label}: launches {launches}, expected {want}")
    return launches


def scratch_dir():
    """A temporary directory inside the checkout (under the gitignored
    _dev/), removed when the phase ends."""
    import tempfile

    os.makedirs(os.path.join(REPO, "_dev"), exist_ok=True)
    return tempfile.TemporaryDirectory(dir=os.path.join(REPO, "_dev"))


def disk_hamlyn(dev, card: str):
    """The disk path at full width: the Hamlyn exporter, then the CLI on
    the card with stereo evaluation, RMSE file, PLY and checkpoint; the NCC
    matcher on the card against the CPU on the last frame's inputs."""
    from nrslam_tpu_torch import convert
    from nrslam_tpu_torch.apps import run_slam
    from nrslam_tpu_torch.config import Settings
    from nrslam_tpu_torch.datasets import hamlyn_export, loaders, synthetic
    from nrslam_tpu_torch.ops import stereo
    from nrslam_tpu_torch.slam import system
    from nrslam_tpu_torch.utils import checkpoint, tree

    n = 60
    with scratch_dir() as tmp:
        scene = synthetic.SceneConfig(height=480, width=640, deform_amp=0.02)
        t0 = time.perf_counter()
        root = hamlyn_export.export_hamlyn_stereo_dataset(
            os.path.join(tmp, "hamlyn"), scene, n_frames=n, device=dev)
        t_export = time.perf_counter() - t0
        files = {k: os.path.join(tmp, k) for k in ("rmse.txt", "map.ply",
                                                   "ck")}
        reset_launches()
        t0 = time.perf_counter()
        with FrameTimer(system) as timer:
            summary, slam = run_slam.main([
                "--dataset", "hamlyn", "--dataset_path", str(root),
                "--settings_path", str(root / "settings.yaml"),
                "--end_frame", str(n), "--max_points", "768",
                "--save_rmse", files["rmse.txt"],
                "--save_ply", files["map.ply"],
                "--checkpoint_dir", files["ck"]])
        t_run = time.perf_counter() - t0
        launches = check_launches("disk-hamlyn",
                                  timer.count("keyframe", "non-keyframe"),
                                  timer.count("keyframe"))
        print(f"[disk-hamlyn] 640x480 P=768 on {card}: {n} stereo pairs "
              f"exported in {t_export:.2f} s, run_slam {t_run:.2f} s: "
              f"{json.dumps(summary)}; {timer.summary()}")
        rmse = [float(v) for v in open(files["rmse.txt"]).read().split()]
        ply = open(files["map.ply"]).read()
        n_vertices = int(ply.split("element vertex ")[1].split()[0])
        back = checkpoint.restore(files["ck"], slam.state)
        same = tree.tree_map(torch.equal, back, slam.state)
        leaves = []
        tree.tree_map(leaves.append, same)
        print(f"[disk-hamlyn] RMSE file {len(rmse)} lines, PLY "
              f"{n_vertices} vertices, checkpoint {len(leaves)} tensors "
              f"restored, all equal={all(leaves)}")
        med = summary["median_stereo_rmse"]
        if not (summary["status"] == system.TRACKING
                and summary["frames_tracked"] >= 30
                and med is not None and math.isfinite(med) and med < 0.5):
            raise AssertionError(f"disk-hamlyn: {summary}")
        if (len(rmse) != summary["frames_tracked"]
                or not all(math.isfinite(v) for v in rmse)):
            raise AssertionError("disk-hamlyn: the RMSE file does not hold "
                                 "one finite line per tracked frame")
        if n_vertices == 0 or not all(leaves) or len(leaves) < 40:
            raise AssertionError("disk-hamlyn: empty PLY or checkpoint not "
                                 "restored bit for bit")

        # The NCC matcher on the card and on the CPU, last frame's inputs.
        ds = loaders.Hamlyn(str(root))
        st = slam.state
        left = slam._preprocess(ds.get_image(n - 1))
        right = slam._preprocess(ds.get_right_image(n - 1))
        valid = st.slot_used & (st.status == 0)
        bf = Settings(str(root / "settings.yaml"), dev).bf
        args = (slam.cam, bf, left, right, st.keypoints, valid)
        X_g, ok_g = stereo.stereo_pattern_matching(*args)
        X_c, ok_c = stereo.stereo_pattern_matching(
            convert.to_device(slam.cam, "cpu"), bf, left.cpu(), right.cpu(),
            st.keypoints.cpu(), valid.cpu())
        agree = float((ok_g.cpu() == ok_c).float().mean())
        both = ok_g.cpu() & ok_c
        rel = (torch.abs(X_g[..., 2].cpu() - X_c[..., 2])
               / torch.abs(X_c[..., 2]))[both]
        med_rel = float(torch.median(rel)) if both.any() else float("nan")
        ms_ncc = cuda_ms(lambda: stereo.stereo_pattern_matching(*args),
                         warmup=2, reps=10)
        print(f"[disk-hamlyn] NCC stereo, card against CPU on frame {n - 1} "
              f"({int(valid.sum())} valid slots, D=96, 11x11): ok agree "
              f"{agree:.4f} (gate 0.99), {int(both.sum())} accepted by both, "
              f"relative depth difference median {med_rel:.3e} max "
              f"{float(rel.max()) if both.any() else float('nan'):.3e} "
              f"(gate median 1e-4); matcher alone {ms_ncc:.3f} ms on the card")
        if not (agree >= 0.99 and both.any() and med_rel <= 1e-4):
            raise AssertionError("disk-hamlyn: NCC card against CPU outside "
                                 "the gates")
    return launches


def disk_simulation(dev, card: str):
    """The Simulation layout on the card: a KB8 scene exported with 16-bit
    PNG depth, the CLI through Settings' KannalaBrandt8 branch and a masker
    of a BorderFilter and a PredefinedFilter (an endoscope-corner mask read
    from a PNG, which must reach the card with the camera), with viz dumps;
    the native loader's decode of the exported frames, where it builds."""
    from nrslam_tpu_torch.apps import run_slam
    from nrslam_tpu_torch.datasets import (native_loader, png,
                                           simulation_export, synthetic)
    from nrslam_tpu_torch.ops import image as image_ops
    from nrslam_tpu_torch.slam import system

    n = 30
    with scratch_dir() as tmp:
        scene = synthetic.SceneConfig(height=240, width=320, deform_amp=0.02,
                                      camera_kind="kb8")
        t0 = time.perf_counter()
        root = simulation_export.export_simulation_dataset(
            os.path.join(tmp, "sim"), scene, n_frames=n, device=dev,
            filters=("BorderFilter 4 4", "PredefinedFilter mask.png"))
        t_export = time.perf_counter() - t0
        H, W = scene.height, scene.width
        corners = torch.full((H, W), 255, dtype=torch.uint8)
        for ys in (slice(0, 24), slice(-24, None)):
            for xs in (slice(0, 24), slice(-24, None)):
                corners[ys, xs] = 0
        png.write(root / "mask.png", corners.numpy())
        viz = os.path.join(tmp, "viz")
        reset_launches()
        t0 = time.perf_counter()
        with FrameTimer(system) as timer:
            summary, slam = run_slam.main([
                "--dataset", "simulation", "--dataset_path", str(root),
                "--settings_path", str(root / "settings.yaml"),
                "--end_frame", str(n), "--max_points", "384",
                "--save_viz", viz])
        t_run = time.perf_counter() - t0
        check_launches("disk-simulation",
                       timer.count("keyframe", "non-keyframe"),
                       timer.count("keyframe"))
        dumps = sorted(f for f in os.listdir(viz) if f.endswith(".png"))
        shapes = {png.read(os.path.join(viz, f)).shape for f in dumps}
        print(f"[disk-simulation] 320x240 KB8 P=384 on {card}: {n} frames "
              f"exported in {t_export:.2f} s, run_slam {t_run:.2f} s: "
              f"{json.dumps(summary)}; {timer.summary()}; camera "
              f"{slam.cam.kind}, masker {sorted(slam.masker.filters)}; "
              f"{len(dumps)} viz PNGs read back, shapes {shapes}")
        med = summary["median_rmse"]
        masks = slam.masker.get_all_masks(torch.zeros(H, W, device=dev))
        if not (summary["status"] == system.TRACKING and slam.cam.kind == "kb8"
                and med is not None and math.isfinite(med)
                and set(masks) == {"BorderFilter", "PredefinedFilter",
                                   "Global"}
                and masks["PredefinedFilter"].device == dev
                and not bool(masks["PredefinedFilter"][0, 0])):
            raise AssertionError(f"disk-simulation: {summary}, masks "
                                 f"{sorted(masks)}")
        if not dumps or shapes != {(H, W, 3)}:
            raise AssertionError("disk-simulation: viz dumps missing")

        available = native_loader.available()
        print(f"[disk-simulation] native loader available: {available}")
        if not available:
            # The compiler's own message says what is missing.
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            why = "no C++ compiler"
            if cxx:
                proc = subprocess.run(
                    [cxx, *native_loader.CXX_FLAGS, "-o", os.devnull,
                     str(native_loader.SOURCE), *native_loader.LIBS],
                    capture_output=True, text=True)
                why = " | ".join((proc.stderr + proc.stdout).splitlines()[:3])
            print(f"[disk-simulation] native loader build: {why}")
        else:
            names = [os.path.join(root, "rgb", f"image_{i:04d}.png")
                     for i in range(n)]
            with native_loader.PrefetchLoader(names) as frames:
                same = [bool((f == image_ops.rgb_to_gray(torch.from_numpy(
                    png.imread_color(p))).numpy()).all())
                    for p, f in zip(names, frames)]
            print(f"[disk-simulation] native decode equal to png.py + "
                  f"rgb_to_gray on {sum(same)} of {n} frames")
            if len(same) != n or not all(same):
                raise AssertionError("disk-simulation: the native loader's "
                                     "decode differs from png.py's")


def collapse_phase(dev, card: str):
    """[collapse]: the System at 320x240/P=384 with auto_reinitialize and
    the LOST flag read every frame, on the card: tracked until the keyframe
    ring has wrapped (>= 9 keyframes inserted into its 8 slots), then 4
    black frames, within which LOST must latch, then the scene again until
    the re-initialised map has tracked 3 frames."""
    from nrslam_tpu_torch.datasets import synthetic
    from nrslam_tpu_torch.slam import system
    from nrslam_tpu_torch.slam.state import Config

    scene = synthetic.SceneConfig(height=240, width=320, deform_amp=0.02)
    cam = synthetic.camera(scene, dev)
    config = Config(max_points=384, max_new_keypoints=128,
                    rad_per_pixel=1.0 / scene.fx)
    sysm = system.System(cam, config, auto_reinitialize=True,
                         lost_check_every=1)
    changes, status, black, inserted, lost_at, reinit_at = [], None, None, \
        0, None, None
    out = {}
    for i in range(200):
        gray, depth, _ = synthetic.render_frame(i, scene, dev)
        dark = black is not None and black <= i < black + 4
        out = sysm.track_image_with_depth(gray * 0.0 if dark else gray,
                                          depth)
        if sysm.status != status:
            changes.append((i, sysm.status))
            status = sysm.status
            if black is not None and status == system.NOT_INITIALIZED:
                lost_at = i if lost_at is None else lost_at
            if lost_at is not None and status == system.TRACKING:
                reinit_at = i
        if black is None and sysm.state is not None:
            inserted = int(sysm.state.kf_next)
            if inserted >= 9:
                black = i + 1
        if reinit_at is not None and i >= reinit_at + 3:
            break
    st = sysm.state
    n3d = int(out.get("n_tracked_3d", 0))
    finite = st is not None and bool(torch.isfinite(st.positions).all())
    print(f"[collapse] 320x240 P=384 auto_reinitialize on {card}: status "
          f"changes (frame, status) {changes}; {inserted} keyframes inserted "
          f"into the 8-slot ring before the blackout at frames "
          f"{black}-{None if black is None else black + 3}; LOST latched at "
          f"{lost_at}, re-initialised at {reinit_at}; last frame {i}: "
          f"{sysm.status}, n_tracked_3d={n3d}, finite={finite}")
    if black is None or lost_at is None or not black <= lost_at < black + 4:
        raise AssertionError("collapse: LOST did not latch in the blackout")
    if reinit_at is None or sysm.status != system.TRACKING or n3d < 10 \
            or not finite:
        raise AssertionError("collapse: no re-initialised map tracking")


def _np(tree):
    from nrslam_tpu_torch import convert
    return convert.to_numpy(tree)


def parallel_phase(dev, card: str, world, tmp: str):
    """[parallel]: the 4 ranks of ``world`` (spawned on this one card at the
    script's start: gloo over a FileStore in ``tmp``,
    ``parallel.dryrun.World``) run the pose normal equations sharded over
    points, the sharded pose-only and joint solves, the keyframe-sharded BA
    and the row-sharded frame at P=768 and P=4096; then the
    keyframe-sharded BA once more in this process on NCCL with world size
    1. Each is held to its single-process counterpart on the card. Returns
    rank 0's phase launches of the sharded solves over the frames."""
    import torch.distributed as dist

    from nrslam_tpu_torch import bench_problem
    from nrslam_tpu_torch.parallel import dryrun, sharding
    from nrslam_tpu_torch.solver import bundle_adjustment as ba
    from nrslam_tpu_torch.solver import pose_only

    n = world.n
    t0 = time.perf_counter()
    # The pose normal equations, P=768, against one einsum.
    cam, T0, X, obs, valid, _ = bench_problem.solver_problem(
        device=dev, with_pairs=False)
    w = valid.to(torch.float32)
    outs = world.run("pose_system", _np(cam), _np(T0.q), _np(T0.t),
                     _np(X), _np(obs), _np(w))
    print(f"[parallel] {n} gloo ranks on {card} answering the first task "
          f"in {time.perf_counter() - t0:.2f} s")
    H_ref, g_ref, _, _ = pose_only._pose_system(cam, T0, X, obs, w)
    H_ref, g_ref = H_ref.cpu().numpy(), g_ref.cpu().numpy()
    H, g, _ = outs[0]
    scale = float(abs(H_ref).max())
    dH, dg = float(abs(H - H_ref).max()), float(abs(g - g_ref).max())
    print(f"[parallel] pose system P={X.shape[0]} over {n} ranks: "
          f"max|dH| {dH:.3e} (gate 1e-5 x {scale:.3e}), max|dg| "
          f"{dg:.3e}")
    if not (dH <= 1e-5 * scale
            and dg <= 1e-5 * max(1.0, float(abs(g_ref).max()))):
        raise AssertionError("parallel: pose system outside gates")

    # The sharded pose-only and joint solves alone at P=768 on the rigid
    # scene against the whole-solver kernels in this process under the
    # same-device gates (the deformed scene: [kernel], and the frames).
    dryrun.report_solves("[parallel]", dryrun.solves_against_whole(
        world, dev, 0.0), n, SAME_DEVICE_POSE_TOL, SAME_DEVICE_FLOW_TOL)

    # The window BA partitioned over the ranks' point blocks, against the
    # whole-solver kernel, plain and this process as one rank, at both of
    # the sharded frame's P.
    for n_valid, P in ((5, 768), (3, 768), (5, 4096)):
        dryrun.report_points_ba("[parallel]", dryrun.points_ba_against_whole(
            world, dev, n_valid, P), n, SAME_DEVICE_BA_TOL)

    # The keyframe-sharded BA at the ring's size, 5 of 8 slots valid (all
    # 8: on NCCL below).
    cam_b, poses0, L0, prob = bench_problem.ba_problem(
        n_valid=5, device=dev, K=8, P=768)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = ba.local_deformable_ba_plain(cam_b, poses0, L0, prob, 5, 32)
    torch.cuda.synchronize()
    print(f"[parallel] plain single-process BA 5/8 valid: "
          f"{1e3 * (time.perf_counter() - t1):.2f} ms")
    outs = world.run("kf_sharded_ba", _np(cam_b), _np(poses0), _np(L0),
                     _np(prob), 5, 32)
    dryrun.report_ba("[parallel]", "kf-sharded BA 5/8 valid",
                     dryrun.ba_against_plain(outs, cam_b, poses0, L0, prob,
                                             plain), n, L0, prob)

    # The row-sharded frame against the single-process frame: each
    # rank builds the seeded problem with its own graph rows. The
    # ranks share the card: a measurement, no speed-up expected.
    launches = {"pose_only_shard": 0, "pose_deformation_shard": 0,
                "bundle_adjustment_shard": 0}
    for P, kfs in dryrun.FRAME_RUNS:
        r = dryrun.frames_against_single(world, dev, P, kfs,
                                         gather_graph=P <= 768)
        dryrun.report_frames("[parallel]", card, r, P, kfs,
                             dryrun.PREDICTED[P])
        for k, v in r["launches"][0].items():
            route = k.split(".")[0]
            if route in launches and not k.endswith(".calls"):
                launches[route] += v

    # A window of 3 keyframes at P=4096 (keyframes at frames 2 and 3): the
    # sharded frame's own work, the BA's write-back included, bit for bit
    # one process's with the same solves; the partitioned solves'
    # n_tracked_3d beside it is a reading (they flip one slot at frame 3
    # against the plain drivers, PERF.md §6).
    kfs = (False, True, True)
    r = dryrun.structure_against_one_process(dev, 4096, kfs)
    dryrun.report_structure("[parallel]", r)
    _, part, _ = dryrun.one_rank_frames(dev, 4096, kfs)
    print(f"[parallel] the same frames with the partitioned solves as one "
          f"rank (a reading): n_tracked_3d {part}")

    # NCCL, world size 1, in this process.
    cam_b, poses0, L0, prob = bench_problem.ba_problem(
        n_valid=8, device=dev, K=8, P=768)
    plain = ba.local_deformable_ba_plain(cam_b, poses0, L0, prob, 5, 32)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "nccl"), 1),
        rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(dev)
        assert mesh.group is not None and mesh.world_size == 1
        outs = [dryrun.TASKS["kf_sharded_ba"](
            mesh, _np(cam_b), _np(poses0), _np(L0), _np(prob), 5, 32)]
        dryrun.report_ba(
            "[parallel]",
            f"kf-sharded BA on {dist.get_backend()} world size 1",
            dryrun.ba_against_plain(outs, cam_b, poses0, L0, prob, plain),
            1, L0, prob)
    finally:
        dist.destroy_process_group()
    return launches


def run_phases(phase, dev, card: str, world, tmp: str):
    """Every phase of the default run, in order; returns (the kernels'
    records, their launches on the paths that drive them)."""
    rec = phase("kernels", kernel_phase, dev)
    rec.update(phase("sharded kernels", shard_kernel_phase, dev, rec))
    rec["bundle_adjustment_shard"] = phase(
        "partitioned BA kernels", ba_shard_kernel_phase, dev, rec)
    phase("shared-memory overflow", overflow_phase, dev)
    phase("slice parity", slice_parity, dev)
    phase("system parity", system_parity, dev)
    phase("slice 320x240", slice_at_scale, dev, card, 384, 240, 320, 128)
    phase("slice 640x480", slice_at_scale, dev, card, 768, 480, 640, 256)
    launches, refine_inputs = phase("system 640x480", system_at_scale, dev,
                                    card)
    phase("pose-only at the init refine", refine_kernel_check, refine_inputs,
          rec)
    phase("disk-hamlyn", disk_hamlyn, dev, card)
    phase("disk-simulation", disk_simulation, dev, card)
    phase("collapse", collapse_phase, dev, card)
    launches.update(phase("parallel", parallel_phase, dev, card, world,
                          tmp))
    return rec, launches


def main():
    args = sys.argv[1:]
    witness = args == ["--witness"]
    wrappers = len(args) == 2 and args[0] == "--wrappers"
    if args and not (witness or wrappers):
        raise SystemExit("usage: python3 chip_smoke.py [--witness | "
                         "--wrappers TREE]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # cuBLAS deterministic too where [parallel]'s plain-driver process turns
    # on torch's deterministic algorithms (dryrun._plain_solves); read when
    # the first cuBLAS handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    root = os.path.abspath(args[1]) if wrappers else REPO
    sys.path.insert(0, root)
    from nrslam_tpu_torch import kernels
    if not kernels.__file__.startswith(root):
        raise SystemExit(f"chip_smoke: nrslam_tpu_torch not found in {root}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)

    t_start = time.perf_counter()
    kernels.library()
    print(f"[build] csrc/*.cu built with nvcc and loaded in "
          f"{time.perf_counter() - t_start:.2f} s")
    # An older tree timed with --wrappers keeps no build log.
    for src, log in sorted(getattr(kernels, "build_log", {}).items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[ptxas] {src}: {line.strip()}")
    if not wrappers:
        check_no_spills(kernels.build_log.get("pose_only.cu", ""),
                        "pose_only_kernel", 2)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
        return out

    if witness:
        phase("system witness", system_witness, dev, card)
        return
    if wrappers:
        phase("wrappers", time_wrappers, dev, card)
        return
    # The [parallel] ranks start now and wait, so their start-up overlaps
    # the phases before theirs; they are stopped however the script ends.
    from nrslam_tpu_torch.parallel import dryrun
    tmp = scratch_dir()
    world = dryrun.World(4, str(dev), store_dir=tmp.name)
    try:
        rec, launches = run_phases(phase, dev, card, world, tmp.name)
    finally:
        world.close()
        tmp.cleanup()
    print(f"[phase] total: {time.perf_counter() - t_start:.2f} s")

    sources = {
        "pose_only": ("nrslam_tpu_torch/csrc/pose_only.cu",
                      "nrslam_tpu/solver/pose_only_pallas.py:40"),
        "pose_deformation": ("nrslam_tpu_torch/csrc/pose_deformation.cu",
                             "nrslam_tpu/solver/pose_deformation_pallas.py:81"),
        "bundle_adjustment": ("nrslam_tpu_torch/csrc/bundle_adjustment.cu",
                              "nrslam_tpu/solver/bundle_adjustment_pallas.py:66"),
        "pose_only_shard": ("nrslam_tpu_torch/csrc/pose_only_shard.cu",
                            "nrslam_tpu/solver/pose_only_pallas.py:40"),
        "pose_deformation_shard": (
            "nrslam_tpu_torch/csrc/pose_deformation_shard.cu",
            "nrslam_tpu/solver/pose_deformation_pallas.py:81"),
        "bundle_adjustment_shard": (
            "nrslam_tpu_torch/csrc/bundle_adjustment_shard.cu",
            "nrslam_tpu/solver/bundle_adjustment_pallas.py:66"),
    }
    kernels_json = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": rec[name]["err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"], "bound_by": rec[name]["bound_by"],
        "library_ms": rec[name]["library_ms"],
        "kernel_ms": rec[name]["kernel_ms"], "work": rec[name]["work"],
    } for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
