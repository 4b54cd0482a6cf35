#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nrslam_tpu_torch) once on one GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught; each
prints its seconds):
  1. require a CUDA device; print the card's name and power limit;
  2. build the three hand-written kernels from csrc/ with nvcc (sm_90a, one
     nvcc per source, all started together);
  3. kernel phase: at the frame's shapes (P=768, E=5376 from a K=11 kNN
     graph on a seeded scene), pinhole and KB8, the pose-only and joint
     kernels against their plain PyTorch versions on the card, with the CPU
     tests' tolerances and the tighter same-device gates below; then the
     keyframe-BA kernel at the keyframe's shapes (K=5, P=768, E=5376,
     noisy seeds, ~25% of copies unobserved), pinhole, KB8 and a window
     with 3 of 5 valid slots, against the plain BA driver, with unobserved
     copies checked unchanged. Kernels timed with CUDA events as the median
     of 20 after warm-up, plain versions as the median of 5 (joint, BA);
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
     synchronisation it detects), then 50 timed frames at the 1-in-5
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
     triangulated ones valid), at the same-device gate, and timed.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
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


def kernel_phase(dev):
    """Each kernel vs its plain version at the main-path shapes."""
    from nrslam_tpu_torch.bench_problem import solver_problem
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_deformation_cuda as pdc
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    rec = {"pose_only": {"err": 0.0}, "pose_deformation": {"err": 0.0}}
    for kind in ("pinhole", "kb8"):
        cam, T0, X, obs, valid, pairs = solver_problem(kind, device=dev)

        # Kernel 1: |dq|, |dt| below SAME_DEVICE_POSE_TOL; the CPU tests'
        # 1e-4 (tests/test_torch_pose_only.py) is implied.
        T_k = pose_only_cuda.camera_pose_optimization_cuda(cam, T0, X, obs,
                                                           valid)
        T_p = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid)
        dq, dt = quat_err(T_k.q, T_p.q), float(torch.linalg.norm(T_k.t - T_p.t))
        print(f"[kernel] pose_only {kind}: |dq|={dq:.3e} |dt|={dt:.3e} "
              f"(tol {SAME_DEVICE_POSE_TOL:.0e})")
        if not (dq < SAME_DEVICE_POSE_TOL and dt < SAME_DEVICE_POSE_TOL):
            raise AssertionError(f"pose_only {kind} disagrees with plain")
        ms_k = cuda_ms(lambda: pose_only_cuda.camera_pose_optimization_cuda(
            cam, T0, X, obs, valid))
        ms_p = cuda_ms(lambda: pose_only.camera_pose_optimization_plain(
            cam, T0, X, obs, valid))
        print(f"[kernel] pose_only {kind}: kernel {ms_k:.4f} ms, plain "
              f"{ms_p:.4f} ms (P={X.shape[0]})")
        r = rec["pose_only"]
        r["err"] = max(r["err"], dq, float(torch.max(torch.abs(T_k.t - T_p.t))))
        if kind == "pinhole":
            r["ms"], r["plain_ms"] = ms_k, ms_p

        # Kernel 2: the tolerances of tests/test_pose_deformation_pallas.py,
        # then the same-device gates on pose and on every point's flow.
        seed = T_p
        cp = pd.compact_pairs(pairs, X.shape[0], valid)
        E = int(cp.i.shape[0])
        Tk, fk, ck = pdc.pose_deformation_cuda(cam, seed, X, obs, valid, cp,
                                               1.0)
        Tp, fp, cpl = pd.pose_deformation_plain(cam, seed, X, obs, valid, cp,
                                                1.0)
        dq, dt = quat_err(Tk.q, Tp.q), float(torch.linalg.norm(Tk.t - Tp.t))
        m = valid
        dflow = torch.linalg.norm(fk - fp, dim=-1)[m]
        fmag = max(float(torch.median(torch.linalg.norm(fp, dim=-1))), 0.01)
        med = float(torch.median(dflow))
        flips = float(torch.mean(((ck <= pd.TH_2DOF) & m)
                                 .ne((cpl <= pd.TH_2DOF) & m).float()))
        max_dflow = float(torch.max(dflow))
        print(f"[kernel] pose_deformation {kind}: E={E} |dq|={dq:.3e} "
              f"|dt|={dt:.3e} (tol {SAME_DEVICE_POSE_TOL:.0e}) "
              f"median|dflow|={med:.3e} "
              f"(tol {5e-3 * max(fmag / 0.01, 1.0):.3e}) "
              f"inlier flips={flips:.4f} (tol 0.03) "
              f"max|dflow|={max_dflow:.3e} (tol {SAME_DEVICE_FLOW_TOL:.0e})")
        if not (dq < 2e-3 and dt < 2e-3 and flips < 0.03
                and med < 5e-3 * max(fmag / 0.01, 1.0)):
            raise AssertionError(f"pose_deformation {kind} disagrees")
        if not (dq < SAME_DEVICE_POSE_TOL and dt < SAME_DEVICE_POSE_TOL
                and max_dflow < SAME_DEVICE_FLOW_TOL):
            raise AssertionError(f"pose_deformation {kind} disagrees with "
                                 "plain beyond the same-device gates")
        ms_k = cuda_ms(lambda: pdc.pose_deformation_cuda(
            cam, seed, X, obs, valid, cp, 1.0))
        ms_p = cuda_ms(lambda: pd.pose_deformation_plain(
            cam, seed, X, obs, valid, cp, 1.0), warmup=1, reps=5)
        print(f"[kernel] pose_deformation {kind}: kernel {ms_k:.4f} ms, "
              f"plain {ms_p:.4f} ms (P={X.shape[0]}, E={E})")
        r = rec["pose_deformation"]
        r["err"] = max(r["err"], dq, dt, max_dflow)
        if kind == "pinhole":
            r["ms"], r["plain_ms"] = ms_k, ms_p
    rec["bundle_adjustment"] = ba_kernel_phase(dev)
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
    r = {"err": 0.0}
    for kind, n_valid in (("pinhole", 5), ("kb8", 5), ("pinhole", 3)):
        cam, poses0, L0, prob = ba_problem(kind, n_valid, device=dev)
        pk, Lk = bac.local_deformable_ba_cuda(cam, poses0, L0, prob,
                                              cg_iters=cg)
        pp, Lp = ba.local_deformable_ba_plain(cam, poses0, L0, prob,
                                              cg_iters=cg)
        live = prob.kf_valid
        seen = prob.obs_valid & live[:, None]
        dq = max(quat_err(pk.q[k], pp.q[k]) for k in range(5) if live[k])
        dt = float(torch.max(torch.linalg.norm(pk.t - pp.t, dim=-1)[live]))
        dL = float(torch.max(torch.linalg.norm(Lk - Lp, dim=-1)[seen]))
        moved = float(torch.max(torch.linalg.norm(Lp - L0, dim=-1)[seen]))
        same = bool(torch.equal(Lk[~seen], L0[~seen]))
        label = f"{kind} {n_valid}/5 valid"
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
        ms_k = cuda_ms(lambda: bac.local_deformable_ba_cuda(
            cam, poses0, L0, prob, cg_iters=cg))
        ms_p = cuda_ms(lambda: ba.local_deformable_ba_plain(
            cam, poses0, L0, prob, cg_iters=cg), warmup=1, reps=5)
        print(f"[kernel] bundle_adjustment {label}: kernel {ms_k:.4f} ms, "
              f"plain {ms_p:.4f} ms (K=5, P=768, cg_iters={cg})")
        r["err"] = max(r["err"], dq, dt, dL)
        if n_valid == 5:
            r[f"ms_{kind}"], r[f"plain_ms_{kind}"] = ms_k, ms_p
            if kind == "pinhole":
                r["ms"], r["plain_ms"] = ms_k, ms_p
    return r


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
    seq = synthetic.SyntheticSequence(scene, n_frames=40)
    cam = synthetic.camera(scene)
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
    """4 warm-up frames (the last two under sync_debug_mode="error"), then 50
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

    pose_only_cuda.launches = 0
    pdc.launches = 0
    bac.launches = 0
    n = 50
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
    if launches != {"pose_only": n, "pose_deformation": n,
                    "bundle_adjustment": n // 5}:
        raise AssertionError(f"kernel launch counts {launches} != {n} / "
                             f"{n // 5} keyframes")


def system_at_scale(dev, card: str, n: int = 60):
    """The main path: the System from frame 0 at 640x480, P=768. Returns
    the launch counts of the run and the inputs of the pose-only solves
    made on init frames (the two-view refinement's)."""
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
    pose_only_cuda.launches = 0
    pdc.launches = 0
    bac.launches = 0
    initializer.refines = 0
    ms = {"init": [], "keyframe": [], "non-keyframe": []}
    est, gt, init_frame, out = [], [], None, {}
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
    finally:
        pose_only.camera_pose_optimization = solve
    launches = {"pose_only": pose_only_cuda.launches,
                "pose_deformation": pdc.launches,
                "bundle_adjustment": bac.launches}
    refines = initializer.refines
    steady = len(ms["keyframe"]) + len(ms["non-keyframe"])
    n3d = int(out.get("n_tracked_3d", 0))
    finite = sysm.state is not None and bool(
        torch.isfinite(sysm.state.positions).all())
    rmse = statistics.median(sysm.evaluator.rmse_history)
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    med = {k: statistics.median(v) if v else float("nan")
           for k, v in ms.items()}
    print(f"[system] 640x480 P=768 on {card}: {n} frames, status "
          f"{sysm.status}, init frame {init_frame} ({refines} two-view "
          f"refinements), init frames {len(ms['init'])} median "
          f"{med['init']:.2f} ms (first {ms['init'][0]:.2f} ms), keyframes "
          f"{len(ms['keyframe'])} median {med['keyframe']:.2f} ms, "
          f"non-keyframes {len(ms['non-keyframe'])} median "
          f"{med['non-keyframe']:.2f} ms; median depth RMSE {rmse:.5f}, "
          f"Sim3 ATE {ate:.6f} over {len(est)} tracked frames; "
          f"n_tracked_3d={n3d} finite={finite} launches={launches}")
    if sysm.status != system.TRACKING or n3d < 10 or not finite:
        raise AssertionError("system at scale: not tracking, < 10 tracked "
                             "3D points or non-finite positions")
    want = {"pose_only": steady + 3 * refines, "pose_deformation": steady,
            "bundle_adjustment": len(ms["keyframe"])}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"system at scale: launches {launches}, "
                             f"expected {want}")
    if len(refine_inputs) != 3 * refines:
        raise AssertionError(f"{len(refine_inputs)} pose-only solves on init "
                             f"frames, expected 3 x {refines} refinements")
    return launches, refine_inputs


def refine_kernel_check(inputs, rec):
    """Kernel 1 vs its plain version on the inputs the main path's two-view
    refinement gave it (P = max_features, only triangulated points valid),
    at the same-device gate; the first solve timed."""
    from nrslam_tpu_torch.solver import pose_only, pose_only_cuda

    r = rec["pose_only"]
    for n, (cam, T0, X, obs, valid) in enumerate(inputs):
        T_k = pose_only_cuda.camera_pose_optimization_cuda(cam, T0, X, obs,
                                                           valid)
        T_p = pose_only.camera_pose_optimization_plain(cam, T0, X, obs, valid)
        dq, dt = quat_err(T_k.q, T_p.q), float(torch.linalg.norm(T_k.t - T_p.t))
        print(f"[kernel] pose_only init refine solve {n}: P={X.shape[0]} "
              f"valid={int(valid.sum())} |dq|={dq:.3e} |dt|={dt:.3e} "
              f"(tol {SAME_DEVICE_POSE_TOL:.0e})")
        if not (dq < SAME_DEVICE_POSE_TOL and dt < SAME_DEVICE_POSE_TOL):
            raise AssertionError(f"pose_only init refine solve {n} disagrees "
                                 "with plain")
        r["err"] = max(r["err"], dq, float(torch.max(torch.abs(T_k.t - T_p.t))))
    cam, T0, X, obs, valid = inputs[0]
    ms_k = cuda_ms(lambda: pose_only_cuda.camera_pose_optimization_cuda(
        cam, T0, X, obs, valid))
    ms_p = cuda_ms(lambda: pose_only.camera_pose_optimization_plain(
        cam, T0, X, obs, valid))
    print(f"[kernel] pose_only init refine: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms (P={X.shape[0]})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from nrslam_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)

    t_start = time.perf_counter()
    kernels.library()
    print(f"[build] csrc/*.cu built with nvcc and loaded in "
          f"{time.perf_counter() - t_start:.2f} s")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
        return out

    rec = phase("kernels", kernel_phase, dev)
    phase("slice parity", slice_parity, dev)
    phase("system parity", system_parity, dev)
    phase("slice 320x240", slice_at_scale, dev, card, 384, 240, 320, 128)
    phase("slice 640x480", slice_at_scale, dev, card, 768, 480, 640, 256)
    launches, refine_inputs = phase("system 640x480", system_at_scale, dev,
                                    card)
    phase("pose-only at the init refine", refine_kernel_check, refine_inputs,
          rec)
    print(f"[phase] total: {time.perf_counter() - t_start:.2f} s")

    sources = {
        "pose_only": ("nrslam_tpu_torch/csrc/pose_only.cu",
                      "nrslam_tpu/solver/pose_only_pallas.py:40"),
        "pose_deformation": ("nrslam_tpu_torch/csrc/pose_deformation.cu",
                             "nrslam_tpu/solver/pose_deformation_pallas.py:81"),
        "bundle_adjustment": ("nrslam_tpu_torch/csrc/bundle_adjustment.cu",
                              "nrslam_tpu/solver/bundle_adjustment_pallas.py:66"),
    }
    kernels_json = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": rec[name]["err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
    } for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
