"""The steady-state frame at three operating points and the monocular
initialisation at the reference's 4,000 features, on one GPU (counterpart
of the root ``profile_scale.py``).

    python -m nrslam_tpu_torch.profile_scale

The reference tracks half-resolution Endomapper frames and initialises
with up to 4,000 features (tracking.cc:46-61). For each point of
``POINTS`` (P, height, width, new keypoints a keyframe), ``bench_point``
builds the bench problem on the card, runs 4 warm-up frames, then
``n_frames`` frames at the 1-in-5 keyframe cadence eagerly
(``system.frame_step``) and as many replayed by a
``slam.frame_graph.FrameGraph`` built from the state reached: ms a frame
and frames a second of each, host clock with a synchronize at the end of
each run, the warm-up's and the build's seconds, and the residency plan
the joint and the BA kernel took in the replays (the kernels' work
headers). ``init_at_scale`` times the initializer loop (``reset``, then
``init_step`` a frame with ``system.ransac_draws``, the System's draws) at
``max_features``. The card's name, power limit and SM clock come first.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import torch

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.device import resolve

POINTS = ((384, 240, 320, 128),    # bench.py's default
          (768, 480, 640, 256),    # the reference's half-resolution scale
          (1024, 480, 640, 256))   # above the reference's point budget

# The JAX tool's row keys, then the port's additions.
POINT_KEYS = ("P", "h", "w", "new_kp", "fps", "frame_ms", "warmup_s",
              "replayed_fps", "replayed_frame_ms", "build_s", "joint_plan",
              "ba_plan")
INIT_KEYS = ("max_features", "h", "w", "init_frame_ms", "success",
             "first_reset_s", "features", "success_frames", "refines",
             "pose_only_launches")

# The residency fields of a joint or BA launch's work header.
PLAN_FIELDS = ("owned_state_in_smem", "full_vectors_in_smem",
               "edge_ends_in_smem")


def _plan(header) -> dict:
    from nrslam_tpu_torch.solver.pose_deformation_cuda import WORK_FIELDS

    work = dict(zip(WORK_FIELDS, header.tolist()))
    return {f: work[f] for f in PLAN_FIELDS}


def bench_point(max_points: int, h: int, w: int, new_kp: int,
                n_frames: int = 50, device=None) -> dict:
    """One operating point's row of ``POINT_KEYS`` (the module's
    docstring says how each is taken)."""
    from nrslam_tpu_torch.slam import frame_graph, system

    dev = resolve(device)
    state, frames, mask, cam, config = bench_problem.build_bench_problem(
        max_points, h, w, new_kp, device=dev)

    def run(step, s):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n_frames):
            s, _ = step(s, frames[i % len(frames)], mask, (i % 5) == 4)
        torch.cuda.synchronize(dev)
        return s, (time.perf_counter() - t0) / n_frames

    def eager(s, raw, m, kf):
        return system.frame_step(s, raw, m, cam, config, kf)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    s = state
    for i, kf in enumerate([False, True, False, True]):
        s, _ = eager(s, frames[i], mask, kf)
    torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0
    s, dt = run(eager, s)
    fg = frame_graph.FrameGraph(s, frames[0], mask, cam, config)
    s, dt_r = run(fg.step, s)
    return dict(P=max_points, h=h, w=w, new_kp=new_kp, fps=1.0 / dt,
                frame_ms=1e3 * dt, warmup_s=warmup_s, replayed_fps=1.0 / dt_r,
                replayed_frame_ms=1e3 * dt_r, build_s=fg.build_s,
                joint_plan=_plan(profiler.kept("pose_deformation.last_work")),
                ba_plan=_plan(profiler.kept("bundle_adjustment.last_work")))


def init_scene(h: int, w: int) -> dict:
    """The ``SceneConfig`` fields of the init's scene: the synthetic
    deforming scene (deformation 0.02) with relief 1.0 and the camera
    moving 0.08 a frame. With the defaults (relief 0.25, 0.012 a frame)
    the 640x480 scene gives too little parallax to initialise within 8
    frames (the System there initialises at frame 19); here both packages
    initialise on the second frame after the reset (on the CPU, the JAX
    package's draws: tests/test_torch_init_at_scale.py), so the timed
    loop includes the success branch and its two-view refinement."""
    return dict(height=h, width=w, deform_amp=0.02, relief=1.0,
                motion_translation=0.08)


def init_at_scale(max_features: int = 4000, h: int = 480, w: int = 640,
                  n_frames: int = 8, device=None, seed: int = 4) -> dict:
    """``reset`` on frame 0 (its seconds, ``first_reset_s``, the first call
    at this size), then ``init_step`` on frames 1..n_frames, each attempt
    with the System's draws (``system.ransac_draws(config, seed, i)``),
    success flags read once at the end; one warm pass, then the timed
    pass: ms per init frame, whether and on which frames it succeeded, the
    two-view refinements it ran and the pose-only kernel's launches in
    it. Rendering, the pyramids and the draws are made before the loop."""
    from nrslam_tpu_torch.datasets import synthetic
    from nrslam_tpu_torch.ops import klt
    from nrslam_tpu_torch.slam import initializer, system
    from nrslam_tpu_torch.slam.state import Config

    dev = resolve(device)
    scene = synthetic.SceneConfig(**init_scene(h, w))
    seq = synthetic.SyntheticSequence(scene, n_frames=n_frames + 1,
                                      device=dev)
    cam = synthetic.camera(scene, dev)
    kcfg = Config(rad_per_pixel=1.0 / scene.fx).klt_config
    icfg = initializer.InitializerConfig(max_features=max_features,
                                         rad_per_pixel=1.0 / scene.fx)
    pyr = klt.build_pyramid(seq.get_frame(0)[0], kcfg)
    mask = torch.ones((h, w), dtype=torch.bool, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    st = initializer.reset(pyr, mask, 0, kcfg, icfg)
    torch.cuda.synchronize(dev)
    first_reset_s = time.perf_counter() - t0

    pyrs = [klt.build_pyramid(seq.get_frame(i)[0], kcfg)
            for i in range(1, n_frames + 1)]
    draws = [system.ransac_draws(icfg, seed, i, dev) for i in range(n_frames)]

    def one_pass(s):
        flags = []
        for p, (perm, gumbel) in zip(pyrs, draws):
            s, res = initializer.init_step(s, p, mask, perm, gumbel, cam,
                                           kcfg, icfg)
            flags.append(res.success)
        return torch.stack(flags).tolist()

    one_pass(st)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    flags, rec = profiler.record(lambda: one_pass(st))
    torch.cuda.synchronize(dev)
    per_frame_ms = 1e3 * (time.perf_counter() - t0) / n_frames
    profiler.replay(rec)
    return dict(max_features=max_features, h=h, w=w,
                init_frame_ms=per_frame_ms, success=any(flags),
                first_reset_s=first_reset_s, features=int(st.valid.sum()),
                success_frames=[i + 1 for i, ok in enumerate(flags) if ok],
                refines=rec.counts.get("initializer.refines", 0),
                pose_only_launches=rec.counts.get("pose_only.launches", 0))


def main(argv=None):
    import argparse

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    dev = resolve()
    print(profiler.gpu_header(), flush=True)
    for P, h, w, kp in POINTS:
        print(json.dumps(bench_point(P, h, w, kp, device=dev)), flush=True)
    print(json.dumps(init_at_scale(4000, 480, 640, device=dev)), flush=True)


if __name__ == "__main__":
    main()
