"""Device time of each stage of the steady-state frame on one GPU
(counterpart of the root ``profile_device.py``).

    python -m nrslam_tpu_torch.profile_device [--points 768 --height 480
        --width 640 --new-kp 256]

On the steady state of ``profile_stages.steady_state``, each stage of
``KEYS`` (a null step, then ``profile_stages``' stages) runs as a step that
maps its carry (the raw frame, the keypoints, the graph's weights or the
whole ``SlamState``) to the next carry; ``utils.profiler.device_timeit``
captures k chained calls in one CUDA graph and replays it, so each figure
is the device's ms a call with no host enqueue in it. Then one replay of
each kind of the captured frame (``slam.frame_graph.FrameGraph``) under
``torch.profiler`` gives the device ms of each whole-solver kernel inside
it (``solver_kernels_in_replay``). The card's name, power limit and SM
clock come first, and once more while replays run (the clock under load).
Needs a CUDA device.
"""

from __future__ import annotations

import json

import torch

from nrslam_tpu_torch import profile_stages
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.device import resolve

KEYS = ("null_step",) + profile_stages.KEYS

# Substrings of the whole-solver kernels' names in the profiler's events.
SOLVER_KERNELS = {"pose_only": "pose_only_kernel",
                  "pose_deformation": "pose_deformation_kernel",
                  "bundle_adjustment": "::ba_kernel"}


def stage_steps(pb: profile_stages.Problem) -> dict:
    """Every stage of ``KEYS`` as (step, carry0): ``step(carry)`` runs the
    stage and returns the next carry, of ``carry0``'s structure."""
    from nrslam_tpu_torch.ops import klt
    from nrslam_tpu_torch.slam import graph as graph_mod
    from nrslam_tpu_torch.slam import mapping, system, tracking
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_only

    s, pyr, mask, cam, config = pb.state, pb.pyramid, pb.mask, pb.cam, \
        pb.config
    raw = pb.frames[4]
    with3d, pairs = profile_stages.solver_inputs(pb)

    def pyramid_step(g):
        klt.build_pyramid(g, config.klt_config)
        return g

    def klt_step(kp):
        return klt.track(pyr, s.refs, kp, s.status, config.klt_config,
                         min_ssim=config.klt_min_ssim,
                         use_initial_flow=True)[0]

    def pose_only_step(kp):
        T = pose_only.camera_pose_optimization(cam, s.Tcw, s.positions, kp,
                                               with3d)
        return kp + 1e-9 * T.t[:2]

    def joint_step(kp):
        res = pd.pose_deformation_optimization(
            cam, s.Tcw, s.positions, kp, with3d, pairs, s.scale)
        return kp + 1e-9 * res.flows[:, :2]

    def nbr_step(w):
        graph_mod.top_k_neighbors(s.graph._replace(weight=w), with3d,
                                  config.regularizers_per_point)
        return w

    def reuse_step(st):
        return tracking.point_reuse(st, pyr, cam, config)

    def trk_step(kf):
        return lambda st: tracking.process_frame(st, pyr, mask, cam, config,
                                                 kf)[0]

    def map_step(kf):
        return lambda st: mapping.do_mapping(st, cam, config,
                                             has_new_keyframe=kf)

    def full_step(kf):
        return lambda st: system.frame_step(st, raw, mask, cam, config,
                                            kf)[0]

    steps = {
        "null_step": (lambda g: g * 1.000001 + 1e-9, raw),
        "pyramid": (pyramid_step, raw),
        "klt_track": (klt_step, s.keypoints),
        "pose_only": (pose_only_step, s.keypoints),
        "pose_deformation": (joint_step, s.keypoints),
        "top_k_neighbors": (nbr_step, s.graph.weight),
        "point_reuse": (reuse_step, s),
        "tracking_frame_nokf": (trk_step(False), s),
        "tracking_frame_kf": (trk_step(True), s),
        "mapping_triangulate": (map_step(False), s),
        "mapping_ba": (map_step(True), s),
        "full_frame_nokf": (full_step(False), s),
        "full_frame_kf": (full_step(True), s),
    }
    assert tuple(steps) == KEYS
    return steps


def run(pb: profile_stages.Problem, keys=KEYS, k: int = 8,
        reps: int = 3) -> dict:
    """``device_timeit`` of each stage of ``keys``."""
    steps = stage_steps(pb)
    return {key: profiler.device_timeit(*steps[key], k=k, reps=reps,
                                        name=key) for key in keys}


def solver_kernels_in_replay(pb: profile_stages.Problem) -> tuple:
    """Per frame kind, the device ms (and launches) of each whole-solver
    kernel inside one replay of the captured frame from the steady
    state, read under ``torch.profiler``; and the FrameGraph."""
    from torch.profiler import ProfilerActivity, profile

    from nrslam_tpu_torch.slam import frame_graph

    fg = frame_graph.FrameGraph(pb.state, pb.frames[4], pb.mask, pb.cam,
                                pb.config)
    out = {}
    for label, kf in (("non-keyframe", False), ("keyframe", True)):
        fg.step(pb.state, pb.frames[4], pb.mask, kf)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fg.step(pb.state, pb.frames[4], pb.mask, kf)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        out[label] = {
            name: {"device_ms": sum(e.device_time_total for e in events
                                    if sub in e.key) / 1e3,
                   "launches": sum(e.count for e in events if sub in e.key)}
            for name, sub in SOLVER_KERNELS.items()}
    return out, fg


def main(argv=None):
    args = profile_stages.size_args(__doc__.splitlines()[0], argv)
    dev = resolve()
    print(profiler.gpu_header(), flush=True)
    pb = profile_stages.steady_state(args.points, args.height, args.width,
                                     args.new_kp, dev)
    stages = run(pb)
    kernels, fg = solver_kernels_in_replay(pb)

    def busy():
        for i in range(40):
            fg.step(pb.state, pb.frames[4], pb.mask, i % 5 == 4)

    print(f"under load: {profiler.gpu_header(busy)}", flush=True)
    print(json.dumps({"where": f"{args.width}x{args.height} "
                      f"P={args.points} new_kp={args.new_kp}",
                      "stages": stages,
                      "solver_kernels_in_replay": kernels}, indent=1))


if __name__ == "__main__":
    main()
