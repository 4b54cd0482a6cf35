"""Per-stage timing of the steady-state frame on one GPU (counterpart of
the root ``profile_stages.py``).

    python -m nrslam_tpu_torch.profile_stages [--points 768 --height 480
        --width 640 --new-kp 256]

Builds the bench problem on the card, advances it through frames (0,
non-keyframe), (1, keyframe), (2, non-keyframe), (3, keyframe) with
``tracking.process_frame`` and ``mapping.do_mapping``, and times each of
the 12 stages of ``KEYS`` on the state reached and the pyramid of frame 4:
the pyramid, KLT, pose-only, joint pose + deformation, the graph's top-k,
point reuse, the tracking frame, triangulation mapping, keyframe BA and
the whole frame, each frame kind apart. For every stage it prints
``chained_ms`` (``utils.profiler.chained_timeit``: ms a call as the host
issues the calls, its enqueue included), ``device_ms`` (the summed device
time of one call's kernels under ``torch.profiler``) and ``kernels`` (that
call's kernels). The card's name, power limit and SM clock come first.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch

from nrslam_tpu_torch import bench_problem
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.device import resolve

KEYS = ("pyramid", "klt_track", "pose_only", "pose_deformation",
        "top_k_neighbors", "point_reuse", "tracking_frame_nokf",
        "tracking_frame_kf", "mapping_triangulate", "mapping_ba",
        "full_frame_nokf", "full_frame_kf")


class Problem(NamedTuple):
    """A steady state of the bench problem and what its stages take."""

    state: object
    frames: list
    mask: torch.Tensor
    cam: object
    config: object
    pyramid: list   # of frames[4]


def steady_state(points: int = 768, height: int = 480, width: int = 640,
                 new_kp: int = 256, device=None) -> Problem:
    """The bench problem (on the card unless ``device`` says otherwise)
    after frames 0-3 with keyframes at 1 and 3, and frame 4's pyramid."""
    from nrslam_tpu_torch.ops import klt
    from nrslam_tpu_torch.slam import mapping, tracking

    state, frames, mask, cam, config = bench_problem.build_bench_problem(
        points, height, width, new_kp, device=resolve(device))
    s = state
    for i, kf in [(0, False), (1, True), (2, False), (3, True)]:
        pyr = klt.build_pyramid(frames[i], config.klt_config)
        s, _ = tracking.process_frame(s, pyr, mask, cam, config, kf)
        s = mapping.do_mapping(s, cam, config, has_new_keyframe=kf)
    pyr = klt.build_pyramid(frames[4], config.klt_config)
    return Problem(s, frames, mask, cam, config, pyr)


def solver_inputs(pb: Problem):
    """(with3d [P], pairs): the slots tracked with 3D and the joint's pair
    table from the graph's top-k, as the tracking frame builds them."""
    from nrslam_tpu_torch.slam import graph as graph_mod
    from nrslam_tpu_torch.slam import state as state_mod
    from nrslam_tpu_torch.solver import pose_deformation as pd

    with3d = state_mod.tracked_with_3d(pb.state)
    nbr_idx, nbr_w, nbr_d0, nbr_valid = graph_mod.top_k_neighbors(
        pb.state.graph, with3d, pb.config.regularizers_per_point)
    return with3d, pd.pairs_from_neighbors(nbr_idx, nbr_w, nbr_d0,
                                           nbr_valid & with3d[:, None])


def stage_calls(pb: Problem) -> dict:
    """Every stage of ``KEYS`` as (fn, perturb) for ``chained_timeit``:
    ``fn(perturb(eps))`` runs the stage on the problem with one input
    moved by the scalar ``eps``."""
    from nrslam_tpu_torch.ops import klt
    from nrslam_tpu_torch.slam import graph as graph_mod
    from nrslam_tpu_torch.slam import mapping, system, tracking
    from nrslam_tpu_torch.solver import pose_deformation as pd
    from nrslam_tpu_torch.solver import pose_only

    s, pyr, mask, cam, config = pb.state, pb.pyramid, pb.mask, pb.cam, \
        pb.config
    raw = pb.frames[4]
    with3d, pairs = solver_inputs(pb)

    def kp(eps):
        return s.keypoints + eps

    def moved(eps):
        return s._replace(positions=s.positions + eps)

    def process(kf):
        return lambda st: tracking.process_frame(st, pyr, mask, cam, config,
                                                 kf)[0].positions

    def mapped(kf):
        return lambda st: mapping.do_mapping(
            st, cam, config, has_new_keyframe=kf).positions

    def full(kf):
        return lambda st: system.frame_step(st, raw, mask, cam, config,
                                            kf)[0].positions

    calls = {
        "pyramid": (lambda g: klt.build_pyramid(g, config.klt_config)[0][0],
                    lambda eps: raw + eps),
        "klt_track": (lambda k: klt.track(
            pyr, s.refs, k, s.status, config.klt_config,
            min_ssim=config.klt_min_ssim, use_initial_flow=True)[0], kp),
        "pose_only": (lambda k: pose_only.camera_pose_optimization(
            cam, s.Tcw, s.positions, k, with3d).t, kp),
        "pose_deformation": (lambda k: pd.pose_deformation_optimization(
            cam, s.Tcw, s.positions, k, with3d, pairs, s.scale).flows, kp),
        "top_k_neighbors": (lambda g: graph_mod.top_k_neighbors(
            g, with3d, config.regularizers_per_point)[1],
            lambda eps: s.graph._replace(weight=s.graph.weight + eps)),
        "point_reuse": (lambda st: tracking.point_reuse(
            st, pyr, cam, config).keypoints, moved),
        "tracking_frame_nokf": (process(False), moved),
        "tracking_frame_kf": (process(True), moved),
        "mapping_triangulate": (mapped(False), moved),
        "mapping_ba": (mapped(True), moved),
        "full_frame_nokf": (full(False), moved),
        "full_frame_kf": (full(True), moved),
    }
    assert tuple(calls) == KEYS
    return calls


def measure(fn, perturb, n: int = 20, warmup: int = 2) -> dict:
    """``chained_ms`` over ``n`` calls after ``warmup``, and ``device_ms``
    and ``kernels`` of one more call under ``torch.profiler``
    (``profiler.device_reading``)."""
    chained = profiler.chained_timeit(fn, perturb, n, warmup)
    eps = torch.zeros((), dtype=torch.float32, device="cuda")
    reading = profiler.device_reading(lambda: fn(perturb(eps)))
    return {"chained_ms": chained, "device_ms": reading["device_ms"],
            "kernels": reading["kernels"]}


def run(pb: Problem, keys=KEYS, n: int = 20, warmup: int = 2) -> dict:
    """``measure`` of each stage of ``keys``."""
    calls = stage_calls(pb)
    return {k: measure(*calls[k], n=n, warmup=warmup) for k in keys}


def size_args(description: str, argv=None):
    """The tools' problem size: --points --height --width --new-kp."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--points", type=int, default=768)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--new-kp", type=int, default=256)
    return ap.parse_args(argv)


def main(argv=None):
    args = size_args(__doc__.splitlines()[0], argv)
    dev = resolve()
    print(profiler.gpu_header(), flush=True)
    pb = steady_state(args.points, args.height, args.width, args.new_kp, dev)
    print(json.dumps({"where": f"{args.width}x{args.height} "
                      f"P={args.points} new_kp={args.new_kp}",
                      "stages": run(pb)}, indent=1))


if __name__ == "__main__":
    main()
