"""Run the SLAM system over a sequence (counterpart of apps/run_slam.py).

    python -m nrslam_tpu_torch.apps.run_slam --dataset hamlyn \\
        --dataset_path DIR --settings_path DIR/settings.yaml --end_frame 60

One entry point for the reference's three binaries (apps/endomapper.cc,
apps/hamlyn.cc, apps/simulation.cc) and the synthetic sequence; the flags
are the JAX CLI's. ``--device`` (default ``cuda``) says where the system
runs; ``--device cpu`` runs the plain PyTorch versions of the kernels on
the CPU. Settings, masks, the camera and every frame's math live on that
device; decoding and the dumps are host work.

The last line of standard output is a JSON summary with the JAX CLI's
keys. ``main(argv)`` returns ``(summary, system)`` for callers in the same
process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nrslam_tpu_torch.apps.run_slam")
    ap.add_argument("--dataset", choices=["synthetic", "simulation", "hamlyn",
                                          "endomapper"], default="synthetic")
    ap.add_argument("--dataset_path", default="")
    ap.add_argument("--settings_path", default="")
    ap.add_argument("--starting_frame", type=int, default=0)
    ap.add_argument("--end_frame", type=int, default=100)
    ap.add_argument("--half_resolution", action="store_true",
                    help="process at half resolution (the reference does this "
                         "for endomapper/simulation, apps/endomapper.cc:66-67)")
    ap.add_argument("--deform_amp", type=float, default=0.02,
                    help="synthetic scene deformation amplitude")
    ap.add_argument("--save_ply", default="")
    ap.add_argument("--save_viz", default="",
                    help="directory for overlay dumps every 10 frames "
                         "(feature/graph/flow-trail PNGs + final 3D trails "
                         "PLY; the ImageVisualizer/MapVisualizer save_path "
                         "behavior, image_visualizer.cc:45-50)")
    ap.add_argument("--save_rmse", default="")
    ap.add_argument("--checkpoint_dir", default="")
    ap.add_argument("--max_points", type=int, default=0,
                    help="override landmark slot capacity (0 = Config default)")
    ap.add_argument("--auto_reinit", action="store_true",
                    help="re-initialize a fresh map after tracking collapse "
                         "instead of stopping (the reference exit(0)s, "
                         "tracking.cc:97-99)")
    ap.add_argument("--init_check_every", type=int, default=4,
                    help="read the initializer's success flags every N "
                         "frames (1 = reference-exact handoff; N > 1 trades "
                         "up to N-1 frames at the init->tracking handoff for "
                         "fewer device->host reads)")
    ap.add_argument("--lost_check_every", type=int, default=5,
                    help="read the LOST latch every N frames; the collapse "
                         "latches on the device at the frame it happens and "
                         "later frames leave the map unchanged, so N only "
                         "delays when it is reported")
    ap.add_argument("--device", default="cuda",
                    help="torch device the system runs on (cuda, cuda:1, "
                         "cpu)")
    return ap.parse_args(argv)


def _frames(args, device):
    """(frames iterator of (index, image, depth or None, right or None),
    camera, Config, masker, Stereo.bf)."""
    from nrslam_tpu_torch.slam.state import Config

    if args.dataset == "synthetic":
        from nrslam_tpu_torch.datasets import synthetic
        scene = synthetic.SceneConfig(deform_amp=args.deform_amp)
        seq = synthetic.SyntheticSequence(scene, n_frames=args.end_frame,
                                          device=device)
        config = Config(rad_per_pixel=1.0 / scene.fx)
        if args.max_points:
            config = config._replace(max_points=args.max_points)

        def frames():
            for i in range(args.starting_frame, args.end_frame):
                gray, depth, _ = seq.get_frame(i)
                yield i, gray, depth, None

        return frames(), synthetic.camera(scene, device), config, None, 0.0

    from nrslam_tpu_torch.config import Settings
    from nrslam_tpu_torch.datasets import loaders

    settings = Settings(args.settings_path, device)
    config = (settings.slam_config(max_points=args.max_points)
              if args.max_points else settings.slam_config())
    half = (slice(None, None, 2),) * 2 if args.half_resolution else ()

    def cut(img):
        return None if img is None else img[half]

    if args.dataset == "simulation":
        ds = loaders.Simulation(args.dataset_path)

        def frames():
            for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                yield i, cut(ds.get_image(i)), cut(ds.get_depth_image(i)), None
    elif args.dataset == "hamlyn":
        ds = loaders.Hamlyn(args.dataset_path)

        # Stereo evaluation path (system.cc:134-160): track the left
        # stream; right frames + Stereo.bf feed the stereo-GT evaluator.
        def frames():
            for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                yield (i, cut(ds.get_image(i)), None,
                       cut(ds.get_right_image(i)))
    else:
        ds = loaders.Endomapper(args.dataset_path)

        def frames():
            for i in range(args.starting_frame, min(args.end_frame, len(ds))):
                yield i, cut(ds.get_image(i)), None, None

    return (frames(), settings.calibration, config, settings.masker,
            settings.bf)


def _dump_viz(out_dir: Path, i: int, slam, img) -> None:
    from nrslam_tpu_torch.viz import dumps

    out_dir.mkdir(parents=True, exist_ok=True)
    gray = slam._preprocess(img).cpu().numpy()
    st = slam.state
    dumps.save_png(out_dir / f"features_{i:05d}.png",
                   dumps.draw_frame(gray, st.keypoints, st.status,
                                    st.slot_used))
    dumps.save_png(out_dir / f"graph_{i:05d}.png",
                   dumps.draw_graph(gray, st.keypoints, st.status,
                                    st.slot_used, st.graph))
    dumps.save_png(out_dir / f"flow_{i:05d}.png",
                   dumps.draw_optical_flow(gray, st))


def main(argv=None):
    """Run the CLI on ``argv`` (default: the command line); print the JSON
    summary as the last line and return ``(summary, system)``."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_slam: --device cuda but torch.cuda.is_available()"
                         " is False (pass --device cpu to run on the CPU)")

    from nrslam_tpu_torch.slam import system as system_mod
    from nrslam_tpu_torch.utils.profiler import TimeProfiler

    def sync():
        # Wait for queued device work, so wall-clock rates are honest.
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    frames, cam, config, masker, stereo_bf = _frames(args, device)
    slam = system_mod.System(cam, config, masker=masker,
                             lost_check_every=args.lost_check_every,
                             init_check_every=args.init_check_every,
                             auto_reinitialize=args.auto_reinit)
    profiler = TimeProfiler()
    stereo_rmses = []
    n_tracked = n_frames = steady_n = 0
    steady_t0 = None
    t_loop0 = time.perf_counter()
    for i, img, depth, right in frames:
        with profiler.section("frame"):
            if depth is not None:
                out = slam.track_image_with_depth(img, depth)
            elif right is not None and stereo_bf > 0:
                out = slam.track_image_with_stereo(img, right, bf=stereo_bf)
                if "stereo_rmse" in out:
                    stereo_rmses.append(out["stereo_rmse"])
            else:
                out = slam.track_image(img)
        n_frames += 1
        if out["status"] == system_mod.TRACKING:
            n_tracked += 1
        # The steady-state window opens after 12 tracked frames, so the
        # kernels' build and other one-off costs stay out of it.
        if steady_t0 is None and n_tracked >= 12:
            sync()
            steady_t0 = time.perf_counter()
        elif steady_t0 is not None:
            steady_n += 1
        if i % 10 == 0:
            print(f"frame {i}: status={out['status']} "
                  f"kf={out.get('keyframe')}", file=sys.stderr)
            if args.save_viz and slam.state is not None:
                _dump_viz(Path(args.save_viz), i, slam, img)
        if out["status"] == system_mod.LOST:
            print("tracking lost", file=sys.stderr)
            break

    sync()
    loop_s = time.perf_counter() - t_loop0
    stats = profiler.statistics().get("frame", {})
    summary = {
        "frames_tracked": n_tracked,
        "status": slam.status,
        "mean_frame_ms": stats.get("mean_ms"),
        "fps": round(n_frames / loop_s, 2) if n_frames else None,
        "steady_fps": (round(steady_n / (time.perf_counter() - steady_t0), 2)
                       if steady_t0 is not None and steady_n else None),
        "median_rmse": (float(np.median(slam.evaluator.rmse_history))
                        if slam.evaluator.rmse_history else None),
        "median_stereo_rmse": (float(np.median(stereo_rmses))
                               if stereo_rmses else None),
    }
    print(json.dumps(summary))

    if args.save_ply and slam.state is not None:
        from nrslam_tpu_torch.viz.dumps import export_ply
        export_ply(args.save_ply, slam.state)
    if args.save_viz and slam.state is not None:
        from nrslam_tpu_torch.viz.dumps import export_flow_trails_ply
        export_flow_trails_ply(
            str(Path(args.save_viz) / "flow_trails.ply"), slam.state)
    if args.save_rmse:
        if slam.evaluator.rmse_history or not stereo_rmses:
            slam.evaluator.save(args.save_rmse)
        else:
            # Stereo runs: the per-frame stereo-GT RMSE file
            # (frame_evaluator.cc's results convention).
            Path(args.save_rmse).write_text(
                "".join(f"{r}\n" for r in stereo_rmses))
    if args.checkpoint_dir and slam.state is not None:
        from nrslam_tpu_torch.utils import checkpoint
        checkpoint.save(args.checkpoint_dir, slam.state)
    return summary, slam


if __name__ == "__main__":
    main()
